"""Frontend pipeline: images -> tracks -> triangulated BA problem
(counterpart of gbp_tpu/frontend/pipeline.py).

Harris / ZNCC feature tracking (`frontend.features`) on the device,
host-side track chaining (numpy, as the reference), linear triangulation
with a deterministic per-landmark sum, geometric track filtering, and the
synthetic renderer the tests and the example draw their frames with.
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.graph import adjacency_csr
from gbp_tpu_torch.frontend import features
from gbp_tpu_torch.utils.lie import hat3, so3_exp
from gbp_tpu_torch.utils.smalllinalg import bT, bmm, bmv, scaled_sym_inv


def _frame(img, device) -> torch.Tensor:
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.array(img, dtype=np.float32))
    return img.to(device)


def build_tracks(images, max_corners: int = 512, patch_size: int = 9, min_score: float = 0.6,
                 ratio: float = 0.95, min_track_len: int = 2, max_disp: float | None = None,
                 device=None):
    """Detect and match across an image sequence; chain the matches into
    tracks.

    images: a sequence of [H, W] frames (numpy or tensors), or one [n, H,
    W] array.  Detection, description and matching run on `device` (None:
    the card), frame to frame (consecutive pairs); the chaining runs on the
    host (small and data-dependent).  Returns (cam_ids, lmk_ids, obs [n,
    2]) numpy arrays, one row per observation of a track, as `models.ba`
    takes them."""
    device = resolve_device(device)
    n_frames = len(images)
    feats = []
    for img in images:
        img = _frame(img, device)
        xy, score = features.detect(img, max_corners=max_corners)
        feats.append((xy, features.extract_patches(img, xy, size=patch_size), score > 0))
    xys = [xy.cpu().numpy() for xy, _, _ in feats]

    # Track chaining: track_of[f][i] = global track id of feature i in frame f.
    track_of = [np.full(max_corners, -1, dtype=np.int64) for _ in range(n_frames)]
    n_tracks = 0
    obs_cam, obs_track, obs_uv = [], [], []
    for f in range(n_frames - 1):
        (xy1, d1, v1), (xy2, d2, v2) = feats[f], feats[f + 1]
        mj, ok = features.match(d1, d2, valid1=v1, valid2=v2, xy1=xy1, xy2=xy2,
                                min_score=min_score, ratio=ratio, max_disp=max_disp)
        mj, ok = mj.cpu().numpy(), ok.cpu().numpy()
        for i in np.flatnonzero(ok):
            j = mj[i]
            t = track_of[f][i]
            if t < 0:
                t = n_tracks
                n_tracks += 1
                track_of[f][i] = t
                obs_cam.append(f)
                obs_track.append(t)
                obs_uv.append(xys[f][i])
            track_of[f + 1][j] = t
            obs_cam.append(f + 1)
            obs_track.append(t)
            obs_uv.append(xys[f + 1][j])

    cam_ids = np.asarray(obs_cam, dtype=np.int64)
    lmk_ids = np.asarray(obs_track, dtype=np.int64)
    obs = np.asarray(obs_uv, dtype=np.float64).reshape(-1, 2)

    # Keep tracks seen >= min_track_len times; remap ids densely.
    counts = np.bincount(lmk_ids, minlength=n_tracks)
    keep = counts >= min_track_len
    remap = -np.ones(n_tracks, dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[lmk_ids]
    return cam_ids[sel], remap[lmk_ids[sel]], obs[sel]


def _segment_sum(x: torch.Tensor, lmk_ids: np.ndarray, n_lmks: int) -> torch.Tensor:
    """Sum of the rows x [m, ...] per landmark id, [n_lmks, ...], in a fixed
    order: the rows of each landmark by a CSR (`adjacency_csr`, rows in
    their order), gathered into [n_lmks, longest track] with zero padding and
    summed along the track axis.  No atomics: two runs on the card agree bit
    for bit."""
    rows, offsets = adjacency_csr(lmk_ids, n_lmks)
    lens = np.diff(offsets)
    width = max(int(lens.max()) if n_lmks else 0, 1)
    slot = np.arange(width)[None, :]
    idx = np.where(slot < lens[:, None], offsets[:-1, None] + slot, rows.size)
    table = np.append(rows, x.shape[0]).astype(np.int64)[idx]  # [n_lmks, width]
    padded = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
    return padded[torch.as_tensor(table, device=x.device)].sum(1)


def triangulate(cams, k, cam_ids, lmk_ids, obs, n_lmks=None, eps=1e-8, device=None):
    """Linear (DLT-style) triangulation of tracks given camera poses.

    cams: [n_cams, 6] world->camera [omega, t] states (numpy: its dtype is
    kept); k: [fx, fy, cx, cy].  Each observation contributes the constraint
    [x_n]x (R X + t) = 0 with x_n the normalized ray; the per-landmark 3x3
    normal equations are summed (`_segment_sum`) and solved in closed form.
    Runs on `device` (None: the card).  Returns [n_lmks, 3]."""
    device = resolve_device(device)
    cams = torch.as_tensor(cams, device=device)
    k = torch.as_tensor(np.asarray(k), dtype=cams.dtype, device=device)
    obs = torch.as_tensor(np.asarray(obs), dtype=cams.dtype, device=device)
    lmk_ids = np.asarray(lmk_ids)
    if n_lmks is None:
        n_lmks = int(lmk_ids.max()) + 1
    ci = torch.as_tensor(np.asarray(cam_ids), dtype=torch.int64, device=device)
    r = so3_exp(cams[:, :3])  # [n_cams, 3, 3]
    xn = torch.stack([(obs[:, 0] - k[2]) / k[0], (obs[:, 1] - k[3]) / k[1],
                      torch.ones_like(obs[:, 0])], dim=-1)
    cross = hat3(xn)  # [m, 3, 3]
    a = bmm(cross, r[ci])  # [m, 3, 3]
    b = -bmv(cross, cams[ci, 3:])  # [m, 3]
    ata = _segment_sum(bmm(bT(a), a), lmk_ids, n_lmks)
    atb = _segment_sum(bmv(bT(a), b), lmk_ids, n_lmks)
    ata = ata + eps * torch.eye(3, dtype=cams.dtype, device=device)
    return bmv(scaled_sym_inv(ata, 3), atb)


def _rotations(cams: np.ndarray) -> np.ndarray:
    return so3_exp(torch.as_tensor(cams[:, :3])).numpy()


def filter_tracks(cams, k, cam_ids, lmk_ids, obs, thresh=3.0, min_track_len=2, n_rounds=2,
                  device=None):
    """Geometric outlier rejection: triangulate (on `device`, None: the
    card), gate each observation by its reprojection error, prune short
    tracks, repeat.  Removes the wrong associations that survive appearance
    matching.  numpy in, numpy out."""
    cams = np.asarray(cams)
    k = np.asarray(k)
    cam_ids = np.asarray(cam_ids)
    lmk_ids = np.asarray(lmk_ids)
    obs = np.asarray(obs)
    for _ in range(n_rounds):
        n_lmks = int(lmk_ids.max()) + 1 if lmk_ids.size else 0
        if not n_lmks:
            break
        lmks = triangulate(cams, k, cam_ids, lmk_ids, obs, n_lmks=n_lmks,
                           device=device).cpu().numpy()
        rot = _rotations(cams)
        xc = np.einsum("oij,oj->oi", rot[cam_ids], lmks[lmk_ids]) + cams[cam_ids, 3:]
        z_ok = xc[:, 2] > 1e-3
        uv = np.stack(
            [k[0] * xc[:, 0] / np.where(z_ok, xc[:, 2], 1.0) + k[2],
             k[1] * xc[:, 1] / np.where(z_ok, xc[:, 2], 1.0) + k[3]], axis=1,
        )
        keep = z_ok & (np.linalg.norm(uv - obs, axis=1) < thresh)
        cam_ids, lmk_ids, obs = cam_ids[keep], lmk_ids[keep], obs[keep]
        # Re-prune short tracks + remap densely.
        counts = np.bincount(lmk_ids, minlength=n_lmks)
        keep_t = counts >= min_track_len
        remap = -np.ones(n_lmks, dtype=np.int64)
        remap[keep_t] = np.arange(int(keep_t.sum()))
        sel = keep_t[lmk_ids]
        cam_ids, lmk_ids, obs = cam_ids[sel], remap[lmk_ids[sel]], obs[sel]
    return cam_ids, lmk_ids, obs


def render_scene(cams, lmks, k, shape=(240, 320), blob_sigma=1.2, intensities=None, seed=0,
                 device=None):
    """Render synthetic frames: landmarks splatted as distinctive blobs.

    The test and demo harness of the frontend (no imagery ships with the
    repo).  Each landmark renders as an anisotropic Gaussian with a
    satellite lobe in a per-landmark random direction, so that local
    patches are discriminative under ZNCC.  cams [n, 6] world->camera, lmks
    [nl, 3], k = [fx, fy, cx, cy] scaled to `shape`.  The blobs are added
    landmark by landmark in the reference's order, in float32, each step
    over all frames at once, on `device` (None: the card).  Returns [n, H,
    W] float32 frames in [0, 1]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    nl = lmks.shape[0]
    if intensities is None:
        intensities = 0.5 + 0.5 * rng.random(nl)
    # Per-landmark appearance: anisotropic scales, orientation, satellite lobe.
    sx = blob_sigma * (0.7 + 0.9 * rng.random(nl))
    sy = blob_sigma * (0.7 + 0.9 * rng.random(nl))
    phi = 2 * np.pi * rng.random(nl)
    sat_ang = 2 * np.pi * rng.random(nl)
    sat_r = 2.0 + 2.0 * rng.random(nl)
    sat_i = 0.3 + 0.5 * rng.random(nl)

    f32 = dict(dtype=torch.float32, device=device)
    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    cams = torch.as_tensor(np.asarray(cams), **f32)
    lmks = torch.as_tensor(np.asarray(lmks), **f32)
    k = torch.as_tensor(np.asarray(k), **f32)
    app = torch.as_tensor(np.stack([intensities, sx, sy, phi, sat_ang, sat_r, sat_i], 0), **f32)

    rot = so3_exp(cams[:, :3])  # [n, 3, 3]
    xc = lmks[None] @ rot.transpose(1, 2) + cams[:, None, 3:]  # [n, nl, 3]
    vis = xc[..., 2] > 0.5
    u = k[0] * xc[..., 0] / xc[..., 2] + k[2]
    v = k[1] * xc[..., 1] / xc[..., 2] + k[3]
    ii, sxi, syi, ph, sa, sr, si = app  # each [nl]
    c, s = torch.cos(ph), torch.sin(ph)
    sat_dx, sat_dy = sr * torch.cos(sa), sr * torch.sin(sa)
    sat_w = (0.6 * sxi) ** 2
    img = torch.zeros((cams.shape[0], h, w), **f32)
    for j in range(nl):
        dx = xx - u[:, j, None, None]
        dy = yy - v[:, j, None, None]
        rx = (c[j] * dx + s[j] * dy) / sxi[j]
        ry = (-s[j] * dx + c[j] * dy) / syi[j]
        blob = ii[j] * torch.exp(-0.5 * (rx * rx + ry * ry))
        d2s = (dx - sat_dx[j]) ** 2 + (dy - sat_dy[j]) ** 2
        blob = blob + si[j] * ii[j] * torch.exp(-0.5 * d2s / sat_w[j])
        img = img + torch.where(vis[:, j, None, None], blob, 0.0)
    return torch.clamp(img, 0.0, 1.0)
