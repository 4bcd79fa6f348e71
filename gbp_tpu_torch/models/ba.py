"""Bundle adjustment: synthetic scenes, graph building and the ARE metric.

Counterpart of the main-path subset of gbp_tpu/models/ba.py.  `simulate`,
`simulate_corridor` and `simulate_blocks` are the reference's numpy code
with the same `numpy.random.Generator` call order, so a seed gives the same
scene in both packages (the reference's rotations go through JAX, these
through the port's `lie` on the CPU in float64).
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch.core.graph import GraphBuilder
from gbp_tpu_torch.core.sweep import GBPState, gather_linpoint
from gbp_tpu_torch.factors import reprojection
from gbp_tpu_torch.utils.lie import so3_exp, so3_log

CAM = 0  # variable-block handles returned by build()
LMK = 1


def simulate(
    n_cams=12,
    n_lmks=300,
    pix_sigma=1.0,
    radius=10.0,
    fov_frac=0.7,
    cam_noise=(0.03, 0.08),
    lmk_noise=0.3,
    seed=0,
    k=(500.0, 500.0, 320.0, 240.0),
):
    """Synthetic BA scene: cameras on an arc looking at a landmark cloud.

    Returns ground-truth and noisy initial camera [n_cams, 6] and landmark
    [n, 3] states, pixel observations with camera/landmark ids, and the
    shared intrinsics K = [fx, fy, cx, cy]."""
    rng = np.random.default_rng(seed)
    k_arr = np.asarray(k)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)

    angles = np.linspace(0, fov_frac * 2 * np.pi, n_cams, endpoint=False)
    centers = np.stack(
        [radius * np.cos(angles), radius * np.sin(angles),
         1.0 + 0.2 * rng.standard_normal(n_cams)],
        axis=1,
    )
    cams = np.zeros((n_cams, 6))
    for i, c in enumerate(centers):
        fwd = -c / np.linalg.norm(c)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up0)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        r = np.stack([right, up, fwd], axis=1).T  # world -> cam
        cams[i, :3] = so3_log(f64(r)).numpy()
        cams[i, 3:] = -r @ c

    lmks = rng.standard_normal((n_lmks, 3)) * np.array([3.0, 3.0, 1.5])

    # Observations: every landmark with positive depth and in-image.
    obs, cam_ids, lmk_ids = [], [], []
    for i in range(n_cams):
        r = so3_exp(f64(cams[i, :3])).numpy()
        xc = lmks @ r.T + cams[i, 3:]
        uv = np.stack(
            [k_arr[0] * xc[:, 0] / xc[:, 2] + k_arr[2],
             k_arr[1] * xc[:, 1] / xc[:, 2] + k_arr[3]],
            axis=1,
        )
        vis = (
            (xc[:, 2] > 0.5)
            & (uv[:, 0] > 0) & (uv[:, 0] < 2 * k_arr[2])
            & (uv[:, 1] > 0) & (uv[:, 1] < 2 * k_arr[3])
        )
        idx = np.flatnonzero(vis)
        obs.append(uv[idx] + pix_sigma * rng.standard_normal((idx.size, 2)))
        cam_ids.append(np.full(idx.size, i))
        lmk_ids.append(idx)
    obs = np.concatenate(obs)
    cam_ids = np.concatenate(cam_ids)
    lmk_ids = np.concatenate(lmk_ids)

    # Keep only landmarks seen >= 2 times.
    keep = np.bincount(lmk_ids, minlength=n_lmks) >= 2
    remap = -np.ones(n_lmks, dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[lmk_ids]
    obs, cam_ids, lmk_ids = obs[sel], cam_ids[sel], remap[lmk_ids[sel]]
    lmks = lmks[keep]

    cam_init = cams + np.concatenate(
        [cam_noise[0] * rng.standard_normal((n_cams, 3)),
         cam_noise[1] * rng.standard_normal((n_cams, 3))], axis=1
    )
    cam_init[0] = cams[0]  # gauge anchor starts exactly at its prior
    lmk_init = lmks + lmk_noise * rng.standard_normal(lmks.shape)

    return dict(
        cam_truth=cams, lmk_truth=lmks, cam_init=cam_init, lmk_init=lmk_init,
        obs=obs, cam_ids=cam_ids, lmk_ids=lmk_ids, k=k_arr, pix_sigma=pix_sigma,
    )


def simulate_corridor(
    n_cams=32,
    lmks_per_cam=40,
    window=3,
    step=1.0,
    wall_dist=4.0,
    pix_sigma=1.0,
    cam_noise=(0.02, 0.05),
    lmk_noise=0.2,
    seed=0,
    k=(500.0, 500.0, 320.0, 240.0),
):
    """Synthetic corridor/street BA scene with visibility locality.

    Cameras move along a line looking at a landmark wall; each landmark is
    only visible from cameras within +-`window` positions, so consecutive
    landmarks (in corridor order) see nearby cameras.  The landmark
    numbering is random along the corridor.  Returns the same dict shape as
    `simulate`."""
    rng = np.random.default_rng(seed)
    k_arr = np.asarray(k)

    # Cameras along +x, looking at the wall in +y; one shared rotation.
    cams = np.zeros((n_cams, 6))
    fwd = np.array([0.0, 1.0, 0.0])
    up0 = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r = np.stack([right, up, fwd], axis=1).T
    w = so3_log(torch.as_tensor(r, dtype=torch.float64)).numpy()
    for i in range(n_cams):
        c = np.array([i * step, 0.0, 0.0])
        cams[i, :3] = w
        cams[i, 3:] = -r @ c

    # Landmarks on the wall, spread along the corridor.
    n_lmks = n_cams * lmks_per_cam
    lx = rng.uniform(-step, (n_cams - 1 + 1.0) * step, n_lmks)
    lmks = np.stack(
        [lx, wall_dist + 0.5 * rng.standard_normal(n_lmks),
         0.8 * rng.standard_normal(n_lmks)], axis=1)

    obs, cam_ids, lmk_ids = [], [], []
    for i in range(n_cams):
        xi = i * step
        near = np.flatnonzero(np.abs(lmks[:, 0] - xi) <= window * step)
        xc = lmks[near] @ r.T + cams[i, 3:]
        uv = np.stack(
            [k_arr[0] * xc[:, 0] / xc[:, 2] + k_arr[2],
             k_arr[1] * xc[:, 1] / xc[:, 2] + k_arr[3]], axis=1)
        vis = (
            (xc[:, 2] > 0.5)
            & (uv[:, 0] > 0) & (uv[:, 0] < 2 * k_arr[2])
            & (uv[:, 1] > 0) & (uv[:, 1] < 2 * k_arr[3])
        )
        idx = near[vis]
        obs.append(uv[vis] + pix_sigma * rng.standard_normal((idx.size, 2)))
        cam_ids.append(np.full(idx.size, i))
        lmk_ids.append(idx)
    obs = np.concatenate(obs)
    cam_ids = np.concatenate(cam_ids)
    lmk_ids = np.concatenate(lmk_ids)

    keep = np.bincount(lmk_ids, minlength=n_lmks) >= 2
    remap = -np.ones(n_lmks, dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[lmk_ids]
    obs, cam_ids, lmk_ids = obs[sel], cam_ids[sel], remap[lmk_ids[sel]]
    lmks = lmks[keep]

    cam_init = cams + np.concatenate(
        [cam_noise[0] * rng.standard_normal((n_cams, 3)),
         cam_noise[1] * rng.standard_normal((n_cams, 3))], axis=1)
    cam_init[0] = cams[0]
    lmk_init = lmks + lmk_noise * rng.standard_normal(lmks.shape)

    return dict(
        cam_truth=cams, lmk_truth=lmks, cam_init=cam_init, lmk_init=lmk_init,
        obs=obs, cam_ids=cam_ids, lmk_ids=lmk_ids, k=k_arr, pix_sigma=pix_sigma,
    )


def simulate_blocks(n_blocks=8, n_cams=40, lmks_per_cam=20, window=3,
                    seed=0, shuffle=False, **kw):
    """`n_blocks` independent corridor blocks merged into one graph: the
    float32-stable large-camera-count scene (each block is a 40-camera
    corridor, so the merged problem has bounded effective diameter, unlike
    one long chain).  32 blocks x 40 cameras x 60 landmarks per camera is
    the city scene, 256 x 40 x 80 the venice scene.

    shuffle=True randomizes the landmark numbering over the whole scene, so
    that the camera windows of core/sweep_cm.py engage only through the
    locality sort (the condition of real BAL files).  Returns the same dict
    shape as `simulate`."""
    sims = [simulate_corridor(n_cams=n_cams, lmks_per_cam=lmks_per_cam,
                              window=window, seed=seed + i, **kw)
            for i in range(n_blocks)]
    out = {}
    for key in ("cam_truth", "cam_init", "lmk_truth", "lmk_init", "obs"):
        out[key] = np.concatenate([s[key] for s in sims])
    cam_ids, lmk_ids, co, lo = [], [], 0, 0
    for s in sims:
        cam_ids.append(s["cam_ids"] + co)
        lmk_ids.append(s["lmk_ids"] + lo)
        co += s["cam_init"].shape[0]
        lo += s["lmk_init"].shape[0]
    out["cam_ids"] = np.concatenate(cam_ids)
    out["lmk_ids"] = np.concatenate(lmk_ids)
    out["k"] = sims[0]["k"]
    out["pix_sigma"] = sims[0]["pix_sigma"]
    if shuffle:
        rng = np.random.default_rng(seed + 99)
        perm = rng.permutation(lo)
        inv = np.argsort(perm)
        out["lmk_truth"] = out["lmk_truth"][perm]
        out["lmk_init"] = out["lmk_init"][perm]
        out["lmk_ids"] = inv[out["lmk_ids"]]
    return out


def build(
    sim: dict,
    pix_sigma=None,
    huber=None,
    anchor_prec=(1e5, 1e5),
    cam_prior_prec=1.0,
    lmk_prior_prec=1.0,
    dtype=torch.float32,
    device=None,
    layout="ell",
):
    """Build the BA factor graph in normalized image coordinates, on
    `device` (None: the card, see `gbp_tpu_torch.default_device`); returns
    (graph, init_means).

    Camera 0 is anchored with anchor_prec[0] (6-dof gauge), camera 1's
    translation with anchor_prec[1] (scale gauge); every other variable gets
    a prior at its initial estimate.  layout="ell" groups observations by
    landmark, padded to uniform track length.  The pixel-space build waits
    for the other factor variants (ROADMAP A7)."""
    n_cams = sim["cam_init"].shape[0]
    pix_sigma = sim.get("pix_sigma", 1.0) if pix_sigma is None else pix_sigma
    k_arr = np.asarray(sim["k"], dtype=np.float64)

    b = GraphBuilder(dtype=dtype, device=device)
    cam = b.add_variables("cam", sim["cam_init"], prior_prec=cam_prior_prec)
    lmk = b.add_variables("lmk", sim["lmk_init"], prior_prec=lmk_prior_prec)
    b.set_prior(cam, 0, sim["cam_init"][0], anchor_prec[0])
    if n_cams > 1:
        prec1 = np.full(6, cam_prior_prec)
        prec1[3:] = anchor_prec[1]
        b.set_prior(cam, 1, sim["cam_init"][1], prec1)
    z = (sim["obs"] - k_arr[2:]) / k_arr[:2]
    sigma = np.broadcast_to(pix_sigma / k_arr[:2], z.shape)
    b.add_factors("reproj", reprojection.reprojection_normalized(),
                  [(cam, sim["cam_ids"]), (lmk, sim["lmk_ids"])], z,
                  sigma=sigma, huber=huber)
    return b.build(layout=layout)


def with_means(state: GBPState, means: tuple) -> GBPState:
    """Return a state whose belief means are replaced (for metric evaluation)."""
    return state._replace(v=tuple(vs._replace(mean=mu) for vs, mu in zip(state.v, means)))


def reprojection_errors_px(graph, state: GBPState, k, fi: int = 0) -> torch.Tensor:
    """Per-factor reprojection error ||z - h(mean)||_2 in pixels [m]."""
    fb = graph.fblocks[fi]
    x = gather_linpoint(graph, state, fi)
    r = fb.ftype.residual(fb.z, fb.ftype.meas(x, fb.args))
    r = r * torch.as_tensor(np.asarray(k[:2]), dtype=r.dtype, device=r.device)
    return torch.linalg.norm(r, dim=-1)


def avg_reprojection_error(graph, state: GBPState, k, fi: int = 0) -> torch.Tensor:
    """The reference's `are()` metric in pixels; ELL padding rows excluded."""
    e = reprojection_errors_px(graph, state, k, fi)
    valid = graph.fblocks[fi].valid
    if valid is None:
        return e.mean()
    return torch.where(valid, e, torch.zeros_like(e)).sum() / valid.sum()
