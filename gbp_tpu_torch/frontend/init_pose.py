"""Camera pose bootstrap from 2D tracks alone: two-view essential-matrix
initialization + incremental DLT-PnP registration (the port's own copy of
gbp_tpu/frontend/init_pose.py: the same numpy, with the port's rotation
maps and triangulation).

Pixels in, poses out, no oracle: this module plays the role the classical
SfM bootstrap plays upstream of GBP bundle adjustment.

All of this but the triangulation is host-side f64 numpy by design: it runs
ONCE per sequence on O(10^2..10^3) matches (microseconds of math), is full
of data-dependent branching (cheirality votes, registration order), and
feeds the GBP refinement on the device, which is where the compute is.

Robust estimation: the seed pair runs LO-RANSAC around
the 8-point fit (`essential_ransac`), registration runs LO-RANSAC around
DLT resection (`pnp_ransac`), and triangulation trims each track's worst
over-gate observation iteratively — 25% gross matches (the worst ZNCC
failure mode on real imagery) leave the bootstrap within the clean-data
accuracy bounds.

Conventions match models/ba: camera state [omega, t] with x_cam = R x_world
+ t; the first registered camera is the world origin and the two-view
baseline sets the (arbitrary) scale to 1.
"""
from __future__ import annotations

import numpy as np

import torch

from gbp_tpu_torch.frontend.pipeline import triangulate
from gbp_tpu_torch.utils.lie import so3_exp, so3_log


def _log(r: np.ndarray) -> np.ndarray:
    return so3_log(torch.as_tensor(r)).numpy()


def _exp(w: np.ndarray) -> np.ndarray:
    return so3_exp(torch.as_tensor(w)).numpy()


def _to_normalized(obs, k):
    return np.stack([(obs[:, 0] - k[2]) / k[0], (obs[:, 1] - k[3]) / k[1]],
                    axis=1)


def _hartley_normalize(x):
    mean = x.mean(axis=0)
    d = x - mean
    scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(d, axis=1)), 1e-12)
    t = np.array([[scale, 0, -scale * mean[0]],
                  [0, scale, -scale * mean[1]],
                  [0, 0, 1.0]])
    return d * scale, t


def _eight_point(x1, x2, essential=True):
    """Normalized 8-point epipolar fit from >= 8 correspondences.

    essential=True projects singular values to (1, 1, 0) (a proper
    essential matrix, the final-answer form); essential=False keeps
    (s1, s2, 0) — rank-2 only — which scores candidate consensus sets far
    more faithfully when the minimal sample is ill-conditioned (the (1,1,0)
    forcing can distort a noisy fit until even its own sample points fail
    the inlier gate)."""
    assert x1.shape[0] >= 8, "essential_8pt needs >= 8 correspondences"
    p1, t1 = _hartley_normalize(x1)
    p2, t2 = _hartley_normalize(x2)
    a = np.stack([
        p2[:, 0] * p1[:, 0], p2[:, 0] * p1[:, 1], p2[:, 0],
        p2[:, 1] * p1[:, 0], p2[:, 1] * p1[:, 1], p2[:, 1],
        p1[:, 0], p1[:, 1], np.ones(len(p1)),
    ], axis=1)
    _, _, vt = np.linalg.svd(a)
    e = vt[-1].reshape(3, 3)
    e = t2.T @ e @ t1
    u, s, vt = np.linalg.svd(e)
    sv = np.array([1.0, 1.0, 0.0]) if essential else np.array([s[0], s[1], 0.0])
    return u @ np.diag(sv) @ vt


def essential_8pt(x1, x2):
    """Normalized 8-point essential matrix from >= 8 correspondences.

    x1, x2: [m, 2] NORMALIZED image coordinates in views 1, 2.  Returns E
    with x2h^T E x1h = 0, singular values projected to (1, 1, 0)."""
    return _eight_point(x1, x2, essential=True)


def _sampson_sq(e, x1, x2):
    """Squared Sampson distance of x2h^T E x1h = 0 per correspondence [m]."""
    x1h = np.hstack([x1, np.ones((len(x1), 1))])
    x2h = np.hstack([x2, np.ones((len(x2), 1))])
    ex1 = x1h @ e.T  # [m, 3] = (E x1)^T rows
    etx2 = x2h @ e  # [m, 3] = (E^T x2)^T rows
    num = np.sum(x2h * ex1, axis=1) ** 2
    den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    return num / np.maximum(den, 1e-18)


def essential_ransac(x1, x2, iters=1000, thresh=3e-3, seed=0):
    """RANSAC-robust essential matrix (the plain least-squares 8-point over
    ALL matches lets one gross ZNCC mismatch in the seed pair sink the whole
    bootstrap).

    Samples 8-point minimal sets, scores by Sampson distance in normalized
    coordinates (`thresh` ~ gross-outlier gate, e.g. 1.5 px / f), then
    iterates refit-on-consensus to convergence (a minimal-sample fit is
    noisy, so the first consensus set usually misses clean matches; 2-3
    refit rounds recover them).  `iters` is sized for ~40% outlier rates:
    P(clean 8-sample) = 0.6^8 ~ 1.7%, so 1000 samples give ~17 clean draws.
    Returns (E, inlier mask)."""
    rng = np.random.default_rng(seed)
    m = x1.shape[0]
    assert m >= 8
    best_inl, best_n = None, -1
    for _ in range(iters):
        idx = rng.choice(m, 8, replace=False)
        try:
            e = _eight_point(x1[idx], x2[idx], essential=False)
        except np.linalg.LinAlgError:
            continue
        inl = _sampson_sq(e, x1, x2) < thresh * thresh
        if inl.sum() < 8:
            continue
        # Local optimization (LO-RANSAC): a minimal 8-point fit is noisy,
        # so refit on the consensus set and re-score until the inlier set
        # stops growing — a single good sample then expands to the full
        # clean set, while a wrong-E consensus stays small.  Run it on
        # every candidate with >= 8 initial inliers: good samples may start
        # BELOW the current best and only overtake it after expansion.
        for _ in range(4):
            e = _eight_point(x1[inl], x2[inl], essential=False)
            inl2 = _sampson_sq(e, x1, x2) < thresh * thresh
            if (inl2 == inl).all() or inl2.sum() < 8:
                break
            inl = inl2
        if inl.sum() > best_n:
            best_inl, best_n = inl, int(inl.sum())
    if best_inl is None or best_n < 8:
        raise ValueError("essential_ransac: no 8-inlier consensus found")
    # Final answer must be a proper essential matrix ((1,1,0) projection),
    # which is sensitive to any borderline outlier the rank-2 consensus
    # admitted — one gross point can drag the unweighted fit until most
    # clean inliers fail the gate.  Iterate fit/re-score and keep the
    # (E, inliers) pair with the largest consensus seen.
    e_best, set_best, n_best = None, None, -1
    inl = best_inl
    for _ in range(5):
        if inl.sum() < 8:
            break
        e = essential_8pt(x1[inl], x2[inl])
        inl2 = _sampson_sq(e, x1, x2) < thresh * thresh
        if inl2.sum() > n_best:
            e_best, set_best, n_best = e, inl2, int(inl2.sum())
        if (inl2 == inl).all():
            break
        inl = inl2
    if e_best is None or n_best < 8:
        raise ValueError("essential_ransac: essential projection lost the "
                         "consensus set")
    return e_best, set_best


def pnp_ransac(xn, pts, iters=500, thresh=4e-3, seed=0):
    """RANSAC-robust DLT resection: minimal 6-point samples scored by
    reprojection error in normalized coordinates; refit on the consensus
    set.  Returns (r, t, inlier mask) or None."""
    rng = np.random.default_rng(seed)
    m = xn.shape[0]
    if m < 6:
        return None

    def reproj_err(r, t):
        xc = pts @ r.T + t
        ok = xc[:, 2] > 1e-6
        uv = xc[:, :2] / np.where(ok, xc[:, 2], 1.0)[:, None]
        err = np.linalg.norm(uv - xn, axis=1)
        return np.where(ok, err, np.inf)

    best, best_inl, best_n = None, None, -1
    for _ in range(iters):
        idx = rng.choice(m, 6, replace=False)
        res = pnp_dlt(xn[idx], pts[idx])
        if res is None:
            continue
        inl = reproj_err(*res) < thresh
        if inl.sum() <= best_n:
            continue
        for _ in range(4):  # local optimization, as in essential_ransac
            if inl.sum() < 6:
                break
            res2 = pnp_dlt(xn[inl], pts[inl])
            if res2 is None:
                break
            res = res2
            inl2 = reproj_err(*res) < thresh
            if (inl2 == inl).all() or inl2.sum() < 6:
                break
            inl = inl2
        if inl.sum() > best_n:
            best, best_inl, best_n = res, inl, int(inl.sum())
    if best_inl is None or best_n < 6:
        return None
    return best[0], best[1], best_inl


def _triangulate_two(r, t, x1, x2):
    """Midpoint-free linear triangulation for the pair (I,0), (r,t)."""
    m = x1.shape[0]
    out = np.zeros((m, 3))
    p1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    p2 = np.hstack([r, t[:, None]])
    for i in range(m):
        a = np.stack([
            x1[i, 0] * p1[2] - p1[0],
            x1[i, 1] * p1[2] - p1[1],
            x2[i, 0] * p2[2] - p2[0],
            x2[i, 1] * p2[2] - p2[1],
        ])
        _, _, vt = np.linalg.svd(a)
        x = vt[-1]
        out[i] = x[:3] / x[3]
    return out


def decompose_essential(e, x1, x2):
    """Pick the (R, t) of the 4 essential decompositions by cheirality.

    Returns (r, t, points [m, 3] in view-1 frame, in_front mask)."""
    u, _, vt = np.linalg.svd(e)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    best = None
    for r in (u @ w @ vt, u @ w.T @ vt):
        for t in (u[:, 2], -u[:, 2]):
            pts = _triangulate_two(r, t, x1, x2)
            z1 = pts[:, 2]
            z2 = (pts @ r.T + t)[:, 2]
            front = (z1 > 0) & (z2 > 0)
            if best is None or front.sum() > best[3].sum():
                best = (r, t, pts, front)
    return best


def pnp_dlt(xn, pts):
    """DLT camera resection from >= 6 (2D normalized, 3D world) pairs.

    Returns (r, t) with x_cam = r x_world + t, or None if degenerate."""
    m = xn.shape[0]
    if m < 6:
        return None
    # Normalize the 3D points for conditioning.
    c = pts.mean(axis=0)
    s = np.sqrt(3.0) / max(np.mean(np.linalg.norm(pts - c, axis=1)), 1e-12)
    ph = np.hstack([(pts - c) * s, np.ones((m, 1))])
    rows = []
    for i in range(m):
        rows.append(np.concatenate([ph[i], np.zeros(4), -xn[i, 0] * ph[i]]))
        rows.append(np.concatenate([np.zeros(4), ph[i], -xn[i, 1] * ph[i]]))
    _, _, vt = np.linalg.svd(np.asarray(rows))
    p = vt[-1].reshape(3, 4)
    mm = p[:, :3]
    um, sm, vmt = np.linalg.svd(mm)
    if np.prod(sm) < 1e-12:
        return None
    r = um @ vmt
    if np.linalg.det(r) < 0:
        r = -r
        p = -p
    scale = sm.mean()
    t = p[:, 3] / scale
    # Undo 3D normalization: x_cam = r (s (X - c)) + t  =>  t' = t - s r c
    t = t * (1.0 / s)
    t = t - r @ c
    # Cheirality: majority of the points must be in front.
    z = (pts @ r.T + t)[:, 2]
    if (z > 0).sum() < m / 2:
        return None
    return r, t


def initialize_poses(k, cam_ids, lmk_ids, obs, n_cams,
                     min_common=12, pnp_min_pts=8, reproj_gate=8.0,
                     ransac=True, ransac_iters=1000, seed=0, device=None):
    """Bootstrap all camera poses + landmark points from tracks alone.

    k: [fx, fy, cx, cy]; (cam_ids, lmk_ids, obs): the track observations
    build_tracks produces.  Strategy (classical incremental SfM, e.g.
    Hartley & Zisserman ch.10-12 / the bootstrap every BA system assumes):

      1. seed: the adjacent frame pair with the most shared tracks ->
         essential matrix (8-point) -> cheirality-checked (R, t), baseline
         scale := 1, world := first camera of the pair;
      2. repeat: triangulate every track with >= 2 registered views, then
         register the unregistered camera seeing the most triangulated
         points via DLT PnP (gated by reprojection error).

    The triangulations run on `device` (None: the card); the rest is
    numpy.  Returns (cams [n_cams, 6], lmks [n_lmks, 3], cam_ok, lmk_ok) —
    means ready for models/ba.build; unresolved entries are zero with mask
    False.
    """
    k = np.asarray(k, dtype=np.float64)
    cam_ids = np.asarray(cam_ids)
    lmk_ids = np.asarray(lmk_ids)
    obs = np.asarray(obs, dtype=np.float64)
    n_lmks = int(lmk_ids.max()) + 1 if lmk_ids.size else 0
    xn = _to_normalized(obs, k)

    # Per-camera observation table.
    obs_of = [np.flatnonzero(cam_ids == c) for c in range(n_cams)]
    track_of = [dict(zip(lmk_ids[o], o)) for o in obs_of]

    # 1. Seed pair: adjacent pair sharing the most tracks.
    best_pair, best_common = None, -1
    for c in range(n_cams - 1):
        common = np.intersect1d(lmk_ids[obs_of[c]], lmk_ids[obs_of[c + 1]])
        if common.size > best_common:
            best_pair, best_common = (c, c + 1), common.size
    if best_pair is None or best_common < max(min_common, 8):
        raise ValueError("not enough shared tracks to bootstrap a pose pair")
    c0, c1 = best_pair
    common = np.intersect1d(lmk_ids[obs_of[c0]], lmk_ids[obs_of[c1]])
    i0 = np.asarray([track_of[c0][t] for t in common])
    i1 = np.asarray([track_of[c1][t] for t in common])
    f_mean = 0.5 * (k[0] + k[1])
    if ransac:
        e, seed_inl = essential_ransac(
            xn[i0], xn[i1], iters=ransac_iters,
            thresh=max(reproj_gate / 4.0, 1.5) / f_mean, seed=seed)
        i0, i1 = i0[seed_inl], i1[seed_inl]
    else:
        e = essential_8pt(xn[i0], xn[i1])
    r, t, pts, front = decompose_essential(e, xn[i0], xn[i1])
    t = t / max(np.linalg.norm(t), 1e-12)  # gauge: unit baseline

    cams = np.zeros((n_cams, 6))
    cam_ok = np.zeros(n_cams, dtype=bool)
    cams[c0] = 0.0
    cams[c1, :3] = _log(r)
    cams[c1, 3:] = t
    cam_ok[[c0, c1]] = True

    lmks = np.zeros((n_lmks, 3))
    lmk_ok = np.zeros(n_lmks, dtype=bool)

    def _reproj_err(pts3, rows):
        rot = _exp(cams[:, :3])
        ci, li = cam_ids[rows], lmk_ids[rows]
        xc = np.einsum("oij,oj->oi", rot[ci], pts3[li]) + cams[ci, 3:]
        zok = xc[:, 2] > 1e-3
        uv = np.stack([k[0] * xc[:, 0] / np.where(zok, xc[:, 2], 1.0) + k[2],
                       k[1] * xc[:, 1] / np.where(zok, xc[:, 2], 1.0) + k[3]],
                      axis=1)
        err = np.linalg.norm(uv - obs[rows], axis=1)
        return np.where(zok, err, np.inf)

    def retriangulate():
        """Triangulate every track with >= 2 registered views, gating
        per-OBSERVATION: a gross match must cost its observation, not the
        whole landmark (25% outlier rates would otherwise kill nearly every
        multi-view track).  Pass 1 triangulates on all
        registered-view observations and drops those whose reprojection
        error exceeds the gate; pass 2 re-triangulates on the inliers and
        accepts landmarks whose inlier views agree."""
        reg = np.flatnonzero(cam_ok)
        sel = np.isin(cam_ids, reg)
        counts = np.bincount(lmk_ids[sel], minlength=n_lmks)
        sel &= (counts >= 2)[lmk_ids]
        if not sel.any():
            return
        inl = np.flatnonzero(sel)
        # Iterative per-track trimming: one gross observation drags the DLT
        # triangulation so far that EVERY view of the track fails the gate
        # (gating all observations at once then kills ~80% of landmarks at
        # 25% outlier rates).  Instead drop only each landmark's WORST
        # over-gate observation per round and re-triangulate — the outlier
        # is almost always the worst, so clean views survive the rounds.
        pts3 = None
        for _ in range(4):
            pts3 = triangulate(cams, k, cam_ids[inl], lmk_ids[inl], obs[inl],
                               n_lmks=n_lmks, device=device).cpu().numpy()
            err = _reproj_err(pts3, inl)
            order = np.argsort(-err)  # worst first
            li_sorted = lmk_ids[inl][order]
            first = np.zeros(li_sorted.size, dtype=bool)
            _, fidx = np.unique(li_sorted, return_index=True)
            first[fidx] = True  # each landmark's worst observation
            drop = first & (err[order] > reproj_gate)
            if not drop.any():
                break
            keep = np.ones(inl.size, dtype=bool)
            keep[order[drop]] = False
            inl = inl[keep]
            counts2 = np.bincount(lmk_ids[inl], minlength=n_lmks)
            inl = inl[(counts2 >= 2)[lmk_ids[inl]]]
            if inl.size == 0:
                return
        err2 = _reproj_err(pts3, inl)
        bad = np.zeros(n_lmks, dtype=bool)
        np.add.at(bad, lmk_ids[inl[err2 > reproj_gate]], True)
        good = (np.bincount(lmk_ids[inl], minlength=n_lmks) >= 2) & ~bad
        lmks[good] = pts3[good]
        lmk_ok[:] = good

    retriangulate()

    # 2. Incremental registration.
    for _ in range(n_cams):
        cand, cand_n = None, 0
        for c in np.flatnonzero(~cam_ok):
            n = int(lmk_ok[lmk_ids[obs_of[c]]].sum())
            if n > cand_n:
                cand, cand_n = c, n
        if cand is None or cand_n < pnp_min_pts:
            break
        o = obs_of[cand]
        use = lmk_ok[lmk_ids[o]]
        if ransac:
            res = pnp_ransac(xn[o][use], lmks[lmk_ids[o][use]],
                             iters=ransac_iters,
                             thresh=max(reproj_gate / 2.0, 2.0) / f_mean,
                             seed=seed + 1 + cand)
            if res is None:
                break
            r, t = res[0], res[1]
        else:
            res = pnp_dlt(xn[o][use], lmks[lmk_ids[o][use]])
            if res is None:
                break
            r, t = res
        cams[cand, :3] = _log(r)
        cams[cand, 3:] = t
        cam_ok[cand] = True
        retriangulate()

    return cams, lmks, cam_ok, lmk_ok
