"""Cameras along a corridor looking at a landmark wall.

A frozen copy of `simulate_corridor` in `gbp_tpu_torch/models/ba.py` at commit
ad6c174, with the same `numpy.random.Generator` call order; found by the
name a configuration gives as its "generator".
"""
from __future__ import annotations

import numpy as np

from benchmark.generators._geometry import finish, project, renoise, so3_log, visible  # noqa: F401


def generate(n_cams=32, lmks_per_cam=40, window=3, step=1.0, wall_dist=4.0,
                      pix_sigma=1.0, cam_noise=(0.02, 0.05), lmk_noise=0.2, seed=0,
                      k=(500.0, 500.0, 320.0, 240.0)):
    """Cameras along a line looking at a landmark wall; a landmark is seen
    only from cameras within +-`window` positions."""
    rng = np.random.default_rng(seed)
    k = np.asarray(k, dtype=np.float64)
    fwd = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r = np.stack([right, up, fwd], 1).T
    w = so3_log(r)
    cams = np.zeros((n_cams, 6))
    for i in range(n_cams):
        cams[i, :3] = w
        cams[i, 3:] = -r @ np.array([i * step, 0.0, 0.0])
    n_lmks = n_cams * lmks_per_cam
    lx = rng.uniform(-step, (n_cams - 1 + 1.0) * step, n_lmks)
    lmks = np.stack([lx, wall_dist + 0.5 * rng.standard_normal(n_lmks),
                     0.8 * rng.standard_normal(n_lmks)], 1)
    obs, cam_ids, lmk_ids = [], [], []
    for i in range(n_cams):
        near = np.flatnonzero(np.abs(lmks[:, 0] - i * step) <= window * step)
        xc = lmks[near] @ r.T + cams[i, 3:]
        uv = project(xc, k)
        vis = visible(xc, k, uv)
        idx = near[vis]
        obs.append(uv[vis] + pix_sigma * rng.standard_normal((idx.size, 2)))
        cam_ids.append(np.full(idx.size, i))
        lmk_ids.append(idx)
    return finish(rng, cams, lmks, obs, cam_ids, lmk_ids, n_lmks, cam_noise, lmk_noise, k,
                   pix_sigma)
