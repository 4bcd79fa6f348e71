"""Cameras on an arc around a landmark cloud (the headline BA scene).

A frozen copy of `simulate` in `gbp_tpu_torch/models/ba.py` at commit
ad6c174, with the same `numpy.random.Generator` call order; found by the
name a configuration gives as its "generator".
"""
from __future__ import annotations

import numpy as np

from benchmark.generators._geometry import finish, project, renoise, so3_exp, so3_log, visible  # noqa: F401


def generate(n_cams=12, n_lmks=300, pix_sigma=1.0, radius=10.0, fov_frac=0.7,
             cam_noise=(0.03, 0.08), lmk_noise=0.3, seed=0, k=(500.0, 500.0, 320.0, 240.0)):
    """Cameras on an arc looking at a landmark cloud."""
    rng = np.random.default_rng(seed)
    k = np.asarray(k, dtype=np.float64)
    angles = np.linspace(0, fov_frac * 2 * np.pi, n_cams, endpoint=False)
    centers = np.stack([radius * np.cos(angles), radius * np.sin(angles),
                        1.0 + 0.2 * rng.standard_normal(n_cams)], 1)
    cams = np.zeros((n_cams, 6))
    for i, c in enumerate(centers):
        fwd = -c / np.linalg.norm(c)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        r = np.stack([right, up, fwd], 1).T  # world -> camera
        cams[i, :3] = so3_log(r)
        cams[i, 3:] = -r @ c
    lmks = rng.standard_normal((n_lmks, 3)) * np.array([3.0, 3.0, 1.5])
    obs, cam_ids, lmk_ids = [], [], []
    for i in range(n_cams):
        xc = lmks @ so3_exp(cams[i, :3]).T + cams[i, 3:]
        uv = project(xc, k)
        idx = np.flatnonzero(visible(xc, k, uv))
        obs.append(uv[idx] + pix_sigma * rng.standard_normal((idx.size, 2)))
        cam_ids.append(np.full(idx.size, i))
        lmk_ids.append(idx)
    return finish(rng, cams, lmks, obs, cam_ids, lmk_ids, n_lmks, cam_noise, lmk_noise, k,
                   pix_sigma)
