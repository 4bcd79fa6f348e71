"""What the bundle-adjustment generators share, in NumPy alone: the
Rodrigues map and its inverse (in place of the port's `utils/lie.py`), the
pinhole projection, the landmark filter and initial estimate that close
every generator, and `renoise`, which draws a scene's noise anew from a
run's seed.

Frozen with the generators (`simulate.py`, `simulate_corridor.py`,
`simulate_blocks.py`) from `gbp_tpu_torch/models/ba.py` at commit ad6c174.
A scene is the dict the port's `models.ba.build` takes: cam_truth /
cam_init [n_cams, 6] (angle-axis, translation; world -> camera), lmk_truth /
lmk_init [n, 3], obs [m, 2] pixels, cam_ids / lmk_ids [m], k = [fx, fy, cx,
cy], pix_sigma.
"""
from __future__ import annotations

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: angle-axis [..., 3] -> rotation [..., 3, 3], Taylor near 0."""
    w = np.asarray(w, dtype=np.float64)
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    safe = np.where(small, 1.0, t2)
    th = np.sqrt(safe)
    sinc = np.where(small, 1.0 - t2 / 6.0, np.sin(th) / th)
    cosc = np.where(small, 0.5 - t2 / 24.0, (1.0 - np.cos(th)) / safe)
    k = hat(w)
    return np.eye(3) + sinc[..., None, None] * k + cosc[..., None, None] * (k @ k)


def so3_log(r: np.ndarray) -> np.ndarray:
    """Rotation [..., 3, 3] -> angle-axis [..., 3]."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    th = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    vee = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                    r[..., 1, 0] - r[..., 0, 1]], -1)
    small = np.abs(th) < 1e-4
    scale = np.where(small, 0.5 + th * th / 12.0,
                     th / (2.0 * np.where(small, 1.0, np.sin(th))))
    return scale[..., None] * vee


def hat(w: np.ndarray) -> np.ndarray:
    """[..., 3] -> the skew-symmetric [..., 3, 3]."""
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def visible(xc, k, uv):
    return ((xc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 2 * k[2])
            & (uv[:, 1] > 0) & (uv[:, 1] < 2 * k[3]))


def project(xc, k):
    return np.stack([k[0] * xc[:, 0] / xc[:, 2] + k[2], k[1] * xc[:, 1] / xc[:, 2] + k[3]], 1)


def finish(rng, cams, lmks, obs, cam_ids, lmk_ids, n_lmks, cam_noise, lmk_noise, k, pix_sigma):
    """Keep landmarks seen twice or more, then draw the initial estimate."""
    obs, cam_ids, lmk_ids = np.concatenate(obs), np.concatenate(cam_ids), np.concatenate(lmk_ids)
    keep = np.bincount(lmk_ids, minlength=n_lmks) >= 2
    remap = -np.ones(n_lmks, dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[lmk_ids]
    obs, cam_ids, lmk_ids = obs[sel], cam_ids[sel], remap[lmk_ids[sel]]
    lmks = lmks[keep]
    n_cams = cams.shape[0]
    cam_init = cams + np.concatenate([cam_noise[0] * rng.standard_normal((n_cams, 3)),
                                      cam_noise[1] * rng.standard_normal((n_cams, 3))], 1)
    cam_init[0] = cams[0]  # the gauge anchor starts at its prior
    lmk_init = lmks + lmk_noise * rng.standard_normal(lmks.shape)
    return dict(cam_truth=cams, lmk_truth=lmks, cam_init=cam_init, lmk_init=lmk_init,
                obs=obs, cam_ids=cam_ids, lmk_ids=lmk_ids, k=np.asarray(k, dtype=np.float64),
                pix_sigma=pix_sigma)


def renoise(sim: dict, seed: int, cam_noise, lmk_noise) -> dict:
    """`sim` with its pixel noise and initial estimate drawn anew from
    `seed`: the same cameras, landmarks and visibility (so the same sizes),
    observations = the true projections + pix_sigma N(0, 1), the initial
    estimate = the truth + the generator's noise (camera 0 exact)."""
    rng = np.random.default_rng(seed)
    k, cams, lmks = sim["k"], sim["cam_truth"], sim["lmk_truth"]
    ci, li = np.asarray(sim["cam_ids"]), np.asarray(sim["lmk_ids"])
    xc = np.einsum("oij,oj->oi", so3_exp(cams[:, :3])[ci], lmks[li]) + cams[ci, 3:]
    obs = project(xc, k) + sim["pix_sigma"] * rng.standard_normal((ci.size, 2))
    n = cams.shape[0]
    cam_init = cams + np.concatenate([cam_noise[0] * rng.standard_normal((n, 3)),
                                      cam_noise[1] * rng.standard_normal((n, 3))], 1)
    cam_init[0] = cams[0]
    lmk_init = lmks + lmk_noise * rng.standard_normal(lmks.shape)
    return dict(sim, obs=obs, cam_init=cam_init, lmk_init=lmk_init)
