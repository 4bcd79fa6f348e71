"""Benchmark and profiling scripts of the port, and what they share: the
large scenes' arguments, the sweep configuration, the card's name line and
the kernels a run went through.  `python -m gbp_tpu_torch.bench` is the
headline benchmark (`headline.py`)."""
from __future__ import annotations

import subprocess

import numpy as np

from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.ops.messages import COUNTS

CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
# `models.ba.simulate_blocks` arguments: shuffled landmark ids, so the camera
# windows engage only through the locality sort.
CITY = dict(n_blocks=32, n_cams=40, lmks_per_cam=60, window=3, seed=0, shuffle=True)
VENICE = dict(n_blocks=256, n_cams=40, lmks_per_cam=80, window=3, seed=1, shuffle=True)
# `models.ba.build` arguments of the large scenes.
BIG_BUILD = dict(layout="ell", cam_prior_prec=1000.0, lmk_prior_prec=1000.0)


def dense_cameras(sim: dict, keep_every: int = 4) -> dict:
    """A BA scene with more cameras than landmarks, so that the ELL layout
    groups by camera and gathers the landmarks (the cameras in the ELL
    slot): the scene `sim` (a `models.ba` simulation dict) with its
    landmarks ordered by their lowest observing camera, every
    `keep_every`-th of them kept (and the first landmark of a camera that
    would see none) and numbered in that order, so that on a corridor-like
    scene the landmark windows engage in the natural camera order.  Numpy in, numpy out: the same scene for both packages."""
    lowest = np.full(sim["lmk_init"].shape[0], np.iinfo(np.int64).max)
    np.minimum.at(lowest, sim["lmk_ids"], sim["cam_ids"])
    order = np.argsort(lowest, kind="stable")
    keep = np.zeros(lowest.size, dtype=bool)
    keep[order[::keep_every]] = True
    # A camera left without a landmark keeps its first observed one.
    seen = np.zeros(sim["cam_init"].shape[0], dtype=bool)
    seen[sim["cam_ids"][keep[sim["lmk_ids"]]]] = True
    first = np.unique(sim["cam_ids"], return_index=True)[1]
    keep[sim["lmk_ids"][first[~seen[sim["cam_ids"][first]]]]] = True
    kept = order[keep[order]]
    new_id = np.full(lowest.size, -1)
    new_id[kept] = np.arange(kept.size)
    sel = new_id[sim["lmk_ids"]] >= 0
    n_cams = sim["cam_init"].shape[0]
    out = dict(sim, obs=sim["obs"][sel], cam_ids=sim["cam_ids"][sel],
               lmk_ids=new_id[sim["lmk_ids"][sel]], lmk_truth=sim["lmk_truth"][kept],
               lmk_init=sim["lmk_init"][kept])
    if np.bincount(out["cam_ids"], minlength=n_cams).min() < 1 or kept.size >= n_cams:
        raise ValueError("a camera sees no kept landmark, or the cameras do not outnumber them")
    return out


# The cameras-in-ELL scene: 16 blocks of 40 cameras (640 cameras), a quarter
# of their landmarks kept.
DENSE_BLOCKS = dict(n_blocks=16, n_cams=40, lmks_per_cam=3, window=3, seed=0)


def bal_scene(sim: dict, seed: int = 0) -> dict:
    """A synthetic BAL problem (the `io.bal.to_sim` dict) on the geometry of
    a `models.ba` simulation: its cameras turned to the BAL convention (the
    camera looks along its -z, so the pose's frame is flipped about x), the
    truth reprojected through the BAL camera model (p = -P[:2] / P[2], then
    f (1 + k1 |p|^2 + k2 |p|^4) p, pixels) with per-camera focal lengths
    and distortion drawn from `seed` with numpy, the same visibility, and
    the simulation's initial estimate (intrinsics 1 % off in focal)."""
    import torch

    from gbp_tpu_torch.utils.lie import so3_exp, so3_log

    rng = np.random.default_rng(seed)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64))

    def turned(cams):
        rot = flip @ so3_exp(torch.as_tensor(cams[:, :3], dtype=torch.float64))
        return np.concatenate([so3_log(rot).numpy(), cams[:, 3:] * [1.0, -1.0, -1.0]], 1), rot

    cams, rot = turned(np.asarray(sim["cam_truth"], dtype=np.float64))
    cam_ids, lmk_ids = np.asarray(sim["cam_ids"]), np.asarray(sim["lmk_ids"])
    n_cams = cams.shape[0]
    intr = np.stack([500.0 * (1 + 0.02 * rng.standard_normal(n_cams)),
                     0.01 * rng.standard_normal(n_cams), 0.001 * rng.standard_normal(n_cams)], 1)
    pts = np.asarray(sim["lmk_truth"], dtype=np.float64)
    p_cam = np.einsum("oij,oj->oi", rot.numpy()[cam_ids], pts[lmk_ids]) + cams[cam_ids, 3:]
    p = -p_cam[:, :2] / p_cam[:, 2:]
    r2 = (p * p).sum(1, keepdims=True)
    f, k1, k2 = (intr[cam_ids, j:j + 1] for j in range(3))
    obs = f * (1 + k1 * r2 + k2 * r2 * r2) * p + rng.standard_normal(p.shape)
    return dict(cam_init=turned(np.asarray(sim["cam_init"], dtype=np.float64))[0],
                cam_truth=cams, lmk_init=np.asarray(sim["lmk_init"], dtype=np.float64),
                lmk_truth=pts, obs=obs, cam_ids=cam_ids, lmk_ids=lmk_ids,
                intrinsics=intr * np.array([1.01, 1.0, 1.0]), pix_sigma=1.0)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernels_used() -> list:
    """The kernels (`ops.messages.KERNELS` names) whose wrappers ran since
    `COUNTS.reset()`: launched on the card, or their plain versions on the
    CPU.  Under a capture a wrapper runs at the warm-up and the capture
    only, so this names the kernels, not how often a replay launches them."""
    return [k for k in COUNTS.kernel if COUNTS.kernel[k] or COUNTS.plain[k]]
