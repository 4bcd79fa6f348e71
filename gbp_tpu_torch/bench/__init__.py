"""Benchmark and profiling scripts of the port, and what they share: the
large scenes' arguments, the sweep configuration and the card's name line."""
from __future__ import annotations

import subprocess

from gbp_tpu_torch.core.sweep import GBPConfig

CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
# `models.ba.simulate_blocks` arguments: shuffled landmark ids, so the camera
# windows engage only through the locality sort.
CITY = dict(n_blocks=32, n_cams=40, lmks_per_cam=60, window=3, seed=0, shuffle=True)
VENICE = dict(n_blocks=256, n_cams=40, lmks_per_cam=80, window=3, seed=1, shuffle=True)
# `models.ba.build` arguments of the large scenes.
BIG_BUILD = dict(layout="ell", cam_prior_prec=1000.0, lmk_prior_prec=1000.0)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
