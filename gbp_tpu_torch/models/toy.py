"""1D line-fitting toy problem (counterpart of gbp_tpu/models/toy.py): a
chain of scalar "height" variables with smoothness (displacement) factors
and noisy unary measurements.  GBP is exact here: the converged means equal
the dense MAP solution to machine precision.
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch.core.graph import GraphBuilder
from gbp_tpu_torch.factors import linear


def simulate(n=50, obs_sigma=0.3, smooth_sigma=0.1, seed=0):
    """Smooth 1D signal + noisy observations (numpy, as the reference's)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 4 * np.pi, n)
    truth = np.sin(xs) + 0.3 * xs
    obs = truth + obs_sigma * rng.standard_normal(n)
    return dict(truth=truth, obs=obs, obs_sigma=obs_sigma, smooth_sigma=smooth_sigma)


def build(sim: dict, prior_prec=1e-4, dtype=torch.float32, device=None):
    """Build the toy graph on `device` (None: the card); returns (graph,
    init_means)."""
    obs = np.asarray(sim["obs"], dtype=np.float64)
    n = obs.shape[0]
    b = GraphBuilder(dtype=dtype, device=device)
    v = b.add_variables("height", np.zeros((n, 1)), prior_prec=prior_prec)
    b.add_factors("obs", linear.observation(1), [(v, np.arange(n))], obs[:, None],
                  sigma=sim["obs_sigma"])
    b.add_factors("smooth", linear.displacement(1),
                  [(v, np.arange(n - 1)), (v, np.arange(1, n))],
                  np.zeros((n - 1, 1)), sigma=sim["smooth_sigma"])
    return b.build()
