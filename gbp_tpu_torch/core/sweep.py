"""GBP configuration, state containers and factor linearization.

Counterpart of the parts of gbp_tpu/core/sweep.py that the component-major
fast path (core/sweep_cm.py) uses.  The generic row-major sweep follows as
ROADMAP A4.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gbp_tpu_torch.core.graph import FactorBlock, Graph


@dataclasses.dataclass(frozen=True)
class GBPConfig:
    """The reference's tuning surface (gbp_tpu.core.sweep.GBPConfig)."""

    eta_damping: float = 0.4
    lam_damping: float = 0.0
    beta: float = 0.01
    num_undamped_iters: int = 6
    min_linear_iters: int = 8
    # Jitter added to cavity precisions before inversion.
    cavity_jitter: float = 0.0
    # Relative cavity floor: cav_lam += floor * diag(belief_lam), the
    # roundoff guard for belief - own_msg cancelling in float32.  None =
    # auto: 1e-5 for float32, 0 for float64.
    cavity_floor: float | None = None


class VariableState(NamedTuple):
    eta: torch.Tensor  # [n, d]
    lam: torch.Tensor  # [n, d, d]
    mean: torch.Tensor  # [n, d]


class FactorState(NamedTuple):
    linpoint: torch.Tensor  # [m, tdof]
    jac: torch.Tensor  # [m, zdim, tdof]
    r0: torch.Tensor  # [m, zdim]
    msg_eta: tuple  # per slot [m, d_k]
    msg_lam: tuple  # per slot [m, d_k, d_k]
    since_relin: torch.Tensor  # [m] int32


class GBPState(NamedTuple):
    v: tuple  # tuple[VariableState]
    f: tuple  # tuple[FactorState]


def linearize_block(fb: FactorBlock, x: torch.Tensor):
    """Linearize all factors of a block at x [m, tdof] -> (jac, r0)."""
    ft = fb.ftype
    h = ft.meas(x, fb.args).to(x.dtype)
    jac = ft.jac(x, fb.args).to(x.dtype)
    return jac, ft.residual(fb.z, h).to(x.dtype)


def gather_linpoint(graph: Graph, state: GBPState, fi: int) -> torch.Tensor:
    """Concatenate adjacent variable means per factor -> [m, tdof]."""
    fb = graph.fblocks[fi]
    parts = [state.v[vb].mean[fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)]
    return torch.cat(parts, dim=-1)


def huber_weight(fb: FactorBlock, r0: torch.Tensor) -> torch.Tensor:
    """Covariance-scaling Huber weight from the linpoint residual [m]:
    w = 2T/M - T^2/M^2 for M > T else 1 (diagonal precision)."""
    if fb.huber is None and fb.huber_arr is None:
        return torch.ones(r0.shape[0], dtype=r0.dtype, device=r0.device)
    m = torch.sqrt(torch.clamp((fb.prec * r0 * r0).sum(-1), min=1e-12))
    t = (fb.huber_arr.to(r0.dtype) if fb.huber_arr is not None
         else torch.tensor(fb.huber, dtype=r0.dtype, device=r0.device))
    w = 2.0 * t / m - (t * t) / (m * m)
    # t == 0 rows (per-factor robustification off) keep weight 1.
    return torch.where((m > t) & (t > 0), w, torch.ones_like(w))


def _cavity_floor(cfg: GBPConfig, dtype) -> float:
    if cfg.cavity_floor is not None:
        return cfg.cavity_floor
    return 1e-5 if dtype == torch.float32 else 0.0


def _kernel_params(cfg: GBPConfig, dtype) -> tuple:
    """The kernels' 7 scalar params (eta_damping, lam_damping, num_undamped,
    floor, beta, min_linear, jitter), each rounded to `dtype` as the
    reference's [7] param vector is."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    vals = (cfg.eta_damping, cfg.lam_damping, cfg.num_undamped_iters,
            _cavity_floor(cfg, dtype), cfg.beta, cfg.min_linear_iters,
            cfg.cavity_jitter)
    return tuple(float(np_dt(v)) for v in vals)
