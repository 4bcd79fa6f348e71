"""Linear factor types (counterpart of gbp_tpu/factors/linear.py): exactness
checks and toy problems.  On graphs built purely from linear factors GBP is
exact at convergence, which the tests use as their strongest invariant.
The functions are batched over factors: x [m, tdof].
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.factors.base import FactorType


def _eye_rows(x, dof):
    return torch.eye(dof, dtype=x.dtype, device=x.device).expand(x.shape[0], dof, dof)


def displacement(dof: int) -> FactorType:
    """h([x_i, x_j]) = x_j - x_i  (the displacement between two variables)."""

    def meas(x, args):
        del args
        return x[..., dof:] - x[..., :dof]

    def jac(x, args):
        del args
        eye = _eye_rows(x, dof)
        return torch.cat([-eye, eye], dim=-1)

    return FactorType(name=f"displacement{dof}", zdim=dof, meas_fn=meas, jac_fn=jac, linear=True)


def observation(dof: int) -> FactorType:
    """Unary direct observation h(x) = x (a soft anchor / GPS-style factor)."""

    def meas(x, args):
        del args
        return x

    def jac(x, args):
        del args
        return _eye_rows(x, dof)

    return FactorType(name=f"observation{dof}", zdim=dof, meas_fn=meas, jac_fn=jac, linear=True)


def height_1d() -> FactorType:
    """1D line-fitting style unary measurement of a scalar variable."""
    return observation(1)
