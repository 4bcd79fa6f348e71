"""SE(2) pose-graph factors (odometry and loop closure); counterpart of
gbp_tpu/factors/odometry.py.

Each pose variable is [x, y, theta].  The measurement is the relative pose
T_i^-1 T_j expressed in frame i; the residual wraps its angle component to
[-pi, pi) (`utils.lie.wrap_angle`).  Functions are batched over factors.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.factors.base import FactorType, identity_jac
from gbp_tpu_torch.utils.lie import se2_relative, wrap_angle


def _wrapped_residual(z, z_hat):
    r = z - z_hat
    return torch.cat([r[..., :2], wrap_angle(r[..., 2:3])], dim=-1)


def _between_meas(x, args):
    del args
    return se2_relative(x[..., :3], x[..., 3:])


def _between_jac(x, args):
    """Analytic dh/dx [m, 3, 6] of h = se2_relative(x_i, x_j)."""
    del args
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    dx, dy = x[..., 3] - x[..., 0], x[..., 4] - x[..., 1]
    h0, h1 = c * dx + s * dy, -s * dx + c * dy
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([-c, -s, h1, c, s, zero], dim=-1),
        torch.stack([s, -c, -h0, -s, c, zero], dim=-1),
        torch.stack([zero, zero, -one, zero, zero, one], dim=-1),
    ], dim=-2)


def se2_between() -> FactorType:
    """h([p_i, p_j]) = p_i^-1 * p_j (relative SE(2) pose), zdim = 3."""
    return FactorType(name="se2_between", zdim=3, meas_fn=_between_meas, jac_fn=_between_jac,
                      residual_fn=_wrapped_residual)


def se2_prior() -> FactorType:
    """Unary SE(2) anchor factor h(p) = p with wrapped angle residual."""
    return FactorType(name="se2_prior", zdim=3, meas_fn=lambda x, args: x, jac_fn=identity_jac,
                      residual_fn=_wrapped_residual, linear=True)
