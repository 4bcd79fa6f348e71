"""SE(3) pose-graph factors (3D odometry / loop closure); counterpart of
gbp_tpu/factors/se3.py.

Each pose is [t (3), omega (3)]: the world pose of frame i as a translation
and an angle-axis rotation R_wi = exp(omega), updated additively.  The
measurement is the relative pose of frame j in frame i,

    h = [R_i^T (t_j - t_i),  log(R_i^T R_j)],

and the residual's rotation block is taken on the manifold, r_w =
log(R(h_w)^T R(z_w)), so it vanishes exactly at h == z and never wraps.
The Jacobian is the analytic one of the component form
(ops/comp_factors.se3_between_comp), in the flat additive-update
convention exp(w + dw) = exp(w) exp(Jr(w) dw).  Batched over factors.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.factors.base import FactorType, identity_jac
from gbp_tpu_torch.utils.lie import so3_exp, so3_log
from gbp_tpu_torch.utils.smalllinalg import bT, bmm, bmv


def _manifold_residual(z, z_hat):
    rt = z[..., :3] - z_hat[..., :3]
    rw = so3_log(bmm(bT(so3_exp(z_hat[..., 3:])), so3_exp(z[..., 3:])))
    return torch.cat([rt, rw], dim=-1)


def _between_meas(x, args):
    del args
    ti, wi, tj, wj = x[..., :3], x[..., 3:6], x[..., 6:9], x[..., 9:12]
    rit = bT(so3_exp(wi))
    return torch.cat([bmv(rit, tj - ti), so3_log(bmm(rit, so3_exp(wj)))], dim=-1)


def _between_jac(x, args):
    """dh/dx [m, 6, 12] through the component-form model."""
    del args
    from gbp_tpu_torch.ops.comp_factors import se3_between_comp

    _, jac = se3_between_comp([x[..., k] for k in range(12)])
    return torch.stack([torch.stack(row, dim=-1) for row in jac], dim=-2)


def se3_between() -> FactorType:
    """h([p_i, p_j]) = relative pose (t_ij, omega_ij) of j in frame i; zdim = 6."""
    return FactorType(name="se3_between", zdim=6, meas_fn=_between_meas, jac_fn=_between_jac,
                      residual_fn=_manifold_residual)


def se3_prior() -> FactorType:
    """Unary SE(3) anchor factor h(p) = p with manifold rotation residual."""
    return FactorType(name="se3_prior", zdim=6, meas_fn=lambda x, args: x, jac_fn=identity_jac,
                      residual_fn=_manifold_residual)
