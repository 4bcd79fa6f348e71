"""Pinhole reprojection factor in normalized image coordinates.

Counterpart of `reprojection_normalized` in gbp_tpu/factors/reprojection.py.
State x = [omega (angle-axis, 3), t (3), X (3)] with the camera mapping
world -> camera; h(x) = [Xc.x / Xc.z, Xc.y / Xc.z] with Xc = R(omega) X + t.
The other variants (pixel-space, BAL) follow with BAL input (ROADMAP A7).
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.factors.base import FactorType
from gbp_tpu_torch.utils.lie import hat3, so3_exp
from gbp_tpu_torch.utils.smalllinalg import bmm, bmv

CAM_DOF = 6
LMK_DOF = 3


def _right_jacobian_so3(w):
    """Right Jacobian of SO(3): Jr(w) = I - c1 [w]x + c2 [w]x^2."""
    theta = torch.linalg.norm(w, dim=-1)
    t2 = theta * theta
    small = torch.abs(theta) < 1e-4
    one = torch.ones_like(t2)
    safe_t2 = torch.where(small, one, t2)
    safe_t3 = torch.where(small, one, t2 * theta)
    c1 = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c2 = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    k = hat3(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - c1[..., None, None] * k + c2[..., None, None] * bmm(k, k)


def _cam_point(x):
    """Split x = [omega, t, X]; return (R, Xc = R X + t, X)."""
    w, t, pt = x[..., :3], x[..., 3:6], x[..., 6:9]
    r = so3_exp(w)
    return r, bmv(r, pt) + t, pt


def _safe_z(z, eps=1e-2):
    """Sign-preserving depth floor |z| >= eps: a landmark on or behind the
    camera's z = 0 plane gives a large but finite residual instead of a
    1/z overflow.  The identity for |z| >= eps."""
    return torch.where(z >= 0, torch.clamp(z, min=eps), torch.clamp(z, max=-eps))


def _meas(x, args):
    del args
    _, xc, _ = _cam_point(x)
    return xc[..., :2] / _safe_z(xc[..., 2:3])


def _jac(x, args):
    del args
    r, xc, pt = _cam_point(x)
    inv_z = 1.0 / _safe_z(xc[..., 2])
    zero = torch.zeros_like(inv_z)
    dpi = torch.stack([
        torch.stack([inv_z, zero, -xc[..., 0] * inv_z * inv_z], dim=-1),
        torch.stack([zero, inv_z, -xc[..., 1] * inv_z * inv_z], dim=-1),
    ], dim=-2)
    # d(Xc)/d(omega) = -R [pt]x Jr(omega);  d(Xc)/dt = I;  d(Xc)/dX = R.
    d_omega = -bmm(bmm(r, hat3(pt)), _right_jacobian_so3(x[..., :3]))
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(r.shape)
    return bmm(dpi, torch.cat([d_omega, eye, r], dim=-1))


def reprojection_normalized() -> FactorType:
    """Pinhole reprojection in normalized image coordinates; args = None.

    Measurements are pre-normalized, z = (pixel - principal_point) / focal,
    with sigma = pix_sigma / focal: the same posterior as the pixel-space
    model with O(1/depth) Jacobian entries, which float32 messages need."""
    return FactorType(name="reprojection_normalized", zdim=2, meas_fn=_meas,
                      jac_fn=_jac)


FACTOR_TYPES = {"reprojection_normalized": reprojection_normalized}
