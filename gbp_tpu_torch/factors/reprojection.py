"""Pinhole reprojection factors for bundle adjustment.

Counterpart of gbp_tpu/factors/reprojection.py.  State x = [omega
(angle-axis, 3), t (3), X (3)] with the camera mapping world -> camera,
Xc = R(omega) X + t.  Four variants:

  * `reprojection()`: pixel space, shared pinhole intrinsics K = [fx, fy,
    cx, cy] as per-factor args;
  * `reprojection_normalized()`: normalized image coordinates, no args;
  * `bal_reprojection()`: the BAL convention (p = -Xc.xy / Xc.z, radial
    distortion) in pixels, args [f, k1, k2] per factor;
  * `bal_reprojection_normalized()`: the same divided by the focal, args
    [k1, k2];
  * `bal_reprojection_intrinsics()`: the 9-dof BAL camera [omega, t, rf, k1,
    k2] in the state (rf = f / f0), measurements divided by f0, no args.

Every variant has an analytic Jacobian (the reference differentiates the
BAL models with jacfwd; the port has no batched autodiff on its hot path),
built from d(R(w)p)/dw = -R [p]x Jr(w) and the distortion chain rule.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.factors.base import FactorType
from gbp_tpu_torch.utils.lie import hat3, so3_exp
from gbp_tpu_torch.utils.smalllinalg import bmm, bmv

CAM_DOF = 6
LMK_DOF = 3
CAM_INTR_DOF = 9  # [omega, t, rf, k1, k2] for bal_reprojection_intrinsics


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


def _cam_point(w, t, pt):
    """(R, Xc = R X + t) of the camera (w, t) and the point X."""
    r = so3_exp(w)
    return r, bmv(r, pt) + t


def _safe_z(z, eps=1e-2):
    """Sign-preserving depth floor |z| >= eps: a landmark on or behind the
    camera's z = 0 plane gives a large but finite residual instead of a
    1/z overflow.  The identity for |z| >= eps."""
    return torch.where(z >= 0, torch.clamp(z, min=eps), torch.clamp(z, max=-eps))


def _dxc(w, r, pt):
    """d(Xc)/d(omega, t, X) [..., 3, 9]: -R [X]x Jr(omega) | I | R."""
    d_omega = -bmm(bmm(r, hat3(pt)), _right_jacobian_so3(w))
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape)
    return torch.cat([d_omega, eye, r], dim=-1)


def _rows2(a, b):
    """[..., 2, n] from two [..., n] rows."""
    return torch.stack([a, b], dim=-2)


def _dpi(xc, sign):
    """d(sign * Xc.xy / Xc.z)/d(Xc) [..., 2, 3] (1/z floored as in _safe_z)."""
    inv_z = 1.0 / _safe_z(xc[..., 2])
    zero = torch.zeros_like(inv_z)
    return _rows2(torch.stack([sign * inv_z, zero, -sign * xc[..., 0] * inv_z * inv_z], dim=-1),
                  torch.stack([zero, sign * inv_z, -sign * xc[..., 1] * inv_z * inv_z], dim=-1))


def _bal_projection(xc, k1, k2):
    """BAL projection p = -Xc.xy / Xc.z and its distortion: (p [..., 2],
    r2, dist = 1 + k1 r2 + k2 r2^2, dh/dp [..., 2, 2] of h = dist * p)."""
    p = -xc[..., :2] / _safe_z(xc[..., 2:3])
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    dist = 1.0 + r2 * (k1 + k2 * r2)
    ddist = (k1 + 2.0 * k2 * r2)[..., None, None]
    eye = torch.eye(2, dtype=p.dtype, device=p.device)
    dh_dp = dist[..., None, None] * eye + 2.0 * ddist * p[..., :, None] * p[..., None, :]
    return p, r2, dist, dh_dp


def _split9(x):
    return x[..., :3], x[..., 3:6], x[..., 6:9]


def reprojection() -> FactorType:
    """Pinhole reprojection in pixels; args = K as [fx, fy, cx, cy]."""

    def meas(x, k):
        _, xc = _cam_point(*_split9(x))
        inv_z = 1.0 / _safe_z(xc[..., 2])
        return torch.stack([k[..., 0] * xc[..., 0] * inv_z + k[..., 2],
                            k[..., 1] * xc[..., 1] * inv_z + k[..., 3]], dim=-1)

    def jac(x, k):
        w, t, pt = _split9(x)
        r, xc = _cam_point(w, t, pt)
        return k[..., :2, None] * bmm(_dpi(xc, 1.0), _dxc(w, r, pt))

    return FactorType(name="reprojection", zdim=2, meas_fn=meas, jac_fn=jac)


def _meas_normalized(x, args):
    del args
    _, xc = _cam_point(*_split9(x))
    return xc[..., :2] / _safe_z(xc[..., 2:3])


def _jac_normalized(x, args):
    del args
    w, t, pt = _split9(x)
    r, xc = _cam_point(w, t, pt)
    return bmm(_dpi(xc, 1.0), _dxc(w, r, pt))


def reprojection_normalized() -> FactorType:
    """Pinhole reprojection in normalized image coordinates; args = None.

    Measurements are pre-normalized, z = (pixel - principal_point) / focal,
    with sigma = pix_sigma / focal: the same posterior as the pixel-space
    model with O(1/depth) Jacobian entries, which float32 messages need."""
    return FactorType(name="reprojection_normalized", zdim=2, meas_fn=_meas_normalized,
                      jac_fn=_jac_normalized)


def bal_reprojection() -> FactorType:
    """The BAL measurement model in pixels; args = [f, k1, k2] per factor:
    h = f * (1 + k1 r^2 + k2 r^4) * p, p = -Xc.xy / Xc.z."""

    def meas(x, cam):
        _, xc = _cam_point(*_split9(x))
        p, _, dist, _ = _bal_projection(xc, cam[..., 1], cam[..., 2])
        return (cam[..., 0] * dist)[..., None] * p

    def jac(x, cam):
        w, t, pt = _split9(x)
        r, xc = _cam_point(w, t, pt)
        _, _, _, dh_dp = _bal_projection(xc, cam[..., 1], cam[..., 2])
        return cam[..., 0, None, None] * bmm(bmm(dh_dp, _dpi(xc, -1.0)), _dxc(w, r, pt))

    return FactorType(name="bal_reprojection", zdim=2, meas_fn=meas, jac_fn=jac)


def bal_reprojection_normalized() -> FactorType:
    """The BAL model in normalized coordinates; args = [k1, k2]: h = (1 + k1
    r^2 + k2 r^4) * p with measurements divided by the per-camera focal
    (z = pixel / f, sigma = pix_sigma / f)."""

    def meas(x, dist_k):
        _, xc = _cam_point(*_split9(x))
        p, _, dist, _ = _bal_projection(xc, dist_k[..., 0], dist_k[..., 1])
        return dist[..., None] * p

    def jac(x, dist_k):
        w, t, pt = _split9(x)
        r, xc = _cam_point(w, t, pt)
        _, _, _, dh_dp = _bal_projection(xc, dist_k[..., 0], dist_k[..., 1])
        return bmm(bmm(dh_dp, _dpi(xc, -1.0)), _dxc(w, r, pt))

    return FactorType(name="bal_reprojection_normalized", zdim=2, meas_fn=meas, jac_fn=jac)


def bal_reprojection_intrinsics() -> FactorType:
    """The BAL model with the per-camera intrinsics in the state; args = None.

    x = [omega (3), t (3), rf, k1, k2 | X (3)], rf = f / f0 relative to the
    file's focal f0, measurements divided by f0:
    h = rf * (1 + k1 r^2 + k2 r^4) * p.  The Jacobian is [2, 12] with the
    intrinsics columns at 6..8."""

    def split(x):
        return x[..., :3], x[..., 3:6], x[..., 6], x[..., 7], x[..., 8], x[..., 9:12]

    def meas(x, args):
        del args
        w, t, rf, k1, k2, pt = split(x)
        _, xc = _cam_point(w, t, pt)
        p, _, dist, _ = _bal_projection(xc, k1, k2)
        return (rf * dist)[..., None] * p

    def jac(x, args):
        del args
        w, t, rf, k1, k2, pt = split(x)
        r, xc = _cam_point(w, t, pt)
        p, r2, dist, dh_dp = _bal_projection(xc, k1, k2)
        d_pose_pt = rf[..., None, None] * bmm(bmm(dh_dp, _dpi(xc, -1.0)), _dxc(w, r, pt))
        d_intr = torch.stack([dist[..., None] * p, (rf * r2)[..., None] * p,
                              (rf * r2 * r2)[..., None] * p], dim=-1)
        return torch.cat([d_pose_pt[..., :6], d_intr, d_pose_pt[..., 6:]], dim=-1)

    return FactorType(name="bal_reprojection_intrinsics", zdim=2, meas_fn=meas, jac_fn=jac)


FACTOR_TYPES = {
    "reprojection": reprojection,
    "reprojection_normalized": reprojection_normalized,
    "bal_reprojection": bal_reprojection,
    "bal_reprojection_normalized": bal_reprojection_normalized,
    "bal_reprojection_intrinsics": bal_reprojection_intrinsics,
}
