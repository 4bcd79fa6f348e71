"""SO(3) / SE(3) / SE(2) helpers in torch, batched over leading dims.

Counterpart of gbp_tpu/utils/lie.py: the same Taylor guards around
theta ~ 0, the same `stable_acos` and the same floor-form `wrap_angle`, so
f64 results agree with the reference to roundoff (near theta = pi too,
where so3_log divides by sin(theta)).
"""
from __future__ import annotations

import math

import torch

from gbp_tpu_torch.utils.smalllinalg import bmm, bmv


def hat3(w):
    """so(3) hat: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _theta_coeffs(t2):
    """(sin t / t, (1 - cos t) / t^2, (1 - sinc) / t^2) from t2 = theta^2,
    Taylor near 0."""
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    cc = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - sinc) / safe_t2)
    return sinc, cosc, cc


def so3_exp(w):
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    sinc, cosc, _ = _theta_coeffs((w * w).sum(-1))
    k = hat3(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + sinc[..., None, None] * k + cosc[..., None, None] * bmm(k, k)


def stable_acos(c):
    """arccos(clip(c, -1, 1)) by three Newton steps from a series seed.

    The same function as gbp_tpu.utils.lie.stable_acos (a few ulp in f64),
    kept so that so3_log follows the reference's rounding near theta = pi."""
    a = torch.abs(torch.clamp(c, -1.0, 1.0))
    s = torch.sqrt(torch.clamp((1.0 - a) * (1.0 + a), min=0.0))

    def asin_series(t):
        t2 = t * t
        return t * (1.0 + t2 * (1.0 / 6.0 + t2 * (3.0 / 40.0 + t2 * (15.0 / 336.0))))

    near1 = a >= 0.7071067811865476
    th = torch.where(near1, asin_series(s), 0.5 * math.pi - asin_series(a))
    for _ in range(3):
        sin_t, cos_t = torch.sin(th), torch.cos(th)
        th = torch.where(near1, th - (sin_t - s) / cos_t, th + (cos_t - a) / sin_t)
    return torch.where(c < 0, math.pi - th, th)


def so3_log(r):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    theta = stable_acos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    vee = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]],
        dim=-1,
    )
    # vee = 2 sin(theta) * axis; w = theta * axis.
    small = torch.abs(theta) < 1e-4
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(theta), torch.sin(theta))),
    )
    return scale[..., None] * vee


def _left_jacobian(w):
    """V(w) = I + cosc [w]x + cc [w]x^2 (the SO(3) left Jacobian)."""
    _, cosc, cc = _theta_coeffs((w * w).sum(-1))
    k = hat3(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + cosc[..., None, None] * k + cc[..., None, None] * bmm(k, k)


def se3_exp(xi):
    """se(3) twist [..., 6] (rho, omega) -> (R [..., 3, 3], t [..., 3])."""
    rho, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), bmv(_left_jacobian(w), rho)


def se3_log(r, t):
    """(R, t) -> twist [..., 6] (rho, omega)."""
    w = so3_log(r)
    rho = bmv(torch.linalg.inv(_left_jacobian(w)), t)
    return torch.cat([rho, w], dim=-1)


def transform_point(w_t, x):
    """Apply pose [..., 6] = (omega, trans) to world point [..., 3]: R x + t
    (the BA camera convention: world -> camera frame)."""
    return bmv(so3_exp(w_t[..., :3]), x) + w_t[..., 3:]


# --- SE(2) -----------------------------------------------------------------


def se2_compose(a, b):
    """Compose SE(2) poses [..., 3] = (x, y, theta): a then b (a * b)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, a[..., 2] + b[..., 2]], dim=-1)


def se2_relative(a, b):
    """Relative pose a^-1 * b for SE(2) poses [..., 3] (x, y, theta)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack([ca * dx + sa * dy, -sa * dx + ca * dy, b[..., 2] - a[..., 2]], dim=-1)


def wrap_angle(theta):
    """Wrap to [-pi, pi), in the reference's floor form (not atan2(sin,
    cos)): theta - 2 pi floor((theta + pi) / (2 pi)).  The generic engine,
    the kernels' plain versions and the CUDA kernels (csrc/comp_factors.cuh)
    all evaluate this one formula in this order, so a residual near +-pi
    wraps the same way everywhere."""
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor((theta + math.pi) / two_pi)
