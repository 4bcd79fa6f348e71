"""SO(3) helpers in torch, batched over leading dims.

Counterpart of the SO(3) part of gbp_tpu/utils/lie.py: the same Taylor
guards around theta ~ 0 and the same `stable_acos`, so f64 results agree
with the reference to roundoff (near theta = pi too, where so3_log divides
by sin(theta)).
"""
from __future__ import annotations

import math

import torch

from gbp_tpu_torch.utils.smalllinalg import bmm


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
    """(sin t / t, (1 - cos t) / t^2) from t2 = theta^2, Taylor near 0."""
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    return sinc, cosc


def so3_exp(w):
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    sinc, cosc = _theta_coeffs((w * w).sum(-1))
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
