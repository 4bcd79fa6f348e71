"""Information-form Gaussian helpers (counterpart of gbp_tpu/gaussians.py):
the batched (eta, lam) container, its constructors (from moments, isotropic,
all zeros), Schur marginalization, and the packed padding row for virtual
ELL variables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.utils.smalllinalg import bT, bmm, bmv, scaled_sym_inv, sym_inv, sym_solve


class Gaussian(NamedTuple):
    """Batched information-form Gaussian: eta [..., d], lam [..., d, d]."""

    eta: torch.Tensor
    lam: torch.Tensor

    @property
    def dim(self) -> int:
        return self.eta.shape[-1]

    def mean(self) -> torch.Tensor:
        return sym_solve(self.lam, self.eta)

    def cov(self) -> torch.Tensor:
        return sym_inv(self.lam)


def from_moments(mu: torch.Tensor, sigma: torch.Tensor) -> Gaussian:
    """The Gaussian of mean mu [..., d] and covariance sigma [..., d, d]."""
    lam = sym_inv(sigma)
    return Gaussian(bmv(lam, mu), lam)


def isotropic(mu: torch.Tensor, prec) -> Gaussian:
    """The Gaussian of mean mu [..., d] and precision `prec` times the
    identity (a scalar, or a tensor broadcasting against mu's batch dims)."""
    d = mu.shape[-1]
    prec = torch.as_tensor(prec, dtype=mu.dtype, device=mu.device)
    eye = torch.eye(d, dtype=mu.dtype, device=mu.device)
    return Gaussian(prec[..., None] * mu, prec[..., None, None] * eye)


def zeros(shape, d: int, dtype=torch.float32, device=None) -> Gaussian:
    """An all-zero (uninformative) batch of shape `shape`; device None: the
    card."""
    shape, device = tuple(shape), resolve_device(device)
    return Gaussian(torch.zeros(shape + (d,), dtype=dtype, device=device),
                    torch.zeros(shape + (d, d), dtype=dtype, device=device))


def marginalize(eta, lam, keep_start: int, keep_dim: int) -> Gaussian:
    """Marginalize a joint information-form Gaussian (eta [..., t], lam
    [..., t, t]) onto the contiguous block [keep_start, keep_start +
    keep_dim) by the Schur complement:

        lam_m = lam_aa - lam_ab lam_bb^-1 lam_ba
        eta_m = eta_a - lam_ab lam_bb^-1 eta_b
    """
    t = eta.shape[-1]
    ks, kd = keep_start, keep_dim
    if t == kd:
        return Gaussian(eta, lam)
    perm = list(range(ks, ks + kd)) + [i for i in range(t) if not ks <= i < ks + kd]
    eta_p = eta[..., perm]
    lam_p = lam[..., perm, :][..., :, perm]
    eta_a, eta_b = eta_p[..., :kd], eta_p[..., kd:]
    lam_aa, lam_ab, lam_bb = lam_p[..., :kd, :kd], lam_p[..., :kd, kd:], lam_p[..., kd:, kd:]
    w = bmm(lam_ab, scaled_sym_inv(lam_bb, t - kd))  # [..., kd, t - kd]
    return Gaussian(eta_a - bmv(w, eta_b), lam_aa - bmm(w, bT(lam_ab)))


def packed_identity_row(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """One packed (eta | lam | mean) row with eta = 0, lam = I, mean = 0.

    Virtual padding variables carry it, so that the cavity inverses of
    structurally dead factor rows stay finite while contributing nothing."""
    return torch.cat([
        torch.zeros(d, dtype=dtype, device=device),
        torch.eye(d, dtype=dtype, device=device).reshape(-1),
        torch.zeros(d, dtype=dtype, device=device),
    ])
