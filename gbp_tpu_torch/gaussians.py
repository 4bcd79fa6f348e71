"""Information-form Gaussian helpers (counterpart of gbp_tpu/gaussians.py).

Only the piece the component-major sweep needs so far: the packed padding
row for virtual ELL variables.
"""
from __future__ import annotations

import torch


def packed_identity_row(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """One packed (eta | lam | mean) row with eta = 0, lam = I, mean = 0.

    Virtual padding variables carry it, so that the cavity inverses of
    structurally dead factor rows stay finite while contributing nothing."""
    return torch.cat([
        torch.zeros(d, dtype=dtype, device=device),
        torch.eye(d, dtype=dtype, device=device).reshape(-1),
        torch.zeros(d, dtype=dtype, device=device),
    ])
