"""gbp-tpu's engine in PyTorch with hand-written CUDA kernels for Hopper.

A second package beside `gbp_tpu/` (the JAX reference, which stays as it
is).  The first slice is the bundle-adjustment fast path:

    from gbp_tpu_torch.models import ba
    from gbp_tpu_torch.core import sweep_cm
    from gbp_tpu_torch.core.sweep import GBPConfig
    from gbp_tpu_torch.parallel import schur

Tensors on a CUDA device go through the kernels in `csrc/`; tensors on the
CPU go through each kernel's plain PyTorch version (ops/messages.py).
"""
from __future__ import annotations

import torch


def set_exact_f32() -> None:
    """Run float32 products in full float32 (no TF32) on the card.

    The counterpart of gbp_tpu.core.sweep.f32_exact.  The engine's
    small-matrix algebra is cancellation-heavy; TF32 keeps about three
    decimal digits.  Entry points call this; importing the package does not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


__version__ = "0.1.0"
