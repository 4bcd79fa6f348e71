"""gbp-tpu's engine in PyTorch with hand-written CUDA kernels for Hopper.

A second package beside `gbp_tpu/` (the JAX reference, which stays as it
is).  Ported so far: the bundle-adjustment fast path, from the 64-camera
bench scene (camera table in shared memory) to city and venice scenes
(per-tile camera windows after the locality sort) and scenes without camera
locality (expanded operands), pose-graph SLAM on the same fast path (SE(2)
and SE(3), `python -m gbp_tpu_torch.slam`), the generic row-major engine
with the dense oracle for every other graph, and owner-sharded halo
partitions of a graph run through the halo exchange (`parallel.halo`,
`parallel.halo_cm`; `--n_chips` on both command lines), and the wildfire,
priority, random and partition-dropout schedules on all four engines
(`core.schedules`, `parallel.schedules`), and the online model with its
fixed-lag serving loop (`models.online`, `bench.serving`, each frame one
CUDA-graph replay on the card), checkpoint / resume and profiling
(`utils.checkpoint`, `utils.profiling`), and structure from motion from
rendered pixels (`frontend`, `examples.sfm_from_pixels`):

    from gbp_tpu_torch.models import ba, online, pose_graph, toy
    from gbp_tpu_torch.io import g2o
    from gbp_tpu_torch.core import oracle, sweep, sweep_cm
    from gbp_tpu_torch.core.sweep import GBPConfig
    from gbp_tpu_torch.parallel import halo, halo_cm, schur
    from gbp_tpu_torch.core import schedules
    from gbp_tpu_torch.parallel import schedules

`sweep_cm.prepare(graph)` returns None for a graph the fast path does not
take; run `sweep.run` on it then.

Entry points that build tensors (`GraphBuilder`, `models.ba.build`,
`interop.*_from_numpy`, the bench scripts) take `device=None`, which means
`default_device()`: the card, or a RuntimeError when there is none.  Pass
`device="cpu"` to run on the CPU.  Tensors on a CUDA device go through the
kernels in `csrc/`; tensors on the CPU go through each kernel's plain
PyTorch version (ops/messages.py).
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


def default_device() -> torch.device:
    """The device the port's entry points build on when the caller names
    none: the CUDA card.  Raises when there is no card: nothing moves to
    the CPU on its own; ask for it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gbp_tpu_torch: no CUDA device is present (torch.cuda.is_available() is "
            "False) and no device was asked for; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)


__version__ = "0.1.0"
