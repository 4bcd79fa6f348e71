"""What the per-layer readers share: the traced window's per-sweep
arithmetic and the table of peaks."""
from __future__ import annotations

from benchmark.trace import is_port_kernel


def has_device(r) -> bool:
    """A traced window in which some operation ran on the device."""
    return r.trace is not None and r.trace.count() > 0 and r.sweeps > 0


def idle_percent(r):
    if not has_device(r):
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def sym(d: int) -> int:
    """Values a symmetric d x d matrix needs."""
    return d * (d + 1) // 2


def glue_ms(r):
    """Device ms a sweep in operations outside the port's own kernels."""
    if not has_device(r):
        return None
    return 1e3 * r.trace.device_s(lambda name: not is_port_kernel(name)) / r.sweeps


def kernel_ms(r):
    """Device ms a sweep in the port's own kernels (`gbp::`)."""
    if not has_device(r):
        return None
    return 1e3 * r.trace.device_s(is_port_kernel) / r.sweeps


def kernels_per_sweep(r):
    """Device operation records a sweep."""
    if not has_device(r):
        return None
    return r.trace.count() / r.sweeps
