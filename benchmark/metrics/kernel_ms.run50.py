"""kernel_ms.run50: device ms a sweep in the port's own kernels (`gbp::`), in
the runs of 50 sweeps (traffic restart50)."""
from benchmark.metrics._common import kernel_ms as read  # noqa: F401
