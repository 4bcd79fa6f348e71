"""kernel_ms.steady: device ms a sweep in the port's own kernels (`gbp::`), in
the back-to-back chunks (traffic steady)."""
from benchmark.metrics._common import kernel_ms as read  # noqa: F401
