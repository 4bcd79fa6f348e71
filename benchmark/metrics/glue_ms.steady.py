"""glue_ms.steady: device ms a sweep in operations outside the port's own
kernels (PyTorch glue: packing, the ELL sum, the belief solve, copies), in
the back-to-back chunks (traffic steady)."""
from benchmark.metrics._common import glue_ms as read  # noqa: F401
