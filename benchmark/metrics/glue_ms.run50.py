"""glue_ms.run50: device ms a sweep in operations outside the port's own
kernels (PyTorch glue: packing, the ELL sum, the belief solve, copies), in
the runs of 50 sweeps (traffic restart50)."""
from benchmark.metrics._common import glue_ms as read  # noqa: F401
