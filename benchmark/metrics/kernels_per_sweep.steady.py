"""kernels_per_sweep.steady: device operation records a sweep (every kernel,
copy and fill of the replayed chunks), in the back-to-back chunks (traffic
steady)."""
from benchmark.metrics._common import kernels_per_sweep as read  # noqa: F401
