"""kernels_per_sweep.run50: device operation records a sweep (every kernel,
copy and fill of the replayed chunks), in the runs of 50 sweeps (traffic
restart50)."""
from benchmark.metrics._common import kernels_per_sweep as read  # noqa: F401
