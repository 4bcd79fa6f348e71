"""idle_share.run50: percent of the traced window in which no operation ran on
the device (1 - the union of operation intervals / the window), in the runs
of 50 sweeps (traffic restart50)."""
from benchmark.metrics._common import idle_percent as read  # noqa: F401
