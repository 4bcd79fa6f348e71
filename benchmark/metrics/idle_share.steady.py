"""idle_share.steady: percent of the traced window in which no operation ran on
the device (1 - the union of operation intervals / the window), in the back-
to-back chunks (traffic steady)."""
from benchmark.metrics._common import idle_percent as read  # noqa: F401
