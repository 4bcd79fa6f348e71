"""idle_share.solve: percent of the traced solve window in which no
operation ran on the device."""
from benchmark.metrics._common import idle_percent as read  # noqa: F401


