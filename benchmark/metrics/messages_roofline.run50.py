"""messages_roofline.run50: percent of the HBM roofline that the messages step
reaches, in the runs of 50 sweeps (traffic restart50) (the byte count and
the kernels it divides by: `_rooflines.py`)."""
from benchmark.metrics._rooflines import messages_roofline as read  # noqa: F401
