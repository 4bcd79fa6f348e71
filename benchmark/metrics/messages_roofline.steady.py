"""messages_roofline.steady: percent of the HBM roofline that the messages step
reaches, in the back-to-back chunks (traffic steady) (the byte count and the
kernels it divides by: `_rooflines.py`)."""
from benchmark.metrics._rooflines import messages_roofline as read  # noqa: F401
