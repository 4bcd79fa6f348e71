"""sweep_roofline.steady: percent of the HBM roofline that a whole sweep
reaches over the traced window, in the back-to-back chunks (traffic steady)
(the byte count: `_rooflines.py`)."""
from benchmark.metrics._rooflines import sweep_roofline as read  # noqa: F401
