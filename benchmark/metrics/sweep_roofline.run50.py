"""sweep_roofline.run50: percent of the HBM roofline that a whole sweep reaches
over the traced window, in the runs of 50 sweeps (traffic restart50) (the
byte count: `_rooflines.py`)."""
from benchmark.metrics._rooflines import sweep_roofline as read  # noqa: F401
