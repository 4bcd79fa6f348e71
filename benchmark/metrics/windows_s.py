"""windows_s: host seconds of this run's `sweep_cm.prepare.windows`: the
camera-window search, the locality sort and relabel, and the windows' CSRs
in the port's prepare (set-up)."""
from benchmark.metrics._spans import setup_s


def read(r):
    return setup_s(r, "sweep_cm.prepare.windows")
