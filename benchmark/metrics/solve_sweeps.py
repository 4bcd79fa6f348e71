"""solve_sweeps: the mean sweeps a solve took to reach the target, over
every solve of the traced run (chunks run x sweeps a chunk)."""


def read(r):
    s = r.counters.get("solve_sweeps")
    return sum(s) / len(s) if s else None
