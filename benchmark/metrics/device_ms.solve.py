"""device_ms.solve: device ms a solve in the traced solve window (the busy
union over the solves run): the device's part of a solve, which the host's
speed does not move, beside solve_p95_ms, which it does."""
from benchmark.metrics._common import has_device


def read(r):
    s = r.counters.get("solve_sweeps")
    if not has_device(r) or not s:
        return None
    return 1e3 * r.trace.busy_s() / len(s)
