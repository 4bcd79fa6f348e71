"""What the readers of the port's set-up spans share
(`gbp_tpu_torch.utils.profiling`: `span`, `recorded`): this run's newest
span of a name that ended before the traced window opened.  The port stamps
its spans on the profiler's clock, so they line up with the window.  On a
program without the recorder every reader finds nothing and returns None."""
from __future__ import annotations

from gbp_tpu_torch.utils import profiling


def port_spans() -> list:
    """[(name, start_s, end_s)] the port has recorded, in the order they
    ended; [] where it records none."""
    rec = getattr(profiling, "recorded", None)
    return [(n, a * 1e-9, b * 1e-9) for n, a, b in rec()] if rec else []


def setup_s(r, name: str):
    """Seconds of the newest span `name` that ended before the window
    opened: this run's set-up."""
    if r.trace is None:
        return None
    before = [s for s in port_spans() if s[0] == name and s[2] <= r.trace.window[0]]
    if not before:
        return None
    _, a, b = max(before, key=lambda s: s[2])
    return b - a
