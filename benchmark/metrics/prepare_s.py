"""prepare_s: host seconds of the port's `models.ba.build` and
`core.sweep_cm.prepare` in set-up (a sync after them)."""


def read(r):
    return r.counters.get("prepare_s")
