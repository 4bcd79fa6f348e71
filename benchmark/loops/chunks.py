"""Loop kind "chunks": back-to-back replays of one captured chunk of sweeps,
no sync between them.  The host waits only on an event QUEUED_GROUPS
groups back, so the queue does not run dry; the window starts on an empty
queue and ends at the sync after the last replay.  With "restart_chunks"
each group of that many chunks starts again from the initial state: runs
of a fixed budget of sweeps, back to back.

Traffic keys: chunk (sweeps a chunk), group (chunks between events) or
restart_chunks, warm_sweeps, trace_chunks (chunks in a traced window) and
rate_metric (the end-to-end metric the rate is reported under).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import check
from benchmark.device import memory_peak, sync
from benchmark.loops._common import (Outcome, captured, chunk_check, free, port, scene, stage,
                                     window)
from benchmark.reference import gbp
from benchmark.trace import span

# Groups of chunks the host keeps queued ahead of the device: a graph
# launch takes the host 1-2 ms, near a bench64 chunk's 2.2 device ms, so a
# shallow queue runs dry whenever the host is slowed.
QUEUED_GROUPS = 3


def run(cell) -> Outcome:
    tr, cfg = cell.traffic, cell.config
    sim, rows, shapes = scene(cell)
    p = port(cell, sim)
    means = (p.tensor(sim["cam_init"]), p.tensor(sim["lmk_init"]))
    n = int(tr["chunk"])
    start = p.init(means)
    rec = captured(p, start, n)
    rec()
    sync(cell.device)
    stage(cell, "chunk captured")
    restart = int(tr.get("restart_chunks", 0))
    group = restart or int(tr["group"])

    def one_group():
        if restart:
            rec.load(start)  # a device copy, no sync
        for _ in range(group):
            rec()

    for _ in range(-(-int(tr["warm_sweeps"]) // (n * group))):
        one_group()
    sync(cell.device)
    setup_s = time.perf_counter() - cell.t_process
    on_card = cell.device.type == "cuda"

    finite = []  # a device flag per group: its last state is finite

    def body():
        done, events = 0, []
        t0 = time.perf_counter()
        while True:
            with span("replay"):
                one_group()
                finite.append(torch.stack([torch.isfinite(v.mean).all()
                                           for v in rec.state.v]).all())
            done += group
            if on_card:
                events.append(torch.cuda.Event())
                events[-1].record()
                if len(events) > QUEUED_GROUPS:
                    with span("wait"):
                        events[-1 - QUEUED_GROUPS].synchronize()
            if cell.trace:
                if done >= int(tr["trace_chunks"]):
                    return done
            elif time.perf_counter() - t0 >= cell.seconds:
                return done

    window_s, done, trace = window(cell, body)
    peak = memory_peak(cell.device)
    failed = group * int((~torch.stack(finite)).sum())
    # The check, through the window's captured run: the first chunk from the
    # start, and a chunk from a state the window reached: with restarts the
    # last chunk of a run (driven again from the start, it must end on the
    # window's last state bit for bit), else the chunk after the window.
    p_start_next = None
    if restart:
        last = tuple(v.mean.clone() for v in rec.state.v)
        rec.load(start)
        for k in range(group - 1):
            rec()
            if k == 0:
                p_start_next = p.observed(rec.state, rows)
        p_from = p.observed(rec.state, rows)
        rec()
        rerun = [float((a != b).sum()) for a, b in zip(last, (v.mean for v in rec.state.v))]
    else:
        p_from = p.observed(rec.state, rows)
        rec()
        rerun = []
    p_next = p.observed(rec.state, rows)
    if p_start_next is None:
        rec.load(start)
        rec()
        p_start_next = p.observed(rec.state, rows)
    del rec, start
    p.close()
    free(cell)
    pb = gbp.problem(sim, cfg["build"], cell.device)
    sc = gbp.sweep_config(cfg["gbp"], cfg["dtype"])
    f64, tf32 = gbp.Arith("f64"), gbp.Arith("tf32")
    means64 = tuple(t.double() for t in means)
    a = chunk_check(cell, pb, sc, n, p_start_next, gbp.init_state(pb, means64, f64),
                    lambda: gbp.init_state(pb, means64, tf32))
    b = chunk_check(cell, pb, sc, n, p_next, p_from, lambda: gbp.cast(p_from, torch.float32))
    numbers = check.worst(a["gaps"], b["gaps"])
    if restart:
        numbers["rerun_gap"] = sum(rerun)
    sweeps = done * n
    print(f"[bench] rows the reference relinearizes a sweep in the later chunk: {b['relin']}",
          file=sys.stderr, flush=True)
    return Outcome(
        attempted=done, failed=failed, setup_s=setup_s, window_s=window_s, sweeps=sweeps,
        e2e={tr["rate_metric"]: sweeps / window_s},
        counters=dict(prepare_s=p.prepare_s, relin_rows_per_sweep=float(np.mean(b["relin"])),
                      shapes=shapes,
                      control=check.worst(a["control"], b["control"]) if cell.control else None),
        numbers=numbers, memory_peak_bytes=peak, trace=trace)
