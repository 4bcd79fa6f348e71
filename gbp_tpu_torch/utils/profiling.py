"""Profiling and timing helpers (counterpart of gbp_tpu/utils/profiling.py,
whose traces are jax.profiler's): a `torch.profiler` trace, the sweep rate of
a run function, and the port's set-up spans.

Spans time the set-up steps that run once per prepared graph or capture:

    with span("capture.capture"):
        ...
    recorded()  # [(name, start_ns, end_ns)], as they ended
    reset()     # forget them

A span records every time it runs (two clock reads and an append), so none
sits on the path a sweep or a solve repeats.  The newest `SPAN_CAPACITY`
spans are kept in memory.  Stamps are `time.time_ns()`, Unix nanoseconds,
the clock of the profiler's own events (`_KinetoEvent.start_ns()`), so a
span lines up with a trace taken in the same process.  A span emits nothing
into that trace: no `record_function`, NVTX range, CUDA event or
synchronization.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from gbp_tpu_torch import resolve_device

SPAN_CAPACITY = 65536

_spans = collections.deque(maxlen=SPAN_CAPACITY)


@contextlib.contextmanager
def span(name: str):
    """Record the block as the span `name` (see the module docstring)."""
    start = time.time_ns()
    try:
        yield
    finally:
        _spans.append((name, start, time.time_ns()))


def recorded() -> list:
    """The kept spans in the order they ended: (name, start_ns, end_ns)."""
    return list(_spans)


def reset() -> None:
    """Forget every recorded span."""
    _spans.clear()


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Trace the block with `torch.profiler`: the CPU, and the card's kernels
    when `device` (None: the card) is a CUDA device.  On exit a Chrome trace
    (`<worker>.<time>.pt.trace.json`, for Perfetto or TensorBoard) is
    written into `logdir`.  Yields the profiler (`key_averages()`,
    `events()`)."""
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def _device_of(tree) -> torch.device:
    """The device of the first tensor in a (nested) NamedTuple / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    for item in tree if isinstance(tree, (tuple, list)) else ():
        found = _device_of(item)
        if found is not None:
            return found
    return None


def time_sweeps(run_fn, graph, state, cfg, n_iters: int, warmup: int = 5):
    """Steady-state sweeps/s of `run_fn(graph, state, cfg, n)` (e.g.
    `core.sweep.run`, `core.sweep_cm.run`, a halo run function).

    `warmup` sweeps first (they build the kernels and fill the caching
    allocator), then `n_iters` timed ones: by CUDA events on the card (the
    stream's time from the first launch to the last kernel's end, host gaps
    included), by `time.perf_counter` on the CPU.  Returns (sweeps_per_s,
    final_state)."""
    state = run_fn(graph, state, cfg, warmup)
    device = _device_of(state)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state = run_fn(graph, state, cfg, n_iters)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        state = run_fn(graph, state, cfg, n_iters)
        seconds = time.perf_counter() - t0
    return n_iters / seconds, state
