"""The traced run's records and the arithmetic every per-layer reader
shares: device intervals from `torch.profiler`, the benchmark's own spans
around its calls into the port, busy and idle time, and the breakdown the
result line carries.

Kernel classes: the port's hand-written kernels are named in its C++
namespace, `gbp::` (a frozen copy of the split in
`gbp_tpu_torch/bench/profile_sweep.py`, commit ad6c174); every other device
operation is PyTorch glue.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
PORT_NAMESPACE = "gbp::"


def is_port_kernel(name: str) -> bool:
    return PORT_NAMESPACE in name


def span(name: str):
    """A span of the benchmark's own around a call into the port."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Trace:
    """Device operations [(name, start_s, end_s)] and the benchmark's spans
    [(name, start_s, end_s)] of one traced window, on one clock."""

    ops: list
    spans: list
    window: tuple  # (start_s, end_s)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def ops_in_window(self) -> list:
        t0, t1 = self.window
        return [o for o in self.ops if o[2] > t0 and o[1] < t1]

    def busy_intervals(self) -> list:
        """The union of the device's operation intervals, clipped to the window."""
        t0, t1 = self.window
        out = []
        for _, a, b in sorted(self.ops_in_window(), key=lambda o: o[1]):
            a, b = max(a, t0), min(b, t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, keep=lambda name: True) -> float:
        """Seconds of device operations whose name passes `keep` (summed, not
        merged)."""
        return sum(b - a for n, a, b in self.ops_in_window() if keep(n))

    def count(self, keep=lambda name: True) -> int:
        return sum(1 for n, _, _ in self.ops_in_window() if keep(n))

    def idle_gaps(self) -> list:
        """[(label, seconds)]: the device's idle time in the window, each gap
        named by the innermost span of the benchmark's that holds its middle."""
        t0, t1 = self.window
        edges = np.array([t0] + [x for iv in self.busy_intervals() for x in iv] + [t1])
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        mid = 0.5 * (a + b)
        order = np.argsort(mid)
        mid, length = mid[order], (b - a)[order]
        label = np.full(mid.size, -1)
        held_by = np.full(mid.size, np.inf)
        for i, (_, s0, s1) in enumerate(self.spans):
            lo, hi = np.searchsorted(mid, s0), np.searchsorted(mid, s1, side="right")
            inner = held_by[lo:hi] > s1 - s0
            label[lo:hi][inner] = i
            held_by[lo:hi][inner] = s1 - s0
        gaps = {}
        for lab, dt in zip(label.tolist(), length.tolist()):
            name = self.spans[lab][0] if lab >= 0 else "outside spans"
            gaps[name] = gaps.get(name, 0.0) + dt
        return sorted(gaps.items(), key=lambda kv: -kv[1])

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b in self.ops_in_window():
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def _start_end_s(evt):
    if hasattr(evt, "start_ns"):
        s = evt.start_ns() * 1e-9
        return s, s + evt.duration_ns() * 1e-9
    s = evt.start_us() * 1e-6
    return s, s + evt.duration_us() * 1e-6


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body (CPU and, on a card, CUDA activity); yields a dict
    whose "trace" holds the `Trace` once the body has ended.  The body runs
    its window inside `span("window")`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    ops, spans = [], []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if name.startswith(SPAN_PREFIX):
            # A span shows twice: on the host, and as its annotation on the
            # device's timeline, which is no device operation.
            if evt.device_type() == torch.autograd.DeviceType.CUDA:
                continue
            spans.append((name[len(SPAN_PREFIX):], *_start_end_s(evt)))
        elif evt.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((name, *_start_end_s(evt)))
    windows = [s for s in spans if s[0] == WINDOW_SPAN[len(SPAN_PREFIX):]]
    if len(windows) != 1:
        raise RuntimeError(f"the traced run must hold one window span, found {len(windows)}")
    out["trace"] = Trace(ops=ops, spans=[s for s in spans if s is not windows[0]],
                         window=windows[0][1:])
