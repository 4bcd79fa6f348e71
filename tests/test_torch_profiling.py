"""The port's span recorder (`utils.profiling`: `span`, `recorded`, `reset`):
what a span records, the buffer's bound, the clock it shares with
`torch.profiler`, that it adds nothing to the profiler's trace, and where the
port records spans: once per prepare and per capture, never on the solve
path.  On the CPU, except the test marked `cuda`.  This file imports no JAX,
so the card's machine runs it (README)."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gbp_tpu_torch.bench import CFG
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.utils import profiling
from gbp_tpu_torch.utils.capture import CapturedRun

torch.set_num_threads(1)
SCENE = dict(n_cams=8, n_lmks=200, pix_sigma=1.0, seed=0)


@pytest.fixture(autouse=True)
def _empty():
    profiling.reset()
    yield
    profiling.reset()


def _profiled(device="cpu"):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    return profile(activities=acts)


def _names():
    return [s[0] for s in profiling.recorded()]


def _solve_path(device):
    """A tiny BA problem prepared and captured on `device`; returns one
    solve: a fresh estimate loaded, one chunk, the ARE."""
    sim = ba.simulate(**SCENE)
    graph, means = ba.build(sim, device=device)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    run = CapturedRun(lambda s: sweep_cm.sweep(cmg, s, CFG), sweep_cm.init_state(cmg, means), 2)
    run()  # on a card: the capture, in set-up

    def solve():
        run.load(sweep_cm.init_state(cmg, means))
        run()
        return float(ba.avg_reprojection_error(graph, sweep_cm.to_gbp_state(cmg, run.state),
                                               k=np.asarray(sim["k"])))
    return solve


def test_a_span_records_its_name_and_stamps_and_reset_forgets():
    with profiling.span("capture.capture"):
        pass
    with pytest.raises(ValueError):
        with profiling.span("raised"):
            raise ValueError
    (name, start, end), raised = profiling.recorded()
    assert name == "capture.capture" and 0 < start <= end <= raised[1]
    assert raised[0] == "raised"
    profiling.recorded().clear()  # a copy
    assert len(profiling.recorded()) == 2
    profiling.reset()
    assert profiling.recorded() == []


def test_a_span_calls_no_trace_annotation(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called")

    for mod, attr in ((torch.profiler, "record_function"), (torch.autograd.profiler,
                      "record_function"), (torch.cuda.nvtx, "range_push"),
                      (torch.cuda, "Event"), (torch.cuda, "synchronize")):
        monkeypatch.setattr(mod, attr, boom)
    with _profiled() as prof:
        with profiling.span("capture.capture"):
            torch.ones(3).sum()
    assert _names() == ["capture.capture"]
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and "capture.capture" not in events


def test_the_buffer_keeps_its_bound():
    n = profiling.SPAN_CAPACITY
    assert n >= 65536
    for i in range(n + 5):
        with profiling.span(str(i)):
            pass
    names = _names()
    assert len(names) == n and names[0] == "5" and names[-1] == str(n + 4)


def test_spans_share_the_profilers_clock():
    with _profiled() as prof:
        with record_function("warm-up"):  # the first range pays a one-off start
            pass
        for i in range(5):
            with record_function(f"twin{i}"), profiling.span(f"port{i}"):
                torch.randn(300, 300) @ torch.randn(300, 300)
    twins = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("twin")}
    spans = profiling.recorded()
    assert len(spans) == 5 and len(twins) == 5
    for name, start, end in spans:
        t0, t1 = twins["twin" + name[len("port"):]]
        assert abs(start - t0) < 1_000_000 and abs(end - t1) < 1_000_000, (name, start - t0,
                                                                            end - t1)


def test_prepare_records_one_windows_span_a_call():
    graph, _ = ba.build(ba.simulate(**SCENE), device="cpu")
    for calls in (1, 2):
        t0 = time.time_ns()
        sweep_cm.prepare(graph, segsum_exact=True)
        t1 = time.time_ns()
        assert _names() == ["sweep_cm.prepare.windows"] * calls
        _, start, end = profiling.recorded()[-1]
        assert t0 <= start <= end <= t1


def test_the_solve_path_records_no_span():
    solve = _solve_path("cpu")
    # The CPU steps eagerly: no capture, so prepare's span alone.
    assert _names() == ["sweep_cm.prepare.windows"]
    profiling.reset()
    with _profiled():
        are = solve()
    assert np.isfinite(are) and profiling.recorded() == []
    assert np.isfinite(solve()) and profiling.recorded() == []


@pytest.mark.cuda
def test_spans_on_the_card():
    """The capture is recorded once, in set-up; a solve records nothing and
    the profiler's trace of it holds no span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    solve = _solve_path(torch.device("cuda"))
    assert _names() == ["sweep_cm.prepare.windows", "capture.capture"]
    profiling.reset()
    solve()
    torch.cuda.synchronize()
    with _profiled("cuda") as prof:
        solve()
        torch.cuda.synchronize()
    assert profiling.recorded() == []
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not events & {"sweep_cm.prepare.windows", "capture.capture"}
