"""The per-layer metrics that read the port's set-up spans (`metrics/_spans.py`,
`gbp_tpu_torch.utils.profiling`): `windows_s` is in every traced line on the
CPU and `capture_s` in none (the CPU steps eagerly and never captures),
neither in an untraced line; the readers pick this run's set-up on a made-up
trace; a program without the recorder gives nothing; and, on the card, both
read this run's set-up, which ends before the traced window opens.

    python -m pytest benchmark/tests -q            (-m cuda on a card)
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import loops, run
from benchmark.loops._common import Cell
from benchmark.metrics import _spans
from benchmark.tests.test_bench_harness import ROOT, manifest, run_tiny
from benchmark.trace import Trace
from gbp_tpu_torch.utils import profiling

NEW = {"windows_s", "capture_s"}
CELLS = ["bench64.steady", "venice1778.steady", "bench64.solve"]


def reading(trace) -> run.Reading:
    return run.Reading(trace=trace, sweeps=10, counters={"solve_sweeps": [5, 5]}, peaks=None)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line_reads_the_setup_spans_on_cpu(workload):
    listed = {m["name"] for m in manifest()["per_layer"]
              if m["name"] in NEW and workload in m["workloads"]}
    assert listed == NEW
    r = run_tiny(workload, seed=2 ** 31 + 7, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["windows_s"]["value"] > 0, r["metrics"]
    assert "capture_s" not in r["metrics"]  # the CPU steps eagerly: no capture
    untraced = run_tiny(workload, seed=2 ** 31 + 7, trace=False)
    assert not NEW & set(untraced["metrics"])


def test_readers_on_a_made_up_trace(monkeypatch):
    ns = lambda s: int(round(s * 1e9))
    made = [("sweep_cm.prepare.windows", -9.0, -8.5), ("capture.capture", -8.0, -7.0),
            ("sweep_cm.prepare.windows", -5.0, -4.75),  # this run's prepare
            ("capture.capture", -4.5, -4.0),  # this run's capture
            ("sweep_cm.prepare.windows", 1.0, 3.0)]  # inside the window: not set-up
    monkeypatch.setattr(profiling, "recorded", lambda: [(n, ns(a), ns(b)) for n, a, b in made])
    r = reading(Trace(ops=[("k", 1.0, 2.0)], spans=[], window=(0.0, 6.0)))
    assert run.reader("windows_s")(r) == pytest.approx(0.25)
    assert run.reader("capture_s")(r) == pytest.approx(0.5)
    # Untraced, or with no such span before the window, the readers give nothing.
    assert run.reader("windows_s")(reading(None)) is None
    early = reading(Trace(ops=[], spans=[], window=(-20.0, -10.0)))
    assert run.reader("capture_s")(early) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    # The parent of the recorder: `utils.profiling` without `recorded`.
    monkeypatch.delattr(profiling, "recorded")
    assert _spans.port_spans() == []
    r = reading(Trace(ops=[("k", 1.0, 2.0)], spans=[], window=(0.0, 6.0)))
    for name in sorted(NEW):
        assert run.reader(name)(r) is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bench64.steady", "bench64.solve"])
def test_setup_spans_on_the_card(workload):
    """A traced run on the card: both readers read this run's set-up, the
    window search before the capture, both ended before the window opened."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: only the card captures")
    torch.set_num_threads(1)
    man = manifest()
    cell = next(w for w in man["workloads"] if w["name"] == workload)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    c = Cell(config=json.loads((ROOT / conf["file"]).read_text()),
             traffic=json.loads((ROOT / "benchmark" / "traffic"
                                 / f"{cell['traffic']}.json").read_text()),
             limits=json.loads((ROOT / "benchmark" / "limits" / f"{workload}.json").read_text()),
             seed=4294967311, seconds=1.0, trace=True, device=torch.device("cuda", 0),
             t_process=time.perf_counter())
    profiling.reset()
    out = loops.load(c.traffic["loop"])(c)
    r = run.Reading(trace=out.trace, sweeps=out.sweeps, counters=out.counters, peaks=None)
    values = {n: run.reader(n)(r) for n in sorted(NEW)}
    assert all(v is not None and v > 0 for v in values.values()), values
    # The newest of each name before the window, as the readers take them.
    spans = {n: (a, b) for n, a, b in _spans.port_spans() if b <= out.trace.window[0]}
    assert spans["sweep_cm.prepare.windows"][1] <= spans["capture.capture"][0]
    assert values["capture_s"] == pytest.approx(spans["capture.capture"][1]
                                                - spans["capture.capture"][0])
    print(f"[spans] {workload}: {values}, prepare_s {out.counters['prepare_s']:.6f}")
