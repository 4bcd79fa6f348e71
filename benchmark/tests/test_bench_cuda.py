"""The benchmark on the card: one short run of each cell, traced and not,
through its command line, and the line it prints held to the contract.

    python -m pytest benchmark/tests -q -m cuda     (on a machine with a card)
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["bench64.steady", "venice1778.steady", "bench64.solve"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the device")


def _run(workload: str, trace: int) -> tuple:
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "4294967311",
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_line_on_the_card(card, workload, trace):
    line, err = _run(workload, trace)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert list(line)[-1] == "checks"
    kinds = man["per_layer"] if trace else man["end_to_end"]
    expected = {m["name"] for m in kinds if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == expected
    for name, m in line["metrics"].items():
        assert m["value"] > 0 or name.startswith("idle_share"), (name, m)
        if "roofline" in name:
            assert m["value"] <= 100.0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    for name, e in line["checks"].items():
        assert f"[check] {name} {e['value']!r} limit {e['limit']!r}" in err
