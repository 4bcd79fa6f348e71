"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
BENCHMARK.json; its configuration in configs/<config>.json, whose "port"
and "generator" pick ports/<port>.py and generators/<generator>.py; its
traffic mix in traffic/<mix>.json, whose "loop" picks loops/<loop>.py; the
limits of its correctness check in limits/<workload>.json; and each
per-layer metric's reader in metrics/<metric>.py.

Set-up (the scene from the seed, the port's build and prepare, the capture,
the warm-up) counts as setup_s, from process start to the window.  With
--trace 0 the line carries the cell's end-to-end metrics; with --trace 1 the
window runs under torch.profiler and the line carries its per-layer metrics,
the device's busy and window seconds and a breakdown.  After the window the
check compares what the window's captured run produced with the plain
reference (check.py); each number and its limit go last on stderr and last
in the line ("checks").  Exits non-zero, printing no result, without a
CUDA card (or fewer than the cell asks for) and when JAX or the JAX package
is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "gbp_tpu")

# Kernel caches at fixed paths inside the checkout (the port builds its own
# library under gbp_tpu_torch/_build/, also inside the checkout).
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))

import torch  # noqa: E402

from benchmark import check, loops  # noqa: E402
from benchmark.loops._common import Cell  # noqa: E402
from benchmark.trace import Trace  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Reading:
    """What a per-layer reader sees (metrics/*.py `read(r)`)."""

    trace: Trace | None
    sweeps: int  # sweeps completed in the (traced) window
    counters: dict
    peaks: dict | None  # the card's row of peaks.json, None off the table


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, workload: str, per_layer: bool) -> list:
    """The metric entries this cell reports."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    listed = lambda m: workload in m["workloads"] if "workloads" in m else m["moves"] in names
    return [m for m in man["per_layer"] if listed(m)]


def card_line() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             overrides: dict | None = None, faults=None, control: bool = False,
             t_process: float = T_PROCESS) -> dict:
    """One run of a cell on `device`: the result dict (module docstring).
    `overrides` (tests) updates the configuration's and traffic's entries;
    `faults` (tests, control.py) is called with the Port to break it;
    `control` (control.py) adds the control's readings under "control"."""
    man = manifest()
    cell = next(w for w in man["workloads"] if w["name"] == workload)
    conf_entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    config = _json(ROOT / conf_entry["file"])
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    limits = _json(HERE / "limits" / f"{workload}.json")
    c = Cell(config=config, traffic=traffic, limits=limits,
             seed=int(seed) & (2 ** 62 - 1), seconds=float(seconds), trace=trace,
             device=device, t_process=t_process, faults=faults, control=control)
    out = loops.load(traffic["loop"])(c)
    ok, table = check.judge(out.numbers, limits)
    correct = bool(ok and out.failed == 0)
    metrics = {}
    peaks = _json(HERE / "peaks.json").get(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "", None)
    reading = Reading(trace=out.trace, sweeps=out.sweeps, counters=out.counters, peaks=peaks)
    values = dict(out.e2e, setup_s=out.setup_s)
    for m in cell_metrics(man, workload, trace):
        v = reader(m["name"])(reading) if trace else values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and out.trace is not None:
        device_info.update(busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in out.trace.top_ops(10)],
                               "idle_gaps": [list(x) for x in out.trace.idle_gaps()[:10]]}
    log(f"[bench] {workload} seed {c.seed}: {out.attempted} attempted, {out.failed} failed, "
        f"window {out.window_s:.6f} s, {out.sweeps} sweeps, set-up {out.setup_s:.6f} s, "
        f"prepare {out.counters['prepare_s']:.6f} s")
    if control:
        result["control"] = out.counters["control"]
    result["checks"] = table
    return result


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = next(w["chips"] for w in manifest()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] needs {chips} CUDA card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    # One host thread for the port's CPU-side work: the host's launches are
    # on the measured path, and other threads only contend with them.
    torch.set_num_threads(1)
    line = card_line()
    log(f"[bench] card: {line or torch.cuda.get_device_name(0)} "
        "(name, power limit, SM clock, max SM clock)")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        log(f"[bench] refused: modules {bad} are loaded in this process")
        return 3
    for name, e in result["checks"].items():
        log(f"[check] {name} {e['value']!r} limit {e['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
