"""The port's headline benchmark: GBP sweeps/s on one card on the bench
bundle-adjustment problem, and the wall-clock to 1.05x the MAP ARE.

Counterpart of the root `bench.py` (the reference's, which stays as it is):
the same problem, measurements and JSON line.

  problem    `ba.simulate(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)`
             (BENCH_N_CAMS / BENCH_N_LMKS set the sizes) -> `ba.build`
             (float32, ELL) -> `sweep_cm.prepare(graph, segsum_exact=True)`
             under `bench.CFG`: kernels 1, 2 and 3 once a sweep.
  sweeps/s   a 5-sweep chunk captured as one CUDA graph
             (`utils.capture.CapturedRun`): 200 warm-up sweeps (capture
             included), then 200 sweeps timed by CUDA events as 40 replays
             with no sync in between.  The same 200 sweeps from the same
             state run eagerly (`sweep_cm.run`) beside them: their rate goes
             on stderr, and the two final states are compared bit for bit.
  MAP ARE    six `schur.gauss_newton_step(graph, means, cg_iters=60)`, not
             timed.
  wall-clock to 1.05x the MAP ARE: from the initial state the captured chunk
             is replayed, synced and its ARE computed, up to 40 chunks, with
             the clock running; the ARE per chunk goes on stderr.
  baseline   `bench_baseline.json` at the repo root, read only: seconds a
             sweep of the serial NumPy reference (`bench/numpy_gbp.py`) by
             factor count.  Where the count is missing, one NumPy sweep is
             timed at this size and cached nowhere.

Prints on stdout one JSON line with `bench.py`'s keys: metric, value
(captured sweeps/s), unit, vs_baseline, wall_clock_to_convergence_s and
n_factors; the card's name and power limit go on stderr.

    python -m gbp_tpu_torch.bench [--device cpu]

Without a card it raises unless `--device cpu` is given.  The CPU runs the
reduced problem (16 cameras, 600 landmarks, unless BENCH_N_CAMS is set)
eagerly, timed by the host clock, and marks the line "platform": "cpu".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import CFG, card_line
from gbp_tpu_torch.bench.numpy_gbp import build_ba_numpy
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.parallel import schur
from gbp_tpu_torch.utils.capture import CapturedRun, map_tensors

SWEEPS = 200
CHUNK = 5
MAX_CHUNKS = 40
BASELINE_CACHE = Path(__file__).resolve().parents[2] / "bench_baseline.json"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_s(device, fn) -> float:
    """Seconds `fn()` takes once the queue is empty: CUDA events around it on
    the card (the stream's time from its first launch to its last kernel's
    end), the host clock on the CPU."""
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def median_run_s(step, init, n: int, reps: int, device):
    """(median seconds, the run): `reps` runs of `n` steps from `init`, each
    one call of a `CapturedRun` (one replay on the card, captured by a
    first, untimed call), host clock around the call and a sync."""
    run = CapturedRun(step, init, n)
    run()
    ts = []
    for _ in range(reps):
        run.load(init)
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2], run


@dataclasses.dataclass
class Problem:
    """The bench problem on a device, prepared for the fast path."""

    sim: dict
    graph: object
    means: tuple
    cmg: sweep_cm.CMGraph
    n_factors: int

    def are(self, state) -> float:
        """The ARE in pixels of a CM state."""
        return float(ba.avg_reprojection_error(
            self.graph, sweep_cm.to_gbp_state(self.cmg, state), k=self.sim["k"]))

    def step(self, state):
        return sweep_cm.sweep(self.cmg, state, CFG)


def problem(sim: dict, device) -> Problem:
    """`sim` built in float32 (ELL) on `device` and prepared as `bench.py`
    prepares it."""
    graph, means = ba.build(sim, device=device)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    if cmg is None:
        raise RuntimeError("the bench graph must take the fast path (sweep_cm.prepare)")
    fb = graph.fblocks[0]
    # Real factors: the ELL layout pads rows with inert clones, and the
    # serial baseline builds only the real ones.
    m = fb.count if fb.n_valid is None else fb.n_valid
    return Problem(sim, graph, means, cmg, int(m))


@dataclasses.dataclass
class Measurement:
    n_factors: int
    sweeps_per_s: float  # captured chunks (eager on the CPU)
    eager_sweeps_per_s: float
    captured_equals_eager: bool  # the timed sweeps' means, bit for bit
    are_px: float  # after the warm-up and the timed sweeps
    are_map_px: float
    ares: list  # ARE after each chunk from the initial state
    t_conv: float | None  # seconds to the first chunk at <= 1.05x the MAP ARE
    conv_sweeps: int | None
    run: CapturedRun  # the captured chunk (its graph, on the card)


def measure(p: Problem, sweeps: int = SWEEPS, chunk: int = CHUNK,
            max_chunks: int = MAX_CHUNKS) -> Measurement:
    """`bench.py`'s `measure_tpu` on the port: sweeps/s, MAP ARE and the
    wall-clock to 1.05x the MAP ARE (module docstring)."""
    if sweeps % chunk:
        raise ValueError(f"sweeps ({sweeps}) must be a multiple of the chunk ({chunk})")
    device = p.cmg.z.device
    init = sweep_cm.init_state(p.cmg, p.means)
    run = CapturedRun(p.step, init, chunk)

    def replays():
        for _ in range(sweeps // chunk):
            run()

    log(f"[bench] graph: {p.sim['cam_init'].shape[0]} cams, {p.sim['lmk_init'].shape[0]} lmks, "
        f"{p.n_factors} factors on {device}")
    t_warm = elapsed_s(device, replays)
    log(f"[bench] warm-up ({'capture + ' if run.on_card else ''}{sweeps} sweeps): "
        f"{t_warm:.3f}s")
    start = map_tensors(torch.clone, run.state)
    dt = elapsed_s(device, replays)
    sweeps_per_s = sweeps / dt
    sweep_cm.run(p.cmg, start, CFG, chunk)  # the eager path's allocations, untimed
    eager = []
    dt_eager = elapsed_s(device, lambda: eager.append(sweep_cm.run(p.cmg, start, CFG, sweeps)))
    equal = all(torch.equal(a.mean, b.mean) for a, b in zip(run.state.v, eager[0].v))
    are = p.are(run.state)
    log(f"[bench] {sweeps} sweeps in {dt:.4f}s -> {sweeps_per_s:.2f} sweeps/s "
        f"({'captured, ' if run.on_card else ''}{sweeps // chunk} chunks of {chunk}); "
        f"ARE {are:.6f}px")
    log(f"[bench] eager {sweeps} sweeps: {dt_eager:.4f}s -> {sweeps / dt_eager:.2f} sweeps/s; "
        f"means {'equal' if equal else 'NOT equal'} bit for bit to the "
        f"{'captured' if run.on_card else 'chunked'} run's")
    if not math.isfinite(are):
        raise RuntimeError("benchmark produced non-finite ARE")

    t0 = time.perf_counter()
    mu = p.means
    for _ in range(6):
        mu = schur.gauss_newton_step(p.graph, mu, cg_iters=60)
    are_map = float(ba.avg_reprojection_error(
        p.graph, ba.with_means(sweep_cm.to_gbp_state(p.cmg, run.state), mu), k=p.sim["k"]))
    log(f"[bench] MAP target via Schur-GN: ARE {are_map:.6f} px "
        f"({time.perf_counter() - t0:.1f}s, not counted)")
    target = 1.05 * are_map

    run.load(init)
    ares, t_conv, conv_sweeps = [], None, None
    sync(device)
    t0 = time.perf_counter()
    for i in range(max_chunks):
        run()
        sync(device)
        t_i = time.perf_counter() - t0
        ares.append(p.are(run.state))
        if t_conv is None and ares[-1] <= target:
            t_conv, conv_sweeps = t_i, (i + 1) * chunk
    shown = " ".join(f"{a:.4f}" for a in ares)
    if t_conv is not None:
        log(f"[bench] convergence to <=1.05x MAP ARE at sweep {conv_sweeps} ({t_conv:.4f}s "
            f"wall); ARE/{chunk}-sweep chunk = {shown}")
    else:
        log(f"[bench] NOT converged to 1.05x MAP ARE ({target:.4f}) within {chunk * max_chunks} "
            f"sweeps; trajectory {shown}")
    return Measurement(p.n_factors, sweeps_per_s, sweeps / dt_eager, equal, are, are_map, ares,
                       t_conv, conv_sweeps, run)


def baseline_s_per_sweep(m: int, sim: dict, cache: Path = BASELINE_CACHE) -> float:
    """Seconds a sweep of the serial NumPy reference at m factors: the cached
    entry (read only), else one sweep timed here and cached nowhere."""
    entries = {}
    if cache.exists():
        cached = json.loads(cache.read_text())
        entries = {int(k): v for k, v in cached.get("by_factors", {}).items()}
        if "full_size_factors" in cached:
            entries[int(cached["full_size_factors"])] = cached["full_size_s_per_sweep"]
    if m in entries:
        log(f"[bench] cached numpy baseline: {entries[m]:.1f} s/sweep at {m} factors")
        return entries[m]
    log(f"[bench] measuring the serial numpy baseline at {m} factors (1 sweep, not cached)...")
    g = build_ba_numpy(sim)
    if len(g.factors) != m:
        raise RuntimeError(f"the numpy baseline has {len(g.factors)} factors, the graph {m}")
    t0 = time.perf_counter()
    g.synchronous_iteration()
    s = time.perf_counter() - t0
    log(f"[bench] numpy baseline: {s:.3f} s/sweep ({s / m * 1e6:.1f} us/factor)")
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    on_card = device.type == "cuda"
    if "BENCH_N_CAMS" in os.environ or on_card:
        n_cams = int(os.environ.get("BENCH_N_CAMS", 64))
        n_lmks = int(os.environ.get("BENCH_N_LMKS", 8000))
    else:
        n_cams, n_lmks = 16, 600
    if on_card:
        log(f"[bench] {card_line()}")
    sim = ba.simulate(n_cams=n_cams, n_lmks=n_lmks, pix_sigma=1.0, seed=0)
    r = measure(problem(sim, device))
    s_base = baseline_s_per_sweep(r.n_factors, sim)
    log(f"[bench] baseline (serial numpy reference impl): {1.0 / s_base:.4f} sweeps/s on the "
        f"same problem")
    result = {
        "metric": "ba_gbp_sweeps_per_s_per_chip",
        "value": round(r.sweeps_per_s, 2),
        "unit": "sweeps/s",
        "vs_baseline": round(r.sweeps_per_s * s_base, 2),
        "wall_clock_to_convergence_s": None if r.t_conv is None else round(r.t_conv, 3),
        "n_factors": r.n_factors,
    }
    if not on_card:
        result["platform"] = "cpu"
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
