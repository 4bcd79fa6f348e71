"""What every loop kind shares: the cell's parsed files, the outcome it
hands back, set-up's stages, the scene and the port by name, the measured
(or traced) window, and the check of one chunk of sweeps against the plain
reference.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from benchmark import check, generators, ports
from benchmark.device import sync
from benchmark.reference import gbp, layout
from benchmark.trace import span, traced


@dataclasses.dataclass
class Cell:
    """What a loop needs: the parsed files and the run's arguments."""

    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float  # the host clock at process start
    faults: object = None  # tests and control.py: a callable that breaks the Port it is given
    control: bool = False  # control.py only: also judge the control


@dataclasses.dataclass
class Outcome:
    """A loop's result: end-to-end readings, counters for the per-layer
    readers, the check's numbers, and the device trace when traced."""

    attempted: int
    failed: int
    setup_s: float
    window_s: float
    sweeps: int  # sweeps completed in the window
    e2e: dict
    counters: dict
    numbers: dict
    memory_peak_bytes: int
    trace: object = None


def stage(cell: Cell, what: str) -> None:
    """Set-up's parts on earlier lines of stderr: seconds since process start."""
    print(f"[setup] {what}: {time.perf_counter() - cell.t_process:.6f} s since process start",
          file=sys.stderr, flush=True)


def scene(cell: Cell):
    """(the scene, each observation's row in the port's user order, the
    shapes the roofline readers count bytes from)."""
    stage(cell, "imports done")
    sim = generators.make_scene(cell.config, cell.seed)
    stage(cell, "scene made")
    rows, n_rows, deg, slot = layout.ell_rows(sim["cam_ids"], sim["lmk_ids"],
                                              sim["cam_init"].shape[0], sim["lmk_init"].shape[0])
    shapes = dict(n_obs=int(sim["obs"].shape[0]), n_rows=int(n_rows), deg=int(deg),
                  n_cams=int(sim["cam_init"].shape[0]), n_lmks=int(sim["lmk_init"].shape[0]),
                  itemsize=torch.finfo(getattr(torch, cell.config["dtype"])).bits // 8,
                  cam_dof=6, lmk_dof=3, zdim=2)
    return sim, torch.as_tensor(rows, device=cell.device), shapes


def port(cell: Cell, sim: dict):
    p = ports.load(cell.config["port"])(sim, cell.config, cell.device)
    if cell.faults is not None:
        cell.faults(p)
    stage(cell, f"port built and prepared ({p.prepare_s:.6f} s)")
    return p


def captured(p, state, n: int):
    from gbp_tpu_torch.utils.capture import CapturedRun

    return CapturedRun(p.step, state, n)


def window(cell: Cell, body):
    """Run `body()` as the window: traced or not; returns (seconds, body's
    value, Trace or None).  The collector is off inside it: its pauses
    would land on the host's launches at random."""
    sync(cell.device)
    gc.collect()
    gc.disable()
    try:
        if not cell.trace:
            t0 = time.perf_counter()
            val = body()
            sync(cell.device)
            return time.perf_counter() - t0, val, None
        with traced(cell.device) as rec:
            with span("window"):
                t0 = time.perf_counter()
                val = body()
                sync(cell.device)
                dt = time.perf_counter() - t0
        return dt, val, rec["trace"]
    finally:
        gc.enable()


def free(cell: Cell) -> None:
    """Give the program's memory back before the reference runs."""
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def _follow(pb, sc: dict, n: int, start, at, ar):
    """n reference sweeps from `start` that take the decisions `at` (each
    row's sweep of the chunk at which it relinearized, 1..n, or none):
    (the state, rows relinearized a sweep, [own decisions that differ,
    eligible rows])."""
    ref, relin, tally = start, [], [0, 0]
    for i in range(1, n + 1):
        ref = gbp.sweep(pb, ref, sc, ar, follow=at == i, tally=tally)
        relin.append(int((ref.srel == 0).sum()))
    return ref, relin, tally


def _gaps(cell: Cell, pb, state, ref, tally) -> dict:
    return dict(check.state_gaps(pb, state, ref, cell.traffic.get("gap_quantile")),
                relin_disagree=tally[0] / tally[1] if tally[1] else 0.0)


def chunk_check(cell: Cell, pb, sc: dict, n: int, program_next, start, control_start) -> dict:
    """The gaps of the program's state after a chunk of n sweeps against the
    reference's n sweeps from `start` (observation order, float64).

    The reference takes the program's relinearization decisions, read from
    its sweeps since relinearization after the chunk (at most one a row:
    the chunk is shorter than min_linear_iters), so that what follows them
    is judged on the program's own decisions; `relin_disagree` is the share
    of eligible rows at which the reference's own decision differs.  With
    cell.control the control (TF32 products) runs the same chunk from
    `control_start()` on its own decisions, and is judged in the same way
    against a reference that takes them ("control")."""
    f64 = gbp.Arith("f64")
    ref, relin, tally = _follow(pb, sc, n, start, n - program_next.srel, f64)
    out = dict(gaps=_gaps(cell, pb, program_next, ref, tally), relin=relin)
    if cell.control:
        ctl = gbp.run(pb, control_start(), sc, gbp.Arith("tf32"), n)
        ref_c, _, tally_c = _follow(pb, sc, n, start, n - ctl.srel.double(), f64)
        out["control"] = _gaps(cell, pb, gbp.cast(ctl, torch.float64), ref_c, tally_c)
    return out
