#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's paths on one GPU: the bundle-adjustment fast
paths (camera table, windows, expanded operands, the unfused table kernels,
whole-table and windowed), the BA command line on BAL files with in-engine
annealing, the generic engine, and pose-graph SLAM (SE(2) and SE(3)).

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero; no phase is caught):

  1. device: a CUDA card must be present; prints its name and power limit
     (nvidia-smi), torch and CUDA versions; pins exact float32.
  2. build: compiles gbp_tpu_torch/csrc/*.cu with nvcc (first use, one
     compiler per source side by side) and prints the seconds taken and
     ptxas's register/spill report.
  3. kernel vs plain, full-table kernels: on the 8-cam/120-landmark scene
     and on the bench scene (64 cams, 8000 landmarks, 469,861 factors),
     after 8 plain sweeps on the CPU (8 = min_linear_iters), each kernel and
     its plain PyTorch version run on identical CUDA inputs:
     relinearization at the config's beta (every valid row relinearizes) and
     at the median distance (half do), messages with and without Huber.
     float64 must agree to 1e-11 and float32 to 1e-4, relative to each
     output's magnitude; the camera sum must repeat bit for bit.
  4. kernel vs plain, windowed kernels: the same checks on 7 merged blocks
     of 40 cameras (280 cameras, float64 and float32; the shuffled landmark
     numbering makes the locality sort engage; a single 280-camera corridor
     diverges under the plain schedule, non-finite in float32 by sweep 8,
     and leaves nothing to compare) and on the city scene (1,280 cameras,
     float32), and again with the windows widened to 256 cameras (float64)
     and 384 (city, float32), where a block stages more than 48 KB and the
     launch asks for dynamic shared memory; `segsum_cm_blk` and `scatter_windows_cm` must repeat bit for
     bit, their combination is held against the whole-table camera sum, and
     `scatter_windows_cm` against a dense accumulation with overlapping and
     repeated window starts.
     At the bench scene (full-table kernels) and the city scene (windowed
     kernels), float32, each kernel is timed against its plain version, its
     bound (bytes moved once over the card's memory rate, or operations over
     its float32 rate) and, for the sums, one `index_add_` call.
  5. windowed path vs full-table path: the 280-camera scene in float32 fits
     both; 15 sweeps each way, ARE equal to 5e-3 px (mid-convergence float32
     roundoff: the two summation orders take different paths to the same
     fixed point while the ARE is still falling by pixels per sweep).
  6. main path, bench scene: simulate -> build (f32) -> prepare ->
     init_state -> 200 sweeps through the kernels (launch counts 200, plain
     counts 0) -> to_gbp_state -> ARE, held to <= 1.05x the ARE of 6
     Gauss-Newton steps on the card; a rerun from the same init must give
     bitwise-equal means; a second timed 200-sweep call gives sweeps/s.
  7. main path, city scene (32 blocks x 40 cameras x 60 landmarks per
     camera, shuffled ids): simulate_blocks -> build (f32) ->
     prepare(window=True) -> init_state -> 50 sweeps through the windowed
     kernels (launch counts 50, plain counts 0) -> to_gbp_state -> ARE:
     finite, below the initial ARE and within 1e-2 px of the same 50 sweeps
     through the plain versions; bitwise rerun; 200 timed sweeps.  Then the
     venice scene (256 blocks x 40 x 80; 10,240 cameras, about 4.1 million
     factors): 50 sweeps, finite ARE below the initial one, launch counts,
     timed sweeps.
  8. kernel vs plain, expanded-operand kernels (csrc/rows.cu), on the 8-cam
     and the bench scene from the same states: `relin_cm` and `messages_cm`
     on component-major operands, `fused_relin_messages` and
     `fused_messages` on their row-major transposes, both relinearization
     regimes, Huber none / scalar / per row, diagonal and full precision
     (float64 1e-11, float32 1e-4); timed with their bounds at the bench
     scene in float32.
  9. generic path: the bench scene through `core.sweep` under
     message_form="pallas" (row-major state, `fused_relin_messages` every
     sweep): 200 sweeps, launch counts 200, plain calls 0, ARE <= 1.05x the
     MAP ARE, bitwise rerun, sweeps/s; then 50 sweeps with layout="none"
     (both belief updates by the deterministic segment sum), ARE within
     1e-3 px of the ELL run at 50 sweeps.
 10. rows path: 512 cameras that all see every landmark (no window engages,
     the packed table is beyond shared memory): `prepare` must choose
     gather_mode "rows"; 50 sweeps (counts, ARE finite and below the initial
     one), 200 sweeps against the MAP ARE (printed, which of the two it
     meets), bitwise rerun, sweeps/s, peak memory; then the bench scene
     forced to "rows" and "take1", 50 sweeps, within 1e-3 px of "table".
 11. linear path: the 1-D toy chain in float64 under message_form="pallas"
     on the card (kernel `fused_messages` at (1, 1, 1)), means against
     `oracle.map_solution` to 1e-9.
 12. kernel vs plain, unfused table kernels (csrc/unfused.cu): inside phase
     3, from the same states (8-cam and bench scene, float64 and float32) and
     on the 280-camera scene prepared without windows (float32: in float64
     its table is beyond the 48 KB the full-table kernels stage):
     `expand_ell_blk` (exact), `relin_cm_tab` in both regimes,
     `messages_cm_tab` with and without Huber; timed with their bounds at
     the bench scene, `expand_ell_blk` beside one `index_select`.
 13. kernel vs plain at the pose-graph shapes: every kernel at (3, 3, 3)
     with per-row Huber thresholds on Manhattan graphs after 11 plain sweeps
     (500 poses in float64 and 1,000 in float32: the largest tables that fit
     48 KB), fused, unfused, expanded operands in both layouts; the windowed
     kernels on the 1,500-pose graph; everything again at (6, 6, 6) on a
     250-pose SE(3) helix (its ELL layout groups by the first end of its
     factors, so slot 1 is the gathered one).
 14. unfused path: the bench scene with `prepare(ell_fused=False)`, 50 sweeps
     through `relin_cm_tab`, `messages_cm_tab`, `expand_ell_blk` and
     `segsum_by_id` (launch counts 50 each, plain calls 0), ARE within 1e-3 px
     of the fused run's, bitwise rerun, both timed side by side.
 15. pose path: a 4,000-pose Manhattan graph (f32) -> `prepare` (prints the
     mode it chose) -> 400 timed sweeps with `pose_graph.default_config()`
     (launch counts, plain calls 0, ATE finite and below the initial ATE,
     bitwise rerun), the Gauss-Newton ATE by `schur.solve_pcg` on the card,
     then 50-sweep chunks up to 6,000 sweeps until the ATE is at or below
     1.25 x ATE_GN + 0.02 (or the statement that it was not reached); 1,000
     poses in table mode fused and unfused (150 sweeps, means equal to 1e-4,
     ATE finite) and the 200-pose graph of the reference's float32 test (ATE
     below half the initial one); 1,500 poses windowed against
     window=False (50 sweeps); a 250-pose SE(3) helix (100 sweeps); and
     data/manhattan_sim.g2o (full information matrices) through `read_g2o`,
     `build_g2o` and the generic engine, energy decreasing.
 16. the kernels' JSON line, the card line, and the last line
     {"ok": true, "device": {...}}.
 17. kernel vs plain, windowed unfused kernels (csrc/unfused_win.cu): inside
     phase 4, from the same states (280 cameras in float64 and float32, the
     windows widened to 256 cameras in float64, city widened to 384 and city
     in float32) and inside phase 13 on the 1,500-pose graph at (3, 3, 3)
     with per-row thresholds: `relin_cm_tabblk` in both regimes,
     `messages_cm_tabblk` with and without Huber; timed with their bounds at
     the city scene.
 18. kernel vs plain, BAL models: on data/ladybug49_sim.txt.gz after 8 plain
     sweeps, float64 and float32, every relinearization and messages entry
     (full-table, unfused, expanded operands in both layouts, and the
     windowed fused and unfused entries with every tile's window holding
     all 49 cameras) with `bal_reprojection_normalized` and its per-row
     arguments at (6, 3, 2), and with `bal_reprojection_intrinsics` at
     (9, 3, 2).
 19. windowed unfused path: city and venice with `prepare(window=True,
     ell_fused=False)`, 50 sweeps through `relin_cm_tabblk`,
     `messages_cm_tabblk`, `expand_ell_blk`, `segsum_cm_blk` and
     `scatter_windows_cm` (launch counts 50 each, plain calls 0), ARE
     finite and falling; at city within 1e-3 px of the fused windowed run
     and a bitwise rerun; seconds per sweep beside the fused path's.
 20. BAL path: `python -m gbp_tpu_torch.ba --bal_file
     data/ladybug49_sim.txt.gz --n_iters 100 --oracle` in this process, with
     and without --optimize_intrinsics: launch counts 100, plain calls 0,
     final ARE <= 1.05x the dense-MAP ARE, the ARE every 10 sweeps beside
     the reference's CPU run, a bitwise rerun, sweeps/s; then
     data/corridor_sim.txt.gz with --prior_prec 1000 under the full default
     schedule in float32: ARE finite and falling.
 21. `run_annealed_cm` on the city scene, 50 sweeps through the windowed
     kernels: launch counts, ARE finite and below the initial one.
 22. kernel vs plain, the halo paths' windowed kernels (csrc/halo.cuh,
     kernels 12, 13, 17, 18): the merged-blocks scene of 1,280 cameras with
     8 landmarks each (float64, 1e-11) and the city scene (float32, 1e-4),
     both cut into 2 owner-sharded partitions (`halo_cm.distribute`, plain
     layout) after 8 plain sweeps on the CPU; per partition, on the
     operands its sweep hands them: `relin_cm_tabblkg_ell` and
     `relin_cm_tabblkg` in both relinearization regimes,
     `messages_cm_tabblkg_ell` and `messages_cm_tabblkg` with and without
     Huber; city again with every window widened to 384 cameras (64,512
     bytes, dynamic shared memory); timed at city, partition 0.
 23. halo paths, the P partitions in one process on the card through the
     single-process exchange: city at P = 2 through kernels 17, 18 and,
     unfused, 12, 13 (50 sweeps: launch counts P per sweep, plain calls 0,
     ARE finite, below the initial one and within 5e-3 px of the
     one-device run of phase 7, bitwise rerun, sweeps/s, collective bytes);
     city at P = 4 and venice at P = 4 (the mode `prepare` picks, 50 sweeps,
     ARE finite and falling, sweeps/s, peak memory);
     `python -m gbp_tpu_torch.slam --n_poses 4000 --n_iters 100 --n_chips 2`
     (launch counts, ATE finite and at or below the initial one, sweeps/s);
     `python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz
     --n_iters 100 --n_chips 2 --oracle`, final ARE within 1e-3 px of the
     same command on one device.
"""
import contextlib
import dataclasses
import json
import math
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

import gbp_tpu_torch
from gbp_tpu_torch import ba as ba_cli
from gbp_tpu_torch import slam as slam_cli
from gbp_tpu_torch.bench import BIG_BUILD as BIG
from gbp_tpu_torch.bench import CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import anneal, oracle, sweep, sweep_cm
from gbp_tpu_torch.core.sweep import _kernel_params
from gbp_tpu_torch.io import bal, g2o
from gbp_tpu_torch.models import ba, pose_graph, toy
from gbp_tpu_torch.ops import _build
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm, schur

SWEEPS = 200
QUALITY_SWEEPS = 50  # corridor scenes: the plain schedule is taken at 50 sweeps
BENCH = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
SMALL = dict(n_cams=8, n_lmks=120, seed=0)
BLOCKS7 = dict(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True)
TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
FULL = ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id")
WINDOWED = ("relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
            "scatter_windows_cm")
ROWS = ("messages_cm", "relin_cm", "fused_messages", "fused_relin_messages")
UNFUSED = ("relin_cm_tab", "messages_cm_tab", "expand_ell_blk")
UNFUSED_WIN = ("relin_cm_tabblk", "messages_cm_tabblk")
# One sweep of the windowed unfused path.
UNFUSED_WIN_PATH = (*UNFUSED_WIN, "expand_ell_blk", "segsum_cm_blk", "scatter_windows_cm")
ROWS_MODE = ("relin_cm", "messages_cm", "segsum_by_id", "expand_ell_blk")
HALO_KERNELS = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "relin_cm_tabblkg",
                "messages_cm_tabblkg")
# One partition's sweep of the windowed halo path, fused and unfused.
HALO_FUSED_PATH = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "segsum_cm_blk",
                   "scatter_windows_cm", "segsum_by_id")
HALO_UNFUSED_PATH = ("relin_cm_tabblkg", "messages_cm_tabblkg", "expand_ell_blk",
                     "segsum_cm_blk", "scatter_windows_cm", "segsum_by_id")
# The halo paths partition the plain layout (the command lines' choice).
HALO_BUILD = dict(layout="none", cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
HALO_BLOCKS = dict(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
NONLOCAL = dict(n_cams=512, n_lmks=2000, pix_sigma=1.0, seed=0)
# Manhattan pose graphs: the kernel checks' (500 poses fill the 48 KB table
# in float64, 1,000 in float32), the windowed one, the pose path's.
M500 = dict(n_poses=500, seed=0, loop_prob=0.3, loop_radius=3.0, outlier_frac=0.1)
M1000 = dict(n_poses=1000, seed=0, loop_prob=0.3, loop_radius=3.0)
M1500 = dict(n_poses=1500, seed=4, loop_prob=0.5, loop_radius=3.0)
M4000 = dict(n_poses=4000, seed=0, loop_prob=0.3, loop_radius=3.0)
HELIX = dict(n_poses=250, seed=0)
M200 = dict(n_poses=200, seed=1, loop_prob=0.5, loop_radius=3.0)
# Sweeps before a pose graph's kernel checks: with min_linear_iters = 5 rows
# relinearize in sweep 6 and are eligible again from sweep 12 on.
POSE_WARM = 11
DATA = Path(__file__).resolve().parent / "data"
G2O_FILE = DATA / "manhattan_sim.g2o"
LADYBUG = DATA / "ladybug49_sim.txt.gz"
CORRIDOR = DATA / "corridor_sim.txt.gz"
# The reference's command line on ladybug49 (`python ba.py --bal_file
# data/ladybug49_sim.txt.gz --n_iters 100 --oracle`, JAX on a CPU in float32,
# Pallas in interpret mode): the ARE every 10 sweeps, printed beside the
# port's for comparison, not held.
LADYBUG_REFERENCE_CPU = {"": {0: 21.3756, 10: 1.2461, 20: 1.2331, 50: 1.2325, 100: 1.2323},
                         "--optimize_intrinsics": {0: 21.3756, 10: 1.2511, 20: 1.2345,
                                                   50: 1.2338, 60: 1.2337}}
PCFG = pose_graph.default_config()
SOURCE = {**dict.fromkeys(FULL, "gbp_tpu_torch/csrc/messages.cu"),
          **dict.fromkeys(WINDOWED, "gbp_tpu_torch/csrc/windows.cu"),
          **dict.fromkeys(ROWS, "gbp_tpu_torch/csrc/rows.cu"),
          **dict.fromkeys(UNFUSED, "gbp_tpu_torch/csrc/unfused.cu"),
          **dict.fromkeys(UNFUSED_WIN, "gbp_tpu_torch/csrc/unfused_win.cu"),
          **dict.fromkeys(HALO_KERNELS, "gbp_tpu_torch/csrc/halo.cuh")}
REPLACES = {
    "relin_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1118",
    "messages_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1054",
    "segsum_by_id": "gbp_tpu/ops/messages_pallas.py:646",
    "relin_cm_tabblk_ell": "gbp_tpu/ops/messages_pallas.py:1221",
    "messages_cm_tabblk_ell": "gbp_tpu/ops/messages_pallas.py:1162",
    "segsum_cm_blk": "gbp_tpu/ops/messages_pallas.py:1588",
    "scatter_windows_cm": "gbp_tpu/ops/messages_pallas.py:1562",
    "messages_cm": "gbp_tpu/ops/messages_pallas.py:372",
    "relin_cm": "gbp_tpu/ops/messages_pallas.py:404",
    "fused_messages": "gbp_tpu/ops/messages_pallas.py:1796",
    "fused_relin_messages": "gbp_tpu/ops/messages_pallas.py:1871",
    "messages_cm_tab": "gbp_tpu/ops/messages_pallas.py:446",
    "relin_cm_tab": "gbp_tpu/ops/messages_pallas.py:491",
    "expand_ell_blk": "gbp_tpu/ops/messages_pallas.py:1469",
    "messages_cm_tabblk": "gbp_tpu/ops/messages_pallas.py:734",
    "relin_cm_tabblk": "gbp_tpu/ops/messages_pallas.py:787",
    "messages_cm_tabblkg": "gbp_tpu/ops/messages_pallas.py:1348",
    "relin_cm_tabblkg": "gbp_tpu/ops/messages_pallas.py:1396",
    "messages_cm_tabblkg_ell": "gbp_tpu/ops/messages_pallas.py:1700",
    "relin_cm_tabblkg_ell": "gbp_tpu/ops/messages_pallas.py:1748",
}
# The card's published peaks (H100 SXM data sheet): device memory rate and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Arithmetic per factor row, counted from csrc/messages_rows.cuh: the
# distance test of every row (27) and Rodrigues + the 2x9 Jacobian of a
# relinearizing row (about 300); two cavity inverses (6x6 about 430, 3x3 about
# 70), their projections (about 420) and the two emitted messages (about 520).
RELIN_TEST_FLOPS, RELIN_ROW_FLOPS, MESSAGES_ROW_FLOPS = 27, 300, 1440
# Leave the timed venice sweeps out beyond this many seconds of script time.
VENICE_TIMING_DEADLINE_S = 700.0
T_START = time.perf_counter()


def to_device(obj, device):
    """Move every tensor of a (nested) NamedTuple/tuple state to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [to_device(o, device) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def rel_err(got, ref):
    """(max |got - ref| / max |ref|, max |got - ref|)."""
    err = float((got - ref).abs().max())
    return err / max(float(ref.abs().max()), 1e-300), err


def sync(x):
    torch.cuda.synchronize()
    return x


def time_ms(fn, n):
    """Mean ms per call over n calls, by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(inputs, outputs, flops):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of every input read once and every output written once over the
    memory rate, and `flops` over the float32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
                 if isinstance(t, torch.Tensor))
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def are_px(graph, cmg, state, k):
    return float(ba.avg_reprojection_error(graph, sweep_cm.to_gbp_state(cmg, state), k=k))


def check_counts(what, names, sweeps):
    """The kernels `names` were launched `sweeps` times each (or, given a
    dict, its count times `sweeps`), the others not at all, and no plain
    version ran; returns the launch counts."""
    launches, plain = dict(M.COUNTS.kernel), dict(M.COUNTS.plain)
    per = names if isinstance(names, dict) else dict.fromkeys(names, 1)
    want = {k: sweeps * per.get(k, 0) for k in M.KERNELS}
    if launches != want or any(plain.values()):
        raise AssertionError(f"{what} did not run through its kernels: launches {launches} "
                             f"(expected {want}), plain calls {plain}")
    return launches


@contextlib.contextmanager
def plain_versions():
    """Inside, `sweep_cm.sweep` calls the windowed kernels' plain versions
    whatever the device: the reference run beside the kernels' run."""
    # (`segsum_cm_blk` is reached through the messages wrapper, not by name.)
    saved = {name: getattr(sweep_cm, name) for name in WINDOWED if name != "segsum_cm_blk"}
    try:
        for name in saved:
            setattr(sweep_cm, name, getattr(M, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(sweep_cm, name, fn)


def cpu_state(sim, dtype, build_kw, prep_kw):
    """The state after 8 plain sweeps on the CPU (in resident order)."""
    g_cpu, m_cpu = ba.build(sim, dtype=dtype, device="cpu", **build_kw)
    cmg_cpu = sweep_cm.prepare(g_cpu, **prep_kw)
    return sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), CFG, 8)


def widened(cmg, w):
    """`cmg` with every camera window widened to `w` (starts moved down where
    the wider window would pass the padded camera count): still a valid
    windowing, at the shared-memory sizes of wider scenes."""
    dev = cmg.gidx.device
    starts = np.minimum(cmg.win_starts.cpu().numpy(), cmg.win_ncpad - w) // sweep_cm.SUB \
        * sweep_cm.SUB
    if w > cmg.win_ncpad or (starts < 0).any():
        raise ValueError(f"a window of {w} does not fit {cmg.win_ncpad} cameras")
    rows, offsets = M.window_rows_csr(cmg.gidx.cpu().numpy(), starts, w)
    cov_tiles, cov_offsets = M.window_cover_csr(starts, w, cmg.base.vblocks[0].count)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return cmg._replace(win_w=w, win_starts=i32(starts), win_rows=i32(rows),
                        win_offsets=i32(offsets), cov_tiles=i32(cov_tiles),
                        cov_offsets=i32(cov_offsets))


def check_kernels(tag, sim, dtype, dev, build_kw, timings=None, wide=None, prep_kw=None):
    """Phases 3 and 4 for one scene and dtype: the full-table kernels when
    the prepared graph has no windows, the windowed ones when it has (with
    the windows widened to `wide` cameras, if given).
    Returns {kernel: max abs err}."""
    tol = TOL[dtype]
    prep_kw = prep_kw or {}
    st = to_device(cpu_state(sim, dtype, build_kw, prep_kw), dev)
    cmg = sweep_cm.prepare(ba.build(sim, dtype=dtype, **build_kw)[0], **prep_kw)
    if wide:
        cmg = widened(cmg, wide)
    win = bool(cmg.win_w)
    fs = st.f
    deg = cmg.fb.ell_deg
    params = _kernel_params(CFG, dtype)
    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    n_cam = cam_mean.shape[0]
    tag = f"{tag} {str(dtype)[6:]}"
    errs = {}
    if win:
        print(f"[kernels] {tag}: {cmg.mp // M.TILE} tiles, win_w {cmg.win_w} "
              f"({cmg.win_w * M.F_CAM * cam_tab.element_size()} bytes of packed beliefs per "
              f"block), locality sort {'on' if cmg.vperm is not None else 'off'}")

    def compare(name, got, ref, record=True, key=None):
        """Hold every output to the tolerance; `key` files the error under a
        kernel's name and prints one line for the call, not one per output."""
        worst_rel, worst_abs = 0.0, 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if key is None:
                print(f"[kernels] {tag} {name} out{i}: max abs {err:.3e} rel {rel:.3e}")
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        if key is not None:
            print(f"[kernels] {tag} {name}: {len(got)} outputs, max abs {worst_abs:.3e} rel "
                  f"{worst_rel:.3e}")
        if record:
            errs[key or name] = max(errs.get(key or name, 0.0), worst_abs)

    def repeats(name, fn, args, kw, first):
        if not torch.equal(first, sync(fn(*args, **kw))):
            raise AssertionError(f"{name} {tag}: two runs differ")
        print(f"[kernels] {tag} {name}: two runs bitwise equal")

    if win:
        n_relin_name, n_msg_name = "relin_cm_tabblk_ell", "messages_cm_tabblk_ell"
        relin, relin_plain = M.relin_cm_tabblk_ell, M.relin_cm_tabblk_ell_plain
        msgs, msgs_plain = M.messages_cm_tabblk_ell, M.messages_cm_tabblk_ell_plain
        ids, r_kw = (cmg.gidx, cmg.win_starts), dict(deg=deg, win_w=cmg.win_w)
        sum_index = (cmg.win_rows, cmg.win_offsets)
    else:
        n_relin_name, n_msg_name = "relin_cm_tab_ell", "messages_cm_tab_ell"
        relin, relin_plain = M.relin_cm_tab_ell, M.relin_cm_tab_ell_plain
        msgs, msgs_plain = M.messages_cm_tab_ell, M.messages_cm_tab_ell_plain
        ids, r_kw = (cmg.gidx,), dict(deg=deg)
        sum_index = (cmg.seg_rows, cmg.seg_offsets)

    # The median linearization-point distance of the valid rows, as beta,
    # makes half of them relinearize: the beta decision is checked both ways.
    rows = torch.arange(cmg.mp, device=dev) // deg
    x = torch.cat([cam_mean[cmg.gidx.long()], lmk_mean[rows]], 1).T
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    n_valid = int(on.sum())
    for beta in (beta_mid, CFG.beta):  # the config's beta last: its outputs feed on
        relin_args = (_kernel_params(dataclasses.replace(CFG, beta=beta), dtype), cam_mean,
                      lmk_mean, *ids, cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        ref_r = sync(relin_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        print(f"[kernels] {tag} beta {beta:.4g}: {n_relin} of {n_valid} valid rows relinearize")
        if n_relin == 0 or (beta == beta_mid and n_relin == n_valid):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare(n_relin_name, sync(relin(*relin_args, **r_kw)), ref_r)

    lp, jac, r0, srel = ref_r
    msg_args = (params, cam_tab, lmk_tab, *ids, jac, lp, r0, cmg.prec, srel, cmg.act,
                fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1], *sum_index)
    for huber in (None, 1.0):
        ref_m = sync(msgs_plain(*msg_args, huber=huber, **r_kw))
        got_m = sync(msgs(*msg_args, huber=huber, **r_kw))
        compare(n_msg_name, got_m, ref_m)

    if win:
        for name in WINDOWED[:2]:
            print(f"[kernels] {tag} {name}: {M.window_blocks_per_sm(name, cmg.win_w, dtype)} "
                  f"blocks of 256 threads per SM at win_w {cmg.win_w}")

    me, ml = ref_m[0], ref_m[1]
    whole = sync(M.segsum_by_id_plain(me, ml, cmg.seg_rows, cmg.seg_offsets))
    if win:
        blk_args, blk_kw = (me, ml, *sum_index), dict(n_tiles=cmg.mp // M.TILE, w=cmg.win_w)
        part = sync(M.segsum_cm_blk(*blk_args, **blk_kw))
        compare("segsum_cm_blk", (part,), (sync(M.segsum_cm_blk_plain(*blk_args, **blk_kw)),))
        repeats("segsum_cm_blk", M.segsum_cm_blk, blk_args, blk_kw, part)
        sc_args = (part, cmg.win_starts, cmg.cov_tiles, cmg.cov_offsets)
        sc_kw = dict(n_seg=n_cam)
        got_s = sync(M.scatter_windows_cm(*sc_args, **sc_kw))
        compare("scatter_windows_cm", (got_s,),
                (sync(M.scatter_windows_cm_plain(*sc_args, **sc_kw)),))
        compare("scatter_windows_cm vs the whole-table sum", (got_s,), (whole,), record=False)
        repeats("scatter_windows_cm", M.scatter_windows_cm, sc_args, sc_kw, got_s)
    else:
        seg_args = (me, ml, *sum_index)
        got_s = sync(M.segsum_by_id(*seg_args))
        compare("segsum_by_id", (got_s,), (whole,))
        repeats("segsum_by_id", M.segsum_by_id, seg_args, {}, got_s)

    if not win:
        check_row_kernels(tag, cmg, st, ref_r, dtype, compare, timings)
        check_unfused_kernels(tag, cmg, st, dtype, compare, timings)
    else:
        check_unfused_win_kernels(tag, cmg, st, dtype, compare, timings)
    if timings is None:
        return errs
    vals = torch.cat([me, ml])
    gl = cmg.gidx.long()
    zeros = lambda n: torch.zeros((M.F_CAM, n), dtype=dtype, device=dev)
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        (n_relin_name, relin, relin_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * cmg.mp + RELIN_ROW_FLOPS * n_relin_cfg, None),
        (n_msg_name, msgs, msgs_plain, msg_args, dict(huber=None, **r_kw), got_m,
         (MESSAGES_ROW_FLOPS + M.F_CAM) * cmg.mp, None),
    ]
    if win:
        tile_key = (torch.arange(cmg.mp, device=dev) // M.TILE) * cmg.win_w + (
            gl - cmg.win_starts.long().repeat_interleave(M.TILE))
        win_ids = (cmg.win_starts.long()[:, None] + torch.arange(cmg.win_w, device=dev)).reshape(-1)
        part_cm = part.permute(1, 0, 2).reshape(M.F_CAM, -1).contiguous()
        timed += [
            ("segsum_cm_blk", M.segsum_cm_blk, M.segsum_cm_blk_plain, blk_args, blk_kw, (part,),
             M.F_CAM * cmg.mp,
             lambda: zeros(part_cm.shape[1]).index_add_(1, tile_key, vals)),
            # One addition per covering tile, camera and component.
            ("scatter_windows_cm", M.scatter_windows_cm, M.scatter_windows_cm_plain, sc_args,
             sc_kw, (got_s,), M.F_CAM * cmg.cov_tiles.shape[0],
             lambda: zeros(cmg.win_ncpad).index_add_(1, win_ids, part_cm)),
        ]
    else:
        timed.append(("segsum_by_id", M.segsum_by_id, M.segsum_by_id_plain, seg_args, {},
                      (got_s,), M.F_CAM * cmg.mp,
                      lambda: zeros(n_cam).index_add_(1, gl, vals)))
    for name, kern, plain, args, kw, outs, flops, library in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        lib_ms = None if library is None else time_ms(library, 20)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), index_add_ "
              + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))
    return errs


def check_row_kernels(tag, cmg, st, ref_r, dtype, compare, timings):
    """Phase 8 for one scene and dtype, from the state `st` of the full-table
    checks: the four expanded-operand entries against their plain versions.
    `ref_r` is the relinearized state at the config's beta."""
    fs = st.f
    fb = cmg.fb
    dev = fs.lp.device
    rows = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be1, bl1, mean1 = sweep_cm._expand_ell(rows, st.v[fb.vblocks[1]])
    be0, bl0, mean0 = sweep_cm._expand_gather(rows, st.v[fb.vblocks[0]])
    x = torch.cat([mean0, mean1])
    rm = lambda a: a.T.contiguous()  # the same operand, one row per factor
    shape = dict(d0=M.D0, d1=M.D1, z=M.Z)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    n_valid = int(on.sum())

    lp, jac, r0, srel = ref_r
    gen = torch.Generator(device="cpu").manual_seed(0)
    thr = torch.randint(0, 3, (1, cmg.mp), generator=gen).to(dev, dtype)  # 0 = off
    off = 0.3 * (cmg.prec[0] * cmg.prec[1]).sqrt()
    prec_of = {
        (False, False): cmg.prec,
        (False, True): torch.cat([cmg.prec, thr]),
        (True, False): torch.stack([cmg.prec[0], off, off, cmg.prec[1]]),
    }
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for huber, prec_full in ((None, False), (1.0, False), ("row", False), (None, True),
                             (1.0, True)):
        prec = prec_of[(prec_full, huber == "row")]
        kw = dict(prec_full=prec_full, huber=huber, **shape)
        cm_args = (_kernel_params(CFG, dtype), jac, lp, r0, prec, srel, cmg.act, be0, bl0, be1,
                   bl1, *msgs)
        got_cm = sync(M.messages_cm(*cm_args, **kw))
        compare(f"messages_cm[huber={huber}, full={prec_full}]",
                got_cm, sync(M.messages_cm_plain(*cm_args, **kw)), key="messages_cm")
        rm_args = (cm_args[0], *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        got_rm = sync(M.fused_messages(*rm_args, **kw))
        compare(f"fused_messages[huber={huber}, full={prec_full}]",
                got_rm, sync(M.fused_messages_plain(*rm_args, **kw)), key="fused_messages")
        # One body, two layouts: the same bits either way.
        for a, b in zip(got_cm, got_rm):
            if not torch.equal(a.T, b):
                raise AssertionError(f"{tag}: messages_cm and fused_messages differ")

    kw = dict(prec_full=False, huber=None, **shape)
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, x, cmg.z, None, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        r_kw = dict(comp_name=fb.ftype.name, **shape)
        ref = sync(M.relin_cm_plain(*relin_args, **r_kw))
        n_relin = int((ref[3] == 0).sum())
        print(f"[kernels] {tag} rows beta {beta:.4g}: {n_relin} of {n_valid} valid rows "
              f"relinearize")
        if n_relin == 0 or (beta == beta_mid and n_relin == n_valid):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm", sync(M.relin_cm(*relin_args, **r_kw)), ref, key="relin_cm")
        frm_args = (params, rm(x), rm(cmg.z), None, rm(fs.lp), rm(fs.jac), rm(fs.r0),
                    rm(cmg.prec), fs.srel[0], cmg.act[0], *(rm(a) for a in (be0, bl0, be1, bl1)),
                    *(rm(a) for a in msgs))
        frm_kw = dict(comp_name=fb.ftype.name, **kw)
        compare("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
                sync(M.fused_relin_messages_plain(*frm_args, **frm_kw)),
                key="fused_relin_messages")

    if timings is None:
        return
    n_relin_cfg = int((ref_r[3] == 0).sum())
    msg_flops = MESSAGES_ROW_FLOPS * cmg.mp
    relin_flops = RELIN_TEST_FLOPS * cmg.mp + RELIN_ROW_FLOPS * n_relin_cfg
    cm_args = (_kernel_params(CFG, dtype), jac, lp, r0, cmg.prec, srel, cmg.act, be0, bl0, be1,
               bl1, *msgs)
    rm_args = (cm_args[0], *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
               *(rm(a) for a in cm_args[7:]))
    timed = [
        ("messages_cm", M.messages_cm, M.messages_cm_plain, cm_args, kw, msg_flops),
        ("relin_cm", M.relin_cm, M.relin_cm_plain, relin_args, r_kw, relin_flops),
        ("fused_messages", M.fused_messages, M.fused_messages_plain, rm_args, kw, msg_flops),
        ("fused_relin_messages", M.fused_relin_messages, M.fused_relin_messages_plain,
         frm_args, frm_kw, msg_flops + relin_flops),
    ]
    for name, kern, plain, args, t_kw, flops in timed:
        outs = kern(*args, **t_kw)
        ms = time_ms(lambda: kern(*args, **t_kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **t_kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), no single library call")


def check_unfused_kernels(tag, cmg, st, dtype, compare, timings):
    """Phase 12 for one scene and dtype, from the state `st` of the full-table
    checks: `expand_ell_blk`, `relin_cm_tab` and `messages_cm_tab` against
    their plain versions."""
    fs, fb = st.f, cmg.fb
    deg = fb.ell_deg
    dev = fs.lp.device
    vs_c, vs_l = st.v[fb.vblocks[0]], st.v[fb.vblocks[1]]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), fb.dofs[1],
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    cm = sync(M.expand_ell_blk(pk, deg=deg))
    if not torch.equal(cm, sync(M.expand_ell_blk_plain(pk, deg=deg))):
        raise AssertionError(f"expand_ell_blk {tag}: differs from its plain version")
    compare("expand_ell_blk", (cm,), (M.expand_ell_blk_plain(pk, deg=deg),))
    be1, bl1, mean1 = sweep_cm._split(cm, fb.dofs[1])
    mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
    x = torch.cat([mtab[cmg.gidx.long()].T, mean1])
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, mean1, mtab, cmg.gidx, cmg.z, None, fs.lp, fs.jac, fs.r0, fs.srel,
                      cmg.act)
        r_kw = dict(comp_name=fb.ftype.name)
        ref_r = sync(M.relin_cm_tab_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm_tab", sync(M.relin_cm_tab(*relin_args, **r_kw)), ref_r,
                key="relin_cm_tab")
    lp, jac, r0, srel = ref_r
    msg_args = (_kernel_params(CFG, dtype), jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab,
                cmg.gidx, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for huber in (1.0, None):
        got_m = sync(M.messages_cm_tab(*msg_args, huber=huber))
        compare(f"messages_cm_tab[huber={huber}]", got_m,
                sync(M.messages_cm_tab_plain(*msg_args, huber=huber)), key="messages_cm_tab")
    if timings is None:
        return
    rows = torch.arange(cmg.mp, device=dev) // deg
    pk_t = pk.T.contiguous()
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        ("expand_ell_blk", M.expand_ell_blk, M.expand_ell_blk_plain, (pk,), dict(deg=deg), (cm,),
         0, lambda: pk_t.index_select(1, rows)),
        ("relin_cm_tab", M.relin_cm_tab, M.relin_cm_tab_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * cmg.mp + RELIN_ROW_FLOPS * n_relin_cfg, None),
        ("messages_cm_tab", M.messages_cm_tab, M.messages_cm_tab_plain, msg_args,
         dict(huber=None), got_m, MESSAGES_ROW_FLOPS * cmg.mp, None),
    ]
    for name, kern, plain, args, kw, outs, flops, library in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        lib_ms = None if library is None else time_ms(library, 20)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), index_select "
              + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))


def check_unfused_win_kernels(tag, cmg, st, dtype, compare, timings):
    """Phase 17 for one windowed scene and dtype, from the state `st` of the
    windowed checks: `relin_cm_tabblk` (both regimes) and
    `messages_cm_tabblk` (Huber none and scalar) against their plain
    versions, the ELL slot expanded by `expand_ell_blk`; timed with their
    bounds when `timings` is given."""
    fs, fb = st.f, cmg.fb
    deg = fb.ell_deg
    vs_c, vs_l = st.v[fb.vblocks[0]], st.v[fb.vblocks[1]]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), fb.dofs[1],
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    be1, bl1, mean1 = sweep_cm._split(sync(M.expand_ell_blk(pk, deg=deg)), fb.dofs[1])
    mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
    w_kw = dict(win_w=cmg.win_w)
    x = torch.cat([mtab[cmg.gidx.long()].T, mean1])
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, mean1, mtab, cmg.gidx, cmg.win_starts, cmg.z, cmg.args, fs.lp,
                      fs.jac, fs.r0, fs.srel, cmg.act)
        r_kw = dict(comp_name=fb.ftype.name, **w_kw)
        ref_r = sync(M.relin_cm_tabblk_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm_tabblk", sync(M.relin_cm_tabblk(*relin_args, **r_kw)), ref_r,
                key="relin_cm_tabblk")
    lp, jac, r0, srel = ref_r
    msg_args = (_kernel_params(CFG, dtype), jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab,
                cmg.gidx, cmg.win_starts, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1],
                fs.msg_lam[1])
    for huber in (1.0, None):
        got_m = sync(M.messages_cm_tabblk(*msg_args, huber=huber, **w_kw))
        compare(f"messages_cm_tabblk[huber={huber}]", got_m,
                sync(M.messages_cm_tabblk_plain(*msg_args, huber=huber, **w_kw)),
                key="messages_cm_tabblk")
    if timings is None:
        return
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        ("relin_cm_tabblk", M.relin_cm_tabblk, M.relin_cm_tabblk_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * cmg.mp + RELIN_ROW_FLOPS * n_relin_cfg),
        ("messages_cm_tabblk", M.messages_cm_tabblk, M.messages_cm_tabblk_plain, msg_args,
         dict(huber=None, **w_kw), got_m, MESSAGES_ROW_FLOPS * cmg.mp),
    ]
    for name, kern, plain, args, kw, outs, flops in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), no single library call")


def check_pose_kernels(tag, build, dtype, dev, ptimes):
    """Phase 13 for one pose graph and dtype.  `build(dtype, device)` gives
    (graph, means).  From the state after POSE_WARM plain sweeps on the CPU
    (every row is eligible to relinearize in the next), every kernel the graph's shape can
    reach runs against its plain version on identical CUDA inputs: the fused
    table kernels, or the windowed ones where `prepare` cuts windows, the
    unfused ones, the expanded-operand ones in both layouts.  Thresholds:
    the graph's own (per row, or none) and a scalar.  `ptimes` collects the
    kernels' times at this graph's shape."""
    tol = TOL[dtype]
    g_cpu, m_cpu = build(dtype, "cpu")
    cmg_cpu = sweep_cm.prepare(g_cpu)
    st = to_device(sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), PCFG, POSE_WARM),
                   dev)
    graph = build(dtype, dev)[0]
    cmg = sweep_cm.prepare(graph)
    fs, fb = st.f, cmg.fb
    e, deg, model = fb.ell_slot, fb.ell_deg, fb.ftype.name
    g = 1 - e
    shape = dict(d0=fb.dofs[0], d1=fb.dofs[1], z=cmg.z.shape[0])
    own = "row" if fb.huber_arr is not None else fb.huber
    hubers = (own, 1.5) if own is not None else (None, 1.5)
    tag = f"{tag} {str(dtype)[6:]} {tuple(shape.values())}"
    print(f"[kernels] {tag}: {cmg.mp} rows (deg {deg}, ELL slot {e}), mode "
          f"{cmg.gather_mode!r}, win_w {cmg.win_w}, thresholds {own!r}")
    by_slot = lambda a_g, a_e: (a_g, a_e) if g == 0 else (a_e, a_g)
    worst = {}

    def hold(name, got, ref):
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst[name] = max(worst.get(name, 0.0), rel)

    def timed(name, fn):
        if dtype == torch.float32:
            ptimes.setdefault(name, {})[tuple(shape.values())] = time_ms(fn, 20)

    vs_c, vs_l = sweep_cm._slot_states(cmg, st)
    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    x = sweep_cm.expand_means(cmg, st)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    betas = (beta_mid, PCFG.beta)
    params_at = lambda beta: _kernel_params(dataclasses.replace(PCFG, beta=beta), dtype)
    params = params_at(PCFG.beta)
    state_ops = (cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    prec_of = lambda h: cmg.prec if h == own else cmg.prec[:shape["z"]].contiguous()

    def both_regimes(name, ref_of):
        """The plain version's output at the config's beta, after checking
        that the median distance as beta splits the valid rows."""
        n_mid = int((sync(ref_of(beta_mid))[3] == 0).sum())
        ref = sync(ref_of(PCFG.beta))
        print(f"[kernels] {tag} {name}: {n_mid} of {int(on.sum())} valid rows relinearize at "
              f"beta {beta_mid:.4g}, {int((ref[3] == 0).sum())} at {PCFG.beta}")
        if not 0 < n_mid < int(on.sum()):
            raise AssertionError(f"{tag} {name}: the relinearization check needs both kinds "
                                 f"of rows")
        return ref

    # Fused table kernels, whole table or windows.
    if cmg.win_w:
        w_kw = dict(deg=deg, win_w=cmg.win_w, gslot=g)
        r_args = lambda beta: (params_at(beta), cam_mean, lmk_mean, cmg.gidx, cmg.win_starts,
                               *state_ops)
        for beta in betas:
            hold("relin_cm_tabblk_ell",
                 sync(M.relin_cm_tabblk_ell(*r_args(beta), comp_name=model, **w_kw)),
                 M.relin_cm_tabblk_ell_plain(*r_args(beta), comp_name=model, **w_kw))
        ref_r = both_regimes("relin_cm_tabblk_ell", lambda beta: M.relin_cm_tabblk_ell_plain(
            *r_args(beta), comp_name=model, **w_kw))
        lp, jac, r0, srel = ref_r
        for h in hubers:
            m_args = (params, cam_tab, lmk_tab, cmg.gidx, cmg.win_starts, jac, lp, r0,
                      prec_of(h), srel, cmg.act, *msgs, cmg.win_rows, cmg.win_offsets)
            ref_m = sync(M.messages_cm_tabblk_ell_plain(*m_args, huber=h, **w_kw))
            got_m = sync(M.messages_cm_tabblk_ell(*m_args, huber=h, **w_kw))
            hold("messages_cm_tabblk_ell", got_m[:4], ref_m[:4])
            hold("segsum_cm_blk", got_m[4:], ref_m[4:])
        sc_args = (got_m[4], cmg.win_starts, cmg.cov_tiles, cmg.cov_offsets)
        n_g = cam_mean.shape[0]
        got_s = sync(M.scatter_windows_cm(*sc_args, n_seg=n_g))
        hold("scatter_windows_cm", (got_s,), (M.scatter_windows_cm_plain(*sc_args, n_seg=n_g),))
        hold("scatter_windows_cm", (got_s,), (M.segsum_by_id_plain(
            ref_m[2 * g], ref_m[2 * g + 1], cmg.seg_rows, cmg.seg_offsets),))
        timed("messages_cm_tabblk_ell", lambda: M.messages_cm_tabblk_ell(*m_args, huber=h, **w_kw))
        timed("relin_cm_tabblk_ell", lambda: M.relin_cm_tabblk_ell(
            *r_args(PCFG.beta), comp_name=model, **w_kw))
    elif cmg.gather_mode == "table":
        t_kw = dict(deg=deg, gslot=g)
        r_args = lambda beta: (params_at(beta), cam_mean, lmk_mean, cmg.gidx, *state_ops)
        for beta in betas:
            hold("relin_cm_tab_ell",
                 sync(M.relin_cm_tab_ell(*r_args(beta), comp_name=model, **t_kw)),
                 M.relin_cm_tab_ell_plain(*r_args(beta), comp_name=model, **t_kw))
        ref_r = both_regimes("relin_cm_tab_ell", lambda beta: M.relin_cm_tab_ell_plain(
            *r_args(beta), comp_name=model, **t_kw))
        lp, jac, r0, srel = ref_r
        for h in hubers:
            m_args = (params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, prec_of(h), srel,
                      cmg.act, *msgs, cmg.seg_rows, cmg.seg_offsets)
            ref_m = sync(M.messages_cm_tab_ell_plain(*m_args, huber=h, **t_kw))
            got_m = sync(M.messages_cm_tab_ell(*m_args, huber=h, **t_kw))
            hold("messages_cm_tab_ell", got_m[:4], ref_m[:4])
            hold("segsum_by_id", got_m[4:], ref_m[4:])
        timed("messages_cm_tab_ell", lambda: M.messages_cm_tab_ell(*m_args, huber=h, **t_kw))
        timed("relin_cm_tab_ell", lambda: M.relin_cm_tab_ell(
            *r_args(PCFG.beta), comp_name=model, **t_kw))
    else:
        raise AssertionError(f"{tag}: prepare chose {cmg.gather_mode!r}; the check needs a table")

    # Expansion, then the unfused kernels (where the whole table fits) and
    # the expanded-operand kernels in both layouts.
    d_e = fb.dofs[e]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), d_e,
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    cm = sync(M.expand_ell_blk(pk, deg=deg))
    if not torch.equal(cm, M.expand_ell_blk_plain(pk, deg=deg)):
        raise AssertionError(f"expand_ell_blk {tag}: differs from its plain version")
    worst["expand_ell_blk"] = 0.0
    be_l, bl_l, mean_l = sweep_cm._split(cm, d_e)
    if not cmg.win_w:
        mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
        u_args = lambda beta: (params_at(beta), mean_l, mtab, cmg.gidx, cmg.z, None, *state_ops[1:])
        for beta in betas:
            hold("relin_cm_tab", sync(M.relin_cm_tab(*u_args(beta), comp_name=model, gslot=g)),
                 M.relin_cm_tab_plain(*u_args(beta), comp_name=model, gslot=g))
        for h in hubers:
            m_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be_l, bl_l, btab,
                      cmg.gidx, *msgs)
            hold("messages_cm_tab", sync(M.messages_cm_tab(*m_args, huber=h, gslot=g)),
                 M.messages_cm_tab_plain(*m_args, huber=h, gslot=g))
        timed("messages_cm_tab", lambda: M.messages_cm_tab(*m_args, huber=h, gslot=g))
    else:
        mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
        w_kw = dict(win_w=cmg.win_w, gslot=g)
        u_args = lambda beta: (params_at(beta), mean_l, mtab, cmg.gidx, cmg.win_starts, cmg.z,
                               None, *state_ops[1:])
        for beta in betas:
            hold("relin_cm_tabblk",
                 sync(M.relin_cm_tabblk(*u_args(beta), comp_name=model, **w_kw)),
                 M.relin_cm_tabblk_plain(*u_args(beta), comp_name=model, **w_kw))
        for h in hubers:
            m_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be_l, bl_l, btab,
                      cmg.gidx, cmg.win_starts, *msgs)
            hold("messages_cm_tabblk", sync(M.messages_cm_tabblk(*m_args, huber=h, **w_kw)),
                 M.messages_cm_tabblk_plain(*m_args, huber=h, **w_kw))
        timed("messages_cm_tabblk", lambda: M.messages_cm_tabblk(*m_args, huber=h, **w_kw))
    rows_cmg = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be_c, bl_c, mean_c = sweep_cm._expand_gather(rows_cmg, vs_c)
    (be0, be1), (bl0, bl1) = by_slot(be_c, be_l), by_slot(bl_c, bl_l)
    x_cm = torch.cat(by_slot(mean_c, mean_l))
    rm = lambda a: a.T.contiguous()
    for beta in betas:
        rr_args = (params_at(beta), x_cm, cmg.z, None, *state_ops[1:])
        rr_kw = dict(comp_name=model, **shape)
        hold("relin_cm", sync(M.relin_cm(*rr_args, **rr_kw)), M.relin_cm_plain(*rr_args, **rr_kw))
        frm_args = (params_at(beta), rm(x_cm), rm(cmg.z), None, rm(fs.lp), rm(fs.jac), rm(fs.r0),
                    rm(cmg.prec), fs.srel[0], cmg.act[0],
                    *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
        frm_kw = dict(prec_full=False, huber=own, comp_name=model, **shape)
        hold("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
             M.fused_relin_messages_plain(*frm_args, **frm_kw))
    for h in hubers:
        cm_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be0, bl0, be1, bl1, *msgs)
        kw = dict(prec_full=False, huber=h, **shape)
        got_cm = sync(M.messages_cm(*cm_args, **kw))
        hold("messages_cm", got_cm, M.messages_cm_plain(*cm_args, **kw))
        rm_args = (params, *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        got_rm = sync(M.fused_messages(*rm_args, **kw))
        hold("fused_messages", got_rm, M.fused_messages_plain(*rm_args, **kw))
        for a, b in zip(got_cm, got_rm):
            if not torch.equal(a.T, b):
                raise AssertionError(f"{tag}: messages_cm and fused_messages differ")
    # Full precision in the row-major layout, as the generic engine hands a
    # g2o file's information matrices over.
    zd = shape["z"]
    full = torch.diag_embed(rm(cmg.prec[:zd])).reshape(cmg.mp, zd * zd).contiguous()
    fp_args = (params, *(rm(a) for a in (jac, lp, r0)), full, srel[0], cmg.act[0],
               *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
    fp_kw = dict(prec_full=True, huber=None, **shape)
    hold("fused_messages", sync(M.fused_messages(*fp_args, **fp_kw)),
         M.fused_messages_plain(*fp_args, **fp_kw))
    timed("messages_cm", lambda: M.messages_cm(*cm_args, **kw))
    timed("fused_messages", lambda: M.fused_messages(*rm_args, **kw))
    print(f"[kernels] {tag}: worst rel err per kernel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {tol:g})")


def check_bal_kernels(tag, intrinsics, dtype, dev):
    """Phase 18 on ladybug49 for one camera model and dtype: from the state
    after 8 plain sweeps on the CPU, every relinearization and messages
    entry the BAL graph reaches (the full-table kernels, the unfused table
    kernels with the expansion, the expanded-operand kernels in both
    layouts) against its plain version on identical CUDA inputs, with the
    BAL model's per-row arguments [k1, k2] (6-dof cameras) or at (9, 3, 2)
    (9-dof cameras); relinearization in both regimes, Huber none and
    scalar; the windowed entries with one window of all cameras per
    tile."""
    tol = TOL[dtype]
    sim = bal.to_sim(bal.prune(bal.read_bal(LADYBUG)))
    build = lambda device: ba.build_bal(sim, dtype=dtype, device=device,
                                        optimize_intrinsics=intrinsics)[:2]
    g_cpu, m_cpu = build("cpu")
    cmg_cpu = sweep_cm.prepare(g_cpu)
    st = to_device(sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), CFG, 8), dev)
    cmg = sweep_cm.prepare(build(dev)[0])
    fs, fb = st.f, cmg.fb
    model, deg = fb.ftype.name, fb.ell_deg
    shape = dict(d0=fb.dofs[0], d1=fb.dofs[1], z=cmg.z.shape[0])
    tag = f"{tag} {str(dtype)[6:]} {tuple(shape.values())}"
    if cmg.gather_mode != "table" or cmg.win_w or not cmg.ell_fused:
        raise AssertionError(f"{tag}: prepare chose {cmg.gather_mode!r}, win_w {cmg.win_w}")
    print(f"[kernels] {tag}: {model}, {cmg.mp} rows (deg {deg}), args "
          f"{None if cmg.args is None else tuple(cmg.args.shape)}")
    worst = {}

    def hold(name, got, ref):
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, _ = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst[name] = max(worst.get(name, 0.0), rel)

    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    x = sweep_cm.expand_means(cmg, st)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    params_at = lambda beta: _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
    params = params_at(CFG.beta)
    state_ops = (cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for beta in (beta_mid, CFG.beta):
        r_args = (params_at(beta), cam_mean, lmk_mean, cmg.gidx, *state_ops)
        r_kw = dict(deg=deg, comp_name=model, fargs=cmg.args)
        ref_r = sync(M.relin_cm_tab_ell_plain(*r_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        hold("relin_cm_tab_ell", sync(M.relin_cm_tab_ell(*r_args, **r_kw)), ref_r)
    lp, jac, r0, srel = ref_r
    for h in (None, 1.0):
        m_args = (params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, cmg.prec, srel, cmg.act, *msgs,
                  cmg.seg_rows, cmg.seg_offsets)
        hold("messages_cm_tab_ell", sync(M.messages_cm_tab_ell(*m_args, deg=deg, huber=h)),
             M.messages_cm_tab_ell_plain(*m_args, deg=deg, huber=h))
    vs_c, vs_l = st.v[0], st.v[1]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), 3,
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    be1, bl1, mean1 = sweep_cm._split(sync(M.expand_ell_blk(pk, deg=deg)), 3)
    mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
    for beta in (beta_mid, CFG.beta):
        u_args = (params_at(beta), mean1, mtab, cmg.gidx, cmg.z, cmg.args, *state_ops[1:])
        hold("relin_cm_tab", sync(M.relin_cm_tab(*u_args, comp_name=model)),
             M.relin_cm_tab_plain(*u_args, comp_name=model))
    for h in (None, 1.0):
        m_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab, cmg.gidx, *msgs)
        hold("messages_cm_tab", sync(M.messages_cm_tab(*m_args, huber=h)),
             M.messages_cm_tab_plain(*m_args, huber=h))
    rows_cmg = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be0, bl0, mean0 = sweep_cm._expand_gather(rows_cmg, vs_c)
    x_cm = torch.cat([mean0, mean1])
    rm = lambda a: None if a is None else a.T.contiguous()
    for beta in (beta_mid, CFG.beta):
        rr_args = (params_at(beta), x_cm, cmg.z, cmg.args, *state_ops[1:])
        hold("relin_cm", sync(M.relin_cm(*rr_args, comp_name=model, **shape)),
             M.relin_cm_plain(*rr_args, comp_name=model, **shape))
        frm_args = (params_at(beta), rm(x_cm), rm(cmg.z), rm(cmg.args), rm(fs.lp), rm(fs.jac),
                    rm(fs.r0), rm(cmg.prec), fs.srel[0], cmg.act[0],
                    *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
        frm_kw = dict(prec_full=False, huber=None, comp_name=model, **shape)
        hold("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
             M.fused_relin_messages_plain(*frm_args, **frm_kw))
    for h in (None, 1.0):
        cm_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be0, bl0, be1, bl1, *msgs)
        kw = dict(prec_full=False, huber=h, **shape)
        hold("messages_cm", sync(M.messages_cm(*cm_args, **kw)), M.messages_cm_plain(*cm_args, **kw))
        rm_args = (params, *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        hold("fused_messages", sync(M.fused_messages(*rm_args, **kw)),
             M.fused_messages_plain(*rm_args, **kw))
    # The windowed entries on the same operands, every tile's window holding
    # all cameras (the BAL files have too few for windows of their own).
    n_tiles = cmg.mp // M.TILE
    w = -(-cam_mean.shape[0] // sweep_cm.SUB) * sweep_cm.SUB
    starts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    win_rows, win_offsets = (torch.tensor(a, device=dev) for a in M.window_rows_csr(
        cmg.gidx.cpu().numpy(), np.zeros(n_tiles, dtype=np.int64), w))
    w_kw = dict(win_w=w)
    for beta in (beta_mid, CFG.beta):
        r_args = (params_at(beta), cam_mean, lmk_mean, cmg.gidx, starts, *state_ops)
        r_kw = dict(deg=deg, comp_name=model, fargs=cmg.args, **w_kw)
        hold("relin_cm_tabblk_ell", sync(M.relin_cm_tabblk_ell(*r_args, **r_kw)),
             M.relin_cm_tabblk_ell_plain(*r_args, **r_kw))
        u_args = (params_at(beta), mean1, mtab, cmg.gidx, starts, cmg.z, cmg.args,
                  *state_ops[1:])
        hold("relin_cm_tabblk", sync(M.relin_cm_tabblk(*u_args, comp_name=model, **w_kw)),
             M.relin_cm_tabblk_plain(*u_args, comp_name=model, **w_kw))
    for h in (None, 1.0):
        m_args = (params, cam_tab, lmk_tab, cmg.gidx, starts, jac, lp, r0, cmg.prec, srel,
                  cmg.act, *msgs, win_rows, win_offsets)
        hold("messages_cm_tabblk_ell",
             sync(M.messages_cm_tabblk_ell(*m_args, deg=deg, huber=h, **w_kw)),
             M.messages_cm_tabblk_ell_plain(*m_args, deg=deg, huber=h, **w_kw))
        u_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab, cmg.gidx, starts,
                  *msgs)
        hold("messages_cm_tabblk", sync(M.messages_cm_tabblk(*u_args, huber=h, **w_kw)),
             M.messages_cm_tabblk_plain(*u_args, huber=h, **w_kw))
    print(f"[kernels] {tag}: worst rel err per kernel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {tol:g})")


def check_scatter_dense(dev):
    """`scatter_windows_cm` against a dense accumulation in tile order, with
    overlapping windows, a repeated start and a window reaching into the
    padded tail of the camera range."""
    n_tiles, f, w, n_seg, ncpad = 7, M.F_CAM, 128, 1280, 1536
    rng = np.random.default_rng(7)
    starts = np.sort(rng.integers(0, (ncpad - w) // 8 + 1, size=n_tiles)) * 8
    starts[1] = starts[0]
    starts[-1] = ncpad - w
    cov_tiles, cov_offsets = M.window_cover_csr(starts, w, n_seg)
    for dtype, atol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        part = torch.tensor(rng.normal(size=(n_tiles, f, w)), dtype=dtype, device=dev)
        want = torch.zeros((f, ncpad), dtype=dtype, device=dev)
        for i, s in enumerate(starts):
            want[:, s:s + w] += part[i]
        got = sync(M.scatter_windows_cm(
            part, torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(cov_tiles, device=dev), torch.tensor(cov_offsets, device=dev),
            n_seg=n_seg))
        err = float((got - want[:, :n_seg]).abs().max())
        print(f"[kernels] scatter_windows_cm vs dense accumulation {str(dtype)[6:]}: starts "
              f"{starts.tolist()}, max abs {err:.3e}")
        if not err <= atol:
            raise AssertionError(f"scatter_windows_cm vs dense: {err:.3e} > {atol:g}")


def window_vs_full():
    """Phase 5: one scene through the windowed and the full-table kernels."""
    sim = ba.simulate_blocks(**BLOCKS7)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    n = 15
    ares, states = {}, {}
    for window, names in ((True, WINDOWED), (False, FULL)):
        cmg = sweep_cm.prepare(graph, window=window)
        if bool(cmg.win_w) != window or (cmg.vperm is not None) != window:
            raise AssertionError(f"prepare(window={window}) gave win_w {cmg.win_w}")
        M.COUNTS.reset()
        st = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, n))
        check_counts(f"window={window}", names, n)
        states[window] = sweep_cm.to_gbp_state(cmg, st)
        ares[window] = are_px(graph, cmg, st, sim["k"])
    diff = max(float((a.mean - b.mean).abs().max())
               for a, b in zip(states[True].v, states[False].v))
    print(f"[paths] 280 cams in 7 blocks f32, {n} sweeps: ARE windowed {ares[True]:.6f} px, "
          f"full table {ares[False]:.6f} px; largest difference of the means {diff:.3e}")
    if not abs(ares[True] - ares[False]) <= 5e-3:
        raise AssertionError(f"windowed and full-table ARE differ: {ares}")


def timed_sweeps(tag, cmg, init, n, n_valid, card, cfg=CFG):
    """Time n sweeps from `init`; returns the seconds per sweep."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync(sweep_cm.run(cmg, init, cfg, n))
    dt = time.perf_counter() - t0
    print(f"[{tag}] timed {n} sweeps: {dt:.4f} s -> {n / dt:.2f} sweeps/s, "
          f"{dt / n / n_valid * 1e9:.4f} ns per valid factor (informational; {card}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return dt / n


def bench_path(card):
    """Phase 6.  Built on the default device: the card."""
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    n_valid = graph.fblocks[0].n_valid
    print(f"[main] bench scene on {means[0].device}: {BENCH['n_cams']} cams, "
          f"{sim['lmk_init'].shape[0]} lmks, {n_valid} factors in {cmg.mp} rows "
          f"(deg {cmg.fb.ell_deg})")
    init = sweep_cm.init_state(cmg, means)
    torch.cuda.synchronize()

    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts("the bench path", FULL, SWEEPS)
    print(f"[main] {SWEEPS} sweeps (first call) in {t_first:.3f} s; launches {launches}; "
          f"plain calls 0")

    are = are_px(graph, cmg, state, sim["k"])
    mu = means
    for _ in range(6):
        mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
    are_map = float(ba.avg_reprojection_error(
        graph, ba.with_means(sweep_cm.to_gbp_state(cmg, state), mu), k=sim["k"]))
    print(f"[main] ARE after {SWEEPS} sweeps {are:.6f} px; MAP (6 Gauss-Newton steps) "
          f"{are_map:.6f} px; ratio {are / are_map:.6f}")
    if not (are == are and are_map == are_map and are <= 1.05 * are_map):
        raise AssertionError(f"ARE {are} not within 1.05x of MAP ARE {are_map}")

    again = sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    for vi, (a, b) in enumerate(zip(state.v, again.v)):
        if not torch.equal(a.mean, b.mean):
            raise AssertionError(f"rerun from the same init differs (variable block {vi})")
    print("[main] rerun from the same init: means bitwise equal")
    timed_sweeps("main", cmg, init, SWEEPS, n_valid, card)
    return launches


def big_path(tag, scene, card, against_plain):
    """Phase 7 for one merged-blocks scene, through the entry points a user
    calls, on the default device."""
    t0 = time.perf_counter()
    sim = ba.simulate_blocks(**scene)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, segsum_exact=True, window=True)
    n_valid = graph.fblocks[0].n_valid
    if not cmg.win_w or cmg.vperm is None:
        raise AssertionError(f"{tag}: the windows did not engage through the locality sort")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    torch.cuda.synchronize()
    print(f"[{tag}] scene on {means[0].device}: {sim['cam_init'].shape[0]} cams, "
          f"{sim['lmk_init'].shape[0]} lmks, {n_valid} factors in {cmg.mp} rows (deg "
          f"{cmg.fb.ell_deg}); {cmg.mp // M.TILE} tiles, win_w {cmg.win_w}, "
          f"{cmg.cov_tiles.shape[0]} window covers; built and prepared in "
          f"{time.perf_counter() - t0:.1f} s; initial ARE {are0:.6f} px")

    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts(f"the {tag} path", WINDOWED, QUALITY_SWEEPS)
    are = are_px(graph, cmg, state, sim["k"])
    print(f"[{tag}] {QUALITY_SWEEPS} sweeps (first call) in {t_first:.3f} s; launches "
          f"{launches}; plain calls 0; ARE {are:.6f} px")
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag}: ARE {are} is not finite and below the initial {are0}")

    if against_plain:
        with plain_versions():
            ref = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        are_ref = are_px(graph, cmg, ref, sim["k"])
        print(f"[{tag}] the same {QUALITY_SWEEPS} sweeps through the plain versions on the "
              f"card: ARE {are_ref:.6f} px (difference {abs(are - are_ref):.3e})")
        if not abs(are - are_ref) <= 1e-2:
            raise AssertionError(f"{tag}: ARE {are} vs plain versions' {are_ref}")
        again = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        for vi, (a, b) in enumerate(zip(state.v, again.v)):
            if not torch.equal(a.mean, b.mean):
                raise AssertionError(f"{tag}: rerun from the same init differs (block {vi})")
        print(f"[{tag}] rerun from the same init: means bitwise equal")
        mu = means
        for _ in range(6):
            mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
        are_gn = float(ba.avg_reprojection_error(
            graph, ba.with_means(sweep_cm.to_gbp_state(cmg, state), mu), k=sim["k"]))
        print(f"[{tag}] ARE of 6 Gauss-Newton steps on the card {are_gn:.6f} px "
              f"(informational)")

    late = time.perf_counter() - T_START > VENICE_TIMING_DEADLINE_S
    n = QUALITY_SWEEPS if late else SWEEPS
    if late:
        print(f"[{tag}] past {VENICE_TIMING_DEADLINE_S:.0f} s of script time: timing {n} "
              f"sweeps instead of {SWEEPS}")
    per_sweep = timed_sweeps(tag, cmg, init, n, n_valid, card)
    return launches, (are, per_sweep)


def map_are(graph, state, means, k):
    """The ARE of 6 Gauss-Newton steps from `means`, on the card."""
    mu = means
    for _ in range(6):
        mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
    return float(ba.avg_reprojection_error(graph, ba.with_means(state, mu), k=k))


def same_means(what, a, b):
    for vi, (x, y) in enumerate(zip(a.v, b.v)):
        if not torch.equal(x.mean, y.mean):
            raise AssertionError(f"{what}: rerun from the same init differs (variable block {vi})")
    print(f"[{what}] rerun from the same init: means bitwise equal")


def generic_path(card):
    """Phase 9.  Built on the default device: the card."""
    cfg = dataclasses.replace(CFG, message_form="pallas")
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32, layout="ell")
    fb = graph.fblocks[0]
    print(f"[generic] bench scene on {means[0].device}: {fb.n_valid} factors in {fb.count} "
          f"row-major rows (ELL by landmark, deg {fb.ell_deg}), message_form 'pallas'")
    init = sweep.init_state(graph, means)
    are = lambda g, st: float(ba.avg_reprojection_error(g, st, k=sim["k"]))
    are50 = are(graph, sync(sweep.run(graph, init, cfg, QUALITY_SWEEPS)))

    per_sweep = {"fused_relin_messages": 1, "fused_messages": 1, "segsum_by_id": 1}
    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep.run(graph, init, cfg, SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts("the generic path", per_sweep, SWEEPS)
    a, a_map = are(graph, state), map_are(graph, state, means, sim["k"])
    print(f"[generic] {SWEEPS} sweeps (first call) in {t_first:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls 0; ARE {a:.6f} px; MAP "
          f"{a_map:.6f} px; ratio {a / a_map:.6f}; ARE at {QUALITY_SWEEPS} sweeps {are50:.6f} px")
    if not (a == a and a_map == a_map and a <= 1.05 * a_map):
        raise AssertionError(f"generic path: ARE {a} not within 1.05x of MAP ARE {a_map}")
    same_means("generic", state, sync(sweep.run(graph, init, cfg, SWEEPS)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync(sweep.run(graph, init, cfg, SWEEPS))
    dt = time.perf_counter() - t0
    print(f"[generic] timed {SWEEPS} sweeps: {dt:.4f} s -> {SWEEPS / dt:.2f} sweeps/s, "
          f"{dt / SWEEPS / fb.n_valid * 1e9:.4f} ns per valid factor (informational; {card}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    flat, means_n = ba.build(sim, dtype=torch.float32, layout="none")
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st_n = sync(sweep.run(flat, sweep.init_state(flat, means_n), cfg, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    check_counts("the generic path, layout none", {**per_sweep, "segsum_by_id": 2},
                 QUALITY_SWEEPS)
    a_n = are(flat, st_n)
    print(f"[generic] layout none, {QUALITY_SWEEPS} sweeps in {dt:.3f} s "
          f"({QUALITY_SWEEPS / dt:.2f} sweeps/s, first call): ARE {a_n:.6f} px vs ELL "
          f"{are50:.6f} px")
    if not abs(a_n - are50) <= 1e-3:
        raise AssertionError(f"generic path: layout none ARE {a_n} vs ELL {are50}")
    return launches


def rows_path(card):
    """Phase 10.  Built on the default device: the card."""
    sim = ba.simulate(**NONLOCAL)
    graph, means = ba.build(sim, dtype=torch.float32)
    cmg = sweep_cm.prepare(graph)
    n_valid = graph.fblocks[0].n_valid
    n_cam = graph.vblocks[0].count
    if cmg.gather_mode != "rows" or cmg.win_w:
        raise AssertionError(f"nonlocal512: prepare chose {cmg.gather_mode!r}, win_w {cmg.win_w}")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    print(f"[rows] nonlocal512 on {means[0].device}: {n_cam} cams "
          f"({n_cam * M.F_CAM * 4} bytes of packed beliefs, shared-memory table limit "
          f"{sweep_cm.SMEM_TABLE_BYTES}), {sim['lmk_init'].shape[0]} lmks, {n_valid} factors in "
          f"{cmg.mp} rows (deg {cmg.fb.ell_deg}); gather_mode {cmg.gather_mode!r}; initial ARE "
          f"{are0:.6f} px")
    names = ROWS_MODE
    M.COUNTS.reset()
    st50 = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    launches = check_counts("the rows path", names, QUALITY_SWEEPS)
    a50 = are_px(graph, cmg, st50, sim["k"])
    print(f"[rows] {QUALITY_SWEEPS} sweeps: launches { {k: launches[k] for k in names} }; plain "
          f"calls 0; ARE {a50:.6f} px")
    if not (math.isfinite(a50) and a50 < are0):
        raise AssertionError(f"rows path: ARE {a50} is not finite and below the initial {are0}")
    same_means("rows", st50, sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS)))
    st = sync(sweep_cm.run(cmg, st50, CFG, SWEEPS - QUALITY_SWEEPS))
    a = are_px(graph, cmg, st, sim["k"])
    a_map = map_are(graph, sweep_cm.to_gbp_state(cmg, st), means, sim["k"])
    print(f"[rows] ARE after {SWEEPS} sweeps {a:.6f} px; MAP (6 Gauss-Newton steps) "
          f"{a_map:.6f} px; ratio {a / a_map:.6f}: "
          + ("within 1.05x of the MAP ARE" if a <= 1.05 * a_map else
             "NOT within 1.05x of the MAP ARE (informational at this scene)"))
    if not math.isfinite(a):
        raise AssertionError(f"rows path: ARE {a} after {SWEEPS} sweeps")
    timed_sweeps("rows", cmg, init, SWEEPS, n_valid, card)

    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    ares = {}
    for mode in ("table", "rows", "take1"):
        cmg = sweep_cm.prepare(graph, gather_mode=mode)
        if cmg.gather_mode != mode:
            raise AssertionError(f"prepare(gather_mode={mode!r}) gave {cmg.gather_mode!r}")
        init = sweep_cm.init_state(cmg, means)
        sync(sweep_cm.run(cmg, init, CFG, 5))
        M.COUNTS.reset()
        t0 = time.perf_counter()
        st = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        dt = time.perf_counter() - t0
        check_counts(f"bench64 {mode}", FULL if mode == "table" else names, QUALITY_SWEEPS)
        ares[mode] = are_px(graph, cmg, st, sim["k"])
        print(f"[rows] bench64 gather_mode {mode!r}: {QUALITY_SWEEPS} sweeps in {dt:.4f} s "
              f"({QUALITY_SWEEPS / dt:.2f} sweeps/s), ARE {ares[mode]:.6f} px")
    if not all(abs(ares[m] - ares["table"]) <= 1e-3 for m in ares):
        raise AssertionError(f"gather modes disagree at bench64: {ares}")
    return launches


def unfused_path(card):
    """Phase 14.  Built on the default device: the card."""
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    n_valid = graph.fblocks[0].n_valid
    n = QUALITY_SWEEPS
    out = {}
    for fused, names in ((True, FULL), (False, (*UNFUSED, "segsum_by_id"))):
        cmg = sweep_cm.prepare(graph, ell_fused=fused)
        if cmg.ell_fused != fused or cmg.gather_mode != "table" or cmg.win_w:
            raise AssertionError(f"prepare(ell_fused={fused}) gave ell_fused {cmg.ell_fused}, "
                                 f"mode {cmg.gather_mode!r}, win_w {cmg.win_w}")
        init = sweep_cm.init_state(cmg, means)
        sync(sweep_cm.run(cmg, init, CFG, 5))
        M.COUNTS.reset()
        t0 = time.perf_counter()
        st = sync(sweep_cm.run(cmg, init, CFG, n))
        dt = time.perf_counter() - t0
        launches = check_counts(f"bench64 ell_fused={fused}", names, n)
        out[fused] = (are_px(graph, cmg, st, sim["k"]), dt, launches, cmg, init, st)
    (a_f, dt_f, _, _, _, _), (a_u, dt_u, launches, cmg, init, st) = out[True], out[False]
    print(f"[unfused] bench64, {n} sweeps, ell_fused=False: launches "
          f"{ {k: launches[k] for k in (*UNFUSED, 'segsum_by_id')} }; plain calls 0; ARE "
          f"{a_u:.6f} px vs fused {a_f:.6f} px; {dt_u / n * 1e3:.4f} ms per sweep "
          f"({n / dt_u:.2f} sweeps/s) vs fused {dt_f / n * 1e3:.4f} ms ({n / dt_f:.2f} sweeps/s) "
          f"({card})")
    if not (math.isfinite(a_u) and abs(a_u - a_f) <= 1e-3):
        raise AssertionError(f"unfused path: ARE {a_u} vs the fused path's {a_f}")
    same_means("unfused", st, sync(sweep_cm.run(cmg, init, CFG, n)))
    timed_sweeps("unfused", cmg, init, SWEEPS, n_valid, card)
    return launches


def unfused_big_path(tag, scene, card, fused):
    """Phase 19 for one merged-blocks scene: `prepare(window=True,
    ell_fused=False)`, the windowed unfused kernels (kernels 8 and 9 of the
    reference) with the expansion and the windowed camera sum.  `fused` is
    (ARE after QUALITY_SWEEPS sweeps, seconds per sweep) of the fused
    windowed run of `big_path`; with `against_fused` the ARE is held to
    1e-3 px of it and a rerun must repeat bit for bit."""
    sim = ba.simulate_blocks(**scene)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, window=True, ell_fused=False)
    n_valid = graph.fblocks[0].n_valid
    if not cmg.win_w or cmg.ell_fused or cmg.gather_mode != "table":
        raise AssertionError(f"{tag}: prepare(ell_fused=False) gave win_w {cmg.win_w}, "
                             f"ell_fused {cmg.ell_fused}, mode {cmg.gather_mode!r}")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    sync(sweep_cm.run(cmg, init, CFG, 2))
    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    launches = check_counts(f"the {tag} unfused path", UNFUSED_WIN_PATH, QUALITY_SWEEPS)
    are = are_px(graph, cmg, state, sim["k"])
    print(f"[{tag}_unfused] {n_valid} factors in {cmg.mp} rows, win_w {cmg.win_w}: "
          f"{QUALITY_SWEEPS} sweeps, launches { {k: launches[k] for k in UNFUSED_WIN_PATH} }; "
          f"plain calls 0; ARE {are0:.6f} -> {are:.6f} px vs fused {fused[0]:.6f} px; "
          f"{dt / QUALITY_SWEEPS * 1e3:.4f} ms per sweep ({QUALITY_SWEEPS / dt:.2f} sweeps/s) vs "
          f"fused {fused[1] * 1e3:.4f} ms ({1 / fused[1]:.2f} sweeps/s) ({card})")
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag} unfused: ARE {are} is not finite and below {are0}")
    if tag == "city":
        if not abs(are - fused[0]) <= 1e-3:
            raise AssertionError(f"city unfused: ARE {are} vs the fused path's {fused[0]}")
        same_means("city_unfused", state, sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS)))
    return launches


def bal_path(card):
    """Phase 20: the BA command line (`python -m gbp_tpu_torch.ba`) in this
    process, on the card: ladybug49 with and without its intrinsics in the
    state, 100 annealed sweeps and the dense MAP; then the corridor file
    under the full default schedule."""
    out = {}
    for extra in ("", "--optimize_intrinsics"):
        argv = ["--bal_file", str(LADYBUG), "--n_iters", "100", "--oracle", *extra.split()]
        M.COUNTS.reset()
        res = ba_cli.main(argv)
        launches = check_counts(f"ladybug49 {extra or 'fixed intrinsics'}", FULL, 100)
        final, are_map = res["are"][-1][1], res["are_map"]
        ref = LADYBUG_REFERENCE_CPU[extra]
        print(f"[bal] ladybug49 {extra or '(fixed intrinsics)'}: launches "
              f"{ {k: launches[k] for k in FULL} }; plain calls 0; ARE per 10 sweeps on the card "
              f"vs the reference's CPU run: "
              + ", ".join(f"{i}: {a:.4f}" + (f" ({ref[i]:.4f})" if i in ref else "")
                          for i, a in res["are"])
              + f"; final {final:.6f} px, dense MAP {are_map:.6f} px, ratio "
              f"{final / are_map:.6f}; {res['sweeps_per_s']:.2f} sweeps/s ({card})")
        if not (math.isfinite(final) and final <= 1.05 * are_map):
            raise AssertionError(f"ladybug49 {extra}: ARE {final} not within 1.05x of {are_map}")
        again = ba_cli.main([a for a in argv if a != "--oracle"])
        same_means(f"ladybug49 {extra or 'fixed'}", res["state"], again["state"])
        out[extra] = launches
    res = ba_cli.main(["--bal_file", str(CORRIDOR), "--prior_prec", "1000"])
    ares = [a for _, a in res["are"]]
    print(f"[bal] corridor_sim, prior_prec 1000, float32, default schedule: ARE "
          + ", ".join(f"{a:.4f}" for a in ares))
    if not (all(map(math.isfinite, ares)) and ares[-1] < ares[0]):
        raise AssertionError(f"corridor: ARE {ares} not finite and falling")
    return out[""]


def annealed_city(card):
    """Phase 21: `run_annealed_cm` on the city scene, 50 sweeps through the
    windowed kernels under the default schedule (the reference's
    tests/test_table_window.py runs the same on its city scene)."""
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, window=True)
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st = sync(anneal.run_annealed_cm(cmg, init, CFG, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    check_counts("annealed city", WINDOWED, QUALITY_SWEEPS)
    are = are_px(graph, cmg, st, sim["k"])
    print(f"[anneal] city, {QUALITY_SWEEPS} annealed sweeps in {dt:.3f} s (first call): ARE "
          f"{are0:.6f} -> {are:.6f} px ({card})")
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"annealed city: ARE {are} not finite and below {are0}")


def mode_kernels(cmg):
    """The kernels one sweep of the prepared graph launches, once each."""
    if cmg.gather_mode != "table":
        return ROWS_MODE
    if not cmg.ell_fused:
        return UNFUSED_WIN_PATH if cmg.win_w else (*UNFUSED, "segsum_by_id")
    return WINDOWED if cmg.win_w else FULL


def pose_run(tag, graph, means, truth, n, card, prep_kw=None, timed=False, gate=1.0):
    """Prepare a pose graph, run `n` sweeps through the kernels (launch
    counts checked, plain calls 0), return (cmg, state, ATE, initial ATE,
    launch counts).  The ATE must be finite and below `gate` times the
    initial one (None: finite)."""
    cmg = sweep_cm.prepare(graph, **(prep_kw or {}))
    if cmg is None:
        raise AssertionError(f"{tag}: prepare declined the graph")
    fb = graph.fblocks[0]
    init = sweep_cm.init_state(cmg, means)
    ate0 = pose_graph.ate(means[0], truth)
    torch.cuda.synchronize()
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st = sync(sweep_cm.run(cmg, init, PCFG, n))
    dt = time.perf_counter() - t0
    launches = check_counts(tag, mode_kernels(cmg), n)
    ate = pose_graph.ate(st.v[0].mean, truth)
    print(f"[pose] {tag} on {means[0].device}: {graph.vblocks[0].count} poses, {fb.n_valid} "
          f"factors in {cmg.mp} rows (deg {fb.ell_deg}, ELL slot {fb.ell_slot}), mode "
          f"{cmg.gather_mode!r}, ell_fused {cmg.ell_fused}, win_w {cmg.win_w}; {n} sweeps (first "
          f"call) in {dt:.3f} s; launches { {k: v for k, v in launches.items() if v} }; plain "
          f"calls 0; ATE {ate0:.6f} -> {ate:.6f}")
    if not (math.isfinite(ate) and (gate is None or ate < gate * ate0)):
        raise AssertionError(f"{tag}: ATE {ate} is not finite and below {gate} x the initial "
                             f"{ate0}")
    if timed:
        same_means(tag, st, sync(sweep_cm.run(cmg, init, PCFG, n)))
        timed_sweeps(tag, cmg, init, n, fb.n_valid, card, PCFG)
    return cmg, st, ate, ate0, launches


def pose_path(card):
    """Phase 15.  Built on the default device: the card."""
    f32 = torch.float32
    sim = pose_graph.simulate_manhattan(**M4000)
    graph, means = pose_graph.build(sim, layout="ell")
    n_poses = M4000["n_poses"]
    n_g = graph.vblocks[0].count
    print(f"[pose] manhattan4000: {n_g * 12 * 4} bytes of packed pose beliefs, shared-memory "
          f"table limit {sweep_cm.SMEM_TABLE_BYTES}")
    cmg, st, ate, ate0, launches = pose_run("manhattan4000", graph, means, sim["truth"], 400,
                                            card, timed=True)
    if not all(launches[k] == 400 for k in mode_kernels(cmg)):
        raise AssertionError(f"manhattan4000 launched {launches}")
    t0 = time.perf_counter()
    mu = sync(schur.solve_pcg(graph, means, n_steps=8, cg_iters=max(1000, n_poses // 2)))
    ate_gn = pose_graph.ate(mu[0], sim["truth"])
    target = 1.25 * ate_gn + 0.02
    print(f"[pose] manhattan4000 Gauss-Newton target (8 PCG steps of "
          f"{max(1000, n_poses // 2)} iterations on the card, {time.perf_counter() - t0:.1f} s): "
          f"ATE_GN {ate_gn:.6f}; bar 1.25 x ATE_GN + 0.02 = {target:.6f}")
    if not math.isfinite(ate_gn):
        raise AssertionError(f"pose path: ATE_GN {ate_gn}")
    chunk, reached, traj = 50, None, []
    state = sweep_cm.init_state(cmg, means)
    t0 = time.perf_counter()
    for i in range(6000 // chunk):
        state = sync(sweep_cm.run(cmg, state, PCFG, chunk))
        a = pose_graph.ate(state.v[0].mean, sim["truth"])
        traj.append(round(a, 4))
        if a <= target:
            reached = ((i + 1) * chunk, time.perf_counter() - t0)
            break
    print("[pose] manhattan4000 ATE per 50 sweeps " + str(traj[:20]) + ": "
          + (f"at or below the bar at sweep {reached[0]} ({reached[1]:.3f} s of wall clock)"
             if reached else "did NOT reach the bar within 6000 sweeps (throughput only)"))

    # 200 poses, the graph of the reference's float32 test: half the initial
    # ATE within 150 sweeps.
    sim = pose_graph.simulate_manhattan(**M200)
    graph, means = pose_graph.build(sim, layout="ell")
    pose_run("manhattan200", graph, means, sim["truth"], 150, card, gate=0.5)

    # 1,000 poses: the largest table that fits shared memory; fused against
    # unfused.  Its diameter is far beyond 150 sweeps (the ATE is still in its
    # transient, and may pass above the initial one), so only the two runs'
    # agreement is held.
    sim = pose_graph.simulate_manhattan(**M1000)
    graph, means = pose_graph.build(sim, layout="ell")
    runs = {}
    for fused in (True, False):
        cmg, st, ate, ate0, _ = pose_run(f"manhattan1000 ell_fused={fused}", graph, means,
                                         sim["truth"], 150, card, prep_kw=dict(ell_fused=fused),
                                         gate=None)
        if cmg.gather_mode != "table" or cmg.ell_fused != fused:
            raise AssertionError(f"manhattan1000: mode {cmg.gather_mode!r}, ell_fused "
                                 f"{cmg.ell_fused}")
        runs[fused] = st.v[0].mean
    diff = float((runs[True] - runs[False]).abs().max())
    print(f"[pose] manhattan1000 fused vs unfused, 150 sweeps: largest difference of the means "
          f"{diff:.3e}")
    if not diff <= 1e-4:
        raise AssertionError(f"manhattan1000: fused and unfused means differ by {diff}")

    # 1,500 poses: chain locality engages the windows.
    sim = pose_graph.simulate_manhattan(**M1500)
    graph, means = pose_graph.build(sim, layout="ell")
    ates = {}
    for window in (True, False):
        cmg, st, ates[window], _, _ = pose_run(f"manhattan1500 window={window}", graph, means,
                                               sim["truth"], QUALITY_SWEEPS, card,
                                               prep_kw=dict(window=window))
        if bool(cmg.win_w) != window:
            raise AssertionError(f"manhattan1500: prepare(window={window}) gave win_w {cmg.win_w}")
    if not abs(ates[True] - ates[False]) <= 1e-3:
        raise AssertionError(f"manhattan1500: windowed ATE {ates[True]} vs {ates[False]}")

    # SE(3): a 250-pose helix, diagonal information, table mode.
    data = pose_graph.simulate_helix(**HELIX)
    graph, means = pose_graph.build_g2o(data, dtype=f32, layout="ell")
    # Its initial estimate is the truth plus 5 cm of noise, and the first
    # hundreds of sweeps of the schedule move the chain away from it before it
    # settles (0.085 -> 0.89 at 100 sweeps in the reference as well): the ATE is
    # held finite, not falling.
    pose_run("helix250 (SE(3))", graph, means, data["truth"], 100, card, gate=None)

    # A g2o file with full information matrices: the generic engine.
    data = g2o.read_g2o(G2O_FILE)
    graph, means = pose_graph.build_g2o(data, huber=2.0, dtype=f32, layout="ell")
    if sweep_cm.prepare(graph) is not None:
        raise AssertionError("manhattan_sim.g2o: prepare took a full-precision graph")
    cfg = dataclasses.replace(PCFG, message_form="pallas")
    state = sweep.init_state(graph, means)
    e0 = float(sweep.energy(graph, state))
    M.COUNTS.reset()
    state = sync(sweep.run(graph, state, cfg, 100))
    got = {k: v for k, v in M.COUNTS.kernel.items() if v}
    e1 = float(sweep.energy(graph, state))
    print(f"[pose] {G2O_FILE.name} ({data['kind']}, {data['poses'].shape[0]} poses, "
          f"{data['edges_ij'].shape[0]} edges, full information): generic engine, 100 sweeps, "
          f"launches {got}, plain calls {sum(M.COUNTS.plain.values())}; energy {e0:.3f} -> "
          f"{e1:.3f}")
    if any(M.COUNTS.plain.values()) or got.get("fused_relin_messages") != 100:
        raise AssertionError(f"g2o path did not run through its kernels: {got}")
    if not (math.isfinite(e1) and e1 < e0):
        raise AssertionError(f"g2o path: energy {e0} -> {e1}")


def linear_path():
    """Phase 11: a linear chain, where GBP is exact, through the (1, 1, 1)
    instantiation of the row-major messages kernel, in float64."""
    n, sweeps = 50, 300
    graph, means = toy.build(toy.simulate(n=n), dtype=torch.float64)
    cfg = sweep.GBPConfig(message_form="pallas")
    M.COUNTS.reset()
    state = sync(sweep.run(graph, sweep.init_state(graph, means), cfg, sweeps))
    # The smoothness block goes through the kernel; its two slots and the
    # unary block's one are summed by the deterministic segment sum.
    check_counts("the linear path", {"fused_messages": 1, "segsum_by_id": 3}, sweeps)
    err = float((state.v[0].mean - oracle.map_solution(graph, state)[0]).abs().max())
    print(f"[linear] toy chain of {n} on {means[0].device}, float64, {sweeps} sweeps under "
          f"message_form 'pallas': largest difference from the dense MAP solution {err:.3e}")
    if not err <= 1e-9:
        raise AssertionError(f"linear path: {err:.3e} from the oracle")


# --- the halo paths (phases 22 and 23) ------------------------------------------------


def halo_mode_kernels(hcm):
    """The kernels one partition's sweep launches, once each."""
    if hcm.gather_mode != "table":
        return ROWS_MODE
    if hcm.win_w:
        return HALO_FUSED_PATH if hcm.ell_fused else HALO_UNFUSED_PATH
    return FULL if hcm.ell_fused else (*UNFUSED, "segsum_by_id")


def halo_widened(hcm, w):
    """`hcm` with every partition's owned-camera windows widened to `w`
    (starts moved down where the wider window would pass the padded owned
    count): still a valid windowing, at the shared-memory sizes of wider
    scenes."""
    dev = hcm.gidx.device
    no = hcm.comm[hcm.vb_g].n_own_max
    nopad = -(-no // sweep_cm.SUB) * sweep_cm.SUB
    starts = np.minimum(hcm.win_starts.cpu().numpy(), nopad - w) // sweep_cm.SUB * sweep_cm.SUB
    if w > nopad or (starts < 0).any():
        raise ValueError(f"a window of {w} does not fit {nopad} owned cameras")
    gidx = hcm.gidx.cpu().numpy()
    csr = [M.window_rows_csr(gidx[c], starts[c], w, n_own=no) for c in range(len(starts))]
    cov = [M.window_cover_csr(starts[c], w, no) for c in range(len(starts))]
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
    n_cov = max(len(a) for a, _ in cov)
    pad = lambda a: np.pad(a, (0, n_cov - len(a)))
    return hcm._replace(win_w=w, win_starts=i32(starts),
                        win_rows=i32(np.stack([a for a, _ in csr])),
                        win_offsets=i32(np.stack([b for _, b in csr])),
                        cov_tiles=i32(np.stack([pad(a) for a, _ in cov])),
                        cov_offsets=i32(np.stack([b for _, b in cov])))


def halo_state(sim, dtype, n_parts, sweeps):
    """The halo_cm partition of `sim` (plain layout) and its state after
    `sweeps` plain sweeps on the CPU, both moved to the card."""
    g, m = ba.build(sim, dtype=dtype, device="cpu", **HALO_BUILD)
    hp, hcm, st, run = halo_cm.distribute(g, m, n_parts, device="cpu")
    st = run(hcm, st, CFG, sweeps)
    return halo.to_device(hcm, "cuda"), halo.to_device(st, "cuda")


def check_halo_kernels(tag, hcm, st, dtype, errs, timings=None):
    """Phase 22 for one partitioned scene and dtype: per partition, kernels
    12, 13, 17 and 18 against their plain versions on the operands the halo
    sweep hands them (relinearization at the median distance and at the
    config's beta, messages with and without Huber); timed on partition 0
    when `timings` is given."""
    tol = TOL[dtype]
    tag = f"{tag} {str(dtype)[6:]}"
    d_e = hcm.dofs[hcm.e]
    f_e = d_e + d_e * d_e
    gslot = 1 - hcm.e
    no = hcm.comm[hcm.vb_g].n_own_max
    tab_e, mean_e, tab_g, mean_g, gtab_g, gmean_g = halo_cm.belief_tables(hcm, st)
    wkw = dict(win_w=hcm.win_w, n_own=no, gslot=gslot)
    print(f"[halo kernels] {tag}: {hcm.z.shape[0]} partitions, {hcm.mp // M.TILE} tiles each, "
          f"win_w {hcm.win_w} ({hcm.win_w * M.F_CAM * tab_g.element_size()} bytes of packed "
          f"beliefs per block), ghost table {gtab_g.shape[1]} rows, cut cameras {hcm.n_cut}")

    def compare(name, got, ref):
        worst_rel, worst_abs = 0.0, 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        print(f"[halo kernels] {tag} {name}: {len(got)} outputs, max abs {worst_abs:.3e} rel "
              f"{worst_rel:.3e}")
        errs[name] = max(errs.get(name, 0.0), worst_abs)

    for p in range(hcm.z.shape[0]):
        fs = sweep_cm.CMFactorState(*(halo._at(x, p) for x in st.f))
        cm_e = sync(M.expand_ell_blk(torch.cat([tab_e[p], mean_e[p]], 1), deg=hcm.deg))
        be_e, bl_e, x_e = cm_e[:d_e], cm_e[d_e:f_e], cm_e[f_e:]
        state_r = (fs.lp, fs.jac, fs.r0, fs.srel, hcm.act[p])
        msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
        x = halo_cm.expand_means(hcm, st)[p]
        on = hcm.act[p, 0] > 0.5
        beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
        calls = {}
        for beta in (beta_mid, CFG.beta):  # the config's beta last: its outputs feed on
            params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
            calls["relin_cm_tabblkg_ell"] = (
                (params, mean_g[p, :no], gmean_g[p], mean_e[p], hcm.gidx[p], hcm.win_starts[p],
                 hcm.z[p], *state_r),
                dict(deg=hcm.deg, comp_name=hcm.comp_name, fargs=None, **wkw))
            calls["relin_cm_tabblkg"] = (
                (params, x_e, mean_g[p, :no], gmean_g[p], hcm.gidx[p], hcm.win_starts[p],
                 hcm.z[p], None, *state_r), dict(comp_name=hcm.comp_name, **wkw))
            for name in ("relin_cm_tabblkg_ell", "relin_cm_tabblkg"):
                args, kw = calls[name]
                ref_r = sync(getattr(M, name + "_plain")(*args, **kw))
                n_relin, n_on = int((ref_r[3] == 0).sum()), int(on.sum())
                if n_relin == 0 or (beta == beta_mid and n_relin == n_on):
                    raise AssertionError(f"{tag}: the relinearization check needs both kinds "
                                         f"of rows")
                compare(name, sync(getattr(M, name)(*args, **kw)), ref_r)
        lp, jac, r0, srel = ref_r
        head = (jac, lp, r0, hcm.prec[p], srel, hcm.act[p])
        for huber in (None, 1.0):
            params = _kernel_params(CFG, dtype)
            calls["messages_cm_tabblkg_ell"] = (
                (params, tab_g[p, :no], gtab_g[p], tab_e[p], hcm.gidx[p], hcm.win_starts[p],
                 *head, *msgs), dict(deg=hcm.deg, huber=huber, **wkw))
            calls["messages_cm_tabblkg"] = (
                (params, *head, be_e, bl_e, tab_g[p, :no], gtab_g[p], hcm.gidx[p],
                 hcm.win_starts[p], *msgs), dict(huber=huber, **wkw))
            for name in ("messages_cm_tabblkg_ell", "messages_cm_tabblkg"):
                args, kw = calls[name]
                compare(name, sync(getattr(M, name)(*args, **kw)),
                        sync(getattr(M, name + "_plain")(*args, **kw)))
        if timings is None or p:
            continue
        n_relin_cfg = int((ref_r[3] == 0).sum())
        for name in HALO_KERNELS:
            args, kw = calls[name]
            kern, plain = getattr(M, name), getattr(M, name + "_plain")
            outs = sync(kern(*args, **kw))
            flops = (RELIN_TEST_FLOPS * hcm.mp + RELIN_ROW_FLOPS * n_relin_cfg
                     if name.startswith("relin") else MESSAGES_ROW_FLOPS * hcm.mp)
            ms = time_ms(lambda: kern(*args, **kw), 20)
            plain_ms = time_ms(lambda: plain(*args, **kw), 3)
            b_ms, b_by = bound_ms(args, outs, flops)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
            print(f"[halo kernels] {tag} {name} (partition 0, huber 1.0): kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no single library "
                  f"call")


def halo_run(tag, graph, means, k, n_parts, card, are_single=None, ell_fused=None, timed=True):
    """Phase 23 for one BA scene: `halo_cm.distribute` on the card, 50 sweeps
    through the partition's kernels (launch counts P per sweep, plain calls
    0), ARE finite and below the initial one (and within 5e-3 px of the
    one-device run when given), a bitwise rerun, sweeps/s, peak memory and
    the collective volume.  Returns the launch counts."""
    t0 = time.perf_counter()
    hp, hcm, init, run = halo_cm.distribute(graph, means, n_parts, ell_fused=ell_fused)
    tmpl = sweep.init_state(graph, means)
    are_of = lambda st: float(ba.avg_reprojection_error(
        graph, ba.with_means(tmpl, halo.collect_means(hp, st)), k=k))
    are0 = are_of(init)
    torch.cuda.synchronize()
    print(f"[halo] {tag}: {n_parts} partitions of {hcm.mp} rows (deg {hcm.deg}), gather mode "
          f"{hcm.gather_mode}, win_w {hcm.win_w}, ell_fused {hcm.ell_fused}, owned cameras "
          f"{hcm.comm[hcm.vb_g].n_own_max} and ghost cameras {hcm.comm[hcm.vb_g].n_ghost_max} "
          f"per partition, cut cameras {hcm.n_cut or 'none'}; distributed in "
          f"{time.perf_counter() - t0:.1f} s; initial ARE {are0:.6f} px; collective bytes "
          f"{halo.collective_bytes(hp)}")
    M.COUNTS.reset()
    state = sync(run(hcm, init, CFG, QUALITY_SWEEPS))
    launches = check_counts(f"the {tag} halo path",
                            dict.fromkeys(halo_mode_kernels(hcm), n_parts), QUALITY_SWEEPS)
    are = are_of(state)
    print(f"[halo] {tag}: {QUALITY_SWEEPS} sweeps, launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls 0; ARE {are:.6f} px"
          + ("" if are_single is None else f" (one device {are_single:.6f} px, difference "
             f"{abs(are - are_single):.3e})"))
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag}: ARE {are} is not finite and below the initial {are0}")
    if are_single is not None and not abs(are - are_single) <= 5e-3:
        raise AssertionError(f"{tag}: ARE {are} vs one device's {are_single}")
    same_means(f"halo {tag}", state, sync(run(hcm, init, CFG, QUALITY_SWEEPS)))
    if timed:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sync(run(hcm, init, CFG, QUALITY_SWEEPS))
        dt = time.perf_counter() - t0
        print(f"[halo] {tag}: timed {QUALITY_SWEEPS} sweeps {dt:.4f} s -> "
              f"{QUALITY_SWEEPS / dt:.2f} sweeps/s ({card}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def halo_path(card, are_city):
    """Phase 23: the owner-sharded halo paths through the entry points a
    user calls, the P partitions in one process on the card."""
    out = {}
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    out["fused"] = halo_run("city1280 P=2", graph, means, sim["k"], 2, card, are_city)
    out["unfused"] = halo_run("city1280 P=2 unfused", graph, means, sim["k"], 2, card,
                              are_city, ell_fused=False)
    halo_run("city1280 P=4", graph, means, sim["k"], 4, card, timed=False)
    del graph, means
    torch.cuda.empty_cache()
    sim = ba.simulate_blocks(**VENICE)
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    halo_run("venice10240 P=4", graph, means, sim["k"], 4, card)
    del graph, means
    torch.cuda.empty_cache()

    # python -m gbp_tpu_torch.slam --n_poses 4000 --n_iters 100 --n_chips 2
    M.COUNTS.reset()
    res = slam_cli.main(["--n_poses", "4000", "--n_iters", "100", "--n_chips", "2"])
    hcm = res["hcm"]
    launches = check_counts("slam --n_chips 2", dict.fromkeys(halo_mode_kernels(hcm), 2), 100)
    ate0, ate = res["ate0"], res["ate"][-1][1]
    print(f"[halo] slam manhattan4000 --n_chips 2: gather mode {hcm.gather_mode} (slot "
          f"{1 - hcm.e} gathered), launches { {k: v for k, v in launches.items() if v} }, "
          f"plain calls 0; ATE {ate0:.6f} -> {ate:.6f}; {res['sweeps_per_s']:.2f} sweeps/s "
          f"({card})")
    if not (math.isfinite(ate) and ate <= ate0):
        raise AssertionError(f"slam --n_chips 2: ATE {ate} not finite and at or below {ate0}")

    # python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz --n_iters 100
    #   --n_chips 2 --oracle, against the same command on one device.
    argv = ["--bal_file", str(LADYBUG), "--n_iters", "100", "--oracle"]
    one = ba_cli.main(argv)
    M.COUNTS.reset()
    two = ba_cli.main([*argv, "--n_chips", "2"])
    hcm = two["hcm"]
    launches = check_counts("ba --n_chips 2", dict.fromkeys(halo_mode_kernels(hcm), 2), 100)
    a1, a2 = one["are"][-1][1], two["are"][-1][1]
    print(f"[halo] ladybug49 --n_chips 2: path {two['path']} ({hcm.gather_mode}, ell_fused "
          f"{hcm.ell_fused}), launches { {k: v for k, v in launches.items() if v} }; ARE per 10 "
          f"sweeps " + ", ".join(f"{i}: {a:.4f}" for i, a in two["are"])
          + f"; final {a2:.6f} px against {a1:.6f} on one device (difference "
          f"{abs(a2 - a1):.3e}); dense MAP {two['are_map']:.6f} / {one['are_map']:.6f} px; "
          f"{two['sweeps_per_s']:.2f} sweeps/s ({card})")
    if not abs(a2 - a1) <= 1e-3:
        raise AssertionError(f"ladybug49 --n_chips 2: ARE {a2} vs one device's {a1}")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = gbp_tpu_torch.default_device()
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    gbp_tpu_torch.set_exact_f32()

    t0 = time.perf_counter()
    _, compile_s = _build.build()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {compile_s:.2f} s)")
    # One line per kernel instantiation of ptxas's report: mangled name (its
    # template arguments follow the kernel's name), registers, spilled bytes.
    for name, stores, loads, regs in re.findall(
            r"Compiling entry function '_ZN3gbp\d+([^']+)' for 'sm_90a'\n(?:.*\n)*?.*?(\d+) bytes "
            r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
            _build.ptxas_report()):
        print(f"[build] {regs:>3} registers, spills {stores}/{loads} bytes: {name[:60]}")

    timings, errs = {}, {}
    f64, f32 = torch.float64, torch.float32
    # (scene, build arguments, dtypes, widened window; the last dtype's run is
    # timed and kept for the JSON line when `keep`).  The widened runs stage
    # more than 48 KB per block (dynamic shared memory): 86,016 bytes at 256
    # cameras in float64, 64,512 at 384 in float32.
    city = ba.simulate_blocks(**CITY)
    checks = [
        ("8cam", ba.simulate(**SMALL), {}, (f64, f32), None, False),
        ("64cam", ba.simulate(**BENCH), {}, (f64, f32), None, True),
        ("280cam", ba.simulate_blocks(**BLOCKS7), BIG, (f64, f32), None, False),
        ("280cam wide", ba.simulate_blocks(**BLOCKS7), BIG, (f64,), 256, False),
        ("280cam no windows", ba.simulate_blocks(**BLOCKS7), BIG, (f32,), None, False),
        ("city wide", city, BIG, (f32,), 384, False),
        ("city", city, BIG, (f32,), None, True),
    ]
    for tag, sim, build_kw, dtypes, wide, keep in checks:
        prep_kw = dict(window=False) if tag.endswith("no windows") else None
        for dtype in dtypes:
            last = keep and dtype is dtypes[-1]
            e = check_kernels(tag, sim, dtype, dev, build_kw, timings if last else None, wide,
                              prep_kw)
            if last:
                errs.update(e)
        print(f"[kernels] {tag} done at {time.perf_counter() - T_START:.1f} s")
    check_scatter_dense(dev)
    window_vs_full()

    # Pose-graph shapes: (3, 3, 3) with per-row thresholds, (6, 6, 6).
    ptimes = {}
    m500, m1000 = (pose_graph.simulate_manhattan(**kw) for kw in (M500, M1000))
    m1500 = pose_graph.simulate_manhattan(**M1500)
    helix = pose_graph.simulate_helix(**HELIX)
    se2 = lambda sim: lambda dt, dv: pose_graph.build(sim, dtype=dt, layout="ell", device=dv)
    se3 = lambda dt, dv: pose_graph.build_g2o(helix, dtype=dt, layout="ell", device=dv)
    for tag, build, dtypes in (("manhattan500", se2(m500), (f64,)),
                               ("manhattan1000", se2(m1000), (f32,)),
                               ("manhattan1500", se2(m1500), (f64, f32)),
                               ("helix120", lambda dt, dv: pose_graph.build_g2o(
                                   pose_graph.simulate_helix(n_poses=120, seed=0), dtype=dt,
                                   layout="ell", device=dv), (f64,)),
                               ("helix250", se3, (f32,))):
        for dtype in dtypes:
            check_pose_kernels(tag, build, dtype, dev, ptimes)
    for name, by_shape in ptimes.items():
        print(f"[kernels] {name} at the pose-graph shapes, float32 ({card}): "
              + ", ".join(f"{shape} {ms:.4f} ms" for shape, ms in by_shape.items()))
    print(f"[kernels] pose shapes done at {time.perf_counter() - T_START:.1f} s")

    # The BAL models: per-row arguments at (6, 3, 2), the 9-dof camera.
    for intrinsics in (False, True):
        for dtype in (f64, f32):
            check_bal_kernels("ladybug49", intrinsics, dtype, dev)
    print(f"[kernels] BAL models done at {time.perf_counter() - T_START:.1f} s")

    launches = bench_path(card)
    unfused = unfused_path(card)
    city, city_fused = big_path("city", CITY, card, against_plain=True)
    city_unfused = unfused_big_path("city", CITY, card, city_fused)
    torch.cuda.empty_cache()
    venice, venice_fused = big_path("venice", VENICE, card, against_plain=False)
    if any(venice[k] != city[k] for k in WINDOWED):
        raise AssertionError(f"venice launches {venice} differ from the city's {city}")
    unfused_big_path("venice", VENICE, card, venice_fused)
    launches = {**{k: launches[k] for k in FULL}, **{k: city[k] for k in WINDOWED},
                **{k: city_unfused[k] for k in UNFUSED_WIN}}
    torch.cuda.empty_cache()
    annealed_city(card)
    bal_path(card)

    # The halo paths' kernels against their plain versions, then the paths.
    other = {}
    for dtype in (f64, f32):
        hcm, st = halo_state(ba.simulate_blocks(**HALO_BLOCKS), dtype, 2, 8)
        check_halo_kernels("blocks1280 P=2", hcm, st, dtype, other)
    hcm, st = halo_state(ba.simulate_blocks(**CITY), f32, 2, 8)
    check_halo_kernels("city P=2", hcm, st, f32, errs, timings)
    check_halo_kernels("city P=2 wide", halo_widened(hcm, 384), st, f32, other)
    del hcm, st
    torch.cuda.empty_cache()
    print(f"[halo kernels] done at {time.perf_counter() - T_START:.1f} s")
    halo_launches = halo_path(card, city_fused[0])
    launches.update({k: halo_launches["fused"][k] for k in HALO_KERNELS[:2]},
                    **{k: halo_launches["unfused"][k] for k in HALO_KERNELS[2:]})
    print(f"[halo] done at {time.perf_counter() - T_START:.1f} s")
    generic = generic_path(card)
    rows = rows_path(card)
    linear_path()
    pose_path(card)
    launches.update({k: generic[k] for k in ROWS[2:]}, **{k: rows[k] for k in ROWS[:2]},
                    **{k: unfused[k] for k in UNFUSED})
    print(f"[done] {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name], **timings[name]}
        for name in M.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
