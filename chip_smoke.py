#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's paths on one GPU: the bundle-adjustment fast
paths (camera table, windows, expanded operands) and the generic engine.

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
 12. the kernels' JSON line, the card line, and the last line
     {"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import json
import math
import re
import sys
import time

import numpy as np
import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD as BIG
from gbp_tpu_torch.bench import CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import oracle, sweep, sweep_cm
from gbp_tpu_torch.core.sweep import _kernel_params
from gbp_tpu_torch.models import ba, toy
from gbp_tpu_torch.ops import _build
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import schur

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
NONLOCAL = dict(n_cams=512, n_lmks=2000, pix_sigma=1.0, seed=0)
SOURCE = {**dict.fromkeys(FULL, "gbp_tpu_torch/csrc/messages.cu"),
          **dict.fromkeys(WINDOWED, "gbp_tpu_torch/csrc/windows.cu"),
          **dict.fromkeys(ROWS, "gbp_tpu_torch/csrc/rows.cu")}
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


def cpu_state(sim, dtype, build_kw):
    """The state after 8 plain sweeps on the CPU (in resident order)."""
    g_cpu, m_cpu = ba.build(sim, dtype=dtype, device="cpu", **build_kw)
    cmg_cpu = sweep_cm.prepare(g_cpu)
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


def check_kernels(tag, sim, dtype, dev, build_kw, timings=None, wide=None):
    """Phases 3 and 4 for one scene and dtype: the full-table kernels when
    the prepared graph has no windows, the windowed ones when it has (with
    the windows widened to `wide` cameras, if given).
    Returns {kernel: max abs err}."""
    tol = TOL[dtype]
    st = to_device(cpu_state(sim, dtype, build_kw), dev)
    cmg = sweep_cm.prepare(ba.build(sim, dtype=dtype, **build_kw)[0])
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


def timed_sweeps(tag, cmg, init, n, n_valid, card):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync(sweep_cm.run(cmg, init, CFG, n))
    dt = time.perf_counter() - t0
    print(f"[{tag}] timed {n} sweeps: {dt:.4f} s -> {n / dt:.2f} sweeps/s, "
          f"{dt / n / n_valid * 1e9:.4f} ns per valid factor (informational; {card}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


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
    timed_sweeps(tag, cmg, init, n, n_valid, card)
    return launches


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
    names = ("relin_cm", "messages_cm", "segsum_by_id")
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
        ("city wide", city, BIG, (f32,), 384, False),
        ("city", city, BIG, (f32,), None, True),
    ]
    for tag, sim, build_kw, dtypes, wide, keep in checks:
        for dtype in dtypes:
            last = keep and dtype is dtypes[-1]
            e = check_kernels(tag, sim, dtype, dev, build_kw, timings if last else None, wide)
            if last:
                errs.update(e)
        print(f"[kernels] {tag} done at {time.perf_counter() - T_START:.1f} s")
    check_scatter_dense(dev)
    window_vs_full()

    launches = bench_path(card)
    city = big_path("city", CITY, card, against_plain=True)
    torch.cuda.empty_cache()
    venice = big_path("venice", VENICE, card, against_plain=False)
    if any(venice[k] != city[k] for k in WINDOWED):
        raise AssertionError(f"venice launches {venice} differ from the city's {city}")
    launches = {**{k: launches[k] for k in FULL}, **{k: city[k] for k in WINDOWED}}
    torch.cuda.empty_cache()
    generic = generic_path(card)
    rows = rows_path(card)
    linear_path()
    launches.update({k: generic[k] for k in ROWS[2:]}, **{k: rows[k] for k in ROWS[:2]})
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
