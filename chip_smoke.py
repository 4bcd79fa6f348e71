#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's bundle-adjustment fast path on one GPU.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero; no phase is caught):

  1. device: a CUDA card must be present; prints its name and power limit
     (nvidia-smi), torch and CUDA versions; pins exact float32.
  2. build: compiles gbp_tpu_torch/csrc/*.cu with nvcc (first use) and
     prints the seconds taken and ptxas's register/spill report.
  3. kernel vs plain: on the 8-cam/120-landmark scene and on the full bench
     scene (64 cams, 8000 landmarks, 469,861 factors), after 8 plain sweeps
     on the CPU (8 = min_linear_iters), each kernel and its plain PyTorch
     version run on identical CUDA inputs: relinearization at the config's
     beta (every valid row relinearizes) and at the median distance (half
     do), messages with and without Huber.  float64 must agree to 1e-11
     and float32 to 1e-4, relative to each output's magnitude; the camera
     sum must repeat bit for bit.  Also times each kernel against its plain
     version.
  4. main path: simulate -> build (f32) -> prepare -> init_state -> 200
     sweeps through the kernels (launch counts 200, plain counts 0) ->
     to_gbp_state -> ARE, held to <= 1.05x the ARE of 6 Gauss-Newton steps
     on the card; a rerun from the same init must give bitwise-equal means;
     a second timed 200-sweep call gives sweeps/s.
  5. the kernels' JSON line, the card line, and the last line
     {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import subprocess
import sys
import time

import torch

import gbp_tpu_torch
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops import _build
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import schur

CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
SWEEPS = 200
BENCH = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
SMALL = dict(n_cams=8, n_lmks=120, seed=0)
TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
SOURCE = "gbp_tpu_torch/csrc/messages.cu"
REPLACES = {
    "relin_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1118",
    "messages_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1054",
    "segsum_by_id": "gbp_tpu/ops/messages_pallas.py:646",
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def kernel_inputs(scene, dtype, dev):
    """The CM graph on `dev` and the state after 8 plain sweeps on the CPU."""
    sim = ba.simulate(**scene)
    g_cpu, m_cpu = ba.build(sim, dtype=dtype)
    cmg_cpu = sweep_cm.prepare(g_cpu)
    state = sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), CFG, 8)
    g, _ = ba.build(sim, dtype=dtype, device=dev)
    return sweep_cm.prepare(g), to_device(state, dev)


def check_kernels(scene, dtype, dev, timings=None):
    """Phase 3 for one scene and dtype; returns {kernel: max abs err}."""
    tol = TOL[dtype]
    cmg, st = kernel_inputs(scene, dtype, dev)
    fs = st.f
    deg = cmg.fb.ell_deg
    params = _kernel_params(CFG, dtype)
    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    tag = f"{scene['n_cams']}cam {str(dtype)[6:]}"
    errs = {}

    def compare(name, got, ref):
        worst_rel, worst_abs = 0.0, 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            print(f"[kernels] {tag} {name} out{i}: max abs {err:.3e} rel {rel:.3e}")
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        errs[name] = max(errs.get(name, 0.0), worst_abs)

    # The median linearization-point distance of the valid rows, as beta,
    # makes half of them relinearize: the beta decision is checked both ways.
    rows = torch.arange(cmg.mp, device=dev) // deg
    x = torch.cat([cam_mean[cmg.gidx.long()], lmk_mean[rows]], 1).T
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    n_valid = int(on.sum())
    for beta in (beta_mid, CFG.beta):  # the config's beta last: its outputs feed on
        relin_args = (_kernel_params(dataclasses.replace(CFG, beta=beta), dtype), cam_mean,
                      lmk_mean, cmg.gidx, cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        ref_r = sync(M.relin_cm_tab_ell_plain(*relin_args, deg=deg))
        n_relin = int((ref_r[3] == 0).sum())
        print(f"[kernels] {tag} beta {beta:.4g}: {n_relin} of {n_valid} valid rows relinearize")
        if n_relin == 0 or (beta == beta_mid and n_relin == n_valid):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm_tab_ell", sync(M.relin_cm_tab_ell(*relin_args, deg=deg)), ref_r)

    lp, jac, r0, srel = ref_r
    for huber in (None, 1.0):
        msg_args = (params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, cmg.prec, srel,
                    cmg.act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
                    cmg.seg_rows, cmg.seg_offsets)
        ref_m = sync(M.messages_cm_tab_ell_plain(*msg_args, deg=deg, huber=huber))
        compare("messages_cm_tab_ell",
                sync(M.messages_cm_tab_ell(*msg_args, deg=deg, huber=huber)), ref_m)

    seg_args = (ref_m[0], ref_m[1], cmg.seg_rows, cmg.seg_offsets)
    ref_s = sync(M.segsum_by_id_plain(*seg_args))
    got_s = sync(M.segsum_by_id(*seg_args))
    compare("segsum_by_id", (got_s,), (ref_s,))
    again = sync(M.segsum_by_id(*seg_args))
    if not torch.equal(got_s, again):
        raise AssertionError(f"segsum_by_id {tag}: two runs differ")
    print(f"[kernels] {tag} segsum_by_id: two runs bitwise equal")

    if timings is not None:
        for name, kern, plain, args, kw in (
            ("relin_cm_tab_ell", M.relin_cm_tab_ell, M.relin_cm_tab_ell_plain,
             relin_args, dict(deg=deg)),
            ("messages_cm_tab_ell", M.messages_cm_tab_ell, M.messages_cm_tab_ell_plain,
             msg_args, dict(deg=deg, huber=None)),
            ("segsum_by_id", M.segsum_by_id, M.segsum_by_id_plain, seg_args, {}),
        ):
            ms = time_ms(lambda: kern(*args, **kw), 20)
            plain_ms = time_ms(lambda: plain(*args, **kw), 3)
            timings[name] = (ms, plain_ms)
            print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return errs


def main_path(dev, card):
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32, device=dev)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    n_valid = graph.fblocks[0].n_valid
    print(f"[main] bench scene: {BENCH['n_cams']} cams, {sim['lmk_init'].shape[0]} lmks, "
          f"{n_valid} factors in {cmg.mp} rows (deg {cmg.fb.ell_deg})")
    init = sweep_cm.init_state(cmg, means)
    torch.cuda.synchronize()

    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    t_first = time.perf_counter() - t0
    launches, plain = dict(M.COUNTS.kernel), dict(M.COUNTS.plain)
    print(f"[main] {SWEEPS} sweeps (first call) in {t_first:.3f} s; launches {launches}; "
          f"plain calls {plain}")
    if any(v != SWEEPS for v in launches.values()) or any(plain.values()):
        raise AssertionError(f"main path did not run through the kernels: {launches} {plain}")

    are = float(ba.avg_reprojection_error(graph, sweep_cm.to_gbp_state(cmg, state), k=sim["k"]))
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

    t0 = time.perf_counter()
    sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    dt = time.perf_counter() - t0
    print(f"[main] timed {SWEEPS} sweeps: {dt:.4f} s -> {SWEEPS / dt:.2f} sweeps/s "
          f"(informational; {card}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    gbp_tpu_torch.set_exact_f32()

    t0 = time.perf_counter()
    _, compile_s = _build.build()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {compile_s:.2f} s)")
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    timings = {}
    errs = {}
    for scene in (SMALL, BENCH):
        for dtype in (torch.float64, torch.float32):
            bench_f32 = scene is BENCH and dtype == torch.float32
            e = check_kernels(scene, dtype, dev, timings if bench_f32 else None)
            if bench_f32:
                errs = e

    launches = main_path(dev, card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timings[name][0], "plain_ms": timings[name][1]}
        for name in M.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
