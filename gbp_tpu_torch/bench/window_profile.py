"""Stage-level profile of the component-major sweep: each stage timed alone.

Counterpart of gbp_tpu/bench/window_profile.py; it ports what that harness
measures, not the TPU's window-table mechanism.  Stages of one sweep of
`sweep_cm.sweep` on a prepared graph (`prepare(window=...,
ell_fused=...)`):

  full        the whole sweep
  tabprep     the kernels' belief inputs: `sweep_cm.belief_tables` (fused),
              or the ELL slot's expansion (kernel 14) and the packed camera
              table (`--unfused`)
  relin       the relinearization kernel (1, or 11 with windows; unfused 7, 9)
  messages    the messages wrapper as the sweep calls it (2, or 10 with
              windows; unfused 6, 8); the fused wrappers fold in the camera
              sum's first stage (3, or 16), which `folded_sum` times alone
  segsum      the camera-side sum: kernel 3, or kernels 16 + 15 with windows
  other       full - (tabprep + relin + messages + segsum - folded_sum): the
              belief update, solves and glue

Each stage runs `--iters` times captured as one CUDA graph and replayed
between CUDA events (the counterpart of the reference's `fori_loop`): launch
latency stays out of the numbers, and a graph hoists nothing, so the stages
need no data dependency between calls.  The full sweep is `--iters` sweeps
as one `utils.capture.CapturedRun`; the stages' operands are the state it
leaves.  Each number is the median of 3 replays.  Where the stages miss the
full sweep by more than 10 % a note says so (on the card the glue in
`other` is about half of a sweep).

Scenes: the bench scene (64 cameras, 8,000 landmarks: the whole camera table,
kernels 1, 2, 3) unless `--skip_bench_scene`, and the merged-blocks city
scene (`--blocks 32 --cams 40 --lpc 60`: windows after the locality sort,
kernels 11, 10, 16, 15).  The reference also profiles the city scene
without windows; its 1,280-camera table exceeds the 48 KB the full-table
kernels stage, so the port's `prepare` takes gather mode "rows" there and
that row is not a table profile.

    python -m gbp_tpu_torch.bench.window_profile [--blocks 32] [--cams 40]
        [--lpc 60] [--iters 50] [--skip_bench_scene] [--unfused] [--out FILE]
        [--device cpu]

Prints one line per scene and the JSON of all; `--out` also writes it.
Runs on the card unless `--device cpu` is given (host clock there).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, card_line, kernels_used
from gbp_tpu_torch.bench.headline import elapsed_s
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.sweep import _kernel_params
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.utils.capture import CapturedRun, capture

REPS = 3


def _median_ms(device, fn, calls):
    """Median ms per call of `fn()` (one run of `calls` calls) over REPS runs."""
    ts = sorted(elapsed_s(device, fn) for _ in range(REPS))
    return ts[REPS // 2] / calls * 1e3


def stage_ms(fn, iters, device):
    """ms per call of `fn`: `iters` calls captured as one CUDA graph and
    replayed (card), or called (CPU)."""
    if device.type != "cuda":
        fn()
        return _median_ms(device, lambda: [fn() for _ in range(iters)], iters)
    graph = capture(lambda: [fn() for _ in range(iters)], fn)
    graph.replay()
    return _median_ms(device, graph.replay, iters)


def stages(cmg, state, cfg) -> dict:
    """{stage: fn} of the sweep's stages on the operands of `state`; the
    calls are the ones `sweep_cm.sweep` makes."""
    fb, fs = cmg.fb, state.f
    g, deg = 1 - fb.ell_slot, fb.ell_deg
    params = _kernel_params(cfg, fs.r0.dtype)
    model = fb.ftype.name
    huber = "row" if fb.huber_arr is not None else fb.huber
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    rel = (fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
    mes = (fs.jac, fs.lp, fs.r0, cmg.prec, fs.srel, cmg.act)
    out = {}
    if cmg.ell_fused:
        cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, state)
        out["tabprep"] = lambda: sweep_cm.belief_tables(cmg, state)
        if cmg.win_w:
            out["relin"] = lambda: M.relin_cm_tabblk_ell(
                params, cam_mean, lmk_mean, cmg.gidx, cmg.win_starts, cmg.z, *rel, deg=deg,
                win_w=cmg.win_w, comp_name=model, gslot=g, fargs=cmg.args)
            out["messages"] = lambda: M.messages_cm_tabblk_ell(
                params, cam_tab, lmk_tab, cmg.gidx, cmg.win_starts, *mes, *msgs, cmg.win_rows,
                cmg.win_offsets, deg=deg, huber=huber, win_w=cmg.win_w, gslot=g)
        else:
            out["relin"] = lambda: M.relin_cm_tab_ell(
                params, cam_mean, lmk_mean, cmg.gidx, cmg.z, *rel, deg=deg, comp_name=model,
                gslot=g, fargs=cmg.args)
            out["messages"] = lambda: M.messages_cm_tab_ell(
                params, cam_tab, lmk_tab, cmg.gidx, *mes, *msgs, cmg.seg_rows, cmg.seg_offsets,
                deg=deg, huber=huber, gslot=g, seg_ids=cmg.seg_ids)
    else:
        vs_c, vs_l = sweep_cm._slot_states(cmg, state)
        be_l, bl_l, mean_l = sweep_cm._expand_ell(cmg, vs_l)
        mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
        out["tabprep"] = lambda: (sweep_cm._expand_ell(cmg, vs_l),
                                  sweep_cm._packed(vs_c).contiguous())
        if cmg.win_w:
            out["relin"] = lambda: M.relin_cm_tabblk(
                params, mean_l, mtab, cmg.gidx, cmg.win_starts, cmg.z, cmg.args, *rel,
                win_w=cmg.win_w, comp_name=model, gslot=g)
            out["messages"] = lambda: M.messages_cm_tabblk(
                params, *mes, be_l, bl_l, btab, cmg.gidx, cmg.win_starts, *msgs, huber=huber,
                win_w=cmg.win_w, gslot=g)
        else:
            out["relin"] = lambda: M.relin_cm_tab(
                params, mean_l, mtab, cmg.gidx, cmg.z, cmg.args, *rel, comp_name=model, gslot=g)
            out["messages"] = lambda: M.messages_cm_tab(
                params, *mes, be_l, bl_l, btab, cmg.gidx, *msgs, huber=huber, gslot=g)
    me_g, ml_g = fs.msg_eta[g], fs.msg_lam[g]
    if cmg.win_w:
        n_cam = cmg.base.vblocks[fb.vblocks[g]].count
        blk = lambda: M.segsum_cm_blk(me_g, ml_g, cmg.win_rows, cmg.win_offsets,
                                      n_tiles=cmg.mp // M.TILE, w=cmg.win_w)
        out["segsum"] = lambda: M.scatter_windows_cm(blk(), cmg.win_starts, cmg.blk_tiles,
                                                     cmg.blk_offsets, n_seg=n_cam)
    else:
        blk = lambda: M.segsum_by_id(me_g, ml_g, cmg.seg_rows, cmg.seg_offsets)
        out["segsum"] = blk
    if cmg.ell_fused:
        out["folded_sum"] = blk
    return out


def profile_scene(graph, means, cfg, window, iters, ell_fused=None) -> dict:
    """Every stage's ms per sweep (module docstring) on one scene."""
    device = graph.fblocks[0].z.device
    cmg = sweep_cm.prepare(graph, segsum_exact=True, window=window, ell_fused=ell_fused)
    if not isinstance(cmg, sweep_cm.CMGraph) or cmg.gather_mode != "table":
        raise RuntimeError("window_profile takes graphs that sweep_cm.prepare puts on a table "
                           f"(gather mode {getattr(cmg, 'gather_mode', None)!r})")
    fb = cmg.fb
    m = fb.count if fb.n_valid is None else fb.n_valid
    res = {"win_w": int(cmg.win_w), "ell_fused": bool(cmg.ell_fused), "n_factors": int(m),
           "mp": int(cmg.mp), "ncpad": int(cmg.win_ncpad) or None}
    M.COUNTS.reset()
    run = CapturedRun(lambda s: sweep_cm.sweep(cmg, s, cfg), sweep_cm.init_state(cmg, means),
                      iters)
    run()
    res["full_ms"] = _median_ms(device, run, iters)
    res["kernels"] = kernels_used()
    for name, fn in stages(cmg, run.state, cfg).items():
        res[f"{name}_ms"] = stage_ms(fn, iters, device)
    res.setdefault("folded_sum_ms", 0.0)
    res["other_ms"] = res["full_ms"] - (res["tabprep_ms"] + res["relin_ms"] + res["messages_ms"]
                                        + res["segsum_ms"] - res["folded_sum_ms"])
    res["ns_per_factor"] = res["full_ms"] * 1e6 / m
    if abs(res["other_ms"]) > 0.10 * res["full_ms"]:
        res["note"] = (f"the stages miss the full sweep by {res['other_ms'] / res['full_ms']:+.0%}:"
                       " positive, the untimed glue (belief update, solves) holds it; negative,"
                       " isolated stages overstate costs that overlap in context - treat "
                       "per-stage numbers as relative comparisons only")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--cams", type=int, default=40, help="cams per block")
    ap.add_argument("--lpc", type=int, default=60)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--skip_bench_scene", action="store_true")
    ap.add_argument("--unfused", action="store_true",
                    help="profile the unfused table kernels (ell_fused=False)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    on_card = device.type == "cuda"
    ell_fused = False if args.unfused else None
    out = {"platform": torch.cuda.get_device_name(device) if on_card else "cpu",
           "card": card_line() if on_card else None, "iters": args.iters, "scenes": {}}

    if not args.skip_bench_scene:
        sim = ba.simulate(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
        graph, means = ba.build(sim, device=device)
        r = profile_scene(graph, means, CFG, False, args.iters, ell_fused)
        out["scenes"]["bench64"] = r
        print(f"[profile] bench64: {json.dumps(r)}", flush=True)

    t0 = time.perf_counter()
    sim = ba.simulate_blocks(n_blocks=args.blocks, n_cams=args.cams, lmks_per_cam=args.lpc,
                             window=3, seed=0, shuffle=True)
    graph, means = ba.build(sim, device=device, **BIG_BUILD)
    key = f"blocks{sim['cam_init'].shape[0]}_win"
    r = profile_scene(graph, means, CFG, True, args.iters, ell_fused)
    out["scenes"][key] = r
    print(f"[profile] {key} ({time.perf_counter() - t0:.1f} s): {json.dumps(r)}", flush=True)

    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
