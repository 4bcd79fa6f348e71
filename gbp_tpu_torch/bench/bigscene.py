"""Large-scene single-GPU throughput: city- and venice-scale bundle adjustment
and a long Manhattan pose graph.

Counterpart of gbp_tpu/bench/bigscene.py.  The BA scenes are merged corridor
blocks (`models.ba.simulate_blocks`) with shuffled landmark
ids, so the camera windows engage only through the locality sort, as on real
BAL files:

  ba_city    32 blocks x 40 cameras x 60 landmarks per camera
             (1,280 cameras, about 367 thousand factors)
  ba_venice  256 blocks x 40 cameras x 80 landmarks per camera
             (10,240 cameras, about 4.1 million factors)

Each row runs `prepare(window=True, segment=True)`, as the reference's
rows do: the degree-class segmented layout where its classes pay (city and
venice: three and five windowed classes), else the single segment (a
full-table row at these camera counts would be `prepare(window=False)`,
which lands on the expanded operands of gather mode "rows").  A row
records its rows (`mp_rows`) and, segmented, its classes (`deg_classes`:
[degree, landmark groups] each).  It warms up with one run of `--sweeps`
sweeps, times three more (host clock around `torch.cuda.synchronize`) and
takes the quality at 50 sweeps from the initial state: the plain
static-prior schedule goes non-finite on corridor scenes past about 100
sweeps, so timing integrates longer runs than quality does.

  pose_graph_cm  `simulate_manhattan(n_poses=--poses, seed=0, loop_prob=0.3,
             loop_radius=3.0)` in ELL layout under `pose_graph.default_config()`:
             max(--sweeps, 400) timed sweeps, the ATE against the Gauss-Newton
             target `schur.solve_pcg(n_steps=8, cg_iters=max(1000, poses // 2))`
             (block-Jacobi PCG moves information about one pose per iteration
             between loop closures, hence the iteration count), and the first
             50-sweep chunk whose ATE is at or below 1.25 x ATE_GN + 0.02, up
             to 6,000 sweeps, with a note when it is not reached.

    python -m gbp_tpu_torch.bench.bigscene [--blocks 32] [--cams 40] [--lpc 60]
        [--sweeps 200] [--poses 4000] [--skip_ba] [--skip_venice] [--device cuda]
        [--out results.json]

Prints one line per row and the JSON of all rows; `--out` also writes the
JSON to a file.  Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba, pose_graph
from gbp_tpu_torch.parallel import schur

QUALITY_SWEEPS = 50


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def win_width(cmg) -> int:
    """The camera window width of a prepared graph (the widest class's when
    segmented), 0 without windows."""
    if isinstance(cmg, sweep_cm.CMSegGraph):
        return max(p.win_w for p in cmg.parts)
    return int(cmg.win_w)


def _measure_cm(graph, means, cfg, sweeps, window, reps=3):
    """Prepare (segment=True: the single segment where the segmented layout
    does not apply, as for pose graphs), warm up with one run of `sweeps`
    sweeps, then `reps` timed runs.

    Returns (sweeps/s dict with min/median/max, final state, cmg, win_w)."""
    device = graph.fblocks[0].z.device
    cmg = sweep_cm.prepare(graph, segsum_exact=True, window=window, segment=True)
    state = sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), cfg, sweeps)
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = sweep_cm.run(cmg, state, cfg, sweeps)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    sps = {"median": sweeps / ts[len(ts) // 2], "min": sweeps / ts[-1],
           "max": sweeps / ts[0], "sweeps_per_rep": sweeps}
    return sps, state, cmg, win_width(cmg) or None


def _city_row(out, key, sim, cfg, sweeps, device, windows=(True,)):
    """Measure one merged-blocks scene, once per entry of `windows`."""
    n_cams = sim["cam_init"].shape[0]
    graph, means = ba.build(sim, device=device, **BIG_BUILD)
    fb = graph.fblocks[0]
    m = fb.count if fb.n_valid is None else fb.n_valid
    print(f"[bigscene] {key}: {n_cams} cams, {sim['lmk_init'].shape[0]} lmks, {m} factors",
          flush=True)
    for window in windows:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sps, _, cmg, win_w = _measure_cm(graph, means, cfg, sweeps, window)
        st = sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), cfg, QUALITY_SWEEPS)
        are = float(ba.avg_reprojection_error(graph, sweep_cm.to_gbp_state(cmg, st), k=sim["k"]))
        if not math.isfinite(are):
            raise AssertionError(f"{key}: non-finite ARE at {QUALITY_SWEEPS} sweeps")
        tag = "window" if window else "full_table"
        out["results"][f"{key}_{tag}"] = {
            "n_cams": int(n_cams), "n_factors": int(m),
            "sweeps_per_s": sps["median"], "sweeps_per_s_min_max": [sps["min"], sps["max"]],
            "sweeps_per_rep": sps["sweeps_per_rep"],
            "factor_updates_per_s": sps["median"] * m,
            "mp_rows": int(cmg.mp),
            "deg_classes": ([[p.deg, p.n_groups] for p in cmg.parts]
                            if isinstance(cmg, sweep_cm.CMSegGraph) else None),
            "ns_per_valid_factor": 1e9 / (sps["median"] * m),
            "are_px_at_50_sweeps": are, "win_w": win_w,
            "sorted": cmg.vperm is not None,
            "peak_memory_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                                if device.type == "cuda" else None),
        }
        print(f"[bigscene] {key} {tag}: {sps['median']:.2f} sweeps/s "
              f"[{sps['min']:.2f}, {sps['max']:.2f}] "
              f"({sps['median'] * m / 1e6:.0f}M factor-updates/s), ARE {are:.3f}px, "
              f"{cmg.mp} rows" + (f", win_w={win_w}" if win_w else "")
              + (f", classes {[p.deg for p in cmg.parts]}"
                 if isinstance(cmg, sweep_cm.CMSegGraph) else ""), flush=True)


def _pose_row(out, n_poses, sweeps, device):
    """The long Manhattan pose graph on the component-major fast path."""
    sim = pose_graph.simulate_manhattan(n_poses=n_poses, seed=0, loop_prob=0.3, loop_radius=3.0)
    graph, means = pose_graph.build(sim, layout="ell", device=device)
    cfg = pose_graph.default_config()
    fb = graph.fblocks[0]
    m = fb.count if fb.n_valid is None else fb.n_valid
    sps, state, cmg, win_w = _measure_cm(graph, means, cfg, max(sweeps, 400), True)
    ate_end = pose_graph.ate(sweep_cm.to_gbp_state(cmg, state).v[0].mean, sim["truth"])
    if not math.isfinite(ate_end):
        raise AssertionError("pose graph: non-finite ATE")

    t0 = time.perf_counter()
    mu = schur.solve_pcg(graph, means, n_steps=8, cg_iters=max(1000, n_poses // 2))
    ate_gn = pose_graph.ate(mu[0], sim["truth"])
    print(f"[bigscene] pose-graph GN target: ATE {ate_gn:.4f} "
          f"({time.perf_counter() - t0:.1f}s, not counted)", flush=True)
    target = 1.25 * ate_gn + 0.02

    chunk = 50
    st = sweep_cm.init_state(cmg, means)
    t_conv, conv_sweeps, traj = None, None, []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(6000 // chunk):
        st = sweep_cm.run(cmg, st, cfg, chunk)
        _sync(device)
        t_i = time.perf_counter() - t0
        a = pose_graph.ate(sweep_cm.to_gbp_state(cmg, st).v[0].mean, sim["truth"])
        traj.append(round(a, 4))
        if a <= target:
            t_conv, conv_sweeps = t_i, (i + 1) * chunk
            break
    row = {
        "n_poses": n_poses, "n_factors": int(m), "mp_rows": int(cmg.mp),
        "gather_mode": cmg.gather_mode, "win_w": win_w,
        "sweeps_per_s": sps["median"], "sweeps_per_s_min_max": [sps["min"], sps["max"]],
        "sweeps_per_rep": sps["sweeps_per_rep"], "factor_updates_per_s": sps["median"] * m,
        "ate_gn_target": ate_gn, "ate_at_end_of_timing": ate_end,
        "wall_clock_to_1.25x_gn_ate_s": t_conv, "sweeps_to_1.25x_gn_ate": conv_sweeps,
        "ate_target_threshold": target, "ate_per_50_sweeps": traj[:20],
    }
    if t_conv is None:
        row["note"] = ("did not reach 1.25x GN ATE + 0.02 within 6000 sweeps; trajectory in "
                       "ate_per_50_sweeps: treat sweeps_per_s as throughput only")
    out["results"]["pose_graph_cm"] = row
    print(f"[bigscene] pose graph ({n_poses} poses, {m} factors, mode {cmg.gather_mode!r}): "
          f"{sps['median']:.2f} sweeps/s [{sps['min']:.2f}, {sps['max']:.2f}]"
          + (f", win_w={win_w}" if win_w else "")
          + (f"; ATE<=1.25xGN+0.02 at sweep {conv_sweeps} ({t_conv:.3f}s wall)"
             if t_conv is not None else f"; NOT converged to {target:.3f} in 6000 sweeps"),
          flush=True)


def _platform(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "card": card_line()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=CITY["n_blocks"],
                    help="independent corridor blocks of the city scene")
    ap.add_argument("--cams", type=int, default=CITY["n_cams"], help="cameras per block")
    ap.add_argument("--lpc", type=int, default=CITY["lmks_per_cam"],
                    help="landmarks per camera within a block")
    ap.add_argument("--sweeps", type=int, default=200, help="sweeps per timed repeat")
    ap.add_argument("--venice_blocks", type=int, default=VENICE["n_blocks"])
    ap.add_argument("--venice_lpc", type=int, default=VENICE["lmks_per_cam"])
    ap.add_argument("--skip_venice", action="store_true")
    ap.add_argument("--skip_ba", action="store_true", help="only the pose-graph row")
    ap.add_argument("--poses", type=int, default=4000,
                    help="poses of the Manhattan pose-graph row (0: skip it)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    out = {"device": _platform(device), "results": {}}

    if not args.skip_ba:
        sim = ba.simulate_blocks(**{**CITY, "n_blocks": args.blocks, "n_cams": args.cams,
                                    "lmks_per_cam": args.lpc})
        _city_row(out, "ba_city", sim, CFG, args.sweeps, device)
        if not args.skip_venice:
            vsim = ba.simulate_blocks(**{**VENICE, "n_blocks": args.venice_blocks,
                                         "n_cams": args.cams, "lmks_per_cam": args.venice_lpc})
            _city_row(out, "ba_venice", vsim, CFG, args.sweeps, device)
    if args.poses:
        _pose_row(out, args.poses, args.sweeps, device)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
