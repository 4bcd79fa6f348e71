"""Weak-scaling harness: sweeps/s as the graph and the partition count grow
together.

Counterpart of gbp_tpu/bench/scaling.py.  The P partitions of a run share
one device in one process (`halo.LocalComm`: every kernel launched once per
partition, the exchange a gather and a roll on the device), so this machine
measures what partitioning and the exchange cost on shared silicon, not a
run across cards: a run across several cards cannot be measured on a
one-card machine, and no column here stands for one.

`--chips` lists the partition counts; each row grows the cameras with P
(`--cams_per_chip` a partition), keeping factors per partition about
constant.  Paths: `spmd` (replicated beliefs, one all-reduce per variable
block; generic engine, covariance form), `halo` (owner-sharded beliefs,
boundary-only exchange; generic, covariance) and `halo_cm` (the per-partition
component-major fast path, the kernels).  Each point is the median of
`--reps` timed runs of `--sweeps` sweeps, each one CUDA-graph replay
(`utils.capture.CapturedRun`, captured first).  Columns:

  raw_efficiency                  t_1 / t_P
  shared_silicon_efficiency       t_1 * P / t_P (the legacy correction for P
                                  partitions on one device)
  collective_overhead_efficiency  t_skip / t_P, t_skip the same program
                                  without the exchange (`make_run(...,
                                  skip_exchange=True)`; halo and halo_cm)
  single_process_same_size_ratio  t_single / t_P, t_single the same total
                                  problem unpartitioned in one process (always
                                  measured: the partitions share the device)

A value above 1.0 is flagged in its row with the reason.

    python -m gbp_tpu_torch.bench.scaling [--chips 1 2 4 8] [--path spmd|halo|halo_cm]
        [--scene arc|corridor|blocks] [--cams_per_chip 8] [--n_lmks 2000]
        [--lmks_per_cam 30] [--sweeps 30] [--reps 5] [--out FILE] [--device cpu]

Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json

import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import card_line, kernels_used
from gbp_tpu_torch.bench.headline import median_run_s
from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops.messages import COUNTS
from gbp_tpu_torch.parallel import halo, halo_cm, spmd

BUILD_KW = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
NOTE_OVERHEAD = (">1.0 is impossible by construction (the control without the exchange ran "
                 "slower than the real program): residual timing noise - treat as ~1.0")
NOTE_SHARED = (">1.0 with the partitions on one device: partitioning shrinks each partition's "
               "tables and its per-launch work changes - read collective_overhead_efficiency "
               "instead")


def _cfg(path):
    return GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8,
                     message_form="pallas" if path == "halo_cm" else "covariance")


def _build(scene, n_cams, n_lmks, lmks_per_cam, layout, device):
    if scene == "corridor":
        sim = ba.simulate_corridor(n_cams=n_cams, lmks_per_cam=lmks_per_cam, window=3, seed=0)
        return ba.build(sim, layout=layout, device=device, **BUILD_KW)
    if scene == "blocks":
        # The city scene's regime: shuffled ids, windows through the locality sort.
        sim = ba.simulate_blocks(n_blocks=max(n_cams // 40, 1), n_cams=40,
                                 lmks_per_cam=lmks_per_cam, window=3, seed=0, shuffle=True)
        return ba.build(sim, layout=layout, device=device, **BUILD_KW)
    sim = ba.simulate(n_cams=n_cams, n_lmks=n_lmks, seed=0)
    return ba.build(sim, layout=layout, device=device)


def measure(n_parts, cams_per_chip, n_lmks, lmks_per_cam, sweeps, path, scene, reps, device):
    """One row's partitioned run: (sweeps/s, seconds, factors, collective
    bytes, window width, seconds without the exchange, kernels)."""
    cfg = _cfg(path)
    n_cams = n_parts * cams_per_chip
    COUNTS.reset()
    if path == "halo_cm":
        graph, means = _build(scene, n_cams, n_lmks, lmks_per_cam, "none", device)
        out = halo_cm.distribute(graph, means, n_parts, device=device)
        if out is None:
            raise RuntimeError("the scene must take halo_cm")
        hp, hcm, st, run_fn = out
        skip = halo_cm.make_run(hcm, skip_exchange=True)
        step = lambda s: run_fn(hcm, s, cfg, 1)
        step_skip = lambda s: skip(hcm, s, cfg, 1)
        comm, win_w = halo.collective_bytes(hp), int(hcm.win_w)
    elif path == "halo":
        graph, means = _build(scene, n_cams, n_lmks, lmks_per_cam, "none", device)
        hp, st, run_fn = halo.distribute(graph, means, n_parts, device=device)
        skip = halo.make_run(hp, skip_exchange=True)
        step = lambda s: run_fn(hp.hgraph, s, cfg, 1)
        step_skip = lambda s: skip(hp.hgraph, s, cfg, 1)
        comm, win_w = halo.collective_bytes(hp), None
    else:
        graph, means = _build(scene, n_cams, n_lmks, lmks_per_cam, "ell", device)
        g_sh, st = spmd.distribute(graph, means, n_parts, device=device)
        run_fn = spmd.make_run(g_sh, n_parts)
        step, step_skip = lambda s: run_fn(g_sh, s, cfg, 1), None
        comm, win_w = None, None
    dt = median_run_s(step, st, sweeps, reps, device)[0]
    kernels = kernels_used()
    dt_skip = None if step_skip is None else median_run_s(step_skip, st, sweeps, reps, device)[0]
    fb = graph.fblocks[0]
    m = fb.count if fb.n_valid is None else fb.n_valid
    return sweeps / dt, dt, int(m), comm, win_w, dt_skip, kernels


def measure_single(n_cams_total, n_lmks, lmks_per_cam, sweeps, path, scene, reps, device):
    """Seconds of the same total problem unpartitioned in one process: the
    fast path for halo_cm, the generic engine for the others."""
    cfg = _cfg(path)
    graph, means = _build(scene, n_cams_total, n_lmks, lmks_per_cam, "ell", device)
    if path == "halo_cm":
        cmg = sweep_cm.prepare(graph, segsum_exact=True)
        return median_run_s(lambda s: sweep_cm.sweep(cmg, s, cfg),
                            sweep_cm.init_state(cmg, means), sweeps, reps, device)[0]
    return median_run_s(lambda s: sweep_mod.sweep(graph, s, cfg),
                        sweep_mod.init_state(graph, means), sweeps, reps, device)[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="partition counts (all on one device)")
    p.add_argument("--cams_per_chip", type=int, default=8)
    p.add_argument("--n_lmks", type=int, default=2000)
    p.add_argument("--lmks_per_cam", type=int, default=30)
    p.add_argument("--sweeps", type=int, default=30)
    p.add_argument("--path", choices=("spmd", "halo", "halo_cm"), default="halo")
    p.add_argument("--scene", choices=("arc", "corridor", "blocks"), default="corridor")
    p.add_argument("--reps", type=int, default=5, help="timing repeats per point (median)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    on_card = device.type == "cuda"
    platform = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {card_line() if on_card else 'cpu'}; the partitions share it "
          f"(shared silicon: True)", flush=True)
    results, t1 = [], None
    for n in args.chips:
        sps, dt, m, comm, win_w, dt_skip, kernels = measure(
            n, args.cams_per_chip, args.n_lmks, args.lmks_per_cam, args.sweeps, args.path,
            args.scene, args.reps, device)
        t1 = dt if t1 is None else t1
        row = dict(chips=n, factors=m, sweeps_per_s=round(sps, 2),
                   raw_efficiency=round(t1 / dt, 3),
                   shared_silicon_efficiency=round(t1 * n / dt, 3))
        if dt_skip is not None:
            row["collective_overhead_efficiency"] = round(dt_skip / dt, 3)
            if dt_skip / dt > 1.0:
                row["collective_overhead_efficiency_note"] = NOTE_OVERHEAD
        t_single = measure_single(n * args.cams_per_chip, args.n_lmks, args.lmks_per_cam,
                                  args.sweeps, args.path, args.scene, args.reps, device)
        row["single_process_same_size_ratio"] = round(t_single / dt, 3)
        if win_w is not None:
            row["win_w"] = win_w
        if comm:
            row["collective_bytes_per_sweep"] = comm["halo_bytes_per_sweep"]
        row["kernels"] = kernels
        for key in ("shared_silicon_efficiency", "single_process_same_size_ratio"):
            if row[key] > 1.0:
                row[f"{key}_note"] = NOTE_SHARED
        results.append(row)
        print(f"{n} partitions: {m} factors, {sps:.2f} sweeps/s, raw eff {row['raw_efficiency']}, "
              f"shared-silicon eff {row['shared_silicon_efficiency']}"
              + (f", collective-overhead eff {row['collective_overhead_efficiency']}"
                 if dt_skip is not None else "")
              + f", single-process ratio {row['single_process_same_size_ratio']}"
              + (f", win_w {win_w}" if win_w else "")
              + (f", comm {comm['halo_bytes_per_sweep']}B/sweep" if comm else ""), flush=True)
    doc = {"metric": "weak_scaling", "path": args.path, "scene": args.scene,
           "platform": platform, "card": card_line() if on_card else None,
           "shared_silicon": True, "sweeps": args.sweeps, "cams_per_chip": args.cams_per_chip,
           "timing_reps_median": args.reps, "results": results}
    text = json.dumps(doc)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return doc


if __name__ == "__main__":
    main()
