"""Per-card rate under partitioning: `halo_cm` on one partition against the
plain component-major fast path, on one card.

Counterpart of gbp_tpu/bench/per_chip_rate.py.  What the partitioned
machinery itself costs (the per-partition ELL regroup and layout, the ghost
table, the exchange through `halo.LocalComm`, here trivial), measured at
the headline bench size so that a partitioned run's per-card rate can be
read against the single-card fast path:

  ba          `ba.simulate(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)`:
              plain `sweep_cm.prepare` on the ELL build against
              `halo_cm.distribute(graph, means, 1)` on the plain build
  pose_graph  `pose_graph.simulate_manhattan(n_poses=1500, seed=0,
              loop_prob=0.3, loop_radius=3.0)` under
              `pose_graph.default_config()`, the same two ways

Each side runs `--sweeps` sweeps from the initial state as one CUDA-graph
replay (`utils.capture.CapturedRun`, captured before timing); the rate is
the median of 3 timed runs (host clock around the replay and a sync).  The
BA rows also give both runs' ARE, and every row the halo run's layout and
the kernels each side went through.

    python -m gbp_tpu_torch.bench.per_chip_rate [--sweeps 100] [--n_cams 64]
        [--n_lmks 8000] [--out FILE] [--device cpu]

Prints one line per row and the JSON of all rows; `--out` also writes it
(nothing is written otherwise).  Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json

import torch

import gbp_tpu_torch
from gbp_tpu_torch.bench import CFG, card_line, kernels_used
from gbp_tpu_torch.bench.headline import median_run_s
from gbp_tpu_torch.core import sweep, sweep_cm
from gbp_tpu_torch.models import ba, pose_graph
from gbp_tpu_torch.ops.messages import COUNTS
from gbp_tpu_torch.parallel import halo, halo_cm


def timed(step, init, sweeps, device):
    """(sweeps/s, final state, kernels): the median of 3 captured runs of
    `sweeps` steps from `init` (`headline.median_run_s`)."""
    COUNTS.reset()
    dt, run = median_run_s(step, init, sweeps, 3, device)
    return sweeps / dt, run.state, kernels_used()


def compare(plain_graph, plain_means, none_graph, none_means, cfg, sweeps, device, are_of=None):
    """One row: plain CM against halo_cm on one partition."""
    cmg = sweep_cm.prepare(plain_graph, segsum_exact=True)
    sps_plain, st_plain, k_plain = timed(
        lambda s: sweep_cm.sweep(cmg, s, cfg), sweep_cm.init_state(cmg, plain_means), sweeps,
        device)
    out = halo_cm.distribute(none_graph, none_means, 1, device=device)
    if out is None:
        raise RuntimeError("the graph does not take halo_cm")
    hp, hcm, st, run_fn = out
    sps_halo, st_halo, k_halo = timed(lambda s: run_fn(hcm, s, cfg, 1), st, sweeps, device)
    fb = plain_graph.fblocks[0]
    row = {
        "n_factors": int(fb.n_valid or fb.count),
        "plain_cm_sweeps_per_s": round(sps_plain, 1),
        "halo_cm_1chip_sweeps_per_s": round(sps_halo, 1),
        "ratio": round(sps_halo / sps_plain, 3),
        "halo_cm_layout": {"gather_mode": hcm.gather_mode, "win_w": int(hcm.win_w),
                           "ell_fused": bool(hcm.ell_fused)},
        "plain_cm_kernels": k_plain, "halo_cm_kernels": k_halo,
    }
    if are_of is not None:
        tmpl = sweep.init_state(none_graph, none_means)
        row["are_plain_cm_px"] = are_of(plain_graph, sweep_cm.to_gbp_state(cmg, st_plain))
        row["are_halo_cm_px"] = are_of(none_graph,
                                       ba.with_means(tmpl, halo.collect_means(hp, st_halo)))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_cams", type=int, default=64)
    ap.add_argument("--n_lmks", type=int, default=8000)
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    on_card = device.type == "cuda"
    out = {"metric": "per_chip_rate_under_partitioning",
           "platform": torch.cuda.get_device_name(device) if on_card else "cpu",
           "card": card_line() if on_card else None, "results": {}}

    sim = ba.simulate(n_cams=args.n_cams, n_lmks=args.n_lmks, pix_sigma=1.0, seed=0)
    are_of = lambda g, st: float(ba.avg_reprojection_error(g, st, k=sim["k"]))
    row = compare(*ba.build(sim, device=device), *ba.build(sim, layout="none", device=device),
                  CFG, args.sweeps, device, are_of)
    out["results"]["ba"] = row
    print(f"[per_chip_rate] BA {row['n_factors']} factors: plain {row['plain_cm_sweeps_per_s']}, "
          f"halo_cm(1) {row['halo_cm_1chip_sweeps_per_s']} sweeps/s ({row['ratio']:.1%}); "
          f"ARE {row['are_plain_cm_px']:.6f} / {row['are_halo_cm_px']:.6f} px; halo layout "
          f"{row['halo_cm_layout']}, kernels {row['halo_cm_kernels']}", flush=True)

    psim = pose_graph.simulate_manhattan(n_poses=1500, seed=0, loop_prob=0.3, loop_radius=3.0)
    row = compare(*pose_graph.build(psim, layout="ell", device=device),
                  *pose_graph.build(psim, device=device), pose_graph.default_config(),
                  args.sweeps, device)
    out["results"]["pose_graph"] = row
    print(f"[per_chip_rate] pose graph {row['n_factors']} factors: plain "
          f"{row['plain_cm_sweeps_per_s']}, halo_cm(1) {row['halo_cm_1chip_sweeps_per_s']} "
          f"sweeps/s ({row['ratio']:.1%}); halo layout {row['halo_cm_layout']}, kernels "
          f"{row['halo_cm_kernels']}", flush=True)

    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
