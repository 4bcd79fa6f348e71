"""Pose-graph SLAM from the command line: g2o files or synthetic worlds.

Counterpart of the repository's root `slam.py` on the port:

    python -m gbp_tpu_torch.slam --g2o_file data/manhattan_sim.g2o --n_iters 200
    python -m gbp_tpu_torch.slam --n_poses 500 --n_iters 200       # Manhattan world
    python -m gbp_tpu_torch.slam --se3 --n_poses 120               # SE(3) helix
    python -m gbp_tpu_torch.slam --n_poses 4000 --n_chips 2        # two partitions

Builds the graph in ELL layout, takes the component-major fast path where
`sweep_cm.prepare` accepts the graph (diagonal information) and the generic
sweep in its kernel form (message_form="pallas") otherwise (a g2o file with
full information matrices), and prints the path chosen, the energy (and the
ATE where the truth is known) every `--print_every` sweeps, and sweeps/s.
Runs on the card unless `--device cpu` is given.  `--n_chips P` > 1 cuts the
graph into P owner-sharded partitions run through the halo exchange
(parallel/halo_cm.py, or parallel/halo.py where the fast path does not take
the graph), in one process on `--device`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

import gbp_tpu_torch
from gbp_tpu_torch.core import sweep, sweep_cm
from gbp_tpu_torch.io import g2o
from gbp_tpu_torch.models import pose_graph
from gbp_tpu_torch.parallel import halo, halo_cm


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--g2o_file", default=None, help="g2o pose-graph file (SE2 or SE3)")
    p.add_argument("--n_iters", type=int, default=200)
    p.add_argument("--huber", type=float, default=2.0)
    p.add_argument("--n_poses", type=int, default=500)
    p.add_argument("--se3", action="store_true",
                   help="synthetic 3D helical world (SE(3) pose graph) instead of the 2D "
                        "Manhattan world")
    p.add_argument("--outlier_frac", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_every", type=int, default=20)
    p.add_argument("--n_chips", type=int, default=1,
                   help="owner-sharded partitions of the graph (halo exchange), run in one "
                        "process on --device")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns what it printed as numbers: {"energy": [(sweep,
    energy), ...], "ate": [(sweep, ATE), ...] (empty without a truth),
    "ate0" (None without a truth), "sweeps_per_s", "state", and with
    --n_chips > 1 "hp", "hcm"}."""
    args = parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    cfg = pose_graph.default_config()
    truth = None
    # Single device: ELL layout for the fast path; halo partitions the plain one.
    layout = "ell" if args.n_chips == 1 else "none"
    if args.g2o_file:
        data = g2o.read_g2o(args.g2o_file)
        graph, means = pose_graph.build_g2o(data, huber=args.huber, layout=layout, device=device)
        print(f"loaded {args.g2o_file} ({data['kind']}): {data['poses'].shape[0]} poses, "
              f"{data['edges_ij'].shape[0]} edges")
    elif args.se3:
        data = pose_graph.simulate_helix(n_poses=args.n_poses, seed=args.seed)
        graph, means = pose_graph.build_g2o(data, huber=args.huber, layout=layout, device=device)
        truth = data["truth"]
        print(f"simulated SE(3) helix: {args.n_poses} poses, {data['edges_ij'].shape[0]} edges")
    else:
        sim = pose_graph.simulate_manhattan(n_poses=args.n_poses, outlier_frac=args.outlier_frac,
                                            seed=args.seed)
        graph, means = pose_graph.build(sim, huber=args.huber, layout=layout, device=device)
        truth = sim["truth"]
        print(f"simulated Manhattan world: {args.n_poses} poses, {sim['odom_ij'].shape[0]} "
              f"odometry + {sim['loop_ij'].shape[0]} loop factors")

    cmg = hp = hcm = None
    if args.n_chips > 1:
        out = halo_cm.distribute(graph, means, args.n_chips, device=device)
        if out is not None:
            hp, hcm, state, run_halo = out
            print(f"path: halo_cm (owner-sharded, per-chip CM fast path, gather mode "
                  f"{hcm.gather_mode!r}) on {args.n_chips} partitions")
        else:
            cfg = dataclasses.replace(cfg, message_form="pallas")
            hp, state, run_halo = halo.distribute(graph, means, args.n_chips, device=device)
            print(f"path: halo (owner-sharded) on {args.n_chips} partitions")
        # Means-only template for the energy of the fast path (built once).
        metric_state = sweep.init_state(graph, means)
    else:
        cmg = sweep_cm.prepare(graph)
        if cmg is not None:
            state = sweep_cm.init_state(cmg, means)
            win = f", pose-window w={cmg.win_w}" if cmg.win_w else ""
            print(f"path: cm (persistent component-major, gather mode {cmg.gather_mode!r}{win})")
        else:
            # The generic engine in its kernel form (`fused_relin_messages`).
            cfg = dataclasses.replace(cfg, message_form="pallas")
            state = sweep.init_state(graph, means)
            print("path: generic sweep")
    print(f"device: {device}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    energies, ates = [], []
    ate0 = None if truth is None else pose_graph.ate(means[0], truth)
    t0 = time.time()
    for it in range(0, args.n_iters, args.print_every):
        n = min(args.print_every, args.n_iters - it)
        if hp is not None:
            state = run_halo(hcm if hcm is not None else hp.hgraph, state, cfg, n)
            mu = halo.collect_means(hp, state)
            e = (float(sweep.energy(graph, metric_state._replace(v=(
                metric_state.v[0]._replace(mean=mu[0]),)))) if hcm is not None
                else halo.energy_halo(hp, state))
        elif cmg is not None:
            state = sweep_cm.run(cmg, state, cfg, n)
            mu = (state.v[0].mean,)
            e = float(sweep.energy(graph, sweep_cm.to_gbp_state(cmg, state)))
        else:
            state = sweep.run(graph, state, cfg, n)
            mu = (state.v[0].mean,)
            e = float(sweep.energy(graph, state))
        line = f"sweep {it + n:4d}: energy {e:12.3f}"
        energies.append((it + n, e))
        if truth is not None:
            ates.append((it + n, pose_graph.ate(mu[0], truth)))
            line += f"  ATE {ates[-1][1]:8.4f}"
        print(line)
    sync()
    dt = time.time() - t0
    print(f"{args.n_iters} sweeps in {dt:.2f}s  ({args.n_iters / dt:.1f} sweeps/s)")
    return dict(energy=energies, ate=ates, ate0=ate0, sweeps_per_s=args.n_iters / dt,
                state=state, hp=hp, hcm=hcm)


if __name__ == "__main__":
    main()
