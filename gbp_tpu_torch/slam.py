"""Pose-graph SLAM from the command line: g2o files or synthetic worlds.

Counterpart of the repository's root `slam.py` on the port:

    python -m gbp_tpu_torch.slam --g2o_file data/manhattan_sim.g2o --n_iters 200
    python -m gbp_tpu_torch.slam --n_poses 500 --n_iters 200       # Manhattan world
    python -m gbp_tpu_torch.slam --se3 --n_poses 120               # SE(3) helix

Builds the graph in ELL layout, takes the component-major fast path where
`sweep_cm.prepare` accepts the graph (diagonal information) and the generic
sweep in its kernel form (message_form="pallas") otherwise (a g2o file with
full information matrices), and prints the path chosen, the energy (and the
ATE where the truth is known) every `--print_every` sweeps, and sweeps/s.
Runs on the card unless `--device cpu` is given.
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
                   help="more than one device is not ported yet (ROADMAP A12)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.n_chips != 1:
        raise NotImplementedError(
            f"--n_chips {args.n_chips}: partitioning a pose graph over several devices is not "
            f"ported yet (ROADMAP A12)")
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    cfg = pose_graph.default_config()
    truth = None
    if args.g2o_file:
        data = g2o.read_g2o(args.g2o_file)
        graph, means = pose_graph.build_g2o(data, huber=args.huber, layout="ell", device=device)
        print(f"loaded {args.g2o_file} ({data['kind']}): {data['poses'].shape[0]} poses, "
              f"{data['edges_ij'].shape[0]} edges")
    elif args.se3:
        data = pose_graph.simulate_helix(n_poses=args.n_poses, seed=args.seed)
        graph, means = pose_graph.build_g2o(data, huber=args.huber, layout="ell", device=device)
        truth = data["truth"]
        print(f"simulated SE(3) helix: {args.n_poses} poses, {data['edges_ij'].shape[0]} edges")
    else:
        sim = pose_graph.simulate_manhattan(n_poses=args.n_poses, outlier_frac=args.outlier_frac,
                                            seed=args.seed)
        graph, means = pose_graph.build(sim, huber=args.huber, layout="ell", device=device)
        truth = sim["truth"]
        print(f"simulated Manhattan world: {args.n_poses} poses, {sim['odom_ij'].shape[0]} "
              f"odometry + {sim['loop_ij'].shape[0]} loop factors")

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

    t0 = time.time()
    for it in range(0, args.n_iters, args.print_every):
        n = min(args.print_every, args.n_iters - it)
        if cmg is not None:
            state = sweep_cm.run(cmg, state, cfg, n)
            e = float(sweep.energy(graph, sweep_cm.to_gbp_state(cmg, state)))
        else:
            state = sweep.run(graph, state, cfg, n)
            e = float(sweep.energy(graph, state))
        line = f"sweep {it + n:4d}: energy {e:12.3f}"
        if truth is not None:
            line += f"  ATE {pose_graph.ate(state.v[0].mean, truth):8.4f}"
        print(line)
    sync()
    dt = time.time() - t0
    print(f"{args.n_iters} sweeps in {dt:.2f}s  ({args.n_iters / dt:.1f} sweeps/s)")


if __name__ == "__main__":
    main()
