"""Bundle adjustment from the command line: BAL files or synthetic scenes.

Counterpart of the repository's root `ba.py` on the port, with the same
flags and the same lines of output:

    python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz --n_iters 100 --oracle
    python -m gbp_tpu_torch.ba --bal_file data/toy_ba.txt --device cpu
    python -m gbp_tpu_torch.ba --n_cams 16 --n_lmks 400           # synthetic scene
    python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz --n_chips 2 --oracle

Loads a BAL file (read_bal -> prune -> to_sim -> build_bal) or simulates a
scene, takes the component-major fast path where `sweep_cm.prepare` accepts
the graph and message_form is "pallas" (the generic engine otherwise, and
for "covariance" / "schur"), runs the whole solve under the in-engine
prior-annealing schedule (core/anneal.py) and prints the average
reprojection error every `--weaken_every` sweeps, the sweep rate and, with
`--oracle`, the dense-MAP error under the final weakened priors.  Runs on
the card unless `--device cpu` is given.

`--n_chips P` > 1 cuts the graph into P owner-sharded partitions
(parallel/halo.py) and runs them through the halo exchange: the per-partition
fast path (parallel/halo_cm.py) where it takes the graph, the generic halo
sweep otherwise, annealed by `anneal.make_run_annealed_halo`.  The P
partitions run in one process on `--device`, exchanging through the
single-process communicator (`halo.LocalComm`).
"""
from __future__ import annotations

import argparse
import time

import torch

import gbp_tpu_torch
from gbp_tpu_torch.core import anneal, oracle, sweep, sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.parallel import halo, halo_cm


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bal_file", "--file", default=None,
                   help="BAL-format problem file (optionally .gz)")
    p.add_argument("--n_iters", type=int, default=100, help="GBP sweeps")
    p.add_argument("--eta_damping", type=float, default=0.4)
    p.add_argument("--lam_damping", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=0.01,
                   help="relinearization threshold on belief-mean motion")
    p.add_argument("--num_undamped_iters", type=int, default=6)
    p.add_argument("--min_linear_iters", type=int, default=8)
    p.add_argument("--huber", type=float, default=None,
                   help="Huber Mahalanobis threshold in std-devs (None = off)")
    p.add_argument("--pix_sigma", type=float, default=1.0)
    p.add_argument("--prior_prec", type=float, default=1.0,
                   help="initial camera/landmark prior precision, before the weakening "
                        "schedule (chain-structured scenes such as corridor_sim need ~1000)")
    p.add_argument("--weaken_every", type=int, default=10,
                   help="weaken non-anchor priors every N sweeps")
    p.add_argument("--weaken_factor", type=float, default=0.1)
    p.add_argument("--weaken_times", type=int, default=3)
    p.add_argument("--anneal_damp_window", type=int, default=None,
                   help="sweeps of raised lam damping after each weakening "
                        "(default: weaken_every)")
    p.add_argument("--anneal_damp_lam", type=float, default=0.4)
    p.add_argument("--n_cams", type=int, default=16)
    p.add_argument("--n_lmks", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--oracle", action="store_true",
                   help="also print the dense-MAP reprojection error")
    p.add_argument("--message_form", default="pallas", choices=("pallas", "covariance", "schur"),
                   help="'pallas': the kernels (the component-major fast path where the "
                        "graph allows it); 'schur' is float64 only")
    p.add_argument("--optimize_intrinsics", action="store_true",
                   help="9-dof BAL cameras [omega, t, rf, k1, k2] in the state; needs "
                        "--bal_file")
    p.add_argument("--n_chips", type=int, default=1,
                   help="owner-sharded partitions of the graph (halo exchange), run in one "
                        "process on --device")
    p.add_argument("--dtype", default="f32", choices=("f32", "f64"),
                   help="f64 for parity runs; forced by --message_form schur")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns what it printed as numbers: {"are": [(sweep,
    ARE px), ...], "sweeps_per_s", "are_map" (None without --oracle),
    "path", "cmg", "state", "graph", and with --n_chips > 1 "hp", "hcm"}."""
    args = parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()
    cfg = GBPConfig(eta_damping=args.eta_damping, lam_damping=args.lam_damping, beta=args.beta,
                    num_undamped_iters=args.num_undamped_iters,
                    min_linear_iters=args.min_linear_iters, message_form=args.message_form)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if args.message_form == "schur":
        dtype = torch.float64
        print("message_form=schur: building in f64 (f32 is numerically unsafe for the "
              "info-form marginalization)")

    px_scale = k = None
    layout = "none" if args.n_chips > 1 else "ell"  # halo partitions the plain layout
    if args.bal_file:
        from gbp_tpu_torch.io import bal as balio

        sim = balio.to_sim(balio.prune(balio.read_bal(args.bal_file)), pix_sigma=args.pix_sigma)
        graph, means, px_scale = ba.build_bal(
            sim, huber=args.huber, layout=layout, dtype=dtype, device=device,
            cam_prior_prec=args.prior_prec, lmk_prior_prec=args.prior_prec,
            optimize_intrinsics=args.optimize_intrinsics)
        print(f"loaded {args.bal_file}: {sim['cam_init'].shape[0]} cams, "
              f"{sim['lmk_init'].shape[0]} landmarks, {sim['obs'].shape[0]} observations"
              + (" (9-dof cameras: optimizing intrinsics)" if args.optimize_intrinsics else ""))
    else:
        if args.optimize_intrinsics:
            raise SystemExit("--optimize_intrinsics requires --bal_file")
        sim = ba.simulate(n_cams=args.n_cams, n_lmks=args.n_lmks, pix_sigma=args.pix_sigma,
                          seed=args.seed)
        graph, means = ba.build(sim, huber=args.huber, layout=layout, dtype=dtype, device=device,
                                cam_prior_prec=args.prior_prec, lmk_prior_prec=args.prior_prec)
        k = sim["k"]
        print(f"simulated scene: {args.n_cams} cams, {sim['lmk_init'].shape[0]} landmarks, "
              f"{sim['obs'].shape[0]} observations")

    cmg = hp = hcm = None
    if args.n_chips > 1:
        out = (halo_cm.distribute(graph, means, args.n_chips, device=device)
               if args.message_form == "pallas" else None)
        if out is not None:
            hp, hcm, state, _ = out
            path = "halo_cm (owner-sharded, per-chip CM fast path)"
        else:
            hp, state, _ = halo.distribute(graph, means, args.n_chips, device=device)
            path = "halo (owner-sharded)"
        where = f"{device.type}:{torch.cuda.current_device()}" if (
            device.type == "cuda" and device.index is None) else str(device)
        print(f"path: {path} on {args.n_chips} partitions of {where}")
        # Means-only template for the metrics (built once).
        metric_state = sweep.init_state(graph, means)
    else:
        cmg = sweep_cm.prepare(graph) if args.message_form == "pallas" else None
        if cmg is not None:
            state = sweep_cm.init_state(cmg, means)
            win = f", camera-window w={cmg.win_w}" if cmg.win_w else ""
            path = f"persistent component-major sweep (gather_mode={cmg.gather_mode}{win})"
        else:
            state = sweep.init_state(graph, means)
            path = f"generic sweep ({args.message_form})"
        print(f"path: {path} on {device}")

    def gbp_state(st):
        if hp is not None:
            return ba.with_means(metric_state, halo.collect_means(hp, st))
        return sweep_cm.to_gbp_state(cmg, st) if cmg is not None else st

    def current_are(st):
        return float(ba.avg_reprojection_error(graph, gbp_state(st), k=k, px_scale=px_scale))

    damp_window = (args.weaken_every if args.anneal_damp_window is None
                   else args.anneal_damp_window)
    sched = dict(every=args.weaken_every, factor=args.weaken_factor, times=args.weaken_times,
                 damp_window=damp_window, damp_lam=args.anneal_damp_lam)
    if hp is not None:
        run = anneal.make_run_annealed_halo(hp, state)
        operand = hcm if hcm is not None else hp.hgraph
    else:
        run, operand = (anneal.run_annealed_cm, cmg) if cmg is not None else \
            (anneal.run_annealed, graph)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    are = [(0, current_are(state))]
    print(f"sweep   0: avg reprojection error {are[0][1]:9.4f} px")
    sync()
    t0 = time.perf_counter()
    for it in range(0, args.n_iters, args.weaken_every):
        n = min(args.weaken_every, args.n_iters - it)
        state = run(operand, state, cfg, n, i0=it, **sched)
        are.append((it + n, current_are(state)))
        print(f"sweep {it + n:3d}: avg reprojection error {are[-1][1]:9.4f} px")
    sync()
    dt = time.perf_counter() - t0
    # The final effective priors: factor^k on the non-anchor priors, k the
    # weakening events that fired.
    k_fired = min(args.weaken_times, max(0, (args.n_iters - 1) // args.weaken_every))
    if k_fired:
        graph = ba.weaken_priors(graph, args.weaken_factor ** k_fired)
    rate = args.n_iters / dt
    print(f"{args.n_iters} sweeps in {dt:.2f}s  ({rate:.1f} sweeps/s)")

    are_map = None
    if args.oracle:
        gstate = (sweep.init_state(graph, halo.collect_means(hp, state)) if hp is not None
                  else gbp_state(state))
        ref = ba.with_means(gstate, oracle.map_solution(graph, gstate))
        are_map = float(ba.avg_reprojection_error(graph, ref, k=k, px_scale=px_scale))
        print(f"dense-MAP avg reprojection error {are_map:9.4f} px")
    return dict(are=are, sweeps_per_s=rate, are_map=are_map, path=path, cmg=cmg, state=state,
                graph=graph, hp=hp, hcm=hcm)


if __name__ == "__main__":
    main()
