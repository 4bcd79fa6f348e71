"""Wall-clock to convergence: GBP sweeps against the Schur / CG Gauss-Newton
solver on one bundle-adjustment problem.

Counterpart of gbp_tpu/bench/convergence.py.  The generic engine
(`core.sweep`, message_form "pallas": kernels 20, 19 and 3 once a sweep)
runs in chunks of `--chunk` sweeps, each chunk one CUDA-graph replay
(`utils.capture.CapturedRun`; the capture is made before the clock starts),
synced and its ARE computed with the clock running, up to `--max_sweeps`,
until the ARE is within `--tol_px` of the Gauss-Newton optimum
(`schur.solve(graph, means, n_steps=5, cg_iters=100)`, timed once,
first-call costs included).  Prints the ARE after each chunk and one JSON
line with the reference's keys.

    python -m gbp_tpu_torch.bench.convergence [--bal_file data/ladybug49_sim.txt.gz]
        [--n_cams 32] [--n_lmks 2000] [--max_sweeps 400] [--chunk 20]
        [--tol_px 0.02] [--device cpu]

Runs on the card unless `--device cpu` is given (eagerly, host clock).
"""
from __future__ import annotations

import argparse
import json
import time

import gbp_tpu_torch
from gbp_tpu_torch.bench import card_line, kernels_used
from gbp_tpu_torch.bench.headline import sync
from gbp_tpu_torch.core.sweep import GBPConfig, init_state, sweep
from gbp_tpu_torch.io import bal as balio
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops.messages import COUNTS
from gbp_tpu_torch.parallel import schur
from gbp_tpu_torch.utils.capture import CapturedRun


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bal_file", default=None)
    p.add_argument("--n_cams", type=int, default=32)
    p.add_argument("--n_lmks", type=int, default=2000)
    p.add_argument("--max_sweeps", type=int, default=400)
    p.add_argument("--chunk", type=int, default=20)
    p.add_argument("--tol_px", type=float, default=0.02,
                   help="converged when ARE is within tol of the GN optimum")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = gbp_tpu_torch.resolve_device(args.device)
    gbp_tpu_torch.set_exact_f32()

    px_scale, k = None, None
    if args.bal_file:
        sim = balio.to_sim(balio.prune(balio.read_bal(args.bal_file)))
        graph, means, px_scale = ba.build_bal(sim, device=device)
    else:
        sim = ba.simulate(n_cams=args.n_cams, n_lmks=args.n_lmks, seed=0)
        graph, means = ba.build(sim, device=device)
        k = sim["k"]
    fb = graph.fblocks[0]
    m = int(fb.valid.sum()) if fb.valid is not None else fb.count
    print(f"problem: {means[0].shape[0]} cams, {means[1].shape[0]} lmks, {m} obs on "
          f"{card_line() if device.type == 'cuda' else device}", flush=True)

    def are_of(state):
        return float(ba.avg_reprojection_error(graph, state, k=k, px_scale=px_scale))

    # Gauss-Newton via the Schur complement (the direct solver's reference point).
    state0 = init_state(graph, means)
    sync(device)
    t0 = time.perf_counter()
    gn_means = schur.solve(graph, means, n_steps=5, cg_iters=100)
    sync(device)
    t_gn = time.perf_counter() - t0
    are_gn = are_of(ba.with_means(state0, gn_means))
    print(f"schur-GN: {t_gn:.2f}s (incl. first calls) -> ARE {are_gn:.4f} px", flush=True)

    # GBP sweeps (the capture excluded: one chunk first, then back to the start).
    cfg = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8,
                    message_form="pallas")
    COUNTS.reset()
    run = CapturedRun(lambda s: sweep(graph, s, cfg), state0, args.chunk)
    run()
    run.load(state0)
    sync(device)
    t0 = time.perf_counter()
    t_conv, sweeps_done = None, 0
    curve = [(0, are_of(state0))]
    for it in range(0, args.max_sweeps, args.chunk):
        state = run()
        sync(device)
        sweeps_done = it + args.chunk
        are = are_of(state)
        curve.append((sweeps_done, are))
        print(f"  sweep {sweeps_done:4d}: ARE {are:.4f} px ({time.perf_counter() - t0:.2f}s)",
              flush=True)
        if t_conv is None and are <= are_gn + args.tol_px:
            t_conv = time.perf_counter() - t0
            break
    print(f"kernels: {kernels_used()}", flush=True)
    result = {
        "metric": "ba_wallclock_to_convergence",
        "gbp_seconds": round(t_conv if t_conv is not None else float("nan"), 3),
        "gbp_sweeps": sweeps_done,
        "gn_seconds_incl_compile": round(t_gn, 3),
        "are_gn_px": round(are_gn, 4),
        "are_gbp_px": round(curve[-1][1], 4),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
