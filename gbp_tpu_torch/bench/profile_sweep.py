"""Where one sweep's time goes on the card: `torch.profiler` over a few
steady sweeps of one scene.

    python -m gbp_tpu_torch.bench.profile_sweep
        [--scene bench64|bench64_unfused|bench64_generic|nonlocal512|city|city1280_unfused|
                 city1280_halo2|city1280_halo2_unfused|venice|venice10240_unfused|
                 manhattan4000|ladybug49]
        [--sweeps 20] [--warm 10] [--out trace.json]

bench64, city and venice run the component-major fast path as `prepare`
sets it up (camera table, or windows); bench64_unfused, city1280_unfused
and venice10240_unfused those scenes with `prepare(ell_fused=False)` (the
unfused table kernels, or their windowed form, and the expansion); ladybug49 is
data/ladybug49_sim.txt.gz through `io.bal` and `build_bal` (the BAL model
with its per-row distortion arguments) under the in-engine annealing of
core/anneal.py, as `python -m gbp_tpu_torch.ba` runs it;
nonlocal512 (512 cameras that all see every landmark) lands on its expanded
operands (gather_mode "rows"); bench64_generic runs the bench scene through
the generic row-major sweep under message_form="pallas"; manhattan4000 a
4,000-pose Manhattan pose graph under `pose_graph.default_config()`;
city1280_halo2 the city scene cut into two owner-sharded partitions
(`parallel/halo_cm.distribute(graph, means, 2)`, plain layout) run in one
process through the halo exchange: per partition the windowed kernels with
the ghost table, then the exchange batched over the partitions;
city1280_halo2_unfused the same with `ell_fused=False` (the ELL slot
expanded per partition, kernels 14, 13, 12).

Prints the unprofiled time per sweep (CUDA events), the device time per
sweep summed over all kernels, the device's busy share (device time over
unprofiled sweep time), the kernel launches per sweep, and the device time
per sweep of each kernel name (the port's own kernels are `gbp::*`; the rest
is PyTorch glue), and `segsum_by_id`'s device time summed over its kernels
(the chunked form launches two, `segsum_chunk_kernel` then
`segsum_combine_kernel`; the short form one, `segsum_kernel`).  `--out` also
writes the chrome trace.  Needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

import dataclasses

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import anneal, sweep, sweep_cm
from gbp_tpu_torch.io import bal
from gbp_tpu_torch.models import ba, pose_graph
from gbp_tpu_torch.parallel import halo_cm

BENCH64 = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
SCENES = {
    "bench64": (lambda: ba.simulate(**BENCH64), {}),
    "bench64_unfused": (lambda: ba.simulate(**BENCH64), {}),
    "bench64_generic": (lambda: ba.simulate(**BENCH64), {}),
    "manhattan4000": (lambda: pose_graph.simulate_manhattan(
        n_poses=4000, seed=0, loop_prob=0.3, loop_radius=3.0), {"layout": "ell"}),
    "nonlocal512": (lambda: ba.simulate(n_cams=512, n_lmks=2000, pix_sigma=1.0, seed=0), {}),
    "city": (lambda: ba.simulate_blocks(**CITY), BIG_BUILD),
    "city1280_unfused": (lambda: ba.simulate_blocks(**CITY), BIG_BUILD),
    "city1280_halo2": (lambda: ba.simulate_blocks(**CITY), {**BIG_BUILD, "layout": "none"}),
    "city1280_halo2_unfused": (lambda: ba.simulate_blocks(**CITY),
                               {**BIG_BUILD, "layout": "none"}),
    "venice": (lambda: ba.simulate_blocks(**VENICE), BIG_BUILD),
    "venice10240_unfused": (lambda: ba.simulate_blocks(**VENICE), BIG_BUILD),
    "ladybug49": (lambda: bal.to_sim(bal.prune(bal.read_bal(LADYBUG))), {"layout": "ell"}),
}
LADYBUG = "data/ladybug49_sim.txt.gz"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="city")
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the chrome trace here")
    args = ap.parse_args(argv)

    device = gbp_tpu_torch.default_device()
    gbp_tpu_torch.set_exact_f32()
    card = card_line()
    make, build_kw = SCENES[args.scene]
    build = {"manhattan4000": pose_graph.build,
             "ladybug49": lambda *a, **k: ba.build_bal(*a, **k)[:2]}.get(args.scene, ba.build)
    sweep_cfg = pose_graph.default_config() if args.scene == "manhattan4000" else CFG
    graph, means = build(make(), dtype=torch.float32, device=device, **build_kw)
    if args.scene.startswith("city1280_halo2"):
        hp, hcm, state, run_halo = halo_cm.distribute(
            graph, means, 2, device=device,
            ell_fused=False if args.scene.endswith("_unfused") else None)
        run = lambda st, n: run_halo(hcm, st, sweep_cfg, n)
        state = run(state, args.warm)
        rows, win_w = 2 * hcm.mp, hcm.win_w
        mode = f"halo_cm on 2 partitions, {hcm.gather_mode}, ell_fused {hcm.ell_fused}"
    elif args.scene == "bench64_generic":
        cfg = dataclasses.replace(CFG, message_form="pallas")
        run = lambda st, n: sweep.run(graph, st, cfg, n)
        state = run(sweep.init_state(graph, means), args.warm)
        rows, win_w, mode = graph.fblocks[0].count, 0, "generic"
    else:
        cmg = sweep_cm.prepare(graph, window=True,
                               ell_fused=False if args.scene.endswith("_unfused") else None)
        if args.scene == "ladybug49":
            # The annealed run from its first schedule level on (sweeps past
            # the warm-up index keep the schedule's last level).
            run = lambda st, n: anneal.run_annealed_cm(cmg, st, sweep_cfg, n, i0=args.warm)
        else:
            run = lambda st, n: sweep_cm.run(cmg, st, sweep_cfg, n)
        state = run(sweep_cm.init_state(cmg, means), args.warm)
        rows, win_w, mode = cmg.mp, cmg.win_w, cmg.gather_mode
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(state, args.sweeps)
    end.record()
    torch.cuda.synchronize()
    sweep_ms = start.elapsed_time(end) / args.sweeps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state, args.sweeps)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = {}
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(evt.name, (0.0, 0))
            kernels[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    launches = sum(1 for evt in events if evt.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                       "cudaLaunchKernelExC"))
    device_ms = sum(ms for ms, _ in kernels.values()) / args.sweeps
    own_ms = sum(ms for name, (ms, _) in kernels.items() if "gbp::" in name) / args.sweeps
    segsum = {stage: sum(ms for name, (ms, _) in kernels.items() if f"gbp::{stage}<" in name)
              / args.sweeps
              for stage in ("segsum_chunk_kernel", "segsum_combine_kernel", "segsum_kernel")}
    out = {
        "scene": args.scene, "card": card, "sweeps": args.sweeps, "mp_rows": rows,
        "win_w": win_w, "mode": mode, "sweep_ms_unprofiled": sweep_ms, "device_ms_per_sweep": device_ms,
        "own_kernels_ms_per_sweep": own_ms, "glue_ms_per_sweep": device_ms - own_ms,
        "segsum_by_id_ms_per_sweep": sum(segsum.values()), "segsum_by_id_stages": segsum,
        "device_busy_share": device_ms / sweep_ms,
        "kernel_launches_per_sweep": launches / args.sweeps,
        "device_kernels_per_sweep": sum(n for _, n in kernels.values()) / args.sweeps,
    }
    print(f"[profile] {args.scene} on {card}: {rows} rows, win_w {win_w}, mode {mode}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"[profile] {ms / args.sweeps:9.4f} ms/sweep  {n / args.sweeps:6.1f} calls/sweep  "
              f"{name[:100]}")
    print(json.dumps(out))
    if args.out:
        prof.export_chrome_trace(args.out)
    return out


if __name__ == "__main__":
    main()
