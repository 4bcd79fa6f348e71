"""Where one sweep's time goes on the card: `torch.profiler` over a few
steady sweeps of one scene.

    python -m gbp_tpu_torch.bench.profile_sweep
        [--scene bench64|bench64_generic|nonlocal512|city|venice]
        [--sweeps 20] [--warm 10] [--out trace.json]

bench64, city and venice run the component-major fast path as `prepare`
sets it up (camera table, or windows); nonlocal512 (512 cameras that all
see every landmark) lands on its expanded operands (gather_mode "rows");
bench64_generic runs the bench scene through the generic row-major sweep
under message_form="pallas".

Prints the unprofiled time per sweep (CUDA events), the device time per
sweep summed over all kernels, the device's busy share (device time over
unprofiled sweep time), the kernel launches per sweep, and the device time
per sweep of each kernel name (the port's own kernels are `gbp::*`; the rest
is PyTorch glue).  `--out` also writes the chrome trace.  Needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

import dataclasses

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import sweep, sweep_cm
from gbp_tpu_torch.models import ba

BENCH64 = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
SCENES = {
    "bench64": (lambda: ba.simulate(**BENCH64), {}),
    "bench64_generic": (lambda: ba.simulate(**BENCH64), {}),
    "nonlocal512": (lambda: ba.simulate(n_cams=512, n_lmks=2000, pix_sigma=1.0, seed=0), {}),
    "city": (lambda: ba.simulate_blocks(**CITY), BIG_BUILD),
    "venice": (lambda: ba.simulate_blocks(**VENICE), BIG_BUILD),
}


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
    graph, means = ba.build(make(), dtype=torch.float32, device=device, **build_kw)
    if args.scene == "bench64_generic":
        cfg = dataclasses.replace(CFG, message_form="pallas")
        run = lambda st, n: sweep.run(graph, st, cfg, n)
        state = run(sweep.init_state(graph, means), args.warm)
        rows, win_w, mode = graph.fblocks[0].count, 0, "generic"
    else:
        cmg = sweep_cm.prepare(graph, segsum_exact=True, window=True)
        run = lambda st, n: sweep_cm.run(cmg, st, CFG, n)
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
    out = {
        "scene": args.scene, "card": card, "sweeps": args.sweeps, "mp_rows": rows,
        "win_w": win_w, "mode": mode, "sweep_ms_unprofiled": sweep_ms, "device_ms_per_sweep": device_ms,
        "own_kernels_ms_per_sweep": own_ms, "glue_ms_per_sweep": device_ms - own_ms,
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
