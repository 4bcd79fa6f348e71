"""The windowed messages and relinearization kernels timed on the sweeps' own
operands at city, venice and city cut in two, by one or several checkouts
of the port in one call.

    python -m gbp_tpu_torch.bench.compare_windows [--label NAME] [--scenes city,halo2,venice,bench64]
    cd OTHER && PYTHONPATH=. python /path/to/compare_windows.py --label NAME

For each scene the process builds it in float32 (bench.CITY, bench.VENICE),
runs 10 sweeps and records the operands of the 11th sweep's windowed
kernel calls, fused (`prepare(window=True)`) and unfused
(`ell_fused=False`):
  city, venice  kernels 10 `messages_cm_tabblk_ell`, 11 `relin_cm_tabblk_ell`,
                8 `messages_cm_tabblk`, 9 `relin_cm_tabblk`;
  halo2         city cut in two owner-sharded partitions
                (`halo_cm.distribute`, plain layout), partition 0: kernels
                17 `messages_cm_tabblkg_ell`, 18 `relin_cm_tabblkg_ell`,
                12 `messages_cm_tabblkg`, 13 `relin_cm_tabblkg`;
  bench64       the full-table kernels beside them, whose code the windowed
                kernels share: 2 `messages_cm_tab_ell` (fused), 6
                `messages_cm_tab` (unfused).
On them it times each kernel by the profiler: the mean device time of the
kernel's own launches over 20 calls (not the wrapper's other launches:
kernel 10's wrapper also runs kernel 16), its bound (every operand it reads read
once and its four outputs written once at 3.35 TB/s), the share of the
bound, the launch plan where the checkout reports one
(`ops.messages.window_plan`), and a checksum of each output (a hash of its
bytes: two checkouts agree on it exactly when their outputs agree bit for
bit), with a checksum of the operands, which shows that every checkout
timed the same inputs.  Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json

import torch
from torch.profiler import ProfilerActivity, profile

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo_cm

CALLS = 20
WARM = 10
BENCH64 = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
PEAK_BYTES_PER_S = 3.35e12
# The kernel each wrapper launches (by the name the profiler shows) and its
# number in PERF.md's table.  Each writes four outputs (the fused messages
# wrapper also returns kernel 16's window partials).
KERNELS = {
    "messages_cm_tabblk_ell": ("gbp::messages_win_kernel", 10),
    "relin_cm_tabblk_ell": ("gbp::relin_win_kernel", 11),
    "messages_cm_tabblk": ("gbp::messages_tabblk_kernel", 8),
    "relin_cm_tabblk": ("gbp::relin_tabblk_kernel", 9),
    "messages_cm_tabblkg_ell": ("gbp::messages_win_kernel", 17),
    "relin_cm_tabblkg_ell": ("gbp::relin_win_kernel", 18),
    "messages_cm_tabblkg": ("gbp::messages_tabblk_kernel", 12),
    "relin_cm_tabblkg": ("gbp::relin_tabblk_kernel", 13),
    "messages_cm_tab_ell": ("gbp::messages_kernel", 2),
    "messages_cm_tab": ("gbp::messages_tab_kernel", 6),
}
# The fused messages wrappers' last two operands (the camera sum's CSR) are
# kernel 16's or kernel 3's, not read by kernel 10 or 2.
NOT_READ = {"messages_cm_tabblk_ell": 2, "messages_cm_tab_ell": 2}


def recorded_calls(module, names, run_one):
    """{name: (args, kwargs)} of the first call of each kernel wrapper
    `names` (as `module` calls it) during `run_one()`."""
    calls, real = {}, {n: getattr(module, n) for n in names}

    def recorder(name):
        def record(*args, **kw):
            calls.setdefault(name, (args, kw))
            return real[name](*args, **kw)
        return record

    try:
        for n in names:
            setattr(module, n, recorder(n))
        run_one()
    finally:
        for n, f in real.items():
            setattr(module, n, f)
    return calls


def scene_calls(scene, device):
    """{wrapper name: (args, kwargs)} of one steady sweep of `scene`."""
    calls = {}
    if scene == "bench64":
        graph, means = ba.build(ba.simulate(**BENCH64), dtype=torch.float32, device=device)
        for fused, names in ((None, ("messages_cm_tab_ell",)), (False, ("messages_cm_tab",))):
            cmg = sweep_cm.prepare(graph, ell_fused=fused)
            st = sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, WARM)
            calls.update(recorded_calls(sweep_cm, names, lambda: sweep_cm.sweep(cmg, st, CFG)))
        return calls
    sim = ba.simulate_blocks(**(VENICE if scene == "venice" else CITY))
    if scene == "halo2":
        graph, means = ba.build(sim, dtype=torch.float32, device=device,
                                **{**BIG_BUILD, "layout": "none"})
        for fused, names in ((True, ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell")),
                             (False, ("relin_cm_tabblkg", "messages_cm_tabblkg"))):
            _, hcm, st, run = halo_cm.distribute(graph, means, 2, device=device,
                                                 ell_fused=fused)
            st = run(hcm, st, CFG, WARM)
            calls.update(recorded_calls(halo_cm, names, lambda: run(hcm, st, CFG, 1)))
        return calls
    graph, means = ba.build(sim, dtype=torch.float32, device=device, **BIG_BUILD)
    for fused, names in ((None, ("relin_cm_tabblk_ell", "messages_cm_tabblk_ell")),
                         (False, ("relin_cm_tabblk", "messages_cm_tabblk"))):
        cmg = sweep_cm.prepare(graph, window=True, ell_fused=fused)
        st = sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, WARM)
        calls.update(recorded_calls(sweep_cm, names, lambda: sweep_cm.sweep(cmg, st, CFG)))
    return calls


def device_ms(fn):
    """{kernel name: [device ms of each launch]} over CALLS calls, after a
    warm one (the profiler may drop some launches' records)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def tensors(args, kw):
    return [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# Positions of r0 and me0 among the messages wrappers' arguments.
POS = {"messages_cm_tabblk_ell": (7, 11), "messages_cm_tabblk": (3, 12),
       "messages_cm_tabblkg_ell": (8, 12), "messages_cm_tabblkg": (3, 13)}


def plan_of(name, args, kw):
    """The checkout's launch plan of a messages kernel, or None (a checkout
    without `window_plan`, or another kernel)."""
    if not hasattr(M, "window_plan") or name not in POS:
        return None
    i_r0, i_me0 = POS[name]
    me0, me1 = args[i_me0], args[i_me0 + 2]
    return M.window_plan(name, me0.dtype, win_w=kw["win_w"], mp=me0.shape[1], d0=me0.shape[0],
                         d1=me1.shape[0], z=args[i_r0].shape[0], gslot=kw.get("gslot", 0),
                         huber=kw.get("huber"))


def kernel_report(name, args, kw):
    """The kernel behind wrapper `name` on these operands: {kernel (its
    number), device_ms (the mean of its launches the profiler recorded),
    bound_ms, share, launches (recorded), plan, checksums (of its four
    outputs), kernels (device ms per call of every kernel the wrapper
    launched)}."""
    kernel, number = KERNELS[name]
    fn = getattr(M, name)
    outs = fn(*args, **kw)[:4]
    read = tensors(args[:len(args) - NOT_READ.get(name, 0)], kw)
    b_ms = sum(t.numel() * t.element_size() for t in (*read, *outs)) / PEAK_BYTES_PER_S * 1e3
    # The mean over the launches the profiler recorded (one per call), in a
    # new window while it recorded none (it may drop a window's records).
    # float64 and the 12-dof shapes launch the per-tile form of a windowed
    # messages kernel (`..._tile_kernel`).
    names = (kernel + "<", kernel.replace("_kernel", "_tile_kernel") + "<")
    for _ in range(5):
        by_kernel = device_ms(lambda: fn(*args, **kw))
        times = [t for k, ts in by_kernel.items() if any(n in k for n in names) for t in ts]
        if times:
            break
    else:
        raise RuntimeError(f"the profiler recorded no launch of {kernel}")
    ms = sum(times) / len(times)
    return dict(kernel=number, device_ms=ms, bound_ms=b_ms, share=b_ms / ms, launches=len(times),
                plan=plan_of(name, args, kw), checksums=[digest([o]) for o in outs],
                kernels={k: sum(ts) / CALLS for k, ts in by_kernel.items()})


def report_line(name, r):
    return (f"#{r['kernel']} {name}: device {r['device_ms']:.4f} ms ({r['launches']} launches "
            f"profiled), bound {r['bound_ms']:.4f} ms, share {r['share']:.3f}, outputs "
            f"{' '.join(r['checksums'])}"
            + ("" if r["plan"] is None else f", plan {r['plan']}"))


def measure(label, scenes):
    dev = gbp_tpu_torch.default_device()
    gbp_tpu_torch.set_exact_f32()
    out = {"label": label, "card": card_line(), "scenes": {}}
    for scene in scenes:
        calls = scene_calls(scene, dev)
        rec = {"operand_checksum": digest(t for a, k in calls.values() for t in tensors(a, k))}
        for name, (args, kw) in calls.items():
            rec[name] = kernel_report(name, args, kw)
            print(f"[windows] {label} {scene} {report_line(name, rec[name])}")
        out["scenes"][scene] = rec
        del calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--scenes", default="city,halo2,venice,bench64")
    args = ap.parse_args(argv)
    measure(args.label, args.scenes.split(","))


if __name__ == "__main__":
    main()
