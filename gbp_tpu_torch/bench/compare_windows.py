"""The windowed messages and relinearization kernels timed on the sweeps' own
operands at city, venice and city cut in two, by one or several checkouts
of the port in one call.

    python -m gbp_tpu_torch.bench.compare_windows [--label NAME] [--scenes city,halo2,venice,bench64]
        [--only WRAPPER,...] [--save DIR | --load DIR]
    cd OTHER && PYTHONPATH=. python /path/to/compare_windows.py --label NAME [--load DIR]

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
kernel's own launches over 20 calls, its bound (every operand it reads read
once and its four outputs written once at 3.35 TB/s), the share of the
bound, the launch plan where the checkout reports one
(`ops.messages.window_plan`), and a checksum of each output (a hash of its
bytes: two checkouts agree on it exactly when their outputs agree bit for
bit), with a checksum of the operands, which shows that every checkout
timed the same inputs.  A kernel's time depends on its operands (a state
ten sweeps on differs in its last bits between checkouts whose camera
sums add in different orders), so `--save DIR` writes the recorded
operands (one file a scene) and `--load DIR` times another checkout on
exactly those (`--only` times the listed wrappers alone).  The fused
wrappers (2, 10) also return the
camera-side sum; a checkout may compute it in the messages launch or in
launches of its own, so each wrapper's entry is reported too: the device
time a call of every kernel it launched, and the bound of all five outputs
(every operand read once, the sum's CSR too, every output written once).
The JSON also holds ptxas's report (registers, spilled bytes) of the
checkout's messages and camera-sum kernels, every instantiation.  Prints one
JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import gbp_tpu_torch
from gbp_tpu_torch.bench import BIG_BUILD, CFG, CITY, VENICE, card_line
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops import _build
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo_cm

CALLS = 20
WARM = 10
BENCH64 = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
PEAK_BYTES_PER_S = 3.35e12
# The kernel each wrapper launches (by the name the profiler shows) and its
# number in PERF.md's table.  Each writes four outputs (the fused messages
# wrappers also return the camera-side sum).
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
# The fused messages wrappers' last two operands: the camera sum's CSR.
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


# Keyword operands that hold no data of their own (the windowed fold's tile
# counters, zero before and after each launch; kernel 2's per-row segment
# map, made from the CSR): left out of the operands' checksum, and passed
# only to a checkout whose wrapper takes them.
STATE_KW = ("tile_counts", "seg_ids")


def taken(fn, kw):
    """kw without the STATE_KW keywords `fn` does not take."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k not in STATE_KW or k in params}


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
    without `window_plan` or `table_plan`, or another kernel)."""
    if name == "messages_cm_tab_ell" and hasattr(M, "table_plan"):
        me0, me1 = args[10], args[12]
        return M.table_plan(me0.dtype, n_cam=args[1].shape[0], n_seg=args[-1].shape[0] - 1,
                            mp=me0.shape[1], d0=me0.shape[0], d1=me1.shape[0],
                            z=args[6].shape[0], gslot=kw.get("gslot", 0), huber=kw.get("huber"))
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
    launched); for the fused wrappers also entry_ms (the device time a call
    of all of them), entry_bound_ms and entry_share (all five outputs) and
    sum_checksum (the fifth output's)}."""
    kernel, number = KERNELS[name]
    fn = getattr(M, name)
    every = fn(*args, **kw)
    outs = every[:4]
    read = tensors(args[:len(args) - NOT_READ.get(name, 0)], kw)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    b_ms = nbytes((*read, *outs)) / PEAK_BYTES_PER_S * 1e3
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
    out = dict(kernel=number, device_ms=ms, bound_ms=b_ms, share=b_ms / ms, launches=len(times),
               plan=plan_of(name, args, kw), checksums=[digest([o]) for o in outs],
               kernels={k: sum(ts) / CALLS for k, ts in by_kernel.items()})
    if name in NOT_READ:
        e_ms = sum(out["kernels"].values())
        e_bound = nbytes((*tensors(args, kw), *every)) / PEAK_BYTES_PER_S * 1e3
        out.update(entry_ms=e_ms, entry_bound_ms=e_bound, entry_share=e_bound / e_ms,
                   sum_checksum=digest([every[4]]))
    return out


def report_line(name, r):
    return (f"#{r['kernel']} {name}: device {r['device_ms']:.4f} ms ({r['launches']} launches "
            f"profiled), bound {r['bound_ms']:.4f} ms, share {r['share']:.3f}, outputs "
            f"{' '.join(r['checksums'])}"
            + ("" if "entry_ms" not in r else
               f"; entry (every kernel a call) {r['entry_ms']:.4f} ms, bound "
               f"{r['entry_bound_ms']:.4f} ms, share {r['entry_share']:.3f}, sum "
               f"{r['sum_checksum']}")
            + ("" if r["plan"] is None else f", plan {r['plan']}"))


# The kernels whose ptxas lines the report keeps.
PTXAS_KERNELS = ("messages_kernel", "messages_win_kernel", "messages_win_tile_kernel",
                 "segsum_chunk_kernel", "segsum_blk_kernel", "segsum_combine_kernel")


def ptxas_lines():
    """[(mangled name, registers, spill store bytes, spill load bytes)] of
    the checkout's build (`ops._build.ptxas_report`) for PTXAS_KERNELS."""
    found = re.findall(
        r"Compiling entry function '_ZN3gbp\d+([^']+)' for 'sm_90a'\n(?:.*\n)*?.*?(\d+) bytes "
        r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
        _build.ptxas_report())
    return [(name, int(regs), int(st), int(ld)) for name, st, ld, regs in found
            if name.startswith(PTXAS_KERNELS)]


def measure(label, scenes, save=None, load=None, only=None):
    dev = gbp_tpu_torch.default_device()
    gbp_tpu_torch.set_exact_f32()
    _build.build()
    out = {"label": label, "card": card_line(), "scenes": {}, "ptxas": ptxas_lines()}
    for name, regs, st, ld in out["ptxas"]:
        print(f"[windows] {label} ptxas {regs:>3} registers, spills {st}/{ld} bytes: {name[:90]}")
    for scene in scenes:
        if load:
            calls = torch.load(Path(load) / f"{scene}.pt", map_location=dev)
        else:
            calls = scene_calls(scene, dev)
        if save:
            Path(save).mkdir(parents=True, exist_ok=True)
            torch.save(calls, Path(save) / f"{scene}.pt")
        rec = {"operand_checksum": digest(
            t for a, k in calls.values()
            for t in tensors(a, {n: v for n, v in k.items() if n not in STATE_KW}))}
        for name, (args, kw) in calls.items():
            if only and name not in only:
                continue
            rec[name] = kernel_report(name, args, taken(getattr(M, name), kw))
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
    ap.add_argument("--only", default=None, help="time these wrappers alone (comma-separated)")
    ops = ap.add_mutually_exclusive_group()
    ops.add_argument("--save", default=None, help="write the recorded operands here")
    ops.add_argument("--load", default=None, help="time the operands written by --save")
    args = ap.parse_args(argv)
    measure(args.label, args.scenes.split(","), args.save, args.load,
            args.only.split(",") if args.only else None)


if __name__ == "__main__":
    main()
