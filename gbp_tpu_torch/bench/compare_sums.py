"""The camera-side sums, `segsum_by_id`, `scatter_windows_cm` and the window
partials `segsum_cm_blk`, timed on the same inputs by two checkouts of the
port, for a comparison on one card in one call.

    python -m gbp_tpu_torch.bench.compare_sums --save DIR
        builds the scenes with this checkout, writes their index structures
        to DIR and times this checkout on them;
    cd OTHER && PYTHONPATH=. python /path/to/compare_sums.py --load DIR --label NAME
        times the checkout in OTHER (the `gbp_tpu_torch` found first on the
        path) on the same index structures.

Scenes: bench64, ladybug49 and nonlocal512 for `segsum_by_id`, each on two
CSRs of its camera ids: the valid rows only (what `prepare` lists) and every
row (padded rows and the ELL clones included: a landmark's clone rows all
name the camera of its first row, so they make long runs); city and venice
for `scatter_windows_cm` on their windows; city, venice and city cut in two
owner-sharded partitions (`halo_cm.distribute`, plain layout; partition 0,
whose CSR lists its owned rows only) for `segsum_cm_blk` on their CSRs
(`win_rows`, `win_offsets`).  Messages and partials are
normal values from a seeded generator on the card, the same bits in every
process.  A checkout whose `scatter_windows_cm` takes the cover lists
(`window_cover_csr`) gets them, and the block lists too where it names them
as keyword arguments.

Prints, per scene, CSR and sum, the device time per call (the profiler's
kernel time, every kernel of the call summed, over 20 calls), the events
time per call, and the max abs difference from the plain version; for
`segsum_cm_blk` the mean device time of the kernel's recorded launches, its
bound (operands read once, partials written once, at 3.35 TB/s), the
share, the launch plan where the checkout reports one, whether it equals
the plain version on CPU copies of its operands bit for bit, and a digest
of its output (equal digests: equal bits); then one JSON line with all of
them.  Needs a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gbp_tpu_torch.bench import compare_windows as CW
from gbp_tpu_torch.ops import messages as M

SEG_SCENES = ("bench64", "ladybug49", "nonlocal512")
SCATTER_SCENES = ("city", "venice")
BLK_SCENES = ("city", "venice", "city_halo2")
CALLS = 20


def _by_id(ids, keep, n_seg):
    sel = np.flatnonzero(keep)
    rows = sel[np.argsort(ids[sel], kind="stable")].astype(np.int32)
    return rows, np.concatenate([[0], np.cumsum(np.bincount(ids[sel], minlength=n_seg))]
                                ).astype(np.int32)


def save(out_dir):
    """Build the scenes with this checkout and write their index structures."""
    from gbp_tpu_torch.bench import BIG_BUILD, CITY, VENICE
    from gbp_tpu_torch.bench.profile_sweep import BENCH64, LADYBUG
    from gbp_tpu_torch.core import sweep_cm
    from gbp_tpu_torch.io import bal
    from gbp_tpu_torch.models import ba
    from gbp_tpu_torch.parallel import halo_cm

    os.makedirs(out_dir, exist_ok=True)
    made = {
        "bench64": lambda: ba.build(ba.simulate(**BENCH64), dtype=torch.float32),
        "ladybug49": lambda: ba.build_bal(bal.to_sim(bal.prune(bal.read_bal(LADYBUG))),
                                          dtype=torch.float32, layout="ell")[:2],
        "nonlocal512": lambda: ba.build(ba.simulate(n_cams=512, n_lmks=2000, pix_sigma=1.0,
                                                    seed=0), dtype=torch.float32),
        "city": lambda: ba.build(ba.simulate_blocks(**CITY), dtype=torch.float32, **BIG_BUILD),
        "venice": lambda: ba.build(ba.simulate_blocks(**VENICE), dtype=torch.float32,
                                   **BIG_BUILD),
    }
    for scene, make in made.items():
        graph, _ = make()
        cmg = sweep_cm.prepare(graph, window=True)
        n_cam = cmg.base.vblocks[0].count
        gidx = cmg.gidx.cpu().numpy()
        rec = {"n_seg": n_cam, "mp": cmg.mp}
        if scene in SEG_SCENES:
            rec["valid"] = (cmg.seg_rows.cpu().numpy(), cmg.seg_offsets.cpu().numpy())
            rec["all"] = _by_id(gidx, np.ones(gidx.size, dtype=bool), n_cam)
        else:
            starts = cmg.win_starts.cpu().numpy()
            rec.update(w=cmg.win_w, starts=starts,
                       cover=M.window_cover_csr(starts, cmg.win_w, n_cam),
                       blocks=M.window_block_csr(starts, cmg.win_w, n_cam),
                       win=(cmg.win_rows.cpu().numpy(), cmg.win_offsets.cpu().numpy()))
        np.save(os.path.join(out_dir, f"{scene}.npy"), rec, allow_pickle=True)
        print(f"[compare] {scene}: {cmg.mp} rows, {n_cam} cameras, mode {cmg.gather_mode}, "
              f"win_w {cmg.win_w}")
    graph, means = ba.build(ba.simulate_blocks(**CITY), dtype=torch.float32,
                            **{**BIG_BUILD, "layout": "none"})
    _, hcm, _, _ = halo_cm.distribute(graph, means, 2)
    rec = {"mp": hcm.mp, "w": hcm.win_w,
           "win": (hcm.win_rows[0].cpu().numpy(), hcm.win_offsets[0].cpu().numpy())}
    np.save(os.path.join(out_dir, "city_halo2.npy"), rec, allow_pickle=True)
    print(f"[compare] city_halo2 partition 0: {hcm.mp} rows, win_w {hcm.win_w}, "
          f"{int(rec['win'][1][-1])} owned rows listed")


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / CALLS


def events_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def segsum_blk_report(me, ml, win_rows, win_offsets, *, n_tiles, w):
    """Kernel 16 (`segsum_cm_blk`) on these operands: {device_ms (the mean of
    its recorded launches), launches, events_ms (per wrapper call),
    bound_ms, share, plan (None where the checkout reports none),
    equals_plain (bit for bit, the plain version on CPU copies), digest}."""
    fn = lambda: M.segsum_cm_blk(me, ml, win_rows, win_offsets, n_tiles=n_tiles, w=w)
    out = fn()
    plain = M.segsum_cm_blk_plain(me.cpu(), ml.cpu(), win_rows.cpu(), win_offsets.cpu(),
                                  n_tiles=n_tiles, w=w)
    b_ms = sum(t.numel() * t.element_size() for t in (me, ml, win_rows, win_offsets, out)
               ) / CW.PEAK_BYTES_PER_S * 1e3
    # The mean over the launches the profiler recorded, in a new window while
    # it recorded none (it may drop a window's records).
    for _ in range(5):
        times = [t for k, ts in CW.device_ms(fn).items() if "segsum_blk_kernel" in k
                 for t in ts]
        if times:
            break
    else:
        raise RuntimeError("the profiler recorded no launch of segsum_blk_kernel")
    ms = sum(times) / len(times)
    plan = (M.segsum_blk_plan(me.dtype, me.shape[0], n_tiles)
            if hasattr(M, "segsum_blk_plan") else None)
    return dict(device_ms=ms, launches=len(times), events_ms=events_ms(fn), bound_ms=b_ms,
                share=b_ms / ms, plan=plan, equals_plain=torch.equal(out.cpu(), plain),
                digest=CW.digest([out]))


def normal(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def load(in_dir, label, dev="cuda"):
    """Time this checkout's two sums on the saved index structures."""
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    params = list(inspect.signature(M.scatter_windows_cm).parameters)
    out = {"label": label, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    for scene in (*SEG_SCENES, *SCATTER_SCENES):
        rec = np.load(os.path.join(in_dir, f"{scene}.npy"), allow_pickle=True).item()
        n_seg, mp = rec["n_seg"], rec["mp"]
        if scene in SEG_SCENES:
            me, ml = normal((M.D0, mp), 1, dev), normal((M.D0 * M.D0, mp), 2, dev)
            for csr in ("valid", "all"):
                args = (me, ml, *map(on_dev, rec[csr]))
                fn = lambda: M.segsum_by_id(*args)
                err = float((fn() - M.segsum_by_id_plain(*args)).abs().max())
                key = f"segsum_by_id {scene} {csr} rows"
                out[key] = dict(device_ms=device_ms(fn), events_ms=events_ms(fn),
                                max_abs_vs_plain=err, rows=int(rec[csr][1][-1]),
                                form=list(M.segsum_form(mp, n_seg, rec[csr][0].size))
                                if hasattr(M, "segsum_form") else None)
                print(f"[compare] {label} {key}: {out[key]}")
        else:
            part = normal((mp // M.TILE, M.F_CAM, rec["w"]), 3, dev)
            starts = on_dev(rec["starts"])
            cover, blocks = [tuple(map(on_dev, rec[k])) for k in ("cover", "blocks")]
            if params[2] == "cov_tiles":
                kw = dict(zip(("blk_tiles", "blk_offsets"), blocks)) if "blk_tiles" in params \
                    else {}
                fn = lambda: M.scatter_windows_cm(part, starts, *cover, n_seg=n_seg, **kw)
            else:
                fn = lambda: M.scatter_windows_cm(part, starts, *blocks, n_seg=n_seg)
            got = fn()
            exact = torch.equal(got, M.scatter_windows_cm_plain(part, starts, *cover, n_seg=n_seg))
            key = f"scatter_windows_cm {scene}"
            out[key] = dict(device_ms=device_ms(fn), events_ms=events_ms(fn),
                            equals_plain=exact, tiles=int(mp // M.TILE))
            print(f"[compare] {label} {key}: {out[key]}")
    for scene in BLK_SCENES:
        rec = np.load(os.path.join(in_dir, f"{scene}.npy"), allow_pickle=True).item()
        mp, w = rec["mp"], rec["w"]
        me, ml = normal((M.D0, mp), 4, dev), normal((M.D0 * M.D0, mp), 5, dev)
        key = f"segsum_cm_blk {scene}"
        out[key] = segsum_blk_report(me, ml, *map(on_dev, rec["win"]), n_tiles=mp // M.TILE, w=w)
        print(f"[compare] {label} {key}: {out[key]}")
        del me, ml
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", default=None, help="build the scenes and write their indices here")
    ap.add_argument("--load", default=None, help="time the sums on the indices saved here")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    if args.save:
        save(args.save)
    load(args.save or args.load, args.label)


if __name__ == "__main__":
    main()
