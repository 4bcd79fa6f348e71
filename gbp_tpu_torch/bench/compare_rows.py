"""The expanded-operand kernels timed on the generic sweep's own operands
at bench64, by one or several checkouts of the port in one call.

    python -m gbp_tpu_torch.bench.compare_rows [--label NAME] [--dtype f32|f64]
    cd OTHER && PYTHONPATH=. python /path/to/compare_rows.py --label NAME

Each process builds the bench scene (64 cameras, 8,000 landmarks, 512,000
factor rows), runs 10 generic sweeps under message_form="pallas" and
records the operands of the 11th sweep's `fused_relin_messages` call (the
belief operands are views into packed rows, as the sweep makes them).  On
them it times, by the profiler (device time per call of the port's own
kernels over 20 calls, each kernel by name; the wrappers' casts apart):
  19 `fused_messages`        row-major, on the recorded state;
  20 `fused_relin_messages`  row-major, the relinearization then the messages;
   4 `messages_cm`           the same operands transposed, component-major;
   5 `relin_cm`              the same.
Beside each: the bound (every input read once and every output written
once at 3.35 TB/s; for kernel 20 also the floor of its two kernels, which
write and read again the new linearization), the share of the bound, and
the largest difference from the component-major kernels' outputs (0.0 when
the two layouts agree bit for bit).  A checksum of the operands shows that
every checkout timed the same inputs.  Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile

import gbp_tpu_torch
from gbp_tpu_torch.bench import CFG, card_line
from gbp_tpu_torch.core import sweep
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.ops import messages as M

BENCH64 = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
CALLS = 20
PEAK_BYTES_PER_S = 3.35e12


def recorded_call(dtype, device, warm=10):
    """(args, kwargs) of the generic sweep's `fused_relin_messages` call in
    sweep warm + 1."""
    graph, means = ba.build(ba.simulate(**BENCH64), dtype=dtype, device=device)
    cfg = dataclasses.replace(CFG, message_form="pallas")
    state = sweep.run(graph, sweep.init_state(graph, means), cfg, warm)
    calls = []
    real = sweep.fused_relin_messages

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    sweep.fused_relin_messages = record
    try:
        sweep.sweep(graph, state, cfg)
    finally:
        sweep.fused_relin_messages = real
    return calls[0]


def device_ms(fn):
    """{kernel name: device ms per call} over CALLS calls, after a warm one."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / CALLS
    return out


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def bound(*ts):
    return nbytes(*ts) / PEAK_BYTES_PER_S * 1e3


def cm(a):
    return a.T.contiguous() if a.ndim == 2 else a


def checksum(ts):
    return float(sum(t.double().abs().sum() for t in ts if isinstance(t, torch.Tensor)))


def measure(label, dtype):
    dev = gbp_tpu_torch.default_device()
    gbp_tpu_torch.set_exact_f32()
    args, kw = recorded_call(dtype, dev)
    params, x, z, fargs, lp, jac, r0, prec, srel, act, *rest = args
    shape = dict(d0=kw["d0"], d1=kw["d1"], z=kw["z"])
    mkw = dict(prec_full=kw["prec_full"], huber=kw["huber"], **shape)
    new = M.fused_relin_messages(*args, **kw)
    lp_n, jac_n, r0_n, srel_n = new[4:]
    msg_args = (params, jac_n, lp_n, r0_n, prec, srel_n[:, 0], act, *rest)
    cm_msg_args = (params, *map(cm, msg_args[1:5]), srel_n[:, 0], act, *map(cm, rest))
    cm_relin_args = (params, *map(cm, (x, z)), None if fargs is None else cm(fargs),
                     *map(cm, (lp, jac, r0)), srel, act)
    rkw = dict(comp_name=kw["comp_name"], **shape)
    cm_relin = M.relin_cm(*cm_relin_args, **rkw)
    cm_msgs = M.messages_cm(*cm_msg_args, **mkw)
    rm_msgs = M.fused_messages(*msg_args, **mkw)

    def diff(rm, cmo):
        return max(float((a - b.T).abs().max()) for a, b in zip(rm, cmo))

    relin_io = (x, z, fargs, lp, jac, r0, srel, act, *new[4:])
    msg_io = (*msg_args[1:], *rm_msgs)
    out = {"label": label, "card": card_line(), "dtype": str(dtype), "rows": x.shape[0],
           "operand_checksum": checksum(args)}
    runs = {
        "fused_messages": (lambda: M.fused_messages(*msg_args, **mkw), bound(*msg_io),
                           diff(rm_msgs, cm_msgs)),
        "fused_relin_messages": (lambda: M.fused_relin_messages(*args, **kw),
                                 bound(*args[1:], *new),
                                 max(diff(new[4:], cm_relin), diff(new[:4], cm_msgs))),
        "messages_cm": (lambda: M.messages_cm(*cm_msg_args, **mkw), bound(*msg_io), 0.0),
        "relin_cm": (lambda: M.relin_cm(*cm_relin_args, **rkw), bound(*relin_io), 0.0),
    }
    for name, (fn, b_ms, err) in runs.items():
        by_kernel = device_ms(fn)
        total = sum(v for k, v in by_kernel.items() if "gbp::" in k)
        rec = dict(device_ms=total, bound_ms=b_ms, share=b_ms / total, max_abs_vs_cm=err,
                   kernels=by_kernel, glue_ms=sum(by_kernel.values()) - total)
        if name == "fused_relin_messages":
            relin_ms = sum(v for k, v in by_kernel.items() if "gbp::relin" in k)
            floor = b_ms + nbytes(*new[4:]) / PEAK_BYTES_PER_S * 1e3
            rec.update(relin_ms=relin_ms, relin_bound_ms=bound(*relin_io),
                       relin_share=bound(*relin_io) / relin_ms, two_kernel_floor_ms=floor,
                       share_of_floor=floor / total)
        out[name] = rec
        print(f"[rows] {label} {name}: device {total:.4f} ms, bound {b_ms:.4f} ms, share "
              f"{b_ms / total:.3f}, max abs vs the component-major kernels {err:.3e}; "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in by_kernel.items()))
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args(argv)
    measure(args.label, torch.float32 if args.dtype == "f32" else torch.float64)


if __name__ == "__main__":
    main()
