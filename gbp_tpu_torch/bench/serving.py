"""Serving benchmark: frames/s through the fixed-lag online path.

Counterpart of gbp_tpu/bench/serving.py.  It streams a corridor sequence
through `models/online.py`:

  per frame: [fixed-lag eviction of the oldest cameras when the window is
             full] -> add_frame (one camera, its observations, its new
             landmarks) -> `--sweeps_per_frame` GBP sweeps -> prior
             annealing (weaken_landmark_priors, weaken_camera_priors)

On a CUDA state each variant of the frame (plain or odometry arrival, with
or without an eviction) is one CUDA graph, captured on its first call and
replayed after that: the counterpart of the reference's one jitted program
per frame.  On the CPU the same step runs eagerly.  The stream asserts that
it captured at most three graphs (absolute arrivals: plain with and
without eviction; odometry: frame 0 plain, then odometry with and without).

Passes over the same stream:
  * timed, the frame latency with one sync per frame at the serving point
    (host bookkeeping, input staging, replay, sync), captured and, on the
    card, eager in the same run;
  * profiled (on the card): kernels, launch calls and device ms per frame;
  * quality: per-frame pixel ARE over the active window (not timed).

    python -m gbp_tpu_torch.bench.serving [--frames 120] [--lpc 40] [--lag 16]
        [--n_evict 4] [--sweeps_per_frame 10] [--arrivals absolute|odometry]
        [--out FILE] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import gbp_tpu_torch
from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.bench import card_line
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba, online
from gbp_tpu_torch.utils.lie import so3_exp, so3_log
from gbp_tpu_torch.utils.smalllinalg import bT, bmm, bmv

# The corridor recipe plus num_undamped_iters=0: arrivals relinearize
# factors every frame, so the post-relinearization undamped window would
# keep most sweeps undamped and the chain oscillates (the reference's
# measurement: max ARE 1920 px at 6 undamped sweeps, 190 at 0).
CFG = GBPConfig(eta_damping=0.4, lam_damping=0.4, num_undamped_iters=0, min_linear_iters=8)
MAX_GRAPHS = 3
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cuGraphLaunch")


def _pad(a, n):
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


class FrameStep:
    """The whole frame as one program: [evict] + add_frame + sweeps + prior
    annealing, with the reference's annealing recipe (landmarks 0.6 down to
    1.0; cameras 0.7 with the floor at the arrival precision 1000, i.e. no
    camera annealing: a streamed chain needs stiff pose anchors).

    The step owns the state: on its first call it takes a copy of `ob`, each
    call returns that same OnlineBA, and the next call must pass it back.
    Every variant reads and writes one shared set of state tensors in place
    (a captured graph's outputs live in its private pool, so each graph
    copies its results back into the shared state at its end), and reads its
    inputs from static buffers, staged from pinned host memory without a
    sync.  The caller syncs once per frame before staging the next one.

    capture (default: whether the state lies on a card): each variant is
    captured as a CUDA graph on its first call (after one warm-up run on a
    copy of the state) and replayed after that; else it runs eagerly.  The
    kernels' launch counts (ops.messages.COUNTS) then count the warm-up and
    the capture only."""

    def __init__(self, cfg: GBPConfig, n_sweeps: int, n_evict: int, capture: bool | None = None):
        self.cfg, self.n_sweeps, self.n_evict = cfg, n_sweeps, n_evict
        self.capture = capture
        self.ob = None
        self.inputs, self.host = {}, {}
        self.graphs = {}

    def __call__(self, ob, odometry: bool, do_evict: bool, **inputs) -> online.OnlineBA:
        """One frame.  inputs: prec [6], z0 [chunk], oid [chunk], uv [chunk,
        2], n_o, lmk [chunk, 3], n_l, and cam [6] for an absolute arrival or
        rel_r [3, 3], rel_t [3] for an odometry one (lmk then holds the new
        landmarks in the new camera's frame)."""
        if self.ob is None:
            self._adopt(ob)
        elif ob is not self.ob:
            raise ValueError("FrameStep: pass the state its previous call returned")
        self._stage(inputs)
        key = (bool(odometry), bool(do_evict))
        if not self.capture:
            self._write_back(self._frame(self.ob, *key))
        else:
            if key not in self.graphs:
                if len(self.graphs) == MAX_GRAPHS:
                    raise AssertionError(f"frame step: a {MAX_GRAPHS + 1}th graph {key}")
                self.graphs[key] = self._capture(key)
            self.graphs[key].replay()
        return self.ob

    def _adopt(self, ob):
        """Own copies of ob's tensors, contiguous and sharing no memory, and
        the static input buffers."""
        self.ob = online.map_tensors(lambda t: t.clone(memory_format=torch.contiguous_format), ob)
        if self.capture is None:
            self.capture = self.ob.n_cams.is_cuda
        dt, dev, chunk = self.ob.graph.fblocks[0].z.dtype, self.ob.n_cams.device, self.ob.chunk
        shapes = dict(cam=((6,), dt), rel_r=((3, 3), dt), rel_t=((3,), dt), prec=((6,), dt),
                      z0=((chunk,), torch.int32), oid=((chunk,), torch.int32),
                      uv=((chunk, 2), dt), n_o=((), torch.int32), lmk=((chunk, 3), dt),
                      n_l=((), torch.int32))
        for name, (shape, t) in shapes.items():
            self.inputs[name] = torch.zeros(shape, dtype=t, device=dev)
            if dev.type == "cuda":
                self.host[name] = torch.zeros(shape, dtype=t, pin_memory=True)

    def _stage(self, inputs):
        for name, value in inputs.items():
            dst = self.inputs[name]
            if name in self.host:
                self.host[name].numpy()[...] = value
                dst.copy_(self.host[name], non_blocking=True)
            else:
                dst.copy_(torch.as_tensor(np.asarray(value)))

    def _frame(self, ob, odometry, do_evict):
        x = self.inputs
        if odometry:
            # The arrival pose (the previous camera's estimate composed with
            # the measured relative motion) and the new landmarks' placement,
            # X = R^T (X_cam - t), composed on the device: a host-side
            # composition would read the previous estimate back.
            prev = ob.state.v[0].mean.index_select(0, (ob.n_cams - 1).reshape(1))[0]
            r = bmm(x["rel_r"], so3_exp(prev[:3]))
            t = bmv(x["rel_r"], prev[3:]) + x["rel_t"]
            cam = torch.cat([so3_log(r), t])
            lmk = bmv(bT(r), x["lmk"] - t)
        else:
            cam, lmk = x["cam"], x["lmk"]
        if do_evict:
            ob = online.evict_frames(ob, self.n_evict)
        ob = online.add_frame(ob, cam, x["prec"], x["z0"], x["oid"], x["uv"], x["n_o"], lmk,
                              x["n_l"], check=False)
        ob = online.run(ob, self.cfg, self.n_sweeps)
        ob = online.weaken_landmark_priors(ob, 0.6, floor=1.0)
        return online.weaken_camera_priors(ob, 0.7, floor=1000.0)

    def _write_back(self, new):
        """Copy the frame's results into the shared state tensors.  A result
        that is still (a view of) a shared tensor other than its own target is
        copied first, so no write lands before a read."""
        dst, src = online.tensors(self.ob), online.tensors(new)
        shared = {d.untyped_storage().data_ptr() for d in dst}
        src = [s.clone() if s is not d and s.untyped_storage().data_ptr() in shared else s
               for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)

    def _capture(self, key):
        # Warm-up on a copy of the state, on a side stream: every kernel and
        # library is loaded before the capture, and the state is untouched.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._frame(online.map_tensors(torch.clone, self.ob), *key)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._write_back(self._frame(self.ob, *key))
        return graph


def _make_step(cfg: GBPConfig, n_sweeps: int, n_evict: int, capture: bool | None = None):
    """The frame step (`FrameStep`) of a stream."""
    return FrameStep(cfg, n_sweeps, n_evict, capture)


def _serving_point(ob):
    if ob.n_cams.is_cuda:
        torch.cuda.synchronize(ob.n_cams.device)


def _stream(ob, frames, lmk_init, chunk, lag, n_evict, step, on_frame=None):
    """Run the serving loop; calls on_frame(i, ob) after each frame's sync
    (quality pass).  Returns (ob, per-frame latency in s).

    The frontend bookkeeping is host-side and counted in the latency: the
    global -> online id map (online.OnlineIds) tracks `evict_frames`'s
    landmark compaction, whose cut is predicted here (the frontend fed every
    observation) so that no frame reads the device; the quality pass holds
    the prediction against the device every frame.  Odometry frames (fr
    has "rel", see online.frames_from_sim) compose their arrival on the
    device; absolute frames go through the plain step, with the motion-model
    fallback for an init that fails `online.cheirality_ok`."""
    lat = []
    ids = online.OnlineIds()
    z0 = np.zeros(chunk, np.int32)
    active = 0  # host-side window occupancy
    n_lmks = 0  # host mirror of ob.n_lmks
    cam_min = []  # per active camera: the least online landmark id it observes
    n_fallback = 0
    for i, fr in enumerate(frames):
        prec = np.full(6, 1e5 if i == 0 else 1000.0)
        t0 = time.perf_counter()
        odometry = bool(active) and "rel" in fr
        cam = np.asarray(fr["cam"], np.float64)
        if not odometry and active and not online.cheirality_ok(
                cam, lmk_init[fr["lmk_global"]]):
            # Degenerate arrival init: start from the previous camera's
            # estimate (one device read, on such frames only).
            cam = ob.state.v[0].mean[active - 1].double().cpu().numpy()
            n_fallback += 1
        do_evict = active + 1 > lag
        if do_evict:
            lmin = min((m for m in cam_min[n_evict:] if m is not None), default=0)
            del cam_min[:n_evict]
            cam_min = [None if m is None else m - lmin for m in cam_min]
            ids.shift(lmin)
            n_lmks -= lmin
            active -= n_evict
        oid, new_sel = ids.resolve(fr["lmk_global"], n_lmks)
        cam_min.append(int(oid.min()) if len(oid) else None)
        n_lmks += len(new_sel)
        active += 1
        common = dict(prec=prec, z0=z0, oid=_pad(oid, chunk), uv=_pad(fr["obs_uv"], chunk),
                      n_o=len(oid), n_l=len(new_sel))
        if odometry:
            r_rel, t_rel = fr["rel"]
            lmk = np.asarray(fr["lmk_cam"][new_sel], np.float64).reshape(-1, 3)
            ob = step(ob, True, do_evict, rel_r=r_rel, rel_t=t_rel, lmk=_pad(lmk, chunk),
                      **common)
        else:
            lmk = np.asarray(lmk_init[fr["lmk_global"][new_sel]], np.float64).reshape(-1, 3)
            ob = step(ob, False, do_evict, cam=cam, lmk=_pad(lmk, chunk), **common)
        _serving_point(ob)
        lat.append(time.perf_counter() - t0)
        if on_frame is not None:
            if int(ob.n_lmks) != n_lmks:
                raise AssertionError(f"frame {i}: landmark cut predicted {n_lmks}, device "
                                     f"{int(ob.n_lmks)}")
            on_frame(i, ob)
    if n_fallback:
        print(f"[serving] cheirality fallback on {n_fallback} arrival(s)", flush=True)
    return ob, lat


def scene(frames, lpc, arrivals):
    """(sim, stream frames, chunk) of the serving corridor: `frames`
    cameras, `lpc` new landmarks per camera, absolute or odometry arrivals."""
    sim = ba.simulate_corridor(n_cams=frames, lmks_per_cam=lpc, window=3, seed=0)
    fr = online.frames_from_sim(
        sim, odometry_sigma=(0.02, 0.05) if arrivals == "odometry" else None)
    max_obs = max(len(f["lmk_global"]) for f in fr)
    return sim, fr, int(np.ceil(max_obs / 64) * 64)


def fresh(sim, chunk, lag, dtype=torch.float32, device=None):
    """The serving problem's empty state: capacities lag / 2048 / 8192."""
    return online.create(cam_capacity=lag, lmk_capacity=2048, obs_capacity=8192, chunk=chunk,
                         pix_sigma_n=sim["pix_sigma"] / sim["k"][0], lmk_prior_prec=1000.0,
                         dtype=dtype, device=device)


def window_are(ob, f_px) -> float:
    """Pixel ARE over the active window."""
    z = ob.graph.fblocks[0].z
    px_scale = torch.full(z.shape, float(f_px), dtype=z.dtype, device=z.device)
    return float(ba.avg_reprojection_error(ob.graph, ob.state, px_scale=px_scale))


def _profile_frames(run_stream, first, n):
    """(kernels, launch calls, device ms) per frame over frames first ..
    first + n - 1 of `run_stream(on_frame)`, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_frame(i, ob):
        if i == first - 1:
            prof.start()
        elif i == first + n - 1:
            prof.stop()

    run_stream(on_frame)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(1 for e in events if e.name in LAUNCH_CALLS)
    return (len(kernels) / n, calls / n,
            sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n)


def serve(frames=120, lpc=40, lag=16, n_evict=4, sweeps_per_frame=10, arrivals="absolute",
          device=None, cfg=CFG) -> dict:
    """The benchmark's passes; returns the result's JSON object."""
    dev = resolve_device(device)
    sim, fr, chunk = scene(frames, lpc, arrivals)
    f_px = sim["k"][0]
    max_obs = max(len(f["lmk_global"]) for f in fr)
    print(f"[serving] {frames} frames, <= {max_obs} obs/frame (chunk {chunk}), lag {lag} cams, "
          f"{sweeps_per_frame} sweeps/frame, {arrivals} arrivals on {dev}", flush=True)
    first_evict = next(i for i in range(len(fr)) if i + 1 > lag)
    card = dev.type == "cuda"

    def stream(capture, on_frame=None, n=None):
        step = _make_step(cfg, sweeps_per_frame, n_evict, capture)
        ob, lat = _stream(fresh(sim, chunk, lag, device=dev), fr[:n], sim["lmk_init"], chunk,
                          lag, n_evict, step, on_frame)
        if len(step.graphs) > MAX_GRAPHS:
            raise AssertionError(f"the stream captured {len(step.graphs)} graphs")
        return ob, lat, step

    def steady(lat):
        s = np.asarray(lat[first_evict + 1:])
        return 1.0 / np.median(s), np.median(s) * 1e3, np.percentile(s, 95) * 1e3, len(s)

    t0 = time.perf_counter()
    _, lat, step = stream(None)
    total = time.perf_counter() - t0
    fps, p50, p95, n_steady = steady(lat)
    mode = "captured" if card else "eager"
    print(f"[serving] timed pass ({mode}): {total:.1f} s total; steady {fps:.2f} frames/s "
          f"(p50 {p50:.3f} ms, p95 {p95:.3f} ms/frame, {n_steady} frames), "
          f"{len(step.graphs)} graphs captured", flush=True)
    out = {"platform": card_line() if card else "cpu",
           "arrivals": arrivals, "frames": frames, "fixed_lag_cams": lag, "n_evict": n_evict,
           "sweeps_per_frame": sweeps_per_frame, "max_obs_per_frame": int(max_obs),
           "frames_per_s_steady": float(fps), "frame_latency_ms_p50": float(p50),
           "frame_latency_ms_p95": float(p95), "steady_frames_measured": int(n_steady),
           "graphs_captured": len(step.graphs)}
    if card:
        _, lat_e, _ = stream(False)
        fps_e, p50_e, p95_e, _ = steady(lat_e)
        print(f"[serving] timed pass (eager): steady {fps_e:.2f} frames/s (p50 {p50_e:.3f} ms, "
              f"p95 {p95_e:.3f} ms/frame)", flush=True)
        n_prof = min(8, len(fr) - first_evict - 2)
        per = {}
        for capture in (True, False):
            per[capture] = _profile_frames(
                lambda on_frame: stream(capture, on_frame, first_evict + 2 + n_prof),
                first_evict + 2, n_prof)
            print(f"[serving] profiled frames {first_evict + 2}..{first_evict + 1 + n_prof} "
                  f"({'captured' if capture else 'eager'}): {per[capture][0]:.1f} kernels, "
                  f"{per[capture][1]:.1f} launch calls, {per[capture][2]:.4f} device ms "
                  f"per frame", flush=True)
        out.update(frames_per_s_steady_eager=float(fps_e), frame_latency_ms_p50_eager=float(p50_e),
                   frame_latency_ms_p95_eager=float(p95_e),
                   kernels_per_frame=per[True][0], launch_calls_per_frame=per[True][1],
                   launch_calls_per_frame_eager=per[False][1],
                   device_ms_per_frame=per[True][2], device_ms_per_frame_eager=per[False][2])

    ares = []
    stream(None, lambda i, ob: ares.append(window_are(ob, f_px)))
    a = np.asarray(ares)
    if not np.isfinite(a).all():
        raise AssertionError("non-finite ARE in stream")
    tail = float(np.median(a[-10:]))
    print(f"[serving] quality pass: ARE median {np.median(a):.4f} px, max {a.max():.4f} px, "
          f"final {a[-1]:.4f} px, median of the last 10 {tail:.4f} px", flush=True)
    out.update(are_px_median=float(np.median(a)), are_px_max=float(a.max()),
               are_px_final=float(a[-1]), are_px_median_last10=tail,
               are_px=[float(v) for v in a],
               note=("one frame = evict + add + sweeps + anneal; on a card one CUDA-graph "
                     "replay per frame plus staging and one sync"))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--lpc", type=int, default=40, help="new landmarks per camera")
    ap.add_argument("--lag", type=int, default=16, help="fixed-lag window (cameras)")
    ap.add_argument("--n_evict", type=int, default=4)
    ap.add_argument("--sweeps_per_frame", type=int, default=10)
    ap.add_argument("--arrivals", choices=("absolute", "odometry"), default="absolute",
                    help="arrival init: the sim's absolute noisy poses, or odometry "
                         "composition (long horizons; see online.frames_from_sim)")
    ap.add_argument("--out", default=None, help="write the JSON here (else print only)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()
    gbp_tpu_torch.set_exact_f32()
    out = serve(args.frames, args.lpc, args.lag, args.n_evict, args.sweeps_per_frame,
                args.arrivals, args.device)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"[serving] wrote {args.out}")


if __name__ == "__main__":
    main()
