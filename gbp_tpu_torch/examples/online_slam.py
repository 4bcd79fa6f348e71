"""Incremental (online) bundle adjustment: keyframes stream in and the graph
grows inside fixed-capacity tensors, so each frame runs the same program.
Part 2 streams a corridor PAST the window capacity: `evict_frames`
marginalizes the oldest cameras into landmark priors (fixed-lag smoothing),
so the loop serves indefinitely.  The port of examples/online_slam.py.

    python -m gbp_tpu_torch.examples.online_slam [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import gbp_tpu_torch
from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba, online


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device):
    scene = ba.simulate(n_cams=10, n_lmks=200, seed=1, fov_frac=0.25)
    k = scene["k"]
    uv_n = np.stack([(scene["obs"][:, 0] - k[2]) / k[0],
                     (scene["obs"][:, 1] - k[3]) / k[1]], axis=1)

    # group observations per camera; landmarks numbered by first sighting
    remap, frames = {}, []
    for c in range(10):
        sel = np.flatnonzero(scene["cam_ids"] == c)
        new, ids = [], []
        for t in scene["lmk_ids"][sel]:
            if t not in remap:
                remap[t] = len(remap)
                new.append(scene["lmk_init"][t])
            ids.append(remap[t])
        frames.append((scene["cam_init"][c], np.asarray(ids, np.int32),
                       uv_n[sel], np.asarray(new).reshape(-1, 3)))

    chunk = 256
    pad = lambda a: np.concatenate(
        [a, np.zeros((chunk - len(a),) + a.shape[1:], a.dtype)])
    ob = online.create(cam_capacity=12, lmk_capacity=400, obs_capacity=4096,
                       chunk=chunk, pix_sigma_n=scene["pix_sigma"] / k[0], device=device)
    cfg = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)

    for i, (cam, ids, uv, new) in enumerate(frames):
        prec = (np.full(6, 1e5) if i == 0
                else np.array([1.0] * 3 + [1e5] * 3) if i == 1
                else np.ones(6))
        t0 = time.time()
        ob = online.add_frame(
            ob, cam, prec, np.zeros(chunk, np.int32), pad(ids), pad(uv), len(ids),
            pad(new), len(new),
            check=False)  # capacity pre-sized above; skip the read-back
        ob = online.run(ob, cfg, 10)
        ob = online.weaken_landmark_priors(ob, 0.6)
        _sync(device)
        print(f"frame {i}: {len(ids):3d} obs, {len(new):3d} new landmarks, "
              f"{(time.time() - t0) * 1e3:7.1f} ms")

    m = ob.graph.fblocks[0].count
    are = float(ba.avg_reprojection_error(
        ob.graph, ob.state, px_scale=np.full((m, 2), k[0])))
    print(f"final avg reprojection error: {are:.3f} px "
          f"({int(ob.n_cams)} cams, {int(ob.n_lmks)} landmarks, "
          f"{int(ob.n_obs)} observations)")


def main_fixed_lag(device):
    """Stream 24 corridor keyframes through an 8-camera fixed-lag window:
    3x the capacity, bounded memory, bounded per-frame latency."""
    n_frames, cap, n_evict = 24, 8, 4
    scene = ba.simulate_corridor(n_cams=n_frames, lmks_per_cam=12, window=2,
                                 seed=1)
    k = scene["k"]
    uv_n = np.stack([(scene["obs"][:, 0] - k[2]) / k[0],
                     (scene["obs"][:, 1] - k[3]) / k[1]], axis=1)
    chunk = 128
    pad = lambda a: np.concatenate(
        [a, np.zeros((chunk - len(a),) + a.shape[1:], a.dtype)])
    ob = online.create(cam_capacity=cap, lmk_capacity=256, obs_capacity=1024,
                       chunk=chunk, pix_sigma_n=scene["pix_sigma"] / k[0],
                       lmk_prior_prec=1000.0, device=device)
    # chain-structured windows need lambda damping + firm annealed arrival
    # priors (docs/PERFORMANCE.md "Chain-structured scenes")
    cfg = GBPConfig(eta_damping=0.4, lam_damping=0.4, num_undamped_iters=6,
                    min_linear_iters=8)

    live = {}  # global landmark id -> current online id
    for c in range(n_frames):
        t0 = time.time()
        evicted = ""
        if int(ob.n_cams) + 1 > cap:
            before = int(ob.n_lmks)
            ob = online.evict_frames(ob, n_evict)
            lmin = before - int(ob.n_lmks)
            live = {g: i - lmin for g, i in live.items() if i >= lmin}
            evicted = f" (evicted {n_evict} cams, {lmin} lmks)"
        sel = np.flatnonzero(scene["cam_ids"] == c)
        ids, new = [], []
        base = int(ob.n_lmks)
        for t in scene["lmk_ids"][sel]:
            if t not in live:
                live[t] = base + len(new)
                new.append(scene["lmk_init"][t])
            ids.append(live[t])
        prec = np.full(6, 1e5 if c == 0 else 1000.0)
        ob = online.add_frame(
            ob, scene["cam_init"][c], prec, np.zeros(chunk, np.int32),
            pad(np.asarray(ids, np.int32)), pad(uv_n[sel]), len(ids),
            pad(np.asarray(new).reshape(-1, 3)), len(new), check=False)
        ob = online.run(ob, cfg, 10)
        ob = online.weaken_landmark_priors(ob, 0.6, floor=1.0)
        ob = online.weaken_camera_priors(ob, 0.7, floor=30.0)
        _sync(device)
        m = ob.graph.fblocks[0].count
        are = float(ba.avg_reprojection_error(
            ob.graph, ob.state, px_scale=np.full((m, 2), k[0])))
        print(f"frame {c:2d}: window {int(ob.n_cams)} cams / "
              f"{int(ob.n_lmks):3d} lmks, ARE {are:6.3f} px, "
              f"{(time.time() - t0) * 1e3:7.1f} ms{evicted}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    gbp_tpu_torch.set_exact_f32()
    main(dev)
    print("\n--- fixed-lag corridor stream (3x window capacity) ---")
    main_fixed_lag(dev)
