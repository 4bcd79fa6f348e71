"""Loop kind "solves": a closed loop of one caller, solve after solve from
a pool of initial estimates, each to the first chunk whose ARE reaches the
target share of the MAP ARE; a sync and an ARE check after every chunk.

Traffic keys: chunk, max_chunks, target (share of the MAP ARE), pool,
cam_noise, lmk_noise, warm_solves, trace_solves (solves in a traced
window), check_solves, tail_metric (the end-to-end metric the 95th
percentile is reported under) and gap_quantile (`check.state_gaps`: a
solve's first chunks are transients, whose widest row gaps swing with a few
ill-conditioned rows).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import check
from benchmark.device import memory_peak, sync
from benchmark.loops._common import (Outcome, captured, chunk_check, free, port, scene, stage,
                                     window)
from benchmark.reference import gbp, gn_map
from benchmark.trace import span


def estimate_pool(sim: dict, traffic: dict, seed: int, device, dtype) -> tuple:
    """(cameras [P, n_c, 6], landmarks [P, n_l, 3]): P initial estimates
    drawn around the scene's truth with the generator's noise (camera 0, the
    gauge anchor, exact), on the device from the seed in two large draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p = int(traffic["pool"])
    cams = torch.as_tensor(sim["cam_truth"]).to(device, dtype)
    lmks = torch.as_tensor(sim["lmk_truth"]).to(device, dtype)
    scale = torch.tensor([traffic["cam_noise"][0]] * 3 + [traffic["cam_noise"][1]] * 3,
                         device=device, dtype=dtype)
    noise = torch.randn((p, *cams.shape), generator=gen, device=device, dtype=dtype) * scale
    noise[:, 0] = 0.0
    lmk = lmks + float(traffic["lmk_noise"]) * torch.randn(
        (p, *lmks.shape), generator=gen, device=device, dtype=dtype)
    return cams + noise, lmk


def run(cell) -> Outcome:
    tr, cfg = cell.traffic, cell.config
    sim, rows, shapes = scene(cell)
    p = port(cell, sim)
    pool_c, pool_l = estimate_pool(sim, tr, cell.seed, cell.device, p.dtype)
    pool = [(c, l) for c, l in zip(pool_c, pool_l)]
    pb = gbp.problem(sim, cfg["build"], cell.device)
    _, _, are_map = gn_map.gauss_newton(pb, torch.as_tensor(sim["cam_init"]).to(cell.device),
                                        torch.as_tensor(sim["lmk_init"]).to(cell.device))
    target = float(tr["target"]) * are_map
    stage(cell, f"MAP ARE {are_map:.6f} px")
    n, max_chunks = int(tr["chunk"]), int(tr["max_chunks"])
    rec = captured(p, p.init(pool[0]), n)
    parts = {"init": [], "replay": [], "are": []}  # host seconds of each part

    def solve(j):
        """(chunks run, the last ARE, reached the target)."""
        clock = time.perf_counter
        t0 = clock()
        with span("init"):
            rec.load(p.init(pool[j]))
        t1 = clock()
        parts["init"].append(t1 - t0)
        for c in range(1, max_chunks + 1):
            with span("replay"):
                rec()
            t2 = clock()
            parts["replay"].append(t2 - t1)
            with span("are"):
                a = p.are(rec.state)
            t1 = clock()
            parts["are"].append(t1 - t2)
            if a <= target:
                return c, a, True
        return max_chunks, a, False

    for j in range(int(tr["warm_solves"])):
        solve(j % len(pool))
    sync(cell.device)
    setup_s = time.perf_counter() - cell.t_process

    def body():
        out = []
        t_end = time.perf_counter() + cell.seconds
        while (len(out) < int(tr["trace_solves"]) if cell.trace
               else time.perf_counter() < t_end):
            j = len(out) % len(pool)
            t0 = time.perf_counter()
            c, a, ok = solve(j)
            out.append((j, c, a, ok, time.perf_counter() - t0))
        return out

    for v in parts.values():
        v.clear()
    window_s, done, trace = window(cell, body)
    peak = memory_peak(cell.device)
    times = np.array([d[4] for d in done])
    hist = np.bincount([d[1] for d in done])
    print(f"[bench] solves by chunks run: { {c: int(k) for c, k in enumerate(hist) if k} }; "
          f"ms p50 {np.percentile(times, 50) * 1e3:.4f}, p95 {np.percentile(times, 95) * 1e3:.4f}",
          file=sys.stderr, flush=True)
    print("[bench] host ms a part, p50 / p95 over the window: " + ", ".join(
        f"{k} {np.percentile(v, 50) * 1e3:.4f} / {np.percentile(v, 95) * 1e3:.4f}"
        for k, v in parts.items()), file=sys.stderr, flush=True)
    failed = sum(1 for d in done if not d[3] or not np.isfinite(d[2]))
    # The check: solves drawn from the seed, and the longest, driven again
    # through the same captured run (the window's readings must repeat bit
    # for bit): each one's first chunk and its stop, and the second chunk
    # (where every row is first eligible to relinearize) of the first drawn
    # solve that runs one, from its own state before it.
    rng = np.random.default_rng([cell.seed, 2])
    k = min(int(tr["check_solves"]), len(done))
    drawn = rng.choice(len(done), size=k, replace=False).tolist()
    longest = int(np.argmax([d[1] for d in done]))
    picked = sorted(set(drawn) | {longest})
    second = next((i for i in drawn + [longest] if done[i][1] > 1), None)
    again, late = [], None
    for i in picked:
        j, c, a, _, _ = done[i]
        rec.load(p.init(pool[j]))
        rec()
        first = p.observed(rec.state, rows)
        a2 = p.are(rec.state)
        for r in range(c - 1):
            rec()
            if i == second and r == 0:
                late = (first, p.observed(rec.state, rows))
            a2 = p.are(rec.state)
        again.append((first, tuple(v.mean.double().clone() for v in rec.state.v), a2))
    del rec
    p.close()
    free(cell)
    sc = gbp.sweep_config(cfg["gbp"], cfg["dtype"])
    ar = gbp.Arith("f64")
    readings, controls = [], []
    for i, (first, (cam, lmk), a2) in zip(picked, again):
        j, c, a, _, _ = done[i]
        means64 = tuple(x.double() for x in pool[j])
        head = chunk_check(cell, pb, sc, n, first, gbp.init_state(pb, means64, ar),
                           lambda: gbp.init_state(pb, means64, gbp.Arith("tf32")))
        ref, ares = gbp.init_state(pb, means64, ar), []
        for _ in range(c):
            ref = gbp.run(pb, ref, sc, ar, n)
            ares.append(gbp.are(pb, *ref.mean))
        stop = max(0.0, ares[-1] / target - 1.0, (1.0 - ares[-2] / target) if c > 1 else 0.0)
        are_ref = gbp.are(pb, cam, lmk)
        readings.append(dict(head["gaps"], are_gap=abs(a - are_ref) / are_ref, stop_gap=stop,
                             rerun_gap=abs(a2 - a) / abs(a) if a else abs(a2)))
        if cell.control:
            are_ctl = gbp.are(pb, cam, lmk, gbp.Arith("tf32"))
            controls.append(dict(head["control"], are_gap=abs(are_ctl - are_ref) / are_ref))
    if late is not None:
        before, after = late
        tail = chunk_check(cell, pb, sc, n, after, before,
                           lambda: gbp.cast(before, torch.float32))
        readings.append(tail["gaps"])
        if cell.control:
            controls.append(tail["control"])
    numbers = check.worst(*readings)
    sweeps = int(sum(d[1] for d in done)) * n
    return Outcome(
        attempted=len(done), failed=failed, setup_s=setup_s, window_s=window_s, sweeps=sweeps,
        e2e={tr["tail_metric"]: float(np.percentile(times, 95)) * 1e3},
        counters=dict(prepare_s=p.prepare_s, solve_sweeps=[d[1] * n for d in done],
                      are_map=are_map, target=target, shapes=shapes,
                      control=check.worst(*controls) if cell.control else None),
        numbers=numbers, memory_peak_bytes=peak, trace=trace)
