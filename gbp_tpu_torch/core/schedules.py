"""Message schedules: synchronous, wildfire, priority (top-k) and random
sweeps (counterpart of gbp_tpu/core/schedules.py).

A schedule is a per-sweep boolean `active` mask per factor block, handed
to `sweep.sweep(..., active=)` (or `sweep_cm.sweep`): inactive factors keep
their linearization point, Jacobian, residual and both messages, and their
`since_relin` counts up by one, so a masked sweep does the same batched
work with selects (arXiv:1910.14139 §5.2 "wildfire"; arXiv:2107.02308 §3.5:
GBP converges under partial and lossy schedules).

A factor's urgency (its score) is how far its adjacent belief means moved
since it last fired: ||x - last_x|| over the components, x the current
adjacent means and last_x the means it last fired from.  `last_x` starts at
+inf, so every score is inf on sweep 1 and every factor fires.

    wildfire  active = score > tau (tau < 0: the synchronous schedule)
    priority  the top `frac` of each block's real factors by score (at
              least one); ties at the threshold may turn on more
    random    independent Bernoulli(keep_prob) per factor and sweep, drawn
              from an explicit torch.Generator on the state's device

Every budget (k of the top-k), shape and threshold is fixed before a run's
loop starts: nothing is read back from the device between sweeps.  The
runners do not change global state (exact float32 is the caller's
`gbp_tpu_torch.set_exact_f32()`, as for `sweep.run`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import GBPConfig, GBPState, gather_linpoint, sweep


class ScheduleState(NamedTuple):
    """Per factor block, the adjacent means each factor last fired from."""

    last_x: tuple  # per fblock [m, tdof]


def init_schedule(graph: Graph, state: GBPState) -> ScheduleState:
    """last_x = +inf: every score is inf on the first sweep, so every factor
    fires (from a zero start nothing would ever move)."""
    return ScheduleState(last_x=tuple(torch.full_like(state.f[fi].linpoint, math.inf)
                                      for fi in range(len(graph.fblocks))))


def _means(graph: Graph, state: GBPState) -> tuple:
    return tuple(gather_linpoint(graph, state, fi) for fi in range(len(graph.fblocks)))


def _norms(xs: tuple, last_x: tuple) -> tuple:
    """||x - last_x|| over the last axis, as the reference's norm: sqrt of
    the sum of squares (any leading axes: the halo forms' [P, m_loc])."""
    out = []
    for x, lx in zip(xs, last_x):
        d = x - lx
        out.append(torch.sqrt((d * d).sum(-1)))
    return tuple(out)


def scores(graph: Graph, state: GBPState, sched: ScheduleState) -> tuple:
    """Per fblock [m] urgency: |current adjacent means - means at last fire|."""
    return _norms(_means(graph, state), sched.last_x)


def _wildfire(ss: tuple, tau: float) -> tuple:
    return tuple(s > tau for s in ss)


def wildfire_masks(graph: Graph, state: GBPState, sched: ScheduleState, tau: float) -> tuple:
    """active[fi] = score > tau.  tau < 0 is the synchronous schedule."""
    return _wildfire(scores(graph, state, sched), tau)


def _top(s: torch.Tensor, k: int) -> torch.Tensor:
    """s >= the k-th largest value along the last axis (the least of the
    top k, which need not be sorted)."""
    return s >= torch.topk(s, k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)


def _priority(graph: Graph, ss: tuple, frac: float) -> tuple:
    masks = []
    for fb, s in zip(graph.fblocks, ss):
        m = s.shape[0]
        # The budget counts real factors only: ELL and partition layouts pad
        # blocks with invalid clone rows, which must neither shrink the
        # fraction nor crowd real factors out of the top k.
        n_real = fb.n_valid if fb.n_valid is not None else m
        if fb.valid is not None:
            s = torch.where(fb.valid, s, -math.inf)
        masks.append(_top(s, max(1, min(int(frac * n_real), m))))
    return tuple(masks)


def priority_masks(graph: Graph, state: GBPState, sched: ScheduleState,
                   frac: float) -> tuple:
    """The top `frac` of each block's real factors by urgency (at least 1)."""
    return _priority(graph, scores(graph, state, sched), frac)


def _record(active: tuple, xs: tuple, last_x: tuple) -> tuple:
    """last_x <- the current means xs [..., m, tdof] where a factor fired."""
    return tuple(torch.where(a[..., None], x, lx) for a, x, lx in zip(active, xs, last_x))


def _advance(sched: ScheduleState, graph: Graph, state: GBPState,
             active: tuple) -> ScheduleState:
    """Record the fire points: last_x <- current means where a factor fired."""
    return ScheduleState(last_x=_record(active, _means(graph, state), sched.last_x))


def wildfire_sweep(graph: Graph, state: GBPState, sched: ScheduleState, cfg: GBPConfig,
                   tau: float):
    """One wildfire iteration; returns (state, sched)."""
    xs = _means(graph, state)
    active = _wildfire(_norms(xs, sched.last_x), tau)
    sched = ScheduleState(last_x=_record(active, xs, sched.last_x))
    return sweep(graph, state, cfg, active=active), sched


def priority_sweep(graph: Graph, state: GBPState, sched: ScheduleState, cfg: GBPConfig,
                   frac: float):
    """One top-k priority iteration; returns (state, sched)."""
    xs = _means(graph, state)
    active = _priority(graph, _norms(xs, sched.last_x), frac)
    sched = ScheduleState(last_x=_record(active, xs, sched.last_x))
    return sweep(graph, state, cfg, active=active), sched


def run_wildfire(graph: Graph, state: GBPState, cfg: GBPConfig, n_iters: int,
                 tau: float) -> GBPState:
    """n_iters wildfire sweeps from a fresh schedule state."""
    sched = init_schedule(graph, state)
    for _ in range(n_iters):
        state, sched = wildfire_sweep(graph, state, sched, cfg, tau)
    return state


def run_priority(graph: Graph, state: GBPState, cfg: GBPConfig, n_iters: int,
                 frac: float) -> GBPState:
    """n_iters priority sweeps from a fresh schedule state."""
    sched = init_schedule(graph, state)
    for _ in range(n_iters):
        state, sched = priority_sweep(graph, state, sched, cfg, frac)
    return state


def random_masks(graph: Graph, generator: torch.Generator, keep_prob: float) -> tuple:
    """Independent Bernoulli(keep_prob) activity per factor (the message-loss
    setting of arXiv:2107.02308 §3.5), drawn on the graph's device from
    `generator`, which must live there."""
    return tuple(torch.rand(fb.count, generator=generator, device=fb.z.device) < keep_prob
                 for fb in graph.fblocks)


def run_random(graph: Graph, state: GBPState, cfg: GBPConfig, n_iters: int,
               keep_prob: float, generator: torch.Generator) -> GBPState:
    """n_iters sweeps with random factor dropout; the same generator state
    gives the same run bit for bit."""
    for _ in range(n_iters):
        state = sweep(graph, state, cfg, active=random_masks(graph, generator, keep_prob))
    return state


# --------------------------------------------------------------------------
# The component-major fast path (core/sweep_cm.py): the same schedules with
# the masks in CM layout [1, mp], in resident row order, composed with the
# validity mask inside sweep_cm.sweep, whose kernels take `act` per row.
# --------------------------------------------------------------------------


class CMScheduleState(NamedTuple):
    """CM layout bookkeeping: the adjacent means each row last fired from."""

    last_x: torch.Tensor  # [tdof, mp]


def init_schedule_cm(cmg, state) -> CMScheduleState:
    x = sweep_cm.expand_means(cmg, state)
    return CMScheduleState(last_x=torch.full_like(x, math.inf))


def _scores_cm(cmg, state, sched: CMScheduleState):
    """Urgency [mp] and the current means [tdof, mp] (reused for the record)."""
    x = sweep_cm.expand_means(cmg, state)
    d = x - sched.last_x
    return torch.sqrt((d * d).sum(0)), x


def wildfire_mask_cm(cmg, state, sched: CMScheduleState, tau: float):
    """(active [1, mp] = score > tau, the current means [tdof, mp])."""
    s, x = _scores_cm(cmg, state, sched)
    return (s > tau)[None], x


def priority_k_cm(cmg, frac: float) -> int:
    """The top-k budget of `priority_sweep_cm`: frac of the real factors, at
    least 1, at most mp."""
    fb = cmg.fb
    n_real = fb.n_valid if fb.n_valid is not None else fb.count
    return max(1, min(int(frac * n_real), cmg.mp))


def priority_mask_cm(cmg, state, sched: CMScheduleState, frac: float):
    """(active [1, mp]: the top `frac` of the real rows, the current means
    [tdof, mp]); rows the validity mask turns off score -inf."""
    s, x = _scores_cm(cmg, state, sched)
    s = torch.where(cmg.act[0] > 0.5, s, -math.inf)
    return _top(s, priority_k_cm(cmg, frac))[None], x


def _fire_cm(cmg, state, sched: CMScheduleState, cfg: GBPConfig, active, x):
    sched = CMScheduleState(last_x=torch.where(active, x, sched.last_x))
    return sweep_cm.sweep(cmg, state, cfg, active=active), sched


def wildfire_sweep_cm(cmg, state, sched: CMScheduleState, cfg: GBPConfig, tau: float):
    """One wildfire iteration on the CM fast path; returns (state, sched)."""
    return _fire_cm(cmg, state, sched, cfg, *wildfire_mask_cm(cmg, state, sched, tau))


def priority_sweep_cm(cmg, state, sched: CMScheduleState, cfg: GBPConfig, frac: float):
    """One top-k priority iteration on the CM fast path; returns (state, sched)."""
    return _fire_cm(cmg, state, sched, cfg, *priority_mask_cm(cmg, state, sched, frac))


def run_wildfire_cm(cmg, state, cfg: GBPConfig, n_iters: int, tau: float):
    sched = init_schedule_cm(cmg, state)
    for _ in range(n_iters):
        state, sched = wildfire_sweep_cm(cmg, state, sched, cfg, tau)
    return state


def run_priority_cm(cmg, state, cfg: GBPConfig, n_iters: int, frac: float):
    sched = init_schedule_cm(cmg, state)
    for _ in range(n_iters):
        state, sched = priority_sweep_cm(cmg, state, sched, cfg, frac)
    return state


def random_mask_cm(cmg, generator: torch.Generator, keep_prob: float) -> torch.Tensor:
    """Bernoulli(keep_prob) per CM row, [1, mp], on the graph's device."""
    return torch.rand((1, cmg.mp), generator=generator, device=cmg.act.device) < keep_prob


def run_random_cm(cmg, state, cfg: GBPConfig, n_iters: int, keep_prob: float,
                  generator: torch.Generator):
    """Random factor dropout on the CM fast path (arXiv:2107.02308 §3.5)."""
    for _ in range(n_iters):
        state = sweep_cm.sweep(cmg, state, cfg, active=random_mask_cm(cmg, generator, keep_prob))
    return state
