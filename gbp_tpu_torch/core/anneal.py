"""In-engine prior annealing: the reference's prior-weakening schedule run
sweep by sweep (counterpart of gbp_tpu/core/anneal.py).

Each sweep scales the initial priors by factor^k(i), k(i) the weakening
events up to sweep i (min(i // every, times)), except the gauge anchors,
and after every weakening raises lambda damping to `damp_lam` for
`damp_window` sweeps (the float32 stabilization of chain-structured
scenes; damp_window=0 reproduces the host loop of `models.ba.weaken_priors`
between sweep batches).  One annealed sweep is `sweep_cm.sweep` (or
`sweep.sweep`, or a halo sweep of a partitioned graph) on the prepared
graph with its priors scaled and that sweep's lam_damping.

The schedule is a function of the Python loop index alone: nothing is read
back from the device between sweeps, so the run queues its kernels without
a host round trip and can later be captured whole.  The scaled priors of
each of the times + 1 schedule levels are computed once per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import GBPConfig, GBPState

# Gauge anchors: camera block 0, cameras 0 and 1, state components 0..6 (the
# whole 6-dof camera; the pose of a 9-dof camera, whose intrinsics prior
# anneals like every other: models/ba.weaken_priors).
DEFAULT_KEEP = ((0, (0, 1), (0, 6)),)


def _keep_map(keep):
    """keep entries: (vblock, ids) or (vblock, ids, (lo, hi) component range)."""
    return {e[0]: (np.asarray(e[1]), e[2] if len(e) > 2 else None) for e in keep}


def anchor_masks(graph: Graph, keep=DEFAULT_KEEP) -> tuple:
    """Per variable block a bool [n, d] tensor: True = anchored component,
    never weakened."""
    km = _keep_map(keep)
    masks = []
    for vi, vb in enumerate(graph.vblocks):
        dof = vb.prior_eta.shape[-1]
        m = np.zeros((vb.count, dof), bool)
        if vi in km:
            ids, comps = km[vi]
            lo, hi = (0, dof) if comps is None else comps
            m[ids, lo:min(hi, dof)] = True
        masks.append(torch.as_tensor(m, device=vb.prior_eta.device))
    return tuple(masks)


def _scale_vblocks(vblocks, masks, s):
    """Priors scaled by `s` except where the mask is set.  The priors are
    diagonal, so scaling the rows of prior_lam component by component is
    exact."""
    out = []
    for vb, m in zip(vblocks, masks):
        one = torch.ones((), dtype=vb.prior_eta.dtype, device=vb.prior_eta.device)
        sv = torch.where(m, one, one * s)
        out.append(dataclasses.replace(vb, prior_eta=vb.prior_eta * sv,
                                       prior_lam=vb.prior_lam * sv[..., None]))
    return tuple(out)


def schedule_scalars(i: int, cfg: GBPConfig, every: int, factor: float, times: int,
                     damp_window: int, damp_lam: float, dtype=torch.float32):
    """(schedule level k, prior scale, effective lam_damping) at sweep index
    i.  The scale is factor^k rounded to `dtype` as the reference computes
    it (factor rounded first, then the power in that type)."""
    k = min(i // every, times) if times else 0
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    s = float(np_dt(factor) ** np_dt(k))
    lam_d = cfg.lam_damping
    if damp_window and times and k >= 1 and (i - k * every) < damp_window:
        lam_d = max(float(np_dt(cfg.lam_damping)), float(np_dt(damp_lam)))
    return k, s, lam_d


def _schedule(base_graph: Graph, n_iters, every, factor, times, damp_window, damp_lam, masks,
              i0, cfg, dtype):
    """Per sweep of an annealed run, (the graph with that sweep's priors,
    that sweep's config); each schedule level's graph is built once."""
    if masks is None:
        masks = anchor_masks(base_graph)
    levels = {}
    for i in range(int(i0), int(i0) + n_iters):
        k, s, lam_d = schedule_scalars(i, cfg, every, factor, times, damp_window, damp_lam, dtype)
        if k not in levels:
            levels[k] = dataclasses.replace(
                base_graph, vblocks=_scale_vblocks(base_graph.vblocks, masks, s))
        yield levels[k], dataclasses.replace(cfg, lam_damping=lam_d)


def run_annealed(graph: Graph, state: GBPState, cfg: GBPConfig, n_iters: int, every: int = 10,
                 factor: float = 0.1, times: int = 3, damp_window: int = 10,
                 damp_lam: float = 0.4, masks: tuple | None = None, i0: int = 0) -> GBPState:
    """n_iters sweeps of the generic engine (core/sweep.py) under the
    prior-annealing schedule.  `masks` defaults to the BA gauge anchors; i0
    is the global index of the first sweep, so chunked calls continue the
    schedule."""
    for g, c in _schedule(graph, n_iters, every, factor, times, damp_window, damp_lam, masks, i0,
                          cfg, state.v[0].mean.dtype):
        state = sweep_mod.sweep(g, state, c)
    return state


def run_annealed_cm(cmg, state, cfg: GBPConfig, n_iters: int, every: int = 10,
                    factor: float = 0.1, times: int = 3, damp_window: int = 10,
                    damp_lam: float = 0.4, masks: tuple | None = None, i0: int = 0):
    """`run_annealed` on the component-major fast path (core/sweep_cm.py):
    the same schedule on a prepared graph, whose priors live in its
    (possibly locality-sorted) `base` graph."""
    for g, c in _schedule(cmg.base, n_iters, every, factor, times, damp_window, damp_lam, masks,
                          i0, cfg, state.f.r0.dtype):
        state = sweep_cm.sweep(cmg._replace(base=g), state, c)
    return state


def halo_anchor_masks(hp, keep=DEFAULT_KEEP) -> tuple:
    """Anchor masks in the halo layout of a partitioned graph: per variable
    block a bool [K, n_own_max, d] tensor over each held partition's OWNED
    variables (ghosts take their owners' beliefs, not priors)."""
    km = _keep_map(keep)
    masks = []
    for vi, ids in enumerate(hp.owned_ids):
        ids = hp.local(ids)
        vb = hp.hgraph.vblocks[vi]
        dof = vb.prior_eta.shape[-1]
        m = np.zeros(ids.shape + (dof,), bool)
        if vi in km:
            gids, comps = km[vi]
            lo, hi = (0, dof) if comps is None else comps
            m[np.isin(ids, gids), lo:min(hi, dof)] = True
        masks.append(torch.as_tensor(m, device=vb.prior_eta.device))
    return tuple(masks)


def make_run_annealed_halo(hp, state, keep=DEFAULT_KEEP, skip_exchange: bool = False,
                           comm=None):
    """The annealed run of a partitioned graph: run_fn(hg, state, cfg,
    n_iters, every, factor, times, damp_window, damp_lam, i0), hg the
    generic HaloGraph (hp.hgraph) or the HaloCMGraph, whose priors live in
    `.vblocks` of either.  Each sweep is the halo sweep with that sweep's
    scaled owned priors and lam_damping; the schedule comes from the loop
    index, nothing is read back between sweeps.  comm: the communicator
    (default: the single-process halo.LocalComm)."""
    from gbp_tpu_torch.parallel import halo, halo_cm

    if isinstance(state, halo.HaloState):
        sweep_fn = halo._sweep_halo
    elif isinstance(state, halo_cm.HaloCMState):
        sweep_fn = halo_cm._sweep_cm_halo
    else:
        raise TypeError(f"make_run_annealed_halo: expected a HaloState or a HaloCMState, got "
                        f"{type(state).__name__}")
    masks = halo_anchor_masks(hp, keep)
    comm = halo.LocalComm(hp.n_chips) if comm is None else comm

    def run_fn(hg, state, cfg, n_iters, every=10, factor=0.1, times=3, damp_window=10,
               damp_lam=0.4, i0=0):
        levels = {}
        for i in range(int(i0), int(i0) + n_iters):
            k, s, lam_d = schedule_scalars(i, cfg, every, factor, times, damp_window, damp_lam,
                                           state.v[0].mean.dtype)
            if k not in levels:
                levels[k] = hg._replace(vblocks=_scale_vblocks(hg.vblocks, masks, s))
            state = sweep_fn(levels[k], state, dataclasses.replace(cfg, lam_damping=lam_d),
                             comm, skip_exchange=skip_exchange)
        return state

    return run_fn
