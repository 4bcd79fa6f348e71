"""Wildfire, priority, random and partition-dropout schedules on the
owner-sharded halo paths (counterpart of gbp_tpu/parallel/schedules.py).

Each runner composes a per-sweep, partition-local factor mask into the halo
sweep's `active` operand (`halo._sweep_halo`, `halo_cm._sweep_cm_halo`).
The scores need only partition-local belief means: every variable a
factor touches is in its partition's [owned | ghosts] table.  A partition
that computes nothing for a stretch of sweeps (`make_run_chip_dropout`:
its boundary messages go stale as if its exchanges were dropped) only
delays convergence (arXiv:2107.02308 §3.5).

Budgets: priority takes the top `frac` of each partition's real local
factors, with k from the partition that has the most of them (over all P,
through the communicator), set once when the runner is made; lighter
partitions never turn on an invalid or padded row.  Every mask is computed
for the held partitions at once on the stacked [K, ...] state (K = P in
one process); nothing is read back from the device inside a run.  The
reference's runners take a device mesh and an axis name and run one
fori_loop under shard_map; here they take the communicator of the halo
sweeps (default: the single-process `halo.LocalComm`), and the global
partition index p stands for the reference's chip.  Random draws are made
for all P partitions and cut to the held ones, so a run over several
ranks draws what one process draws.
"""
from __future__ import annotations

import math

import torch

from gbp_tpu_torch.core.schedules import _norms, _record, _top
from gbp_tpu_torch.parallel import halo as halo_mod
from gbp_tpu_torch.parallel import halo_cm as halo_cm_mod

# --------------------------------------------------------------------------
# Partition-local scoring, batched over the partitions
# --------------------------------------------------------------------------


def _local_means(hg, state) -> tuple:
    """Per fblock the adjacent means [P, m_loc, tdof] from each partition's
    [owned | ghosts] belief table: `sweep.gather_linpoint` on
    `halo._local_graph(hg, p)` for every p, as one gather per slot."""
    means = [torch.cat([v.mean, g.mean], dim=1) for v, g in zip(state.v, state.ghost)]
    return tuple(
        torch.cat([halo_mod._take(means[vb], fb.adj[k].long())
                   for k, vb in enumerate(fb.vblocks)], dim=-1)
        for fb in hg.fblocks)


_scores = _norms  # the reference's name here


def _priority_mask(s: torch.Tensor, valid: torch.Tensor | None, k: int) -> torch.Tensor:
    """Top k of the real rows along the last axis; never an invalid or pad
    row."""
    if valid is not None:
        s = torch.where(valid, s, -math.inf)
    return _top(s, k) & (s > -math.inf)


def _init_last(state) -> tuple:
    return tuple(torch.full_like(fs.linpoint, math.inf) for fs in state.f)


def _comm(n_parts: int, comm):
    return halo_mod.LocalComm(n_parts) if comm is None else comm


def _dead_mask(shape: tuple, dead_chip: int, comm, device) -> torch.Tensor:
    """All True except global partition `dead_chip`, over the held
    partitions (built once, before a loop)."""
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    if dead_chip in comm.parts:
        alive[dead_chip - comm.parts.start] = False
    return alive


def _draw(shape: tuple, comm, generator, device) -> torch.Tensor:
    """Uniform [0, 1) draws for all P partitions, cut to the held ones."""
    u = torch.rand((comm.n_parts, *shape[1:]), generator=generator, device=device)
    return u[comm.parts.start:comm.parts.stop]


def _most_real(counts: torch.Tensor, comm) -> int:
    """The largest of the held partitions' counts [K] over all P."""
    return int(comm.all_gather(counts.reshape(-1, 1)).max())


# --------------------------------------------------------------------------
# The generic halo path (parallel/halo.py)
# --------------------------------------------------------------------------


def make_run_wildfire(hp: halo_mod.HaloProblem, comm=None):
    """run(hgraph, state, cfg, n_iters, tau): a factor fires when its
    adjacent local means moved more than tau since it last fired."""
    comm = _comm(hp.n_chips, comm)

    def run(hgraph, state, cfg, n_iters, tau):
        last = _init_last(state)
        for _ in range(n_iters):
            xs = _local_means(hgraph, state)
            masks = tuple(s > tau for s in _scores(xs, last))
            last = _record(masks, xs, last)
            state = halo_mod._sweep_halo(hgraph, state, cfg, comm, active=masks)
        return state

    return run


def priority_ks(hp: halo_mod.HaloProblem, frac: float, comm=None) -> tuple:
    """Per fblock the top-k budget: frac of the largest partition's real
    factor count, at least 1, at most m_loc."""
    comm = _comm(hp.n_chips, comm)
    ks = []
    for hfb in hp.hgraph.fblocks:
        real = _most_real(hfb.valid.sum(1), comm)
        ks.append(max(1, min(int(frac * real), hfb.valid.shape[1])))
    return tuple(ks)


def make_run_priority(hp: halo_mod.HaloProblem, frac: float, comm=None):
    """run(hgraph, state, cfg, n_iters): per partition the top `frac` of its
    real factors by urgency."""
    comm = _comm(hp.n_chips, comm)
    ks = priority_ks(hp, frac, comm)

    def run(hgraph, state, cfg, n_iters):
        last = _init_last(state)
        for _ in range(n_iters):
            xs = _local_means(hgraph, state)
            masks = tuple(_priority_mask(s, fb.valid, k)
                          for s, fb, k in zip(_scores(xs, last), hgraph.fblocks, ks))
            last = _record(masks, xs, last)
            state = halo_mod._sweep_halo(hgraph, state, cfg, comm, active=masks)
        return state

    return run


def make_run_random(hp: halo_mod.HaloProblem, comm=None):
    """run(hgraph, state, cfg, n_iters, keep_prob, generator): independent
    Bernoulli(keep_prob) activity per factor and sweep, one [P, m_loc] draw
    per block from `generator` (on the state's device)."""
    comm = _comm(hp.n_chips, comm)

    def run(hgraph, state, cfg, n_iters, keep_prob, generator):
        for _ in range(n_iters):
            masks = tuple(_draw(fb.valid.shape, comm, generator, fb.valid.device) < keep_prob
                          for fb in hgraph.fblocks)
            state = halo_mod._sweep_halo(hgraph, state, cfg, comm, active=masks)
        return state

    return run


def make_run_chip_dropout(hp: halo_mod.HaloProblem, comm=None):
    """run(hgraph, state, cfg, n_iters, dead_chip, dead_sweeps): partition
    `dead_chip` computes nothing (all its factors inactive) while the sweep
    index is below `dead_sweeps`, then rejoins."""
    comm = _comm(hp.n_chips, comm)

    def run(hgraph, state, cfg, n_iters, dead_chip, dead_sweeps):
        dead = tuple(_dead_mask(fb.valid.shape, dead_chip, comm, fb.valid.device)
                     for fb in hgraph.fblocks)
        for i in range(n_iters):
            state = halo_mod._sweep_halo(hgraph, state, cfg, comm,
                                         active=dead if i < dead_sweeps else None)
        return state

    return run


# --------------------------------------------------------------------------
# The CM fast path under halo (parallel/halo_cm.py): masks [P, 1, mp]
# --------------------------------------------------------------------------


def _scores_cm(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """[P, tdof, mp] means against their fire points -> urgency [P, mp]."""
    d = x - last
    return torch.sqrt((d * d).sum(1))


def priority_k_cm(hcm, frac: float, comm=None) -> int:
    """The top-k budget of `make_run_priority_cm`: frac of the largest
    partition's real rows (hcm.act > 0.5), at least 1, at most mp."""
    comm = _comm(hcm.z.shape[0], comm)
    real = _most_real((hcm.act > 0.5).reshape(hcm.act.shape[0], -1).sum(1), comm)
    return max(1, min(int(frac * real), hcm.mp))


def make_run_wildfire_cm(hcm, comm=None):
    """run(hcm, state, cfg, n_iters, tau): wildfire on the CM halo path."""
    comm = _comm(hcm.z.shape[0], comm)

    def run(hcm, state, cfg, n_iters, tau):
        last = torch.full_like(halo_cm_mod.expand_means(hcm, state), math.inf)
        for _ in range(n_iters):
            x = halo_cm_mod.expand_means(hcm, state)
            active = (_scores_cm(x, last) > tau)[:, None]
            last = torch.where(active, x, last)
            state = halo_cm_mod._sweep_cm_halo(hcm, state, cfg, comm, active=active)
        return state

    return run


def make_run_priority_cm(hcm, frac: float, comm=None):
    """run(hcm, state, cfg, n_iters): per-partition top-`frac` priority on
    the CM halo path."""
    comm = _comm(hcm.z.shape[0], comm)
    k = priority_k_cm(hcm, frac, comm)

    def run(hcm, state, cfg, n_iters):
        last = torch.full_like(halo_cm_mod.expand_means(hcm, state), math.inf)
        valid = hcm.act[:, 0] > 0.5
        for _ in range(n_iters):
            x = halo_cm_mod.expand_means(hcm, state)
            active = _priority_mask(_scores_cm(x, last), valid, k)[:, None]
            last = torch.where(active, x, last)
            state = halo_cm_mod._sweep_cm_halo(hcm, state, cfg, comm, active=active)
        return state

    return run


def make_run_random_cm(hcm, comm=None):
    """run(hcm, state, cfg, n_iters, keep_prob, generator): random factor
    dropout on the CM halo path, one [P, 1, mp] draw per sweep."""
    comm = _comm(hcm.z.shape[0], comm)

    def run(hcm, state, cfg, n_iters, keep_prob, generator):
        for _ in range(n_iters):
            active = _draw(hcm.act.shape, comm, generator, hcm.act.device) < keep_prob
            state = halo_cm_mod._sweep_cm_halo(hcm, state, cfg, comm, active=active)
        return state

    return run


def make_run_chip_dropout_cm(hcm, comm=None):
    """run(hcm, state, cfg, n_iters, dead_chip, dead_sweeps): the dead
    partition on the CM halo path (see `make_run_chip_dropout`)."""
    comm = _comm(hcm.z.shape[0], comm)

    def run(hcm, state, cfg, n_iters, dead_chip, dead_sweeps):
        dead = _dead_mask(hcm.act.shape, dead_chip, comm, hcm.act.device)
        for i in range(n_iters):
            state = halo_cm_mod._sweep_cm_halo(hcm, state, cfg, comm,
                                               active=dead if i < dead_sweeps else None)
        return state

    return run
