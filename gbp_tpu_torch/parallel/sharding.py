"""Factor-sharded GBP: every factor block cut into contiguous row shards,
beliefs replicated, partial message sums all-reduced each sweep
(counterpart of gbp_tpu/parallel/sharding.py).

The reference shards each factor block's rows over a device mesh with
`NamedSharding` annotations and lets the XLA partitioner insert the
collectives: the belief update's segment sums become per-device partial
sums reduced by a psum.  Here those collectives are written out: a padded
block's rows [P * m_loc] are P contiguous shards, which is the chip-major
layout of `parallel/spmd.py`, and the sweep is spmd's runner (each shard's
factor stage through the generic engine's kernels, its partial sums by
`segsum_by_id` over the shard's CSR, one `comm.all_reduce` per variable
block, then prior + sums and the belief solve).  The Schur step takes the
same shards (`parallel/schur.gauss_newton_step(..., comm=...)`).

The reference's `make_mesh` has no counterpart: the communicator
(`halo.LocalComm`, or `multihost.global_comm` over a process group) is
what a mesh was.
"""
from __future__ import annotations

import dataclasses

import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import GBPState, init_state
from gbp_tpu_torch.parallel.halo import _rows, to_device
from gbp_tpu_torch.parallel.spmd import _csr, keep_parts


def _pad_rows(a, target: int, fill=0):
    pad = target - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)])


def pad_graph(graph: Graph, n_parts: int) -> Graph:
    """Pad every factor block to a multiple of n_parts rows with invalid
    dummies.

    Dummy factors point at variable 0 with unit precision and valid False:
    the sweep masks them (their messages stay zero) and the energy ignores
    them.  The ELL markers are dropped (appended rows break the ELL row
    grouping); each block's CSR is rebuilt over the padded rows."""
    vcounts = [vb.count for vb in graph.vblocks]
    new_fblocks = []
    for fb in graph.fblocks:
        fb = dataclasses.replace(fb, ell_slot=None, ell_deg=0)
        m = fb.count
        target = -(-m // n_parts) * n_parts
        valid = fb.valid
        if valid is None:
            valid = torch.ones(m, dtype=torch.bool, device=fb.z.device)
        if fb.n_valid is None:
            fb = dataclasses.replace(fb, n_valid=int(valid.sum()))
        if target != m:
            adj = tuple(_pad_rows(a, target) for a in fb.adj)
            fb = dataclasses.replace(
                fb, adj=adj, z=_pad_rows(fb.z, target), prec=_pad_rows(fb.prec, target, fill=1),
                args=None if fb.args is None else _pad_rows(fb.args, target),
                huber_arr=None if fb.huber_arr is None else _pad_rows(fb.huber_arr, target),
                valid=_pad_rows(valid, target, fill=False),
                csr=tuple(_csr(a, vcounts[vb], a.device) for a, vb in zip(adj, fb.vblocks)))
        else:
            fb = dataclasses.replace(fb, valid=valid)
        new_fblocks.append(fb)
    return dataclasses.replace(graph, fblocks=tuple(new_fblocks))


def distribute(graph: Graph, state: GBPState, n_parts: int, device=None, comm=None):
    """Pad + cut graph and state into n_parts contiguous row shards per
    factor block, variables replicated; returns (graph, state) on `device`
    (None: the communicator's device, else the card), which
    `spmd.make_run(graph, n_parts, comm)` runs.

    The dense inboxes are dropped: the sharded belief update reduces
    per-shard partial sums.  The state is rebuilt at its means when padding
    changed a block's row count.  With a communicator
    (`multihost.DistComm`) the rank keeps its own shards."""
    device = resolve_device(device if device is not None else getattr(comm, "device", None))
    padded = dataclasses.replace(pad_graph(graph, n_parts), inboxes=None)
    if any(pf.count != of.count for pf, of in zip(padded.fblocks, graph.fblocks)):
        state = init_state(padded, tuple(vs.mean for vs in state.v))
    if comm is not None:
        m_locs = [fb.count // n_parts for fb in padded.fblocks]
        padded = keep_parts(padded, n_parts, comm.parts)
        lo, hi = comm.parts.start, comm.parts.stop
        state = state._replace(f=tuple(_rows(fs, lo * m, hi * m)
                                       for fs, m in zip(state.f, m_locs)))
    return to_device(padded, device), to_device(state, device)
