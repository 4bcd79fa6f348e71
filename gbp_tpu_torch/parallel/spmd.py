"""Explicit SPMD GBP: keyframe-partitioned factors, replicated beliefs and
one all-reduce of partial message sums per variable block and sweep
(counterpart of gbp_tpu/parallel/spmd.py).

  * factors are PARTITIONED by the variable their anchor slot connects to
    (cameras for BA, pose index for pose graphs), a keyframe-block
    partition; each partition's share is padded to a common size with inert
    dummies, rows chip-major [P * m_loc];
  * variable beliefs are replicated; each sweep every partition runs the
    generic engine's factor stage on its own rows (relinearization, Huber,
    messages: kernel 20, or 19 where the factor type has no component
    form, under message_form "pallas"), computes PARTIAL per-variable
    message sums from zeros with its local dense inbox (gather + masked
    reduce) or, where the degree skew rules the inbox out, `segsum_by_id`
    (kernel 3) over its rows' CSR, and the partials are combined by one
    `comm.all_reduce` (a variable no factor of a partition touches gets
    zeros from it), after which the prior is added and the beliefs solved,
    the same on every partition.

Collective volume is O(total variable state) and beliefs are replicated,
so this path does not scale memory with the partitions;
`parallel/halo.py` is the owner-sharded path with boundary-only exchange.

The reference runs one `shard_map` over a device mesh; here the
communicator is `halo.LocalComm` (all P partitions in one process, each
partition's kernels launched on their own) or `multihost.DistComm` (K = P /
W partitions on each of W ranks; `distribute(..., comm=...)` keeps a
rank's rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core.graph import Graph, Inbox, adjacency_csr, build_inboxes
from gbp_tpu_torch.core.sweep import GBPConfig, GBPState, VariableState
from gbp_tpu_torch.ops.messages import segsum_by_id
from gbp_tpu_torch.parallel.halo import LocalComm, _rows, to_device
from gbp_tpu_torch.utils.smalllinalg import scaled_sym_solve


def _csr(adj, n: int, device) -> tuple:
    """`adjacency_csr` of an adjacency tensor, as int32 tensors on `device`."""
    return tuple(torch.tensor(a, device=device)
                 for a in adjacency_csr(adj.cpu().numpy(), n))


def partition_graph(graph: Graph, n_parts: int, anchor_slot: int = 0) -> Graph:
    """Host-side keyframe-block partition of every factor block.

    Factors go to the partition owning their anchor-slot variable
    (contiguous variable ranges).  Returns a new Graph whose factor arrays
    are chip-major ([P * m_loc] rows, inert dummies padding each partition
    to m_loc: `prec` 1, `valid` False), `ell_slot` None, the block's CSR
    over all its rows (the generic engine runs it as it is), plus
    per-partition local inboxes padded to a common degree and stacked as
    [P * n, deg]."""
    vcounts = [vb.count for vb in graph.vblocks]
    new_fblocks = []
    for fb in graph.fblocks:
        dev = fb.z.device
        slot = min(anchor_slot, len(fb.vblocks) - 1)
        n_anchor = vcounts[fb.vblocks[slot]]
        chip = (fb.adj[slot].cpu().numpy().astype(np.int64) * n_parts) // n_anchor
        order = np.argsort(chip, kind="stable")
        counts = np.bincount(chip, minlength=n_parts)
        m_loc = max(int(counts.max()), 1)
        starts = np.concatenate([[0], np.cumsum(counts)])
        src = np.full(n_parts * m_loc, -1, dtype=np.int64)
        for c in range(n_parts):
            src[c * m_loc:c * m_loc + counts[c]] = order[starts[c]:starts[c + 1]]
        real = torch.tensor(src >= 0, device=dev)
        take = torch.tensor(np.maximum(src, 0), device=dev)

        def place(a, fill=0):
            if a is None:
                return None
            out = a[take]
            out[~real] = fill
            return out

        valid = real if fb.valid is None else place(fb.valid, fill=False) & real
        adj = tuple(place(a) for a in fb.adj)
        new_fblocks.append(dataclasses.replace(
            fb, n_valid=int(valid.sum()), ell_slot=None, ell_deg=0, adj=adj, z=place(fb.z),
            prec=place(fb.prec, fill=1), args=place(fb.args), huber_arr=place(fb.huber_arr),
            valid=valid,
            csr=tuple(_csr(a, vcounts[vb], dev) for a, vb in zip(adj, fb.vblocks))))

    # Per-partition local inboxes (local factor row coords), stacked.
    per_chip = []
    for c in range(n_parts):
        chip_fblocks = []
        for fb in new_fblocks:
            m_loc = fb.count // n_parts
            chip_fblocks.append(dataclasses.replace(
                fb, adj=tuple(a[c * m_loc:(c + 1) * m_loc] for a in fb.adj),
                z=fb.z[c * m_loc:(c + 1) * m_loc]))
        per_chip.append(build_inboxes(chip_fblocks, vcounts))
    stacked_inboxes = []
    for vi in range(len(vcounts)):
        if any(pc is None or pc[vi] is None for pc in per_chip):
            stacked_inboxes.append(None)
            continue
        stacked = []
        for k, s0 in enumerate(per_chip[0][vi]):
            deg = max(pc[vi][k].idx.shape[1] for pc in per_chip)
            pad = lambda a: torch.nn.functional.pad(a, (0, deg - a.shape[1]))
            stacked.append(Inbox(idx=torch.cat([pad(pc[vi][k].idx) for pc in per_chip]),
                                 mask=torch.cat([pad(pc[vi][k].mask) for pc in per_chip]),
                                 fi=s0.fi, slot=s0.slot))
        stacked_inboxes.append(tuple(stacked))
    inboxes = None if all(s is None for s in stacked_inboxes) else tuple(stacked_inboxes)
    return dataclasses.replace(graph, fblocks=tuple(new_fblocks), inboxes=inboxes)


def keep_parts(graph: Graph, n_parts: int, parts: range) -> Graph:
    """The rows of partitions `parts` of a chip-major graph (factor rows and
    stacked inboxes; variable blocks stay whole), each block's CSR rebuilt
    over the rows kept."""
    lo, hi = parts.start, parts.stop
    vcounts = [vb.count for vb in graph.vblocks]
    fblocks = []
    for fb in graph.fblocks:
        m_loc = fb.count // n_parts
        kept = _rows(dataclasses.replace(fb, csr=None), lo * m_loc, hi * m_loc)
        fblocks.append(dataclasses.replace(kept, csr=tuple(
            _csr(a, vcounts[vb], a.device) for a, vb in zip(kept.adj, fb.vblocks))))
    inboxes = graph.inboxes
    if inboxes is not None:
        inboxes = tuple(None if specs is None else tuple(
            dataclasses.replace(s, idx=s.idx[lo * n:hi * n], mask=s.mask[lo * n:hi * n])
            for s in specs) for specs, n in zip(inboxes, vcounts))
    return dataclasses.replace(graph, fblocks=tuple(fblocks), inboxes=inboxes)


def distribute(graph: Graph, means: tuple, n_parts: int, device=None, anchor_slot: int = 0,
               comm=None):
    """Partition + place a freshly built graph; returns (graph, state) on
    `device` (None: the communicator's device, else the card).

    The state is built on the partitioned graph (messages zero,
    linearization points at `means`).  With a communicator
    (`multihost.DistComm`) every rank runs the same host-side partition and
    keeps its own partitions' rows; the variable blocks are replicated."""
    device = resolve_device(device if device is not None else getattr(comm, "device", None))
    pgraph = partition_graph(graph, n_parts, anchor_slot)
    if comm is not None:
        pgraph = keep_parts(pgraph, n_parts, comm.parts)
    pgraph = to_device(pgraph, device)
    return pgraph, sweep_mod.init_state(pgraph, tuple(m.to(device) for m in means))


def _cat(parts: list):
    """The partitions' factor states (NamedTuples of row-major tensors)
    joined along the rows."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    items = [_cat([q[i] for q in parts]) for i in range(len(first))]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def _partial_sums(lgraph: Graph, f: tuple, vi: int) -> torch.Tensor:
    """One partition's message sums [n, d + d^2] into variable block vi, from
    zeros: its dense inbox, else the segment sum over its rows' CSR."""
    vb = lgraph.vblocks[vi]
    d = vb.dof
    packed = vb.prior_eta.new_zeros((vb.count, d + d * d))
    specs = None if lgraph.inboxes is None else lgraph.inboxes[vi]
    if specs is not None:
        for spec in specs:
            g = sweep_mod._pack_msgs(f[spec.fi], spec.slot)[spec.idx.long()]
            packed = packed + torch.where(spec.mask[:, :, None], g, torch.zeros_like(g)).sum(1)
        return packed
    for fi, fb in enumerate(lgraph.fblocks):
        for k, target in enumerate(fb.vblocks):
            if target == vi:
                ml = f[fi].msg_lam[k]
                packed = packed + segsum_by_id(f[fi].msg_eta[k], ml.reshape(ml.shape[0], -1),
                                               *fb.csr[k], row_major=True)
    return packed


def _sweep_local(graph: Graph, views: list, state: GBPState, cfg: GBPConfig,
                 comm) -> GBPState:
    """One sweep: every held partition's factor stage and partial sums, one
    all-reduce per variable block, then prior + sums and the belief solve
    (the same on every partition)."""
    k = len(views)
    new_f, packed = [], [[] for _ in graph.vblocks]
    for p, lgraph in enumerate(views):
        lstate = GBPState(v=state.v, f=tuple(
            _rows(fs, p * (fs.r0.shape[0] // k), (p + 1) * (fs.r0.shape[0] // k))
            for fs in state.f))
        f_p = []
        for fi, fb in enumerate(lgraph.fblocks):
            fs, act = lstate.f[fi], fb.valid
            beliefs, x = sweep_mod._gather_beliefs_and_means(lgraph, lstate, fi)
            if sweep_mod._use_fused_relin(cfg, fb):
                fs = sweep_mod._fused_relin_messages(fb, fs, beliefs, x, cfg, act)
            else:
                fs = sweep_mod._relinearize(fb, fs, x, cfg, act)
                fs = sweep_mod._compute_messages(fb, fs, beliefs, cfg, act)
            f_p.append(fs)
        new_f.append(f_p)
        for vi in range(len(graph.vblocks)):
            packed[vi].append(_partial_sums(lgraph, f_p, vi))
    f = tuple(new_f[0]) if k == 1 else tuple(_cat(list(per_fb)) for per_fb in zip(*new_f))
    new_v = []
    for vi, vb in enumerate(graph.vblocks):
        d = vb.dof
        total = comm.all_reduce(torch.stack(packed[vi]))[0]  # the halo exchange
        eta = vb.prior_eta + total[:, :d]
        lam = vb.prior_lam + total[:, d:].reshape(vb.count, d, d)
        new_v.append(VariableState(eta=eta, lam=lam, mean=scaled_sym_solve(lam, eta)))
    return GBPState(v=tuple(new_v), f=f)


def make_run(graph: Graph, n_parts: int, comm=None):
    """run(graph, state, cfg, n_iters) over the held partitions of a
    `distribute`d graph (chip-major rows).  comm: the communicator (default:
    the single-process `halo.LocalComm` over all n_parts partitions)."""
    comm = LocalComm(n_parts) if comm is None else comm
    if comm.n_parts != n_parts:
        raise ValueError(f"the communicator spans {comm.n_parts} partitions, not {n_parts}")
    k = len(comm.parts)
    views = [keep_parts(graph, k, range(p, p + 1)) for p in range(k)]

    def run_spmd(graph, state, cfg, n_iters):
        for _ in range(n_iters):
            state = _sweep_local(graph, views, state, cfg, comm)
        return state

    return run_spmd
