"""Owner-sharded GBP with halo exchange (counterpart of gbp_tpu/parallel/halo.py).

The graph is cut into P partitions.  Every variable has one owner partition
(the anchor block, cameras or keyframes: contiguous ranges cut to balance
factor counts; the other blocks: the majority vote of their factors'
owners); every factor follows its anchor variable.  A partition holds its
owned beliefs and read-only GHOST copies of the boundary variables its
factors touch but do not own.  One sweep, per partition:

  1. the factor stage (the generic engine's kernels) over the local belief
     table [owned | ghosts];
  2. local partial message sums over that table (deterministic: a CSR of
     each slot's local ids built at partition time);
  3. ghost partials -> owners, through one collective;
  4. owners update their beliefs (prior + own partials + received ones);
  5. updated boundary beliefs -> ghost holders, through one collective.

The collectives are written once against a communicator with three
operations (the reference's `all_gather`, `ppermute` and `psum`), over the
K partitions a process holds, stacked [K, ...]:

  all_gather(x)     x [K, n, f]: every partition's block -> each held
                    partition sees [P * n, f], in partition order;
  shift(x, offset)  partition p's block goes to partition (p + offset) % P;
  all_reduce(x)     x [K, ...]: each held partition gets the sum over all P
                    partitions, added in partition order (0 first), so the
                    result repeats bit for bit.

`LocalComm` implements them for all P partitions in one process on one
device (K = P: an expand, a `torch.roll` along the partition axis and a
sum in order); `parallel/multihost.DistComm` for K = P / W partitions on
each of W ranks of a `torch.distributed` group.  The factor stage runs
once per held partition (each partition's kernels launch on their own, the
multi-device program's per-rank step) and the owner updates run batched
over K.  Every structure is stacked on a leading partition axis as the
reference's, whose leading axis is sharded over a device mesh;
`distribute(..., comm=...)` keeps a rank's K partitions (`HaloProblem.
parts`).  Per-sweep collective bytes are O(total boundary)
(`collective_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core.graph import FactorBlock, Graph, VariableBlock, adjacency_csr
from gbp_tpu_torch.core.sweep import FactorState, GBPConfig, GBPState, VariableState
from gbp_tpu_torch.gaussians import packed_identity_row
from gbp_tpu_torch.ops.messages import segsum_by_id
from gbp_tpu_torch.utils.smalllinalg import scaled_sym_solve


class HaloComm(NamedTuple):
    """Per-variable-block halo wiring, every tensor stacked [P, ...].

    Two lowerings of the same exchange, chosen per block at partition time
    (`mode`): "gather" (one all_gather of the per-partition ghost / boundary
    buffer each way) and "permute" (one shift per owner-distance offset:
    contiguous keyframe blocks put almost every ghost on a ring
    neighbour).  The arrays are the reference's; `fold` is the port's
    deterministic form of the owner-side segment sum."""

    # gather mode: ghost partials -> owner (flat index into the all-gathered
    # ghost buffer [P * n_ghost_max], target owned slot, validity) ...
    recv_src: torch.Tensor  # [P, r_max] int64
    recv_tgt: torch.Tensor  # [P, r_max] int64
    recv_mask: torch.Tensor  # [P, r_max] bool
    # ... and boundary beliefs -> ghost holders: the owned slots to export,
    # and per ghost slot the flat index into the all-gathered export.
    bnd_idx: torch.Tensor  # [P, b_max] int64
    ghost_src: torch.Tensor  # [P, n_ghost_max] int64
    ghost_mask: torch.Tensor  # [P, n_ghost_max] bool
    # permute mode (None in gather mode): per offset d the ghost slots sent
    # to partition (p + d) % P, the owned slot each received row adds to
    # (n_own_max: dropped), per offset e the owned slots exported, and per
    # ghost slot its row of the concatenated received buffers.
    send_idx: tuple | None = None  # per d: [P, s_d] int64
    send_mask: tuple | None = None  # per d: [P, s_d] bool
    cat_tgt: torch.Tensor | None = None  # [P, sum_d s_d] int64
    bsend_idx: tuple | None = None  # per e: [P, t_e] int64
    perm_ghost_src: torch.Tensor | None = None  # [P, n_ghost_max] int64
    # fold[p, s, k]: the k-th received row that adds to owned slot s, in the
    # reference's order of summation; the received rows get one zero row
    # appended, which padding entries point at.  Built at partition time, so
    # the owner-side sum is the same sum every sweep (no atomics).
    fold: torch.Tensor | None = None  # [P, n_own_max, K] int64
    n_own_max: int = 0
    n_ghost_max: int = 0
    b_max: int = 0
    r_max: int = 0
    mode: str = "gather"
    offsets_out: tuple = ()
    offsets_in: tuple = ()


class HaloGraph(NamedTuple):
    """Static per-partition graph data, stacked on a leading partition axis."""

    vblocks: tuple  # VariableBlock per vblock, priors [P, n_own_max, ...]
    fblocks: tuple  # FactorBlock per fblock, arrays [P, m_loc, ...], LOCAL adj and csr
    comm: tuple  # HaloComm per vblock


class HaloState(NamedTuple):
    v: tuple  # owned VariableState per vblock [P, n_own_max, ...]
    ghost: tuple  # ghost VariableState per vblock [P, max(n_ghost_max, 1), ...]
    f: tuple  # FactorState per fblock [P, m_loc, ...]


class HaloProblem:
    """Host-side partition result: the stacked graph + numpy bookkeeping."""

    def __init__(self, hgraph, n_parts, owned_ids, owned_valid, ghost_ids, fb_src_rows,
                 src_graph):
        self.hgraph = hgraph
        self.n_chips = n_parts  # the reference's name: partitions here
        self.owned_ids = owned_ids  # per vblock [P, n_own_max] int64 (-1 pad)
        self.owned_valid = owned_valid  # per vblock [P, n_own_max] bool
        self.ghost_ids = ghost_ids  # per vblock [P, n_ghost_max] int64 (-1 pad)
        self.fb_src_rows = fb_src_rows  # per fblock [P, m_loc] int64 (-1 pad)
        self.src_graph = src_graph
        # The partitions whose tensors this process holds (hgraph and state
        # stacked [len(parts), ...]); the numpy bookkeeping stays global.
        self.parts = range(n_parts)

    def local(self, a):
        """The held partitions' rows of a global per-partition array."""
        return a[self.parts.start:self.parts.stop]


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """x [P, ...] summed over the partition axis, partition 0 first: one
    fixed order of addition, whoever holds the blocks."""
    total = x[0]
    for k in range(1, x.shape[0]):
        total = total + x[k]
    return total


class LocalComm:
    """The exchange's collectives over P partitions held stacked [P, ...]
    in one process on one device."""

    def __init__(self, n_parts: int):
        self.n_parts = n_parts
        self.parts = range(n_parts)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [P, n, ...] -> [P, P * n, ...]: every partition sees every
        partition's block, in partition order (a view, nothing is copied)."""
        flat = x.reshape(1, -1, *x.shape[2:])
        return flat.expand(x.shape[0], *flat.shape[1:])

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Partition p's block goes to partition (p + offset) % P: the
        reference's ppermute with perm [(p, (p + offset) % P)]."""
        return torch.roll(x, shifts=offset, dims=0)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x [P, ...] -> [P, ...]: every partition gets the sum over all
        partitions, added in partition order (a view of one sum)."""
        return sum_in_order(x).unsqueeze(0).expand_as(x)


# --------------------------------------------------------------------------
# Host-side partitioner (numpy, the reference's code)
# --------------------------------------------------------------------------


def _balanced_cut(weights: np.ndarray, n_parts: int) -> np.ndarray:
    """Owner per index: contiguous ranges cutting the weight prefix into
    n_parts near-equal loads."""
    c = np.cumsum(weights, dtype=np.float64)
    total = c[-1] if c.size else 0.0
    if total <= 0:
        return (np.arange(weights.size) * n_parts) // max(weights.size, 1)
    owner = np.minimum((np.floor((c - weights / 2) * n_parts / total)).astype(np.int64),
                       n_parts - 1)
    return np.maximum.accumulate(owner)  # monotone => contiguous ranges


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _fold_table(tgt: np.ndarray, keep: np.ndarray, n_own: int, n_rows: int):
    """[P, n_own, K] int64: per owned slot the rows j (ascending) with
    tgt[p, j] == slot and keep[p, j]; padding entries point at row n_rows
    (the appended zero row)."""
    n_parts = tgt.shape[0]
    per = [[[] for _ in range(n_own)] for _ in range(n_parts)]
    for p in range(n_parts):
        for j in np.flatnonzero(keep[p]):
            per[p][int(tgt[p, j])].append(int(j))
    k = max(1, max((len(x) for row in per for x in row), default=0))
    out = np.full((n_parts, n_own, k), n_rows, dtype=np.int64)
    for p in range(n_parts):
        for s, rows in enumerate(per[p]):
            out[p, s, :len(rows)] = rows
    return out


def partition(graph: Graph, n_parts: int, anchor_slot: int = 0, comm_mode: str = "auto",
              order_keys: dict | None = None) -> HaloProblem:
    """Partition `graph` (plain row layout) into an owner-sharded HaloProblem
    on the graph's device; owners, local ids, ghost lists, wiring arrays and
    modes are the reference's.

    anchor_slot: the factor slot whose variable's owner the factor follows
    (cameras / keyframes).  comm_mode: "auto" picks per variable block
    between the gather and the per-offset permute exchange by modelled
    bytes; "gather" / "permute" force one.  order_keys: optional {vblock:
    [count] key array}: each partition's owned / ghost slots of that block
    follow ascending key instead of ascending global id (the free
    per-partition locality sort of halo_cm's camera windows)."""
    dev = graph.vblocks[0].prior_eta.device
    nvb = len(graph.vblocks)
    vcounts = [vb.count for vb in graph.vblocks]
    adjs = [[_np(a).astype(np.int64) for a in fb.adj] for fb in graph.fblocks]
    i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)

    # 1. Owners of anchor vblocks: degree-weighted balanced contiguous cut.
    owner_of = [None] * nvb
    anchor_vb = []
    for fb in graph.fblocks:
        s = min(anchor_slot, len(fb.vblocks) - 1)
        anchor_vb.append((fb.vblocks[s], s))
    for vbi, _ in anchor_vb:
        if owner_of[vbi] is not None:
            continue
        deg = np.zeros(vcounts[vbi], dtype=np.int64)
        for fi, (avb, s) in enumerate(anchor_vb):
            if avb == vbi:
                deg += np.bincount(adjs[fi][s], minlength=vcounts[vbi])
        owner_of[vbi] = _balanced_cut(deg + 1, n_parts)

    # 2. Factor owners follow their anchor variable's owner.
    fowner = [owner_of[avb][adjs[fi][s]] for fi, (avb, s) in enumerate(anchor_vb)]

    # 3. Remaining vblocks: majority vote of the owning partitions of their factors.
    for vbi in range(nvb):
        if owner_of[vbi] is not None:
            continue
        votes = np.zeros((vcounts[vbi], n_parts), dtype=np.int64)
        for fi, fb in enumerate(graph.fblocks):
            for k, tvb in enumerate(fb.vblocks):
                if tvb == vbi:
                    np.add.at(votes, (adjs[fi][k], fowner[fi]), 1)
        own = votes.argmax(axis=1)
        own[votes.sum(axis=1) == 0] = 0  # prior-only variables
        owner_of[vbi] = own

    # 4. Per-partition local universes: owned + ghosts, and local id maps.
    def by_key(vbi, ids):
        if order_keys is None or vbi not in order_keys:
            return ids
        return ids[np.argsort(np.asarray(order_keys[vbi])[ids], kind="stable")]

    owned_lists = [[by_key(vbi, np.where(owner_of[vbi] == c)[0]) for c in range(n_parts)]
                   for vbi in range(nvb)]
    ghost_sets = [[set() for _ in range(n_parts)] for _ in range(nvb)]
    for fi, fb in enumerate(graph.fblocks):
        for k, tvb in enumerate(fb.vblocks):
            ghosted = owner_of[tvb][adjs[fi][k]] != fowner[fi]
            for v, c in zip(adjs[fi][k][ghosted], fowner[fi][ghosted]):
                ghost_sets[tvb][int(c)].add(int(v))
    ghost_lists = [[by_key(vbi, np.array(sorted(s), dtype=np.int64)) for s in per_vb]
                   for vbi, per_vb in enumerate(ghost_sets)]
    n_own_max = [max(max(len(o) for o in owned_lists[vbi]), 1) for vbi in range(nvb)]
    n_ghost_max = [max(len(g) for g in ghost_lists[vbi]) for vbi in range(nvb)]

    own_slot = [np.zeros(vcounts[vbi], dtype=np.int64) for vbi in range(nvb)]
    for vbi in range(nvb):
        for c in range(n_parts):
            own_slot[vbi][owned_lists[vbi][c]] = np.arange(len(owned_lists[vbi][c]))
    ghost_lookup = []
    for vbi in range(nvb):
        gl = np.full((n_parts, vcounts[vbi]), -1, dtype=np.int64)
        for c in range(n_parts):
            gl[c, ghost_lists[vbi][c]] = np.arange(ghost_lists[vbi][c].size)
        ghost_lookup.append(gl)

    # 5. Local factor blocks (partition-stacked, local adjacency, and per
    # slot a CSR of the local ids: the deterministic local partial sums).
    n_loc = [n_own_max[v] + max(n_ghost_max[v], 1) for v in range(nvb)]
    new_fblocks, fb_src_rows = [], []
    chipcol = np.arange(n_parts)[:, None]
    for fi, fb in enumerate(graph.fblocks):
        m_loc = max(int(np.bincount(fowner[fi], minlength=n_parts).max()), 1)
        rows = np.full((n_parts, m_loc), -1, dtype=np.int64)
        for c in range(n_parts):
            mine = np.where(fowner[fi] == c)[0]
            rows[c, :mine.size] = mine
        fb_src_rows.append(rows)
        safe = np.maximum(rows, 0)
        flat = torch.tensor(safe.reshape(-1), dtype=torch.int64, device=dev)
        place = lambda a: None if a is None else a[flat].reshape(n_parts, m_loc, *a.shape[1:])
        ladj, csr = [], []
        for k, tvb in enumerate(fb.vblocks):
            gadj = adjs[fi][k][safe]
            loc = np.where(owner_of[tvb][gadj] == chipcol, own_slot[tvb][gadj],
                           n_own_max[tvb] + ghost_lookup[tvb][chipcol, gadj])
            loc[rows < 0] = 0
            ladj.append(torch.tensor(loc, dtype=torch.int32, device=dev))
            parts = [adjacency_csr(loc[c], n_loc[tvb]) for c in range(n_parts)]
            csr.append(tuple(torch.tensor(np.stack(a), dtype=torch.int32, device=dev)
                             for a in zip(*parts)))
        valid = rows >= 0
        if fb.valid is not None:
            valid = valid & _np(fb.valid)[safe]
        new_fblocks.append(dataclasses.replace(
            fb, adj=tuple(ladj), z=place(fb.z), prec=place(fb.prec), args=place(fb.args),
            huber_arr=place(fb.huber_arr), valid=torch.tensor(valid, device=dev),
            n_valid=int(valid.sum()), ell_slot=None, ell_deg=0, csr=tuple(csr)))

    # 6. Owned priors (padded slots: eta 0, lam I so solves stay finite).
    new_vblocks, owned_ids_np, owned_valid_np, ghost_ids_np = [], [], [], []
    for vbi, vb in enumerate(graph.vblocks):
        d, no = vb.dof, n_own_max[vbi]
        pe = np.zeros((n_parts, no, d))
        pl = np.tile(np.eye(d), (n_parts, no, 1, 1))
        ids = np.full((n_parts, no), -1, dtype=np.int64)
        val = np.zeros((n_parts, no), dtype=bool)
        src_pe, src_pl = _np(vb.prior_eta), _np(vb.prior_lam)
        for c in range(n_parts):
            o = owned_lists[vbi][c]
            pe[c, :o.size] = src_pe[o]
            pl[c, :o.size] = src_pl[o]
            ids[c, :o.size] = o
            val[c, :o.size] = True
        dt = vb.prior_eta.dtype
        new_vblocks.append(VariableBlock(prior_eta=torch.tensor(pe, dtype=dt, device=dev),
                                         prior_lam=torch.tensor(pl, dtype=dt, device=dev),
                                         name=vb.name))
        owned_ids_np.append(ids)
        owned_valid_np.append(val)
        gids = np.full((n_parts, n_ghost_max[vbi]), -1, dtype=np.int64)
        for c in range(n_parts):
            g = ghost_lists[vbi][c]
            gids[c, :g.size] = g
        ghost_ids_np.append(gids)

    # 7. Comm wiring.
    comms = []
    for vbi in range(nvb):
        ng = n_ghost_max[vbi]
        no = n_own_max[vbi]
        bnd_per_chip = [[] for _ in range(n_parts)]
        ghosted_by = {}  # global id -> (owner, position in the owner's boundary list)
        for c in range(n_parts):
            for v in ghost_lists[vbi][c]:
                v = int(v)
                if v not in ghosted_by:
                    o = int(owner_of[vbi][v])
                    ghosted_by[v] = (o, len(bnd_per_chip[o]))
                    bnd_per_chip[o].append(v)
        b_max = max((len(b) for b in bnd_per_chip), default=0)
        recv = [[] for _ in range(n_parts)]
        for p in range(n_parts):
            for j, v in enumerate(ghost_lists[vbi][p]):
                o = int(owner_of[vbi][int(v)])
                recv[o].append((p * ng + j, int(own_slot[vbi][int(v)])))
        r_max = max((len(r) for r in recv), default=0)
        recv_src = np.zeros((n_parts, max(r_max, 1)), dtype=np.int64)
        recv_tgt = np.zeros((n_parts, max(r_max, 1)), dtype=np.int64)
        recv_mask = np.zeros((n_parts, max(r_max, 1)), dtype=bool)
        for c in range(n_parts):
            for j, (s, t) in enumerate(recv[c]):
                recv_src[c, j], recv_tgt[c, j], recv_mask[c, j] = s, t, True
        bnd_idx = np.zeros((n_parts, max(b_max, 1)), dtype=np.int64)
        for c in range(n_parts):
            for j, v in enumerate(bnd_per_chip[c]):
                bnd_idx[c, j] = own_slot[vbi][v]
        ghost_src = np.zeros((n_parts, max(ng, 1)), dtype=np.int64)
        ghost_mask = np.zeros((n_parts, max(ng, 1)), dtype=bool)
        for c in range(n_parts):
            for j, v in enumerate(ghost_lists[vbi][c]):
                o, pos = ghosted_by[int(v)]
                ghost_src[c, j] = o * max(b_max, 1) + pos
                ghost_mask[c, j] = True

        # permute-mode wiring: one hop per owner-distance offset.
        gowner = [owner_of[vbi][ghost_lists[vbi][p]] for p in range(n_parts)]
        offs_out = sorted({int((o - p) % n_parts) for p in range(n_parts) for o in gowner[p]})
        send_idx, send_mask, s_sizes = [], [], []
        for d in offs_out:
            per_p = [np.flatnonzero(gowner[p] == (p + d) % n_parts) for p in range(n_parts)]
            s_d = max(max((len(x) for x in per_p), default=0), 1)
            si = np.zeros((n_parts, s_d), dtype=np.int64)
            sm = np.zeros((n_parts, s_d), dtype=bool)
            for p in range(n_parts):
                si[p, :per_p[p].size] = per_p[p]
                sm[p, :per_p[p].size] = True
            send_idx.append(si)
            send_mask.append(sm)
            s_sizes.append(s_d)
        cat_tgt = np.full((n_parts, max(sum(s_sizes), 1)), no, dtype=np.int64)
        col = 0
        for d, s_d in zip(offs_out, s_sizes):
            for c in range(n_parts):
                p = (c - d) % n_parts
                vs = ghost_lists[vbi][p][gowner[p] == c]
                cat_tgt[c, col:col + vs.size] = own_slot[vbi][vs]
            col += s_d
        offs_in = sorted({int((p - o) % n_parts) for p in range(n_parts) for o in gowner[p]})
        bsend_idx, t_sizes = [], []
        for e in offs_in:
            per_o = [ghost_lists[vbi][(o + e) % n_parts][gowner[(o + e) % n_parts] == o]
                     for o in range(n_parts)]
            t_e = max(max((len(x) for x in per_o), default=0), 1)
            bi = np.zeros((n_parts, t_e), dtype=np.int64)
            for o in range(n_parts):
                bi[o, :per_o[o].size] = own_slot[vbi][per_o[o]]
            bsend_idx.append(bi)
            t_sizes.append(t_e)
        perm_ghost_src = np.zeros((n_parts, max(ng, 1)), dtype=np.int64)
        base = {e: int(np.sum(t_sizes[:i])) for i, e in enumerate(offs_in)}
        for p in range(n_parts):
            for o in set(int(x) for x in gowner[p]):
                sel = np.flatnonzero(gowner[p] == o)
                perm_ghost_src[p, sel] = base[(p - o) % n_parts] + np.arange(sel.size)

        gather_vol = n_parts * (ng + b_max)
        permute_vol = sum(s_sizes) + sum(t_sizes)
        if comm_mode == "auto":
            mode = "permute" if (ng > 0 and permute_vol < gather_vol) else "gather"
        else:
            mode = comm_mode if ng > 0 else "gather"
        perm = mode == "permute"
        if perm:
            fold = _fold_table(cat_tgt, cat_tgt < no, no, cat_tgt.shape[1])
        else:
            fold = _fold_table(recv_tgt, recv_mask, no, recv_tgt.shape[1])
        comms.append(HaloComm(
            recv_src=i64(recv_src), recv_tgt=i64(recv_tgt),
            recv_mask=torch.tensor(recv_mask, device=dev), bnd_idx=i64(bnd_idx),
            ghost_src=i64(ghost_src), ghost_mask=torch.tensor(ghost_mask, device=dev),
            send_idx=tuple(i64(a) for a in send_idx) if perm else None,
            send_mask=tuple(torch.tensor(a, device=dev) for a in send_mask) if perm else None,
            cat_tgt=i64(cat_tgt) if perm else None,
            bsend_idx=tuple(i64(a) for a in bsend_idx) if perm else None,
            perm_ghost_src=i64(perm_ghost_src) if perm else None,
            fold=i64(fold), n_own_max=no, n_ghost_max=ng, b_max=b_max, r_max=r_max, mode=mode,
            offsets_out=tuple(offs_out) if perm else (),
            offsets_in=tuple(offs_in) if perm else ()))

    hgraph = HaloGraph(vblocks=tuple(new_vblocks), fblocks=tuple(new_fblocks),
                       comm=tuple(comms))
    return HaloProblem(hgraph, n_parts, owned_ids_np, owned_valid_np, ghost_ids_np,
                       fb_src_rows, graph)


# --------------------------------------------------------------------------
# State init / collection (host-side helpers)
# --------------------------------------------------------------------------


def ghost_states(hp: HaloProblem, means: tuple) -> tuple:
    """Per vblock the ghost VariableState [P, max(ng, 1), ...] of the
    initial beliefs: priors and means of the ghosted variables, identity
    rows in the padding."""
    out = []
    for vbi, vb in enumerate(hp.src_graph.vblocks):
        d = vb.dof
        ng = hp.hgraph.comm[vbi].n_ghost_max
        dt, dev = vb.prior_eta.dtype, vb.prior_eta.device
        gids = hp.local(hp.ghost_ids[vbi])
        n_parts = len(gids)
        ge = torch.zeros((n_parts, max(ng, 1), d), dtype=dt, device=dev)
        gl = torch.eye(d, dtype=dt, device=dev).repeat(n_parts, max(ng, 1), 1, 1)
        gm = torch.zeros((n_parts, max(ng, 1), d), dtype=dt, device=dev)
        for c in range(n_parts):
            sel = gids[c] >= 0
            n = int(sel.sum())
            src = torch.tensor(gids[c][sel], dtype=torch.int64, device=dev)
            ge[c, :n] = vb.prior_eta[src]
            gl[c, :n] = vb.prior_lam[src]
            gm[c, :n] = means[vbi].to(dev)[src].to(dt)
        out.append(VariableState(eta=ge, lam=gl, mean=gm))
    return tuple(out)


def owned_means(hp: HaloProblem, means: tuple) -> tuple:
    """Per vblock the held partitions' owned means [K, n_own_max, d] (zero
    in the padding)."""
    out = []
    for vbi, vb in enumerate(hp.src_graph.vblocks):
        ids, val = hp.local(hp.owned_ids[vbi]), hp.local(hp.owned_valid[vbi])
        m = torch.zeros((*ids.shape, vb.dof), dtype=vb.prior_eta.dtype,
                        device=vb.prior_eta.device)
        m[torch.tensor(val, device=m.device)] = means[vbi].to(m.device)[
            torch.tensor(ids[val], dtype=torch.int64, device=m.device)].to(m.dtype)
        out.append(m)
    return tuple(out)


def init_state(hp: HaloProblem, means: tuple) -> HaloState:
    """Beliefs = priors (owned AND ghost copies), factors linearized at
    `means`, zero messages: sweep.init_state's semantics."""
    g = hp.src_graph
    n_parts = len(hp.parts)
    vstates = tuple(VariableState(eta=hvb.prior_eta, lam=hvb.prior_lam, mean=m)
                    for hvb, m in zip(hp.hgraph.vblocks, owned_means(hp, means)))
    fstates = []
    for fi, fb in enumerate(g.fblocks):
        hfb = hp.hgraph.fblocks[fi]
        dev = hfb.z.device
        safe = torch.tensor(np.maximum(hp.local(hp.fb_src_rows[fi]), 0), dtype=torch.int64,
                            device=dev)
        x = torch.cat([means[vb].to(dev)[fb.adj[k].to(dev).long()[safe]]
                       for k, vb in enumerate(fb.vblocks)], dim=-1).to(hfb.z.dtype)
        m_loc, t = x.shape[1], x.shape[2]
        flat = lambda a: None if a is None else a.reshape(n_parts * m_loc, *a.shape[2:])
        flat_fb = dataclasses.replace(fb, z=flat(hfb.z), prec=flat(hfb.prec),
                                      args=flat(hfb.args))
        jac, r0 = sweep_mod.linearize_block(flat_fb, x.reshape(n_parts * m_loc, t))
        dt = jac.dtype
        zeros = lambda *shape: torch.zeros((n_parts, m_loc, *shape), dtype=dt, device=dev)
        fstates.append(FactorState(
            linpoint=x, jac=jac.reshape(n_parts, m_loc, *jac.shape[1:]),
            r0=r0.reshape(n_parts, m_loc, -1),
            msg_eta=tuple(zeros(d) for d in fb.dofs),
            msg_lam=tuple(zeros(d, d) for d in fb.dofs),
            since_relin=torch.zeros((n_parts, m_loc), dtype=torch.int32, device=dev)))
    return HaloState(v=vstates, ghost=ghost_states(hp, means), f=tuple(fstates))


def weaken_priors(hp: HaloProblem, factor: float = 0.1,
                  keep=((0, (0, 1), (0, 6)),)) -> HaloProblem:
    """Owner-sharded models/ba.weaken_priors: scale every owned variable's
    prior by `factor` except the listed gauge anchors (global ids); keep
    entries are (vblock, ids) or (vblock, ids, (lo, hi)) pinning only that
    component range.  Padded owned slots keep their identity prior."""
    hg = hp.hgraph
    new_vbs = []
    for vbi, vb in enumerate(hg.vblocks):
        dof = vb.prior_eta.shape[-1]
        ids = hp.local(hp.owned_ids[vbi])
        scale = np.full(ids.shape + (dof,), factor)
        scale[~hp.local(hp.owned_valid[vbi])] = 1.0
        for e in keep:
            if e[0] != vbi:
                continue
            lo, hi = (0, dof) if len(e) < 3 else e[2]
            for gid in np.asarray(e[1]).ravel():
                hits = np.argwhere(ids == gid)
                if hits.size:
                    scale[hits[0][0], hits[0][1], lo:min(hi, dof)] = 1.0
        sc = torch.tensor(scale, dtype=vb.prior_eta.dtype, device=vb.prior_eta.device)
        new_vbs.append(dataclasses.replace(vb, prior_eta=vb.prior_eta * sc,
                                           prior_lam=vb.prior_lam * sc[..., None]))
    hp.hgraph = hg._replace(vblocks=tuple(new_vbs))
    return hp


def collect_means(hp: HaloProblem, state) -> tuple:
    """Owned per-partition means -> global [n, d] tensors (on the state's
    device); the variables of partitions held elsewhere stay zero
    (`multihost.collect_means` gathers them first)."""
    out = []
    for vbi, vb in enumerate(hp.src_graph.vblocks):
        m = state.v[vbi].mean
        ids, val = hp.local(hp.owned_ids[vbi]), hp.local(hp.owned_valid[vbi])
        g = torch.zeros((vb.count, vb.dof), dtype=m.dtype, device=m.device)
        g[torch.tensor(ids[val], dtype=torch.int64, device=m.device)] = \
            m[torch.tensor(val, device=m.device)]
        out.append(g)
    return tuple(out)


def collective_bytes(hp: HaloProblem, itemsize: int = 4) -> dict:
    """Analytic per-sweep collective volume (bytes moved per partition):
    the two exchanges, against what a replicated all-reduce of the full
    packed variable state would move."""
    n_parts = hp.n_chips
    halo = rep = 0
    modes = []
    for vbi, vb in enumerate(hp.src_graph.vblocks):
        d = vb.dof
        c = hp.hgraph.comm[vbi]
        modes.append(c.mode)
        if c.mode == "permute":
            s_out = sum(int(si.shape[1]) for si in c.send_idx)
            s_in = sum(int(bi.shape[1]) for bi in c.bsend_idx)
            halo += s_out * (d + d * d) * itemsize
            halo += s_in * (2 * d + d * d) * itemsize
        else:
            halo += n_parts * c.n_ghost_max * (d + d * d) * itemsize
            halo += n_parts * c.b_max * (2 * d + d * d) * itemsize
        rep += 2 * vb.count * (d + d * d) * itemsize  # ring all-reduce ~2x
    return {"halo_bytes_per_sweep": int(halo), "replicated_psum_bytes_per_sweep": int(rep),
            "modes": modes}


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per partition rows idx[p] of x[p]: x [P, n, ...], idx [P, k] -> [P, k, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _at(obj, p: int):
    """Partition p's slice of a NamedTuple (or tuple) of stacked tensors."""
    if isinstance(obj, torch.Tensor):
        return obj[p]
    if isinstance(obj, tuple):
        items = [_at(o, p) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def _rows(obj, lo: int, hi: int):
    """Rows lo..hi-1 (partitions, or factor rows) of every tensor of a
    (nested) NamedTuple / tuple / dataclass."""
    return _map_tensors(lambda t: t[lo:hi], obj)


def keep_parts(hp: HaloProblem, comm) -> HaloProblem:
    """Keep the partitions `comm` holds (`comm.parts`): a range-slice of
    every stacked tensor of hp.hgraph; hp.parts records it."""
    if comm.n_parts != hp.n_chips:
        raise ValueError(f"the communicator spans {comm.n_parts} partitions, the problem "
                         f"{hp.n_chips}")
    hp.parts = comm.parts
    hp.hgraph = _rows(hp.hgraph, comm.parts.start, comm.parts.stop)
    return hp


def _stack(parts: list):
    """The inverse of `_at` over partitions: stack the partitions' tensors."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    if isinstance(first, tuple):
        items = [_stack([q[i] for q in parts]) for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    return first


def _local_fblock(fb: FactorBlock, p: int) -> FactorBlock:
    at = lambda a: None if a is None else a[p]
    valid = fb.valid[p]
    return dataclasses.replace(
        fb, adj=tuple(a[p] for a in fb.adj), z=fb.z[p], prec=fb.prec[p], args=at(fb.args),
        huber_arr=at(fb.huber_arr), valid=valid, n_valid=None,
        csr=tuple(tuple(a[p] for a in c) for c in fb.csr))


def _local_graph(hg: HaloGraph, p: int) -> Graph:
    """Partition p's Graph view, whose belief table is [owned | ghosts].
    The priors are only a shape carrier: the owners update beliefs in the
    exchange, not in update_beliefs."""
    vbs = []
    for vbi, vb in enumerate(hg.vblocks):
        c = hg.comm[vbi]
        d = vb.prior_eta.shape[-1]
        n_loc = c.n_own_max + max(c.n_ghost_max, 1)
        vbs.append(VariableBlock(prior_eta=vb.prior_eta.new_zeros((n_loc, d)),
                                 prior_lam=vb.prior_lam.new_zeros((n_loc, d, d)), name=vb.name))
    return Graph(vblocks=tuple(vbs), fblocks=tuple(_local_fblock(fb, p) for fb in hg.fblocks))


def _local_beliefs(state) -> tuple:
    """Per vblock the [owned | ghosts] VariableState, stacked [P, n_loc, ...]."""
    return tuple(VariableState(*(torch.cat([a, b], dim=1) for a, b in zip(v, g)))
                 for v, g in zip(state.v, state.ghost))


def _sweep_halo(hg: HaloGraph, state: HaloState, cfg: GBPConfig, comm,
                active: tuple | None = None, skip_exchange: bool = False) -> HaloState:
    """One synchronous sweep of every partition.

    active: optional per-fblock [P, m_loc] bool mask (the halo schedules):
    inactive factors keep their previous messages and skip
    relinearization, composed with the validity mask as in sweep.sweep."""
    lv = _local_beliefs(state)
    new_f, packed = [], [[] for _ in hg.vblocks]
    for p in range(len(state.v[0].eta)):
        lgraph = _local_graph(hg, p)
        lstate = GBPState(v=_at(lv, p), f=_at(state.f, p))
        f_p = []
        for fi, fb in enumerate(lgraph.fblocks):
            fs = lstate.f[fi]
            act = fb.valid if active is None else fb.valid & active[fi][p]
            beliefs, x = sweep_mod._gather_beliefs_and_means(lgraph, lstate, fi)
            if sweep_mod._use_fused_relin(cfg, fb):
                fs = sweep_mod._fused_relin_messages(fb, fs, beliefs, x, cfg, act)
            else:
                fs = sweep_mod._relinearize(fb, fs, x, cfg, act)
                fs = sweep_mod._compute_messages(fb, fs, beliefs, cfg, act)
            f_p.append(fs)
        new_f.append(tuple(f_p))
        # Local partial sums over the [owned | ghosts] table.
        for vbi, vb in enumerate(lgraph.vblocks):
            d = vb.dof
            pk = vb.prior_eta.new_zeros((vb.count, d + d * d))
            for fi, fb in enumerate(lgraph.fblocks):
                for k, tvb in enumerate(fb.vblocks):
                    if tvb == vbi:
                        ml = f_p[fi].msg_lam[k]
                        pk = pk + segsum_by_id(f_p[fi].msg_eta[k], ml.reshape(ml.shape[0], -1),
                                               *fb.csr[k], row_major=True)
            packed[vbi].append(pk)
    new_v, new_ghost = [], []
    for vbi, vb in enumerate(hg.vblocks):
        ov, gv = exchange_and_update(vb, hg.comm[vbi], torch.stack(packed[vbi]),
                                     state.ghost[vbi], comm, skip=skip_exchange)
        new_v.append(ov)
        new_ghost.append(gv)
    return HaloState(v=tuple(new_v), ghost=tuple(new_ghost), f=_stack(new_f))


def exchange_and_update(vb: VariableBlock, c: HaloComm, packed: torch.Tensor, ghost_prev,
                        comm, skip: bool = False):
    """The halo exchange and the owner belief update of one variable block.

    packed: [P, n_own_max + max(ng, 1), d + d^2] local partial message sums
    (rows from n_own_max on are the ghost partials).  Returns (owned
    VariableState, ghost VariableState), stacked [P, ...].

    skip=True drops both collectives: owners update from local partials
    only and ghosts go stale.  Wrong numerics, the same local work: the
    baseline that isolates the cost of the exchange."""
    d = vb.prior_eta.shape[-1]
    no, ng = c.n_own_max, c.n_ghost_max
    n_parts = packed.shape[0]
    own_part = packed[:, :no]
    if ng > 0 and not skip:
        # ghost partials -> owners (O(boundary) collective #1)
        gbuf = packed[:, no:no + ng]
        if c.mode == "permute":
            recvs = []
            for i, off in enumerate(c.offsets_out):
                buf = torch.where(c.send_mask[i][:, :, None], _take(gbuf, c.send_idx[i]),
                                  torch.zeros((), dtype=gbuf.dtype, device=gbuf.device))
                recvs.append(comm.shift(buf, off))
            contrib = torch.cat(recvs, dim=1)
        else:
            flat = comm.all_gather(gbuf)
            contrib = torch.where(c.recv_mask[:, :, None], _take(flat, c.recv_src),
                                  torch.zeros((), dtype=gbuf.dtype, device=gbuf.device))
        contrib = torch.cat([contrib, contrib.new_zeros((n_parts, 1, contrib.shape[2]))], dim=1)
        rows = _take(contrib, c.fold.reshape(n_parts, -1)).reshape(n_parts, no, -1,
                                                                    contrib.shape[2])
        total = rows[:, :, 0]
        for k in range(1, rows.shape[2]):
            total = total + rows[:, :, k]
        own_part = own_part + total
    eta = vb.prior_eta + own_part[..., :d]
    lam = vb.prior_lam + own_part[..., d:].reshape(n_parts, no, d, d)
    mean = scaled_sym_solve(lam, eta)
    owned = VariableState(eta=eta, lam=lam, mean=mean)
    if ng == 0 or skip:
        return owned, ghost_prev
    # boundary beliefs -> ghost holders (O(boundary) collective #2)
    pk = torch.cat([eta, lam.reshape(n_parts, no, -1), mean], dim=-1)
    if c.mode == "permute":
        recvs = [comm.shift(_take(pk, bi), off) for bi, off in zip(c.bsend_idx, c.offsets_in)]
        got = _take(torch.cat(recvs, dim=1), c.perm_ghost_src)
    else:
        got = _take(comm.all_gather(_take(pk, c.bnd_idx)), c.ghost_src)
    idrow = packed_identity_row(d, dtype=pk.dtype, device=pk.device)
    got = torch.where(c.ghost_mask[:, :, None], got, idrow)
    ghost = VariableState(eta=got[..., :d], lam=got[..., d:d + d * d].reshape(n_parts, ng, d, d),
                          mean=got[..., -d:])
    return owned, ghost


def make_run(hp: HaloProblem, skip_exchange: bool = False, comm=None):
    """run(hgraph, state, cfg, n_iters) over the partitions of `hp`.
    skip_exchange=True drops the collectives each sweep (the
    no-communication baseline).  comm: the communicator (default: the
    single-process `LocalComm`)."""
    comm = LocalComm(hp.n_chips) if comm is None else comm

    def run_halo(hgraph, state, cfg, n_iters):
        for _ in range(n_iters):
            state = _sweep_halo(hgraph, state, cfg, comm, skip_exchange=skip_exchange)
        return state

    return run_halo


def _map_tensors(fn, obj):
    """`fn` applied to every tensor of a (nested) NamedTuple / tuple /
    dataclass; everything else (ints, tuples of ints, strings) kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = [_map_tensors(fn, o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))})
    return obj


def to_device(obj, device):
    """Every tensor of a (nested) NamedTuple / tuple / dataclass moved to
    `device`."""
    return _map_tensors(lambda t: t.to(device), obj)


def distribute(graph: Graph, means: tuple, n_parts: int, device=None, anchor_slot: int = 0,
               comm_mode: str = "auto", comm=None):
    """Partition + place: returns (HaloProblem, HaloState, run_fn), every
    tensor on `device` (None: the communicator's device, else the card).
    The reference's `distribute` takes a device mesh.  comm=None: the P
    partitions share one device and exchange through `LocalComm`; with a
    communicator (`multihost.DistComm`) every rank runs the same host-side
    partition and keeps its own partitions."""
    device = resolve_device(device if device is not None else getattr(comm, "device", None))
    hp = partition(graph, n_parts, anchor_slot, comm_mode)
    if comm is not None:
        keep_parts(hp, comm)
    hp.hgraph = to_device(hp.hgraph, device)
    state = to_device(init_state(hp, means), device)
    return hp, state, make_run(hp, comm=comm)


def energy_halo(hp: HaloProblem, state: HaloState, comm=None) -> float:
    """Total energy: per-partition sums over their local factors, added in
    partition order across the communicator (the reference's one psum of
    a scalar; default: the single-process `LocalComm`)."""
    comm = LocalComm(hp.n_chips) if comm is None else comm
    lv = _local_beliefs(state)
    e = torch.stack([
        sweep_mod.energy(_local_graph(hp.hgraph, p),
                         GBPState(v=_at(lv, p), f=_at(state.f, p))).to(torch.float64)
        for p in range(len(state.v[0].eta))])
    return float(comm.all_reduce(e)[0])
