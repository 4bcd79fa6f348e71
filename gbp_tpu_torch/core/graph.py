"""Factor graph as structure-of-arrays with static topology.

Counterpart of gbp_tpu/core/graph.py.  Variables are grouped into
`VariableBlock`s by dof class, factors into `FactorBlock`s by factor type,
and topology is int32 index tensors (factor -> variable id per slot).
`GraphBuilder` is the reference's numpy code, so the same inputs give the
same ELL row order, `valid`, `n_valid` and `ell_deg`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.factors.base import FactorType


@dataclasses.dataclass(frozen=True)
class VariableBlock:
    """A group of `n` variables sharing one dof class, with unary priors in
    information form."""

    prior_eta: torch.Tensor  # [n, d]
    prior_lam: torch.Tensor  # [n, d, d]
    name: str = "var"

    @property
    def count(self) -> int:
        return self.prior_eta.shape[0]

    @property
    def dof(self) -> int:
        return self.prior_eta.shape[-1]


@dataclasses.dataclass(frozen=True)
class FactorBlock:
    """A group of `m` same-type factors.

    adj[k] [m] int32: which variable of block `vblocks[k]` slot k connects
    to.  prec is the diagonal measurement precision [m, zdim] (or full
    [m, zdim, zdim]).  valid False marks inert padding rows.  huber_arr [m]
    holds per-factor Huber thresholds (0 = off for that factor) and excludes
    the static `huber`.  With the ELL layout (`ell_slot` not None) row r
    belongs to variable r // ell_deg of slot `ell_slot`.  csr[k] = (rows,
    offsets), int32: the rows sorted by adj[k] (stable) and the offsets of
    each variable's rows, the fixed summation order of the deterministic
    scatter lowering of the belief update."""

    adj: tuple
    z: torch.Tensor
    prec: torch.Tensor
    args: Any = None
    valid: torch.Tensor | None = None
    huber_arr: torch.Tensor | None = None
    ftype: FactorType | None = None
    vblocks: tuple = ()
    dofs: tuple = ()
    huber: float | None = None
    name: str = "factor"
    n_valid: int | None = None
    ell_slot: int | None = None
    ell_deg: int = 0
    csr: tuple | None = None

    @property
    def count(self) -> int:
        return self.z.shape[0]

    @property
    def tdof(self) -> int:
        return sum(self.dofs)

    @property
    def offsets(self) -> tuple:
        out, acc = [], 0
        for d in self.dofs:
            out.append(acc)
            acc += d
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Inbox:
    """Dense per-variable message inbox for one (factor block, slot) source:
    idx[v, k] is the factor row whose slot-`slot` message is variable v's
    k-th incoming message (0 where mask is False), so a belief update is a
    gather and a masked sum, with no scatter."""

    idx: torch.Tensor  # [n, max_deg] int32
    mask: torch.Tensor  # [n, max_deg] bool
    fi: int = 0
    slot: int = 0


@dataclasses.dataclass(frozen=True)
class Graph:
    vblocks: tuple  # tuple[VariableBlock]
    fblocks: tuple  # tuple[FactorBlock]
    # inboxes[vi] = tuple[Inbox] for variable block vi, or None to sum that
    # block's messages by the ELL reshape-sum / scatter lowering.
    inboxes: tuple | None = None

    def total_dim(self) -> int:
        return sum(vb.count * vb.dof for vb in self.vblocks)


def adjacency_csr(adj, n: int):
    """(rows, offsets) int32 numpy arrays: the factor rows sorted by their
    variable id `adj` (stable, so each variable's rows stay in row order)
    and the [n + 1] offsets of each variable's rows."""
    adj = np.asarray(adj, dtype=np.int64)
    rows = np.argsort(adj, kind="stable").astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(adj, minlength=n))]).astype(np.int32)
    return rows, offsets


def adjacency_csr_device(adj: torch.Tensor, valid: torch.Tensor, n: int):
    """`adjacency_csr` of the rows where `valid` holds, built on adj's device
    in fixed shapes and with no host read: (rows [m], offsets [n + 1]) int32.
    The other rows sort past offsets[n], where `segsum_by_id` takes them for
    padding.  For graphs whose adjacency changes on the device (the online
    model's add_frame and evict_frames)."""
    key = torch.where(valid, adj.to(torch.int32), n)
    sorted_key, rows = torch.sort(key, stable=True)
    ids = torch.arange(n + 1, dtype=torch.int32, device=key.device)
    return rows.to(torch.int32), torch.searchsorted(sorted_key, ids, out_int32=True)


def build_inboxes(fblocks, vcounts, max_pad_ratio=8.0, device=None):
    """Precompute dense inboxes from factor adjacency (host-side numpy).

    Returns a tuple per variable block of tuples of Inbox, with None where
    the degree skew makes the padding exceed max_pad_ratio x the message
    count (that block keeps the scatter lowering), or None when every block
    does.  The reference's numpy code, so both packages build the same
    inboxes."""
    out = []
    for vi, n in enumerate(vcounts):
        specs = []
        ok = True
        for fi, fb in enumerate(fblocks):
            for slot, target in enumerate(fb.vblocks):
                if target != vi:
                    continue
                adj = np.asarray(fb.adj[slot].cpu())
                m = adj.shape[0]
                deg = np.bincount(adj, minlength=n)
                max_deg = max(int(deg.max()), 1)
                if n * max_deg > max_pad_ratio * max(m, 1):
                    ok = False
                    break
                order = np.argsort(adj, kind="stable")
                pos = np.arange(m) - np.concatenate([[0], np.cumsum(deg)])[adj[order]]
                idx = np.zeros((n, max_deg), dtype=np.int32)
                mask = np.zeros((n, max_deg), dtype=bool)
                idx[adj[order], pos] = order.astype(np.int32)
                mask[adj[order], pos] = True
                dev = fb.adj[slot].device if device is None else device
                specs.append(Inbox(idx=torch.tensor(idx, device=dev),
                                   mask=torch.tensor(mask, device=dev), fi=fi, slot=slot))
            if not ok:
                break
        out.append(tuple(specs) if ok else None)
    if all(s is None for s in out):
        return None
    return tuple(out)


class GraphBuilder:
    """Host-side (numpy) construction of a Graph + initial means.  The
    tensors are built on `device`; None means the card (`default_device()`)."""

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._vblocks: list[dict] = []
        self._fblocks: list[dict] = []

    def add_variables(self, name, init_means, prior_means=None, prior_prec=None):
        """Add a block of variables: init_means [n, d]; prior_prec scalar,
        [n] or [n, d] diagonal precision of the unary prior (default 0)."""
        init_means = np.asarray(init_means, dtype=np.float64)
        n, d = init_means.shape
        if prior_means is None:
            prior_means = init_means
        prior_means = np.broadcast_to(np.asarray(prior_means, dtype=np.float64), (n, d)).copy()
        if prior_prec is None:
            prior_prec = 0.0
        prior_prec = np.broadcast_to(np.asarray(prior_prec, dtype=np.float64), (n, d)).copy()
        self._vblocks.append(dict(name=name, init=init_means, pm=prior_means, pp=prior_prec))
        return len(self._vblocks) - 1

    def set_prior(self, vblock, idx, mean, prec):
        """Override the prior of variable `idx` in block `vblock` (gauge anchors)."""
        b = self._vblocks[vblock]
        b["pm"][idx] = np.asarray(mean, dtype=np.float64)
        b["pp"][idx] = np.broadcast_to(np.asarray(prec, dtype=np.float64), b["pm"][idx].shape)

    def add_factors(self, name, ftype, connections, z, sigma=None, prec=None,
                    args=None, huber=None):
        """Add a block of same-type factors.

        connections: list of (vblock_handle, idx [m]), one per slot.  z
        [m, zdim]; sigma (scalar / [m] / [m, zdim]) or prec.  huber: scalar
        Mahalanobis threshold, or per-factor [m] thresholds."""
        z = np.asarray(z, dtype=np.float64)
        m = z.shape[0]
        if prec is None:
            sigma = np.asarray(sigma, dtype=np.float64)
            prec = 1.0 / (sigma * sigma)
        prec = np.asarray(prec, dtype=np.float64)
        if prec.ndim == 3:
            if prec.shape != (m, z.shape[1], z.shape[1]):
                raise ValueError(f"full prec must be [m, z, z], got {prec.shape}")
        else:
            prec = np.broadcast_to(prec, z.shape).copy()
        conns = [(int(vb), np.asarray(idx, dtype=np.int32)) for vb, idx in connections]
        for _, idx in conns:
            if idx.shape != (m,):
                raise ValueError(f"adjacency shape {idx.shape} != ({m},)")
        huber_arr = None
        if huber is not None and np.ndim(huber) > 0:
            huber_arr = np.asarray(huber, dtype=np.float64)
            if huber_arr.shape != (m,):
                raise ValueError(f"huber array shape {huber_arr.shape} != ({m},)")
            huber = None
        self._fblocks.append(dict(name=name, ftype=ftype, conns=conns, z=z, prec=prec,
                                  args=args, huber=huber, huber_arr=huber_arr))
        return len(self._fblocks) - 1

    @staticmethod
    def _ell_reorder(fb: dict, vcounts: list, max_pad_ratio: float = 2.0):
        """Reorder one factor block into ELL layout; returns (fb, ell_slot,
        ell_deg).  The reference's numpy code, line for line: group rows by
        the slot whose other slots have the fewest variables (tiebreak:
        padding), pad every group to the max degree with inert clones
        (valid=False) of the group's first row."""
        m = fb["z"].shape[0]
        if m == 0:
            return fb, None, 0
        best = None
        for k, (vb, idx) in enumerate(fb["conns"]):
            deg = np.bincount(idx, minlength=vcounts[vb])
            d_max = max(int(deg.max()), 1)
            rows = vcounts[vb] * d_max
            if rows > max_pad_ratio * m:
                continue
            other = max(
                (vcounts[vb2] for j, (vb2, _) in enumerate(fb["conns"]) if j != k),
                default=0,
            )
            key = (other, rows)
            if best is None or key < best[0]:
                best = (key, k, d_max, rows)
        if best is None:
            return fb, None, 0
        _, k, d_max, rows = best
        vb_k, idx_k = fb["conns"][k]
        n = vcounts[vb_k]
        order = np.argsort(idx_k, kind="stable")
        deg = np.bincount(idx_k, minlength=n)
        starts = np.concatenate([[0], np.cumsum(deg)])
        # Destination row of each (sorted) factor: var * d_max + rank.
        rank = np.arange(m) - starts[idx_k[order]]
        dest = idx_k[order] * d_max + rank
        # Source row for every destination: the group's first real row
        # (global row 0 for empty groups), overwritten by the real rows.
        first = np.zeros(n, dtype=np.int64)
        has = deg > 0
        first[has] = order[starts[:-1][has]]
        src = np.repeat(first, d_max)
        src[dest] = order
        valid = np.zeros(rows, dtype=bool)
        valid[dest] = True

        out = dict(fb)
        out["conns"] = [(vb, idx[src].copy()) for vb, idx in fb["conns"]]
        # The ELL slot's ids must match the row grouping even for clones.
        out["conns"][k] = (vb_k, np.repeat(np.arange(n, dtype=idx_k.dtype), d_max))
        out["z"] = fb["z"][src]
        out["prec"] = fb["prec"][src]
        if fb["args"] is not None:
            out["args"] = np.asarray(fb["args"])[src]
        if fb.get("huber_arr") is not None:
            out["huber_arr"] = fb["huber_arr"][src]
        out["valid"] = valid
        return out, k, d_max

    def build(self, with_inboxes: bool = False, layout: str = "none"):
        """Returns (Graph, init_means).  layout="ell" reorders every factor
        block into ELL form; "none" keeps insertion order.  with_inboxes
        precomputes dense per-variable inboxes (gather-form belief updates)."""
        for vb in self._vblocks:
            if (vb["pp"] == 0).all(axis=-1).any():
                warnings.warn(
                    f"variable block '{vb['name']}' has variables with zero prior "
                    "precision; their initial beliefs are singular and GBP will "
                    "produce NaNs. Give every variable at least a weak prior.",
                    stacklevel=2,
                )
        dt, dev = self.dtype, self.device
        vblocks, init_means = [], []
        for vb in self._vblocks:
            n, d = vb["init"].shape
            prior_lam = np.zeros((n, d, d))
            prior_lam[:, np.arange(d), np.arange(d)] = vb["pp"]
            vblocks.append(VariableBlock(
                prior_eta=torch.tensor(vb["pp"] * vb["pm"], dtype=dt, device=dev),
                prior_lam=torch.tensor(prior_lam, dtype=dt, device=dev),
                name=vb["name"],
            ))
            init_means.append(torch.tensor(vb["init"], dtype=dt, device=dev))
        vcounts = [v["init"].shape[0] for v in self._vblocks]
        fblocks = []
        for fb in self._fblocks:
            ell_slot, ell_deg = None, 0
            if layout == "ell":
                fb, ell_slot, ell_deg = self._ell_reorder(fb, vcounts)
            vb_ids = tuple(vb for vb, _ in fb["conns"])
            args = fb["args"]
            if args is not None:
                args = torch.tensor(np.asarray(args), dtype=dt, device=dev)
            valid = fb.get("valid")
            fblocks.append(FactorBlock(
                adj=tuple(torch.tensor(idx, dtype=torch.int32, device=dev)
                          for _, idx in fb["conns"]),
                z=torch.tensor(fb["z"], dtype=dt, device=dev),
                prec=torch.tensor(fb["prec"], dtype=dt, device=dev),
                args=args,
                valid=None if valid is None else torch.tensor(valid, device=dev),
                huber_arr=None if fb.get("huber_arr") is None
                else torch.tensor(fb["huber_arr"], dtype=dt, device=dev),
                ftype=fb["ftype"],
                vblocks=vb_ids,
                dofs=tuple(self._vblocks[vb]["init"].shape[1] for vb in vb_ids),
                huber=fb["huber"],
                name=fb["name"],
                n_valid=None if valid is None else int(valid.sum()),
                ell_slot=ell_slot,
                ell_deg=ell_deg,
                csr=tuple(
                    tuple(torch.tensor(a, dtype=torch.int32, device=dev)
                          for a in adjacency_csr(idx, vcounts[vb]))
                    for vb, idx in fb["conns"]),
            ))
        inboxes = build_inboxes(fblocks, vcounts) if with_inboxes else None
        return (Graph(vblocks=tuple(vblocks), fblocks=tuple(fblocks), inboxes=inboxes),
                tuple(init_means))
