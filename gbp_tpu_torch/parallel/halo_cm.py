"""The component-major fast path under halo partitioning (counterpart of
gbp_tpu/parallel/halo_cm.py).

Each partition of a `halo.partition` runs the single-device fast path's
sweep (core/sweep_cm.py) on its local universe: its factor rows grouped by
their partition-local ELL-slot variable (uniform degree), factor state
resident component-major [F, mp], the same kernels; the ELL reshape-sum and
the gathered slot's sums give partial sums over the partition's whole local
universe (owned + ghosts), which is what the halo exchange consumes
(`halo.exchange_and_update`).  Pose graphs (both slots on one variable
block) add their two slots' sums before one exchange.

How the gathered slot's beliefs reach the kernels (`prepare` decides, per
the reference's rules with the port's shared-memory gates):

  windowed   the partition's camera windows engage (city and venice cut
             into partitions): a tile's owned ids lie in its window of the
             OWNED table, ghost ids (and the duplicated cut cameras that
             boundary landmarks owned elsewhere read) in a small ghost table
             in device memory: `relin_cm_tabblkg_ell` +
             `messages_cm_tabblkg_ell` (ELL slot fused), or `expand_ell_blk`
             + `relin_cm_tabblkg` + `messages_cm_tabblkg` (unfused); the
             owned sums by `segsum_cm_blk` + `scatter_windows_cm`, the ghost
             and cut sums by `segsum_by_id`, the cut partials folded back
             onto their owned slots;
  table      the whole local table fits a block's shared memory
             (SMEM_TABLE_BYTES): kernels 1, 2 (3 folded in), or unfused 14,
             7, 6, 3;
  rows       otherwise: expanded operands, kernels 14, 5, 4, 3.

Every structure is stacked [P, ...] on one device, as the reference's
(which shards the leading axis over a device mesh), or [K, ...] on each
rank of a `torch.distributed` group (`distribute(..., comm=DistComm)`);
one sweep launches each kernel once per held partition, the multi-device
program's per-rank step, and runs the exchange batched over them through
the communicator (`halo.LocalComm` in one process).  Graphs the fast path does not take (several blocks, full
precision, no component model) stay on the generic halo path
(`prepare` returns None).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core.sweep import GBPConfig, VariableState, _kernel_params
from gbp_tpu_torch.core.sweep_cm import LANE, SUB, CMFactorState
from gbp_tpu_torch.gaussians import packed_identity_row
from gbp_tpu_torch.ops.comp_factors import COMP_FACTORS, comp_n_args
from gbp_tpu_torch.ops.messages import (
    ROW_SHAPES,
    SMEM_TABLE_BYTES,
    SMEM_WINDOW_BYTES,
    TABLE_SHAPES,
    TILE,
    expand_ell_blk,
    messages_cm,
    messages_cm_tab,
    messages_cm_tab_ell,
    messages_cm_tabblkg,
    messages_cm_tabblkg_ell,
    relin_cm,
    relin_cm_tab,
    relin_cm_tab_ell,
    relin_cm_tabblkg,
    relin_cm_tabblkg_ell,
    scatter_windows_cm,
    segment_ids,
    segsum_by_id,
    segsum_cm_blk,
    window_block_csr,
    window_rows_csr,
)
from gbp_tpu_torch.parallel import halo as halo_mod

GATHER_MODES = ("auto", "table", "rows")


class HaloCMGraph(NamedTuple):
    """Static per-partition CM factor data, stacked [P, ...]; the priors and
    the exchange wiring are the generic partition's."""

    vblocks: tuple  # owned priors per vblock [P, n_own_max, ...]
    comm: tuple  # HaloComm per vblock
    z: torch.Tensor  # [P, zdim, mp]
    prec: torch.Tensor  # [P, zdim (+1: per-row Huber thresholds), mp]
    args: torch.Tensor | None  # [P, n_args, mp] per-row factor arguments
    act: torch.Tensor  # [P, 1, mp] float; 0 = padded, clone or invalid row
    gidx: torch.Tensor  # [P, mp] int32 gathered-slot local ids (cut rows remapped)
    mp: int = 0
    nv: int = 0  # virtual ELL variables per partition, mp // deg
    deg: int = 0
    e: int = 0  # the ELL slot
    vb_e: int = 0
    vb_g: int = 0
    dofs: tuple = ()
    zdim: int = 0
    comp_name: str = ""
    n_args: int = 0
    huber: float | str | None = None
    n_loc_e: int = 0
    n_loc_g: int = 0
    gather_mode: str = "rows"  # "table" | "rows" (module docstring)
    ell_fused: bool = False
    # table and rows modes: every valid row by local gathered id (the
    # deterministic sum `segsum_by_id`); rows mode: the expanding gather.
    seg_rows: torch.Tensor | None = None  # [P, most valid rows of a partition] int32
    seg_offsets: torch.Tensor | None = None  # [P, n_loc_g + 1] int32
    seg_ids: torch.Tensor | None = None  # [P, mp] int32 per-row map (`segment_ids`)
    gidx_rm: torch.Tensor | None = None  # [P, mp] int64
    # Windows (win_w == 0: none).  Every owned id (< n_own_max) of tile i
    # lies in [win_starts[p, i], + win_w); the ghost table holds the
    # partition's ghosts (padded to win_ngp rows) then win_ncut duplicated
    # cut cameras (cut_ids, n_cut[p] of them real); gidx_ghost is the
    # reference's ghost-table id per row (win_ngp + win_ncut for window
    # rows).
    win_w: int = 0
    win_ngp: int = 0
    win_ncut: int = 0
    win_starts: torch.Tensor | None = None  # [P, n_tiles] int32
    gidx_ghost: torch.Tensor | None = None  # [P, mp] int32
    cut_ids: torch.Tensor | None = None  # [P, win_ncut] int64
    n_cut: tuple = ()
    gtab_idx: torch.Tensor | None = None  # [P, win_ngp + win_ncut] int64 rows of [local | 0]
    # The windowed sums' CSRs: owned rows by window column, the tiles that
    # meet each block of owned cameras, ghost and cut rows by ghost-table id.
    win_rows: torch.Tensor | None = None  # [P, mp] int32
    win_offsets: torch.Tensor | None = None  # [P, n_tiles * win_w + 1] int32
    blk_tiles: torch.Tensor | None = None  # [P, max nnz] int32 (`window_block_csr`)
    blk_offsets: torch.Tensor | None = None  # [P, ceil(n_own_max / SCATTER_CAMS) + 1] int32
    ext_rows: torch.Tensor | None = None  # [P, most ghost and cut rows of a partition] int32
    ext_offsets: torch.Tensor | None = None  # [P, win_ngp + win_ncut + 1] int32


class HaloCMState(NamedTuple):
    v: tuple  # owned VariableState per vblock [P, n_own_max, ...]
    ghost: tuple  # ghost VariableState per vblock [P, max(n_ghost_max, 1), ...]
    f: CMFactorState  # leaves [P, F, mp]


def _ceil(n: int, k: int) -> int:
    return (n + k - 1) // k * k


def _stack_i32(arrays, dev):
    """Per-partition int arrays of unequal length, zero-padded and stacked."""
    n = max(max(len(a) for a in arrays), 1)
    out = np.zeros((len(arrays), n), dtype=np.int32)
    for c, a in enumerate(arrays):
        out[c, :len(a)] = a
    return torch.tensor(out, device=dev)


def _by_id_csr(ids: np.ndarray, keep: np.ndarray, n_seg: int, length: int):
    """(rows [length], offsets [n_seg + 1]) int32: the rows with keep,
    stably sorted by id (so ascending within each id), zero-padded to
    `length` entries that no segment reaches."""
    rows = np.zeros(length, dtype=np.int32)
    sel = np.flatnonzero(keep)
    rows[:sel.size] = sel[np.argsort(ids[sel], kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(ids[sel], minlength=n_seg))])
    return rows, offsets.astype(np.int32)


def prepare(hp: halo_mod.HaloProblem, segsum_exact: bool = True, gather_mode: str = "auto",
            window: bool = True, ell_fused: bool | None = None):
    """The per-partition ELL / CM layout of a HaloProblem: (HaloCMGraph,
    rows_global [P, mp] source-graph row of every CM row), or None for a
    graph the fast path does not take (several factor blocks, a block that
    is not 2-slot, no component-form model, full precision: the caller runs
    the generic halo sweep, as with the reference).

    The reference's rules: the ELL slot is the larger variable block; rows
    regroup per partition by local ELL id with empty groups forward-filled;
    windows over the owned range with the cut rows remapped into the ghost
    table's extension, where 2 (w + ngp + ncut) <= the padded local table.
    Where the reference tests its VMEM limit the port tests shared memory:
    windows also need w rows of the packed table within SMEM_WINDOW_BYTES,
    and without windows "table" needs the whole local table within
    SMEM_TABLE_BYTES, else "rows".  Wherever both reach "table" the
    windows, cut lists and remapped ids equal the reference's.  A BA graph
    with at least as many cameras as landmarks gathers the landmarks (slot 1
    at (6, 3, 2) or (9, 3, 2)); the gates then take the landmark table's
    width, 12 values a row.  A shape the kernels are not instantiated for
    raises NotImplementedError, as sweep_cm.prepare does.  segsum_exact is accepted for the reference's
    signature: the sums always run at full precision."""
    del segsum_exact
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got {gather_mode!r}")
    g = hp.src_graph
    if len(g.fblocks) != 1:
        return None
    fb = g.fblocks[0]
    name = getattr(fb.ftype, "name", None)
    entry = COMP_FACTORS.get(name)
    if (len(fb.dofs) != 2 or entry is None
            or (fb.ftype.residual_fn is not None and len(entry) < 3) or fb.prec.ndim != 2):
        return None
    n_parts = hp.n_chips
    hfb = hp.hgraph.fblocks[0]
    dev, dt = hfb.z.device, hfb.z.dtype
    m_loc = hfb.z.shape[1]
    zdim = fb.z.shape[-1]
    counts = [g.vblocks[v].count for v in fb.vblocks]
    e = 0 if counts[0] >= counts[1] else 1
    gs = 1 - e
    shape = (*fb.dofs, zdim)
    if shape not in TABLE_SHAPES or shape not in ROW_SHAPES:
        raise NotImplementedError(
            f"halo_cm.prepare: no kernel is instantiated for (d0, d1, z) = {shape}; the table "
            f"kernels have {TABLE_SHAPES}, either slot gathered")
    vb_e, vb_g = fb.vblocks[e], fb.vblocks[gs]
    c_e, c_g = hp.hgraph.comm[vb_e], hp.hgraph.comm[vb_g]
    n_loc_e = c_e.n_own_max + max(c_e.n_ghost_max, 1)
    n_loc_g = c_g.n_own_max + max(c_g.n_ghost_max, 1)

    adj_e = hfb.adj[e].cpu().numpy().astype(np.int64)
    adj_g = hfb.adj[gs].cpu().numpy()
    valid = hfb.valid.cpu().numpy()
    deg = 1
    for c in range(n_parts):
        ids = adj_e[c][valid[c]]
        if ids.size:
            deg = max(deg, int(np.bincount(ids).max()))
    nv = n_loc_e
    while (nv * deg) % TILE:
        nv += 1
    mp = nv * deg
    if mp > 6 * max(int(valid.sum(1).max()), 1) and mp - m_loc > 64 * TILE:
        return None

    # Per-partition reorder: row local_ell_id * deg + rank; empty and pad
    # groups clone the nearest previous non-empty group's first row, so
    # their gathered ids stay inside their neighbours' windows.
    src = np.zeros((n_parts, mp), dtype=np.int64)
    act = np.zeros((n_parts, mp))
    for c in range(n_parts):
        rows = np.flatnonzero(valid[c])
        ids = adj_e[c][rows]
        order = np.argsort(ids, kind="stable")
        rows, ids = rows[order], ids[order]
        degc = np.bincount(ids, minlength=nv)
        starts = np.concatenate([[0], np.cumsum(degc)])
        dest = ids * deg + np.arange(rows.size) - starts[ids]
        first = np.zeros(nv, dtype=np.int64)
        has = degc > 0
        first[has] = rows[starts[:-1][has]]
        if has.any() and not has.all():
            ff = np.maximum.accumulate(np.where(has, np.arange(nv), -1))
            ff[ff < 0] = np.flatnonzero(has)[0]
            first = first[ff]
        src[c] = np.repeat(first, deg)
        src[c, dest] = rows
        act[c, dest] = 1.0

    gidx = adj_g[np.arange(n_parts)[:, None], src].astype(np.int32)
    d_g = fb.dofs[gs]
    width = d_g + d_g * d_g
    itemsize = hfb.z.element_size()
    no_g, ng_g = c_g.n_own_max, max(c_g.n_ghost_max, 1)

    # Windows over the OWNED gathered range (the reference's rule and
    # layout; see the module docstring), tried in "auto" and "table".
    win = None
    if window and gather_mode in ("auto", "table"):
        nopad = _ceil(no_g, SUB)
        main = (np.arange(mp) // deg < c_e.n_own_max)[None, :]
        own = np.where(main & (gidx < no_g), gidx, -1).reshape(n_parts, -1, TILE)
        has_own = (own >= 0).any(-1)
        mins = np.where(has_own, np.where(own >= 0, own, no_g).min(-1), 0)
        maxs = np.where(has_own, own.max(-1), 0)
        w = (int((maxs - mins).max()) + 1 + SUB + LANE - 1) // LANE * LANE
        edge_own = (~main) & (gidx < no_g)
        cuts = [np.unique(gidx[c][edge_own[c]]) for c in range(n_parts)]
        ncut = max(len(x) for x in cuts)
        ncutp = _ceil(ncut, SUB) if ncut else 0
        ngp = _ceil(ng_g, LANE)
        if (2 * (w + ngp + ncutp) <= _ceil(n_loc_g, LANE)
                and w * width * itemsize <= SMEM_WINDOW_BYTES):
            starts = np.clip(mins, 0, max(nopad - w, 0)) // SUB * SUB
            if not (np.where(has_own, maxs, starts) < starts + w).all():
                raise AssertionError("a camera window does not cover its tile")
            win = (starts, w, ngp, max(ncutp, 1), cuts, edge_own)
    fits = n_loc_g * width * itemsize <= SMEM_TABLE_BYTES
    if gather_mode in ("auto", "table"):
        gather_mode = "table" if win is not None or fits else "rows"

    as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
    extra = {}
    if win is not None:
        starts, w, ngp, ncut_w, cuts, edge_own = win
        gidx = gidx.copy()
        cut_np = np.zeros((n_parts, ncut_w), dtype=np.int64)
        for c in range(n_parts):
            cut_np[c, :len(cuts[c])] = cuts[c]
            if len(cuts[c]):
                lut = np.full(no_g, -1, dtype=np.int64)
                lut[cuts[c]] = np.arange(len(cuts[c]))
                sel = edge_own[c]
                gidx[c][sel] = (no_g + ngp + lut[gidx[c][sel]]).astype(np.int32)
        n_gt = ngp + ncut_w
        gg = np.where(gidx >= no_g, gidx - no_g, n_gt).astype(np.int32)
        # The ghost table's rows as rows of [local table | one zero row]:
        # the ghosts, zero padding to ngp, the cut cameras.
        gt = np.full((n_parts, n_gt), n_loc_g, dtype=np.int64)
        gt[:, :n_loc_g - no_g] = np.arange(no_g, n_loc_g)
        gt[:, ngp:] = cut_np
        csr = [window_rows_csr(gidx[c], starts[c], w, n_own=no_g) for c in range(n_parts)]
        blk = [window_block_csr(starts[c], w, no_g) for c in range(n_parts)]
        # The ghost CSR lists only the ghost and cut rows, so its length tells
        # `segsum_by_id` that its segments are short.
        n_ext = max(int((gg < n_gt).sum(axis=1).max()), 1)
        ext = [_by_id_csr(gg[c], gg[c] < n_gt, n_gt, n_ext) for c in range(n_parts)]
        extra.update(
            win_w=int(w), win_ngp=int(ngp), win_ncut=int(ncut_w), win_starts=as_i32(starts),
            gidx_ghost=as_i32(gg), cut_ids=torch.tensor(cut_np, device=dev),
            n_cut=tuple(len(x) for x in cuts), gtab_idx=torch.tensor(gt, device=dev),
            win_rows=as_i32(np.stack([a for a, _ in csr])),
            win_offsets=as_i32(np.stack([b for _, b in csr])),
            blk_tiles=_stack_i32([a for a, _ in blk], dev),
            blk_offsets=as_i32(np.stack([b for _, b in blk])),
            ext_rows=as_i32(np.stack([a for a, _ in ext])),
            ext_offsets=as_i32(np.stack([b for _, b in ext])))
    else:
        # The valid rows by local gathered id (clones and padding carry zero
        # messages), zero-padded to the most valid rows of a partition.
        n_val = max(int((act > 0.5).sum(axis=1).max()), 1)
        seg = [_by_id_csr(gidx[c], act[c] > 0.5, n_loc_g, n_val) for c in range(n_parts)]
        extra.update(seg_rows=as_i32(np.stack([a for a, _ in seg])),
                     seg_offsets=as_i32(np.stack([b for _, b in seg])),
                     seg_ids=torch.stack([segment_ids(torch.from_numpy(a), torch.from_numpy(b),
                                                      mp) for a, b in seg]).to(dev))
        if gather_mode == "rows":
            extra["gidx_rm"] = torch.tensor(gidx, dtype=torch.int64, device=dev)
    fused = (True if ell_fused is None else bool(ell_fused)) and gather_mode == "table" and deg > 1

    src_t = torch.tensor(src, device=dev)
    reorder = lambda a: a[torch.arange(n_parts, device=dev)[:, None], src_t]  # [P, mp, ...]
    to_cm = lambda a: reorder(a).transpose(1, 2).contiguous()
    prec, huber = hfb.prec, fb.huber
    if fb.huber_arr is not None:
        # Per-factor thresholds ride as one more component of prec.
        prec = torch.cat([prec, hfb.huber_arr[..., None].to(dt)], dim=-1)
        huber = "row"
    n_args = comp_n_args(name)
    hcm = HaloCMGraph(
        vblocks=hp.hgraph.vblocks, comm=hp.hgraph.comm, z=to_cm(hfb.z), prec=to_cm(prec),
        args=None if n_args == 0 else to_cm(
            hfb.args.reshape(n_parts, m_loc, -1)[..., :n_args].to(dt)),
        act=torch.tensor(act, dtype=dt, device=dev)[:, None, :].contiguous(),
        gidx=as_i32(gidx), mp=mp, nv=nv, deg=deg, e=e, vb_e=vb_e, vb_g=vb_g, dofs=fb.dofs,
        zdim=zdim, comp_name=name, n_args=n_args, huber=huber, n_loc_e=n_loc_e,
        n_loc_g=n_loc_g, gather_mode=gather_mode, ell_fused=fused, **extra)
    rows_global = np.maximum(hp.fb_src_rows[0][np.arange(n_parts)[:, None], src], 0)
    return hcm, rows_global


def init_state(hp: halo_mod.HaloProblem, hcm: HaloCMGraph, rows_global: np.ndarray,
               means: tuple) -> HaloCMState:
    """Owned and ghost beliefs = priors; the CM factor state linearized at
    `means`, zero messages; for the held partitions (hcm and rows_global
    [K, mp] hold only those)."""
    fb = hp.src_graph.fblocks[0]
    n_parts, mp = hcm.z.shape[0], hcm.mp
    dev, dt = hcm.z.device, hcm.z.dtype
    rg = torch.tensor(rows_global, dtype=torch.int64, device=dev)
    x = torch.cat([means[vb].to(dev)[fb.adj[k].to(dev).long()[rg]]
                   for k, vb in enumerate(fb.vblocks)], dim=-1).to(dt)  # [P, mp, t]
    # The rows' measurements and arguments in CM row order (clone rows
    # copy their group's first row).
    flat = lambda a: None if a is None else a.reshape(n_parts * mp, *a.shape[2:])
    at_rows = lambda a: None if a is None else flat(a.to(dev)[rg])
    flat_fb = dataclasses.replace(fb, z=at_rows(fb.z), args=at_rows(fb.args))
    jac, r0 = sweep_mod.linearize_block(flat_fb, flat(x))
    to_cm = lambda a: a.reshape(n_parts, mp, -1).transpose(1, 2).contiguous()
    zeros = lambda f: torch.zeros((n_parts, f, mp), dtype=dt, device=dev)
    d0, d1 = hcm.dofs
    fstate = CMFactorState(lp=to_cm(x), jac=to_cm(jac), r0=to_cm(r0), srel=zeros(1),
                           msg_eta=(zeros(d0), zeros(d1)), msg_lam=(zeros(d0 * d0), zeros(d1 * d1)))
    v = tuple(VariableState(eta=hvb.prior_eta, lam=hvb.prior_lam, mean=m)
              for hvb, m in zip(hp.hgraph.vblocks, halo_mod.owned_means(hp, means)))
    return HaloCMState(v=v, ghost=halo_mod.ghost_states(hp, means), f=fstate)


def _pack_local(vs_own, vs_ghost, n_pad: int, d: int):
    """[owned | ghosts | identity padding] of one block, stacked over the
    partitions: (packed eta | lam [P, n_pad, d + d^2], means [P, n_pad, d])."""
    n_parts = vs_own.eta.shape[0]
    lam = lambda vs: vs.lam.reshape(n_parts, -1, d * d)
    tab = torch.cat([torch.cat([vs_own.eta, lam(vs_own)], -1),
                     torch.cat([vs_ghost.eta, lam(vs_ghost)], -1)], dim=1)
    mean = torch.cat([vs_own.mean, vs_ghost.mean], dim=1)
    n = tab.shape[1]
    if n_pad > n:
        row = packed_identity_row(d, dtype=tab.dtype, device=tab.device)
        tab = torch.cat([tab, row[:d + d * d].expand(n_parts, n_pad - n, -1)], dim=1)
        mean = torch.cat([mean, mean.new_zeros((n_parts, n_pad - n, d))], dim=1)
    return tab.contiguous(), mean.contiguous()


def expand_means(hcm: HaloCMGraph, state: HaloCMState) -> torch.Tensor:
    """Adjacent belief means per local factor row, CM [P, tdof, mp] (slot-0
    components first): what the halo schedules rate a factor's urgency by."""
    d_e, d_g = hcm.dofs[hcm.e], hcm.dofs[1 - hcm.e]
    n_parts = hcm.z.shape[0]
    _, me = _pack_local(state.v[hcm.vb_e], state.ghost[hcm.vb_e], hcm.nv, d_e)
    cm_e = me[:, :hcm.nv].transpose(1, 2)[:, :, :, None].expand(
        n_parts, d_e, hcm.nv, hcm.deg).reshape(n_parts, d_e, hcm.mp)
    _, mg = _pack_local(state.v[hcm.vb_g], state.ghost[hcm.vb_g], hcm.n_loc_g, d_g)
    local = hcm.gidx.long()
    if hcm.win_w:
        # Cut rows name the ghost table's extension: back to their owned ids.
        first_cut = hcm.comm[hcm.vb_g].n_own_max + hcm.win_ngp
        cut = halo_mod._take(hcm.gtab_idx[:, hcm.win_ngp:], (local - first_cut).clamp(min=0))
        local = torch.where(local >= first_cut, cut, local)
    cm_g = halo_mod._take(mg, local).transpose(1, 2)
    return torch.cat([cm_e, cm_g] if hcm.e == 0 else [cm_g, cm_e], dim=1)


def belief_tables(hcm: HaloCMGraph, state: HaloCMState):
    """The kernels' belief inputs, stacked over the partitions: (ELL slot's
    packed eta | lam [P, nv, d_e + d_e^2] and means [P, nv, d_e], the
    gathered slot's over the local universe [P, n_loc_g, ...] twice, and
    with windows its ghost tables [ghosts | zero padding | cut cameras]
    [P, win_ngp + win_ncut, ...] twice, else None, None)."""
    d_e, d_g = hcm.dofs[hcm.e], hcm.dofs[1 - hcm.e]
    tab_e, mean_e = _pack_local(state.v[hcm.vb_e], state.ghost[hcm.vb_e], hcm.nv, d_e)
    tab_g, mean_g = _pack_local(state.v[hcm.vb_g], state.ghost[hcm.vb_g], hcm.n_loc_g, d_g)
    if not hcm.win_w:
        return tab_e, mean_e, tab_g, mean_g, None, None
    ext = lambda t: halo_mod._take(torch.cat([t, t.new_zeros((t.shape[0], 1, t.shape[2]))], 1),
                                   hcm.gtab_idx)
    return tab_e, mean_e, tab_g, mean_g, ext(tab_g), ext(mean_g)


def _partition_sums(hcm: HaloCMGraph, p: int, me_g, ml_g) -> torch.Tensor:
    """Partition p's gathered-slot partial sums [d_g + d_g^2, n_loc_g] of its
    new gathered-slot messages (windowed modes; the table modes fold the sum
    into their kernels or call `segsum_by_id` themselves)."""
    no = hcm.comm[hcm.vb_g].n_own_max
    n_tiles = hcm.mp // TILE
    part = segsum_cm_blk(me_g, ml_g, hcm.win_rows[p], hcm.win_offsets[p], n_tiles=n_tiles,
                         w=hcm.win_w)
    sum_own = scatter_windows_cm(part, hcm.win_starts[p], hcm.blk_tiles[p], hcm.blk_offsets[p],
                                 n_seg=no)
    sum_ext = segsum_by_id(me_g, ml_g, hcm.ext_rows[p], hcm.ext_offsets[p])
    k = hcm.n_cut[p]
    if k:
        # The cut cameras' partials fold back onto their owned slots (a
        # partition's cut ids are distinct: a plain indexed add, one order).
        cut = hcm.cut_ids[p, :k]
        sum_own[:, cut] = sum_own[:, cut] + sum_ext[:, hcm.win_ngp:hcm.win_ngp + k]
    return torch.cat([sum_own, sum_ext[:, :hcm.n_loc_g - no]], dim=1)


def _sweep_cm_halo(hcm: HaloCMGraph, state: HaloCMState, cfg: GBPConfig, comm,
                   active: torch.Tensor | None = None, skip_exchange: bool = False) -> HaloCMState:
    """One synchronous sweep of every partition: each partition's kernels,
    then the ELL reshape-sum, the exchange and the owner updates batched
    over the partitions.

    active: optional factor mask [P, 1, mp] (or [P, mp]) for the halo
    schedules, composed with the validity mask as in sweep_cm.sweep."""
    n_parts = hcm.z.shape[0]
    d0, d1 = hcm.dofs
    d_e, d_g = hcm.dofs[hcm.e], hcm.dofs[1 - hcm.e]
    f_e, f_g = d_e + d_e * d_e, d_g + d_g * d_g
    gslot = 1 - hcm.e
    dt = state.f.r0.dtype
    act = hcm.act if active is None else hcm.act * active.to(dt).reshape(n_parts, 1, hcm.mp)
    params = _kernel_params(cfg, dt)
    tab_e, mean_e, tab_g, mean_g, gtab_g, gmean_g = belief_tables(hcm, state)
    no = hcm.comm[hcm.vb_g].n_own_max
    expand = not hcm.ell_fused
    huber = hcm.huber
    mkw = dict(huber=huber, gslot=gslot)
    rkw = dict(comp_name=hcm.comp_name, gslot=gslot)
    out, sums_g = [], []
    for p in range(n_parts):
        fs = CMFactorState(*(halo_mod._at(x, p) for x in state.f))
        fargs = None if hcm.args is None else hcm.args[p]
        msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
        state_r = (fs.lp, fs.jac, fs.r0, fs.srel, act[p])
        if expand:
            pk = torch.cat([tab_e[p], mean_e[p]], dim=1)
            cm_e = expand_ell_blk(pk, deg=hcm.deg)
            be_e, bl_e, x_e = cm_e[:d_e], cm_e[d_e:f_e], cm_e[f_e:]
        if hcm.gather_mode == "rows":
            cm_g = torch.cat([tab_g[p], mean_g[p]], dim=1)[hcm.gidx_rm[p]].T.contiguous()
            be_g, bl_g, x_g = cm_g[:d_g], cm_g[d_g:f_g], cm_g[f_g:]
            by = lambda a_g, a_e: (a_g, a_e) if gslot == 0 else (a_e, a_g)
            shape = dict(d0=d0, d1=d1, z=hcm.zdim)
            lp, jac, r0, srel = relin_cm(params, torch.cat(by(x_g, x_e)), hcm.z[p], fargs,
                                         *state_r, comp_name=hcm.comp_name, **shape)
            (be0, be1), (bl0, bl1) = by(be_g, be_e), by(bl_g, bl_e)
            o = messages_cm(params, jac, lp, r0, hcm.prec[p], srel, act[p], be0, bl0, be1,
                            bl1, *msgs, prec_full=False, huber=huber, **shape)
            s_g = segsum_by_id(o[2 * gslot], o[2 * gslot + 1], hcm.seg_rows[p],
                               hcm.seg_offsets[p])
        elif hcm.win_w:
            wkw = dict(win_w=hcm.win_w, n_own=no)
            if hcm.ell_fused:
                lp, jac, r0, srel = relin_cm_tabblkg_ell(
                    params, mean_g[p, :no], gmean_g[p], mean_e[p], hcm.gidx[p],
                    hcm.win_starts[p], hcm.z[p], *state_r, deg=hcm.deg, fargs=fargs, **wkw,
                    **rkw)
                o = messages_cm_tabblkg_ell(
                    params, tab_g[p, :no], gtab_g[p], tab_e[p], hcm.gidx[p], hcm.win_starts[p],
                    jac, lp, r0, hcm.prec[p], srel, act[p], *msgs, deg=hcm.deg, **wkw, **mkw)
            else:
                lp, jac, r0, srel = relin_cm_tabblkg(
                    params, x_e, mean_g[p, :no], gmean_g[p], hcm.gidx[p], hcm.win_starts[p],
                    hcm.z[p], fargs, *state_r, **wkw, **rkw)
                o = messages_cm_tabblkg(
                    params, jac, lp, r0, hcm.prec[p], srel, act[p], be_e, bl_e, tab_g[p, :no],
                    gtab_g[p], hcm.gidx[p], hcm.win_starts[p], *msgs, **wkw, **mkw)
            s_g = _partition_sums(hcm, p, o[2 * gslot], o[2 * gslot + 1])
        elif hcm.ell_fused:
            lp, jac, r0, srel = relin_cm_tab_ell(
                params, mean_g[p], mean_e[p], hcm.gidx[p], hcm.z[p], *state_r, deg=hcm.deg,
                fargs=fargs, **rkw)
            *o, s_g = messages_cm_tab_ell(
                params, tab_g[p], tab_e[p], hcm.gidx[p], jac, lp, r0, hcm.prec[p], srel, act[p],
                *msgs, hcm.seg_rows[p], hcm.seg_offsets[p], deg=hcm.deg, seg_ids=hcm.seg_ids[p],
                **mkw)
        else:
            lp, jac, r0, srel = relin_cm_tab(params, x_e, mean_g[p], hcm.gidx[p], hcm.z[p],
                                             fargs, *state_r, **rkw)
            o = messages_cm_tab(params, jac, lp, r0, hcm.prec[p], srel, act[p], be_e, bl_e,
                                tab_g[p], hcm.gidx[p], *msgs, **mkw)
            s_g = segsum_by_id(o[2 * gslot], o[2 * gslot + 1], hcm.seg_rows[p],
                               hcm.seg_offsets[p])
        out.append(CMFactorState(lp=lp, jac=jac, r0=r0, srel=srel, msg_eta=(o[0], o[2]),
                                 msg_lam=(o[1], o[3])))
        sums_g.append(s_g[:, :hcm.n_loc_g])
    fs = halo_mod._stack(out)

    # ELL slot: reshape-sum over the degree axis (clone and pad rows carry
    # zero messages), batched over the partitions.
    me_e, ml_e = fs.msg_eta[hcm.e], fs.msg_lam[hcm.e]
    sum_e = torch.cat([me_e.reshape(n_parts, d_e, hcm.nv, hcm.deg).sum(-1),
                       ml_e.reshape(n_parts, d_e * d_e, hcm.nv, hcm.deg).sum(-1)], dim=1)
    packed_e = sum_e[:, :, :hcm.n_loc_e].transpose(1, 2)
    packed_g = torch.stack(sums_g).transpose(1, 2)

    new_v, new_ghost = list(state.v), list(state.ghost)
    if hcm.vb_e == hcm.vb_g:
        # Same-block factors (pose graphs): both slots' partial sums land on
        # the one local universe; combine before the single exchange.
        new_v[hcm.vb_e], new_ghost[hcm.vb_e] = halo_mod.exchange_and_update(
            hcm.vblocks[hcm.vb_e], hcm.comm[hcm.vb_e], packed_e + packed_g,
            state.ghost[hcm.vb_e], comm, skip=skip_exchange)
        return HaloCMState(v=tuple(new_v), ghost=tuple(new_ghost), f=fs)
    for vb, pk in ((hcm.vb_e, packed_e), (hcm.vb_g, packed_g)):
        new_v[vb], new_ghost[vb] = halo_mod.exchange_and_update(
            hcm.vblocks[vb], hcm.comm[vb], pk, state.ghost[vb], comm, skip=skip_exchange)
    return HaloCMState(v=tuple(new_v), ghost=tuple(new_ghost), f=fs)


def make_run(hcm: HaloCMGraph, skip_exchange: bool = False, comm=None):
    """run(hcm, state, cfg, n_iters) over the partitions (default
    communicator: the single-process `halo.LocalComm`)."""
    comm = halo_mod.LocalComm(hcm.z.shape[0]) if comm is None else comm

    def run_halo_cm(hcm, state, cfg, n_iters):
        for _ in range(n_iters):
            state = _sweep_cm_halo(hcm, state, cfg, comm, skip_exchange=skip_exchange)
        return state

    return run_halo_cm


def _ell_order_keys(graph):
    """Partition-time locality ordering for the ELL slot: each ELL-slot
    variable keyed by its lowest adjacent gathered-slot GLOBAL id, so each
    partition's ELL groups see nearby cameras and its windows stay narrow
    (free: per-partition slot numbering is not user-visible)."""
    fb = graph.fblocks[0]
    if len(fb.dofs) != 2:
        return None
    counts = [graph.vblocks[v].count for v in fb.vblocks]
    e = 0 if counts[0] >= counts[1] else 1
    if fb.vblocks[e] == fb.vblocks[1 - e]:
        return None  # same-block pose graphs: the natural order is local
    key = np.full(counts[e], np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(key, fb.adj[e].cpu().numpy().astype(np.int64),
                  fb.adj[1 - e].cpu().numpy().astype(np.int64))
    return {fb.vblocks[e]: key}


def keep_parts(hcm: HaloCMGraph, rows_global: np.ndarray, parts: range):
    """The held partitions of a prepared graph: (hcm, rows_global) cut to
    `parts` along the partition axis (the layout decisions stay the ones
    made over all P partitions)."""
    lo, hi = parts.start, parts.stop
    hcm = halo_mod._rows(hcm, lo, hi)._replace(n_cut=hcm.n_cut[lo:hi])
    return hcm, rows_global[lo:hi]


def distribute(graph, means, n_parts: int, device=None, anchor_slot: int = 0,
               comm_mode: str = "auto", segsum_exact: bool = True, gather_mode: str = "auto",
               window: bool = True, ell_fused: bool | None = None, comm=None):
    """Partition + CM-prepare + place on `device` (None: the communicator's
    device, else the card): returns (hp, hcm, state, run_fn), or None when
    the graph is CM-ineligible.  The reference's `distribute` takes a device
    mesh.  comm=None: the P partitions share one device and exchange through
    `halo.LocalComm`; with a communicator (`multihost.DistComm`) every rank
    runs the same host-side partition and layout and keeps its own
    partitions."""
    device = resolve_device(device if device is not None else getattr(comm, "device", None))
    hp = halo_mod.partition(graph, n_parts, anchor_slot, comm_mode,
                            order_keys=_ell_order_keys(graph) if window else None)
    prepped = prepare(hp, segsum_exact=segsum_exact, gather_mode=gather_mode, window=window,
                      ell_fused=ell_fused)
    if prepped is None:
        return None
    hcm, rows_global = prepped
    if comm is not None:
        halo_mod.keep_parts(hp, comm)
        hcm, rows_global = keep_parts(hcm, rows_global, hp.parts)
    hp.hgraph = halo_mod.to_device(hp.hgraph, device)
    hcm = halo_mod.to_device(hcm, device)
    state = halo_mod.to_device(init_state(hp, hcm, rows_global, means), device)
    return hp, hcm, state, make_run(hcm, comm=comm)
