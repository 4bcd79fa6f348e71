"""Persistent component-major GBP sweeps: the single-GPU speed path.

Counterpart of the single-segment fast path of gbp_tpu/core/sweep_cm.py.
The whole factor state stays component-major, [F, mp] tensors, across
sweeps.  One slot of the one factor block is the ELL slot (`fb.ell_slot`:
row r belongs to variable r // deg; landmarks, or one end of a pose graph's
between factors), the other the gathered slot (cameras; the other end):
bundle adjustment has them on two variable blocks, a pose graph on one
(same-block factors: both tables come from the one block and its belief
update adds both slots' sums).  The text below says "camera" and "landmark"
for the gathered and the ELL slot.  How the camera (gathered) slot's beliefs
reach the kernels is the prepared graph's `gather_mode`:

  "table"  the kernels read the packed camera table themselves, whole from
           shared memory or, on large scenes with camera locality, their
           tile's window of it; the landmark (ELL) slot is read at
           row // deg.  Nothing is expanded in device memory.
  "rows"   both slots' beliefs are expanded to per-row operands [F, mp]
           (one wide-row gather pk[gidx] and a transpose of the gathered
           data for the cameras, a broadcast over the degree axis for the
           landmarks) and `relin_cm` / `messages_cm` read those; the camera
           sum is the standalone `segsum_by_id`.  For camera tables beyond
           shared memory on scenes whose windows do not engage.
  "take1"  as "rows" with the camera gather taken along the trailing axis
           of the transposed table (no transpose of gathered data).

`prepare(gather_mode="auto")` picks "table" where it can and "rows"
otherwise, and returns None for a graph the fast path does not take (the
caller then runs the generic sweep of core/sweep.py).  In "table" mode with
the ELL slot fused (`ell_fused`, the default at ELL degree > 1) one sweep is:

  1. pack the camera beliefs [n_cam, eta 6 | lam 36] and the landmark
     beliefs [nv, eta 3 | lam 9] (virtual padding landmarks get eta = 0,
     lam = I, mean = 0);
  2. `relin_cm_tab_ell`: masked relinearization, reading camera means by
     id and landmark means at row // deg;
  3. `messages_cm_tab_ell`: covariance-form messages, plus the camera-side
     sum of the new camera messages (`segsum_by_id`);
  4. belief updates (`update_beliefs`, one launch): landmarks summed over
     their rows, cameras from the segment sum, means by `scaled_sym_solve`'s
     closed forms.

Large scenes (city, venice): the packed camera table no longer fits one
block's shared memory, so `prepare(window=True)` gives every tile of
ROW_ALIGN rows a camera window [win_starts[i], win_starts[i] + win_w) that
holds all of the tile's camera ids, sorting the landmarks by their lowest
camera id first when the natural order is not local (the reference's
locality sort).  Steps 2 and 3 then run `relin_cm_tabblk_ell` and
`messages_cm_tabblk_ell`, whose blocks stage only their tile's window; the
camera sum comes as per-tile window partials (`segsum_cm_blk`) combined by
`scatter_windows_cm`.  With the sort the landmark beliefs and the factor
rows live in sorted order across sweeps (`vperm`, `rowperm`); `init_state`,
`from_gbp_state` and `to_gbp_state` apply and undo it at the boundaries.

Unfused (`prepare(ell_fused=False)`, and by itself at ELL degree 1, where
the reference does the same): the landmark slot's packed beliefs are
expanded to per-row operands by `expand_ell_blk`, `relin_cm_tab` and
`messages_cm_tab` read the cameras from the shared-memory table and the
landmarks from those operands, and the camera sum is the standalone
`segsum_by_id`.  With camera windows `relin_cm_tabblk` and
`messages_cm_tabblk` read the cameras from the tile's window instead, and
the camera sum is `segsum_cm_blk` then `scatter_windows_cm`.

Factor types whose model reads per-row arguments (the BAL model's
distortion [k1, k2]) carry them as one more resident operand, `args`
[n_args, mp], handed to every relinearization kernel.

The degree-class segmented layout (`prepare(segment=True)`, `prepare_seg`):
the ELL layout pads every landmark group to the largest degree, so the
factor block is cut into classes of landmark degrees, each padded only to
its own largest degree and run as a segment of its own through the same
fused kernels (windowed or with the whole camera table) at its degree.  The
state's factor part is then a tuple of CMFactorState, [F, mp] per class;
`init_state`, `sweep`, `run`, `to_gbp_state` and `from_gbp_state` take
either kind of graph.  A graph with more cameras than landmarks has the
cameras in the ELL slot and gathers the landmarks (gslot 1): the same
kernels, instantiated for it; read "camera" as the gathered slot's variable
throughout.

The reference's one-hot table dots and per-tile table stacks exist because
a TPU kernel has no lane-dynamic gather; an index read does their job here.
`mp`, `nv`, the windows and the row order are the reference's, so the state
converts row for row (interop.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import (
    FactorState,
    GBPConfig,
    GBPState,
    VariableState,
    _kernel_params,
    linearize_block,
)
from gbp_tpu_torch.gaussians import packed_identity_row
from gbp_tpu_torch.ops.comp_factors import COMP_FACTORS, comp_n_args
from gbp_tpu_torch.ops.messages import (
    ROW_SHAPES,
    SMEM_TABLE_BYTES,
    SMEM_WINDOW_BYTES,
    TABLE_SHAPES,
    TILE,
    belief_plain,
    ell_sum_plain,
    expand_ell_blk,
    messages_cm,
    messages_cm_tab,
    messages_cm_tab_ell,
    messages_cm_tabblk,
    messages_cm_tabblk_ell,
    relin_cm,
    relin_cm_tab,
    relin_cm_tab_ell,
    relin_cm_tabblk,
    relin_cm_tabblk_ell,
    scatter_windows_cm,
    segment_ids,
    segsum_by_id,
    segsum_cm_blk,
    update_beliefs,
    window_block_csr,
    window_rows_csr,
)
from gbp_tpu_torch.utils.profiling import span
from gbp_tpu_torch.utils.smalllinalg import scaled_sym_solve

# Rows are padded to a multiple of lcm(ROW_ALIGN, deg), the reference's
# grid tile (8 x 128 factors), so that state arrays convert row for row.
# It is also the window tile of the large-scene kernels.
ROW_ALIGN = TILE
# Without windows the whole packed camera table is staged in each block's
# (static) shared memory, SMEM_TABLE_BYTES; larger camera sets need windows
# or, where those do not engage, the expanded operands of gather_mode "rows".
GATHER_MODES = ("auto", "table", "rows", "take1")
# Window starts are multiples of SUB and widths multiples of LANE, as in the
# reference (its sublane and lane counts), so that both packages cut the
# same windows.
SUB = 8
LANE = 128


class CMFactorState(NamedTuple):
    """Factor state resident in component-major layout [F, mp]."""

    lp: torch.Tensor  # [t, mp] linearization point, t = d0 + d1
    jac: torch.Tensor  # [z * t, mp]
    r0: torch.Tensor  # [z, mp]
    srel: torch.Tensor  # [1, mp] float sweeps-since-relin
    msg_eta: tuple  # per slot [d_k, mp]
    msg_lam: tuple  # per slot [d_k * d_k, mp]


class CMState(NamedTuple):
    v: tuple  # tuple[VariableState], row-major as in GBPState
    f: CMFactorState


class CMGraph(NamedTuple):
    """Static per-graph data for the CM sweep (component-major, padded)."""

    base: Graph
    z: torch.Tensor  # [z, mp]
    # [z, mp] diagonal measurement precision, then the per-factor Huber
    # thresholds as one more component when the block has them (pad 1.0)
    prec: torch.Tensor
    act: torch.Tensor  # [1, mp] float; 0 = padded or invalid row
    gidx: torch.Tensor  # [mp] int32 gathered-slot (camera) id per row (edge-padded)
    seg_rows: torch.Tensor  # [mp] int32 rows sorted by camera id (stable)
    seg_offsets: torch.Tensor  # [n_cam + 1] int32 CSR offsets into seg_rows
    mp: int
    nv: int  # virtual ELL landmarks, mp // deg
    gather_mode: str = "table"  # "table" | "rows" | "take1" (module docstring)
    # "table" mode: the kernels read the ELL slot at row // deg themselves;
    # False: it is expanded first (`expand_ell_blk`), the unfused kernels.
    ell_fused: bool = True
    gidx_rm: torch.Tensor | None = None  # [mp] int64 ids for the expanding gather
    # Camera windows (win_w == 0: none, the whole table is staged).  Every
    # camera id of tile i (rows [i * ROW_ALIGN, (i + 1) * ROW_ALIGN)) lies
    # in [win_starts[i], win_starts[i] + win_w).
    win_w: int = 0
    win_ncpad: int = 0  # camera count padded to a multiple of SUB
    win_starts: torch.Tensor | None = None  # [n_tiles] int32, multiples of SUB
    win_rows: torch.Tensor | None = None  # [mp] int32: each tile's rows by window column
    win_offsets: torch.Tensor | None = None  # [n_tiles * win_w + 1] int32
    # The tiles meeting each block of SCATTER_CAMS cameras, ascending (the
    # kernel's walk of `scatter_windows_cm`).
    blk_tiles: torch.Tensor | None = None
    blk_offsets: torch.Tensor | None = None  # [ceil(n_cam / SCATTER_CAMS) + 1] int32
    # Locality sort (None when the natural order is local enough): the
    # landmark block of `base` carries its priors in sorted order and the
    # resident landmark beliefs live in sorted order.  vperm: sorted id ->
    # user id; vinv: user id -> sorted id; rowperm: CM row -> row of `fb`.
    # `fb` itself (adjacency, z, prec) stays in user order.
    vperm: torch.Tensor | None = None  # [n_lmk] int64
    vinv: torch.Tensor | None = None  # [n_lmk] int64
    rowperm: torch.Tensor | None = None  # [m] int64
    # Per-row factor arguments [n_args, mp] of models that read them
    # (`bal_reprojection_normalized`: k1, k2), in resident row order; None
    # for the others.
    args: torch.Tensor | None = None
    # [mp] int32: the CSR's per-row map, each row's camera id or -1 where the
    # CSR leaves the row out (`segment_ids`; kernel 2's fold reads it).
    seg_ids: torch.Tensor | None = None

    @property
    def fb(self):
        return self.base.fblocks[0]


def _fast_block(graph: Graph):
    """The one factor block the fast path takes, or None for a graph it
    declines (several factor blocks, a block that is not 2-slot or has no
    ELL slot, a factor type without a component-form model, full
    measurement precision).  A shape the table kernels are not instantiated
    for raises NotImplementedError."""
    if len(graph.fblocks) != 1:
        return None
    fb = graph.fblocks[0]
    entry = COMP_FACTORS.get(getattr(fb.ftype, "name", None))
    if (len(fb.dofs) != 2 or fb.ell_slot is None or entry is None
            or (fb.ftype.residual_fn is not None and len(entry) < 3) or fb.prec.ndim != 2):
        return None
    shape = (*fb.dofs, fb.z.shape[-1])
    if shape not in TABLE_SHAPES or shape not in ROW_SHAPES:
        raise NotImplementedError(
            f"sweep_cm.prepare: no kernel is instantiated for (d0, d1, z) = {shape}; the table "
            f"kernels have {TABLE_SHAPES}, either slot gathered")
    return fb


def _windows(gp: np.ndarray, n_cam: int, itemsize: int, width: int = 42):
    """Per-tile windows (starts, w, ncpad) of the edge-padded camera ids
    `gp`, or None when they are too wide to pay; `width` is the values of one
    packed belief row of the gathered slot (42 for a camera).  The
    reference's rule, so
    that both packages cut the same windows: the width covers the widest
    tile plus SUB of slack for the SUB-aligned starts, rounded up to LANE."""
    ncpad = ((n_cam + SUB - 1) // SUB) * SUB
    tiles = gp.reshape(-1, ROW_ALIGN)
    mins, maxs = tiles.min(1), tiles.max(1)
    w = (int((maxs - mins).max()) + 1 + SUB + LANE - 1) // LANE * LANE
    # Gate: the window must be at most half the table (the reference's
    # rule), and its packed beliefs must fit the shared memory one block can
    # ask for.  The latter replaces the reference's VMEM limits on the whole
    # table (4 MB and 6 MB), which are the TPU's: here only the window is
    # staged.
    if 2 * w > ncpad or w * width * itemsize > SMEM_WINDOW_BYTES:
        return None
    starts = np.maximum(np.minimum(mins, ncpad - w), 0) // SUB * SUB
    if not ((maxs < starts + w).all() and (mins >= starts).all()):
        raise AssertionError("a camera window does not cover its tile")
    return starts, w, ncpad


def _rows_by_id(gidx: np.ndarray, listed: np.ndarray, n_cam: int):
    """(seg_rows, seg_offsets) int32: the CSR of the rows r < listed.size
    with listed[r], by camera id gidx[r], in row order within a camera."""
    rows = np.flatnonzero(listed)
    seg_rows = rows[np.argsort(gidx[rows], kind="stable")].astype(np.int32)
    seg_offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(gidx[rows], minlength=n_cam))]).astype(np.int32)
    return seg_rows, seg_offsets


def prepare(graph: Graph, gather_mode: str = "auto", segsum_exact: bool = True,
            window: bool = True, ell_fused: bool | None = None,
            segment: bool = False) -> CMGraph | CMSegGraph | None:
    """Build the CM static data for `graph`, or None if the fast path does
    not take it: several factor blocks, a block that is not 2-slot or has no
    ELL slot, a factor type without a component-form model, full measurement
    precision, or degenerate ELL padding.  The caller then runs the generic
    sweep (core/sweep.py), as with the reference.

    Taken: one block of `reprojection_normalized`,
    `bal_reprojection_normalized` (per-row arguments [k1, k2]),
    `bal_reprojection_intrinsics` (9-dof cameras), `se2_between` or
    `se3_between` factors in ELL layout (cameras and landmarks grouped by
    landmark, or by camera on a graph with more cameras than landmarks, the
    landmarks then gathered; between factors by either end), diagonal
    precision, no Huber, a scalar threshold or per-factor thresholds, the
    two slots on two variable blocks or on one (pose graphs).  A shape the
    kernels are not instantiated for raises NotImplementedError.

    segment=True first tries the degree-class segmented layout
    (`prepare_seg`, window as given) and returns its CMSegGraph, which runs
    through the same init_state / sweep / run / to_gbp_state /
    from_gbp_state; where `prepare_seg` declines it falls back to the single
    segment below, as the reference does.

    gather_mode "auto" (and "table") picks "table" when the camera windows
    engage or the whole packed camera table fits a block's shared memory
    (SMEM_TABLE_BYTES: 1,024 SE(2) poses or landmarks, or 292 cameras or
    SE(3) poses in float32; the reference's rule is its 4 MB of VMEM), else
    "rows"; "rows" and "take1" force the expanded operands.  window=True
    gives every tile of rows a camera window when the graph has camera
    locality, in its
    natural landmark order or, with the slots on two blocks, after sorting
    the landmarks by their lowest camera id (see the module docstring); the
    windows, `vperm` and `rowperm` equal the reference's.  Windows exist in
    "table" mode only.

    ell_fused None fuses the ELL slot into the table kernels at ELL degree
    > 1 and takes the unfused kernels at degree 1 (the reference's rule,
    with windows tried at every degree, as there); False forces the unfused
    kernels, windowed or not.

    segsum_exact is accepted for the reference's signature and ignored: the
    camera-side sum always runs at full precision (the reference's bf16
    hi/lo split is a TPU matrix-unit device)."""
    del segsum_exact
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got {gather_mode!r}")
    fb = _fast_block(graph)
    if fb is None:
        return None
    if segment:
        sg = prepare_seg(graph, window=window)
        if sg is not None:
            return sg
    name = fb.ftype.name
    m, deg = fb.count, fb.ell_deg
    lcm = ROW_ALIGN * deg // math.gcd(ROW_ALIGN, deg)
    mp = ((m + lcm - 1) // lcm) * lcm
    # Reject only degenerate padding: a large relative blowup that is also
    # large in absolute rows.
    if mp > 4 * m and mp - m > 64 * ROW_ALIGN:
        return None
    e = fb.ell_slot
    g = 1 - e
    same_block = fb.vblocks[0] == fb.vblocks[1]
    n_cam = graph.vblocks[fb.vblocks[g]].count
    dt, dev = fb.z.dtype, fb.z.device
    pad = mp - m
    d_g = fb.dofs[g]
    width, itemsize = d_g + d_g * d_g, fb.z.element_size()

    gidx = np.asarray(fb.adj[g].cpu(), dtype=np.int32)
    # Padded rows carry zero messages, so any id in range is inert; the edge
    # value keeps them inside their tile's window.
    edge_pad = lambda a: np.pad(a, (0, pad), mode="edge") if pad else a
    win, rowperm, order = None, None, None
    fused = deg > 1 if ell_fused is None else bool(ell_fused)
    with span("sweep_cm.prepare.windows"):
        if gather_mode in ("auto", "table"):
            if window:
                win = _windows(edge_pad(gidx), n_cam, itemsize, width)
                if win is None and not same_block:
                    # The natural landmark order is not camera-local (random
                    # numbering: real BAL files, the corridor scenes): sort the
                    # ELL groups (blocks of `deg` rows) by their lowest camera
                    # id and try again.  Same-block graphs get windows in their
                    # natural order only (chain numbering is already local).
                    n_ell = m // deg
                    order = np.argsort(gidx.reshape(n_ell, deg).min(1), kind="stable")
                    rowperm = (order[:, None] * deg + np.arange(deg)).reshape(-1)
                    win = _windows(edge_pad(gidx[rowperm]), n_cam, itemsize, width)
                    if win is None:
                        rowperm = order = None
            fits = n_cam * width * itemsize <= SMEM_TABLE_BYTES
            gather_mode = "table" if win is not None or fits else "rows"

        as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
        as_i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)
        extra = {}
        if rowperm is not None:
            vb_l = graph.vblocks[fb.vblocks[e]]
            if m // deg != vb_l.count:
                raise AssertionError("the ELL layout does not cover every landmark")
            gidx = gidx[rowperm]
            vperm = as_i64(order)
            # The sort relabels the landmark block: its priors, and with them
            # the resident beliefs, live in sorted order, so a sweep pays
            # nothing for it.
            vblocks = list(graph.vblocks)
            vblocks[fb.vblocks[e]] = dataclasses.replace(
                vb_l, prior_eta=vb_l.prior_eta[vperm], prior_lam=vb_l.prior_lam[vperm])
            graph = dataclasses.replace(graph, vblocks=tuple(vblocks))
            extra.update(vperm=vperm, vinv=as_i64(np.argsort(order)), rowperm=as_i64(rowperm))
        gidx = edge_pad(gidx)
        if win is not None:
            starts, w, ncpad = win
            win_rows, win_offsets = window_rows_csr(gidx, starts, w)
            blk_tiles, blk_offsets = window_block_csr(starts, w, n_cam)
            extra.update(win_w=int(w), win_ncpad=int(ncpad), win_starts=as_i32(starts),
                         win_rows=as_i32(win_rows), win_offsets=as_i32(win_offsets),
                         blk_tiles=as_i32(blk_tiles), blk_offsets=as_i32(blk_offsets))

    # CSR of the valid rows by camera id, in row order (ascending within a
    # camera): the fixed summation order that makes the camera-side sum
    # deterministic.  Padded rows and the ELL layout's clones carry zero
    # messages, so leaving them out changes no value; kept, they would all
    # name the camera of their landmark's first row.
    valid = np.ones(m, dtype=bool) if fb.valid is None else fb.valid.cpu().numpy()
    seg_rows, seg_offsets = _rows_by_id(gidx, valid if rowperm is None else valid[rowperm], n_cam)
    seg_ids = segment_ids(torch.from_numpy(seg_rows), torch.from_numpy(seg_offsets), mp)
    act = torch.ones(m, dtype=dt, device=dev) if fb.valid is None else fb.valid.to(dt)
    rp = extra.get("rowperm")
    perm = lambda a: a if rp is None else a[rp]
    to_cm = lambda a, fill=0.0: F.pad(perm(a).T, (0, pad), value=fill).contiguous()
    # Per-factor Huber thresholds ride as one more component of prec; the pad
    # fill 1.0 keeps padded rows' weight finite (act masks them anyway).
    prec = fb.prec if fb.huber_arr is None else torch.cat(
        [fb.prec, fb.huber_arr[:, None].to(dt)], dim=1)
    n_args = comp_n_args(name)
    if n_args:
        extra["args"] = to_cm(fb.args.reshape(m, -1)[:, :n_args].to(dt))
    return CMGraph(
        base=graph,
        z=to_cm(fb.z),
        prec=to_cm(prec, fill=1.0),
        act=to_cm(act[:, None]),
        gidx=as_i32(gidx),
        seg_rows=as_i32(seg_rows),
        seg_offsets=as_i32(seg_offsets),
        seg_ids=seg_ids.to(dev),
        mp=mp,
        nv=mp // deg,
        gather_mode=gather_mode,
        ell_fused=fused and gather_mode == "table",
        gidx_rm=None if gather_mode == "table" else as_i64(gidx),
        **extra,
    )


def _rm2cm(cmg: CMGraph, a: torch.Tensor) -> torch.Tensor:
    """Rows of `fb` [m, F] -> resident [F, mp]: sorted by `rowperm` when the
    locality sort is on, zero rows appended."""
    if cmg.rowperm is not None:
        a = a[cmg.rowperm]
    return F.pad(a.T, (0, cmg.mp - a.shape[0])).contiguous()


def _sorted_landmarks(cmg: CMGraph | CMSegGraph, vstates, index) -> tuple:
    """`vstates` with the landmark block's tensors indexed by `index`
    (vperm: user -> sorted order, vinv: back); unchanged without the sort."""
    if index is None:
        return tuple(vstates)
    out = list(vstates)
    li = cmg.fb.vblocks[cmg.fb.ell_slot]
    out[li] = VariableState(*(t[index] for t in out[li]))
    return tuple(out)


def init_state(cmg: CMGraph | CMSegGraph, means: tuple) -> CMState:
    """Beliefs = priors, factors linearized at `means` (in user order), zero
    messages."""
    if isinstance(cmg, CMSegGraph):
        return init_state_seg(cmg, means)
    fb = cmg.fb
    # The factors are linearized with the user adjacency and user means;
    # their rows are sorted afterwards.  The beliefs take the sorted order
    # of the (relabelled) landmark priors.
    vmeans = list(means)
    if cmg.vperm is not None:
        li = fb.vblocks[fb.ell_slot]
        vmeans[li] = means[li][cmg.vperm]
    vstates = tuple(VariableState(eta=vb.prior_eta, lam=vb.prior_lam, mean=mu)
                    for vb, mu in zip(cmg.base.vblocks, vmeans))
    x = torch.cat([means[vb][fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)], dim=-1)
    jac, r0 = linearize_block(fb, x)
    zeros = lambda f: torch.zeros((f, cmg.mp), dtype=x.dtype, device=x.device)
    fstate = CMFactorState(
        lp=_rm2cm(cmg, x),
        jac=_rm2cm(cmg, jac.reshape(fb.count, -1)),
        r0=_rm2cm(cmg, r0),
        srel=zeros(1),
        msg_eta=tuple(zeros(d) for d in fb.dofs),
        msg_lam=tuple(zeros(d * d) for d in fb.dofs),
    )
    return CMState(v=vstates, f=fstate)


def _packed(vs: VariableState) -> torch.Tensor:
    """[n, d + d*d] packed (eta | lam) belief rows."""
    return torch.cat([vs.eta, vs.lam.reshape(vs.eta.shape[0], -1)], dim=1)


def _with_identity_rows(pk: torch.Tensor, d: int, n_pad: int) -> torch.Tensor:
    """Packed belief rows [n, f] (eta | lam | mean, or its first f values)
    with `n_pad` virtual padding variables appended: eta = 0, lam = I, mean =
    0, so the cavity inverses of padded rows stay finite."""
    if not n_pad:
        return pk
    row = packed_identity_row(d, dtype=pk.dtype, device=pk.device)[:pk.shape[1]]
    return torch.cat([pk, row.expand(n_pad, -1)])


def _slot_states(cmg: CMGraph, state: CMState):
    """(gathered slot's, ELL slot's) VariableState."""
    fb = cmg.fb
    return state.v[fb.vblocks[1 - fb.ell_slot]], state.v[fb.vblocks[fb.ell_slot]]


def belief_tables(cmg: CMGraph, state: CMState):
    """The fused table kernels' belief inputs: (cam_mean [n_cam, d_g],
    lmk_mean [nv, d_e], cam_tab [n_cam, d_g + d_g * d_g], lmk_tab [nv, d_e +
    d_e * d_e]) of the gathered and the ELL slot; on a same-block graph both
    pairs come from the one block.  Virtual
    ELL variables (ids >= the real count) carry eta = 0, lam = I, mean = 0."""
    fb = cmg.fb
    vs_c, vs_l = _slot_states(cmg, state)
    n_pad = cmg.nv - vs_l.eta.shape[0]
    lmk_tab = _with_identity_rows(_packed(vs_l), fb.dofs[fb.ell_slot], n_pad)
    lmk_mean = F.pad(vs_l.mean, (0, 0, 0, n_pad))
    return (vs_c.mean.contiguous(), lmk_mean.contiguous(), _packed(vs_c).contiguous(),
            lmk_tab.contiguous())


def _pack_beliefs(vs: VariableState) -> torch.Tensor:
    """[n, 2d + d*d] packed (eta | lam | mean) belief rows."""
    return torch.cat([_packed(vs), vs.mean], dim=1)


def _split(cm: torch.Tensor, d: int):
    """Packed components [2d + d*d, mp] -> (eta [d, mp], lam [d*d, mp], mean [d, mp])."""
    return cm[:d], cm[d:d + d * d], cm[d + d * d:]


def _expand_ell(cmg: CMGraph, vs: VariableState):
    """ELL-slot beliefs -> per-row operands [F, mp]: row r takes the packed
    (eta | lam | mean) row of variable r // deg, through `expand_ell_blk`.
    The reference calls its kernel only at degrees that do not divide its
    lane count and broadcasts in XLA otherwise; a GPU has no such alignment,
    so the kernel runs at every degree on the card (the broadcast is exactly
    its plain version, which CPU tensors take).  Virtual padding variables
    get (eta = 0, lam = I, mean = 0), so padded rows' cavity inverses stay
    finite."""
    d = vs.eta.shape[1]
    pk = _pack_beliefs(vs)  # locality-sorted order when cmg.vperm is set
    pk = _with_identity_rows(pk, d, cmg.nv - pk.shape[0])
    return _split(expand_ell_blk(pk.contiguous(), deg=cmg.fb.ell_deg), d)


def _expand_gather(cmg: CMGraph, vs: VariableState):
    """Gathered-slot beliefs -> per-row operands [F, mp] by one gather of the
    (small) packed table: wide rows then a transpose of the gathered data
    ("rows"), or a take along the trailing axis of the transposed table
    ("take1")."""
    pk = _pack_beliefs(vs)
    if cmg.gather_mode == "take1":
        cm = pk.T.index_select(1, cmg.gidx_rm)
    else:
        cm = pk[cmg.gidx_rm].T.contiguous()
    return _split(cm, vs.eta.shape[1])


def expand_means(cmg: CMGraph, state: CMState) -> torch.Tensor:
    """Adjacent belief means per factor in CM layout [tdof, mp] (slot-0
    components first), without the full belief expansion: what schedules
    need to rate a factor's urgency."""
    fb = cmg.fb
    vs_c, vs_l = _slot_states(cmg, state)
    me = F.pad(vs_l.mean, (0, 0, 0, cmg.nv - vs_l.mean.shape[0]))
    cm_l = me.T[:, :, None].expand(me.shape[1], cmg.nv, fb.ell_deg).reshape(me.shape[1], cmg.mp)
    cm_c = vs_c.mean.T.index_select(1, cmg.gidx.long())
    return torch.cat([cm_c, cm_l] if fb.ell_slot == 1 else [cm_l, cm_c])


def sweep(cmg: CMGraph | CMSegGraph, state: CMState, cfg: GBPConfig,
          active: torch.Tensor | None = None) -> CMState:
    """One synchronous GBP iteration on resident-CM state.

    active: optional factor mask in CM layout [1, mp] (or [mp]), in resident
    row order, for wildfire / priority schedules: inactive factors keep
    their previous messages and skip relinearization, which is what the
    kernels' `act` operand does, so the mask composes with the validity
    mask.  A segmented graph takes no mask (ValueError), as the reference's
    dispatcher asserts."""
    if isinstance(cmg, CMSegGraph):
        if active is not None:
            single_segment(cmg, "sweep(..., active=...)")
        return sweep_seg(cmg, state, cfg)
    fb = cmg.fb
    fs = state.f
    deg = fb.ell_deg
    dt = fs.r0.dtype
    params = _kernel_params(cfg, dt)
    act = cmg.act
    if active is not None:
        act = act * active.to(dt).reshape(1, cmg.mp)
    g = 1 - fb.ell_slot
    by_slot = lambda a_g, a_e: (a_g, a_e) if g == 0 else (a_e, a_g)
    n_cam = cmg.base.vblocks[fb.vblocks[g]].count
    vs_c, vs_l = _slot_states(cmg, state)
    model = fb.ftype.name
    # "row": per-factor thresholds, the last component of cmg.prec.
    huber = "row" if fb.huber_arr is not None else fb.huber
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    if cmg.gather_mode != "table":
        be_l, bl_l, mean_l = _expand_ell(cmg, vs_l)
        be_c, bl_c, mean_c = _expand_gather(cmg, vs_c)
        shape = dict(d0=fb.dofs[0], d1=fb.dofs[1], z=cmg.z.shape[0])
        lp, jac, r0, srel = relin_cm(
            params, torch.cat(by_slot(mean_c, mean_l)), cmg.z, cmg.args, fs.lp, fs.jac, fs.r0,
            fs.srel, act, comp_name=model, **shape)
        (be0, be1), (bl0, bl1) = by_slot(be_c, be_l), by_slot(bl_c, bl_l)
        out = messages_cm(
            params, jac, lp, r0, cmg.prec, srel, act, be0, bl0, be1, bl1, *msgs,
            prec_full=False, huber=huber, **shape)
        sum_c = segsum_by_id(out[2 * g], out[2 * g + 1], cmg.seg_rows, cmg.seg_offsets)
    elif not cmg.ell_fused and cmg.win_w:
        be_l, bl_l, mean_l = _expand_ell(cmg, vs_l)
        lp, jac, r0, srel = relin_cm_tabblk(
            params, mean_l, vs_c.mean.contiguous(), cmg.gidx, cmg.win_starts, cmg.z, cmg.args,
            fs.lp, fs.jac, fs.r0, fs.srel, act, win_w=cmg.win_w, comp_name=model, gslot=g)
        out = messages_cm_tabblk(
            params, jac, lp, r0, cmg.prec, srel, act, be_l, bl_l, _packed(vs_c).contiguous(),
            cmg.gidx, cmg.win_starts, *msgs, huber=huber, win_w=cmg.win_w, gslot=g)
        part = segsum_cm_blk(out[2 * g], out[2 * g + 1], cmg.win_rows, cmg.win_offsets,
                             n_tiles=cmg.mp // TILE, w=cmg.win_w)
        sum_c = scatter_windows_cm(part, cmg.win_starts, cmg.blk_tiles, cmg.blk_offsets,
                                   n_seg=n_cam)
    elif not cmg.ell_fused:
        be_l, bl_l, mean_l = _expand_ell(cmg, vs_l)
        lp, jac, r0, srel = relin_cm_tab(
            params, mean_l, vs_c.mean.contiguous(), cmg.gidx, cmg.z, cmg.args, fs.lp, fs.jac,
            fs.r0, fs.srel, act, comp_name=model, gslot=g)
        out = messages_cm_tab(
            params, jac, lp, r0, cmg.prec, srel, act, be_l, bl_l, _packed(vs_c).contiguous(),
            cmg.gidx, *msgs, huber=huber, gslot=g)
        sum_c = segsum_by_id(out[2 * g], out[2 * g + 1], cmg.seg_rows, cmg.seg_offsets)
    elif cmg.win_w:
        cam_mean, lmk_mean, cam_tab, lmk_tab = belief_tables(cmg, state)
        lp, jac, r0, srel = relin_cm_tabblk_ell(
            params, cam_mean, lmk_mean, cmg.gidx, cmg.win_starts, cmg.z, fs.lp, fs.jac,
            fs.r0, fs.srel, act, deg=deg, win_w=cmg.win_w, comp_name=model, gslot=g,
            fargs=cmg.args)
        *out, part = messages_cm_tabblk_ell(
            params, cam_tab, lmk_tab, cmg.gidx, cmg.win_starts, jac, lp, r0, cmg.prec,
            srel, act, *msgs, cmg.win_rows, cmg.win_offsets, deg=deg, huber=huber,
            win_w=cmg.win_w, gslot=g)
        sum_c = scatter_windows_cm(part, cmg.win_starts, cmg.blk_tiles, cmg.blk_offsets,
                                   n_seg=n_cam)
    else:
        cam_mean, lmk_mean, cam_tab, lmk_tab = belief_tables(cmg, state)
        lp, jac, r0, srel = relin_cm_tab_ell(
            params, cam_mean, lmk_mean, cmg.gidx, cmg.z, fs.lp, fs.jac, fs.r0,
            fs.srel, act, deg=deg, comp_name=model, gslot=g, fargs=cmg.args)
        *out, sum_c = messages_cm_tab_ell(
            params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, cmg.prec, srel,
            act, *msgs, cmg.seg_rows, cmg.seg_offsets, deg=deg, huber=huber, gslot=g,
            seg_ids=cmg.seg_ids)
    oe0, ol0, oe1, ol1 = out
    return _update_beliefs(cmg, state, CMFactorState(
        lp=lp, jac=jac, r0=r0, srel=srel, msg_eta=(oe0, oe1), msg_lam=(ol0, ol1)), sum_c)


def _update_beliefs(cmg: CMGraph, state: CMState, fs: CMFactorState,
                    sum_c: torch.Tensor) -> CMState:
    """Beliefs = priors + message sums: the ELL slot summed over each
    variable's `deg` rows, the gathered slot from `sum_c` [d_g + d_g * d_g,
    n_cam].  With the slots on two variable blocks both updates are one
    `update_beliefs` call (its kernel on the card); on one block (pose
    graphs) `_new_beliefs` adds both sums onto that block."""
    fb = cmg.fb
    e, g = fb.ell_slot, 1 - fb.ell_slot
    vb_l, vb_c = (cmg.base.vblocks[fb.vblocks[k]] for k in (e, g))
    # ELL slot: padded and clone rows carry zero messages, so the sum over
    # the degree axis is exact.  The beliefs live in the (possibly sorted)
    # group order, so the sum is already aligned.
    if fb.vblocks[e] == fb.vblocks[g]:
        sum_l = ell_sum_plain(fs.msg_eta[e], fs.msg_lam[e], cmg.nv, fb.ell_deg)[:, :vb_l.count]
        return CMState(v=_new_beliefs(cmg.base, state.v, sum_l, sum_c), f=fs)
    new_l, new_c = update_beliefs(fs.msg_eta[e], fs.msg_lam[e], sum_c, vb_l.prior_eta,
                                  vb_l.prior_lam, vb_c.prior_eta, vb_c.prior_lam,
                                  deg=fb.ell_deg)
    new_v = list(state.v)
    new_v[fb.vblocks[e]], new_v[fb.vblocks[g]] = VariableState(*new_l), VariableState(*new_c)
    return CMState(v=tuple(new_v), f=fs)


def _new_beliefs(base: Graph, vstates: tuple, sum_l: torch.Tensor, sum_c: torch.Tensor) -> tuple:
    """Beliefs = priors + message sums, means by `scaled_sym_solve`: sum_l
    [d_e + d_e * d_e, n] of the ELL slot's variables, sum_c of the gathered
    slot's.  With both slots on one variable block (pose graphs) the two
    sums land on that block: prior + ELL sum + gathered sum, one solve."""
    fb = base.fblocks[0]
    e = fb.ell_slot
    g = 1 - e
    d_l = fb.dofs[e]
    vb_c = base.vblocks[fb.vblocks[g]]
    vb_l = base.vblocks[fb.vblocks[e]]
    n_l = vb_l.count
    new_v = list(vstates)
    if fb.vblocks[e] == fb.vblocks[g]:
        eta = vb_l.prior_eta + sum_l[:d_l].T + sum_c[:d_l].T
        lam = (vb_l.prior_lam + sum_l[d_l:].T.reshape(n_l, d_l, d_l)
               + sum_c[d_l:].T.reshape(n_l, d_l, d_l))
        new_v[fb.vblocks[e]] = VariableState(eta=eta, lam=lam, mean=scaled_sym_solve(lam, eta))
        return tuple(new_v)
    for vi, vb, s in ((fb.vblocks[e], vb_l, sum_l), (fb.vblocks[g], vb_c, sum_c)):
        new_v[vi] = VariableState(*belief_plain(vb.prior_eta, vb.prior_lam, s))
    return tuple(new_v)


def run(cmg: CMGraph | CMSegGraph, state: CMState, cfg: GBPConfig, n_iters: int) -> CMState:
    """n_iters synchronous sweeps (either layout)."""
    for _ in range(n_iters):
        state = sweep(cmg, state, cfg)
    return state


def from_gbp_state(cmg: CMGraph | CMSegGraph, state: GBPState) -> CMState:
    """Resume a row-major GBPState (user order) in the CM layout.  Rows are
    sorted by `rowperm` and re-padded with zeros, which restores the
    invariants the sweep relies on: padded rows carry zero messages and
    act = 0 keeps them inert.  Landmark beliefs take the sorted order."""
    if isinstance(cmg, CMSegGraph):
        return from_gbp_state_seg(cmg, state)
    fb = cmg.fb
    m = fb.count
    fs = state.f[0]
    to_cm = lambda a: _rm2cm(cmg, a.reshape(m, -1))
    fstate = CMFactorState(
        lp=to_cm(fs.linpoint),
        jac=to_cm(fs.jac),
        r0=to_cm(fs.r0),
        srel=to_cm(fs.since_relin.to(fs.r0.dtype)),
        msg_eta=tuple(to_cm(me) for me in fs.msg_eta),
        msg_lam=tuple(to_cm(ml) for ml in fs.msg_lam),
    )
    return CMState(v=_sorted_landmarks(cmg, state.v, cmg.vperm), f=fstate)


def to_gbp_state(cmg: CMGraph | CMSegGraph, state: CMState) -> GBPState:
    """Convert to the row-major GBPState in user order (diagnostics,
    checkpoints, tests): factor rows and landmark beliefs are unsorted."""
    if isinstance(cmg, CMSegGraph):
        return to_gbp_state_seg(cmg, state)
    fb = cmg.fb
    m = fb.count
    fs = state.f
    inv = None if cmg.rowperm is None else torch.argsort(cmg.rowperm)
    row = (lambda a: a[:, :m].T) if inv is None else (lambda a: a[:, :m].T[inv])
    fstate = FactorState(
        linpoint=row(fs.lp),
        jac=row(fs.jac).reshape(m, fb.z.shape[-1], fb.tdof),
        r0=row(fs.r0),
        msg_eta=tuple(row(me) for me in fs.msg_eta),
        msg_lam=tuple(row(ml).reshape(m, d, d) for ml, d in zip(fs.msg_lam, fb.dofs)),
        since_relin=row(fs.srel).reshape(m).to(torch.int32),
    )
    return GBPState(v=_sorted_landmarks(cmg, state.v, cmg.vinv), f=(fstate,))


# --- the degree-class segmented layout -------------------------------------------------
#
# The ELL layout pads every landmark group to the largest degree: on the city
# scene 451,584 rows hold 366,973 factors.  The segmented layout cuts the
# factor block into degree classes (contiguous ranges of landmark degrees,
# each padded to its own largest degree) and runs each class as its own
# segment through the same kernels at its own degree, camera windows and
# row count.  The landmark block is relabelled to (class, locality) order,
# as the single segment's locality sort does.  BA-class graphs only (the two
# slots on two variable blocks); schedule masks, the annealed runner and the
# halo paths stay on the single segment.


class CMSegPart(NamedTuple):
    """Static and per-row data of one degree class: n_groups landmark
    groups of `deg` rows in (class, locality) order, padded to mp rows (a
    multiple of lcm(ROW_ALIGN, deg)).  Static operands are edge-padded (the
    last row repeated, so padded rows keep finite math and their camera's
    window); act is 0 on padded rows and on the clones of groups below the
    class degree."""

    z: torch.Tensor  # [z, mp]
    prec: torch.Tensor  # [z, mp], then the per-factor Huber thresholds
    act: torch.Tensor  # [1, mp]
    gidx: torch.Tensor  # [mp] int32 camera (gathered-slot) id per row
    rows: torch.Tensor  # [mp] int64 row of `fb` per row
    deg: int
    mp: int
    nv: int  # mp // deg landmark slots; the first n_groups are the class's
    n_groups: int
    v0: int  # the class's first landmark in the relabelled order
    m: int  # n_groups * deg rows before the padding
    args: torch.Tensor | None = None  # [n_args, mp] per-row factor arguments
    # A windowed class runs kernels 11, 10, 16, 15 (as the single segment's
    # windows, `CMGraph.win_*`); an unwindowed one runs 1, 2, 3 with the
    # whole camera table and the CSR of its valid rows by camera id.
    win_w: int = 0
    win_starts: torch.Tensor | None = None  # [mp / TILE] int32
    win_rows: torch.Tensor | None = None
    win_offsets: torch.Tensor | None = None
    blk_tiles: torch.Tensor | None = None
    blk_offsets: torch.Tensor | None = None
    seg_rows: torch.Tensor | None = None
    seg_offsets: torch.Tensor | None = None
    seg_ids: torch.Tensor | None = None  # [mp] int32 (`CMGraph.seg_ids`)


class CMSegGraph(NamedTuple):
    """Static per-graph data of the degree-class segmented CM sweep."""

    base: Graph  # the landmark block's priors in (class, locality) order
    parts: tuple  # tuple[CMSegPart], classes in descending degree
    vperm: torch.Tensor  # [n_lmk] int64 relabelled id -> user id
    vinv: torch.Tensor  # [n_lmk] int64 user id -> relabelled id
    # Per row of `fb`, its row in the parts' rows laid end to end; clone rows
    # beyond their class degree name their group's first row.
    inv_map: torch.Tensor  # [fb.count] int64
    n_tab: int  # rows of the shared landmark tables: max over parts of v0 + nv

    @property
    def fb(self):
        return self.base.fblocks[0]

    @property
    def mp(self) -> int:
        """Rows over all segments."""
        return sum(p.mp for p in self.parts)


def single_segment(cmg, who: str) -> None:
    """Raise ValueError naming `who` for a CMSegGraph: schedule masks, the
    annealed runner and the CM schedules run on the single-segment layout
    only (the reference asserts for masks and fails on the others)."""
    if isinstance(cmg, CMSegGraph):
        raise ValueError(f"{who} runs on the single-segment layout: prepare the graph with "
                         "segment=False")


def _class_rows(groups: int, deg: int) -> int:
    """Rows of a class of `groups` groups of `deg` rows, padded to a
    multiple of lcm(ROW_ALIGN, deg)."""
    lcm = ROW_ALIGN * deg // math.gcd(ROW_ALIGN, deg)
    return -(-groups * deg // lcm) * lcm


# The reference's class-choice constants: each extra class costs MERGE_MIN_ROWS
# rows in the dynamic program, and the segmented layout must save MIN_SAVING
# of the single segment's rows.
MERGE_MIN_ROWS = 4 * ROW_ALIGN
MIN_SAVING = 0.03


def _degree_bounds(distinct, cnts, classes_mode: str) -> list:
    """Degree classes as index ranges (i, j) into the descending distinct
    degrees: "exact" one class per degree; "auto" the reference's dynamic
    program over contiguous ranges, each class costing its padded rows
    (`_class_rows` at max(degree, 2)) plus MERGE_MIN_ROWS."""
    k = len(distinct)
    if classes_mode == "exact":
        return [(i, i) for i in range(k)]
    if classes_mode != "auto":
        raise ValueError(f"classes_mode must be 'auto' or 'exact', got {classes_mode!r}")
    cost = lambda i, j: _class_rows(sum(cnts[i:j + 1]), max(int(distinct[i]), 2))
    best, choice = [0] * (k + 1), [0] * (k + 1)
    for j in range(k):
        b = None
        for i in range(j + 1):
            v = best[i] + cost(i, j) + MERGE_MIN_ROWS
            if b is None or v < b:
                b, choice[j + 1] = v, i
        best[j + 1] = b
    bounds, j = [], k
    while j > 0:
        bounds.append((choice[j], j - 1))
        j = choice[j]
    return bounds[::-1]


def prepare_seg(graph: Graph, window: bool = True,
                classes_mode: str = "auto") -> CMSegGraph | None:
    """Build the degree-class segmented CM data, or None where the layout
    does not apply or does not pay: the graph is not fast-path BA (one
    factor block on two variable blocks, every landmark group of the ELL
    layout non-empty, some clone rows), a single class, a pad-row saving
    below MIN_SAVING of the single segment's rows, or (auto mode) a class
    without camera windows.

    classes_mode "auto" chooses the classes by the reference's dynamic
    program over contiguous degree ranges (`_degree_bounds`); "exact" takes
    one class per distinct degree and skips both worth-it gates.  Within a
    class the landmark groups are sorted by their lowest camera id and every
    class tries camera windows through `_windows`, the single segment's rule
    with its shared-memory gate, so where both packages' gates pass the
    windows are the reference's.

    The reference declines in auto mode when a class has no windows because
    its unwindowed multi-segment sweep faults the TPU worker; the port has
    no such fault and keeps the decline only so that both packages return
    the same kind of graph for the same graph: classes_mode="exact" runs
    unwindowed classes.  An unwindowed class stages the whole camera table
    in shared memory, so where that table exceeds SMEM_TABLE_BYTES (in
    float64 from 147 cameras on) this returns None, as the reference does
    at its VMEM gate."""
    fb = _fast_block(graph)
    if fb is None or fb.vblocks[0] == fb.vblocks[1] or fb.valid is None:
        return None
    e = fb.ell_slot
    g = 1 - e
    d_max = fb.ell_deg
    n_l = graph.vblocks[fb.vblocks[e]].count
    if fb.count != n_l * d_max:
        return None
    n_cam = graph.vblocks[fb.vblocks[g]].count
    d_g = fb.dofs[g]
    width, itemsize = d_g + d_g * d_g, fb.z.element_size()
    valid = fb.valid.cpu().numpy().astype(bool)
    degv = valid.reshape(n_l, d_max).sum(1)
    if degv.min() < 1:
        return None
    gidx = np.asarray(fb.adj[g].cpu(), dtype=np.int32)

    distinct = np.unique(degv)[::-1]
    cnts = [int((degv == d).sum()) for d in distinct]
    bounds = _degree_bounds(distinct, cnts, classes_mode)
    if len(bounds) < 2:
        return None
    if classes_mode != "exact":
        rows_seg = sum(_class_rows(sum(cnts[i:j + 1]), max(int(distinct[i]), 2))
                       for i, j in bounds)
        if rows_seg > (1.0 - MIN_SAVING) * _class_rows(n_l, d_max):
            return None  # too few pad rows saved for the extra launches

    # The lowest camera id of each group's valid rows: the locality key.
    gmin = np.where(valid.reshape(n_l, d_max), gidx.reshape(n_l, d_max), 2**30).min(1)
    classes, inv_map = [], np.zeros(n_l * d_max, dtype=np.int64)
    v0 = base = 0
    for i, j in bounds:
        c = max(int(distinct[i]), 2)
        gids = np.flatnonzero(np.isin(degv, distinct[i:j + 1]))
        gids = gids[np.argsort(gmin[gids], kind="stable")]
        rows = (gids[:, None] * d_max + np.arange(c)).reshape(-1)
        m_s, mp_s = rows.size, _class_rows(gids.size, c)
        rows_p = np.pad(rows, (0, mp_s - m_s), mode="edge")
        # Real and in-class clone rows map to their own position; clones
        # beyond the class degree to their group's first row.
        pos = base + np.arange(m_s)
        inv_map[rows] = pos
        for r in range(c, d_max):
            inv_map[gids * d_max + r] = pos[::c]
        gseg = gidx[rows_p]
        classes.append(dict(deg=c, gids=gids, rows=rows_p, m=m_s, mp=mp_s, v0=v0, gidx=gseg,
                            act=np.where(np.arange(mp_s) < m_s, valid[rows_p], False),
                            win=_windows(gseg, n_cam, itemsize, width) if window else None))
        v0 += gids.size
        base += m_s
    if v0 != n_l:
        raise AssertionError("the degree classes do not cover every landmark")
    unwindowed = any(cl["win"] is None for cl in classes)
    if unwindowed and (classes_mode != "exact"
                       or n_cam * width * itemsize > SMEM_TABLE_BYTES):
        return None

    dt, dev = fb.z.dtype, fb.z.device
    as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
    as_i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)
    prec = fb.prec if fb.huber_arr is None else torch.cat(
        [fb.prec, fb.huber_arr[:, None].to(dt)], dim=1)
    n_args = comp_n_args(fb.ftype.name)
    parts = []
    for cl in classes:
        rows_t = as_i64(cl["rows"])
        to_cm = lambda a: a.reshape(fb.count, -1)[rows_t].T.contiguous()
        extra = {}
        if cl["win"] is not None:
            starts, w, _ = cl["win"]
            win_rows, win_offsets = window_rows_csr(cl["gidx"], starts, w)
            blk_tiles, blk_offsets = window_block_csr(starts, w, n_cam)
            extra.update(win_w=int(w), win_starts=as_i32(starts), win_rows=as_i32(win_rows),
                         win_offsets=as_i32(win_offsets),
                         blk_tiles=as_i32(blk_tiles), blk_offsets=as_i32(blk_offsets))
        else:
            seg_rows, seg_offsets = _rows_by_id(cl["gidx"], cl["act"], n_cam)
            extra.update(seg_rows=as_i32(seg_rows), seg_offsets=as_i32(seg_offsets),
                         seg_ids=segment_ids(torch.from_numpy(seg_rows),
                                             torch.from_numpy(seg_offsets), cl["mp"]).to(dev))
        if n_args:
            extra["args"] = to_cm(fb.args.reshape(fb.count, -1)[:, :n_args].to(dt))
        parts.append(CMSegPart(
            z=to_cm(fb.z), prec=to_cm(prec),
            act=torch.tensor(cl["act"], dtype=dt, device=dev)[None],
            gidx=as_i32(cl["gidx"]), rows=rows_t, deg=cl["deg"], mp=cl["mp"],
            nv=cl["mp"] // cl["deg"], n_groups=int(cl["gids"].size), v0=cl["v0"], m=cl["m"],
            **extra))

    perm = np.concatenate([cl["gids"] for cl in classes])
    vperm = as_i64(perm)
    # Relabel the landmark block to (class, locality) order: its priors, and
    # with them the resident beliefs, live in that order across sweeps.
    vblocks = list(graph.vblocks)
    vb_l = vblocks[fb.vblocks[e]]
    vblocks[fb.vblocks[e]] = dataclasses.replace(
        vb_l, prior_eta=vb_l.prior_eta[vperm], prior_lam=vb_l.prior_lam[vperm])
    return CMSegGraph(base=dataclasses.replace(graph, vblocks=tuple(vblocks)), parts=tuple(parts),
                      vperm=vperm, vinv=as_i64(np.argsort(perm)), inv_map=as_i64(inv_map),
                      n_tab=max(p.v0 + p.nv for p in parts))


def _seg_to_cm(part: CMSegPart, a: torch.Tensor) -> torch.Tensor:
    """Rows of `fb` [m, F] (or [m]) -> the class's resident [F, mp]: its m
    rows, zero rows appended (padded rows carry zero messages and inert
    factor state, as on the single segment)."""
    rows = a.reshape(a.shape[0], -1)[part.rows[:part.m]]
    return F.pad(rows.T, (0, part.mp - part.m)).contiguous()


def init_state_seg(sg: CMSegGraph, means: tuple) -> CMState:
    """`init_state` of a segmented graph: beliefs = priors (landmarks in the
    relabelled order), factors linearized at the user-order `means`, zero
    messages; the factor state a tuple of CMFactorState, [F, mp] per class."""
    fb = sg.fb
    vmeans = list(means)
    li = fb.vblocks[fb.ell_slot]
    vmeans[li] = means[li][sg.vperm]
    vstates = tuple(VariableState(eta=vb.prior_eta, lam=vb.prior_lam, mean=mu)
                    for vb, mu in zip(sg.base.vblocks, vmeans))
    x = torch.cat([means[vb][fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)], dim=-1)
    jac, r0 = linearize_block(fb, x)
    fstates = []
    for p in sg.parts:
        zeros = lambda f: torch.zeros((f, p.mp), dtype=x.dtype, device=x.device)
        fstates.append(CMFactorState(
            lp=_seg_to_cm(p, x), jac=_seg_to_cm(p, jac), r0=_seg_to_cm(p, r0), srel=zeros(1),
            msg_eta=tuple(zeros(d) for d in fb.dofs),
            msg_lam=tuple(zeros(d * d) for d in fb.dofs)))
    return CMState(v=vstates, f=tuple(fstates))


def sweep_seg(sg: CMSegGraph, state: CMState, cfg: GBPConfig) -> CMState:
    """One synchronous sweep of a segmented graph: each class runs the
    kernels at its own degree (windowed: relin_cm_tabblk_ell,
    messages_cm_tabblk_ell with segsum_cm_blk, scatter_windows_cm;
    unwindowed: relin_cm_tab_ell, messages_cm_tab_ell with segsum_by_id),
    then one belief update.  The classes read one landmark table: the
    landmarks in relabelled order, then identity rows (eta = 0, lam = I,
    mean = 0) up to n_tab, each class the rows [v0, v0 + nv) of it, so a
    class's padded groups read the next class's landmarks, inert under act
    = 0, as in the reference.  The camera sums add over the classes in
    order from zero; the landmark sums are each class's reshape-sum over its
    degree, laid end to end."""
    fb = sg.fb
    e = fb.ell_slot
    g = 1 - e
    d_c, d_l = fb.dofs[g], fb.dofs[e]
    dt = state.f[0].r0.dtype
    params = _kernel_params(cfg, dt)
    model = fb.ftype.name
    huber = "row" if fb.huber_arr is not None else fb.huber
    vs_c, vs_l = state.v[fb.vblocks[g]], state.v[fb.vblocks[e]]
    n_c = vs_c.eta.shape[0]
    n_pad = sg.n_tab - vs_l.eta.shape[0]
    cam_mean, cam_tab = vs_c.mean.contiguous(), _packed(vs_c).contiguous()
    lmk_tab = _with_identity_rows(_packed(vs_l), d_l, n_pad).contiguous()
    lmk_mean = F.pad(vs_l.mean, (0, 0, 0, n_pad)).contiguous()
    sum_c = torch.zeros((d_c + d_c * d_c, n_c), dtype=dt, device=cam_tab.device)
    new_f, sums_l = [], []
    for p, fs in zip(sg.parts, state.f):
        lm, lt = lmk_mean[p.v0:p.v0 + p.nv], lmk_tab[p.v0:p.v0 + p.nv]
        msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
        if p.win_w:
            lp, jac, r0, srel = relin_cm_tabblk_ell(
                params, cam_mean, lm, p.gidx, p.win_starts, p.z, fs.lp, fs.jac, fs.r0, fs.srel,
                p.act, deg=p.deg, win_w=p.win_w, comp_name=model, gslot=g, fargs=p.args)
            *out, part = messages_cm_tabblk_ell(
                params, cam_tab, lt, p.gidx, p.win_starts, jac, lp, r0, p.prec, srel, p.act,
                *msgs, p.win_rows, p.win_offsets, deg=p.deg, huber=huber, win_w=p.win_w, gslot=g)
            s = scatter_windows_cm(part, p.win_starts, p.blk_tiles, p.blk_offsets, n_seg=n_c)
        else:
            lp, jac, r0, srel = relin_cm_tab_ell(
                params, cam_mean, lm, p.gidx, p.z, fs.lp, fs.jac, fs.r0, fs.srel, p.act,
                deg=p.deg, comp_name=model, gslot=g, fargs=p.args)
            *out, s = messages_cm_tab_ell(
                params, cam_tab, lt, p.gidx, jac, lp, r0, p.prec, srel, p.act, *msgs,
                p.seg_rows, p.seg_offsets, deg=p.deg, huber=huber, gslot=g, seg_ids=p.seg_ids)
        sum_c = sum_c + s
        oe0, ol0, oe1, ol1 = out
        new_f.append(CMFactorState(lp=lp, jac=jac, r0=r0, srel=srel, msg_eta=(oe0, oe1),
                                   msg_lam=(ol0, ol1)))
        sums_l.append(ell_sum_plain(out[2 * e], out[2 * e + 1], p.nv, p.deg)[:, :p.n_groups])
    return CMState(v=_new_beliefs(sg.base, state.v, torch.cat(sums_l, dim=1), sum_c),
                   f=tuple(new_f))


def to_gbp_state_seg(sg: CMSegGraph, state: CMState) -> GBPState:
    """`to_gbp_state` of a segmented graph: every row of `fb` takes its
    class row (`inv_map`; clones beyond their class degree their group's
    first row, which is what the ELL layout put there), except that
    messages are zero on invalid rows, as the layout keeps them; landmark
    beliefs back in user order."""
    fb = sg.fb
    m = fb.count
    cat = lambda get: torch.cat([get(fs)[:, :p.m].T for p, fs in zip(sg.parts, state.f)])[
        sg.inv_map]
    msg = lambda get: torch.where(fb.valid[:, None], cat(get), 0.0)
    fstate = FactorState(
        linpoint=cat(lambda fs: fs.lp),
        jac=cat(lambda fs: fs.jac).reshape(m, fb.z.shape[-1], fb.tdof),
        r0=cat(lambda fs: fs.r0),
        msg_eta=tuple(msg(lambda fs, k=k: fs.msg_eta[k]) for k in range(2)),
        msg_lam=tuple(msg(lambda fs, k=k: fs.msg_lam[k]).reshape(m, d, d)
                      for k, d in enumerate(fb.dofs)),
        since_relin=cat(lambda fs: fs.srel).reshape(m).to(torch.int32),
    )
    return GBPState(v=_sorted_landmarks(sg, state.v, sg.vinv), f=(fstate,))


def from_gbp_state_seg(sg: CMSegGraph, state: GBPState) -> CMState:
    """`from_gbp_state` of a segmented graph: each class takes its rows of
    `fb`, zero rows appended; landmark beliefs in the relabelled order."""
    fs = state.f[0]
    fstates = tuple(CMFactorState(
        lp=_seg_to_cm(p, fs.linpoint), jac=_seg_to_cm(p, fs.jac), r0=_seg_to_cm(p, fs.r0),
        srel=_seg_to_cm(p, fs.since_relin.to(fs.r0.dtype)),
        msg_eta=tuple(_seg_to_cm(p, me) for me in fs.msg_eta),
        msg_lam=tuple(_seg_to_cm(p, ml) for ml in fs.msg_lam)) for p in sg.parts)
    return CMState(v=_sorted_landmarks(sg, state.v, sg.vperm), f=fstates)
