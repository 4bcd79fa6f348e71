"""Persistent component-major GBP sweeps: the single-GPU speed path.

Counterpart of the single-segment fast path of gbp_tpu/core/sweep_cm.py
(`prepare(graph, segsum_exact=True, window=False)` with the camera table in
the kernels and the ELL slot fused).  The whole factor state stays
component-major, [F, mp] tensors, across sweeps, so one sweep is:

  1. pack the camera beliefs [n_cam, eta 6 | lam 36] and the landmark
     beliefs [nv, eta 3 | lam 9] (virtual padding landmarks get eta = 0,
     lam = I, mean = 0);
  2. `relin_cm_tab_ell`: masked relinearization, reading camera means by
     id and landmark means at row // deg;
  3. `messages_cm_tab_ell`: covariance-form messages, plus the camera-side
     sum of the new camera messages (`segsum_by_id`);
  4. belief updates: landmarks by a reshape-sum over the degree axis,
     cameras from the segment sum, means by `scaled_sym_solve`.

The reference's camera windows, locality sort and one-hot table dots exist
because a TPU kernel has no lane-dynamic gather; an index read does their
job here.  `mp`, `nv` and the row order are the reference's, so the state
converts row for row (interop.py).
"""
from __future__ import annotations

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
from gbp_tpu_torch.ops.messages import (
    D0,
    D1,
    F_CAM,
    F_LMK,
    messages_cm_tab_ell,
    relin_cm_tab_ell,
)
from gbp_tpu_torch.utils.smalllinalg import scaled_sym_solve

# Rows are padded to a multiple of lcm(ROW_ALIGN, deg), the reference's
# grid tile (8 x 128 factors), so that state arrays convert row for row.
ROW_ALIGN = 1024
# The packed camera table is staged in each block's shared memory; larger
# camera sets need a global-memory table (ROADMAP A11).
SMEM_TABLE_BYTES = 48 * 1024


class CMFactorState(NamedTuple):
    """Factor state resident in component-major layout [F, mp]."""

    lp: torch.Tensor  # [9, mp] linearization point
    jac: torch.Tensor  # [18, mp]
    r0: torch.Tensor  # [2, mp]
    srel: torch.Tensor  # [1, mp] float sweeps-since-relin
    msg_eta: tuple  # per slot [d_k, mp]
    msg_lam: tuple  # per slot [d_k * d_k, mp]


class CMState(NamedTuple):
    v: tuple  # tuple[VariableState], row-major as in GBPState
    f: CMFactorState


class CMGraph(NamedTuple):
    """Static per-graph data for the CM sweep (component-major, padded)."""

    base: Graph
    z: torch.Tensor  # [2, mp]
    prec: torch.Tensor  # [2, mp] diagonal measurement precision (pad 1.0)
    act: torch.Tensor  # [1, mp] float; 0 = padded or invalid row
    gidx: torch.Tensor  # [mp] int32 camera id per row (edge-padded)
    seg_rows: torch.Tensor  # [mp] int32 rows sorted by camera id (stable)
    seg_offsets: torch.Tensor  # [n_cam + 1] int32 CSR offsets into seg_rows
    mp: int
    nv: int  # virtual ELL landmarks, mp // deg

    @property
    def fb(self):
        return self.base.fblocks[0]


def _unsupported(what: str, item: str):
    return NotImplementedError(f"sweep_cm.prepare: {what} is not ported yet (ROADMAP {item})")


def prepare(graph: Graph, segsum_exact: bool = True, segment: bool = False) -> CMGraph:
    """Build the CM static data for `graph`.

    Takes what the slice runs: one `reprojection_normalized` block in ELL
    layout grouped by landmark, diagonal precision, no Huber or a scalar
    Huber threshold, a camera table that fits shared memory.  Anything else
    raises NotImplementedError naming the ROADMAP item that ports it.

    segsum_exact is accepted for the reference's signature and ignored: the
    camera-side sum always runs at full precision (the reference's bf16
    hi/lo split is a TPU matrix-unit device)."""
    del segsum_exact
    if segment:
        raise _unsupported("the degree-class segmented layout", "A11")
    if len(graph.fblocks) != 1:
        raise _unsupported("a graph with several factor blocks (generic sweep)", "A4")
    fb = graph.fblocks[0]
    if fb.ftype is None or fb.ftype.name != "reprojection_normalized":
        raise _unsupported(f"factor type {getattr(fb.ftype, 'name', None)!r}", "A7/A8")
    if fb.huber_arr is not None:
        raise _unsupported("per-factor ('row') Huber thresholds", "A8")
    if fb.prec.ndim != 2:
        raise _unsupported("full measurement precision (prec.ndim != 2)", "A8")
    if fb.ell_slot != 1 or tuple(fb.dofs) != (D0, D1) or fb.vblocks[0] == fb.vblocks[1]:
        raise _unsupported("a layout other than cameras gathered, landmarks in ELL", "A7")
    m, deg = fb.count, fb.ell_deg
    lcm = ROW_ALIGN * deg // math.gcd(ROW_ALIGN, deg)
    mp = ((m + lcm - 1) // lcm) * lcm
    if mp > 4 * m and mp - m > 64 * ROW_ALIGN:
        raise _unsupported("an ELL layout with degenerate padding (generic sweep)", "A4")
    n_cam = graph.vblocks[fb.vblocks[0]].count
    dt, dev = fb.z.dtype, fb.z.device
    if n_cam * F_CAM * fb.z.element_size() > SMEM_TABLE_BYTES:
        raise _unsupported(f"a camera table of {n_cam} cameras beyond shared memory", "A11")
    pad = mp - m

    gidx = np.asarray(fb.adj[0].cpu(), dtype=np.int32)
    if pad:
        gidx = np.pad(gidx, (0, pad), mode="edge")
    # CSR of all rows by camera id, in row order: the fixed summation order
    # that makes the camera-side sum deterministic.  Padded rows carry zero
    # messages, so including them changes no value.
    seg_rows = np.argsort(gidx, kind="stable").astype(np.int32)
    seg_offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(gidx, minlength=n_cam))]).astype(np.int32)
    act = torch.ones(m, dtype=dt, device=dev) if fb.valid is None else fb.valid.to(dt)
    to_cm = lambda a, fill=0.0: F.pad(a.T, (0, pad), value=fill).contiguous()
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return CMGraph(
        base=graph,
        z=to_cm(fb.z),
        prec=to_cm(fb.prec, fill=1.0),
        act=to_cm(act[:, None]),
        gidx=as_i32(gidx),
        seg_rows=as_i32(seg_rows),
        seg_offsets=as_i32(seg_offsets),
        mp=mp,
        nv=mp // deg,
    )


def _rm2cm(a: torch.Tensor, mp: int) -> torch.Tensor:
    """[m, F] -> [F, mp], zero rows appended."""
    return F.pad(a.T, (0, mp - a.shape[0])).contiguous()


def init_state(cmg: CMGraph, means: tuple) -> CMState:
    """Beliefs = priors, factors linearized at `means`, zero messages."""
    fb = cmg.fb
    vstates = tuple(VariableState(eta=vb.prior_eta, lam=vb.prior_lam, mean=mu)
                    for vb, mu in zip(cmg.base.vblocks, means))
    x = torch.cat([means[vb][fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)], dim=-1)
    jac, r0 = linearize_block(fb, x)
    zeros = lambda f: torch.zeros((f, cmg.mp), dtype=x.dtype, device=x.device)
    fstate = CMFactorState(
        lp=_rm2cm(x, cmg.mp),
        jac=_rm2cm(jac.reshape(fb.count, -1), cmg.mp),
        r0=_rm2cm(r0, cmg.mp),
        srel=zeros(1),
        msg_eta=tuple(zeros(d) for d in fb.dofs),
        msg_lam=tuple(zeros(d * d) for d in fb.dofs),
    )
    return CMState(v=vstates, f=fstate)


def _packed(vs: VariableState) -> torch.Tensor:
    """[n, d + d*d] packed (eta | lam) belief rows."""
    return torch.cat([vs.eta, vs.lam.reshape(vs.eta.shape[0], -1)], dim=1)


def belief_tables(cmg: CMGraph, state: CMState):
    """The kernels' belief inputs: (cam_mean [n_cam, 6], lmk_mean [nv, 3],
    cam_tab [n_cam, 42], lmk_tab [nv, 12]).  Virtual landmarks (ids >= the
    real count) carry eta = 0, lam = I, mean = 0, so the cavity inverses of
    padded rows stay finite."""
    fb = cmg.fb
    vs_c, vs_l = state.v[fb.vblocks[0]], state.v[fb.vblocks[1]]
    n_pad = cmg.nv - vs_l.eta.shape[0]
    lmk_tab, lmk_mean = _packed(vs_l), vs_l.mean
    if n_pad:
        row = packed_identity_row(D1, dtype=lmk_tab.dtype, device=lmk_tab.device)
        lmk_tab = torch.cat([lmk_tab, row[:F_LMK].expand(n_pad, F_LMK)])
        lmk_mean = torch.cat([lmk_mean, row[F_LMK:].expand(n_pad, D1)])
    return (vs_c.mean.contiguous(), lmk_mean.contiguous(), _packed(vs_c).contiguous(),
            lmk_tab.contiguous())


def sweep(cmg: CMGraph, state: CMState, cfg: GBPConfig) -> CMState:
    """One synchronous GBP iteration on resident-CM state."""
    fb = cmg.fb
    fs = state.f
    deg = fb.ell_deg
    params = _kernel_params(cfg, fs.r0.dtype)
    cam_mean, lmk_mean, cam_tab, lmk_tab = belief_tables(cmg, state)
    lp, jac, r0, srel = relin_cm_tab_ell(
        params, cam_mean, lmk_mean, cmg.gidx, cmg.z, fs.lp, fs.jac, fs.r0,
        fs.srel, cmg.act, deg=deg)
    oe0, ol0, oe1, ol1, sum_c = messages_cm_tab_ell(
        params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, cmg.prec, srel,
        cmg.act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
        cmg.seg_rows, cmg.seg_offsets, deg=deg, huber=fb.huber)
    fs = CMFactorState(lp=lp, jac=jac, r0=r0, srel=srel, msg_eta=(oe0, oe1),
                       msg_lam=(ol0, ol1))

    # Landmarks: padded and clone rows carry zero messages, so the plain
    # reshape-sum over the degree axis is exact.
    vb_c = cmg.base.vblocks[fb.vblocks[0]]
    vb_l = cmg.base.vblocks[fb.vblocks[1]]
    n_c, n_l = vb_c.count, vb_l.count
    sum_l = torch.cat([oe1.reshape(D1, cmg.nv, deg).sum(-1),
                       ol1.reshape(D1 * D1, cmg.nv, deg).sum(-1)])[:, :n_l]
    new_v = list(state.v)
    for vi, vb, s, n, d in ((fb.vblocks[1], vb_l, sum_l, n_l, D1),
                            (fb.vblocks[0], vb_c, sum_c, n_c, D0)):
        eta = vb.prior_eta + s[:d].T
        lam = vb.prior_lam + s[d:].T.reshape(n, d, d)
        new_v[vi] = VariableState(eta=eta, lam=lam, mean=scaled_sym_solve(lam, eta))
    return CMState(v=tuple(new_v), f=fs)


def run(cmg: CMGraph, state: CMState, cfg: GBPConfig, n_iters: int) -> CMState:
    """n_iters synchronous sweeps."""
    for _ in range(n_iters):
        state = sweep(cmg, state, cfg)
    return state


def from_gbp_state(cmg: CMGraph, state: GBPState) -> CMState:
    """Resume a row-major GBPState in the CM layout.  Rows are re-padded
    with zeros, which restores the invariants the sweep relies on: padded
    rows carry zero messages and act = 0 keeps them inert."""
    fb = cmg.fb
    m = fb.count
    fs = state.f[0]
    to_cm = lambda a: _rm2cm(a.reshape(m, -1), cmg.mp)
    fstate = CMFactorState(
        lp=to_cm(fs.linpoint),
        jac=to_cm(fs.jac),
        r0=to_cm(fs.r0),
        srel=to_cm(fs.since_relin.to(fs.r0.dtype)),
        msg_eta=tuple(to_cm(me) for me in fs.msg_eta),
        msg_lam=tuple(to_cm(ml) for ml in fs.msg_lam),
    )
    return CMState(v=tuple(state.v), f=fstate)


def to_gbp_state(cmg: CMGraph, state: CMState) -> GBPState:
    """Convert to the row-major GBPState (diagnostics, checkpoints, tests)."""
    fb = cmg.fb
    m = fb.count
    fs = state.f
    row = lambda a: a[:, :m].T
    fstate = FactorState(
        linpoint=row(fs.lp),
        jac=row(fs.jac).reshape(m, fb.z.shape[-1], fb.tdof),
        r0=row(fs.r0),
        msg_eta=tuple(row(me) for me in fs.msg_eta),
        msg_lam=tuple(row(ml).reshape(m, d, d) for ml, d in zip(fs.msg_lam, fb.dofs)),
        since_relin=row(fs.srel).reshape(m).to(torch.int32),
    )
    return GBPState(v=tuple(state.v), f=(fstate,))
