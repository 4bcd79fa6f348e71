"""State carried across from the JAX reference, through numpy.

The functions take (or return) nested objects of numpy arrays: the JAX side
converts with `jax.tree.map(np.asarray, obj)`, which keeps the objects'
static fields (dofs, ell_deg, factor type, ...) and turns every array leaf
into numpy.  Nothing here imports JAX.

Component-major arrays are [F, mp/128, 128] in the reference and [F, mp]
here; the memory order is the same, so the conversion is a reshape.
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.graph import FactorBlock, Graph, Inbox, VariableBlock, adjacency_csr
from gbp_tpu_torch.core.sweep import FactorState, GBPState, VariableState
from gbp_tpu_torch.core.sweep_cm import CMFactorState, CMState
from gbp_tpu_torch.factors import linear
from gbp_tpu_torch.factors.reprojection import FACTOR_TYPES

LANE = 128  # the reference's trailing component-major dim


def _t(a, device, dtype=None):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)


def factor_type(name: str):
    """The port's FactorType for the reference's type `name`."""
    if name in FACTOR_TYPES:
        return FACTOR_TYPES[name]()
    for prefix, make in (("displacement", linear.displacement),
                         ("observation", linear.observation)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return make(int(name[len(prefix):]))
    raise NotImplementedError(f"factor type {name!r} is not ported yet (ROADMAP A7/A8)")


def graph_from_numpy(g, device=None) -> Graph:
    """The port's Graph from the reference's Graph / FactorBlock /
    VariableBlock / Inbox with numpy leaves: any number of blocks, priors,
    z, diagonal or full prec, adj, valid, huber_arr, inboxes, and the static
    ell_slot, ell_deg, dofs, huber, n_valid, on `device` (None: the card)."""
    device = resolve_device(device)
    vblocks = tuple(
        VariableBlock(prior_eta=_t(vb.prior_eta, device), prior_lam=_t(vb.prior_lam, device),
                      name=vb.name)
        for vb in g.vblocks)
    fblocks = []
    for fb in g.fblocks:
        fblocks.append(FactorBlock(
            adj=tuple(_t(a, device, torch.int32) for a in fb.adj),
            z=_t(fb.z, device),
            prec=_t(fb.prec, device),
            args=_t(fb.args, device),
            valid=_t(fb.valid, device),
            huber_arr=_t(fb.huber_arr, device),
            ftype=factor_type(fb.ftype.name),
            vblocks=tuple(fb.vblocks),
            dofs=tuple(fb.dofs),
            huber=fb.huber,
            name=fb.name,
            n_valid=fb.n_valid,
            ell_slot=fb.ell_slot,
            ell_deg=fb.ell_deg,
            csr=tuple(
                tuple(_t(a, device, torch.int32)
                      for a in adjacency_csr(adj, vblocks[vb].count))
                for adj, vb in zip(fb.adj, fb.vblocks)),
        ))
    inboxes = None
    if getattr(g, "inboxes", None) is not None:
        inboxes = tuple(
            None if specs is None else tuple(
                Inbox(idx=_t(sp.idx, device, torch.int32), mask=_t(sp.mask, device),
                      fi=sp.fi, slot=sp.slot) for sp in specs)
            for specs in g.inboxes)
    return Graph(vblocks=vblocks, fblocks=tuple(fblocks), inboxes=inboxes)


def gbp_state_from_numpy(st, device=None) -> GBPState:
    """The port's row-major GBPState (every variable and factor block) from
    the reference's GBPState with numpy leaves, on `device` (None: the
    card)."""
    device = resolve_device(device)
    return GBPState(
        v=tuple(VariableState(eta=_t(vs.eta, device), lam=_t(vs.lam, device),
                              mean=_t(vs.mean, device)) for vs in st.v),
        f=tuple(FactorState(
            linpoint=_t(fs.linpoint, device), jac=_t(fs.jac, device), r0=_t(fs.r0, device),
            msg_eta=tuple(_t(a, device) for a in fs.msg_eta),
            msg_lam=tuple(_t(a, device) for a in fs.msg_lam),
            since_relin=_t(fs.since_relin, device, torch.int32)) for fs in st.f),
    )


def gbp_state_to_numpy(state: GBPState) -> dict:
    """Nested dict of numpy arrays with the reference's field names:
    {"v": [{"eta", "lam", "mean"}, ...], "f": [{"linpoint", "jac", "r0",
    "msg_eta": (...), "msg_lam": (...), "since_relin"}, ...]}."""
    n = lambda t: t.detach().cpu().numpy()
    return {
        "v": [{k: n(getattr(vs, k)) for k in ("eta", "lam", "mean")} for vs in state.v],
        "f": [{"linpoint": n(fs.linpoint), "jac": n(fs.jac), "r0": n(fs.r0),
               "msg_eta": tuple(n(a) for a in fs.msg_eta),
               "msg_lam": tuple(n(a) for a in fs.msg_lam),
               "since_relin": n(fs.since_relin)} for fs in state.f],
    }


def _cm_in(a, device):
    a = np.asarray(a)
    return torch.tensor(a.reshape(a.shape[0], -1), device=device)


def _cm_out(t):
    a = t.detach().cpu().numpy()
    return a.reshape(a.shape[0], -1, LANE)


def cm_state_from_numpy(st, device=None) -> CMState:
    """The port's CMState from the reference's CMState with numpy leaves:
    beliefs (v[i].eta, .lam, .mean) and factor state (f.lp, .jac, .r0,
    .srel, .msg_eta, .msg_lam as [F, T, 128]), on `device` (None: the card).

    A CM state travels in its resident order, whatever the graph's
    gather mode ("table", "rows", "take1": the factor state is the same).  With camera windows the
    landmark beliefs and the factor rows live locality-sorted (`vperm`,
    `rowperm` of the CMGraph); both packages' `prepare` derive the same
    permutations from the same graph, so the state converts leaf for leaf
    and no permutation is applied here.  User order is restored by
    `to_gbp_state` on either side."""
    device = resolve_device(device)
    f = st.f
    return CMState(
        v=tuple(VariableState(eta=_t(vs.eta, device), lam=_t(vs.lam, device),
                              mean=_t(vs.mean, device)) for vs in st.v),
        f=CMFactorState(
            lp=_cm_in(f.lp, device), jac=_cm_in(f.jac, device), r0=_cm_in(f.r0, device),
            srel=_cm_in(f.srel, device),
            msg_eta=tuple(_cm_in(a, device) for a in f.msg_eta),
            msg_lam=tuple(_cm_in(a, device) for a in f.msg_lam),
        ),
    )


def cm_state_to_numpy(state: CMState) -> dict:
    """Nested dict of numpy arrays in the reference's layout:
    {"v": [{"eta", "lam", "mean"}, ...], "f": {"lp", "jac", "r0", "srel",
    "msg_eta": (...), "msg_lam": (...)}} with [F, T, 128] factor arrays."""
    f = state.f
    return {
        "v": [{k: getattr(vs, k).detach().cpu().numpy() for k in ("eta", "lam", "mean")}
              for vs in state.v],
        "f": {
            "lp": _cm_out(f.lp), "jac": _cm_out(f.jac), "r0": _cm_out(f.r0),
            "srel": _cm_out(f.srel),
            "msg_eta": tuple(_cm_out(a) for a in f.msg_eta),
            "msg_lam": tuple(_cm_out(a) for a in f.msg_lam),
        },
    }
