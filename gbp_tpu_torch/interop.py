"""State carried across from the JAX reference, through numpy.

The functions take (or return) nested objects of numpy arrays: the JAX side
converts with `jax.tree.map(np.asarray, obj)`, which keeps the objects'
static fields (dofs, ell_deg, factor type, ...) and turns every array leaf
into numpy.  Nothing here imports JAX.

Component-major arrays are [F, mp/128, 128] in the reference and [F, mp]
here; the memory order is the same, so the conversion is a reshape.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.graph import FactorBlock, Graph, Inbox, VariableBlock, adjacency_csr
from gbp_tpu_torch.core.schedules import CMScheduleState, ScheduleState
from gbp_tpu_torch.core.sweep import FactorState, GBPState, VariableState
from gbp_tpu_torch.core.sweep_cm import CMFactorState, CMState
from gbp_tpu_torch.factors import linear, odometry, se3
from gbp_tpu_torch.factors.reprojection import FACTOR_TYPES as BA_FACTOR_TYPES
from gbp_tpu_torch.models import online

FACTOR_TYPES = {
    **BA_FACTOR_TYPES,
    "se2_between": odometry.se2_between, "se2_prior": odometry.se2_prior,
    "se3_between": se3.se3_between, "se3_prior": se3.se3_prior,
}

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
    raise NotImplementedError(f"factor type {name!r} has no counterpart in gbp_tpu_torch")


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


def graph_to_numpy(graph: Graph):
    """The port's Graph as the same nested objects with numpy leaves that
    `graph_from_numpy` takes (what `jax.tree.map(np.asarray, g)` makes of
    the reference's): blocks of any dofs (9-dof BAL cameras), per-factor
    args, priors, z, prec, adj, valid, huber_arr and the static fields; the
    factor type travels by name."""
    n = lambda t: None if t is None else t.detach().cpu().numpy()
    ns = types.SimpleNamespace
    vblocks = tuple(ns(prior_eta=n(vb.prior_eta), prior_lam=n(vb.prior_lam), name=vb.name)
                    for vb in graph.vblocks)
    fblocks = tuple(ns(adj=tuple(n(a) for a in fb.adj), z=n(fb.z), prec=n(fb.prec),
                       args=n(fb.args), valid=n(fb.valid), huber_arr=n(fb.huber_arr),
                       ftype=ns(name=fb.ftype.name), vblocks=tuple(fb.vblocks),
                       dofs=tuple(fb.dofs), huber=fb.huber, name=fb.name, n_valid=fb.n_valid,
                       ell_slot=fb.ell_slot, ell_deg=fb.ell_deg)
                    for fb in graph.fblocks)
    inboxes = None
    if graph.inboxes is not None:
        inboxes = tuple(None if specs is None else tuple(
            ns(idx=n(sp.idx), mask=n(sp.mask), fi=sp.fi, slot=sp.slot) for sp in specs)
            for specs in graph.inboxes)
    return ns(vblocks=vblocks, fblocks=fblocks, inboxes=inboxes)


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
    `to_gbp_state` on either side.  A same-block (pose-graph) state has one
    variable block and converts the same way.  The state of a segmented
    graph (`sweep_cm.CMSegGraph`) has a tuple of factor states, one per
    degree class, [F, T_s, 128] each: it converts to a tuple of [F, mp_s]."""
    device = resolve_device(device)
    one = lambda f: CMFactorState(
        lp=_cm_in(f.lp, device), jac=_cm_in(f.jac, device), r0=_cm_in(f.r0, device),
        srel=_cm_in(f.srel, device),
        msg_eta=tuple(_cm_in(a, device) for a in f.msg_eta),
        msg_lam=tuple(_cm_in(a, device) for a in f.msg_lam))
    return CMState(
        v=tuple(VariableState(eta=_t(vs.eta, device), lam=_t(vs.lam, device),
                              mean=_t(vs.mean, device)) for vs in st.v),
        f=tuple(one(p) for p in st.f) if isinstance(st.f, (tuple, list)) else one(st.f),
    )


def cm_state_to_numpy(state: CMState) -> dict:
    """Nested dict of numpy arrays in the reference's layout:
    {"v": [{"eta", "lam", "mean"}, ...], "f": {"lp", "jac", "r0", "srel",
    "msg_eta": (...), "msg_lam": (...)}} with [F, T, 128] factor arrays;
    a segmented graph's state has "f" a tuple of such dicts, one per degree
    class."""
    one = lambda f: {
        "lp": _cm_out(f.lp), "jac": _cm_out(f.jac), "r0": _cm_out(f.r0),
        "srel": _cm_out(f.srel),
        "msg_eta": tuple(_cm_out(a) for a in f.msg_eta),
        "msg_lam": tuple(_cm_out(a) for a in f.msg_lam),
    }
    f = state.f
    return {
        "v": [{k: getattr(vs, k).detach().cpu().numpy() for k in ("eta", "lam", "mean")}
              for vs in state.v],
        "f": one(f) if isinstance(f, CMFactorState) else tuple(one(p) for p in f),
    }


def _vs_from(vs, device):
    return VariableState(eta=_t(vs.eta, device), lam=_t(vs.lam, device), mean=_t(vs.mean, device))


def _vs_to(vs) -> dict:
    return {k: getattr(vs, k).detach().cpu().numpy() for k in ("eta", "lam", "mean")}


def halo_state_from_numpy(st, device=None):
    """The port's HaloState (parallel/halo.py) from the reference's HaloState
    with numpy leaves: owned and ghost beliefs [P, n, ...] per variable
    block, factor state [P, m_loc, ...] per factor block, leaf for leaf, on
    `device` (None: the card)."""
    from gbp_tpu_torch.parallel.halo import HaloState

    device = resolve_device(device)
    f = gbp_state_from_numpy(types.SimpleNamespace(v=(), f=st.f), device).f
    return HaloState(v=tuple(_vs_from(vs, device) for vs in st.v),
                     ghost=tuple(_vs_from(vs, device) for vs in st.ghost), f=f)


def halo_state_to_numpy(state) -> dict:
    """{"v": [...], "ghost": [...], "f": [...]} with the reference's field
    names (as `gbp_state_to_numpy`), every array stacked [P, ...]."""
    d = gbp_state_to_numpy(GBPState(v=state.v, f=state.f))
    return {"v": d["v"], "ghost": [_vs_to(vs) for vs in state.ghost], "f": d["f"]}


def halo_cm_state_from_numpy(st, device=None):
    """The port's HaloCMState (parallel/halo_cm.py) from the reference's
    with numpy leaves: beliefs as in `halo_state_from_numpy`, factor state
    [P, F, T, 128] -> [P, F, mp]."""
    from gbp_tpu_torch.parallel.halo_cm import HaloCMState

    device = resolve_device(device)
    cm = lambda a: torch.tensor(np.asarray(a).reshape(np.shape(a)[0], np.shape(a)[1], -1),
                                device=device)
    f = st.f
    return HaloCMState(
        v=tuple(_vs_from(vs, device) for vs in st.v),
        ghost=tuple(_vs_from(vs, device) for vs in st.ghost),
        f=CMFactorState(lp=cm(f.lp), jac=cm(f.jac), r0=cm(f.r0), srel=cm(f.srel),
                        msg_eta=tuple(cm(a) for a in f.msg_eta),
                        msg_lam=tuple(cm(a) for a in f.msg_lam)))


def halo_cm_state_to_numpy(state) -> dict:
    """{"v", "ghost", "f": {"lp", "jac", "r0", "srel", "msg_eta", "msg_lam"}}
    in the reference's layout, factor arrays [P, F, T, 128]."""
    cm = lambda t: t.detach().cpu().numpy().reshape(t.shape[0], t.shape[1], -1, LANE)
    f = state.f
    return {"v": [_vs_to(vs) for vs in state.v], "ghost": [_vs_to(vs) for vs in state.ghost],
            "f": {"lp": cm(f.lp), "jac": cm(f.jac), "r0": cm(f.r0), "srel": cm(f.srel),
                  "msg_eta": tuple(cm(a) for a in f.msg_eta),
                  "msg_lam": tuple(cm(a) for a in f.msg_lam)}}


def schedule_state_from_numpy(st, device=None) -> ScheduleState:
    """The port's ScheduleState (core/schedules.py) from the reference's with
    numpy leaves: last_x per factor block [m, tdof], on `device` (None: the
    card)."""
    device = resolve_device(device)
    return ScheduleState(last_x=tuple(_t(a, device) for a in st.last_x))


def schedule_state_to_numpy(sched: ScheduleState) -> dict:
    """{"last_x": (...)} with a numpy [m, tdof] array per factor block."""
    return {"last_x": tuple(a.detach().cpu().numpy() for a in sched.last_x)}


def cm_schedule_state_from_numpy(st, device=None) -> CMScheduleState:
    """The port's CMScheduleState from the reference's with numpy leaves:
    last_x [tdof, T, 128] -> [tdof, mp], in resident row order."""
    return CMScheduleState(last_x=_cm_in(st.last_x, resolve_device(device)))


def cm_schedule_state_to_numpy(sched: CMScheduleState) -> dict:
    """{"last_x": [tdof, T, 128]} in the reference's layout."""
    return {"last_x": _cm_out(sched.last_x)}


def online_from_numpy(ob, device=None):
    """The port's OnlineBA (models/online.py) from the reference's OnlineBA
    with numpy leaves: graph (its CSRs built on the device from adj and
    valid, as the online model keeps them), state, the counts as 0-d int32
    tensors, the marginals and the static chunk and lmk_prior_prec, on
    `device` (None: the card)."""
    device = resolve_device(device)
    graph = graph_from_numpy(ob.graph, device)
    graph = dataclasses.replace(graph, fblocks=tuple(
        online._with_csr(fb, online._counts(graph)) for fb in graph.fblocks))
    return online.OnlineBA(
        graph=graph, state=gbp_state_from_numpy(ob.state, device),
        n_cams=_t(ob.n_cams, device, torch.int32), n_lmks=_t(ob.n_lmks, device, torch.int32),
        n_obs=_t(ob.n_obs, device, torch.int32),
        marg_eta=_t(ob.marg_eta, device), marg_lam=_t(ob.marg_lam, device),
        chunk=int(ob.chunk), lmk_prior_prec=float(ob.lmk_prior_prec))


def online_to_numpy(ob) -> dict:
    """{"graph", "state", "n_cams", "n_lmks", "n_obs", "marg_eta",
    "marg_lam", "chunk", "lmk_prior_prec"}: the graph as `graph_to_numpy`
    gives it, the state as `gbp_state_to_numpy`, the counts as Python ints."""
    n = lambda t: None if t is None else t.detach().cpu().numpy()
    return {"graph": graph_to_numpy(ob.graph), "state": gbp_state_to_numpy(ob.state),
            "n_cams": int(ob.n_cams), "n_lmks": int(ob.n_lmks), "n_obs": int(ob.n_obs),
            "marg_eta": n(ob.marg_eta), "marg_lam": n(ob.marg_lam), "chunk": ob.chunk,
            "lmk_prior_prec": ob.lmk_prior_prec}
