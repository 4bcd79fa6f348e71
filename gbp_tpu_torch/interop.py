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

from gbp_tpu_torch.core.graph import FactorBlock, Graph, VariableBlock
from gbp_tpu_torch.core.sweep import VariableState
from gbp_tpu_torch.core.sweep_cm import CMFactorState, CMState
from gbp_tpu_torch.factors.reprojection import FACTOR_TYPES

LANE = 128  # the reference's trailing component-major dim


def _t(a, device, dtype=None):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)


def graph_from_numpy(g, device=None) -> Graph:
    """The port's Graph from the reference's Graph / FactorBlock /
    VariableBlock with numpy leaves (priors, z, prec, adj, valid,
    huber_arr, and the static ell_slot, ell_deg, dofs, huber, n_valid)."""
    vblocks = tuple(
        VariableBlock(prior_eta=_t(vb.prior_eta, device), prior_lam=_t(vb.prior_lam, device),
                      name=vb.name)
        for vb in g.vblocks)
    fblocks = []
    for fb in g.fblocks:
        name = fb.ftype.name
        if name not in FACTOR_TYPES:
            raise NotImplementedError(f"factor type {name!r} is not ported yet (ROADMAP A7/A8)")
        fblocks.append(FactorBlock(
            adj=tuple(_t(a, device, torch.int32) for a in fb.adj),
            z=_t(fb.z, device),
            prec=_t(fb.prec, device),
            args=_t(fb.args, device),
            valid=_t(fb.valid, device),
            huber_arr=_t(fb.huber_arr, device),
            ftype=FACTOR_TYPES[name](),
            vblocks=tuple(fb.vblocks),
            dofs=tuple(fb.dofs),
            huber=fb.huber,
            name=fb.name,
            n_valid=fb.n_valid,
            ell_slot=fb.ell_slot,
            ell_deg=fb.ell_deg,
        ))
    return Graph(vblocks=vblocks, fblocks=tuple(fblocks))


def _cm_in(a, device):
    a = np.asarray(a)
    return torch.tensor(a.reshape(a.shape[0], -1), device=device)


def _cm_out(t):
    a = t.detach().cpu().numpy()
    return a.reshape(a.shape[0], -1, LANE)


def cm_state_from_numpy(st, device=None) -> CMState:
    """The port's CMState from the reference's CMState with numpy leaves:
    beliefs (v[i].eta, .lam, .mean) and factor state (f.lp, .jac, .r0,
    .srel, .msg_eta, .msg_lam as [F, T, 128])."""
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
