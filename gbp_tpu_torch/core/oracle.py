"""Dense exact-MAP oracle for validation (counterpart of
gbp_tpu/core/oracle.py): assemble the full joint information form over all
variables from priors and (Huber-scaled, currently linearized) factor
potentials, and solve for the MAP mean.  On convergence GBP marginal means
match it: exactly for linear graphs, to the relinearization fixed point
otherwise.  Dense O(D^2) memory: a test path, not a fast one;
`torch.linalg.solve` / `inv` are the library calls the reference makes too.
"""
from __future__ import annotations

import dataclasses

import torch

from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import GBPState, factor_potential, huber_weight


def _voffsets(graph: Graph):
    offs, acc = [], 0
    for vb in graph.vblocks:
        offs.append(acc)
        acc += vb.count * vb.dof
    return offs, acc


def dense_joint(graph: Graph, state: GBPState):
    """Assemble (eta [D], lam [D, D]) of the full joint at current linpoints,
    in float64 whatever the graph's dtype: the priors and the factor
    potentials are computed and summed in float64, since the joint of a BA
    graph (cond(lam) ~ 1e8 at ladybug49) is noise at the pixel's thousandth
    in float32 and its sum changes with the order of the additions."""
    offs, dim = _voffsets(graph)
    dt, dev = torch.float64, state.v[0].mean.device
    eta = torch.zeros(dim, dtype=dt, device=dev)
    lam = torch.zeros((dim, dim), dtype=dt, device=dev)

    def add(idx, v_eta, v_lam):
        # idx [m, t] global dims; index_put_ with accumulate sums repeats.
        eta.index_put_((idx,), v_eta.to(dt), accumulate=True)
        lam.index_put_((idx[:, :, None], idx[:, None, :]), v_lam.to(dt), accumulate=True)

    for vi, vb in enumerate(graph.vblocks):
        n, d = vb.count, vb.dof
        add((offs[vi] + torch.arange(n * d, device=dev)).reshape(n, d), vb.prior_eta,
            vb.prior_lam)

    # Factor potentials (with the same Huber scaling the messages see).
    cast = lambda t: None if t is None else t.to(dt)
    for fi, fb in enumerate(graph.fblocks):
        fb = dataclasses.replace(fb, prec=cast(fb.prec), huber_arr=cast(fb.huber_arr))
        fs = state.f[fi]
        fs = fs._replace(jac=cast(fs.jac), linpoint=cast(fs.linpoint), r0=cast(fs.r0))
        w = huber_weight(fb, fs.r0)
        pot_eta, pot_lam = factor_potential(fb, fs)
        f_eta = pot_eta * w[:, None]
        f_lam = pot_lam * w[:, None, None]
        if fb.valid is not None:
            # Select (not scale): padded rows may hold non-finite values.
            f_eta = torch.where(fb.valid[:, None], f_eta, torch.zeros_like(f_eta))
            f_lam = torch.where(fb.valid[:, None, None], f_lam, torch.zeros_like(f_lam))
        gidx = torch.cat([
            offs[vb] + fb.adj[k].long()[:, None] * fb.dofs[k]
            + torch.arange(fb.dofs[k], device=dev)[None, :]
            for k, vb in enumerate(fb.vblocks)], dim=-1)
        add(gidx, f_eta, f_lam)
    return eta, lam


def _per_block(graph: Graph, fn):
    offs, _ = _voffsets(graph)
    return tuple(fn(offs[vi], vb.count, vb.dof) for vi, vb in enumerate(graph.vblocks))


def map_solution(graph: Graph, state: GBPState):
    """Dense MAP means, returned per variable block: tuple of [n, d].

    The joint is assembled and solved in float64 (`dense_joint`), and the
    result cast back to the graph's dtype."""
    eta, lam = dense_joint(graph, state)
    mu = torch.linalg.solve(lam, eta).to(state.v[0].mean.dtype)
    return _per_block(graph, lambda o, n, d: mu[o:o + n * d].reshape(n, d))


def marginal_covariances(graph: Graph, state: GBPState):
    """Exact per-variable marginal covariances (the joint assembled and
    inverted in float64, cast back to the graph's dtype), per block."""
    _, lam = dense_joint(graph, state)
    cov = torch.linalg.inv(lam).to(state.v[0].mean.dtype)

    def block(o, n, d):
        idx = (o + torch.arange(n * d, device=cov.device)).reshape(n, d)
        return cov[idx[:, :, None], idx[:, None, :]]

    return _per_block(graph, block)
