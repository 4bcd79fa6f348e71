"""Gauss-Newton MAP targets: the camera-block Schur-complement step for
bundle adjustment and the full-system PCG step for pose graphs.

Counterpart of gbp_tpu/parallel/schur.py (`gauss_newton_step`, `solve`,
`gauss_newton_step_pcg`, `solve_pcg`): the MAP targets the GBP runs are held
against.  In the BA step landmarks are eliminated,

    S dc = r,   S = Hcc - Hcl Hll^-1 Hlc,   dl = Hll^-1 (bl - Hlc dc),

with S applied implicitly through two factor-indexed segment sums per
product and the reduced system solved by block-Jacobi-preconditioned CG.
Segment sums are `index_add_` (on a CUDA device their order of addition
varies from run to run; this is the reference solver, not the GBP path).

Sharded (`comm` given, the graph from `sharding.distribute`: each factor
block cut into contiguous row shards, the K held ones stacked along the
rows): every segment sum is per-shard partials and one `comm.all_reduce`,
and the priors are added once, after the reduction; the reduced system,
the CG vectors and their dot products are replicated.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import _apply_prec, huber_weight, linearize_block
from gbp_tpu_torch.utils.smalllinalg import bmm, bmv, bT, scaled_sym_inv


def _segment_sum(a, ids, n):
    return torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                       device=a.device).index_add_(0, ids, a)


def _sharded_sum(comm):
    """The segment sum of the Schur step: whole, or (comm given) per held
    shard, reduced over every shard through `comm`."""
    if comm is None:
        return _segment_sum
    k = len(comm.parts)

    def seg(a, ids, n):
        return comm.all_reduce(torch.stack([
            _segment_sum(x, i, n) for x, i in zip(a.chunk(k), ids.chunk(k))]))[0]

    return seg


def gauss_newton_step(graph: Graph, means: tuple, fi: int = 0, cam_vi: int = 0,
                      lmk_vi: int = 1, cg_iters: int = 50, lm_damping: float = 0.0,
                      comm=None):
    """One Schur/CG Gauss-Newton step on a BA graph; returns new means tuple.

    graph: 2-slot reprojection block `fi` connecting (cam_vi, lmk_vi), with
    variable priors supplying the gauge (models/ba.build's output); diagonal
    or full measurement precision.  lm_damping: optional
    Levenberg-Marquardt diagonal damping on Hcc / Hll.  comm: the
    communicator over the factor shards of a `sharding.distribute`d graph
    (None: the whole block here)."""
    fb = graph.fblocks[fi]
    vb_c, vb_l = graph.vblocks[cam_vi], graph.vblocks[lmk_vi]
    d_c, d_l = vb_c.dof, vb_l.dof
    cam_ids, lmk_ids = fb.adj[0].long(), fb.adj[1].long()
    seg = _sharded_sum(comm)
    seg_c = lambda a: seg(a, cam_ids, vb_c.count)
    seg_l = lambda a: seg(a, lmk_ids, vb_l.count)

    x = torch.cat([means[cam_vi][cam_ids], means[lmk_vi][lmk_ids]], dim=-1)
    jac, r0 = linearize_block(fb, x)
    if fb.valid is not None:
        # Zero padded rows at the source: clones may hold non-finite values.
        jac = torch.where(fb.valid[:, None, None], jac, torch.zeros_like(jac))
        r0 = torch.where(fb.valid[:, None], r0, torch.zeros_like(r0))
    w = huber_weight(fb, r0)
    if fb.prec.ndim == 2:
        jw = jac * (fb.prec * w[:, None])[:, :, None]  # Lam_meas J (weighted)
    else:
        jw = bmm(fb.prec, jac) * w[:, None, None]
    jc, jl = jac[:, :, :d_c], jac[:, :, d_c:]
    jwc, jwl = jw[:, :, :d_c], jw[:, :, d_c:]

    a_f = bmm(bT(jwc), jc)  # [m, dc, dc]
    b_f = bmm(bT(jwc), jl)  # [m, dc, dl]
    d_f = bmm(bT(jwl), jl)  # [m, dl, dl]
    hcc = seg_c(a_f) + vb_c.prior_lam
    hll = seg_l(d_f) + vb_l.prior_lam
    if lm_damping:
        hcc = hcc + lm_damping * torch.eye(d_c, dtype=hcc.dtype, device=hcc.device)
        hll = hll + lm_damping * torch.eye(d_l, dtype=hll.dtype, device=hll.device)
    # Priors in Delta coordinates around the current means.
    bc = seg_c(bmv(bT(jwc), r0)) + (vb_c.prior_eta - bmv(vb_c.prior_lam, means[cam_vi]))
    bl = seg_l(bmv(bT(jwl), r0)) + (vb_l.prior_eta - bmv(vb_l.prior_lam, means[lmk_vi]))

    hll_inv = scaled_sym_inv(hll, d_l)
    hcc_inv = scaled_sym_inv(hcc, d_c)  # block-Jacobi preconditioner

    def s_matvec(v):
        """S v = Hcc v - Hcl Hll^-1 Hlc v, via two factor reductions."""
        y = bmv(hll_inv, seg_l(bmv(bT(b_f), v[cam_ids])))
        return bmv(hcc, v) - seg_c(bmv(b_f, y[lmk_ids]))

    rhs = bc - seg_c(bmv(b_f, bmv(hll_inv, bl)[lmk_ids]))
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    dc = torch.zeros_like(rhs)
    r = rhs - s_matvec(dc)
    z = bmv(hcc_inv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        sp = s_matvec(p)
        denom = (p * sp).sum()
        alpha = torch.where(denom > 0, rz / denom, zero)
        dc = dc + alpha * p
        r = r - alpha * sp
        z = bmv(hcc_inv, r)
        rz_new = (r * z).sum()
        p = z + torch.where(rz > 0, rz_new / rz, zero) * p
        rz = rz_new

    dl = bmv(hll_inv, bl - seg_l(bmv(bT(b_f), dc[cam_ids])))
    new_means = list(means)
    new_means[cam_vi] = means[cam_vi] + dc
    new_means[lmk_vi] = means[lmk_vi] + dl
    return tuple(new_means)


def solve(graph: Graph, means: tuple, n_steps: int = 5, fi: int = 0, cam_vi: int = 0,
          lmk_vi: int = 1, cg_iters: int = 50, lm_damping: float = 0.0, comm=None):
    """n_steps Schur/CG Gauss-Newton iterations (relinearizing each step)."""
    for _ in range(n_steps):
        means = gauss_newton_step(graph, means, fi=fi, cam_vi=cam_vi, lmk_vi=lmk_vi,
                                  cg_iters=cg_iters, lm_damping=lm_damping, comm=comm)
    return means


def gauss_newton_step_pcg(graph: Graph, means: tuple, fi: int = 0, cg_iters: int = 100,
                          lm_damping: float = 0.0):
    """One Gauss-Newton step by block-Jacobi PCG on the FULL normal
    equations; returns the new means tuple.

    Works for any 2-slot factor block, in particular same-variable-block
    pose graphs, where the camera/landmark elimination above does not apply:
    the MAP target of the pose-graph runs.  Diagonal or full measurement
    precision; lm_damping adds Levenberg-Marquardt diagonal damping to H."""
    fb = graph.fblocks[fi]
    ids = [a.long() for a in fb.adj]
    x = torch.cat([means[vb][ids[k]] for k, vb in enumerate(fb.vblocks)], dim=-1)
    jac, r0 = linearize_block(fb, x)
    if fb.valid is not None:
        jac = torch.where(fb.valid[:, None, None], jac, torch.zeros_like(jac))
        r0 = torch.where(fb.valid[:, None], r0, torch.zeros_like(r0))
    w = huber_weight(fb, r0)
    wmul = lambda u: _apply_prec(fb.prec, u) * w[:, None]  # Lam_meas-weighted [m, z]
    js = [jac[:, :, o:o + d] for o, d in zip(fb.offsets, fb.dofs)]
    segs = [lambda a, k=k, vb=vb: _segment_sum(a, ids[k], graph.vblocks[vb].count)
            for k, vb in enumerate(fb.vblocks)]

    # rhs b = J^T W r0 + prior pull (per variable block, summed over slots).
    rhs = [vb.prior_eta - bmv(vb.prior_lam, mu) for vb, mu in zip(graph.vblocks, means)]
    wr = wmul(r0)
    for k, vb in enumerate(fb.vblocks):
        rhs[vb] = rhs[vb] + segs[k](bmv(bT(js[k]), wr))

    def h_matvec(v):
        u = sum(bmv(js[k], v[vb][ids[k]]) for k, vb in enumerate(fb.vblocks))
        wu = wmul(u)
        out = [bmv(vb.prior_lam, vk) + (lm_damping * vk if lm_damping else 0.0)
               for vb, vk in zip(graph.vblocks, v)]
        for k, vb in enumerate(fb.vblocks):
            out[vb] = out[vb] + segs[k](bmv(bT(js[k]), wu))
        return tuple(out)

    # Block-Jacobi preconditioner: per-variable diagonal blocks of H.
    pinv = []
    for vi, vb in enumerate(graph.vblocks):
        blk = vb.prior_lam
        if lm_damping:
            blk = blk + lm_damping * torch.eye(vb.dof, dtype=blk.dtype, device=blk.device)
        for k, tvb in enumerate(fb.vblocks):
            if tvb == vi:
                wjk = _apply_prec(fb.prec, js[k]) * w[:, None, None]
                blk = blk + segs[k](bmm(bT(wjk), js[k]))
        pinv.append(scaled_sym_inv(blk, vb.dof))

    tdot = lambda u, v: sum((a * b).sum() for a, b in zip(u, v))
    papply = lambda r: tuple(bmv(p, rk) for p, rk in zip(pinv, r))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    xk = tuple(torch.zeros_like(b) for b in rhs)
    r = tuple(b - h for b, h in zip(rhs, h_matvec(xk)))
    z = papply(r)
    p = z
    rz = tdot(r, z)
    for _ in range(cg_iters):
        hp = h_matvec(p)
        denom = tdot(p, hp)
        alpha = torch.where(denom > 0, rz / denom, zero)
        xk = tuple(a + alpha * b for a, b in zip(xk, p))
        r = tuple(a - alpha * b for a, b in zip(r, hp))
        z = papply(r)
        rz_new = tdot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        p = tuple(a + beta * b for a, b in zip(z, p))
        rz = rz_new
    return tuple(mu + d for mu, d in zip(means, xk))


def solve_pcg(graph: Graph, means: tuple, n_steps: int = 5, fi: int = 0, cg_iters: int = 100,
              lm_damping: float = 0.0):
    """n_steps full-system PCG Gauss-Newton iterations (relinearizing)."""
    for _ in range(n_steps):
        means = gauss_newton_step_pcg(graph, means, fi=fi, cg_iters=cg_iters,
                                      lm_damping=lm_damping)
    return means
