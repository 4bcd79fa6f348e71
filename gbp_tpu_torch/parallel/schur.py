"""Camera-block Schur-complement Gauss-Newton for bundle adjustment.

Counterpart of `gauss_newton_step` in gbp_tpu/parallel/schur.py: the MAP
target the GBP run is held against.  Landmarks are eliminated,

    S dc = r,   S = Hcc - Hcl Hll^-1 Hlc,   dl = Hll^-1 (bl - Hlc dc),

with S applied implicitly through two factor-indexed segment sums per
product and the reduced system solved by block-Jacobi-preconditioned CG.
Segment sums are `index_add_` (on a CUDA device their order of addition
varies from run to run; this is the reference solver, not the GBP path).
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.core.graph import Graph
from gbp_tpu_torch.core.sweep import huber_weight, linearize_block
from gbp_tpu_torch.utils.smalllinalg import bmm, bmv, bT, scaled_sym_inv


def _segment_sum(a, ids, n):
    return torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                       device=a.device).index_add_(0, ids, a)


def gauss_newton_step(graph: Graph, means: tuple, cg_iters: int = 50):
    """One Schur/CG Gauss-Newton step on a BA graph; returns new means tuple.

    graph: models/ba.build's output, one 2-slot reprojection block
    connecting cameras (variable block 0) and landmarks (block 1), with
    variable priors supplying the gauge."""
    cam_vi, lmk_vi = 0, 1
    fb = graph.fblocks[0]
    if fb.prec.ndim != 2:
        raise NotImplementedError("gauss_newton_step: full measurement precision (ROADMAP A8)")
    vb_c, vb_l = graph.vblocks[cam_vi], graph.vblocks[lmk_vi]
    d_c = vb_c.dof
    cam_ids, lmk_ids = fb.adj[0].long(), fb.adj[1].long()
    seg_c = lambda a: _segment_sum(a, cam_ids, vb_c.count)
    seg_l = lambda a: _segment_sum(a, lmk_ids, vb_l.count)

    x = torch.cat([means[cam_vi][cam_ids], means[lmk_vi][lmk_ids]], dim=-1)
    jac, r0 = linearize_block(fb, x)
    if fb.valid is not None:
        # Zero padded rows at the source: clones may hold non-finite values.
        jac = torch.where(fb.valid[:, None, None], jac, torch.zeros_like(jac))
        r0 = torch.where(fb.valid[:, None], r0, torch.zeros_like(r0))
    w = huber_weight(fb, r0)
    jw = jac * (fb.prec * w[:, None])[:, :, None]  # Lam_meas J (weighted)
    jc, jl = jac[:, :, :d_c], jac[:, :, d_c:]
    jwc, jwl = jw[:, :, :d_c], jw[:, :, d_c:]

    a_f = bmm(bT(jwc), jc)  # [m, dc, dc]
    b_f = bmm(bT(jwc), jl)  # [m, dc, dl]
    d_f = bmm(bT(jwl), jl)  # [m, dl, dl]
    hcc = seg_c(a_f) + vb_c.prior_lam
    hll = seg_l(d_f) + vb_l.prior_lam
    # Priors in Delta coordinates around the current means.
    bc = seg_c(bmv(bT(jwc), r0)) + (vb_c.prior_eta - bmv(vb_c.prior_lam, means[cam_vi]))
    bl = seg_l(bmv(bT(jwl), r0)) + (vb_l.prior_eta - bmv(vb_l.prior_lam, means[lmk_vi]))

    hll_inv = scaled_sym_inv(hll, vb_l.dof)
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
