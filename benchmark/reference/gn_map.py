"""The MAP estimate of a BA problem by damped Gauss-Newton (Levenberg-
Marquardt), in plain PyTorch and float64: the solve cell's target.

Written for the benchmark in place of the port's
`gbp_tpu_torch/parallel/schur.gauss_newton_step` (commit ad6c174), which the
program could change.  Each step linearizes every observation and prior at
the current estimate (the same additive [omega, t] camera parameters as the
factor model), adds lambda * diag(H) to the normal equations, eliminates the
landmarks (3 x 3 blocks), solves the dense camera system directly
(Cholesky) and back-substitutes.  A step is taken only where it lowers the
cost (lambda / 10 next), else lambda grows tenfold and the step is solved
again: from an initial estimate whose undamped step overshoots (a landmark
carried behind a camera), the Schur complement loses definiteness and plain
Gauss-Newton cannot go on.  The camera system is dense: n_cams * 6 dofs,
meant for scenes of some hundreds of cameras.
"""
from __future__ import annotations

import torch

from benchmark.reference.gbp import ROWS, Arith, Problem, are, project

LAMBDA0 = 1e-6
LAMBDA_MAX = 1e12
RTOL = 1e-12  # stop once a step lowers the cost by less than this share


def _prior(prior, x):
    """(cost, negative gradient, Hessian) of a diagonal prior
    0.5 (x - m)^T L (x - m), with eta = L m."""
    eta, lam = prior
    g = eta - torch.matmul(lam, x[..., None])[..., 0]  # -L (x - m)
    d = torch.linalg.solve(lam, -g[..., None])[..., 0]  # x - m
    return 0.5 * float((d * -g).sum()), g, lam


def cost(pb: Problem, cam: torch.Tensor, lmk: torch.Tensor) -> float:
    """0.5 * the squared Mahalanobis norm of every residual and prior."""
    ar = Arith("f64")
    total = _prior(pb.cam_prior, cam)[0] + _prior(pb.lmk_prior, lmk)[0]
    for s in range(0, pb.z.shape[0], ROWS):
        rows = slice(s, s + ROWS)
        h, _ = project(ar, torch.cat([cam[pb.cam[rows]], lmk[pb.lmk[rows]]], 1), with_jac=False)
        r = pb.z[rows].double() - h
        total += 0.5 * float((r * r * pb.prec[rows].double()).sum())
    return total


def _normal_equations(pb: Problem, cam: torch.Tensor, lmk: torch.Tensor):
    """(g_c, h_cc [n_c, 6, 6], g_l, h_ll [n_l, 3, 3], b [n_c, n_l, 6, 3]):
    the Gauss-Newton system's blocks, g the negative gradient."""
    ar = Arith("f64")
    n_c, n_l = cam.shape[0], lmk.shape[0]
    _, g_c, h_cc = _prior(pb.cam_prior, cam)
    _, g_l, h_ll = _prior(pb.lmk_prior, lmk)
    g_c, g_l, h_cc, h_ll = g_c.clone(), g_l.clone(), h_cc.clone(), h_ll.clone()
    b = torch.zeros((n_c, n_l, 6, 3), dtype=torch.float64, device=cam.device)
    for s in range(0, pb.z.shape[0], ROWS):
        rows = slice(s, s + ROWS)
        ci, li = pb.cam[rows], pb.lmk[rows]
        h, jac = project(ar, torch.cat([cam[ci], lmk[li]], 1))
        r = pb.z[rows].double() - h
        jw = jac * pb.prec[rows].double()[:, :, None]  # Lam_meas J
        jtj = torch.matmul(jac.transpose(1, 2), jw)  # [m, 9, 9]
        jtr = torch.matmul(jw.transpose(1, 2), r[:, :, None])[..., 0]
        g_c.index_add_(0, ci, jtr[:, :6])
        g_l.index_add_(0, li, jtr[:, 6:])
        h_ll.index_add_(0, li, jtj[:, 6:, 6:])
        h_cc.index_add_(0, ci, jtj[:, :6, :6])
        b.index_put_((ci, li), jtj[:, :6, 6:], accumulate=True)
    return g_c, h_cc, g_l, h_ll, b


def _damped_step(g_c, h_cc, g_l, h_ll, b, lam: float):
    """(dx_c [n_c, 6], dx_l [n_l, 3]) of the system with lam * diag(H)
    added, or None where the camera system is not positive definite."""
    n_c, n_l = g_c.shape[0], g_l.shape[0]
    damp = lambda h: h + lam * torch.diag_embed(torch.diagonal(h, dim1=-2, dim2=-1))
    h_ll_inv = torch.linalg.inv(damp(h_ll))  # [n_l, 3, 3]
    bb = b.permute(0, 2, 1, 3).reshape(6 * n_c, n_l, 3)
    c = torch.einsum("anj,njk->ank", bb, h_ll_inv)  # B H_ll^-1
    s_mat = torch.block_diag(*damp(h_cc)) - torch.einsum("ank,bnk->ab", c, bb)
    rhs = g_c.reshape(-1) - torch.einsum("ank,nk->a", c, g_l)
    chol, info = torch.linalg.cholesky_ex(s_mat)
    if int(info) != 0:
        return None
    dx_c = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    dx_l = torch.matmul(h_ll_inv, (g_l - torch.einsum("anj,a->nj", bb, dx_c))[..., None])[..., 0]
    return dx_c.reshape(n_c, 6), dx_l


def gauss_newton(pb: Problem, cam: torch.Tensor, lmk: torch.Tensor, steps: int = 50):
    """(camera means, landmark means, ARE in pixels) after at most `steps`
    accepted steps, or once a step lowers the cost by less than RTOL."""
    cam, lmk = cam.double().clone(), lmk.double().clone()
    f, lam = cost(pb, cam, lmk), LAMBDA0
    for _ in range(steps):
        system = _normal_equations(pb, cam, lmk)
        while lam <= LAMBDA_MAX:
            step = _damped_step(*system, lam)
            if step is not None:
                cam_new, lmk_new = cam + step[0], lmk + step[1]
                f_new = cost(pb, cam_new, lmk_new)
                if f_new < f:
                    break
            lam *= 10.0
        else:
            break  # no step lowers the cost: at the minimum to rounding
        done = (f - f_new) <= RTOL * f
        cam, lmk, f, lam = cam_new, lmk_new, f_new, max(lam / 10.0, LAMBDA0)
        if done:
            break
    return cam, lmk, are(pb, cam, lmk)
