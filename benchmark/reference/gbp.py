"""The plain reference: bundle adjustment by synchronous GBP in plain
PyTorch, one row per observation, in the order the scene lists them.

Written for the benchmark from the algorithm the port documents
(`gbp_tpu_torch/core/sweep.py` at commit ad6c174: relinearize -> covariance-
form messages -> damping -> beliefs), with none of its layouts: no ELL rows,
no camera windows, no landmark sort, no packed tables and no kernels.  It
imports nothing of the program.  `precision` is "f64" (the reference), or
"tf32" (the control: float32 arithmetic with both operands of every product
rounded to TF32's 10-bit mantissa first, as a TF32 matrix unit reads them).

One sweep, per observation row (camera slot c, landmark slot l):
  1. relinearize where ||x - lp|| > beta and at least min_linear_iters sweeps
     have passed since the last time (x: the current belief means);
  2. per slot s, the cavity (belief minus the row's own old message, its
     precision floored by floor * diag(belief)), P_s = J_s Cov_s J_s^T,
     q_s = J_s (lp_s - mean_s); the message to slot a:
     S = Sigma + P_b, u = J_a lp_a + r0 + q_b, (J_a^T S^-1 u, J_a^T S^-1 J_a);
  3. eta damped by eta_damping once num_undamped_iters sweeps have passed
     since the row's last relinearization; precisions symmetrized;
  4. beliefs = priors + the sums of the messages, means = Lam^-1 eta.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ROWS = 1 << 20  # rows a block: bounds the reference's memory at any scene


class Problem(NamedTuple):
    """A BA problem as the reference holds it (observation order)."""

    z: torch.Tensor  # [m, 2] normalized image coordinates
    prec: torch.Tensor  # [m, 2] diagonal measurement precision
    cam: torch.Tensor  # [m] int64
    lmk: torch.Tensor  # [m] int64
    cam_prior: tuple  # (eta [nc, 6], lam [nc, 6, 6])
    lmk_prior: tuple  # (eta [nl, 3], lam [nl, 3, 3])
    k: np.ndarray  # [fx, fy, cx, cy]


class State(NamedTuple):
    """GBP state in observation order: the factors' part per row and the
    beliefs per variable."""

    lp: torch.Tensor  # [m, 9] linearization point
    jac: torch.Tensor  # [m, 2, 9]
    r0: torch.Tensor  # [m, 2]
    srel: torch.Tensor  # [m] sweeps since the last relinearization (float)
    msg_eta: tuple  # camera [m, 6], landmark [m, 3]
    msg_lam: tuple  # camera [m, 6, 6], landmark [m, 3, 3]
    eta: tuple  # beliefs: camera [nc, 6], landmark [nl, 3]
    lam: tuple  # camera [nc, 6, 6], landmark [nl, 3, 3]
    mean: tuple  # camera [nc, 6], landmark [nl, 3]


def _diag_prior(means, prec):
    lam = torch.diag_embed(prec)
    return (prec * means, lam)


def problem(sim: dict, build: dict, device, dtype=torch.float64) -> Problem:
    """The problem of the port's `models.ba.build(sim, **build)` (normalized
    coordinates): camera 0 anchored with 1e5 on all six components, camera
    1's translation with 1e5, every other variable a diagonal prior at its
    initial estimate."""
    cam_pp = float(build.get("cam_prior_prec", 1.0))
    lmk_pp = float(build.get("lmk_prior_prec", 1.0))
    anchor = build.get("anchor_prec", (1e5, 1e5))
    k = np.asarray(sim["k"], dtype=np.float64)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)
    n_c = sim["cam_init"].shape[0]
    cam_prec = np.full((n_c, 6), cam_pp)
    cam_prec[0] = anchor[0]
    if n_c > 1:
        cam_prec[1, 3:] = anchor[1]
    lmk_prec = np.full(sim["lmk_init"].shape, lmk_pp)
    sigma = sim.get("pix_sigma", 1.0) / k[:2]
    return Problem(
        z=t((sim["obs"] - k[2:]) / k[:2]),
        prec=t(np.broadcast_to(1.0 / (sigma * sigma), sim["obs"].shape)),
        cam=torch.as_tensor(np.asarray(sim["cam_ids"]), device=device).long(),
        lmk=torch.as_tensor(np.asarray(sim["lmk_ids"]), device=device).long(),
        cam_prior=_diag_prior(t(sim["cam_init"]), t(cam_prec)),
        lmk_prior=_diag_prior(t(sim["lmk_init"]), t(lmk_prec)),
        k=k)


# --- arithmetic --------------------------------------------------------------


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32 (10 explicit mantissa bits, nearest)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """Products in the reference's precision: exact in float64, or with
    TF32 operands (the control)."""

    def __init__(self, precision: str):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"precision must be 'f64' or 'tf32', got {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return torch.matmul(a, b)

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(w):
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)  # sin t / t
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / safe)  # (1 - cos t) / t^2
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (th - torch.sin(th)) / (safe * th))
    return a, b, c


def project(ar: Arith, x: torch.Tensor, with_jac: bool = True):
    """The normalized pinhole model at x [n, 9] = [omega, t, X]: (h [n, 2],
    dh/dx [n, 2, 9] or None).  Xc = R(omega) X + t, h = Xc.xy / z with z
    floored at +-1e-2 keeping its sign; dXc/domega = -R [X]x Jr(omega)."""
    w, t, p = x[:, :3], x[:, 3:6], x[:, 6:9]
    a, b, c = _coeffs(w)
    k = hat(w)
    kk = ar.mm(k, k)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    r = eye + a[:, None, None] * k + b[:, None, None] * kk
    xc = ar.mv(r, p) + t
    zc = xc[:, 2]
    zs = torch.where(zc >= 0, torch.clamp(zc, min=1e-2), torch.clamp(zc, max=-1e-2))
    h = xc[:, :2] / zs[:, None]
    if not with_jac:
        return h, None
    jr = eye - b[:, None, None] * k + c[:, None, None] * kk
    d_w = -ar.mm(ar.mm(r, hat(p)), jr)
    dxc = torch.cat([d_w, eye.expand_as(r), r], -1)  # [n, 3, 9]
    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    dpi = torch.stack([torch.stack([iz, zero, -xc[:, 0] * iz * iz], -1),
                       torch.stack([zero, iz, -xc[:, 1] * iz * iz], -1)], -2)
    return h, ar.mm(dpi, dxc)


# --- the sweep -----------------------------------------------------------------


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def init_state(pb: Problem, means: tuple, ar: Arith) -> State:
    """Beliefs = priors with the given means, factors linearized at the
    means, zero messages."""
    cam_mu, lmk_mu = (m.to(ar.dtype) for m in means)
    x = torch.cat([cam_mu[pb.cam], lmk_mu[pb.lmk]], 1)
    jac, r0 = [], []
    for s in range(0, x.shape[0], ROWS):
        h, j = project(ar, x[s:s + ROWS])
        jac.append(j)
        r0.append(pb.z[s:s + ROWS].to(ar.dtype) - h)
    m = x.shape[0]
    zeros = lambda *shape: torch.zeros((m, *shape), dtype=ar.dtype, device=x.device)
    return State(lp=x, jac=torch.cat(jac), r0=torch.cat(r0), srel=zeros(),
                 msg_eta=(zeros(6), zeros(3)), msg_lam=(zeros(6, 6), zeros(3, 3)),
                 eta=(pb.cam_prior[0].to(ar.dtype), pb.lmk_prior[0].to(ar.dtype)),
                 lam=(pb.cam_prior[1].to(ar.dtype), pb.lmk_prior[1].to(ar.dtype)),
                 mean=(cam_mu, lmk_mu))


def _messages(ar: Arith, cfg: dict, floor: float, rows: slice, st: State, pb: Problem,
              lp, jac, r0, srel):
    """New (damped) messages of the rows `rows`, both slots."""
    ids = (pb.cam[rows], pb.lmk[rows])
    dofs, offs = (6, 3), (0, 6)
    jacs = [jac[:, :, o:o + d] for o, d in zip(offs, dofs)]
    x0s = [lp[:, o:o + d] for o, d in zip(offs, dofs)]
    ps, qs = [], []
    for s in range(2):
        b_lam = st.lam[s][ids[s]]
        cav_lam = b_lam - st.msg_lam[s][rows]
        cav_lam = cav_lam + floor * torch.diag_embed(torch.diagonal(b_lam, dim1=-2, dim2=-1))
        cav_eta = st.eta[s][ids[s]] - st.msg_eta[s][rows]
        cov = torch.linalg.inv(cav_lam)
        jc = ar.mm(jacs[s], cov)
        ps.append(ar.mm(jc, jacs[s].transpose(-1, -2)))
        qs.append(ar.mv(jacs[s], x0s[s] - ar.mv(cov, cav_eta)))
    sigma = torch.diag_embed(1.0 / pb.prec[rows].to(ar.dtype))
    undamped = srel >= cfg["num_undamped_iters"]
    damp = (undamped.to(ar.dtype) * cfg["eta_damping"])[:, None]
    out_eta, out_lam = [], []
    for a in range(2):
        b = 1 - a
        s_inv = torch.linalg.inv(_sym(sigma + ps[b]))
        u = ar.mv(jacs[a], x0s[a]) + r0 + qs[b]
        sj = ar.mm(s_inv, jacs[a])
        eta = ar.mv(sj.transpose(-1, -2), u)
        lam = ar.mm(jacs[a].transpose(-1, -2), sj)
        out_eta.append((1.0 - damp) * eta + damp * st.msg_eta[a][rows])
        out_lam.append(_sym(lam))
    return out_eta, out_lam


def sweep(pb: Problem, st: State, cfg: dict, ar: Arith,
          follow: torch.Tensor | None = None, tally: list | None = None) -> State:
    """One synchronous sweep (module docstring); `cfg` holds eta_damping,
    num_undamped_iters, min_linear_iters, beta and cavity_floor.

    follow [m] bool: the program's relinearization decisions at this sweep,
    taken for every eligible row, so that what follows is judged on the
    program's own decisions; `tally` ([disagreeing, eligible] rows) then
    counts where the reference's own decision differs."""
    m = st.lp.shape[0]
    lp_all, jac_all, r0_all, srel_all = [], [], [], []
    eta_all, lam_all = ([], []), ([], [])
    for s0 in range(0, m, ROWS):
        rows = slice(s0, min(m, s0 + ROWS))
        x = torch.cat([st.mean[0][pb.cam[rows]], st.mean[1][pb.lmk[rows]]], 1)
        lp, jac, r0, srel = st.lp[rows], st.jac[rows], st.r0[rows], st.srel[rows]
        dist = torch.linalg.vector_norm(x - lp, dim=-1)
        eligible = srel >= cfg["min_linear_iters"]
        relin = (dist > cfg["beta"]) & eligible
        if follow is not None:
            own, relin = relin, follow[rows] & eligible
            if tally is not None:
                tally[0] += int((own != relin).sum())
                tally[1] += int(eligible.sum())
        h, j_new = project(ar, x)
        lp = torch.where(relin[:, None], x, lp)
        jac = torch.where(relin[:, None, None], j_new, jac)
        r0 = torch.where(relin[:, None], pb.z[rows].to(ar.dtype) - h, r0)
        srel = torch.where(relin, torch.zeros_like(srel), srel + 1.0)
        e, l = _messages(ar, cfg, cfg["cavity_floor"], rows, st, pb, lp, jac, r0, srel)
        for acc, v in ((lp_all, lp), (jac_all, jac), (r0_all, r0), (srel_all, srel)):
            acc.append(v)
        for a in range(2):
            eta_all[a].append(e[a])
            lam_all[a].append(l[a])
    msg_eta = tuple(torch.cat(v) for v in eta_all)
    msg_lam = tuple(torch.cat(v) for v in lam_all)
    eta, lam, mean = beliefs(pb, msg_eta, msg_lam, ar.dtype)
    return State(lp=torch.cat(lp_all), jac=torch.cat(jac_all), r0=torch.cat(r0_all),
                 srel=torch.cat(srel_all), msg_eta=msg_eta, msg_lam=msg_lam,
                 eta=eta, lam=lam, mean=mean)


def message_sums(pb: Problem, msg_eta: tuple, msg_lam: tuple):
    """Per variable, the sums of the messages it receives: ((camera eta,
    landmark eta), (camera lam, landmark lam))."""
    out_e, out_l = [], []
    for s, (ids, prior) in enumerate(((pb.cam, pb.cam_prior), (pb.lmk, pb.lmk_prior))):
        n, d = prior[0].shape
        e = torch.zeros((n, d), dtype=msg_eta[s].dtype, device=ids.device)
        l = torch.zeros((n, d, d), dtype=msg_lam[s].dtype, device=ids.device)
        out_e.append(e.index_add_(0, ids, msg_eta[s]))
        out_l.append(l.index_add_(0, ids, msg_lam[s]))
    return tuple(out_e), tuple(out_l)


def beliefs(pb: Problem, msg_eta: tuple, msg_lam: tuple, dtype):
    """Beliefs = priors + message sums; means by a solve."""
    se, sl = message_sums(pb, msg_eta, msg_lam)
    eta = (pb.cam_prior[0].to(dtype) + se[0], pb.lmk_prior[0].to(dtype) + se[1])
    lam = (pb.cam_prior[1].to(dtype) + sl[0], pb.lmk_prior[1].to(dtype) + sl[1])
    mean = tuple(torch.linalg.solve(l, e[..., None])[..., 0] for e, l in zip(eta, lam))
    return eta, lam, mean


def run(pb: Problem, st: State, cfg: dict, ar: Arith, n: int) -> State:
    for _ in range(n):
        st = sweep(pb, st, cfg, ar)
    return st


def cast(st: State, dtype) -> State:
    """`st` with every floating tensor in `dtype`."""
    return State(*(tuple(t.to(dtype) for t in v) if isinstance(v, tuple) else v.to(dtype)
                   for v in st))


def are(pb: Problem, cam_mean: torch.Tensor, lmk_mean: torch.Tensor,
        ar: Arith | None = None) -> float:
    """Average reprojection error in pixels of the means (float64 products
    unless `ar` says otherwise)."""
    ar = ar or Arith("f64")
    total = 0.0
    scale = torch.as_tensor(pb.k[:2], dtype=ar.dtype, device=pb.z.device)
    for s in range(0, pb.z.shape[0], ROWS):
        rows = slice(s, s + ROWS)
        x = torch.cat([cam_mean.to(ar.dtype)[pb.cam[rows]], lmk_mean.to(ar.dtype)[pb.lmk[rows]]], 1)
        h, _ = project(ar, x, with_jac=False)
        r = (pb.z[rows].to(ar.dtype) - h) * scale
        total += float(torch.linalg.vector_norm(r, dim=-1).double().sum())
    return total / pb.z.shape[0]


def sweep_config(gbp: dict, program_dtype: str) -> dict:
    """The sweep settings of the configuration's `gbp` entry, with the
    port's defaults (beta 0.01, the cavity floor 1e-5 of diag(belief) for
    float32 programs, 0 for float64) filled in."""
    floor = gbp.get("cavity_floor", 1e-5 if program_dtype == "float32" else 0.0)
    out = dict(eta_damping=float(gbp["eta_damping"]), beta=float(gbp.get("beta", 0.01)),
               num_undamped_iters=int(gbp["num_undamped_iters"]),
               min_linear_iters=int(gbp["min_linear_iters"]), cavity_floor=float(floor))
    if not math.isfinite(out["eta_damping"]):
        raise ValueError("eta_damping must be finite")
    return out
