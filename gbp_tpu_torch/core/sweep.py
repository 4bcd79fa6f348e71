"""The GBP sweep: relinearize -> robustify -> messages -> beliefs.

Counterpart of gbp_tpu/core/sweep.py: the generic row-major engine for any
graph (several factor and variable blocks, unary factors, full precision,
per-factor Huber, inboxes), which the entry points fall back to whenever
`sweep_cm.prepare` returns None, and which the oracle, `energy` and the CM
tests are built on.  All data-dependent decisions (relinearization
triggers, Huber weights, damping warm-up) are masked arithmetic over factor
batches.

Per sweep: (1) relinearize factor f iff ||adjacent means - linpoint_f|| >
beta and >= min_linear_iters sweeps passed since it last did; (2) Huber
covariance scaling from the residual at the linearization point; (3) factor
-> variable messages, eta-damped except for num_undamped_iters sweeps after
a relinearization; (4) belief = prior + sum of incoming messages, means by
a closed-form small solve.

Message forms (`GBPConfig.message_form`): "covariance" (default; S_a =
Sigma / w + sum over the other slots of J_s C_s^-1 J_s^T, a sum of PSD
terms that float32 survives), "schur" (the joint potential Schur-
marginalized; float64 only in practice) and "pallas": the covariance form
in the hand-written kernels of ops/messages.py (`fused_messages`, and
`fused_relin_messages` where the factor type has a component-form model)
for 2-slot blocks; on CPU tensors those run their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gbp_tpu_torch.core.graph import FactorBlock, Graph
from gbp_tpu_torch.gaussians import Gaussian, marginalize
from gbp_tpu_torch.ops.comp_factors import COMP_FACTORS
from gbp_tpu_torch.ops.messages import fused_messages, fused_relin_messages, segsum_by_id
from gbp_tpu_torch.utils.smalllinalg import (
    bT,
    bmm,
    bmv,
    scaled_sym_inv,
    scaled_sym_solve,
    symmetrize,
)


@dataclasses.dataclass(frozen=True)
class GBPConfig:
    """The reference's tuning surface (gbp_tpu.core.sweep.GBPConfig)."""

    eta_damping: float = 0.4
    lam_damping: float = 0.0
    beta: float = 0.01
    num_undamped_iters: int = 6
    min_linear_iters: int = 8
    # "covariance" | "schur" | "pallas" (see the module docstring).
    message_form: str = "covariance"
    # Jitter added to cavity precisions before inversion ("covariance") or
    # to the marginalization pivot ("schur").
    cavity_jitter: float = 0.0
    # Relative cavity floor: cav_lam += floor * diag(belief_lam), the
    # roundoff guard for belief - own_msg cancelling in float32.  None =
    # auto: 1e-5 for float32, 0 for float64.
    cavity_floor: float | None = None


class VariableState(NamedTuple):
    eta: torch.Tensor  # [n, d]
    lam: torch.Tensor  # [n, d, d]
    mean: torch.Tensor  # [n, d]


class FactorState(NamedTuple):
    linpoint: torch.Tensor  # [m, tdof]
    jac: torch.Tensor  # [m, zdim, tdof]
    r0: torch.Tensor  # [m, zdim]
    msg_eta: tuple  # per slot [m, d_k]
    msg_lam: tuple  # per slot [m, d_k, d_k]
    since_relin: torch.Tensor  # [m] int32


class GBPState(NamedTuple):
    v: tuple  # tuple[VariableState]
    f: tuple  # tuple[FactorState]


def linearize_block(fb: FactorBlock, x: torch.Tensor):
    """Linearize all factors of a block at x [m, tdof] -> (jac, r0)."""
    ft = fb.ftype
    h = ft.meas(x, fb.args).to(x.dtype)
    jac = ft.jac(x, fb.args).to(x.dtype)
    return jac, ft.residual(fb.z, h).to(x.dtype)


def gather_linpoint(graph: Graph, state: GBPState, fi: int) -> torch.Tensor:
    """Concatenate adjacent variable means per factor -> [m, tdof]."""
    fb = graph.fblocks[fi]
    parts = [state.v[vb].mean[fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)]
    return torch.cat(parts, dim=-1)


def factor_potential(fb: FactorBlock, fs: FactorState):
    """The information-form factor potential of the linearization:
    Lam_f = J^T Lam_meas J, eta_f = J^T Lam_meas (J x0 + r0).  Used by the
    oracle and the "schur" message form."""
    jac, x, r0 = fs.jac, fs.linpoint, fs.r0
    jp = _apply_prec(fb.prec, jac)
    f_lam = bmm(bT(jp), jac)
    f_eta = bmv(bT(jp), bmv(jac, x) + r0)
    return f_eta, f_lam


def _apply_prec(prec, v):
    """Apply measurement precision (diag [m, z] or full [m, z, z]) to [m, z, ...]."""
    if prec.ndim == 2:
        return v * prec[:, :, None] if v.ndim == 3 else v * prec
    if v.ndim == 3:
        return bmm(prec, v)
    return bmv(prec, v)


def _mahalanobis_sq(prec, r):
    if prec.ndim == 2:
        return (prec * r * r).sum(-1)
    return (r * bmv(prec, r)).sum(-1)


def huber_weight(fb: FactorBlock, r0: torch.Tensor) -> torch.Tensor:
    """Covariance-scaling Huber weight from the linpoint residual [m]:
    w = 2T/M - T^2/M^2 for M > T else 1, which makes the scaled quadratic
    energy equal the Huber cost."""
    if fb.huber is None and fb.huber_arr is None:
        return torch.ones(r0.shape[0], dtype=r0.dtype, device=r0.device)
    m = torch.sqrt(torch.clamp(_mahalanobis_sq(fb.prec, r0), min=1e-12))
    t = (fb.huber_arr.to(r0.dtype) if fb.huber_arr is not None
         else torch.tensor(fb.huber, dtype=r0.dtype, device=r0.device))
    w = 2.0 * t / m - (t * t) / (m * m)
    # t == 0 rows (per-factor robustification off) keep weight 1.
    return torch.where((m > t) & (t > 0), w, torch.ones_like(w))


def _cavity_floor(cfg: GBPConfig, dtype) -> float:
    if cfg.cavity_floor is not None:
        return cfg.cavity_floor
    return 1e-5 if dtype == torch.float32 else 0.0


def _kernel_params(cfg: GBPConfig, dtype) -> tuple:
    """The kernels' 7 scalar params (eta_damping, lam_damping, num_undamped,
    floor, beta, min_linear, jitter), each rounded to `dtype` as the
    reference's [7] param vector is."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    vals = (cfg.eta_damping, cfg.lam_damping, cfg.num_undamped_iters,
            _cavity_floor(cfg, dtype), cfg.beta, cfg.min_linear_iters,
            cfg.cavity_jitter)
    return tuple(float(np_dt(v)) for v in vals)


# --- factor-local steps -----------------------------------------------------


def _relinearize(fb: FactorBlock, fs: FactorState, x: torch.Tensor, cfg: GBPConfig,
                 active: torch.Tensor | None) -> FactorState:
    dist = torch.linalg.vector_norm(x - fs.linpoint, dim=-1)
    eligible = (dist > cfg.beta) & (fs.since_relin >= cfg.min_linear_iters)
    if active is not None:
        eligible = eligible & active
    new_jac, new_r0 = linearize_block(fb, x)
    sel = eligible[:, None]
    return fs._replace(
        linpoint=torch.where(sel, x, fs.linpoint),
        jac=torch.where(sel[:, :, None], new_jac, fs.jac),
        r0=torch.where(sel, new_r0, fs.r0),
        since_relin=torch.where(eligible, torch.zeros_like(fs.since_relin),
                                fs.since_relin + 1),
    )


def _damping(fs: FactorState, cfg: GBPConfig, dtype):
    undamped = fs.since_relin >= cfg.num_undamped_iters
    zero = torch.zeros((), dtype=dtype, device=fs.r0.device)
    return (torch.where(undamped, zero + cfg.eta_damping, zero),
            torch.where(undamped, zero + cfg.lam_damping, zero))


def _finish_messages(fs: FactorState, raw: list, cfg: GBPConfig,
                     active: torch.Tensor | None) -> FactorState:
    """Apply damping and the active mask to freshly computed per-slot messages."""
    damp, ldamp = _damping(fs, cfg, raw[0].eta.dtype)
    new_eta, new_lam = [], []
    for a, marg in enumerate(raw):
        me = (1.0 - damp[:, None]) * marg.eta + damp[:, None] * fs.msg_eta[a]
        ml = (1.0 - ldamp[:, None, None]) * marg.lam + ldamp[:, None, None] * fs.msg_lam[a]
        if active is not None:
            sel = active[:, None]
            me = torch.where(sel, me, fs.msg_eta[a])
            ml = torch.where(sel[:, :, None], ml, fs.msg_lam[a])
        new_eta.append(me)
        new_lam.append(symmetrize(ml))
    return fs._replace(msg_eta=tuple(new_eta), msg_lam=tuple(new_lam))


def _floor_cavity(cav_lam, belief_lam, floor):
    """cav_lam += floor * diag(belief_lam) on the diagonal (roundoff guard)."""
    if not floor:
        return cav_lam
    eye = torch.eye(cav_lam.shape[-1], dtype=cav_lam.dtype, device=cav_lam.device)
    return cav_lam + floor * belief_lam * eye


def _messages_covariance(fb: FactorBlock, fs: FactorState, beliefs: tuple,
                         cfg: GBPConfig) -> list:
    """Covariance-form messages (see the module docstring): per-slot Gaussians."""
    n_slots = len(fb.dofs)
    zdim = fb.z.shape[-1]
    dt, dev = fs.r0.dtype, fs.r0.device
    floor = _cavity_floor(cfg, dt)
    w = huber_weight(fb, fs.r0)

    offs = fb.offsets
    jacs = [fs.jac[:, :, o:o + d] for o, d in zip(offs, fb.dofs)]
    x0s = [fs.linpoint[:, o:o + d] for o, d in zip(offs, fb.dofs)]
    ps, qs = [], []
    for s in range(n_slots):
        cav_lam = beliefs[s].lam - fs.msg_lam[s]
        cav_eta = beliefs[s].eta - fs.msg_eta[s]
        cav_lam = _floor_cavity(cav_lam, beliefs[s].lam, floor)
        if cfg.cavity_jitter:
            cav_lam = cav_lam + cfg.cavity_jitter * torch.eye(fb.dofs[s], dtype=dt, device=dev)
        cav_cov = scaled_sym_inv(cav_lam, fb.dofs[s])
        cav_mean = bmv(cav_cov, cav_eta)
        jc = bmm(jacs[s], cav_cov)
        ps.append(bmm(jc, bT(jacs[s])))
        qs.append(bmv(jacs[s], x0s[s] - cav_mean))

    # Sigma_meas / w  (Huber rescales the measurement covariance up).
    if fb.prec.ndim == 2:
        sigma = torch.diag_embed(1.0 / fb.prec)
    else:
        sigma = scaled_sym_inv(fb.prec, zdim)
    sigma = sigma / w[:, None, None]

    out = []
    for a in range(n_slots):
        s_mat = sigma
        u = bmv(jacs[a], x0s[a]) + fs.r0
        for s in range(n_slots):
            if s == a:
                continue
            s_mat = s_mat + ps[s]
            u = u + qs[s]
        s_inv = scaled_sym_inv(symmetrize(s_mat), zdim)
        sj = bmm(s_inv, jacs[a])
        out.append(Gaussian(bmv(bT(sj), u), bmm(bT(jacs[a]), sj)))
    return out


def _messages_schur(fb: FactorBlock, fs: FactorState, beliefs: tuple,
                    cfg: GBPConfig) -> list:
    """Reference-form messages: joint potential + cavities, Schur-marginalized."""
    offs = fb.offsets
    w = huber_weight(fb, fs.r0)
    f_eta, f_lam = factor_potential(fb, fs)
    base_eta = f_eta * w[:, None]
    base_lam = f_lam * w[:, None, None]
    floor = _cavity_floor(cfg, f_eta.dtype)
    cav_eta = [beliefs[k].eta - fs.msg_eta[k] for k in range(len(fb.dofs))]
    cav_lam = [_floor_cavity(beliefs[k].lam - fs.msg_lam[k], beliefs[k].lam, floor)
               for k in range(len(fb.dofs))]

    out = []
    for a, (da, off_a) in enumerate(zip(fb.dofs, offs)):
        eta = base_eta.clone()
        lam = base_lam.clone()
        for b, (db, off_b) in enumerate(zip(fb.dofs, offs)):
            if b == a:
                continue
            eta[:, off_b:off_b + db] += cav_eta[b]
            lam[:, off_b:off_b + db, off_b:off_b + db] += cav_lam[b]
        if cfg.cavity_jitter:
            lam = lam + cfg.cavity_jitter * torch.eye(fb.tdof, dtype=lam.dtype, device=lam.device)
        out.append(marginalize(eta, lam, off_a, da))
    return out


def _prec_huber_operand(fb: FactorBlock):
    """(prec 2-D operand, static huber) for the kernels: per-factor
    thresholds (fb.huber_arr) ride as an extra trailing column of the prec
    operand, with the static huber set to "row"."""
    prec = fb.prec.reshape(fb.count, -1) if fb.prec.ndim == 3 else fb.prec
    if fb.huber_arr is None:
        return prec, fb.huber
    if fb.prec.ndim != 2:
        raise ValueError("per-factor huber requires diagonal prec")
    return torch.cat([prec, fb.huber_arr[:, None].to(prec.dtype)], dim=1), "row"


def _act_operand(fs: FactorState, active):
    dt = fs.r0.dtype
    if active is None:
        return torch.ones(fs.r0.shape[0], dtype=dt, device=fs.r0.device)
    return active.to(dt)


def _messages_fused(fb: FactorBlock, fs: FactorState, beliefs: tuple,
                    cfg: GBPConfig, active: torch.Tensor | None) -> FactorState:
    """Covariance-form messages + damping + masking in one kernel
    (`ops.messages.fused_messages`); the same update as
    _messages_covariance -> _finish_messages."""
    d0, d1 = fb.dofs
    m = fb.count
    prec_op, huber = _prec_huber_operand(fb)
    oe0, ol0, oe1, ol1 = fused_messages(
        _kernel_params(cfg, fs.r0.dtype),
        fs.jac.reshape(m, -1), fs.linpoint, fs.r0, prec_op,
        fs.since_relin, _act_operand(fs, active),
        beliefs[0].eta, beliefs[0].lam.reshape(m, -1),
        beliefs[1].eta, beliefs[1].lam.reshape(m, -1),
        fs.msg_eta[0], fs.msg_lam[0].reshape(m, -1),
        fs.msg_eta[1], fs.msg_lam[1].reshape(m, -1),
        d0=d0, d1=d1, z=fb.z.shape[-1], prec_full=fb.prec.ndim == 3, huber=huber)
    return fs._replace(msg_eta=(oe0, oe1),
                       msg_lam=(ol0.reshape(m, d0, d0), ol1.reshape(m, d1, d1)))


def _use_fused_relin(cfg: GBPConfig, fb: FactorBlock) -> bool:
    """Whole-sweep fusion (relinearization and messages in the kernels) is
    available when the factor type has a component-form measurement model."""
    entry = COMP_FACTORS.get(fb.ftype.name)
    return (
        cfg.message_form == "pallas"
        and len(fb.dofs) == 2
        and entry is not None
        # custom residuals need a component form in the registry
        and (fb.ftype.residual_fn is None or len(entry) > 2)
    )


def _fused_relin_messages(fb: FactorBlock, fs: FactorState, beliefs: tuple,
                          x: torch.Tensor, cfg: GBPConfig,
                          active: torch.Tensor | None) -> FactorState:
    """Relinearization + message update through the kernels."""
    d0, d1 = fb.dofs
    zdim = fb.z.shape[-1]
    m = fb.count
    n_args = COMP_FACTORS[fb.ftype.name][1]
    prec_op, huber = _prec_huber_operand(fb)
    oe0, ol0, oe1, ol1, lp, jc, r0, srel = fused_relin_messages(
        _kernel_params(cfg, fs.r0.dtype), x, fb.z,
        None if n_args == 0 else fb.args,
        fs.linpoint, fs.jac.reshape(m, -1), fs.r0, prec_op,
        fs.since_relin, _act_operand(fs, active),
        beliefs[0].eta, beliefs[0].lam.reshape(m, -1),
        beliefs[1].eta, beliefs[1].lam.reshape(m, -1),
        fs.msg_eta[0], fs.msg_lam[0].reshape(m, -1),
        fs.msg_eta[1], fs.msg_lam[1].reshape(m, -1),
        d0=d0, d1=d1, z=zdim, prec_full=fb.prec.ndim == 3, huber=huber,
        comp_name=fb.ftype.name)
    return fs._replace(
        msg_eta=(oe0, oe1),
        msg_lam=(ol0.reshape(m, d0, d0), ol1.reshape(m, d1, d1)),
        linpoint=lp,
        jac=jc.reshape(m, zdim, d0 + d1),
        r0=r0,
        since_relin=srel.reshape(m).to(torch.int32),
    )


def _compute_messages(fb: FactorBlock, fs: FactorState, beliefs: tuple,
                      cfg: GBPConfig, active: torch.Tensor | None) -> FactorState:
    if cfg.message_form == "pallas" and len(fb.dofs) == 2:
        return _messages_fused(fb, fs, beliefs, cfg, active)
    if cfg.message_form in ("covariance", "pallas"):
        raw = _messages_covariance(fb, fs, beliefs, cfg)
    elif cfg.message_form == "schur":
        raw = _messages_schur(fb, fs, beliefs, cfg)
    else:
        raise ValueError(f"unknown message_form {cfg.message_form!r}")
    return _finish_messages(fs, raw, cfg, active)


# --- graph-level steps ------------------------------------------------------


def _pack_msgs(fs: FactorState, slot: int) -> torch.Tensor:
    """Messages of one slot packed as one wide 2-D array [m, d + d*d]."""
    me, ml = fs.msg_eta[slot], fs.msg_lam[slot]
    return torch.cat([me, ml.reshape(ml.shape[0], -1)], dim=1)


def update_beliefs(graph: Graph, state: GBPState) -> GBPState:
    """belief = prior + sum of factor -> variable messages.

    Three lowerings of the same sum: a dense-inbox gather and masked
    reduction where the graph carries inboxes, a reshape-sum over the degree
    axis for a block's ELL slot (padded rows carry zero messages), and
    otherwise the deterministic segment sum over the block's CSR
    (`segsum_by_id`: a fixed order, so two runs give the same bits)."""
    new_v = []
    for vi, vb in enumerate(graph.vblocks):
        d = vb.dof
        packed = torch.cat([vb.prior_eta, vb.prior_lam.reshape(vb.count, -1)], dim=1)
        specs = None if graph.inboxes is None else graph.inboxes[vi]
        if specs is not None:
            for spec in specs:
                g = _pack_msgs(state.f[spec.fi], spec.slot)[spec.idx.long()]
                packed = packed + torch.where(spec.mask[:, :, None], g,
                                              torch.zeros_like(g)).sum(1)
        else:
            for fi, fb in enumerate(graph.fblocks):
                for k, target in enumerate(fb.vblocks):
                    if target != vi:
                        continue
                    fs = state.f[fi]
                    if fb.ell_slot == k:
                        packed = packed + _pack_msgs(fs, k).reshape(
                            vb.count, fb.ell_deg, -1).sum(1)
                    else:
                        ml = fs.msg_lam[k]
                        packed = packed + segsum_by_id(
                            fs.msg_eta[k], ml.reshape(ml.shape[0], -1), *fb.csr[k],
                            row_major=True)
        eta = packed[:, :d]
        lam = packed[:, d:].reshape(vb.count, d, d)
        new_v.append(VariableState(eta=eta, lam=lam, mean=scaled_sym_solve(lam, eta)))
    return state._replace(v=tuple(new_v))


def _gather_beliefs_and_means(graph: Graph, state: GBPState, fi: int):
    """Per-factor adjacent beliefs and means in one wide gather per slot:
    each variable block's (eta | lam | mean) is packed into [n, 2d + d*d]
    rows, gathered (or, for the ELL slot, broadcast over the degree axis)
    and split into views, which the kernels read in place.  Returns
    (beliefs tuple, linpoint x [m, tdof])."""
    fb = graph.fblocks[fi]
    beliefs, means = [], []
    for k, vb in enumerate(fb.vblocks):
        vs = state.v[vb]
        n, d = vs.eta.shape
        packed = torch.cat([vs.eta, vs.lam.reshape(n, -1), vs.mean], dim=1)
        if fb.ell_slot == k:
            f = packed.shape[-1]
            packed = packed[:, None, :].expand(n, fb.ell_deg, f).reshape(n * fb.ell_deg, f)
        else:
            packed = packed[fb.adj[k].long()]
        beliefs.append(Gaussian(packed[:, :d], packed[:, d:-d].reshape(-1, d, d)))
        means.append(packed[:, -d:])
    return tuple(beliefs), torch.cat(means, dim=-1)


def sweep(graph: Graph, state: GBPState, cfg: GBPConfig,
          active: tuple | None = None) -> GBPState:
    """One synchronous GBP iteration.

    active: optional per-fblock [m] bool mask (wildfire / priority
    schedules); inactive factors keep their previous messages and skip
    relinearization."""
    new_f = []
    for fi, fb in enumerate(graph.fblocks):
        fs = state.f[fi]
        act = None if active is None else active[fi]
        if fb.valid is not None:
            act = fb.valid if act is None else (act & fb.valid)
        beliefs, x = _gather_beliefs_and_means(graph, state, fi)
        if _use_fused_relin(cfg, fb):
            fs = _fused_relin_messages(fb, fs, beliefs, x, cfg, act)
        else:
            fs = _relinearize(fb, fs, x, cfg, act)
            fs = _compute_messages(fb, fs, beliefs, cfg, act)
        new_f.append(fs)
    return update_beliefs(graph, state._replace(f=tuple(new_f)))


def run(graph: Graph, state: GBPState, cfg: GBPConfig, n_iters: int) -> GBPState:
    """n_iters synchronous sweeps."""
    for _ in range(n_iters):
        state = sweep(graph, state, cfg)
    return state


def init_state(graph: Graph, means: tuple) -> GBPState:
    """Initial state: beliefs = priors, all factors linearized at `means`,
    zero messages."""
    vstates = tuple(VariableState(eta=vb.prior_eta, lam=vb.prior_lam, mean=mu)
                    for vb, mu in zip(graph.vblocks, means))
    fstates = []
    for fb in graph.fblocks:
        x = torch.cat([means[vb][fb.adj[k].long()] for k, vb in enumerate(fb.vblocks)], dim=-1)
        jac, r0 = linearize_block(fb, x)
        zeros = lambda *shape: torch.zeros((fb.count, *shape), dtype=jac.dtype, device=x.device)
        fstates.append(FactorState(
            linpoint=x, jac=jac, r0=r0,
            msg_eta=tuple(zeros(d) for d in fb.dofs),
            msg_lam=tuple(zeros(d, d) for d in fb.dofs),
            since_relin=torch.zeros(fb.count, dtype=torch.int32, device=x.device),
        ))
    return GBPState(v=vstates, f=tuple(fstates))


def energy(graph: Graph, state: GBPState) -> torch.Tensor:
    """Total (Huber-adjusted) energy at the current belief means: 0.5 M^2
    inside the quadratic region, T*M - 0.5 T^2 beyond."""
    total = torch.zeros((), dtype=state.v[0].mean.dtype, device=state.v[0].mean.device)
    for fi, fb in enumerate(graph.fblocks):
        x = gather_linpoint(graph, state, fi)
        r = fb.ftype.residual(fb.z, fb.ftype.meas(x, fb.args))
        m2 = _mahalanobis_sq(fb.prec, r)
        if fb.huber is None and fb.huber_arr is None:
            e = 0.5 * m2
        else:
            mm = torch.sqrt(torch.clamp(m2, min=1e-12))
            t = (fb.huber_arr.to(mm.dtype) if fb.huber_arr is not None
                 else torch.tensor(fb.huber, dtype=mm.dtype, device=mm.device))
            e = torch.where((mm > t) & (t > 0), t * mm - 0.5 * t * t, 0.5 * m2)
        if fb.valid is not None:
            e = torch.where(fb.valid, e, torch.zeros_like(e))
        total = total + e.sum()
    return total
