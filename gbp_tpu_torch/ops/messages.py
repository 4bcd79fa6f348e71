"""The fast path's three kernels: wrappers, plain versions, launch counts.

Each function dispatches on where its tensors lie: CUDA tensors go to the
hand-written kernel in csrc/messages.cu (built on first use by
ops/_build.py), CPU tensors to the `*_plain` version beside it.  There is
no fallback: a CUDA tensor that the kernel does not take raises.

Layout: component-major, every per-factor operand is [F, mp] (component k
of factor row r at [k, r]), the memory order of the reference's
[F, mp/128, 128].  The two slots are fixed to the slice's BA shapes:
slot 0 = camera (6 dof, gathered by id from a per-camera table), slot 1 =
landmark (3 dof, ELL slot: row r belongs to landmark r // deg), z = 2.

  relin_cm_tab_ell     replaces gbp_tpu.ops.messages_pallas.fused_relin_cm_tab_ell
  messages_cm_tab_ell  replaces gbp_tpu.ops.messages_pallas.fused_messages_cm_tab_ell
  segsum_by_id         replaces gbp_tpu.ops.messages_pallas.segsum_cm and the
                       5th output of fused_messages_cm_tab_ell
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from gbp_tpu_torch.ops import comp_linalg as cl
from gbp_tpu_torch.ops.comp_factors import reprojection_normalized_comp

D0, D1, Z = 6, 3, 2  # camera dofs, landmark dofs, measurement dim
T = D0 + D1
F_CAM = D0 + D0 * D0  # packed camera belief row: eta | lam
F_LMK = D1 + D1 * D1  # packed landmark belief row: eta | lam
KERNELS = ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id")


@dataclasses.dataclass
class Counts:
    """Plain-integer counts: `kernel[name]` grows by one where a wrapper
    launches its kernel, `plain[name]` where the plain version runs."""

    kernel: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KERNELS, 0))
    plain: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KERNELS, 0))

    def reset(self):
        for d in (self.kernel, self.plain):
            for k in d:
                d[k] = 0


COUNTS = Counts()


def _rows(a):
    return [a[k] for k in range(a.shape[0])]


def _mat(comps, r, c):
    return [[comps[i * c + j] for j in range(c)] for i in range(r)]


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


# --- plain versions ---------------------------------------------------------


def relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0,
                           srel, act, *, deg):
    """Masked relinearization (the reference's `_relin_math`).

    x = [cam_mean[gidx[r]], lmk_mean[r // deg]];  eligible =
    ||x - lp||^2 > beta^2 and srel >= min_linear_iters and act.  Eligible
    rows take lp = x, the new (J, r0 = z - h) and srel = 0; the others keep
    their state and srel + 1."""
    COUNTS.plain["relin_cm_tab_ell"] += 1
    mp = lp.shape[1]
    rows = torch.arange(mp, device=lp.device) // deg
    x = _rows(cam_mean[gidx.long()].T) + _rows(lmk_mean[rows].T)
    lp_o = _rows(lp)
    beta = _scalar(params[4], lp)
    dist2 = sum((x[i] - lp_o[i]) * (x[i] - lp_o[i]) for i in range(T))
    eligible = (dist2 > beta * beta) & (srel[0] >= params[5]) & (act[0] > 0.5)
    h, j_new = reprojection_normalized_comp(x)
    r_new = [z[i] - h[i] for i in range(Z)]
    jac_new = [j_new[i][j] for i in range(Z) for j in range(T)]
    sel = lambda new, old: torch.stack(
        [torch.where(eligible, a, b) for a, b in zip(new, old)])
    return (sel(x, lp_o), sel(jac_new, _rows(jac)), sel(r_new, _rows(r0)),
            torch.where(eligible, torch.zeros_like(srel), srel + 1.0))


def _messages_plain(params, cam_tab, lmk_tab, gidx, jac, lp, r0, prec, srel,
                    act, me0, ml0, me1, ml1, *, deg, huber):
    """Covariance-form factor -> variable messages (the reference's
    `_message_math`, diagonal prec): Huber weight, cavities with floor and
    jitter, S = sym(Sigma / w + P_other), damping, act select."""
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    mp = jac.shape[1]
    rows = torch.arange(mp, device=jac.device) // deg
    cam = _rows(cam_tab[gidx.long()].T)
    lmk = _rows(lmk_tab[rows].T)
    jm = _mat(_rows(jac), Z, T)
    j0 = [row[:D0] for row in jm]
    j1 = [row[D0:] for row in jm]
    x0 = _rows(lp)
    r0_l = _rows(r0)
    pr = _rows(prec)
    floor_t, jitter_t = _scalar(floor, jac), _scalar(jitter, jac)

    m2 = sum(pr[i] * r0_l[i] * r0_l[i] for i in range(Z))
    zero = torch.zeros_like(r0_l[0])
    sigma = [[1.0 / pr[i] if i == j else zero for j in range(Z)] for i in range(Z)]
    if huber is not None:
        mm = torch.sqrt(torch.clamp(m2, min=1e-12))
        # 2T and T^2 rounded once from the Python float, as the reference's
        # weakly typed scalars are.
        two_h, h_sq = _scalar(2.0 * huber, jac), _scalar(huber * huber, jac)
        w = torch.where(mm > _scalar(huber, jac), two_h / mm - h_sq / (mm * mm),
                        torch.ones_like(mm))
        sigma = cl.cscale(sigma, 1.0 / w)

    def slot(be, bl_flat, me, ml_flat, j_s, x0_s, d):
        bl = _mat(bl_flat, d, d)
        ml = _mat(ml_flat, d, d)
        cav_lam = cl.csub(bl, ml)
        for i in range(d):
            cav_lam[i][i] = cav_lam[i][i] + floor_t * bl[i][i] + jitter_t
        cav_eta = [b - m for b, m in zip(be, me)]
        cav_cov = cl.cscaled_sym_inv(cav_lam)
        cav_mu = cl.cmv(cav_cov, cav_eta)
        p = cl.cmm(cl.cmm(j_s, cav_cov), cl.ct(j_s))
        q = cl.cmv(j_s, cl.vsub(x0_s, cav_mu))
        return p, q, ml

    p0, q0, ml0_m = slot(cam[:D0], cam[D0:], _rows(me0), _rows(ml0), j0, x0[:D0], D0)
    p1, q1, ml1_m = slot(lmk[:D1], lmk[D1:], _rows(me1), _rows(ml1), j1, x0[D0:], D1)

    undamped = srel[0] >= num_undamped
    damp = torch.where(undamped, _scalar(eta_damping, jac), zero)
    ldamp = torch.where(undamped, _scalar(lam_damping, jac), zero)
    on = act[0] > 0.5

    def emit(j_a, x0_a, p_o, q_o, me_old, ml_old, d):
        s_inv = cl.cscaled_sym_inv(cl.csym(cl.cadd(sigma, p_o)))
        sj = cl.cmm(s_inv, j_a)
        u = cl.vadd(cl.vadd(cl.cmv(j_a, x0_a), r0_l), q_o)
        lam_msg = cl.csym(cl.cmm(cl.ct(j_a), sj))
        eta_msg = cl.cmv(cl.ct(sj), u)
        # Masked rows keep their old message by a select, never by mixing:
        # padded rows may compute non-finite candidates and NaN * 0 = NaN.
        oe = [torch.where(on, (1.0 - damp) * eta_msg[i] + damp * me_old[i], me_old[i])
              for i in range(d)]
        ol = [torch.where(on, (1.0 - ldamp) * lam_msg[i][j] + ldamp * ml_old[i][j],
                          ml_old[i][j])
              for i in range(d) for j in range(d)]
        return torch.stack(oe), torch.stack(ol)

    oe0, ol0 = emit(j0, x0[:D0], p1, q1, _rows(me0), ml0_m, D0)
    oe1, ol1 = emit(j1, x0[D0:], p0, q0, _rows(me1), ml1_m, D1)
    return oe0, ol0, oe1, ol1


def messages_cm_tab_ell_plain(params, cam_tab, lmk_tab, gidx, jac, lp, r0,
                              prec, srel, act, me0, ml0, me1, ml1, seg_rows,
                              seg_offsets, *, deg, huber):
    """Plain version of `messages_cm_tab_ell`: the four new messages and the
    camera-side sum of the new camera messages [F_CAM, n_cam]."""
    COUNTS.plain["messages_cm_tab_ell"] += 1
    oe0, ol0, oe1, ol1 = _messages_plain(
        params, cam_tab, lmk_tab, gidx, jac, lp, r0, prec, srel, act,
        me0, ml0, me1, ml1, deg=deg, huber=huber)
    return oe0, ol0, oe1, ol1, segsum_by_id_plain(oe0, ol0, seg_rows, seg_offsets)


def segsum_by_id_plain(me, ml, seg_rows, seg_offsets):
    """Sum the (eta | lam) components of the rows of each segment:
    out[k, s] = sum over i in [offsets[s], offsets[s+1]) of comp_k[rows[i]]."""
    COUNTS.plain["segsum_by_id"] += 1
    n_seg = seg_offsets.shape[0] - 1
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=me.device), (seg_offsets[1:] - seg_offsets[:-1]).long())
    vals = torch.cat([me, ml])[:, seg_rows.long()]
    out = torch.zeros((vals.shape[0], n_seg), dtype=me.dtype, device=me.device)
    return out.index_add_(1, ids, vals)


# --- kernel wrappers --------------------------------------------------------


def _check(name, t, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return ctypes.c_void_p(t.data_ptr())


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, got {dtype}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def relin_cm_tab_ell(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0, srel,
                     act, *, deg):
    """Masked relinearization; returns new (lp [9, mp], jac [18, mp],
    r0 [2, mp], srel [1, mp]).  cam_mean [n_cam, 6], lmk_mean [nv, 3] with
    nv = mp // deg, gidx [mp] int32 camera ids."""
    if not lp.is_cuda:
        return relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, gidx, z, lp,
                                      jac, r0, srel, act, deg=deg)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    n_cam, nv = cam_mean.shape[0], lmk_mean.shape[0]
    if mp != nv * deg:
        raise ValueError(f"relin_cm_tab_ell: mp={mp} != nv*deg={nv}*{deg}")
    out = [torch.empty((f, mp), dtype=dt, device=lp.device) for f in (T, Z * T, Z, 1)]
    args = [
        _check("cam_mean", cam_mean, (n_cam, D0), dt), ctypes.c_int(n_cam),
        _check("lmk_mean", lmk_mean, (nv, D1), dt), ctypes.c_int(nv),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("z", z, (Z, mp), dt), _check("lp", lp, (T, mp), dt),
        _check("jac", jac, (Z * T, mp), dt), _check("r0", r0, (Z, mp), dt),
        _check("srel", srel, (1, mp), dt), _check("act", act, (1, mp), dt),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg),
        ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tab_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tab_ell")
    COUNTS.kernel["relin_cm_tab_ell"] += 1
    return tuple(out)


def messages_cm_tab_ell(params, cam_tab, lmk_tab, gidx, jac, lp, r0, prec,
                        srel, act, me0, ml0, me1, ml1, seg_rows, seg_offsets,
                        *, deg, huber):
    """Factor -> variable messages; returns (eta0 [6, mp], lam0 [36, mp],
    eta1 [3, mp], lam1 [9, mp], camera sum [42, n_cam]) like the reference.

    cam_tab [n_cam, 42] and lmk_tab [nv, 12] are the packed (eta | lam)
    beliefs; huber is None or the scalar Mahalanobis threshold."""
    if not jac.is_cuda:
        return messages_cm_tab_ell_plain(
            params, cam_tab, lmk_tab, gidx, jac, lp, r0, prec, srel, act,
            me0, ml0, me1, ml1, seg_rows, seg_offsets, deg=deg, huber=huber)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    n_cam, nv = cam_tab.shape[0], lmk_tab.shape[0]
    if mp != nv * deg:
        raise ValueError(f"messages_cm_tab_ell: mp={mp} != nv*deg={nv}*{deg}")
    out = [torch.empty((f, mp), dtype=dt, device=jac.device)
           for f in (D0, D0 * D0, D1, D1 * D1)]
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    args = [
        _check("cam_tab", cam_tab, (n_cam, F_CAM), dt), ctypes.c_int(n_cam),
        _check("lmk_tab", lmk_tab, (nv, F_LMK), dt), ctypes.c_int(nv),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("jac", jac, (Z * T, mp), dt), _check("lp", lp, (T, mp), dt),
        _check("r0", r0, (Z, mp), dt), _check("prec", prec, (Z, mp), dt),
        _check("srel", srel, (1, mp), dt), _check("act", act, (1, mp), dt),
        _check("me0", me0, (D0, mp), dt), _check("ml0", ml0, (D0 * D0, mp), dt),
        _check("me1", me1, (D1, mp), dt), _check("ml1", ml1, (D1 * D1, mp), dt),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg),
        ctypes.c_double(eta_damping), ctypes.c_double(lam_damping),
        ctypes.c_double(num_undamped), ctypes.c_double(floor),
        ctypes.c_double(jitter), ctypes.c_int(huber is not None),
        ctypes.c_double(0.0 if huber is None else huber), _stream(),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tab_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tab_ell")
    COUNTS.kernel["messages_cm_tab_ell"] += 1
    return (*out, segsum_by_id(out[0], out[1], seg_rows, seg_offsets))


def segsum_by_id(me, ml, seg_rows, seg_offsets):
    """Deterministic segment sum [d + d*d, n_seg] of me [d, mp] | ml
    [d*d, mp] over the CSR (seg_rows sorted by segment, seg_offsets
    [n_seg + 1]).  Two runs give the same bits: no atomics."""
    if not me.is_cuda:
        return segsum_by_id_plain(me, ml, seg_rows, seg_offsets)
    from gbp_tpu_torch.ops._build import library

    dt = me.dtype
    mp = me.shape[1]
    n_seg = seg_offsets.shape[0] - 1
    n_rows = seg_rows.shape[0]
    out = torch.empty((F_CAM, n_seg), dtype=dt, device=me.device)
    args = [
        _check("me", me, (D0, mp), dt), _check("ml", ml, (D0 * D0, mp), dt),
        _check("seg_rows", seg_rows, (n_rows,), torch.int32),
        _check("seg_offsets", seg_offsets, (n_seg + 1,), torch.int32),
        ctypes.c_int(n_seg), ctypes.c_int64(mp),
        ctypes.c_void_p(out.data_ptr()), _stream(),
    ]
    fn = getattr(library(), f"gbp_segsum_by_id_{_suffix(dt)}")
    _raise_on(fn(*args), "segsum_by_id")
    COUNTS.kernel["segsum_by_id"] += 1
    return out
