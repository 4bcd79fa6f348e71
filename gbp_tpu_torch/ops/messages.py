"""The port's eleven kernels: wrappers, plain versions, launch counts.

Each function dispatches on where its tensors lie: CUDA tensors go to the
hand-written kernel in csrc/*.cu (built on first use by ops/_build.py), CPU
tensors to the `*_plain` version beside it.  There is no fallback: a CUDA
tensor that the kernel does not take raises.

Layout: component-major, every per-factor operand is [F, mp] (component k
of factor row r at [k, r]), the memory order of the reference's
[F, mp/128, 128].  The two slots are fixed to the slice's BA shapes:
slot 0 = camera (6 dof, gathered by id from a per-camera table), slot 1 =
landmark (3 dof, ELL slot: row r belongs to landmark r // deg), z = 2.

  relin_cm_tab_ell     replaces gbp_tpu.ops.messages_pallas.fused_relin_cm_tab_ell
  messages_cm_tab_ell  replaces gbp_tpu.ops.messages_pallas.fused_messages_cm_tab_ell
  segsum_by_id         replaces gbp_tpu.ops.messages_pallas.segsum_cm and the
                       5th output of fused_messages_cm_tab_ell

Large scenes (csrc/windows.cu): rows are cut into tiles of TILE rows and
every camera id of tile i lies in the window [win_starts[i], win_starts[i] +
win_w), so a block stages only its tile's window of the camera table.

  relin_cm_tabblk_ell     replaces fused_relin_cm_tabblk_ell
  messages_cm_tabblk_ell  replaces fused_messages_cm_tabblk_ell
  segsum_cm_blk           replaces the kernel stage of segsum_cm_blk and the
                          5th output of fused_messages_cm_tabblk_ell: per-tile
                          window partials [n_tiles, F, w]
  scatter_windows_cm      replaces scatter_windows_cm: the partials combined
                          over the overlapping windows, tiles in ascending order

Expanded operands (csrc/rows.cu): both slots' beliefs arrive per factor row
instead of from a table, for any instantiated (d0, d1, z), diagonal or full
precision, Huber none / scalar / per row ("row": the thresholds ride as the
component after the precision, 0 = off for that row).  One kernel body per
function serves both layouts; every operand is passed with its leading
stride, so slices of wider arrays are taken in place.

  messages_cm           replaces fused_messages_cm      (operands [F, mp])
  relin_cm              replaces fused_relin_cm         (operands [F, mp])
  fused_messages        replaces fused_messages         (operands [m, F])
  fused_relin_messages  replaces fused_relin_messages   (operands [m, F]): the
                        relinearization kernel, then `fused_messages` on the
                        new linearization
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gbp_tpu_torch.ops import comp_linalg as cl
from gbp_tpu_torch.ops.comp_factors import comp_model

D0, D1, Z = 6, 3, 2  # camera dofs, landmark dofs, measurement dim
T = D0 + D1
F_CAM = D0 + D0 * D0  # packed camera belief row: eta | lam
F_LMK = D1 + D1 * D1  # packed landmark belief row: eta | lam
TILE = 1024  # rows per window tile, the reference's grid tile (8 x 128)
# The most dynamic shared memory one block can ask for on sm_90.
SMEM_WINDOW_BYTES = 232448
KERNELS = ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id",
           "relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
           "scatter_windows_cm", "messages_cm", "relin_cm", "fused_messages",
           "fused_relin_messages")
# (d0, d1, z) the expanded-operand messages kernel is instantiated for, and
# the ROADMAP items that add the others.
ROW_SHAPES = ((6, 3, 2), (1, 1, 1))
ROW_SHAPES_QUEUED = {(9, 3, 2): "A7", (3, 3, 3): "A8", (6, 6, 6): "A8"}


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


def _relin_math(params, x, z, lp_o, jac_o, r0_o, srel, act, comp_name):
    """Masked relinearization (the reference's `_relin_math`) on component
    lists: x the adjacent means, srel and act one tensor each.

    eligible = ||x - lp||^2 > beta^2 and srel >= min_linear_iters and act.
    Eligible rows take lp = x, the new (J, r0 = z - h) and srel = 0; the
    others keep their state and srel + 1.  Returns (lp, jac, r0) as lists
    and the new srel."""
    comp_fn = comp_model(comp_name)
    t, zd = len(x), len(z)
    beta = _scalar(params[4], lp_o[0])
    dist2 = sum((x[i] - lp_o[i]) * (x[i] - lp_o[i]) for i in range(t))
    eligible = (dist2 > beta * beta) & (srel >= params[5]) & (act > 0.5)
    h, j_new = comp_fn(x)
    r_new = [z[i] - h[i] for i in range(zd)]
    jac_new = [j_new[i][j] for i in range(zd) for j in range(t)]
    sel = lambda new, old: [torch.where(eligible, a, b) for a, b in zip(new, old)]
    return (sel(x, lp_o), sel(jac_new, jac_o), sel(r_new, r0_o),
            torch.where(eligible, torch.zeros_like(srel), srel + 1.0))


def _relin_plain(params, cam_rows, lmk_mean, z, lp, jac, r0, srel, act, *, deg):
    """`_relin_math` on component-major state with the camera means already
    read per row, cam_rows [mp, 6]: x = [cam_rows[r], lmk_mean[r // deg]]."""
    mp = lp.shape[1]
    rows = torch.arange(mp, device=lp.device) // deg
    x = _rows(cam_rows.T) + _rows(lmk_mean[rows].T)
    lp_n, jac_n, r0_n, srel_n = _relin_math(
        params, x, _rows(z), _rows(lp), _rows(jac), _rows(r0), srel[0], act[0],
        "reprojection_normalized")
    return torch.stack(lp_n), torch.stack(jac_n), torch.stack(r0_n), srel_n[None]


def relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0,
                           srel, act, *, deg):
    """Plain version of `relin_cm_tab_ell`: camera means read by id from the
    whole table."""
    COUNTS.plain["relin_cm_tab_ell"] += 1
    return _relin_plain(params, cam_mean[gidx.long()], lmk_mean, z, lp, jac, r0,
                        srel, act, deg=deg)


def _window_rows(tab, gidx, win_starts, win_w):
    """tab[start + (gidx - start)] per row, start the row's tile's window
    start: the read the windowed kernels make, with their in-window check."""
    start = win_starts.long().repeat_interleave(TILE)
    off = gidx.long() - start
    if bool(((off < 0) | (off >= win_w) | (gidx.long() >= tab.shape[0])).any()):
        raise ValueError("a camera id lies outside its tile's window")
    return tab[start + off]


def relin_cm_tabblk_ell_plain(params, cam_mean, lmk_mean, gidx, win_starts, z, lp,
                              jac, r0, srel, act, *, deg, win_w):
    """Plain version of `relin_cm_tabblk_ell`: camera means read from each
    row's tile window."""
    COUNTS.plain["relin_cm_tabblk_ell"] += 1
    return _relin_plain(params, _window_rows(cam_mean, gidx, win_starts, win_w), lmk_mean,
                        z, lp, jac, r0, srel, act, deg=deg)


def _message_math(params, jac, x0, r0_l, prec, srel, act, be0, bl0, be1, bl1,
                  me0, ml0, me1, ml1, *, d0, d1, z, prec_full, huber):
    """Covariance-form factor -> variable messages (the reference's
    `_message_math`) on component lists: Huber weight, cavities with floor
    and jitter, S = sym(Sigma / w + P_other), damping, act select.  prec:
    the z diagonal or z*z full precision components, then the per-row Huber
    threshold when huber == "row".  Returns four component lists."""
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    like = jac[0]
    jm = _mat(jac, z, d0 + d1)
    j0 = [row[:d0] for row in jm]
    j1 = [row[d0:] for row in jm]
    floor_t, jitter_t = _scalar(floor, like), _scalar(jitter, like)
    zero = torch.zeros_like(r0_l[0])

    if prec_full:
        pm = _mat(prec[:z * z], z, z)
        pr = cl.cmv(pm, r0_l)
        m2 = sum(r0_l[i] * pr[i] for i in range(z))
        sigma = cl.cscaled_sym_inv(pm)
    else:
        m2 = sum(prec[i] * r0_l[i] * r0_l[i] for i in range(z))
        sigma = [[1.0 / prec[i] if i == j else zero for j in range(z)] for i in range(z)]
    if huber is not None:
        mm = torch.sqrt(torch.clamp(m2, min=1e-12))
        if huber == "row":
            t = prec[z * z if prec_full else z]
            w = torch.where((mm > t) & (t > 0.0), 2.0 * t / mm - (t * t) / (mm * mm),
                            torch.ones_like(mm))
        else:
            # 2T and T^2 rounded once from the Python float, as the
            # reference's weakly typed scalars are.
            two_h, h_sq = _scalar(2.0 * huber, like), _scalar(huber * huber, like)
            w = torch.where(mm > _scalar(huber, like), two_h / mm - h_sq / (mm * mm),
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

    p0, q0, ml0_m = slot(be0, bl0, me0, ml0, j0, x0[:d0], d0)
    p1, q1, ml1_m = slot(be1, bl1, me1, ml1, j1, x0[d0:], d1)

    undamped = srel >= num_undamped
    damp = torch.where(undamped, _scalar(eta_damping, like), zero)
    ldamp = torch.where(undamped, _scalar(lam_damping, like), zero)
    on = act > 0.5

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
        return oe, ol

    oe0, ol0 = emit(j0, x0[:d0], p1, q1, me0, ml0_m, d0)
    oe1, ol1 = emit(j1, x0[d0:], p0, q0, me1, ml1_m, d1)
    return oe0, ol0, oe1, ol1


def _messages_plain(params, cam_rows, lmk_tab, jac, lp, r0, prec, srel,
                    act, me0, ml0, me1, ml1, *, deg, huber):
    """`_message_math` on component-major state (diagonal prec) with the
    packed camera beliefs already read per row, cam_rows [mp, 42], and the
    landmark beliefs read at r // deg."""
    mp = jac.shape[1]
    rows = torch.arange(mp, device=jac.device) // deg
    cam = _rows(cam_rows.T)
    lmk = _rows(lmk_tab[rows].T)
    out = _message_math(
        params, _rows(jac), _rows(lp), _rows(r0), _rows(prec), srel[0], act[0],
        cam[:D0], cam[D0:], lmk[:D1], lmk[D1:], _rows(me0), _rows(ml0), _rows(me1),
        _rows(ml1), d0=D0, d1=D1, z=Z, prec_full=False, huber=huber)
    return tuple(torch.stack(o) for o in out)


def messages_cm_tab_ell_plain(params, cam_tab, lmk_tab, gidx, jac, lp, r0,
                              prec, srel, act, me0, ml0, me1, ml1, seg_rows,
                              seg_offsets, *, deg, huber):
    """Plain version of `messages_cm_tab_ell`: the four new messages and the
    camera-side sum of the new camera messages [F_CAM, n_cam]."""
    COUNTS.plain["messages_cm_tab_ell"] += 1
    oe0, ol0, oe1, ol1 = _messages_plain(
        params, cam_tab[gidx.long()], lmk_tab, jac, lp, r0, prec, srel, act,
        me0, ml0, me1, ml1, deg=deg, huber=huber)
    return oe0, ol0, oe1, ol1, segsum_by_id_plain(oe0, ol0, seg_rows, seg_offsets)


def messages_cm_tabblk_ell_plain(params, cam_tab, lmk_tab, gidx, win_starts, jac, lp,
                                 r0, prec, srel, act, me0, ml0, me1, ml1, win_rows,
                                 win_offsets, *, deg, huber, win_w):
    """Plain version of `messages_cm_tabblk_ell`: the four new messages and
    the per-tile window partials of the new camera messages
    [n_tiles, F_CAM, win_w]."""
    COUNTS.plain["messages_cm_tabblk_ell"] += 1
    oe0, ol0, oe1, ol1 = _messages_plain(
        params, _window_rows(cam_tab, gidx, win_starts, win_w), lmk_tab, jac, lp, r0,
        prec, srel, act, me0, ml0, me1, ml1, deg=deg, huber=huber)
    part = segsum_cm_blk_plain(oe0, ol0, win_rows, win_offsets,
                               n_tiles=jac.shape[1] // TILE, w=win_w)
    return oe0, ol0, oe1, ol1, part


def _csr_sum(me, ml, rows, offsets, row_major=False):
    """out[k, s] = sum over i in [offsets[s], offsets[s+1]) of comp_k[rows[i]]
    for the components (me | ml); with row_major the operands are [m, d] |
    [m, d*d] and the result [n_seg, d + d*d]."""
    n_seg = offsets.shape[0] - 1
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=me.device), (offsets[1:] - offsets[:-1]).long())
    if row_major:
        vals = torch.cat([me, ml], dim=1)[rows.long()]
        out = torch.zeros((n_seg, vals.shape[1]), dtype=me.dtype, device=me.device)
        return out.index_add_(0, ids, vals)
    vals = torch.cat([me, ml])[:, rows.long()]
    out = torch.zeros((vals.shape[0], n_seg), dtype=me.dtype, device=me.device)
    return out.index_add_(1, ids, vals)


def segsum_by_id_plain(me, ml, seg_rows, seg_offsets, *, row_major=False):
    """Sum the (eta | lam) components of the rows of each segment:
    out[k, s] = sum over i in [offsets[s], offsets[s+1]) of comp_k[rows[i]]
    ([s, k] with row_major)."""
    COUNTS.plain["segsum_by_id"] += 1
    return _csr_sum(me, ml, seg_rows, seg_offsets, row_major)


def segsum_cm_blk_plain(me, ml, win_rows, win_offsets, *, n_tiles, w):
    """Per-tile window partials: part[i, k, j] = sum of component k over
    the rows of tile i with camera id win_starts[i] + j, from the CSR of
    `window_rows_csr` (segment i * w + j)."""
    COUNTS.plain["segsum_cm_blk"] += 1
    out = _csr_sum(me, ml, win_rows, win_offsets)
    return out.reshape(-1, n_tiles, w).permute(1, 0, 2).contiguous()


def scatter_windows_cm_plain(part, win_starts, cov_tiles, cov_offsets, *, n_seg):
    """out[k, c] = sum over the tiles i that cover camera c of
    part[i, k, c - win_starts[i]], in ascending i (the cover lists of
    `window_cover_csr`): pass r adds every camera's r-th covering tile."""
    COUNTS.plain["scatter_windows_cm"] += 1
    f = part.shape[1]
    first = cov_offsets[:-1].long()
    counts = cov_offsets[1:].long() - first
    starts = win_starts.long()
    out = torch.zeros((f, n_seg), dtype=part.dtype, device=part.device)
    cams = torch.arange(n_seg, device=part.device)
    for r in range(int(counts.max()) if n_seg else 0):
        sel = cams[counts > r]
        t = cov_tiles[first[sel] + r].long()
        off = sel - starts[t]
        if bool(((off < 0) | (off >= part.shape[2])).any()):
            raise ValueError("a cover list names a tile whose window does not hold the camera")
        out[:, sel] += part[t, :, off].T
    return out


# --- window index structures (numpy, built once per graph) --------------------


def window_rows_csr(gidx, win_starts, w):
    """CSR of each tile's rows by window column, for `segsum_cm_blk`:
    (rows [mp] int32, offsets [n_tiles * w + 1] int32); segment i * w + j
    lists, in row order, the rows of tile i whose camera id is
    win_starts[i] + j.  Raises if an id lies outside its tile's window."""
    gidx = np.asarray(gidx, dtype=np.int64)
    win_starts = np.asarray(win_starts, dtype=np.int64)
    if gidx.size != win_starts.size * TILE:
        raise ValueError(f"{gidx.size} rows are not {win_starts.size} tiles of {TILE}")
    tile = np.arange(gidx.size) // TILE
    off = gidx - win_starts[tile]
    if ((off < 0) | (off >= w)).any():
        raise ValueError("a camera id lies outside its tile's window")
    key = tile * w + off
    rows = np.argsort(key, kind="stable").astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(key, minlength=win_starts.size * w))]).astype(np.int32)
    return rows, offsets


def window_cover_csr(win_starts, w, n_seg):
    """For `scatter_windows_cm`: per camera c < n_seg the tiles i with
    win_starts[i] <= c < win_starts[i] + w, ascending, as
    (tiles [nnz] int32, offsets [n_seg + 1] int32).  Starts may repeat and
    windows may overlap or reach past n_seg."""
    win_starts = np.asarray(win_starts, dtype=np.int64)
    cams = (win_starts[:, None] + np.arange(w)).reshape(-1)
    tiles = np.repeat(np.arange(win_starts.size), w)
    keep = (cams >= 0) & (cams < n_seg)
    cams, tiles = cams[keep], tiles[keep]
    order = np.argsort(cams, kind="stable")  # stable: tiles stay ascending
    offsets = np.concatenate([[0], np.cumsum(np.bincount(cams, minlength=n_seg))])
    return tiles[order].astype(np.int32), offsets.astype(np.int32)


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


def _check_op(name, t, rows, comps, dtype, row_major):
    """A per-factor operand of `comps` components and `rows` rows, [rows,
    comps] (row_major) or [comps, rows], unit stride along the trailing axis;
    returns (pointer, leading stride).  A slice of a wider array passes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    shape = (rows, comps) if row_major else (comps, rows)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: expected unit stride along the trailing axis")
    ld = t.stride(0) if shape[0] > 1 else shape[1]
    if ld < shape[1]:
        raise ValueError(f"{name}: leading stride {ld} below the row length {shape[1]}")
    return ctypes.c_void_p(t.data_ptr()), ld


def segsum_by_id(me, ml, seg_rows, seg_offsets, *, row_major=False):
    """Deterministic segment sum of me | ml over the CSR (seg_rows sorted by
    segment, seg_offsets [n_seg + 1]): component-major me [d, mp], ml
    [d*d, mp] -> [d + d*d, n_seg], or with row_major me [m, d], ml [m, d*d]
    -> [n_seg, d + d*d].  Two runs give the same bits: no atomics."""
    if not me.is_cuda:
        return segsum_by_id_plain(me, ml, seg_rows, seg_offsets, row_major=row_major)
    from gbp_tpu_torch.ops._build import library

    dt = me.dtype
    d, m = (me.shape[1], me.shape[0]) if row_major else me.shape
    f = d + d * d
    n_seg = seg_offsets.shape[0] - 1
    n_rows = seg_rows.shape[0]
    out = torch.empty((n_seg, f) if row_major else (f, n_seg), dtype=dt, device=me.device)
    me_p, me_ld = _check_op("me", me, m, d, dt, row_major)
    ml_p, ml_ld = _check_op("ml", ml, m, d * d, dt, row_major)
    args = [
        me_p, ctypes.c_int64(me_ld), ml_p, ctypes.c_int64(ml_ld), ctypes.c_int(d),
        ctypes.c_int(row_major),
        _check("seg_rows", seg_rows, (n_rows,), torch.int32),
        _check("seg_offsets", seg_offsets, (n_seg + 1,), torch.int32),
        ctypes.c_int(n_seg), ctypes.c_void_p(out.data_ptr()), _stream(),
    ]
    fn = getattr(library(), f"gbp_segsum_by_id_{_suffix(dt)}")
    _raise_on(fn(*args), "segsum_by_id")
    COUNTS.kernel["segsum_by_id"] += 1
    return out


def _window_smem(name, win_w, width, dt):
    """Raise unless a window of `win_w` table rows of `width` values fits
    one block's shared memory."""
    need = win_w * width * torch.empty((), dtype=dt).element_size()
    if need > SMEM_WINDOW_BYTES:
        raise ValueError(
            f"{name}: a window of {win_w} cameras x {width} values of {dt} takes {need} "
            f"bytes of shared memory; one block has {SMEM_WINDOW_BYTES}")


def window_blocks_per_sm(name, win_w, dtype):
    """Blocks of the windowed kernel `name` ("relin_cm_tabblk_ell" or
    "messages_cm_tabblk_ell") that one SM holds at once when each stages a
    window of `win_w` cameras, as the CUDA occupancy calculator reports it."""
    from gbp_tpu_torch.ops._build import library

    n = getattr(library(), f"gbp_{name}_blocks_per_sm_{_suffix(dtype)}")(ctypes.c_int(win_w))
    _raise_on(max(-n, 0), f"{name} occupancy")
    return n


def _tiles(name, mp):
    if mp <= 0 or mp % TILE:
        raise ValueError(f"{name}: mp={mp} is not a positive multiple of the tile ({TILE} rows)")
    return mp // TILE


def relin_cm_tabblk_ell(params, cam_mean, lmk_mean, gidx, win_starts, z, lp, jac, r0,
                        srel, act, *, deg, win_w):
    """`relin_cm_tab_ell` for large scenes: the block of tile i stages rows
    [win_starts[i], win_starts[i] + win_w) of cam_mean and a row reads its
    camera at gidx[r] - win_starts[i].  win_starts [mp / TILE] int32.  An id
    outside its tile's window stops the kernel (a fault of `prepare`)."""
    if not lp.is_cuda:
        return relin_cm_tabblk_ell_plain(params, cam_mean, lmk_mean, gidx, win_starts, z,
                                         lp, jac, r0, srel, act, deg=deg, win_w=win_w)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    n_cam, nv = cam_mean.shape[0], lmk_mean.shape[0]
    n_tiles = _tiles("relin_cm_tabblk_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"relin_cm_tabblk_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("relin_cm_tabblk_ell", win_w, D0, dt)
    out = [torch.empty((f, mp), dtype=dt, device=lp.device) for f in (T, Z * T, Z, 1)]
    args = [
        _check("cam_mean", cam_mean, (n_cam, D0), dt), ctypes.c_int(n_cam),
        _check("lmk_mean", lmk_mean, (nv, D1), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        _check("z", z, (Z, mp), dt), _check("lp", lp, (T, mp), dt),
        _check("jac", jac, (Z * T, mp), dt), _check("r0", r0, (Z, mp), dt),
        _check("srel", srel, (1, mp), dt), _check("act", act, (1, mp), dt),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg),
        ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tabblk_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tabblk_ell")
    COUNTS.kernel["relin_cm_tabblk_ell"] += 1
    return tuple(out)


def messages_cm_tabblk_ell(params, cam_tab, lmk_tab, gidx, win_starts, jac, lp, r0,
                           prec, srel, act, me0, ml0, me1, ml1, win_rows, win_offsets,
                           *, deg, huber, win_w):
    """`messages_cm_tab_ell` for large scenes; returns (eta0, lam0, eta1,
    lam1, part) like the reference: part [mp / TILE, 42, win_w] holds the
    per-tile window partials of the new camera messages (`segsum_cm_blk` on
    the outputs), to be combined by `scatter_windows_cm`."""
    if not jac.is_cuda:
        return messages_cm_tabblk_ell_plain(
            params, cam_tab, lmk_tab, gidx, win_starts, jac, lp, r0, prec, srel, act,
            me0, ml0, me1, ml1, win_rows, win_offsets, deg=deg, huber=huber, win_w=win_w)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    n_cam, nv = cam_tab.shape[0], lmk_tab.shape[0]
    n_tiles = _tiles("messages_cm_tabblk_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"messages_cm_tabblk_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("messages_cm_tabblk_ell", win_w, F_CAM, dt)
    out = [torch.empty((f, mp), dtype=dt, device=jac.device)
           for f in (D0, D0 * D0, D1, D1 * D1)]
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    args = [
        _check("cam_tab", cam_tab, (n_cam, F_CAM), dt), ctypes.c_int(n_cam),
        _check("lmk_tab", lmk_tab, (nv, F_LMK), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
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
    fn = getattr(library(), f"gbp_messages_cm_tabblk_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tabblk_ell")
    COUNTS.kernel["messages_cm_tabblk_ell"] += 1
    return (*out, segsum_cm_blk(out[0], out[1], win_rows, win_offsets, n_tiles=n_tiles, w=win_w))


def segsum_cm_blk(me, ml, win_rows, win_offsets, *, n_tiles, w):
    """Deterministic per-tile window partials [n_tiles, d + d*d, w] of
    me [d, mp] | ml [d*d, mp] over the CSR of `window_rows_csr`: one thread
    per output adds its rows in CSR order.  Two runs give the same bits."""
    if not me.is_cuda:
        return segsum_cm_blk_plain(me, ml, win_rows, win_offsets, n_tiles=n_tiles, w=w)
    from gbp_tpu_torch.ops._build import library

    dt = me.dtype
    d, mp = me.shape
    if n_tiles != _tiles("segsum_cm_blk", mp):
        raise ValueError(f"segsum_cm_blk: n_tiles={n_tiles} but mp={mp} holds {mp // TILE} tiles")
    f = d + d * d
    if not 0 < f <= 65535 or w <= 0:
        raise ValueError(f"segsum_cm_blk: d={d}, w={w} out of range")
    out = torch.empty((n_tiles, f, w), dtype=dt, device=me.device)
    args = [
        _check("me", me, (d, mp), dt), _check("ml", ml, (d * d, mp), dt), ctypes.c_int(d),
        _check("win_rows", win_rows, (mp,), torch.int32),
        _check("win_offsets", win_offsets, (n_tiles * w + 1,), torch.int32),
        ctypes.c_int(n_tiles), ctypes.c_int(w), ctypes.c_int64(mp),
        ctypes.c_void_p(out.data_ptr()), _stream(),
    ]
    fn = getattr(library(), f"gbp_segsum_cm_blk_{_suffix(dt)}")
    _raise_on(fn(*args), "segsum_cm_blk")
    COUNTS.kernel["segsum_cm_blk"] += 1
    return out


def scatter_windows_cm(part, win_starts, cov_tiles, cov_offsets, *, n_seg):
    """Combine per-tile window partials part [n_tiles, f, w] into [f, n_seg]:
    out[k, c] = sum over the tiles i covering c of part[i, k, c -
    win_starts[i]], in ascending i.  (cov_tiles, cov_offsets) are the cover
    lists of `window_cover_csr`; starts are int32.  Deterministic."""
    if not part.is_cuda:
        return scatter_windows_cm_plain(part, win_starts, cov_tiles, cov_offsets, n_seg=n_seg)
    from gbp_tpu_torch.ops._build import library

    dt = part.dtype
    n_tiles, f, w = part.shape
    if not 0 < f <= 65535:
        raise ValueError(f"scatter_windows_cm: f={f} out of range")
    out = torch.empty((f, n_seg), dtype=dt, device=part.device)
    args = [
        _check("part", part, (n_tiles, f, w), dt),
        _check("win_starts", win_starts, (n_tiles,), torch.int32),
        _check("cov_tiles", cov_tiles, (cov_tiles.shape[0],), torch.int32),
        _check("cov_offsets", cov_offsets, (n_seg + 1,), torch.int32),
        ctypes.c_int(f), ctypes.c_int(w), ctypes.c_int(n_seg),
        ctypes.c_void_p(out.data_ptr()), _stream(),
    ]
    fn = getattr(library(), f"gbp_scatter_windows_cm_{_suffix(dt)}")
    _raise_on(fn(*args), "scatter_windows_cm")
    COUNTS.kernel["scatter_windows_cm"] += 1
    return out


# --- expanded operands: both slots' beliefs arrive per factor row ---------------


def _row_shape(name, d0, d1, z):
    if (d0, d1, z) not in ROW_SHAPES:
        item = ROW_SHAPES_QUEUED.get((d0, d1, z))
        raise NotImplementedError(
            f"{name}: the kernel is not instantiated for (d0, d1, z) = ({d0}, {d1}, {z})"
            + (f" (ROADMAP {item})" if item else ""))


def _huber_mode(huber, prec_full):
    """(per-row mode, has scalar, scalar value) of the static huber argument:
    None | float | "row"."""
    if huber is None:
        return False, False, 0.0
    if isinstance(huber, str):
        if huber != "row":
            raise ValueError(f"huber must be None, a number or 'row', got {huber!r}")
        if prec_full:
            raise ValueError("per-row Huber thresholds require diagonal precision")
        return True, False, 0.0
    return False, True, float(huber)


def _prec_comps(z, prec_full, huber):
    return (z * z if prec_full else z) + int(isinstance(huber, str))


def _comps(a, row_major):
    """The components of an operand as a list of [rows] tensors."""
    return [a[:, k] for k in range(a.shape[1])] if row_major else _rows(a)


def _stack(comps, row_major):
    return torch.stack(comps, dim=1 if row_major else 0)


def _as_col(a, dt, row_major):
    """A per-row scalar operand ([m], [m, 1] or [1, mp]) as the layout's
    one-component operand of dtype dt."""
    a = a.to(dt)
    if a.ndim == 1:
        a = a[:, None] if row_major else a[None]
    return a


def _messages_any_plain(params, ops, *, row_major, d0, d1, z, prec_full, huber):
    jac, x0, r0, prec, srel, act = ops[:6]
    dt = jac.dtype
    _huber_mode(huber, prec_full)
    c = lambda a: _comps(a, row_major)
    out = _message_math(
        params, c(jac), c(x0), c(r0), c(prec), c(_as_col(srel, dt, row_major))[0],
        c(_as_col(act, dt, row_major))[0], *(c(a) for a in ops[6:]),
        d0=d0, d1=d1, z=z, prec_full=prec_full, huber=huber)
    return tuple(_stack(o, row_major) for o in out)


def _messages_any(name, params, ops, *, row_major, d0, d1, z, prec_full, huber):
    """Launch the expanded-operand messages kernel in one layout; `ops` are
    (jac, x0, r0, prec, srel, act, be0, bl0, be1, bl1, me0, ml0, me1, ml1)."""
    from gbp_tpu_torch.ops._build import library

    _row_shape(name, d0, d1, z)
    huber_row, has_huber, huber_val = _huber_mode(huber, prec_full)
    jac = ops[0]
    dt = jac.dtype
    m = jac.shape[0] if row_major else jac.shape[1]
    t = d0 + d1
    widths = (z * t, t, z, _prec_comps(z, prec_full, huber), 1, 1,
              d0, d0 * d0, d1, d1 * d1, d0, d0 * d0, d1, d1 * d1)
    names = ("jac", "x0", "r0", "prec", "srel", "act", "be0", "bl0", "be1", "bl1",
             "me0", "ml0", "me1", "ml1")
    ops = list(ops)
    ops[4], ops[5] = _as_col(ops[4], dt, row_major), _as_col(ops[5], dt, row_major)
    checked = [_check_op(f"{name}: {n}", a, m, w, dt, row_major)
               for n, a, w in zip(names, ops, widths)]
    out = [torch.empty((m, w) if row_major else (w, m), dtype=dt, device=jac.device)
           for w in (d0, d0 * d0, d1, d1 * d1)]
    out_ld = [o.shape[1] for o in out]
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    fn = getattr(library(), f"gbp_messages_rows_{_suffix(dt)}")
    rc = fn(d0, d1, z, int(row_major), int(prec_full), int(huber_row),
            (ctypes.c_void_p * 14)(*[p for p, _ in checked]),
            (ctypes.c_int64 * 14)(*[ld for _, ld in checked]),
            (ctypes.c_void_p * 4)(*[o.data_ptr() for o in out]),
            (ctypes.c_int64 * 4)(*out_ld), m, eta_damping, lam_damping, num_undamped,
            floor, jitter, int(has_huber), huber_val, _stream())
    _raise_on(rc, name)
    COUNTS.kernel[name] += 1
    return tuple(out)


def _relin_any_plain(params, ops, *, row_major, comp_name):
    x, z_meas, lp, jac, r0, srel, act = ops
    dt = x.dtype
    c = lambda a: _comps(a, row_major)
    lp_n, jac_n, r0_n, srel_n = _relin_math(
        params, c(x), c(z_meas), c(lp), c(jac), c(r0), c(_as_col(srel, dt, row_major))[0],
        c(_as_col(act, dt, row_major))[0], comp_name)
    return (_stack(lp_n, row_major), _stack(jac_n, row_major), _stack(r0_n, row_major),
            _stack([srel_n], row_major))


def _relin_any(name, params, ops, *, row_major, d0, d1, z, comp_name):
    """Launch the expanded-operand relinearization kernel in one layout;
    `ops` are (x, z_meas, lp, jac, r0, srel, act)."""
    from gbp_tpu_torch.ops._build import library

    comp_model(comp_name)  # raises for a model that is not ported
    if (d0, d1, z) != (D0, D1, Z):
        raise NotImplementedError(
            f"{name}: the kernel holds the reprojection_normalized model, (d0, d1, z) = "
            f"({D0}, {D1}, {Z}); got ({d0}, {d1}, {z}) (ROADMAP A7/A8)")
    x = ops[0]
    dt = x.dtype
    m = x.shape[0] if row_major else x.shape[1]
    ops = list(ops)
    ops[5], ops[6] = _as_col(ops[5], dt, row_major), _as_col(ops[6], dt, row_major)
    names = ("x", "z", "lp", "jac", "r0", "srel", "act")
    checked = [_check_op(f"{name}: {n}", a, m, w, dt, row_major)
               for n, a, w in zip(names, ops, (T, Z, T, Z * T, Z, 1, 1))]
    out = [torch.empty((m, w) if row_major else (w, m), dtype=dt, device=x.device)
           for w in (T, Z * T, Z, 1)]
    fn = getattr(library(), f"gbp_relin_rows_{_suffix(dt)}")
    rc = fn(int(row_major),
            (ctypes.c_void_p * 7)(*[p for p, _ in checked]),
            (ctypes.c_int64 * 7)(*[ld for _, ld in checked]),
            (ctypes.c_void_p * 4)(*[o.data_ptr() for o in out]),
            (ctypes.c_int64 * 4)(*[o.shape[1] for o in out]), m, params[4], params[5],
            _stream())
    _raise_on(rc, name)
    COUNTS.kernel[name] += 1
    return tuple(out)


def _no_fargs(name, fargs):
    if fargs is not None:
        raise NotImplementedError(
            f"{name}: per-factor model arguments are not ported yet (ROADMAP A7)")


def messages_cm_plain(params, jac, x0, r0, prec, srel, act, be0, bl0, be1, bl1,
                      me0, ml0, me1, ml1, *, d0, d1, z, prec_full, huber):
    """Plain version of `messages_cm`."""
    COUNTS.plain["messages_cm"] += 1
    return _messages_any_plain(
        params, (jac, x0, r0, prec, srel, act, be0, bl0, be1, bl1, me0, ml0, me1, ml1),
        row_major=False, d0=d0, d1=d1, z=z, prec_full=prec_full, huber=huber)


def messages_cm(params, jac, x0, r0, prec, srel, act, be0, bl0, be1, bl1,
                me0, ml0, me1, ml1, *, d0, d1, z, prec_full, huber):
    """Factor -> variable messages on component-major operands [F, mp] with
    both slots' beliefs expanded per row (be* [d, mp], bl* [d*d, mp]);
    returns (eta0, lam0, eta1, lam1), component-major.  prec [z | z*z (+1),
    mp]; huber None, the scalar threshold, or "row"."""
    ops = (jac, x0, r0, prec, srel, act, be0, bl0, be1, bl1, me0, ml0, me1, ml1)
    if not jac.is_cuda:
        return messages_cm_plain(params, *ops, d0=d0, d1=d1, z=z, prec_full=prec_full,
                                 huber=huber)
    return _messages_any("messages_cm", params, ops, row_major=False, d0=d0, d1=d1, z=z,
                         prec_full=prec_full, huber=huber)


def relin_cm_plain(params, x, z_meas, fargs, linpoint, jac, r0, srel, act, *,
                   d0, d1, z, comp_name):
    """Plain version of `relin_cm`."""
    del d0, d1, z
    _no_fargs("relin_cm", fargs)
    COUNTS.plain["relin_cm"] += 1
    return _relin_any_plain(params, (x, z_meas, linpoint, jac, r0, srel, act),
                            row_major=False, comp_name=comp_name)


def relin_cm(params, x, z_meas, fargs, linpoint, jac, r0, srel, act, *,
             d0, d1, z, comp_name):
    """Masked relinearization on component-major operands [F, mp], the
    adjacent means x [t, mp] expanded per row; returns (lp, jac, r0, srel)."""
    if not x.is_cuda:
        return relin_cm_plain(params, x, z_meas, fargs, linpoint, jac, r0, srel, act,
                              d0=d0, d1=d1, z=z, comp_name=comp_name)
    _no_fargs("relin_cm", fargs)
    return _relin_any("relin_cm", params, (x, z_meas, linpoint, jac, r0, srel, act),
                      row_major=False, d0=d0, d1=d1, z=z, comp_name=comp_name)


def fused_messages_plain(params, jac, x0, r0, prec, since_relin, active, be0, bl0, be1,
                         bl1, me0, ml0, me1, ml1, *, d0, d1, z, prec_full, huber):
    """Plain version of `fused_messages`."""
    COUNTS.plain["fused_messages"] += 1
    return _messages_any_plain(
        params, (jac, x0, r0, prec, since_relin, active, be0, bl0, be1, bl1, me0, ml0,
                 me1, ml1),
        row_major=True, d0=d0, d1=d1, z=z, prec_full=prec_full, huber=huber)


def fused_messages(params, jac, x0, r0, prec, since_relin, active, be0, bl0, be1, bl1,
                   me0, ml0, me1, ml1, *, d0, d1, z, prec_full, huber):
    """Factor -> variable messages of one 2-slot factor block on row-major
    operands, matrices flattened ([m, z*t], [m, d*d], ...); since_relin and
    active are [m].  Returns (eta0 [m, d0], lam0 [m, d0*d0], eta1, lam1)."""
    ops = (jac, x0, r0, prec, since_relin, active, be0, bl0, be1, bl1, me0, ml0, me1, ml1)
    if not jac.is_cuda:
        return fused_messages_plain(params, *ops, d0=d0, d1=d1, z=z, prec_full=prec_full,
                                    huber=huber)
    return _messages_any("fused_messages", params, ops, row_major=True, d0=d0, d1=d1, z=z,
                         prec_full=prec_full, huber=huber)


def fused_relin_messages_plain(params, x, z_meas, fargs, linpoint, jac, r0, prec,
                               since_relin, active, be0, bl0, be1, bl1, me0, ml0, me1, ml1,
                               *, d0, d1, z, prec_full, huber, comp_name):
    """Plain version of `fused_relin_messages`."""
    _no_fargs("fused_relin_messages", fargs)
    COUNTS.plain["fused_relin_messages"] += 1
    lp, jc, r0n, srel = _relin_any_plain(
        params, (x, z_meas, linpoint, jac, r0, since_relin, active), row_major=True,
        comp_name=comp_name)
    out = fused_messages_plain(params, jc, lp, r0n, prec, srel, active, be0, bl0, be1, bl1,
                               me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
                               huber=huber)
    return (*out, lp, jc, r0n, srel)


def fused_relin_messages(params, x, z_meas, fargs, linpoint, jac, r0, prec, since_relin,
                         active, be0, bl0, be1, bl1, me0, ml0, me1, ml1, *, d0, d1, z,
                         prec_full, huber, comp_name):
    """Masked relinearization at the adjacent means x [m, t], then the
    message update on the new linearization (`fused_messages`), row-major.
    Returns (eta0, lam0, eta1, lam1, linpoint, jac [m, z*t], r0, since_relin
    [m, 1] as float)."""
    if not x.is_cuda:
        return fused_relin_messages_plain(
            params, x, z_meas, fargs, linpoint, jac, r0, prec, since_relin, active, be0, bl0,
            be1, bl1, me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
            huber=huber, comp_name=comp_name)
    _no_fargs("fused_relin_messages", fargs)
    lp, jc, r0n, srel = _relin_any(
        "fused_relin_messages", params, (x, z_meas, linpoint, jac, r0, since_relin, active),
        row_major=True, d0=d0, d1=d1, z=z, comp_name=comp_name)
    out = fused_messages(params, jc, lp, r0n, prec, srel, active, be0, bl0, be1, bl1,
                         me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
                         huber=huber)
    return (*out, lp, jc, r0n, srel)
