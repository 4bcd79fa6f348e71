"""The port's twenty kernels: wrappers, plain versions, launch counts.

Each function dispatches on where its tensors lie: CUDA tensors go to the
hand-written kernel in csrc/*.cu (built on first use by ops/_build.py), CPU
tensors to the `*_plain` version beside it.  There is no fallback: a CUDA
tensor that the kernel does not take raises.

Layout: component-major, every per-factor operand is [F, mp] (component k
of factor row r at [k, r]), the memory order of the reference's
[F, mp/128, 128].  One slot is gathered by id from a per-variable table
(slot `gslot`), the other is the ELL slot (row r belongs to variable
r // deg).  The table kernels are instantiated for TABLE_SHAPES, each with
either slot gathered: (6, 3, 2) cameras and landmarks under
`reprojection_normalized`, with the cameras gathered (gslot 0) or, on a
graph with more cameras than landmarks, the landmarks gathered and the
cameras in the ELL slot (gslot 1), and (3, 3, 3) SE(2) and (6, 6, 6) SE(3)
poses under `se2_between` / `se3_between` (both slots on one variable
block); a wrapper reads the shape off its operands.  The names of
the arguments keep the bundle-adjustment words (cam = gathered slot, lmk =
ELL slot).  (9, 3, 2) is the 9-dof BAL camera of
`bal_reprojection_intrinsics`.  Every relinearization entry takes the
per-row factor arguments `fargs` of models that read them
(`bal_reprojection_normalized`: [k1, k2]) as an operand [n_args, mp]
([m, n_args] row-major), None for the others.

  relin_cm_tab_ell     replaces gbp_tpu.ops.messages_pallas.fused_relin_cm_tab_ell
  messages_cm_tab_ell  replaces gbp_tpu.ops.messages_pallas.fused_messages_cm_tab_ell
  segsum_by_id         replaces gbp_tpu.ops.messages_pallas.segsum_cm and the
                       5th output of fused_messages_cm_tab_ell (csrc/segsum.cu;
                       the chunked or the short form by `segsum_form`)

Large scenes (csrc/windows.cu): rows are cut into tiles of TILE rows and
every camera id of tile i lies in the window [win_starts[i], win_starts[i] +
win_w), so a block stages only its tile's window of the camera table (the
messages kernels: persistent blocks over units of rows, each bringing in the
window of every tile its units enter; `window_plan`).

  relin_cm_tabblk_ell     replaces fused_relin_cm_tabblk_ell
  messages_cm_tabblk_ell  replaces fused_messages_cm_tabblk_ell
  segsum_cm_blk           replaces the kernel stage of segsum_cm_blk and the
                          5th output of fused_messages_cm_tabblk_ell: per-tile
                          window partials [n_tiles, F, w]
  scatter_windows_cm      replaces scatter_windows_cm: the partials combined
                          over the overlapping windows, tiles in ascending order;
                          the kernel walks per block of SCATTER_CAMS cameras the
                          tiles of `window_block_csr` (its index operand; the
                          plain version walks per camera the cover lists of
                          `window_cover_csr`, built from the starts)

Expanded operands (csrc/rows.cu): both slots' beliefs arrive per factor row
instead of from a table, for any instantiated (d0, d1, z), diagonal or full
precision, Huber none / scalar / per row ("row": the thresholds ride as the
component after the precision, 0 = off for that row).  Every operand is
passed with its leading stride, so slices of wider arrays are taken in
place.  Component-major operands are read where they lie; row-major ones
are staged a tile of rows per block through shared memory (the outputs then
leave the same way, so they must be fresh contiguous tensors, as the
wrappers allocate them); the per-row arithmetic is the same in both, and so
are the bits.

  messages_cm           replaces fused_messages_cm      (operands [F, mp])
  relin_cm              replaces fused_relin_cm         (operands [F, mp])
  fused_messages        replaces fused_messages         (operands [m, F])
  fused_relin_messages  replaces fused_relin_messages   (operands [m, F]): the
                        relinearization kernel, then `fused_messages` on the
                        new linearization

The unfused table path (csrc/unfused.cu; `prepare(ell_fused=False)`, and by
itself at ELL degree 1): the gathered slot from the table in shared memory,
the ELL slot from expanded operands.

  expand_ell_blk   replaces expand_ell_blk: the packed ELL-slot table
                   [nv, f] expanded to [f, mp], out[k, r] = tab[r // deg, k]
  relin_cm_tab     replaces fused_relin_cm_tab
  messages_cm_tab  replaces fused_messages_cm_tab (no sum folded in: the
                   sweep calls `segsum_by_id`)

The windowed unfused path (csrc/unfused_win.cu; `prepare(ell_fused=False)`
with engaged camera windows, and by itself at ELL degree 1 where windows
engage): the gathered slot from the tile's camera window in shared memory,
the ELL slot from expanded operands.

  relin_cm_tabblk     replaces fused_relin_cm_tabblk
  messages_cm_tabblk  replaces fused_messages_cm_tabblk (no sum folded in: the
                      sweep calls `segsum_cm_blk` and `scatter_windows_cm`)

The halo paths' windowed kernels (csrc/halo.cuh; parallel/halo_cm.py when a
partition's camera windows engage): the gathered slot of a partition's
factor rows from two sources, ids below n_own from the tile's window of the
owned table, ids from n_own on from row id - n_own of the partition's ghost
table gtab (its ghost beliefs, then duplicated cut-camera rows), read from
device memory.  No sum is folded in.

  relin_cm_tabblkg_ell     replaces fused_relin_cm_tabblkg_ell
  messages_cm_tabblkg_ell  replaces fused_messages_cm_tabblkg_ell
  relin_cm_tabblkg         replaces fused_relin_cm_tabblkg (ELL slot expanded)
  messages_cm_tabblkg      replaces fused_messages_cm_tabblkg (ELL slot expanded)
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gbp_tpu_torch.ops import comp_linalg as cl
from gbp_tpu_torch.ops.comp_factors import comp_model, comp_n_args, comp_residual

D0, D1, Z = 6, 3, 2  # bundle adjustment: camera dofs, landmark dofs, measurement dim
F_CAM = D0 + D0 * D0  # packed camera belief row: eta | lam
TILE = 1024  # rows per window tile, the reference's grid tile (8 x 128)
# The most dynamic shared memory one block can ask for on sm_90 (the windowed
# kernels' limit), and the static shared memory the full-table kernels stage
# their table in.
SMEM_WINDOW_BYTES = 232448
SMEM_TABLE_BYTES = 48 * 1024
N_SM = 132  # streaming multiprocessors of the H100 SXM
# segsum_by_id's chunked form: rows per chunk, powers of two between these.
SEGSUM_CHUNK_MIN, SEGSUM_CHUNK_MAX = 256, 8192
SCATTER_CAMS = 128  # cameras per block of scatter_windows_cm's kernel
KERNELS = ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id",
           "relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
           "scatter_windows_cm", "messages_cm", "relin_cm", "fused_messages",
           "fused_relin_messages", "messages_cm_tab", "relin_cm_tab", "expand_ell_blk",
           "messages_cm_tabblk", "relin_cm_tabblk", "messages_cm_tabblkg", "relin_cm_tabblkg",
           "messages_cm_tabblkg_ell", "relin_cm_tabblkg_ell")
# (d0, d1, z) the expanded-operand messages kernel is instantiated for.
ROW_SHAPES = ((6, 3, 2), (1, 1, 1), (3, 3, 3), (6, 6, 6), (9, 3, 2))
# (d0, d1, z) of the table kernels, each instantiated with either slot
# gathered, and the measurement models of the relinearization kernels with
# their ids in the C entries.
TABLE_SHAPES = ((6, 3, 2), (3, 3, 3), (6, 6, 6), (9, 3, 2))
MODELS = {"reprojection_normalized": (0, (6, 3, 2)), "se2_between": (1, (3, 3, 3)),
          "se3_between": (2, (6, 6, 6)), "bal_reprojection_normalized": (3, (6, 3, 2)),
          "bal_reprojection_intrinsics": (4, (9, 3, 2))}
BA_MODEL = "reprojection_normalized"


@dataclasses.dataclass
class Counts:
    """Plain-integer counts: `kernel[name]` grows by one where a wrapper
    launches its kernel, `plain[name]` where the plain version runs, and
    `segsum_forms[form]` by the form of each `segsum_by_id` launch."""

    kernel: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KERNELS, 0))
    plain: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KERNELS, 0))
    segsum_forms: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(("chunked", "short"), 0))

    def reset(self):
        for d in (self.kernel, self.plain, self.segsum_forms):
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


def _relin_math(params, x, z, fargs, lp_o, jac_o, r0_o, srel, act, comp_name):
    """Masked relinearization (the reference's `_relin_math`) on component
    lists: x the adjacent means, fargs the model's per-row argument
    components (None when it reads none), srel and act one tensor each.

    eligible = ||x - lp||^2 > beta^2 and srel >= min_linear_iters and act.
    Eligible rows take lp = x, the new (J, r0 = z - h, or the factor type's
    own residual: angle wrap, manifold log) and srel = 0; the others keep
    their state and srel + 1.  Returns (lp, jac, r0) as lists and the new
    srel."""
    comp_fn = comp_model(comp_name)
    res_fn = comp_residual(comp_name)
    t, zd = len(x), len(z)
    beta = _scalar(params[4], lp_o[0])
    dist2 = sum((x[i] - lp_o[i]) * (x[i] - lp_o[i]) for i in range(t))
    eligible = (dist2 > beta * beta) & (srel >= params[5]) & (act > 0.5)
    h, j_new = comp_fn(x, fargs)
    r_new = res_fn(z, h) if res_fn is not None else [z[i] - h[i] for i in range(zd)]
    jac_new = [j_new[i][j] for i in range(zd) for j in range(t)]
    sel = lambda new, old: [torch.where(eligible, a, b) for a, b in zip(new, old)]
    return (sel(x, lp_o), sel(jac_new, jac_o), sel(r_new, r0_o),
            torch.where(eligible, torch.zeros_like(srel), srel + 1.0))


def _n_args(name, fargs, comp_name):
    """The per-row arguments model `comp_name` reads; raises when the
    operand `fargs` (None for none) and the model disagree."""
    n_args = comp_n_args(comp_name)
    if (fargs is None) != (n_args == 0):
        raise ValueError(f"{name}: model {comp_name!r} reads {n_args} per-row arguments, got "
                         f"{'none' if fargs is None else tuple(fargs.shape)}")
    return n_args


def _fargs_comps(name, fargs, comp_name, row_major=False):
    """The per-row argument components of model `comp_name`, or None when it
    reads none."""
    n_args = _n_args(name, fargs, comp_name)
    return None if fargs is None else _comps(fargs, row_major)[:n_args]


def _relin_cm(params, x, z, fargs, lp, jac, r0, srel, act, comp_name):
    """`_relin_math` on component-major state, x the adjacent means as a
    component list, fargs [n_args, mp] or None."""
    lp_n, jac_n, r0_n, srel_n = _relin_math(
        params, x, _rows(z), _fargs_comps("relin", fargs, comp_name), _rows(lp), _rows(jac),
        _rows(r0), srel[0], act[0], comp_name)
    return torch.stack(lp_n), torch.stack(jac_n), torch.stack(r0_n), srel_n[None]


def _by_slot(gat, ell, gslot):
    """(slot 0's, slot 1's) of the gathered and the ELL slot's operand."""
    return (gat, ell) if gslot == 0 else (ell, gat)


def _relin_plain(params, cam_rows, lmk_mean, z, fargs, lp, jac, r0, srel, act, *, deg,
                 comp_name, gslot):
    """`_relin_cm` with the gathered slot's means already read per row,
    cam_rows [mp, d_g]: x joins cam_rows[r] and lmk_mean[r // deg] in slot
    order."""
    rows = torch.arange(lp.shape[1], device=lp.device) // deg
    x0, x1 = _by_slot(_rows(cam_rows.T), _rows(lmk_mean[rows].T), gslot)
    return _relin_cm(params, x0 + x1, z, fargs, lp, jac, r0, srel, act, comp_name)


def relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0,
                           srel, act, *, deg, comp_name=BA_MODEL, gslot=0, fargs=None):
    """Plain version of `relin_cm_tab_ell`: gathered-slot means read by id
    from the whole table."""
    COUNTS.plain["relin_cm_tab_ell"] += 1
    return _relin_plain(params, cam_mean[gidx.long()], lmk_mean, z, fargs, lp, jac, r0,
                        srel, act, deg=deg, comp_name=comp_name, gslot=gslot)


def _relin_other_plain(params, x_other, gat_rows, z, fargs, lp, jac, r0, srel, act, *,
                       comp_name, gslot):
    """`_relin_cm` with x joining the gathered slot's rows gat_rows [mp, d_g]
    and the expanded operand x_other [d_o, mp] in slot order."""
    x0, x1 = _by_slot(_rows(gat_rows.T), _rows(x_other), gslot)
    return _relin_cm(params, x0 + x1, z, fargs, lp, jac, r0, srel, act, comp_name)


def relin_cm_tab_plain(params, x_other, mtab, gidx, z, fargs, lp, jac, r0, srel, act, *,
                       comp_name, gslot=0):
    """Plain version of `relin_cm_tab`: x joins mtab[gidx[r]] and
    x_other[:, r] in slot order."""
    COUNTS.plain["relin_cm_tab"] += 1
    return _relin_other_plain(params, x_other, mtab[gidx.long()], z, fargs, lp, jac, r0, srel,
                              act, comp_name=comp_name, gslot=gslot)


def relin_cm_tabblk_plain(params, x_other, mtab, gidx, win_starts, z, fargs, lp, jac, r0, srel,
                          act, *, win_w, comp_name, gslot=0):
    """Plain version of `relin_cm_tabblk`: the gathered slot's means read
    from each row's tile window, the other slot's from x_other [d_o, mp]."""
    COUNTS.plain["relin_cm_tabblk"] += 1
    return _relin_other_plain(params, x_other, _window_rows(mtab, gidx, win_starts, win_w), z,
                              fargs, lp, jac, r0, srel, act, comp_name=comp_name, gslot=gslot)


def _window_rows(tab, gidx, win_starts, win_w):
    """tab[start + (gidx - start)] per row, start the row's tile's window
    start: the read the windowed kernels make, with their in-window check."""
    start = win_starts.long().repeat_interleave(TILE)
    off = gidx.long() - start
    if bool(((off < 0) | (off >= win_w) | (gidx.long() >= tab.shape[0])).any()):
        raise ValueError("a camera id lies outside its tile's window")
    return tab[start + off]


def relin_cm_tabblk_ell_plain(params, cam_mean, lmk_mean, gidx, win_starts, z, lp,
                              jac, r0, srel, act, *, deg, win_w, comp_name=BA_MODEL,
                              gslot=0, fargs=None):
    """Plain version of `relin_cm_tabblk_ell`: gathered-slot means read from
    each row's tile window."""
    COUNTS.plain["relin_cm_tabblk_ell"] += 1
    return _relin_plain(params, _window_rows(cam_mean, gidx, win_starts, win_w), lmk_mean,
                        z, fargs, lp, jac, r0, srel, act, deg=deg, comp_name=comp_name,
                        gslot=gslot)


def _halo_rows(tab, gtab, gidx, win_starts, win_w, n_own):
    """Per row its gathered variable's table row on the halo paths: ids
    below n_own from the row's tile window of `tab`, the others row id -
    n_own of the ghost table `gtab`; the reads the kernels make, with their
    checks."""
    ids = gidx.long()
    own = ids < n_own
    start = win_starts.long().repeat_interleave(TILE)
    off = ids - start
    n_in = torch.clamp(tab.shape[0] - start, max=win_w)
    if bool((own & ((off < 0) | (off >= n_in))).any()):
        raise ValueError("an owned camera id lies outside its tile's window")
    if bool((~own & (ids - n_own >= gtab.shape[0])).any()):
        raise ValueError("a ghost camera id lies beyond the ghost table")
    zero = torch.zeros_like(ids)
    return torch.where(own[:, None], tab[torch.where(own, ids, zero)],
                       gtab[torch.where(own, zero, ids - n_own)])


def relin_cm_tabblkg_ell_plain(params, cam_mean, gtab, lmk_mean, gidx, win_starts, z, lp, jac,
                               r0, srel, act, *, deg, win_w, n_own, comp_name=BA_MODEL, gslot=0,
                               fargs=None):
    """Plain version of `relin_cm_tabblkg_ell`: gathered-slot means from
    each row's tile window of the owned means or from the ghost mean table,
    ELL-slot means at r // deg."""
    COUNTS.plain["relin_cm_tabblkg_ell"] += 1
    return _relin_plain(params, _halo_rows(cam_mean, gtab, gidx, win_starts, win_w, n_own),
                        lmk_mean, z, fargs, lp, jac, r0, srel, act, deg=deg,
                        comp_name=comp_name, gslot=gslot)


def relin_cm_tabblkg_plain(params, x_other, mtab, gtab, gidx, win_starts, z, fargs, lp, jac, r0,
                           srel, act, *, win_w, n_own, comp_name, gslot=0):
    """Plain version of `relin_cm_tabblkg`: gathered-slot means as in
    `relin_cm_tabblkg_ell_plain`, the other slot's from x_other [d_o, mp]."""
    COUNTS.plain["relin_cm_tabblkg"] += 1
    return _relin_other_plain(params, x_other,
                              _halo_rows(mtab, gtab, gidx, win_starts, win_w, n_own), z, fargs,
                              lp, jac, r0, srel, act, comp_name=comp_name, gslot=gslot)


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


def _messages_cm(params, be0, bl0, be1, bl1, jac, lp, r0, prec, srel, act, me0, ml0, me1,
                 ml1, huber):
    """`_message_math` on component-major state (diagonal prec; with huber
    "row" the thresholds ride as prec's last component), the two slots'
    beliefs as component lists; the shape is read off the operands."""
    out = _message_math(
        params, _rows(jac), _rows(lp), _rows(r0), _rows(prec), srel[0], act[0],
        be0, bl0, be1, bl1, _rows(me0), _rows(ml0), _rows(me1), _rows(ml1),
        d0=me0.shape[0], d1=me1.shape[0], z=r0.shape[0], prec_full=False, huber=huber)
    return tuple(torch.stack(o) for o in out)


def _messages_plain(params, cam_rows, lmk_tab, jac, lp, r0, prec, srel,
                    act, me0, ml0, me1, ml1, *, deg, huber, gslot):
    """`_messages_cm` with the gathered slot's packed beliefs already read
    per row, cam_rows [mp, d_g + d_g * d_g], and the ELL slot's read at
    r // deg."""
    d_g, d_e = _by_slot(me0.shape[0], me1.shape[0], gslot)
    rows = torch.arange(jac.shape[1], device=jac.device) // deg
    cam = _rows(cam_rows.T)
    lmk = _rows(lmk_tab[rows].T)
    (be0, bl0), (be1, bl1) = _by_slot((cam[:d_g], cam[d_g:]), (lmk[:d_e], lmk[d_e:]), gslot)
    return _messages_cm(params, be0, bl0, be1, bl1, jac, lp, r0, prec, srel, act, me0, ml0,
                        me1, ml1, huber)


def _messages_other_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, gat_rows, me0,
                          ml0, me1, ml1, *, huber, gslot):
    """`_messages_cm` with the gathered slot's packed beliefs read per row,
    gat_rows [mp, d_g + d_g * d_g], and the other slot's from the expanded
    operands be_o [d_o, mp], bl_o [d_o * d_o, mp]."""
    d_g = (me0, me1)[gslot].shape[0]
    gat = _rows(gat_rows.T)
    (be0, bl0), (be1, bl1) = _by_slot((gat[:d_g], gat[d_g:]), (_rows(be_o), _rows(bl_o)), gslot)
    return _messages_cm(params, be0, bl0, be1, bl1, jac, lp, r0, prec, srel, act, me0, ml0,
                        me1, ml1, huber)


def messages_cm_tab_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gidx,
                          me0, ml0, me1, ml1, *, huber, gslot=0):
    """Plain version of `messages_cm_tab`: the gathered slot's beliefs are
    btab[gidx[r]], the other slot's the expanded operands."""
    COUNTS.plain["messages_cm_tab"] += 1
    return _messages_other_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o,
                                 btab[gidx.long()], me0, ml0, me1, ml1, huber=huber, gslot=gslot)


def messages_cm_tabblk_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gidx,
                             win_starts, me0, ml0, me1, ml1, *, huber, win_w, gslot=0):
    """Plain version of `messages_cm_tabblk`: the gathered slot's beliefs
    read from each row's tile window of btab, the other slot's from the
    expanded operands."""
    COUNTS.plain["messages_cm_tabblk"] += 1
    return _messages_other_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o,
                                 _window_rows(btab, gidx, win_starts, win_w), me0, ml0, me1, ml1,
                                 huber=huber, gslot=gslot)


def messages_cm_tabblkg_ell_plain(params, cam_tab, gtab, lmk_tab, gidx, win_starts, jac, lp, r0,
                                  prec, srel, act, me0, ml0, me1, ml1, *, deg, huber, win_w,
                                  n_own, gslot=0):
    """Plain version of `messages_cm_tabblkg_ell`: the gathered slot's
    packed beliefs from each row's tile window of the owned table or from
    the ghost table, the ELL slot's at r // deg; the four new messages."""
    COUNTS.plain["messages_cm_tabblkg_ell"] += 1
    return _messages_plain(
        params, _halo_rows(cam_tab, gtab, gidx, win_starts, win_w, n_own), lmk_tab, jac, lp, r0,
        prec, srel, act, me0, ml0, me1, ml1, deg=deg, huber=huber, gslot=gslot)


def messages_cm_tabblkg_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gtab, gidx,
                              win_starts, me0, ml0, me1, ml1, *, huber, win_w, n_own, gslot=0):
    """Plain version of `messages_cm_tabblkg`: the gathered slot's beliefs
    as in `messages_cm_tabblkg_ell_plain`, the other slot's from the
    expanded operands."""
    COUNTS.plain["messages_cm_tabblkg"] += 1
    return _messages_other_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o,
                                 _halo_rows(btab, gtab, gidx, win_starts, win_w, n_own), me0, ml0,
                                 me1, ml1, huber=huber, gslot=gslot)


def expand_ell_blk_plain(tab, *, deg):
    """Plain version of `expand_ell_blk`: the transposed table broadcast over
    the degree axis, out[k, r] = tab[r // deg, k] (the reference's
    broadcast-reshape at lane-aligned degrees)."""
    COUNTS.plain["expand_ell_blk"] += 1
    nv, f = tab.shape
    return tab.T[:, :, None].expand(f, nv, deg).reshape(f, nv * deg)


def messages_cm_tab_ell_plain(params, cam_tab, lmk_tab, gidx, jac, lp, r0,
                              prec, srel, act, me0, ml0, me1, ml1, seg_rows,
                              seg_offsets, *, deg, huber, gslot=0):
    """Plain version of `messages_cm_tab_ell`: the four new messages and the
    sum of the new gathered-slot messages per variable [d_g + d_g * d_g, n]."""
    COUNTS.plain["messages_cm_tab_ell"] += 1
    out = _messages_plain(
        params, cam_tab[gidx.long()], lmk_tab, jac, lp, r0, prec, srel, act,
        me0, ml0, me1, ml1, deg=deg, huber=huber, gslot=gslot)
    return (*out, segsum_by_id_plain(out[2 * gslot], out[2 * gslot + 1], seg_rows, seg_offsets))


def messages_cm_tabblk_ell_plain(params, cam_tab, lmk_tab, gidx, win_starts, jac, lp,
                                 r0, prec, srel, act, me0, ml0, me1, ml1, win_rows,
                                 win_offsets, *, deg, huber, win_w, gslot=0):
    """Plain version of `messages_cm_tabblk_ell`: the four new messages and
    the per-tile window partials of the new gathered-slot messages
    [n_tiles, d_g + d_g * d_g, win_w]."""
    COUNTS.plain["messages_cm_tabblk_ell"] += 1
    out = _messages_plain(
        params, _window_rows(cam_tab, gidx, win_starts, win_w), lmk_tab, jac, lp, r0,
        prec, srel, act, me0, ml0, me1, ml1, deg=deg, huber=huber, gslot=gslot)
    part = segsum_cm_blk_plain(out[2 * gslot], out[2 * gslot + 1], win_rows, win_offsets,
                               n_tiles=jac.shape[1] // TILE, w=win_w)
    return (*out, part)


def _csr_sum(me, ml, rows, offsets, row_major=False):
    """out[k, s] = sum over i in [offsets[s], offsets[s+1]) of comp_k[rows[i]]
    for the components (me | ml); with row_major the operands are [m, d] |
    [m, d*d] and the result [n_seg, d + d*d]."""
    n_seg = offsets.shape[0] - 1
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=me.device), (offsets[1:] - offsets[:-1]).long())
    rows = rows[:ids.shape[0]]  # entries past the last segment are padding
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


def window_rows_csr(gidx, win_starts, w, n_own=None):
    """CSR of each tile's rows by window column, for `segsum_cm_blk`:
    (rows [mp] int32, offsets [n_tiles * w + 1] int32); segment i * w + j
    lists, in row order, the rows of tile i whose camera id is
    win_starts[i] + j.  Raises if an id lies outside its tile's window.
    With n_own (the halo paths) only the rows with ids below n_own are
    listed, and `rows` is padded with zeros to mp entries that no segment
    reaches."""
    gidx = np.asarray(gidx, dtype=np.int64)
    win_starts = np.asarray(win_starts, dtype=np.int64)
    if gidx.size != win_starts.size * TILE:
        raise ValueError(f"{gidx.size} rows are not {win_starts.size} tiles of {TILE}")
    tile = np.arange(gidx.size) // TILE
    off = gidx - win_starts[tile]
    keep = np.ones(gidx.size, dtype=bool) if n_own is None else gidx < n_own
    if (keep & ((off < 0) | (off >= w))).any():
        raise ValueError("a camera id lies outside its tile's window")
    # Left-out rows sort past every segment.
    key = np.where(keep, tile * w + off, win_starts.size * w)
    rows = np.argsort(key, kind="stable").astype(np.int32)
    rows[int(keep.sum()):] = 0
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(key[keep], minlength=win_starts.size * w))]).astype(np.int32)
    return rows, offsets


def window_block_csr(win_starts, w, n_seg):
    """For `scatter_windows_cm`'s kernel: per block b of SCATTER_CAMS cameras,
    [b * SCATTER_CAMS, min((b + 1) * SCATTER_CAMS, n_seg)), the tiles whose
    window [win_starts[i], win_starts[i] + w) meets it, ascending (the union
    of the block's cover lists of `window_cover_csr`), as (tiles [nnz]
    int32, offsets [n_blocks + 1] int32)."""
    s = np.asarray(win_starts, dtype=np.int64)
    n_blk = -(-n_seg // SCATTER_CAMS)
    hit = (s < n_seg) & (s + w > 0)
    first = np.maximum(s, 0) // SCATTER_CAMS
    count = np.where(hit, (np.minimum(s + w, n_seg) - 1) // SCATTER_CAMS - first + 1, 0)
    tiles = np.repeat(np.arange(s.size), count)
    # Block of each (tile, block) pair: the tile's first block plus its rank.
    blocks = np.repeat(first, count) + np.arange(tiles.size) - np.repeat(
        np.cumsum(count) - count, count)
    order = np.argsort(blocks, kind="stable")  # stable: tiles stay ascending
    offsets = np.concatenate([[0], np.cumsum(np.bincount(blocks, minlength=n_blk))])
    return tiles[order].astype(np.int32), offsets.astype(np.int32)


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


def cover_lists(win_starts, w, n_seg):
    """`window_cover_csr` of the int32 tensor win_starts, as int32 tensors on
    its device: the index of `scatter_windows_cm_plain`."""
    tiles, offsets = window_cover_csr(win_starts.cpu().numpy(), w, n_seg)
    return (torch.from_numpy(tiles).to(win_starts.device),
            torch.from_numpy(offsets).to(win_starts.device))


# --- kernel wrappers --------------------------------------------------------


def _on_card(t) -> bool:
    """Whether a wrapper launches its kernel for `t` (a CUDA tensor) or runs
    its plain version (a CPU tensor): the one place that decides."""
    return t.is_cuda


def _check(name, t, shape, dtype):
    if not _on_card(t):
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


def _table_shape(name, d0, d1, z, gslot=0):
    """Raise unless the table kernels are instantiated for (d0, d1, z) with
    slot `gslot` gathered: every TABLE_SHAPES entry, with either slot."""
    if gslot not in (0, 1):
        raise ValueError(f"{name}: gslot must be 0 or 1, got {gslot}")
    if (d0, d1, z) not in TABLE_SHAPES:
        raise NotImplementedError(
            f"{name}: the kernel is not instantiated for (d0, d1, z) = ({d0}, {d1}, {z}); "
            f"it has {TABLE_SHAPES}")


def _model(name, comp_name, d0, d1, z, gslot=0):
    """The C entries' id of the measurement model `comp_name`, checked
    against the operands' shape."""
    comp_model(comp_name)  # raises for a model that is not ported
    model, shape = MODELS[comp_name]
    if shape != (d0, d1, z):
        raise ValueError(f"{name}: model {comp_name!r} has (d0, d1, z) = {shape}, the operands "
                         f"({d0}, {d1}, {z})")
    _table_shape(name, d0, d1, z, gslot)
    return model


def _shape_args(d0, d1, zd, gslot, huber):
    """The messages entries' leading arguments: d0, d1, z, gslot and the
    per-row Huber flag."""
    return [ctypes.c_int(v) for v in (d0, d1, zd, gslot, int(_huber_mode(huber, False)[0]))]


def _relin_outputs(lp, z):
    t, zd = lp.shape[0], z.shape[0]
    return [torch.empty((f, lp.shape[1]), dtype=lp.dtype, device=lp.device)
            for f in (t, zd * t, zd, 1)]


def _message_outputs(me0, me1):
    d0, d1 = me0.shape[0], me1.shape[0]
    return [torch.empty((f, me0.shape[1]), dtype=me0.dtype, device=me0.device)
            for f in (d0, d0 * d0, d1, d1 * d1)]


def _fargs_arg(name, fargs, comp_name, rows, dt, row_major=False):
    """(pointer, leading stride) of the per-row factor arguments of model
    `comp_name` ([n_args, rows], or [rows, n_args] row-major), (NULL, 0)
    for a model that reads none."""
    n_args = _n_args(name, fargs, comp_name)
    if fargs is None:
        return ctypes.c_void_p(None), 0
    return _check_op(f"{name}: fargs", fargs, rows, n_args, dt, row_major)


def _relin_state_args(name, z, fargs, lp, jac, r0, srel, act, d0, d1, zd, comp_name):
    """The table relinearization kernels' state operands, checked: z, the
    factor arguments [n_args, mp] (NULL for a model that reads none), lp,
    jac, r0, srel, act."""
    dt, mp, t = lp.dtype, lp.shape[1], d0 + d1
    n_args = _n_args(name, fargs, comp_name)
    args_p = ctypes.c_void_p(None) if fargs is None else _check("fargs", fargs, (n_args, mp), dt)
    return [_check("z", z, (zd, mp), dt), args_p,
            _check("lp", lp, (t, mp), dt),
            _check("jac", jac, (zd * t, mp), dt), _check("r0", r0, (zd, mp), dt),
            _check("srel", srel, (1, mp), dt), _check("act", act, (1, mp), dt)]


def _message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd, huber):
    """The messages kernels' ten state operands, checked; prec carries the
    per-row thresholds as one more component under huber "row"."""
    dt, mp, t = jac.dtype, jac.shape[1], d0 + d1
    return [
        _check("jac", jac, (zd * t, mp), dt), _check("lp", lp, (t, mp), dt),
        _check("r0", r0, (zd, mp), dt),
        _check("prec", prec, (_prec_comps(zd, False, huber), mp), dt),
        _check("srel", srel, (1, mp), dt), _check("act", act, (1, mp), dt),
        _check("me0", me0, (d0, mp), dt), _check("ml0", ml0, (d0 * d0, mp), dt),
        _check("me1", me1, (d1, mp), dt), _check("ml1", ml1, (d1 * d1, mp), dt)]


def _message_scalars(params, huber):
    eta_damping, lam_damping, num_undamped, floor, _, _, jitter = params
    _, has_huber, huber_val = _huber_mode(huber, False)
    return [ctypes.c_double(eta_damping), ctypes.c_double(lam_damping),
            ctypes.c_double(num_undamped), ctypes.c_double(floor), ctypes.c_double(jitter),
            ctypes.c_int(has_huber), ctypes.c_double(huber_val), _stream()]


def relin_cm_tab_ell(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0, srel,
                     act, *, deg, comp_name=BA_MODEL, gslot=0, fargs=None):
    """Masked relinearization; returns new (lp [t, mp], jac [z * t, mp],
    r0 [z, mp], srel [1, mp]).  cam_mean [n, d_g] the gathered slot's means
    (slot `gslot`), lmk_mean [nv, d_e] the ELL slot's with nv = mp // deg,
    gidx [mp] int32 ids into cam_mean; comp_name the measurement model and
    fargs its per-row arguments [n_args, mp] (None when it reads none)."""
    if not _on_card(lp):
        return relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, gidx, z, lp, jac, r0, srel,
                                      act, deg=deg, comp_name=comp_name, gslot=gslot,
                                      fargs=fargs)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_cam, d_g), (nv, d_e), zd = cam_mean.shape, lmk_mean.shape, z.shape[0]
    d0, d1 = _by_slot(d_g, d_e, gslot)
    model = _model("relin_cm_tab_ell", comp_name, d0, d1, zd, gslot)
    if mp != nv * deg:
        raise ValueError(f"relin_cm_tab_ell: mp={mp} != nv*deg={nv}*{deg}")
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot),
        _check("cam_mean", cam_mean, (n_cam, d_g), dt), ctypes.c_int(n_cam),
        _check("lmk_mean", lmk_mean, (nv, d_e), dt), ctypes.c_int(nv),
        _check("gidx", gidx, (mp,), torch.int32),
        *_relin_state_args("relin_cm_tab_ell", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
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
                        *, deg, huber, gslot=0):
    """Factor -> variable messages; returns (eta0 [d0, mp], lam0 [d0 * d0,
    mp], eta1 [d1, mp], lam1 [d1 * d1, mp], gathered-slot sum [d_g + d_g *
    d_g, n]) like the reference.

    cam_tab [n, d_g + d_g * d_g] and lmk_tab [nv, d_e + d_e * d_e] are the
    packed (eta | lam) beliefs of the gathered slot (slot `gslot`) and the
    ELL slot; huber is None, the scalar Mahalanobis threshold, or "row"
    (per-row thresholds as prec's last component, 0 = off)."""
    if not _on_card(jac):
        return messages_cm_tab_ell_plain(
            params, cam_tab, lmk_tab, gidx, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1,
            seg_rows, seg_offsets, deg=deg, huber=huber, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tab_ell", d0, d1, zd, gslot)
    d_g, d_e = _by_slot(d0, d1, gslot)
    n_cam, nv = cam_tab.shape[0], lmk_tab.shape[0]
    if mp != nv * deg:
        raise ValueError(f"messages_cm_tab_ell: mp={mp} != nv*deg={nv}*{deg}")
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("cam_tab", cam_tab, (n_cam, d_g + d_g * d_g), dt), ctypes.c_int(n_cam),
        _check("lmk_tab", lmk_tab, (nv, d_e + d_e * d_e), dt), ctypes.c_int(nv),
        _check("gidx", gidx, (mp,), torch.int32),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg), *_message_scalars(params, huber),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tab_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tab_ell")
    COUNTS.kernel["messages_cm_tab_ell"] += 1
    return (*out, segsum_by_id(out[2 * gslot], out[2 * gslot + 1], seg_rows, seg_offsets))


def _table_smem(name, n, width, dt):
    """Raise unless a table of `n` rows of `width` values fits the static
    shared memory the full-table kernels stage it in."""
    need = n * width * torch.empty((), dtype=dt).element_size()
    if need > SMEM_TABLE_BYTES:
        raise ValueError(
            f"{name}: a table of {n} rows x {width} values of {dt} takes {need} bytes of "
            f"shared memory; the full-table kernels stage {SMEM_TABLE_BYTES}")


def expand_ell_blk(tab, *, deg):
    """The packed ELL-slot table tab [nv, f] expanded to per-row operands
    [f, nv * deg]: out[k, r] = tab[r // deg, k]."""
    if not _on_card(tab):
        return expand_ell_blk_plain(tab, deg=deg)
    from gbp_tpu_torch.ops._build import library

    dt = tab.dtype
    nv, f = tab.shape
    if deg <= 0:
        raise ValueError(f"expand_ell_blk: deg={deg}")
    out = torch.empty((f, nv * deg), dtype=dt, device=tab.device)
    fn = getattr(library(), f"gbp_expand_ell_blk_{_suffix(dt)}")
    _raise_on(fn(_check("tab", tab, (nv, f), dt), ctypes.c_int(f), ctypes.c_int(deg),
                 ctypes.c_int64(nv * deg), ctypes.c_void_p(out.data_ptr()), _stream()),
              "expand_ell_blk")
    COUNTS.kernel["expand_ell_blk"] += 1
    return out


def relin_cm_tab(params, x_other, mtab, gidx, z, fargs, lp, jac, r0, srel, act, *,
                 comp_name, gslot=0):
    """Masked relinearization with slot `gslot`'s means read by id from the
    table mtab [n, d_g] and the other slot's from the expanded operand
    x_other [d_o, mp]; returns (lp, jac, r0, srel).  The table must fit the
    static shared memory (SMEM_TABLE_BYTES)."""
    if not _on_card(lp):
        return relin_cm_tab_plain(params, x_other, mtab, gidx, z, fargs, lp, jac, r0, srel,
                                  act, comp_name=comp_name, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_g, d_g), d_o, zd = mtab.shape, x_other.shape[0], z.shape[0]
    d0, d1 = _by_slot(d_g, d_o, gslot)
    model = _model("relin_cm_tab", comp_name, d0, d1, zd, gslot)
    _table_smem("relin_cm_tab", n_g, d_g, dt)
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot), _check("x_other", x_other, (d_o, mp), dt),
        _check("mtab", mtab, (n_g, d_g), dt), ctypes.c_int(n_g),
        _check("gidx", gidx, (mp,), torch.int32),
        *_relin_state_args("relin_cm_tab", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tab_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tab")
    COUNTS.kernel["relin_cm_tab"] += 1
    return tuple(out)


def messages_cm_tab(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gidx,
                    me0, ml0, me1, ml1, *, huber, gslot=0):
    """Factor -> variable messages with slot `gslot`'s packed beliefs read by
    id from the table btab [n, d_g + d_g * d_g] and the other slot's from the
    expanded operands be_o [d_o, mp], bl_o [d_o * d_o, mp]; returns (eta0,
    lam0, eta1, lam1).  No sum is folded in.  The table must fit the static
    shared memory (SMEM_TABLE_BYTES)."""
    if not _on_card(jac):
        return messages_cm_tab_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab,
                                     gidx, me0, ml0, me1, ml1, huber=huber, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tab", d0, d1, zd, gslot)
    d_g, d_o = _by_slot(d0, d1, gslot)
    n_g = btab.shape[0]
    _table_smem("messages_cm_tab", n_g, d_g + d_g * d_g, dt)
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("btab", btab, (n_g, d_g + d_g * d_g), dt), ctypes.c_int(n_g),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("be_o", be_o, (d_o, mp), dt), _check("bl_o", bl_o, (d_o * d_o, mp), dt),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), *_message_scalars(params, huber),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tab_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tab")
    COUNTS.kernel["messages_cm_tab"] += 1
    return tuple(out)


def relin_cm_tabblk(params, x_other, mtab, gidx, win_starts, z, fargs, lp, jac, r0, srel, act,
                    *, win_w, comp_name, gslot=0):
    """`relin_cm_tab` for large scenes: the block of tile i stages rows
    [win_starts[i], win_starts[i] + win_w) of the gathered slot's mean table
    mtab [n, d_g] and a row reads its mean at gidx[r] - win_starts[i]; the
    other slot's means come from x_other [d_o, mp].  An id outside its
    tile's window stops the kernel (a fault of `prepare`)."""
    if not _on_card(lp):
        return relin_cm_tabblk_plain(params, x_other, mtab, gidx, win_starts, z, fargs, lp, jac,
                                     r0, srel, act, win_w=win_w, comp_name=comp_name,
                                     gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_g, d_g), d_o, zd = mtab.shape, x_other.shape[0], z.shape[0]
    d0, d1 = _by_slot(d_g, d_o, gslot)
    model = _model("relin_cm_tabblk", comp_name, d0, d1, zd, gslot)
    n_tiles = _tiles("relin_cm_tabblk", mp)
    _window_smem("relin_cm_tabblk", win_w, d_g, dt)
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot), _check("x_other", x_other, (d_o, mp), dt),
        _check("mtab", mtab, (n_g, d_g), dt), ctypes.c_int(n_g),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        *_relin_state_args("relin_cm_tabblk", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tabblk_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tabblk")
    COUNTS.kernel["relin_cm_tabblk"] += 1
    return tuple(out)


def messages_cm_tabblk(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gidx, win_starts,
                       me0, ml0, me1, ml1, *, huber, win_w, gslot=0):
    """`messages_cm_tab` for large scenes: the rows of tile i read their
    gathered slot's packed belief from rows [win_starts[i], win_starts[i] +
    win_w) of btab [n, d_g + d_g * d_g], staged in shared memory by the block
    that computes them; the other slot's beliefs come from the
    expanded operands be_o [d_o, mp], bl_o [d_o * d_o, mp]; returns (eta0,
    lam0, eta1, lam1).  No sum is folded in."""
    if not _on_card(jac):
        return messages_cm_tabblk_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab,
                                        gidx, win_starts, me0, ml0, me1, ml1, huber=huber,
                                        win_w=win_w, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tabblk", d0, d1, zd, gslot)
    d_g, d_o = _by_slot(d0, d1, gslot)
    n_g = btab.shape[0]
    n_tiles = _tiles("messages_cm_tabblk", mp)
    _window_smem("messages_cm_tabblk", win_w, d_g + d_g * d_g, dt)
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("btab", btab, (n_g, d_g + d_g * d_g), dt), ctypes.c_int(n_g),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        _check("be_o", be_o, (d_o, mp), dt), _check("bl_o", bl_o, (d_o * d_o, mp), dt),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), *_message_scalars(params, huber), ctypes.c_void_p(None),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tabblk_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tabblk")
    COUNTS.kernel["messages_cm_tabblk"] += 1
    return tuple(out)


def _ghost_args(name, gtab, width, dt, n_own):
    """The ghost table's pointer and row count, checked: [n_gt, width] of
    dtype dt, n_gt >= 1, n_own >= 0."""
    if n_own < 0 or gtab.shape[0] < 1:
        raise ValueError(f"{name}: n_own={n_own}, ghost table of {gtab.shape[0]} rows")
    return [_check("gtab", gtab, (gtab.shape[0], width), dt), ctypes.c_int(gtab.shape[0])]


def relin_cm_tabblkg_ell(params, cam_mean, gtab, lmk_mean, gidx, win_starts, z, lp, jac, r0, srel,
                         act, *, deg, win_w, n_own, comp_name=BA_MODEL, gslot=0, fargs=None):
    """`relin_cm_tabblk_ell` on a halo partition: a row with gidx < n_own
    reads its gathered variable's mean from its tile's window of the owned
    means cam_mean [n_cam, d_g], any other row reads row gidx - n_own of the
    ghost mean table gtab [n_gt, d_g]; the ELL slot's means at r // deg of
    lmk_mean [nv, d_e].  An id outside its window or beyond the ghost table
    stops the kernel (a fault of `prepare`)."""
    if not _on_card(lp):
        return relin_cm_tabblkg_ell_plain(params, cam_mean, gtab, lmk_mean, gidx, win_starts, z,
                                          lp, jac, r0, srel, act, deg=deg, win_w=win_w,
                                          n_own=n_own, comp_name=comp_name, gslot=gslot,
                                          fargs=fargs)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_cam, d_g), (nv, d_e), zd = cam_mean.shape, lmk_mean.shape, z.shape[0]
    d0, d1 = _by_slot(d_g, d_e, gslot)
    model = _model("relin_cm_tabblkg_ell", comp_name, d0, d1, zd, gslot)
    n_tiles = _tiles("relin_cm_tabblkg_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"relin_cm_tabblkg_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("relin_cm_tabblkg_ell", win_w, d_g, dt)
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot),
        _check("cam_mean", cam_mean, (n_cam, d_g), dt), ctypes.c_int(n_cam),
        *_ghost_args("relin_cm_tabblkg_ell", gtab, d_g, dt, n_own),
        _check("lmk_mean", lmk_mean, (nv, d_e), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        ctypes.c_int(n_own),
        *_relin_state_args("relin_cm_tabblkg_ell", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg),
        ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tabblkg_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tabblkg_ell")
    COUNTS.kernel["relin_cm_tabblkg_ell"] += 1
    return tuple(out)


def messages_cm_tabblkg_ell(params, cam_tab, gtab, lmk_tab, gidx, win_starts, jac, lp, r0, prec,
                            srel, act, me0, ml0, me1, ml1, *, deg, huber, win_w, n_own, gslot=0):
    """`messages_cm_tabblk_ell` on a halo partition: the gathered slot's
    packed (eta | lam) beliefs from the tile's window of the owned table
    cam_tab [n_cam, d_g + d_g * d_g] for ids below n_own, from row gidx -
    n_own of the ghost table gtab [n_gt, d_g + d_g * d_g] otherwise; the ELL
    slot's at r // deg of lmk_tab.  Returns (eta0, lam0, eta1, lam1); no sum
    is folded in."""
    if not _on_card(jac):
        return messages_cm_tabblkg_ell_plain(
            params, cam_tab, gtab, lmk_tab, gidx, win_starts, jac, lp, r0, prec, srel, act, me0,
            ml0, me1, ml1, deg=deg, huber=huber, win_w=win_w, n_own=n_own, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tabblkg_ell", d0, d1, zd, gslot)
    d_g, d_e = _by_slot(d0, d1, gslot)
    n_cam, nv = cam_tab.shape[0], lmk_tab.shape[0]
    n_tiles = _tiles("messages_cm_tabblkg_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"messages_cm_tabblkg_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("messages_cm_tabblkg_ell", win_w, d_g + d_g * d_g, dt)
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("cam_tab", cam_tab, (n_cam, d_g + d_g * d_g), dt), ctypes.c_int(n_cam),
        *_ghost_args("messages_cm_tabblkg_ell", gtab, d_g + d_g * d_g, dt, n_own),
        _check("lmk_tab", lmk_tab, (nv, d_e + d_e * d_e), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        ctypes.c_int(n_own),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg), *_message_scalars(params, huber),
        ctypes.c_void_p(None),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tabblkg_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tabblkg_ell")
    COUNTS.kernel["messages_cm_tabblkg_ell"] += 1
    return tuple(out)


def relin_cm_tabblkg(params, x_other, mtab, gtab, gidx, win_starts, z, fargs, lp, jac, r0, srel,
                     act, *, win_w, n_own, comp_name, gslot=0):
    """`relin_cm_tabblk` on a halo partition: the gathered slot's means as
    in `relin_cm_tabblkg_ell` (owned window of mtab [n_g, d_g] or ghost
    table gtab [n_gt, d_g]), the other slot's from x_other [d_o, mp]."""
    if not _on_card(lp):
        return relin_cm_tabblkg_plain(params, x_other, mtab, gtab, gidx, win_starts, z, fargs,
                                      lp, jac, r0, srel, act, win_w=win_w, n_own=n_own,
                                      comp_name=comp_name, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_g, d_g), d_o, zd = mtab.shape, x_other.shape[0], z.shape[0]
    d0, d1 = _by_slot(d_g, d_o, gslot)
    model = _model("relin_cm_tabblkg", comp_name, d0, d1, zd, gslot)
    n_tiles = _tiles("relin_cm_tabblkg", mp)
    _window_smem("relin_cm_tabblkg", win_w, d_g, dt)
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot), _check("x_other", x_other, (d_o, mp), dt),
        _check("mtab", mtab, (n_g, d_g), dt), ctypes.c_int(n_g),
        *_ghost_args("relin_cm_tabblkg", gtab, d_g, dt, n_own),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        ctypes.c_int(n_own),
        *_relin_state_args("relin_cm_tabblkg", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_double(params[4]), ctypes.c_double(params[5]), _stream(),
    ]
    fn = getattr(library(), f"gbp_relin_cm_tabblkg_{_suffix(dt)}")
    _raise_on(fn(*args), "relin_cm_tabblkg")
    COUNTS.kernel["relin_cm_tabblkg"] += 1
    return tuple(out)


def messages_cm_tabblkg(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab, gtab, gidx,
                        win_starts, me0, ml0, me1, ml1, *, huber, win_w, n_own, gslot=0):
    """`messages_cm_tabblk` on a halo partition: the gathered slot's packed
    beliefs from the tile's window of the owned table btab or from the ghost
    table gtab, the other slot's from the expanded operands be_o [d_o, mp],
    bl_o [d_o * d_o, mp]; returns (eta0, lam0, eta1, lam1)."""
    if not _on_card(jac):
        return messages_cm_tabblkg_plain(params, jac, lp, r0, prec, srel, act, be_o, bl_o, btab,
                                         gtab, gidx, win_starts, me0, ml0, me1, ml1, huber=huber,
                                         win_w=win_w, n_own=n_own, gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tabblkg", d0, d1, zd, gslot)
    d_g, d_o = _by_slot(d0, d1, gslot)
    n_g = btab.shape[0]
    n_tiles = _tiles("messages_cm_tabblkg", mp)
    _window_smem("messages_cm_tabblkg", win_w, d_g + d_g * d_g, dt)
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("btab", btab, (n_g, d_g + d_g * d_g), dt), ctypes.c_int(n_g),
        *_ghost_args("messages_cm_tabblkg", gtab, d_g + d_g * d_g, dt, n_own),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        ctypes.c_int(n_own),
        _check("be_o", be_o, (d_o, mp), dt), _check("bl_o", bl_o, (d_o * d_o, mp), dt),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), *_message_scalars(params, huber), ctypes.c_void_p(None),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tabblkg_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tabblkg")
    COUNTS.kernel["messages_cm_tabblkg"] += 1
    return tuple(out)


def _check_op(name, t, rows, comps, dtype, row_major):
    """A per-factor operand of `comps` components and `rows` rows, [rows,
    comps] (row_major) or [comps, rows], unit stride along the trailing axis;
    returns (pointer, leading stride).  A slice of a wider array passes."""
    if not _on_card(t):
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


def _pow2_floor(n):
    return 1 << (max(int(n), 1).bit_length() - 1)


def segsum_form(m, n_seg, n_rows, row_major=False):
    """(chunk, group) of `segsum_by_id`'s chunked form for operands of m
    rows, n_seg segments and a CSR of n_rows entries, or (0, 0) for the
    short-segment form.  The one rule: the chunk is the smallest power of
    two from SEGSUM_CHUNK_MIN that keeps the dense partials [n_chunk, f,
    n_seg] within 1/8 of the messages (chunk >= 8 * n_seg), raised while at
    least two chunks per SM remain and capped at SEGSUM_CHUNK_MAX; the
    chunked form needs component-major operands, such a chunk, at least one
    chunk per SM and a CSR listing at least half the rows.  `group` lanes
    sum one run of a chunk, about four entries each (a power of two up to
    32)."""
    if row_major or n_seg <= 0 or m <= 0 or 2 * n_rows < m:
        return 0, 0
    low = max(SEGSUM_CHUNK_MIN, 1 << (8 * n_seg - 1).bit_length())
    if low > SEGSUM_CHUNK_MAX:
        return 0, 0
    chunk = max(low, min(SEGSUM_CHUNK_MAX, _pow2_floor(m // (2 * N_SM))))
    if -(-m // chunk) < N_SM:
        return 0, 0
    return chunk, min(32, _pow2_floor(chunk // n_seg // 4))


def segsum_by_id(me, ml, seg_rows, seg_offsets, *, row_major=False):
    """Deterministic segment sum of me | ml over the CSR (seg_offsets
    [n_seg + 1]; seg_rows lists each segment's rows ascending, entries past
    the last segment are padding): component-major me [d, m], ml [d*d, m]
    -> [d + d*d, n_seg], or with row_major me [m, d], ml [m, d*d] ->
    [n_seg, d + d*d].  The form (`segsum_form`) sets the summation order;
    two runs give the same bits: no atomics."""
    if not _on_card(me):
        return segsum_by_id_plain(me, ml, seg_rows, seg_offsets, row_major=row_major)
    from gbp_tpu_torch.ops._build import library

    dt = me.dtype
    d, m = (me.shape[1], me.shape[0]) if row_major else me.shape
    f = d + d * d
    n_seg = seg_offsets.shape[0] - 1
    n_rows = seg_rows.shape[0]
    chunk, group = segsum_form(m, n_seg, n_rows, row_major)
    # One allocation: the output, then the chunked form's partials [n_chunk,
    # f * n_seg].
    n_part = -(-m // chunk) * f * n_seg if chunk else 0
    buf = torch.empty(f * n_seg + n_part, dtype=dt, device=me.device)
    out = buf[:f * n_seg].view((n_seg, f) if row_major else (f, n_seg))
    me_p, me_ld = _check_op("me", me, m, d, dt, row_major)
    ml_p, ml_ld = _check_op("ml", ml, m, d * d, dt, row_major)
    v = 16 // me.element_size()
    if chunk and (me.data_ptr() % 16 or ml.data_ptr() % 16 or me_ld % v or ml_ld % v or m % v):
        raise ValueError("segsum_by_id: the chunked form takes 16-byte aligned operands with m "
                         "and the leading strides multiples of 16 bytes")
    args = [
        me_p, ctypes.c_int64(me_ld), ml_p, ctypes.c_int64(ml_ld), ctypes.c_int(d),
        ctypes.c_int(row_major),
        _check("seg_rows", seg_rows, (n_rows,), torch.int32),
        _check("seg_offsets", seg_offsets, (n_seg + 1,), torch.int32),
        ctypes.c_int(n_seg), ctypes.c_int64(m), ctypes.c_int(chunk), ctypes.c_int(group),
        ctypes.c_void_p(buf[f * n_seg:].data_ptr() if chunk else None),
        ctypes.c_void_p(out.data_ptr()), _stream(),
    ]
    fn = getattr(library(), f"gbp_segsum_by_id_{_suffix(dt)}")
    _raise_on(fn(*args), "segsum_by_id")
    COUNTS.kernel["segsum_by_id"] += 1
    COUNTS.segsum_forms["chunked" if chunk else "short"] += 1
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
    """Blocks of the windowed relinearization kernel `name`
    ("relin_cm_tabblk_ell") that one SM holds at once when each stages a
    window of `win_w` cameras, as the CUDA occupancy calculator reports it
    (the messages kernels' launch: `window_plan`)."""
    from gbp_tpu_torch.ops._build import library

    n = getattr(library(), f"gbp_{name}_blocks_per_sm_{_suffix(dtype)}")(ctypes.c_int(win_w))
    _raise_on(max(-n, 0), f"{name} occupancy")
    return n


WINDOW_PLAN_KEYS = ("units", "unit_rows", "blocks", "smem_bytes", "registers", "local_bytes",
                    "blocks_per_sm")


def window_plan(name, dtype, *, win_w, mp, d0=D0, d1=D1, z=Z, gslot=0, huber=None):
    """How the windowed messages kernel `name` ("messages_cm_tabblk_ell",
    "messages_cm_tabblk", "messages_cm_tabblkg_ell" or
    "messages_cm_tabblkg") launches on this card for mp rows and windows of
    `win_w` rows of the gathered slot's table.  Returns {units, unit_rows,
    blocks, smem_bytes, registers, local_bytes, blocks_per_sm}: the grid
    (units of unit_rows rows over `blocks` persistent blocks; in float64 and
    at 12 dofs one block per tile of 1024 rows), the shared bytes per block,
    registers and local-memory bytes per thread, resident blocks per SM."""
    from gbp_tpu_torch.ops._build import library

    kinds = ("messages_cm_tabblk_ell", "messages_cm_tabblk", "messages_cm_tabblkg_ell",
             "messages_cm_tabblkg")
    if name not in kinds:
        raise ValueError(f"window_plan: {name!r} is not one of {kinds}")
    _table_shape(name, d0, d1, z, gslot)
    _tiles(name, mp)
    null, i = ctypes.c_void_p(None), ctypes.c_int
    ell, ghost = name.endswith("_ell"), "tabblkg" in name
    mid = ([null, i(0)] + ([null, i(1)] if ghost else []) + ([null] if ell else [])
           + [null, null, i(win_w)] + ([i(0)] if ghost else []) + ([] if ell else [null, null]))
    info = (ctypes.c_int * len(WINDOW_PLAN_KEYS))()
    args = [*_shape_args(d0, d1, z, gslot, huber), *mid, *[null] * 14, ctypes.c_int64(mp),
            *([i(1)] if ell else []), *[ctypes.c_double(0.0)] * 5, i(0), ctypes.c_double(0.0),
            null, info]
    _raise_on(getattr(library(), f"gbp_{name}_{_suffix(dtype)}")(*args), f"{name} plan")
    return dict(zip(WINDOW_PLAN_KEYS, info))


def _tiles(name, mp):
    if mp <= 0 or mp % TILE:
        raise ValueError(f"{name}: mp={mp} is not a positive multiple of the tile ({TILE} rows)")
    return mp // TILE


def relin_cm_tabblk_ell(params, cam_mean, lmk_mean, gidx, win_starts, z, lp, jac, r0,
                        srel, act, *, deg, win_w, comp_name=BA_MODEL, gslot=0, fargs=None):
    """`relin_cm_tab_ell` for large scenes: the block of tile i stages rows
    [win_starts[i], win_starts[i] + win_w) of cam_mean and a row reads its
    gathered variable at gidx[r] - win_starts[i].  win_starts [mp / TILE]
    int32.  An id outside its tile's window stops the kernel (a fault of
    `prepare`)."""
    if not _on_card(lp):
        return relin_cm_tabblk_ell_plain(params, cam_mean, lmk_mean, gidx, win_starts, z,
                                         lp, jac, r0, srel, act, deg=deg, win_w=win_w,
                                         comp_name=comp_name, gslot=gslot, fargs=fargs)
    from gbp_tpu_torch.ops._build import library

    dt = lp.dtype
    mp = lp.shape[1]
    (n_cam, d_g), (nv, d_e), zd = cam_mean.shape, lmk_mean.shape, z.shape[0]
    d0, d1 = _by_slot(d_g, d_e, gslot)
    model = _model("relin_cm_tabblk_ell", comp_name, d0, d1, zd, gslot)
    n_tiles = _tiles("relin_cm_tabblk_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"relin_cm_tabblk_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("relin_cm_tabblk_ell", win_w, d_g, dt)
    out = _relin_outputs(lp, z)
    args = [
        ctypes.c_int(model), ctypes.c_int(gslot),
        _check("cam_mean", cam_mean, (n_cam, d_g), dt), ctypes.c_int(n_cam),
        _check("lmk_mean", lmk_mean, (nv, d_e), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        *_relin_state_args("relin_cm_tabblk_ell", z, fargs, lp, jac, r0, srel, act, d0, d1, zd,
                           comp_name),
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
                           *, deg, huber, win_w, gslot=0):
    """`messages_cm_tab_ell` for large scenes; returns (eta0, lam0, eta1,
    lam1, part) like the reference: part [mp / TILE, d_g + d_g * d_g, win_w]
    holds the per-tile window partials of the new gathered-slot messages
    (`segsum_cm_blk` on the outputs), to be combined by
    `scatter_windows_cm`."""
    if not _on_card(jac):
        return messages_cm_tabblk_ell_plain(
            params, cam_tab, lmk_tab, gidx, win_starts, jac, lp, r0, prec, srel, act,
            me0, ml0, me1, ml1, win_rows, win_offsets, deg=deg, huber=huber, win_w=win_w,
            gslot=gslot)
    from gbp_tpu_torch.ops._build import library

    dt = jac.dtype
    mp = jac.shape[1]
    d0, d1, zd = me0.shape[0], me1.shape[0], r0.shape[0]
    _table_shape("messages_cm_tabblk_ell", d0, d1, zd, gslot)
    d_g, d_e = _by_slot(d0, d1, gslot)
    n_cam, nv = cam_tab.shape[0], lmk_tab.shape[0]
    n_tiles = _tiles("messages_cm_tabblk_ell", mp)
    if mp != nv * deg:
        raise ValueError(f"messages_cm_tabblk_ell: mp={mp} != nv*deg={nv}*{deg}")
    _window_smem("messages_cm_tabblk_ell", win_w, d_g + d_g * d_g, dt)
    out = _message_outputs(me0, me1)
    args = [
        *_shape_args(d0, d1, zd, gslot, huber),
        _check("cam_tab", cam_tab, (n_cam, d_g + d_g * d_g), dt), ctypes.c_int(n_cam),
        _check("lmk_tab", lmk_tab, (nv, d_e + d_e * d_e), dt),
        _check("gidx", gidx, (mp,), torch.int32),
        _check("win_starts", win_starts, (n_tiles,), torch.int32), ctypes.c_int(win_w),
        *_message_state_args(jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, d0, d1, zd,
                             huber),
        *[ctypes.c_void_p(o.data_ptr()) for o in out],
        ctypes.c_int64(mp), ctypes.c_int(deg), *_message_scalars(params, huber),
        ctypes.c_void_p(None),
    ]
    fn = getattr(library(), f"gbp_messages_cm_tabblk_ell_{_suffix(dt)}")
    _raise_on(fn(*args), "messages_cm_tabblk_ell")
    COUNTS.kernel["messages_cm_tabblk_ell"] += 1
    return (*out, segsum_cm_blk(out[2 * gslot], out[2 * gslot + 1], win_rows, win_offsets,
                                n_tiles=n_tiles, w=win_w))


def segsum_cm_blk(me, ml, win_rows, win_offsets, *, n_tiles, w):
    """Deterministic per-tile window partials [n_tiles, d + d*d, w] of
    me [d, mp] | ml [d*d, mp] over the CSR of `window_rows_csr`: persistent
    blocks over (tile, group of components) items stage each item's slices
    of the tile in shared memory, the next item's arriving meanwhile, and
    add each non-empty segment in CSR order (`segsum_blk_plan`).  Equal bit
    for bit to the plain version; a row outside its tile stops the kernel
    (a fault of `prepare`)."""
    if not _on_card(me):
        return segsum_cm_blk_plain(me, ml, win_rows, win_offsets, n_tiles=n_tiles, w=w)
    from gbp_tpu_torch.ops._build import library

    dt = me.dtype
    d, mp = me.shape
    if n_tiles != _tiles("segsum_cm_blk", mp):
        raise ValueError(f"segsum_cm_blk: n_tiles={n_tiles} but mp={mp} holds {mp // TILE} tiles")
    f = d + d * d
    if not 0 < f <= 65535 or w <= 0:
        raise ValueError(f"segsum_cm_blk: d={d}, w={w} out of range")
    if me.data_ptr() % 16 or ml.data_ptr() % 16:
        raise ValueError("segsum_cm_blk: me and ml must be 16-byte aligned (bulk copies)")
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


SEGSUM_BLK_PLAN_KEYS = ("comps_per_block", "groups", "items", "blocks", "threads", "smem_bytes",
                        "registers", "local_bytes", "blocks_per_sm")


def segsum_blk_plan(dtype, d, n_tiles):
    """How `segsum_cm_blk` launches on this card for n_tiles tiles of d-dof
    messages ([d, mp] | [d*d, mp]): {comps_per_block (at most; the d + d*d
    components are dealt evenly over `groups` items per tile), groups,
    items, blocks (persistent, each taking every blocks-th item), threads,
    smem_bytes (per block, whatever the window width), registers,
    local_bytes (per thread), blocks_per_sm (resident)}."""
    from gbp_tpu_torch.ops._build import library

    info = (ctypes.c_int * len(SEGSUM_BLK_PLAN_KEYS))()
    fn = getattr(library(), f"gbp_segsum_cm_blk_plan_{_suffix(dtype)}")
    _raise_on(fn(ctypes.c_int(d), ctypes.c_int(n_tiles), info), "segsum_cm_blk plan")
    return dict(zip(SEGSUM_BLK_PLAN_KEYS, info))


def scatter_windows_cm(part, win_starts, blk_tiles, blk_offsets, *, n_seg):
    """Combine per-tile window partials part [n_tiles, f, w] into [f, n_seg]:
    out[k, c] = sum over the tiles i covering c of part[i, k, c -
    win_starts[i]], in ascending i.  (blk_tiles, blk_offsets) are the block
    lists of `window_block_csr`; starts are int32 multiples of 8, w a
    multiple of 8.  Deterministic, and equal bit for bit to the plain
    version, which walks the cover lists (`cover_lists`)."""
    if not _on_card(part):
        return scatter_windows_cm_plain(part, win_starts,
                                        *cover_lists(win_starts, part.shape[2], n_seg),
                                        n_seg=n_seg)
    from gbp_tpu_torch.ops._build import library

    dt = part.dtype
    n_tiles, f, w = part.shape
    if not 0 < f <= 65535 or w % 8:
        raise ValueError(f"scatter_windows_cm: f={f}, w={w} out of range")
    if part.data_ptr() % 16:
        raise ValueError("scatter_windows_cm: part must be 16-byte aligned")
    out = torch.empty((f, n_seg), dtype=dt, device=part.device)
    args = [
        _check("part", part, (n_tiles, f, w), dt),
        _check("win_starts", win_starts, (n_tiles,), torch.int32),
        _check("blk_tiles", blk_tiles, (blk_tiles.shape[0],), torch.int32),
        _check("blk_offsets", blk_offsets, (-(-n_seg // SCATTER_CAMS) + 1,), torch.int32),
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
        raise NotImplementedError(
            f"{name}: the kernel is not instantiated for (d0, d1, z) = ({d0}, {d1}, {z}); "
            f"it has {ROW_SHAPES}")


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


def staged_info(name, dtype, *, d0=D0, d1=D1, z=Z, prec_full=False, huber=None,
                comp_name=BA_MODEL):
    """What the card makes of a row-major (staged) kernel: "fused_messages"
    at (d0, d1, z) with its precision and Huber options, or the
    relinearization of "fused_relin_messages" under `comp_name` (its shape
    is the model's).  Returns
    {rows, smem_bytes, registers, local_bytes, blocks_per_sm}: rows (threads)
    and shared-memory bytes per block, registers and local-memory bytes
    (spills, and arrays kept off registers) per thread, resident blocks per
    SM."""
    from gbp_tpu_torch.ops._build import library

    info = (ctypes.c_int * 5)()
    sfx = _suffix(dtype)
    if name == "fused_messages":
        _row_shape(name, d0, d1, z)
        huber_row = _huber_mode(huber, prec_full)[0]
        rc = getattr(library(), f"gbp_messages_rows_info_{sfx}")(d0, d1, z, int(prec_full),
                                                                 int(huber_row), info)
    elif name == "fused_relin_messages":
        comp_model(comp_name)  # raises for a model that is not ported
        rc = getattr(library(), f"gbp_relin_rows_info_{sfx}")(MODELS[comp_name][0], info)
    else:
        raise ValueError(f"staged_info: no staged kernel for {name!r}")
    _raise_on(rc, f"{name} info")
    return dict(zip(("rows", "smem_bytes", "registers", "local_bytes", "blocks_per_sm"), info))


def _relin_any_plain(params, ops, fargs, *, row_major, comp_name):
    x, z_meas, lp, jac, r0, srel, act = ops
    dt = x.dtype
    c = lambda a: _comps(a, row_major)
    lp_n, jac_n, r0_n, srel_n = _relin_math(
        params, c(x), c(z_meas), _fargs_comps("relin", fargs, comp_name, row_major), c(lp),
        c(jac), c(r0), c(_as_col(srel, dt, row_major))[0], c(_as_col(act, dt, row_major))[0],
        comp_name)
    return (_stack(lp_n, row_major), _stack(jac_n, row_major), _stack(r0_n, row_major),
            _stack([srel_n], row_major))


def _relin_any(name, params, ops, fargs, *, row_major, d0, d1, z, comp_name):
    """Launch the expanded-operand relinearization kernel in one layout;
    `ops` are (x, z_meas, lp, jac, r0, srel, act), fargs the model's
    per-row arguments or None."""
    from gbp_tpu_torch.ops._build import library

    model = _model(name, comp_name, d0, d1, z)
    x = ops[0]
    dt = x.dtype
    m = x.shape[0] if row_major else x.shape[1]
    t = d0 + d1
    ops = list(ops)
    ops[5], ops[6] = _as_col(ops[5], dt, row_major), _as_col(ops[6], dt, row_major)
    names = ("x", "z", "lp", "jac", "r0", "srel", "act")
    checked = [_check_op(f"{name}: {n}", a, m, w, dt, row_major)
               for n, a, w in zip(names, ops, (t, z, t, z * t, z, 1, 1))]
    checked.append(_fargs_arg(name, fargs, comp_name, m, dt, row_major))
    out = [torch.empty((m, w) if row_major else (w, m), dtype=dt, device=x.device)
           for w in (t, z * t, z, 1)]
    fn = getattr(library(), f"gbp_relin_rows_{_suffix(dt)}")
    rc = fn(model, int(row_major),
            (ctypes.c_void_p * 8)(*[p for p, _ in checked]),
            (ctypes.c_int64 * 8)(*[ld for _, ld in checked]),
            (ctypes.c_void_p * 4)(*[o.data_ptr() for o in out]),
            (ctypes.c_int64 * 4)(*[o.shape[1] for o in out]), m, params[4], params[5],
            _stream())
    _raise_on(rc, name)
    COUNTS.kernel[name] += 1
    return tuple(out)


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
    if not _on_card(jac):
        return messages_cm_plain(params, *ops, d0=d0, d1=d1, z=z, prec_full=prec_full,
                                 huber=huber)
    return _messages_any("messages_cm", params, ops, row_major=False, d0=d0, d1=d1, z=z,
                         prec_full=prec_full, huber=huber)


def relin_cm_plain(params, x, z_meas, fargs, linpoint, jac, r0, srel, act, *,
                   d0, d1, z, comp_name):
    """Plain version of `relin_cm`."""
    del d0, d1, z
    COUNTS.plain["relin_cm"] += 1
    return _relin_any_plain(params, (x, z_meas, linpoint, jac, r0, srel, act), fargs,
                            row_major=False, comp_name=comp_name)


def relin_cm(params, x, z_meas, fargs, linpoint, jac, r0, srel, act, *,
             d0, d1, z, comp_name):
    """Masked relinearization on component-major operands [F, mp], the
    adjacent means x [t, mp] expanded per row, fargs [n_args, mp] or None;
    returns (lp, jac, r0, srel)."""
    if not _on_card(x):
        return relin_cm_plain(params, x, z_meas, fargs, linpoint, jac, r0, srel, act,
                              d0=d0, d1=d1, z=z, comp_name=comp_name)
    return _relin_any("relin_cm", params, (x, z_meas, linpoint, jac, r0, srel, act), fargs,
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
    if not _on_card(jac):
        return fused_messages_plain(params, *ops, d0=d0, d1=d1, z=z, prec_full=prec_full,
                                    huber=huber)
    return _messages_any("fused_messages", params, ops, row_major=True, d0=d0, d1=d1, z=z,
                         prec_full=prec_full, huber=huber)


def fused_relin_messages_plain(params, x, z_meas, fargs, linpoint, jac, r0, prec,
                               since_relin, active, be0, bl0, be1, bl1, me0, ml0, me1, ml1,
                               *, d0, d1, z, prec_full, huber, comp_name):
    """Plain version of `fused_relin_messages`."""
    COUNTS.plain["fused_relin_messages"] += 1
    lp, jc, r0n, srel = _relin_any_plain(
        params, (x, z_meas, linpoint, jac, r0, since_relin, active), fargs, row_major=True,
        comp_name=comp_name)
    out = fused_messages_plain(params, jc, lp, r0n, prec, srel, active, be0, bl0, be1, bl1,
                               me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
                               huber=huber)
    return (*out, lp, jc, r0n, srel)


def fused_relin_messages(params, x, z_meas, fargs, linpoint, jac, r0, prec, since_relin,
                         active, be0, bl0, be1, bl1, me0, ml0, me1, ml1, *, d0, d1, z,
                         prec_full, huber, comp_name):
    """Masked relinearization at the adjacent means x [m, t] (factor
    arguments fargs [m, n_args] or None), then the message update on the new
    linearization (`fused_messages`), row-major.  Returns (eta0, lam0, eta1,
    lam1, linpoint, jac [m, z*t], r0, since_relin [m, 1] as float)."""
    if not _on_card(x):
        return fused_relin_messages_plain(
            params, x, z_meas, fargs, linpoint, jac, r0, prec, since_relin, active, be0, bl0,
            be1, bl1, me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
            huber=huber, comp_name=comp_name)
    lp, jc, r0n, srel = _relin_any(
        "fused_relin_messages", params, (x, z_meas, linpoint, jac, r0, since_relin, active),
        fargs, row_major=True, d0=d0, d1=d1, z=z, comp_name=comp_name)
    out = fused_messages(params, jc, lp, r0n, prec, srel, active, be0, bl0, be1, bl1,
                         me0, ml0, me1, ml1, d0=d0, d1=d1, z=z, prec_full=prec_full,
                         huber=huber)
    return (*out, lp, jc, r0n, srel)
