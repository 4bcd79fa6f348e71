"""Incremental (online) bundle adjustment: the graph grows inside fixed-capacity tensors.

Counterpart of gbp_tpu/models/online.py.  Every tensor keeps a FIXED
capacity and the graph grows by value only:

  * cameras / landmarks / observations live in capacity-sized tensors with
    an active prefix; the counts are 0-d int32 tensors on the state's device,
    never Python ints, so no step reads them back;
  * inactive factor rows are `valid=False` (the sweep masks them); inactive
    variables hold an identity prior so their belief solves stay finite;
  * `add_frame` writes one camera, up to `chunk` observations and new
    landmarks at the device-side offsets (by gather: see `_rows_writer`) and
    linearizes just the new rows;
  * each change of `adj` or `valid` rebuilds the factor block's CSRs on the
    device (`graph.adjacency_csr_device`), which the belief sums
    (`ops.messages.segsum_by_id`, kernel 3) walk: the valid rows only.

Nothing here reads the device but the capacity check of `add_frame` and
`snapshot`, so a whole serving frame (bench/serving.py) is one CUDA graph.
The generic row-major sweep (`core/sweep.py`) runs the online graph: its
adjacency changes as observations arrive, which the CM layouts bake in.

The host-side helpers (`frames_from_sim`, `cheirality_ok`, `OnlineIds`) are
the reference's numpy code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core import sweep as sweep_mod
from gbp_tpu_torch.core.graph import FactorBlock, Graph, VariableBlock, adjacency_csr_device
from gbp_tpu_torch.core.sweep import FactorState, GBPConfig, GBPState, VariableState
from gbp_tpu_torch.factors import reprojection
from gbp_tpu_torch.ops.messages import segsum_by_id

D_C, D_L, ZD = 6, 3, 2


@dataclasses.dataclass(frozen=True)
class OnlineBA:
    """Fixed-capacity BA problem + GBP state; update with `dataclasses.replace`."""

    graph: Graph
    state: GBPState
    n_cams: torch.Tensor  # [] int32 active cameras
    n_lmks: torch.Tensor  # [] int32 active landmarks
    n_obs: torch.Tensor  # [] int32 active observations
    # Marginalization info absorbed into landmark priors by evict_frames
    # (fixed-lag smoothing), kept apart so that weaken_landmark_priors anneals
    # only the arrival priors, never absorbed measurement information.
    marg_eta: torch.Tensor | None = None  # [lmk_capacity, 3]
    marg_lam: torch.Tensor | None = None  # [lmk_capacity, 3, 3]
    chunk: int = 0
    # New-landmark prior precision: a landmark seen from one view has
    # unobservable depth and, under a weak prior, its mean wanders (behind
    # the camera at worst); `weaken_landmark_priors` relaxes it per frame.
    lmk_prior_prec: float = 50.0


def tensors(obj) -> list:
    """Every tensor of an OnlineBA (or of any nesting of dataclasses, named
    tuples and tuples of tensors), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in tensors(o)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensors(getattr(obj, f.name))]
    return []


def map_tensors(fn, obj):
    """`obj` with every tensor t (in the nesting `tensors` walks) replaced by fn(t)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = [map_tensors(fn, o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def _with_csr(fb: FactorBlock, counts) -> FactorBlock:
    """fb with its CSRs rebuilt on the device from adj and valid."""
    return dataclasses.replace(fb, csr=tuple(
        adjacency_csr_device(a, fb.valid, n) for a, n in zip(fb.adj, counts)))


def _counts(graph: Graph):
    return tuple(vb.count for vb in graph.vblocks)


def create(cam_capacity: int, lmk_capacity: int, obs_capacity: int, chunk: int = 256,
           pix_sigma_n: float = 0.002, lmk_prior_prec: float = 50.0,
           huber: float | None = 2.0, dtype=torch.float32, device=None) -> OnlineBA:
    """Empty fixed-capacity problem (normalized-coordinate reprojection) on
    `device` (None: the card).

    pix_sigma_n: measurement sigma in normalized image coordinates (pixel
    sigma / focal length).  chunk: the most observations one add_frame call
    takes.  huber: Mahalanobis threshold in std-devs (robust by default:
    every arrival enters with a single-view init whose first-sweep residuals
    are 10-30 sigma, and `evict_frames` freezes messages into priors)."""
    dev = resolve_device(device)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    eye = lambda d, n: torch.eye(d, dtype=dtype, device=dev).repeat(n, 1, 1)
    cams = VariableBlock(prior_eta=zeros(cam_capacity, D_C), prior_lam=eye(D_C, cam_capacity),
                         name="cam")
    lmks = VariableBlock(prior_eta=zeros(lmk_capacity, D_L), prior_lam=eye(D_L, lmk_capacity),
                         name="lmk")
    fb = FactorBlock(
        adj=(zeros(obs_capacity, dt=torch.int32), zeros(obs_capacity, dt=torch.int32)),
        z=zeros(obs_capacity, ZD),
        prec=torch.full((obs_capacity, ZD), 1.0 / pix_sigma_n ** 2, dtype=dtype, device=dev),
        valid=zeros(obs_capacity, dt=torch.bool),
        ftype=reprojection.reprojection_normalized(), vblocks=(0, 1), dofs=(D_C, D_L),
        huber=huber, name="reproj")
    graph = Graph(vblocks=(cams, lmks), fblocks=(_with_csr(fb, (cam_capacity, lmk_capacity)),))
    # The beliefs start equal to the priors, as copies: the reference shares
    # the arrays, but the serving step writes every field in place.
    state = GBPState(
        v=(VariableState(eta=cams.prior_eta.clone(), lam=cams.prior_lam.clone(),
                         mean=zeros(cam_capacity, D_C)),
           VariableState(eta=lmks.prior_eta.clone(), lam=lmks.prior_lam.clone(),
                         mean=zeros(lmk_capacity, D_L))),
        f=(FactorState(
            linpoint=zeros(obs_capacity, D_C + D_L), jac=zeros(obs_capacity, ZD, D_C + D_L),
            r0=zeros(obs_capacity, ZD),
            msg_eta=(zeros(obs_capacity, D_C), zeros(obs_capacity, D_L)),
            msg_lam=(zeros(obs_capacity, D_C, D_C), zeros(obs_capacity, D_L, D_L)),
            since_relin=zeros(obs_capacity, dt=torch.int32)),))
    count = lambda: zeros(dt=torch.int32)
    return OnlineBA(graph=graph, state=state, n_cams=count(), n_lmks=count(), n_obs=count(),
                    marg_eta=zeros(lmk_capacity, D_L), marg_lam=zeros(lmk_capacity, D_L, D_L),
                    chunk=chunk, lmk_prior_prec=lmk_prior_prec)


def add_frame(ob: OnlineBA, cam_mean, cam_prior_prec, obs_cam_local, obs_lmk, obs_uv,
              obs_count, new_lmk_means, new_lmk_count, check: bool = True) -> OnlineBA:
    """Capacity-checked wrapper around `_add_frame`.

    With check=True the three counts are read back once (a device round
    trip) and overflow raises ValueError: past capacity the writes would be
    dropped while the counts still advance.  Latency-critical loops that
    pre-size capacity pass check=False, which reads nothing back."""
    if check:
        nc, nl, no = torch.stack([ob.n_cams, ob.n_lmks, ob.n_obs]).tolist()
        if nc + 1 > ob.graph.vblocks[0].count:
            raise ValueError("camera capacity exhausted")
        if nl + int(new_lmk_count) > ob.graph.vblocks[1].count:
            raise ValueError("landmark capacity exhausted")
        if no + int(obs_count) > ob.graph.fblocks[0].count:
            raise ValueError("observation capacity exhausted")
    return _add_frame(ob, cam_mean, cam_prior_prec, obs_cam_local, obs_lmk, obs_uv, obs_count,
                      new_lmk_means, new_lmk_count)


def _rows_writer(cap: int, offset, count, chunk: int, device):
    """put(a, new) -> a with rows offset .. offset + count - 1 replaced by
    new[0 .. count - 1] (new=None: by zeros).

    The reference scatters with the pad rows sent out of bounds, where JAX
    drops the writes; PyTorch's scatter raises there.  So each of the `cap`
    rows gathers its source row r - offset and keeps its old value where
    that is not in [0, count): the same result, fixed shapes, no host read,
    and no two writes to one row."""
    src = torch.arange(cap, device=device) - offset
    on = (src >= 0) & (src < count) & (src < chunk)
    idx = src.clamp(0, chunk - 1)

    def put(a, new=None):
        mask = on.view((cap,) + (1,) * (a.ndim - 1))
        return torch.where(mask, 0 if new is None else new.to(a.dtype)[idx], a)

    return put


def _add_frame(ob: OnlineBA, cam_mean, cam_prior_prec, obs_cam_local, obs_lmk, obs_uv,
               obs_count, new_lmk_means, new_lmk_count) -> OnlineBA:
    """Append one camera, `new_lmk_count` landmarks and `obs_count`
    observations (inputs padded to the chunk size; tensors on the state's
    device, or anything `torch.as_tensor` takes).

    obs_cam_local: [chunk] 0 for the new camera, else the (negative) offset
    from it.  obs_lmk: [chunk] landmark ids, where an id >= the current
    n_lmks refers to this call's new landmarks."""
    g = ob.graph
    fb = g.fblocks[0]
    dt, dev = fb.z.dtype, fb.z.device
    t = lambda a, dtype=dt: torch.as_tensor(a, device=dev).to(dtype)
    ci, li, oi = ob.n_cams, ob.n_lmks, ob.n_obs
    chunk = ob.chunk
    cams, lmks = g.vblocks
    v0, v1 = ob.state.v

    # --- camera: row n_cams ------------------------------------------------
    cam_mean = t(cam_mean)
    pp = t(cam_prior_prec).expand(D_C)
    at_ci = (torch.arange(cams.count, device=dev) == ci)[:, None]
    cam_eta, cam_lam = pp * cam_mean, torch.diag_embed(pp)
    cams = dataclasses.replace(cams, prior_eta=torch.where(at_ci, cam_eta, cams.prior_eta),
                               prior_lam=torch.where(at_ci[:, :, None], cam_lam, cams.prior_lam))
    v0 = VariableState(eta=torch.where(at_ci, cam_eta, v0.eta),
                       lam=torch.where(at_ci[:, :, None], cam_lam, v0.lam),
                       mean=torch.where(at_ci, cam_mean, v0.mean))

    # --- landmarks: rows n_lmks .. n_lmks + new_lmk_count - 1 --------------
    new_lmk_means = t(new_lmk_means)
    put_l = _rows_writer(lmks.count, li, t(new_lmk_count, torch.int32), chunk, dev)
    lpp = ob.lmk_prior_prec
    lmk_eta = lpp * new_lmk_means
    lmk_lam = torch.eye(D_L, dtype=dt, device=dev).repeat(chunk, 1, 1) * lpp
    lmks = dataclasses.replace(lmks, prior_eta=put_l(lmks.prior_eta, lmk_eta),
                               prior_lam=put_l(lmks.prior_lam, lmk_lam))
    v1 = VariableState(eta=put_l(v1.eta, lmk_eta), lam=put_l(v1.lam, lmk_lam),
                       mean=put_l(v1.mean, new_lmk_means))

    # --- observations: rows n_obs .. n_obs + obs_count - 1 -----------------
    n_o = t(obs_count, torch.int32)
    on = torch.arange(chunk, device=dev) < n_o
    cam_ids = (ci + t(obs_cam_local, torch.int32)).to(torch.int32)
    lmk_ids = t(obs_lmk, torch.int32)
    obs_uv = t(obs_uv)
    put_r = _rows_writer(fb.count, oi, n_o, chunk, dev)
    fb = dataclasses.replace(fb, adj=(put_r(fb.adj[0], cam_ids), put_r(fb.adj[1], lmk_ids)),
                             z=put_r(fb.z, obs_uv), valid=put_r(fb.valid, torch.ones_like(on)))
    fb = _with_csr(fb, (cams.count, lmks.count))

    # linearize only the new rows, at the current means
    x_new = torch.cat([v0.mean[torch.where(on, cam_ids, 0).long()],
                       v1.mean[torch.where(on, lmk_ids, 0).long()]], dim=-1)
    chunk_fb = dataclasses.replace(fb, adj=(cam_ids, lmk_ids),
                                   z=torch.where(on[:, None], obs_uv, 0.0),
                                   prec=fb.prec[:chunk], valid=None, csr=None)
    jac, r0 = sweep_mod.linearize_block(chunk_fb, x_new)
    fs = ob.state.f[0]
    fs = FactorState(
        linpoint=put_r(fs.linpoint, x_new), jac=put_r(fs.jac, jac), r0=put_r(fs.r0, r0),
        msg_eta=tuple(put_r(a) for a in fs.msg_eta),
        msg_lam=tuple(put_r(a) for a in fs.msg_lam),
        since_relin=put_r(fs.since_relin))
    return dataclasses.replace(
        ob, graph=dataclasses.replace(g, vblocks=(cams, lmks), fblocks=(fb,)),
        state=GBPState(v=(v0, v1), f=(fs,)),
        n_cams=ci + 1, n_lmks=li + t(new_lmk_count, torch.int32), n_obs=oi + n_o)


def _anneal_scale(lam, on, factor, floor):
    """Per-variable prior scale: `factor`, but not below floor / max diag,
    and at most 1; 1 for inactive variables."""
    cur = torch.diagonal(lam, dim1=1, dim2=2).amax(dim=1)
    s = torch.full_like(cur, floor) / cur.clamp(min=1e-20)
    return torch.where(on, s.clamp(min=factor), 1.0).clamp(max=1.0)


def weaken_landmark_priors(ob: OnlineBA, factor=0.5, floor=1.0) -> OnlineBA:
    """Scale every active landmark's ARRIVAL prior by `factor`, with the
    diagonal kept at or above `floor`: once per frame this gives each
    landmark an age-dependent prior, firm while single-view and relaxing as
    views accumulate.  The marginalization info absorbed by `evict_frames`
    is subtracted before the scaling and added back after."""
    lmks = ob.graph.vblocks[1]
    on = torch.arange(lmks.count, device=lmks.prior_eta.device) < ob.n_lmks
    m_eta = 0.0 if ob.marg_eta is None else ob.marg_eta
    m_lam = 0.0 if ob.marg_lam is None else ob.marg_lam
    ann_eta, ann_lam = lmks.prior_eta - m_eta, lmks.prior_lam - m_lam
    s = _anneal_scale(ann_lam, on, factor, floor)
    lmks = dataclasses.replace(lmks, prior_eta=ann_eta * s[:, None] + m_eta,
                               prior_lam=ann_lam * s[:, None, None] + m_lam)
    return dataclasses.replace(ob, graph=dataclasses.replace(
        ob.graph, vblocks=(ob.graph.vblocks[0], lmks)))


def weaken_camera_priors(ob: OnlineBA, factor=0.7, floor=30.0) -> OnlineBA:
    """Anneal the active cameras' arrival priors by `factor` down to `floor`
    (the fixed-lag twin of `weaken_landmark_priors`; cameras absorb no
    marginalization info, so the whole prior anneals)."""
    cams = ob.graph.vblocks[0]
    on = torch.arange(cams.count, device=cams.prior_eta.device) < ob.n_cams
    s = _anneal_scale(cams.prior_lam, on, factor, floor)
    cams = dataclasses.replace(cams, prior_eta=cams.prior_eta * s[:, None],
                               prior_lam=cams.prior_lam * s[:, None, None])
    return dataclasses.replace(ob, graph=dataclasses.replace(
        ob.graph, vblocks=(cams, ob.graph.vblocks[1])))


def evict_frames(ob: OnlineBA, n_evict: int, marg_discount: float = 0.5) -> OnlineBA:
    """Fixed-lag eviction of the oldest `n_evict` cameras, so the problem
    serves indefinitely.

    Evicting a camera freezes each of its factors' current landmark-slot
    message into the landmark's prior, then deletes the factors and the
    camera.  marg_discount scales the frozen messages.  The default 0.5 is a
    forgetting factor, as in the reference: the absorbed prior is HALF the
    marginal, not the exact marginal (the message may be frozen mid-recovery
    from an arrival transient; the reference measured a small tail-quality
    gain on its 120-frame corridor stream).  marg_discount=1.0 absorbs the
    messages whole: the exact marginal of the evicted factors onto their
    landmarks at the current linearization.

    The absorbed sums run through `segsum_by_id` over the device CSR of the
    evicted rows.  Then the factor rows compact by a stable sort (survivors
    first, in order), cameras shift down by `n_evict`, and landmarks below
    the lowest id a surviving factor needs (ids follow first sighting) leave
    with their absorbed estimates: the landmark tensors roll down by that
    device-side count, by gather."""
    g = ob.graph
    fb, fs = g.fblocks[0], ob.state.f[0]
    cams, lmks = g.vblocks
    v0, v1 = ob.state.v
    dt, dev = fb.z.dtype, fb.z.device
    lcap, ocap = lmks.count, fb.count

    ev = fb.valid & (fb.adj[0] < n_evict)  # factors losing their camera
    keep = fb.valid & ~ev

    # --- absorb the evicted factors' landmark messages into the priors ----
    w = (ev.to(dt) * marg_discount)[:, None]
    absorbed = segsum_by_id(fs.msg_eta[1] * w, fs.msg_lam[1].reshape(ocap, -1) * w,
                            *adjacency_csr_device(fb.adj[1], ev, lcap), row_major=True)
    a_eta, a_lam = absorbed[:, :D_L], absorbed[:, D_L:].reshape(lcap, D_L, D_L)
    marg_eta, marg_lam = ob.marg_eta + a_eta, ob.marg_lam + a_lam
    prior_eta_l, prior_lam_l = lmks.prior_eta + a_eta, lmks.prior_lam + a_lam

    # --- compact factor rows: survivors to the front, in order -------------
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    keep_p = keep[order]
    kf = keep.to(dt)[:, None]
    # One wide gather for the float factor state; dead rows' messages are
    # zeroed first (belief sums rely on zero messages in inert rows).
    wide = torch.cat([
        fs.linpoint, fs.jac.reshape(ocap, -1), fs.r0,
        fs.msg_eta[0] * kf, fs.msg_eta[1] * kf,
        fs.msg_lam[0].reshape(ocap, -1) * kf, fs.msg_lam[1].reshape(ocap, -1) * kf,
        fb.z], dim=1)[order]
    t = D_C + D_L
    offs = np.cumsum([0, t, ZD * t, ZD, D_C, D_L, D_C * D_C, D_L * D_L, ZD])
    cut = lambda i: wide[:, offs[i]:offs[i + 1]]

    adj0 = torch.where(keep_p, (fb.adj[0][order] - n_evict).clamp(min=0), 0)
    adj1_p = fb.adj[1][order]
    # The landmark cut: the lowest id a surviving factor needs.
    lmin = torch.where(keep_p, adj1_p, ob.n_lmks).min()
    adj1 = torch.where(keep_p, (adj1_p - lmin).clamp(min=0), 0)
    new_fb = _with_csr(dataclasses.replace(
        fb, adj=(adj0.to(torch.int32), adj1.to(torch.int32)), z=cut(7), prec=fb.prec[order],
        valid=keep_p), _counts(g))
    new_fs = FactorState(
        linpoint=cut(0), jac=cut(1).reshape(ocap, ZD, t), r0=cut(2),
        msg_eta=(cut(3), cut(4)),
        msg_lam=(cut(5).reshape(ocap, D_C, D_C), cut(6).reshape(ocap, D_L, D_L)),
        since_relin=torch.where(keep_p, fs.since_relin[order], 0))

    # --- shift cameras down by n_evict (inert tail) -------------------------
    eye_c = torch.eye(D_C, dtype=dt, device=dev).repeat(n_evict, 1, 1)
    z6 = torch.zeros((n_evict, D_C), dtype=dt, device=dev)
    shift = lambda a, fill: torch.cat([a[n_evict:], fill], dim=0)
    new_cams = dataclasses.replace(cams, prior_eta=shift(cams.prior_eta, z6),
                                   prior_lam=shift(cams.prior_lam, eye_c))
    new_v0 = VariableState(eta=shift(v0.eta, z6), lam=shift(v0.lam, eye_c),
                           mean=shift(v0.mean, z6))

    # --- roll landmarks down by lmin (inert wrapped tail) -------------------
    rows_l = torch.arange(lcap, device=dev)
    live = rows_l < ob.n_lmks - lmin
    src = (rows_l + lmin) % lcap  # jnp.roll(a, -lmin) as a gather
    eye_l = torch.eye(D_L, dtype=dt, device=dev)

    def roll_l(a, identity=False):
        mask = live.view((lcap,) + (1,) * (a.ndim - 1))
        return torch.where(mask, a[src], eye_l if identity else 0.0)

    new_lmks = dataclasses.replace(lmks, prior_eta=roll_l(prior_eta_l),
                                   prior_lam=roll_l(prior_lam_l, identity=True))
    new_v1 = VariableState(eta=roll_l(v1.eta), lam=roll_l(v1.lam, identity=True),
                           mean=roll_l(v1.mean))
    return dataclasses.replace(
        ob, graph=dataclasses.replace(g, vblocks=(new_cams, new_lmks), fblocks=(new_fb,)),
        state=GBPState(v=(new_v0, new_v1), f=(new_fs,)),
        n_cams=ob.n_cams - n_evict, n_lmks=ob.n_lmks - lmin,
        n_obs=keep.sum().to(torch.int32),
        marg_eta=roll_l(marg_eta), marg_lam=roll_l(marg_lam))


def run(ob: OnlineBA, cfg: GBPConfig, n_iters: int) -> OnlineBA:
    """n_iters synchronous sweeps on the current (masked) graph."""
    return dataclasses.replace(ob, state=sweep_mod.run(ob.graph, ob.state, cfg, n_iters))


def snapshot(ob: OnlineBA) -> dict:
    """Host copy of the ACTIVE subproblem (offline refinement, metrics,
    export): one read of the counts, then the active prefixes."""
    nc, nl, no = torch.stack([ob.n_cams, ob.n_lmks, ob.n_obs]).tolist()
    fb = ob.graph.fblocks[0]
    n = lambda a: a.detach().cpu().numpy()
    return dict(cam_means=n(ob.state.v[0].mean[:nc]), lmk_means=n(ob.state.v[1].mean[:nl]),
                cam_ids=n(fb.adj[0][:no]), lmk_ids=n(fb.adj[1][:no]), z=n(fb.z[:no]))


# --- host-side helpers (the reference's numpy code) ---------------------------------


def frames_from_sim(sim, odometry_sigma=None, odometry_seed=1234):
    """Group a batch sim's observations into per-camera arrival-order frames
    in GLOBAL landmark ids and normalized coordinates; the caller owns the
    global -> online id map (`OnlineIds`), which a fixed-lag stream must
    track frame by frame.

    odometry_sigma=(rot, trans): also attach a noisy RELATIVE camera motion
    `rel` = (R_rel, t_rel) per frame (world -> cam: T_i = rel o T_{i-1}) and
    each frame's landmark inits in its camera's frame, `lmk_cam` (the
    triangulation stand-in of a tracking frontend), drawn with
    np.random.default_rng(odometry_seed).  Odometry arrivals have a lever arm
    of about one step, where the sim's absolute noisy poses put the noise on
    [omega, t] with |t| growing along the trajectory."""
    k = sim["k"]
    uv_n = np.stack([(sim["obs"][:, 0] - k[2]) / k[0],
                     (sim["obs"][:, 1] - k[3]) / k[1]], axis=1)
    frames = [dict(cam=sim["cam_init"][c],
                   lmk_global=sim["lmk_ids"][sel].astype(np.int64),
                   obs_uv=uv_n[sel])
              for c in range(sim["cam_init"].shape[0])
              for sel in (np.flatnonzero(sim["cam_ids"] == c),)]
    if odometry_sigma is not None:
        rng = np.random.default_rng(odometry_seed)
        sr, st = odometry_sigma
        tru = np.asarray(sim["cam_truth"], np.float64)
        for i, fr in enumerate(frames):
            r_i = _so3_exp_np(tru[i][:3])
            fr["lmk_cam"] = (sim["lmk_init"][fr["lmk_global"]] @ r_i.T
                             + tru[i][3:])
            if i == 0:
                continue
            r_prev = _so3_exp_np(tru[i - 1][:3])
            r_rel = r_i @ r_prev.T
            t_rel = tru[i][3:] - r_rel @ tru[i - 1][3:]
            r_rel = _so3_exp_np(rng.normal(0.0, sr, 3)) @ r_rel
            fr["rel"] = (r_rel, t_rel + rng.normal(0.0, st, 3))
    return frames


def _so3_exp_np(w):
    th = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + k
    return (np.eye(3) + np.sin(th) / th * k
            + (1.0 - np.cos(th)) / th ** 2 * (k @ k))


def _so3_log_np(r):
    c = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(c))
    v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if th < 1e-12:
        return v / 2.0
    return th / (2.0 * np.sin(th)) * v


def cheirality_ok(cam6, pts, min_frac=0.95, eps=0.05):
    """Does the world -> cam pose `cam6` put at least `min_frac` of `pts`
    [n, 3] in front of the camera (z > eps)?  A streaming frontend catches an
    arrival init whose own landmarks sit behind it (no solver converges a
    reprojection factor from the wrong side of z = 0) and falls back to a
    motion-model pose (bench/serving.py)."""
    r = _so3_exp_np(np.asarray(cam6[:3], np.float64))
    z = (np.asarray(pts, np.float64) @ r.T + np.asarray(cam6[3:]))[:, 2]
    return z.size == 0 or float((z > eps).mean()) >= min_frac


class OnlineIds:
    """Host-side global -> online landmark id map for a fixed-lag stream.

    `evict_frames(ob, n)` drops the oldest cameras and compacts landmarks:
    ids below the cut disappear and the rest shift down by the cut.
    `shift(lmin)` mirrors that; a re-observation of a marginalized landmark
    re-enters as a NEW landmark."""

    def __init__(self):
        self._map = {}

    def shift(self, lmin: int):
        self._map = {g: i - lmin for g, i in self._map.items() if i >= lmin}

    def resolve(self, lmk_global, n_lmks: int):
        """Map one frame's global ids to online ids, allocating fresh ids
        (from n_lmks on) for unseen or evicted landmarks.  Returns
        (online_ids [n_obs], new_sel): new_sel indexes the frame's
        observations at each first sighting."""
        ids, new_sel = [], []
        for j, g in enumerate(np.asarray(lmk_global)):
            g = int(g)
            if g not in self._map:
                self._map[g] = n_lmks + len(new_sel)
                new_sel.append(j)
            ids.append(self._map[g])
        return (np.asarray(ids, np.int32), np.asarray(new_sel, np.int64))
