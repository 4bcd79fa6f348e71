"""The halo paths' windowed kernels (kernels 12, 13, 17 and 18 of the
reference: `messages_cm_tabblkg`, `relin_cm_tabblkg`,
`messages_cm_tabblkg_ell`, `relin_cm_tabblkg_ell`): their plain versions
against the reference's Pallas kernels in interpret mode, on a few tiles of
real factor rows whose gathered ids hit the tile's window of the owned
table, the ghost table and the ghost table's cut-camera extension.

The rows come from small scenes through the port's own halo_cm path (one
partition), after a few sweeps; the owned / ghost split, the windows and the
cut rows are then laid over them, so that every row reads the same belief
through the halo kernels as through the whole-table kernels.  Shapes:
(6, 3, 2) and (9, 3, 2) with slot 0 gathered, (3, 3, 3) with slot 1
gathered and per-row Huber thresholds; relinearization at the config's beta
and at the median distance (both kinds of rows).

Tolerance: 1e-12 relative to each output's magnitude in float64 (the same
model and message math in the same operation order; the reference selects
rows by one-hot dots, exact for one nonzero).  The halo kernels' plain
versions also equal the whole-table kernels' bit for bit.  The CUDA
kernels run only on a card (`cuda`-marked case; chip_smoke.py at city
scale)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.io import bal
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm

torch.set_num_threads(1)
TILE, SUB, LANE = 1024, 8, 128
W = 128
BA_CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=2, min_linear_iters=0)


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def reference():
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.core.sweep_cm import _start_slices
    from gbp_tpu.ops import messages_pallas as mp

    return types.SimpleNamespace(jnp=jnp, JConfig=JConfig, j_kernel_params=j_kernel_params,
                                 start_slices=_start_slices, mp=mp)


def scene(kind):
    """(graph in plain layout, means, config, huber of the scene)."""
    if kind == "ba632":
        sim = pba.simulate(n_cams=16, n_lmks=200, seed=0)
        g, m = pba.build(sim, dtype=torch.float64, device="cpu", cam_prior_prec=1000.0,
                         lmk_prior_prec=1000.0)
        return g, m, BA_CFG, 1.5
    if kind == "bal932":
        sim = bal.to_sim(bal.prune(bal.read_bal("data/toy_ba.txt")))
        g, m, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu", optimize_intrinsics=True)
        return g, m, BA_CFG, None
    sim = ppg.simulate_manhattan(n_poses=400, seed=0, loop_prob=0.3, loop_radius=3.0,
                                 outlier_frac=0.1)
    g, m = ppg.build(sim, dtype=torch.float64, device="cpu")
    cfg = dataclasses.replace(ppg.default_config(), min_linear_iters=0)
    return g, m, cfg, "row"


@pytest.fixture(scope="module", params=["ba632", "bal932", "pose333"])
def setup(request):
    """Real factor rows of one partition after 3 sweeps, with a synthetic
    owned / ghost split, windows and cut rows laid over them, and the
    reference's kernels called on the same operands."""
    r = reference()
    jnp = r.jnp
    g, m, cfg, huber = scene(request.param)
    hp = halo.partition(g, 1)
    hcm, rows_global = halo_cm.prepare(hp, window=False)
    st = halo_cm.init_state(hp, hcm, rows_global, m)
    st = halo_cm.make_run(hcm)(hcm, st, cfg, 3)
    d0, d1 = hcm.dofs
    gslot, deg = 1 - hcm.e, hcm.deg
    d_g, d_e = hcm.dofs[gslot], hcm.dofs[hcm.e]
    f_g, f_e = d_g + d_g * d_g, d_e + d_e * d_e
    n_tiles = min(hcm.mp // TILE, 3)
    mp = n_tiles * TILE
    assert mp % deg == 0
    nv = mp // deg
    tab_g, mean_g = (t[0] for t in halo_cm._pack_local(st.v[hcm.vb_g], st.ghost[hcm.vb_g],
                                                      hcm.n_loc_g, d_g))
    tab_e, mean_e = (t[0, :nv].contiguous() for t in halo_cm._pack_local(
        st.v[hcm.vb_e], st.ghost[hcm.vb_e], hcm.nv, d_e))
    cut = lambda a: a[0, :, :mp].contiguous()
    fs = types.SimpleNamespace(**{k: cut(getattr(st.f, k)) for k in ("lp", "jac", "r0", "srel")})
    msgs = tuple(cut(a) for a in (st.f.msg_eta[0], st.f.msg_lam[0], st.f.msg_eta[1],
                                  st.f.msg_lam[1]))
    z, prec, act = cut(hcm.z), cut(hcm.prec), cut(hcm.act)
    gidx0 = hcm.gidx[0, :mp].clone()

    # The halo split: owned ids [0, n_own) in windows of W, ghosts from n_own
    # on; odd ELL groups' owned rows (and every owned id outside its tile's
    # window) read a duplicated cut-camera row instead.
    n_g = int(gidx0.max()) + 1
    n_own = max(n_g // 2, 1)
    starts = np.array([SUB * (i % 2) if n_own > W // 2 else 0 for i in range(n_tiles)])
    ids = gidx0.numpy().astype(np.int64)
    tile_start = np.repeat(starts, TILE)
    owned = ids < n_own
    is_cut = owned & (((np.arange(mp) // deg) % 2 == 1) | (ids < tile_start)
                      | (ids >= tile_start + W))
    cuts = np.unique(ids[is_cut])
    ngp = -(-max(n_g - n_own, 1) // LANE) * LANE
    ncut = -(-max(len(cuts), 1) // SUB) * SUB
    lut = np.zeros(n_g, dtype=np.int64)
    lut[cuts] = np.arange(len(cuts))
    gidx = np.where(is_cut, n_own + ngp + lut[ids], ids).astype(np.int32)
    assert is_cut.any() and (~owned).any() and (owned & ~is_cut).any()
    rows_g = torch.zeros(ngp + ncut, dtype=torch.int64)
    rows_g[:n_g - n_own] = torch.arange(n_own, n_g)
    rows_g[ngp:ngp + len(cuts)] = torch.tensor(cuts)
    valid = torch.zeros(ngp + ncut, 1, dtype=torch.bool)
    valid[:n_g - n_own] = True
    valid[ngp:ngp + len(cuts)] = True
    gtab = torch.where(valid, tab_g[rows_g], torch.zeros(()))
    gmean = torch.where(valid, mean_g[rows_g], torch.zeros(()))
    be_e, bl_e, x_e = (a.contiguous() for a in M.expand_ell_blk_plain(
        torch.cat([tab_e, mean_e], 1), deg=deg).split([d_e, d_e * d_e, d_e]))

    # The reference's operands: per-tile windows of the owned table, the
    # transposed ghost table, the ELL group windows, [F, T, 128] state.
    jt = lambda a: jnp.asarray(a.numpy())
    cm = lambda a: jnp.asarray(a.numpy().reshape(a.shape[0], -1, LANE))
    width = int(starts.max()) + W
    own_t = torch.zeros(f_g + d_g, max(width, n_own), dtype=torch.float64)
    own_t[:, :n_own] = torch.cat([tab_g[:n_own], mean_g[:n_own]], 1).T
    wtab = jnp.stack([jt(own_t[:, s:s + W]) for s in starts])
    gtab_j = jt(torch.cat([gtab, gmean], 1).T)
    w2 = ((TILE // deg + 2) + SUB + LANE - 1) // LANE * LANE
    nvp = max(-(-nv // SUB) * SUB, w2)
    st2 = tuple(int(s) for s in np.clip((np.arange(n_tiles) * TILE // deg) // SUB * SUB, 0,
                                        nvp - w2))
    pk_e = torch.zeros(f_e + d_e, nvp, dtype=torch.float64)
    pk_e[:, :nv] = torch.cat([tab_e, mean_e], 1).T
    ltab = r.start_slices(jt(pk_e), None, st2, w2)
    j_starts = jnp.asarray(starts, jnp.int32)
    j_gidx = jnp.asarray(gidx.reshape(1, -1, LANE))
    jcfg = r.JConfig(**{k: getattr(cfg, k) for k in (
        "eta_damping", "lam_damping", "beta", "num_undamped_iters", "min_linear_iters")})
    kw = dict(d0=d0, d1=d1, z=hcm.zdim, gslot=gslot, win_w=W, n_own=n_own, interpret=True)
    ekw = dict(deg=deg, ell_w2=w2)

    def j_relin(beta, fused):
        p = r.j_kernel_params(dataclasses.replace(jcfg, beta=beta), jnp.float64)
        state = (cm(z), None, cm(fs.lp), cm(fs.jac), cm(fs.r0), cm(fs.srel), cm(act))
        rkw = dict(comp_name=hcm.comp_name, n_args=0, **kw)
        if fused:
            return r.mp.fused_relin_cm_tabblkg_ell(
                p, jnp.asarray(st2, jnp.int32), j_starts, ltab[:, f_e:], wtab[:, f_g:],
                gtab_j[f_g:], j_gidx, *state, **rkw, **ekw)
        return r.mp.fused_relin_cm_tabblkg(p, j_starts, cm(x_e), wtab[:, f_g:], gtab_j[f_g:],
                                           j_gidx, *state, **rkw)

    def j_messages(relin_out, fused):
        lp, jac, r0, srel = relin_out
        p = r.j_kernel_params(jcfg, jnp.float64)
        head = (jac, lp, r0, cm(prec), srel, cm(act))
        mkw = dict(prec_full=False, huber=huber, **kw)
        if fused:
            return r.mp.fused_messages_cm_tabblkg_ell(
                p, jnp.asarray(st2, jnp.int32), j_starts, *head, ltab[:, :f_e], wtab[:, :f_g],
                gtab_j[:f_g], j_gidx, *(cm(a) for a in msgs), **mkw, **ekw)
        return r.mp.fused_messages_cm_tabblkg(
            p, j_starts, *head, cm(be_e), cm(bl_e), wtab[:, :f_g], gtab_j[:f_g], j_gidx,
            *(cm(a) for a in msgs), **mkw)

    return types.SimpleNamespace(
        cfg=cfg, huber=huber, hcm=hcm, gslot=gslot, deg=deg, n_own=n_own, mp=mp,
        gidx=torch.tensor(gidx), gidx0=gidx0, starts=torch.tensor(starts, dtype=torch.int32),
        tab_g=tab_g, mean_g=mean_g, tab_e=tab_e, mean_e=mean_e, gtab=gtab.contiguous(),
        gmean=gmean.contiguous(), be_e=be_e, bl_e=bl_e, x_e=x_e, fs=fs, msgs=msgs, z=z,
        prec=prec, act=act, j_relin=j_relin, j_messages=j_messages)


def median_beta(s):
    x_g = s.mean_g[s.gidx0.long()].T
    x_e = s.x_e
    x = torch.cat([x_g, x_e] if s.gslot == 0 else [x_e, x_g])
    on = s.act[0] > 0.5
    # Halfway between the two middle distances: no row sits on the threshold,
    # where the last bit of dist^2 against beta^2 decides either way.
    d = ((x - s.fs.lp) ** 2).sum(0).sqrt()[on].sort().values
    k = d.shape[0] // 2
    return float(0.5 * (d[k - 1] + d[k]))


def port_relin(s, beta, fused):
    params = _kernel_params(dataclasses.replace(s.cfg, beta=beta), torch.float64)
    fs = s.fs
    state = (fs.lp, fs.jac, fs.r0, fs.srel, s.act)
    kw = dict(win_w=W, n_own=s.n_own, comp_name=s.hcm.comp_name, gslot=s.gslot)
    if fused:
        return M.relin_cm_tabblkg_ell_plain(params, s.mean_g[:s.n_own], s.gmean, s.mean_e, s.gidx,
                                            s.starts, s.z, *state, deg=s.deg, **kw)
    return M.relin_cm_tabblkg_plain(params, s.x_e, s.mean_g[:s.n_own], s.gmean, s.gidx, s.starts,
                                    s.z, None, *state, **kw)


def port_messages(s, relin_out, fused):
    lp, jac, r0, srel = relin_out
    params = _kernel_params(s.cfg, torch.float64)
    head = (jac, lp, r0, s.prec, srel, s.act)
    kw = dict(huber=s.huber, win_w=W, n_own=s.n_own, gslot=s.gslot)
    if fused:
        return M.messages_cm_tabblkg_ell_plain(params, s.tab_g[:s.n_own], s.gtab, s.tab_e, s.gidx,
                                               s.starts, *head, *s.msgs, deg=s.deg, **kw)
    return M.messages_cm_tabblkg_plain(params, *head, s.be_e, s.bl_e, s.tab_g[:s.n_own], s.gtab,
                                       s.gidx, s.starts, *s.msgs, **kw)


@pytest.mark.parametrize("fused", [True, False], ids=["ell_fused", "unfused"])
@pytest.mark.parametrize("which", ["config", "median"])
def test_halo_relin_plain_matches_reference(setup, which, fused):
    s = setup
    beta = s.cfg.beta if which == "config" else median_beta(s)
    got = port_relin(s, beta, fused)
    for a, b in zip(got, s.j_relin(beta, fused)):
        assert rel(a, b) <= 1e-12
    n_relin, n_on = int((got[3] == 0).sum()), int(s.act.sum())
    assert 0 < n_relin < n_on if which == "median" else n_relin > 0
    # The same rows through the whole table: the halo split changes where a
    # row reads its mean, not the value.
    params = _kernel_params(dataclasses.replace(s.cfg, beta=beta), torch.float64)
    whole = M.relin_cm_tab_plain(params, s.x_e, s.mean_g, s.gidx0, s.z, None, s.fs.lp, s.fs.jac,
                                 s.fs.r0, s.fs.srel, s.act, comp_name=s.hcm.comp_name,
                                 gslot=s.gslot)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [True, False], ids=["ell_fused", "unfused"])
def test_halo_messages_plain_matches_reference(setup, fused):
    s = setup
    beta = median_beta(s)
    relin = port_relin(s, beta, fused)
    j_in = tuple(s.j_relin(beta, fused))
    got = port_messages(s, relin, fused)
    for a, b in zip(got, s.j_messages(j_in, fused)):
        assert rel(a, b) <= 1e-12
    params = _kernel_params(s.cfg, torch.float64)
    lp, jac, r0, srel = relin
    whole = M.messages_cm_tab_plain(params, jac, lp, r0, s.prec, srel, s.act, s.be_e, s.bl_e,
                                    s.tab_g, s.gidx0, *s.msgs, huber=s.huber, gslot=s.gslot)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_halo_plain_rejects_ids_outside_their_sources(setup):
    s = setup
    params = _kernel_params(s.cfg, torch.float64)
    fs = s.fs
    kw = dict(deg=s.deg, win_w=W, n_own=s.n_own, comp_name=s.hcm.comp_name, gslot=s.gslot)
    bad = s.gidx.clone()
    bad[3] = s.n_own + s.gtab.shape[0]
    with pytest.raises(ValueError, match="beyond the ghost table"):
        M.relin_cm_tabblkg_ell_plain(params, s.mean_g[:s.n_own], s.gmean, s.mean_e, bad,
                                     s.starts, s.z, fs.lp, fs.jac, fs.r0, fs.srel, s.act, **kw)
    bad = s.gidx.clone()
    bad[TILE + 3] = int(s.starts[1]) + W if s.n_own > int(s.starts[1]) + W else -1
    with pytest.raises(ValueError, match="outside its tile's window"):
        M.relin_cm_tabblkg_ell_plain(params, s.mean_g[:s.n_own], s.gmean, s.mean_e, bad,
                                     s.starts, s.z, fs.lp, fs.jac, fs.r0, fs.srel, s.act, **kw)


def test_cpu_tensors_take_the_plain_versions(setup):
    s = setup
    M.COUNTS.reset()
    relin = port_relin(s, s.cfg.beta, True)
    port_messages(s, relin, True)
    relin = port_relin(s, s.cfg.beta, False)
    port_messages(s, relin, False)
    halo_names = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "relin_cm_tabblkg",
                  "messages_cm_tabblkg")
    assert {k: v for k, v in M.COUNTS.plain.items() if v} == dict.fromkeys(halo_names, 1)
    assert not any(M.COUNTS.kernel.values())
    assert len(M.KERNELS) == 20 and set(halo_names) <= set(M.KERNELS)


# --- on the card ------------------------------------------------------------------------


def halo_widened(hcm, w):
    """`hcm` with every partition's owned-camera windows widened to `w`
    (starts moved down where the wider window would pass the padded owned
    count): a valid windowing at the shared-memory sizes of wider scenes."""
    dev = hcm.gidx.device
    no = hcm.comm[hcm.vb_g].n_own_max
    nopad = -(-no // SUB) * SUB
    starts = np.minimum(hcm.win_starts.cpu().numpy(), nopad - w) // SUB * SUB
    assert w <= nopad and (starts >= 0).all()
    gidx = hcm.gidx.cpu().numpy()
    csr = [M.window_rows_csr(gidx[c], starts[c], w, n_own=no) for c in range(len(starts))]
    blk = [M.window_block_csr(starts[c], w, no) for c in range(len(starts))]
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
    padded = lambda lists: np.stack([np.pad(a, (0, max(len(b) for b, _ in lists) - len(a)))
                                     for a, _ in lists])
    return hcm._replace(win_w=w, win_starts=i32(starts),
                        win_rows=i32(np.stack([a for a, _ in csr])),
                        win_offsets=i32(np.stack([b for _, b in csr])),
                        blk_tiles=i32(padded(blk)), blk_offsets=i32(np.stack([b for _, b in blk])))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wide", [(torch.float64, 1e-11, None),
                                            (torch.float32, 1e-4, None),
                                            (torch.float32, 1e-4, 384)])
def test_halo_kernels_match_plain_on_card(dtype, tol, wide):
    """One halo sweep (city-like blocks cut in two) through kernels 17, 18,
    12, 13 against the same sweep through their plain versions; also with
    every window widened to 384 cameras (64.5 KB in float32: kernels 17 and
    12 take one operand stage), and with the ghost table the launch plan
    keeps in device memory or stages."""
    dev = _card()
    sim = pba.simulate_blocks(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0,
                              shuffle=True)
    g, m = pba.build(sim, dtype=dtype, device="cpu", cam_prior_prec=1000.0,
                     lmk_prior_prec=1000.0)
    cfg = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
    for fused in (True, False):
        hp, hcm, st, run = halo_cm.distribute(g, m, 2, device="cpu", ell_fused=fused)
        assert hcm.win_w
        st = halo.to_device(run(hcm, st, cfg, 8), dev)
        hcm = halo.to_device(hcm if wide is None else halo_widened(hcm, wide), dev)
        names = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "relin_cm_tabblkg",
                 "messages_cm_tabblkg")
        M.COUNTS.reset()
        got = halo_cm.make_run(hcm)(hcm, st, cfg, 1)
        torch.cuda.synchronize()
        assert sum(M.COUNTS.kernel[n] for n in names) == 4 and not any(M.COUNTS.plain.values())
        saved = {n: getattr(halo_cm, n) for n in names}
        try:
            for n in names:
                setattr(halo_cm, n, getattr(M, n + "_plain"))
            ref = halo_cm.make_run(hcm)(hcm, st, cfg, 1)
        finally:
            for n, f in saved.items():
                setattr(halo_cm, n, f)
        for a, b in zip(got.f.msg_eta + got.f.msg_lam + (got.f.lp, got.f.jac),
                        ref.f.msg_eta + ref.f.msg_lam + (ref.f.lp, ref.f.jac)):
            assert rel(a.cpu(), b.cpu()) <= tol
