"""The windowed unfused path of the port (kernels 8 and 9 of the reference:
`relin_cm_tabblk`, `messages_cm_tabblk`): their plain versions against the
reference's `fused_relin_cm_tabblk` / `fused_messages_cm_tabblk` (Pallas in
interpret mode), the sweep that runs them (`prepare(ell_fused=False)` with
engaged camera windows) against the reference's and the port's fused
windowed sweep, and the degree-1 rule: `prepare` tries camera windows at
ELL degree 1, as the reference does.

Tolerances, relative to each output's magnitude:
  kernels 8 and 9 against the reference's, float64: 1e-12 (the same model
    and message math in the same operation order; the reference selects
    window rows by one-hot dots, exact for one nonzero); 1e-4 in float32 on
    the card;
  one sweep from a common state: 1e-10 (the sums and the belief solves
    round in another order);
  15 sweeps against the reference: 1e-4 absolute on the means, the bound of
    the reference's own fused-against-unfused check (tests/test_ell_fused.py:
    the beta decisions amplify last-bit differences along a relinearizing
    run); the port's fused and unfused windowed sweeps run the same
    arithmetic in the same order and agree bit for bit.

The CUDA kernels run only on a card: the `cuda`-marked case holds them
against these plain versions there; chip_smoke.py does so at city scale.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.ops import messages as M
from test_torch_window import CARD_SCENES, _card, card_state, off16, widened

torch.set_num_threads(1)
BA_CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PCFG = GBPConfig(**BA_CFG)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
UNFUSED_WIN = ("relin_cm_tabblk", "messages_cm_tabblk", "expand_ell_blk", "segsum_cm_blk",
               "scatter_windows_cm")


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def reference():
    """The JAX reference's modules, imported on first use (the card case
    runs without JAX)."""
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import VariableState as JVar
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import pose_graph as jpg
    from gbp_tpu.ops import messages_pallas as mp

    return types.SimpleNamespace(jax=jax, jnp=jnp, J=J, JConfig=JConfig, JVar=JVar,
                                 j_kernel_params=j_kernel_params, jba=jba, jpg=jpg, mp=mp)


@functools.cache
def jsweep():
    """The reference's one sweep as one compiled program (an eager call
    compiles each of its operations apart, about twice the time; the results
    agree with it to roundoff)."""
    return reference().jax.jit(reference().J.sweep, static_argnums=2)


@functools.cache
def jare():
    """The reference's ARE as one compiled program (eager, it compiles each
    of its operations apart, seconds a graph; the value agrees to roundoff)."""
    return reference().jax.jit(reference().jba.avg_reprojection_error, static_argnames="fi")


def jax_state(d, jdt=None):
    r = reference()
    arr = lambda a: r.jnp.asarray(a, jdt)
    f = {k: (tuple(arr(a) for a in v) if isinstance(v, tuple) else arr(v))
         for k, v in d["f"].items()}
    return r.J.CMState(v=tuple(r.JVar(**{k: arr(a) for k, a in v.items()}) for v in d["v"]),
                       f=r.J.CMFactorState(**f))


def blocks7():
    return pba.simulate_blocks(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0,
                               shuffle=True)


def scene(kind):
    """(port graph, means, reference graph, configs, warm-up sweeps)."""
    r = reference()
    if kind == "ba":
        sim = blocks7()
        pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
        jg, _ = r.jba.build(sim, dtype=r.jnp.float64, layout="ell", **PRIORS)
        return pg, pm, jg, PCFG, r.JConfig(message_form="pallas", **BA_CFG), 8
    sim = ppg.simulate_manhattan(n_poses=1500, seed=4, loop_prob=0.5, loop_radius=3.0,
                                 outlier_frac=0.1)
    pg, pm = ppg.build(sim, dtype=torch.float64, layout="ell", device="cpu")
    jg, _ = r.jpg.build(sim, dtype=r.jnp.float64, layout="ell")
    return (pg, pm, jg, ppg.default_config(),
            dataclasses.replace(r.jpg.default_config(), message_form="pallas"), 11)


@pytest.fixture(scope="module", params=["ba", "pose"], ids=["blocks7_632", "manhattan1500_333"])
def setup(request):
    """The port's windowed unfused graph, its state after the warm-up
    sweeps, and the reference's kernel operands for the same state."""
    r = reference()
    jnp, J, mp = r.jnp, r.J, r.mp
    pg, pm, jg, pcfg, jcfg, warm = scene(request.param)
    pc = P.prepare(pg, ell_fused=False)
    jc = J.prepare(jg, segsum_exact=True, ell_fused=False)
    assert pc.win_w and jc.win_w == pc.win_w and not pc.ell_fused and not jc.ell_fused
    np.testing.assert_array_equal(pc.win_starts.numpy(), np.asarray(jc.win_starts))
    st = P.run(pc, P.init_state(pc, pm), pcfg, warm)
    jst = jax_state(interop.cm_state_to_numpy(st))
    fb = jc.fb
    e = fb.ell_slot
    g = 1 - e
    be_e, bl_e, mean_e = J._expand_ell(jc, jst.v[fb.vblocks[e]])
    bwtab, mwtab = J.window_tables(jc, J._pack_beliefs(jst.v[fb.vblocks[g]]))
    d0, d1 = fb.dofs
    zd = fb.z.shape[-1]
    own = "row" if fb.huber_arr is not None else fb.huber
    kw = dict(d0=d0, d1=d1, z=zd, gslot=g, win_w=jc.win_w, interpret=True)

    def relin(beta):
        return mp.fused_relin_cm_tabblk(
            r.j_kernel_params(dataclasses.replace(jcfg, beta=beta), jnp.float64), jc.win_starts,
            mean_e, mwtab, jc.gidx_cm, jc.z, jc.args, jst.f.lp, jst.f.jac, jst.f.r0,
            jst.f.srel, jc.act, comp_name=fb.ftype.name, n_args=0, **kw)

    def messages(relin_out, huber):
        lp, jac, r0, srel = relin_out
        prec = jc.prec if huber == own else jc.prec[:zd]
        return mp.fused_messages_cm_tabblk(
            r.j_kernel_params(jcfg, jnp.float64), jc.win_starts, jac, lp, r0, prec, srel, jc.act,
            be_e, bl_e, bwtab, jc.gidx_cm, jst.f.msg_eta[0], jst.f.msg_lam[0], jst.f.msg_eta[1],
            jst.f.msg_lam[1], prec_full=False, huber=huber, **kw)

    return types.SimpleNamespace(pc=pc, st=st, pcfg=pcfg, relin=relin, messages=messages,
                                 own=own, g=g)


def port_operands(s):
    pc, st = s.pc, s.st
    fb = pc.fb
    vs_c, vs_l = P._slot_states(pc, st)
    pk = P._with_identity_rows(P._pack_beliefs(vs_l), fb.dofs[fb.ell_slot],
                               pc.nv - vs_l.eta.shape[0]).contiguous()
    be_l, bl_l, mean_l = P._split(M.expand_ell_blk_plain(pk, deg=fb.ell_deg), fb.dofs[fb.ell_slot])
    return be_l, bl_l, mean_l, vs_c.mean.contiguous(), P._packed(vs_c).contiguous()


def median_beta(s):
    x = P.expand_means(s.pc, s.st)
    on = s.pc.act[0] > 0.5
    return float(((x - s.st.f.lp) ** 2).sum(0).sqrt()[on].double().median())


@pytest.mark.parametrize("which", ["config", "median"])
def test_relin_cm_tabblk_plain_matches_reference(setup, which):
    s = setup
    pc, fs = s.pc, s.st.f
    beta = s.pcfg.beta if which == "config" else median_beta(s)
    _, _, mean_l, mtab, _ = port_operands(s)
    got = M.relin_cm_tabblk_plain(
        _kernel_params(dataclasses.replace(s.pcfg, beta=beta), torch.float64), mean_l, mtab,
        pc.gidx, pc.win_starts, pc.z, pc.args, fs.lp, fs.jac, fs.r0, fs.srel, pc.act,
        win_w=pc.win_w, comp_name=pc.fb.ftype.name, gslot=s.g)
    for a, b in zip(got, s.relin(beta)):
        assert rel(a, b) <= 1e-12
    n_relin, n_valid = int((got[3] == 0).sum()), int(pc.act.sum())
    assert 0 < n_relin < n_valid if which == "median" else n_relin > 0


@pytest.mark.parametrize("huber", ["own", 1.5])
def test_messages_cm_tabblk_plain_matches_reference(setup, huber):
    s = setup
    pc, fs = s.pc, s.st.f
    huber = s.own if huber == "own" else huber
    relin_ref = s.relin(s.pcfg.beta)
    lp, jac, r0, srel = (torch.tensor(np.asarray(a).reshape(a.shape[0], -1)) for a in relin_ref)
    be_l, bl_l, _, _, btab = port_operands(s)
    prec = pc.prec if huber == s.own else pc.prec[:pc.z.shape[0]].contiguous()
    got = M.messages_cm_tabblk_plain(
        _kernel_params(s.pcfg, torch.float64), jac, lp, r0, prec, srel, pc.act, be_l, bl_l, btab,
        pc.gidx, pc.win_starts, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
        huber=huber, win_w=pc.win_w, gslot=s.g)
    for a, b in zip(got, s.messages(relin_ref, huber)):
        assert rel(a, b) <= 1e-12
    # The same rows through the whole table: the window changes where a row
    # reads its belief, not the value.
    whole = M.messages_cm_tab_plain(
        _kernel_params(s.pcfg, torch.float64), jac, lp, r0, prec, srel, pc.act, be_l, bl_l, btab,
        pc.gidx, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1], huber=huber,
        gslot=s.g)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_tabblk_plain_rejects_ids_outside_their_window(setup):
    pc, fs = setup.pc, setup.st.f
    _, _, mean_l, mtab, _ = port_operands(setup)
    gidx = pc.gidx.clone()
    gidx[5] = pc.win_starts[0] + pc.win_w
    with pytest.raises(ValueError, match="outside its tile's window"):
        M.relin_cm_tabblk_plain(_kernel_params(setup.pcfg, torch.float64), mean_l, mtab, gidx,
                                pc.win_starts, pc.z, pc.args, fs.lp, fs.jac, fs.r0, fs.srel,
                                pc.act, win_w=pc.win_w, comp_name=pc.fb.ftype.name,
                                gslot=setup.g)


# --- the windowed unfused sweep ---------------------------------------------------------


@pytest.fixture(scope="module")
def ba_both():
    r = reference()
    sim = blocks7()
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    jg, jm = r.jba.build(sim, dtype=r.jnp.float64, layout="ell", **PRIORS)
    return sim, pg, pm, jg, jm


@pytest.mark.parametrize("start", [0, 8])
def test_one_unfused_windowed_sweep_matches_reference(ba_both, start):
    r = reference()
    _, pg, pm, jg, _ = ba_both
    pc = P.prepare(pg, ell_fused=False)
    jc = r.J.prepare(jg, segsum_exact=True, ell_fused=False)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, start)
    js = jax_state(interop.cm_state_to_numpy(ps))
    M.COUNTS.reset()
    ps = P.sweep(pc, ps, PCFG)
    js = jsweep()(jc, js, r.JConfig(message_form="pallas", **BA_CFG))
    assert {k: v for k, v in M.COUNTS.plain.items() if v} == dict.fromkeys(
        UNFUSED_WIN + ("update_beliefs",), 1)
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10


def test_fifteen_unfused_windowed_sweeps_track_reference_and_fused(ba_both):
    r = reference()
    sim, pg, pm, jg, jm = ba_both
    pu, pf = P.prepare(pg, ell_fused=False), P.prepare(pg)
    assert pf.ell_fused and not pu.ell_fused and pu.win_w == pf.win_w > 0
    su, sf = P.init_state(pu, pm), P.init_state(pf, pm)
    for _ in range(15):
        su, sf = P.sweep(pu, su, PCFG), P.sweep(pf, sf, PCFG)
    for a, b in zip(su.v, sf.v):
        assert torch.equal(a.mean, b.mean)
    jc = r.J.prepare(jg, segsum_exact=True, ell_fused=False)
    js = r.jax.jit(r.J.run, static_argnums=3)(jc, r.J.init_state(jc, jm),
                                                r.JConfig(message_form="pallas", **BA_CFG), 15)
    for pv, jv in zip(su.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-4
    are = float(pba.avg_reprojection_error(pg, P.to_gbp_state(pu, su), k=sim["k"]))
    are_ref = float(jare()(jg, r.J.to_gbp_state(jc, js), k=sim["k"]))
    assert abs(are - are_ref) <= 1e-4


# --- degree 1 ---------------------------------------------------------------------------


def degree_one_scene(n_cams=400, per_cam=10, seed=0):
    """Cameras along a corridor, each with `per_cam` landmarks that only it
    sees, numbered in camera order: ELL degree 1 with camera locality."""
    rng = np.random.default_rng(seed)
    k = np.array([500.0, 500.0, 320.0, 240.0])
    cams = np.zeros((n_cams, 6))
    cams[:, 3] = -np.arange(n_cams, dtype=float)  # camera i at x = i, looking down +z
    cam_ids = np.repeat(np.arange(n_cams), per_cam)
    lmks = np.stack([cam_ids + rng.uniform(-0.5, 0.5, cam_ids.size),
                     rng.uniform(-1.0, 1.0, cam_ids.size), rng.uniform(3.0, 6.0, cam_ids.size)], 1)
    xc = lmks + cams[cam_ids, 3:]
    obs = k[:2] * xc[:, :2] / xc[:, 2:] + k[2:] + rng.standard_normal((cam_ids.size, 2))
    cam_init = cams + 0.01 * rng.standard_normal(cams.shape)
    cam_init[0] = cams[0]
    return dict(cam_truth=cams, lmk_truth=lmks, cam_init=cam_init,
                lmk_init=lmks + 0.05 * rng.standard_normal(lmks.shape), obs=obs,
                cam_ids=cam_ids, lmk_ids=np.arange(cam_ids.size), k=k, pix_sigma=1.0)


def test_degree_one_prepare_matches_reference():
    """At degree 1 the reference tries camera windows as at any degree; so
    does the port, and the decisions agree: gather mode, windows, locality
    sort, ELL fusion (none at degree 1)."""
    r = reference()
    sim = degree_one_scene()
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell")
    jg, jm = r.jba.build(sim, dtype=r.jnp.float64, layout="ell")
    assert pg.fblocks[0].ell_deg == 1
    pc, jc = P.prepare(pg), r.J.prepare(jg, segsum_exact=True)
    assert (pc.gather_mode, pc.win_w, pc.ell_fused, pc.mp) == \
        (jc.gather_mode, jc.win_w, jc.ell_fused, jc.mp) == ("table", 128, False, 4096)
    np.testing.assert_array_equal(pc.win_starts.numpy(), np.asarray(jc.win_starts))
    assert pc.vperm is None and jc.vperm is None
    # One sweep through the windowed unfused kernels (plain versions here),
    # from a state with damping on and rows relinearizing.
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    js = jax_state(interop.cm_state_to_numpy(ps))
    M.COUNTS.reset()
    ps = P.sweep(pc, ps, PCFG)
    js = jsweep()(jc, js, r.JConfig(message_form="pallas", **BA_CFG))
    assert {k: v for k, v in M.COUNTS.plain.items() if v} == dict.fromkeys(
        UNFUSED_WIN + ("update_beliefs",), 1)
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10
    # Without windows the same graph takes the whole-table unfused kernels.
    assert P.prepare(pg, window=False).win_w == 0


# --- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("scene,dtype,tol,wide", [
    ("blocks7", torch.float64, 1e-11, None), ("blocks7", torch.float32, 1e-4, None),
    ("blocks7", torch.float64, 1e-11, 256), ("blocks10", torch.float32, 1e-4, 384),
    ("blocks7_odd", torch.float32, 1e-4, None), ("blocks24", torch.float32, 1e-4, None)])
def test_unfused_window_kernels_match_plain_on_card(scene, dtype, tol, wide):
    """Kernels 9 and 8 against their plain versions on the scenes and
    launch plans of test_torch_window.py's card cases (kernel 8: two stages
    and one window buffer in float32, none in float64, one stage at 384
    cameras; a table off a 16-byte boundary; odd last windows; more units
    than blocks)."""
    dev = _card()
    pc, st = card_state(CARD_SCENES[scene](pba), dtype, dev, ell_fused=False)
    assert pc.win_w and not pc.ell_fused
    if wide:
        pc = widened(pc, wide)
    plan = M.window_plan("messages_cm_tabblk", dtype, win_w=pc.win_w, mp=pc.mp)
    if scene == "blocks24":
        assert plan["units"] > plan["blocks"] and plan["units"] % plan["blocks"]
    s = types.SimpleNamespace(pc=pc, st=st)
    be_l, bl_l, mean_l, mtab, btab = port_operands(s)
    fs = st.f
    params = _kernel_params(PCFG, dtype)
    r_args = (params, mean_l, mtab, pc.gidx, pc.win_starts, pc.z, None, fs.lp, fs.jac, fs.r0,
              fs.srel, pc.act)
    r_kw = dict(win_w=pc.win_w, comp_name="reprojection_normalized")
    ref_r = M.relin_cm_tabblk_plain(*r_args, **r_kw)
    for a, b in zip(M.relin_cm_tabblk(*r_args, **r_kw), ref_r):
        assert rel(a.cpu(), b.cpu()) <= tol
    lp, jac, r0, srel = ref_r
    for tab in (btab, off16(btab)):
        for huber in (None, 1.0):
            m_args = (params, jac, lp, r0, pc.prec, srel, pc.act, be_l, bl_l, tab, pc.gidx,
                      pc.win_starts, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
            got = M.messages_cm_tabblk(*m_args, huber=huber, win_w=pc.win_w)
            torch.cuda.synchronize()
            for a, b in zip(got, M.messages_cm_tabblk_plain(*m_args, huber=huber,
                                                            win_w=pc.win_w)):
                assert rel(a.cpu(), b.cpu()) <= tol


@pytest.mark.cuda
def test_unfused_window_messages_equal_full_table_on_card():
    """On the 280-camera float32 scene, the windowed unfused graph's own
    operands through kernel 8 and through the full-table kernel 6
    (`messages_cm_tab`): equal bit for bit."""
    dev = _card()
    pc, st = card_state(blocks7(), torch.float32, dev, ell_fused=False)
    be_l, bl_l, _, _, btab = port_operands(types.SimpleNamespace(pc=pc, st=st))
    assert pc.win_w and btab.numel() * 4 <= M.SMEM_TABLE_BYTES
    fs = st.f
    params = _kernel_params(PCFG, torch.float32)
    head = (params, fs.jac, fs.lp, fs.r0, pc.prec, fs.srel, pc.act, be_l, bl_l, btab, pc.gidx)
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for huber in (None, 1.0):
        win = M.messages_cm_tabblk(*head, pc.win_starts, *msgs, huber=huber, win_w=pc.win_w)
        full = M.messages_cm_tab(*head, *msgs, huber=huber)
        torch.cuda.synchronize()
        for a, b in zip(win, full):
            assert torch.equal(a, b)
