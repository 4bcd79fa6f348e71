"""The unfused table path of the port (`prepare(ell_fused=False)`, and by
itself at ELL degree 1): the plain versions of `messages_cm_tab`,
`relin_cm_tab` and `expand_ell_blk` against the reference kernels they
replace (`fused_messages_cm_tab`, `fused_relin_cm_tab`, `expand_ell_blk`, in
interpret mode) at (6, 3, 2) and (3, 3, 3), and the unfused sweep against the
fused one and against the reference's.

Tolerances, relative to each output's magnitude:
  messages 1e-10 (the cavity inverses amplify operation-order roundoff; the
    reference selects table rows by one-hot matrix dots);
  relinearization 1e-12 (the same model in the same operation order);
  expansion exact (a copy);
  fused against unfused sweeps, 30 sweeps: 1e-6 absolute on means, the
    reference's own bound (tests/test_ell_fused.py); in the port both forms
    run the same arithmetic in the same order, so they agree far closer;
  one unfused sweep against the reference's: 1e-10 relative.

The CUDA kernels run only on a card: the two `cuda`-marked cases hold them
against these plain versions there, as chip_smoke.py does at the bench scene.
The JAX reference is imported by `reference()`, which only the CPU cases
call, so that on a machine with a card and no JAX the card cases run alone:
    python -m pytest tests/test_torch_unfused.py -m cuda --noconftest
"""
import dataclasses
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

torch.set_num_threads(1)
BA_CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
UNFUSED = ("relin_cm_tab", "messages_cm_tab", "expand_ell_blk", "segsum_by_id")


def rel(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    ref = ref.reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def reference():
    """The JAX reference's modules, imported on first use."""
    import jax.numpy as jnp

    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import VariableState as JVar
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import pose_graph as jpg
    from gbp_tpu.ops import messages_pallas as mp

    return types.SimpleNamespace(jnp=jnp, J=J, JConfig=JConfig, JVar=JVar,
                                 j_kernel_params=j_kernel_params, jba=jba, jpg=jpg, mp=mp)


def jax_state(d):
    r = reference()
    jnp, J = r.jnp, r.J
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(r.JVar(**{k: jnp.asarray(a) for k, a in v.items()})
                             for v in d["v"]),
                     f=J.CMFactorState(**f))


def scene(shape):
    """(simulated scene, port graph, means, port config, warm-up sweeps) of
    the (6, 3, 2) or the (3, 3, 3) scene."""
    if shape == (6, 3, 2):
        sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
        pg, pm = pba.build(sim, dtype=torch.float64, device="cpu")
        return sim, pg, pm, GBPConfig(**BA_CFG), 8
    sim = ppg.simulate_manhattan(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0,
                                 outlier_frac=0.15)
    pg, pm = ppg.build(sim, dtype=torch.float64, layout="ell", device="cpu")
    return sim, pg, pm, ppg.default_config(), 11


def reference_scene(shape, sim):
    """(reference graph, reference config) of the same scene."""
    r = reference()
    if shape == (6, 3, 2):
        return (r.jba.build(sim, dtype=r.jnp.float64)[0],
                r.JConfig(message_form="pallas", **BA_CFG))
    return (r.jpg.build(sim, dtype=r.jnp.float64, layout="ell")[0],
            dataclasses.replace(r.jpg.default_config(), message_form="pallas"))


@pytest.fixture(scope="module", params=[(6, 3, 2), (3, 3, 3)], ids=["ba632", "se2_333"])
def setup(request):
    """The port's unfused graph and its state after the warm-up sweeps, the
    same state in the reference's layout, and the operands the reference's
    unfused sweep hands its kernels."""
    r = reference()
    jnp, J, mp = r.jnp, r.J, r.mp
    sim, pg, pm, pcfg, warm = scene(request.param)
    jg, jcfg = reference_scene(request.param, sim)
    pc = P.prepare(pg, ell_fused=False)
    jc = J.prepare(jg, segsum_exact=True, ell_fused=False)
    assert pc.gather_mode == jc.gather_mode == "table"
    assert not pc.ell_fused and not jc.ell_fused and not pc.win_w and not jc.win_w
    st = P.run(pc, P.init_state(pc, pm), pcfg, warm)
    jst = jax_state(interop.cm_state_to_numpy(st))
    fb = jc.fb
    e = fb.ell_slot
    assert e == 1 and pg.fblocks[0].ell_slot == 1
    be_e, bl_e, mean_e = J._expand_ell(jc, jst.v[fb.vblocks[e]])
    pk = J._pack_beliefs(jst.v[fb.vblocks[0]])
    d_g = fb.dofs[0]
    ncp = ((pk.shape[0] + mp.LANE - 1) // mp.LANE) * mp.LANE
    tab = jnp.swapaxes(jnp.pad(pk, ((0, ncp - pk.shape[0]), (0, 0))), 0, 1)
    ref = dict(jc=jc, jst=jst, be_e=be_e, bl_e=bl_e, mean_e=mean_e,
               btab=tab[:d_g + d_g * d_g], mtab=tab[d_g + d_g * d_g:], jcfg=jcfg,
               shape=dict(d0=fb.dofs[0], d1=fb.dofs[1], z=request.param[2]))
    return pg, pm, pc, pcfg, st, ref


def port_operands(pc, st):
    """What the port's unfused sweep hands its kernels."""
    fb = pc.fb
    vs_c, vs_l = st.v[fb.vblocks[0]], st.v[fb.vblocks[1]]
    be_l, bl_l, mean_l = P._expand_ell(pc, vs_l)
    return be_l, bl_l, mean_l, vs_c.mean.contiguous(), P._packed(vs_c).contiguous()


def test_expand_ell_plain_matches_reference(setup):
    """out[k, r] = tab[r // deg, k]: the plain version (the broadcast), the
    reference's kernel on per-tile slices, and an index read, all equal."""
    pg, _, pc, _, st, ref = setup
    jnp, mp = reference().jnp, reference().mp
    jc = ref["jc"]
    fb = pc.fb
    deg = fb.ell_deg
    vs_l = st.v[fb.vblocks[1]]
    pk = P._with_identity_rows(P._pack_beliefs(vs_l), fb.dofs[1], pc.nv - vs_l.eta.shape[0])
    M.COUNTS.reset()
    got = M.expand_ell_blk(pk.contiguous(), deg=deg)
    assert M.COUNTS.plain["expand_ell_blk"] == 1 and not any(M.COUNTS.kernel.values())
    assert got.shape == (pk.shape[1], pc.mp) and got.is_contiguous()
    assert torch.equal(got, pk.T[:, torch.arange(pc.mp) // deg])
    assert jc.ell_w2 > 0
    pkj = jnp.asarray(pk.numpy())
    pkT = jnp.swapaxes(jnp.pad(pkj, ((0, jc.ell_nvp - pkj.shape[0]), (0, 0))), 0, 1)
    ltab = jnp.stack([pkT[:, int(s):int(s) + jc.ell_w2] for s in np.asarray(jc.ell_starts)])
    out = mp.expand_ell_blk(ltab, jc.ell_starts, jc.ell_row0s, deg=deg, w2=jc.ell_w2,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out).reshape(got.shape))


@pytest.mark.parametrize("which", ["config", "median"])
def test_relin_cm_tab_plain_matches_reference(setup, which):
    _, _, pc, pcfg, st, ref = setup
    r = reference()
    jnp, mp, j_kernel_params = r.jnp, r.mp, r.j_kernel_params
    jc, jst = ref["jc"], ref["jst"]
    _, _, mean_l, mtab, _ = port_operands(pc, st)
    x = torch.cat([mtab[pc.gidx.long()].T, mean_l])
    dist = ((x - st.f.lp) ** 2).sum(0).sqrt()[pc.act[0] > 0.5]
    beta = pcfg.beta if which == "config" else float(dist.median())
    params = _kernel_params(dataclasses.replace(pcfg, beta=beta), torch.float64)
    fs = st.f
    M.COUNTS.reset()
    got = M.relin_cm_tab(params, mean_l, mtab, pc.gidx, pc.z, None, fs.lp, fs.jac, fs.r0,
                         fs.srel, pc.act, comp_name=pc.fb.ftype.name)
    assert M.COUNTS.plain["relin_cm_tab"] == 1 and not any(M.COUNTS.kernel.values())
    jf = jst.f
    out = mp.fused_relin_cm_tab(
        j_kernel_params(dataclasses.replace(ref["jcfg"], beta=beta), jnp.float64), ref["mean_e"],
        ref["mtab"], jc.gidx_cm, jc.z, jc.args, jf.lp, jf.jac, jf.r0, jf.srel, jc.act,
        comp_name=jc.fb.ftype.name, n_args=0, gslot=0, interpret=True, **ref["shape"])
    for g, r in zip(got, out):
        assert rel(g, r) <= 1e-12
    n_relin, n_valid = int((got[3] == 0).sum()), int(pc.act.sum())
    assert 0 < n_relin <= n_valid if which == "config" else 0 < n_relin < n_valid


@pytest.mark.parametrize("huber", ["own", 1.0])
def test_messages_cm_tab_plain_matches_reference(setup, huber):
    """The graph's own thresholds (none for the cameras, per row for the
    poses) and a scalar, with every 5th row switched off: those rows pass
    their old messages through."""
    _, _, pc, pcfg, st, ref = setup
    r = reference()
    jnp, mp, j_kernel_params = r.jnp, r.mp, r.j_kernel_params
    jc, jst = ref["jc"], ref["jst"]
    fb = pc.fb
    own = "row" if fb.huber_arr is not None else fb.huber
    huber = own if huber == "own" else huber
    zd = ref["shape"]["z"]
    prec, jprec = (pc.prec, jc.prec) if huber == own else (pc.prec[:zd].contiguous(),
                                                          jc.prec[:zd])
    be_l, bl_l, _, _, btab = port_operands(pc, st)
    act = pc.act.clone()
    act[0, ::5] = 0.0
    fs, jf = st.f, jst.f
    params = _kernel_params(pcfg, torch.float64)
    got = M.messages_cm_tab(params, fs.jac, fs.lp, fs.r0, prec, fs.srel, act, be_l, bl_l, btab,
                            pc.gidx, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
                            huber=huber)
    out = mp.fused_messages_cm_tab(
        j_kernel_params(ref["jcfg"], jnp.float64), jf.jac, jf.lp, jf.r0, jprec, jf.srel,
        jnp.asarray(act.numpy().reshape(jc.act.shape)), ref["be_e"], ref["bl_e"], ref["btab"],
        jc.gidx_cm, jf.msg_eta[0], jf.msg_lam[0], jf.msg_eta[1], jf.msg_lam[1],
        prec_full=False, huber=huber, gslot=0, interpret=True, **ref["shape"])
    assert len(got) == 4
    for g, r in zip(got, out):
        assert rel(g, r) <= 1e-10
    off = act[0] == 0
    for g, old in zip(got, (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])):
        assert torch.equal(g[:, off], old[:, off])
        assert not torch.equal(g[:, ~off], old[:, ~off])


def test_one_unfused_sweep_matches_reference(setup):
    _, _, pc, pcfg, st, ref = setup
    M.COUNTS.reset()
    ps, js = P.sweep(pc, st, pcfg), reference().J.sweep(ref["jc"], ref["jst"], ref["jcfg"])
    assert M.COUNTS.plain == {k: int(k in UNFUSED) for k in M.KERNELS}
    assert M.COUNTS.kernel == dict.fromkeys(M.KERNELS, 0)
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10


def test_fused_matches_unfused_sweeps(setup):
    """30 sweeps each way, through relinearization (the reference's A/B
    check, tests/test_ell_fused.py)."""
    pg, pm, pc, pcfg, _, _ = setup
    fused = P.prepare(pg)
    assert fused.ell_fused and not pc.ell_fused
    s0 = P.run(pc, P.init_state(pc, pm), pcfg, 30)
    s1 = P.run(fused, P.init_state(fused, pm), pcfg, 30)
    for v0, v1 in zip(s0.v, s1.v):
        assert float((v0.mean - v1.mean).abs().max()) <= 1e-6


def test_degree_one_graph_takes_the_unfused_kernels():
    """A pose chain without loop closures: every ELL variable has one factor
    (degree 1), where the reference takes its unfused branch by itself.  Its
    ELL layout groups by the first end of the factors, so slot 1 is
    gathered."""
    r = reference()
    jnp, J, jpg = r.jnp, r.J, r.jpg
    sim = ppg.simulate_manhattan(n_poses=100, seed=1, loop_prob=0.0)
    assert sim["loop_ij"].shape[0] == 0
    pg, pm = ppg.build(sim, dtype=torch.float64, layout="ell", device="cpu")
    jg, jm = jpg.build(sim, dtype=jnp.float64, layout="ell")
    pc, jc = P.prepare(pg), J.prepare(jg, segsum_exact=True)
    fb = pg.fblocks[0]
    assert fb.ell_deg == 1 and (fb.ell_slot, jg.fblocks[0].ell_slot) == (0, 0)
    assert pc.gather_mode == jc.gather_mode == "table"
    assert not pc.ell_fused and not jc.ell_fused and pc.nv == pc.mp
    assert P.prepare(pg, ell_fused=True).ell_fused  # the fused kernels take degree 1 too
    cfg = ppg.default_config()
    M.COUNTS.reset()
    ps = P.run(pc, P.init_state(pc, pm), cfg, 10)
    assert M.COUNTS.plain == {k: 10 * int(k in UNFUSED) for k in M.KERNELS}
    jcfg = dataclasses.replace(jpg.default_config(), message_form="pallas")
    js = J.init_state(jc, jm)
    for _ in range(10):
        js = J.sweep(jc, js, jcfg)
    np.testing.assert_allclose(ps.v[0].mean.numpy(), np.asarray(js.v[0].mean), atol=1e-9, rtol=0)
    forced = P.prepare(pg, ell_fused=True)
    pf = P.run(forced, P.init_state(forced, pm), cfg, 10)
    assert float((pf.v[0].mean - ps.v[0].mean).abs().max()) <= 1e-9


def test_long_chain_at_degree_one_takes_the_expanded_operands():
    """A 4,000-pose chain: degree 1, a table beyond shared memory and no
    window (the last pose's empty ELL group is a clone of row 0, which
    stretches its tile over the whole chain, in the reference as well):
    `prepare` lands on the expanded operands."""
    r = reference()
    jnp, J, jpg = r.jnp, r.J, r.jpg
    sim = ppg.simulate_manhattan(n_poses=4000, seed=1, loop_prob=0.0)
    pg, _ = ppg.build(sim, dtype=torch.float32, layout="ell", device="cpu")
    jg, _ = jpg.build(sim, dtype=jnp.float32, layout="ell")
    pc, jc = P.prepare(pg), J.prepare(jg)
    assert pg.fblocks[0].ell_deg == 1 and (pc.mp, pc.win_w) == (jc.mp, jc.win_w) == (4096, 0)
    assert pc.gather_mode == "rows" and not pc.ell_fused and not jc.ell_fused


@pytest.mark.parametrize("kind", ["ba_blocks", "pose_chain"])
def test_unfused_with_engaged_windows_raises(kind):
    if kind == "ba_blocks":
        sim = pba.simulate_blocks(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0,
                                  shuffle=True)
        pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell",
                           cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
    else:
        sim = ppg.simulate_manhattan(n_poses=1500, seed=4, loop_prob=0.5, loop_radius=3.0)
        pg, pm = ppg.build(sim, dtype=torch.float64, layout="ell", device="cpu")
    fused = P.prepare(pg)
    assert fused.win_w > 0
    # The windowed unfused kernels (`relin_cm_tabblk`, `messages_cm_tabblk`)
    # take the same windows; one sweep runs them (their plain versions here).
    pc = P.prepare(pg, ell_fused=False)
    assert not pc.ell_fused and pc.gather_mode == "table"
    assert pc.win_w == fused.win_w and torch.equal(pc.win_starts, fused.win_starts)
    cfg = GBPConfig(**BA_CFG) if kind == "ba_blocks" else ppg.default_config()
    M.COUNTS.reset()
    P.sweep(pc, P.init_state(pc, pm), cfg)
    assert {k: v for k, v in M.COUNTS.plain.items() if v} == dict.fromkeys(
        ("relin_cm_tabblk", "messages_cm_tabblk", "expand_ell_blk", "segsum_cm_blk",
         "scatter_windows_cm"), 1)
    # Without windows the table is beyond shared memory in float64: the
    # expanded operands, where `ell_fused` has no meaning.
    pc = P.prepare(pg, ell_fused=False, window=False)
    assert pc.gather_mode == "rows" and not pc.ell_fused and pc.win_w == 0


def test_wrappers_refuse_what_is_not_instantiated():
    sim = pba.simulate(n_cams=4, n_lmks=20, seed=0)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu")
    # Both camera shapes take either slot gathered (the landmarks gathered:
    # the cameras in the ELL slot); a shape without instantiations is refused.
    M._table_shape("messages_cm_tab", 6, 3, 2, gslot=1)
    with pytest.raises(NotImplementedError, match="not instantiated"):
        M._table_shape("messages_cm_tab", 9, 3, 3)
    with pytest.raises(NotImplementedError, match="not instantiated"):
        M._table_shape("messages_cm_tab", 9, 3, 3, gslot=1)
    M._table_shape("messages_cm_tab", 9, 3, 2, gslot=1)
    M._table_shape("messages_cm_tab", 9, 3, 2)
    M._table_shape("messages_cm_tab", 3, 3, 3, gslot=1)
    M._table_shape("messages_cm_tab", 6, 6, 6, gslot=1)
    with pytest.raises(ValueError, match="has .d0, d1, z. = .3, 3, 3."):
        M._model("relin_cm_tab", "se2_between", 6, 3, 2)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        M._table_smem("messages_cm_tab", 2000, 12, torch.float32)
    M._table_smem("messages_cm_tab", 1024, 12, torch.float32)
    pc = P.prepare(pg, ell_fused=False)
    st = P.init_state(pc, pm)
    with pytest.raises(ValueError, match="reads 0 per-row arguments"):
        M.relin_cm_tab(None, st.f.lp[6:], st.v[0].mean, pc.gidx, pc.z, pc.z, st.f.lp, st.f.jac,
                       st.f.r0, st.f.srel, pc.act, comp_name="reprojection_normalized")


# --- on the card ----------------------------------------------------------------------


def _on_card(cmg, st, dtype):
    dev = torch.device("cuda")
    cast = lambda t: t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
    cmg = cmg._replace(**{k: cast(v) for k, v in cmg._asdict().items()
                          if isinstance(v, torch.Tensor)})
    st = P.CMState(
        v=tuple(type(v)(*(cast(t) for t in v)) for v in st.v),
        f=P.CMFactorState(*(tuple(cast(t) for t in x) if isinstance(x, tuple) else cast(x)
                            for x in st.f)))
    return cmg, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_unfused_kernels_match_plain_on_card(dtype, tol):
    """The three CUDA kernels against their plain versions on identical CUDA
    inputs, at (6, 3, 2) and at (3, 3, 3) with per-row thresholds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for shape in ((6, 3, 2), (3, 3, 3)):
        _, pg, pm, pcfg, warm = scene(shape)
        pc = P.prepare(pg, ell_fused=False)
        st = P.run(pc, P.init_state(pc, pm), pcfg, warm)
        pc, st = _on_card(pc, st, dtype)
        fb, fs = pc.fb, st.f
        vs_l = st.v[fb.vblocks[1]]
        pk = P._with_identity_rows(P._pack_beliefs(vs_l), fb.dofs[1],
                                   pc.nv - vs_l.eta.shape[0]).contiguous()
        cm = M.expand_ell_blk(pk, deg=fb.ell_deg)
        assert torch.equal(cm, M.expand_ell_blk_plain(pk, deg=fb.ell_deg))
        be_l, bl_l, mean_l, mtab, btab = port_operands(pc, st)
        params = _kernel_params(pcfg, dtype)
        r_args = (params, mean_l, mtab, pc.gidx, pc.z, None, fs.lp, fs.jac, fs.r0, fs.srel, pc.act)
        ref_r = M.relin_cm_tab_plain(*r_args, comp_name=fb.ftype.name)
        for g, r in zip(M.relin_cm_tab(*r_args, comp_name=fb.ftype.name), ref_r):
            assert rel(g, r) <= tol
        huber = "row" if fb.huber_arr is not None else 1.0
        m_args = (params, ref_r[1], ref_r[0], ref_r[2], pc.prec, ref_r[3], pc.act, be_l, bl_l,
                  btab, pc.gidx, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
        for g, r in zip(M.messages_cm_tab(*m_args, huber=huber),
                        M.messages_cm_tab_plain(*m_args, huber=huber)):
            assert rel(g, r) <= tol
        assert M.COUNTS.kernel["messages_cm_tab"] > 0
        with pytest.raises(ValueError):
            M.expand_ell_blk(pk.T, deg=fb.ell_deg)
