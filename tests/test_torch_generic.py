"""The port's generic row-major engine (gbp_tpu_torch.core.sweep, oracle,
models.toy, factors.linear; the kernels' plain versions on the CPU) against
the JAX reference on identical inputs made with numpy.

Tolerances (float64):
  fused_messages: 1e-10 relative (the 6x6 cavity inverses amplify
    operation-order roundoff); the relinearization outputs of
    fused_relin_messages: 1e-12 (the same closed forms in the same order);
  one generic sweep from a common state: 1e-10 relative, every message form
    and every belief-update lowering; energy 1e-10 relative;
  20 sweeps: 1e-6 absolute on the means, loose on purpose: the
    beta-threshold relinearization turns roundoff into different
    relinearization decisions;
  linear chain and toy, per sweep: 1e-12 absolute (no relinearization
    decision can differ on a linear graph); converged means against
    `oracle.map_solution`: 1e-9, the reference's own bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import oracle as joracle
from gbp_tpu.core import sweep as JS
from gbp_tpu.core.graph import GraphBuilder as JBuilder
from gbp_tpu.factors import linear as jlinear
from gbp_tpu.models import ba as jba
from gbp_tpu.models import toy as jtoy
from gbp_tpu.ops import messages_pallas as mp
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import oracle as poracle
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core.graph import GraphBuilder as PBuilder
from gbp_tpu_torch.core.graph import build_inboxes
from gbp_tpu_torch.factors import linear as plinear
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import toy as ptoy
from gbp_tpu_torch.ops import messages as M

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PARAMS = (0.4, 0.0, 6.0, 0.0, 0.01, 8.0, 0.0)
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _spd(rng, m, d):
    a = rng.normal(size=(m, d, d))
    return a @ a.transpose(0, 2, 1) + d * np.eye(d)


def message_operands(rng, m, d0, d1, z, prec_full, huber):
    """Row-major operands of `fused_messages`, numpy float64, in call order:
    SPD beliefs, messages a fraction of them, a mix of damped and undamped,
    active and masked rows."""
    t = d0 + d1
    bl0, bl1 = _spd(rng, m, d0), _spd(rng, m, d1)
    prec = _spd(rng, m, z).reshape(m, -1) if prec_full else rng.uniform(0.5, 2.0, size=(m, z))
    if huber == "row":
        thr = rng.uniform(0.0, 2.0, size=(m, 1))
        thr[::3] = 0.0  # robustification off for these rows
        prec = np.concatenate([prec, thr], 1)
    return [rng.normal(size=(m, z * t)), rng.normal(size=(m, t)), rng.normal(size=(m, z)), prec,
            rng.integers(0, 12, size=m).astype(np.int32),
            (rng.uniform(size=m) > 0.2).astype(np.float64),
            rng.normal(size=(m, d0)), bl0.reshape(m, -1), rng.normal(size=(m, d1)),
            bl1.reshape(m, -1), 0.1 * rng.normal(size=(m, d0)), 0.3 * bl0.reshape(m, -1),
            0.1 * rng.normal(size=(m, d1)), 0.3 * bl1.reshape(m, -1)]


def as_torch(ops):
    return [torch.tensor(a) for a in ops]


# --- the row-major kernels' plain versions -----------------------------------------


@pytest.mark.parametrize("shape", [(6, 3, 2), (1, 1, 1)])
@pytest.mark.parametrize("huber,prec_full", [(None, False), (1.0, False), ("row", False),
                                             (None, True), (1.0, True)])
def test_fused_messages_matches_reference(shape, huber, prec_full):
    """Per-row thresholds go with diagonal precision only, in both packages."""
    d0, d1, z = shape
    ops = message_operands(np.random.default_rng(0), 200, d0, d1, z, prec_full, huber)
    kw = dict(d0=d0, d1=d1, z=z, prec_full=prec_full, huber=huber)
    ref = mp.fused_messages(jnp.asarray(PARAMS), *[jnp.asarray(a) for a in ops],
                            interpret=True, **kw)
    M.COUNTS.reset()
    got = M.fused_messages(PARAMS, *as_torch(ops), **kw)
    assert M.COUNTS.plain["fused_messages"] == 1 and not any(M.COUNTS.kernel.values())
    for a, b in zip(got, ref):
        assert rel(a, b) <= 1e-10


@pytest.mark.parametrize("huber,prec_full", [(1.0, True), ("row", False)])
def test_fused_relin_messages_matches_reference(huber, prec_full):
    rng = np.random.default_rng(1)
    m = 300
    ops = message_operands(rng, m, 6, 3, 2, prec_full, huber)
    x = rng.normal(size=(m, 9)) * 0.3
    x[:, 5] += 4.0  # the landmarks in front of the cameras
    # Linearization points a hair or a stride away: both sides of beta.
    lp = x + rng.normal(size=(m, 9)) * rng.choice([1e-4, 0.05], size=(m, 1))
    z_meas = rng.normal(size=(m, 2))
    jac, _, r0, prec, srel, act, *rest = ops
    kw = dict(d0=6, d1=3, z=2, prec_full=prec_full, huber=huber,
              comp_name="reprojection_normalized")
    j = jnp.asarray
    ref = mp.fused_relin_messages(
        j(PARAMS), j(x), j(z_meas), None, j(lp), j(jac), j(r0), j(prec), j(srel), j(act),
        *[j(a) for a in rest], n_args=0, interpret=True, **kw)
    t = torch.tensor
    got = M.fused_relin_messages(
        PARAMS, t(x), t(z_meas), None, t(lp), t(jac), t(r0), t(prec), t(srel), t(act),
        *as_torch(rest), **kw)
    n_relin = int((got[7] == 0).sum())
    assert 0 < n_relin < m
    for a, b in zip(got[:4], ref[:4]):
        assert rel(a, b) <= 1e-10
    for a, b in zip(got[4:], ref[4:]):
        assert rel(a, b) <= 1e-12


def test_row_kernels_refuse_what_is_not_instantiated():
    ops = as_torch(message_operands(np.random.default_rng(2), 8, 3, 3, 3, False, None))
    # On the CPU the plain version takes any shape; the shape gate is the
    # kernel's, so it is checked directly.
    M.fused_messages(PARAMS, *ops, d0=3, d1=3, z=3, prec_full=False, huber=None)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        M._row_shape("fused_messages", 3, 3, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        M._row_shape("fused_messages", 9, 3, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        M._relin_math(PARAMS, [], [], [], [], [], None, None, "se2_between")
    with pytest.raises(ValueError, match="CUDA tensor"):
        M._check_op("jac", ops[0], 8, 18, torch.float64, True)
    with pytest.raises(ValueError, match="diagonal"):
        M.fused_messages(PARAMS, *ops, d0=3, d1=3, z=3, prec_full=True, huber="row")


# --- the generic sweep on a BA scene -------------------------------------------------


def jax_state(d):
    j = jnp.asarray
    return JS.GBPState(
        v=tuple(JS.VariableState(**{k: j(a) for k, a in v.items()}) for v in d["v"]),
        f=tuple(JS.FactorState(linpoint=j(f["linpoint"]), jac=j(f["jac"]), r0=j(f["r0"]),
                               msg_eta=tuple(j(a) for a in f["msg_eta"]),
                               msg_lam=tuple(j(a) for a in f["msg_lam"]),
                               since_relin=j(f["since_relin"])) for f in d["f"]))


LAYOUTS = {"none": dict(layout="none"), "ell": dict(layout="ell"), "inbox": dict(layout="none")}


@pytest.fixture(scope="module")
def scenes():
    sim = pba.simulate(n_cams=6, n_lmks=50, seed=0)
    out = {}
    for name, kw in LAYOUTS.items():
        jg, jm = jba.build(sim, dtype=jnp.float64, **kw)
        pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", **kw)
        if name == "inbox":
            from gbp_tpu.core.graph import build_inboxes as jbuild_inboxes

            jg = jg.replace(inboxes=jbuild_inboxes(jg.fblocks, [v.count for v in jg.vblocks]))
            pg = dataclasses.replace(
                pg, inboxes=build_inboxes(pg.fblocks, [v.count for v in pg.vblocks]))
            for ps_, js_ in zip(pg.inboxes, jg.inboxes):
                for a, b in zip(ps_, js_):
                    np.testing.assert_array_equal(a.idx.numpy(), np.asarray(b.idx))
                    np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        out[name] = (sim, (jg, jm), (pg, pm))
    return out


def compare_states(ps, js, tol):
    for pf, jf in zip(ps.f, js.f):
        for a, b in zip(pf.msg_eta + pf.msg_lam, jf.msg_eta + jf.msg_lam):
            assert rel(a, b) <= tol
        for name in ("linpoint", "jac", "r0"):
            assert rel(getattr(pf, name), getattr(jf, name)) <= tol
        np.testing.assert_array_equal(pf.since_relin.numpy(), np.asarray(jf.since_relin))
    for pv, jv in zip(ps.v, js.v):
        for name in ("eta", "lam", "mean"):
            assert rel(getattr(pv, name), getattr(jv, name)) <= tol


@pytest.mark.parametrize("form", ["covariance", "schur", "pallas"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_one_generic_sweep_matches_reference(scenes, layout, form):
    """One sweep from the state after 8 port sweeps: damping is on and part
    of the rows relinearize."""
    _, (jg, _), (pg, pm) = scenes[layout]
    pcfg = PS.GBPConfig(message_form=form, **CFG)
    jcfg = JS.GBPConfig(message_form=form, **CFG)
    ps = PS.run(pg, PS.init_state(pg, pm), pcfg, 8)
    js = jax_state(interop.gbp_state_to_numpy(ps))
    assert rel(PS.energy(pg, ps), JS.energy(jg, js)) <= 1e-10
    ps, js = PS.sweep(pg, ps, pcfg), jax.jit(JS.sweep)(jg, js, jcfg)
    assert int((ps.f[0].since_relin == 0).sum()) > 0  # this sweep relinearizes
    compare_states(ps, js, 1e-10)
    assert rel(PS.energy(pg, ps), JS.energy(jg, js)) <= 1e-10


@pytest.mark.parametrize("layout,form", [("none", "covariance"), ("inbox", "schur"),
                                         ("ell", "pallas")])
def test_twenty_generic_sweeps_track_reference(scenes, layout, form):
    _, (jg, jm), (pg, pm) = scenes[layout]
    js = jax.jit(JS.run, static_argnums=3)(
        jg, JS.init_state(jg, jm), JS.GBPConfig(message_form=form, **CFG), 20)
    ps = PS.run(pg, PS.init_state(pg, pm), PS.GBPConfig(message_form=form, **CFG), 20)
    for pv, jv in zip(ps.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-6


def test_init_state_and_interop_graph(scenes):
    """`init_state` equals the reference's, and a graph carried over with
    `interop.graph_from_numpy` (inboxes included) gives the same sweep as the
    one the port built itself."""
    _, (jg, jm), (pg, pm) = scenes["inbox"]
    compare_states(PS.init_state(pg, pm), JS.init_state(jg, jm), 1e-12)
    carried = interop.graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    assert carried.total_dim() == jg.total_dim() == pg.total_dim()
    cfg = PS.GBPConfig(**CFG)
    a = PS.run(pg, PS.init_state(pg, pm), cfg, 3)
    b = PS.run(carried, PS.init_state(carried, pm), cfg, 3)
    for av, bv in zip(a.v, b.v):
        assert torch.equal(av.mean, bv.mean)


def test_sweep_active_mask_matches_reference(scenes):
    _, (jg, _), (pg, pm) = scenes["none"]
    pcfg, jcfg = PS.GBPConfig(message_form="pallas", **CFG), JS.GBPConfig(
        message_form="pallas", **CFG)
    ps = PS.run(pg, PS.init_state(pg, pm), pcfg, 8)
    js = jax_state(interop.gbp_state_to_numpy(ps))
    mask = np.random.default_rng(3).uniform(size=pg.fblocks[0].count) > 0.4
    pn = PS.sweep(pg, ps, pcfg, active=(torch.tensor(mask),))
    jn = jax.jit(JS.sweep)(jg, js, jcfg, (jnp.asarray(mask),))
    compare_states(pn, jn, 1e-10)
    off = torch.tensor(~mask)
    assert torch.equal(pn.f[0].msg_eta[0][off], ps.f[0].msg_eta[0][off])
    assert torch.equal(pn.f[0].linpoint[off], ps.f[0].linpoint[off])


# --- per-factor Huber and full precision through the generic sweep ------------------------


@pytest.mark.parametrize("form", ["covariance", "pallas"])
@pytest.mark.parametrize("variant", ["huber_arr", "full_prec", "huber"])
def test_generic_sweep_huber_and_full_precision(variant, form):
    sim = pba.simulate(n_cams=5, n_lmks=30, seed=4)
    jg, jm = jba.build(sim, dtype=jnp.float64, layout="none")
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="none")
    jfb, pfb = jg.fblocks[0], pg.fblocks[0]
    if variant == "huber_arr":
        thr = np.random.default_rng(5).choice([0.0, 1.0, 2.0], size=pfb.count)
        jfb = jfb.replace(huber_arr=jnp.asarray(thr))
        pfb = dataclasses.replace(pfb, huber_arr=T64(thr))
    elif variant == "full_prec":
        full = _spd(np.random.default_rng(6), pfb.count, 2) * np.asarray(pfb.prec)[:, :1, None]
        jfb = jfb.replace(prec=jnp.asarray(full), huber=1.5)
        pfb = dataclasses.replace(pfb, prec=T64(full), huber=1.5)
    else:
        jfb, pfb = jfb.replace(huber=1.0), dataclasses.replace(pfb, huber=1.0)
    jg, pg = jg.replace(fblocks=(jfb,)), dataclasses.replace(pg, fblocks=(pfb,))
    pcfg, jcfg = PS.GBPConfig(message_form=form, **CFG), JS.GBPConfig(message_form=form, **CFG)
    ps = PS.run(pg, PS.init_state(pg, pm), pcfg, 3)
    js = jax_state(interop.gbp_state_to_numpy(ps))
    w = PS.huber_weight(pfb, ps.f[0].r0)
    assert float(w.min()) < 1.0  # the robust weight acts on this scene
    assert rel(w, JS.huber_weight(jfb, js.f[0].r0)) <= 1e-12
    compare_states(PS.sweep(pg, ps, pcfg), jax.jit(JS.sweep)(jg, js, jcfg), 1e-10)
    assert rel(PS.energy(pg, ps), JS.energy(jg, js)) <= 1e-10


# --- linear graphs: exactness -----------------------------------------------------------


def chain(builder_cls, lin, n, dtype, **kw):
    rng = np.random.default_rng(7)
    b = builder_cls(dtype=dtype, **kw)
    v = b.add_variables("x", np.zeros((n, 2)), prior_prec=1e-3)
    b.set_prior(v, 0, np.array([0.5, -0.5]), 10.0)
    b.add_factors("odo", lin.displacement(2), [(v, np.arange(n - 1)), (v, np.arange(1, n))],
                  rng.normal(size=(n - 1, 2)), sigma=0.2)
    b.add_factors("gps", lin.observation(2), [(v, np.arange(0, n, 5))],
                  rng.normal(size=(len(range(0, n, 5)), 2)) * 3, sigma=0.5)
    return b.build()


@pytest.mark.parametrize("form", ["covariance", "schur", "pallas"])
def test_linear_chain_matches_reference_and_oracle(form):
    """A 2-D chain of 40 nodes with displacement and unary factors: the
    (2, 2, 2) block has no kernel instantiation, so on the CPU its "pallas"
    form runs the plain version, like the reference's interpret mode."""
    jg, jm = chain(JBuilder, jlinear, 40, jnp.float64)
    pg, pm = chain(PBuilder, plinear, 40, torch.float64, device="cpu")
    pcfg, jcfg = PS.GBPConfig(message_form=form), JS.GBPConfig(message_form=form)
    ps, js = PS.init_state(pg, pm), JS.init_state(jg, jm)
    jsweep = jax.jit(JS.sweep)
    for _ in range(5):
        ps, js = PS.sweep(pg, ps, pcfg), jsweep(jg, js, jcfg)
        assert np.abs(ps.v[0].mean.numpy() - np.asarray(js.v[0].mean)).max() <= 1e-12
    ps = PS.run(pg, ps, pcfg, 150)
    mu = poracle.map_solution(pg, ps)[0]
    assert (ps.v[0].mean - mu).abs().max() <= 1e-9
    jmu = joracle.map_solution(jg, JS.init_state(jg, jm))[0]
    assert rel(mu, jmu) <= 1e-10


@pytest.mark.parametrize("form", ["covariance", "pallas"])
def test_toy_matches_reference_and_oracle(form):
    """The 1-D toy: its smoothness block is the (1, 1, 1) shape the row-major
    kernel is instantiated for."""
    sim = ptoy.simulate(n=60)
    np.testing.assert_array_equal(sim["obs"], jtoy.simulate(n=60)["obs"])
    jg, jm = jtoy.build(sim, dtype=jnp.float64)
    pg, pm = ptoy.build(sim, dtype=torch.float64, device="cpu")
    pcfg, jcfg = PS.GBPConfig(message_form=form), JS.GBPConfig(message_form=form)
    ps, js = PS.init_state(pg, pm), JS.init_state(jg, jm)
    M.COUNTS.reset()
    jsweep = jax.jit(JS.sweep)
    for _ in range(4):
        ps, js = PS.sweep(pg, ps, pcfg), jsweep(jg, js, jcfg)
        assert np.abs(ps.v[0].mean.numpy() - np.asarray(js.v[0].mean)).max() <= 1e-12
    assert M.COUNTS.plain["fused_messages"] == (4 if form == "pallas" else 0)
    ps = PS.run(pg, ps, pcfg, 200)
    assert (ps.v[0].mean - poracle.map_solution(pg, ps)[0]).abs().max() <= 1e-9
    assert rel(PS.energy(pg, ps), JS.energy(jg, jax_state(interop.gbp_state_to_numpy(ps)))) \
        <= 1e-10


def test_marginal_covariances_on_a_tree():
    """On a tree GBP's belief covariances are the exact marginals."""
    pg, pm = chain(PBuilder, plinear, 12, torch.float64, device="cpu")
    jg, jm = chain(JBuilder, jlinear, 12, jnp.float64)
    ps = PS.run(pg, PS.init_state(pg, pm), PS.GBPConfig(eta_damping=0.0), 40)
    cov = poracle.marginal_covariances(pg, ps)[0]
    assert rel(cov, joracle.marginal_covariances(jg, JS.init_state(jg, jm))[0]) <= 1e-10
    assert rel(torch.linalg.inv(ps.v[0].lam), cov) <= 1e-9
    eta, lam = poracle.dense_joint(pg, ps)
    jeta, jlam = joracle.dense_joint(jg, JS.init_state(jg, jm))
    assert rel(eta, jeta) <= 1e-12 and rel(lam, jlam) <= 1e-12


def test_marginalize_matches_reference():
    from gbp_tpu.gaussians import marginalize as jmarg
    from gbp_tpu_torch.gaussians import marginalize as pmarg

    rng = np.random.default_rng(8)
    lam, eta = _spd(rng, 20, 9), rng.normal(size=(20, 9))
    for start, d in ((0, 6), (6, 3), (0, 9)):
        got, ref = pmarg(T64(eta), T64(lam), start, d), jmarg(jnp.asarray(eta), jnp.asarray(lam),
                                                             start, d)
        assert rel(got.eta, ref.eta) <= 1e-12 and rel(got.lam, ref.lam) <= 1e-12


def test_several_block_state_round_trip():
    """A GBPState of a graph with two factor blocks (one unary) survives the
    trip through numpy, the reference's containers and back bit for bit."""
    pg, pm = chain(PBuilder, plinear, 15, torch.float64, device="cpu")
    ps = PS.run(pg, PS.init_state(pg, pm), PS.GBPConfig(), 7)
    assert len(ps.f) == 2 and len(ps.f[1].msg_eta) == 1
    back = interop.gbp_state_from_numpy(
        jax.tree.map(np.asarray, jax_state(interop.gbp_state_to_numpy(ps))), device="cpu")
    a, b = jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(ps))
    assert len(a) == len(b) == 17
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
