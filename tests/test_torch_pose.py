"""Pose-graph SLAM in the port (gbp_tpu_torch: lie helpers, SE(2)/SE(3)
factor types and component models, models.pose_graph, io.g2o, the same-block
component-major sweep, the PCG Gauss-Newton target, the CLI) against the JAX
reference on identical inputs made from numpy seeds, on the CPU (the port's
kernels run their plain versions; the reference's Pallas kernels run in
interpret mode, as in its own CPU tests).

Tolerances, with the reason:
  lie helpers, factor types, component models: 1e-12 absolute in float64
    (the same formulas; torch vs XLA roundoff on O(1) values); analytic
    Jacobians against autograd, the port's and the reference's SE(3) one,
    1e-9 (autodiff differentiates through so3_log's division by
    sin(theta));
  simulated scenes: ids equal, values 1e-12 (numpy in both; the reference
    routes SE(2) composition through JAX once per pose);
  built graphs and g2o arrays: exact or 1e-12 (the same numpy code);
  prepare: integers equal (the same layout code; where the port's 48 KB
    shared-memory gate differs from the reference's 4 MB, the gather mode is
    forced on both sides and the test says so);
  one component-major sweep from a common state: 1e-10 relative;
  25 sweeps: 1e-9 absolute on means (the reference's own bound between its
    engines, tests/test_cm_pose_graph.py: roundoff through relinearization);
  Gauss-Newton by PCG: 1e-8 relative (CG iterations amplify roundoff);
  ATE: 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.factors import odometry as jodo
from gbp_tpu.factors import se3 as jse3
from gbp_tpu.io import g2o as jg2o
from gbp_tpu.models import pose_graph as jpg
from gbp_tpu.ops import comp_factors as jcf
from gbp_tpu.parallel import schur as jschur
from gbp_tpu.utils import lie as jlie
from gbp_tpu_torch import interop, slam
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.factors import odometry as podo
from gbp_tpu_torch.factors import se3 as pse3
from gbp_tpu_torch.io import g2o as pg2o
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.ops import comp_factors as pcf
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import schur as pschur
from gbp_tpu_torch.utils import lie as plie

torch.set_num_threads(1)
G2O_FILE = "data/manhattan_sim.g2o"
JCFG = dataclasses.replace(jpg.default_config(), message_form="pallas")
PCFG = ppg.default_config()
T = lambda a: torch.tensor(np.asarray(a))


def close(got, ref, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(got.shape), atol=atol, rtol=0)


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


# --- lie helpers, factor types, component models ---------------------------------------


@pytest.mark.parametrize("name", ["se2_compose", "se2_relative", "wrap_angle", "_left_jacobian",
                                  "se3_exp", "se3_log", "transform_point"])
def test_lie_helpers_match_reference(name):
    rng = np.random.default_rng(0)
    n = 64
    if name in ("se2_compose", "se2_relative"):
        args = [rng.normal(size=(n, 3)) * 3.0, rng.normal(size=(n, 3)) * 3.0]
    elif name == "wrap_angle":
        # Away from the +-pi knife edge, over several turns, and the edge itself.
        args = [np.concatenate([rng.uniform(-20, 20, size=n), [np.pi, -np.pi, 3 * np.pi, 0.0]])]
    elif name == "_left_jacobian":
        scale = np.r_[np.full(n // 2, 1.0), np.full(n // 2, 1e-6)]  # also the Taylor branch
        args = [rng.normal(size=(n, 3)) * scale[:, None]]
    elif name == "se3_exp":
        args = [rng.normal(size=(n, 6))]
    elif name == "se3_log":
        r, t = jlie.se3_exp(jnp.asarray(rng.normal(size=(n, 6)) * 0.8))
        args = [np.asarray(r), np.asarray(t)]
    else:
        args = [rng.normal(size=(n, 6)), rng.normal(size=(n, 3))]
    ref = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    got = getattr(plie, name)(*[T(a) for a in args])
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            close(g, r)
    else:
        close(got, ref, atol=1e-11 if name == "se3_log" else 1e-12)
    if name == "wrap_angle":
        assert float(got.min()) >= -np.pi and float(got.max()) < np.pi
        assert float(got[-4]) == -np.pi  # +pi wraps to -pi: the interval is [-pi, pi)


FACTORS = {"se2_between": (jodo.se2_between, podo.se2_between, 6),
           "se2_prior": (jodo.se2_prior, podo.se2_prior, 3),
           "se3_between": (jse3.se3_between, pse3.se3_between, 12),
           "se3_prior": (jse3.se3_prior, pse3.se3_prior, 6)}


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_factor_types_match_reference(name):
    """meas, Jacobian and residual, batched in the port and per factor in
    the reference; the analytic Jacobian also against autograd."""
    jmake, pmake, tdof = FACTORS[name]
    jf, pf = jmake(), pmake()
    assert (pf.name, pf.zdim, pf.linear) == (jf.name, jf.zdim, jf.linear)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, tdof)) * np.r_[np.full(6, 0.4), np.full(6, 1.3)][:, None]
    z = rng.normal(size=(12, jf.zdim)) * 0.7
    xj = jnp.asarray(x)
    h_ref = jax.vmap(lambda v: jf.meas(v, None))(xj)
    close(pf.meas(T(x), None), h_ref)
    # The reference's SE(3) Jacobian is forward-mode autodiff through so3_log;
    # the port's is the analytic component form: 1e-9 at large angles.
    close(pf.jac(T(x), None), jax.vmap(lambda v: jf.jac(v, None))(xj),
          atol=1e-9 if name == "se3_between" else 1e-12)
    close(pf.residual(T(z), T(np.asarray(h_ref))), jf.residual(jnp.asarray(z), h_ref))
    for i in range(4):
        auto = torch.autograd.functional.jacobian(lambda v: pf.meas(v[None], None)[0], T(x[i]))
        close(pf.jac(T(x[i:i + 1]), None)[0], auto, atol=1e-9)


@pytest.mark.parametrize("name", ["se2_between", "se3_between"])
def test_comp_models_match_reference(name):
    """The component forms (what the kernels' plain versions evaluate)
    against the reference's, and against the row-major factor type."""
    tdof = FACTORS[name][2]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, tdof)) * np.r_[np.full(8, 0.3), np.full(8, 1.5)][:, None]
    z = rng.normal(size=(16, tdof // 2)) * 0.7
    fn, n_args, res = pcf.COMP_FACTORS[name]
    jfn, jn_args, jres = jcf.COMP_FACTORS[name]
    assert n_args == jn_args == 0
    h, jac = fn([T(x[:, k]) for k in range(tdof)])
    h_ref, jac_ref = jfn([jnp.asarray(x[:, k]) for k in range(tdof)], None)
    close(torch.stack(h), jnp.stack(h_ref))
    close(torch.stack([torch.stack(r) for r in jac]), jnp.stack([jnp.stack(r) for r in jac_ref]))
    r = res([T(z[:, k]) for k in range(z.shape[1])], h)
    close(torch.stack(r), jnp.stack(jres([jnp.asarray(z[:, k]) for k in range(z.shape[1])], h_ref)))
    pf = FACTORS[name][1]()
    close(torch.stack(h, dim=1), pf.meas(T(x), None))
    close(torch.stack(r, dim=1), pf.residual(T(z), torch.stack(h, dim=1)))
    assert pcf.comp_residual(name) is res and pcf.comp_residual("reprojection_normalized") is None


def test_se2_comp_residual_wraps():
    r = pcf.se2_between_res([T(0.0), T(0.0), T(3.1)], [T(0.0), T(0.0), T(-3.1)])
    assert abs(float(r[2]) - (6.2 - 2 * np.pi)) < 1e-12


# --- scenes, graphs, g2o --------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0),
                                dict(n_poses=150, seed=2, loop_prob=0.5, loop_radius=3.0,
                                     outlier_frac=0.15),
                                dict(n_poses=40, seed=1)])
def test_simulate_manhattan_matches_reference(kw):
    ref, got = jpg.simulate_manhattan(**kw), ppg.simulate_manhattan(**kw)
    assert sorted(ref) == sorted(got)
    for k in ("odom_ij", "loop_ij"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("truth", "odom_z", "loop_z", "init", "odom_sigma", "loop_sigma"):
        close(got[k], ref[k])


def test_simulate_helix_matches_reference():
    ref, got = jpg.simulate_helix(n_poses=60, seed=3), ppg.simulate_helix(n_poses=60, seed=3)
    assert got["kind"] == ref["kind"] == "se3"
    np.testing.assert_array_equal(got["edges_ij"], ref["edges_ij"])
    for k in ("poses", "edges_z", "edges_info", "truth"):
        close(got[k], ref[k])


def same_graph(pg, jg):
    assert len(pg.vblocks) == len(jg.vblocks) and len(pg.fblocks) == len(jg.fblocks)
    for pv, jv in zip(pg.vblocks, jg.vblocks):
        close(pv.prior_eta, jv.prior_eta)
        close(pv.prior_lam, jv.prior_lam)
    for pf, jf in zip(pg.fblocks, jg.fblocks):
        assert (pf.ftype.name, pf.dofs, pf.vblocks, pf.huber, pf.ell_slot, pf.ell_deg,
                pf.n_valid) == (jf.ftype.name, jf.dofs, jf.vblocks, jf.huber, jf.ell_slot,
                                jf.ell_deg, jf.n_valid)
        for a, b in zip(pf.adj, jf.adj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        close(pf.z, jf.z)
        close(pf.prec, jf.prec)
        for a, b in ((pf.valid, jf.valid), (pf.huber_arr, jf.huber_arr)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("merged,layout", [(True, "ell"), (True, "none"), (False, "none")])
def test_build_matches_reference(merged, layout):
    sim = ppg.simulate_manhattan(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0)
    jg, jm = jpg.build(sim, dtype=jnp.float64, merged=merged, layout=layout)
    pg, pm = ppg.build(sim, dtype=torch.float64, merged=merged, layout=layout, device="cpu")
    assert len(pg.fblocks) == (1 if merged else 2)
    assert (pg.fblocks[0].huber_arr is not None) == merged
    same_graph(pg, jg)
    close(pm[0], jm[0])


@pytest.mark.parametrize("kind", ["se2_full", "se3_diagonal"])
def test_build_g2o_matches_reference(kind):
    """Full information stays full; exactly diagonal information collapses
    to diagonal precision, which the fast path needs."""
    data = (pg2o.read_g2o(G2O_FILE) if kind == "se2_full"
            else ppg.simulate_helix(n_poses=40, seed=3))
    jg, jm = jpg.build_g2o(data, huber=2.0, dtype=jnp.float64, layout="ell")
    pg, pm = ppg.build_g2o(data, huber=2.0, dtype=torch.float64, layout="ell", device="cpu")
    assert pg.fblocks[0].prec.ndim == (3 if kind == "se2_full" else 2)
    same_graph(pg, jg)
    close(pm[0], jm[0])
    assert (P.prepare(pg) is None) == (kind == "se2_full")


def test_read_g2o_matches_reference():
    ref, got = jg2o.read_g2o(G2O_FILE), pg2o.read_g2o(G2O_FILE)
    assert got["kind"] == ref["kind"] == "se2" and got["poses"].shape == (500, 3)
    np.testing.assert_array_equal(got["edges_ij"], ref["edges_ij"])
    for k in ("poses", "edges_z", "edges_info"):
        close(got[k], ref[k])


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_g2o_write_read_round_trip(tmp_path, kind):
    """write -> read gives the arrays back (12 significant digits in the
    file), through the information-matrix conjugation both ways; the
    reference reads the port's file to the same arrays."""
    rng = np.random.default_rng(5)
    if kind == "se2":
        sim = ppg.simulate_manhattan(n_poses=30, seed=0, loop_prob=0.5, loop_radius=3.0)
        poses, ij, z = sim["init"], sim["odom_ij"], sim["odom_z"]
        write = pg2o.write_g2o_se2
    else:
        data = ppg.simulate_helix(n_poses=20, seed=0)
        poses, ij, z = data["poses"], data["edges_ij"], data["edges_z"]
        write = pg2o.write_g2o_se3
    d = z.shape[1]
    a = rng.normal(size=(ij.shape[0], d, d))
    info = a @ a.transpose(0, 2, 1) + 5.0 * np.eye(d)  # anisotropic, full
    path = tmp_path / f"{kind}.g2o"
    write(path, poses, ij, z, info)
    for back in (pg2o.read_g2o(path), jg2o.read_g2o(str(path))):
        assert back["kind"] == kind
        np.testing.assert_array_equal(back["edges_ij"], ij)
        close(back["poses"], poses, atol=1e-9)
        close(back["edges_z"], z, atol=1e-9)
        assert rel(back["edges_info"], info) <= 1e-9


def test_ate_matches_reference():
    sim = ppg.simulate_manhattan(n_poses=80, seed=3, loop_prob=0.5, loop_radius=3.0)
    assert abs(ppg.ate(sim["init"], sim["truth"]) - jpg.ate(sim["init"], sim["truth"])) <= 1e-12
    assert ppg.ate(T(sim["truth"]), sim["truth"]) <= 1e-12
    d = ppg.simulate_helix(n_poses=30, seed=0)
    assert abs(ppg.ate(d["poses"], d["truth"]) - jpg.ate(d["poses"], d["truth"])) <= 1e-12
    pc, jc = ppg.default_config(), jpg.default_config()
    for f in ("eta_damping", "lam_damping", "num_undamped_iters", "min_linear_iters", "beta"):
        assert getattr(pc, f) == getattr(jc, f)


# --- the component-major sweep ---------------------------------------------------------


def jax_state(d):
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d["v"]),
                     f=J.CMFactorState(**f))


def both(sim, **prep):
    jg, jm = jpg.build(sim, dtype=jnp.float64, layout="ell")
    pg, pm = ppg.build(sim, dtype=torch.float64, layout="ell", device="cpu")
    return (jg, jm, J.prepare(jg, segsum_exact=True, **prep)), (pg, pm, P.prepare(pg, **prep))


@pytest.fixture(scope="module")
def sim120():
    """120 poses with loop closures, 15 % of them gross outliers, so the
    per-row Huber thresholds act."""
    return ppg.simulate_manhattan(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0,
                                  outlier_frac=0.15)


@pytest.mark.parametrize("n_poses", [120, 1500])
def test_prepare_integers_match_reference(n_poses):
    """mp, deg, ELL slot, mode and windows.  At 1,500 poses the packed table
    (144,000 bytes in float64) is beyond the port's 48 KB of static shared
    memory and inside the reference's 4 MB: with windows both pick "table";
    without them the port falls to "rows", so that case forces the mode on
    both sides."""
    sim = ppg.simulate_manhattan(n_poses=n_poses, seed=4, loop_prob=0.5, loop_radius=3.0)
    (jg, _, jc), (pg, _, pc) = both(sim)
    fb = pg.fblocks[0]
    assert fb.vblocks[0] == fb.vblocks[1] and fb.huber_arr is not None
    assert (pc.mp, pc.nv, fb.ell_deg, fb.ell_slot) == (jc.mp, jc.nv, jg.fblocks[0].ell_deg,
                                                       jg.fblocks[0].ell_slot)
    assert (pc.gather_mode, pc.win_w, pc.win_ncpad, pc.ell_fused) == (
        jc.gather_mode, jc.win_w, jc.win_ncpad, jc.ell_fused)
    assert pc.vperm is None and jc.vperm is None  # same-block graphs are never sorted
    assert pc.prec.shape[0] == 4  # z = 3 precisions, then the per-row thresholds
    np.testing.assert_array_equal(pc.prec.numpy(), np.asarray(jc.prec).reshape(4, -1))
    np.testing.assert_array_equal(pc.gidx.numpy(), np.asarray(jc.gidx_cm).reshape(-1))
    if n_poses == 1500:
        assert pc.win_w == 640
        np.testing.assert_array_equal(pc.win_starts.numpy(), np.asarray(jc.win_starts))
        (_, _, jr), (_, _, pr) = both(sim, window=False, gather_mode="rows")
        assert pr.gather_mode == jr.gather_mode == "rows" and pr.win_w == jr.win_w == 0
        assert P.prepare(pg, window=False).gather_mode == "rows"


@pytest.mark.parametrize("mode", ["table", "rows", "unfused"])
def test_one_sweep_matches_reference(sim120, mode):
    """One sweep from the state after 11 sweeps (damping on, part of the rows
    relinearize, outlier rows are down-weighted)."""
    prep = {"rows": dict(gather_mode="rows"), "unfused": dict(ell_fused=False)}.get(mode, {})
    (_, _, jc), (_, pm, pc) = both(sim120, **prep)
    assert (pc.gather_mode, pc.ell_fused) == (jc.gather_mode, jc.ell_fused)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 11)
    js = jax_state(interop.cm_state_to_numpy(ps))
    ps, js = P.sweep(pc, ps, PCFG), J.sweep(jc, js, JCFG)
    n_relin = int(((ps.f.srel[0] == 0) & (pc.act[0] > 0)).sum())
    assert 0 < n_relin < int(pc.act.sum())
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10
    assert rel(ps.v[0].mean, js.v[0].mean) <= 1e-10


def test_one_windowed_sweep_matches_reference():
    sim = ppg.simulate_manhattan(n_poses=1500, seed=4, loop_prob=0.5, loop_radius=3.0)
    (_, _, jc), (_, pm, pc) = both(sim)
    assert pc.win_w == jc.win_w > 0
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 6)
    js = jax_state(interop.cm_state_to_numpy(ps))
    M.COUNTS.reset()
    ps, js = P.sweep(pc, ps, PCFG), J.sweep(jc, js, JCFG)
    assert M.COUNTS.plain["messages_cm_tabblk_ell"] == M.COUNTS.plain["scatter_windows_cm"] == 1
    assert rel(ps.v[0].mean, js.v[0].mean) <= 1e-10
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10


@pytest.mark.parametrize("mode", ["table", "rows"])
def test_twenty_five_sweeps_track_reference(sim120, mode):
    prep = dict(gather_mode="rows") if mode == "rows" else {}
    (_, jm, jc), (_, pm, pc) = both(sim120, **prep)
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 25)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 25)
    close(ps.v[0].mean, js.v[0].mean, atol=1e-9)
    back = P.to_gbp_state(pc, ps)
    jback = J.to_gbp_state(jc, js)
    close(back.f[0].msg_eta[1], jback.f[0].msg_eta[1], atol=1e-6)
    assert back.f[0].since_relin.dtype == torch.int32


def test_se3_sweeps_track_reference():
    """SE(3), 40 poses: the helix's ELL layout groups by the first end of its
    factors (slot 0), so slot 1 is the gathered one."""
    data = ppg.simulate_helix(n_poses=40, seed=3)
    jg, jm = jpg.build_g2o(data, dtype=jnp.float64, layout="ell")
    pg, pm = ppg.build_g2o(data, dtype=torch.float64, layout="ell", device="cpu")
    jc, pc = J.prepare(jg, segsum_exact=True), P.prepare(pg)
    assert pg.fblocks[0].ell_slot == jg.fblocks[0].ell_slot == 0
    assert (pc.mp, pc.gather_mode, pc.ell_fused) == (jc.mp, jc.gather_mode, jc.ell_fused)
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 25)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 25)
    close(ps.v[0].mean, js.v[0].mean, atol=1e-9)
    # The other two forms against the table form, through the first
    # relinearization (sweep 6).
    short = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    for prep in (dict(gather_mode="rows"), dict(ell_fused=False)):
        pc2 = P.prepare(pg, **prep)
        close(P.run(pc2, P.init_state(pc2, pm), PCFG, 8).v[0].mean, short.v[0].mean, atol=1e-9)


@pytest.mark.parametrize("form", ["covariance", "pallas"])
def test_cm_matches_the_generic_engine(sim120, form):
    """The component-major sweep against the port's generic row-major
    engine: same-block belief update, wrapped residual, per-factor Huber."""
    pg, pm = ppg.build(sim120, dtype=torch.float64, layout="ell", device="cpu")
    pc = P.prepare(pg)
    cm = P.to_gbp_state(pc, P.run(pc, P.init_state(pc, pm), PCFG, 25))
    cfg = dataclasses.replace(PCFG, message_form=form)
    gen = PS.run(pg, PS.init_state(pg, pm), cfg, 25)
    close(cm.v[0].mean, gen.v[0].mean, atol=1e-9)
    back = P.from_gbp_state(pc, cm)
    again = P.to_gbp_state(pc, back)
    assert torch.equal(again.f[0].msg_eta[0], cm.f[0].msg_eta[0])
    assert torch.equal(again.v[0].mean, cm.v[0].mean)


def test_expand_means_matches_reference(sim120):
    (_, _, jc), (_, pm, pc) = both(sim120)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 3)
    ref = J.expand_means(jc, jax_state(interop.cm_state_to_numpy(ps)))
    close(P.expand_means(pc, ps), np.asarray(ref).reshape(6, -1))


def test_state_crosses_through_interop(sim120):
    """A same-block CMState goes to the reference's layout and back leaf for
    leaf, and the reference's graph carries across by factor-type name."""
    (jg, _, _), (pg, pm, pc) = both(sim120)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 4)
    again = interop.cm_state_from_numpy(
        jax.tree.map(np.asarray, jax_state(interop.cm_state_to_numpy(ps))), device="cpu")
    assert len(again.v) == 1
    for a, b in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(ps))):
        assert torch.equal(a, b)
    carried = interop.graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    assert carried.fblocks[0].ftype.name == "se2_between"
    assert carried.fblocks[0].ftype.residual_fn is not None
    same_graph(carried, jg)
    pc2 = P.prepare(carried)
    close(P.sweep(pc2, ps, PCFG).v[0].mean, P.sweep(pc, ps, PCFG).v[0].mean, atol=0)


@pytest.mark.parametrize("kind", ["se2_diagonal", "se2_full"])
def test_solve_pcg_matches_reference(kind):
    if kind == "se2_full":
        data = pg2o.read_g2o(G2O_FILE)
        jg, jm = jpg.build_g2o(data, huber=2.0, dtype=jnp.float64)
        pg, pm = ppg.build_g2o(data, huber=2.0, dtype=torch.float64, device="cpu")
    else:
        sim = ppg.simulate_manhattan(n_poses=80, seed=3, loop_prob=0.5, loop_radius=3.0)
        jg, jm = jpg.build(sim, dtype=jnp.float64)
        pg, pm = ppg.build(sim, dtype=torch.float64, device="cpu")
    ref = jschur.solve_pcg(jg, jm, n_steps=2, cg_iters=40)
    got = pschur.solve_pcg(pg, pm, n_steps=2, cg_iters=40)
    assert rel(got[0], ref[0]) <= 1e-8
    assert not torch.equal(got[0], pm[0])


def test_gauss_newton_lowers_the_energy():
    """The MAP target minimizes the energy (the ATE of a MAP estimate may lie
    above the odometry's on a small world: the measurements are noisy)."""
    sim = ppg.simulate_manhattan(n_poses=80, seed=3, loop_prob=0.5, loop_radius=3.0)
    pg, pm = ppg.build(sim, dtype=torch.float64, device="cpu")
    energy = lambda m: float(PS.energy(pg, PS.init_state(pg, m)))
    one = pschur.solve_pcg(pg, pm, n_steps=1, cg_iters=200)
    mu = pschur.solve_pcg(pg, one, n_steps=3, cg_iters=200)
    assert energy(mu) <= energy(one) < energy(pm) and energy(mu) < 0.5 * energy(pm)
    assert np.isfinite(ppg.ate(mu[0], sim["truth"]))


def test_f32_run_lowers_the_ate():
    """The production dtype end to end (the reference's float32 test)."""
    sim = ppg.simulate_manhattan(n_poses=200, seed=1, loop_prob=0.5, loop_radius=3.0)
    pg, pm = ppg.build(sim, layout="ell", device="cpu")
    pc = P.prepare(pg)
    assert pm[0].dtype == torch.float32 and pc.gather_mode == "table"
    st = P.run(pc, P.init_state(pc, pm), PCFG, 150)
    ate0, ate1 = ppg.ate(pm[0], sim["truth"]), ppg.ate(st.v[0].mean, sim["truth"])
    assert np.isfinite(ate1) and ate1 < 0.5 * ate0, (ate0, ate1)


# --- the CLI -----------------------------------------------------------------------------


def energies(out):
    return [float(line.split("energy")[1].split()[0]) for line in out.splitlines()
            if line.startswith("sweep")]


def test_cli_manhattan_on_the_cpu(capsys):
    """60 poses, a seed whose world closes loops: the fast path is chosen,
    the energy falls from the first report to the last, the ATE is printed."""
    slam.main(["--n_poses", "60", "--seed", "5", "--n_iters", "120", "--print_every", "20",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "path: cm (persistent component-major" in out and "device: cpu" in out
    assert "ATE" in out and "sweeps/s" in out
    e = energies(out)
    assert len(e) == 6 and e[-1] < e[0]


def test_cli_g2o_file_takes_the_generic_engine(capsys):
    slam.main(["--g2o_file", G2O_FILE, "--n_iters", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded data/manhattan_sim.g2o (se2): 500 poses, 552 edges" in out
    assert "path: generic sweep" in out
    e = energies(out)
    assert len(e) == 2 and e[1] < e[0]


def test_cli_refuses_several_chips(capsys):
    """Several partitions no longer raise: they run the owner-sharded halo
    path on the one device (tests/test_torch_halo_cm.py holds its numbers)."""
    out = slam.main(["--n_chips", "4", "--n_poses", "200", "--n_iters", "20", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "path: halo_cm (owner-sharded, per-chip CM fast path, gather mode 'table') on 4 " \
           "partitions" in text
    assert out["hp"].n_chips == 4 and np.isfinite(out["ate"][-1][1])
