"""BAL input and the BAL factor models of the port against the JAX reference
(gbp_tpu.io.bal, gbp_tpu.factors.reprojection, gbp_tpu.ops.comp_factors,
gbp_tpu.models.ba.build_bal, gbp_tpu.core.sweep_cm), float64 unless named.

Tolerances:
  parsers, prune, to_sim, the built graphs: exact (the same numpy code, the
    same tokens);
  factor models: 1e-12 relative against the reference (torch against XLA,
    the analytic Jacobians against the reference's jacfwd) and 1e-10
    against autograd;
  one fast-path sweep from a common state: 1e-10 relative (the cavity
    inverses amplify operation-order roundoff, as in test_torch_sweep_cm);
    20 sweeps from the same start: 1e-6 (the beta decisions of the
    relinearization may flip on a last-bit difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.factors import reprojection as jrep
from gbp_tpu.io import bal as jbal
from gbp_tpu.models import ba as jba
from gbp_tpu.ops import comp_factors as jcf
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.factors import reprojection as prep
from gbp_tpu_torch.io import _native
from gbp_tpu_torch.io import bal as pbal
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import comp_factors as pcf

torch.set_num_threads(1)
TOL = 1e-12
FILES = {"toy": "data/toy_ba.txt", "corridor": "data/corridor_sim.txt.gz",
         "ladybug49": "data/ladybug49_sim.txt.gz"}
BA_CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PCFG = GBPConfig(**BA_CFG)
JCFG = JConfig(message_form="pallas", **BA_CFG)

# The reference's one sweep as one compiled program (an eager call compiles
# each of its operations apart, about twice the time; the results agree with
# it to roundoff).
_jsweep = jax.jit(J.sweep, static_argnums=2)
# The reference's ARE as one compiled program (eager, it compiles each of its
# operations apart, seconds a graph; the value agrees to roundoff).
_jare = jax.jit(jba.avg_reprojection_error, static_argnames="fi")


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def reference_problems():
    return {name: jbal.read_bal(path) for name, path in FILES.items()}


# --- BAL I/O ----------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", list(FILES))
def test_read_bal_matches_reference(reference_problems, name, native):
    """Both of the port's parsers (its own C++ tokenizer, built into the
    package's build directory, and the pure-Python one) give the
    reference's arrays."""
    if native:
        assert _native.get_lib() is not None, "g++ is present here: the native parser must build"
    got, ref = pbal.read_bal(FILES[name], native=native), reference_problems[name]
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_native_parser_lives_in_the_package():
    so = _native._build(_native._HERE / "native" / "fastbal.cpp")
    assert so is not None and _native._BUILD in so.parents


def test_write_bal_round_trip(tmp_path, reference_problems):
    p = reference_problems["toy"]
    for suffix in (".txt", ".txt.gz"):
        path = tmp_path / f"rt{suffix}"
        pbal.write_bal(path, p["cam_params"], p["points"], p["obs"], p["cam_ids"],
                       p["point_ids"])
        for back in (pbal.read_bal(path), pbal.read_bal(path, native=False),
                     jbal.read_bal(str(path))):
            np.testing.assert_array_equal(back["cam_ids"], p["cam_ids"])
            np.testing.assert_array_equal(back["point_ids"], p["point_ids"])
            np.testing.assert_array_equal(back["cam_params"], p["cam_params"])  # %.17g
            np.testing.assert_array_equal(back["points"], p["points"])
            assert np.abs(back["obs"] - p["obs"]).max() <= 1e-12 * np.abs(p["obs"]).max()


@pytest.mark.parametrize("name", ["toy", "ladybug49"])
def test_prune_and_to_sim_match_reference(reference_problems, name):
    p = reference_problems[name]
    got, ref = pbal.prune(p), jbal.prune(p)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    counts = np.bincount(got["point_ids"])
    assert (counts >= 2).all() and got["points"].shape[0] == counts.size
    s_got, s_ref = pbal.to_sim(got, pix_sigma=2.0), jbal.to_sim(ref, pix_sigma=2.0)
    assert set(s_got) == set(s_ref)
    for key in s_ref:
        np.testing.assert_array_equal(np.asarray(s_got[key]), np.asarray(s_ref[key]), err_msg=key)


def test_bad_bal_file_raises(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("2 1 1\n0 0 1.0 2.0\n" + "0.5\n" * 18 + "1 2 3 4\n")
    with pytest.raises(ValueError, match="trailing tokens"):
        pbal.read_bal(path)


# --- factor models ----------------------------------------------------------------------


def _bal_points(tdof_cam, rng):
    """States of BAL factors: cameras near the identity looking down -z
    (points at depth about -4), with intrinsics [rf, k1, k2] when the
    camera has 9 dofs."""
    n = 24
    cam = 0.2 * rng.standard_normal((n, 6))
    pts = rng.standard_normal((n, 3)) * [1.0, 1.0, 0.3] + [0, 0, -4.0]
    if tdof_cam == 9:
        intr = np.stack([1.0 + 0.1 * rng.standard_normal(n), 0.1 * rng.standard_normal(n),
                         0.05 * rng.standard_normal(n)], 1)
        cam = np.concatenate([cam, intr], 1)
    return np.concatenate([cam, pts], 1)


MODELS = {
    # name: (camera dofs, per-factor args of n rows or None)
    "reprojection": (6, lambda n, rng: np.tile([500.0, 480.0, 320.0, 240.0], (n, 1))),
    "bal_reprojection": (6, lambda n, rng: np.stack(
        [500.0 + 10 * rng.standard_normal(n), 0.1 * rng.standard_normal(n),
         0.05 * rng.standard_normal(n)], 1)),
    "bal_reprojection_normalized": (6, lambda n, rng: np.stack(
        [0.1 * rng.standard_normal(n), 0.05 * rng.standard_normal(n)], 1)),
    "bal_reprojection_intrinsics": (9, None),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_factor_models_match_reference_and_autograd(name):
    rng = np.random.default_rng(3)
    d_cam, make_args = MODELS[name]
    x = _bal_points(d_cam, rng)
    if name == "reprojection":
        x[:, 8] *= -1.0  # the pinhole camera looks down +z
    args = None if make_args is None else make_args(x.shape[0], rng)
    jf, pf = getattr(jrep, name)(), getattr(prep, name)()
    ja = None if args is None else jnp.asarray(args)
    h_ref = jax.vmap(jf.meas)(jnp.asarray(x), ja) if ja is not None else \
        jax.vmap(jf.meas, in_axes=(0, None))(jnp.asarray(x), None)
    j_ref = jax.vmap(jf.jac)(jnp.asarray(x), ja) if ja is not None else \
        jax.vmap(jf.jac, in_axes=(0, None))(jnp.asarray(x), None)
    xt = torch.from_numpy(x)
    at = None if args is None else torch.from_numpy(args)
    h, jac = pf.meas(xt, at), pf.jac(xt, at)
    assert h.shape == (x.shape[0], 2) and jac.shape == (x.shape[0], 2, x.shape[1])
    assert rel(h, h_ref) <= TOL and rel(jac, j_ref) <= TOL
    for i in range(6):
        a_i = None if at is None else at[i:i + 1]
        auto = torch.autograd.functional.jacobian(lambda v: pf.meas(v[None], a_i)[0], xt[i])
        assert rel(jac[i], auto) <= 1e-10


@pytest.mark.parametrize("name", ["bal_reprojection_normalized", "bal_reprojection_intrinsics"])
def test_bal_component_models_match_reference(name):
    """The component forms the kernels' plain versions evaluate, against
    the reference's and against the row-major factor type."""
    rng = np.random.default_rng(4)
    d_cam, make_args = MODELS[name]
    x = _bal_points(d_cam, rng)
    args = None if make_args is None else make_args(x.shape[0], rng)
    fn, n_args = pcf.COMP_FACTORS[name][:2]
    jfn, jn_args = jcf.COMP_FACTORS[name][:2]
    assert n_args == jn_args == (0 if args is None else 2) == pcf.comp_n_args(name)
    cols = lambda a, conv: None if a is None else [conv(a[:, k]) for k in range(a.shape[1])]
    h, jac = fn(cols(x, torch.from_numpy), cols(args, torch.from_numpy))
    h_ref, j_ref = jfn(cols(x, jnp.asarray), cols(args, jnp.asarray))
    assert rel(torch.stack(h), jnp.stack(h_ref)) <= TOL
    jac = torch.stack([torch.stack(r) for r in jac])
    assert rel(jac, jnp.stack([jnp.stack(r) for r in j_ref])) <= TOL
    pf = getattr(prep, name)()
    at = None if args is None else torch.from_numpy(args)
    assert rel(torch.stack(h, 1), pf.meas(torch.from_numpy(x), at)) <= TOL
    assert rel(jac.permute(2, 0, 1), pf.jac(torch.from_numpy(x), at)) <= TOL


# --- graphs -----------------------------------------------------------------------------


def _sim(name, n_lmk=None):
    sim = pbal.to_sim(pbal.prune(pbal.read_bal(FILES[name])))
    if n_lmk is not None:
        # A corridor subset: the observations of the first n_lmk landmarks.
        keep = sim["lmk_ids"] < n_lmk
        sim = dict(sim, obs=sim["obs"][keep], cam_ids=sim["cam_ids"][keep],
                   lmk_ids=sim["lmk_ids"][keep], lmk_init=sim["lmk_init"][:n_lmk],
                   lmk_truth=sim["lmk_truth"][:n_lmk])
    return sim


@pytest.mark.parametrize("intr", [False, True], ids=["fixed", "intrinsics"])
@pytest.mark.parametrize("name", ["toy", "corridor"])
def test_build_bal_matches_reference(name, intr):
    sim = _sim(name)
    jg, jm, jpx = jba.build_bal(sim, dtype=jnp.float64, optimize_intrinsics=intr)
    pg, pm, ppx = pba.build_bal(sim, dtype=torch.float64, device="cpu", optimize_intrinsics=intr)
    jf, pf = jg.fblocks[0], pg.fblocks[0]
    assert pf.ftype.name == jf.ftype.name
    assert (pf.ell_slot, pf.ell_deg, pf.dofs) == (jf.ell_slot, jf.ell_deg, tuple(jf.dofs))
    for a, b in zip(pf.adj, jf.adj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for key in ("z", "prec", "valid", "args"):
        a, b = getattr(pf, key), getattr(jf, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    for pv, jv in zip(pg.vblocks, jg.vblocks):
        np.testing.assert_array_equal(pv.prior_eta.numpy(), np.asarray(jv.prior_eta))
        np.testing.assert_array_equal(pv.prior_lam.numpy(), np.asarray(jv.prior_lam))
    for a, b in zip(pm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ppx.numpy(), np.asarray(jpx))
    assert pg.vblocks[0].dof == (9 if intr else 6)
    # The graph converts from the reference unchanged (interop), args included.
    ig = interop.graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    assert ig.fblocks[0].ftype.name == pf.ftype.name
    if pf.args is not None:
        np.testing.assert_array_equal(ig.fblocks[0].args.numpy(), pf.args.numpy())


def test_graph_round_trips_through_numpy():
    """A BAL graph with 9-dof cameras and one with per-factor args go to
    numpy and back (interop) unchanged."""
    sim = _sim("toy")
    for intr in (False, True):
        pg, _, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu", optimize_intrinsics=intr)
        back = interop.graph_from_numpy(interop.graph_to_numpy(pg), device="cpu")
        for a, b in zip(back.vblocks, pg.vblocks):
            assert torch.equal(a.prior_eta, b.prior_eta) and torch.equal(a.prior_lam, b.prior_lam)
        fa, fb = back.fblocks[0], pg.fblocks[0]
        assert (fa.ftype.name, fa.dofs, fa.ell_deg) == (fb.ftype.name, fb.dofs, fb.ell_deg)
        for key in ("z", "prec", "valid", "args"):
            a, b = getattr(fa, key), getattr(fb, key)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), key
        assert all(torch.equal(a, b) for a, b in zip(fa.adj, fb.adj))


def test_build_pixel_space_matches_reference():
    """models.ba.build(normalized=False): the pixel-space `reprojection`
    with K as per-factor args; the same ARE as the normalized build."""
    sim = pba.simulate(n_cams=6, n_lmks=60, seed=2)
    jg, jm = jba.build(sim, dtype=jnp.float64, normalized=False)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", normalized=False)
    np.testing.assert_array_equal(pg.fblocks[0].args.numpy(), np.asarray(jg.fblocks[0].args))
    from gbp_tpu.core.sweep import init_state as j_init
    from gbp_tpu_torch.core.sweep import init_state as p_init
    a = float(pba.avg_reprojection_error(pg, p_init(pg, pm)))
    assert abs(a - float(_jare(jg, j_init(jg, jm)))) <= 1e-10
    ng, nm = pba.build(sim, dtype=torch.float64, device="cpu")
    assert abs(a - float(pba.avg_reprojection_error(ng, p_init(ng, nm), k=sim["k"]))) <= 1e-9


# --- the fast path on BAL graphs --------------------------------------------------------


def _jax_state(d):
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d["v"]),
                     f=J.CMFactorState(**f))


@pytest.fixture(scope="module", params=[False, True], ids=["bal632", "bal932"])
def toy_cm(request):
    sim = _sim("toy")
    intr = request.param
    jg, jm, _ = jba.build_bal(sim, dtype=jnp.float64, optimize_intrinsics=intr)
    pg, pm, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu", optimize_intrinsics=intr)
    jc, pc = J.prepare(jg, segsum_exact=True), P.prepare(pg)
    return jc, jm, pc, pm


def test_prepare_bal_matches_reference(toy_cm):
    jc, _, pc, _ = toy_cm
    assert (pc.gather_mode, pc.mp, pc.nv, pc.win_w, pc.ell_fused) == \
        (jc.gather_mode, jc.mp, jc.nv, jc.win_w, jc.ell_fused)
    if jc.args is None:
        assert pc.args is None
    else:
        np.testing.assert_array_equal(pc.args.numpy(), np.asarray(jc.args).reshape(2, -1))
    assert pc.z.shape[0] == 2 and pc.fb.dofs[0] in (6, 9)


@pytest.mark.parametrize("start", [0, 8])
def test_one_bal_sweep_matches_reference(toy_cm, start):
    jc, _, pc, pm = toy_cm
    ps = P.run(pc, P.init_state(pc, pm), PCFG, start)
    js = _jax_state(interop.cm_state_to_numpy(ps))
    ps, js = P.sweep(pc, ps, PCFG), _jsweep(jc, js, JCFG)
    if start:
        assert 0 < int((ps.f.srel == 0).sum()) < pc.mp  # part of the rows relinearize
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10


def test_twenty_bal_sweeps_track_reference(toy_cm):
    jc, jm, pc, pm = toy_cm
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 20)
    js = J.run(jc, J.init_state(jc, jm), JCFG, 20)
    for pv, jv in zip(ps.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-6
