"""The port's BA scene, GraphBuilder, reprojection factor and ARE metric
against the JAX reference (gbp_tpu.models.ba, gbp_tpu.factors), float64.

Exact equality where both packages run the same numpy code (the scene's
integer arrays, the ELL layout, z, prec, priors); 1e-12 relative where the
arithmetic runs in torch on one side and XLA on the other (rotations, the
factor model, the metric), which differ only by roundoff.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core.sweep import GBPState as JState
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.factors import reprojection as jrep
from gbp_tpu.models import ba as jba
from gbp_tpu.ops import comp_factors as jcf
from gbp_tpu_torch import interop
from gbp_tpu_torch.core.sweep import GBPState, VariableState
from gbp_tpu_torch.factors import reprojection as prep
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import comp_factors as pcf

torch.set_num_threads(1)
TOL = 1e-12
SCENE = dict(n_cams=8, n_lmks=120, seed=0)


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def scenes():
    return jba.simulate(**SCENE), pba.simulate(**SCENE)


@pytest.fixture(scope="module")
def graphs(scenes):
    jsim, psim = scenes
    return jba.build(jsim, dtype=jnp.float64), pba.build(psim, dtype=torch.float64, device="cpu")


def test_simulate_matches_reference(scenes):
    jsim, psim = scenes
    assert set(jsim) == set(psim)
    for key, ref in jsim.items():
        ref, got = np.asarray(ref), np.asarray(psim[key])
        assert got.shape == ref.shape, key
        if ref.dtype.kind in "iu":
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1.0), key


def test_build_matches_reference(graphs):
    (jg, jm), (pg, pm) = graphs
    jfb, pfb = jg.fblocks[0], pg.fblocks[0]
    assert (pfb.ell_slot, pfb.ell_deg, pfb.n_valid, pfb.dofs, pfb.vblocks, pfb.huber) == (
        jfb.ell_slot, jfb.ell_deg, jfb.n_valid, jfb.dofs, jfb.vblocks, jfb.huber)
    for a, b in zip(pfb.adj, jfb.adj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("valid", "z", "prec"):
        np.testing.assert_array_equal(getattr(pfb, name).numpy(), np.asarray(getattr(jfb, name)))
    for pvb, jvb, pmu, jmu in zip(pg.vblocks, jg.vblocks, pm, jm):
        np.testing.assert_array_equal(pvb.prior_eta.numpy(), np.asarray(jvb.prior_eta))
        np.testing.assert_array_equal(pvb.prior_lam.numpy(), np.asarray(jvb.prior_lam))
        np.testing.assert_array_equal(pmu.numpy(), np.asarray(jmu))


def test_graph_from_numpy_matches_port_build(graphs):
    """interop.graph_from_numpy on the reference graph gives the port's own
    build of the same scene."""
    (jg, _), (pg, _) = graphs
    g = interop.graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    fb, pfb = g.fblocks[0], pg.fblocks[0]
    assert fb.ftype.name == pfb.ftype.name
    assert (fb.ell_slot, fb.ell_deg, fb.n_valid, fb.dofs) == (
        pfb.ell_slot, pfb.ell_deg, pfb.n_valid, pfb.dofs)
    for a, b in zip(fb.adj, pfb.adj):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    for name in ("valid", "z", "prec"):
        assert torch.equal(getattr(fb, name), getattr(pfb, name))
    for vb, pvb in zip(g.vblocks, pg.vblocks):
        assert torch.equal(vb.prior_eta, pvb.prior_eta)
        assert torch.equal(vb.prior_lam, pvb.prior_lam)


def _points():
    """Healthy points in front of the camera, then the depth-guard cases:
    on the z = 0 plane and behind the camera."""
    rng = np.random.default_rng(7)
    x = np.concatenate([0.3 * rng.standard_normal((32, 6)),
                        rng.standard_normal((32, 3)) * [1.0, 1.0, 0.3] + [0, 0, 4.0]], 1)
    guard = np.array([[0.0] * 6 + [0.3, -0.2, zc] for zc in (0.0, -0.5, 1e-6)])
    return np.concatenate([x, guard])


def test_reprojection_matches_reference_and_autograd():
    x = _points()
    jft, pft = jrep.reprojection_normalized(), prep.reprojection_normalized()
    h_ref = jax.vmap(jft.meas, in_axes=(0, None))(jnp.asarray(x), None)
    j_ref = jax.vmap(jft.jac, in_axes=(0, None))(jnp.asarray(x), None)
    xt = torch.from_numpy(x)
    h, jac = pft.meas(xt, None), pft.jac(xt, None)
    assert torch.isfinite(h).all() and torch.isfinite(jac).all()
    assert rel(h.numpy(), h_ref) <= TOL
    assert rel(jac.numpy(), j_ref) <= TOL
    # Analytic Jacobian against autograd where the depth guard is the identity.
    for i in range(32):
        auto = torch.autograd.functional.jacobian(lambda v: pft.meas(v[None], None)[0], xt[i])
        assert rel(jac[i].numpy(), auto.numpy()) <= 1e-10


def test_component_model_matches_reference():
    """The kernel's plain component model against the reference's."""
    x = _points()
    h_ref, j_ref = jcf.reprojection_normalized_comp([jnp.asarray(x[:, k]) for k in range(9)], None)
    h, jac = pcf.reprojection_normalized_comp([torch.from_numpy(x[:, k]) for k in range(9)])
    for i in range(2):
        assert rel(h[i].numpy(), h_ref[i]) <= TOL
        for k in range(9):
            assert rel(jac[i][k].numpy(), j_ref[i][k]) <= TOL


def test_avg_reprojection_error_matches_reference(scenes, graphs):
    jsim, _ = scenes
    (jg, jm), (pg, pm) = graphs
    rng = np.random.default_rng(11)
    mus = [np.asarray(m) + 0.01 * rng.standard_normal(np.asarray(m).shape) for m in jm]
    jstate = JState(v=tuple(JVar(eta=vb.prior_eta, lam=vb.prior_lam, mean=jnp.asarray(mu))
                            for vb, mu in zip(jg.vblocks, mus)), f=())
    pstate = GBPState(v=tuple(VariableState(eta=vb.prior_eta, lam=vb.prior_lam,
                                            mean=torch.from_numpy(mu))
                              for vb, mu in zip(pg.vblocks, mus)), f=())
    ref = float(jba.avg_reprojection_error(jg, jstate, k=jsim["k"]))
    got = float(pba.avg_reprojection_error(pg, pstate, k=jsim["k"]))
    assert abs(got - ref) <= TOL * ref
    per_ref = np.asarray(jba.reprojection_errors_px(jg, jstate, k=jsim["k"]))
    per = pba.reprojection_errors_px(pg, pstate, k=jsim["k"]).numpy()
    assert rel(per, per_ref) <= TOL
