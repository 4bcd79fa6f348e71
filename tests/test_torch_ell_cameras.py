"""Cameras in the ELL slot: graphs with more cameras than landmarks, whose
ELL layout groups by camera and gathers the landmarks (slot 1 at (6, 3, 2)
and (9, 3, 2)), on the port's fast path (gbp_tpu_torch.core.sweep_cm, plain
versions on the CPU) and its halo path (parallel/halo_cm.py) against the
JAX reference, float64.

Scenes: `ba.simulate(n_cams=16, n_lmks=12)` (every camera sees every
landmark: ELL degree 12, "table"); 16 blocks of 40 cameras with a quarter
of their landmarks kept (`bench.dense_cameras`: 640 cameras, 471
landmarks, the landmark windows engage); `ba.simulate(n_cams=24,
n_lmks=16)` as a BAL problem (`bench.bal_scene`) with 9-dof cameras.

Tolerances (tests/test_torch_sweep_cm.py's): prepare exact; one sweep from
a common state 1e-10 relative; 20 sweeps 1e-6 absolute on the means and
the ARE; the halo path 1e-7 relative on the means after 5 sweeps and 1e-9
after one more from a common state (tests/test_torch_halo_cm.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.models import ba as jba
from gbp_tpu.parallel import halo as jhalo
from gbp_tpu.parallel import halo_cm as jhcm
from gbp_tpu.parallel import sharding
from gbp_tpu_torch import interop
from gbp_tpu_torch.bench import DENSE_BLOCKS, bal_scene, dense_cameras
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
JCFG = JConfig(message_form="pallas", **CFG)
PCFG = GBPConfig(**CFG)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_state(d):
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d["v"]),
                     f=J.CMFactorState(**f))


def both(kind, **prepare_kw):
    """(reference graph, means, prepared), (port graph, means, prepared)."""
    if kind == "bal9":
        sim = bal_scene(pba.simulate(n_cams=24, n_lmks=16, seed=0))
        jg, jm, _ = jba.build_bal(sim, dtype=jnp.float64, optimize_intrinsics=True, **PRIORS)
        pg, pm, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu",
                                  optimize_intrinsics=True, **PRIORS)
    else:
        sim = (pba.simulate(n_cams=16, n_lmks=12, seed=0) if kind == "16x12"
               else dense_cameras(pba.simulate_blocks(**DENSE_BLOCKS)))
        kw = {} if kind == "16x12" else PRIORS
        jg, jm = jba.build(sim, dtype=jnp.float64, **kw)
        pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", **kw)
    return (jg, jm, J.prepare(jg, segsum_exact=True, **prepare_kw)), (pg, pm,
                                                                       P.prepare(pg, **prepare_kw))


@pytest.fixture(scope="module", params=["16x12", "dense", "bal9"])
def scene(request):
    return request.param, both(request.param)


def test_prepare_matches_reference(scene):
    kind, ((jg, _, jc), (pg, _, pc)) = scene
    jf, pf = jg.fblocks[0], pg.fblocks[0]
    assert pf.ell_slot == jf.ell_slot == 0 and pf.ell_deg == jf.ell_deg
    assert (pc.gather_mode, pc.mp, pc.nv, pc.ell_fused, pc.win_w) == (
        jc.gather_mode, jc.mp, jc.nv, jc.ell_fused, jc.win_w)
    want = {"16x12": (3072, 0, (6, 3)), "dense": (7168, 128, (6, 3)), "bal9": (1024, 0, (9, 3))}
    assert (pc.gather_mode, pc.mp, pc.win_w, pf.dofs) == ("table", *want[kind])
    flat = lambda a: np.asarray(a).reshape(np.asarray(a).shape[0], -1)
    for name in ("z", "prec", "act"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), flat(getattr(jc, name)))
    np.testing.assert_array_equal(pc.gidx.numpy(), np.asarray(jc.gidx_cm).reshape(-1))
    if pc.win_w:
        np.testing.assert_array_equal(pc.win_starts.numpy(), np.asarray(jc.win_starts))
    # The gathered landmarks' table: 12 values a row.
    assert pc.gidx.max() < pg.vblocks[pf.vblocks[1]].count


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_one_sweep_matches_reference(scene, fused):
    """One sweep from the port's state after 9 sweeps, handed to the
    reference: every message, the linearization and the means."""
    kind, ((jg, _, _), (pg, pm, _)) = scene
    jc, pc = J.prepare(jg, segsum_exact=True, ell_fused=fused), P.prepare(pg, ell_fused=fused)
    assert pc.ell_fused == jc.ell_fused == (fused is None)
    st = P.run(pc, P.init_state(pc, pm), PCFG, 9)
    ref = J.sweep(jc, jax_state(interop.cm_state_to_numpy(st)), JCFG)
    M.COUNTS.reset()
    got = P.sweep(pc, st, PCFG)
    for a, b in zip(got.f.msg_eta + got.f.msg_lam + (got.f.lp, got.f.jac, got.f.r0),
                    ref.f.msg_eta + ref.f.msg_lam + (ref.f.lp, ref.f.jac, ref.f.r0)):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(got.v, ref.v):
        assert rel(pv.mean, jv.mean) <= 1e-10
    # The landmark sums are 3 + 9 = 12 values a landmark; unfused, the
    # expansion writes the cameras' 6 + 36 + 6 = 48 per row.
    used = {k for k, v in M.COUNTS.plain.items() if v}
    if fused is None:
        assert used == ({"relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
                         "scatter_windows_cm"} if pc.win_w else
                        {"relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id"})
    else:
        assert "expand_ell_blk" in used
        assert P._expand_ell(pc, st.v[0])[0].shape == (pg.fblocks[0].dofs[0], pc.mp)


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_twenty_sweeps_match_reference(fused):
    """The 16 x 12 scene: 20 sweeps of each package from its own initial
    state, means and ARE."""
    (jg, jm, _), (pg, pm, _) = both("16x12")
    jc, pc = J.prepare(jg, segsum_exact=True, ell_fused=fused), P.prepare(pg, ell_fused=fused)
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 20)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 20)
    jgs, pgs = J.to_gbp_state(jc, js), P.to_gbp_state(pc, ps)
    for pv, jv in zip(pgs.v, jgs.v):
        np.testing.assert_allclose(pv.mean.numpy(), np.asarray(jv.mean), atol=1e-6)
    are_p = float(pba.avg_reprojection_error(pg, pgs))
    assert abs(are_p - float(jba.avg_reprojection_error(jg, jgs))) <= 1e-6
    assert are_p < float(pba.avg_reprojection_error(pg, P.to_gbp_state(pc, P.init_state(pc, pm))))


def test_halo_cm_matches_reference():
    """The 16 x 12 scene cut in two: the halo layout groups by camera (the
    larger block) and gathers the landmarks in both packages; 5 sweeps, then
    one more from the port's state handed to the reference."""
    sim = pba.simulate(n_cams=16, n_lmks=12, seed=0)
    jg, jm = jba.build(sim, dtype=jnp.float64, layout="none")
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="none")
    mesh = sharding.make_mesh(2)
    jhp, jh, jst, jrun = jhcm.distribute(jg, jm, mesh)
    php, ph, pst, prun = halo_cm.distribute(pg, pm, 2, device="cpu")
    assert (ph.e, ph.gather_mode, ph.ell_fused, ph.mp, ph.deg) == (
        jh.e, jh.gather_mode, jh.ell_fused, jh.mp, jh.deg)
    assert ph.e == 0 and ph.gather_mode == "table"
    np.testing.assert_array_equal(np.asarray(jh.gidx_rm), ph.gidx.numpy())
    jst, pst = jrun(jh, jst, JCFG, 5), prun(ph, pst, PCFG, 5)
    ref_means = jhalo.collect_means(jhp, jst)
    got_means = halo.collect_means(php, pst)
    assert max(rel(p, r) for p, r in zip(got_means, ref_means)) <= 1e-7
    d = interop.halo_cm_state_to_numpy(pst)
    jst2 = jhcm.HaloCMState(
        v=tuple(jhalo.VariableState(**{k: jnp.asarray(a) for k, a in v.items()})
                for v in d["v"]),
        ghost=tuple(jhalo.VariableState(**{k: jnp.asarray(a) for k, a in v.items()})
                    for v in d["ghost"]),
        f=jhcm.CMFactorState(**{k: jax.tree.map(jnp.asarray, a) for k, a in d["f"].items()}))
    jst2, pst = jrun(jh, jst2, JCFG, 1), prun(ph, pst, PCFG, 1)
    got_means, ref_means = halo.collect_means(php, pst), jhalo.collect_means(jhp, jst2)
    assert max(rel(p, r) for p, r in zip(got_means, ref_means)) <= 1e-9
