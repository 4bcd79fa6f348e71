"""The port's component-major sweep (gbp_tpu_torch.core.sweep_cm, plain
versions on the CPU) and its Gauss-Newton MAP target against the JAX
reference, on the 8-cam/120-landmark scene.

Tolerances:
  prepare: exact (the same numpy layout code);
  init_state: 1e-12 relative (the same model, torch vs XLA roundoff);
  one sweep from a common state: 1e-10 relative on messages and means;
  20 sweeps: 1e-6 absolute on means, loose on purpose: the beta-threshold
    relinearization turns roundoff-level differences into different
    relinearization decisions (docs/PERFORMANCE.md, "ULP chaos");
  float32 ARE after 20 sweeps: within 1e-3 px of the reference's;
  Gauss-Newton: 1e-8 relative (60 CG iterations amplify roundoff).
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.models import ba as jba
from gbp_tpu.parallel import schur as jschur
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.parallel import schur as pschur

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
JCFG = JConfig(message_form="pallas", **CFG)
PCFG = GBPConfig(**CFG)


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_state(d):
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d["v"]),
                     f=J.CMFactorState(**f))


def build_both(dtype):
    sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
    jg, jm = jba.build(sim, dtype={torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype])
    pg, pm = pba.build(sim, dtype=dtype, device="cpu")
    return sim, (jg, jm, J.prepare(jg, segsum_exact=True)), (pg, pm, P.prepare(pg))


@pytest.fixture(scope="module")
def f64():
    return build_both(torch.float64)


def test_prepare_matches_reference(f64):
    _, (_, _, jc), (_, _, pc) = f64
    assert (pc.mp, pc.nv) == (jc.mp, jc.nv)
    flat = lambda a: np.asarray(a).reshape(np.asarray(a).shape[0], -1)
    for name in ("z", "prec", "act"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), flat(getattr(jc, name)))
    np.testing.assert_array_equal(pc.gidx.numpy(), np.asarray(jc.gidx_cm).reshape(-1))
    # The CSR lists every valid row once (padded and clone rows carry zero
    # messages), grouped by camera id in row order.
    rows, offs = pc.seg_rows.numpy(), pc.seg_offsets.numpy()
    assert sorted(rows.tolist()) == np.flatnonzero(pc.act.numpy()[0] > 0.5).tolist()
    gid = pc.gidx.numpy()
    for c in range(len(offs) - 1):
        seg = rows[offs[c]:offs[c + 1]]
        assert (gid[seg] == c).all() and (np.diff(seg) > 0).all()


def test_init_state_matches_reference(f64):
    _, (_, jm, jc), (_, pm, pc) = f64
    js, ps = J.init_state(jc, jm), P.init_state(pc, pm)
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-12
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert not a.any() and not np.asarray(b).any()
    for pv, jv in zip(ps.v, js.v):
        for name in ("eta", "lam", "mean"):
            np.testing.assert_array_equal(getattr(pv, name).numpy(), np.asarray(getattr(jv, name)))


@pytest.mark.parametrize("start", [0, 8])
def test_one_sweep_matches_reference(f64, start):
    """One sweep from a common state: the initial state, and the state after
    8 sweeps (damping on, the sweep relinearizes part of the rows)."""
    _, (_, _, jc), (_, pm, pc) = f64
    ps = P.run(pc, P.init_state(pc, pm), PCFG, start)
    js = jax_state(interop.cm_state_to_numpy(ps))
    ps, js = P.sweep(pc, ps, PCFG), J.sweep(jc, js, JCFG)
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10


def test_twenty_sweeps_track_reference(f64):
    _, (_, jm, jc), (_, pm, pc) = f64
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 20)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 20)
    for pv, jv in zip(ps.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-6


def test_f32_are_after_twenty_sweeps_matches_reference():
    sim, (jg, jm, jc), (pg, pm, pc) = build_both(torch.float32)
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 20)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 20)
    ref = float(jba.avg_reprojection_error(jg, J.to_gbp_state(jc, js), k=sim["k"]))
    got = float(pba.avg_reprojection_error(pg, P.to_gbp_state(pc, ps), k=sim["k"]))
    assert np.isfinite(got) and abs(got - ref) <= 1e-3, (got, ref)
    are0 = float(pba.avg_reprojection_error(pg, P.to_gbp_state(pc, P.init_state(pc, pm)),
                                            k=sim["k"]))
    assert got < are0


def test_gbp_state_round_trip(f64):
    """to_gbp_state matches the reference's conversion, and from_gbp_state
    inverts it exactly on the real rows (padded rows come back zero, with
    act = 0 they are inert; only their sweep counter differs)."""
    _, (_, _, jc), (_, pm, pc) = f64
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 9)
    g = P.to_gbp_state(pc, ps)
    jg = J.to_gbp_state(jc, jax_state(interop.cm_state_to_numpy(ps)))
    f, jf = g.f[0], jg.f[0]
    assert f.since_relin.dtype == torch.int32
    for name in ("linpoint", "jac", "r0", "since_relin"):
        np.testing.assert_array_equal(getattr(f, name).numpy(), np.asarray(getattr(jf, name)))
    for a, b in zip(f.msg_eta + f.msg_lam, jf.msg_eta + jf.msg_lam):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = P.from_gbp_state(pc, g)
    m = pc.fb.count
    for a, b in zip(back.f, ps.f):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x[:, :m], y[:, :m]) and not x[:, m:].any()
    # Through numpy and back (the checkpoint path of interop.py).
    again = interop.cm_state_from_numpy(jax.tree.map(np.asarray, jax_state(
        interop.cm_state_to_numpy(ps))), device="cpu")
    for a, b in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(ps))):
        assert torch.equal(a, b)


def test_gauss_newton_step_matches_reference(f64):
    _, (jg, jm, _), (pg, pm, _) = f64
    jmu, pmu = jm, pm
    for _ in range(2):
        jmu = jschur.gauss_newton_step(jg, jmu, cg_iters=60)
        pmu = pschur.gauss_newton_step(pg, pmu, cg_iters=60)
    for a, b in zip(pmu, jmu):
        assert rel(a, b) <= 1e-8


def _with_fb(graph, **kw):
    return dataclasses.replace(graph, fblocks=(dataclasses.replace(graph.fblocks[0], **kw),))


@pytest.mark.parametrize("case", ["segment", "huber_arr", "full_prec", "factor_type",
                                  "cam_table", "two_blocks", "ell_fused", "no_ell"])
def test_prepare_rejects_what_is_not_ported(f64, case):
    """What the reference declines returns None (the caller runs the generic
    sweep); a camera table beyond shared memory without camera locality
    lands on the expanded operands; per-factor Huber thresholds,
    `ell_fused=False` and the BAL model with its per-row arguments are
    taken, a factor type without a component model declined; with
    segment=True the reference's `prepare_seg` declines this scene (its
    degree classes save too few rows) and both packages return the single
    segment."""
    _, (jg, _, _), (pg, _, _) = f64
    fb = pg.fblocks[0]
    kw = {}
    if case == "huber_arr":
        pg = _with_fb(pg, huber_arr=torch.ones(fb.count, dtype=torch.float64))
    elif case == "full_prec":
        pg = _with_fb(pg, prec=torch.diag_embed(fb.prec))
    elif case == "factor_type":
        args = torch.arange(2 * fb.count, dtype=torch.float64).reshape(fb.count, 2)
        pg = _with_fb(pg, ftype=dataclasses.replace(fb.ftype, name="bal_reprojection_normalized"),
                      args=args)
    elif case == "cam_table":
        cams = dataclasses.replace(pg.vblocks[0], prior_eta=torch.zeros(200, 6, dtype=torch.float64))
        pg = dataclasses.replace(pg, vblocks=(cams, pg.vblocks[1]))
    elif case == "two_blocks":
        pg = dataclasses.replace(pg, fblocks=(fb, fb))
    elif case == "no_ell":
        pg = _with_fb(pg, ell_slot=None, ell_deg=0)
    elif case == "ell_fused":
        kw = {"ell_fused": False}
    else:
        kw = {"segment": True}
    if case in ("full_prec", "two_blocks", "no_ell"):
        assert P.prepare(pg, **kw) is None
    elif case == "factor_type":
        cmg = P.prepare(pg, **kw)
        assert cmg.gather_mode == "table" and cmg.args.shape == (2, cmg.mp)
        assert torch.equal(cmg.args[:, :fb.count], args.T) and not bool(cmg.args[:, fb.count:].any())
        assert P.prepare(_with_fb(pg, ftype=dataclasses.replace(fb.ftype, name="bal_reprojection"))) \
            is None
    elif case == "cam_table":
        cmg = P.prepare(pg, **kw)
        assert cmg.gather_mode == "rows" and cmg.win_w == 0 and cmg.gidx_rm is not None
    elif case == "huber_arr":
        # The thresholds ride as one more component of prec (pad fill 1.0).
        cmg = P.prepare(pg, **kw)
        assert cmg.gather_mode == "table" and cmg.prec.shape == (3, cmg.mp)
        assert bool((cmg.prec[2, :fb.count] == 1.0).all()) and bool((cmg.prec[:, fb.count:] == 1).all())
    elif case == "ell_fused":
        cmg = P.prepare(pg, **kw)
        assert cmg.gather_mode == "table" and not cmg.ell_fused and P.prepare(pg).ell_fused
    else:
        assert isinstance(J.prepare(jg, segsum_exact=True, **kw), J.CMGraph)
        cmg = P.prepare(pg, **kw)
        assert isinstance(cmg, P.CMGraph) and P.prepare_seg(pg) is None
        assert torch.equal(cmg.gidx, P.prepare(pg).gidx) and cmg.win_w == 0


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gbp_tpu_torch\n"
        "for m in pkgutil.walk_packages(gbp_tpu_torch.__path__, 'gbp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gbp_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('gbp_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
