"""In-engine prior annealing (gbp_tpu_torch/core/anneal.py) and the BA
command line (python -m gbp_tpu_torch.ba) against the JAX reference
(gbp_tpu/core/anneal.py, the root ba.py), on the CPU.

Tolerances:
  damp_window=0 against the port's own host loop (sweep batches with
    `weaken_priors` between them): bit for bit, the same operations;
  against the reference's annealed runs, float64: 1e-9 on the means, the
    settings of tests/test_anneal.py;
  the printed ARE lines against the root ba.py on data/toy_ba.txt: 1e-3 px
    in float32 (the two packages round differently along 20 sweeps of a
    relinearizing run), 1e-6 px in float64.
"""
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import anneal as janneal
from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.core.sweep import init_state as j_init
from gbp_tpu.models import ba as jba
from gbp_tpu_torch import ba as cli
from gbp_tpu_torch.core import anneal, sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig, init_state, run
from gbp_tpu_torch.models import ba

torch.set_num_threads(1)
BA_CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
CFG = GBPConfig(**BA_CFG)


def _leaves(state):
    return [t for t in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(
        x, torch.Tensor)) if isinstance(t, torch.Tensor)]


def test_run_annealed_matches_host_loop_exactly():
    """damp_window=0 reproduces the reference's host loop (sweep
    `every`, weaken by `factor`, repeat) bit for bit."""
    sim = ba.simulate(n_cams=6, n_lmks=60, seed=0)
    graph, means = ba.build(sim, dtype=torch.float64, device="cpu")
    g, st = graph, init_state(graph, means)
    for _ in range(3):
        st = run(g, st, CFG, 10)
        g = ba.weaken_priors(g, 0.1)
    ref = run(g, st, CFG, 10)
    got = anneal.run_annealed(graph, init_state(graph, means), CFG, 40, every=10, factor=0.1,
                              times=3, damp_window=0)
    for a, b in zip(_leaves(got), _leaves(ref)):
        assert torch.equal(a, b)


def test_run_annealed_matches_reference():
    sim = ba.simulate(n_cams=6, n_lmks=60, seed=0)
    graph, means = ba.build(sim, dtype=torch.float64, device="cpu")
    jg, jm = jba.build(sim, dtype=jnp.float64)
    kw = dict(every=10, factor=0.1, times=2, damp_window=5)
    got = anneal.run_annealed(graph, init_state(graph, means), CFG, 30, **kw)
    ref = janneal.run_annealed(jg, j_init(jg, jm), JConfig(**BA_CFG), 30, **kw)
    for pv, jv in zip(got.v, ref.v):
        np.testing.assert_allclose(pv.mean.numpy(), np.asarray(jv.mean), rtol=1e-9, atol=1e-9)


def test_run_annealed_cm_matches_reference_and_generic():
    """The fast path's annealed run against the reference's (its
    tests/test_anneal.py settings) and against the port's generic engine."""
    sim = ba.simulate(n_cams=6, n_lmks=60, seed=1)
    graph, means = ba.build(sim, dtype=torch.float64, device="cpu", layout="ell")
    jg, jm = jba.build(sim, dtype=jnp.float64, layout="ell")
    cfg = GBPConfig(message_form="pallas", **BA_CFG)
    kw = dict(every=10, factor=0.1, times=2, damp_window=5)
    cmg = sweep_cm.prepare(graph)
    got = anneal.run_annealed_cm(cmg, sweep_cm.init_state(cmg, means), cfg, 30, **kw)
    jc = J.prepare(jg, segsum_exact=True)
    ref = janneal.run_annealed_cm(jc, J.init_state(jc, jm), JConfig(message_form="pallas",
                                                                     **BA_CFG), 30, **kw)
    gen = anneal.run_annealed(graph, init_state(graph, means), cfg, 30, **kw)
    for vi in range(2):
        np.testing.assert_allclose(got.v[vi].mean.numpy(), np.asarray(ref.v[vi].mean),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got.v[vi].mean.numpy(), gen.v[vi].mean.numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_chunked_calls_continue_the_schedule():
    """i0 is the global index of a chunk's first sweep: 3 chunks of 10 give
    the bits of one call of 30, and the run reads nothing back between
    sweeps (the schedule is the loop index)."""
    sim = ba.simulate(n_cams=6, n_lmks=60, seed=1)
    graph, means = ba.build(sim, dtype=torch.float64, device="cpu", layout="ell")
    cmg = sweep_cm.prepare(graph)
    kw = dict(every=10, factor=0.1, times=2, damp_window=5)
    one = anneal.run_annealed_cm(cmg, sweep_cm.init_state(cmg, means), CFG, 30, **kw)
    st = sweep_cm.init_state(cmg, means)
    for i0 in (0, 10, 20):
        st = anneal.run_annealed_cm(cmg, st, CFG, 10, i0=i0, **kw)
    for a, b in zip(_leaves(one), _leaves(st)):
        assert torch.equal(a, b)


def test_schedule_and_anchors_match_reference():
    cfg = GBPConfig(lam_damping=0.1)
    jcfg = JConfig(lam_damping=0.1)
    for i in range(45):
        k, s, lam = anneal.schedule_scalars(i, cfg, 10, 0.1, 3, 5, 0.4, torch.float64)
        js, jlam = janneal.schedule_scalars(jnp.asarray(i), jcfg, 10, 0.1, 3, 5, 0.4,
                                            jnp.float64)
        assert k == min(i // 10, 3) and s == float(js) and lam == float(jlam)
    sim = jba.simulate(n_cams=5, n_lmks=30, seed=0)
    intr = np.tile([500.0, 0.01, 0.0], (5, 1))
    bal_sim = dict(sim, intrinsics=intr)
    pg, _, _ = ba.build_bal(bal_sim, dtype=torch.float64, device="cpu", optimize_intrinsics=True)
    jg, _, _ = jba.build_bal(bal_sim, dtype=jnp.float64, optimize_intrinsics=True)
    for pm, jm in zip(anneal.anchor_masks(pg), janneal.anchor_masks(jg)):
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    # The 9-dof cameras 0 and 1 keep their pose prior and anneal their
    # intrinsics prior, in `weaken_priors` as in the masks.
    w, jw = ba.weaken_priors(pg, 0.1), jba.weaken_priors(jg, 0.1)
    for pv, jv in zip(w.vblocks, jw.vblocks):
        np.testing.assert_array_equal(pv.prior_lam.numpy(), np.asarray(jv.prior_lam))


def test_halo_annealing_raises():
    """The halo annealing is ported (tests/test_torch_halo.py holds it
    against the reference); what it still refuses is a state that is not a
    partition's."""
    from gbp_tpu_torch.parallel import halo

    sim = ba.simulate(n_cams=8, n_lmks=60, seed=0)
    g, m = ba.build(sim, dtype=torch.float64, device="cpu")
    hp = halo.partition(g, 2)
    assert [tuple(a.shape) for a in anneal.halo_anchor_masks(hp)] == [
        (2, hp.hgraph.comm[0].n_own_max, 6), (2, hp.hgraph.comm[1].n_own_max, 3)]
    with pytest.raises(TypeError, match="a HaloState or a HaloCMState"):
        anneal.make_run_annealed_halo(hp, None)


# --- the command line -------------------------------------------------------------------

LINE = re.compile(r"sweep\s+(\d+): avg reprojection error\s+([-\d.]+) px")


def _ares(text):
    return {int(a): float(b) for a, b in LINE.findall(text)}


def _reference_cli(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ba.py", *argv])
    runpy.run_path("ba.py", run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("extra,tol", [([], 1e-3), (["--dtype", "f64"], 1e-6),
                                       (["--optimize_intrinsics"], 1e-3)],
                         ids=["f32", "f64", "intrinsics"])
def test_cli_matches_reference_on_toy(extra, tol, capsys, monkeypatch):
    argv = ["--bal_file", "data/toy_ba.txt", "--n_iters", "20", *extra]
    out = cli.main([*argv, "--device", "cpu"])
    got_text = capsys.readouterr().out
    ref_text = _reference_cli(argv, capsys, monkeypatch)
    got, ref = _ares(got_text), _ares(ref_text)
    assert sorted(got) == sorted(ref) == [0, 10, 20]
    for it in ref:
        assert abs(got[it] - ref[it]) <= tol, (it, got[it], ref[it])
    assert "path: persistent component-major sweep (gather_mode=table)" in got_text
    assert got_text.splitlines()[0] == ref_text.splitlines()[0]  # the "loaded ..." line
    assert all(abs(a - got[it]) <= 5e-5 for it, a in out["are"])
    assert out["cmg"] is not None and out["sweeps_per_s"] > 0


def test_cli_generic_engine_and_oracle(capsys, monkeypatch):
    argv = ["--bal_file", "data/toy_ba.txt", "--n_iters", "20", "--message_form", "covariance",
            "--oracle"]
    out = cli.main([*argv, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "path: generic sweep (covariance) on cpu" in text
    ref_text = _reference_cli(argv, capsys, monkeypatch)
    got_map = float(re.search(r"dense-MAP avg reprojection error\s+([\d.]+)", text).group(1))
    ref_map = float(re.search(r"dense-MAP avg reprojection error\s+([\d.]+)", ref_text).group(1))
    assert abs(got_map - ref_map) <= 1e-3 and abs(out["are_map"] - got_map) < 1e-4
    assert out["cmg"] is None and np.isfinite(out["are"][-1][1])


def test_cli_refuses_several_devices(capsys, monkeypatch):
    """A scene with more cameras than landmarks on two partitions: its halo
    layout groups by camera and gathers the landmarks (the cameras in the
    ELL slot), as the reference's does; the ARE every 10 sweeps matches the
    reference's command line (run on two of the conftest's virtual CPU
    devices), as the test above does on one device."""
    argv = ["--n_cams", "16", "--n_lmks", "12", "--n_chips", "2", "--n_iters", "30"]
    out = cli.main([*argv, "--device", "cpu"])
    got_text = capsys.readouterr().out
    ref_text = _reference_cli(argv, capsys, monkeypatch)
    got, ref = _ares(got_text), _ares(ref_text)
    assert sorted(got) == sorted(ref) == [0, 10, 20, 30]
    for it in ref:
        assert abs(got[it] - ref[it]) <= 1e-3, (it, got[it], ref[it])
    assert "path: halo_cm (owner-sharded, per-chip CM fast path) on 2 partitions" in got_text
    hcm = out["hcm"]
    assert out["hp"].n_chips == 2 and hcm.e == 0 and hcm.gather_mode == "table"
