"""The port's checkpoints and profiling helpers (gbp_tpu_torch.utils:
checkpoint, profiling) against tests/test_checkpoint.py's cases, on the CPU
in float64.

A resumed run equals the uninterrupted run bit for bit on every engine: the
generic sweep (a linear chain; a BA scene mid prior weakening, with the
schedule's position in `extras`), the fast path through
`sweep_cm.from_gbp_state`, and the halo path at P = 8 partitions through
`halo.LocalComm`.  Across packages: the reference runs 6 sweeps and goes
through its own (orbax) checkpoint, its state through `interop` into the
port, through the port's checkpoint, and 6 more sweeps of the port: equal to
the reference's uninterrupted 12 sweeps to 1e-10 relative.  The file loads
with `weights_only=True`; a template of another shape or dtype raises,
naming the leaf.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core import sweep_cm as PC
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import toy as ptoy
from gbp_tpu_torch.parallel import halo
from gbp_tpu_torch.utils import checkpoint, profiling

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core import sweep as JS
    from gbp_tpu.models import ba as jba
    from gbp_tpu.utils import checkpoint as jcheckpoint
except ImportError:
    jax = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")
CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
F64 = dict(dtype=torch.float64, device="cpu")


def leaves(tree):
    return list(checkpoint._leaves(tree, "", {}).values())


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def test_save_restore_resume_identical(tmp_path):
    graph, means = ptoy.build(ptoy.simulate(n=40, seed=4), **F64)
    cfg = dataclasses.replace(CFG, num_undamped_iters=3, min_linear_iters=2)
    state = PS.run(graph, PS.init_state(graph, means), cfg, 7)
    checkpoint.save(tmp_path / "ckpt", state, graph=graph)
    ref = PS.run(graph, state, cfg, 9)

    r_state, r_graph = checkpoint.restore(tmp_path / "ckpt", PS.init_state(graph, means), graph)
    assert_same(r_state, state)
    assert_same(r_graph, graph)
    assert_same(PS.run(r_graph, r_state, cfg, 9), ref)


def test_resume_mid_prior_weakening_schedule(tmp_path):
    """Three periods of 5 sweeps, the priors weakened after each: saved after
    period 2 with the weakened graph and the schedule's position."""
    sim = pba.simulate(n_cams=5, n_lmks=40, seed=6)
    graph, means = pba.build(sim, **F64)
    g, st = graph, PS.init_state(graph, means)
    for _ in range(3):
        st = PS.run(g, st, CFG, 5)
        g = pba.weaken_priors(g, 0.1)
    ref = PS.run(g, st, CFG, 5)

    g2, st2 = graph, PS.init_state(graph, means)
    for _ in range(2):
        st2 = PS.run(g2, st2, CFG, 5)
        g2 = pba.weaken_priors(g2, 0.1)
    checkpoint.save(tmp_path / "ck", st2, graph=g2, extras={"sweep": 10, "weakened": 2})
    r_state, r_graph, r_extras = checkpoint.restore(
        tmp_path / "ck", PS.init_state(graph, means), graph,
        extras_template={"sweep": 0, "weakened": 0})
    assert int(r_extras["sweep"]) == 10 and int(r_extras["weakened"]) == 2
    g3, st3 = r_graph, r_state
    for _ in range(int(r_extras["weakened"]), 3):
        st3 = PS.run(g3, st3, CFG, 5)
        g3 = pba.weaken_priors(g3, 0.1)
    assert_same(PS.run(g3, st3, CFG, 5), ref)


def test_resume_into_cm(tmp_path):
    """A GBPState checkpoint resumes in the fast path
    (`sweep_cm.from_gbp_state`), equal to an uninterrupted fast-path run."""
    graph, means = pba.build(pba.simulate(n_cams=6, n_lmks=50, seed=3), layout="ell", **F64)
    cfg = dataclasses.replace(CFG, message_form="pallas")
    cmg = PC.prepare(graph)
    assert cmg is not None
    ref = PC.run(cmg, PC.init_state(cmg, means), cfg, 12)

    mid = PC.run(cmg, PC.init_state(cmg, means), cfg, 6)
    checkpoint.save(tmp_path / "cm", PC.to_gbp_state(cmg, mid))
    template = PC.to_gbp_state(cmg, PC.init_state(cmg, means))
    resumed = PC.run(cmg, PC.from_gbp_state(cmg, checkpoint.restore(tmp_path / "cm", template)),
                     cfg, 6)
    assert_same(PC.to_gbp_state(cmg, resumed), PC.to_gbp_state(cmg, ref))
    for a, b in zip(resumed.v, ref.v):
        assert torch.equal(a.mean, b.mean)


def test_halo_state_save_restore_resume(tmp_path):
    """HaloState (owned beliefs, ghosts, factor shards) at P = 8 partitions
    in one process, restored onto the template's device."""
    graph, means = pba.build(pba.simulate(n_cams=8, n_lmks=100, seed=5), layout="none", **F64)
    hp, st0, run_halo = halo.distribute(graph, means, 8, device="cpu")
    assert hp.n_chips == 8
    ref = run_halo(hp.hgraph, run_halo(hp.hgraph, st0, CFG, 8), CFG, 8)

    checkpoint.save(tmp_path / "halo", run_halo(hp.hgraph, st0, CFG, 8), extras={"sweep": 8})
    hp2, template, run2 = halo.distribute(graph, means, 8, device="cpu")
    r_state, r_extras = checkpoint.restore(tmp_path / "halo", template,
                                           extras_template={"sweep": 0})
    assert int(r_extras["sweep"]) == 8
    assert all(t.device == u.device for t, u in zip(leaves(r_state), leaves(template)))
    assert_same(run2(hp2.hgraph, r_state, CFG, 8), ref)


@needs_jax
def test_resume_across_packages(tmp_path):
    """The reference's 6 sweeps through its own checkpoint, then the port's
    checkpoint and 6 sweeps of the port: the reference's uninterrupted 12."""
    sim = pba.simulate(n_cams=6, n_lmks=60, seed=2)
    jg, jm = jba.build(sim, dtype=jnp.float64)
    runj = jax.jit(JS.run, static_argnums=3)
    jcfg = JS.GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
    want = runj(jg, runj(jg, JS.init_state(jg, jm), jcfg, 6), jcfg, 6)
    jcheckpoint.save(tmp_path / "jax", runj(jg, JS.init_state(jg, jm), jcfg, 6))
    mid = jcheckpoint.restore(tmp_path / "jax", JS.init_state(jg, jm))

    pg, pm = pba.build(sim, **F64)
    checkpoint.save(tmp_path / "torch", interop.gbp_state_from_numpy(mid, device="cpu"))
    got = PS.run(pg, checkpoint.restore(tmp_path / "torch", PS.init_state(pg, pm)), CFG, 6)
    # The two NamedTuple trees list their leaves in the same order.
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(leaves(got))
    for g, w in zip(leaves(got), want_leaves):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-10 * max(np.abs(w).max(), 1e-300)


def test_file_is_a_flat_dict_of_tensors_loaded_weights_only(tmp_path):
    graph, means = ptoy.build(ptoy.simulate(n=10), **F64)
    state = PS.init_state(graph, means)
    checkpoint.save(tmp_path / "ck", state, graph=graph, extras={"sweep": 3})
    flat = torch.load(tmp_path / "ck", weights_only=True)
    assert all(isinstance(t, torch.Tensor) for t in flat.values())
    assert "state.v.0.eta" in flat and "state.f.1.msg_lam.1" in flat
    assert "graph.fblocks.0.z" in flat and int(flat["extras.sweep"]) == 3
    assert len([k for k in flat if k.startswith("state.")]) == len(leaves(state))


def test_mismatched_template_raises_naming_the_leaf(tmp_path):
    graph, means = ptoy.build(ptoy.simulate(n=10), **F64)
    checkpoint.save(tmp_path / "ck", PS.init_state(graph, means))
    other, other_means = ptoy.build(ptoy.simulate(n=12), **F64)
    with pytest.raises(ValueError, match=r"state\.v\.0\.eta.*\(10, 1\).*\(12, 1\)"):
        checkpoint.restore(tmp_path / "ck", PS.init_state(other, other_means))
    g32, m32 = ptoy.build(ptoy.simulate(n=10), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=r"state\.v\.0\.eta.*torch\.float64.*torch\.float32"):
        checkpoint.restore(tmp_path / "ck", PS.init_state(g32, m32))
    with pytest.raises(ValueError, match=r"no leaf 'extras\.sweep'"):
        checkpoint.restore(tmp_path / "ck", PS.init_state(graph, means),
                           extras_template={"sweep": 0})


def test_trace_writes_a_file_and_time_sweeps_gives_a_rate(tmp_path):
    graph, means = ptoy.build(ptoy.simulate(n=20), **F64)
    state = PS.init_state(graph, means)
    with profiling.trace(tmp_path / "trace", device="cpu") as prof:
        PS.run(graph, state, CFG, 2)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any("aten::" in e.key for e in prof.key_averages())
    rate, out = profiling.time_sweeps(PS.run, graph, state, CFG, 5, warmup=2)
    assert rate > 0 and torch.equal(out.v[0].mean, PS.run(graph, state, CFG, 7).v[0].mean)


@pytest.mark.cuda
def test_checkpoint_crosses_devices(tmp_path):
    """Saved on the card, restored on the CPU, and back: leaves equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graph, means = pba.build(pba.simulate(n_cams=6, n_lmks=50, seed=3), dtype=torch.float64,
                             device="cuda")
    state = PS.run(graph, PS.init_state(graph, means), CFG, 4)
    checkpoint.save(tmp_path / "card", state)
    cpu_graph, cpu_means = pba.build(pba.simulate(n_cams=6, n_lmks=50, seed=3), **F64)
    on_cpu = checkpoint.restore(tmp_path / "card", PS.init_state(cpu_graph, cpu_means))
    assert all(t.device.type == "cpu" for t in leaves(on_cpu))
    checkpoint.save(tmp_path / "cpu", on_cpu)
    back = checkpoint.restore(tmp_path / "cpu", PS.init_state(graph, means))
    assert_same(back, state)
