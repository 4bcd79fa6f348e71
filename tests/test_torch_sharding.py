"""The port's factor-sharded path (gbp_tpu_torch/parallel/sharding.py) and
the sharded Schur step (parallel/schur.py with a communicator) against the
reference's GSPMD runs (gbp_tpu/parallel/sharding.py on the conftest's 8
virtual CPU devices), mirroring tests/test_distributed.py and
tests/test_schur.py::test_schur_sharded_matches_single_device.

  * padding dummies are inert: 20 sweeps of the padded graph equal the
    unpadded graph's to 1e-12, and `pad_graph`'s arrays are the reference's;
  * the sharded run (8 shards through spmd's runner, partial sums by the
    segment sum and one all-reduce) equals the reference's sharded run and
    its single-device run to rtol 1e-9, atol 1e-11, on BA (40 sweeps) and a
    60-pose Manhattan graph (30 sweeps);
  * the sharded Gauss-Newton step equals the single-device step to rtol
    1e-9, atol 1e-12, and the reference's sharded step;
  * 2 gloo processes x 4 shards equal the single-process run and step bit
    for bit.
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch.core import sweep
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.parallel import multihost, schur, sharding, spmd
from gbp_tpu_torch.parallel.halo import LocalComm

from tests.test_torch_multihost import spawn

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
BA = dict(n_cams=8, n_lmks=120, seed=0)
POSE = dict(n_poses=60, seed=4, loop_prob=0.5, loop_radius=3.0)
SCHUR = dict(n_cams=8, n_lmks=100, seed=3)


def test_padding_dummies_are_inert():
    import jax.numpy as jnp

    from gbp_tpu.models import ba as jba
    from gbp_tpu.parallel import sharding as jsharding

    kw = dict(n_cams=6, n_lmks=80, seed=1)
    graph, means = pba.build(pba.simulate(**kw), dtype=torch.float64, device="cpu",
                             layout="none")
    assert graph.fblocks[0].count % 8 != 0
    cfg = GBPConfig(**CFG)
    plain = sweep.run(graph, sweep.init_state(graph, means), cfg, 20)
    padded = sharding.pad_graph(graph, 8)
    assert padded.fblocks[0].count % 8 == 0
    out = sweep.run(padded, sweep.init_state(padded, means), cfg, 20)
    for a, b in zip(out.v, plain.v):
        np.testing.assert_allclose(a.mean.numpy(), b.mean.numpy(), rtol=1e-12, atol=1e-12)
    jp = jsharding.pad_graph(jba.build(jba.simulate(**kw), dtype=jnp.float64,
                                       layout="none")[0], 8)
    for fb, jfb in zip(padded.fblocks, jp.fblocks):
        assert fb.n_valid == jfb.n_valid and fb.ell_slot is None
        for name in ("z", "prec", "valid"):
            np.testing.assert_array_equal(getattr(fb, name).numpy(),
                                          np.asarray(getattr(jfb, name)))
        for a, b in zip(fb.adj, jfb.adj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def scene(kind):
    """(port graph, means, config, reference graph, means, config), float64."""
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import pose_graph as jpg

    if kind == "ba":
        return (*pba.build(pba.simulate(**BA), dtype=torch.float64, device="cpu"),
                GBPConfig(**CFG), *jba.build(jba.simulate(**BA), dtype=jnp.float64),
                JConfig(**CFG))
    return (*ppg.build(ppg.simulate_manhattan(**POSE), dtype=torch.float64, device="cpu"),
            ppg.default_config(),
            *jpg.build(jpg.simulate_manhattan(**POSE), dtype=jnp.float64),
            jpg.default_config())


def sharded_run(graph, means, cfg, n_iters, comm=None):
    g, st = sharding.distribute(graph, sweep.init_state(graph, means), 8, device="cpu",
                                comm=comm)
    return spmd.make_run(g, 8, comm)(g, st, cfg, n_iters)


@pytest.mark.parametrize("kind,n_iters", [("ba", 40), ("pose", 30)])
def test_sharded_run_matches_reference(kind, n_iters):
    import jax

    from gbp_tpu.core.sweep import init_state, run
    from gbp_tpu.parallel import sharding as jsharding

    pg, pm, pcfg, jg, jm, jcfg = scene(kind)
    jstate = init_state(jg, jm)
    single = jax.jit(run, static_argnums=3)(jg, jstate, jcfg, n_iters)
    g_sh, s_sh = jsharding.distribute(jg, jstate, jsharding.make_mesh(8))
    multi = jax.jit(run, static_argnums=3)(g_sh, s_sh, jcfg, n_iters)
    got = sharded_run(pg, pm, pcfg, n_iters)
    for vs, vm, v1 in zip(got.v, multi.v, single.v):
        for want in (vm, v1):
            np.testing.assert_allclose(vs.mean.numpy(), np.asarray(want.mean), rtol=1e-9,
                                       atol=1e-11)


def sharded_step(comm=None):
    graph, means = pba.build(pba.simulate(**SCHUR), dtype=torch.float64, device="cpu")
    g, _ = sharding.distribute(graph, sweep.init_state(graph, means), 8, device="cpu",
                               comm=comm)
    return schur.gauss_newton_step(g, means, cg_iters=100,
                                   comm=LocalComm(8) if comm is None else comm)


def test_sharded_schur_matches_single_device():
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import init_state
    from gbp_tpu.models import ba as jba
    from gbp_tpu.parallel import schur as jschur
    from gbp_tpu.parallel import sharding as jsharding

    graph, means = pba.build(pba.simulate(**SCHUR), dtype=torch.float64, device="cpu")
    single = schur.gauss_newton_step(graph, means, cg_iters=100)
    multi = sharded_step()
    jg, jm = jba.build(jba.simulate(**SCHUR), dtype=jnp.float64)
    jg_sh, _ = jsharding.distribute(jg, init_state(jg, jm), jsharding.make_mesh(8))
    jmulti = jschur.gauss_newton_step(jg_sh, jm, cg_iters=100)
    for a, b, c in zip(multi, single, jmulti):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-9, atol=1e-12)


def test_schur_on_the_padded_graph_without_a_communicator():
    """The padded, sharded rows in one reduction (comm None): the dummies
    add nothing and the step is the unsharded one."""
    graph, means = pba.build(pba.simulate(n_cams=6, n_lmks=80, seed=1), dtype=torch.float64,
                             device="cpu", layout="none")
    single = schur.gauss_newton_step(graph, means, cg_iters=100)
    g, _ = sharding.distribute(graph, sweep.init_state(graph, means), 8, device="cpu")
    assert g.fblocks[0].count > graph.fblocks[0].count
    for a, b in zip(schur.gauss_newton_step(g, means, cg_iters=100), single):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def scene_port():
    return (*pba.build(pba.simulate(**BA), dtype=torch.float64, device="cpu"),
            GBPConfig(**CFG, message_form="pallas"))


def shard_runs(comm):
    pg, pm, pcfg = scene_port()
    return {"run": tuple(vs.mean for vs in sharded_run(pg, pm, pcfg, 40, comm).v),
            "step": sharded_step(comm)}


def shard_worker(rank):
    return shard_runs(multihost.global_comm(8, device="cpu"))


@pytest.fixture(scope="module")
def shard_ranks():
    return spawn(shard_worker, 2)


@pytest.mark.parametrize("what", ["run", "step"])
def test_two_process_sharding_equals_one_process(shard_ranks, what):
    want = shard_runs(None)[what]
    for got in shard_ranks:
        assert all(torch.equal(a, b) for a, b in zip(got[what], want))
