"""The port's explicit SPMD sweep (gbp_tpu_torch/parallel/spmd.py) against
the reference's (gbp_tpu/parallel/spmd.py, shard_map over the conftest's 8
virtual CPU devices), mirroring tests/test_spmd.py.

  * BA (8 cameras, 120 landmarks, float64, 30 sweeps) and a 64-pose
    Manhattan graph (25 sweeps): the port's run on 8 partitions in one
    process equals the reference's SPMD run and its single-device run to
    rtol 1e-9, atol 1e-11 (the reference test's bar; the partial sums add
    in another order);
  * the partition balances its rows and keeps every factor, and its arrays
    (chip-major rows, inert dummies, stacked local inboxes) equal the
    reference's `partition_graph`;
  * 2 gloo processes x 4 partitions (`multihost.DistComm`) equal the
    single-process run bit for bit, covariance and "pallas" forms (the
    kernels' plain versions here).
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.parallel import multihost, spmd
from gbp_tpu_torch.parallel.halo import LocalComm

from tests.test_torch_multihost import spawn

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
BA = dict(n_cams=8, n_lmks=120, seed=0)
POSE = dict(n_poses=64, seed=4, loop_prob=0.5, loop_radius=3.0)


def reference(kind):
    """(reference graph, means, config) of one scene, float64."""
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import pose_graph as jpg

    if kind == "ba":
        return (*jba.build(jba.simulate(**BA), dtype=jnp.float64), JConfig(**CFG))
    return (*jpg.build(jpg.simulate_manhattan(**POSE), dtype=jnp.float64),
            jpg.default_config())


def port(kind):
    if kind == "ba":
        return (*pba.build(pba.simulate(**BA), dtype=torch.float64, device="cpu"),
                GBPConfig(**CFG))
    return (*ppg.build(ppg.simulate_manhattan(**POSE), dtype=torch.float64, device="cpu"),
            ppg.default_config())


@pytest.mark.parametrize("kind,n_iters", [("ba", 30), ("pose", 25)])
def test_spmd_matches_reference(kind, n_iters):
    import jax

    from gbp_tpu.core.sweep import init_state, run
    from gbp_tpu.parallel import sharding
    from gbp_tpu.parallel import spmd as jspmd

    jg, jm, jcfg = reference(kind)
    single = jax.jit(run, static_argnums=3)(jg, init_state(jg, jm), jcfg, n_iters)
    mesh = sharding.make_mesh(8)
    g_sh, s_sh = jspmd.distribute(jg, jm, mesh)
    multi = jspmd.make_run(mesh, g_sh, s_sh)(g_sh, s_sh, jcfg, n_iters)

    pg, pm, pcfg = port(kind)
    g, st = spmd.distribute(pg, pm, 8, device="cpu")
    got = spmd.make_run(g, 8)(g, st, pcfg, n_iters)
    for vs, vm, vs1 in zip(got.v, multi.v, single.v):
        for want in (vm, vs1):
            np.testing.assert_allclose(vs.mean.numpy(), np.asarray(want.mean), rtol=1e-9,
                                       atol=1e-11)


def test_partition_balances_and_preserves_factors():
    """The reference test's checks, and the arrays against the reference's."""
    import jax.numpy as jnp

    from gbp_tpu.models import ba as jba
    from gbp_tpu.parallel import spmd as jspmd

    kw = dict(n_cams=8, n_lmks=100, seed=2)
    graph, _ = pba.build(pba.simulate(**kw), device="cpu")
    p = spmd.partition_graph(graph, 4)
    jp = jspmd.partition_graph(jba.build(jba.simulate(**kw), dtype=jnp.float32)[0], 4)
    for fb_old, fb_new, jfb in zip(graph.fblocks, p.fblocks, jp.fblocks):
        assert fb_new.count % 4 == 0
        valid_old = (np.ones(fb_old.count, bool) if fb_old.valid is None
                     else fb_old.valid.numpy())
        assert int(fb_new.valid.sum()) == int(valid_old.sum()) == fb_new.n_valid
        z_old = np.sort(fb_old.z.numpy()[valid_old], axis=0)
        z_new = np.sort(fb_new.z.numpy()[fb_new.valid.numpy()], axis=0)
        np.testing.assert_array_equal(z_old, z_new)
        assert fb_new.ell_slot is None and jfb.n_valid == fb_new.n_valid
        for name in ("z", "prec", "valid"):
            np.testing.assert_array_equal(getattr(fb_new, name).numpy(),
                                          np.asarray(getattr(jfb, name)))
        for a, b in zip(fb_new.adj, jfb.adj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (p.inboxes is None) == (jp.inboxes is None)
    for specs, jspecs in zip(p.inboxes, jp.inboxes):
        assert (specs is None) == (jspecs is None)
        for s, js in zip(specs or (), jspecs or ()):
            assert (s.fi, s.slot) == (js.fi, js.slot)
            np.testing.assert_array_equal(s.idx.numpy(), np.asarray(js.idx))
            np.testing.assert_array_equal(s.mask.numpy(), np.asarray(js.mask))


def test_keep_parts_cuts_rows_and_inboxes():
    """A rank's rows: its partitions' factor rows and inbox rows, its own
    CSR over them; variables whole."""
    graph, _ = pba.build(pba.simulate(**BA), dtype=torch.float64, device="cpu")
    p = spmd.partition_graph(graph, 4)
    kept = spmd.keep_parts(p, 4, range(2, 4))
    fb, kfb = p.fblocks[0], kept.fblocks[0]
    m = fb.count // 4
    assert kfb.count == 2 * m
    assert torch.equal(kfb.z, fb.z[2 * m:]) and torch.equal(kfb.adj[1], fb.adj[1][2 * m:])
    rows, offsets = kfb.csr[1]
    assert torch.equal(kfb.adj[1][rows.long()].sort(stable=True).values,
                       kfb.adj[1][rows.long()])
    assert int(offsets[-1]) == 2 * m
    assert kept.vblocks is p.vblocks
    spec, kspec = p.inboxes[0][0], kept.inboxes[0][0]
    n = graph.vblocks[0].count
    assert torch.equal(kspec.idx, spec.idx[2 * n:]) and torch.equal(kspec.mask, spec.mask[2 * n:])


FORMS = ("covariance", "pallas")


def spmd_runs(comm):
    """30 sweeps of the BA scene on 8 partitions in both forms (comm None:
    one process)."""
    pg, pm, _ = port("ba")
    out = {}
    for form in FORMS:
        g, st = spmd.distribute(pg, pm, 8, device="cpu", comm=comm)
        st = spmd.make_run(g, 8, comm)(g, st, GBPConfig(**CFG, message_form=form), 30)
        out[form] = tuple(vs.mean for vs in st.v)
    return out


def spmd_worker(rank):
    return spmd_runs(multihost.global_comm(8, device="cpu"))


@pytest.fixture(scope="module")
def spmd_ranks():
    return spawn(spmd_worker, 2)


@pytest.mark.parametrize("form", FORMS)
def test_two_process_spmd_equals_one_process(spmd_ranks, form):
    want = spmd_runs(None)[form]
    for got in spmd_ranks:
        assert all(torch.equal(a, b) for a, b in zip(got[form], want))


def test_make_run_rejects_a_communicator_of_other_size():
    pg, pm, _ = port("ba")
    g, _ = spmd.distribute(pg, pm, 4, device="cpu")
    with pytest.raises(ValueError):
        spmd.make_run(g, 4, LocalComm(8))
