"""The port's multi-process communicator (gbp_tpu_torch/parallel/multihost.py)
on the CPU: two gloo processes started by `spawn`.

  * `DistComm` over 2 ranks x 2 partitions: all_gather, shift at offsets
    -2, -1, 1, 2 and all_reduce each equal `halo.LocalComm` on the same 4
    partitions bit for bit; 3 partitions over 2 ranks raise.
  * The halo paths across processes, mirroring tests/test_multihost.py: 2
    ranks x 4 partitions of the corridor (24 cameras, 12 landmarks each,
    plain layout, priors 1000), 15 sweeps of `halo` (covariance form) and
    `halo_cm` (kernels' plain versions here): the collected means equal the
    reference's 8-device `halo.distribute` / `halo_cm.distribute` run to
    rtol 1e-7, atol 1e-9 (the reference test's bar), and the port's
    single-process run on 8 partitions bit for bit; so do `energy_halo`,
    the halo schedules (wildfire, priority, random, a dead partition on
    rank 1) and the annealed halo runner, 5 sweeps each.

`spawn` is shared with tests/test_torch_spmd.py and test_torch_sharding.py:
the worker functions are module-level functions of those files, and the
children import the module they live in, so no module of these tests
imports JAX at its top (the reference is imported inside the tests).
"""
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gbp_tpu_torch.core import anneal
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.parallel import halo, halo_cm, multihost
from gbp_tpu_torch.parallel import schedules as hsched

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
CORRIDOR = dict(n_cams=24, lmks_per_cam=12, window=2, seed=2)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
SPAWN_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(fn, rank, world, init_method, out_dir, args):
    torch.set_num_threads(1)
    multihost.initialize(init_method, world, rank, backend="gloo", device="cpu")
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """fn(rank, *args) in `world` spawned processes joined in one gloo group
    (CPU tensors); returns each rank's result.  A rank that exits non-zero,
    or is still running after `timeout` seconds, fails the test (the others
    are killed)."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, init_method, out, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            assert not hung, f"ranks {hung} still running after {timeout} s"
            codes = [p.exitcode for p in procs]
            assert codes == [0] * world, f"exit codes {codes}"
            return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


# --- the communicator -----------------------------------------------------------------


OFFSETS = (-2, -1, 1, 2)


def blocks(n_parts=4):
    return torch.tensor(np.random.default_rng(0).standard_normal((n_parts, 3, 5)))


def comm_ops(comm, x):
    """The three collectives on the held partitions' rows of x."""
    mine = x[comm.parts.start:comm.parts.stop]
    out = {"all_gather": comm.all_gather(mine), "all_reduce": comm.all_reduce(mine)}
    out.update({f"shift{o}": comm.shift(mine, o) for o in OFFSETS})
    return out


def comm_worker(rank):
    comm = multihost.global_comm(4, device="cpu")
    out = {"parts": (comm.parts.start, comm.parts.stop), "transport": comm.transport,
           **comm_ops(comm, blocks())}
    try:
        multihost.DistComm(3, device="cpu")
        out["uneven raises"] = False
    except ValueError:
        out["uneven raises"] = True
    return out


@pytest.fixture(scope="module")
def comm_ranks():
    return spawn(comm_worker, 2)


@pytest.mark.parametrize("op", ["all_gather", "all_reduce", *(f"shift{o}" for o in OFFSETS)])
def test_dist_comm_equals_local_comm(comm_ranks, op):
    want = comm_ops(halo.LocalComm(4), blocks())[op]
    for rank, got in enumerate(comm_ranks):
        assert got["parts"] == (2 * rank, 2 * rank + 2) and got["transport"] == "gloo"
        assert torch.equal(got[op], want[2 * rank:2 * rank + 2])


def test_dist_comm_rejects_uneven_partitions(comm_ranks):
    assert all(r["uneven raises"] for r in comm_ranks)


# --- the halo paths across processes ---------------------------------------------------


def corridor():
    return pba.build(pba.simulate_corridor(**CORRIDOR), dtype=torch.float64, device="cpu",
                     layout="none", **PRIORS)


def halo_runs(comm):
    """The halo paths of the corridor on 8 partitions (comm None: one
    process, the single-process communicator), each collected to global
    means on every rank."""
    graph, means = corridor()
    cfg, cfgp = GBPConfig(**CFG), GBPConfig(**CFG, message_form="pallas")
    coll = comm if comm is not None else halo.LocalComm(8)
    gen = lambda: halo.distribute(graph, means, 8, device="cpu", comm=comm)
    cm = lambda: halo_cm.distribute(graph, means, 8, device="cpu", comm=comm)
    out = {}
    hp, st, run = gen()
    st = run(hp.hgraph, st, cfg, 15)
    out["halo"] = multihost.collect_means(hp, st, coll)
    out["energy"] = halo.energy_halo(hp, st, comm)
    hp, st, _ = gen()
    st = hsched.make_run_wildfire(hp, comm)(hp.hgraph, st, cfg, 5, 1e-4)
    out["wildfire"] = multihost.collect_means(hp, st, coll)
    hp, st, _ = gen()
    st = anneal.make_run_annealed_halo(hp, st, comm=comm)(hp.hgraph, st, cfg, 5, every=2)
    out["annealed"] = multihost.collect_means(hp, st, coll)
    hp, hcm, st, run = cm()
    st = run(hcm, st, cfgp, 15)
    out["halo_cm"] = multihost.collect_means(hp, st, coll)
    hp, hcm, st, _ = cm()
    st = hsched.make_run_priority_cm(hcm, 0.5, comm)(hcm, st, cfgp, 5)
    out["priority_cm"] = multihost.collect_means(hp, st, coll)
    hp, hcm, st, _ = cm()
    st = hsched.make_run_chip_dropout_cm(hcm, comm)(hcm, st, cfgp, 5, 5, 3)
    out["dropout_cm"] = multihost.collect_means(hp, st, coll)
    hp, hcm, st, _ = cm()
    gen_r = torch.Generator().manual_seed(0)
    st = hsched.make_run_random_cm(hcm, comm)(hcm, st, cfgp, 5, 0.7, gen_r)
    out["random_cm"] = multihost.collect_means(hp, st, coll)
    return out


def halo_worker(rank):
    return halo_runs(multihost.global_comm(8, device="cpu"))


@pytest.fixture(scope="module")
def halo_ranks():
    return spawn(halo_worker, 2)


@pytest.fixture(scope="module")
def halo_one_process():
    return halo_runs(None)


@pytest.mark.parametrize("what", ["halo", "energy", "wildfire", "annealed", "halo_cm",
                                  "priority_cm", "dropout_cm", "random_cm"])
def test_two_process_halo_equals_one_process(halo_ranks, halo_one_process, what):
    want = halo_one_process[what]
    for got in halo_ranks:
        if what == "energy":
            assert got[what] == want
        else:
            assert all(torch.equal(a, b) for a, b in zip(got[what], want))


@pytest.mark.parametrize("path", ["halo", "halo_cm"])
def test_two_process_halo_matches_reference(halo_ranks, path):
    """The reference's tests/test_multihost.py bar against its single-process
    8-device run (conftest: 8 virtual CPU devices)."""
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.parallel import halo as jhalo
    from gbp_tpu.parallel import halo_cm as jhalo_cm
    from gbp_tpu.parallel import sharding

    graph, means = jba.build(jba.simulate_corridor(**CORRIDOR), dtype=jnp.float64,
                             layout="none", **PRIORS)
    mesh = sharding.make_mesh(8)
    if path == "halo":
        hp, st, run = jhalo.distribute(graph, means, mesh)
        st = run(hp.hgraph, st, JConfig(**CFG), 15)
    else:
        hp, hcm, st, run = jhalo_cm.distribute(graph, means, mesh)
        st = run(hcm, st, JConfig(**CFG, message_form="pallas"), 15)
    want = jhalo.collect_means(hp, st)
    for got in halo_ranks:
        for a, b in zip(got[path], want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-9)
