"""The owner-sharded halo partition and its generic sweep (parallel/halo.py)
against the reference's (gbp_tpu/parallel/halo.py, on a mesh of CPU devices).

`partition` is host numpy: owners, local ids, ghost lists, the exchange
wiring, the modes and the collective volume must equal the reference's.
The generic sweep runs the P partitions in one process through the
single-process communicator; its means, after sweeps through the
all_gather exchange, the per-offset permute exchange and with the exchange
skipped, must equal the reference's to 1e-7 relative (the reference's own
bar for its halo paths; the partial sums add in another order).  The
energy, the prior weakening, the anchor masks of the annealing and the
state converters are held the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import anneal as janneal
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.models import ba as jba
from gbp_tpu.models import pose_graph as jpg
from gbp_tpu.parallel import halo as jhalo
from gbp_tpu.parallel import halo_cm as jhalo_cm
from gbp_tpu.parallel import sharding
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import anneal
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.parallel import halo

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8, message_form="pallas")
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
COMM = ("recv_src", "recv_tgt", "recv_mask", "bnd_idx", "ghost_src", "ghost_mask")
PERM = ("cat_tgt", "perm_ghost_src")
STATIC = ("n_own_max", "n_ghost_max", "b_max", "r_max", "mode", "offsets_out", "offsets_in")


def graphs(kind):
    """(reference graph, means, port graph, means), plain layout, float64."""
    if kind == "corridor16":
        kw = dict(n_cams=16, lmks_per_cam=8, window=2, seed=3)
        return (*jba.build(jba.simulate_corridor(**kw), dtype=jnp.float64, **PRIORS),
                *pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu",
                           **PRIORS))
    if kind == "corridor12":
        kw = dict(n_cams=12, lmks_per_cam=6, window=2, seed=4)
        return (*jba.build(jba.simulate_corridor(**kw), dtype=jnp.float64, **PRIORS),
                *pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu",
                           **PRIORS))
    if kind == "blocks1280":
        kw = dict(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
        return (*jba.build(jba.simulate_blocks(**kw), dtype=jnp.float64, **PRIORS),
                *pba.build(pba.simulate_blocks(**kw), dtype=torch.float64, device="cpu",
                           **PRIORS))
    kw = dict(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0)
    return (*jpg.build(jpg.simulate_manhattan(**kw), dtype=jnp.float64),
            *ppg.build(ppg.simulate_manhattan(**kw), dtype=torch.float64, device="cpu"))


def assert_same_partition(jhp, php):
    for name in ("owned_ids", "owned_valid", "ghost_ids", "fb_src_rows"):
        for a, b in zip(getattr(jhp, name), getattr(php, name)):
            np.testing.assert_array_equal(a, b)
    for jfb, pfb in zip(jhp.hgraph.fblocks, php.hgraph.fblocks):
        for a, b in zip(jfb.adj, pfb.adj):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(jfb.valid), pfb.valid.numpy())
        np.testing.assert_array_equal(np.asarray(jfb.z), pfb.z.numpy())
        assert jfb.n_valid == pfb.n_valid
    for jvb, pvb in zip(jhp.hgraph.vblocks, php.hgraph.vblocks):
        np.testing.assert_array_equal(np.asarray(jvb.prior_lam), pvb.prior_lam.numpy())
    for jc, pc in zip(jhp.hgraph.comm, php.hgraph.comm):
        assert all(getattr(jc, k) == getattr(pc, k) for k in STATIC)
        for k in COMM + (PERM if jc.mode == "permute" else ()):
            np.testing.assert_array_equal(np.asarray(getattr(jc, k)), getattr(pc, k).numpy())
        if jc.mode == "permute":
            for k in ("send_idx", "send_mask", "bsend_idx"):
                for a, b in zip(getattr(jc, k), getattr(pc, k)):
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jhalo.collective_bytes(jhp) == halo.collective_bytes(php)


@pytest.mark.parametrize("kind,n_parts,mode", [
    ("corridor16", 2, "auto"), ("corridor16", 4, "gather"), ("corridor16", 4, "permute"),
    ("blocks1280", 2, "auto"), ("blocks1280", 4, "auto"), ("manhattan120", 2, "auto"),
    ("manhattan120", 4, "permute")])
def test_partition_matches_reference(kind, n_parts, mode):
    jg, _, pg, _ = graphs(kind)
    assert_same_partition(jhalo.partition(jg, n_parts, comm_mode=mode),
                          halo.partition(pg, n_parts, comm_mode=mode))


def test_partition_with_order_keys_matches_reference():
    """The per-partition locality order of halo_cm's windows."""
    from gbp_tpu_torch.parallel import halo_cm

    jg, _, pg, _ = graphs("blocks1280")
    jk, pk = jhalo_cm._ell_order_keys(jg), halo_cm._ell_order_keys(pg)
    assert jk.keys() == pk.keys()
    np.testing.assert_array_equal(jk[1], pk[1])
    assert_same_partition(jhalo.partition(jg, 2, order_keys=jk),
                          halo.partition(pg, 2, order_keys=pk))


# --- the generic sweep -------------------------------------------------------------------


@pytest.fixture(scope="module")
def corridor12():
    return graphs("corridor12")


def rel_means(port, ref):
    return max(np.abs(p.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max()
               for p, r in zip(port, ref))


@pytest.mark.parametrize("mode,skip", [("auto", False), ("gather", False), ("auto", True)],
                         ids=["permute", "gather", "skip_exchange"])
def test_generic_halo_sweep_matches_reference(corridor12, mode, skip):
    jg, jm, pg, pm = corridor12
    mesh = sharding.make_mesh(2)
    jhp = jhalo.partition(jg, 2, comm_mode=mode)
    jst = jhalo.init_state(jhp, jm)
    jst = jhalo.make_run(mesh, jhp, jst, skip_exchange=skip)(jhp.hgraph, jst, JConfig(**CFG), 8)
    php = halo.partition(pg, 2, comm_mode=mode)
    assert [c.mode for c in php.hgraph.comm] == ["gather", "permute" if mode == "auto" else
                                                 "gather"]
    pst = halo.init_state(php, pm)
    pst = halo.make_run(php, skip_exchange=skip)(php.hgraph, pst, GBPConfig(**CFG), 8)
    assert rel_means(halo.collect_means(php, pst), jhalo.collect_means(jhp, jst)) <= 1e-7
    if not skip:
        for a, b in zip(pst.ghost, jst.ghost):
            assert np.abs(a.mean.numpy() - np.asarray(b.mean)).max() <= 1e-7 * np.abs(
                np.asarray(b.mean)).max()
    if mode == "auto" and not skip:
        e, je = halo.energy_halo(php, pst), jhalo.energy_halo(jhp, jst, mesh)
        assert abs(e - je) <= 1e-9 * abs(je)


def test_distribute_and_converters(corridor12):
    """distribute runs on the asked device; its state converts to numpy,
    into the reference's HaloState, and back leaf for leaf."""
    jg, jm, pg, pm = corridor12
    php, pst, run = halo.distribute(pg, pm, 2, device="cpu")
    pst = run(php.hgraph, pst, GBPConfig(**CFG), 3)
    d = interop.halo_state_to_numpy(pst)
    back = interop.halo_state_from_numpy(jax.tree.map(np.asarray, jhalo.HaloState(
        v=tuple(jhalo.VariableState(**v) for v in d["v"]),
        ghost=tuple(jhalo.VariableState(**v) for v in d["ghost"]),
        f=tuple(jhalo.FactorState(**f) for f in d["f"]))), device="cpu")
    for a, b in zip(jax.tree.leaves(tuple(pst)), jax.tree.leaves(tuple(back))):
        assert torch.equal(a, b)


def test_weaken_priors_and_anchor_masks_match_reference(corridor12):
    jg, jm, pg, pm = corridor12
    jhp, php = jhalo.partition(jg, 2), halo.partition(pg, 2)
    keep = ((0, (0, 1, 5), (0, 3)),)
    jhp, php = jhalo.weaken_priors(jhp, 0.1, keep=keep), halo.weaken_priors(php, 0.1, keep=keep)
    for jv, pv in zip(jhp.hgraph.vblocks, php.hgraph.vblocks):
        np.testing.assert_array_equal(np.asarray(jv.prior_lam), pv.prior_lam.numpy())
        np.testing.assert_array_equal(np.asarray(jv.prior_eta), pv.prior_eta.numpy())
    for a, b in zip(janneal.halo_anchor_masks(jhp), anneal.halo_anchor_masks(php)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert anneal.halo_anchor_masks(php)[0].any()
