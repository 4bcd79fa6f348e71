"""The component-major fast path under halo partitioning
(parallel/halo_cm.py): `prepare`'s decisions against the reference's
(gbp_tpu/parallel/halo_cm.py), the table path against the reference's on a
mesh of CPU devices, the windowed paths against the port's single-device
windowed sweep, pose graphs and 9-dof cameras against the single-device
fast path, the annealed run and the command line.

Tolerances: 1e-7 relative on the means (the reference's own bar for its
halo paths, tests/test_halo_cm.py: the same synchronous sweep, with partial
sums and the exchange adding in another order), 1e-9 absolute on pose
means (as there); the command line's final ARE in float32 within 1e-3 px of
the one-device run.  The windows, cut lists and remapped ids of `prepare`
equal the reference's exactly; at 4,000 poses the reference stages the
whole pose table (its 4 MB gate) where the port's 48 KB of shared memory
sends the graph to "rows", a documented departure.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.models import ba as jba
from gbp_tpu.models import pose_graph as jpg
from gbp_tpu.parallel import halo as jhalo
from gbp_tpu.parallel import halo_cm as jhcm
from gbp_tpu.parallel import sharding
from gbp_tpu_torch import ba as cli
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import anneal, sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.io import bal
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8, message_form="pallas")
PCFG = GBPConfig(**CFG)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
BLOCKS = dict(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
WINDOWED = {True: ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell"),
            False: ("relin_cm_tabblkg", "messages_cm_tabblkg", "expand_ell_blk")}


def rel_means(port, ref):
    return max(np.abs(p.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max()
               for p, r in zip(port, ref))


@pytest.fixture(scope="module")
def blocks():
    """The 32 x 40-camera blocks scene (1,280 cameras, 8 landmarks per
    camera) in both packages, plain layout, and the port's ELL build."""
    jg, jm = jba.build(jba.simulate_blocks(**BLOCKS), dtype=jnp.float64, **PRIORS)
    sim = pba.simulate_blocks(**BLOCKS)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", **PRIORS)
    pe, pme = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    return jg, jm, pg, pm, pe, pme


def test_prepare_windows_match_reference(blocks):
    jg, _, pg, _, _, _ = blocks
    jhp = jhalo.partition(jg, 2, order_keys=jhcm._ell_order_keys(jg))
    php = halo.partition(pg, 2, order_keys=halo_cm._ell_order_keys(pg))
    jc, _ = jhcm.prepare(jhp, segsum_exact=True)
    pc, rows = halo_cm.prepare(php)
    assert (pc.gather_mode, pc.win_w, pc.win_ngp, pc.win_ncut, pc.mp, pc.nv, pc.deg, pc.e,
            pc.ell_fused) == (jc.gather_mode, jc.win_w, jc.win_ngp, jc.win_ncut, jc.mp, jc.nv,
                              jc.deg, jc.e, jc.ell_fused) == ("table", 128, 128, 8, 30720, 5120,
                                                              6, 1, True)
    np.testing.assert_array_equal(np.asarray(jc.win_starts), pc.win_starts.numpy())
    np.testing.assert_array_equal(np.asarray(jc.cut_ids), pc.cut_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jc.gidx_rm), pc.gidx.numpy())
    np.testing.assert_array_equal(np.asarray(jc.gidx_ghost_cm).reshape(2, -1),
                                  pc.gidx_ghost.numpy())
    np.testing.assert_array_equal(np.asarray(jc.act).reshape(2, 1, -1), pc.act.numpy())
    # The cut cameras the boundary landmarks read: real entries first, then
    # the reference's zero padding.
    assert sum(pc.n_cut) > 0
    assert all((pc.cut_ids[c, k:] == 0).all() for c, k in enumerate(pc.n_cut))


def test_prepare_table_and_gate_departure():
    """The corridor at P = 2: "table" in both packages, with the same ELL
    layout.  The 4,000-pose graph at P = 2: slot 1 gathered (equal counts);
    the reference stages its 2,081-pose table (4 MB gate), the port's 99,888
    bytes are beyond 48 KB of shared memory and no window engages, so it
    takes "rows"."""
    kw = dict(n_cams=16, lmks_per_cam=8, window=2, seed=3)
    jg, _ = jba.build(jba.simulate_corridor(**kw), dtype=jnp.float64, **PRIORS)
    pg, _ = pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu", **PRIORS)
    jc, jrows = jhcm.prepare(jhalo.partition(jg, 2), segsum_exact=True)
    pc, prows = halo_cm.prepare(halo.partition(pg, 2))
    assert (pc.gather_mode, pc.ell_fused, pc.win_w, pc.mp, pc.deg) == (
        jc.gather_mode, jc.ell_fused, jc.win_w, jc.mp, jc.deg)
    np.testing.assert_array_equal(np.asarray(jc.gidx_rm), pc.gidx.numpy())
    np.testing.assert_array_equal(jrows, prows)

    kw = dict(n_poses=4000, seed=0, loop_prob=0.3, loop_radius=3.0)
    jg, _ = jpg.build(jpg.simulate_manhattan(**kw), dtype=jnp.float32)
    pg, _ = ppg.build(ppg.simulate_manhattan(**kw), dtype=torch.float32, device="cpu")
    jc, _ = jhcm.prepare(jhalo.partition(jg, 2), segsum_exact=True)
    pc, _ = halo_cm.prepare(halo.partition(pg, 2))
    assert (jc.gather_mode, pc.gather_mode) == ("table", "rows")
    assert jc.e == pc.e == 0 and jc.deg == pc.deg and jc.mp == pc.mp and pc.huber == "row"
    assert jc.win_w == pc.win_w == 0
    np.testing.assert_array_equal(np.asarray(jc.gidx_rm), pc.gidx.numpy())


# --- paths ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corridor12():
    kw = dict(n_cams=12, lmks_per_cam=6, window=2, seed=4)
    return (*jba.build(jba.simulate_corridor(**kw), dtype=jnp.float64, **PRIORS),
            *pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu",
                       **PRIORS))


@pytest.mark.parametrize("fused,mode", [(True, "auto"), (False, "gather")],
                         ids=["fused_permute", "unfused_gather"])
def test_table_path_matches_reference(corridor12, fused, mode):
    jg, jm, pg, pm = corridor12
    mesh = sharding.make_mesh(2)
    jhp, jh, jst, jrun = jhcm.distribute(jg, jm, mesh, comm_mode=mode, ell_fused=fused)
    php, ph, pst, prun = halo_cm.distribute(pg, pm, 2, device="cpu", comm_mode=mode,
                                            ell_fused=fused)
    assert (ph.gather_mode, ph.ell_fused) == (jh.gather_mode, jh.ell_fused) == ("table", fused)
    jst, pst = jrun(jh, jst, JConfig(**CFG), 5), prun(ph, pst, PCFG, 5)
    assert rel_means(halo.collect_means(php, pst), jhalo.collect_means(jhp, jst)) <= 1e-7
    # One more sweep from the port's state, handed to the reference through
    # the converters: the same state feeds both packages.
    d = interop.halo_cm_state_to_numpy(pst)
    jst2 = jhcm.HaloCMState(
        v=tuple(jhalo.VariableState(**{k: jnp.asarray(a) for k, a in v.items()})
                for v in d["v"]),
        ghost=tuple(jhalo.VariableState(**{k: jnp.asarray(a) for k, a in v.items()})
                    for v in d["ghost"]),
        f=jhcm.CMFactorState(**{k: jax.tree.map(jnp.asarray, a) for k, a in d["f"].items()}))
    back = interop.halo_cm_state_from_numpy(jax.tree.map(np.asarray, jst2), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(tuple(pst)),
                                                jax.tree.leaves(tuple(back))))
    jst2 = jrun(jh, jst2, JConfig(**CFG), 1)
    pst = prun(ph, pst, PCFG, 1)
    assert rel_means(halo.collect_means(php, pst), jhalo.collect_means(jhp, jst2)) <= 1e-9


def test_skip_exchange_matches_reference(corridor12):
    jg, jm, pg, pm = corridor12
    mesh = sharding.make_mesh(2)
    jhp, jh, jst, _ = jhcm.distribute(jg, jm, mesh)
    jst = jhcm.make_run(mesh, jh, jst, skip_exchange=True)(jh, jst, JConfig(**CFG), 5)
    php, ph, pst, _ = halo_cm.distribute(pg, pm, 2, device="cpu")
    pst = halo_cm.make_run(ph, skip_exchange=True)(ph, pst, PCFG, 5)
    assert rel_means(halo.collect_means(php, pst), jhalo.collect_means(jhp, jst)) <= 1e-7


@pytest.fixture(scope="module")
def single_windowed(blocks):
    _, _, _, _, pe, pme = blocks
    cmg = sweep_cm.prepare(pe)
    assert cmg.win_w
    return sweep_cm.to_gbp_state(cmg, sweep_cm.run(cmg, sweep_cm.init_state(cmg, pme), PCFG, 8))


@pytest.mark.parametrize("fused", [True, False], ids=["ell_fused", "unfused"])
def test_windowed_path_matches_single_device(blocks, single_windowed, fused):
    _, _, pg, pm, _, _ = blocks
    php, ph, pst, prun = halo_cm.distribute(pg, pm, 2, device="cpu", ell_fused=fused)
    assert ph.win_w == 128 and ph.ell_fused == fused
    # Linearized at the means: every real row's adjacent means are its lp
    # (cut rows read their owned camera back).
    on = ph.act[:, 0] > 0.5
    assert torch.equal(halo_cm.expand_means(ph, pst).transpose(1, 2)[on],
                       pst.f.lp.transpose(1, 2)[on])
    M.COUNTS.reset()
    pst = prun(ph, pst, PCFG, 8)
    used = {k for k, v in M.COUNTS.plain.items() if v}
    assert set(WINDOWED[fused]) | {"segsum_cm_blk", "scatter_windows_cm", "segsum_by_id"} == used
    assert all(M.COUNTS.plain[k] == 2 * 8 for k in used)
    assert rel_means(halo.collect_means(php, pst), [v.mean for v in single_windowed.v]) <= 1e-7


def test_pose_graph_matches_single_device():
    """Same-block factors with per-row Huber thresholds: the two slots' sums
    combine before one exchange (slot 1 gathered)."""
    sim = ppg.simulate_manhattan(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0)
    cfg = ppg.default_config()
    g, m = ppg.build(sim, dtype=torch.float64, device="cpu")
    ge, me = ppg.build(sim, dtype=torch.float64, device="cpu", layout="ell")
    cmg = sweep_cm.prepare(ge)
    single = sweep_cm.run(cmg, sweep_cm.init_state(cmg, me), cfg, 25)
    hp, hcm, st, run = halo_cm.distribute(g, m, 2, device="cpu")
    assert hcm.vb_e == hcm.vb_g and hcm.huber == "row" and hcm.e == 0
    st = run(hcm, st, cfg, 25)
    got = halo.collect_means(hp, st)[0]
    assert np.abs(got.numpy() - single.v[0].mean.numpy()).max() <= 1e-9


def test_nine_dof_cameras_match_single_device():
    sim = bal.to_sim(bal.prune(bal.read_bal("data/toy_ba.txt")))
    g, m, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu", optimize_intrinsics=True)
    ge, me, _ = pba.build_bal(sim, dtype=torch.float64, device="cpu", layout="ell",
                              optimize_intrinsics=True)
    cmg = sweep_cm.prepare(ge)
    single = sweep_cm.to_gbp_state(cmg, sweep_cm.run(cmg, sweep_cm.init_state(cmg, me), PCFG,
                                                     12))
    hp, hcm, st, run = halo_cm.distribute(g, m, 2, device="cpu")
    assert hcm.dofs == (9, 3) and hcm.gather_mode == "table"
    st = run(hcm, st, PCFG, 12)
    assert rel_means(halo.collect_means(hp, st), [v.mean for v in single.v]) <= 1e-7


def test_annealed_run_matches_single_device(corridor12):
    _, _, pg, pm = corridor12
    kw = dict(n_cams=12, lmks_per_cam=6, window=2, seed=4)
    ge, me = pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu",
                       layout="ell", **PRIORS)
    cmg = sweep_cm.prepare(ge)
    sched = dict(every=4, factor=0.1, times=2, damp_window=4, damp_lam=0.4)
    single = anneal.run_annealed_cm(cmg, sweep_cm.init_state(cmg, me), PCFG, 12, **sched)
    single = sweep_cm.to_gbp_state(cmg, single)
    hp, hcm, st, _ = halo_cm.distribute(pg, pm, 2, device="cpu")
    run = anneal.make_run_annealed_halo(hp, st)
    for i0 in (0, 6):  # two calls continue the schedule
        st = run(hcm, st, PCFG, 6, i0=i0, **sched)
    assert rel_means(halo.collect_means(hp, st), [v.mean for v in single.v]) <= 1e-7
    # The generic partition anneals the same way.
    php, pst, _ = halo.distribute(pg, pm, 2, device="cpu")
    gst = anneal.make_run_annealed_halo(php, pst)(php.hgraph, pst, PCFG, 12, **sched)
    assert rel_means(halo.collect_means(php, gst), [v.mean for v in single.v]) <= 1e-7


def test_full_precision_stays_on_the_generic_path():
    sim = ppg.simulate_helix(n_poses=24, seed=0)
    sim["edges_info"][0, 0, 1] = sim["edges_info"][0, 1, 0] = 0.1
    g, m = ppg.build_g2o(sim, dtype=torch.float64, device="cpu")
    assert g.fblocks[0].prec.ndim == 3
    assert halo_cm.distribute(g, m, 2, device="cpu") is None


LINE = re.compile(r"sweep\s+(\d+): avg reprojection error\s+([-\d.]+) px")


def test_cli_runs_two_partitions(capsys):
    argv = ["--bal_file", "data/toy_ba.txt", "--n_iters", "30", "--device", "cpu"]
    two = cli.main([*argv, "--n_chips", "2"])
    text = capsys.readouterr().out
    assert "path: halo_cm (owner-sharded, per-chip CM fast path) on 2 partitions of cpu" in text
    assert [int(i) for i, _ in LINE.findall(text)] == [0, 10, 20, 30]
    one = cli.main(argv)
    assert two["hp"].n_chips == 2 and two["hcm"].gather_mode == "table"
    assert abs(two["are"][-1][1] - one["are"][-1][1]) <= 1e-3
    assert two["are"][0][1] == pytest.approx(one["are"][0][1], rel=1e-6)
