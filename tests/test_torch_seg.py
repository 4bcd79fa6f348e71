"""The port's degree-class segmented layout (gbp_tpu_torch.core.sweep_cm:
`prepare_seg`, `sweep_seg`, the state converters and the dispatchers,
plain versions on the CPU) against the JAX reference's
(gbp_tpu/core/sweep_cm.py, Pallas with `interpret=True`).

Scenes: the reference's own test scene (tests/test_seg.py `_scene`: 2
blocks of 16 cameras, 30 landmarks a camera; exact classes, five, none
windowed), `blocks8` (8 x 40 cameras, auto classes: degrees 6 and 4, both
windowed) and `blocks7` (7 x 40 cameras, exact classes: 6, 5, 4 windowed,
3 and 2 not).  An unwindowed class stages the whole camera table in shared
memory, so `prepare_seg` declines where that table exceeds SMEM_TABLE_BYTES
(as the reference does at its VMEM gate): blocks7 in float64 (280 x 42 x 8 =
94,080 bytes) and blocks8 in exact mode; blocks7's classes are compared in
float32 (47,040 bytes).

Tolerances:
  prepare_seg: every integer exact (classes, degrees, rows, landmark
    counts and offsets, windows, the landmark order, the row map);
  one sweep from a common float64 state: 1e-10 relative on every message
    and mean;
  4 sweeps against the port's own single segment: 1e-9 (the order of the
    camera sums is the only difference), the linearization points equal;
  float32: against the reference's float64 sweep on the same
    float32-rounded state, within 2x the reference's own float32 error
    (tests/test_torch_window.py's rule);
  round trips and a resumed run: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.core.sweep import VariableState as JVar
from gbp_tpu.models import ba as jba
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import anneal, schedules
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PCFG = GBPConfig(**CFG)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
F32_OVER_REF = 2.0
SCENES = {
    "scene": (dict(n_blocks=2, n_cams=16, lmks_per_cam=30, window=3, seed=0, shuffle=True),
              "exact"),
    "blocks8": (dict(n_blocks=8, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True),
                "auto"),
    "blocks7": (dict(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True),
                "exact"),
}


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def port(name, dtype=torch.float64):
    kw, mode = SCENES[name]
    sim = pba.simulate_blocks(**kw)
    pg, pm = pba.build(sim, layout="ell", dtype=dtype, device="cpu", **PRIORS)
    return sim, pg, pm, P.prepare_seg(pg, classes_mode=mode)


def reference(sim, name, dtype=None):
    """The reference's graph, means and segmented graph of scene `name`
    (`sim`, its simulation), built once per module and dtype: the compiled
    sweep `_jsweep` is reused by every test of the scene."""
    return _reference(name, dtype or jnp.float64)


@functools.cache
def _reference(name, dtype):
    jg, jm = jba.build(pba.simulate_blocks(**SCENES[name][0]), layout="ell", dtype=dtype,
                       **PRIORS)
    return jg, jm, J.prepare_seg(jg, segsum_exact=True, classes_mode=SCENES[name][1])


# The reference's float64 sweep as one compiled program, shared by the tests
# of this module (an eager call compiles each of its operations apart, about
# twice the time; the results agree with it to roundoff).
_jsweep = jax.jit(J.sweep, static_argnums=2)


def jax_state(d, dtype=None):
    arr = lambda a: jnp.asarray(a, dtype)
    part = lambda f: J.CMFactorState(**{k: (tuple(arr(a) for a in v) if isinstance(v, tuple)
                                            else arr(v)) for k, v in f.items()})
    return J.CMState(v=tuple(JVar(**{k: arr(a) for k, a in v.items()}) for v in d["v"]),
                     f=tuple(part(f) for f in d["f"]))


@pytest.fixture(scope="module")
def scene():
    return port("scene")


@pytest.fixture(scope="module")
def blocks8():
    return port("blocks8")


# --- tests/test_seg.py's three, on the port --------------------------------------


def test_seg_matches_single_segment_trajectory(scene):
    _, pg, pm, sg = scene
    cmg = P.prepare(pg, window=True)
    assert isinstance(sg, P.CMSegGraph) and len(sg.parts) >= 2
    assert all(p.mp % p.deg == 0 and p.nv * p.deg == p.mp for p in sg.parts)
    s1, s2 = P.init_state(cmg, pm), P.init_state(sg, pm)
    for _ in range(4):
        s1, s2 = P.sweep(cmg, s1, PCFG), P.sweep(sg, s2, PCFG)
    g1, g2 = P.to_gbp_state(cmg, s1), P.to_gbp_state(sg, s2)
    for a, b in zip(g1.v, g2.v):
        assert (a.mean - b.mean).abs().max() <= 1e-9
    for k in range(2):
        a, b = g1.f[0].msg_eta[k], g2.f[0].msg_eta[k]
        assert (a - b).abs().max() <= 1e-9 * max(float(a.abs().max()), 1.0)
    assert torch.equal(g1.f[0].linpoint, g2.f[0].linpoint)
    # Clone rows carry zero messages (the layout's validity invariant).
    valid = pg.fblocks[0].valid
    assert not g2.f[0].msg_eta[0][~valid].any()


def test_seg_gbp_state_roundtrip_exact(scene):
    _, _, pm, sg = scene
    s = P.run(sg, P.init_state(sg, pm), PCFG, 3)
    s2 = P.from_gbp_state(sg, P.to_gbp_state(sg, s))
    # Every class's rows come back bit for bit; its padded rows restart
    # from zero (their srel counts sweeps they were inert, nothing reads it).
    for p, a, b in zip(sg.parts, s.f, s2.f):
        for x, y in zip(checkpoint._leaves(a, "", {}).values(),
                        checkpoint._leaves(b, "", {}).values()):
            assert torch.equal(x[:, :p.m], y[:, :p.m]) and not y[:, p.m:].any()
    a, b = P.sweep(sg, s, PCFG), P.sweep(sg, s2, PCFG)
    for va, vb in zip(a.v, b.v):
        assert torch.equal(va.mean, vb.mean)


def test_seg_run_dispatch_and_fallback(scene):
    """prepare(segment=True) on the small scene: the auto classes save too
    few rows, so it falls back to the single segment; a forced segmented
    graph rides run() through the dispatcher."""
    _, pg, pm, sg = scene
    cmg = P.prepare(pg, window=True, segment=True)
    assert isinstance(cmg, P.CMGraph) and P.prepare_seg(pg) is None
    out = P.run(sg, P.init_state(sg, pm), PCFG, 2)
    assert isinstance(out.f, tuple) and len(out.f) == len(sg.parts)
    assert all(torch.isfinite(v.mean).all() for v in out.v)


# --- prepare_seg against the reference ---------------------------------------------


@pytest.mark.parametrize("name,dtype", [("scene", torch.float64), ("blocks8", torch.float64),
                                        ("blocks7", torch.float32)])
def test_prepare_seg_matches_reference(name, dtype):
    sim, pg, _, sg = port(name, dtype)
    jg, _, js = reference(sim, name, {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype])
    assert sg is not None and js is not None and len(sg.parts) == len(js.parts)
    for p, q in zip(sg.parts, js.parts):
        assert (p.deg, p.mp, p.nv, p.n_groups, p.v0, p.m, p.win_w) == (
            q.deg, q.mp, q.nv, q.n_groups, q.v0, q.m, q.win_w)
        np.testing.assert_array_equal(p.rows.numpy(), np.asarray(q.rows))
        np.testing.assert_array_equal(p.gidx.numpy(), np.asarray(q.gidx_cm).reshape(-1))
        np.testing.assert_array_equal(p.act.numpy(), np.asarray(q.act).reshape(1, -1))
        if q.win_w:
            np.testing.assert_array_equal(p.win_starts.numpy(), np.asarray(q.win_starts))
        else:
            assert p.win_starts is None and p.seg_rows is not None
    np.testing.assert_array_equal(sg.vperm.numpy(), np.asarray(js.vperm))
    np.testing.assert_array_equal(sg.vinv.numpy(), np.asarray(js.vinv))
    np.testing.assert_array_equal(sg.inv_map.numpy(), np.asarray(js.inv_map))
    assert sg.mp == js.mp
    # The relabelled landmark priors.
    li = pg.fblocks[0].vblocks[pg.fblocks[0].ell_slot]
    np.testing.assert_array_equal(sg.base.vblocks[li].prior_eta.numpy(),
                                  np.asarray(js.base.vblocks[li].prior_eta))
    expected = {"scene": [6, 5, 4, 3, 2], "blocks8": [6, 4], "blocks7": [6, 5, 4, 3, 2]}[name]
    assert [p.deg for p in sg.parts] == expected
    assert [bool(p.win_w) for p in sg.parts] == {
        "scene": [False] * 5, "blocks8": [True, True],
        "blocks7": [True, True, True, False, False]}[name]


def test_prepare_seg_declines_as_the_reference_and_at_the_table_gate():
    """Where the reference declines, so does the port (blocks7 in auto mode,
    the prepare(segment=True) fallback); where an unwindowed class's camera
    table exceeds the full-table kernels' shared memory, the port declines
    and the reference (its 4 MB VMEM gate) does not: blocks7 exact in
    float64, blocks8 exact in either dtype."""
    sim, pg, _, sg = port("blocks7")
    jg, _, js = reference(sim, "blocks7")
    assert J.prepare_seg(jg, segsum_exact=True) is None and P.prepare_seg(pg) is None
    assert isinstance(P.prepare(pg, segment=True), P.CMGraph)
    assert js is not None and sg is None
    assert 280 * M.F_CAM * 8 > M.SMEM_TABLE_BYTES >= 280 * M.F_CAM * 4
    _, p8, _, _ = port("blocks8", torch.float32)
    assert P.prepare_seg(p8, classes_mode="exact") is None


# --- sweeps --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["scene", "blocks8"])
def test_one_sweep_matches_reference(name):
    """One sweep from a common float64 state (the port's after 9 sweeps),
    handed to the reference through `interop`: unwindowed classes (scene)
    and windowed ones (blocks8)."""
    sim, pg, pm, sg = port(name)
    _, _, js = reference(sim, name)
    st = P.run(sg, P.init_state(sg, pm), PCFG, 9)
    jst = jax_state(interop.cm_state_to_numpy(st))
    ref = _jsweep(js, jst, JConfig(message_form="pallas", **CFG))
    got = P.sweep(sg, st, PCFG)
    for pv, jv in zip(got.v, ref.v):
        assert rel(pv.mean, jv.mean) <= 1e-10 and rel(pv.eta, jv.eta) <= 1e-10
    for pf, jf in zip(got.f, ref.f):
        for a, b in zip(pf.msg_eta + pf.msg_lam, jf.msg_eta + jf.msg_lam):
            assert rel(a, b) <= 1e-10
        assert rel(pf.lp, jf.lp) <= 1e-10 and torch.equal(pf.srel.flatten(), torch.tensor(
            np.asarray(jf.srel)).flatten())


@pytest.mark.parametrize("name", ["blocks8", "blocks7"])
def test_float32_within_reference_error(name):
    """One float32 sweep of the port and of the reference from one
    float32-rounded state, each against the reference's float64 sweep from
    that state: the port's error within 2x the reference's own."""
    sim, pg, pm, sg = port(name, torch.float32)
    _, _, j64 = reference(sim, name)
    _, _, j32 = reference(sim, name, jnp.float32)
    st = P.run(sg, P.init_state(sg, pm), PCFG, 9)
    d = interop.cm_state_to_numpy(st)
    want = _jsweep(j64, jax_state(d, jnp.float64), JConfig(message_form="pallas", **CFG))
    ref = J.sweep(j32, jax_state(d, jnp.float32), JConfig(message_form="pallas", **CFG))
    got = P.sweep(sg, st, PCFG)
    pairs = [(g.mean, r.mean, w.mean) for g, r, w in zip(got.v, ref.v, want.v)]
    for gf, rf, wf in zip(got.f, ref.f, want.f):
        pairs += list(zip(gf.msg_eta + gf.msg_lam, rf.msg_eta + rf.msg_lam,
                          wf.msg_eta + wf.msg_lam))
    for g, r, w in pairs:
        assert g.dtype == torch.float32
        w = np.asarray(w, np.float64)
        assert rel(g.double(), w) <= F32_OVER_REF * rel(np.asarray(r, np.float64), w)


# --- state converters, checkpoints, guards ---------------------------------------------


def test_checkpoint_resume_bit_for_bit(scene, tmp_path):
    """A checkpoint of a segmented run (through `to_gbp_state`) resumes
    through the dispatched `from_gbp_state`, equal to the uninterrupted run
    bit for bit."""
    _, _, pm, sg = scene
    ref = P.run(sg, P.init_state(sg, pm), PCFG, 12)
    mid = P.run(sg, P.init_state(sg, pm), PCFG, 6)
    checkpoint.save(tmp_path / "seg", P.to_gbp_state(sg, mid))
    template = P.to_gbp_state(sg, P.init_state(sg, pm))
    resumed = P.run(sg, P.from_gbp_state(sg, checkpoint.restore(tmp_path / "seg", template)),
                    PCFG, 6)
    a, b = P.to_gbp_state(sg, resumed), P.to_gbp_state(sg, ref)
    for x, y in zip(checkpoint._leaves(a, "", {}).values(), checkpoint._leaves(b, "", {}).values()):
        assert torch.equal(x, y)


def test_interop_roundtrip_and_reference_conversion(scene):
    """The per-class factor states go to the reference's [F, T_s, 128] and
    back leaf for leaf, and the reference's `to_gbp_state_seg` of them
    equals the port's `to_gbp_state`."""
    sim, _, pm, sg = scene
    _, _, js = reference(sim, "scene")
    st = P.run(sg, P.init_state(sg, pm), PCFG, 5)
    jst = jax_state(interop.cm_state_to_numpy(st))
    again = interop.cm_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for x, y in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(st))):
        assert torch.equal(x, y)
    jg, pgs = J.to_gbp_state(js, jst), P.to_gbp_state(sg, st)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tuple(pgs))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("who", ["sweep_active", "anneal", "wildfire", "priority", "random"])
def test_single_segment_guards(scene, who):
    """Schedule masks, the annealed runner and the CM schedules take the
    single segment: each raises ValueError naming it on a segmented graph
    (the reference asserts for masks and fails on the others)."""
    _, _, pm, sg = scene
    st = P.init_state(sg, pm)
    with pytest.raises(ValueError, match="single-segment layout"):
        if who == "sweep_active":
            P.sweep(sg, st, PCFG, active=torch.ones(1, sg.mp, dtype=torch.bool))
        elif who == "anneal":
            anneal.run_annealed_cm(sg, st, PCFG, 2)
        elif who == "wildfire":
            schedules.run_wildfire_cm(sg, st, PCFG, 2, tau=1e-4)
        elif who == "priority":
            schedules.run_priority_cm(sg, st, PCFG, 2, frac=0.5)
        else:
            schedules.run_random_cm(sg, st, PCFG, 2, 0.7, torch.Generator().manual_seed(0))


def test_sweep_launches_each_class_kernels(blocks8, scene):
    """A segmented sweep runs, per class, the windowed kernels (blocks8:
    11, 10, 16, 15 twice) or the full-table ones (the scene: 1, 2, 3 five
    times): their plain versions here."""
    for (_, _, pm, sg), want in ((blocks8, dict.fromkeys(
            ("relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
             "scatter_windows_cm"), 2)), (scene, dict.fromkeys(
            ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id"), 5))):
        st = P.init_state(sg, pm)
        M.COUNTS.reset()
        P.sweep(sg, st, PCFG)
        assert {k: v for k, v in M.COUNTS.plain.items() if v} == want
