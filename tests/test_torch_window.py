"""The port's windowed large-scene path (gbp_tpu_torch: corridor / merged
blocks scenes, camera windows, locality sort, the four windowed kernels'
plain versions on the CPU) against the JAX reference, on scenes of 280-320
cameras where the windows engage.  The reference's Pallas kernels run as
its own CPU tests run them, with `interpret=True`.

Scenes and `prepare` are compared on single corridors and merged blocks.
The numeric checks run on 7 merged blocks of 40 cameras (280 cameras, ids
shuffled, so the locality sort engages; 280 x 42 floats also fit the
full-table kernels): a single long corridor diverges under the plain
schedule in both packages (ARE of hundreds of pixels by sweep 8 in float64,
non-finite in float32), which leaves nothing to compare.

Tolerances, relative to each output's magnitude unless said otherwise:
  scenes: ids exact, values 1e-12 (one rotation logarithm goes through
    torch on one side and XLA on the other);
  prepare: every integer (windows, permutations, row counts) exact;
  relinearization 1e-12, messages and window partials 1e-10 in float64
    (6x6 cavity inverses amplify operation-order roundoff), 1e-4 in float32;
  scatter_windows_cm 1e-12 absolute in float64 against a dense accumulation
    (the same addends in the same order), 1e-5 in float32;
  one sweep from a common state 1e-10; 6 sweeps 1e-6 absolute on the means
    (beta-threshold relinearization amplifies roundoff);
  float32 against float64 on the same float32-rounded inputs, not against
    the reference's float32 (two float32 results differ by as much as each
    differs from float64, and by how much depends on the CPU): the messages
    within 2x the reference's own float32 error, the ARE after 15 sweeps
    within 3x (measured: the port's error at most 1.01x the reference's for
    every message output, 1.43x for every field of one sweep over the first
    15, 2.1x for the windowed ARE after 15);
  3 sweeps after a to_gbp_state / from_gbp_state round trip: 1e-12 absolute.
"""
import types

import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M

try:  # the card's machine has no JAX: only the cuda-marked cases run there
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import VariableState as JVar
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.models import ba as jba
    from gbp_tpu.ops import messages_pallas as mp
except ImportError:
    jax = None

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
JCFG = None if jax is None else JConfig(message_form="pallas", **CFG)
# The reference's one sweep as one compiled program (an eager call compiles
# each of its operations apart, about twice the time; the results agree with
# it to roundoff).
_jsweep = None if jax is None else jax.jit(J.sweep, static_argnums=2)
# The reference's ARE as one compiled program (eager, it compiles each of its
# operations apart, seconds a graph; the value agrees to roundoff).
_jare = None if jax is None else jax.jit(jba.avg_reprojection_error, static_argnames="fi")
PCFG = GBPConfig(**CFG)
BETA = GBPConfig().beta
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
JDT = {} if jax is None else {torch.float64: jnp.float64, torch.float32: jnp.float32}
# float32 results are held against float64 on the same inputs, within these
# multiples of the reference's own float32 error there (one kernel call; a
# 15-sweep run, whose roundoff compounds through relinearization).
F32_OVER_REF_STAGE, F32_OVER_REF_RUN = 2.0, 3.0
SCENES = {
    "corridor280": lambda m: m.simulate_corridor(n_cams=280, lmks_per_cam=12, window=3, seed=1),
    "corridor320": lambda m: m.simulate_corridor(n_cams=320, lmks_per_cam=20, window=3, seed=1),
    "blocks7": lambda m: m.simulate_blocks(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3,
                                           seed=0, shuffle=True),
    "blocks8": lambda m: m.simulate_blocks(n_blocks=8, n_cams=40, lmks_per_cam=20, window=3,
                                           seed=0, shuffle=True),
    "blocks3_unshuffled": lambda m: m.simulate_blocks(n_blocks=3, n_cams=40, lmks_per_cam=20,
                                                      window=3, seed=2),
}


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_state(d, dtype=None):
    arr = lambda a: jnp.asarray(a, dtype)
    f = {k: (tuple(arr(a) for a in v) if isinstance(v, tuple) else arr(v))
         for k, v in d["f"].items()}
    return J.CMState(v=tuple(JVar(**{k: arr(a) for k, a in v.items()}) for v in d["v"]),
                     f=J.CMFactorState(**f))


def build_both(sim, dtype, **prepare_kw):
    jg, jm = jba.build(sim, dtype=JDT[dtype], layout="ell", **PRIORS)
    pg, pm = pba.build(sim, dtype=dtype, device="cpu", layout="ell", **PRIORS)
    return ((jg, jm, J.prepare(jg, segsum_exact=True, **prepare_kw)),
            (pg, pm, P.prepare(pg, **prepare_kw)))


@pytest.fixture(scope="module")
def sim280():
    return SCENES["blocks7"](pba)


@pytest.fixture(scope="module")
def f64(sim280):
    return build_both(sim280, torch.float64)


@pytest.fixture(scope="module")
def operands(f64):
    """The port's state after 8 plain sweeps (8 = min_linear_iters: rows may
    relinearize next) and the reference sweep's kernel operands for it
    (sweep_cm.sweep, windowed fused path)."""
    (_, _, jc), (_, pm, pc) = f64
    assert jc.win_w and jc.ell_fused and jc.gather_mode == "table"
    st = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    return pc, st, reference_operands(jc, st, jnp.float64)


def reference_operands(jc, st, jdt):
    jst = jax_state(interop.cm_state_to_numpy(st), jdt)
    fb = jc.fb
    bwtab, mwtab = J.window_tables(jc, J._pack_beliefs(jst.v[fb.vblocks[0]]))
    lbtab, lmtab = J.ell_tables(jc, jst.v[fb.vblocks[1]])
    fs = jst.f
    cast = lambda a: jnp.asarray(a, jdt)
    kw = dict(d0=6, d1=3, z=2, gslot=0, win_w=jc.win_w, deg=fb.ell_deg, ell_w2=jc.ell_w2,
              interpret=True)

    def relin(beta):
        return mp.fused_relin_cm_tabblk_ell(
            j_kernel_params(JConfig(beta=beta, **CFG), jdt), jc.ell_starts, jc.win_starts,
            lmtab, mwtab, jc.gidx_cm, cast(jc.z), jc.args, fs.lp, fs.jac, fs.r0, fs.srel,
            cast(jc.act), comp_name=fb.ftype.name, n_args=0, **kw)

    def messages(relin_out, act, huber):
        lp, jac, r0, srel = relin_out
        return mp.fused_messages_cm_tabblk_ell(
            j_kernel_params(JCFG, jdt), jc.ell_starts, jc.win_starts, jac, lp, r0,
            cast(jc.prec), srel, act, lbtab, bwtab, jc.gidx_cm, fs.msg_eta[0], fs.msg_lam[0],
            fs.msg_eta[1], fs.msg_lam[1], prec_full=False, huber=huber, exact=True, **kw)

    return types.SimpleNamespace(jc=jc, jst=jst, relin=relin, messages=messages)


def cast_port(pc, st, dtype):
    """The CM graph's float tensors and the state in `dtype`."""
    c = lambda t: t.to(dtype) if t.is_floating_point() else t
    pc = pc._replace(z=c(pc.z), prec=c(pc.prec), act=c(pc.act))
    st = P.CMState(v=tuple(type(v)(*(c(t) for t in v)) for v in st.v),
                   f=P.CMFactorState(*(tuple(c(t) for t in x) if isinstance(x, tuple) else c(x)
                                       for x in st.f)))
    return pc, st


def median_beta(pc, st):
    cam_mean, lmk_mean, _, _ = P.belief_tables(pc, st)
    rows = torch.arange(pc.mp) // pc.fb.ell_deg
    x = torch.cat([cam_mean[pc.gidx.long()], lmk_mean[rows]], 1).T
    dist = ((x - st.f.lp) ** 2).sum(0).sqrt()[pc.act[0] > 0.5]
    return float(dist.double().median())


# --- (a) scenes -------------------------------------------------------------


@pytest.mark.parametrize("name", ["corridor280", "blocks8", "blocks3_unshuffled"])
def test_scene_matches_reference(name):
    jsim, psim = SCENES[name](jba), SCENES[name](pba)
    assert set(jsim) == set(psim)
    for key, ref in jsim.items():
        ref, got = np.asarray(ref), np.asarray(psim[key])
        assert got.shape == ref.shape, key
        if ref.dtype.kind in "iu":
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0), key


# --- (b) prepare --------------------------------------------------------------


def presorted(sim):
    """Landmarks renumbered in corridor order: windows engage without the sort."""
    order = np.argsort(sim["lmk_truth"][:, 0], kind="stable")
    return dict(sim, lmk_truth=sim["lmk_truth"][order], lmk_init=sim["lmk_init"][order],
                lmk_ids=np.argsort(order)[sim["lmk_ids"]])


@pytest.mark.parametrize("name", ["corridor280", "corridor320", "blocks8", "presorted320"])
def test_prepare_windows_match_reference(name):
    sim = presorted(SCENES["corridor320"](pba)) if name == "presorted320" else SCENES[name](pba)
    (_, _, jc), (_, _, pc) = build_both(sim, torch.float64)
    assert pc.win_w > 0 and 2 * pc.win_w <= pc.win_ncpad
    assert (pc.mp, pc.nv, pc.win_w, pc.win_ncpad) == (jc.mp, jc.nv, jc.win_w, jc.win_ncpad)
    np.testing.assert_array_equal(pc.win_starts.numpy(), np.asarray(jc.win_starts))
    assert (pc.vperm is None) == (name == "presorted320") == (jc.vperm is None)
    if pc.vperm is not None:
        for field in ("vperm", "vinv", "rowperm"):
            np.testing.assert_array_equal(getattr(pc, field).numpy(),
                                          np.asarray(getattr(jc, field)), err_msg=field)
        for field in ("prior_eta", "prior_lam"):
            np.testing.assert_array_equal(getattr(pc.base.vblocks[1], field).numpy(),
                                          np.asarray(getattr(jc.base.vblocks[1], field)))
    flat = lambda a: np.asarray(a).reshape(np.asarray(a).shape[0], -1)
    for field in ("z", "prec", "act"):
        np.testing.assert_array_equal(getattr(pc, field).numpy(), flat(getattr(jc, field)))
    gidx = pc.gidx.numpy()
    np.testing.assert_array_equal(gidx, np.asarray(jc.gidx_rm))
    # Every camera id lies in its tile's window; the per-tile CSR lists each
    # row once, under its window column, in row order; the block lists name
    # exactly the tiles whose window meets the block of cameras, ascending.
    starts, w = pc.win_starts.numpy(), pc.win_w
    tiles = gidx.reshape(-1, P.ROW_ALIGN)
    assert (tiles.min(1) >= starts).all() and (tiles.max(1) < starts + w).all()
    rows, offs = pc.win_rows.numpy(), pc.win_offsets.numpy()
    assert sorted(rows.tolist()) == list(range(pc.mp)) and offs[-1] == pc.mp
    seg_of_row = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    np.testing.assert_array_equal(seg_of_row // w, rows // P.ROW_ALIGN)
    np.testing.assert_array_equal(starts[seg_of_row // w] + seg_of_row % w, gidx[rows])
    assert (np.diff(rows)[np.diff(seg_of_row) == 0] > 0).all()
    blk, boff = pc.blk_tiles.numpy(), pc.blk_offsets.numpy()
    n_cam, b = pc.base.vblocks[0].count, M.SCATTER_CAMS
    assert boff.shape == (-(-n_cam // b) + 1,)
    for i in range(len(boff) - 1):
        c0, c1 = i * b, min((i + 1) * b, n_cam)
        want = np.flatnonzero((starts < c1) & (c0 < starts + w))
        np.testing.assert_array_equal(blk[boff[i]:boff[i + 1]], want)


def test_windows_off_for_64_cams():
    sim = pba.simulate_corridor(n_cams=64, lmks_per_cam=20, window=3, seed=0)
    jg, _ = jba.build(sim, dtype=jnp.float64)
    pg, _ = pba.build(sim, dtype=torch.float64, device="cpu")
    jc, pc = J.prepare(jg, window=True), P.prepare(pg, window=True)
    assert jc.win_w == 0 and pc.win_w == 0
    assert pc.vperm is None and pc.rowperm is None and pc.win_starts is None
    assert (pc.mp, pc.nv) == (jc.mp, jc.nv)


# --- (c) the four kernels' plain versions ---------------------------------------


@pytest.mark.parametrize("which,dtype,tol", [("config", torch.float64, 1e-12),
                                             ("median", torch.float64, 1e-12),
                                             ("config", torch.float32, 1e-4)])
def test_relin_window_plain_matches_reference(operands, which, dtype, tol):
    pc, st, ref = operands
    if dtype == torch.float32:
        pc, st = cast_port(pc, st, dtype)
        ref = reference_operands(ref.jc, st, jnp.float32)
    beta = BETA if which == "config" else median_beta(pc, st)
    cam_mean, lmk_mean, _, _ = P.belief_tables(pc, st)
    fs = st.f
    got = M.relin_cm_tabblk_ell_plain(
        _kernel_params(GBPConfig(beta=beta, **CFG), dtype), cam_mean, lmk_mean, pc.gidx,
        pc.win_starts, pc.z, fs.lp, fs.jac, fs.r0, fs.srel, pc.act, deg=pc.fb.ell_deg,
        win_w=pc.win_w)
    for g, r in zip(got, ref.relin(beta)):
        assert g.dtype == dtype and rel(g, r) <= tol
    n_relin, n_valid = int((got[3] == 0).sum()), int(pc.act.sum())
    assert n_relin == n_valid if which == "config" else 0 < n_relin < n_valid


def window_messages(pc, st, relin_out, act, huber, dtype):
    """The port's windowed messages (plain version) of state `st` from the
    relinearization outputs `relin_out` (reference arrays)."""
    lp, jac, r0, srel = (torch.tensor(np.asarray(a).reshape(a.shape[0], -1)).to(dtype)
                         for a in relin_out)
    _, _, cam_tab, lmk_tab = P.belief_tables(pc, st)
    fs = st.f
    return M.messages_cm_tabblk_ell_plain(
        _kernel_params(PCFG, dtype), cam_tab, lmk_tab, pc.gidx, pc.win_starts, jac, lp, r0,
        pc.prec, srel, act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
        pc.win_rows, pc.win_offsets, deg=pc.fb.ell_deg, huber=huber, win_w=pc.win_w)


@pytest.mark.parametrize("huber,dtype,tol", [(None, torch.float64, 1e-10),
                                             (1.0, torch.float64, 1e-10),
                                             (None, torch.float32, 1e-4)])
def test_messages_window_plain_matches_reference(operands, huber, dtype, tol):
    """All five outputs, with every 5th row switched off (act = 0): those
    rows pass their old messages through unchanged.  The 5th output is the
    stack of per-tile window partials [n_tiles, 42, win_w]."""
    pc, st, ref = operands
    jdt = JDT[dtype]
    if dtype == torch.float32:
        pc, st = cast_port(pc, st, dtype)
        ref = reference_operands(ref.jc, st, jdt)
    relin_ref = ref.relin(BETA)
    act = pc.act.clone()
    act[0, ::5] = 0.0
    got = window_messages(pc, st, relin_ref, act, huber, dtype)
    out = ref.messages(relin_ref, jnp.asarray(act.numpy().reshape(ref.jc.act.shape), jdt), huber)
    assert got[4].shape == (pc.mp // M.TILE, M.F_CAM, pc.win_w) == out[4].shape
    if dtype == torch.float64:
        for g, r in zip(got, out):
            assert g.dtype == dtype and rel(g, r) <= tol
    else:
        # float64 on the same float32-rounded inputs (the state and the
        # reference's float32 relinearization), through both packages.
        pc64, st64 = cast_port(pc, st, torch.float64)
        relin64 = tuple(jnp.asarray(np.asarray(a), jnp.float64) for a in relin_ref)
        exact64 = reference_operands(ref.jc, st64, jnp.float64)
        want = exact64.messages(relin64, jnp.asarray(act.numpy().reshape(ref.jc.act.shape),
                                                     jnp.float64), huber)
        port64 = window_messages(pc64, st64, relin64, act.double(), huber, torch.float64)
        for g, r, g64, w in zip(got, out, port64, want):
            assert rel(g64, w) <= 1e-10
            ref_err = rel(np.asarray(r), w)
            assert g.dtype == dtype and rel(g, w) <= F32_OVER_REF_STAGE * ref_err, (
                rel(g, w), ref_err)
    fs = st.f
    off = act[0] == 0
    for g, old in zip(got[:4], (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])):
        assert torch.equal(g[:, off], old[:, off])
        assert not torch.equal(g[:, ~off], old[:, ~off])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_segsum_blk_plain_matches_reference(operands, dtype, tol):
    """The per-tile partials, combined by scatter_windows_cm_plain, against
    the reference's segsum_cm_blk (kernel stage + combine), and against the
    whole-table camera sum of the same messages."""
    pc, st, _ = operands
    me, ml = st.f.msg_eta[0].to(dtype), st.f.msg_lam[0].to(dtype)
    n_cam = pc.base.vblocks[0].count
    part = M.segsum_cm_blk_plain(me, ml, pc.win_rows, pc.win_offsets,
                                 n_tiles=pc.mp // M.TILE, w=pc.win_w)
    got = M.scatter_windows_cm_plain(part, pc.win_starts,
                                     *M.cover_lists(pc.win_starts, pc.win_w, n_cam), n_seg=n_cam)
    cm = lambda a: jnp.asarray(a.numpy().reshape(a.shape[0], -1, mp.LANE))
    out = mp.segsum_cm_blk(cm(me), cm(ml), cm(pc.gidx[None]), jnp.asarray(pc.win_starts.numpy()),
                           n_seg=n_cam, w=pc.win_w, exact=True, interpret=True)
    assert got.shape == (M.F_CAM, n_cam) and got.dtype == dtype
    assert rel(got, out) <= tol
    assert rel(got, M.segsum_by_id_plain(me, ml, pc.seg_rows, pc.seg_offsets)) <= tol


@pytest.mark.parametrize("dtype,f,n_tiles,w,n_seg,ncpad", [
    (np.float64, 42, 7, 128, 1280, 1536),
    (np.float32, 12, 5, 16, 40, 48),
])
def test_scatter_windows_plain_exact(dtype, f, n_tiles, w, n_seg, ncpad):
    """Against the reference's kernel and a dense accumulation: overlapping
    windows, repeated starts, windows reaching into the padded tail."""
    rng = np.random.default_rng(7)
    part = rng.normal(size=(n_tiles, f, w)).astype(dtype)
    starts = np.sort(rng.integers(0, (ncpad - w) // 8 + 1, size=n_tiles)) * 8
    starts[1] = starts[0]  # a repeated start, whatever the draw
    cov_tiles, cov_offsets = M.window_cover_csr(starts, w, n_seg)
    got = M.scatter_windows_cm_plain(
        torch.tensor(part), torch.tensor(starts, dtype=torch.int32), torch.tensor(cov_tiles),
        torch.tensor(cov_offsets), n_seg=n_seg).numpy()
    want = np.zeros((f, ncpad), dtype)
    for i, s in enumerate(starts):
        want[:, s:s + w] += part[i]
    atol = 1e-5 if dtype is np.float32 else 1e-12
    np.testing.assert_allclose(got, want[:, :n_seg], rtol=0, atol=atol)
    ref = mp.scatter_windows_cm(jnp.asarray(part), jnp.asarray(starts, jnp.int32), n_seg=n_seg,
                                w=w, ncpad=ncpad, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def test_window_csr_rejects_ids_outside_their_window(operands):
    pc, st, _ = operands
    gidx = pc.gidx.numpy().copy()
    gidx[5] = pc.win_starts.numpy()[0] + pc.win_w
    with pytest.raises(ValueError, match="outside its tile's window"):
        M.window_rows_csr(gidx, pc.win_starts.numpy(), pc.win_w)
    cam_mean, lmk_mean, _, _ = P.belief_tables(pc, st)
    fs = st.f
    with pytest.raises(ValueError, match="outside its tile's window"):
        M.relin_cm_tabblk_ell_plain(
            _kernel_params(PCFG, torch.float64), cam_mean, lmk_mean, torch.tensor(gidx),
            pc.win_starts, pc.z, fs.lp, fs.jac, fs.r0, fs.srel, pc.act, deg=pc.fb.ell_deg,
            win_w=pc.win_w)


# --- (d) the windowed sweep -----------------------------------------------------


def test_init_state_lives_in_sorted_order(f64):
    (_, jm, jc), (_, pm, pc) = f64
    js, ps = J.init_state(jc, jm), P.init_state(pc, pm)
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-12
    for pv, jv in zip(ps.v, js.v):
        for name in ("eta", "lam", "mean"):
            np.testing.assert_array_equal(getattr(pv, name).numpy(), np.asarray(getattr(jv, name)))
    assert torch.equal(ps.v[1].mean, pm[1][pc.vperm]) and not torch.equal(ps.v[1].mean, pm[1])


@pytest.mark.parametrize("start", [0, 8])
def test_one_windowed_sweep_matches_reference(f64, start):
    (_, _, jc), (_, pm, pc) = f64
    ps = P.run(pc, P.init_state(pc, pm), PCFG, start)
    js = jax_state(interop.cm_state_to_numpy(ps))
    M.COUNTS.reset()
    ps, js = P.sweep(pc, ps, PCFG), _jsweep(jc, js, JCFG)
    windowed = ("relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "segsum_cm_blk",
                "scatter_windows_cm", "update_beliefs")
    assert M.COUNTS.plain == {k: int(k in windowed) for k in M.KERNELS}
    assert not any(M.COUNTS.kernel.values())
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        for name in ("eta", "lam", "mean"):
            assert rel(getattr(pv, name), getattr(jv, name)) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10


def test_six_windowed_sweeps_track_reference(f64):
    (_, jm, jc), (_, pm, pc) = f64
    js = jax.jit(J.run, static_argnums=3)(jc, J.init_state(jc, jm), JCFG, 6)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 6)
    for pv, jv in zip(ps.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-6


def test_f32_are_after_fifteen_windowed_sweeps(sim280, f64):
    """float32, 15 sweeps (through relinearization): the ARE of the port's
    windowed run and of its own full-table path (280 cameras x 42 floats fit
    the unwindowed kernels' shared memory) each lies within 3x the
    reference's own float32 error of the float64 ARE (the reference's
    windowed run; the port's float64 run equals it to 1e-9 px)."""
    (jg, jm, jc), (pg, pm, pc) = build_both(sim280, torch.float32)
    assert pc.win_w > 0
    (jg64, jm64, jc64), (pg64, pm64, pc64) = f64
    runj = jax.jit(J.run, static_argnums=3)
    are_j = lambda g, c, s: float(jba.avg_reprojection_error(g, J.to_gbp_state(c, s),
                                                             k=sim280["k"]))
    exact = float(_jare(jg64, J.to_gbp_state(jc64, runj(jc64, J.init_state(jc64, jm64), JCFG,
                                                        15)), k=sim280["k"]))
    port64 = float(pba.avg_reprojection_error(
        pg64, P.to_gbp_state(pc64, P.run(pc64, P.init_state(pc64, pm64), PCFG, 15)),
        k=sim280["k"]))
    assert abs(port64 - exact) <= 1e-9, (port64, exact)
    ref_err = abs(are_j(jg, jc, runj(jc, J.init_state(jc, jm), JCFG, 15)) - exact)
    are = lambda c, s: float(pba.avg_reprojection_error(pg, P.to_gbp_state(c, s), k=sim280["k"]))
    got = are(pc, P.run(pc, P.init_state(pc, pm), PCFG, 15))
    assert np.isfinite(got) and abs(got - exact) <= F32_OVER_REF_RUN * ref_err, (
        got, exact, ref_err)
    full = P.prepare(pg, window=False)
    assert full.win_w == 0 and full.vperm is None
    got_full = are(full, P.run(full, P.init_state(full, pm), PCFG, 15))
    assert abs(got_full - exact) <= F32_OVER_REF_RUN * ref_err, (got_full, exact, ref_err)
    assert got < are(pc, P.init_state(pc, pm))


# --- (e) state conversion with the row permutation -----------------------------------


def test_windowed_state_round_trip_with_rowperm(f64):
    (_, _, jc), (pg, pm, pc) = f64
    assert pc.rowperm is not None
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 5)
    g = P.to_gbp_state(pc, ps)
    jg = J.to_gbp_state(jc, jax_state(interop.cm_state_to_numpy(ps)))
    f, jf = g.f[0], jg.f[0]
    for name in ("linpoint", "jac", "r0", "since_relin"):
        np.testing.assert_array_equal(getattr(f, name).numpy(), np.asarray(getattr(jf, name)))
    for a, b in zip(f.msg_eta + f.msg_lam, jf.msg_eta + jf.msg_lam):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for gv, jv in zip(g.v, jg.v):
        np.testing.assert_array_equal(gv.mean.numpy(), np.asarray(jv.mean))
    # User order: a row's linearization point is its own camera and
    # landmark (all rows relinearized at sweep 0, none since).
    fb = pg.fblocks[0]
    valid = fb.valid.numpy()
    x0 = torch.cat([pm[0][fb.adj[0].long()], pm[1][fb.adj[1].long()]], 1).numpy()
    np.testing.assert_array_equal(f.linpoint.numpy()[valid], x0[valid])
    # Back into the CM layout and on: identical to the uninterrupted run.
    back = P.from_gbp_state(pc, g)
    a, b = P.run(pc, ps, PCFG, 3), P.run(pc, back, PCFG, 3)
    for av, bv in zip(a.v, b.v):
        assert (av.mean - bv.mean).abs().max() <= 1e-12
    # Through numpy and back (the checkpoint path of interop.py): leaf for leaf.
    again = interop.cm_state_from_numpy(
        jax.tree.map(np.asarray, jax_state(interop.cm_state_to_numpy(ps))), device="cpu")
    for x, y in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(ps))):
        assert torch.equal(x, y)


# --- (f) what prepare declines -----------------------------------------------------


@pytest.mark.parametrize("case", ["segment", "nonlocal_arc", "window_off_f64"])
def test_prepare_declines(f64, case):
    (jg, _, _), (pg, _, _) = f64
    if case == "segment":
        # The reference's prepare_seg declines this scene in auto mode (a
        # degree class would have no windows), and so does the port's:
        # prepare(segment=True) returns the single segment, the windowed one
        # of prepare(window=True) (tests/test_torch_seg.py holds the classes
        # where the layout applies).
        assert J.prepare_seg(jg, segsum_exact=True) is None and P.prepare_seg(pg) is None
        cmg, single = P.prepare(pg, window=True, segment=True), P.prepare(pg, window=True)
        assert isinstance(cmg, P.CMGraph) and cmg.win_w == single.win_w > 0
        assert torch.equal(cmg.win_starts, single.win_starts) and torch.equal(cmg.vperm, single.vperm)
        return
    if case == "nonlocal_arc":
        # Every landmark sees most cameras: no locality even after the sort,
        # and 260 cameras x 42 doubles exceed the unwindowed kernels' limit.
        sim = pba.simulate(n_cams=260, n_lmks=600, seed=0)
        pg, _ = pba.build(sim, dtype=torch.float64, device="cpu")
    # No window engages and the table is beyond shared memory: the expanded
    # operands ("rows"), where the port used to decline naming B3.
    cmg = P.prepare(pg, window=(case == "nonlocal_arc"))
    assert cmg.gather_mode == "rows" and cmg.win_w == 0 and cmg.vperm is None


def test_window_shared_memory_gate():
    """A window whose packed beliefs exceed one block's shared memory does
    not engage: the gate is the card's, not the reference's VMEM limit."""
    gp = np.repeat(np.arange(0, 40000, 10, dtype=np.int32), 256)  # tile span 40 -> w = 128
    assert P._windows(gp, 40000, 4)[1] == 128
    wide = np.repeat(np.arange(0, 40000, 500, dtype=np.int32), 256)  # tile span 1500 -> 1536
    assert 2 * 1536 <= 40000 and 1536 * M.F_CAM * 4 > M.SMEM_WINDOW_BYTES
    assert P._windows(wide, 40000, 4) is None


# --- on the card ------------------------------------------------------------------------
# Kernel 10 (`messages_cm_tabblk_ell`: persistent blocks over units of
# rows, windows by bulk copy, operands through a ring of stages) against its
# plain version (float64 1e-11, float32 1e-4 relative), and bit for bit
# against the full-table kernel 2 on the same operands.  The scenes cover
# windows widened past the 48 KB of static shared memory (256 cameras in
# float64, 86 KB; 384 in float32, 64.5 KB); the last window of an odd
# camera count (273 cameras: bytes not a multiple of 16, copied by elements
# at its end); a table whose rows start 4 or 8 bytes past a 16-byte
# boundary (elements at both ends); more units than blocks, not a multiple.
CARD_SCENES = {
    "blocks7": SCENES["blocks7"],
    "blocks7_odd": lambda m: m.simulate_blocks(n_blocks=7, n_cams=39, lmks_per_cam=20,
                                               window=3, seed=0, shuffle=True),
    "blocks10": lambda m: m.simulate_blocks(n_blocks=10, n_cams=40, lmks_per_cam=20, window=3,
                                            seed=0, shuffle=True),
    "blocks24": lambda m: m.simulate_blocks(n_blocks=24, n_cams=40, lmks_per_cam=20, window=3,
                                            seed=0, shuffle=True),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def card_state(sim, dtype, dev, **prepare_kw):
    """The port's prepared graph and its state after 8 plain sweeps on the
    CPU, moved to `dev`."""
    pg, pm = pba.build(sim, dtype=dtype, device="cpu", layout="ell", **PRIORS)
    pc = P.prepare(pg, **prepare_kw)
    st = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    mv = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    pc = pc._replace(**{k: mv(v) for k, v in pc._asdict().items() if isinstance(v, torch.Tensor)})
    st = P.CMState(v=tuple(type(v)(*(mv(t) for t in v)) for v in st.v),
                   f=P.CMFactorState(*(tuple(mv(t) for t in x) if isinstance(x, tuple) else mv(x)
                                       for x in st.f)))
    return pc, st


def widened(pc, w):
    """`pc` with every window widened to `w` cameras (starts moved down where
    the wider window would pass the padded camera count)."""
    starts = np.minimum(pc.win_starts.cpu().numpy(), pc.win_ncpad - w) // 8 * 8
    assert w <= pc.win_ncpad and (starts >= 0).all()
    rows, offsets = M.window_rows_csr(pc.gidx.cpu().numpy(), starts, w)
    dev = pc.gidx.device
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return pc._replace(win_w=w, win_starts=i32(starts), win_rows=i32(rows),
                       win_offsets=i32(offsets))


def off16(tab):
    """A copy of `tab` whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(tab.numel() + 16 // tab.element_size() + 1, dtype=tab.dtype,
                      device=tab.device)
    at = (16 - buf.data_ptr() % 16) % 16 // tab.element_size() + 1
    out = buf[at:at + tab.numel()].view(tab.shape)
    out.copy_(tab)
    assert out.data_ptr() % 16
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("scene,dtype,tol,wide", [
    ("blocks7", torch.float64, 1e-11, None), ("blocks7", torch.float32, 1e-4, None),
    ("blocks7", torch.float64, 1e-11, 256), ("blocks10", torch.float32, 1e-4, 384),
    ("blocks7_odd", torch.float32, 1e-4, None), ("blocks24", torch.float32, 1e-4, None)])
def test_window_messages_kernel_matches_plain_on_card(scene, dtype, tol, wide):
    dev = _card()
    pc, st = card_state(CARD_SCENES[scene](pba), dtype, dev)
    assert pc.win_w and pc.ell_fused
    if wide:
        pc = widened(pc, wide)
    plan = M.window_plan("messages_cm_tabblk_ell", dtype, win_w=pc.win_w, mp=pc.mp)
    n_cam = st.v[pc.fb.vblocks[0]].mean.shape[0]
    n_in = np.minimum(pc.win_w, n_cam - pc.win_starts.cpu().numpy())
    if scene == "blocks7_odd":
        assert (n_in * M.F_CAM * 4 % 16 != 0).any()
    if scene == "blocks24":
        assert plan["units"] > plan["blocks"] and plan["units"] % plan["blocks"]
    if wide:
        assert plan["smem_bytes"] > 48 * 1024
    fs = st.f
    params = _kernel_params(PCFG, dtype)
    _, _, cam_tab, lmk_tab = P.belief_tables(pc, st)
    for tab in (cam_tab, off16(cam_tab)):
        for huber in (None, 1.0):
            args = (params, tab, lmk_tab, pc.gidx, pc.win_starts, fs.jac, fs.lp, fs.r0, pc.prec,
                    fs.srel, pc.act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1],
                    fs.msg_lam[1], pc.win_rows, pc.win_offsets)
            kw = dict(deg=pc.fb.ell_deg, huber=huber, win_w=pc.win_w)
            got = M.messages_cm_tabblk_ell(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, M.messages_cm_tabblk_ell_plain(*args, **kw)):
                assert rel(a.cpu(), b.cpu()) <= tol


@pytest.mark.cuda
def test_window_messages_equal_full_table_on_card():
    """On the 280-camera float32 scene (47,040 bytes of table, inside the
    full-table kernels' 48 KB), the windowed graph's own operands through
    kernel 10 and through the full-table kernel 2: equal bit for bit."""
    dev = _card()
    pc, st = card_state(SCENES["blocks7"](pba), torch.float32, dev)
    fs = st.f
    params = _kernel_params(PCFG, torch.float32)
    _, _, cam_tab, lmk_tab = P.belief_tables(pc, st)
    assert pc.win_w and cam_tab.numel() * 4 <= M.SMEM_TABLE_BYTES
    head = (params, cam_tab, lmk_tab, pc.gidx)
    state = (fs.jac, fs.lp, fs.r0, pc.prec, fs.srel, pc.act, fs.msg_eta[0], fs.msg_lam[0],
             fs.msg_eta[1], fs.msg_lam[1])
    for huber in (None, 1.0):
        win = M.messages_cm_tabblk_ell(*head, pc.win_starts, *state, pc.win_rows, pc.win_offsets,
                                       deg=pc.fb.ell_deg, huber=huber, win_w=pc.win_w)
        full = M.messages_cm_tab_ell(*head, *state, pc.seg_rows, pc.seg_offsets,
                                     deg=pc.fb.ell_deg, huber=huber)
        torch.cuda.synchronize()
        for a, b in zip(win[:4], full[:4]):
            assert torch.equal(a, b)

