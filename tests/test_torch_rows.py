"""The expanded-operand ("rows" / "take1") modes of the port's
component-major sweep, and their two kernels' plain versions, against the
JAX reference (Pallas in interpret mode) on identical inputs.

Tolerances (float64):
  messages_cm vs fused_messages_cm: 1e-10 relative; relin_cm vs
    fused_relin_cm: 1e-12 (as the row-major entries, test_torch_generic.py);
  the three gather modes over 8 sweeps: 1e-12 absolute on the means (the
    reference's bar; the per-row arithmetic is the same code in all three);
  CM sweep vs the generic sweep with virtual padding landmarks: 1e-9 (the
    reference's bar in tests/test_cm.py);
  one masked sweep vs the reference's: 1e-10 relative.

The row-major kernels, which stage tiles of rows through shared memory, run
only on a card: `test_staged_messages_on_card` and
`test_staged_relin_messages_on_card` (marker `cuda`) hold them against
their plain versions (float64 1e-11, float32 1e-4 relative: the tolerance
of chip_smoke.py) and bit for bit against the component-major kernels on
the transposed operands, with the generic sweep's operand layout (the
beliefs as views into one packed row per factor, lam at an offset that is
no multiple of 16 bytes) and a row count that is no multiple of any tile.
The JAX reference is imported only where it is installed, so that on a
machine with a card and no JAX the card tests run alone:
    python -m pytest tests/test_torch_rows.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import toy as ptoy
from gbp_tpu_torch.ops import messages as M

try:  # the reference, for every test but the card tests
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core import sweep as JS
    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import toy as jtoy
    from gbp_tpu.ops import messages_pallas as mp
    from test_torch_generic import PARAMS, message_operands, rel
    from test_torch_sweep_cm import jax_state
except ImportError:
    jax = None

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PCFG = PS.GBPConfig(message_form="pallas", **CFG)
JCFG = None if jax is None else JS.GBPConfig(message_form="pallas", **CFG)
MP = 1024  # one grid tile of the reference's kernels


def to_cm(a):
    """[m, F] (or [m]) numpy -> (torch [F, m], jax [F, m / 128, 128])."""
    a = np.asarray(a, dtype=np.float64).reshape(MP, -1).T.copy()
    return torch.tensor(a), jnp.asarray(a.reshape(a.shape[0], -1, 128))


# --- the component-major kernels' plain versions -----------------------------------


@pytest.mark.parametrize("huber,prec_full", [(None, False), (1.0, True), ("row", False)])
def test_messages_cm_matches_reference(huber, prec_full):
    ops = message_operands(np.random.default_rng(0), MP, 6, 3, 2, prec_full, huber)
    both = [to_cm(a) for a in ops]
    kw = dict(d0=6, d1=3, z=2, prec_full=prec_full, huber=huber)
    ref = mp.fused_messages_cm(jnp.asarray(PARAMS), *[j for _, j in both], interpret=True, **kw)
    M.COUNTS.reset()
    got = M.messages_cm(PARAMS, *[t for t, _ in both], **kw)
    assert M.COUNTS.plain["messages_cm"] == 1 and not any(M.COUNTS.kernel.values())
    for a, b in zip(got, ref):
        assert a.shape == (b.shape[0], MP) and rel(a, b) <= 1e-10


def test_relin_cm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(MP, 9)) * 0.3
    x[:, 5] += 4.0
    lp = x + rng.normal(size=(MP, 9)) * rng.choice([1e-4, 0.05], size=(MP, 1))
    ops = [x, rng.normal(size=(MP, 2)), lp, rng.normal(size=(MP, 18)), rng.normal(size=(MP, 2)),
           rng.integers(0, 12, size=MP), rng.uniform(size=MP) > 0.2]
    (tx, jx), (tz, jz), *rest = [to_cm(a) for a in ops]
    kw = dict(d0=6, d1=3, z=2, comp_name="reprojection_normalized")
    ref = mp.fused_relin_cm(jnp.asarray(PARAMS), jx, jz, None, *[j for _, j in rest],
                            n_args=0, interpret=True, **kw)
    got = M.relin_cm(PARAMS, tx, tz, None, *[t for t, _ in rest], **kw)
    assert 0 < int((got[3] == 0).sum()) < MP
    for a, b in zip(got, ref):
        assert rel(a, b) <= 1e-12
    # Factor arguments go to the models that read them, and only to those.
    with pytest.raises(ValueError, match="reads 0 per-row arguments"):
        M.relin_cm(PARAMS, tx, tz, tz, *[t for t, _ in rest], **kw)
    with pytest.raises(ValueError, match="reads 2 per-row arguments"):
        M.relin_cm(PARAMS, tx, tz, None, *[t for t, _ in rest],
                   **{**kw, "comp_name": "bal_reprojection_normalized"})


# --- prepare(gather_mode=...) ---------------------------------------------------------


def build_both(n_cams, n_lmks, seed):
    sim = pba.simulate(n_cams=n_cams, n_lmks=n_lmks, seed=seed)
    jg, jm = jba.build(sim, dtype=jnp.float64, layout="ell")
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell")
    return sim, (jg, jm), (pg, pm)


@pytest.fixture(scope="module")
def small():
    return build_both(5, 30, 2)


def test_gather_modes_agree(small):
    """Mirror of the reference's test_cm_gather_modes_agree."""
    _, _, (pg, pm) = small
    outs = []
    for mode in ("rows", "take1", "table"):
        cmg = P.prepare(pg, gather_mode=mode)
        assert cmg.gather_mode == mode and (cmg.gidx_rm is None) == (mode == "table")
        M.COUNTS.reset()
        outs.append(P.run(cmg, P.init_state(cmg, pm), PS.GBPConfig(message_form="pallas"), 8))
        used = {k for k, v in M.COUNTS.plain.items() if v}
        assert used == ({"relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id",
                         "update_beliefs"}
                        if mode == "table" else {"relin_cm", "messages_cm", "segsum_by_id",
                                                 "expand_ell_blk", "update_beliefs"})
    for o in outs[1:]:
        for a, b in zip(outs[0].v, o.v):
            assert (a.mean - b.mean).abs().max() <= 1e-12
    with pytest.raises(ValueError, match="gather_mode"):
        P.prepare(pg, gather_mode="windows")


@pytest.mark.parametrize("mode", ["rows", "take1"])
def test_rows_mode_matches_reference(small, mode):
    """The integers of the rows-mode CMGraph equal the reference's, and one
    sweep from a common state (after 8 port sweeps) agrees."""
    _, (jg, _), (pg, pm) = small
    jc, pc = J.prepare(jg, gather_mode=mode, segsum_exact=True), P.prepare(pg, gather_mode=mode)
    assert jc.gather_mode == pc.gather_mode == mode
    assert (pc.mp, pc.nv, pc.win_w) == (jc.mp, jc.nv, 0)
    np.testing.assert_array_equal(pc.gidx.numpy(), np.asarray(jc.gidx_rm))
    np.testing.assert_array_equal(pc.gidx_rm.numpy(), np.asarray(jc.gidx_rm))
    flat = lambda a: np.asarray(a).reshape(np.asarray(a).shape[0], -1)
    for name in ("z", "prec", "act"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), flat(getattr(jc, name)))
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    js = jax_state(interop.cm_state_to_numpy(ps))
    ps, js = P.sweep(pc, ps, PCFG), jax.jit(J.sweep)(jc, js, JCFG)
    for a, b in zip(ps.f.msg_eta + ps.f.msg_lam, js.f.msg_eta + js.f.msg_lam):
        assert rel(a, b) <= 1e-10
    for name in ("lp", "jac", "r0", "srel"):
        assert rel(getattr(ps.f, name), getattr(js.f, name)) <= 1e-10
    for pv, jv in zip(ps.v, js.v):
        assert rel(pv.mean, jv.mean) <= 1e-10
    # The CM state of a rows-mode graph through numpy and back, leaf for leaf.
    again = interop.cm_state_from_numpy(
        jax.tree.map(np.asarray, jax_state(interop.cm_state_to_numpy(ps))), device="cpu")
    for x, y in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(ps))):
        assert torch.equal(x, y)


def test_auto_picks_rows_beyond_shared_memory():
    """Every landmark sees most cameras (no locality even after the sort) and
    260 cameras x 42 doubles exceed a block's shared memory: "auto" lands on
    the expanded operands, and the sweep runs there."""
    sim = pba.simulate(n_cams=260, n_lmks=280, seed=0)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu")
    pc = P.prepare(pg)
    assert pc.gather_mode == "rows" and pc.win_w == 0 and pc.vperm is None
    assert 260 * M.F_CAM * 8 > P.SMEM_TABLE_BYTES
    st = P.run(pc, P.init_state(pc, pm), PCFG, 2)
    ref = PS.run(pg, PS.init_state(pg, pm), PCFG, 2)
    for a, b in zip(st.v, ref.v):
        assert (a.mean - b.mean).abs().max() <= 1e-12


@pytest.mark.parametrize("case", ["toy_two_blocks", "ba_layout_none", "displacement_chain"])
def test_prepare_returns_none_like_reference(case):
    """Mirror of the reference's test_cm_prepare_fallbacks: graphs its fast
    path declines come back None from both packages, and the generic sweep
    runs them."""
    if case == "toy_two_blocks":
        sim = ptoy.simulate(n=20)
        (jg, _), (pg, pm) = jtoy.build(sim), ptoy.build(sim, device="cpu")
    elif case == "ba_layout_none":
        sim = pba.simulate(n_cams=4, n_lmks=20, seed=1)
        (jg, _) = jba.build(sim, layout="none")
        pg, pm = pba.build(sim, device="cpu", layout="none")
    else:  # one 2-slot ELL block whose factor type has no component form
        from gbp_tpu.core.graph import GraphBuilder as JB
        from gbp_tpu.factors import linear as jl
        from gbp_tpu_torch.core.graph import GraphBuilder as PB
        from gbp_tpu_torch.factors import linear as pl

        def make(b, lin):
            v = b.add_variables("x", np.zeros((9, 1)), prior_prec=1.0)
            b.add_factors("d", lin.displacement(1), [(v, np.arange(8)), (v, np.arange(1, 9))],
                          np.ones((8, 1)), sigma=0.1)
            return b.build(layout="ell")

        (jg, _), (pg, pm) = make(JB(), jl), make(PB(device="cpu"), pl)
        assert pg.fblocks[0].ell_slot is not None
    assert J.prepare(jg) is None and P.prepare(pg) is None
    st = PS.run(pg, PS.init_state(pg, pm), PS.GBPConfig(message_form="pallas"), 3)
    assert all(torch.isfinite(v.mean).all() for v in st.v)


def test_cm_matches_generic_with_virtual_padding():
    """nv > n_lmks (padding up to lcm(tile, deg)) must not perturb results:
    the CM sweep in every gather mode against the generic sweep."""
    _, _, (pg, pm) = build_both(7, 23, 5)
    cfg = PS.GBPConfig(message_form="pallas")
    ref = PS.run(pg, PS.init_state(pg, pm), cfg, 10)
    for mode in ("table", "rows"):
        pc = P.prepare(pg, gather_mode=mode)
        assert pc.nv > pg.vblocks[1].count  # the padding case is exercised
        st = P.to_gbp_state(pc, P.run(pc, P.init_state(pc, pm), cfg, 10))
        for a, b in zip(st.v, ref.v):
            assert (a.mean - b.mean).abs().max() <= 1e-9
        assert torch.equal(st.f[0].since_relin, ref.f[0].since_relin)


@pytest.mark.parametrize("mode", ["table", "rows"])
def test_sweep_active_mask_matches_reference(small, mode):
    _, (jg, _), (pg, pm) = small
    jc, pc = J.prepare(jg, gather_mode=mode, segsum_exact=True), P.prepare(pg, gather_mode=mode)
    ps = P.run(pc, P.init_state(pc, pm), PCFG, 8)
    js = jax_state(interop.cm_state_to_numpy(ps))
    mask = np.random.default_rng(3).uniform(size=pc.mp) > 0.4
    pn = P.sweep(pc, ps, PCFG, active=torch.tensor(mask))
    jn = jax.jit(J.sweep)(jc, js, JCFG, jnp.asarray(mask))
    for a, b in zip(pn.f.msg_eta + pn.f.msg_lam + (pn.f.lp, pn.f.srel),
                    jn.f.msg_eta + jn.f.msg_lam + (jn.f.lp, jn.f.srel)):
        assert rel(a, b) <= 1e-10
    for pv, jv in zip(pn.v, jn.v):
        assert rel(pv.mean, jv.mean) <= 1e-10
    off = torch.tensor(~mask)
    assert torch.equal(pn.f.msg_eta[0][:, off], ps.f.msg_eta[0][:, off])
    assert torch.equal(pn.f.lp[:, off], ps.f.lp[:, off])
    # expand_means: the adjacent means the schedules rate factors by.
    assert rel(P.expand_means(pc, pn), J.expand_means(jc, jn)) <= 1e-12


def test_segsum_row_major_matches_index_add():
    """The scatter lowering's sum over a block's CSR, row-major, against a
    plain index_add_ (its plain version on the CPU is one)."""
    from gbp_tpu_torch.core.graph import adjacency_csr

    rng = np.random.default_rng(4)
    m, d, n = 500, 3, 17
    adj = rng.integers(0, n, size=m)
    me, ml = torch.tensor(rng.normal(size=(m, d))), torch.tensor(rng.normal(size=(m, d * d)))
    rows, offs = (torch.tensor(a) for a in adjacency_csr(adj, n))
    got = M.segsum_by_id(me, ml, rows, offs, row_major=True)
    want = torch.zeros(n, d + d * d, dtype=torch.float64).index_add_(
        0, torch.tensor(adj), torch.cat([me, ml], 1))
    assert got.shape == (n, 12) and (got - want).abs().max() <= 1e-12
    cm = M.segsum_by_id(me.T.contiguous(), ml.T.contiguous(), rows, offs)
    assert (cm.T - want).abs().max() <= 1e-12


# --- the row-major (staged) kernels on the card -------------------------------------

STAGED_M = 300  # rows: the last tile is partial whatever the rows per tile (128, 64, 32)
STAGED_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
KERNEL_PARAMS = (0.4, 0.0, 6.0, 0.0, 0.01, 8.0, 0.0)  # beta 0.01, min_linear_iters 8
VARIANTS = [(None, False), (1.0, False), ("row", False), (None, True), (1.0, True)]


def _spd_rows(rng, m, d):
    a = rng.normal(size=(m, d, d))
    return (a @ a.transpose(0, 2, 1) + d * np.eye(d)).reshape(m, -1)


def staged_operands(seed, m, shape, prec_full, huber, dtype, dev):
    """Row-major operands of `fused_messages`, in call order, as the generic
    sweep hands them in: each slot's belief (eta, lam) as views into one
    packed (eta | lam | mean) row per factor, so leading strides 2d + d*d and
    lam d values into the row; srel integer counts, act a float mask."""
    d0, d1, z = shape
    t = d0 + d1
    rng = np.random.default_rng(seed)
    put = lambda a: torch.tensor(a, dtype=dtype, device=dev)

    def belief(d):
        packed = put(np.concatenate([rng.normal(size=(m, d)), _spd_rows(rng, m, d),
                                     rng.normal(size=(m, d))], 1))
        return packed[:, :d], packed[:, d:d + d * d]

    prec = _spd_rows(rng, m, z) if prec_full else rng.uniform(0.5, 2.0, size=(m, z))
    if huber == "row":
        thr = rng.uniform(0.0, 2.0, size=(m, 1))
        thr[::3] = 0.0  # robustification off for these rows
        prec = np.concatenate([prec, thr], 1)
    (be0, bl0), (be1, bl1) = belief(d0), belief(d1)
    return [put(rng.normal(size=(m, z * t))), put(rng.normal(size=(m, t))),
            put(rng.normal(size=(m, z))), put(prec),
            torch.tensor(rng.integers(0, 12, size=m), dtype=torch.int32, device=dev),
            put((rng.uniform(size=m) > 0.2).astype(np.float64)), be0, bl0, be1, bl1,
            0.1 * be0, 0.3 * bl0, 0.1 * be1, 0.3 * bl1]


def staged_relin_operands(seed, m, comp_name, dtype, dev):
    """(x, z, fargs) of `fused_relin_messages` for model `comp_name`: x a view
    at an odd offset into a wider array, cameras in front of their points,
    fargs [m, n_args] or None."""
    d0, d1, zd = M.MODELS[comp_name][1]
    t = d0 + d1
    rng = np.random.default_rng(seed)
    wide = 0.3 * rng.normal(size=(m, t + 3))
    if comp_name.startswith("bal") or comp_name == "reprojection_normalized":
        wide[:, 1 + 5] += 4.0  # the camera's translation along its axis
    if comp_name == "bal_reprojection_intrinsics":
        wide[:, 1 + 6] += 1.0  # the focal ratio
    put = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    n_args = M.comp_n_args(comp_name)
    fargs = put(0.01 * rng.normal(size=(m, n_args))) if n_args else None
    return put(wide)[:, 1:1 + t], put(rng.normal(size=(m, zd))), fargs


def linearization(rng, x):
    """A linearization point a hair or a stride from x: rows on both sides
    of beta."""
    m, t = x.shape
    step = torch.tensor(rng.choice([1e-4, 0.05], size=(m, 1)) * rng.normal(size=(m, t)),
                        dtype=x.dtype, device=x.device)
    return x + step


def cm(a):
    """A row-major operand as the component-major one, [F, m] (or [m])."""
    return a.T.contiguous() if a.ndim == 2 else a


def equal_bits(rm_out, cm_out):
    for a, b in zip(rm_out, cm_out):
        assert a.shape == b.T.shape
        assert torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b.T, 7.0))


def close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", M.ROW_SHAPES)
def test_staged_messages_on_card(shape, dtype):
    """The staged `fused_messages` at every instantiated shape: every Huber
    and precision option against the plain version, and bit for bit the
    component-major `messages_cm` on the transposed operands; a prefix of
    the rows alike; outputs the kernel cannot stage raise."""
    dev = _card()
    d0, d1, z = shape
    for i, (huber, prec_full) in enumerate(VARIANTS):
        ops = staged_operands(i, STAGED_M, shape, prec_full, huber, dtype, dev)
        assert ops[7].stride(0) == d0 + d0 * d0 + d0  # lam: a view into the packed rows
        kw = dict(d0=d0, d1=d1, z=z, prec_full=prec_full, huber=huber)
        M.COUNTS.reset()
        got = M.fused_messages(KERNEL_PARAMS, *ops, **kw)
        assert M.COUNTS.kernel["fused_messages"] == 1 and not any(M.COUNTS.plain.values())
        close(got, M.fused_messages_plain(KERNEL_PARAMS, *ops, **kw), STAGED_TOL[dtype])
        equal_bits(got, M.messages_cm(KERNEL_PARAMS, *[cm(a) for a in ops], **kw))
        head = [a[:STAGED_M - 77] for a in ops]
        for a, b in zip(M.fused_messages(KERNEL_PARAMS, *head, **kw), got):
            assert torch.equal(a, b[:STAGED_M - 77])
    info = M.staged_info("fused_messages", dtype, d0=d0, d1=d1, z=z)
    assert info["rows"] in (32, 64, 128) and info["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("comp_name", sorted(M.MODELS))
def test_staged_relin_messages_on_card(comp_name, dtype):
    """The staged relinearization, then the staged messages
    (`fused_relin_messages`), for every measurement model: against the plain
    version, and bit for bit `relin_cm` then `messages_cm` on the transposed
    operands."""
    dev = _card()
    d0, d1, z = M.MODELS[comp_name][1]
    rng = np.random.default_rng(5)
    x, z_meas, fargs = staged_relin_operands(1, STAGED_M, comp_name, dtype, dev)
    jac, _, r0, prec, srel, act, *rest = staged_operands(
        2, STAGED_M, (d0, d1, z), False, "row", dtype, dev)
    lp = linearization(rng, x)
    args = (KERNEL_PARAMS, x, z_meas, fargs, lp, jac, r0, prec, srel, act, *rest)
    kw = dict(d0=d0, d1=d1, z=z, prec_full=False, huber="row", comp_name=comp_name)
    M.COUNTS.reset()
    got = M.fused_relin_messages(*args, **kw)
    assert M.COUNTS.kernel["fused_relin_messages"] == 1 and not any(M.COUNTS.plain.values())
    n_relin = int((got[7] == 0).sum())
    assert 0 < n_relin < STAGED_M  # both sides of the beta decision
    close(got, M.fused_relin_messages_plain(*args, **kw), STAGED_TOL[dtype])
    cm_relin = M.relin_cm(KERNEL_PARAMS, cm(x), cm(z_meas), None if fargs is None else cm(fargs),
                          cm(lp), cm(jac), cm(r0), srel, act, d0=d0, d1=d1, z=z,
                          comp_name=comp_name)
    equal_bits(got[4:], cm_relin)
    lp_n, jac_n, r0_n, srel_n = cm_relin
    cm_msgs = M.messages_cm(KERNEL_PARAMS, jac_n, lp_n, r0_n, cm(prec), srel_n, act,
                            *[cm(a) for a in rest], d0=d0, d1=d1, z=z, prec_full=False,
                            huber="row")
    equal_bits(got[:4], cm_msgs)
    info = M.staged_info("fused_relin_messages", dtype, comp_name=comp_name)
    assert info["rows"] in (64, 128) and info["blocks_per_sm"] >= 2
