"""The gathered-slot sum folded into kernels 2 and 10 (`messages_cm_tab_ell`,
`messages_cm_tabblk_ell`): the order in which their CUDA kernels add it.

Both kernels return the fifth output themselves, as the TPU kernels do.  A
thread runs a row, a warp 32 consecutive rows; the lanes of a warp that share
a segment (kernel 2: a gathered id; kernel 10: a tile's window column) add
their values in a tree over their lane order, each warp adds those sums onto
its own running sums from zero, and at the end the warps' sums are added in
warp order.  A numpy model of each kernel's order, built on the launch plan's
own split (`fold_split`: contiguous ranges of units, q or q + 1 a block):
  - `fold_table_sum`: each block's partial is its warps' sums, the blocks'
    partials then added in 16 phases;
  - `fold_window_sum`: each tile in one block, its part the tile's warps'
    sums (where kernel 10's launch would split tiles between blocks it does
    not fold, and kernel 16 sums the partials after it).
Here, on the CPU, each model is held
  - bit for bit against the same order written out row by row (loops over
    blocks, units, warps and lanes);
  - against the plain versions' fifth output (`messages_cm_tab_ell_plain`,
    `messages_cm_tabblk_ell_plain`) and `segsum_by_id_plain` /
    `segsum_cm_blk_plain`: float64 to 1e-10 relative, float32 to 1e-4
    (chip_smoke.py's float32 tolerance: test_torch_segsum.py holds float64
    only), also on the 1,000-pose graph, whose 1,000 segments exceed what a
    warp keeps in shared memory (its slots past that lie in device memory);
  - against the reference's fifth output of `fused_messages_cm_tab_ell` /
    `fused_messages_cm_tabblk_ell` (Pallas, interpret=True), float64 to
    1e-10 and float32 to 1e-4;
on a scene with padded rows (valid < mp), with the landmarks gathered
(gslot 1), on a degree class's `act` CSR, with messages in the rows the CSR
leaves out (never added), with 128 and 256 threads a block.  The per-row
segment map kernel 2 reads (`segment_ids`, the prepared
graphs' `seg_ids`) equals its CSR bit for bit.
On the card (marked `cuda`, skipped elsewhere): each wrapper run twice gives
equal bits, and its fifth output equals the model at the card's launch plan
bit for bit.
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
BLOCKS7 = dict(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True)


def rel(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    ref = ref.reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def unlisted_messages(d, mp, rows, offsets, dtype, seed):
    """Random messages over six decades, non-zero in the rows the CSR leaves
    out too (a kernel must not add them)."""
    g = np.random.default_rng(seed)
    mag = lambda shape: g.standard_normal(shape) * 10.0 ** g.integers(-3, 3, shape)
    me, ml = (torch.from_numpy(mag(s)).to(dtype) for s in ((d, mp), (d * d, mp)))
    listed = np.zeros(mp, bool)
    listed[rows[:int(offsets[-1])].numpy()] = True
    assert not listed.all() or mp == int(offsets[-1])
    return me, ml, listed


def table_case(name, dtype):
    """(me, ml, seg_rows, seg_offsets) of a whole-table sum: the 8-camera
    scene (clone and pad rows unlisted), 16 cameras x 12 landmarks (the
    landmarks gathered, d = 3), a degree class of the segmented layout (its
    `act` rows listed)."""
    if name == "8cam_padded":
        graph, _ = pba.build(pba.simulate(n_cams=8, n_lmks=120, seed=0), dtype=dtype, device="cpu")
        cmg = P.prepare(graph)
        rows, offsets, mp, d = cmg.seg_rows, cmg.seg_offsets, cmg.mp, 6
        assert int(offsets[-1]) < mp  # valid < mp
    elif name == "16x12_gslot1":
        graph, _ = pba.build(pba.simulate(n_cams=16, n_lmks=12, seed=0), dtype=dtype,
                             device="cpu")
        cmg = P.prepare(graph)
        assert cmg.fb.ell_slot == 0  # the landmarks are gathered (gslot 1)
        rows, offsets, mp, d = cmg.seg_rows, cmg.seg_offsets, cmg.mp, 3
    else:
        graph, _ = pba.build(pba.simulate_blocks(n_blocks=2, n_cams=16, lmks_per_cam=30,
                                                 window=3, seed=0, shuffle=True),
                             layout="ell", dtype=dtype, device="cpu", **PRIORS)
        sg = P.prepare_seg(graph, classes_mode="exact")
        part = next(p for p in sg.parts if p.seg_rows is not None and (p.act < 0.5).any())
        rows, offsets, mp, d = part.seg_rows, part.seg_offsets, part.mp, 6
    me, ml, _ = unlisted_messages(d, mp, rows, offsets, dtype, seed=mp)
    return me, ml, rows, offsets


def test_fold_split_is_the_launch_split():
    """Contiguous ranges of q or q + 1 units covering every unit once; the
    partials' block cap keeps them within 1/8 of the messages."""
    for units, blocks in ((4000, 396), (3528, 396), (8, 8), (37, 5)):
        first, end = M.fold_split(units, blocks)
        sizes = end - first
        assert first[0] == 0 and end[-1] == units and (first[1:] == end[:-1]).all()
        assert sizes.max() - sizes.min() <= 1 and sizes.min() == units // blocks
    assert M.fold_max_blocks(512_000, 64) == 1000  # bench64: the card's 396 blocks fit
    # A table too wide for the rule keeps one block per SM: the 1,000-pose
    # graph's 2,048 rows run on 16 units, not one block.
    assert M.fold_max_blocks(2048, 1000) == M.N_SM == M.fold_max_blocks(100, 64)
    for mp, n_seg in ((512_000, 64), (150_528, 49), (1024, 292), (2048, 1000)):
        b = M.fold_max_blocks(mp, n_seg)
        assert b * n_seg <= max(mp / 8, M.N_SM * n_seg)


def _tree(vals):
    """The sum of a warp group's columns, members in lane order, as
    `warp_tree_sum` adds them: step d = 1, 2, 4, ... member i (i a multiple
    of 2d) adds member i + d's partial."""
    v = list(vals)
    d = 1
    while d < len(v):
        for i in range(0, len(v) - d, 2 * d):
            v[i] = v[i] + v[i + d]
        d *= 2
    return v[0]


def _warp_groups(row_seg, r0, r1):
    """{segment: [rows]} of the listed rows r0 <= r < r1 (one warp's lanes),
    in row order."""
    groups = {}
    for r in range(r0, r1):
        if row_seg[r] >= 0:
            groups.setdefault(int(row_seg[r]), []).append(r)
    return groups


def by_hand_table(vals, rows, offsets, *, blocks, unit_rows):
    """`fold_table_sum`'s order written out: block by block, unit by unit,
    warp by warp."""
    f, mp = vals.shape
    n_seg = offsets.shape[0] - 1
    row_seg = M.segment_ids(rows, offsets, mp).numpy()
    first, end = M.fold_split(-(-mp // unit_rows), blocks)
    warps = unit_rows // 32
    part = torch.zeros((blocks, f, n_seg), dtype=vals.dtype)
    for b in range(blocks):
        slabs = torch.zeros((warps, f, n_seg), dtype=vals.dtype)
        for u in range(first[b], end[b]):
            for w in range(warps):
                r0 = u * unit_rows + w * 32
                for s, rs in _warp_groups(row_seg, r0, min(r0 + 32, mp)).items():
                    slabs[w, :, s] = slabs[w, :, s] + _tree([vals[:, r] for r in rs])
        for w in range(warps):
            part[b] = part[b] + slabs[w]
    phases = [torch.zeros((f, n_seg), dtype=vals.dtype) for _ in range(16)]
    for b in range(blocks):
        phases[b % 16] = phases[b % 16] + part[b]
    out = phases[0]
    for y in range(1, 16):
        out = out + phases[y]
    return out


def by_hand_window(vals, rows, offsets, *, n_tiles, w, threads):
    """`fold_window_sum`'s order written out: each tile in one block, pass by
    pass of `threads` rows, warp by warp, then the warps' sums from zero."""
    f, mp = vals.shape
    row_col = np.full(mp, -1)
    r_np, off = rows.numpy(), offsets.numpy()
    for t in range(n_tiles):
        for c in range(w):
            row_col[r_np[off[t * w + c]:off[t * w + c + 1]]] = c
    warps = threads // 32
    part = torch.zeros((n_tiles, f, w), dtype=vals.dtype)
    for t in range(n_tiles):
        slabs = torch.zeros((warps, f, w), dtype=vals.dtype)
        for p0 in range(t * M.TILE, (t + 1) * M.TILE, threads):
            for k in range(warps):
                r0 = p0 + k * 32
                for c, rs in _warp_groups(row_col, r0, r0 + 32).items():
                    slabs[k, :, c] = slabs[k, :, c] + _tree([vals[:, r] for r in rs])
        for k in range(warps):
            part[t] = part[t] + slabs[k]
    return part


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["8cam_padded", "16x12_gslot1", "class_act"])
def test_table_fold_order(name, dtype):
    """The whole-table fold's order at several launches (one block, blocks
    of 128-row units as in float32, 256-row units as in float64, more blocks
    than the 16 phases) against the plain sum of the listed rows, and bit
    for bit against the order written out by hand."""
    me, ml, rows, offsets = table_case(name, dtype)
    plain = M.segsum_by_id_plain(me, ml, rows, offsets)
    mp = me.shape[1]
    for blocks, unit in ((1, 128), (3, 256), (5, 128), (min(mp // 128, 20), 128)):
        got = M.fold_table_sum(me, ml, rows, offsets, blocks=blocks, unit_rows=unit)
        assert got.dtype == dtype and got.shape == plain.shape
        assert rel(got, plain) <= TOL[dtype]
        if blocks in (1, 3):
            want = by_hand_table(torch.cat([me, ml]), rows, offsets, blocks=blocks,
                                 unit_rows=unit)
            assert torch.equal(got, want)


def window_case(dtype, n_sweeps=3):
    graph, means = pba.build(pba.simulate_blocks(**BLOCKS7), dtype=dtype, device="cpu",
                             layout="ell", **PRIORS)
    cmg = P.prepare(graph, window=True)
    # `window_rows_csr` lists every row, pad and clone rows too (zero messages).
    assert cmg.win_w and int(cmg.win_offsets[-1]) == cmg.mp
    return cmg, P.run(cmg, P.init_state(cmg, means), GBPConfig(**CFG), n_sweeps)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_fold_order(dtype):
    """The windowed fold's order, each tile in one block: 256 threads (the
    per-tile kernel of float64 and 12 dofs) and 128 (the persistent kernel
    with whole tiles a block); against kernel 16's plain sum, and bit for
    bit against the order written out by hand."""
    cmg, _ = window_case(dtype, 0)
    n_tiles, w, mp = cmg.mp // M.TILE, cmg.win_w, cmg.mp
    me, ml, _ = unlisted_messages(6, mp, cmg.win_rows, cmg.win_offsets, dtype, seed=7)
    blk = M.segsum_cm_blk_plain(me, ml, cmg.win_rows, cmg.win_offsets, n_tiles=n_tiles, w=w)
    for threads in (256, 128):
        kw = dict(n_tiles=n_tiles, w=w, threads=threads)
        got = M.fold_window_sum(me, ml, cmg.win_rows, cmg.win_offsets, **kw)
        assert got.shape == blk.shape and rel(got, blk) <= TOL[dtype]
        want = by_hand_window(torch.cat([me, ml]), cmg.win_rows, cmg.win_offsets, **kw)
        assert torch.equal(got, want)


def test_segment_ids_match_the_csr():
    """The per-row map kernel 2 reads, against its CSR bit for bit: the
    prepared graph's (`CMGraph.seg_ids`, a degree class's, a halo
    partition's, each from CSRs with rows left out, the halo's zero-padded)
    and `segment_ids` of the CSR itself."""
    def held(ids, rows, offsets, mp):
        want = np.full(mp, -1, np.int32)
        off = offsets.numpy()
        for s in range(off.size - 1):
            want[rows.numpy()[off[s]:off[s + 1]]] = s
        assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), want)
        assert torch.equal(M.segment_ids(rows, offsets, mp), ids)

    graph, means = pba.build(pba.simulate(n_cams=8, n_lmks=120, seed=0), dtype=torch.float64,
                             device="cpu")
    cmg = P.prepare(graph)
    assert int(cmg.seg_offsets[-1]) < cmg.mp
    held(cmg.seg_ids, cmg.seg_rows, cmg.seg_offsets, cmg.mp)
    from gbp_tpu_torch.parallel import halo_cm
    _, hcm, _, _ = halo_cm.distribute(graph, means, 2, device="cpu", gather_mode="table")
    assert any(hcm.seg_rows.shape[1] > int(hcm.seg_offsets[p, -1]) for p in range(2))
    for p in range(2):
        held(hcm.seg_ids[p], hcm.seg_rows[p], hcm.seg_offsets[p], hcm.mp)
    seg = pba.simulate_blocks(n_blocks=2, n_cams=16, lmks_per_cam=30, window=3, seed=0,
                              shuffle=True)
    sg = P.prepare_seg(pba.build(seg, layout="ell", dtype=torch.float64, device="cpu",
                                 **PRIORS)[0], classes_mode="exact")
    parts = [p for p in sg.parts if p.seg_rows is not None]
    assert parts
    for p in parts:
        held(p.seg_ids, p.seg_rows, p.seg_offsets, p.mp)


def test_table_fold_past_the_shared_slots():
    """The 1,000-pose graph's table (float32 graphs up to 1,024 poses take
    table mode; 1,000 segments are more than a warp keeps in shared memory
    at any occupancy, so the card holds most slots in device memory; the
    order is the same): the model at its launches against the plain sum,
    float32 messages to 1e-4 and float64 ones to 1e-10."""
    from gbp_tpu_torch.models import pose_graph

    sim = pose_graph.simulate_manhattan(n_poses=1000, seed=0, loop_prob=0.3, loop_radius=3.0)
    cmg = P.prepare(pose_graph.build(sim, dtype=torch.float32, layout="ell", device="cpu")[0])
    assert not cmg.win_w and cmg.gather_mode == "table"
    rows, offsets = cmg.seg_rows, cmg.seg_offsets
    n_seg = offsets.shape[0] - 1
    d = cmg.fb.dofs[1 - cmg.fb.ell_slot]
    assert n_seg >= 1000 and n_seg * (d + d * d) * 4 * 4 > 48 * 1024
    for dtype in (torch.float32, torch.float64):
        me, ml, _ = unlisted_messages(d, cmg.mp, rows, offsets, dtype, seed=3)
        plain = M.segsum_by_id_plain(me, ml, rows, offsets)
        for blocks, unit in ((M.fold_max_blocks(cmg.mp, n_seg), 128), (7, 256)):
            blocks = min(blocks, -(-cmg.mp // unit))
            got = M.fold_table_sum(me, ml, rows, offsets, blocks=blocks, unit_rows=unit)
            assert rel(got, plain) <= TOL[dtype]


# --- against the plain versions' and the reference's fifth output ------------------


def _reference():
    import jax.numpy as jnp

    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import VariableState as JVar
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.models import ba as jba
    from gbp_tpu.ops import messages_pallas as mp

    def state(st):
        d = interop.cm_state_to_numpy(st)
        f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
             for k, v in d["f"].items()}
        return J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()})
                                 for v in d["v"]), f=J.CMFactorState(**f))

    return jnp, J, jba, mp, state, j_kernel_params(JConfig(message_form="pallas", **CFG),
                                                   jnp.float64)


def _reference_params(jdt):
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params

    return j_kernel_params(JConfig(message_form="pallas", **CFG), jdt)


def _plain_messages(cmg, st):
    _, _, cam_tab, lmk_tab = P.belief_tables(cmg, st)
    fs = st.f
    dtype = fs.jac.dtype
    args = (_kernel_params(GBPConfig(**CFG), dtype), cam_tab, lmk_tab, cmg.gidx)
    state = (fs.jac, fs.lp, fs.r0, cmg.prec, fs.srel, cmg.act, fs.msg_eta[0], fs.msg_lam[0],
             fs.msg_eta[1], fs.msg_lam[1])
    if cmg.win_w:
        return M.messages_cm_tabblk_ell_plain(*args, cmg.win_starts, *state, cmg.win_rows,
                                              cmg.win_offsets, deg=cmg.fb.ell_deg, huber=None,
                                              win_w=cmg.win_w)
    return M.messages_cm_tab_ell_plain(*args, *state, cmg.seg_rows, cmg.seg_offsets,
                                       deg=cmg.fb.ell_deg, huber=None)


def _table_reference_sum(dtype, tol):
    """The 8-camera scene after 8 sweeps: the model of the kernel's order on
    the new messages against the plain version's fifth output and the
    reference's (`fused_messages_cm_tab_ell`) from the same state."""
    jnp, J, jba, mp, jstate, jparams = _reference()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
    graph, means = pba.build(sim, dtype=dtype, device="cpu")
    cmg = P.prepare(graph)
    st = P.run(cmg, P.init_state(cmg, means), GBPConfig(**CFG), 8)
    out = _plain_messages(cmg, st)
    got = M.fold_table_sum(out[0], out[1], cmg.seg_rows, cmg.seg_offsets, blocks=5,
                           unit_rows=128)
    assert rel(got, out[4]) <= tol

    jg, _ = jba.build(sim, dtype=jdt)
    jcmg = J.prepare(jg, segsum_exact=True)
    jst = jstate(st)
    pk = J._pack_beliefs(jst.v[jcmg.fb.vblocks[0]])
    lbtab, _ = J.ell_tables(jcmg, jst.v[jcmg.fb.vblocks[1]])
    ncp = -(-pk.shape[0] // mp.LANE) * mp.LANE
    btab = jnp.swapaxes(jnp.pad(pk, ((0, ncp - pk.shape[0]), (0, 0))), 0, 1)[:M.F_CAM]
    f = jst.f
    params = _reference_params(jdt)
    ref = mp.fused_messages_cm_tab_ell(
        params, jcmg.ell_starts, f.jac, f.lp, f.r0, jcmg.prec, f.srel, jcmg.act, lbtab, btab,
        jcmg.gidx_cm, f.msg_eta[0], f.msg_lam[0], f.msg_eta[1], f.msg_lam[1], d0=6, d1=3, z=2,
        prec_full=False, huber=None, gslot=0, deg=cmg.fb.ell_deg, ell_w2=jcmg.ell_w2,
        exact=True, interpret=True)
    assert rel(got, np.asarray(ref[4])[:, :got.shape[1]]) <= tol


def test_table_fold_matches_plain_and_reference():
    """The 8-camera scene after 8 sweeps, float64: the model of the kernel's
    order on the new messages against the plain version's fifth output and
    the reference's (`fused_messages_cm_tab_ell`)."""
    _table_reference_sum(torch.float64, 1e-10)


def test_table_fold_matches_plain_and_reference_float32():
    """The same in float32, each package from the same float32 state, to
    chip_smoke.py's float32 tolerance."""
    _table_reference_sum(torch.float32, TOL[torch.float32])


def _window_reference_sum(dtype, tol):
    """Seven blocks of 40 cameras after 3 sweeps: the model against the
    plain version's fifth output and `segsum_cm_blk_plain`, and the
    reference's (`fused_messages_cm_tabblk_ell`)."""
    jnp, J, jba, mp, jstate, jparams = _reference()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cmg, st = window_case(dtype)
    out = _plain_messages(cmg, st)
    n_tiles, w = cmg.mp // M.TILE, cmg.win_w
    got = M.fold_window_sum(out[0], out[1], cmg.win_rows, cmg.win_offsets, n_tiles=n_tiles,
                            w=w, threads=128)
    assert rel(got, out[4]) <= tol
    blk = M.segsum_cm_blk_plain(out[0], out[1], cmg.win_rows, cmg.win_offsets, n_tiles=n_tiles,
                                w=w)
    assert torch.equal(blk, out[4])

    jg, _ = jba.build(pba.simulate_blocks(**BLOCKS7), dtype=jdt, layout="ell", **PRIORS)
    jc = J.prepare(jg, segsum_exact=True, window=True)
    assert jc.win_w == w
    jst = jstate(st)
    bwtab, _ = J.window_tables(jc, J._pack_beliefs(jst.v[jc.fb.vblocks[0]]))
    lbtab, _ = J.ell_tables(jc, jst.v[jc.fb.vblocks[1]])
    f = jst.f
    params = _reference_params(jdt)
    ref = mp.fused_messages_cm_tabblk_ell(
        params, jc.ell_starts, jc.win_starts, f.jac, f.lp, f.r0, jc.prec, f.srel, jc.act, lbtab,
        bwtab, jc.gidx_cm, f.msg_eta[0], f.msg_lam[0], f.msg_eta[1], f.msg_lam[1],
        prec_full=False, huber=None, exact=True, d0=6, d1=3, z=2, gslot=0, win_w=w,
        deg=cmg.fb.ell_deg, ell_w2=jc.ell_w2, interpret=True)
    assert rel(got, ref[4]) <= tol


def test_window_fold_matches_plain_and_reference():
    """Seven blocks of 40 cameras after 3 sweeps, float64: the model against
    the plain version's fifth output,
    `segsum_cm_blk_plain` (the plain version's own sum, bit for bit) and the
    reference's (`fused_messages_cm_tabblk_ell`)."""
    _window_reference_sum(torch.float64, 1e-10)


def test_window_fold_matches_plain_and_reference_float32():
    """The same in float32, to chip_smoke.py's float32 tolerance."""
    _window_reference_sum(torch.float32, TOL[torch.float32])


# --- on the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_folded_sums_repeat_and_follow_the_model_on_card(dtype):
    """Each wrapper twice on the card: equal bits, and the fifth output the
    model's at the card's launch plan, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for windowed in (False, True):
        if windowed:
            cmg, st = window_case(dtype)
        else:
            graph, means = pba.build(pba.simulate(n_cams=8, n_lmks=120, seed=0), dtype=dtype,
                                     device="cpu")
            cmg = P.prepare(graph)
            st = P.run(cmg, P.init_state(cmg, means), GBPConfig(**CFG), 3)
        cam_mean, lmk_mean, cam_tab, lmk_tab = (t.to(dev) for t in P.belief_tables(cmg, st))
        fs = st.f
        state = [t.to(dev) for t in (fs.jac, fs.lp, fs.r0, cmg.prec, fs.srel, cmg.act,
                                     fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1],
                                     fs.msg_lam[1])]
        params = _kernel_params(GBPConfig(**CFG), dtype)
        if windowed:
            args = (params, cam_tab, lmk_tab, cmg.gidx.to(dev), cmg.win_starts.to(dev), *state,
                    cmg.win_rows.to(dev), cmg.win_offsets.to(dev))
            run = lambda: M.messages_cm_tabblk_ell(*args, deg=cmg.fb.ell_deg, huber=None,
                                                   win_w=cmg.win_w)
            plan = M.window_plan("messages_cm_tabblk_ell", dtype, win_w=cmg.win_w, mp=cmg.mp)
        else:
            args = (params, cam_tab, lmk_tab, cmg.gidx.to(dev), *state, cmg.seg_rows.to(dev),
                    cmg.seg_offsets.to(dev))
            run = lambda: M.messages_cm_tab_ell(*args, deg=cmg.fb.ell_deg, huber=None)
            plan = M.table_plan(dtype, n_cam=cam_tab.shape[0],
                                n_seg=cmg.seg_offsets.shape[0] - 1, mp=cmg.mp)
        first, second = run(), run()
        for a, b in zip(first, second):
            assert torch.equal(a, b)
        me, ml = first[0].cpu(), first[1].cpu()
        if windowed:
            csr = (me, ml, cmg.win_rows, cmg.win_offsets)
            kw = dict(n_tiles=cmg.mp // M.TILE, w=cmg.win_w)
            model = (M.fold_window_sum(*csr, **kw, threads=plan["threads"]) if plan["folded"]
                     else M.segsum_cm_blk_plain(*csr, **kw))
        else:
            model = M.fold_table_sum(me, ml, cmg.seg_rows, cmg.seg_offsets,
                                     blocks=plan["blocks"], unit_rows=plan["unit_rows"])
        assert torch.equal(first[4].cpu(), model)


@pytest.mark.cuda
def test_table_fold_past_the_shared_slots_on_card():
    """The 1,000-pose graph's table in float32 on the card: most of a warp's
    1,000 slots lie in device memory (`table_plan`'s slab_slots); two runs
    give equal bits, and the fifth output is the model's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gbp_tpu_torch.models import pose_graph

    dev = torch.device("cuda")
    sim = pose_graph.simulate_manhattan(n_poses=1000, seed=0, loop_prob=0.3, loop_radius=3.0)
    graph, means = pose_graph.build(sim, dtype=torch.float32, layout="ell", device=dev)
    cmg = P.prepare(graph)
    cfg = pose_graph.default_config()
    st = P.run(cmg, P.init_state(cmg, means), cfg, 3)
    _, _, cam_tab, lmk_tab = P.belief_tables(cmg, st)
    fs, g = st.f, 1 - cmg.fb.ell_slot
    huber = "row" if cmg.fb.huber_arr is not None else cmg.fb.huber
    n_seg = cmg.seg_offsets.shape[0] - 1
    d0, d1, z = fs.msg_eta[0].shape[0], fs.msg_eta[1].shape[0], fs.r0.shape[0]
    plan = M.table_plan(torch.float32, n_cam=cam_tab.shape[0], n_seg=n_seg, mp=cmg.mp, d0=d0,
                        d1=d1, z=z, gslot=g, huber=huber)
    assert plan["slab_slots"] < n_seg
    args = (_kernel_params(cfg, torch.float32), cam_tab, lmk_tab, cmg.gidx, fs.jac, fs.lp, fs.r0,
            cmg.prec, fs.srel, cmg.act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1],
            fs.msg_lam[1], cmg.seg_rows, cmg.seg_offsets)
    run = lambda: M.messages_cm_tab_ell(*args, deg=cmg.fb.ell_deg, huber=huber, gslot=g,
                                        seg_ids=cmg.seg_ids)
    first, second = run(), run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    model = M.fold_table_sum(first[2 * g].cpu(), first[2 * g + 1].cpu(), cmg.seg_rows.cpu(),
                             cmg.seg_offsets.cpu(), blocks=plan["blocks"],
                             unit_rows=plan["unit_rows"])
    assert torch.equal(first[4].cpu(), model)


@pytest.mark.cuda
def test_captured_windowed_sweeps_keep_their_tile_counters_on_card():
    """Sweeps of a windowed float32 graph captured as one CUDA graph (too few
    tiles for whole tiles a block: kernel 10 without the fold, kernel 16
    after it in the same call), replayed after the wrapper ran on a scene
    with more tiles: the eager sweeps' bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gbp_tpu_torch.utils.capture import CapturedRun, tensors

    dev = torch.device("cuda")
    cfg = GBPConfig(**CFG)

    def prepared(n_blocks):
        graph, means = pba.build(pba.simulate_blocks(**{**BLOCKS7, "n_blocks": n_blocks}),
                                 dtype=torch.float32, device=dev, layout="ell", **PRIORS)
        cmg = P.prepare(graph, window=True)
        return cmg, P.init_state(cmg, means)

    cmg, init = prepared(7)
    big, big_init = prepared(21)
    assert big.mp > cmg.mp
    plan = M.window_plan("messages_cm_tabblk_ell", torch.float32, win_w=cmg.win_w, mp=cmg.mp)
    assert not plan["folded"]
    eager = P.run(cmg, init, cfg, 5)
    run = CapturedRun(lambda s: P.sweep(cmg, s, cfg), init, 5)
    run()
    run.load(init)
    P.run(big, big_init, cfg, 2)
    got = run()
    torch.cuda.synchronize()
    for a, b in zip(tensors(eager), tensors(got)):
        assert torch.equal(a, b)
