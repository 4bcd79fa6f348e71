"""The two camera-side sums as the card computes them: the CSRs that
`segsum_by_id` walks, the order of its chunked form, the rule that picks
its form, and the block lists of `scatter_windows_cm`'s kernel.

The CUDA kernels run only on a card (chip_smoke.py holds them against their
plain versions there).  Here:
  - every CSR the port hands to `segsum_by_id` lists its rows ascending
    within each segment (the chunked form finds a segment's rows inside a
    chunk as one run of its list) and lists exactly the rows it should;
  - a numpy model of the chunked form's summation order (chunk partials,
    lanes of a group adding every group-th entry of a run in order, the
    shuffle tree, the 16-phase combine), with the wrapper's own form rule,
    against `segsum_by_id_plain` and the reference's `segsum_cm` (Pallas,
    interpret=True) to 1e-12 relative in float64: another association of
    the same addends;
  - the form rule at the scenes' shapes;
  - the per-block tile lists against the union of the cover lists of the
    block's cameras (exact).
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm

torch.set_num_threads(1)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
SMALL = dict(n_cams=8, n_lmks=120, seed=0)
COMBINE_PHASES = 16  # csrc/segsum.cu, stage 2


def check_csr(rows, offsets, ids, keep=None):
    """The CSR lists exactly the rows with `keep`, segment s the rows with
    id s, each segment's rows ascending; entries past the last segment are
    padding."""
    rows, offsets, ids = (np.asarray(a).astype(np.int64) for a in (rows, offsets, ids))
    keep = np.ones(ids.size, bool) if keep is None else np.asarray(keep)
    n_seg = offsets.size - 1
    assert offsets[0] == 0 and (np.diff(offsets) >= 0).all() and offsets[-1] <= rows.size
    listed = rows[:offsets[-1]]
    seg = np.repeat(np.arange(n_seg), np.diff(offsets))
    same = seg[1:] == seg[:-1]
    assert (np.diff(listed)[same] > 0).all()
    np.testing.assert_array_equal(np.sort(listed), np.flatnonzero(keep))
    np.testing.assert_array_equal(ids[listed], seg)


def _fast_path_csrs(**prep_kw):
    graph, _ = pba.build(pba.simulate(**SMALL), dtype=torch.float64, device="cpu")
    cmg = sweep_cm.prepare(graph, **prep_kw)
    # The valid rows only: padded and clone rows carry zero messages.
    return [(cmg.seg_rows, cmg.seg_offsets, cmg.gidx, (cmg.act[0] > 0.5).numpy())]


def _generic_csrs():
    graph, _ = pba.build(pba.simulate(**SMALL), dtype=torch.float64, device="cpu",
                         layout="none")
    fb = graph.fblocks[0]
    return [(*fb.csr[k], fb.adj[k], None) for k in range(2)]


def _halo_generic_csrs():
    graph, _ = pba.build(pba.simulate(**SMALL), dtype=torch.float64, device="cpu",
                         layout="none")
    hp = halo.partition(graph, 2)
    fb = hp.hgraph.fblocks[0]
    return [(fb.csr[k][0][p], fb.csr[k][1][p], fb.adj[k][p], None)
            for k in range(2) for p in range(2)]


def _halo_table_csrs():
    sim = pba.simulate_corridor(n_cams=16, lmks_per_cam=8, window=2, seed=3)
    graph, _ = pba.build(sim, dtype=torch.float64, device="cpu", **PRIORS)
    hcm, _ = halo_cm.prepare(halo.partition(graph, 2))
    assert hcm.gather_mode == "table" and not hcm.win_w
    return [(hcm.seg_rows[p], hcm.seg_offsets[p], hcm.gidx[p], (hcm.act[p, 0] > 0.5).numpy())
            for p in range(2)]


def _halo_window_csrs():
    sim = pba.simulate_blocks(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0,
                              shuffle=True)
    graph, _ = pba.build(sim, dtype=torch.float64, device="cpu", **PRIORS)
    hp = halo.partition(graph, 2, order_keys=halo_cm._ell_order_keys(graph))
    hcm, _ = halo_cm.prepare(hp)
    assert hcm.win_w
    n_gt = hcm.ext_offsets.shape[1] - 1
    ids = hcm.gidx_ghost
    # The ghost CSR is cut to the most ghost rows of a partition.
    assert hcm.ext_rows.shape[1] == max(int((ids < n_gt).sum(1).max()), 1) < hcm.mp
    return [(hcm.ext_rows[p], hcm.ext_offsets[p], ids[p], (ids[p] < n_gt).numpy())
            for p in range(2)]


CSR_SOURCES = {
    "table": lambda: _fast_path_csrs(),
    "rows": lambda: _fast_path_csrs(gather_mode="rows"),
    "unfused": lambda: _fast_path_csrs(ell_fused=False),
    "generic_layout_none": _generic_csrs,
    "halo_generic": _halo_generic_csrs,
    "halo_cm_table": _halo_table_csrs,
    "halo_cm_ghost_rows": _halo_window_csrs,
}


@pytest.mark.parametrize("source", sorted(CSR_SOURCES))
def test_csrs_list_rows_ascending(source):
    for rows, offsets, ids, keep in CSR_SOURCES[source]():
        check_csr(rows, offsets, ids, keep)


def chunked_model(me, ml, rows, offsets, chunk, group):
    """The chunked form's order in numpy: part[q, s, k] = the shuffle tree
    over `group` lanes, lane l having added entries l, l + group, ... of
    segment s's run in chunk q in order; out = the 16 phase sums over the
    chunks, added in order.  Lanes past the group hold zero, so a 32-lane
    tree gives the group's tree.  Returns [f, n_seg]."""
    vals = np.concatenate([me, ml])
    f, m = vals.shape
    n_seg, n_chunk = offsets.size - 1, -(-m // chunk)
    listed = rows[:offsets[-1]].astype(np.int64)
    seg = np.repeat(np.arange(n_seg), np.diff(offsets))
    q = listed // chunk
    key = seg * n_chunk + q
    assert (np.diff(key) >= 0).all()  # every (segment, chunk) run is contiguous
    run_start = np.searchsorted(key, key, side="left")
    lane = (np.arange(listed.size) - run_start) % group
    acc = np.zeros((n_chunk, n_seg, 32, f))
    np.add.at(acc, (q, seg, lane), vals[:, listed].T)  # in entry order
    off = 16
    while off:
        acc[:, :, :off] += acc[:, :, off:2 * off]
        off //= 2
    part = acc[:, :, 0]
    red = np.zeros((COMBINE_PHASES, n_seg, f))
    for c in range(n_chunk):
        red[c % COMBINE_PHASES] += part[c]
    out = red[0].copy()
    for p in range(1, COMBINE_PHASES):
        out += red[p]
    return out.T


def _case(m, n_seg, d, seed, keep_frac=1.0, heavy=0.0):
    """Messages and a CSR of m rows: segment 3 empty, segment 4's rows only
    in the first half (later chunks hold none of them), a share `heavy` of
    the rows in segment 0 (long runs, as a camera seeing many points makes), a
    share of the rows unlisted (zero messages, as padded rows carry) and the
    CSR padded to m entries past the last segment."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_seg, size=m)
    ids[rng.random(m) < heavy] = 0
    if n_seg > 4:
        ids[ids == 3] = 0
        ids[m // 2:][ids[m // 2:] == 4] = 1
    keep = rng.random(m) < keep_frac
    me, ml = rng.normal(size=(d, m)), rng.normal(size=(d * d, m))
    me[:, ~keep], ml[:, ~keep] = 0.0, 0.0
    sel = np.flatnonzero(keep)
    rows = np.zeros(m, np.int32)
    rows[:sel.size] = sel[np.argsort(ids[sel], kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(ids[sel], minlength=n_seg))])
    return me, ml, ids, rows, offsets.astype(np.int32)


@pytest.mark.parametrize("m,n_seg,d,chunk,group,keep_frac,heavy", [
    (36864, 16, 6, None, None, 1.0, 0.3),  # the wrapper's rule: (256, 4); long runs
    (8192, 6, 2, 256, 2, 0.8, 0.0),        # runs cut mid-run, empty segment, padding
    (8192, 2, 3, 512, 32, 1.0, 0.0),       # whole-warp groups
], ids=["rule_long_runs", "cuts_empty_padding", "group32"])
def test_chunked_order_matches_plain_and_reference(m, n_seg, d, chunk, group, keep_frac, heavy):
    import jax.numpy as jnp

    from gbp_tpu.ops import messages_pallas as mp

    me, ml, ids, rows, offsets = _case(m, n_seg, d, seed=m + n_seg, keep_frac=keep_frac,
                                       heavy=heavy)
    if chunk is None:
        chunk, group = M.segsum_form(m, n_seg, rows.size)
        assert (chunk, group) == (256, 4)
    assert chunk >= 8 * n_seg
    got = chunked_model(me, ml, rows, offsets, chunk, group)
    plain = M.segsum_by_id_plain(torch.tensor(me), torch.tensor(ml), torch.tensor(rows),
                                 torch.tensor(offsets)).numpy()
    cm = lambda a: jnp.asarray(a.reshape(a.shape[0], -1, mp.LANE))
    ref = np.asarray(mp.segsum_cm(cm(me), cm(ml), cm(ids[None].astype(np.int32)), n_seg=n_seg,
                                  exact=True, interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-12 * scale
    assert np.abs(got - ref).max() <= 1e-12 * scale
    if n_seg > 4:
        assert not got[:, 3].any()


@pytest.mark.parametrize("m,n_seg,n_rows,row_major,want", [
    (512_000, 64, 512_000, False, (1024, 4)),       # bench64: 8,000 landmarks x deg 64
    (150_528, 49, 150_528, False, (512, 2)),        # ladybug49
    (1_024_000, 512, 1_024_000, False, (4096, 2)),  # nonlocal512: 2,000 landmarks x deg 512
    (469_861, 8_000, 469_861, False, (0, 0)),       # 8,000 short segments
    (469_861, 64, 469_861, True, (0, 0)),           # the generic sweep (row-major)
    (227_328, 150, 3_000, False, (0, 0)),           # a halo partition's ghost rows
    (30_000, 64, 30_000, False, (0, 0)),            # fewer chunks than SMs
], ids=["bench64", "ladybug49", "nonlocal512", "short_8000", "row_major", "ghost_rows",
        "small"])
def test_form_rule(m, n_seg, n_rows, row_major, want):
    chunk, group = M.segsum_form(m, n_seg, n_rows, row_major)
    assert (chunk, group) == want
    if chunk:
        n_chunk = -(-m // chunk)
        # At least one chunk per SM; partials [n_chunk, f, n_seg] within 1/8
        # of the messages [f, m] (and the last chunk's rounding).
        assert n_chunk >= M.N_SM and n_chunk * n_seg <= m / 8 + n_seg
        assert chunk >= 8 * n_seg and 1 <= group <= 32


@pytest.mark.parametrize("w,n_seg,starts", [
    (128, 1280, "sorted_repeats"),
    (256, 700, "past_n_seg"),
    (128, 300, "unsorted"),
    (384, 129, "one_camera_past_a_block"),
])
def test_block_lists_are_the_union_of_cover_lists(w, n_seg, starts):
    rng = np.random.default_rng(n_seg)
    top = (n_seg + w) // 8
    s = {"sorted_repeats": lambda: np.sort(rng.integers(0, (n_seg - w) // 8, 40)),
         "past_n_seg": lambda: np.sort(rng.integers(0, top, 30)),
         "unsorted": lambda: rng.integers(0, top, 25),
         "one_camera_past_a_block": lambda: np.array([0, 0, 8, 16, 16])}[starts]() * 8
    if starts == "sorted_repeats":
        s[1] = s[0]
    tiles, offsets = M.window_block_csr(s, w, n_seg)
    cov_t, cov_o = M.window_cover_csr(s, w, n_seg)
    n_blk = -(-n_seg // M.SCATTER_CAMS)
    assert offsets.shape == (n_blk + 1,) and tiles.dtype == offsets.dtype == np.int32
    for b in range(n_blk):
        c0, c1 = b * M.SCATTER_CAMS, min((b + 1) * M.SCATTER_CAMS, n_seg)
        union = np.unique(cov_t[cov_o[c0]:cov_o[c1]])
        np.testing.assert_array_equal(tiles[offsets[b]:offsets[b + 1]], union)
