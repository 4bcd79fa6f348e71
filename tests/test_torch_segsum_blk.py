"""Kernel 16, `segsum_cm_blk`: the per-tile window partials and the order of
their additions.

The kernel (csrc/windows.cu) adds each segment of the CSR of
`window_rows_csr` from zero in CSR order, so its outputs are bit for bit
those of the plain version when the plain version adds in the same order.
Here, on the CPU:
  - `segsum_cm_blk_plain` equals a sequential loop over each segment's rows
    in CSR order (torch.equal), in float64 and float32, at f = 12, 42 and
    90 (d = 3, 6, 9), window widths 8, 128 and 384, with a tile whose 1,024
    rows all name one camera and a tile of pad rows only (the halo CSRs of
    `window_rows_csr(..., n_own)`, which list owned rows only, and the CSR
    of a prepared windowed graph).
On the card (marked `cuda`, skipped elsewhere): the kernel's output on the
same inputs equals the plain version on CPU copies of its operands
(torch.equal) and repeats bit for bit, also on the city scene's own CSR at
w = 128 and widened to 384; its launch plan fits one block's shared memory.
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo_cm

torch.set_num_threads(1)
N_TILES = 3
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)


def sequential(me, ml, rows, offsets, n_tiles, w):
    """part[i, k, j]: component k of the rows of segment i * w + j added one
    by one in CSR order, starting from zero (numpy, the operands' dtype)."""
    comp = np.concatenate([me.numpy(), ml.numpy()])
    rows, offsets = rows.numpy(), offsets.numpy()
    out = np.zeros((n_tiles * w, comp.shape[0]), comp.dtype)
    for s in range(n_tiles * w):
        acc = np.zeros(comp.shape[0], comp.dtype)
        for i in range(offsets[s], offsets[s + 1]):
            acc = acc + comp[:, rows[i]]
        out[s] = acc
    return torch.from_numpy(out.reshape(n_tiles, w, -1).transpose(0, 2, 1).copy())


def values(d, mp, dtype, seed):
    """Messages over six decades of magnitude: roundoff shows if the order
    of the additions changes."""
    g = np.random.default_rng(seed)
    mag = lambda shape: g.standard_normal(shape) * 10.0 ** g.integers(-3, 3, shape)
    return (torch.from_numpy(mag((d, mp))).to(dtype),
            torch.from_numpy(mag((d * d, mp))).to(dtype))


def synthetic_csr(w, seed, n_own=None):
    """The CSR of 3 tiles: tile 0 spread over its window (at most 11
    cameras, as a locality-sorted tile), tile 1 all on one camera, tile 2
    pad rows only (ids past n_own, listed by no segment) or spread over the
    whole window."""
    g = np.random.default_rng(seed)
    starts = np.array([0, 8, 16])
    gidx = np.concatenate([starts[0] + g.integers(0, min(w, 11), M.TILE),
                           np.full(M.TILE, starts[1] + min(w, 5) - 1),
                           starts[2] + g.integers(0, w, M.TILE)])
    if n_own is not None:
        gidx[2 * M.TILE:] = n_own + 1
    rows, offsets = M.window_rows_csr(gidx, starts, w, n_own)
    return torch.from_numpy(rows), torch.from_numpy(offsets)


def halo_csr():
    """Partition 0's owned-rows CSR of a windowed halo partition, and its
    shape (mp, w)."""
    sim = pba.simulate_blocks(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0,
                              shuffle=True)
    graph, means = pba.build(sim, dtype=torch.float64, device="cpu", layout="none", **PRIORS)
    _, hcm, _, _ = halo_cm.distribute(graph, means, 2, device="cpu")
    assert hcm.win_w and hcm.gather_mode == "table"
    assert int(hcm.win_offsets[0, -1]) < hcm.mp  # owned rows only
    return hcm.win_rows[0], hcm.win_offsets[0], hcm.mp, hcm.win_w


def window_csr():
    """The CSR of a prepared windowed graph (280 cameras, shuffled ids)."""
    sim = pba.simulate_blocks(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0,
                              shuffle=True)
    graph, _ = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    cmg = sweep_cm.prepare(graph)
    assert cmg.win_w
    return cmg.win_rows, cmg.win_offsets, cmg.mp, cmg.win_w


def cases():
    out = []
    for dtype in (torch.float64, torch.float32):
        for d in (3, 6, 9):
            tag = f"{str(dtype)[6:]}-f{d + d * d}"
            for w in (8, 128, 384):
                out.append(pytest.param(dtype, d, w, None, id=f"{tag}-w{w}"))
            out.append(pytest.param(dtype, d, 128, 20, id=f"{tag}-halo"))
    return out


@pytest.mark.parametrize("dtype,d,w,n_own", cases())
def test_plain_adds_in_csr_order(dtype, d, w, n_own):
    rows, offsets = synthetic_csr(w, seed=d * w, n_own=n_own)
    me, ml = values(d, N_TILES * M.TILE, dtype, seed=w)
    got = M.segsum_cm_blk_plain(me, ml, rows, offsets, n_tiles=N_TILES, w=w)
    assert got.shape == (N_TILES, d + d * d, w)
    assert torch.equal(got, sequential(me, ml, rows, offsets, N_TILES, w))
    if n_own is not None:
        assert not got[2].any()  # the pad tile
    assert int(torch.count_nonzero(got[1].abs().sum(0))) == 1  # one camera


@pytest.mark.parametrize("source", ["windows", "halo"])
def test_plain_adds_in_csr_order_on_prepared_graphs(source):
    rows, offsets, mp, w = window_csr() if source == "windows" else halo_csr()
    for dtype in (torch.float64, torch.float32):
        me, ml = values(6, mp, dtype, seed=1)
        got = M.segsum_cm_blk_plain(me, ml, rows, offsets, n_tiles=mp // M.TILE, w=w)
        assert torch.equal(got, sequential(me, ml, rows, offsets, mp // M.TILE, w))


# --- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def held(me, ml, rows, offsets, n_tiles, w, dev):
    """The kernel on the card against the plain version on CPU copies:
    equal bit for bit, and a second launch repeats the bits."""
    args = [t.to(dev) for t in (me, ml, rows, offsets)]
    got = M.segsum_cm_blk(*args, n_tiles=n_tiles, w=w)
    torch.cuda.synchronize()
    ref = M.segsum_cm_blk_plain(me.cpu(), ml.cpu(), rows.cpu(), offsets.cpu(), n_tiles=n_tiles,
                                w=w)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, M.segsum_cm_blk(*args, n_tiles=n_tiles, w=w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,w,n_own", cases())
def test_kernel_equals_plain_on_card(dtype, d, w, n_own):
    dev = _card()
    rows, offsets = synthetic_csr(w, seed=d * w, n_own=n_own)
    me, ml = values(d, N_TILES * M.TILE, dtype, seed=w)
    M.COUNTS.reset()
    held(me, ml, rows, offsets, N_TILES, w, dev)
    assert M.COUNTS.kernel["segsum_cm_blk"] == 2 and M.COUNTS.plain["segsum_cm_blk"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["windows", "halo"])
def test_kernel_equals_plain_on_prepared_graphs_on_card(source):
    dev = _card()
    rows, offsets, mp, w = window_csr() if source == "windows" else halo_csr()
    for dtype in (torch.float64, torch.float32):
        held(*values(6, mp, dtype, seed=1), rows, offsets, mp // M.TILE, w, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 384])
def test_kernel_equals_plain_on_city_csr(w):
    """City's own CSR (441 tiles), at its window width and widened to 384."""
    from gbp_tpu_torch.bench import BIG_BUILD, CITY

    dev = _card()
    graph, _ = pba.build(pba.simulate_blocks(**CITY), dtype=torch.float32, device="cpu",
                         **BIG_BUILD)
    cmg = sweep_cm.prepare(graph, window=True)
    assert cmg.win_w == 128
    rows, offsets = cmg.win_rows, cmg.win_offsets
    if w != cmg.win_w:
        starts = np.minimum(cmg.win_starts.numpy(), cmg.win_ncpad - w) // 8 * 8
        rows, offsets = map(torch.from_numpy, M.window_rows_csr(cmg.gidx.numpy(), starts, w))
    held(*values(6, cmg.mp, torch.float32, seed=2), rows, offsets, cmg.mp // M.TILE, w, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [3, 6, 9])
def test_plan_fits_shared_memory_on_card(dtype, d):
    """Shared memory does not depend on the window width (passes of 128
    columns), so one plan per dtype and d covers every admitted width."""
    _card()
    plan = M.segsum_blk_plan(dtype, d, n_tiles=441)
    f = d + d * d
    assert plan["threads"] == 128 and plan["groups"] * plan["comps_per_block"] >= f
    assert plan["items"] == 441 * plan["groups"] and 0 < plan["blocks"] <= plan["items"]
    assert plan["smem_bytes"] <= M.SMEM_WINDOW_BYTES and plan["blocks_per_sm"] >= 3
    assert plan["local_bytes"] == 0


@pytest.mark.cuda
def test_kernel_rejects_misaligned_operands_on_card():
    """The slices arrive by bulk copies: operands off a 16-byte boundary
    raise (no fallback)."""
    dev = _card()
    rows, offsets = (t.to(dev) for t in synthetic_csr(128, seed=0))
    me, ml = (t.to(dev) for t in values(6, N_TILES * M.TILE, torch.float32, seed=0))
    buf = torch.empty(me.numel() + 1, dtype=me.dtype, device=dev)
    shifted = buf[1:].view(me.shape)
    shifted.copy_(me)
    with pytest.raises(ValueError, match="16-byte"):
        M.segsum_cm_blk(shifted, ml, rows, offsets, n_tiles=N_TILES, w=128)
