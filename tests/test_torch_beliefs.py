"""The belief update that ends a fast-path sweep (`ops.messages.update_beliefs`,
csrc/beliefs.cu).

On the CPU: which path a sweep takes.  A graph whose two slots lie on two
variable blocks runs the wrapper, whose plain version is today's PyTorch
code; a pose graph (one block) and the segmented layout keep their own
plain code and never reach the wrapper.  The models of the kernel's order
(`_ell_sum_model`, `_solve_model`) are held to the plain version here.

On a card (`cuda`, skipped elsewhere): the kernel on small scenes at ELL
degree 64 (the whole camera table, a padding landmark or none), degree 6
(camera windows), the cameras in the ELL slot and the 9-dof BAL camera in
either slot, float32 and float64.  The ELL sums and the solve equal the
models bit for bit (elementwise operations on the card round as the kernel
does), the plain version within the sums' reordering and the solve's
conditioning, reruns give the same bits, and whole sweeps track the plain
sweeps.  This file imports no JAX, so the card's machine runs it (README)."""
import numpy as np
import pytest
import torch

from gbp_tpu_torch.bench import CFG, bal_scene
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.models import ba, pose_graph
from gbp_tpu_torch.ops import messages as M

torch.set_num_threads(1)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
# name -> (builder of (graph, means) on a device in a dtype, (d_e, d_g), ELL degree)
SCENES = {
    "deg64": (lambda dt, dev: ba.build(ba.simulate(n_cams=64, n_lmks=400, seed=0), dtype=dt,
                                       device=dev), (3, 6), 64),
    "deg64_pad": (lambda dt, dev: ba.build(ba.simulate(n_cams=64, n_lmks=399, seed=1), dtype=dt,
                                           device=dev), (3, 6), 64),
    "win6": (lambda dt, dev: ba.build(ba.simulate_blocks(
        n_blocks=24, n_cams=14, lmks_per_cam=20, window=3, seed=0, shuffle=True), dtype=dt,
        device=dev, layout="ell", **PRIORS), (3, 6), 6),
    "ell_cameras": (lambda dt, dev: ba.build(ba.simulate(n_cams=16, n_lmks=12, seed=0), dtype=dt,
                                             device=dev), (6, 3), 12),
    "bal9_ell": (lambda dt, dev: ba.build_bal(bal_scene(ba.simulate(n_cams=24, n_lmks=16, seed=0)),
                                              dtype=dt, device=dev, optimize_intrinsics=True)[:2],
                 (9, 3), 16),
    "bal9_gathered": (lambda dt, dev: ba.build_bal(
        bal_scene(ba.simulate(n_cams=8, n_lmks=60, seed=0)), dtype=dt, device=dev,
        optimize_intrinsics=True)[:2], (3, 9), 8),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _prepared(name, dtype, device):
    build, shape, deg = SCENES[name]
    graph, means = build(dtype, device)
    cmg = P.prepare(graph)
    fb = cmg.fb
    assert ((fb.dofs[fb.ell_slot], fb.dofs[1 - fb.ell_slot]), fb.ell_deg) == (shape, deg)
    if name == "win6":
        assert cmg.win_w > 0
    return cmg, P.init_state(cmg, means)


def _update_operands(cmg, state):
    """The operands (args, deg) that one sweep from `state` hands
    `update_beliefs`."""
    seen = []

    def record(*args, deg):
        seen.append((args, deg))
        return M.update_beliefs_plain(*args, deg=deg)

    real, P.update_beliefs = P.update_beliefs, record
    try:
        P.sweep(cmg, state, CFG)
    finally:
        P.update_beliefs = real
    (op,) = seen
    return op


# --- the kernel's order, as elementwise operations ------------------------------------


def _lanes(deg):
    lanes = 1
    while lanes < 32 and lanes * 8 < deg:
        lanes *= 2
    return lanes


def _ell_sum_model(x, nv, deg):
    """x [c, nv * deg] summed per variable [c, nv] in the kernel's order: lane
    l of a variable's L = _lanes(deg) lanes adds rows l, l + L, ... from
    zero, then the lanes' partials meet in an xor-butterfly."""
    v = x.reshape(x.shape[0], nv, deg)
    lanes = _lanes(deg)
    part = [torch.zeros_like(v[:, :, 0]) for _ in range(lanes)]
    for lane in range(lanes):
        for k in range(lane, deg, lanes):
            part[lane] = part[lane] + v[:, :, k]
    off = lanes // 2
    while off:
        part = [part[lane] + part[lane ^ off] for lane in range(lanes)]
        off //= 2
    return part[0]


def _sum(terms):
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _inv_model(a, d):
    """smalllinalg's `_sym_inv_rec` on lists of [n] tensors, every small sum
    added from its first term on."""
    if d == 2:
        inv_det = 1.0 / (a[0][0] * a[1][1] - a[0][1] * a[0][1])
        return [[a[1][1] * inv_det, -a[0][1] * inv_det], [-a[0][1] * inv_det, a[0][0] * inv_det]]
    if d == 3:
        a00, a01, a02, a11, a12, a22 = a[0][0], a[0][1], a[0][2], a[1][1], a[1][2], a[2][2]
        c00, c01 = a11 * a22 - a12 * a12, a02 * a12 - a01 * a22
        c02, c11 = a01 * a12 - a02 * a11, a00 * a22 - a02 * a02
        c12, c22 = a01 * a02 - a00 * a12, a00 * a11 - a01 * a01
        inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)
        return [[c * inv_det for c in row] for row in ((c00, c01, c02), (c01, c11, c12),
                                                       (c02, c12, c22))]
    d1, d2 = (d + 1) // 2, d - (d + 1) // 2
    pi = _inv_model([row[:d1] for row in a[:d1]], d1)
    q = [row[d1:] for row in a[:d1]]
    pq = [[_sum([pi[i][k] * q[k][j] for k in range(d1)]) for j in range(d2)] for i in range(d1)]
    si = _inv_model([[a[d1 + i][d1 + j] - _sum([q[k][i] * pq[k][j] for k in range(d1)])
                      for j in range(d2)] for i in range(d2)], d2)
    ps = [[_sum([pq[i][k] * si[k][j] for k in range(d2)]) for j in range(d2)] for i in range(d1)]
    out = [[None] * d for _ in range(d)]
    for i in range(d1):
        for j in range(d1):
            out[i][j] = pi[i][j] + _sum([ps[i][k] * pq[j][k] for k in range(d2)])
        for j in range(d2):
            out[i][d1 + j] = out[d1 + j][i] = ps[i][j] * -1.0
    for i in range(d2):
        for j in range(d2):
            out[d1 + i][d1 + j] = si[i][j]
    return out


def _solve_model(lam, eta):
    """`scaled_sym_solve` of [n, d, d], [n, d] with every small sum added
    from its first term on."""
    d = eta.shape[1]
    s = [torch.sqrt(torch.clamp(lam[:, i, i], min=1e-30)) for i in range(d)]
    inv = _inv_model([[lam[:, i, j] / (s[i] * s[j]) for j in range(d)] for i in range(d)], d)
    b = [eta[:, k] / s[k] for k in range(d)]
    return torch.stack([_sum([inv[i][k] * b[k] for k in range(d)]) / s[i] for i in range(d)], 1)


def _eps(dtype):
    return torch.finfo(dtype).eps


def _reorder_gap(args, deg, got, ref):
    """Largest |kernel - plain| of the ELL slot's eta and lam over the bound
    of two orders of the same sum of deg terms onto the prior: 2 deg eps
    (sum |terms| + |prior|).  At most 1 where only the order differs."""
    me, ml, _, pe, pl = args[:5]
    n, d = pe.shape
    mag = M.ell_sum_plain(me.abs(), ml.abs(), me.shape[1] // deg, deg)[:, :n]
    worst = 0.0
    for k, prior, s in ((0, pe, mag[:d].T), (1, pl, mag[d:].T.reshape(n, d, d))):
        bound = 2 * deg * _eps(me.dtype) * (s + prior.abs()) + torch.finfo(me.dtype).tiny
        worst = max(worst, ((got[0][k] - ref[0][k]).abs() / bound).max().item())
    return worst


def _solve_gap(lam, eta, got):
    """Largest normwise |got - plain solve| of the same (lam, eta) over
    8 d eps cond(D^-1 lam D^-1), the solve's sensitivity to the order of its
    small sums (cond in float64)."""
    n, d = eta.shape
    ref = M.scaled_sym_solve(lam, eta)
    s = torch.sqrt(torch.diagonal(lam.double(), dim1=1, dim2=2))
    cond = torch.linalg.cond(lam.double() / (s[:, :, None] * s[:, None, :]))
    gap = (got - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(torch.finfo(ref.dtype).tiny)
    return (gap.double() / (8 * d * _eps(lam.dtype) * cond)).max().item()


# --- CPU: which path runs -------------------------------------------------------------


@pytest.mark.parametrize("name", ["deg64_pad", "ell_cameras"])
def test_cpu_sweep_takes_the_plain_belief_update(name):
    """On CPU tensors a two-block sweep runs `update_beliefs`' plain version
    once a sweep, counted as such, and never the kernel; its beliefs are
    the priors plus the sums of the sweep's messages."""
    cmg, st = _prepared(name, torch.float64, "cpu")
    M.COUNTS.reset()
    st = P.run(cmg, st, CFG, 2)
    assert M.COUNTS.plain["update_beliefs"] == 2 and M.COUNTS.kernel["update_beliefs"] == 0
    args, deg = _update_operands(cmg, st)
    fb = cmg.fb
    e, g = fb.ell_slot, 1 - fb.ell_slot
    got = P.sweep(cmg, st, CFG).v
    for blk, sums in ((fb.vblocks[e], M.ell_sum_plain(args[0], args[1], cmg.nv, deg)),
                      (fb.vblocks[g], args[2])):
        vb = cmg.base.vblocks[blk]
        n, d = vb.prior_eta.shape
        assert torch.equal(got[blk].eta, vb.prior_eta + sums[:d, :n].T)
        assert torch.equal(got[blk].lam, vb.prior_lam + sums[d:, :n].T.reshape(n, d, d))
        assert torch.equal(got[blk].mean, M.scaled_sym_solve(got[blk].lam, got[blk].eta))


@pytest.mark.parametrize("kind", ["pose", "segmented"])
def test_one_block_and_segmented_graphs_keep_their_plain_code(kind):
    """A pose graph (both slots on one block) and the segmented layout
    update their beliefs in their own plain code: `update_beliefs` is not
    called, as a kernel or as its plain version."""
    if kind == "pose":
        sim = pose_graph.simulate_manhattan(n_poses=120, seed=4, loop_prob=0.5, loop_radius=3.0)
        graph, means = pose_graph.build(sim, dtype=torch.float64, layout="ell", device="cpu")
        cmg, cfg = P.prepare(graph), pose_graph.default_config()
        assert len(set(cmg.fb.vblocks)) == 1
    else:
        sim = ba.simulate_blocks(n_blocks=2, n_cams=16, lmks_per_cam=30, window=3, seed=0,
                                 shuffle=True)
        graph, means = ba.build(sim, dtype=torch.float64, layout="ell", device="cpu", **PRIORS)
        cmg, cfg = P.prepare_seg(graph, classes_mode="exact"), CFG
        assert isinstance(cmg, P.CMSegGraph)
    st = P.init_state(cmg, means)
    M.COUNTS.reset()
    st = P.run(cmg, st, cfg, 2)
    assert M.COUNTS.plain["update_beliefs"] == M.COUNTS.kernel["update_beliefs"] == 0
    assert sum(M.COUNTS.plain.values()) > 0
    assert all(torch.isfinite(v.mean).all() for v in st.v)


@pytest.mark.parametrize("name", ["win6", "bal9_ell", "bal9_gathered"])
def test_models_of_the_kernels_order_hold_to_the_plain_version(name):
    """The models the card tests hold the kernel to: the ELL sums within
    their reordering of the plain version's, the solve within its
    conditioning (CPU, float64)."""
    cmg, st = _prepared(name, torch.float64, "cpu")
    args, deg = _update_operands(cmg, P.run(cmg, st, CFG, 2))
    me, ml, sum_c, pe, pl, pe_c, pl_c = args
    n, d = pe.shape
    nv = me.shape[1] // deg
    sums = torch.cat([_ell_sum_model(me, nv, deg), _ell_sum_model(ml, nv, deg)])[:, :n]
    eta, lam = pe + sums[:d].T, pl + sums[d:].T.reshape(n, d, d)
    ref = M.update_beliefs_plain(*args, deg=deg)
    assert _reorder_gap(args, deg, ((eta, lam),), ref) <= 1.0
    assert _solve_gap(lam, eta, _solve_model(lam, eta)) <= 1.0
    lam_c = ref[1][1]
    assert _solve_gap(lam_c, ref[1][0], _solve_model(lam_c, ref[1][0])) <= 1.0


# --- on the card ----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_equals_its_models_and_tracks_the_plain_version(name, dt):
    """One belief update from a state 3 sweeps on: the ELL slot's eta and
    lam equal the priors plus `_ell_sum_model`'s sums, the gathered slot's
    the priors plus its sums, every mean `_solve_model` of the kernel's own
    (lam, eta), bit for bit; against the plain version, eta and lam within
    the reordering of their sums and the means within the solve's
    conditioning; a rerun gives the same bits; one launch is counted."""
    cmg, st = _prepared(name, DTYPES[dt], _card())
    args, deg = _update_operands(cmg, P.run(cmg, st, CFG, 3))
    me, ml, sum_c, pe, pl, pe_c, pl_c = args
    # These degrees stage their rows in shared memory.
    plan = M.belief_plan(DTYPES[dt], d_e=pe.shape[1], d_g=pe_c.shape[1], deg=deg,
                         n_l=pe.shape[0], n_c=pe_c.shape[0])
    assert plan["ell_staged"] >= plan["ell_vars"] * deg
    M.COUNTS.reset()
    got = M.update_beliefs(*args, deg=deg)
    again = M.update_beliefs(*args, deg=deg)
    assert M.COUNTS.kernel["update_beliefs"] == 2 and not any(M.COUNTS.plain.values())
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], again[0] + again[1]))
    n, d = pe.shape
    nv = me.shape[1] // deg
    sums = torch.cat([_ell_sum_model(me, nv, deg), _ell_sum_model(ml, nv, deg)])[:, :n]
    assert torch.equal(got[0][0], pe + sums[:d].T)
    assert torch.equal(got[0][1], pl + sums[d:].T.reshape(n, d, d))
    n_c, d_c = pe_c.shape
    assert torch.equal(got[1][0], pe_c + sum_c[:d_c].T)
    assert torch.equal(got[1][1], pl_c + sum_c[d_c:].T.reshape(n_c, d_c, d_c))
    for eta, lam, mean in got:
        assert torch.equal(mean, _solve_model(lam, eta))
    ref = M.update_beliefs_plain(*args, deg=deg)
    reorder = _reorder_gap(args, deg, got, ref)
    solve = [_solve_gap(lam, eta, mean) for eta, lam, mean in got]
    print(f"[beliefs] {name} {dt}: reorder {reorder:.3g} of its bound, solve {solve} of theirs")
    assert reorder <= 1.0 and max(solve) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("d_e, d_g, deg", [(3, 6, 1500), (6, 3, 300)])
def test_kernel_reads_rows_in_place_past_shared_memory(d_e, d_g, deg, dt):
    """Degrees whose one variable's rows exceed a block's shared memory
    (`belief_plan`'s ell_staged 0) read the rows in place, in the same
    order: the sums equal `_ell_sum_model`'s and the means `_solve_model`'s,
    bit for bit, on random operands with a padding variable."""
    dev, dtype = _card(), DTYPES[dt]
    gen = torch.Generator(device="cpu").manual_seed(deg)
    n_l, n_c = 5, 7
    rand = lambda *shape: torch.randn(*shape, generator=gen, dtype=dtype).to(dev)
    me, ml = rand(d_e, (n_l + 1) * deg), 1e-3 * rand(d_e * d_e, (n_l + 1) * deg)
    me[:, n_l * deg:], ml[:, n_l * deg:] = 0.0, 0.0

    def spd(n, d):
        a = rand(n, d, d)
        return a @ a.transpose(1, 2) + d * torch.eye(d, dtype=dtype, device=dev)

    args = (me, ml, rand(d_g + d_g * d_g, n_c) * 1e-3, rand(n_l, d_e), spd(n_l, d_e),
            rand(n_c, d_g), spd(n_c, d_g))
    plan = M.belief_plan(dtype, d_e=d_e, d_g=d_g, deg=deg, n_l=n_l, n_c=n_c)
    assert plan["ell_staged"] == 0 and plan["ell_vars"] >= 1
    got = M.update_beliefs(*args, deg=deg)
    sums = torch.cat([_ell_sum_model(me, n_l + 1, deg), _ell_sum_model(ml, n_l + 1, deg)])
    assert torch.equal(got[0][0], args[3] + sums[:d_e, :n_l].T)
    assert torch.equal(got[0][1], args[4] + sums[d_e:, :n_l].T.reshape(n_l, d_e, d_e))
    for eta, lam, mean in got:
        assert torch.equal(mean, _solve_model(lam, eta))


def _normwise(a, b):
    return ((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1e-30)).max().item()


# Largest normwise gap of the belief means between sweeps with the kernel
# and sweeps with the plain belief update, both on the card: only the order
# of the ELL sums and of the solve's small sums differs, amplified by the
# cavities of poorly seen landmarks in the first sweeps and carried through
# the later ones (float32 up to 2.1e-3 on the card, float64 up to 4.6e-12).
SWEEP_TOL = {"f64": 1e-9, "f32": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["deg64", "deg64_pad", "win6", "ell_cameras", "bal9_ell"])
def test_sweeps_with_the_kernel_track_the_plain_sweeps(name, dt):
    """1 and 20 sweeps through the kernel against the same sweeps with the
    plain belief update (the other kernels alike): the means within
    SWEEP_TOL; one launch a sweep, no plain call."""
    cmg, st0 = _prepared(name, DTYPES[dt], _card())
    for n in (1, 20):
        M.COUNTS.reset()
        got = P.run(cmg, st0, CFG, n)
        assert M.COUNTS.kernel["update_beliefs"] == n and not any(M.COUNTS.plain.values())
        real, P.update_beliefs = P.update_beliefs, M.update_beliefs_plain
        try:
            ref = P.run(cmg, st0, CFG, n)
        finally:
            P.update_beliefs = real
        gap = max(_normwise(a.mean, b.mean) for a, b in zip(got.v, ref.v))
        print(f"[beliefs] {name} {dt} {n} sweeps: mean gap {gap:.3g}")
        assert np.isfinite(gap) and gap <= SWEEP_TOL[dt]
