"""Each fast-path kernel's plain PyTorch version against the JAX reference
kernel it replaces, on identical component-major inputs (float64, the
8-cam/120-landmark scene after 8 sweeps, carried across through
gbp_tpu_torch.interop).  The reference kernels run as the reference's own
CPU tests run them, with `interpret=True`.

Tolerances, relative to each output's magnitude:
  relinearization 1e-12: the same model in the same operation order;
  messages 1e-10: the 6x6 cavity inverses amplify operation-order roundoff
    (the reference selects table rows by one-hot matrix dots and fuses
    differently);
  camera sum 1e-12: the same addends summed in another order.

The CUDA kernels themselves run only on a card: `test_kernels_match_plain_
on_card` and `test_window_kernels_match_plain_on_card` (marker `cuda`) hold
them against these plain versions there, as chip_smoke.py does at the bench
and city scenes.  The JAX reference is imported by
the fixture that needs it, so that on a machine with a card and no JAX the
card test runs alone:
    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""
import types

import numpy as np
import pytest
import torch

import gbp_tpu_torch
from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep_cm as P
from gbp_tpu_torch.core.sweep import GBPConfig, _kernel_params
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
BETA = GBPConfig().beta


def rel(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    ref = ref.reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def port():
    """The port's graph and its plain-sweep state after 8 sweeps (8 =
    min_linear_iters: rows may relinearize in the next sweep)."""
    sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
    graph, means = pba.build(sim, dtype=torch.float64, device="cpu")
    cmg = P.prepare(graph)
    return sim, cmg, P.run(cmg, P.init_state(cmg, means), GBPConfig(**CFG), 8)


@pytest.fixture(scope="module")
def setup(port):
    """The port's state, and the same state in the JAX reference's layout
    with the reference sweep's kernel operands (sweep_cm.sweep, fused path)."""
    import jax.numpy as jnp

    from gbp_tpu.core import sweep_cm as J
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import VariableState as JVar
    from gbp_tpu.core.sweep import _kernel_params as j_kernel_params
    from gbp_tpu.models import ba as jba
    from gbp_tpu.ops import messages_pallas as mp

    sim, cmg, state = port
    jg, _ = jba.build(sim, dtype=jnp.float64)
    jcmg = J.prepare(jg, segsum_exact=True)
    assert jcmg.gather_mode == "table" and jcmg.ell_fused and not jcmg.win_w
    d = interop.cm_state_to_numpy(state)
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    jst = J.CMState(v=tuple(JVar(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d["v"]),
                    f=J.CMFactorState(**f))
    fb = jcmg.fb
    pk = J._pack_beliefs(jst.v[fb.vblocks[0]])
    lbtab, lmtab = J.ell_tables(jcmg, jst.v[fb.vblocks[1]])
    ncp = ((pk.shape[0] + mp.LANE - 1) // mp.LANE) * mp.LANE
    tab = jnp.swapaxes(jnp.pad(pk, ((0, ncp - pk.shape[0]), (0, 0))), 0, 1)
    fs = jst.f

    def relin(beta):
        return mp.fused_relin_cm_tab_ell(
            j_kernel_params(JConfig(beta=beta, **CFG), jnp.float64), jcmg.ell_starts, lmtab,
            tab[M.F_CAM:], jcmg.gidx_cm, jcmg.z, jcmg.args, fs.lp, fs.jac, fs.r0, fs.srel,
            jcmg.act, d0=6, d1=3, z=2, comp_name=fb.ftype.name, n_args=0, gslot=0,
            deg=fb.ell_deg, ell_w2=jcmg.ell_w2, interpret=True)

    ref = types.SimpleNamespace(jnp=jnp, mp=mp, jcmg=jcmg, jst=jst, lbtab=lbtab,
                                btab=tab[:M.F_CAM], relin_with=relin, relin=relin(BETA),
                                params=j_kernel_params(JConfig(**CFG), jnp.float64))
    return cmg, state, ref


def median_beta(cmg, st):
    """The median linearization-point distance of the valid rows: as beta it
    splits them into rows that relinearize and rows that do not."""
    cam_mean, lmk_mean, _, _ = P.belief_tables(cmg, st)
    rows = torch.arange(cmg.mp, device=cmg.gidx.device) // cmg.fb.ell_deg
    x = torch.cat([cam_mean[cmg.gidx.long()], lmk_mean[rows]], 1).T
    dist = ((x - st.f.lp) ** 2).sum(0).sqrt()[cmg.act[0] > 0.5]
    return float(dist.double().median())


@pytest.mark.parametrize("which", ["config", "median"])
def test_relin_plain_matches_reference(setup, which):
    """At the config's beta every valid row relinearizes after 8 sweeps; at
    the median distance half of them do, so the beta decision is exercised
    both ways on real rows."""
    cmg, st, ref = setup
    beta = BETA if which == "config" else median_beta(cmg, st)
    params = _kernel_params(GBPConfig(beta=beta, **CFG), torch.float64)
    cam_mean, lmk_mean, _, _ = P.belief_tables(cmg, st)
    fs = st.f
    got = M.relin_cm_tab_ell_plain(params, cam_mean, lmk_mean, cmg.gidx, cmg.z, fs.lp, fs.jac,
                                   fs.r0, fs.srel, cmg.act, deg=cmg.fb.ell_deg)
    for g, r in zip(got, ref.relin_with(beta)):
        assert rel(g, r) <= 1e-12
    n_relin, n_valid = int((got[3] == 0).sum()), int(cmg.act.sum())
    assert n_relin == n_valid if which == "config" else 0 < n_relin < n_valid


@pytest.mark.parametrize("huber", [None, 1.0])
def test_messages_plain_matches_reference(setup, huber):
    """All five outputs, with every 5th row switched off (act = 0): those
    rows must pass their old messages through unchanged."""
    cmg, st, ref = setup
    params = _kernel_params(GBPConfig(**CFG), torch.float64)
    _, _, cam_tab, lmk_tab = P.belief_tables(cmg, st)
    lp, jac, r0, srel = ref.relin
    to_port = lambda a: torch.tensor(np.asarray(a).reshape(a.shape[0], -1))
    act = cmg.act.clone()
    act[0, ::5] = 0.0
    fs = st.f
    got = M.messages_cm_tab_ell_plain(
        params, cam_tab, lmk_tab, cmg.gidx, to_port(jac), to_port(lp), to_port(r0), cmg.prec,
        to_port(srel), act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
        cmg.seg_rows, cmg.seg_offsets, deg=cmg.fb.ell_deg, huber=huber)
    jcmg, jf = ref.jcmg, ref.jst.f
    out = ref.mp.fused_messages_cm_tab_ell(
        ref.params, jcmg.ell_starts, jac, lp, r0, jcmg.prec, srel,
        ref.jnp.asarray(act.numpy().reshape(jcmg.act.shape)), ref.lbtab, ref.btab,
        jcmg.gidx_cm, jf.msg_eta[0], jf.msg_lam[0], jf.msg_eta[1], jf.msg_lam[1],
        d0=6, d1=3, z=2, prec_full=False, huber=huber, gslot=0, deg=cmg.fb.ell_deg,
        ell_w2=jcmg.ell_w2, exact=True, interpret=True)
    n_cam = cmg.base.vblocks[0].count
    for g, r in zip(got[:4], out[:4]):
        assert rel(g, r) <= 1e-10
    assert rel(got[4], np.asarray(out[4])[:, :n_cam]) <= 1e-10
    off = act[0] == 0
    olds = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for g, old in zip(got[:4], olds):
        assert torch.equal(g[:, off], old[:, off])
        assert not torch.equal(g[:, ~off], old[:, ~off])


def test_segsum_plain_matches_reference(setup):
    cmg, st, ref = setup
    me, ml = st.f.msg_eta[0], st.f.msg_lam[0]
    n_cam = cmg.base.vblocks[0].count
    got = M.segsum_by_id_plain(me, ml, cmg.seg_rows, cmg.seg_offsets)
    cm = lambda a: ref.jnp.asarray(a.numpy().reshape(a.shape[0], -1, ref.mp.LANE))
    out = ref.mp.segsum_cm(cm(me), cm(ml), cm(cmg.gidx[None]), n_seg=n_cam, exact=True,
                           interpret=True)
    assert got.shape == (M.F_CAM, n_cam)
    assert rel(got, out) <= 1e-12


def test_cpu_tensors_take_the_plain_versions(port):
    """On CPU tensors the wrappers run the plain versions, counted as such;
    no kernel launch is counted."""
    _, cmg, st = port
    M.COUNTS.reset()
    P.sweep(cmg, st, GBPConfig(**CFG))
    assert M.COUNTS.kernel == dict.fromkeys(M.KERNELS, 0)
    full_table = ("relin_cm_tab_ell", "messages_cm_tab_ell", "segsum_by_id")
    assert M.COUNTS.plain == {k: int(k in full_table) for k in M.KERNELS}


def _on_card(cmg, st, dtype):
    """The CM graph's tensors and the state on the card in `dtype`."""
    dev = torch.device("cuda")
    cast = lambda t: t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
    cmg = cmg._replace(**{k: cast(v) for k, v in cmg._asdict().items()
                          if isinstance(v, torch.Tensor)})
    st = P.CMState(
        v=tuple(type(v)(*(cast(t) for t in v)) for v in st.v),
        f=P.CMFactorState(*(tuple(cast(t) for t in x) if isinstance(x, tuple) else cast(x)
                            for x in st.f)))
    return cmg, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_kernels_match_plain_on_card(port, dtype, tol):
    """The CUDA kernels against their plain versions on identical CUDA
    inputs (the module fixture's state, cast to `dtype`); the camera sum
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _, cmg, st = port
    cmg, st = _on_card(cmg, st, dtype)
    params = _kernel_params(GBPConfig(**CFG), dtype)
    cam_mean, lmk_mean, cam_tab, lmk_tab = P.belief_tables(cmg, st)
    fs, deg = st.f, cmg.fb.ell_deg
    for beta in (BETA, median_beta(cmg, st)):
        r_args = (_kernel_params(GBPConfig(beta=beta, **CFG), dtype), cam_mean, lmk_mean,
                  cmg.gidx, cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        ref_r = M.relin_cm_tab_ell_plain(*r_args, deg=deg)
        for g, r in zip(M.relin_cm_tab_ell(*r_args, deg=deg), ref_r):
            assert rel(g, r) <= tol
    m_args = (params, cam_tab, lmk_tab, cmg.gidx, ref_r[1], ref_r[0], ref_r[2], cmg.prec,
              ref_r[3], cmg.act, fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1],
              cmg.seg_rows, cmg.seg_offsets)
    for huber in (None, 1.0):
        ref_m = M.messages_cm_tab_ell_plain(*m_args, deg=deg, huber=huber)
        for g, r in zip(M.messages_cm_tab_ell(*m_args, deg=deg, huber=huber), ref_m):
            assert rel(g, r) <= tol
    s_args = (ref_m[0], ref_m[1], cmg.seg_rows, cmg.seg_offsets)
    got = M.segsum_by_id(*s_args)
    assert rel(got, M.segsum_by_id_plain(*s_args)) <= tol
    assert torch.equal(got, M.segsum_by_id(*s_args))
    # A CUDA tensor the kernel does not take raises; nothing falls back.
    bad_inputs = (
        {"gidx": cmg.gidx.long()},
        {"lp": fs.lp.T.contiguous().T},
        {"z": cmg.z.cpu()},
    )
    names = ("params", "cam_mean", "lmk_mean", "gidx", "z", "lp")
    for bad in bad_inputs:
        args = list(r_args)
        for k, v in bad.items():
            args[names.index(k)] = v
        with pytest.raises(ValueError):
            M.relin_cm_tab_ell(*args, deg=deg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_window_kernels_match_plain_on_card(dtype, tol):
    """The four windowed CUDA kernels against their plain versions on
    identical CUDA inputs (7 blocks of 40 cameras after 8 plain sweeps); the
    window partials and their combination repeat bit for bit; a window
    beyond one block's shared memory is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sim = pba.simulate_blocks(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0,
                              shuffle=True)
    graph, means = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell",
                             cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
    cmg = P.prepare(graph, window=True)
    assert cmg.win_w > 0 and cmg.vperm is not None
    st = P.run(cmg, P.init_state(cmg, means), GBPConfig(**CFG), 8)
    cmg, st = _on_card(cmg, st, dtype)
    cam_mean, lmk_mean, cam_tab, lmk_tab = P.belief_tables(cmg, st)
    fs, deg = st.f, cmg.fb.ell_deg
    kw = dict(deg=deg, win_w=cmg.win_w)
    for beta in (BETA, median_beta(cmg, st)):
        r_args = (_kernel_params(GBPConfig(beta=beta, **CFG), dtype), cam_mean, lmk_mean,
                  cmg.gidx, cmg.win_starts, cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        ref_r = M.relin_cm_tabblk_ell_plain(*r_args, **kw)
        for g, r in zip(M.relin_cm_tabblk_ell(*r_args, **kw), ref_r):
            assert rel(g, r) <= tol
    m_args = (_kernel_params(GBPConfig(**CFG), dtype), cam_tab, lmk_tab, cmg.gidx,
              cmg.win_starts, ref_r[1], ref_r[0], ref_r[2], cmg.prec, ref_r[3], cmg.act,
              fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1], cmg.win_rows,
              cmg.win_offsets)
    for huber in (None, 1.0):
        ref_m = M.messages_cm_tabblk_ell_plain(*m_args, huber=huber, **kw)
        for g, r in zip(M.messages_cm_tabblk_ell(*m_args, huber=huber, **kw), ref_m):
            assert rel(g, r) <= tol
    b_args = (ref_m[0], ref_m[1], cmg.win_rows, cmg.win_offsets)
    b_kw = dict(n_tiles=cmg.mp // M.TILE, w=cmg.win_w)
    part = M.segsum_cm_blk(*b_args, **b_kw)
    assert rel(part, M.segsum_cm_blk_plain(*b_args, **b_kw)) <= tol
    assert torch.equal(part, M.segsum_cm_blk(*b_args, **b_kw))
    n_cam = cam_mean.shape[0]
    s_args = (part, cmg.win_starts, cmg.blk_tiles, cmg.blk_offsets)
    got = M.scatter_windows_cm(*s_args, n_seg=n_cam)
    cover = M.cover_lists(cmg.win_starts, cmg.win_w, n_cam)
    assert rel(got, M.scatter_windows_cm_plain(part, cmg.win_starts, *cover, n_seg=n_cam)) <= tol
    assert rel(got, M.segsum_by_id_plain(ref_m[0], ref_m[1], cmg.seg_rows, cmg.seg_offsets)) <= tol
    assert torch.equal(got, M.scatter_windows_cm(*s_args, n_seg=n_cam))
    # A window that cannot fit one block's shared memory raises, with the numbers.
    with pytest.raises(ValueError, match="bytes of shared memory"):
        M.messages_cm_tabblk_ell(*m_args, huber=None, deg=deg, win_w=4096)


# --- the default device ---------------------------------------------------------------


def test_default_device_is_the_card_or_raises():
    """No quiet move to the CPU: without a card `default_device()` and every
    entry point given device=None raise, naming the problem."""
    if torch.cuda.is_available():
        assert gbp_tpu_torch.default_device().type == "cuda"
        return
    sim = pba.simulate(n_cams=4, n_lmks=20, seed=0)
    for call in (gbp_tpu_torch.default_device,
                 lambda: gbp_tpu_torch.resolve_device(None),
                 lambda: pba.build(sim),
                 lambda: interop.cm_state_from_numpy(None),
                 lambda: interop.graph_from_numpy(None)):
        with pytest.raises(RuntimeError, match="no CUDA device is present"):
            call()


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_an_explicit_cpu_device_is_honoured(device):
    assert gbp_tpu_torch.resolve_device(device) == torch.device("cpu")
    sim = pba.simulate(n_cams=4, n_lmks=20, seed=0)
    graph, means = pba.build(sim, dtype=torch.float64, device=device)
    tensors = [means[0], graph.vblocks[0].prior_eta, graph.fblocks[0].z, graph.fblocks[0].adj[0]]
    cmg = P.prepare(graph)
    st = P.init_state(cmg, means)
    tensors += [cmg.z, cmg.gidx, cmg.seg_rows, st.f.lp, st.v[1].mean]
    back = interop.cm_state_from_numpy(types.SimpleNamespace(
        v=[types.SimpleNamespace(**d) for d in interop.cm_state_to_numpy(st)["v"]],
        f=types.SimpleNamespace(**interop.cm_state_to_numpy(st)["f"])), device=device)
    tensors += [back.f.jac, back.v[0].eta]
    assert all(t.device.type == "cpu" for t in tensors)
