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
on_card` (marker `cuda`) holds them against these plain versions there, as
chip_smoke.py does at the bench scene.  The JAX reference is imported by
the fixture that needs it, so that on a machine with a card and no JAX the
card test runs alone:
    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
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
    graph, means = pba.build(sim, dtype=torch.float64)
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
    assert M.COUNTS.plain == dict.fromkeys(M.KERNELS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_kernels_match_plain_on_card(port, dtype, tol):
    """The CUDA kernels against their plain versions on identical CUDA
    inputs (the module fixture's state, cast to `dtype`); the camera sum
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _, cmg, st = port
    dev = torch.device("cuda")
    cast = lambda t: t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
    cmg = cmg._replace(**{k: cast(getattr(cmg, k)) for k in
                          ("z", "prec", "act", "gidx", "seg_rows", "seg_offsets")})
    st = P.CMState(
        v=tuple(type(v)(*(cast(t) for t in v)) for v in st.v),
        f=P.CMFactorState(*(tuple(cast(t) for t in x) if isinstance(x, tuple) else cast(x)
                            for x in st.f)))
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
