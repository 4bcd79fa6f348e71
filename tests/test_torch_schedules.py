"""The port's message schedules (gbp_tpu_torch.core.schedules: wildfire,
priority and random on the generic and the component-major engines; the
kernels' plain versions on the CPU) against the JAX reference
(gbp_tpu/core/schedules.py, Pallas in interpret mode), float64.

Engines: the generic row-major sweep (message_form="pallas", ELL layout,
6 cameras), the CM fast path with the camera table (the same scene) and
with camera windows (7 merged blocks of 40 cameras, locality sort on).
From a common state, the port's mid-run state and schedule state handed
to the reference through `interop`:

  scores: 1e-12 relative (the same sums of squares), +inf on sweep 1;
  wildfire and priority masks: equal;
  one `*_sweep`: 1e-10 relative on messages, factor state and beliefs,
    `last_x` equal (the fire points are the common state's means), every
    inactive row's factor state and messages kept bit for bit, its
    since_relin counted up by one;
  one sweep under the reference's own random mask (drawn in JAX): 1e-10.

Runs: wildfire with tau < 0 equals the synchronous run (1e-12 absolute on
the chain; bit for bit on the CM path, whose mask multiplies act by 1);
10 sweeps of each runner track the reference's run to 1e-6 absolute on the
means (beta-threshold relinearization and the score thresholds turn
roundoff into different decisions, as in tests/test_torch_generic.py);
wildfire, priority and random reach the dense MAP of the linear chain to
1e-6 (the reference's bar, tests/test_schedules.py); the CM runners equal
the port's generic runners to 1e-9 (wildfire) and 1e-8 (priority), the
reference's bars; seeded random runs repeat bit for bit.  The long runs
use the port alone.  The `cuda` cases run one schedule sweep of each engine
on the card against the CPU (float64 1e-11, float32 1e-4) and skip
elsewhere.
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import schedules as PSch
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core import sweep_cm as PC
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.ops import messages as M

try:  # the card's machine has no JAX: only the cuda-marked cases run there
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core import oracle as joracle
    from gbp_tpu.core import schedules as JSch
    from gbp_tpu.core import sweep as JS
    from gbp_tpu.core import sweep_cm as JC
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from tests.test_sweep_linear import build_chain
except ImportError:
    jax = None

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8, message_form="pallas")
JCFG, PCFG = None if jax is None else JConfig(**CFG), GBPConfig(**CFG)
LIN = dict(eta_damping=0.0, num_undamped_iters=0, min_linear_iters=1)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
BLOCKS7 = dict(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True)
ENGINES = ("generic", "cm_table", "cm_window")
WARM = 9  # wildfire sweeps before the common state: past min_linear_iters


def leaves(obj):
    """The tensors of a (nested) NamedTuple / tuple state, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in leaves(o)]


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def j_gbp_state(d):
    j = jnp.asarray
    return JS.GBPState(
        v=tuple(JS.VariableState(**{k: j(a) for k, a in v.items()}) for v in d["v"]),
        f=tuple(JS.FactorState(linpoint=j(f["linpoint"]), jac=j(f["jac"]), r0=j(f["r0"]),
                               msg_eta=tuple(j(a) for a in f["msg_eta"]),
                               msg_lam=tuple(j(a) for a in f["msg_lam"]),
                               since_relin=j(f["since_relin"])) for f in d["f"]))


def j_cm_state(d):
    f = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in d["f"].items()}
    return JC.CMState(v=tuple(JS.VariableState(**{k: jnp.asarray(a) for k, a in v.items()})
                              for v in d["v"]), f=JC.CMFactorState(**f))


class Case:
    """One engine at a common mid-run state in both packages."""

    def __init__(self, engine, jg, pg, ps, psched):
        self.engine, self.cm = engine, engine != "generic"
        self.jg, self.pg, self.ps, self.psched = jg, pg, ps, psched
        if self.cm:
            self.js = j_cm_state(interop.cm_state_to_numpy(ps))
            self.jsched = JSch.CMScheduleState(last_x=jnp.asarray(
                interop.cm_schedule_state_to_numpy(psched)["last_x"]))
        else:
            self.js = j_gbp_state(interop.gbp_state_to_numpy(ps))
            self.jsched = JSch.ScheduleState(last_x=tuple(
                jnp.asarray(a) for a in interop.schedule_state_to_numpy(psched)["last_x"]))

    # Scores and masks as tuples of 1-D arrays, one per factor block.
    def port_scores(self):
        if self.cm:
            return (PSch._scores_cm(self.pg, self.ps, self.psched)[0],)
        return PSch.scores(self.pg, self.ps, self.psched)

    def ref_scores(self):
        if self.cm:
            return (np.asarray(JSch._scores_cm(self.jg, self.js, self.jsched)[0]).reshape(-1),)
        return tuple(np.asarray(s) for s in JSch.scores(self.jg, self.js, self.jsched))

    def port_masks(self, kind, arg):
        if self.cm:
            fn = PSch.wildfire_mask_cm if kind == "wildfire" else PSch.priority_mask_cm
            return (fn(self.pg, self.ps, self.psched, arg)[0][0],)
        fn = PSch.wildfire_masks if kind == "wildfire" else PSch.priority_masks
        return fn(self.pg, self.ps, self.psched, arg)

    def ref_masks(self, kind, arg):
        if not self.cm:
            fn = JSch.wildfire_masks if kind == "wildfire" else JSch.priority_masks
            return tuple(np.asarray(m) for m in fn(self.jg, self.js, self.jsched, arg))
        # The reference's CM sweeps compute their masks inline
        # (gbp_tpu/core/schedules.py, wildfire_sweep_cm / priority_sweep_cm).
        s, _ = JSch._scores_cm(self.jg, self.js, self.jsched)
        if kind == "wildfire":
            return (np.asarray(s > arg).reshape(-1),)
        fb = self.jg.fb
        n_real = fb.n_valid if fb.n_valid is not None else fb.count
        s = jnp.where(self.jg.act[0] > 0.5, s, -jnp.inf)
        k = max(1, min(int(arg * n_real), self.jg.mp))
        return (np.asarray(s >= jax.lax.top_k(s.reshape(-1), k)[0][-1]).reshape(-1),)

    def port_sweep(self, kind, arg):
        if kind == "random":
            sweep = PC.sweep if self.cm else PS.sweep
            return sweep(self.pg, self.ps, PCFG, active=arg), self.psched
        name = f"{kind}_sweep" + ("_cm" if self.cm else "")
        return getattr(PSch, name)(self.pg, self.ps, self.psched, PCFG, arg)

    def ref_sweep(self, kind, arg):
        if kind == "random":
            sweep = JC.sweep if self.cm else JS.sweep
            return jax.jit(sweep)(self.jg, self.js, JCFG, arg), self.jsched
        name = f"{kind}_sweep" + ("_cm" if self.cm else "")
        fn = getattr(JSch, name)
        if kind == "priority":
            return jax.jit(fn, static_argnums=4)(self.jg, self.js, self.jsched, JCFG, arg)
        return jax.jit(fn)(self.jg, self.js, self.jsched, JCFG, arg)

    def valid(self):
        """Per block the rows a schedule may turn on (validity)."""
        if self.cm:
            return (self.pg.act[0] > 0.5,)
        return tuple(torch.ones(fb.count, dtype=torch.bool) if fb.valid is None else fb.valid
                     for fb in self.pg.fblocks)


def warm(engine, pg, pm, n=WARM, tau=1e-4):
    """The port's state and schedule state after n wildfire sweeps."""
    if engine == "generic":
        ps = PS.init_state(pg, pm)
        sched = PSch.init_schedule(pg, ps)
        step = PSch.wildfire_sweep
    else:
        ps = PC.init_state(pg, pm)
        sched = PSch.init_schedule_cm(pg, ps)
        step = PSch.wildfire_sweep_cm
    for _ in range(n):
        ps, sched = step(pg, ps, sched, PCFG, tau)
    return ps, sched


@pytest.fixture(scope="module")
def ba6():
    sim = pba.simulate(n_cams=6, n_lmks=50, seed=3)
    return (*jba.build(sim, dtype=jnp.float64, layout="ell"),
            *pba.build(sim, dtype=torch.float64, device="cpu", layout="ell"))


@pytest.fixture(scope="module")
def blocks7():
    sim = pba.simulate_blocks(**BLOCKS7)
    jg, jm = jba.build(sim, dtype=jnp.float64, layout="ell", **PRIORS)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    return jg, jm, pg, pm


@pytest.fixture(scope="module")
def cases(ba6, blocks7):
    """engine -> (the graph pair and means, {"first", "mid"} -> Case)."""
    out = {}
    for engine in ENGINES:
        jg, jm, pg, pm = blocks7 if engine == "cm_window" else ba6
        if engine != "generic":
            jg, pg = JC.prepare(jg, segsum_exact=True), PC.prepare(pg)
            assert bool(pg.win_w) == (engine == "cm_window") and pg.gather_mode == "table"
        n = 4 if engine == "cm_window" else WARM
        out[engine] = (jg, jm, pg, pm), {start: Case(engine, jg, pg, *warm(engine, pg, pm, k))
                                         for start, k in (("first", 0), ("mid", n))}
    return out


def mid_tau(ss):
    """A threshold halfway between two neighbouring finite scores near the
    median: a partial mask that no roundoff can flip."""
    s = np.sort(np.concatenate([np.asarray(a) for a in ss]))
    s = s[np.isfinite(s)]
    i = len(s) // 2
    while s[i + 1] <= s[i] * (1 + 1e-6):
        i += 1
    return float(0.5 * (s[i] + s[i + 1]))


@pytest.mark.parametrize("start", ["first", "mid"])
@pytest.mark.parametrize("engine", ENGINES)
def test_scores_and_masks_match_reference(cases, engine, start):
    c = cases[engine][1][start]
    ps, js = c.port_scores(), c.ref_scores()
    if start == "first":
        assert all(torch.isinf(s).all() and np.isinf(r).all() for s, r in zip(ps, js))
        tau = 1e-4
    else:
        for s, r in zip(ps, js):
            assert rel(s, r) <= 1e-12
        tau = mid_tau(js)
    for kind, arg in (("wildfire", tau), ("priority", 0.25), ("priority", 0.5)):
        got, ref = c.port_masks(kind, arg), c.ref_masks(kind, arg)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)
        if start == "mid":  # a partial mask, never an invalid row
            assert all(0 < int(g.sum()) < g.numel() for g in got)
            if kind == "priority":
                assert not any((g & ~v).any() for g, v in zip(got, c.valid()))


def check_kept(before, after, active, cm):
    """Inactive rows keep their factor state and messages bit for bit and
    count since_relin up by one."""
    if cm:
        off = ~active.reshape(-1)
        for a, b in zip((*before.f.msg_eta, *before.f.msg_lam, before.f.lp, before.f.jac,
                         before.f.r0), (*after.f.msg_eta, *after.f.msg_lam, after.f.lp,
                                        after.f.jac, after.f.r0)):
            assert torch.equal(a[:, off], b[:, off])
        assert torch.equal(after.f.srel[:, off], before.f.srel[:, off] + 1)
        return int(off.sum())
    n_off = 0
    for fb_b, fb_a, act in zip(before.f, after.f, active):
        off = ~act
        for a, b in zip((*fb_b.msg_eta, *fb_b.msg_lam, fb_b.linpoint, fb_b.jac, fb_b.r0),
                        (*fb_a.msg_eta, *fb_a.msg_lam, fb_a.linpoint, fb_a.jac, fb_a.r0)):
            assert torch.equal(a[off], b[off])
        assert torch.equal(fb_a.since_relin[off], fb_b.since_relin[off] + 1)
        n_off += int(off.sum())
    return n_off


def compare_states(ps, js, cm, tol):
    if cm:
        pf, jf = ps.f, js.f
        pairs = list(zip(pf.msg_eta + pf.msg_lam, jf.msg_eta + jf.msg_lam))
        pairs += [(getattr(pf, k), getattr(jf, k)) for k in ("lp", "jac", "r0")]
        np.testing.assert_array_equal(pf.srel.numpy(), np.asarray(jf.srel).reshape(
            pf.srel.shape))
    else:
        pairs = []
        for pf, jf in zip(ps.f, js.f):
            pairs += list(zip(pf.msg_eta + pf.msg_lam, jf.msg_eta + jf.msg_lam))
            pairs += [(getattr(pf, k), getattr(jf, k)) for k in ("linpoint", "jac", "r0")]
            np.testing.assert_array_equal(pf.since_relin.numpy(), np.asarray(jf.since_relin))
    pairs += [(getattr(pv, k), getattr(jv, k)) for pv, jv in zip(ps.v, js.v)
              for k in ("eta", "lam", "mean")]
    for a, b in pairs:
        assert rel(a, b) <= tol


@pytest.mark.parametrize("kind", ["wildfire", "priority", "random"])
@pytest.mark.parametrize("engine", ENGINES)
def test_one_schedule_sweep_matches_reference(cases, engine, kind):
    (jg, _, pg, _), by_start = cases[engine]
    c = by_start["mid"]
    if kind == "random":
        key = jax.random.PRNGKey(7)
        if c.cm:
            jmask = jax.random.bernoulli(key, 0.5, (1,) + jg.act.shape[1:])
            arg = torch.tensor(np.asarray(jmask).reshape(1, -1))
        else:
            jmask = JSch.random_masks(jg, key, 0.5)
            arg = tuple(torch.tensor(np.asarray(m)) for m in jmask)
        ps, _ = c.port_sweep(kind, arg)
        js, _ = c.ref_sweep(kind, jmask)
        active = arg
    else:
        arg = mid_tau(c.ref_scores()) if kind == "wildfire" else 0.5
        active = c.port_masks(kind, arg)
        M.COUNTS.reset()
        ps, psched = c.port_sweep(kind, arg)
        js, jsched = c.ref_sweep(kind, arg)
        if c.cm:
            np.testing.assert_array_equal(interop.cm_schedule_state_to_numpy(psched)["last_x"],
                                          np.asarray(jsched.last_x))
            active = active[0][None]
        else:
            for a, b in zip(psched.last_x, jsched.last_x):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # The masked sweep runs the same kernels as the synchronous one.
        assert not any(M.COUNTS.kernel.values()) and sum(M.COUNTS.plain.values()) > 0
    compare_states(ps, js, c.cm, 1e-10)
    valid = c.valid()
    if c.cm:
        on = active.reshape(-1) & valid[0]
    else:
        on = tuple(a & v for a, v in zip(active, valid))
    assert check_kept(c.ps, ps, on, c.cm) > 0


def test_schedule_state_converters(cases):
    for engine, to_np, from_np in (
            ("generic", interop.schedule_state_to_numpy, interop.schedule_state_from_numpy),
            ("cm_table", interop.cm_schedule_state_to_numpy,
             interop.cm_schedule_state_from_numpy)):
        c = cases[engine][1]["mid"]
        back = from_np(jax.tree.map(np.asarray, c.jsched), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(leaves(c.psched), leaves(back)))
        d = to_np(back)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
            jax.tree.leaves(d), jax.tree.leaves(c.jsched)))
    sched = cases["generic"][1]["first"].psched
    assert all(torch.isinf(a).all() and (a > 0).all() for a in sched.last_x)


@pytest.mark.parametrize("engine", ENGINES)
def test_priority_budget_counts_real_rows(cases, engine):
    """Never an invalid or pad row, at least one row per block, and a budget
    of frac x the real rows (mid-run scores have no ties)."""
    c = cases[engine][1]["mid"]
    valid = c.valid()
    for frac in (1e-9, 0.25, 0.5):
        for g, v in zip(c.port_masks("priority", frac), valid):
            n_real = int(v.sum())
            assert not (g & ~v).any()
            assert int(g.sum()) == max(1, int(frac * n_real))
            assert n_real < g.numel()  # the layout pads: the budget is not frac x rows
    # On sweep 1 every score is inf: the tie admits every real row, nothing else.
    for g, v in zip(cases[engine][1]["first"].port_masks("priority", 0.25), valid):
        assert torch.equal(g, v)


# --- runs ----------------------------------------------------------------------------------


def test_wildfire_below_zero_is_the_synchronous_schedule(ba6):
    graph, means = build_chain(seed=0)
    pg = interop.graph_from_numpy(jax.tree.map(np.asarray, graph), device="cpu")
    pm = tuple(torch.tensor(np.asarray(m)) for m in means)
    cfg = GBPConfig(**LIN)
    wf = PSch.run_wildfire(pg, PS.init_state(pg, pm), cfg, 20, -1.0)
    sync = PS.run(pg, PS.init_state(pg, pm), cfg, 20)
    assert (wf.v[0].mean - sync.v[0].mean).abs().max() <= 1e-12
    # On the CM path the all-true mask multiplies act by one: the same bits.
    _, _, pg, pm = ba6
    cmg = PC.prepare(pg)
    wf = PSch.run_wildfire_cm(cmg, PC.init_state(cmg, pm), PCFG, 12, -1.0)
    sync = PC.run(cmg, PC.init_state(cmg, pm), PCFG, 12)
    assert all(torch.equal(a, b) for a, b in zip(leaves(wf), leaves(sync)))


@pytest.mark.parametrize("kind,seed,n,arg", [("wildfire", 1, 150, 1e-6),
                                             ("priority", 2, 200, 0.5),
                                             ("random", 6, 250, 0.7)])
def test_linear_chain_schedules_reach_the_map(kind, seed, n, arg):
    graph, means = build_chain(seed=seed)
    pg = interop.graph_from_numpy(jax.tree.map(np.asarray, graph), device="cpu")
    st = PS.init_state(pg, tuple(torch.tensor(np.asarray(m)) for m in means))
    cfg = GBPConfig(**LIN)
    if kind == "random":
        st = PSch.run_random(pg, st, cfg, n, arg, torch.Generator().manual_seed(0))
    else:
        st = getattr(PSch, f"run_{kind}")(pg, st, cfg, n, arg)
    want = np.asarray(joracle.map_solution(graph, JS.init_state(graph, means))[0])
    assert np.abs(st.v[0].mean.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("kind,arg", [("wildfire", 1e-4), ("priority", 0.5)])
@pytest.mark.parametrize("engine", ["generic", "cm_table"])
def test_ten_schedule_sweeps_track_reference(cases, engine, kind, arg):
    (jg, jm, pg, pm), _ = cases[engine]
    name = f"run_{kind}" + ("" if engine == "generic" else "_cm")
    if engine == "generic":
        jst, pst = JS.init_state(jg, jm), PS.init_state(pg, pm)
    else:
        jst, pst = JC.init_state(jg, jm), PC.init_state(pg, pm)
    js = jax.jit(getattr(JSch, name), static_argnums=(3, 4))(jg, jst, JCFG, 10, arg)
    ps = getattr(PSch, name)(pg, pst, PCFG, 10, arg)
    for pv, jv in zip(ps.v, js.v):
        assert np.abs(pv.mean.numpy() - np.asarray(jv.mean)).max() <= 1e-6


def _ba_ell(seed):
    sim = pba.simulate(n_cams=6, n_lmks=50, seed=seed)
    return pba.build(sim, dtype=torch.float64, device="cpu", layout="ell"), sim


@pytest.mark.parametrize("kind,seed,n,arg,tol", [("wildfire", 3, 15, 1e-4, 1e-9),
                                                 ("priority", 4, 20, 0.5, 1e-8)])
def test_cm_runs_equal_the_generic_runs(kind, seed, n, arg, tol):
    (graph, means), _ = _ba_ell(seed)
    cmg = PC.prepare(graph)
    ref = getattr(PSch, f"run_{kind}")(graph, PS.init_state(graph, means), PCFG, n, arg)
    got = PC.to_gbp_state(cmg, getattr(PSch, f"run_{kind}_cm")(
        cmg, PC.init_state(cmg, means), PCFG, n, arg))
    for g, r in zip(got.v, ref.v):
        np.testing.assert_allclose(g.mean.numpy(), r.mean.numpy(), rtol=tol, atol=tol)


def test_random_cm_converges_and_repeats():
    (graph, means), sim = _ba_ell(5)
    cmg = PC.prepare(graph)
    runs = [PSch.run_random_cm(cmg, PC.init_state(cmg, means), PCFG, 100, 0.7,
                               torch.Generator().manual_seed(0)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0]), leaves(runs[1])))
    are = float(pba.avg_reprojection_error(graph, PC.to_gbp_state(cmg, runs[0]), k=sim["k"]))
    assert np.isfinite(are) and are < 1.5, are
    # The generic engine's random runs repeat too, and another seed differs.
    gen = lambda s: PSch.run_random(graph, PS.init_state(graph, means), PCFG, 5, 0.7,
                                    torch.Generator().manual_seed(s))
    a, b, c = gen(0), gen(0), gen(1)
    assert torch.equal(a.v[1].mean, b.v[1].mean) and not torch.equal(a.v[1].mean, c.v[1].mean)


def test_priority_diverges_on_merged_blocks_as_in_the_reference():
    """Priority at frac 0.5 on merged blocks (8 x 40 cameras, 8 landmarks
    per camera, windows) falls for its first sweeps, then diverges: in the
    reference as in the port.  The port's ARE after 10 sweeps equals the
    reference's to 1e-6 relative and is above the initial ARE; after 5 it
    is below."""
    kw = dict(n_blocks=8, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
    sim = pba.simulate_blocks(**kw)
    jg, jm = jba.build(jba.simulate_blocks(**kw), dtype=jnp.float64, layout="ell", **PRIORS)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    jc, pc = JC.prepare(jg, segsum_exact=True), PC.prepare(pg)
    assert pc.win_w and jc.win_w == pc.win_w
    are = lambda g, st: float(pba.avg_reprojection_error(g, st, k=sim["k"]))
    init = PC.init_state(pc, pm)
    are0 = are(pg, PC.to_gbp_state(pc, init))
    five, ten = (PC.to_gbp_state(pc, PSch.run_priority_cm(pc, init, PCFG, n, 0.5))
                 for n in (5, 10))
    js = jax.jit(JSch.run_priority_cm, static_argnums=(3, 4))(jc, JC.init_state(jc, jm), JCFG,
                                                               10, 0.5)
    jare = float(jba.avg_reprojection_error(jg, JC.to_gbp_state(jc, js), k=sim["k"]))
    assert are(pg, five) < are0 < are(pg, ten)
    assert abs(are(pg, ten) - jare) <= 1e-6 * jare


# --- on the card ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        items = [_to(o, dev) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wildfire", "priority"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
@pytest.mark.parametrize("engine", ["generic", "cm_table"])
def test_schedule_sweep_on_card(engine, dtype, tol, kind):
    """One schedule sweep through the kernels against the same sweep on the
    CPU (plain versions), from the same mid-run state."""
    dev = _card()
    sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
    g_cpu, m_cpu = pba.build(sim, dtype=dtype, device="cpu", layout="ell")
    g_dev, m_dev = pba.build(sim, dtype=dtype, device=dev, layout="ell")
    if engine != "generic":
        g_cpu, g_dev = PC.prepare(g_cpu), PC.prepare(g_dev)
    ps, sched = warm(engine, g_cpu, m_cpu)
    arg = 1e-4 if kind == "wildfire" else 0.5
    name = f"{kind}_sweep" + ("" if engine == "generic" else "_cm")
    ref, ref_sched = getattr(PSch, name)(g_cpu, ps, sched, PCFG, arg)
    M.COUNTS.reset()
    got, got_sched = getattr(PSch, name)(g_dev, _to(ps, dev), _to(sched, dev), PCFG, arg)
    assert sum(M.COUNTS.kernel.values()) > 0 and not any(M.COUNTS.plain.values())
    for a, b in zip(leaves(got), leaves(ref)):
        a, b = a.cpu().double(), b.double()
        assert (a - b).abs().max() <= tol * max(b.abs().max(), 1e-300)
    for a, b in zip(leaves(got_sched), leaves(ref_sched)):
        assert torch.equal(a.cpu(), b)
