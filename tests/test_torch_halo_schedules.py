"""The port's schedules on the owner-sharded halo paths
(gbp_tpu_torch.parallel.schedules; the kernels' plain versions on the CPU)
against the JAX reference (gbp_tpu/parallel/schedules.py on a mesh of CPU
devices, Pallas in interpret mode) and against the port's one-device
schedules, float64.

Engines: the generic halo sweep and the CM halo sweep with the camera
table, on a 12-camera corridor cut in two, and the CM halo sweep with
camera windows on 32 merged blocks of 40 cameras cut in two (cut cameras
exist).  From a common state (the port's, handed over through `interop`):

  local means: equal (gathers of the same beliefs); scores 1e-12
    relative; wildfire and priority masks equal;
  one halo sweep under the reference's own random mask (drawn in JAX) and
    under a dead partition: 1e-10 relative on messages, factor state and
    beliefs, inactive rows kept bit for bit, since_relin counted up by one.

The reference's windowed `halo_cm.expand_means` takes the gathered-slot
means with `jnp.take` at the remapped ids of cut rows, which lie past the
local table: JAX fills them with NaN, so in the reference those rows score
NaN and never fire.  The port maps them back to their owned cameras
(parallel/halo_cm.py, `expand_means`).  On the windowed scene the masks
are held equal on every other row, the cut rows' means against the owned
cameras' beliefs, and the masks against the reference's formulas on the
repaired scores.

Runs, the reference's bars (tests/test_halo_schedules.py): halo wildfire
equals the reference's halo run and the port's one-device run to 1e-7
relative (12 sweeps; windowed: the one-device windowed run, 6 sweeps);
priority, random and dropout runs on the linear chain reach the dense MAP
to 1e-6; on the nonlinear corridor priority and dropout come within 5e-2
of the synchronous answer; seeded random runs repeat bit for bit.  The
`cuda` cases run one sweep of each halo runner on the card against the CPU
(float64 1e-11) and skip elsewhere.
"""
import functools

import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import schedules as PSch
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.parallel import halo, halo_cm
from gbp_tpu_torch.parallel import schedules as PHS

try:  # the card's machine has no JAX: only the cuda-marked cases run there
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from gbp_tpu.core import oracle as joracle
    from gbp_tpu.core import sweep as JS
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.parallel import halo as jhalo
    from gbp_tpu.parallel import halo_cm as jhcm
    from gbp_tpu.parallel import schedules as JHS
    from gbp_tpu.parallel import sharding
    from tests.test_sweep_linear import build_chain
except ImportError:
    jax = None

torch.set_num_threads(1)
CFG = dict(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8, message_form="pallas")
JCFG, PCFG = None if jax is None else JConfig(**CFG), GBPConfig(**CFG)
LIN = GBPConfig(eta_damping=0.0, num_undamped_iters=0, min_linear_iters=1)
PRIORS = dict(cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
BLOCKS = dict(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
ENGINES = ("generic", "cm_table", "cm_window")


def leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in leaves(o)]


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref).reshape(got.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def rel_means(port, ref):
    return max(rel(p, r) for p, r in zip(port, ref))


def corridor(seed, layout="none", jax_too=True):
    kw = dict(n_cams=12, lmks_per_cam=6, window=2, seed=seed)
    port = pba.build(pba.simulate_corridor(**kw), dtype=torch.float64, device="cpu",
                     layout=layout, **PRIORS)
    if not jax_too:
        return port
    return (*jba.build(jba.simulate_corridor(**kw), dtype=jnp.float64, layout=layout,
                       **PRIORS), *port)


def chain(n=12, seed=0):
    graph, means = build_chain(n=n, seed=seed)
    pg = interop.graph_from_numpy(jax.tree.map(np.asarray, graph), device="cpu")
    return graph, means, pg, tuple(torch.tensor(np.asarray(m)) for m in means)


def j_vs(d):
    return tuple(jhalo.VariableState(**{k: jnp.asarray(a) for k, a in v.items()}) for v in d)


def to_reference(state):
    """The port's halo state as the reference's (through interop)."""
    if isinstance(state, halo_cm.HaloCMState):
        d = interop.halo_cm_state_to_numpy(state)
        return jhcm.HaloCMState(v=j_vs(d["v"]), ghost=j_vs(d["ghost"]), f=jhcm.CMFactorState(
            **{k: jax.tree.map(jnp.asarray, a) for k, a in d["f"].items()}))
    d = interop.halo_state_to_numpy(state)
    return jhalo.HaloState(v=j_vs(d["v"]), ghost=j_vs(d["ghost"]), f=tuple(
        jhalo.FactorState(**jax.tree.map(jnp.asarray, f)) for f in d["f"]))


def ref_sweep(mesh, jgraph, jstate, active, cm):
    """One reference halo sweep with an explicit `active` mask (stacked over
    the chips), under shard_map as the reference's runners call it."""
    axis = mesh.axis_names[0]
    spec = lambda t: jhalo.shard_leading(t, axis)
    sweep_fn = jhcm._sweep_cm_halo if cm else jhalo._sweep_halo
    first = lambda t: jax.tree.map(lambda a: a[0], t)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(spec(jgraph), spec(jstate), JP(), spec(active)),
                       out_specs=spec(jstate), check_vma=False)
    def body(g, st, cfg, act):
        out = sweep_fn(first(g), first(st), cfg, axis, active=first(act))
        return jax.tree.map(lambda a: a[None], out)

    return body(jgraph, jstate, JCFG, active)


class HaloCase:
    """One halo engine: both packages' partitions, the port's state after
    `warm` synchronous sweeps, and the local means of `warm - 2` sweeps as
    the fire points."""

    def __init__(self, engine, warm=5):
        self.engine, self.cm = engine, engine != "generic"
        self.mesh = sharding.make_mesh(2)
        if engine == "cm_window":
            jg, jm = jba.build(jba.simulate_blocks(**BLOCKS), dtype=jnp.float64, **PRIORS)
            pg, pm = pba.build(pba.simulate_blocks(**BLOCKS), dtype=torch.float64,
                               device="cpu", **PRIORS)
        else:
            jg, jm, pg, pm = corridor(4)
        if self.cm:
            self.jhp, self.jgraph, _, _ = jhcm.distribute(jg, jm, self.mesh)
            self.php, self.pgraph, st, run = halo_cm.distribute(pg, pm, 2, device="cpu")
            assert bool(self.pgraph.win_w) == (engine == "cm_window")
            assert self.pgraph.win_w == self.jgraph.win_w
        else:
            self.jhp = jhalo.partition(jg, 2)
            self.jgraph = self.jhp.hgraph
            self.php, st, run = halo.distribute(pg, pm, 2, device="cpu")
            self.pgraph = self.php.hgraph
        before = run(self.pgraph, st, PCFG, warm - 2)
        self.state = run(self.pgraph, before, PCFG, 2)
        self.last = self.port_means(before)
        self.jstate = to_reference(self.state)

    def port_means(self, state):
        if self.cm:
            return (halo_cm.expand_means(self.pgraph, state),)
        return PHS._local_means(self.pgraph, state)

    def port_scores(self):
        if self.cm:
            return (PHS._scores_cm(self.port_means(self.state)[0], self.last[0]),)
        return PHS._scores(self.port_means(self.state), self.last)

    def ref_means(self, p):
        """Partition p's local means in the reference, [tdof, mp] (CM) or per
        fblock [m_loc, tdof]."""
        at = lambda t: jax.tree.map(lambda a: a[p], t)
        if self.cm:
            return (np.asarray(jhcm.expand_means(at(self.jgraph), at(self.jstate))).reshape(
                self.pgraph.dofs[0] + self.pgraph.dofs[1], -1),)
        hg = jax.tree.map(lambda a: a[p:p + 1], self.jgraph)
        return tuple(np.asarray(x) for x in JHS._local_means(jhalo._unstack(hg), at(
            self.jstate)))

    def cut_rows(self, p):
        """Rows of partition p whose gathered id names the cut extension."""
        g = self.pgraph
        if not (self.cm and g.win_w):
            return np.zeros(g.mp if self.cm else 0, bool)
        return g.gidx[p].numpy() >= g.comm[g.vb_g].n_own_max + g.win_ngp

    def valid(self):
        if self.cm:
            return (self.pgraph.act[:, 0] > 0.5,)
        return tuple(fb.valid for fb in self.pgraph.fblocks)

    def ks(self, frac):
        """The reference's top-k budgets (gbp_tpu/parallel/schedules.py,
        make_run_priority / make_run_priority_cm)."""
        if self.cm:
            act = np.asarray(self.jgraph.act)
            real = int(act.reshape(act.shape[0], -1).sum(1).max())
            return (max(1, min(int(frac * real), self.jgraph.mp)),)
        return tuple(max(1, min(int(frac * int(np.asarray(fb.valid).sum(1).max())),
                                fb.valid.shape[1])) for fb in self.jgraph.fblocks)


@pytest.fixture(scope="module")
def cases():
    return {}


def get_case(cases, engine):
    if engine not in cases:
        cases[engine] = HaloCase(engine)
    return cases[engine]


def mid_tau(ss):
    s = np.sort(np.concatenate([np.asarray(a).reshape(-1) for a in ss]))
    s = s[np.isfinite(s) & (s > 0)]
    i = len(s) // 2
    while s[i + 1] <= s[i] * (1 + 1e-6):
        i += 1
    return float(0.5 * (s[i] + s[i + 1]))


@pytest.mark.parametrize("engine", ENGINES)
def test_local_means_scores_and_masks_match_reference(cases, engine):
    c = get_case(cases, engine)
    port_x = c.port_means(c.state)
    n_parts = c.php.n_chips
    ref_s, n_cut = [], 0
    for p in range(n_parts):
        ref_x = c.ref_means(p)
        for b, (px, rx) in enumerate(zip(port_x, ref_x)):
            px = px[p].numpy()
            cut = c.cut_rows(p)
            if c.cm:
                np.testing.assert_array_equal(np.isnan(rx).any(0), cut)
            if cut.any():
                # The reference's cut rows are NaN; the port's read the owned
                # cameras' beliefs (the gathered slot's components).
                g = c.pgraph
                d_e = g.dofs[g.e]
                gsl = slice(d_e, None) if g.e == 0 else slice(0, g.dofs[0])
                own = g.cut_ids[p][g.gidx[p][cut].long() - (g.comm[g.vb_g].n_own_max
                                                            + g.win_ngp)]
                np.testing.assert_array_equal(
                    px[gsl][:, cut], c.state.v[g.vb_g].mean[p][own].T.numpy())
                rx = np.where(cut[None], px, rx)
                n_cut += int(cut.sum())
            np.testing.assert_array_equal(px, rx)
            last = c.last[b][p].numpy()
            d = rx - last
            ref_s.append(np.sqrt((d * d).sum(0 if c.cm else -1)))
    if engine == "cm_window":
        assert n_cut > 0
    port_s = c.port_scores()
    got = [s[p].numpy() for p in range(n_parts) for s in port_s]
    for g, r in zip(got, ref_s):
        assert rel(g, r) <= 1e-12
    tau = mid_tau(ref_s)
    ks = c.ks(0.5)
    valid = c.valid()
    for b, s in enumerate(port_s):
        wf = s > tau
        pr = PHS._priority_mask(s, valid[b], ks[b])
        assert 0 < int(wf.sum()) < wf.numel() and 0 < int(pr.sum()) < pr.numel()
        for p in range(n_parts):
            r = jnp.asarray(ref_s[p * len(port_s) + b])
            np.testing.assert_array_equal(wf[p].numpy(), np.asarray(r > tau))
            np.testing.assert_array_equal(pr[p].numpy(), np.asarray(
                JHS._priority_mask(r, jnp.asarray(valid[b][p].numpy()), ks[b])))
    if c.cm:
        assert PHS.priority_k_cm(c.pgraph, 0.5) == ks[0]
    else:
        assert PHS.priority_ks(c.php, 0.5) == ks


def check_kept(c, before, after, active):
    """Inactive rows keep their factor state and messages bit for bit and
    count since_relin up by one; returns how many there were."""
    if c.cm:
        off = ~(active[:, 0] & c.valid()[0])
        f_b, f_a = before.f, after.f
        for a, b in zip(leaves((f_b.lp, f_b.jac, f_b.r0, f_b.msg_eta, f_b.msg_lam)),
                        leaves((f_a.lp, f_a.jac, f_a.r0, f_a.msg_eta, f_a.msg_lam))):
            assert torch.equal(a.transpose(1, 2)[off], b.transpose(1, 2)[off])
        assert torch.equal(f_a.srel.transpose(1, 2)[off], f_b.srel.transpose(1, 2)[off] + 1)
        return int(off.sum())
    n = 0
    for fb, a_f, b_f, act in zip(c.pgraph.fblocks, after.f, before.f, active):
        off = ~(act & fb.valid)
        for a, b in zip(leaves((a_f.linpoint, a_f.jac, a_f.r0, a_f.msg_eta, a_f.msg_lam)),
                        leaves((b_f.linpoint, b_f.jac, b_f.r0, b_f.msg_eta, b_f.msg_lam))):
            assert torch.equal(a[off], b[off])
        assert torch.equal(a_f.since_relin[off], b_f.since_relin[off] + 1)
        n += int(off.sum())
    return n


def compare_halo(pst, jst, tol):
    cm = isinstance(pst, halo_cm.HaloCMState)
    back = (interop.halo_cm_state_from_numpy if cm else interop.halo_state_from_numpy)(
        jax.tree.map(np.asarray, jst), device="cpu")
    for a, b in zip(leaves(pst), leaves(back)):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            assert rel(a, b) <= tol


@pytest.mark.parametrize("mask", ["random", "dead"])
@pytest.mark.parametrize("engine", ["generic", "cm_table"])
def test_one_masked_halo_sweep_matches_reference(cases, engine, mask):
    c = get_case(cases, engine)
    key = jax.random.PRNGKey(11)
    comm = halo.LocalComm(2)
    if c.cm:
        shape = (2,) + c.jgraph.act.shape[1:]
        jmask = (jax.random.bernoulli(key, 0.5, shape) if mask == "random"
                 else jnp.zeros(shape, bool).at[1].set(True))
        active = torch.tensor(np.asarray(jmask).reshape(2, 1, -1))
        pst = halo_cm._sweep_cm_halo(c.pgraph, c.state, PCFG, comm, active=active)
    else:
        keys = jax.random.split(key, len(c.jgraph.fblocks))
        jmask = tuple(jax.random.bernoulli(k, 0.5, fb.valid.shape) if mask == "random"
                      else jnp.zeros(fb.valid.shape, bool).at[1].set(True)
                      for k, fb in zip(keys, c.jgraph.fblocks))
        active = tuple(torch.tensor(np.asarray(m)) for m in jmask)
        pst = halo._sweep_halo(c.pgraph, c.state, PCFG, comm, active=active)
    jst = ref_sweep(c.mesh, c.jgraph, c.jstate, jmask, c.cm)
    compare_halo(pst, jst, 1e-10)
    assert check_kept(c, c.state, pst, active) > 0


def test_dead_partition_is_frozen(cases):
    """While a partition is dead its factor rows keep every bit of their
    state but since_relin, which counts the sweeps."""
    for engine in ("generic", "cm_table"):
        c = get_case(cases, engine)
        if c.cm:
            run = PHS.make_run_chip_dropout_cm(c.pgraph)
            out = run(c.pgraph, c.state, PCFG, 3, 1, 3)
            for name in ("lp", "jac", "r0", "msg_eta", "msg_lam"):
                assert all(torch.equal(a[1], b[1]) for a, b in zip(
                    leaves(getattr(out.f, name)), leaves(getattr(c.state.f, name))))
            assert torch.equal(out.f.srel[1], c.state.f.srel[1] + 3)
            assert not torch.equal(out.f.msg_eta[0][0], c.state.f.msg_eta[0][0])
        else:
            run = PHS.make_run_chip_dropout(c.php)
            out = run(c.pgraph, c.state, PCFG, 3, 1, 3)
            for fb, a, b in zip(c.pgraph.fblocks, out.f, c.state.f):
                for x, y in zip(leaves((a.linpoint, a.jac, a.r0, a.msg_eta, a.msg_lam)),
                                leaves((b.linpoint, b.jac, b.r0, b.msg_eta, b.msg_lam))):
                    assert torch.equal(x[1], y[1])
                assert torch.equal(a.since_relin[1], b.since_relin[1] + 3)


# --- runs ----------------------------------------------------------------------------------


def test_wildfire_halo_matches_reference_and_one_device():
    jg, jm, pg, pm = corridor(4)
    mesh = sharding.make_mesh(2)
    jhp, jst, _ = jhalo.distribute(jg, jm, mesh)
    jst = JHS.make_run_wildfire(mesh, jhp, jst)(jhp.hgraph, jst, JCFG, 12, 1e-4)
    php, pst, _ = halo.distribute(pg, pm, 2, device="cpu")
    pst = PHS.make_run_wildfire(php)(php.hgraph, pst, PCFG, 12, 1e-4)
    got = halo.collect_means(php, pst)
    assert rel_means(got, jhalo.collect_means(jhp, jst)) <= 1e-7
    one = PSch.run_wildfire(pg, PS.init_state(pg, pm), PCFG, 12, 1e-4)
    assert rel_means(got, [v.mean for v in one.v]) <= 1e-7


def test_wildfire_halo_cm_matches_reference_and_one_device():
    jg, jm, pg, pm = corridor(5)
    mesh = sharding.make_mesh(2)
    jhp, jh, jst, _ = jhcm.distribute(jg, jm, mesh)
    jst = JHS.make_run_wildfire_cm(mesh, jh, jst)(jh, jst, JCFG, 12, 1e-4)
    php, ph, pst, _ = halo_cm.distribute(pg, pm, 2, device="cpu")
    assert ph.gather_mode == "table" and not ph.win_w
    pst = PHS.make_run_wildfire_cm(ph)(ph, pst, PCFG, 12, 1e-4)
    got = halo.collect_means(php, pst)
    assert rel_means(got, jhalo.collect_means(jhp, jst)) <= 1e-7
    ge, me = corridor(5, layout="ell", jax_too=False)
    cmg = sweep_cm.prepare(ge)
    one = sweep_cm.to_gbp_state(cmg, PSch.run_wildfire_cm(cmg, sweep_cm.init_state(cmg, me),
                                                          PCFG, 12, 1e-4))
    assert rel_means(got, [v.mean for v in one.v]) <= 1e-7


def test_windowed_halo_wildfire_matches_one_device():
    """Cut cameras exist: the windowed halo wildfire run equals the
    one-device windowed run (the reference's own would leave its cut rows
    unfired, see the module docstring)."""
    sim = pba.simulate_blocks(**BLOCKS)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", **PRIORS)
    ge, me = pba.build(sim, dtype=torch.float64, device="cpu", layout="ell", **PRIORS)
    php, ph, pst, _ = halo_cm.distribute(pg, pm, 2, device="cpu")
    assert ph.win_w and sum(ph.n_cut) > 0
    pst = PHS.make_run_wildfire_cm(ph)(ph, pst, PCFG, 6, 1e-4)
    cmg = sweep_cm.prepare(ge)
    assert cmg.win_w
    one = sweep_cm.to_gbp_state(cmg, PSch.run_wildfire_cm(cmg, sweep_cm.init_state(cmg, me),
                                                          PCFG, 6, 1e-4))
    assert rel_means(halo.collect_means(php, pst), [v.mean for v in one.v]) <= 1e-7


@pytest.mark.parametrize("kind", ["priority", "random", "dropout"])
def test_chain_halo_schedules_reach_the_map(kind):
    n, seed = {"priority": (12, 2), "random": (12, 6), "dropout": (16, 3)}[kind]
    graph, means, pg, pm = chain(n, seed)
    php, pst, _ = halo.distribute(pg, pm, 4, device="cpu")
    if kind == "priority":
        pst = PHS.make_run_priority(php, frac=0.5)(php.hgraph, pst, LIN, 200)
    elif kind == "random":
        run = PHS.make_run_random(php)
        a, b = (run(php.hgraph, pst, LIN, 250, 0.7, torch.Generator().manual_seed(0))
                for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
        pst = a
    else:
        pst = PHS.make_run_chip_dropout(php)(php.hgraph, pst, LIN, 200, 1, 40)
    want = np.asarray(joracle.map_solution(graph, JS.init_state(graph, means))[0])
    assert np.abs(halo.collect_means(php, pst)[0].numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("kind", ["priority", "dropout", "random"])
def test_cm_halo_schedules_approach_the_synchronous_answer(kind):
    """The nonlinear corridor at P = 4: priority (frac 0.75, 120 sweeps),
    partition 0 dead for 15 sweeps (150 sweeps) and random dropout (keep
    0.7, 200 sweeps; 5 sweeps repeat bit for bit) come within 5e-2 of 60
    synchronous sweeps, the reference's bar."""
    seed = {"priority": 6, "dropout": 7, "random": 6}[kind]
    pg, pm = corridor(seed, jax_too=False)
    php, ph, st, run_sync = halo_cm.distribute(pg, pm, 4, device="cpu")
    want = halo.collect_means(php, run_sync(ph, st, PCFG, 60))
    if kind == "priority":
        st = PHS.make_run_priority_cm(ph, frac=0.75)(ph, st, PCFG, 120)
    elif kind == "dropout":
        st = PHS.make_run_chip_dropout_cm(ph)(ph, st, PCFG, 150, 0, 15)
    else:
        run = PHS.make_run_random_cm(ph)
        a, b = (run(ph, st, PCFG, 5, 0.7, torch.Generator().manual_seed(0)) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
        st = run(ph, st, PCFG, 200, 0.7, torch.Generator().manual_seed(0))
    got = halo.collect_means(php, st)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w.numpy()).max() <= 5e-2


# --- on the card ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wildfire", "priority", "dropout"])
@pytest.mark.parametrize("engine", ["generic", "cm"])
def test_halo_schedule_on_card(engine, kind):
    """Three sweeps of a halo runner through the kernels against the same
    runner on the CPU (plain versions), float64, 1e-11."""
    dev = _card()
    pg, pm = corridor(4, jax_too=False)
    out = []
    for d in ("cpu", dev):
        if engine == "cm":
            _, hg, st, _ = halo_cm.distribute(pg, pm, 2, device=d)
            make = {"wildfire": PHS.make_run_wildfire_cm,
                    "priority": lambda h: PHS.make_run_priority_cm(h, 0.5),
                    "dropout": PHS.make_run_chip_dropout_cm}[kind]
            run = make(hg)
        else:
            hp, st, _ = halo.distribute(pg, pm, 2, device=d)
            hg = hp.hgraph
            make = {"wildfire": PHS.make_run_wildfire,
                    "priority": lambda h: PHS.make_run_priority(h, 0.5),
                    "dropout": PHS.make_run_chip_dropout}[kind]
            run = make(hp)
        extra = {"wildfire": (1e-4,), "priority": (), "dropout": (1, 2)}[kind]
        out.append(run(hg, st, PCFG, 3, *extra))
    for a, b in zip(leaves(out[1]), leaves(out[0])):
        a, b = a.cpu().double(), b.double()
        assert (a - b).abs().max() <= 1e-11 * max(float(b.abs().max()), 1e-300)
