"""The dense oracle's solve and the Gauss-Newton targets' options.

The oracle assembles the joint and solves it in float64 whatever the
graph's dtype: in float32 a bundle-adjustment joint (cond ~ 1e8) gives
noise at a thousandth of a pixel, and two runs of the same command line
printed different dense-MAP errors.  The Schur step takes every argument of
the reference's (`fi`, `cam_vi`, `lmk_vi`, full measurement precision,
Levenberg-Marquardt damping), as do `solve`, `gauss_newton_step_pcg` and
`solve_pcg`.

Tolerances: the float32 oracle equals the float64 solve of the same state's
float64 joint, cast to float32, bit for bit (it is that solve); the Schur
and PCG steps against the reference in float64 1e-9 (the same CG
iterations; segment sums add in another order)."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import oracle as joracle
from gbp_tpu.core.sweep import init_state as j_init_state
from gbp_tpu.models import ba as jba
from gbp_tpu.models import pose_graph as jpg
from gbp_tpu.parallel import schur as jschur
from gbp_tpu_torch import ba as cli
from gbp_tpu_torch.core import oracle, sweep
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import pose_graph as ppg
from gbp_tpu_torch.parallel import schur

torch.set_num_threads(1)
MAP_LINE = re.compile(r"dense-MAP avg reprojection error\s+([\d.]+) px")


def test_oracle_print_repeats_run_to_run(capsys):
    argv = ["--bal_file", "data/toy_ba.txt", "--n_iters", "20", "--oracle", "--device", "cpu"]
    prints, values = [], []
    for _ in range(2):
        out = cli.main(argv)
        prints.append(MAP_LINE.search(capsys.readouterr().out).group(1))
        values.append(out["are_map"])
    assert prints[0] == prints[1] and values[0] == values[1]


def test_map_solution_solves_float32_joints_in_float64():
    sim = pba.simulate(n_cams=8, n_lmks=120, seed=0)
    g, m = pba.build(sim, dtype=torch.float32, device="cpu")
    st = sweep.init_state(g, m)
    got = oracle.map_solution(g, st)
    eta, lam = oracle.dense_joint(g, st)
    assert eta.dtype == lam.dtype == torch.float64
    mu = torch.linalg.solve(lam, eta).to(torch.float32)
    o = 0
    for blk, vb in zip(got, g.vblocks):
        assert blk.dtype == torch.float32
        assert torch.equal(blk.reshape(-1), mu[o:o + vb.count * vb.dof])
        o += vb.count * vb.dof
    cov = oracle.marginal_covariances(g, st)
    assert all(c.dtype == torch.float32 and torch.isfinite(c).all() for c in cov)


# --- the Schur step's arguments ----------------------------------------------------------


@pytest.fixture(scope="module")
def ba_pair():
    sim = jba.simulate(n_cams=8, n_lmks=120, seed=1)
    jg, jm = jba.build(sim, dtype=jnp.float64, huber=2.0)
    pg, pm = pba.build(sim, dtype=torch.float64, device="cpu", huber=2.0)
    noise = np.random.default_rng(0)
    jm = tuple(jnp.asarray(np.asarray(a) + 0.01 * noise.standard_normal(a.shape)) for a in jm)
    pm = tuple(torch.tensor(np.asarray(a)) for a in jm)
    return jg, jm, pg, pm


def close(port, ref, tol=1e-9):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= tol * max(np.abs(b).max(), 1.0)


def swapped(g, means, fb_replace):
    """The graph with its variable blocks in the other order and the factor
    block twice (the second one the solver's), and the swapped means."""
    fb = fb_replace(g.fblocks[0], vblocks=(1, 0))
    return g.__class__(vblocks=(g.vblocks[1], g.vblocks[0]), fblocks=(fb, fb),
                       inboxes=None), (means[1], means[0])


@pytest.mark.parametrize("lm", [0.0, 0.5])
def test_schur_step_takes_block_indices_and_damping(ba_pair, lm):
    jg, jm, pg, pm = ba_pair
    jg2, jm2 = swapped(jg, jm, lambda fb, **kw: fb.replace(**kw))
    pg2, pm2 = swapped(pg, pm, dataclasses.replace)
    kw = dict(fi=1, cam_vi=1, lmk_vi=0, cg_iters=40, lm_damping=lm)
    close(schur.gauss_newton_step(pg2, pm2, **kw), jschur.gauss_newton_step(jg2, jm2, **kw))
    # The same step as the default arguments on the graph in its own order.
    close(schur.gauss_newton_step(pg2, pm2, **kw)[::-1],
          schur.gauss_newton_step(pg, pm, cg_iters=40, lm_damping=lm), 1e-12)


def test_schur_step_takes_full_precision(ba_pair):
    jg, jm, pg, pm = ba_pair
    m = pg.fblocks[0].count
    full = np.zeros((m, 2, 2))
    diag = pg.fblocks[0].prec.numpy()
    full[:, 0, 0], full[:, 1, 1] = diag[:, 0], diag[:, 1]
    full[:, 0, 1] = full[:, 1, 0] = 0.3 * np.sqrt(diag[:, 0] * diag[:, 1])
    jgf = jg.replace(fblocks=(jg.fblocks[0].replace(prec=jnp.asarray(full)),))
    pgf = dataclasses.replace(pg, fblocks=(dataclasses.replace(
        pg.fblocks[0], prec=torch.tensor(full)),))
    got = schur.solve(pgf, pm, n_steps=2, cg_iters=40, lm_damping=0.1)
    close(got, jschur.solve(jgf, jm, n_steps=2, cg_iters=40, lm_damping=0.1))


def test_pcg_steps_take_damping():
    sim = jpg.simulate_manhattan(n_poses=60, seed=2, loop_prob=0.5, loop_radius=3.0)
    jg, jm = jpg.build(sim, dtype=jnp.float64)
    pg, pm = ppg.build(sim, dtype=torch.float64, device="cpu")
    close(schur.gauss_newton_step_pcg(pg, pm, cg_iters=60, lm_damping=2.0),
          jschur.gauss_newton_step_pcg(jg, jm, cg_iters=60, lm_damping=2.0))
    close(schur.solve_pcg(pg, pm, n_steps=2, cg_iters=60, lm_damping=2.0),
          jschur.solve_pcg(jg, jm, n_steps=2, cg_iters=60, lm_damping=2.0))
    # Damping changes the step.
    plain = schur.gauss_newton_step_pcg(pg, pm, cg_iters=60)
    damped = schur.gauss_newton_step_pcg(pg, pm, cg_iters=60, lm_damping=2.0)
    assert not torch.allclose(plain[0], damped[0])


def test_oracle_matches_reference_in_float64(ba_pair):
    jg, jm, pg, pm = ba_pair
    got = oracle.map_solution(pg, sweep.init_state(pg, pm))
    close(got, joracle.map_solution(jg, j_init_state(jg, jm)), 1e-10)
