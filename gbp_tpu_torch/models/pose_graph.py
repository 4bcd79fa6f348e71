"""Pose-graph SLAM: synthetic worlds, graph building and the ATE metric.

Counterpart of gbp_tpu/models/pose_graph.py.  Variables are SE(2) poses
[x, y, theta] with `se2_between` factors (odometry and loop closures,
angle-wrapped residuals) or SE(3) poses [t, omega] with `se3_between`
factors; a strong prior anchors pose 0 (gauge freedom).

`simulate_manhattan` and `simulate_helix` are the reference's numpy code
with the same `numpy.random.Generator` call order, so a seed gives the same
scene in both packages; where the reference calls its JAX Lie helpers, the
port's `utils.lie` runs on the CPU in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch.core.graph import GraphBuilder
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.factors import odometry, se3
from gbp_tpu_torch.utils.lie import se2_compose, se2_relative, so3_exp, so3_log


def _f64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def simulate_manhattan(
    n_poses=200,
    step=1.0,
    odom_sigma=(0.05, 0.05, 0.02),
    loop_sigma=(0.03, 0.03, 0.01),
    loop_prob=0.2,
    loop_radius=2.0,
    outlier_frac=0.0,
    seed=0,
):
    """Random Manhattan-world trajectory with noisy odometry + loop closures.

    Returns a dict with ground-truth poses, odometry measurements (i -> i+1),
    loop-closure pairs + measurements, and noisy initial estimates obtained
    by integrating the odometry.  Draws, in order: one turn per pose, the
    odometry noise, one uniform per pose (and one choice per closure), the
    loop noise, the outliers."""
    rng = np.random.default_rng(seed)
    odom_sigma = np.asarray(odom_sigma)
    loop_sigma = np.asarray(loop_sigma)

    # Ground truth: unit steps, occasional 90-degree turns.
    truth = np.zeros((n_poses, 3))
    for i in range(1, n_poses):
        turn = rng.choice([0.0, np.pi / 2, -np.pi / 2], p=[0.7, 0.15, 0.15])
        heading = truth[i - 1, 2] + turn
        truth[i] = [
            truth[i - 1, 0] + step * np.cos(heading),
            truth[i - 1, 1] + step * np.sin(heading),
            heading,
        ]

    # Odometry: relative pose truth_i^-1 * truth_{i+1} + noise.
    rel = se2_relative(_f64(truth[:-1]), _f64(truth[1:])).numpy()
    odom_z = rel + odom_sigma * rng.standard_normal(rel.shape)
    odom_ij = np.stack([np.arange(n_poses - 1), np.arange(1, n_poses)], axis=1)

    # Loop closures between spatially-near, temporally-distant poses.
    loops = []
    for i in range(n_poses):
        if rng.random() > loop_prob:
            continue
        d = np.linalg.norm(truth[:, :2] - truth[i, :2], axis=1)
        cand = np.flatnonzero((d < loop_radius) & (np.arange(n_poses) < i - 10))
        if cand.size:
            loops.append((int(rng.choice(cand)), i))
    loop_ij = np.asarray(loops, dtype=np.int64).reshape(-1, 2)
    if loop_ij.shape[0]:
        lrel = se2_relative(_f64(truth[loop_ij[:, 0]]), _f64(truth[loop_ij[:, 1]])).numpy()
        loop_z = lrel + loop_sigma * rng.standard_normal(lrel.shape)
        # Optional gross outliers (Huber robustness).
        n_out = int(outlier_frac * loop_z.shape[0])
        if n_out:
            idx = rng.choice(loop_z.shape[0], n_out, replace=False)
            loop_z[idx, :2] += rng.standard_normal((n_out, 2)) * 5.0
            loop_z[idx, 2] += rng.standard_normal(n_out) * 1.5
    else:
        loop_z = np.zeros((0, 3))

    # Initial estimate: integrate noisy odometry from the origin.
    init = np.zeros_like(truth)
    for i in range(1, n_poses):
        init[i] = se2_compose(_f64(init[i - 1]), _f64(odom_z[i - 1])).numpy()

    return dict(
        truth=truth, odom_z=odom_z, odom_ij=odom_ij, loop_z=loop_z, loop_ij=loop_ij,
        odom_sigma=odom_sigma, loop_sigma=loop_sigma, init=init,
    )


def build(
    sim: dict,
    huber=2.0,
    anchor_prec=1e6,
    prior_prec=1e-5,
    dtype=torch.float32,
    merged=True,
    layout="none",
    device=None,
):
    """Build the pose graph on `device` (None: the card); returns (graph,
    init_means).

    Pose 0 is anchored with a strong prior (gauge); every other pose gets a
    weak prior at its initial estimate.  Loop closures are
    Huber-robustified, odometry is not.

    merged=True (default) emits odometry + loop closures as ONE factor block
    with per-factor Huber thresholds (0 = off for odometry); merged=False
    keeps the two-block layout.  The component-major fast path
    (core/sweep_cm.py) needs the merged block and layout="ell"."""
    init = np.asarray(sim["init"])
    b = GraphBuilder(dtype=dtype, device=device)
    v = b.add_variables("pose", init, prior_prec=prior_prec)
    b.set_prior(v, 0, init[0], anchor_prec)
    n_loop = sim["loop_ij"].shape[0]
    if merged and n_loop:
        ij = np.concatenate([sim["odom_ij"], sim["loop_ij"]])
        z = np.concatenate([sim["odom_z"], sim["loop_z"]])
        sigma = np.concatenate([
            np.broadcast_to(sim["odom_sigma"], sim["odom_z"].shape),
            np.broadcast_to(sim["loop_sigma"], sim["loop_z"].shape),
        ])
        hub = None
        if huber is not None:
            hub = np.concatenate([np.zeros(sim["odom_z"].shape[0]),
                                  np.full(n_loop, float(huber))])
        b.add_factors("between", odometry.se2_between(), [(v, ij[:, 0]), (v, ij[:, 1])], z,
                      sigma=sigma, huber=hub)
        return b.build(layout=layout)
    b.add_factors(
        "odom", odometry.se2_between(),
        [(v, sim["odom_ij"][:, 0]), (v, sim["odom_ij"][:, 1])], sim["odom_z"],
        sigma=np.broadcast_to(sim["odom_sigma"], sim["odom_z"].shape))
    if n_loop:
        b.add_factors(
            "loop", odometry.se2_between(),
            [(v, sim["loop_ij"][:, 0]), (v, sim["loop_ij"][:, 1])], sim["loop_z"],
            sigma=np.broadcast_to(sim["loop_sigma"], sim["loop_z"].shape), huber=huber)
    return b.build(layout=layout)


def build_g2o(
    data: dict,
    huber=None,
    anchor_prec=1e6,
    prior_prec=1e-5,
    dtype=torch.float32,
    layout="none",
    device=None,
):
    """Build a pose graph from a parsed g2o file (`io.g2o.read_g2o` dict) on
    `device` (None: the card); returns (graph, init_means).

    SE(2) ([x, y, theta] poses, `se2_between`) and SE(3) ([t, omega] poses,
    `se3_between`) with the file's per-edge information matrices.  Exactly
    diagonal information matrices are collapsed to diagonal precision, which
    makes the graph eligible for the component-major fast path under
    layout="ell".  Pose 0 is anchored."""
    init = np.asarray(data["poses"])
    b = GraphBuilder(dtype=dtype, device=device)
    v = b.add_variables("pose", init, prior_prec=prior_prec)
    b.set_prior(v, 0, init[0], anchor_prec)
    ftype = odometry.se2_between() if data["kind"] == "se2" else se3.se3_between()
    ij = np.asarray(data["edges_ij"])
    if ij.shape[0]:
        prec = np.asarray(data["edges_info"])
        if prec.ndim == 3:
            diag = np.einsum("mii->mi", prec)
            if (prec == diag[:, :, None] * np.eye(prec.shape[-1])).all():
                prec = diag
        b.add_factors("between", ftype, [(v, ij[:, 0]), (v, ij[:, 1])], data["edges_z"],
                      prec=prec, huber=huber)
    return b.build(layout=layout)


def default_config() -> GBPConfig:
    """Recommended GBP knobs for pose graphs: unlike BA (bipartite, diameter
    2) pose graphs have O(n) diameter, and damping BOTH eta and lam keeps the
    implied means a convex mix of old and new through the long
    information-propagation transient (eta-only damping diverges once
    relinearization picks up the biased means)."""
    return GBPConfig(eta_damping=0.4, lam_damping=0.4, num_undamped_iters=3,
                     min_linear_iters=5, beta=0.05)


def ate(est, truth):
    """Absolute trajectory error (RMSE of positions) after rigid (Umeyama)
    alignment, so the gauge does not pollute the metric.  Positions are xy
    for SE(2) states [x, y, theta] and xyz for SE(3) states [t, omega]."""
    est = est.detach().cpu().numpy() if isinstance(est, torch.Tensor) else np.asarray(est)
    truth = np.asarray(truth)
    d = 2 if est.shape[1] == 3 else 3
    est_p = est[:, :d].astype(np.float64)
    truth_p = truth[:, :d]
    mu_e = est_p.mean(0)
    mu_t = truth_p.mean(0)
    e = est_p - mu_e
    t = truth_p - mu_t
    cov = t.T @ e / len(e)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(d)
    if np.linalg.det(u @ vt) < 0:
        s[-1, -1] = -1
    rot = u @ s @ vt
    aligned = e @ rot.T + mu_t
    return float(np.sqrt(np.mean(np.sum((aligned - truth_p) ** 2, axis=1))))


def simulate_helix(n_poses=60, seed=0, odom_sigma=0.02, loop_every=7, init_noise=0.05):
    """Synthetic 3D (SE(3)) world: helical trajectory, odometry + periodic
    loop closures, diagonal edge information.  Returns a `build_g2o`-style
    dict (kind="se3") plus ground truth."""
    r_of = lambda w: so3_exp(_f64(w)).numpy()
    log_of = lambda r: so3_log(_f64(r)).numpy()
    rng = np.random.default_rng(seed)
    truth = np.zeros((n_poses, 6))  # [t (3), omega (3)]
    t, w = np.zeros(3), np.zeros(3)
    for i in range(1, n_poses):
        step_t = np.array([1.0, 0.1 * np.sin(i * 0.5), 0.15])
        step_w = np.array([0.0, 0.02, 0.2])
        r1 = r_of(w)
        t = t + r1 @ step_t
        w = log_of(r1 @ r_of(step_w))
        truth[i] = np.concatenate([t, w])

    def relative(i, j):
        ri = r_of(truth[i, 3:])
        dt = ri.T @ (truth[j, :3] - truth[i, :3])
        dr = ri.T @ r_of(truth[j, 3:])
        return np.concatenate([dt, log_of(dr)])

    edges = [(i, i + 1) for i in range(n_poses - 1)]
    edges += [(i, i + loop_every) for i in range(0, n_poses - loop_every, loop_every)]
    ij = np.asarray(edges)
    z = np.stack([relative(i, j) + odom_sigma * rng.standard_normal(6) for i, j in edges])
    info = np.tile(np.eye(6) / odom_sigma**2, (len(edges), 1, 1))
    init = truth + init_noise * rng.standard_normal(truth.shape)
    init[0] = truth[0]
    return dict(kind="se3", poses=init, edges_ij=ij, edges_z=z, edges_info=info, truth=truth)
