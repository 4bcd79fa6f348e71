"""Serial NumPy GBP: the baseline of the headline benchmark.

The port's own copy of gbp_tpu/bench/numpy_gbp.py (the port imports
nothing of `gbp_tpu`), arithmetic unchanged.  The reference repo
(joeaortiz/gbp) is a serial float64 NumPy program whose throughput was never
published (BASELINE.md), so this faithful re-implementation of the same
algorithm and structure (object graph, per-factor Python loop, per-message
dense Schur marginalization, SURVEY.md §3.1) is the baseline that
`python -m gbp_tpu_torch.bench` reports `vs_baseline` against.

It is written in the reference's style on purpose (pointer-chasing
objects, O(n) Python loops): it is the thing the engine replaces.
"""
from __future__ import annotations

import numpy as np


class NumpyFactor:
    __slots__ = ("vars", "z", "prec", "meas_fn", "jac_fn", "linpoint",
                 "f_eta", "f_lam", "msgs_eta", "msgs_lam", "since_relin")

    def __init__(self, variables, z, prec, meas_fn, jac_fn):
        self.vars = variables
        self.z = z
        self.prec = prec  # diagonal [zdim]
        self.meas_fn = meas_fn
        self.jac_fn = jac_fn
        self.linpoint = np.concatenate([v.mean.copy() for v in variables])
        self.msgs_eta = [np.zeros(v.dof) for v in variables]
        self.msgs_lam = [np.zeros((v.dof, v.dof)) for v in variables]
        self.since_relin = 0
        self.compute_factor()
        for v in variables:
            v.factors.append(self)

    def compute_factor(self):
        x0 = self.linpoint
        j = self.jac_fn(x0)
        h = self.meas_fn(x0)
        lam_meas = np.diag(self.prec)
        self.f_lam = j.T @ lam_meas @ j
        self.f_eta = j.T @ lam_meas @ (j @ x0 + self.z - h)

    def maybe_relinearize(self, beta, min_linear_iters):
        x = np.concatenate([v.mean for v in self.vars])
        if (np.linalg.norm(x - self.linpoint) > beta
                and self.since_relin >= min_linear_iters):
            self.linpoint = x
            self.compute_factor()
            self.since_relin = 0
        else:
            self.since_relin += 1

    def compute_messages(self, eta_damping):
        offs = np.cumsum([0] + [v.dof for v in self.vars])
        tdof = offs[-1]
        old_eta = [m.copy() for m in self.msgs_eta]
        old_lam = [m.copy() for m in self.msgs_lam]
        for a, va in enumerate(self.vars):
            eta = self.f_eta.copy()
            lam = self.f_lam.copy()
            for b, vb in enumerate(self.vars):
                if b == a:
                    continue
                sl = slice(offs[b], offs[b + 1])
                eta[sl] += vb.belief_eta - old_eta[b]
                lam[sl, sl] += vb.belief_lam - old_lam[b]
            # Schur-marginalize onto slot a.
            ka = slice(offs[a], offs[a + 1])
            keep = np.zeros(tdof, dtype=bool)
            keep[ka] = True
            aa = lam[np.ix_(keep, keep)]
            ab = lam[np.ix_(keep, ~keep)]
            bb = lam[np.ix_(~keep, ~keep)]
            if bb.size:
                bb_inv = np.linalg.inv(bb)
                w = ab @ bb_inv
                lam_msg = aa - w @ ab.T
                eta_msg = eta[keep] - w @ eta[~keep]
            else:
                lam_msg, eta_msg = aa, eta[keep]
            d = eta_damping
            self.msgs_eta[a] = (1 - d) * eta_msg + d * old_eta[a]
            self.msgs_lam[a] = lam_msg


class NumpyVariable:
    __slots__ = ("dof", "mean", "prior_eta", "prior_lam", "belief_eta",
                 "belief_lam", "factors")

    def __init__(self, mean, prior_prec):
        self.dof = len(mean)
        self.mean = np.asarray(mean, dtype=np.float64).copy()
        self.prior_lam = np.eye(self.dof) * prior_prec
        self.prior_eta = self.prior_lam @ self.mean
        self.belief_eta = self.prior_eta.copy()
        self.belief_lam = self.prior_lam.copy()
        self.factors = []

    def update_belief(self):
        eta = self.prior_eta.copy()
        lam = self.prior_lam.copy()
        for f in self.factors:
            k = f.vars.index(self)
            eta += f.msgs_eta[k]
            lam += f.msgs_lam[k]
        self.belief_eta = eta
        self.belief_lam = lam
        self.mean = np.linalg.solve(lam, eta)


class NumpyGraph:
    def __init__(self):
        self.variables = []
        self.factors = []

    def synchronous_iteration(self, eta_damping=0.4, beta=0.01,
                              min_linear_iters=8, num_undamped_iters=6):
        for f in self.factors:
            f.maybe_relinearize(beta, min_linear_iters)
        for f in self.factors:
            d = eta_damping if f.since_relin >= num_undamped_iters else 0.0
            f.compute_messages(d)
        for v in self.variables:
            v.update_belief()


def _np_hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0.0]])


def _np_so3_exp(w):
    theta = np.linalg.norm(w)
    k = _np_hat(w)
    if theta < 1e-8:
        return np.eye(3) + k
    return (
        np.eye(3)
        + np.sin(theta) / theta * k
        + (1 - np.cos(theta)) / theta**2 * (k @ k)
    )


def _np_right_jac(w):
    theta = np.linalg.norm(w)
    k = _np_hat(w)
    if theta < 1e-8:
        return np.eye(3) - 0.5 * k
    return (
        np.eye(3)
        - (1 - np.cos(theta)) / theta**2 * k
        + (theta - np.sin(theta)) / theta**3 * (k @ k)
    )


def np_reproj_meas(x):
    """Normalized pinhole projection, pure numpy (matches factors/reprojection)."""
    r = _np_so3_exp(x[:3])
    xc = r @ x[6:9] + x[3:6]
    return xc[:2] / xc[2]


def np_reproj_jac(x):
    r = _np_so3_exp(x[:3])
    pt = x[6:9]
    xc = r @ pt + x[3:6]
    inv_z = 1.0 / xc[2]
    dpi = np.array([[inv_z, 0, -xc[0] * inv_z**2], [0, inv_z, -xc[1] * inv_z**2]])
    d_omega = -(r @ _np_hat(pt) @ _np_right_jac(x[:3]))
    dxc = np.concatenate([d_omega, np.eye(3), r], axis=1)
    return dpi @ dxc


def build_ba_numpy(sim, prior_prec=1.0, anchor_prec=1e5):
    """Reference-style BA graph from the same sim dict models/ba.py uses."""
    k = sim["k"]

    g = NumpyGraph()
    cams = []
    for i, mu in enumerate(sim["cam_init"]):
        v = NumpyVariable(mu, anchor_prec if i == 0 else prior_prec)
        cams.append(v)
        g.variables.append(v)
    lmks = []
    for mu in sim["lmk_init"]:
        v = NumpyVariable(mu, prior_prec)
        lmks.append(v)
        g.variables.append(v)

    z_all = (sim["obs"] - k[2:]) / k[:2]
    prec = (k[:2] / sim.get("pix_sigma", 1.0)) ** 2

    for ci, li, z in zip(sim["cam_ids"], sim["lmk_ids"], z_all):
        g.factors.append(
            NumpyFactor([cams[ci], lmks[li]], z, prec, np_reproj_meas, np_reproj_jac)
        )
    return g
