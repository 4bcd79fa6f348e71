"""Component-form measurement models: the plain PyTorch version.

Counterpart of gbp_tpu/ops/comp_factors.py for the slice's factor type.  The
state x is a list of component tensors (one per state dof), outputs are
component lists: (h [z], jac [z][t]).  csrc/comp_factors.cuh is the same
model for one factor per CUDA thread.

Registry: COMP_FACTORS[ftype.name] -> (fn(x_comps), n_args), as in the
reference; a factor type that is absent has no fused relinearization and
the generic sweep relinearizes it in plain torch.  The BAL and pose-graph
models follow with ROADMAP A7/A8.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.ops import comp_linalg as cl


def _hat(w):
    """Component hat operator: [3] -> [3][3]."""
    zero = torch.zeros_like(w[0])
    return [
        [zero, -w[2], w[1]],
        [w[2], zero, -w[0]],
        [-w[1], w[0], zero],
    ]


def _so3_exp(w):
    """Rodrigues in component form: [3] -> R [3][3]."""
    t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    k = _hat(w)
    kk = cl.cmm(k, k)
    r = [[k[i][j] * sinc + kk[i][j] * cosc for j in range(3)] for i in range(3)]
    for i in range(3):
        r[i][i] = r[i][i] + 1.0
    return r


def _right_jacobian(w):
    """SO(3) right Jacobian Jr(w) = I - c1 [w]x + c2 [w]x^2."""
    t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    safe_t3 = safe_t2 * theta
    c1 = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c2 = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    k = _hat(w)
    kk = cl.cmm(k, k)
    jr = [[-c1 * k[i][j] + c2 * kk[i][j] for j in range(3)] for i in range(3)]
    for i in range(3):
        jr[i][i] = jr[i][i] + 1.0
    return jr


def _safe_z(zc):
    """Sign-preserving depth floor |z| >= 1e-2 (factors/reprojection._safe_z)."""
    return torch.where(zc >= 0, torch.clamp(zc, min=1e-2), torch.clamp(zc, max=-1e-2))


def reprojection_normalized_comp(x):
    """Component form of factors/reprojection.reprojection_normalized:
    x = [omega (3), t (3), X (3)] -> (h [2], jac [2][9])."""
    w, t, pt = x[0:3], x[3:6], x[6:9]
    r = _so3_exp(w)
    rp = cl.cmv(r, pt)
    xc = [rp[i] + t[i] for i in range(3)]
    inv_z = 1.0 / _safe_z(xc[2])
    h = [xc[0] * inv_z, xc[1] * inv_z]
    zero = torch.zeros_like(inv_z)
    one = torch.ones_like(inv_z)
    dpi = [
        [inv_z, zero, -xc[0] * inv_z * inv_z],
        [zero, inv_z, -xc[1] * inv_z * inv_z],
    ]
    d_omega = cl.cscale(cl.cmm(cl.cmm(r, _hat(pt)), _right_jacobian(w)), -1.0)
    eye = [[one if i == j else zero for j in range(3)] for i in range(3)]
    dxc = [d_omega[i] + eye[i] + r[i] for i in range(3)]  # [3][9]: omega | t | X
    return h, cl.cmm(dpi, dxc)


COMP_FACTORS = {
    "reprojection_normalized": (reprojection_normalized_comp, 0),
}
# The reference's other component-form models and the ROADMAP items that
# port them.
COMP_FACTORS_QUEUED = {
    "bal_reprojection_normalized": "A7",
    "bal_reprojection_intrinsics": "A7",
    "se2_between": "A8",
    "se3_between": "A8",
}


def comp_model(name: str):
    """The component-form model fn(x_comps) -> (h, jac) of factor type
    `name`; raises for one that is not ported."""
    if name not in COMP_FACTORS:
        item = COMP_FACTORS_QUEUED.get(name)
        raise NotImplementedError(
            f"no component-form model for factor type {name!r}"
            + (f": not ported yet (ROADMAP {item})" if item else ""))
    return COMP_FACTORS[name][0]
