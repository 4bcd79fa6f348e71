"""Component-form measurement models: the plain PyTorch version.

Counterpart of gbp_tpu/ops/comp_factors.py for the ported factor types.  The
state x is a list of component tensors (one per state dof), outputs are
component lists: (h [z], jac [z][t]).  csrc/comp_factors.cuh holds the same
models for one factor per CUDA thread, operation for operation.

Registry: COMP_FACTORS[ftype.name] -> (fn(x_comps), n_args[, residual
fn(z_comps, h_comps)]), as in the reference; the optional third entry
replaces r = z - h in the relinearization (angle wrap, manifold log).  A
factor type that is absent has no fused relinearization and the generic
sweep relinearizes it in plain torch.  The BAL models follow with ROADMAP A7.
"""
from __future__ import annotations

import torch

from gbp_tpu_torch.ops import comp_linalg as cl
from gbp_tpu_torch.utils.lie import stable_acos, wrap_angle


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


def se2_between_comp(x):
    """Component form of factors/odometry.se2_between: x = [xi, yi, ti, xj,
    yj, tj] -> (h [3] = the pose of j in frame i, jac [3][6])."""
    c, s = torch.cos(x[2]), torch.sin(x[2])
    dx = x[3] - x[0]
    dy = x[4] - x[1]
    h0 = c * dx + s * dy
    h1 = -s * dx + c * dy
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    jac = [
        [-c, -s, h1, c, s, zero],
        [s, -c, -h0, -s, c, zero],
        [zero, zero, -one, zero, zero, one],
    ]
    return [h0, h1, x[5] - x[2]], jac


def se2_between_res(z, h):
    """Component residual of se2_between: the angle component wrapped to
    [-pi, pi) by `utils.lie.wrap_angle` (the floor form)."""
    return [z[0] - h[0], z[1] - h[1], wrap_angle(z[2] - h[2])]


def _so3_log(r):
    """Component so3_log with the numerics of utils/lie.so3_log:
    [3][3] component matrix -> [3] axis-angle components."""
    trace = r[0][0] + r[1][1] + r[2][2]
    theta = stable_acos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    vee = [r[2][1] - r[1][2], r[0][2] - r[2][0], r[1][0] - r[0][1]]
    small = torch.abs(theta) < 1e-4
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(theta), torch.sin(theta))))
    return [scale * v for v in vee]


def _right_jacobian_inv(w):
    """Jr(w)^-1 = I + [w]x / 2 + c [w]x^2 with c = 1/t2 - cot(t/2) / (2t),
    finite at t = pi; the series 1/12 + t2/720 for small angles."""
    t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / safe_t2 - 1.0 / (2.0 * theta * torch.tan(theta / 2.0)))
    k = _hat(w)
    kk = cl.cmm(k, k)
    j = [[0.5 * k[i][jj] + c * kk[i][jj] for jj in range(3)] for i in range(3)]
    for i in range(3):
        j[i][i] = j[i][i] + 1.0
    return j


def se3_between_comp(x):
    """Component form of factors/se3.se3_between.

    x = [t_i (3), w_i (3), t_j (3), w_j (3)]; h = [R_i^T (t_j - t_i),
    log(R_i^T R_j)]; analytic [6][12] Jacobian in the flat additive-update
    convention (exp(w + dw) = exp(w) exp(Jr(w) dw)):

        dh_t/dt_i = -R_i^T          dh_t/dt_j = R_i^T
        dh_t/dw_i = [h_t]x Jr(w_i)  dh_t/dw_j = 0
        dh_w/dw_i = -(Jr^-1(h_w))^T Jr(w_i)
        dh_w/dw_j =  Jr^-1(h_w) Jr(w_j)
    """
    ti, wi = x[0:3], x[3:6]
    tj, wj = x[6:9], x[9:12]
    rit = cl.ct(_so3_exp(wi))
    rj = _so3_exp(wj)
    d = [tj[k] - ti[k] for k in range(3)]
    ht = cl.cmv(rit, d)
    hw = _so3_log(cl.cmm(rit, rj))
    jr_i = _right_jacobian(wi)
    jr_j = _right_jacobian(wj)
    jinv = _right_jacobian_inv(hw)
    dt_dwi = cl.cmm(_hat(ht), jr_i)
    dw_dwi = cl.cscale(cl.cmm(cl.ct(jinv), jr_i), -1.0)
    dw_dwj = cl.cmm(jinv, jr_j)
    zero = torch.zeros_like(ht[0])
    jac = []
    for k in range(3):
        jac.append([-rit[k][0], -rit[k][1], -rit[k][2],
                    dt_dwi[k][0], dt_dwi[k][1], dt_dwi[k][2],
                    rit[k][0], rit[k][1], rit[k][2],
                    zero, zero, zero])
    for k in range(3):
        jac.append([zero, zero, zero,
                    dw_dwi[k][0], dw_dwi[k][1], dw_dwi[k][2],
                    zero, zero, zero,
                    dw_dwj[k][0], dw_dwj[k][1], dw_dwj[k][2]])
    return ht + hw, jac


def se3_between_res(z, h):
    """Component residual of se3_between: translation additive, rotation on
    the manifold, r_w = log(R(h_w)^T R(z_w))."""
    rt = [z[k] - h[k] for k in range(3)]
    rw = _so3_log(cl.cmm(cl.ct(_so3_exp(h[3:6])), _so3_exp(z[3:6])))
    return rt + rw


COMP_FACTORS = {
    "reprojection_normalized": (reprojection_normalized_comp, 0),
    "se2_between": (se2_between_comp, 0, se2_between_res),
    "se3_between": (se3_between_comp, 0, se3_between_res),
}
# The reference's other component-form models and the ROADMAP items that
# port them.
COMP_FACTORS_QUEUED = {
    "bal_reprojection_normalized": "A7",
    "bal_reprojection_intrinsics": "A7",
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


def comp_residual(name: str):
    """The component residual fn(z_comps, h_comps) of factor type `name`, or
    None where it is r = z - h."""
    entry = COMP_FACTORS[name]
    return entry[2] if len(entry) > 2 else None
