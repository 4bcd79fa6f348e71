"""Component-form measurement models: the plain PyTorch version.

Counterpart of gbp_tpu/ops/comp_factors.py for the ported factor types.  The
state x is a list of component tensors (one per state dof), outputs are
component lists: (h [z], jac [z][t]).  csrc/comp_factors.cuh holds the same
models for one factor per CUDA thread, operation for operation.

Registry: COMP_FACTORS[ftype.name] -> (fn(x_comps, args_comps), n_args[,
residual fn(z_comps, h_comps)]), as in the reference: `args_comps` are the
n_args per-factor argument components (None where n_args is 0); the
optional third entry replaces r = z - h in the relinearization (angle wrap,
manifold log).  A factor type that is absent has no fused relinearization
and the generic sweep relinearizes it in plain torch.
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


def _cam_point(w, t, pt):
    """(R, Xc = R X + t) in component form."""
    r = _so3_exp(w)
    rp = cl.cmv(r, pt)
    return r, [rp[i] + t[i] for i in range(3)]


def _dxc(r, pt, w, like):
    """d(Xc)/d(omega, t, X) [3][9]: -R [X]x Jr(omega) | I | R."""
    zero, one = torch.zeros_like(like), torch.ones_like(like)
    d_omega = cl.cscale(cl.cmm(cl.cmm(r, _hat(pt)), _right_jacobian(w)), -1.0)
    eye = [[one if i == j else zero for j in range(3)] for i in range(3)]
    return [d_omega[i] + eye[i] + r[i] for i in range(3)]


def reprojection_normalized_comp(x, args=None):
    """Component form of factors/reprojection.reprojection_normalized:
    x = [omega (3), t (3), X (3)] -> (h [2], jac [2][9])."""
    del args
    w, t, pt = x[0:3], x[3:6], x[6:9]
    r, xc = _cam_point(w, t, pt)
    inv_z = 1.0 / _safe_z(xc[2])
    h = [xc[0] * inv_z, xc[1] * inv_z]
    zero = torch.zeros_like(inv_z)
    dpi = [
        [inv_z, zero, -xc[0] * inv_z * inv_z],
        [zero, inv_z, -xc[1] * inv_z * inv_z],
    ]
    return h, cl.cmm(dpi, _dxc(r, pt, w, inv_z))


def _bal_chain(xc, k1, k2, rf=None):
    """The BAL projection p = -Xc.xy / Xc.z with radial distortion, in
    component form: (h = [rf *] dist * p, dh/dXc [2][3], p, r2, dist)."""
    inv_z = 1.0 / _safe_z(xc[2])
    p = [-xc[0] * inv_z, -xc[1] * inv_z]
    r2 = p[0] * p[0] + p[1] * p[1]
    dist = 1.0 + r2 * (k1 + k2 * r2)
    zero = torch.zeros_like(inv_z)
    # dp/dXc [2][3].
    dp = [
        [-inv_z, zero, xc[0] * inv_z * inv_z],
        [zero, -inv_z, xc[1] * inv_z * inv_z],
    ]
    # dh/dp = dist I + 2 (d dist/d r2) p p^T, d dist/d r2 = k1 + 2 k2 r2.
    ddist = k1 + 2.0 * k2 * r2
    dh_dp = [
        [dist + p[0] * ddist * 2.0 * p[0], p[0] * ddist * 2.0 * p[1]],
        [p[1] * ddist * 2.0 * p[0], dist + p[1] * ddist * 2.0 * p[1]],
    ]
    if rf is None:
        h = [dist * p[0], dist * p[1]]
    else:
        h = [rf * dist * p[0], rf * dist * p[1]]
        dh_dp = [[rf * v for v in row] for row in dh_dp]
    return h, cl.cmm(dh_dp, dp), p, r2, dist


def bal_reprojection_normalized_comp(x, args):
    """Component form of factors/reprojection.bal_reprojection_normalized:
    x = [omega (3), t (3), X (3)], args = [k1, k2] ->
    h = (1 + k1 r^2 + k2 r^4) * p, p = -Xc.xy / Xc.z, jac [2][9]."""
    k1, k2 = args[0], args[1]
    w, t, pt = x[0:3], x[3:6], x[6:9]
    r, xc = _cam_point(w, t, pt)
    h, dh_dxc, _, _, _ = _bal_chain(xc, k1, k2)
    return h, cl.cmm(dh_dxc, _dxc(r, pt, w, xc[2]))


def bal_reprojection_intrinsics_comp(x, args=None):
    """Component form of factors/reprojection.bal_reprojection_intrinsics:
    x = [omega (3), t (3), rf, k1, k2, X (3)] -> h = rf * (1 + k1 r^2 +
    k2 r^4) * p, jac [2][12] with the intrinsics columns at 6..8."""
    del args
    w, t = x[0:3], x[3:6]
    rf, k1, k2 = x[6], x[7], x[8]
    pt = x[9:12]
    r, xc = _cam_point(w, t, pt)
    h, dh_dxc, p, r2, dist = _bal_chain(xc, k1, k2, rf)
    d_pose_pt = cl.cmm(dh_dxc, _dxc(r, pt, w, xc[2]))  # [2][9]: omega | t | X
    r4 = r2 * r2
    jac = [d_pose_pt[i][0:6] + [dist * p[i], rf * r2 * p[i], rf * r4 * p[i]]
           + d_pose_pt[i][6:9] for i in range(2)]
    return h, jac


def se2_between_comp(x, args=None):
    """Component form of factors/odometry.se2_between: x = [xi, yi, ti, xj,
    yj, tj] -> (h [3] = the pose of j in frame i, jac [3][6])."""
    del args
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


def se3_between_comp(x, args=None):
    """Component form of factors/se3.se3_between.

    x = [t_i (3), w_i (3), t_j (3), w_j (3)]; h = [R_i^T (t_j - t_i),
    log(R_i^T R_j)]; analytic [6][12] Jacobian in the flat additive-update
    convention (exp(w + dw) = exp(w) exp(Jr(w) dw)):

        dh_t/dt_i = -R_i^T          dh_t/dt_j = R_i^T
        dh_t/dw_i = [h_t]x Jr(w_i)  dh_t/dw_j = 0
        dh_w/dw_i = -(Jr^-1(h_w))^T Jr(w_i)
        dh_w/dw_j =  Jr^-1(h_w) Jr(w_j)
    """
    del args
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


# ftype.name -> (comp fn, n_arg_components[, residual comp fn]).
COMP_FACTORS = {
    "reprojection_normalized": (reprojection_normalized_comp, 0),
    "bal_reprojection_normalized": (bal_reprojection_normalized_comp, 2),
    "bal_reprojection_intrinsics": (bal_reprojection_intrinsics_comp, 0),
    "se2_between": (se2_between_comp, 0, se2_between_res),
    "se3_between": (se3_between_comp, 0, se3_between_res),
}


def comp_model(name: str):
    """The component-form model fn(x_comps, args_comps) -> (h, jac) of
    factor type `name`; raises for a type without one."""
    if name not in COMP_FACTORS:
        raise NotImplementedError(f"no component-form model for factor type {name!r}")
    return COMP_FACTORS[name][0]


def comp_n_args(name: str) -> int:
    """The per-factor argument components the model of `name` reads."""
    return COMP_FACTORS[name][1]


def comp_residual(name: str):
    """The component residual fn(z_comps, h_comps) of factor type `name`, or
    None where it is r = z - h."""
    entry = COMP_FACTORS[name]
    return entry[2] if len(entry) > 2 else None
