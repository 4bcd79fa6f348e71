// Component-form measurement models for one factor per CUDA thread.
//
// The CUDA counterparts of `reprojection_normalized_comp`,
// `bal_reprojection_normalized_comp`, `bal_reprojection_intrinsics_comp`,
// `se2_between_comp` / `se2_between_res` and `se3_between_comp` /
// `se3_between_res` in gbp_tpu/ops/comp_factors.py, with the same Taylor
// guards, the same sign-preserving depth floor, the same floor-form angle
// wrap and the same Newton `stable_acos`; the plain versions are
// gbp_tpu_torch/ops/comp_factors.py, operation for operation.  Branches
// (small angle, angle near pi) are selects between two evaluated values, as
// in the plain versions.
//
// A model is a struct with the slot dofs DA, DB, the measurement dim ZD,
// the number NA of per-row factor arguments it reads (the BAL distortion
// [k1, k2]; 0 for the others), `eval(x, a, h, jac)` with `a` the row's NA
// arguments, and `residual(z, h, r)`; the relinearization bodies of
// messages_rows.cuh take it as a template parameter.
#pragma once

#include "comp_linalg.cuh"

namespace gbp {

template <typename T>
GBP_HD void hat(const T (&w)[3], T (&k)[3][3]) {
  k[0][0] = T(0.0); k[0][1] = -w[2];   k[0][2] = w[1];
  k[1][0] = w[2];   k[1][1] = T(0.0);  k[1][2] = -w[0];
  k[2][0] = -w[1];  k[2][1] = w[0];    k[2][2] = T(0.0);
}

// Rodrigues: R = I + sinc [w]x + cosc [w]x^2.
template <typename T>
GBP_HD void so3_exp(const T (&w)[3], T (&r)[3][3]) {
  const T t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = t2 < T(1e-8);
  const T safe_t2 = small ? T(1.0) : t2;
  const T theta = g_sqrt(safe_t2);
  const T sinc = small ? T(1.0) - t2 / T(6.0) : g_sin(theta) / theta;
  const T cosc = small ? T(0.5) - t2 / T(24.0) : (T(1.0) - g_cos(theta)) / safe_t2;
  T k[3][3], kk[3][3];
  hat(w, k);
  mm(k, k, kk);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = k[i][j] * sinc + kk[i][j] * cosc;
    r[i][i] = r[i][i] + T(1.0);
  }
}

// SO(3) right Jacobian Jr(w) = I - c1 [w]x + c2 [w]x^2.
template <typename T>
GBP_HD void right_jacobian(const T (&w)[3], T (&jr)[3][3]) {
  const T t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = t2 < T(1e-8);
  const T safe_t2 = small ? T(1.0) : t2;
  const T theta = g_sqrt(safe_t2);
  const T safe_t3 = safe_t2 * theta;
  const T c1 = small ? T(0.5) - t2 / T(24.0) : (T(1.0) - g_cos(theta)) / safe_t2;
  const T c2 = small ? T(1.0 / 6.0) - t2 / T(120.0) : (theta - g_sin(theta)) / safe_t3;
  T k[3][3], kk[3][3];
  hat(w, k);
  mm(k, k, kk);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) jr[i][j] = -c1 * k[i][j] + c2 * kk[i][j];
    jr[i][i] = jr[i][i] + T(1.0);
  }
}

// Sign-preserving depth floor |z| >= 1e-2.
template <typename T>
GBP_HD T safe_z(T zc) {
  return zc >= T(0.0) ? max_nan(zc, T(1e-2)) : min_nan(zc, T(-1e-2));
}

// R = R(omega) and Xc = R X + t of the camera (w, t) and the point X.
template <typename T>
GBP_HD void cam_point(const T (&w)[3], const T (&t)[3], const T (&pt)[3], T (&r)[3][3],
                      T (&xc)[3]) {
  so3_exp(w, r);
  T rp[3];
  mv(r, pt, rp);
#pragma unroll
  for (int i = 0; i < 3; ++i) xc[i] = rp[i] + t[i];
}

// d(Xc)/d(omega, t, X) [3][9]: -R [X]x Jr(omega) | I | R.
template <typename T>
GBP_HD void dxc_dx(const T (&w)[3], const T (&pt)[3], const T (&r)[3][3], T (&dxc)[3][9]) {
  T k[3][3], rk[3][3], jr[3][3], rkj[3][3];
  hat(pt, k);
  mm(r, k, rk);
  right_jacobian(w, jr);
  mm(rk, jr, rkj);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dxc[i][j] = rkj[i][j] * T(-1.0);
      dxc[i][3 + j] = i == j ? T(1.0) : T(0.0);
      dxc[i][6 + j] = r[i][j];
    }
  }
}

// x = [omega (3), t (3), X (3)] -> h = Xc.xy / Xc.z, jac = dh/dx [2][9]
// with Xc = R(omega) X + t.
template <typename T>
GBP_HD void reprojection_normalized(const T (&x)[9], T (&h)[2], T (&jac)[2][9]) {
  const T w[3] = {x[0], x[1], x[2]};
  const T t[3] = {x[3], x[4], x[5]};
  const T pt[3] = {x[6], x[7], x[8]};
  T r[3][3], xc[3];
  cam_point(w, t, pt, r, xc);
  const T inv_z = T(1.0) / safe_z(xc[2]);
  h[0] = xc[0] * inv_z;
  h[1] = xc[1] * inv_z;
  const T dpi[2][3] = {{inv_z, T(0.0), -xc[0] * inv_z * inv_z},
                       {T(0.0), inv_z, -xc[1] * inv_z * inv_z}};
  T dxc[3][9];
  dxc_dx(w, pt, r, dxc);
  mm(dpi, dxc, jac);
}

// The BAL projection p = -Xc.xy / Xc.z with radial distortion dist = 1 +
// k1 r2 + k2 r2^2 (r2 = |p|^2): h = rf * dist * p (rf = 1 when !SCALED)
// and dh/dXc [2][3] = rf * (dist I + 2 (k1 + 2 k2 r2) p p^T) . dp/dXc, in
// the operation order of `_bal_chain` in ops/comp_factors.py.
template <typename T, bool SCALED>
GBP_HD void bal_chain(const T (&xc)[3], T k1, T k2, T rf, T (&h)[2], T (&dh_dxc)[2][3],
                      T (&p)[2], T& r2, T& dist) {
  const T inv_z = T(1.0) / safe_z(xc[2]);
  p[0] = -xc[0] * inv_z;
  p[1] = -xc[1] * inv_z;
  r2 = p[0] * p[0] + p[1] * p[1];
  dist = T(1.0) + r2 * (k1 + k2 * r2);
  const T dp[2][3] = {{-inv_z, T(0.0), xc[0] * inv_z * inv_z},
                      {T(0.0), -inv_z, xc[1] * inv_z * inv_z}};
  const T ddist = k1 + T(2.0) * k2 * r2;
  T dh_dp[2][2] = {{dist + p[0] * ddist * T(2.0) * p[0], p[0] * ddist * T(2.0) * p[1]},
                   {p[1] * ddist * T(2.0) * p[0], dist + p[1] * ddist * T(2.0) * p[1]}};
  if constexpr (SCALED) {
    h[0] = rf * dist * p[0];
    h[1] = rf * dist * p[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) dh_dp[i][j] = rf * dh_dp[i][j];
    }
  } else {
    h[0] = dist * p[0];
    h[1] = dist * p[1];
  }
  mm(dh_dp, dp, dh_dxc);
}

// r = z - h, the default residual.
template <typename T, int ZD>
GBP_HD void residual_diff(const T (&z)[ZD], const T (&h)[ZD], T (&r)[ZD]) {
#pragma unroll
  for (int i = 0; i < ZD; ++i) r[i] = z[i] - h[i];
}

struct ReprojectionNormalized {
  static constexpr int DA = 6, DB = 3, ZD = 2, NA = 0;
  template <typename T>
  GBP_HD static void eval(const T (&x)[9], const T* /*a*/, T (&h)[2], T (&jac)[2][9]) {
    reprojection_normalized(x, h, jac);
  }
  template <typename T>
  GBP_HD static void residual(const T (&z)[2], const T (&h)[2], T (&r)[2]) {
    residual_diff(z, h, r);
  }
};

// x = [omega (3), t (3), X (3)], a = [k1, k2] -> h = dist * p (BAL, divided
// by the focal), jac [2][9].
struct BalReprojectionNormalized {
  static constexpr int DA = 6, DB = 3, ZD = 2, NA = 2;
  template <typename T>
  GBP_HD static void eval(const T (&x)[9], const T* a, T (&h)[2], T (&jac)[2][9]) {
    const T w[3] = {x[0], x[1], x[2]};
    const T t[3] = {x[3], x[4], x[5]};
    const T pt[3] = {x[6], x[7], x[8]};
    T r[3][3], xc[3];
    cam_point(w, t, pt, r, xc);
    T dh_dxc[2][3], p[2], r2, dist;
    bal_chain<T, false>(xc, a[0], a[1], T(1.0), h, dh_dxc, p, r2, dist);
    T dxc[3][9];
    dxc_dx(w, pt, r, dxc);
    mm(dh_dxc, dxc, jac);
  }
  template <typename T>
  GBP_HD static void residual(const T (&z)[2], const T (&h)[2], T (&r)[2]) {
    residual_diff(z, h, r);
  }
};

// x = [omega (3), t (3), rf, k1, k2, X (3)] -> h = rf * dist * p (the 9-dof
// BAL camera, rf = f / f0), jac [2][12] with the intrinsics columns at 6..8.
struct BalReprojectionIntrinsics {
  static constexpr int DA = 9, DB = 3, ZD = 2, NA = 0;
  template <typename T>
  GBP_HD static void eval(const T (&x)[12], const T* /*a*/, T (&h)[2], T (&jac)[2][12]) {
    const T w[3] = {x[0], x[1], x[2]};
    const T t[3] = {x[3], x[4], x[5]};
    const T rf = x[6];
    const T pt[3] = {x[9], x[10], x[11]};
    T r[3][3], xc[3];
    cam_point(w, t, pt, r, xc);
    T dh_dxc[2][3], p[2], r2, dist;
    bal_chain<T, true>(xc, x[7], x[8], rf, h, dh_dxc, p, r2, dist);
    T dxc[3][9], d_pose_pt[2][9];
    dxc_dx(w, pt, r, dxc);
    mm(dh_dxc, dxc, d_pose_pt);
    const T r4 = r2 * r2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) jac[i][j] = d_pose_pt[i][j];
      jac[i][6] = dist * p[i];
      jac[i][7] = rf * r2 * p[i];
      jac[i][8] = rf * r4 * p[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) jac[i][9 + j] = d_pose_pt[i][6 + j];
    }
  }
  template <typename T>
  GBP_HD static void residual(const T (&z)[2], const T (&h)[2], T (&r)[2]) {
    residual_diff(z, h, r);
  }
};

// Wrap to [-pi, pi): theta - 2 pi floor((theta + pi) / (2 pi)), the floor
// form of utils/lie.wrap_angle.
template <typename T>
GBP_HD T wrap_angle(T theta) {
  const T pi = T(3.141592653589793), two_pi = T(6.283185307179586);
  return theta - two_pi * g_floor((theta + pi) / two_pi);
}

// x = [xi, yi, ti, xj, yj, tj] -> h = the pose of j in frame i [3],
// jac [3][6]; the residual wraps its angle component.
struct Se2Between {
  static constexpr int DA = 3, DB = 3, ZD = 3, NA = 0;
  template <typename T>
  GBP_HD static void eval(const T (&x)[6], const T* /*a*/, T (&h)[3], T (&jac)[3][6]) {
    const T c = g_cos(x[2]), s = g_sin(x[2]);
    const T dx = x[3] - x[0];
    const T dy = x[4] - x[1];
    const T h0 = c * dx + s * dy;
    const T h1 = -s * dx + c * dy;
    h[0] = h0;
    h[1] = h1;
    h[2] = x[5] - x[2];
    const T row0[6] = {-c, -s, h1, c, s, T(0.0)};
    const T row1[6] = {s, -c, -h0, -s, c, T(0.0)};
    const T row2[6] = {T(0.0), T(0.0), T(-1.0), T(0.0), T(0.0), T(1.0)};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      jac[0][k] = row0[k];
      jac[1][k] = row1[k];
      jac[2][k] = row2[k];
    }
  }
  template <typename T>
  GBP_HD static void residual(const T (&z)[3], const T (&h)[3], T (&r)[3]) {
    r[0] = z[0] - h[0];
    r[1] = z[1] - h[1];
    r[2] = wrap_angle(z[2] - h[2]);
  }
};

// arccos(clip(c, -1, 1)) by three Newton steps from a series seed
// (utils/lie.stable_acos).
template <typename T>
GBP_HD T asin_series(T t) {
  const T t2 = t * t;
  return t * (T(1.0) + t2 * (T(1.0 / 6.0) + t2 * (T(3.0 / 40.0) + t2 * T(15.0 / 336.0))));
}

template <typename T>
GBP_HD T stable_acos(T c) {
  const T a = g_abs(min_nan(max_nan(c, T(-1.0)), T(1.0)));
  const T s = g_sqrt(max_nan((T(1.0) - a) * (T(1.0) + a), T(0.0)));
  const bool near1 = a >= T(0.7071067811865476);
  T th = near1 ? asin_series(s) : T(0.5 * 3.141592653589793) - asin_series(a);
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const T sin_t = g_sin(th), cos_t = g_cos(th);
    const T by_sin = th - (sin_t - s) / cos_t;
    const T by_cos = th + (cos_t - a) / sin_t;
    th = near1 ? by_sin : by_cos;
  }
  return c < T(0.0) ? T(3.141592653589793) - th : th;
}

// Rotation matrix -> axis-angle (utils/lie.so3_log).
template <typename T>
GBP_HD void so3_log(const T (&r)[3][3], T (&w)[3]) {
  const T trace = r[0][0] + r[1][1] + r[2][2];
  const T theta = stable_acos(min_nan(max_nan((trace - T(1.0)) / T(2.0), T(-1.0)), T(1.0)));
  const bool small = g_abs(theta) < T(1e-4);
  const T scale = small ? T(0.5) + theta * theta / T(12.0)
                        : theta / (T(2.0) * (small ? T(1.0) : g_sin(theta)));
  w[0] = scale * (r[2][1] - r[1][2]);
  w[1] = scale * (r[0][2] - r[2][0]);
  w[2] = scale * (r[1][0] - r[0][1]);
}

// Jr(w)^-1 = I + [w]x / 2 + c [w]x^2, c = 1/t2 - cot(t/2) / (2t).
template <typename T>
GBP_HD void right_jacobian_inv(const T (&w)[3], T (&j)[3][3]) {
  const T t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = t2 < T(1e-8);
  const T safe_t2 = small ? T(1.0) : t2;
  const T theta = g_sqrt(safe_t2);
  const T c = small ? T(1.0 / 12.0) + t2 / T(720.0)
                    : T(1.0) / safe_t2 - T(1.0) / (T(2.0) * theta * g_tan(theta / T(2.0)));
  T k[3][3], kk[3][3];
  hat(w, k);
  mm(k, k, kk);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) j[i][jj] = T(0.5) * k[i][jj] + c * kk[i][jj];
    j[i][i] = j[i][i] + T(1.0);
  }
}

template <typename T>
GBP_HD void transpose3(const T (&a)[3][3], T (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = a[j][i];
  }
}

// x = [t_i, w_i, t_j, w_j] -> h = [R_i^T (t_j - t_i), log(R_i^T R_j)] [6],
// jac [6][12] (the analytic blocks of ops/comp_factors.se3_between_comp);
// the residual's rotation block is log(R(h_w)^T R(z_w)).
struct Se3Between {
  static constexpr int DA = 6, DB = 6, ZD = 6, NA = 0;
  template <typename T>
  GBP_HD static void eval(const T (&x)[12], const T* /*a*/, T (&h)[6], T (&jac)[6][12]) {
    const T wi[3] = {x[3], x[4], x[5]};
    const T wj[3] = {x[9], x[10], x[11]};
    T ri[3][3], rit[3][3], rj[3][3];
    so3_exp(wi, ri);
    transpose3(ri, rit);
    so3_exp(wj, rj);
    const T d[3] = {x[6] - x[0], x[7] - x[1], x[8] - x[2]};
    T ht[3], hw[3], rel[3][3];
    mv(rit, d, ht);
    mm(rit, rj, rel);
    so3_log(rel, hw);
    T jr_i[3][3], jr_j[3][3], jinv[3][3], jinv_t[3][3];
    right_jacobian(wi, jr_i);
    right_jacobian(wj, jr_j);
    right_jacobian_inv(hw, jinv);
    transpose3(jinv, jinv_t);
    T ht_hat[3][3], dt_dwi[3][3], dw_dwi[3][3], dw_dwj[3][3];
    hat(ht, ht_hat);
    mm(ht_hat, jr_i, dt_dwi);
    mm(jinv_t, jr_i, dw_dwi);
    mm(jinv, jr_j, dw_dwj);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      h[k] = ht[k];
      h[3 + k] = hw[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        jac[k][c] = -rit[k][c];
        jac[k][3 + c] = dt_dwi[k][c];
        jac[k][6 + c] = rit[k][c];
        jac[k][9 + c] = T(0.0);
        jac[3 + k][c] = T(0.0);
        jac[3 + k][3 + c] = dw_dwi[k][c] * T(-1.0);
        jac[3 + k][6 + c] = T(0.0);
        jac[3 + k][9 + c] = dw_dwj[k][c];
      }
    }
  }
  template <typename T>
  GBP_HD static void residual(const T (&z)[6], const T (&h)[6], T (&r)[6]) {
    const T hw[3] = {h[3], h[4], h[5]};
    const T zw[3] = {z[3], z[4], z[5]};
    T rh[3][3], rht[3][3], rz[3][3], rel[3][3], rw[3];
    so3_exp(hw, rh);
    transpose3(rh, rht);
    so3_exp(zw, rz);
    mm(rht, rz, rel);
    so3_log(rel, rw);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[k] = z[k] - h[k];
      r[3 + k] = rw[k];
    }
  }
};

}  // namespace gbp
