// Component-form measurement model for one factor per CUDA thread.
//
// The CUDA counterpart of `reprojection_normalized_comp` in
// gbp_tpu/ops/comp_factors.py, with the same Taylor guards and the same
// sign-preserving depth floor; the plain version is
// gbp_tpu_torch/ops/comp_factors.py.
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

// x = [omega (3), t (3), X (3)] -> h = Xc.xy / Xc.z, jac = dh/dx [2][9]
// with Xc = R(omega) X + t.
template <typename T>
GBP_HD void reprojection_normalized(const T (&x)[9], T (&h)[2], T (&jac)[2][9]) {
  const T w[3] = {x[0], x[1], x[2]};
  const T pt[3] = {x[6], x[7], x[8]};
  T r[3][3];
  so3_exp(w, r);
  T rp[3];
  mv(r, pt, rp);
  const T xc[3] = {rp[0] + x[3], rp[1] + x[4], rp[2] + x[5]};
  const T inv_z = T(1.0) / safe_z(xc[2]);
  h[0] = xc[0] * inv_z;
  h[1] = xc[1] * inv_z;
  const T dpi[2][3] = {{inv_z, T(0.0), -xc[0] * inv_z * inv_z},
                       {T(0.0), inv_z, -xc[1] * inv_z * inv_z}};
  // d(Xc)/d(omega) = -R [X]x Jr(omega);  d(Xc)/dt = I;  d(Xc)/dX = R.
  T k[3][3], rk[3][3], jr[3][3], rkj[3][3];
  hat(pt, k);
  mm(r, k, rk);
  right_jacobian(w, jr);
  mm(rk, jr, rkj);
  T dxc[3][9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dxc[i][j] = rkj[i][j] * T(-1.0);
      dxc[i][3 + j] = i == j ? T(1.0) : T(0.0);
      dxc[i][6 + j] = r[i][j];
    }
  }
  mm(dpi, dxc, jac);
}

}  // namespace gbp
