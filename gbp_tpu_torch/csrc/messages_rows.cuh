// Per-factor-row bodies shared by the bundle-adjustment kernels.
//
// One thread owns one factor row r of the component-major [F, mp] state.
// The kernels differ only in how the row's camera belief reaches the
// thread: messages.cu stages the whole per-camera table in shared memory,
// windows.cu stages the row's tile window of it.  Both hand these bodies a
// pointer to the camera's packed row, so the arithmetic (operation order,
// the separately rounded beta and Huber decisions) is the same code.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "comp_factors.cuh"
#include "comp_linalg.cuh"

namespace gbp {

constexpr int D0 = 6;
constexpr int D1 = 3;
constexpr int Z = 2;
constexpr int T9 = D0 + D1;
constexpr int F_CAM = D0 + D0 * D0;
constexpr int F_LMK = D1 + D1 * D1;
constexpr int BLOCK = 256;

// Masked relinearization of row r.  cam: the camera's mean [D0]; the
// landmark mean is read at r / deg.
template <typename S>
__device__ __forceinline__ void relin_row(
    const S* __restrict__ cam, const S* __restrict__ lmk_mean, const S* __restrict__ z,
    const S* __restrict__ lp, const S* __restrict__ jac, const S* __restrict__ r0,
    const S* __restrict__ srel, const S* __restrict__ act, S* __restrict__ olp,
    S* __restrict__ ojac, S* __restrict__ or0, S* __restrict__ osrel, int64_t mp, int deg,
    int64_t r, S beta, S min_linear) {
  const int64_t l = r / deg;
  S x[T9], lp_o[T9];
#pragma unroll
  for (int i = 0; i < D0; ++i) x[i] = cam[i];
#pragma unroll
  for (int i = 0; i < D1; ++i) x[D0 + i] = lmk_mean[l * D1 + i];
#pragma unroll
  for (int i = 0; i < T9; ++i) lp_o[i] = lp[i * mp + r];
  // Separately rounded, in the plain version's order: the beta decision
  // must not flip between the kernel and its plain version.
  S dist2 = mul_rn(x[0] - lp_o[0], x[0] - lp_o[0]);
#pragma unroll
  for (int i = 1; i < T9; ++i) dist2 = add_rn(dist2, mul_rn(x[i] - lp_o[i], x[i] - lp_o[i]));
  const S sr = srel[r];
  const bool eligible = (dist2 > mul_rn(beta, beta)) && (sr >= min_linear) && (act[r] > S(0.5));

  if (eligible) {
    S h[Z], jn[Z][T9];
    reprojection_normalized(x, h, jn);
#pragma unroll
    for (int i = 0; i < T9; ++i) olp[i * mp + r] = x[i];
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      or0[i * mp + r] = z[i * mp + r] - h[i];
#pragma unroll
      for (int j = 0; j < T9; ++j) ojac[(i * T9 + j) * mp + r] = jn[i][j];
    }
    osrel[r] = S(0.0);
  } else {
#pragma unroll
    for (int i = 0; i < T9; ++i) olp[i * mp + r] = lp_o[i];
#pragma unroll
    for (int i = 0; i < Z; ++i) or0[i * mp + r] = r0[i * mp + r];
#pragma unroll
    for (int k = 0; k < Z * T9; ++k) ojac[k * mp + r] = jac[k * mp + r];
    osrel[r] = sr + S(1.0);
  }
}

// Cavity of one slot and its projection through that slot's Jacobian:
// p = J C^-1 J^T [Z][Z], q = J (x0 - C^-1 cav_eta) [Z].
template <typename S, int D>
__device__ __forceinline__ void slot_terms(const S (&be)[D], const S (&bl)[D][D],
                                           const S (&me)[D], const S (&ml)[D][D],
                                           const S (&j)[Z][D], const S (&x0)[D],
                                           S floor, S jitter, S (&p)[Z][Z], S (&q)[Z]) {
  S cav_lam[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k < D; ++k) cav_lam[i][k] = bl[i][k] - ml[i][k];
    cav_lam[i][i] = cav_lam[i][i] + floor * bl[i][i] + jitter;
  }
  S cav_eta[D];
#pragma unroll
  for (int i = 0; i < D; ++i) cav_eta[i] = be[i] - me[i];
  S cav_cov[D][D];
  scaled_sym_inv(cav_lam, cav_cov);
  S cav_mu[D];
  mv(cav_cov, cav_eta, cav_mu);
  S jc[Z][D];
  mm(j, cav_cov, jc);
  mm_bt(jc, j, p);
  S dx[D];
#pragma unroll
  for (int i = 0; i < D; ++i) dx[i] = x0[i] - cav_mu[i];
  mv(j, dx, q);
}

// The message to slot a from the other slot's (p_o, q_o), damped and
// selected, written straight to the outputs.
template <typename S, int D>
__device__ __forceinline__ void emit(const S (&j)[Z][D], const S (&x0)[D],
                                     const S (&sigma)[Z][Z], const S (&p_o)[Z][Z],
                                     const S (&q_o)[Z], const S (&r0)[Z],
                                     const S* __restrict__ me_old, const S* __restrict__ ml_old,
                                     S* __restrict__ oe, S* __restrict__ ol, int64_t mp,
                                     int64_t r, S damp, S ldamp, bool on) {
  S sp[Z][Z], s_mat[Z][Z], s_inv[Z][Z];
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int k = 0; k < Z; ++k) sp[i][k] = sigma[i][k] + p_o[i][k];
  }
  sym(sp, s_mat);
  scaled_sym_inv(s_mat, s_inv);
  S sj[Z][D];
  mm(s_inv, j, sj);
  S jx[Z], u[Z];
  mv(j, x0, jx);
#pragma unroll
  for (int i = 0; i < Z; ++i) u[i] = (jx[i] + r0[i]) + q_o[i];
  S jtsj[D][D], lam[D][D];
  mm_at(j, sj, jtsj);
  sym(jtsj, lam);
  S eta[D];
  mv_at(sj, u, eta);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const S old = me_old[i * mp + r];
    oe[i * mp + r] = on ? (S(1.0) - damp) * eta[i] + damp * old : old;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const S old_l = ml_old[(i * D + k) * mp + r];
      ol[(i * D + k) * mp + r] = on ? (S(1.0) - ldamp) * lam[i][k] + ldamp * old_l : old_l;
    }
  }
}

// The scalar parameters of the message computation, rounded to S once.
template <typename S>
struct MsgParams {
  S eta_damping, lam_damping, num_undamped, floor, jitter;
  bool has_huber;
  S huber, two_huber, huber_sq;
};

template <typename S>
inline MsgParams<S> msg_params(double eta_damping, double lam_damping, double num_undamped,
                               double floor, double jitter, int has_huber, double huber) {
  return {static_cast<S>(eta_damping), static_cast<S>(lam_damping),
          static_cast<S>(num_undamped), static_cast<S>(floor), static_cast<S>(jitter),
          has_huber != 0, static_cast<S>(huber), static_cast<S>(2.0 * huber),
          static_cast<S>(huber * huber)};
}

// The four new messages of row r.  cam: the camera's packed belief row
// (eta | lam) [F_CAM]; the landmark's is read at r / deg.
template <typename S>
__device__ __forceinline__ void messages_row(
    const S* __restrict__ cam, const S* __restrict__ lmk_tab, const S* __restrict__ jac,
    const S* __restrict__ lp, const S* __restrict__ r0g, const S* __restrict__ prec,
    const S* __restrict__ srel, const S* __restrict__ act, const S* __restrict__ me0,
    const S* __restrict__ ml0, const S* __restrict__ me1, const S* __restrict__ ml1,
    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1,
    int64_t mp, int deg, int64_t r, const MsgParams<S>& p) {
  S j0[Z][D0], j1[Z][D1];
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int k = 0; k < D0; ++k) j0[i][k] = jac[(i * T9 + k) * mp + r];
#pragma unroll
    for (int k = 0; k < D1; ++k) j1[i][k] = jac[(i * T9 + D0 + k) * mp + r];
  }
  S x00[D0], x01[D1];
#pragma unroll
  for (int k = 0; k < D0; ++k) x00[k] = lp[k * mp + r];
#pragma unroll
  for (int k = 0; k < D1; ++k) x01[k] = lp[(D0 + k) * mp + r];
  const S r0[Z] = {r0g[r], r0g[mp + r]};
  const S pr[Z] = {prec[r], prec[mp + r]};

  // Huber covariance scaling from the linpoint residual.
  S sigma[Z][Z] = {{S(1.0) / pr[0], S(0.0)}, {S(0.0), S(1.0) / pr[1]}};
  if (p.has_huber) {
    const S m2 = add_rn(mul_rn(mul_rn(pr[0], r0[0]), r0[0]), mul_rn(mul_rn(pr[1], r0[1]), r0[1]));
    const S mm_ = g_sqrt(max_nan(m2, S(1e-12)));
    const S w = mm_ > p.huber ? p.two_huber / mm_ - p.huber_sq / (mm_ * mm_) : S(1.0);
    const S inv_w = S(1.0) / w;
#pragma unroll
    for (int i = 0; i < Z; ++i) {
#pragma unroll
      for (int k = 0; k < Z; ++k) sigma[i][k] = sigma[i][k] * inv_w;
    }
  }

  // Slot 0: the camera's cavity terms.
  S p0[Z][Z], q0[Z];
  {
    S be[D0], bl[D0][D0], me[D0], ml[D0][D0];
#pragma unroll
    for (int i = 0; i < D0; ++i) {
      be[i] = cam[i];
      me[i] = me0[i * mp + r];
#pragma unroll
      for (int k = 0; k < D0; ++k) {
        bl[i][k] = cam[D0 + i * D0 + k];
        ml[i][k] = ml0[(i * D0 + k) * mp + r];
      }
    }
    slot_terms(be, bl, me, ml, j0, x00, p.floor, p.jitter, p0, q0);
  }
  // Slot 1: the landmark's cavity terms.
  S p1[Z][Z], q1[Z];
  {
    const int64_t l = r / deg;
    S be[D1], bl[D1][D1], me[D1], ml[D1][D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      be[i] = lmk_tab[l * F_LMK + i];
      me[i] = me1[i * mp + r];
#pragma unroll
      for (int k = 0; k < D1; ++k) {
        bl[i][k] = lmk_tab[l * F_LMK + D1 + i * D1 + k];
        ml[i][k] = ml1[(i * D1 + k) * mp + r];
      }
    }
    slot_terms(be, bl, me, ml, j1, x01, p.floor, p.jitter, p1, q1);
  }

  const bool undamped = srel[r] >= p.num_undamped;
  const S damp = undamped ? p.eta_damping : S(0.0);
  const S ldamp = undamped ? p.lam_damping : S(0.0);
  const bool on = act[r] > S(0.5);
  emit(j0, x00, sigma, p1, q1, r0, me0, ml0, oe0, ol0, mp, r, damp, ldamp, on);
  emit(j1, x01, sigma, p0, q0, r0, me1, ml1, oe1, ol1, mp, r, damp, ldamp, on);
}

inline unsigned int n_blocks(int64_t threads) {
  return static_cast<unsigned int>((threads + BLOCK - 1) / BLOCK);
}

}  // namespace gbp
