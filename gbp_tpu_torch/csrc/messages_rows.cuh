// Per-factor-row bodies shared by all message and relinearization kernels.
//
// One thread owns one factor row r.  The kernels differ only in how the
// row's beliefs reach the thread and in the layout of the per-factor
// operands: messages.cu stages the whole gathered-slot table in shared
// memory, windows.cu stages the row's tile window of it (both
// component-major, the ELL slot's belief read at r / deg), unfused.cu reads
// the ELL slot from expanded operands instead, unfused_win.cu the gathered
// slot from the tile's window and the ELL slot from expanded operands,
// rows.cu both slots' beliefs from expanded per-row operands
// (component-major from device memory, row-major from shared-memory tiles).  All of them run
// `relin_core` and `messages_core`, so the arithmetic (operation order, the
// separately rounded beta and Huber decisions) is the same code.  The slot
// dofs, the measurement dim and the measurement model are template
// parameters: (6, 3, 2) `ReprojectionNormalized` and
// `BalReprojectionNormalized` (cameras and landmarks; the BAL model reads
// two per-row arguments), (9, 3, 2) `BalReprojectionIntrinsics` (9-dof BAL
// cameras), (3, 3, 3) `Se2Between` and (6, 6, 6) `Se3Between` (pose graphs,
// both slots on one variable block).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "comp_factors.cuh"
#include "comp_linalg.cuh"

namespace gbp {

constexpr int BLOCK = 256;
// Model ids of the C entries.
enum ModelId { MODEL_REPROJECTION = 0, MODEL_SE2 = 1, MODEL_SE3 = 2, MODEL_BAL_NORMALIZED = 3,
               MODEL_BAL_INTRINSICS = 4 };

// Call `fn(Model{})` for the model `id`; false for an unknown id.
template <class F>
inline bool with_model(int id, F&& fn) {
  switch (id) {
    case MODEL_REPROJECTION: fn(ReprojectionNormalized{}); return true;
    case MODEL_SE2: fn(Se2Between{}); return true;
    case MODEL_SE3: fn(Se3Between{}); return true;
    case MODEL_BAL_NORMALIZED: fn(BalReprojectionNormalized{}); return true;
    case MODEL_BAL_INTRINSICS: fn(BalReprojectionIntrinsics{}); return true;
    default: return false;
  }
}

// Where component k of row r of an operand lies, `ld` being the operand's
// leading stride: component-major [F, ld] or row-major [m, ld].
struct ColMajor {
  static __device__ __forceinline__ int64_t at(int k, int64_t r, int64_t ld) { return k * ld + r; }
};
struct RowMajor {
  static __device__ __forceinline__ int64_t at(int k, int64_t r, int64_t ld) { return r * ld + k; }
};
// ... or at the thread's own row of a shared-memory tile (rows_kernels.cuh):
// the operand pointer already points at that row, so component k is at k
// whatever r and ld (pass 0 for both).
struct SmemRow {
  static __device__ __forceinline__ int64_t at(int k, int64_t, int64_t) { return k; }
};

// The per-factor operands travel as raw __restrict__ pointers (the compiler
// may then keep loaded values across the stores of the outputs) and their
// leading strides as one object indexed by operand: one stride for all
// (the resident component-major state), or one per operand.
struct UniformLd {
  int64_t v;
  __device__ __forceinline__ int64_t operator[](int) const { return v; }
};
template <int N>
struct OpLds {
  int64_t v[N];
  __device__ __forceinline__ int64_t operator[](int i) const { return v[i]; }
};
// Operand order of the strides: relinearization, then messages.
enum RelinOp { R_Z, R_LP, R_JAC, R_R0, R_SREL, R_ACT, R_ARGS, R_OLP, R_OJAC, R_OR0, R_OSREL,
               N_RELIN_OPS };
enum MsgOp { M_JAC, M_LP, M_R0, M_PREC, M_SREL, M_ACT, M_ME0, M_ML0, M_ME1, M_ML1,
             M_OE0, M_OL0, M_OE1, M_OL1, N_MSG_OPS };

// A slot's belief (eta [D], lam [D][D]) as a packed (eta | lam) table row ...
template <typename S, int D>
struct PackedBelief {
  const S* __restrict__ row;
  __device__ __forceinline__ S eta(int i) const { return row[i]; }
  __device__ __forceinline__ S lam(int i, int k) const { return row[D + i * D + k]; }
};
// ... as the packed row of the ELL slot's variable r / deg, located where it
// is read: the 64-bit division, done ahead of the other slot's work, costs
// the float32 table kernel 55 registers and half its occupancy ...
template <typename S, int D>
struct EllBelief {
  const S* __restrict__ tab;
  int64_t r;
  int deg;
  __device__ __forceinline__ S eta(int i) const { return tab[(r / deg) * (D + D * D) + i]; }
  __device__ __forceinline__ S lam(int i, int k) const {
    return tab[(r / deg) * (D + D * D) + D + i * D + k];
  }
};
// ... or as row r of two expanded per-factor operands.
template <typename S, int D, class L>
struct ExpandedBelief {
  const S* __restrict__ be;
  const S* __restrict__ bl;
  int64_t be_ld, bl_ld, r;
  __device__ __forceinline__ S eta(int i) const { return be[L::at(i, r, be_ld)]; }
  __device__ __forceinline__ S lam(int i, int k) const { return bl[L::at(i * D + k, r, bl_ld)]; }
};

// Masked relinearization of row r at the adjacent means x under the
// measurement model M (its `residual` replaces r = z - h where the factor
// type wraps an angle or takes a manifold log).  `args` holds the model's
// M::NA per-row arguments (unread, and may be null, when NA is 0).
template <typename S, class M, class L, class LD>
__device__ __forceinline__ void relin_core(
    const S (&x)[M::DA + M::DB], const S* __restrict__ z, const S* __restrict__ args,
    const S* __restrict__ lp, const S* __restrict__ jac, const S* __restrict__ r0,
    const S* __restrict__ srel, const S* __restrict__ act, S* __restrict__ olp,
    S* __restrict__ ojac, S* __restrict__ or0, S* __restrict__ osrel, const LD& ld, int64_t r,
    S beta, S min_linear) {
  constexpr int TD = M::DA + M::DB;
  constexpr int ZD = M::ZD;
  S lp_o[TD];
#pragma unroll
  for (int i = 0; i < TD; ++i) lp_o[i] = lp[L::at(i, r, ld[R_LP])];
  // Separately rounded, in the plain version's order: the beta decision
  // must not flip between the kernel and its plain version.
  S dist2 = mul_rn(x[0] - lp_o[0], x[0] - lp_o[0]);
#pragma unroll
  for (int i = 1; i < TD; ++i) dist2 = add_rn(dist2, mul_rn(x[i] - lp_o[i], x[i] - lp_o[i]));
  const S sr = srel[L::at(0, r, ld[R_SREL])];
  const bool eligible = (dist2 > mul_rn(beta, beta)) && (sr >= min_linear) &&
                        (act[L::at(0, r, ld[R_ACT])] > S(0.5));

  if (eligible) {
    S h[ZD], jn[ZD][TD], zm[ZD], rn[ZD];
    S a[M::NA > 0 ? M::NA : 1] = {};
#pragma unroll
    for (int i = 0; i < M::NA; ++i) a[i] = args[L::at(i, r, ld[R_ARGS])];
    M::eval(x, a, h, jn);
#pragma unroll
    for (int i = 0; i < ZD; ++i) zm[i] = z[L::at(i, r, ld[R_Z])];
    M::residual(zm, h, rn);
#pragma unroll
    for (int i = 0; i < TD; ++i) olp[L::at(i, r, ld[R_OLP])] = x[i];
#pragma unroll
    for (int i = 0; i < ZD; ++i) {
      or0[L::at(i, r, ld[R_OR0])] = rn[i];
#pragma unroll
      for (int j = 0; j < TD; ++j) ojac[L::at(i * TD + j, r, ld[R_OJAC])] = jn[i][j];
    }
    osrel[L::at(0, r, ld[R_OSREL])] = S(0.0);
  } else {
#pragma unroll
    for (int i = 0; i < TD; ++i) olp[L::at(i, r, ld[R_OLP])] = lp_o[i];
#pragma unroll
    for (int i = 0; i < ZD; ++i) or0[L::at(i, r, ld[R_OR0])] = r0[L::at(i, r, ld[R_R0])];
#pragma unroll
    for (int k = 0; k < ZD * TD; ++k) ojac[L::at(k, r, ld[R_OJAC])] = jac[L::at(k, r, ld[R_JAC])];
    osrel[L::at(0, r, ld[R_OSREL])] = sr + S(1.0);
  }
}

// The adjacent means x of a row from its gathered variable's mean `gat` and
// its ELL variable's mean `ell`, in slot order: the gathered slot is slot
// `gslot`, the ELL slot the other.
template <typename S, class M>
__device__ __forceinline__ void slot_means(const S* __restrict__ gat, const S* __restrict__ ell,
                                           int64_t ell_stride, int gslot,
                                           S (&x)[M::DA + M::DB]) {
  if (gslot == 0) {
#pragma unroll
    for (int i = 0; i < M::DA; ++i) x[i] = gat[i];
#pragma unroll
    for (int i = 0; i < M::DB; ++i) x[M::DA + i] = ell[i * ell_stride];
  } else {
#pragma unroll
    for (int i = 0; i < M::DA; ++i) x[i] = ell[i * ell_stride];
#pragma unroll
    for (int i = 0; i < M::DB; ++i) x[M::DA + i] = gat[i];
  }
}

// Dofs of the gathered slot of model M.
template <class M>
__host__ __device__ constexpr int gathered_dofs(int gslot) {
  return gslot == 0 ? M::DA : M::DB;
}

// The table form on component-major [F, mp] state.  gat: the gathered
// slot's mean; the ELL slot's mean is read at r / deg.
template <typename S, class M>
__device__ __forceinline__ void relin_row(
    const S* __restrict__ gat, const S* __restrict__ ell_mean, const S* __restrict__ z,
    const S* __restrict__ args, const S* __restrict__ lp, const S* __restrict__ jac,
    const S* __restrict__ r0, const S* __restrict__ srel, const S* __restrict__ act,
    S* __restrict__ olp, S* __restrict__ ojac, S* __restrict__ or0, S* __restrict__ osrel,
    int64_t mp, int deg, int gslot, int64_t r, S beta, S min_linear) {
  const int64_t l = r / deg;
  S x[M::DA + M::DB];
  slot_means<S, M>(gat, ell_mean + l * (M::DA + M::DB - gathered_dofs<M>(gslot)), 1, gslot, x);
  relin_core<S, M, ColMajor>(x, z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel,
                             UniformLd{mp}, r, beta, min_linear);
}

// Cavity of one slot and its projection through that slot's Jacobian:
// p = J C^-1 J^T [ZD][ZD], q = J (x0 - C^-1 cav_eta) [ZD].
template <typename S, int D, int ZD>
__device__ __forceinline__ void slot_terms(const S (&be)[D], const S (&bl)[D][D],
                                           const S (&me)[D], const S (&ml)[D][D],
                                           const S (&j)[ZD][D], const S (&x0)[D],
                                           S floor, S jitter, S (&p)[ZD][ZD], S (&q)[ZD]) {
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
  S jc[ZD][D];
  mm(j, cav_cov, jc);
  mm_bt(jc, j, p);
  S dx[D];
#pragma unroll
  for (int i = 0; i < D; ++i) dx[i] = x0[i] - cav_mu[i];
  mv(j, dx, q);
}

// The message to slot a from the other slot's (p_o, q_o), damped and
// selected, written straight to the outputs.
template <typename S, int D, int ZD, class L>
__device__ __forceinline__ void emit(const S (&j)[ZD][D], const S (&x0)[D],
                                     const S (&sigma)[ZD][ZD], const S (&p_o)[ZD][ZD],
                                     const S (&q_o)[ZD], const S (&r0)[ZD],
                                     const S* __restrict__ me_old, int64_t me_ld,
                                     const S* __restrict__ ml_old, int64_t ml_ld,
                                     S* __restrict__ oe, int64_t oe_ld, S* __restrict__ ol,
                                     int64_t ol_ld, int64_t r, S damp, S ldamp, bool on) {
  S sp[ZD][ZD], s_mat[ZD][ZD], s_inv[ZD][ZD];
#pragma unroll
  for (int i = 0; i < ZD; ++i) {
#pragma unroll
    for (int k = 0; k < ZD; ++k) sp[i][k] = sigma[i][k] + p_o[i][k];
  }
  sym(sp, s_mat);
  scaled_sym_inv(s_mat, s_inv);
  S sj[ZD][D];
  mm(s_inv, j, sj);
  S jx[ZD], u[ZD];
  mv(j, x0, jx);
#pragma unroll
  for (int i = 0; i < ZD; ++i) u[i] = (jx[i] + r0[i]) + q_o[i];
  S jtsj[D][D], lam[D][D];
  mm_at(j, sj, jtsj);
  sym(jtsj, lam);
  S eta[D];
  mv_at(sj, u, eta);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const S old = me_old[L::at(i, r, me_ld)];
    oe[L::at(i, r, oe_ld)] = on ? (S(1.0) - damp) * eta[i] + damp * old : old;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const S old_l = ml_old[L::at(i * D + k, r, ml_ld)];
      ol[L::at(i * D + k, r, ol_ld)] =
          on ? (S(1.0) - ldamp) * lam[i][k] + ldamp * old_l : old_l;
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

// The four new messages of row r for slots of DA and DB dofs and a ZD-dim
// measurement; b0 and b1 hand out the two slots' beliefs.  PREC_FULL: prec
// holds the row's full [ZD][ZD] precision instead of its diagonal.
// HUBER_ROW: the row's own Huber threshold rides as the component after
// the precision (0 = off for that row); otherwise p.has_huber / p.huber.
template <typename S, int DA, int DB, int ZD, class L, bool PREC_FULL, bool HUBER_ROW, class B0,
          class B1, class LD>
__device__ __forceinline__ void messages_core(
    const B0& b0, const B1& b1, const S* __restrict__ jac, const S* __restrict__ lp,
    const S* __restrict__ r0g, const S* __restrict__ prec, const S* __restrict__ srel,
    const S* __restrict__ act, const S* __restrict__ me0, const S* __restrict__ ml0,
    const S* __restrict__ me1, const S* __restrict__ ml1, S* __restrict__ oe0,
    S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1, const LD& ld, int64_t r,
    const MsgParams<S>& p) {
  constexpr int TD = DA + DB;
  S j0[ZD][DA], j1[ZD][DB];
#pragma unroll
  for (int i = 0; i < ZD; ++i) {
#pragma unroll
    for (int k = 0; k < DA; ++k) j0[i][k] = jac[L::at(i * TD + k, r, ld[M_JAC])];
#pragma unroll
    for (int k = 0; k < DB; ++k) j1[i][k] = jac[L::at(i * TD + DA + k, r, ld[M_JAC])];
  }
  S x00[DA], x01[DB];
#pragma unroll
  for (int k = 0; k < DA; ++k) x00[k] = lp[L::at(k, r, ld[M_LP])];
#pragma unroll
  for (int k = 0; k < DB; ++k) x01[k] = lp[L::at(DA + k, r, ld[M_LP])];
  S r0[ZD];
#pragma unroll
  for (int i = 0; i < ZD; ++i) r0[i] = r0g[L::at(i, r, ld[M_R0])];

  // Measurement covariance, and for the Huber weight the squared
  // Mahalanobis residual (separately rounded, in the plain version's order:
  // the Huber decision must not flip).
  const bool robust = HUBER_ROW || p.has_huber;
  S sigma[ZD][ZD];
  S m2 = S(0.0);
  if constexpr (PREC_FULL) {
    S pm[ZD][ZD];
#pragma unroll
    for (int i = 0; i < ZD; ++i) {
#pragma unroll
      for (int k = 0; k < ZD; ++k) pm[i][k] = prec[L::at(i * ZD + k, r, ld[M_PREC])];
    }
    if (robust) {
#pragma unroll
      for (int i = 0; i < ZD; ++i) {
        S pr_i = mul_rn(pm[i][0], r0[0]);
#pragma unroll
        for (int k = 1; k < ZD; ++k) pr_i = add_rn(pr_i, mul_rn(pm[i][k], r0[k]));
        m2 = i == 0 ? mul_rn(r0[0], pr_i) : add_rn(m2, mul_rn(r0[i], pr_i));
      }
    }
    scaled_sym_inv(pm, sigma);
  } else {
    S pr[ZD];
#pragma unroll
    for (int i = 0; i < ZD; ++i) {
      pr[i] = prec[L::at(i, r, ld[M_PREC])];
#pragma unroll
      for (int k = 0; k < ZD; ++k) sigma[i][k] = i == k ? S(1.0) / pr[i] : S(0.0);
    }
    if (robust) {
#pragma unroll
      for (int i = 0; i < ZD; ++i) {
        const S term = mul_rn(mul_rn(pr[i], r0[i]), r0[i]);
        m2 = i == 0 ? term : add_rn(m2, term);
      }
    }
  }
  // Huber covariance scaling from the linpoint residual.
  if (robust) {
    const S mm_ = g_sqrt(max_nan(m2, S(1e-12)));
    S w;
    if constexpr (HUBER_ROW) {
      const S t = prec[L::at(PREC_FULL ? ZD * ZD : ZD, r, ld[M_PREC])];
      w = (mm_ > t && t > S(0.0)) ? S(2.0) * t / mm_ - (t * t) / (mm_ * mm_) : S(1.0);
    } else {
      w = mm_ > p.huber ? p.two_huber / mm_ - p.huber_sq / (mm_ * mm_) : S(1.0);
    }
    const S inv_w = S(1.0) / w;
#pragma unroll
    for (int i = 0; i < ZD; ++i) {
#pragma unroll
      for (int k = 0; k < ZD; ++k) sigma[i][k] = sigma[i][k] * inv_w;
    }
  }

  // Slot 0's cavity terms.
  S p0[ZD][ZD], q0[ZD];
  {
    S be[DA], bl[DA][DA], me[DA], ml[DA][DA];
#pragma unroll
    for (int i = 0; i < DA; ++i) {
      be[i] = b0.eta(i);
      me[i] = me0[L::at(i, r, ld[M_ME0])];
#pragma unroll
      for (int k = 0; k < DA; ++k) {
        bl[i][k] = b0.lam(i, k);
        ml[i][k] = ml0[L::at(i * DA + k, r, ld[M_ML0])];
      }
    }
    slot_terms(be, bl, me, ml, j0, x00, p.floor, p.jitter, p0, q0);
  }
  // Slot 1's cavity terms.
  S p1[ZD][ZD], q1[ZD];
  {
    S be[DB], bl[DB][DB], me[DB], ml[DB][DB];
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      be[i] = b1.eta(i);
      me[i] = me1[L::at(i, r, ld[M_ME1])];
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        bl[i][k] = b1.lam(i, k);
        ml[i][k] = ml1[L::at(i * DB + k, r, ld[M_ML1])];
      }
    }
    slot_terms(be, bl, me, ml, j1, x01, p.floor, p.jitter, p1, q1);
  }

  const bool undamped = srel[L::at(0, r, ld[M_SREL])] >= p.num_undamped;
  const S damp = undamped ? p.eta_damping : S(0.0);
  const S ldamp = undamped ? p.lam_damping : S(0.0);
  const bool on = act[L::at(0, r, ld[M_ACT])] > S(0.5);
  emit<S, DA, ZD, L>(j0, x00, sigma, p1, q1, r0, me0, ld[M_ME0], ml0, ld[M_ML0], oe0,
                     ld[M_OE0], ol0, ld[M_OL0], r, damp, ldamp, on);
  emit<S, DB, ZD, L>(j1, x01, sigma, p0, q0, r0, me1, ld[M_ME1], ml1, ld[M_ML1], oe1,
                     ld[M_OE1], ol1, ld[M_OL1], r, damp, ldamp, on);
}

// The table form on component-major [F, mp] state, diagonal precision.  gat:
// the gathered slot's packed belief row (eta | lam); the ELL slot's is read
// at r / deg.  The gathered slot is slot GSLOT.
template <typename S, int DA, int DB, int ZD, bool HUBER_ROW, int GSLOT>
__device__ __forceinline__ void messages_row(
    const S* __restrict__ gat, const S* __restrict__ ell_tab, const S* __restrict__ jac,
    const S* __restrict__ lp, const S* __restrict__ r0g, const S* __restrict__ prec,
    const S* __restrict__ srel, const S* __restrict__ act, const S* __restrict__ me0,
    const S* __restrict__ ml0, const S* __restrict__ me1, const S* __restrict__ ml1,
    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1,
    int64_t mp, int deg, int64_t r, const MsgParams<S>& p) {
  if constexpr (GSLOT == 0) {
    const PackedBelief<S, DA> b0{gat};
    const EllBelief<S, DB> b1{ell_tab, r, deg};
    messages_core<S, DA, DB, ZD, ColMajor, false, HUBER_ROW>(
        b0, b1, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
        UniformLd{mp}, r, p);
  } else {
    const EllBelief<S, DA> b0{ell_tab, r, deg};
    const PackedBelief<S, DB> b1{gat};
    messages_core<S, DA, DB, ZD, ColMajor, false, HUBER_ROW>(
        b0, b1, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
        UniformLd{mp}, r, p);
  }
}

// A table kernel's shape: slot dofs, measurement dim, and which slot is the
// gathered one; F_G is the gathered slot's packed (eta | lam) row.
template <int A, int B, int Z_, int G>
struct Shape {
  static constexpr int DA = A, DB = B, ZD = Z_, GSLOT = G;
  static constexpr int DG = G == 0 ? A : B;
  static constexpr int F_G = DG + DG * DG;
};
// Call `fn(Shape{})` for an instantiated shape; false otherwise.  Every
// shape is instantiated with either slot gathered: cameras and landmarks
// with the cameras gathered (landmarks in the ELL slot) or, on a graph with
// more cameras than landmarks, the landmarks gathered (cameras in the ELL
// slot); a pose graph's ELL layout may group by either end of its between
// factors.  The messages kernels at (9, 3, 2), the 9-dof BAL camera, and at
// both camera shapes with the landmarks gathered are compiled in sources of
// their own (bal9_table_*.cu, lmk_table_*.cu; table_kernels.cuh).
template <class F>
inline bool with_table_shape(int da, int db, int zd, int gslot, F&& fn) {
  if (da == 6 && db == 3 && zd == 2 && gslot == 0) { fn(Shape<6, 3, 2, 0>{}); return true; }
  if (da == 6 && db == 3 && zd == 2 && gslot == 1) { fn(Shape<6, 3, 2, 1>{}); return true; }
  if (da == 9 && db == 3 && zd == 2 && gslot == 0) { fn(Shape<9, 3, 2, 0>{}); return true; }
  if (da == 9 && db == 3 && zd == 2 && gslot == 1) { fn(Shape<9, 3, 2, 1>{}); return true; }
  if (da == 3 && db == 3 && zd == 3 && gslot == 0) { fn(Shape<3, 3, 3, 0>{}); return true; }
  if (da == 3 && db == 3 && zd == 3 && gslot == 1) { fn(Shape<3, 3, 3, 1>{}); return true; }
  if (da == 6 && db == 6 && zd == 6 && gslot == 0) { fn(Shape<6, 6, 6, 0>{}); return true; }
  if (da == 6 && db == 6 && zd == 6 && gslot == 1) { fn(Shape<6, 6, 6, 1>{}); return true; }
  return false;
}

inline unsigned int n_blocks(int64_t threads) {
  return static_cast<unsigned int>((threads + BLOCK - 1) / BLOCK);
}

}  // namespace gbp
