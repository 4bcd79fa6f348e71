// The bundle-adjustment fast path's kernels for Hopper (sm_90a).
//
// Layout: component-major [F, mp], one thread per factor row, so the
// threads of a warp read neighbouring addresses of every component.  Slot 0
// is the camera (D0 = 6, gathered by id from a per-camera table staged in
// shared memory), slot 1 the landmark (D1 = 3, ELL slot: row r belongs to
// landmark r / deg), Z = 2.  The wrappers and plain versions are in
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on
// the caller's stream; each C entry returns cudaGetLastError().
//
// relin_cm_tab_ell
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_relin_cm_tab_ell`
//   (`_kernel_relin_tab_ell` + `_relin_math`).
//   Bound: device-memory bytes.  Per row it reads 9 + 18 + 2 + 2 + 1 + 1
//   components plus two table entries and writes 30, against a few hundred
//   flops (Rodrigues, the 2x9 Jacobian).
//   Design: the camera means (n_cam x 6) sit in shared memory, so the
//   per-row camera read is a shared-memory index instead of the TPU's
//   one-hot matrix dots; landmark means are read at r / deg, which
//   neighbouring threads share (deg rows per landmark), so they hit L1.
//
// messages_cm_tab_ell
//   Replaces `fused_messages_cm_tab_ell`'s first four outputs
//   (`_kernel_tab_ell` + `_message_math`).
//   Bound: registers.  One thread holds a 6x6 cavity, its Jacobi-scaled
//   Schur-recursion inverse, the 2x9 Jacobian and the 6x6 message at once
//   (the -Xptxas -v report gives the spill bytes), while the bytes moved
//   are ~100 components per row.
//   Design: the packed camera belief table (n_cam x 42) is staged in shared
//   memory; landmark beliefs come from row / deg.  The whole per-factor
//   computation stays in one thread with fully unrolled fixed-size arrays;
//   masked rows keep their old message through a select.
//
// segsum_by_id
//   Replaces `segsum_cm` and the 5th output of `fused_messages_cm_tab_ell`
//   (`_kernel_segsum`, `_segsum_partial_full`).
//   Bound: device-memory reads of the 42 camera-message components (plus
//   the row index), scattered by the landmark grouping.
//   Design: deterministic by construction, no atomics.  One warp per
//   (camera, component); its lanes stride over that camera's rows in the
//   fixed CSR order built at prepare time, and a fixed __shfl_down_sync
//   tree combines them, so two runs give the same bits.
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

template <typename S>
__global__ void __launch_bounds__(BLOCK)
relin_kernel(const S* __restrict__ cam_mean, int n_cam,
             const S* __restrict__ lmk_mean, const int* __restrict__ gidx,
             const S* __restrict__ z, const S* __restrict__ lp,
             const S* __restrict__ jac, const S* __restrict__ r0,
             const S* __restrict__ srel, const S* __restrict__ act,
             S* __restrict__ olp, S* __restrict__ ojac, S* __restrict__ or0,
             S* __restrict__ osrel, int64_t mp, int deg, S beta, S min_linear) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  for (int i = threadIdx.x; i < n_cam * D0; i += blockDim.x) tab[i] = cam_mean[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;

  const int g = gidx[r];
  const int64_t l = r / deg;
  S x[T9], lp_o[T9];
#pragma unroll
  for (int i = 0; i < D0; ++i) x[i] = tab[g * D0 + i];
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

template <typename S>
__global__ void __launch_bounds__(BLOCK)
messages_kernel(const S* __restrict__ cam_tab, int n_cam,
                const S* __restrict__ lmk_tab, const int* __restrict__ gidx,
                const S* __restrict__ jac, const S* __restrict__ lp,
                const S* __restrict__ r0g, const S* __restrict__ prec,
                const S* __restrict__ srel, const S* __restrict__ act,
                const S* __restrict__ me0, const S* __restrict__ ml0,
                const S* __restrict__ me1, const S* __restrict__ ml1,
                S* __restrict__ oe0, S* __restrict__ ol0,
                S* __restrict__ oe1, S* __restrict__ ol1, int64_t mp, int deg,
                S eta_damping, S lam_damping, S num_undamped, S floor, S jitter,
                bool has_huber, S huber, S two_huber, S huber_sq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  for (int i = threadIdx.x; i < n_cam * F_CAM; i += blockDim.x) tab[i] = cam_tab[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;

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
  if (has_huber) {
    const S m2 = add_rn(mul_rn(mul_rn(pr[0], r0[0]), r0[0]), mul_rn(mul_rn(pr[1], r0[1]), r0[1]));
    const S mm_ = g_sqrt(max_nan(m2, S(1e-12)));
    const S w = mm_ > huber ? two_huber / mm_ - huber_sq / (mm_ * mm_) : S(1.0);
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
    const int g = gidx[r];
    S be[D0], bl[D0][D0], me[D0], ml[D0][D0];
#pragma unroll
    for (int i = 0; i < D0; ++i) {
      be[i] = tab[g * F_CAM + i];
      me[i] = me0[i * mp + r];
#pragma unroll
      for (int k = 0; k < D0; ++k) {
        bl[i][k] = tab[g * F_CAM + D0 + i * D0 + k];
        ml[i][k] = ml0[(i * D0 + k) * mp + r];
      }
    }
    slot_terms(be, bl, me, ml, j0, x00, floor, jitter, p0, q0);
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
    slot_terms(be, bl, me, ml, j1, x01, floor, jitter, p1, q1);
  }

  const bool undamped = srel[r] >= num_undamped;
  const S damp = undamped ? eta_damping : S(0.0);
  const S ldamp = undamped ? lam_damping : S(0.0);
  const bool on = act[r] > S(0.5);
  emit(j0, x00, sigma, p1, q1, r0, me0, ml0, oe0, ol0, mp, r, damp, ldamp, on);
  emit(j1, x01, sigma, p0, q0, r0, me1, ml1, oe1, ol1, mp, r, damp, ldamp, on);
}

template <typename S>
__global__ void __launch_bounds__(BLOCK)
segsum_kernel(const S* __restrict__ me, const S* __restrict__ ml,
              const int* __restrict__ rows, const int* __restrict__ offsets,
              int n_seg, int64_t mp, S* __restrict__ out) {
  // Warp w sums component k = w % F_CAM of segment w / F_CAM.  blockDim is
  // a multiple of 32, so a warp either exits whole or runs whole.
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_seg) * F_CAM) return;
  const int seg = static_cast<int>(warp / F_CAM);
  const int k = static_cast<int>(warp % F_CAM);
  const S* src = k < D0 ? me + k * mp : ml + (k - D0) * mp;
  const int end = offsets[seg + 1];
  S acc = S(0.0);
  for (int i = offsets[seg] + lane; i < end; i += 32) acc += src[rows[i]];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[static_cast<int64_t>(k) * n_seg + seg] = acc;
}

inline unsigned int n_blocks(int64_t threads) {
  return static_cast<unsigned int>((threads + BLOCK - 1) / BLOCK);
}

template <typename S>
int relin(const S* cam_mean, int n_cam, const S* lmk_mean, int nv, const int* gidx,
          const S* z, const S* lp, const S* jac, const S* r0, const S* srel,
          const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, int deg,
          double beta, double min_linear, void* stream) {
  (void)nv;
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n_cam) * D0 * sizeof(S);
  relin_kernel<S><<<n_blocks(mp), BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      cam_mean, n_cam, lmk_mean, gidx, z, lp, jac, r0, srel, act, olp, ojac, or0,
      osrel, mp, deg, static_cast<S>(beta), static_cast<S>(min_linear));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages(const S* cam_tab, int n_cam, const S* lmk_tab, int nv, const int* gidx,
             const S* jac, const S* lp, const S* r0, const S* prec, const S* srel,
             const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,
             S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, double eta_damping,
             double lam_damping, double num_undamped, double floor, double jitter,
             int has_huber, double huber, void* stream) {
  (void)nv;
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n_cam) * F_CAM * sizeof(S);
  messages_kernel<S><<<n_blocks(mp), BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      cam_tab, n_cam, lmk_tab, gidx, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1,
      oe0, ol0, oe1, ol1, mp, deg, static_cast<S>(eta_damping),
      static_cast<S>(lam_damping), static_cast<S>(num_undamped), static_cast<S>(floor),
      static_cast<S>(jitter), has_huber != 0, static_cast<S>(huber),
      static_cast<S>(2.0 * huber), static_cast<S>(huber * huber));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int segsum(const S* me, const S* ml, const int* rows, const int* offsets, int n_seg,
           int64_t mp, S* out, void* stream) {
  const int64_t threads = static_cast<int64_t>(n_seg) * F_CAM * 32;
  if (threads <= 0) return static_cast<int>(cudaGetLastError());
  segsum_kernel<S><<<n_blocks(threads), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      me, ml, rows, offsets, n_seg, mp, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_ENTRIES(SFX, S)                                                          \
  extern "C" int gbp_relin_cm_tab_ell_##SFX(                                         \
      const S* cam_mean, int n_cam, const S* lmk_mean, int nv, const int* gidx,      \
      const S* z, const S* lp, const S* jac, const S* r0, const S* srel,             \
      const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, int deg,          \
      double beta, double min_linear, void* stream) {                                \
    return gbp::relin<S>(cam_mean, n_cam, lmk_mean, nv, gidx, z, lp, jac, r0, srel,  \
                         act, olp, ojac, or0, osrel, mp, deg, beta, min_linear,      \
                         stream);                                                    \
  }                                                                                  \
  extern "C" int gbp_messages_cm_tab_ell_##SFX(                                      \
      const S* cam_tab, int n_cam, const S* lmk_tab, int nv, const int* gidx,        \
      const S* jac, const S* lp, const S* r0, const S* prec, const S* srel,          \
      const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,          \
      S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, double eta_damping,       \
      double lam_damping, double num_undamped, double floor, double jitter,          \
      int has_huber, double huber, void* stream) {                                   \
    return gbp::messages<S>(cam_tab, n_cam, lmk_tab, nv, gidx, jac, lp, r0, prec,    \
                            srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp,   \
                            deg, eta_damping, lam_damping, num_undamped, floor,      \
                            jitter, has_huber, huber, stream);                       \
  }                                                                                  \
  extern "C" int gbp_segsum_by_id_##SFX(const S* me, const S* ml, const int* rows,   \
                                        const int* offsets, int n_seg, int64_t mp,   \
                                        S* out, void* stream) {                      \
    return gbp::segsum<S>(me, ml, rows, offsets, n_seg, mp, out, stream);            \
  }

GBP_ENTRIES(f32, float)
GBP_ENTRIES(f64, double)
