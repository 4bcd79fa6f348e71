// The bundle-adjustment fast path's kernels for Hopper (sm_90a).
//
// Layout: component-major [F, mp], one thread per factor row, so the
// threads of a warp read neighbouring addresses of every component.  Slot 0
// is the camera (D0 = 6, gathered by id from a per-camera table staged in
// shared memory), slot 1 the landmark (D1 = 3, ELL slot: row r belongs to
// landmark r / deg), Z = 2.  The per-row arithmetic is in messages_rows.cuh,
// shared with the windowed kernels of windows.cu; the wrappers and plain
// versions are in gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing
// and launch on the caller's stream; each C entry returns cudaGetLastError().
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
//   (segment, component); its lanes stride over that segment's rows in the
//   fixed CSR order built with the graph, and a fixed __shfl_down_sync
//   tree combines them, so two runs give the same bits.  Any slot width d
//   and either layout (component-major in and out for the fast path,
//   row-major in and out for the generic sweep's scatter lowering).
#include "messages_rows.cuh"

namespace gbp {

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
  relin_row(tab + gidx[r] * D0, lmk_mean, z, lp, jac, r0, srel, act, olp, ojac, or0, osrel,
            mp, deg, r, beta, min_linear);
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
                MsgParams<S> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  for (int i = threadIdx.x; i < n_cam * F_CAM; i += blockDim.x) tab[i] = cam_tab[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  messages_row(tab + gidx[r] * F_CAM, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1,
               ml1, oe0, ol0, oe1, ol1, mp, deg, r, p);
}

template <typename S, class L>
__global__ void __launch_bounds__(BLOCK)
segsum_kernel(const S* __restrict__ me, int64_t me_ld, const S* __restrict__ ml, int64_t ml_ld,
              int d, const int* __restrict__ rows, const int* __restrict__ offsets, int n_seg,
              S* __restrict__ out, int64_t out_ld) {
  // Warp w sums component k = w % f of segment w / f, f = d + d * d.
  // blockDim is a multiple of 32, so a warp either exits whole or runs whole.
  const int f = d + d * d;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_seg) * f) return;
  const int seg = static_cast<int>(warp / f);
  const int k = static_cast<int>(warp % f);
  const S* __restrict__ src = k < d ? me : ml;
  const int64_t src_ld = k < d ? me_ld : ml_ld;
  const int ks = k < d ? k : k - d;
  const int end = offsets[seg + 1];
  S acc = S(0.0);
  for (int i = offsets[seg] + lane; i < end; i += 32) acc += src[L::at(ks, rows[i], src_ld)];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[L::at(k, seg, out_ld)] = acc;
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
      oe0, ol0, oe1, ol1, mp, deg,
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int segsum(const S* me, int64_t me_ld, const S* ml, int64_t ml_ld, int d, int rm,
           const int* rows, const int* offsets, int n_seg, S* out, void* stream) {
  const int f = d + d * d;
  const int64_t threads = static_cast<int64_t>(n_seg) * f * 32;
  if (threads <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  if (rm) {
    segsum_kernel<S, RowMajor><<<n_blocks(threads), BLOCK, 0, st>>>(
        me, me_ld, ml, ml_ld, d, rows, offsets, n_seg, out, f);
  } else {
    segsum_kernel<S, ColMajor><<<n_blocks(threads), BLOCK, 0, st>>>(
        me, me_ld, ml, ml_ld, d, rows, offsets, n_seg, out, n_seg);
  }
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
  extern "C" int gbp_segsum_by_id_##SFX(                                             \
      const S* me, int64_t me_ld, const S* ml, int64_t ml_ld, int d, int rm,         \
      const int* rows, const int* offsets, int n_seg, S* out, void* stream) {        \
    return gbp::segsum<S>(me, me_ld, ml, ml_ld, d, rm, rows, offsets, n_seg, out,    \
                          stream);                                                   \
  }

GBP_ENTRIES(f32, float)
GBP_ENTRIES(f64, double)
