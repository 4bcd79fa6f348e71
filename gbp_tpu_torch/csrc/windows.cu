// The windowed large-scene kernels for Hopper (sm_90a): city and venice
// bundle adjustment, where the camera table no longer fits one block's
// shared memory.
//
// Rows are cut into tiles of TILE = 1024 factor rows.  After the locality
// sort of core/sweep_cm.py every camera id of tile i lies in the window
// [starts[i], starts[i] + w).  Layout and slots as in messages.cu; the
// per-row arithmetic is the same code (messages_rows.cuh).  The wrappers and
// plain versions are in gbp_tpu_torch/ops/messages.py.  Kernels allocate
// nothing and launch on the caller's stream; each C entry returns
// cudaGetLastError().
//
// relin_cm_tabblk_ell
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_relin_cm_tabblk_ell`
//   (`_kernel_relin_tab_blk_ell`: camera means from the tile's window
//   stack, landmark means from the tile's ELL group window).
//   Bound: device-memory bytes, as relin_cm_tab_ell.
//   Design: one block per tile stages the tile's window of the camera means
//   (w x 6) in shared memory once and walks the tile's 1024 rows in four
//   passes of 256 threads; a row reads its camera at gidx[r] - start.  The
//   TPU's per-tile table stacks and one-hot dots become that index read.
//
// messages_cm_tabblk_ell
//   Replaces the first four outputs of `fused_messages_cm_tabblk_ell`
//   (`_kernel_tab_blk_ell`).
//   Bound: registers (see messages.cu) and, for wide windows, shared memory:
//   the window of packed beliefs is w x 42 values (21.5 KB at w = 128 in
//   float32, 64.5 KB at w = 384, twice that in float64), so above 48 KB the
//   launch opts into dynamic shared memory and fewer blocks share an SM.
//   Design: as above with the packed (eta | lam) rows.  An id outside its
//   tile's window is a fault of the prepared graph: the kernel traps, it
//   never clamps.
//
// segsum_cm_blk
//   Replaces `segsum_cm_blk`'s kernel stage (`_kernel_segsum_blk`) and the
//   5th output of `fused_messages_cm_tabblk_ell` (`_segsum_partial_blk`):
//   part[i, k, j] = sum of component k over the rows of tile i whose camera
//   id is starts[i] + j.
//   Bound: device-memory bytes: the 42 message components read once, the
//   [n_tiles, 42, w] partials written once (mostly zeros: a tile touches
//   few of its window's cameras).
//   Design: deterministic, no atomics.  A CSR of each tile's rows by window
//   column is built once at prepare time; one thread per output (tile, k, j)
//   adds its rows in CSR order, so neighbouring threads write neighbouring
//   addresses and two runs give the same bits.  A tile's rows span 4 KB per
//   component, so the scattered reads stay in cache.
//
// scatter_windows_cm
//   Replaces `scatter_windows_cm` (`_kernel_scatter_win`): out[k, c] = sum
//   over the tiles i whose window holds c of part[i, k, c - starts[i]], in
//   ascending i, the order of the reference's sequential grid.
//   Bound: device-memory bytes: the partials read once.
//   Design: the TPU kernel walks the tiles in order and adds each window
//   into a resident accumulator; blocks here run in no order, so the sum is
//   turned around: one thread per output (k, c) walks the list of tiles that
//   cover camera c (built at prepare time, ascending).  Starts travel as
//   int32, not through a float row.
#include "messages_rows.cuh"

namespace gbp {

constexpr int TILE = 1024;
constexpr int RED_BLOCK = 128;

// Stage rows [start, start + n_in) of a row-major [n_cam, F] table.
template <typename S, int F>
__device__ __forceinline__ void stage_window(const S* __restrict__ table, int start, int n_in,
                                             S* __restrict__ tab) {
  const S* src = table + static_cast<int64_t>(start) * F;
  for (int i = threadIdx.x; i < n_in * F; i += blockDim.x) tab[i] = src[i];
  __syncthreads();
}

template <typename S>
__global__ void __launch_bounds__(BLOCK)
relin_win_kernel(const S* __restrict__ cam_mean, int n_cam,
                 const S* __restrict__ lmk_mean, const int* __restrict__ gidx,
                 const int* __restrict__ starts, int win_w,
                 const S* __restrict__ z, const S* __restrict__ lp,
                 const S* __restrict__ jac, const S* __restrict__ r0,
                 const S* __restrict__ srel, const S* __restrict__ act,
                 S* __restrict__ olp, S* __restrict__ ojac, S* __restrict__ or0,
                 S* __restrict__ osrel, int64_t mp, int deg, S beta, S min_linear) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  // The window may reach past the last camera (starts are cut against the
  // table padded to a multiple of 8); only rows that exist are staged.
  const int n_in = min(win_w, n_cam - start);
  stage_window<S, D0>(cam_mean, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    const int off = gidx[r] - start;
    if (off < 0 || off >= n_in) __trap();
    relin_row(tab + off * D0, lmk_mean, z, lp, jac, r0, srel, act, olp, ojac, or0, osrel,
              mp, deg, r, beta, min_linear);
  }
}

template <typename S>
__global__ void __launch_bounds__(BLOCK)
messages_win_kernel(const S* __restrict__ cam_tab, int n_cam,
                    const S* __restrict__ lmk_tab, const int* __restrict__ gidx,
                    const int* __restrict__ starts, int win_w,
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
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_cam - start);
  stage_window<S, F_CAM>(cam_tab, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    const int off = gidx[r] - start;
    if (off < 0 || off >= n_in) __trap();
    messages_row(tab + off * F_CAM, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1,
                 ml1, oe0, ol0, oe1, ol1, mp, deg, r, p);
  }
}

// grid.x = n_tiles * ceil(w / RED_BLOCK), grid.y = f components.
template <typename S>
__global__ void __launch_bounds__(RED_BLOCK)
segsum_blk_kernel(const S* __restrict__ me, const S* __restrict__ ml, int d,
                  const int* __restrict__ rows, const int* __restrict__ offsets,
                  int w, int64_t mp, S* __restrict__ out) {
  const int jb = (w + RED_BLOCK - 1) / RED_BLOCK;
  const int tile = blockIdx.x / jb;
  const int j = (blockIdx.x % jb) * RED_BLOCK + threadIdx.x;
  if (j >= w) return;
  const int k = blockIdx.y;
  const int f = gridDim.y;
  const S* src = k < d ? me + static_cast<int64_t>(k) * mp : ml + static_cast<int64_t>(k - d) * mp;
  const int64_t seg = static_cast<int64_t>(tile) * w + j;
  const int end = offsets[seg + 1];
  S acc = S(0.0);
  for (int i = offsets[seg]; i < end; ++i) acc += src[rows[i]];
  out[(static_cast<int64_t>(tile) * f + k) * w + j] = acc;
}

// grid.x = ceil(n_seg / RED_BLOCK), grid.y = f components.
template <typename S>
__global__ void __launch_bounds__(RED_BLOCK)
scatter_win_kernel(const S* __restrict__ part, const int* __restrict__ starts,
                   const int* __restrict__ cov_tiles, const int* __restrict__ cov_offsets,
                   int w, int n_seg, S* __restrict__ out) {
  const int c = blockIdx.x * RED_BLOCK + threadIdx.x;
  if (c >= n_seg) return;
  const int k = blockIdx.y;
  const int f = gridDim.y;
  const int end = cov_offsets[c + 1];
  S acc = S(0.0);
  for (int i = cov_offsets[c]; i < end; ++i) {
    const int t = cov_tiles[i];
    const int j = c - starts[t];
    if (j < 0 || j >= w) __trap();
    acc += part[(static_cast<int64_t>(t) * f + k) * w + j];
  }
  out[static_cast<int64_t>(k) * n_seg + c] = acc;
}

// Shared memory above 48 KB is dynamic and has to be asked for.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Blocks of `kernel` that one SM holds at once with `smem` bytes of window,
// or minus the CUDA error.
template <typename K>
int blocks_per_sm(K kernel, size_t smem) {
  if (int rc = allow_smem(kernel, smem)) return -rc;
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, BLOCK, smem);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

template <typename S>
int relin_win(const S* cam_mean, int n_cam, const S* lmk_mean, const int* gidx,
              const int* starts, int win_w, const S* z, const S* lp, const S* jac,
              const S* r0, const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel,
              int64_t mp, int deg, double beta, double min_linear, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(win_w) * D0 * sizeof(S);
  if (int rc = allow_smem(relin_win_kernel<S>, smem)) return rc;
  relin_win_kernel<S><<<static_cast<unsigned int>(mp / TILE), BLOCK, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, lp, jac, r0, srel, act, olp, ojac,
      or0, osrel, mp, deg, static_cast<S>(beta), static_cast<S>(min_linear));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages_win(const S* cam_tab, int n_cam, const S* lmk_tab, const int* gidx,
                 const int* starts, int win_w, const S* jac, const S* lp, const S* r0,
                 const S* prec, const S* srel, const S* act, const S* me0, const S* ml0,
                 const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp,
                 int deg, double eta_damping, double lam_damping, double num_undamped,
                 double floor, double jitter, int has_huber, double huber, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(win_w) * F_CAM * sizeof(S);
  if (int rc = allow_smem(messages_win_kernel<S>, smem)) return rc;
  messages_win_kernel<S><<<static_cast<unsigned int>(mp / TILE), BLOCK, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      cam_tab, n_cam, lmk_tab, gidx, starts, win_w, jac, lp, r0, prec, srel, act, me0, ml0,
      me1, ml1, oe0, ol0, oe1, ol1, mp, deg,
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int segsum_blk(const S* me, const S* ml, int d, const int* rows, const int* offsets,
               int n_tiles, int w, int64_t mp, S* out, void* stream) {
  if (n_tiles <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const int jb = (w + RED_BLOCK - 1) / RED_BLOCK;
  const dim3 grid(static_cast<unsigned int>(n_tiles) * jb, static_cast<unsigned int>(d + d * d));
  segsum_blk_kernel<S><<<grid, RED_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      me, ml, d, rows, offsets, w, mp, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int scatter_win(const S* part, const int* starts, const int* cov_tiles,
                const int* cov_offsets, int f, int w, int n_seg, S* out, void* stream) {
  if (n_seg <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned int>((n_seg + RED_BLOCK - 1) / RED_BLOCK),
                  static_cast<unsigned int>(f));
  scatter_win_kernel<S><<<grid, RED_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      part, starts, cov_tiles, cov_offsets, w, n_seg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_WINDOW_ENTRIES(SFX, S)                                                     \
  extern "C" int gbp_relin_cm_tabblk_ell_##SFX(                                        \
      const S* cam_mean, int n_cam, const S* lmk_mean, const int* gidx,                \
      const int* starts, int win_w, const S* z, const S* lp, const S* jac,             \
      const S* r0, const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel,     \
      int64_t mp, int deg, double beta, double min_linear, void* stream) {             \
    return gbp::relin_win<S>(cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, lp,    \
                             jac, r0, srel, act, olp, ojac, or0, osrel, mp, deg, beta, \
                             min_linear, stream);                                      \
  }                                                                                    \
  extern "C" int gbp_messages_cm_tabblk_ell_##SFX(                                     \
      const S* cam_tab, int n_cam, const S* lmk_tab, const int* gidx,                  \
      const int* starts, int win_w, const S* jac, const S* lp, const S* r0,            \
      const S* prec, const S* srel, const S* act, const S* me0, const S* ml0,          \
      const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, \
      double eta_damping, double lam_damping, double num_undamped, double floor,       \
      double jitter, int has_huber, double huber, void* stream) {                      \
    return gbp::messages_win<S>(cam_tab, n_cam, lmk_tab, gidx, starts, win_w, jac, lp, \
                                r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0,     \
                                oe1, ol1, mp, deg, eta_damping, lam_damping,           \
                                num_undamped, floor, jitter, has_huber, huber,         \
                                stream);                                               \
  }                                                                                    \
  extern "C" int gbp_segsum_cm_blk_##SFX(const S* me, const S* ml, int d,              \
                                         const int* rows, const int* offsets,          \
                                         int n_tiles, int w, int64_t mp, S* out,       \
                                         void* stream) {                               \
    return gbp::segsum_blk<S>(me, ml, d, rows, offsets, n_tiles, w, mp, out, stream);  \
  }                                                                                    \
  extern "C" int gbp_scatter_windows_cm_##SFX(                                         \
      const S* part, const int* starts, const int* cov_tiles, const int* cov_offsets,  \
      int f, int w, int n_seg, S* out, void* stream) {                                 \
    return gbp::scatter_win<S>(part, starts, cov_tiles, cov_offsets, f, w, n_seg, out, \
                               stream);                                                \
  }                                                                                    \
  extern "C" int gbp_relin_cm_tabblk_ell_blocks_per_sm_##SFX(int win_w) {              \
    return gbp::blocks_per_sm(gbp::relin_win_kernel<S>,                                \
                              static_cast<size_t>(win_w) * gbp::D0 * sizeof(S));       \
  }                                                                                    \
  extern "C" int gbp_messages_cm_tabblk_ell_blocks_per_sm_##SFX(int win_w) {           \
    return gbp::blocks_per_sm(gbp::messages_win_kernel<S>,                             \
                              static_cast<size_t>(win_w) * gbp::F_CAM * sizeof(S));    \
  }

GBP_WINDOW_ENTRIES(f32, float)
GBP_WINDOW_ENTRIES(f64, double)
