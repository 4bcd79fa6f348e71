// The messages kernels of the four table families and their per-shape
// launchers, shared by the sources that dispatch on the shape at run time
// (messages.cu, windows.cu, unfused.cu, unfused_win.cu) and the sources that
// instantiate the 9-dof BAL camera shape (bal9_table_f32.cu,
// bal9_table_f64.cu), so that the heaviest instantiations compile side by
// side.  What each kernel replaces, what bounds it and its design are in
// the header comment of the source that launches it.  The per-row
// arithmetic is messages_rows.cuh.
#pragma once
#include "messages_rows.cuh"

namespace gbp {

constexpr int TILE = 1024;

// The ten state operands and the four outputs of one messages launch.
template <typename S>
struct MsgOps {
  const S *jac, *lp, *r0, *prec, *srel, *act, *me0, *ml0, *me1, *ml1;
  S *oe0, *ol0, *oe1, *ol1;
};

// Stage rows [start, start + n_in) of a row-major [n_cam, f] table.
template <typename S>
__device__ __forceinline__ void stage_window(const S* __restrict__ table, int f, int start,
                                             int n_in, S* __restrict__ tab) {
  const S* src = table + static_cast<int64_t>(start) * f;
  for (int i = threadIdx.x; i < n_in * f; i += blockDim.x) tab[i] = src[i];
  __syncthreads();
}

// Shared memory above 48 KB is dynamic and has to be asked for.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// messages.cu: the whole gathered-slot table in shared memory, the ELL slot
// at r / deg.
template <typename S, class Sh, bool HUBER_ROW>
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
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  for (int i = threadIdx.x; i < n_cam * F_G; i += blockDim.x) tab[i] = cam_tab[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
      tab + gidx[r] * F_G, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0,
      oe1, ol1, mp, deg, r, p);
}

// windows.cu: the tile's window of the gathered-slot table, the ELL slot at
// r / deg.
template <typename S, class Sh, bool HUBER_ROW>
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
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_cam - start);
  stage_window(cam_tab, F_G, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    const int off = gidx[r] - start;
    if (off < 0 || off >= n_in) __trap();
    messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
        tab + off * F_G, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0,
        oe1, ol1, mp, deg, r, p);
  }
}

// The row's messages with the gathered slot's packed belief row `gat` and
// the other slot's belief from the expanded operands be_o, bl_o (the
// unfused kernels, whole table or window).
template <typename S, class Sh, bool HUBER_ROW>
__device__ __forceinline__ void messages_other_row(
    const S* __restrict__ gat, const S* __restrict__ be_o, const S* __restrict__ bl_o,
    const S* __restrict__ jac, const S* __restrict__ lp, const S* __restrict__ r0g,
    const S* __restrict__ prec, const S* __restrict__ srel, const S* __restrict__ act,
    const S* __restrict__ me0, const S* __restrict__ ml0, const S* __restrict__ me1,
    const S* __restrict__ ml1, S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1,
    S* __restrict__ ol1, int64_t mp, int64_t r, const MsgParams<S>& p) {
  constexpr int DA = Sh::DA, DB = Sh::DB, ZD = Sh::ZD;
  if constexpr (Sh::GSLOT == 0) {
    const PackedBelief<S, DA> b0{gat};
    const ExpandedBelief<S, DB, ColMajor> b1{be_o, bl_o, mp, mp, r};
    messages_core<S, DA, DB, ZD, ColMajor, false, HUBER_ROW>(
        b0, b1, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
        UniformLd{mp}, r, p);
  } else {
    const ExpandedBelief<S, DA, ColMajor> b0{be_o, bl_o, mp, mp, r};
    const PackedBelief<S, DB> b1{gat};
    messages_core<S, DA, DB, ZD, ColMajor, false, HUBER_ROW>(
        b0, b1, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
        UniformLd{mp}, r, p);
  }
}

// unfused.cu: the whole gathered-slot table, the other slot expanded.
template <typename S, class Sh, bool HUBER_ROW>
__global__ void __launch_bounds__(BLOCK)
messages_tab_kernel(const S* __restrict__ btab, int n_g, const int* __restrict__ gidx,
                    const S* __restrict__ be_o, const S* __restrict__ bl_o,
                    const S* __restrict__ jac, const S* __restrict__ lp,
                    const S* __restrict__ r0g, const S* __restrict__ prec,
                    const S* __restrict__ srel, const S* __restrict__ act,
                    const S* __restrict__ me0, const S* __restrict__ ml0,
                    const S* __restrict__ me1, const S* __restrict__ ml1,
                    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1,
                    S* __restrict__ ol1, int64_t mp, MsgParams<S> p) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  for (int i = threadIdx.x; i < n_g * F_G; i += blockDim.x) tab[i] = btab[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  messages_other_row<S, Sh, HUBER_ROW>(tab + gidx[r] * F_G, be_o, bl_o, jac, lp, r0g, prec,
                                       srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, r,
                                       p);
}

// unfused_win.cu: the tile's window of the gathered-slot table, the other
// slot expanded.
template <typename S, class Sh, bool HUBER_ROW>
__global__ void __launch_bounds__(BLOCK)
messages_tabblk_kernel(const S* __restrict__ btab, int n_g, const int* __restrict__ gidx,
                       const int* __restrict__ starts, int win_w,
                       const S* __restrict__ be_o, const S* __restrict__ bl_o,
                       const S* __restrict__ jac, const S* __restrict__ lp,
                       const S* __restrict__ r0g, const S* __restrict__ prec,
                       const S* __restrict__ srel, const S* __restrict__ act,
                       const S* __restrict__ me0, const S* __restrict__ ml0,
                       const S* __restrict__ me1, const S* __restrict__ ml1,
                       S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1,
                       S* __restrict__ ol1, int64_t mp, MsgParams<S> p) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_g - start);
  stage_window(btab, F_G, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    const int off = gidx[r] - start;
    if (off < 0 || off >= n_in) __trap();
    messages_other_row<S, Sh, HUBER_ROW>(tab + off * F_G, be_o, bl_o, jac, lp, r0g, prec, srel,
                                         act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, r, p);
  }
}

// The per-shape launchers: each returns 0 or the CUDA error of asking for
// dynamic shared memory; the caller reads cudaGetLastError() after.
template <typename S, class Sh>
int launch_messages_tab_ell(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                            const int* gidx, const MsgOps<S>& o, int64_t mp, int deg,
                            const MsgParams<S>& p, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(n_cam) * Sh::F_G * sizeof(S);
  if (huber_row) {
    messages_kernel<S, Sh, true><<<n_blocks(mp), BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, o.jac, o.lp, o.r0, o.prec, o.srel, o.act, o.me0, o.ml0,
        o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p);
  } else {
    messages_kernel<S, Sh, false><<<n_blocks(mp), BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, o.jac, o.lp, o.r0, o.prec, o.srel, o.act, o.me0, o.ml0,
        o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p);
  }
  return 0;
}

template <typename S, class Sh>
int launch_messages_win(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                        const int* gidx, const int* starts, int win_w, const MsgOps<S>& o,
                        int64_t mp, int deg, const MsgParams<S>& p, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(win_w) * Sh::F_G * sizeof(S);
  const unsigned int grid = static_cast<unsigned int>(mp / TILE);
  int rc = 0;
  if (huber_row) {
    if ((rc = allow_smem(messages_win_kernel<S, Sh, true>, smem))) return rc;
    messages_win_kernel<S, Sh, true><<<grid, BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p);
  } else {
    if ((rc = allow_smem(messages_win_kernel<S, Sh, false>, smem))) return rc;
    messages_win_kernel<S, Sh, false><<<grid, BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p);
  }
  return 0;
}

template <typename S, class Sh>
int launch_messages_tab(bool huber_row, const S* btab, int n_g, const int* gidx, const S* be_o,
                        const S* bl_o, const MsgOps<S>& o, int64_t mp, const MsgParams<S>& p,
                        cudaStream_t st) {
  const size_t smem = static_cast<size_t>(n_g) * Sh::F_G * sizeof(S);
  if (huber_row) {
    messages_tab_kernel<S, Sh, true><<<n_blocks(mp), BLOCK, smem, st>>>(
        btab, n_g, gidx, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act, o.me0, o.ml0,
        o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p);
  } else {
    messages_tab_kernel<S, Sh, false><<<n_blocks(mp), BLOCK, smem, st>>>(
        btab, n_g, gidx, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act, o.me0, o.ml0,
        o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p);
  }
  return 0;
}

template <typename S, class Sh>
int launch_messages_tabblk(bool huber_row, const S* btab, int n_g, const int* gidx,
                           const int* starts, int win_w, const S* be_o, const S* bl_o,
                           const MsgOps<S>& o, int64_t mp, const MsgParams<S>& p,
                           cudaStream_t st) {
  const size_t smem = static_cast<size_t>(win_w) * Sh::F_G * sizeof(S);
  const unsigned int grid = static_cast<unsigned int>(mp / TILE);
  int rc = 0;
  if (huber_row) {
    if ((rc = allow_smem(messages_tabblk_kernel<S, Sh, true>, smem))) return rc;
    messages_tabblk_kernel<S, Sh, true><<<grid, BLOCK, smem, st>>>(
        btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p);
  } else {
    if ((rc = allow_smem(messages_tabblk_kernel<S, Sh, false>, smem))) return rc;
    messages_tabblk_kernel<S, Sh, false><<<grid, BLOCK, smem, st>>>(
        btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p);
  }
  return 0;
}

// The 9-dof BAL camera shape's launchers are compiled in bal9_table_*.cu.
using Bal9 = Shape<9, 3, 2, 0>;
#define GBP_BAL9_TABLE_LAUNCHERS(MODE, S)                                                     \
  MODE template int launch_messages_tab_ell<S, Bal9>(bool, const S*, int, const S*,          \
      const int*, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t);         \
  MODE template int launch_messages_win<S, Bal9>(bool, const S*, int, const S*, const int*,  \
      const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t);    \
  MODE template int launch_messages_tab<S, Bal9>(bool, const S*, int, const int*, const S*,  \
      const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&, cudaStream_t);                \
  MODE template int launch_messages_tabblk<S, Bal9>(bool, const S*, int, const int*,         \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t);
GBP_BAL9_TABLE_LAUNCHERS(extern, float)
GBP_BAL9_TABLE_LAUNCHERS(extern, double)

}  // namespace gbp
