// The messages kernels of the four table families and their per-shape
// launchers, and the windowed relinearization kernels, shared by the sources
// that dispatch on the shape at run time (messages.cu, windows.cu,
// unfused.cu, unfused_win.cu, halo_f32.cu, halo_f64.cu) and the sources that
// instantiate the 9-dof BAL camera shape (bal9_table_*.cu, bal9_halo_*.cu),
// so that the heaviest instantiations compile side by side.  The windowed
// kernels take the gathered slot's second source of the halo paths as a
// template parameter (GHOST): ids from n_own on name rows of a ghost table
// in device memory instead of the tile's window (halo_f32.cu).  What each kernel replaces, what bounds it and its design are in
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

// The gathered slot's ghost table of the halo paths: ids from n_own on name
// row id - n_own of `tab` [n, f], row-major in device memory (the
// partition's ghost beliefs, then the duplicated cut-camera rows: O(boundary)
// rows, which stay in L2); ids below n_own lie in the tile's window.
template <typename S>
struct GhostTable {
  const S* __restrict__ tab;
  int n;
  int n_own;
};

// Where a row finds its gathered variable's f values: the tile's staged
// window (rows [start, start + n_in) of the table), or with GHOST the ghost
// table for ids from g.n_own on.  An id outside both is a fault of the
// prepared graph: the kernel traps, it never clamps.
template <typename S, bool GHOST>
__device__ __forceinline__ const S* gathered_row(const S* win, int start, int n_in, int f, int id,
                                                 const GhostTable<S>& g) {
  if constexpr (GHOST) {
    if (id >= g.n_own) {
      const int gi = id - g.n_own;
      if (gi >= g.n) __trap();
      return g.tab + static_cast<int64_t>(gi) * f;
    }
  }
  const int off = id - start;
  if (off < 0 || off >= n_in) __trap();
  return win + off * f;
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
// r / deg; with GHOST (halo_f32.cu) ghost ids read the ghost table.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST = false>
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
                    MsgParams<S> p, GhostTable<S> gh) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_cam - start);
  stage_window(cam_tab, F_G, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
        gathered_row<S, GHOST>(tab, start, n_in, F_G, gidx[r], gh), lmk_tab, jac, lp, r0g, prec,
        srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, deg, r, p);
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
// slot expanded; with GHOST (halo_f32.cu) ghost ids read the ghost table.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST = false>
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
                       S* __restrict__ ol1, int64_t mp, MsgParams<S> p, GhostTable<S> gh) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_g - start);
  stage_window(btab, F_G, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    messages_other_row<S, Sh, HUBER_ROW>(gathered_row<S, GHOST>(tab, start, n_in, F_G, gidx[r],
                                                                 gh), be_o, bl_o, jac, lp, r0g, prec, srel,
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

// With GHOST the kernel also reads the ghost table `gh` (the halo paths).
template <typename S, class Sh, bool GHOST = false>
int launch_messages_win(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                        const int* gidx, const int* starts, int win_w, const MsgOps<S>& o,
                        int64_t mp, int deg, const MsgParams<S>& p, cudaStream_t st,
                        const GhostTable<S>& gh = GhostTable<S>{}) {
  const size_t smem = static_cast<size_t>(win_w) * Sh::F_G * sizeof(S);
  const unsigned int grid = static_cast<unsigned int>(mp / TILE);
  int rc = 0;
  if (huber_row) {
    if ((rc = allow_smem(messages_win_kernel<S, Sh, true, GHOST>, smem))) return rc;
    messages_win_kernel<S, Sh, true, GHOST><<<grid, BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p, gh);
  } else {
    if ((rc = allow_smem(messages_win_kernel<S, Sh, false, GHOST>, smem))) return rc;
    messages_win_kernel<S, Sh, false, GHOST><<<grid, BLOCK, smem, st>>>(
        cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p, gh);
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

template <typename S, class Sh, bool GHOST = false>
int launch_messages_tabblk(bool huber_row, const S* btab, int n_g, const int* gidx,
                           const int* starts, int win_w, const S* be_o, const S* bl_o,
                           const MsgOps<S>& o, int64_t mp, const MsgParams<S>& p,
                           cudaStream_t st, const GhostTable<S>& gh = GhostTable<S>{}) {
  const size_t smem = static_cast<size_t>(win_w) * Sh::F_G * sizeof(S);
  const unsigned int grid = static_cast<unsigned int>(mp / TILE);
  int rc = 0;
  if (huber_row) {
    if ((rc = allow_smem(messages_tabblk_kernel<S, Sh, true, GHOST>, smem))) return rc;
    messages_tabblk_kernel<S, Sh, true, GHOST><<<grid, BLOCK, smem, st>>>(
        btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p, gh);
  } else {
    if ((rc = allow_smem(messages_tabblk_kernel<S, Sh, false, GHOST>, smem))) return rc;
    messages_tabblk_kernel<S, Sh, false, GHOST><<<grid, BLOCK, smem, st>>>(
        btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
        o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p, gh);
  }
  return 0;
}

// windows.cu: masked relinearization with the gathered slot's means from
// the tile's window (with GHOST, ghost ids from the ghost table), the ELL
// slot's at r / deg.
template <typename S, class M, bool GHOST = false>
__global__ void __launch_bounds__(BLOCK)
relin_win_kernel(const S* __restrict__ cam_mean, int n_cam,
                 const S* __restrict__ lmk_mean, const int* __restrict__ gidx,
                 const int* __restrict__ starts, int win_w,
                 const S* __restrict__ z, const S* __restrict__ args, const S* __restrict__ lp,
                 const S* __restrict__ jac, const S* __restrict__ r0,
                 const S* __restrict__ srel, const S* __restrict__ act,
                 S* __restrict__ olp, S* __restrict__ ojac, S* __restrict__ or0,
                 S* __restrict__ osrel, int64_t mp, int deg, int gslot, S beta,
                 S min_linear, GhostTable<S> gh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  // The window may reach past the last camera (starts are cut against the
  // table padded to a multiple of 8); only rows that exist are staged.
  const int n_in = min(win_w, n_cam - start);
  const int dg = gathered_dofs<M>(gslot);
  stage_window(cam_mean, dg, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    relin_row<S, M>(gathered_row<S, GHOST>(tab, start, n_in, dg, gidx[r], gh), lmk_mean, z,
                    args, lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp, deg, gslot, r, beta,
                    min_linear);
  }
}

// unfused_win.cu: the same with the other slot's means from the expanded
// operand x_other [d_o, mp].
template <typename S, class M, bool GHOST = false>
__global__ void __launch_bounds__(BLOCK)
relin_tabblk_kernel(const S* __restrict__ x_other, const S* __restrict__ mtab, int n_g,
                    const int* __restrict__ gidx, const int* __restrict__ starts, int win_w,
                    const S* __restrict__ z, const S* __restrict__ args,
                    const S* __restrict__ lp, const S* __restrict__ jac,
                    const S* __restrict__ r0, const S* __restrict__ srel,
                    const S* __restrict__ act, S* __restrict__ olp, S* __restrict__ ojac,
                    S* __restrict__ or0, S* __restrict__ osrel, int64_t mp, int gslot, S beta,
                    S min_linear, GhostTable<S> gh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_g - start);
  const int dg = gathered_dofs<M>(gslot);
  stage_window(mtab, dg, start, n_in, tab);
#pragma unroll 1
  for (int s = 0; s < TILE / BLOCK; ++s) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * TILE + s * BLOCK + threadIdx.x;
    S x[M::DA + M::DB];
    slot_means<S, M>(gathered_row<S, GHOST>(tab, start, n_in, dg, gidx[r], gh), x_other + r, mp,
                     gslot, x);
    relin_core<S, M, ColMajor>(x, z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel,
                               UniformLd{mp}, r, beta, min_linear);
  }
}

// The launches of the windowed relinearization kernels (model id, table
// rows, ghost table); each returns 0, the CUDA error of asking for dynamic
// shared memory, or -2 for an unknown model.
template <typename S, bool GHOST>
int launch_relin_win(int model, int gslot, const S* cam_mean, int n_cam, const S* lmk_mean,
                     const int* gidx, const int* starts, int win_w, const S* z, const S* args,
                     const S* lp, const S* jac, const S* r0, const S* srel, const S* act, S* olp,
                     S* ojac, S* or0, S* osrel, int64_t mp, int deg, double beta,
                     double min_linear, cudaStream_t st, const GhostTable<S>& gh) {
  int rc = 0;
  const bool known = with_model(model, [&](auto m) {
    using M = decltype(m);
    const size_t smem = static_cast<size_t>(win_w) * gathered_dofs<M>(gslot) * sizeof(S);
    if ((rc = allow_smem(relin_win_kernel<S, M, GHOST>, smem))) return;
    relin_win_kernel<S, M, GHOST><<<static_cast<unsigned int>(mp / TILE), BLOCK, smem, st>>>(
        cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, args, lp, jac, r0, srel, act, olp,
        ojac, or0, osrel, mp, deg, gslot, static_cast<S>(beta), static_cast<S>(min_linear), gh);
  });
  return known ? rc : -2;
}

template <typename S, bool GHOST>
int launch_relin_tabblk(int model, int gslot, const S* x_other, const S* mtab, int n_g,
                        const int* gidx, const int* starts, int win_w, const S* z, const S* args,
                        const S* lp, const S* jac, const S* r0, const S* srel, const S* act,
                        S* olp, S* ojac, S* or0, S* osrel, int64_t mp, double beta,
                        double min_linear, cudaStream_t st, const GhostTable<S>& gh) {
  int rc = 0;
  const bool known = with_model(model, [&](auto m) {
    using M = decltype(m);
    const size_t smem = static_cast<size_t>(win_w) * gathered_dofs<M>(gslot) * sizeof(S);
    if ((rc = allow_smem(relin_tabblk_kernel<S, M, GHOST>, smem))) return;
    relin_tabblk_kernel<S, M, GHOST><<<static_cast<unsigned int>(mp / TILE), BLOCK, smem, st>>>(
        x_other, mtab, n_g, gidx, starts, win_w, z, args, lp, jac, r0, srel, act, olp, ojac, or0,
        osrel, mp, gslot, static_cast<S>(beta), static_cast<S>(min_linear), gh);
  });
  return known ? rc : -2;
}

// The 9-dof BAL camera shape's launchers are compiled in bal9_table_*.cu.
using Bal9 = Shape<9, 3, 2, 0>;
#define GBP_BAL9_TABLE_LAUNCHERS(MODE, S)                                                     \
  MODE template int launch_messages_tab_ell<S, Bal9>(bool, const S*, int, const S*,          \
      const int*, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t);         \
  MODE template int launch_messages_win<S, Bal9>(bool, const S*, int, const S*, const int*,  \
      const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t,     \
      const GhostTable<S>&);                                                                  \
  MODE template int launch_messages_tab<S, Bal9>(bool, const S*, int, const int*, const S*,  \
      const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&, cudaStream_t);                \
  MODE template int launch_messages_tabblk<S, Bal9>(bool, const S*, int, const int*,         \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&);
GBP_BAL9_TABLE_LAUNCHERS(extern, float)
GBP_BAL9_TABLE_LAUNCHERS(extern, double)
// ... and the halo paths' (GHOST) ones in bal9_halo_*.cu.
#define GBP_BAL9_HALO_LAUNCHERS(MODE, S)                                                      \
  MODE template int launch_messages_win<S, Bal9, true>(bool, const S*, int, const S*,        \
      const int*, const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&,       \
      cudaStream_t, const GhostTable<S>&);                                                    \
  MODE template int launch_messages_tabblk<S, Bal9, true>(bool, const S*, int, const int*,   \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&);
GBP_BAL9_HALO_LAUNCHERS(extern, float)
GBP_BAL9_HALO_LAUNCHERS(extern, double)

}  // namespace gbp
