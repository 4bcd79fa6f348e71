// The messages kernels of the four table families and their per-shape
// launchers, and the windowed relinearization kernels, shared by the sources
// that dispatch on the shape at run time (messages.cu, windows.cu,
// unfused.cu, unfused_win.cu, halo_f32.cu, halo_f64.cu) and the sources that
// instantiate the 9-dof BAL camera shape (bal9_table_*.cu, bal9_halo_*.cu)
// and the camera shapes with the landmarks gathered (lmk_table_*.cu,
// lmk_halo_*.cu), so that the heaviest instantiations compile side by side.  The windowed
// kernels take the gathered slot's second source of the halo paths as a
// template parameter (GHOST): ids from n_own on name rows of a ghost table
// in device memory instead of the tile's window (halo_f32.cu).  What each
// kernel replaces, what bounds it and its design are in the header comment
// of the source that launches it.  The per-row
// arithmetic is messages_rows.cuh.
#pragma once
#include <stdint.h>

#include "async_copy.cuh"
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

// --- the windowed messages kernels (windows.cu, unfused_win.cu, halo.cuh) ---------------
//
// Persistent blocks over units of WIN_UNIT rows (one row per thread).  The
// launch holds every block the SMs keep resident at once (the occupancy
// API, for the instantiation and its shared memory) and gives each block a
// contiguous range of q or q + 1 units, q the quotient of the units over the
// blocks: balanced to within one unit, so no last wave runs part full.  The
// tile (TILE rows) stays the window's unit: a block walks its units in order
// and, where its range enters a tile, brings in that tile's window, rows
// [starts[t], starts[t] + n_in) of the row-major table, one contiguous span:
// by one 1-D bulk copy (the Tensor Memory Accelerator, on an mbarrier) for
// its 16-byte-aligned middle and cp.async of one element for the at most 16
// bytes at either end, into a buffer at the same address mod 16; while one
// block waits for its window the others on the SM compute.  The per-row
// arithmetic is the full-table kernels' (messages_row, messages_other_row)
// on the operands where they lie, pointers restrict-qualified as there, so
// the outputs are their bits and do not depend on the order in which blocks
// run.  What bounds the kernel is the latency of each row's dependent
// arithmetic at the few warps its registers leave an SM: 128-thread blocks,
// three to an SM within 170 registers (12 warps), replace one 256-thread
// block of 173-223 registers (8 warps) in float32 up to 9 slot dofs; the
// heavier instantiations keep their per-tile kernels (win_persistent).  The
// operands staged through a ring of shared-memory stages, a second window
// buffer, the ghost table staged, 256-row units and four blocks per SM were
// timed and not kept (PERF.md, PR 9).

// Rows per unit, and threads per block: one row per thread.
constexpr int WIN_UNIT = 128;
static_assert(TILE % WIN_UNIT == 0 && WIN_UNIT % 32 == 0, "a tile is whole units of warps");
// Shared memory one block may ask for on sm_90: the window buffer, an mbarrier.
constexpr size_t SMEM_BLOCK_MAX = 232448;
constexpr int WIN_BAR_BYTES = 16;
// The float32 kernels of at most 9 slot dofs, whose per-row body fits 170
// registers without spilling, run as persistent blocks of WIN_UNIT threads,
// three to an SM (65536 / (3 x WIN_UNIT) registers, 12 warps).  The others
// (float64, the 12-dof shapes: 255 registers and spills, one 256-thread
// block per SM either way) keep the kernels they had, a block of BLOCK
// threads per tile staging its window itself (messages_win_tile_kernel,
// messages_tabblk_tile_kernel): with the persistent loop, the bulk copy or
// a minimum of blocks per SM ptxas spilled 4-200 bytes more of them.
constexpr int WIN_MIN_BLOCKS = 3;
template <typename S, class Sh>
constexpr bool win_persistent() {
  return sizeof(S) == 4 && Sh::DA + Sh::DB <= 9;
}

// Where a span of a table that starts at `src` lies in its buffer: at the
// same address mod 16.
template <typename S>
__device__ __forceinline__ S* span_at(unsigned char* buf, const S* src) {
  return reinterpret_cast<S*>(buf + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Issue the copy of the n values at `src` into `buf` (span_at): thread 0
// the bulk copy of the 16-byte-aligned middle, completing on `bar`
// (expecting its bytes, possibly none); threads 1-6 the elements at either
// end by cp.async, committed (each waits for them before its next barrier).
template <typename S>
__device__ __forceinline__ void issue_span(unsigned char* buf, const S* src, int n,
                                           unsigned long long* bar) {
  constexpr int V = 16 / sizeof(S);
  S* dst = span_at(buf, src);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) / sizeof(S);
  const int head = min(mis ? V - mis : 0, n);
  const int body = (n - head) / V * V;
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_arrive_expect_tx(bar, static_cast<unsigned>(body * sizeof(S)));
    if (body > 0) bulk_load(dst + head, src + head, static_cast<unsigned>(body * sizeof(S)), bar);
  } else if (t <= 2 * (V - 1)) {
    const int e = t - 1;
    const int i = e < head ? e : head + body + (e - head);
    if (i < n) cp_async_elem(dst + i, src + i);
    cp_async_commit();
  }
}

// The rows of one persistent windowed messages launch (kernels 8, 10, 12,
// 17), q or q + 1 units of WIN_UNIT rows per block: the gathered slot's
// belief from the tile's window of `tab` (with GHOST, ids
// from n_own on from the ghost table), the other slot's at r / deg of
// ell_tab or, with OTHER, from the expanded operands be_o, bl_o.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST, bool OTHER>
__device__ __forceinline__ void window_messages(
    const S* __restrict__ tab, int n_tab, const int* __restrict__ gidx,
    const int* __restrict__ starts, int win_w, const S* __restrict__ ell_tab, int deg,
    const S* __restrict__ be_o, const S* __restrict__ bl_o, const S* __restrict__ jac,
    const S* __restrict__ lp, const S* __restrict__ r0g, const S* __restrict__ prec,
    const S* __restrict__ srel, const S* __restrict__ act, const S* __restrict__ me0,
    const S* __restrict__ ml0, const S* __restrict__ me1, const S* __restrict__ ml1,
    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1,
    int64_t mp, int q, int rem, const MsgParams<S>& p, const GhostTable<S>& gh) {
  constexpr int F = Sh::F_G, UPT = TILE / WIN_UNIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned char* buf = smem_raw + WIN_BAR_BYTES;
  // Tile `tile`'s window into the buffer, once every thread is done with the
  // last one; the mbarrier starts a fresh phase for each window.
  auto load_window = [&](int tile) {
    __syncthreads();
    if (threadIdx.x == 0) mbar_init(bar, 1);
    const int start = starts[tile];
    issue_span(buf, tab + static_cast<int64_t>(start) * F, max(min(win_w, n_tab - start), 0) * F,
               bar);
    cp_async_wait<0>();
    __syncthreads();  // the window's end elements
    mbar_wait(bar, 0);
  };
  // Block b's units: [b q + min(b, rem), + q + (b < rem)), q and rem the
  // quotient and remainder of the units over the blocks.
  const int b = blockIdx.x;
  int u = b * q + min(b, rem);
  const int u1 = u + q + (b < rem ? 1 : 0);
  load_window(u / UPT);
#pragma unroll 1
  for (; u < u1; ++u) {
    const int64_t r = static_cast<int64_t>(u) * WIN_UNIT + threadIdx.x;
    const int start = starts[u / UPT];
    const S* gat = gathered_row<S, GHOST>(span_at(buf, tab + static_cast<int64_t>(start) * F),
                                          start, min(win_w, n_tab - start), F, gidx[r], gh);
    if constexpr (OTHER) {
      messages_other_row<S, Sh, HUBER_ROW>(gat, be_o, bl_o, jac, lp, r0g, prec, srel, act, me0,
                                           ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, r, p);
    } else {
      messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
          gat, ell_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
          mp, deg, r, p);
    }
    if ((u + 1) % UPT == 0 && u + 1 < u1) load_window((u + 1) / UPT);  // the next tile
  }
}

// windows.cu: the tile's window of the gathered-slot table, the ELL slot at
// r / deg; with GHOST (halo_f32.cu) ghost ids read the ghost table.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST>
__global__ void __launch_bounds__(WIN_UNIT, WIN_MIN_BLOCKS)
messages_win_kernel(const S* __restrict__ cam_tab, int n_cam,
                    const S* __restrict__ lmk_tab, const int* __restrict__ gidx,
                    const int* __restrict__ starts, int win_w,
                    const S* __restrict__ jac, const S* __restrict__ lp,
                    const S* __restrict__ r0g, const S* __restrict__ prec,
                    const S* __restrict__ srel, const S* __restrict__ act,
                    const S* __restrict__ me0, const S* __restrict__ ml0,
                    const S* __restrict__ me1, const S* __restrict__ ml1,
                    S* __restrict__ oe0, S* __restrict__ ol0,
                    S* __restrict__ oe1, S* __restrict__ ol1, int64_t mp, int deg, int q, int rem,
                    MsgParams<S> p, GhostTable<S> gh) {
  window_messages<S, Sh, HUBER_ROW, GHOST, false>(
      cam_tab, n_cam, gidx, starts, win_w, lmk_tab, deg, nullptr, nullptr, jac, lp, r0g, prec,
      srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, p, gh);
}

// unfused_win.cu: the tile's window of the gathered-slot table, the other
// slot expanded; with GHOST (halo_f32.cu) ghost ids read the ghost table.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST>
__global__ void __launch_bounds__(WIN_UNIT, WIN_MIN_BLOCKS)
messages_tabblk_kernel(const S* __restrict__ btab, int n_g, const int* __restrict__ gidx,
                       const int* __restrict__ starts, int win_w,
                       const S* __restrict__ be_o, const S* __restrict__ bl_o,
                       const S* __restrict__ jac, const S* __restrict__ lp,
                       const S* __restrict__ r0g, const S* __restrict__ prec,
                       const S* __restrict__ srel, const S* __restrict__ act,
                       const S* __restrict__ me0, const S* __restrict__ ml0,
                       const S* __restrict__ me1, const S* __restrict__ ml1,
                       S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1,
                       S* __restrict__ ol1, int64_t mp, int q, int rem, MsgParams<S> p,
                       GhostTable<S> gh) {
  window_messages<S, Sh, HUBER_ROW, GHOST, true>(
      btab, n_g, gidx, starts, win_w, nullptr, 1, be_o, bl_o, jac, lp, r0g, prec, srel, act, me0,
      ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, p, gh);
}

// The same, as before the persistent form (float64 and the 12-dof shapes):
// one block per tile stages the tile's window and walks its rows in passes
// of BLOCK.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST>
__global__ void __launch_bounds__(BLOCK)
messages_win_tile_kernel(const S* __restrict__ cam_tab, int n_cam,
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

template <typename S, class Sh, bool HUBER_ROW, bool GHOST>
__global__ void __launch_bounds__(BLOCK)
messages_tabblk_tile_kernel(const S* __restrict__ btab, int n_g, const int* __restrict__ gidx,
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

inline int n_sms() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// The launch of a windowed messages kernel: persistent, shared memory for
// the mbarrier and one window and as many blocks as the SMs hold at once
// (the occupancy API), at most one per unit; else one block per tile and
// its window.  Returns 0 or the CUDA error (a window beyond one block's
// shared memory: cudaErrorInvalidValue).
struct WinLaunch {
  int units, unit_rows, threads, blocks, smem, blocks_per_sm;
  int q() const { return units / blocks; }
  int rem() const { return units % blocks; }
};
template <typename S, bool PERSISTENT, typename K>
int win_launch(K kernel, int win_w, int f, int64_t mp, WinLaunch& l) {
  const size_t window = static_cast<size_t>(win_w) * f * sizeof(S);
  const size_t smem = PERSISTENT ? WIN_BAR_BYTES + (window + 15) / 16 * 16 + 16 : window;
  if (smem > SMEM_BLOCK_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = allow_smem(kernel, smem)) return rc;
  const int threads = PERSISTENT ? WIN_UNIT : BLOCK;
  int bps = 0;
  if (cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, threads, smem))
    return static_cast<int>(rc);
  if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = PERSISTENT ? WIN_UNIT : TILE;
  const int units = static_cast<int>(mp / rows);
  l = WinLaunch{units, rows, threads, PERSISTENT ? min(units, bps * n_sms()) : units,
                static_cast<int>(smem), bps};
  return 0;
}

// The plan of a launch for `info` (units, rows per unit, blocks, shared
// bytes, registers and local bytes per thread, blocks per SM).
template <typename K>
int win_info(K kernel, const WinLaunch& l, int* info) {
  cudaFuncAttributes fa{};
  if (cudaError_t rc = cudaFuncGetAttributes(&fa, kernel)) return static_cast<int>(rc);
  const int v[7] = {l.units, l.unit_rows, l.blocks, l.smem, fa.numRegs,
                    static_cast<int>(fa.localSizeBytes), l.blocks_per_sm};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

// With GHOST the kernel also reads the ghost table `gh` (the halo paths).
// Given `info`, no launch: the plan (win_info).
template <typename S, class Sh, bool GHOST = false>
int launch_messages_win(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                        const int* gidx, const int* starts, int win_w, const MsgOps<S>& o,
                        int64_t mp, int deg, const MsgParams<S>& p, cudaStream_t st,
                        const GhostTable<S>& gh = GhostTable<S>{}, int* info = nullptr) {
  constexpr bool PERSISTENT = win_persistent<S, Sh>();
  auto go = [&](auto k) {
    WinLaunch l;
    if (int rc = win_launch<S, PERSISTENT>(k, win_w, Sh::F_G, mp, l)) return rc;
    if (info) return win_info(k, l, info);
    if constexpr (PERSISTENT) {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, l.q(),
          l.rem(), p, gh);
    } else {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p, gh);
    }
    return 0;
  };
  if constexpr (PERSISTENT) {
    return huber_row ? go(messages_win_kernel<S, Sh, true, GHOST>)
                     : go(messages_win_kernel<S, Sh, false, GHOST>);
  } else {
    return huber_row ? go(messages_win_tile_kernel<S, Sh, true, GHOST>)
                     : go(messages_win_tile_kernel<S, Sh, false, GHOST>);
  }
}

template <typename S, class Sh, bool GHOST = false>
int launch_messages_tabblk(bool huber_row, const S* btab, int n_g, const int* gidx,
                           const int* starts, int win_w, const S* be_o, const S* bl_o,
                           const MsgOps<S>& o, int64_t mp, const MsgParams<S>& p,
                           cudaStream_t st, const GhostTable<S>& gh = GhostTable<S>{},
                           int* info = nullptr) {
  constexpr bool PERSISTENT = win_persistent<S, Sh>();
  auto go = [&](auto k) {
    WinLaunch l;
    if (int rc = win_launch<S, PERSISTENT>(k, win_w, Sh::F_G, mp, l)) return rc;
    if (info) return win_info(k, l, info);
    if constexpr (PERSISTENT) {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
          o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, l.q(), l.rem(), p, gh);
    } else {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          btab, n_g, gidx, starts, win_w, be_o, bl_o, o.jac, o.lp, o.r0, o.prec, o.srel, o.act,
          o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, p, gh);
    }
    return 0;
  };
  if constexpr (PERSISTENT) {
    return huber_row ? go(messages_tabblk_kernel<S, Sh, true, GHOST>)
                     : go(messages_tabblk_kernel<S, Sh, false, GHOST>);
  } else {
    return huber_row ? go(messages_tabblk_tile_kernel<S, Sh, true, GHOST>)
                     : go(messages_tabblk_tile_kernel<S, Sh, false, GHOST>);
  }
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

// Shapes whose messages launchers are compiled in sources of their own, so
// that their compilers run beside the others': the 9-dof BAL camera
// (bal9_table_*.cu, bal9_halo_*.cu), and both camera shapes with the
// landmarks gathered, the cameras in the ELL slot (lmk_table_*.cu,
// lmk_halo_*.cu).  Every other source declares them extern.
using Bal9 = Shape<9, 3, 2, 0>;
using Lmk6 = Shape<6, 3, 2, 1>;
using Lmk9 = Shape<9, 3, 2, 1>;
#define GBP_TABLE_LAUNCHERS(MODE, S, SH)                                                      \
  MODE template int launch_messages_tab_ell<S, SH>(bool, const S*, int, const S*,            \
      const int*, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t);         \
  MODE template int launch_messages_win<S, SH>(bool, const S*, int, const S*, const int*,    \
      const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t,     \
      const GhostTable<S>&, int*);                                                            \
  MODE template int launch_messages_tab<S, SH>(bool, const S*, int, const int*, const S*,    \
      const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&, cudaStream_t);                \
  MODE template int launch_messages_tabblk<S, SH>(bool, const S*, int, const int*,           \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&, int*);
// ... and the halo paths' (GHOST) ones.
#define GBP_HALO_LAUNCHERS(MODE, S, SH)                                                       \
  MODE template int launch_messages_win<S, SH, true>(bool, const S*, int, const S*,          \
      const int*, const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&,       \
      cudaStream_t, const GhostTable<S>&, int*);                                              \
  MODE template int launch_messages_tabblk<S, SH, true>(bool, const S*, int, const int*,     \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&, int*);
#define GBP_OWN_SOURCE_SHAPES(MODE, S)                                                        \
  GBP_TABLE_LAUNCHERS(MODE, S, Bal9)                                                          \
  GBP_TABLE_LAUNCHERS(MODE, S, Lmk6)                                                          \
  GBP_TABLE_LAUNCHERS(MODE, S, Lmk9)                                                          \
  GBP_HALO_LAUNCHERS(MODE, S, Bal9)                                                           \
  GBP_HALO_LAUNCHERS(MODE, S, Lmk6)                                                           \
  GBP_HALO_LAUNCHERS(MODE, S, Lmk9)
GBP_OWN_SOURCE_SHAPES(extern, float)
GBP_OWN_SOURCE_SHAPES(extern, double)

}  // namespace gbp
