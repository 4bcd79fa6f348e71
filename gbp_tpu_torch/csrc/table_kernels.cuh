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

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The window's bytes as the windowed kernels place it (persistent: an
// mbarrier, then a buffer with 16 bytes of slack for the span's offset).
template <typename S, bool PERSISTENT>
__host__ __device__ size_t win_bytes(int win_w, int f) {
  const size_t window = static_cast<size_t>(win_w) * f * sizeof(S);
  return PERSISTENT ? WIN_BAR_BYTES + align16(window) + 16 : window;
}

// --- the gathered-slot sum folded into the messages launches (kernels 2, 10) ---------
//
// The messages launches of messages.cu and windows.cu also return the sum of
// their own new gathered-slot messages (eta | lam, F = d_g + d_g * d_g
// components) over the rows the caller lists, as the TPU kernels' fifth
// output does: per gathered id (kernel 2) or per tile and window column
// (kernel 10).  A thread runs one row, a warp 32 consecutive rows, a block
// units of NT rows.  Once a unit's messages are written, each thread
// re-reads its row's F new components (from L2, where its own stores just
// went: no second pass over device memory) and names its row's slot (kernel
// 2: the row's segment; kernel 10: the rank of its window column among the
// tile's non-empty ones; -1 where the row is not listed).  The lanes of a
// warp that name one slot (__match_any_sync) add their values by shuffles in
// a fixed tree over their lane order (warp_tree_sum), and the group's first
// lane adds the result onto the warp's own running sum of the slot: a slab
// per warp, [slots][F] at an odd stride in shared memory, the slots past the
// shared memory the launch leaves in device memory (per block and warp, read
// and written by that warp alone).  So a unit costs no barrier, no atomic
// and no bookkeeping: no warp touches another's sums.  At the end of the
// block's range (kernel 2) or of a tile (kernel 10) one barrier, then each
// output is the warps' sums added from zero in warp order.  Every sum is
// fixed by the launch plan alone: no floating-point atomics, and two runs
// give the same bits; a row that is not listed (padding, ELL clones, a
// degree class's inactive rows) is never added, whatever its message.
// ops.messages.fold_table_sum and fold_window_sum model the order.

constexpr int WARP = 32;
// One SM's shared memory on sm_90 (228 KB) and what the system keeps of it
// for each resident block.
constexpr size_t SMEM_SM_BYTES = 233472;
constexpr size_t SMEM_BLOCK_RESERVED = 1024;

template <typename T>
__host__ __device__ constexpr T lesser(T a, T b) {
  return a < b ? a : b;
}

// x through an opaque copy: a loop's unit index the compiler sees as a new
// value each iteration, so that it does not strength-reduce every operand's
// address into a pointer carried across the loop (kernel 2 at (6, 3, 2)
// float32: 76 / 136 bytes spilled at 128 registers with it, 84 / 156
// without; PERF.md).
__device__ __forceinline__ int opaque(int x) {
#if defined(__CUDA_ARCH__)
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
#endif
  return x;
}

// The shared memory each of `blocks` blocks resident on one SM may take.
__host__ __device__ constexpr size_t smem_share(int blocks) {
  return lesser(SMEM_SM_BYTES / blocks - SMEM_BLOCK_RESERVED, SMEM_BLOCK_MAX);
}

// Components re-read and reduced together: at most 45 (float32: all 42 at
// (6, 3, 2)) or 14 (float64) a row.  FP: a slab slot's stride, odd, so that
// lanes on distinct slots hit distinct banks.
template <typename S, int F>
struct FoldGroups {
  static constexpr int KMAX = sizeof(S) == 4 ? 45 : 14;
  static constexpr int GROUPS = (F + KMAX - 1) / KMAX;
  static constexpr int KG = (F + GROUPS - 1) / GROUPS;
  static constexpr int FP = F | 1;
};

// Components k0 .. k0 + KG - 1 (zero past F, and where `on` is false) of
// row r's new gathered-slot messages: eta [DG, mp] | lam [DG * DG, mp], just
// written by this thread, re-read from L2, all loads in flight together.
template <typename S, int F, int DG, int KG>
__device__ __forceinline__ void fold_load(S (&v)[KG], const S* oe, const S* ol, int64_t mp,
                                          int64_t r, int k0, bool on) {
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
    const int k = k0 + kk;
    v[kk] = on && k < F ? __ldcg(k < DG ? oe + k * mp + r : ol + (k - DG) * mp + r) : S(0.0);
  }
}

// v summed over the lanes of the calling warp in `peers` (the caller's group,
// from __match_any_sync) in a fixed tree over their lane order: at step d =
// 1, 2, 4, ... the member of rank i, i a multiple of 2d, adds the partial of
// the member of rank i + d (found by pointer jumping).  The group's first lane
// ends with the sum.  n_max: the warp's largest group (ceil(log2 n_max)
// steps: none where every group is one lane).  Every lane calls.
template <typename S, int K>
__device__ __forceinline__ void warp_tree_sum(S (&v)[K], unsigned peers, int n_max) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & (WARP - 1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const unsigned above = lane == WARP - 1 ? 0u : peers & (full << (lane + 1));
  int next = above ? __ffs(above) - 1 : -1;  // the member d ranks on
#pragma unroll 1
  for (int d = 1; d < n_max; d <<= 1) {
    const bool take = next >= 0 && (rank & (2 * d - 1)) == 0;
    const int src = next >= 0 ? next : lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const S o = __shfl_sync(full, v[k], src);
      if (take) v[k] += o;
    }
    const int far = __shfl_sync(full, next, src);
    next = next >= 0 ? far : -1;  // the member 2d ranks on
  }
}

// A warp's running sums: slot s below n_sh at sh[s * FP + k] in shared
// memory, the others at gl[(s - n_sh) * F + k] in device memory.
template <typename S, int F>
struct WarpSlab {
  S* sh;
  S* gl;
  int n_sh;
  template <int KG>
  __device__ __forceinline__ void add(int s, int k0, const S (&v)[KG]) const {
    if (s < n_sh) {
      S* c = sh + s * FoldGroups<S, F>::FP + k0;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
        if (k0 + kk < F) c[kk] += v[kk];
    } else {
      S* c = gl + static_cast<int64_t>(s - n_sh) * F + k0;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
        if (k0 + kk < F) __stcg(c + kk, __ldcg(c + kk) + v[kk]);
    }
  }
  __device__ __forceinline__ S get(int s, int k) const {
    return s < n_sh ? sh[s * FoldGroups<S, F>::FP + k]
                    : __ldcg(gl + static_cast<int64_t>(s - n_sh) * F + k);
  }
  // Slots [0, n) to zero, by the 32 lanes of the warp (`lane`).
  __device__ __forceinline__ void zero(int n, int lane) const {
    for (int i = lane; i < lesser(n, n_sh) * FoldGroups<S, F>::FP; i += WARP) sh[i] = S(0.0);
    for (int64_t i = lane; i < static_cast<int64_t>(n - n_sh) * F; i += WARP) __stcg(gl + i, S(0.0));
  }
};

// Add the calling warp's listed rows of a unit onto its slab: `key` the
// calling thread's slot (-1: its row is not listed), r its row.  Every lane
// calls.
template <typename S, int F, int DG>
__device__ __forceinline__ void fold_warp(const WarpSlab<S, F>& slab, const S* oe, const S* ol,
                                          int64_t mp, int64_t r, int key) {
  using G = FoldGroups<S, F>;
  const unsigned full = 0xffffffffu;
  const unsigned peers = __match_any_sync(full, key);
  const int n_max = __reduce_max_sync(full, key >= 0 ? __popc(peers) : 0);
  if (n_max == 0) return;  // no listed row in the warp
  const int lane = threadIdx.x & (WARP - 1);
  const bool lead = key >= 0 && (peers & ((1u << lane) - 1u)) == 0;
  __syncwarp();  // the other lanes' additions of the warp's last unit are seen
#pragma unroll 1
  for (int k0 = 0; k0 < F; k0 += G::KG) {
    S v[G::KG];
    fold_load<S, F, DG, G::KG>(v, oe, ol, mp, r, k0, key >= 0);
    warp_tree_sum(v, peers, n_max);
    if (lead) slab.add(key, k0, v);
  }
}

// No fold: the windowed messages kernels of the unfused and halo paths.
struct NoFold {
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void unit(int64_t, int) {}
  __device__ __forceinline__ void end() {}
};

// The windowed fold's operands (windows.cu): the CSR of `window_rows_csr`
// (segment t * w + j lists the rows of tile t whose gathered id is
// starts[t] + j, ascending), the output part [n_tiles, F, w], the warps'
// slots past shared memory [blocks, warps, w - n_sh, F] and n_sh, the
// slots a warp keeps in shared memory (the launcher's).
template <typename S>
struct WinFoldArgs {
  const int* rows;
  const int* offsets;
  S* part;
  S* slab;
  int n_sh;
};

// The windowed fold, for launches that run every tile in one block (the
// per-tile kernel; the persistent one with whole tiles a block).  A tile's
// slots are its non-empty window columns in column order, so a warp's slab
// holds the few columns a locality-sorted tile touches (3-11 of 128 at
// city).  Where a block enters a tile it ranks the tile's non-empty columns
// from the CSR's offsets, a column a thread, and, unless the CSR lists every
// row of the tile (as `window_rows_csr` does), marks the listed rows in a
// bit mask; at the tile's end it writes the tile's part from its warps'
// sums.  Columns with no listed row are zero.
template <typename S, int F, int DG, int NT>
struct WinFold {
  static constexpr int W = NT / WARP, FP = FoldGroups<S, F>::FP;
  // One slot in every warp's slab.
  static constexpr size_t SLOT_BYTES = sizeof(S) * W * FP;
  WinFoldArgs<S> a;
  const S* oe;
  const S* ol;
  int64_t mp;
  int w;
  unsigned* listed;  // [TILE / 32]: the tile's listed rows
  int* cidx;         // [w]: a column's slot, -1 where it is empty
  int* wcount;       // [W]: the non-empty columns each warp ranks
  S* sh;             // the warps' slabs [W][n_sh][FP]
  int tile;
  bool all_listed;

  // Where the slabs start, for a fold placed from byte `base` on.
  static __host__ __device__ size_t slabs_at(size_t base, int w) {
    return align16(align16(base) + sizeof(unsigned) * (TILE / 32) + sizeof(int) * (w + W));
  }
  __device__ WinFold(const WinFoldArgs<S>& args, const S* oe_g, const S* ol_g, int64_t mp_,
                     int w_, unsigned char* smem, size_t base)
      : a(args), oe(oe_g), ol(ol_g), mp(mp_), w(w_) {
    listed = reinterpret_cast<unsigned*>(smem + align16(base));
    cidx = reinterpret_cast<int*>(listed + TILE / 32);
    wcount = cidx + w;
    sh = reinterpret_cast<S*>(smem + slabs_at(base, w));
  }
  __device__ WarpSlab<S, F> slab(int warp) const {
    return {sh + warp * a.n_sh * FP,
            a.slab + (static_cast<int64_t>(blockIdx.x) * W + warp) * (w - a.n_sh) * F, a.n_sh};
  }

  // Tile t, all of whose rows run in this block.
  __device__ void begin(int t) {
    __syncthreads();  // the last tile's end is done with the slabs and ranks
    tile = t;
    const int64_t row0 = static_cast<int64_t>(t) * TILE;
    const int* off = a.offsets + static_cast<int64_t>(t) * w;
    all_listed = off[w] - off[0] == TILE;
    // Rank the non-empty columns, NT at a time, a column a thread: its
    // warp's ballot, then the counts of the warps before it.
    const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
    int n = 0;
    for (int c0 = 0; c0 < w; c0 += NT) {
      const int c = c0 + threadIdx.x;
      const bool ne = c < w && off[c + 1] > off[c];
      const unsigned m = __ballot_sync(0xffffffffu, ne);
      if (lane == 0) wcount[warp] = __popc(m);
      __syncthreads();
      int s = n + __popc(m & ((1u << lane) - 1u));
      for (int v = 0; v < W; ++v) {
        s += v < warp ? wcount[v] : 0;
        n += wcount[v];
      }
      if (c < w) cidx[c] = ne ? s : -1;
      __syncthreads();  // the counts are read before the next columns'
    }
    if (!all_listed)
      for (int i = threadIdx.x; i < TILE / 32; i += NT) listed[i] = 0u;
    // The warps' running sums of the tile's non-empty columns from zero.
    slab(warp).zero(n, lane);
    if (!all_listed) {
      __syncthreads();  // the mask is clear
      for (int p = off[0] + threadIdx.x; p < off[w]; p += NT) {
        const int64_t r = a.rows[p];
        if (r < row0 || r >= row0 + TILE) __trap();
        const int i = static_cast<int>(r - row0);
        atomicOr(listed + (i >> 5), 1u << (i & 31));
      }
    }
    __syncthreads();
  }
  // The unit from row u0 on; col: the calling thread's window column.
  __device__ void unit(int64_t u0, int col) {
    const int i = static_cast<int>(u0 - static_cast<int64_t>(tile) * TILE) + threadIdx.x;
    const bool on = all_listed || ((listed[i >> 5] >> (i & 31)) & 1u);
    fold_warp<S, F, DG>(slab(threadIdx.x / WARP), oe, ol, mp, u0 + threadIdx.x,
                        on ? cidx[col] : -1);
  }
  // The tile's part: each column's warps' sums added from zero in warp order.
  __device__ void end() {
    S* out = a.part + static_cast<int64_t>(tile) * F * w;
    __syncthreads();  // every warp's sums of the tile
    for (int e = threadIdx.x; e < F * w; e += NT) {
      const int k = e / w, s = cidx[e - k * w];
      S acc = S(0.0);
      if (s >= 0) {
#pragma unroll
        for (int v = 0; v < W; ++v) acc += slab(v).get(s, k);
      }
      out[e] = acc;
    }
  }
};

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
// 17), q or q + 1 grains of `grain` units of WIN_UNIT rows per block (grain
// 1, or a tile's units: whole tiles a block): the gathered slot's belief
// from the tile's window of `tab` (with GHOST, ids from n_own on from the
// ghost table), the other slot's at r / deg of ell_tab or, with OTHER, from
// the expanded operands be_o, bl_o.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST, bool OTHER, class Fold>
__device__ __forceinline__ void window_messages(
    const S* __restrict__ tab, int n_tab, const int* __restrict__ gidx,
    const int* __restrict__ starts, int win_w, const S* __restrict__ ell_tab, int deg,
    const S* __restrict__ be_o, const S* __restrict__ bl_o, const S* __restrict__ jac,
    const S* __restrict__ lp, const S* __restrict__ r0g, const S* __restrict__ prec,
    const S* __restrict__ srel, const S* __restrict__ act, const S* __restrict__ me0,
    const S* __restrict__ ml0, const S* __restrict__ me1, const S* __restrict__ ml1,
    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1,
    int64_t mp, int q, int rem, int grain, const MsgParams<S>& p, const GhostTable<S>& gh,
    Fold& fold) {
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
  // Block b's units: grains [b q + min(b, rem), + q + (b < rem)), q and rem
  // the quotient and remainder of the grains over the blocks.
  const int b = blockIdx.x;
  int u = (b * q + min(b, rem)) * grain;
  const int u1 = u + (q + (b < rem ? 1 : 0)) * grain;
  load_window(u / UPT);
  fold.begin(u / UPT);
#pragma unroll 1
  for (; u < u1; ++u) {
    const int64_t r = static_cast<int64_t>(u) * WIN_UNIT + threadIdx.x;
    const int start = starts[u / UPT];
    const int id = gidx[r];
    const S* gat = gathered_row<S, GHOST>(span_at(buf, tab + static_cast<int64_t>(start) * F),
                                          start, min(win_w, n_tab - start), F, id, gh);
    if constexpr (OTHER) {
      messages_other_row<S, Sh, HUBER_ROW>(gat, be_o, bl_o, jac, lp, r0g, prec, srel, act, me0,
                                           ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, r, p);
    } else {
      messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
          gat, ell_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,
          mp, deg, r, p);
    }
    fold.unit(static_cast<int64_t>(u) * WIN_UNIT, id - start);
    if ((u + 1) % UPT == 0 || u + 1 == u1) fold.end();
    if ((u + 1) % UPT == 0 && u + 1 < u1) {  // the next tile
      load_window((u + 1) / UPT);
      fold.begin((u + 1) / UPT);
    }
  }
}

// windows.cu: the tile's window of the gathered-slot table, the ELL slot at
// r / deg; with GHOST (halo_f32.cu) ghost ids read the ghost table; with
// FOLD (whole tiles a block) the gathered-slot sum folded into `fa`.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST, bool FOLD>
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
                    int grain, MsgParams<S> p, GhostTable<S> gh, WinFoldArgs<S> fa) {
  if constexpr (FOLD) {
    // The fold's shared memory follows the window buffer (launch_messages_win).
    extern __shared__ __align__(16) unsigned char smem_raw[];
    WinFold<S, Sh::F_G, Sh::DG, WIN_UNIT> fold(fa, Sh::GSLOT ? oe1 : oe0, Sh::GSLOT ? ol1 : ol0,
                                               mp, win_w, smem_raw,
                                               win_bytes<S, true>(win_w, Sh::F_G));
    window_messages<S, Sh, HUBER_ROW, GHOST, false>(
        cam_tab, n_cam, gidx, starts, win_w, lmk_tab, deg, nullptr, nullptr, jac, lp, r0g, prec,
        srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, grain, p, gh, fold);
  } else {
    NoFold fold;
    window_messages<S, Sh, HUBER_ROW, GHOST, false>(
        cam_tab, n_cam, gidx, starts, win_w, lmk_tab, deg, nullptr, nullptr, jac, lp, r0g, prec,
        srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, grain, p, gh, fold);
  }
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
  NoFold fold;
  window_messages<S, Sh, HUBER_ROW, GHOST, true>(
      btab, n_g, gidx, starts, win_w, nullptr, 1, be_o, bl_o, jac, lp, r0g, prec, srel, act, me0,
      ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, 1, p, gh, fold);
}

// The same, as before the persistent form (float64 and the 12-dof shapes):
// a block stages a tile's window and walks its rows in passes of BLOCK; with
// the fold the blocks the SMs hold at once take tiles b, b + grid, ..., so
// that the warps' slots past shared memory need one area a resident block,
// without one block a tile.
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
                    MsgParams<S> p, GhostTable<S> gh, WinFoldArgs<S> fa) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  auto rows = [&](auto& fold, int t) {
    const int start = starts[t];
    const int n_in = min(win_w, n_cam - start);
    const int64_t row0 = static_cast<int64_t>(t) * TILE;
    stage_window(cam_tab, F_G, start, n_in, tab);
    fold.begin(t);
#pragma unroll 1
    for (int s = 0; s < TILE / BLOCK; ++s) {
      const int64_t r = row0 + s * BLOCK + threadIdx.x;
      const int id = gidx[r];
      messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
          gathered_row<S, GHOST>(tab, start, n_in, F_G, id, gh), lmk_tab, jac, lp, r0g, prec,
          srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, deg, r, p);
      fold.unit(row0 + s * BLOCK, id - start);
    }
    fold.end();
  };
  if constexpr (GHOST) {
    NoFold fold;
    rows(fold, blockIdx.x);
  } else {
    // The fold's shared memory follows the window (launch_messages_win).
    WinFold<S, F_G, Sh::DG, BLOCK> fold(fa, Sh::GSLOT ? oe1 : oe0, Sh::GSLOT ? ol1 : ol0, mp,
                                        win_w, smem_raw, win_bytes<S, false>(win_w, F_G));
    const int n_tiles = static_cast<int>(mp / TILE);
#pragma unroll 1
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) rows(fold, t);
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

// A launch of a messages kernel: units of unit_rows rows, `threads` a block,
// q or q + 1 grains of `grain` units a block, the shared memory and resident
// blocks per SM; with a fold, the slots a warp keeps in shared memory (n_sh)
// and their bytes, every warp's, and whether the launch folds (folded).
struct WinLaunch {
  int units, unit_rows, threads, blocks, smem, blocks_per_sm;
  int grain = 1, n_sh = 0, slab_bytes = 0, folded = 0;
  int q() const { return units / grain / blocks; }
  int rem() const { return units / grain % blocks; }
};

// The launch of a windowed messages kernel with `smem` bytes of shared memory
// a block: persistent, as many blocks as the SMs hold at once (the occupancy
// API), at most one per unit; else one block per tile and its window, or
// with `resident` as many as the SMs hold, each taking every blocks-th tile.
// Returns 0 or the CUDA error (beyond one block's shared memory:
// cudaErrorInvalidValue).
template <bool PERSISTENT, typename K>
int win_launch(K kernel, size_t smem, int64_t mp, WinLaunch& l, bool resident = false) {
  if (smem > SMEM_BLOCK_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = allow_smem(kernel, smem)) return rc;
  const int threads = PERSISTENT ? WIN_UNIT : BLOCK;
  int bps = 0;
  if (cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, threads, smem))
    return static_cast<int>(rc);
  if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = PERSISTENT ? WIN_UNIT : TILE;
  const int units = static_cast<int>(mp / rows);
  l = WinLaunch{units, rows, threads, PERSISTENT || resident ? min(units, bps * n_sms()) : units,
                static_cast<int>(smem), bps};
  return 0;
}

// The plan of a launch for `info` (ops.messages.PLAN_KEYS): units, rows per
// unit, blocks, shared bytes, registers and local bytes per thread, blocks
// per SM, threads, rows of the split's grain, warps, slots a warp keeps in
// shared memory and the bytes of every warp's, whether it folds.
template <typename K>
int win_info(K kernel, const WinLaunch& l, int* info) {
  cudaFuncAttributes fa{};
  if (cudaError_t rc = cudaFuncGetAttributes(&fa, kernel)) return static_cast<int>(rc);
  const int v[13] = {l.units, l.unit_rows, l.blocks, l.smem, fa.numRegs,
                     static_cast<int>(fa.localSizeBytes), l.blocks_per_sm, l.threads,
                     l.grain * l.unit_rows, l.threads / WARP, l.n_sh, l.slab_bytes, l.folded};
  for (int i = 0; i < 13; ++i) info[i] = v[i];
  return 0;
}

// Kernel 10 folds the gathered-slot sum into its launch where the
// persistent launch gives every block at least WIN_WHOLE_TILES whole tiles
// (q or q + 1 of them: at most 1 / WIN_WHOLE_TILES of imbalance; venice),
// and always in the per-tile form.  Elsewhere (city: 441 tiles on 396
// blocks) it runs without the fold over 128-row units, and the caller sums
// the window partials with kernel 16 (windows.cu): splitting tiles between
// blocks cost more than kernel 16 there (PERF.md).
constexpr int WIN_WHOLE_TILES = 8;

// With GHOST the kernel also reads the ghost table `gh` (the halo paths);
// without, it folds the gathered-slot sum into `fa` where it runs whole
// tiles (windows.cu), each warp keeping as many slots in shared memory as
// the blocks per SM of the launch bounds leave beside the window; `folded`
// (if given) says whether it did.  Given `info`, no launch: the plan
// (win_info).
template <typename S, class Sh, bool GHOST = false>
int launch_messages_win(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                        const int* gidx, const int* starts, int win_w, const MsgOps<S>& o,
                        int64_t mp, int deg, const MsgParams<S>& p, cudaStream_t st,
                        const GhostTable<S>& gh = GhostTable<S>{}, int* info = nullptr,
                        const WinFoldArgs<S>& fa = WinFoldArgs<S>{}, bool* folded = nullptr) {
  constexpr bool PERSISTENT = win_persistent<S, Sh>();
  using WF = WinFold<S, Sh::F_G, Sh::DG, PERSISTENT ? WIN_UNIT : BLOCK>;
  const size_t window = win_bytes<S, PERSISTENT>(win_w, Sh::F_G);
  // The fold's shared memory: the window, then the warps' slabs.
  const size_t at = WF::slabs_at(window, win_w);
  const size_t share = smem_share(PERSISTENT ? WIN_MIN_BLOCKS : 1);
  const int n_sh = at < share ? static_cast<int>(lesser((share - at) / WF::SLOT_BYTES,
                                                        static_cast<size_t>(win_w)))
                              : 0;
  const size_t fold_smem = at + WF::SLOT_BYTES * n_sh;
  const int n_tiles = static_cast<int>(mp / TILE);
  auto go = [&](auto k, bool fold) {
    WinLaunch l;
    if (int rc = win_launch<PERSISTENT>(k, fold ? fold_smem : window, mp, l, fold)) return rc;
    if (fold) {
      l.n_sh = n_sh;
      l.slab_bytes = static_cast<int>(WF::SLOT_BYTES * n_sh);
      if (PERSISTENT) {
        l.grain = TILE / WIN_UNIT;
        l.blocks = min(l.blocks, n_tiles);
      }
    }
    l.folded = fold;
    if (folded) *folded = fold;
    if (info) return win_info(k, l, info);
    WinFoldArgs<S> f = fa;
    f.n_sh = n_sh;
    if constexpr (PERSISTENT) {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, l.q(),
          l.rem(), l.grain, p, gh, f);
    } else {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p, gh, f);
    }
    return 0;
  };
  auto pick = [&](auto hr) {
    constexpr bool HR = decltype(hr)::value;
    if constexpr (!PERSISTENT) {
      return go(messages_win_tile_kernel<S, Sh, HR, GHOST>, !GHOST);
    } else if constexpr (GHOST) {
      return go(messages_win_kernel<S, Sh, HR, GHOST, false>, false);
    } else {
      // Whole tiles a block where each block gets WIN_WHOLE_TILES of them.
      auto k = messages_win_kernel<S, Sh, HR, false, true>;
      WinLaunch l;
      if (int rc = win_launch<PERSISTENT>(k, fold_smem, mp, l)) return rc;
      return n_tiles >= WIN_WHOLE_TILES * l.blocks
                 ? go(k, true)
                 : go(messages_win_kernel<S, Sh, HR, false, false>, false);
    }
  };
  return huber_row ? pick(std::true_type{}) : pick(std::false_type{});
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
    if (int rc = win_launch<PERSISTENT>(k, win_bytes<S, PERSISTENT>(win_w, Sh::F_G), mp, l))
      return rc;
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


// --- messages.cu: the whole gathered-slot table, the sum folded in -----------------------
//
// Blocks of NT threads over contiguous ranges of units of NT rows (q or q +
// 1 units a block, as many blocks as the SMs hold at once and at most
// `max_blocks`; the parent's form, more blocks than the SMs hold, each a
// chunk of rows, timed no faster: PERF.md).  Each block stages
// the packed table once, runs its rows and folds their gathered-slot
// messages onto its warps' slabs (a slot a segment, the gathered ids; the
// row's segment from the per-row map seg_ids, -1 where the CSR does not list
// the row).  At the end of its range it writes part[b] = [F, n_seg], the
// warps' sums added from zero in warp order, and a second launch
// (segsum_combine_kernel) adds the blocks' partials in a fixed order.
// NT = 128 threads, TAB_MIN_BLOCKS blocks an SM with the cameras gathered
// and WIN_MIN_BLOCKS with the landmarks gathered, in float32 up to 9 dofs
// (win_persistent); 256 threads and one block an SM otherwise.
constexpr int TAB_MIN_BLOCKS = 4;
// A row's slot in its warp's slab (null: none).  Where no two lanes of a
// warp name one segment and every segment's slot lies in shared memory
// (bench64: a warp's 32 rows are one landmark's, 32 distinct cameras), each
// row adds its gathered-slot messages onto its slot as it writes them: no
// re-read from L2, the same sums (PERF.md: 0.152 against 0.159 ms).
template <typename S, int SLOT_>
struct SlabSink {
  static constexpr int SLOT = SLOT_;
  S* cell;
  __device__ __forceinline__ void operator()(int k, S v) const {
    if (cell) cell[k] += v;
  }
};
template <typename S, class Sh>
__host__ __device__ constexpr int tab_threads() {
  return win_persistent<S, Sh>() ? WIN_UNIT : BLOCK;
}
template <typename S, class Sh>
__host__ __device__ constexpr int tab_min_blocks() {
  return !win_persistent<S, Sh>() ? 1 : Sh::GSLOT == 0 ? TAB_MIN_BLOCKS : WIN_MIN_BLOCKS;
}

// Stage 2 of the camera-side sums (segsum.cu, messages.cu): out[idx] = the
// sum over the chunks of part[c][idx], idx < n_out, in 16 phases (phase y
// adds chunks y, y + 16, ... in order, then the 16 phase sums in order),
// neighbouring threads on neighbouring idx; blockDim (COMBINE_COLS,
// COMBINE_PHASES).
constexpr int COMBINE_PHASES = 16;
constexpr int COMBINE_COLS = 32;
template <typename S>
__global__ void __launch_bounds__(COMBINE_COLS * COMBINE_PHASES)
segsum_combine_kernel(const S* __restrict__ part, int n_chunk, int64_t n_out,
                      S* __restrict__ out) {
  __shared__ S red[COMBINE_PHASES][COMBINE_COLS];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * COMBINE_COLS + x;
  S acc = S(0.0);
  if (idx < n_out) {
#pragma unroll 4
    for (int c = y; c < n_chunk; c += COMBINE_PHASES) acc += part[c * n_out + idx];
  }
  red[y][x] = acc;
  __syncthreads();
  if (y == 0 && idx < n_out) {
    S t = red[0][x];
#pragma unroll
    for (int p = 1; p < COMBINE_PHASES; ++p) t += red[p][x];
    out[idx] = t;
  }
}

template <typename S>
void launch_combine(const S* part, int n_chunk, int64_t n_out, S* out, cudaStream_t st) {
  const unsigned int blocks = static_cast<unsigned int>((n_out + COMBINE_COLS - 1) / COMBINE_COLS);
  segsum_combine_kernel<S><<<blocks, dim3(COMBINE_COLS, COMBINE_PHASES), 0, st>>>(part, n_chunk,
                                                                                  n_out, out);
}

// Shared memory: the table [n_cam][F], then the warps' slabs [W][n_sh][FP].
template <typename S, class Sh, bool HUBER_ROW, int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
messages_kernel(const S* __restrict__ cam_tab, int n_cam,
                const S* __restrict__ lmk_tab, const int* __restrict__ gidx,
                const S* __restrict__ jac, const S* __restrict__ lp,
                const S* __restrict__ r0g, const S* __restrict__ prec,
                const S* __restrict__ srel, const S* __restrict__ act,
                const S* __restrict__ me0, const S* __restrict__ ml0,
                const S* __restrict__ me1, const S* __restrict__ ml1,
                S* __restrict__ oe0, S* __restrict__ ol0,
                S* __restrict__ oe1, S* __restrict__ ol1, int64_t mp, int deg, int q, int rem,
                MsgParams<S> p, const int* __restrict__ seg_ids, int n_seg, int n_sh,
                S* __restrict__ part, S* __restrict__ slab_gl) {
  constexpr int F = Sh::F_G, W = NT / WARP, FP = FoldGroups<S, F>::FP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  S* sh = reinterpret_cast<S*>(smem_raw + align16(sizeof(S) * n_cam * F));
  const int tid = threadIdx.x, b = blockIdx.x, n_gl = n_seg - n_sh;
  // Warp w's slab: slots past n_sh at [blocks, W, n_gl, F] in device memory.
  auto slab = [&](int w) {
    return WarpSlab<S, F>{sh + w * n_sh * FP,
                          slab_gl + (static_cast<int64_t>(b) * W + w) * n_gl * F, n_sh};
  };
  for (int i = tid; i < n_cam * F; i += NT) tab[i] = cam_tab[i];
  slab(tid / WARP).zero(n_seg, tid & (WARP - 1));
  __syncthreads();
  const S* oe_g = Sh::GSLOT ? oe1 : oe0;
  const S* ol_g = Sh::GSLOT ? ol1 : ol0;
  const int u0 = b * q + min(b, rem), u1 = u0 + q + (b < rem ? 1 : 0);
#pragma unroll 1
  for (int u = u0; u < u1; ++u) {
    const int64_t r = static_cast<int64_t>(opaque(u)) * NT + tid;
    const int key = r < mp ? seg_ids[r] : -1;
    if (key >= n_seg) __trap();  // a fault of the caller's map
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const bool direct = __all_sync(0xffffffffu, key < n_sh && (key < 0 || peers ==
                                                          1u << (tid & (WARP - 1))));
    __syncwarp();  // the warp's last unit's additions are seen
    if (r < mp) {
      S* cell = direct && key >= 0 ? sh + (tid / WARP * n_sh + key) * FP : nullptr;
      messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
          tab + gidx[r] * F, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0,
          ol0, oe1, ol1, mp, deg, r, p, SlabSink<S, Sh::GSLOT>{cell});
    }
    if (!direct) fold_warp<S, F, Sh::DG>(slab(tid / WARP), oe_g, ol_g, mp, r, key);
  }
  __syncthreads();
  S* out = part + static_cast<int64_t>(b) * F * n_seg;
  for (int e = tid; e < F * n_seg; e += NT) {
    const int k = e / n_seg, s = e - k * n_seg;
    S acc = S(0.0);
#pragma unroll
    for (int w = 0; w < W; ++w) acc += slab(w).get(s, k);
    out[e] = acc;
  }
}

// The launch of messages_kernel and the combine of its partials into out
// [F, n_seg]: part holds max_blocks * F * n_seg values, slab_gl the warps'
// slots past shared memory (blocks * warps * (n_seg - slab_slots) * F
// values, `table_plan`).  Each warp keeps as many slots in shared memory as
// the blocks per SM of the launch bounds leave beside the table.  Given
// `info`, no launch: the plan (win_info).
template <typename S, class Sh>
int launch_messages_tab_ell(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                            const int* gidx, const MsgOps<S>& o, int64_t mp, int deg,
                            const MsgParams<S>& p, cudaStream_t st, const int* seg_ids,
                            int n_seg, S* part, int max_blocks, S* slab_gl, S* out, int* info) {
  constexpr int NT = tab_threads<S, Sh>(), MIN_BLOCKS = tab_min_blocks<S, Sh>(), F = Sh::F_G;
  constexpr size_t SLOT_BYTES = sizeof(S) * (NT / WARP) * FoldGroups<S, F>::FP;
  const size_t table = align16(sizeof(S) * n_cam * F), share = smem_share(MIN_BLOCKS);
  const int n_sh = table < share ? static_cast<int>(lesser((share - table) / SLOT_BYTES,
                                                           static_cast<size_t>(n_seg)))
                                 : 0;
  const size_t smem = table + SLOT_BYTES * n_sh;
  auto go = [&](auto k) {
    if (smem > SMEM_BLOCK_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (int rc = allow_smem(k, smem)) return rc;
    int bps = 0;
    if (cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, k, NT, smem))
      return static_cast<int>(rc);
    if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int units = static_cast<int>((mp + NT - 1) / NT);
    WinLaunch l{units, NT, NT, max(1, min(min(units, bps * n_sms()), max_blocks)),
                static_cast<int>(smem), bps};
    l.n_sh = n_sh;
    l.slab_bytes = static_cast<int>(SLOT_BYTES * n_sh);
    l.folded = 1;
    if (info) return win_info(k, l, info);
    k<<<l.blocks, NT, smem, st>>>(cam_tab, n_cam, lmk_tab, gidx, o.jac, o.lp, o.r0, o.prec,
                                  o.srel, o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1,
                                  o.ol1, mp, deg, l.q(), l.rem(), p, seg_ids, n_seg, n_sh, part,
                                  slab_gl);
    if (const cudaError_t rc = cudaGetLastError()) return static_cast<int>(rc);
    if (n_seg > 0) launch_combine(part, l.blocks, static_cast<int64_t>(F) * n_seg, out, st);
    return 0;
  };
  return huber_row ? go(messages_kernel<S, Sh, true, NT, MIN_BLOCKS>)
                   : go(messages_kernel<S, Sh, false, NT, MIN_BLOCKS>);
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
      const int*, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t,          \
      const int*, int, S*, int, S*, S*, int*);                                                \
  MODE template int launch_messages_win<S, SH>(bool, const S*, int, const S*, const int*,    \
      const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t,     \
      const GhostTable<S>&, int*, const WinFoldArgs<S>&, bool*);                              \
  MODE template int launch_messages_tab<S, SH>(bool, const S*, int, const int*, const S*,    \
      const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&, cudaStream_t);                \
  MODE template int launch_messages_tabblk<S, SH>(bool, const S*, int, const int*,           \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&, int*);
// ... and the halo paths' (GHOST) ones.
#define GBP_HALO_LAUNCHERS(MODE, S, SH)                                                       \
  MODE template int launch_messages_win<S, SH, true>(bool, const S*, int, const S*,          \
      const int*, const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&,       \
      cudaStream_t, const GhostTable<S>&, int*, const WinFoldArgs<S>&, bool*);                \
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
