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
// components) over the rows the caller's CSR lists, as the TPU kernels' fifth
// output does.  Rows arrive in units of NT rows, one a thread.  Once a unit's
// messages are written, each thread re-reads its row's F new components
// (from L2, where its own stores just went: no second pass over device
// memory) into a shared-memory stage, a group of components at a time, and
// names its segment (camera, window column; -1 where the CSR does not list
// the row).  One lane for each segment a warp names registers it as a
// candidate of the unit (the list's order changes no sum).  A candidate's
// listed rows in the unit are one run [lo, hi) of its CSR list (rows
// ascending).  The rows of each run are added one by one, in row order,
// onto the segment's running sum: the first n_sh segments' in a
// shared-memory slab, the others' in device memory (the block's own part of
// the output, read and written by this block alone), either by one thread
// per (candidate, component) walking the run through the stage, or, where
// no run is longer than FOLD_PASSES rows, in passes: pass j adds each run's
// j-th row, its own thread adding the row's F staged values.  So each
// segment's sum over a block's rows is one chain of additions from zero in
// row order: no floating-point atomics, and two runs give the same bits.  A
// row the CSR does not list (padding, ELL clones, a degree class's inactive
// rows) is never added, whatever its message.  The unit's bookkeeping
// alternates between two sets, so that clearing one needs no barrier of its
// own: a unit costs two barriers (three and one a pass where runs are
// short and the cursors find them, messages.cu).

// Components re-read per group: at most 45 (float32: one group at (6, 3, 2))
// or 14 (float64) a row, at stage[row * KGP + kk]; the odd stride keeps a
// warp's writes on distinct banks.
template <typename S, int F>
struct FoldGroups {
  static constexpr int KMAX = sizeof(S) == 4 ? 45 : 14;
  static constexpr int GROUPS = (F + KMAX - 1) / KMAX;
  static constexpr int KG = (F + GROUPS - 1) / GROUPS;
  static constexpr int KGP = KG | 1;
};
// Segments whose running sums live in shared memory: FOLD_SLAB_BYTES of
// them (a 128-column window of (6, 3, 2) float32 messages, 64 cameras).
constexpr int FOLD_SLAB_BYTES = 24 * 1024;
template <typename S, int F>
__host__ __device__ constexpr int fold_slab_segs() {
  return FOLD_SLAB_BYTES / (F * static_cast<int>(sizeof(S)));
}
constexpr int FOLD_PASSES = 8;

// The fold's shared memory from byte `base` on: the slab [n_sh][F], the
// stage [NT][KGP], n_cur ints of the caller's (cursors, row positions), two
// sets of unit bookkeeping (per segment a mark and the run's bounds; the
// candidates [NT], their count, the longest run) and the rows' ranks [NT].
template <typename S, int F, int NT>
struct FoldLayout {
  size_t slab, stage, cur, sets, set_ints, bytes;
  __host__ __device__ FoldLayout(size_t base, int n_sh, int n_seg, int n_cur) {
    slab = align16(base);
    stage = align16(slab + sizeof(S) * n_sh * F);
    cur = align16(stage + sizeof(S) * NT * FoldGroups<S, F>::KGP);
    sets = align16(cur + sizeof(int) * n_cur);
    set_ints = 3 * static_cast<size_t>(n_seg) + NT + 2;
    bytes = sets + sizeof(int) * (2 * set_ints + NT + 1);
  }
};

struct FoldSet {
  int *mark, *lo, *hi, *cand, *n_cand, *max_run;
};

template <typename S>
struct FoldShared {
  S* slab;
  S* stage;
  int* cur;
  int* sets;
  int set_ints, n_seg;
  int *rank, *flag;
  __device__ FoldSet set(int parity) const {
    int* b = sets + parity * set_ints;
    return {b, b + n_seg, b + 2 * n_seg, b + 3 * n_seg, b + 3 * n_seg + blockDim.x,
            b + 3 * n_seg + blockDim.x + 1};
  }
};

// The fold's shared pointers, its bookkeeping cleared (every thread calls
// it; a barrier must follow before the first unit).
template <typename S, int F, int NT>
__device__ __forceinline__ FoldShared<S> fold_shared(unsigned char* smem,
                                                      const FoldLayout<S, F, NT>& l, int n_seg) {
  int* sets = reinterpret_cast<int*>(smem + l.sets);
  const FoldShared<S> fs{reinterpret_cast<S*>(smem + l.slab), reinterpret_cast<S*>(smem + l.stage),
                         reinterpret_cast<int*>(smem + l.cur), sets,
                         static_cast<int>(l.set_ints), n_seg,
                         sets + 2 * l.set_ints, sets + 2 * l.set_ints + NT};
  for (int i = threadIdx.x; i < 2 * static_cast<int>(l.set_ints); i += NT) {
    const int j = i % static_cast<int>(l.set_ints);
    sets[i] = j >= n_seg && j < 2 * n_seg ? 0x7fffffff : 0;  // lo starts high, the rest 0
  }
  fs.rank[threadIdx.x] = -1;
  return fs;
}

// Components k0 .. k0 + KG - 1 (zero past F) of row r's new gathered-slot
// messages: eta [DG, mp] | lam [DG * DG, mp], just written by this thread,
// re-read from L2, all loads in flight together.
template <typename S, int F, int DG, int KG>
__device__ __forceinline__ void fold_load(S (&v)[KG], const S* oe, const S* ol, int64_t mp,
                                          int64_t r, int k0) {
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
    const int k = k0 + kk;
    v[kk] = k < F ? __ldcg(k < DG ? oe + k * mp + r : ol + (k - DG) * mp + r) : S(0.0);
  }
}

template <typename S, int F, int DG, int NT>
__device__ __forceinline__ void fold_stage(const FoldShared<S>& fs, const S* oe, const S* ol,
                                           int64_t mp, int64_t r, int k0) {
  using G = FoldGroups<S, F>;
  if (r < mp) {
    S v[G::KG];
    fold_load<S, F, DG, G::KG>(v, oe, ol, mp, r, k0);
#pragma unroll
    for (int kk = 0; kk < G::KG; ++kk) fs.stage[threadIdx.x * G::KGP + kk] = v[kk];
  }
}

// Register the calling thread's segment (-1: none) as a candidate of the
// unit once: one lane of each segment a warp names, one count update a
// warp.  With `pos` (the row's CSR position, rows of a segment ascending
// in lane order) the run's bounds too.
__device__ __forceinline__ void fold_mark(const FoldSet& st, int seg, int pos = -1) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, seg);
  const bool lead = seg >= 0 && __ffs(peers) - 1 == lane;
  if (seg >= 0 && pos >= 0) {
    if (lead) atomicMin(st.lo + seg, pos);
    if (31 - __clz(peers) == lane) atomicMax(st.hi + seg, pos + 1);
  }
  const bool fresh = lead && atomicExch(st.mark + seg, 1) == 0;
  const unsigned fm = __ballot_sync(full, fresh);
  int base = 0;
  if (lane == 0 && fm) base = atomicAdd(st.n_cand, __popc(fm));
  base = __shfl_sync(full, base, 0);
  if (fresh) st.cand[base + __popc(fm & ((1u << lane) - 1u))] = seg;
}

// Where segment s's running sum of component k lies.
template <typename S, int F>
struct FoldCells {
  S* slab;
  int n_sh;
  S* gl;
  int64_t gld;
};

// Add each candidate's run of rows onto its sums, one thread per
// (candidate, component of the staged group k0 .. k0 + nk - 1).
template <typename S, int F, int NT>
__device__ __forceinline__ void fold_pairs(const FoldShared<S>& fs, const FoldSet& st, int nc,
                                           const FoldCells<S, F>& cells,
                                           const int* __restrict__ rows, int64_t u0, int k0,
                                           int nk) {
  using G = FoldGroups<S, F>;
  // Components fastest: a warp's lanes walk few candidates' rows.
  for (int q = threadIdx.x; q < nc * nk; q += NT) {
    const int a = q / nk, kk = q - a * nk;
    const int s = st.cand[a];
    const int p0 = st.lo[s], p1 = st.hi[s];
    const S* v = fs.stage + kk;
    // (Unrolled, so that a chain's loads are in flight together.)
    if (s < cells.n_sh) {
      S* cell = cells.slab + s * F + k0 + kk;
      S acc = *cell;
#pragma unroll 8
      for (int p = p0; p < p1; ++p) acc += v[static_cast<int>(rows[p] - u0) * G::KGP];
      *cell = acc;
    } else {
      S* cell = cells.gl + (k0 + kk) * cells.gld + s;
      S acc = __ldcg(cell);
#pragma unroll 8
      for (int p = p0; p < p1; ++p) acc += v[static_cast<int>(rows[p] - u0) * G::KGP];
      __stcg(cell, acc);
    }
  }
}

// Clear the set a unit used (after the unit's last barrier); the other set
// is the next unit's, and this one is used again only after two barriers.
__device__ __forceinline__ void fold_clear(const FoldSet& st, int nc, int* rank) {
  for (int a = threadIdx.x; a < nc; a += blockDim.x) {
    const int s = st.cand[a];
    st.mark[s] = 0;
    st.lo[s] = 0x7fffffff;
    st.hi[s] = 0;
  }
  rank[threadIdx.x] = -1;
  if (threadIdx.x == 0) {
    *st.n_cand = 0;
    *st.max_run = 0;
  }
}

// The groups after the first: stage, barrier, pairs, barrier each.
template <typename S, int F, int DG, int NT>
__device__ __forceinline__ void fold_rest(const FoldShared<S>& fs, const FoldSet& st, int nc,
                                          const FoldCells<S, F>& cells,
                                          const int* __restrict__ rows, const S* oe, const S* ol,
                                          int64_t mp, int64_t u0) {
  using G = FoldGroups<S, F>;
#pragma unroll 1
  for (int k0 = G::KG; k0 < F; k0 += G::KG) {
    fold_stage<S, F, DG, NT>(fs, oe, ol, mp, u0 + threadIdx.x, k0);
    __syncthreads();
    fold_pairs<S, F, NT>(fs, st, nc, cells, rows, u0, k0, min(G::KG, F - k0));
    __syncthreads();
  }
}

// The first position in [lo, hi) of an ascending run whose row is at least key.
__device__ __forceinline__ int first_at_least(const int* __restrict__ rows, int lo, int hi,
                                              int64_t key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (rows[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The end of the run of rows below `end` from position p0 on, p0 <= hi:
// probes p0, p0 + 1, p0 + 3, p0 + 7, ... then a binary search, so a run of
// n rows costs about 2 log2(n) loads.
__device__ __forceinline__ int run_end(const int* __restrict__ rows, int p0, int hi, int64_t end) {
  int lo = p0, probe = p0, step = 1;
  while (probe < hi && rows[probe] < end) {
    lo = probe + 1;
    probe += step;
    step <<= 1;
  }
  return first_at_least(rows, lo, min(probe, hi), end);
}

// Zero the running sums of n_seg segments: the slab's first n_sh, the rest
// at gl[k * gld + s].
template <typename S, int F, int NT>
__device__ __forceinline__ void fold_zero(const FoldCells<S, F>& c, int n_seg) {
  for (int i = threadIdx.x; i < c.n_sh * F; i += NT) c.slab[i] = S(0.0);
  const int n_gl = n_seg - c.n_sh;
  for (int e = threadIdx.x; e < F * n_gl; e += NT) {
    const int k = e / n_gl;
    __stcg(c.gl + k * c.gld + c.n_sh + (e - k * n_gl), S(0.0));
  }
}

// No fold: the windowed messages kernels of the unfused and halo paths.
struct NoFold {
  __device__ __forceinline__ void begin(int, int64_t, int64_t) {}
  __device__ __forceinline__ void unit(int64_t, int) {}
  __device__ __forceinline__ void end() {}
};

// The windowed fold's operands (windows.cu): the CSR of `window_rows_csr`
// (segment t * w + j lists the rows of tile t whose gathered id is
// starts[t] + j, ascending), the output part [n_tiles, F, w], and for the
// persistent launch the pieces [blocks, 2, F, w] and the per-tile counters
// [n_tiles] (zero between launches).
template <typename S>
struct WinFoldArgs {
  const int* rows;
  const int* offsets;
  S* part;
  S* piece;
  int* count;
};

// The windowed fold: a tile's segments are its window's w columns.  Where a
// block enters a tile it scatters the tile's CSR positions into pos[] (TILE
// ints, -1 for a row the CSR does not list), so a unit's run of each column
// is the span of its rows' positions: no search.  A tile whose rows all run
// in one block (every tile of the per-tile kernel, and of the persistent
// one those that lie inside a block's range) is summed in that block from
// zero in row order, as segsum_cm_blk adds it: the same bits.  A tile the
// persistent launch splits between blocks (its range ends inside the tile)
// is summed by each block over its own rows into a piece; the last block to
// finish (an integer counter a tile) adds the pieces in block order, the
// first block's first, so the result is fixed by the launch plan but not
// that of one chain.  Pieces and the combination cover the tile's non-empty
// columns only; the others are zero.
template <typename S, int F, int DG, int NT>
struct WinFold {
  WinFoldArgs<S> a;
  const S* oe;
  const S* ol;
  int64_t mp;
  int w, q, rem;  // q: the persistent launch's units a block (0: one block a tile)
  FoldShared<S> fs;
  FoldCells<S, F> cells;
  int* pos;
  unsigned* nonempty;
  int* ncol;  // the tile's non-empty columns, ascending, then their count
  int tile, unit_no;
  bool whole;

  // The row positions [TILE], the non-empty columns' bits, their list [w + 1].
  static __host__ __device__ FoldLayout<S, F, NT> layout(size_t base, int w) {
    return FoldLayout<S, F, NT>(base, min(w, fold_slab_segs<S, F>()), w,
                                TILE + (w + 31) / 32 + w + 1);
  }
  __device__ WinFold(const WinFoldArgs<S>& args, const S* oe_g, const S* ol_g, int64_t mp_,
                     int w_, int q_, int rem_, unsigned char* smem, size_t base)
      : a(args), oe(oe_g), ol(ol_g), mp(mp_), w(w_), q(q_), rem(rem_), unit_no(0) {
    fs = fold_shared<S, F, NT>(smem, layout(base, w), w);
    cells = FoldCells<S, F>{fs.slab, min(w, fold_slab_segs<S, F>()), nullptr, w};
    pos = fs.cur;
    nonempty = reinterpret_cast<unsigned*>(fs.cur + TILE);
    ncol = fs.cur + TILE + (w + 31) / 32;
  }
  // The block that runs unit u, and the first tile of block b's range.
  __device__ int block_of(int u) const {
    const int big = rem * (q + 1);
    return u < big ? u / (q + 1) : rem + (u - big) / q;
  }
  __device__ int first_tile(int b) const { return (b * q + min(b, rem)) / (TILE / WIN_UNIT); }
  __device__ bool is_nonempty(int c) const { return (nonempty[c >> 5] >> (c & 31)) & 1u; }

  // Tile t's rows [r0, r1) run in this block.
  __device__ void begin(int t, int64_t r0, int64_t r1) {
    tile = t;
    const int64_t row0 = static_cast<int64_t>(t) * TILE;
    whole = r0 == row0 && r1 == row0 + TILE;
    const int slot = first_tile(blockIdx.x) == t ? 0 : 1;
    cells.gl = whole ? a.part + static_cast<int64_t>(t) * F * w
                     : a.piece + (static_cast<int64_t>(blockIdx.x) * 2 + slot) * F * w;
    fold_zero<S, F, NT>(cells, w);
    const int* off = a.offsets + static_cast<int64_t>(t) * w;
    if (threadIdx.x < 32) {  // one warp lists the non-empty columns
      const int lane = threadIdx.x;
      int n = 0;
      for (int c0 = 0; c0 < w; c0 += 32) {
        const int c = c0 + lane;
        const bool ne = c < w && off[c + 1] > off[c];
        const unsigned m = __ballot_sync(0xffffffffu, ne);
        if (ne) ncol[n + __popc(m & ((1u << lane) - 1u))] = c;
        if (lane == 0) nonempty[c0 >> 5] = m;
        n += __popc(m);
      }
      if (lane == 0) ncol[w] = n;
    }
    for (int i = threadIdx.x; i < TILE; i += NT) pos[i] = -1;
    __syncthreads();
    // The tile's CSR positions of the rows in this block's range.
    for (int p = off[0] + threadIdx.x; p < off[w]; p += NT) {
      const int64_t r = a.rows[p];
      if (r < row0 || r >= row0 + TILE) __trap();
      if (r >= r0 && r < r1) pos[r - row0] = p;
    }
    __syncthreads();
  }
  // The unit from row u0 on; col: the calling thread's window column.
  __device__ void unit(int64_t u0, int col) {
    const int tid = threadIdx.x;
    const FoldSet st = fs.set(unit_no++ & 1);
    const int p = pos[u0 - static_cast<int64_t>(tile) * TILE + tid];
    fold_stage<S, F, DG, NT>(fs, oe, ol, mp, u0 + tid, 0);
    fold_mark(st, p >= 0 ? col : -1, p);
    __syncthreads();
    const int nc = *st.n_cand;
    fold_pairs<S, F, NT>(fs, st, nc, cells, a.rows, u0, 0, min(FoldGroups<S, F>::KG, F));
    __syncthreads();
    fold_rest<S, F, DG, NT>(fs, st, nc, cells, a.rows, oe, ol, mp, u0);
    fold_clear(st, nc, fs.rank);
  }
  __device__ void end() {
    const int nt = threadIdx.x;
    const int n_sh = cells.n_sh;
    S* out = a.part + static_cast<int64_t>(tile) * F * w;
    __syncthreads();  // the last unit's sums
    if (whole) {
      for (int e = nt; e < F * n_sh; e += NT) {
        const int k = e / n_sh, c = e - k * n_sh;
        out[k * w + c] = fs.slab[c * F + k];
      }
      __syncthreads();
      return;
    }
    // The piece's non-empty columns (those past the slab are in it already).
    const int n_ne = ncol[w];
    for (int e = nt; e < F * n_ne; e += NT) {
      const int k = e / n_ne, c = ncol[e - k * n_ne];
      if (c < n_sh) __stcg(cells.gl + k * w + c, fs.slab[c * F + k]);
    }
    // One thread releases the block's piece (the barrier orders the others'
    // stores before its fence) and counts it; the last acquires the rest.
    __syncthreads();
    constexpr int UPT = TILE / WIN_UNIT;
    const int units = static_cast<int>(gridDim.x) * q + rem;
    const int b0 = block_of(tile * UPT), b1 = block_of(min((tile + 1) * UPT, units) - 1);
    if (nt == 0) {
      __threadfence();
      const int last = atomicAdd(a.count + tile, 1) == b1 - b0;
      if (last) {
        atomicExch(a.count + tile, 0);
        __threadfence();
      }
      *fs.flag = last;
    }
    __syncthreads();
    if (*fs.flag) {
      auto piece_of = [&](int b) {
        return a.piece + (static_cast<int64_t>(b) * 2 + (first_tile(b) == tile ? 0 : 1)) * F * w;
      };
      for (int e = nt; e < F * n_ne; e += NT) {
        const int k = e / n_ne;
        const int64_t at = static_cast<int64_t>(k) * w + ncol[e - k * n_ne];
        S acc = __ldcg(piece_of(b0) + at);
#pragma unroll 4
        for (int b = b0 + 1; b <= b1; ++b) acc += __ldcg(piece_of(b) + at);
        out[at] = acc;
      }
      for (int e = nt; e < F * w; e += NT) {
        const int c = e % w;
        if (!is_nonempty(c)) out[e] = S(0.0);
      }
    }
    __syncthreads();
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
// 17), q or q + 1 units of WIN_UNIT rows per block: the gathered slot's
// belief from the tile's window of `tab` (with GHOST, ids
// from n_own on from the ghost table), the other slot's at r / deg of
// ell_tab or, with OTHER, from the expanded operands be_o, bl_o.
template <typename S, class Sh, bool HUBER_ROW, bool GHOST, bool OTHER, class Fold>
__device__ __forceinline__ void window_messages(
    const S* __restrict__ tab, int n_tab, const int* __restrict__ gidx,
    const int* __restrict__ starts, int win_w, const S* __restrict__ ell_tab, int deg,
    const S* __restrict__ be_o, const S* __restrict__ bl_o, const S* __restrict__ jac,
    const S* __restrict__ lp, const S* __restrict__ r0g, const S* __restrict__ prec,
    const S* __restrict__ srel, const S* __restrict__ act, const S* __restrict__ me0,
    const S* __restrict__ ml0, const S* __restrict__ me1, const S* __restrict__ ml1,
    S* __restrict__ oe0, S* __restrict__ ol0, S* __restrict__ oe1, S* __restrict__ ol1,
    int64_t mp, int q, int rem, const MsgParams<S>& p, const GhostTable<S>& gh, Fold& fold) {
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
  // Tile t's rows in this block's range, for the fold.
  auto in_range = [&](int t, int64_t& r0, int64_t& r1) {
    r0 = static_cast<int64_t>(max(t * UPT, u)) * WIN_UNIT;
    r1 = static_cast<int64_t>(min((t + 1) * UPT, u1)) * WIN_UNIT;
  };
  int64_t t0, t1;
  load_window(u / UPT);
  in_range(u / UPT, t0, t1);
  fold.begin(u / UPT, t0, t1);
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
      in_range((u + 1) / UPT, t0, t1);
      fold.begin((u + 1) / UPT, t0, t1);
    }
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
                    MsgParams<S> p, GhostTable<S> gh, WinFoldArgs<S> fa) {
  if constexpr (GHOST) {
    NoFold fold;
    window_messages<S, Sh, HUBER_ROW, GHOST, false>(
        cam_tab, n_cam, gidx, starts, win_w, lmk_tab, deg, nullptr, nullptr, jac, lp, r0g, prec,
        srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, p, gh, fold);
  } else {
    // The fold's shared memory follows the window buffer (win_launch).
    extern __shared__ __align__(16) unsigned char smem_raw[];
    WinFold<S, Sh::F_G, Sh::DG, WIN_UNIT> fold(fa, Sh::GSLOT ? oe1 : oe0, Sh::GSLOT ? ol1 : ol0,
                                               mp, win_w, q, rem, smem_raw,
                                               win_bytes<S, true>(win_w, Sh::F_G));
    window_messages<S, Sh, HUBER_ROW, GHOST, false>(
        cam_tab, n_cam, gidx, starts, win_w, lmk_tab, deg, nullptr, nullptr, jac, lp, r0g, prec,
        srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, p, gh, fold);
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
      ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, q, rem, p, gh, fold);
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
                    MsgParams<S> p, GhostTable<S> gh, WinFoldArgs<S> fa) {
  constexpr int F_G = Sh::F_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int start = starts[blockIdx.x];
  const int n_in = min(win_w, n_cam - start);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TILE;
  auto rows = [&](auto& fold) {
    stage_window(cam_tab, F_G, start, n_in, tab);
    fold.begin(blockIdx.x, row0, row0 + TILE);
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
    rows(fold);
  } else {
    // The fold's shared memory follows the window (win_launch).
    WinFold<S, F_G, Sh::DG, BLOCK> fold(fa, Sh::GSLOT ? oe1 : oe0, Sh::GSLOT ? ol1 : ol0, mp,
                                        win_w, 0, 0, smem_raw, win_bytes<S, false>(win_w, F_G));
    rows(fold);
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
// `fold`: the fold's shared memory after the window (fold_bytes, the kernels'
// own layout) in place of the window alone.
template <typename S, class Sh, bool PERSISTENT>
size_t fold_bytes(int win_w) {
  constexpr int NT = PERSISTENT ? WIN_UNIT : BLOCK;
  return WinFold<S, Sh::F_G, Sh::DG, NT>::layout(win_bytes<S, PERSISTENT>(win_w, Sh::F_G), win_w)
      .bytes;
}
template <typename S, bool PERSISTENT, typename K>
int win_launch(K kernel, int win_w, int f, int64_t mp, WinLaunch& l, size_t fold = 0) {
  const size_t smem = fold ? fold : win_bytes<S, PERSISTENT>(win_w, f);
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

// With GHOST the kernel also reads the ghost table `gh` (the halo paths);
// without, it folds the gathered-slot sum into `fa` (windows.cu).  Given
// `info`, no launch: the plan (win_info).
template <typename S, class Sh, bool GHOST = false>
int launch_messages_win(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                        const int* gidx, const int* starts, int win_w, const MsgOps<S>& o,
                        int64_t mp, int deg, const MsgParams<S>& p, cudaStream_t st,
                        const GhostTable<S>& gh = GhostTable<S>{}, int* info = nullptr,
                        const WinFoldArgs<S>& fa = WinFoldArgs<S>{}) {
  constexpr bool PERSISTENT = win_persistent<S, Sh>();
  const size_t fold = GHOST ? 0 : fold_bytes<S, Sh, PERSISTENT>(win_w);
  auto go = [&](auto k) {
    WinLaunch l;
    if (int rc = win_launch<S, PERSISTENT>(k, win_w, Sh::F_G, mp, l, fold)) return rc;
    if (info) return win_info(k, l, info);
    if constexpr (PERSISTENT) {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, l.q(),
          l.rem(), p, gh, fa);
    } else {
      k<<<l.blocks, l.threads, l.smem, st>>>(
          cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o.jac, o.lp, o.r0, o.prec, o.srel,
          o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1, o.ol1, mp, deg, p, gh, fa);
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

// --- messages.cu: the whole gathered-slot table, the sum folded in -----------------------
//
// Persistent blocks as the windowed kernels' (q or q + 1 contiguous units of
// NT rows, as many blocks as the SMs hold, at most `max_blocks`): 128-thread
// units three to an SM where win_persistent, one 256-thread block per SM
// otherwise.  Each block stages the packed table once, runs its rows and
// folds their gathered-slot messages into its partial sums part[b] = [F,
// n_seg] (segments: the gathered ids; the CSR (seg_rows, seg_offsets) lists
// each id's rows ascending, and a cursor per segment walks it past each
// unit); a second launch (segsum_combine_kernel) adds the blocks' partials
// in a fixed order.

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

// Shared memory: the table [n_cam][F], then the fold (FoldLayout, a cursor a
// segment).
template <typename S, int F, int NT>
__host__ __device__ FoldLayout<S, F, NT> tab_fold_layout(int n_cam, int n_seg) {
  return FoldLayout<S, F, NT>(sizeof(S) * n_cam * F, min(n_seg, fold_slab_segs<S, F>()), n_seg,
                              n_seg);
}

template <typename S, class Sh, bool HUBER_ROW, int NT>
__global__ void __launch_bounds__(NT, NT == WIN_UNIT ? WIN_MIN_BLOCKS : 1)
messages_kernel(const S* __restrict__ cam_tab, int n_cam,
                const S* __restrict__ lmk_tab, const int* __restrict__ gidx,
                const S* __restrict__ jac, const S* __restrict__ lp,
                const S* __restrict__ r0g, const S* __restrict__ prec,
                const S* __restrict__ srel, const S* __restrict__ act,
                const S* __restrict__ me0, const S* __restrict__ ml0,
                const S* __restrict__ me1, const S* __restrict__ ml1,
                S* __restrict__ oe0, S* __restrict__ ol0,
                S* __restrict__ oe1, S* __restrict__ ol1, int64_t mp, int deg, int q, int rem,
                MsgParams<S> p, const int* __restrict__ seg_rows,
                const int* __restrict__ seg_offsets, int n_seg, S* __restrict__ part) {
  constexpr int F = Sh::F_G;
  using G = FoldGroups<S, F>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const FoldShared<S> fs =
      fold_shared<S, F, NT>(smem_raw, tab_fold_layout<S, F, NT>(n_cam, n_seg), n_seg);
  const int tid = threadIdx.x, b = blockIdx.x;
  const FoldCells<S, F> cells{fs.slab, min(n_seg, fold_slab_segs<S, F>()),
                              part + static_cast<int64_t>(b) * F * n_seg, n_seg};
  const int u0 = b * q + min(b, rem), u1 = u0 + q + (b < rem ? 1 : 0);
  for (int i = tid; i < n_cam * F; i += NT) tab[i] = cam_tab[i];
  fold_zero<S, F, NT>(cells, n_seg);
  // A cursor a segment: its first CSR position at or past the block's rows.
  for (int s = tid; s < n_seg; s += NT)
    fs.cur[s] = first_at_least(seg_rows, seg_offsets[s], seg_offsets[s + 1],
                               static_cast<int64_t>(u0) * NT);
  __syncthreads();
  const S* oe_g = Sh::GSLOT ? oe1 : oe0;
  const S* ol_g = Sh::GSLOT ? ol1 : ol0;
#pragma unroll 1
  for (int u = u0; u < u1; ++u) {
    const int64_t base = static_cast<int64_t>(u) * NT, r = base + tid;
    int seg = -1;
    if (r < mp) {
      const int id = gidx[r];
      messages_row<S, Sh::DA, Sh::DB, Sh::ZD, HUBER_ROW, Sh::GSLOT>(
          tab + id * F, lmk_tab, jac, lp, r0g, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0,
          oe1, ol1, mp, deg, r, p);
      seg = id < n_seg ? id : -1;
    }
    const FoldSet st = fs.set(u & 1);
    fold_stage<S, F, Sh::DG, NT>(fs, oe_g, ol_g, mp, r, 0);
    fold_mark(st, seg);
    __syncthreads();
    // Each candidate's run: its cursor walks the CSR list past the unit;
    // where runs are short, each row's rank in its run.
    const int nc = *st.n_cand;
    int longest = 0;
    for (int a = tid; a < nc; a += NT) {
      const int s = st.cand[a];
      const int p0 = fs.cur[s], p1 = run_end(seg_rows, p0, seg_offsets[s + 1], base + NT);
      fs.cur[s] = st.hi[s] = p1;
      st.lo[s] = p0;
      if (p1 - p0 <= FOLD_PASSES) {
        for (int i = p0; i < p1; ++i) fs.rank[static_cast<int>(seg_rows[i] - base)] = i - p0;
      }
      longest = max(longest, p1 - p0);
    }
    longest = __reduce_max_sync(0xffffffffu, longest);
    if ((tid & 31) == 0 && longest > 0) atomicMax(st.max_run, longest);
    __syncthreads();
    const int passes = *st.max_run;  // (a late read after the clear below sees 0 only
                                     // when it was 0: passes end on a barrier)
    if (G::GROUPS == 1 && passes <= FOLD_PASSES) {
      // Pass j: each run's j-th row, its thread adding its staged values.
      const int rank = fs.rank[tid];
      for (int j = 0; j < passes; ++j) {
        if (rank == j) {
          const S* v = fs.stage + tid * G::KGP;
          if (seg < cells.n_sh) {
#pragma unroll
            for (int k = 0; k < F; ++k) cells.slab[seg * F + k] += v[k];
          } else {
#pragma unroll
            for (int k = 0; k < F; ++k) {
              S* cell = cells.gl + k * cells.gld + seg;
              __stcg(cell, __ldcg(cell) + v[k]);
            }
          }
        }
        __syncthreads();
      }
    } else {
      fold_pairs<S, F, NT>(fs, st, nc, cells, seg_rows, base, 0, G::KG);
      __syncthreads();
      fold_rest<S, F, Sh::DG, NT>(fs, st, nc, cells, seg_rows, oe_g, ol_g, mp, base);
    }
    fold_clear(st, nc, fs.rank);
  }
  __syncthreads();
  for (int e = tid; e < F * cells.n_sh; e += NT) {
    const int k = e / cells.n_sh, s = e - k * cells.n_sh;
    cells.gl[static_cast<int64_t>(k) * n_seg + s] = fs.slab[s * F + k];
  }
}

// The launch of messages_kernel and the combine of its partials into out
// [F, n_seg]; part holds max_blocks * F * n_seg values.  Given `info`, no
// launch: {units, rows per unit, blocks, shared bytes, registers and local
// bytes per thread, blocks per SM} (win_info).
template <typename S, class Sh>
int launch_messages_tab_ell(bool huber_row, const S* cam_tab, int n_cam, const S* lmk_tab,
                            const int* gidx, const MsgOps<S>& o, int64_t mp, int deg,
                            const MsgParams<S>& p, cudaStream_t st, const int* seg_rows,
                            const int* seg_offsets, int n_seg, S* part, int max_blocks, S* out,
                            int* info) {
  constexpr int NT = win_persistent<S, Sh>() ? WIN_UNIT : BLOCK;
  auto go = [&](auto k) {
    const size_t smem = tab_fold_layout<S, Sh::F_G, NT>(n_cam, n_seg).bytes;
    if (smem > SMEM_BLOCK_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (int rc = allow_smem(k, smem)) return rc;
    int bps = 0;
    if (cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, k, NT, smem))
      return static_cast<int>(rc);
    if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int units = static_cast<int>((mp + NT - 1) / NT);
    const WinLaunch l{units, NT, NT, max(1, min(min(units, bps * n_sms()), max_blocks)),
                      static_cast<int>(smem), bps};
    if (info) return win_info(k, l, info);
    k<<<l.blocks, NT, smem, st>>>(cam_tab, n_cam, lmk_tab, gidx, o.jac, o.lp, o.r0, o.prec,
                                  o.srel, o.act, o.me0, o.ml0, o.me1, o.ml1, o.oe0, o.ol0, o.oe1,
                                  o.ol1, mp, deg, l.q(), l.rem(), p, seg_rows, seg_offsets, n_seg,
                                  part);
    if (const cudaError_t rc = cudaGetLastError()) return static_cast<int>(rc);
    if (n_seg > 0) launch_combine(part, l.blocks, static_cast<int64_t>(Sh::F_G) * n_seg, out, st);
    return 0;
  };
  return huber_row ? go(messages_kernel<S, Sh, true, NT>) : go(messages_kernel<S, Sh, false, NT>);
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
      const int*, const int*, int, S*, int, S*, int*);                                        \
  MODE template int launch_messages_win<S, SH>(bool, const S*, int, const S*, const int*,    \
      const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&, cudaStream_t,     \
      const GhostTable<S>&, int*, const WinFoldArgs<S>&);                                     \
  MODE template int launch_messages_tab<S, SH>(bool, const S*, int, const int*, const S*,    \
      const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&, cudaStream_t);                \
  MODE template int launch_messages_tabblk<S, SH>(bool, const S*, int, const int*,           \
      const int*, int, const S*, const S*, const MsgOps<S>&, int64_t, const MsgParams<S>&,    \
      cudaStream_t, const GhostTable<S>&, int*);
// ... and the halo paths' (GHOST) ones.
#define GBP_HALO_LAUNCHERS(MODE, S, SH)                                                       \
  MODE template int launch_messages_win<S, SH, true>(bool, const S*, int, const S*,          \
      const int*, const int*, int, const MsgOps<S>&, int64_t, int, const MsgParams<S>&,       \
      cudaStream_t, const GhostTable<S>&, int*, const WinFoldArgs<S>&);                       \
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
