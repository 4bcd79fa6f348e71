// The windowed large-scene kernels for Hopper (sm_90a): city and venice
// bundle adjustment, and long pose chains, where the gathered slot's table
// no longer fits one block's shared memory.  Shapes and models as in
// messages.cu ((6, 3, 2), (9, 3, 2), (3, 3, 3), (6, 6, 6); scalar or per-row
// Huber); the messages kernel is in table_kernels.cuh.
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
//   Bound: device-memory bytes (about 570 bytes per row at (6, 3, 2) in
//   float32), and short of them the latency of the per-row loads at the few
//   warps the registers leave an SM (one row per thread, 150-170 registers
//   at (6, 3, 2) float32); the window of packed beliefs is w x 42 values
//   (21.5 KB at w = 128 in float32, 64.5 KB at w = 384, twice that in
//   float64).
//   Design (window_messages, table_kernels.cuh): persistent blocks over
//   units of rows, balanced to one unit; each tile's window arrives by a
//   bulk copy into one of two buffers while the tile before it computes,
//   each unit's operands by bulk copies into a ring of shared-memory
//   stages; the launch plan keeps the most threads resident per SM
//   (`ops.messages.window_plan`).  The per-row arithmetic is the full-table
//   kernel's, so the outputs are its bits.  An id outside its tile's window
//   is a fault of the prepared graph: the kernel traps, it never clamps.
//
// segsum_cm_blk
//   Replaces `segsum_cm_blk`'s kernel stage (`_kernel_segsum_blk`,
//   gbp_tpu/ops/messages_pallas.py) and the 5th output of
//   `fused_messages_cm_tabblk_ell` (`_segsum_partial_blk`): part[i, k, j] =
//   sum of component k over the rows of tile i whose camera id is
//   starts[i] + j, added in the order of the CSR of `window_rows_csr`
//   (segment i * w + j) starting from zero.
//   Bound: device-memory bytes: the f message components read once, the
//   CSR read once, the [n_tiles, f, w] partials written once (mostly zeros:
//   a locality-sorted tile touches 3-11 of its 128 window columns).  At
//   venice in float32: 808 MB of components, 22 MB of CSR, 101 MB of
//   partials, 0.278 ms at 3.35 TB/s.
//   Design: deterministic, no atomics.  Persistent blocks of 128 threads,
//   three to an SM, walk items of one tile and one group of components (7
//   in float32, 3 in float64).  An item's slices of the tile (1,024
//   contiguous values each) arrive by bulk copies on an mbarrier, its rows
//   and offsets by cp.async, all into second buffers while the item before
//   it sums.  Each pass of 128 window columns compacts the non-empty ones
//   (a ballot and the warps' counts) and deals the (column, component)
//   pairs to the threads; each adds its segment from shared memory in CSR
//   order, the additions and order of the plain version, so the outputs
//   are its bits.  A tile's segments are long (hundreds of rows in a few
//   columns), so the sums are serial chains of shared-memory loads: with
//   one block per item the whole card loaded, then summed, in lockstep
//   waves (PERF.md); prefetching the next item keeps the loads
//   going under the chains.  The pass's output slab, zeroed in shared
//   memory, leaves as contiguous spans of the columns.  A row outside its
//   tile, or offsets that fall, are a fault of the prepared graph: the
//   kernel traps, it never clamps.
//
// scatter_windows_cm
//   Replaces `scatter_windows_cm` (`_kernel_scatter_win`): out[k, c] = sum
//   over the tiles i whose window holds c of part[i, k, c - starts[i]], in
//   ascending i, the order of the reference's sequential grid.
//   Bound: device-memory bytes, the partials read once (9.5 MB at city in
//   float32, mostly still in L2 from segsum_cm_blk); short of that, the
//   latency of the reads, since each camera is covered by tens of tiles.
//   Design: the TPU kernel walks the tiles in order and adds each window
//   into one resident accumulator; here the same walk runs per block of
//   SC_CAMS = 128 consecutive cameras (one thread each) and per group of
//   components.  The block's tiles (those whose window meets it, ascending)
//   come from a list built at prepare time (`window_block_csr`), loaded
//   into shared memory once with their starts, in passes of SC_LIST
//   entries.  Each tile's slice part[t, k, max(c0 - s_t, 0) : ...] is
//   contiguous and 32-byte aligned (starts and block offsets are multiples
//   of 8), so the slices stream into a ring of three shared-memory stages
//   by 16-byte cp.async, each stage holding TP tiles: one barrier per stage,
//   not per tile, and the next two stages' loads in flight while a stage
//   is added (a barrier per tile cost more than the loads at city).  Each
//   thread adds its camera's value from every tile in list order starting
//   from zero, and skips the tiles whose window misses its camera: the same
//   additions in the same order as the plain version and a dense
//   accumulation in tile order, so the results are equal bit for bit.  A
//   listed tile whose window misses the block, or a start that is not a
//   multiple of 8, is a fault of the prepared graph: the kernel traps, it
//   never clamps.  Starts travel as int32, not through a float row.
#include "async_copy.cuh"
#include "table_kernels.cuh"

namespace gbp {

// segsum_cm_blk: persistent blocks of SB_THREADS threads over items, an item
// being one tile and one group of at most KG components (KG by dtype: 7
// float32 or 3 float64 slices of 4 or 8 KB, double-buffered, three blocks
// to an SM).  Block b takes items b, b + grid, ...  While an item sums, the
// next item's slices arrive by bulk copies into the other buffer (an
// mbarrier each), its rows and pass-0 offsets by cp.async into the other
// buffers, and the item after it's head (first offset, row count) into
// registers.  Shared memory: the mbarriers, the slices [2][KG][TILE + pad]
// (pad: 16 bytes, so that the lanes of a warp reading one row of several
// components hit different banks), the output slab of one pass of columns
// [KG][SB_THREADS], the rows [2][TILE] (turned into indices within the tile
// in place), pass 0's offsets [2][SB_THREADS + 2] (the columns' offsets, then
// the tile's end), the pass's non-empty columns (column, first entry, end)
// [3][SB_THREADS] and the warps' counts.
constexpr int SB_THREADS = 128;
template <typename S>
constexpr int sb_comps() {
  return sizeof(S) == 4 ? 7 : 3;
}
template <typename S, int KG>
struct SbSmem {
  static constexpr int SLICE = TILE + 16 / static_cast<int>(sizeof(S));
  static constexpr int OFFS = SB_THREADS + 2;
  static constexpr size_t COMP = 16;
  static constexpr size_t SLAB = COMP + 2 * sizeof(S) * KG * SLICE;
  static constexpr size_t ROWS = SLAB + sizeof(S) * KG * SB_THREADS;
  static constexpr size_t OFF = ROWS + 2 * sizeof(int) * TILE;
  static constexpr size_t CSEG = OFF + 2 * sizeof(int) * OFFS;
  static constexpr size_t WCNT = CSEG + 3 * sizeof(int) * SB_THREADS;
  static constexpr size_t BYTES = WCNT + sizeof(int) * (SB_THREADS / 32);
};

// Item it is group it % groups of tile it / groups; n_items = n_tiles * groups.
template <typename S, int KG>
__global__ void __launch_bounds__(SB_THREADS)
segsum_blk_kernel(const S* __restrict__ me, const S* __restrict__ ml, int d,
                  const int* __restrict__ rows, const int* __restrict__ offsets, int w,
                  int64_t mp, int groups, int n_items, S* __restrict__ out) {
  using L = SbSmem<S, KG>;
  constexpr int NT = SB_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  S* comp0 = reinterpret_cast<S*>(smem_raw + L::COMP);
  S* slab = reinterpret_cast<S*>(smem_raw + L::SLAB);
  int* rows0 = reinterpret_cast<int*>(smem_raw + L::ROWS);
  int* offs0 = reinterpret_cast<int*>(smem_raw + L::OFF);
  int* ccol = reinterpret_cast<int*>(smem_raw + L::CSEG);
  int* cbeg = ccol + NT;
  int* cend = cbeg + NT;
  int* wcnt = reinterpret_cast<int*>(smem_raw + L::WCNT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = d + d * d;
  // The f components dealt evenly over the groups: [k0, k0 + nk) of group g.
  const int q = f / groups, rem = f % groups;
  const int stride = gridDim.x;
  const int n0 = min(w, NT);
  // Item it's slices into buffer b (thread 0: contiguous 16-byte-aligned
  // spans of TILE values, mp being whole tiles), its pass-0 offsets and its
  // n rows from `base` by cp.async from every thread; one commit, made also
  // past the last item, so that every thread's groups stay in step.
  auto fetch = [&](int it, int b, int base, int n) {
    if (it < n_items) {
      const int tile = it / groups, g = it % groups;
      const int64_t row0 = static_cast<int64_t>(tile) * TILE;
      if (tid == 0) {
        const int k0 = g * q + min(g, rem), nk = q + (g < rem ? 1 : 0);
        S* comp = comp0 + b * KG * L::SLICE;
        mbar_arrive_expect_tx(bar + b, static_cast<unsigned>(nk * TILE * sizeof(S)));
        for (int kk = 0; kk < nk; ++kk) {
          const int k = k0 + kk;
          const S* src = (k < d ? me + k * mp : ml + (k - d) * mp) + row0;
          bulk_load(comp + kk * L::SLICE, src, static_cast<unsigned>(TILE * sizeof(S)), bar + b);
        }
      }
      const int* off = offsets + static_cast<int64_t>(tile) * w;
      int* so = offs0 + b * L::OFFS;
      for (int i = tid; i <= n0; i += NT) cp_async_elem(so + i, off + i);
      if (tid == 0) cp_async_elem(so + NT + 1, off + w);
      int* sr = rows0 + b * TILE;
      for (int i = tid; i < n; i += NT) cp_async_elem(sr + i, rows + base + i);
    }
    cp_async_commit();
  };
  auto head = [&](int it, int& base, int& n) {
    if (it < n_items) {
      const int* off = offsets + static_cast<int64_t>(it / groups) * w;
      base = off[0];
      n = off[w] - base;
    }
  };
  int it = blockIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
  }
  __syncthreads();
  int b_cur = 0, n_cur = 0, b_nxt = 0, n_nxt = 0;
  head(it, b_cur, n_cur);
  if (n_cur < 0 || n_cur > TILE) __trap();
  fetch(it, 0, b_cur, n_cur);
  head(it + stride, b_nxt, n_nxt);
  unsigned phase = 0;  // bit b: the parity of buffer b's next completion
  int buf = 0;
  for (; it < n_items; it += stride, buf ^= 1) {
    // Buffer buf ^ 1 was freed by the last item's closing barrier.
    if (n_nxt < 0 || n_nxt > TILE) __trap();
    fetch(it + stride, buf ^ 1, b_nxt, n_nxt);
    const int base = b_cur, n_rows = n_cur;
    b_cur = b_nxt;
    n_cur = n_nxt;
    head(it + 2 * stride, b_nxt, n_nxt);
    const int tile = it / groups, g = it % groups;
    const int k0 = g * q + min(g, rem), nk = q + (g < rem ? 1 : 0);
    const int64_t row0 = static_cast<int64_t>(tile) * TILE;
    const S* comp = comp0 + buf * KG * L::SLICE;
    int* lrow = rows0 + buf * TILE;
    const int* so = offs0 + buf * L::OFFS;
    const int* off = offsets + static_cast<int64_t>(tile) * w;
    cp_async_wait<1>();  // this item's copies (each thread its own: the rows it turns)
    // (In 64 bits: with int arithmetic here ptxas gave the kernel 48
    // registers, not 56, and it ran slower; PERF.md.)
    for (int i = tid; i < n_rows; i += NT) {
      const int64_t r = lrow[i] - row0;
      if (r < 0 || r >= TILE) __trap();
      lrow[i] = static_cast<int>(r);
    }
    __syncthreads();
    if (so[NT + 1] - so[0] != n_rows || so[0] != base) __trap();
    // Passes of NT window columns, one thread each.
    for (int j0 = 0; j0 < w; j0 += NT) {
      const int nc = min(NT, w - j0);
      for (int e = tid; e < nk * NT; e += NT) slab[e] = S(0.0);
      int o0 = 0, o1 = 0;
      if (tid < nc) {
        o0 = j0 ? off[j0 + tid] : so[tid];
        o1 = j0 ? off[j0 + tid + 1] : so[tid + 1];
      }
      if (o1 < o0) __trap();
      const bool filled = o1 > o0;
      const unsigned m = __ballot_sync(0xffffffffu, filled);
      if (lane == 0) wcnt[warp] = __popc(m);
      __syncthreads();
      int pos = __popc(m & ((1u << lane) - 1u)), n_ne = 0;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        pos += i < warp ? wcnt[i] : 0;
        n_ne += wcnt[i];
      }
      if (filled) {
        ccol[pos] = tid;
        cbeg[pos] = o0 - base;
        cend[pos] = o1 - base;
      }
      if (j0 == 0) {
        mbar_wait(bar + buf, (phase >> buf) & 1u);
        phase ^= 1u << buf;
      }
      __syncthreads();
      // (column, component) pairs, components fastest: a warp's lanes walk
      // few columns' rows, each in its own component's slice.  Each adds
      // its segment in CSR order starting from zero.
      for (int p = tid; p < nk * n_ne; p += NT) {
        const int c = p / nk, kk = p - c * nk;
        const S* v = comp + kk * L::SLICE;
        const int end = cend[c];
        S acc = S(0.0);
#pragma unroll 16
        for (int i = cbeg[c]; i < end; ++i) acc += v[lrow[i]];
        slab[kk * NT + ccol[c]] = acc;
      }
      __syncthreads();
      S* o = out + (static_cast<int64_t>(tile) * f + k0) * w + j0;
      for (int e = tid; e < nk * nc; e += NT) {
        const int kk = e / nc, j = e - kk * nc;
        o[static_cast<int64_t>(kk) * w + j] = slab[kk * NT + j];
      }
      __syncthreads();  // the slab, the column lists and the buffers are free
    }
  }
  cp_async_wait<0>();
}

constexpr int SC_CAMS = 128;  // cameras per block, one thread each
constexpr int SC_STAGES = 3;  // ring stages, each of TP tiles
constexpr int SC_LIST = 256;  // list entries staged per pass

// grid.x = ceil(n_seg / SC_CAMS) camera blocks, grid.y = ceil(f / KG)
// component groups.  Shared memory: the ring [SC_STAGES][TP][KG][SC_CAMS],
// then the pass's tiles and their starts [SC_LIST] each.
template <typename S, int TP, int KG>
__global__ void __launch_bounds__(SC_CAMS)
scatter_win_kernel(const S* __restrict__ part, const int* __restrict__ starts,
                   const int* __restrict__ blk_tiles, const int* __restrict__ blk_offsets,
                   int f, int w, int n_seg, S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ring = reinterpret_cast<S*>(smem_raw);
  int* lt = reinterpret_cast<int*>(ring + SC_STAGES * TP * KG * SC_CAMS);
  int* ls = lt + SC_LIST;
  constexpr int V = 16 / sizeof(S);       // values per 16-byte copy
  constexpr int PER = SC_CAMS / V;        // copies per component slice
  constexpr int PIECES = KG * PER;        // copies per tile
  constexpr int STAGE = TP * KG * SC_CAMS;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * SC_CAMS;
  const int c1 = c0 + SC_CAMS < n_seg ? c0 + SC_CAMS : n_seg;
  const int k0 = blockIdx.y * KG;
  const int nk = f - k0 < KG ? f - k0 : KG;
  const int c = c0 + tid;
  S acc[KG];
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) acc[kk] = S(0.0);
  const int beg = blk_offsets[blockIdx.x], end = blk_offsets[blockIdx.x + 1];
  for (int p0 = beg; p0 < end; p0 += SC_LIST) {
    const int n = end - p0 < SC_LIST ? end - p0 : SC_LIST;
    __syncthreads();  // the previous pass is done with the list and the ring
    for (int i = tid; i < n; i += SC_CAMS) {
      const int t = blk_tiles[p0 + i];
      const int s = starts[t];
      if (s >= c1 || s + w <= c0 || (s & 7)) __trap();
      lt[i] = t;
      ls[i] = s;
    }
    __syncthreads();
    const int n_st = (n + TP - 1) / TP;
    // Stage b: the slices of tiles [b * TP, min((b + 1) * TP, n)) into ring
    // slot b % SC_STAGES, closed as one group (empty past the last stage).
    auto issue = [&](int b) {
      if (b < n_st) {
        S* dst = ring + (b % SC_STAGES) * STAGE;
        const int q0 = b * TP, nq = n - q0 < TP ? n - q0 : TP;
        for (int e = tid; e < nq * PIECES; e += SC_CAMS) {
          const int qq = e / PIECES, kk = e % PIECES / PER, x = e % PER * V;
          const int s = ls[q0 + qq];
          if (kk < nk && x >= s - c0 && x < s + w - c0)
            cp_async16(dst + (qq * KG + kk) * SC_CAMS + x,
                       part + (static_cast<int64_t>(lt[q0 + qq]) * f + k0 + kk) * w + (c0 + x - s));
        }
      }
      cp_async_commit();
    };
    for (int b = 0; b < SC_STAGES - 1; ++b) issue(b);
    for (int b = 0; b < n_st; ++b) {
      cp_async_wait<SC_STAGES - 2>();
      __syncthreads();
      issue(b + SC_STAGES - 1);  // into the slot that stage b - 1 used
      const S* v = ring + (b % SC_STAGES) * STAGE + tid;
      const int q0 = b * TP, nq = n - q0 < TP ? n - q0 : TP;
      for (int qq = 0; qq < nq; ++qq) {
        const int j = c - ls[q0 + qq];
        if (c < c1 && j >= 0 && j < w) {
#pragma unroll
          for (int kk = 0; kk < KG; ++kk)
            if (kk < nk) acc[kk] += v[(qq * KG + kk) * SC_CAMS];
        }
      }
    }
    cp_async_wait<0>();
  }
  if (c < c1) {
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
      if (kk < nk) out[static_cast<int64_t>(k0 + kk) * n_seg + c] = acc[kk];
  }
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
int relin_win(int model, int gslot, const S* cam_mean, int n_cam, const S* lmk_mean,
              const int* gidx, const int* starts, int win_w, const S* z, const S* args,
              const S* lp, const S* jac, const S* r0, const S* srel, const S* act, S* olp,
              S* ojac, S* or0, S* osrel, int64_t mp, int deg, double beta, double min_linear,
              void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const int rc = launch_relin_win<S, false>(
      model, gslot, cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, args, lp, jac, r0, srel,
      act, olp, ojac, or0, osrel, mp, deg, beta, min_linear, static_cast<cudaStream_t>(stream),
      GhostTable<S>{});
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages_win(int da, int db, int zd, int gslot, int huber_row, const S* cam_tab,
                 int n_cam, const S* lmk_tab, const int* gidx, const int* starts, int win_w,
                 const S* jac, const S* lp, const S* r0,
                 const S* prec, const S* srel, const S* act, const S* me0, const S* ml0,
                 const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp,
                 int deg, double eta_damping, double lam_damping, double num_undamped,
                 double floor, double jitter, int has_huber, double huber, void* stream,
                 int* info) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  int rc = 0;
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    rc = launch_messages_win<S, decltype(sh)>(huber_row != 0, cam_tab, n_cam, lmk_tab, gidx,
                                              starts, win_w, o, mp, deg, p,
                                              static_cast<cudaStream_t>(stream), GhostTable<S>{},
                                              info);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// segsum_cm_blk's launch for n_tiles tiles of d-dof messages.  With `info`,
// no launch: {components per item (at most), items per tile, items, blocks,
// threads, shared bytes, registers and local bytes per thread, resident
// blocks per SM}.
template <typename S>
int segsum_blk(const S* me, const S* ml, int d, const int* rows, const int* offsets,
               int n_tiles, int w, int64_t mp, S* out, void* stream, int* info) {
  if (!info && (n_tiles <= 0 || w <= 0)) return static_cast<int>(cudaGetLastError());
  constexpr int KG = sb_comps<S>();
  const auto kernel = segsum_blk_kernel<S, KG>;
  constexpr size_t smem = SbSmem<S, KG>::BYTES;
  if (int rc = allow_smem(kernel, smem)) return rc;
  const int groups = (d + d * d + KG - 1) / KG;
  if (static_cast<int64_t>(n_tiles) * groups > 0x7fffffff) return -2;
  const int n_items = n_tiles * groups;
  int bps = 0;
  if (cudaError_t rc =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, SB_THREADS, smem))
    return static_cast<int>(rc);
  if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = min(n_items, bps * n_sms());
  if (info) {
    cudaFuncAttributes fa{};
    if (cudaError_t rc = cudaFuncGetAttributes(&fa, kernel)) return static_cast<int>(rc);
    const int v[9] = {KG, groups, n_items, blocks, SB_THREADS, static_cast<int>(smem),
                      fa.numRegs, static_cast<int>(fa.localSizeBytes), bps};
    for (int i = 0; i < 9; ++i) info[i] = v[i];
    return 0;
  }
  kernel<<<blocks, SB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      me, ml, d, rows, offsets, w, mp, groups, n_items, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int TP, int KG>
int launch_scatter(const S* part, const int* starts, const int* blk_tiles, const int* blk_offsets,
                   int f, int w, int n_seg, S* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(SC_STAGES) * TP * KG * SC_CAMS * sizeof(S) +
                      2 * static_cast<size_t>(SC_LIST) * sizeof(int);
  const auto kernel = scatter_win_kernel<S, TP, KG>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  const dim3 grid(static_cast<unsigned int>((n_seg + SC_CAMS - 1) / SC_CAMS),
                  static_cast<unsigned int>((f + KG - 1) / KG));
  kernel<<<grid, SC_CAMS, smem, st>>>(part, starts, blk_tiles, blk_offsets, f, w, n_seg, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one component and stages of 32 tiles while that makes fewer
// than eight blocks per SM (132 SMs), as at city; on wider scenes (venice)
// blocks of four components and stages of 4 tiles: fewer, longer blocks
// (the best of both shapes among the ones timed on the H100).  -2: w not a
// positive multiple of 8.
template <typename S>
int scatter_win(const S* part, const int* starts, const int* blk_tiles, const int* blk_offsets,
                int f, int w, int n_seg, S* out, void* stream) {
  if (n_seg <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  if (w <= 0 || w % 8) return -2;
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t n_blk = (n_seg + SC_CAMS - 1) / SC_CAMS;
  return f * n_blk < 8 * 132
             ? launch_scatter<S, 32, 1>(part, starts, blk_tiles, blk_offsets, f, w, n_seg, out, st)
             : launch_scatter<S, 4, 4>(part, starts, blk_tiles, blk_offsets, f, w, n_seg, out, st);
}

}  // namespace gbp

#define GBP_WINDOW_ENTRIES(SFX, S)                                                     \
  extern "C" int gbp_relin_cm_tabblk_ell_##SFX(                                        \
      int model, int gslot, const S* cam_mean, int n_cam, const S* lmk_mean,           \
      const int* gidx, const int* starts, int win_w, const S* z, const S* args,        \
      const S* lp, const S* jac, const S* r0, const S* srel, const S* act, S* olp,     \
      S* ojac, S* or0, S* osrel, int64_t mp, int deg, double beta, double min_linear,  \
      void* stream) {                                                                  \
    return gbp::relin_win<S>(model, gslot, cam_mean, n_cam, lmk_mean, gidx, starts,    \
                             win_w, z, args, lp, jac, r0, srel, act, olp, ojac, or0,   \
                             osrel, mp, deg, beta, min_linear, stream);                \
  }                                                                                    \
  extern "C" int gbp_messages_cm_tabblk_ell_##SFX(                                     \
      int da, int db, int zd, int gslot, int huber_row, const S* cam_tab, int n_cam,   \
      const S* lmk_tab, const int* gidx,                                               \
      const int* starts, int win_w, const S* jac, const S* lp, const S* r0,            \
      const S* prec, const S* srel, const S* act, const S* me0, const S* ml0,          \
      const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, \
      double eta_damping, double lam_damping, double num_undamped, double floor,       \
      double jitter, int has_huber, double huber, void* stream, int* info) {           \
    return gbp::messages_win<S>(da, db, zd, gslot, huber_row, cam_tab, n_cam, lmk_tab, \
                                gidx, starts, win_w, jac, lp, r0, prec, srel, act, me0, ml0, \
                                me1, ml1, oe0, ol0, oe1, ol1, mp, deg, eta_damping,    \
                                lam_damping, num_undamped, floor, jitter, has_huber,   \
                                huber, stream, info);                                  \
  }                                                                                    \
  extern "C" int gbp_segsum_cm_blk_##SFX(const S* me, const S* ml, int d,              \
                                         const int* rows, const int* offsets,          \
                                         int n_tiles, int w, int64_t mp, S* out,       \
                                         void* stream) {                               \
    return gbp::segsum_blk<S>(me, ml, d, rows, offsets, n_tiles, w, mp, out, stream,   \
                              nullptr);                                                \
  }                                                                                    \
  extern "C" int gbp_segsum_cm_blk_plan_##SFX(int d, int n_tiles, int* info) {         \
    return gbp::segsum_blk<S>(nullptr, nullptr, d, nullptr, nullptr, n_tiles, 1, 0,    \
                              nullptr, nullptr, info);                                 \
  }                                                                                    \
  extern "C" int gbp_scatter_windows_cm_##SFX(                                         \
      const S* part, const int* starts, const int* blk_tiles, const int* blk_offsets,  \
      int f, int w, int n_seg, S* out, void* stream) {                                 \
    return gbp::scatter_win<S>(part, starts, blk_tiles, blk_offsets, f, w, n_seg, out, \
                               stream);                                                \
  }                                                                                    \
  extern "C" int gbp_relin_cm_tabblk_ell_blocks_per_sm_##SFX(int win_w) {              \
    using M = gbp::ReprojectionNormalized;                                             \
    return gbp::blocks_per_sm(gbp::relin_win_kernel<S, M>,                             \
                              static_cast<size_t>(win_w) * M::DA * sizeof(S));         \
  }

GBP_WINDOW_ENTRIES(f32, float)
GBP_WINDOW_ENTRIES(f64, double)
