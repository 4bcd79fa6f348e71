// The expanded-operand kernels' templates (see rows.cu): the kernels, the
// operand bundle of one launch and the per-shape dispatcher, shared by
// rows.cu and the sources that instantiate the pose shapes and the 9-dof
// BAL camera.
//
// Component-major operands [F, mp] (the fast path's "rows" / "take1" modes)
// are read where they lie: thread r loads component k of its row at
// k * ld + r, and a warp's load is one coalesced span.  Row-major operands
// [m, F] (the generic engine) would have each thread walk its own row, a
// warp's load touching 32 sectors for 4 useful bytes in each; so the
// row-major kernels stage a tile of R rows per block through shared memory:
//   stage in   a tile that is one contiguous span (a full tile of a
//              contiguous operand) moves by one 1-D bulk copy that thread 0
//              issues (the Tensor Memory Accelerator, completing on an
//              mbarrier); any other (the generic sweep's belief views, with
//              leading strides 48 and 15 and lam 24 bytes into the row; the
//              last, partial tile) by cp.async of one element per thread,
//              consecutive threads on consecutive elements, so every warp's
//              load is coalesced along the rows;
//   compute    thread r runs the unchanged relin_core / messages_core on
//              pointers to its own rows of the tiles (SmemRow), writing the
//              four outputs into tiles of their own;
//   stage out  after a barrier, each output's tile, one contiguous span of
//              n * w values of the fresh [m, w] output, leaves by one bulk
//              copy (a partial tile by 16-byte vector stores).
// An element-copied tile's row pitch is its width rounded up to an odd
// number of elements, so that the threads of a warp reading component k of
// their own rows meet in no bank; a bulk-copied tile keeps the operand's
// own pitch (an even width then costs 2- to 4-way conflicts, cheaper than
// the per-element copies).  R is fixed per shape and dtype at compile time:
// the most of 128, 64 and 32 rows whose tiles (inputs and outputs) leave
// room for two blocks on an SM.  Messages: (6, 3, 2) 128 rows in float32
// (104,448 bytes of tiles) and 64 in float64, (1, 1, 1) and (3, 3, 3) 128,
// (6, 6, 6) and (9, 3, 2) 64 in float32 and 32 in float64.
// Relinearization: 128 rows (39,424 bytes for `reprojection_normalized` in
// float32), SE(3) in float64 64.  The outputs are bit for bit those of the
// component-major kernels on the transposed operands (the same arithmetic
// in the same order).
#pragma once
#include <stdint.h>

#include <utility>

#include "async_copy.cuh"
#include "messages_rows.cuh"

namespace gbp {

constexpr int N_MSG_IN = 14;   // jac lp r0 prec srel act be0 bl0 be1 bl1 me0 ml0 me1 ml1
constexpr int N_RELIN_IN = 8;  // x z lp jac r0 srel act args
constexpr int N_OUT = 4;

// The operands of one launch as the C entries receive them: base pointers
// and leading strides, inputs in the order above, then the four outputs.
template <typename S, int N>
struct RowArgs {
  const S* in[N];
  int64_t in_ld[N];
  S* out[N_OUT];
  int64_t out_ld[N_OUT];
};

template <typename S, int N>
inline RowArgs<S, N> row_args(const void* const* in, const int64_t* in_ld, void* const* out,
                              const int64_t* out_ld) {
  RowArgs<S, N> a;
  for (int i = 0; i < N; ++i) {
    a.in[i] = static_cast<const S*>(in[i]);
    a.in_ld[i] = in_ld[i];
  }
  for (int i = 0; i < N_OUT; ++i) {
    a.out[i] = static_cast<S*>(out[i]);
    a.out_ld[i] = out_ld[i];
  }
  return a;
}

// --- component-major: operands read in place ----------------------------------------

template <typename S, int DA, int DB, int ZD, bool PREC_FULL, bool HUBER_ROW>
__global__ void __launch_bounds__(BLOCK)
messages_cm_kernel(RowArgs<S, N_MSG_IN> a, int64_t m, MsgParams<S> p) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const ExpandedBelief<S, DA, ColMajor> b0{a.in[6], a.in[7], a.in_ld[6], a.in_ld[7], r};
  const ExpandedBelief<S, DB, ColMajor> b1{a.in[8], a.in[9], a.in_ld[8], a.in_ld[9], r};
  // Strides in MsgOp order: the six state operands, the four old messages,
  // the four outputs.
  const OpLds<N_MSG_OPS> ld{{a.in_ld[0], a.in_ld[1], a.in_ld[2], a.in_ld[3], a.in_ld[4],
                            a.in_ld[5], a.in_ld[10], a.in_ld[11], a.in_ld[12], a.in_ld[13],
                            a.out_ld[0], a.out_ld[1], a.out_ld[2], a.out_ld[3]}};
  messages_core<S, DA, DB, ZD, ColMajor, PREC_FULL, HUBER_ROW>(
      b0, b1, a.in[0], a.in[1], a.in[2], a.in[3], a.in[4], a.in[5], a.in[10], a.in[11],
      a.in[12], a.in[13], a.out[0], a.out[1], a.out[2], a.out[3], ld, r, p);
}

template <typename S, class M>
__global__ void __launch_bounds__(BLOCK)
relin_cm_kernel(RowArgs<S, N_RELIN_IN> a, int64_t m, S beta, S min_linear) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  constexpr int TD = M::DA + M::DB;
  S x[TD];
#pragma unroll
  for (int i = 0; i < TD; ++i) x[i] = a.in[0][ColMajor::at(i, r, a.in_ld[0])];
  // Strides in RelinOp order: z lp jac r0 srel act args, then the four
  // outputs.
  const OpLds<N_RELIN_OPS> ld{{a.in_ld[1], a.in_ld[2], a.in_ld[3], a.in_ld[4], a.in_ld[5],
                              a.in_ld[6], a.in_ld[7], a.out_ld[0], a.out_ld[1], a.out_ld[2],
                              a.out_ld[3]}};
  relin_core<S, M, ColMajor>(x, a.in[1], a.in[7], a.in[2], a.in[3], a.in[4], a.in[5], a.in[6],
                             a.out[0], a.out[1], a.out[2], a.out[3], ld, r, beta, min_linear);
}

// --- row-major: operands staged through shared-memory tiles -----------------------------

// Shared memory of one SM on sm_90 and the part the runtime keeps per block.
constexpr int SMEM_PER_SM = 233472;
constexpr int SMEM_RESERVED_PER_BLOCK = 1024;

template <int... W>
__host__ __device__ constexpr int pack_at(int i) {
  constexpr int w[] = {W...};
  return w[i];
}
// An odd pitch (0 for an operand of no components, which is not staged).
__host__ __device__ constexpr int tile_pitch(int w) { return w == 0 ? 0 : (w | 1); }
template <int... W>
__host__ __device__ constexpr int pitch_sum(int n) {
  int s = 0;
  for (int i = 0; i < n; ++i) s += tile_pitch(pack_at<W...>(i));
  return s;
}
// The most of 128, 64 and 32 rows per block that leave room for two blocks
// per SM.
__host__ __device__ constexpr int tile_rows(int row_bytes) {
  constexpr int half = SMEM_PER_SM / 2 - SMEM_RESERVED_PER_BLOCK;
  return 128 * row_bytes <= half ? 128 : 64 * row_bytes <= half ? 64 : 32;
}

// The tiles of one row-major kernel: NIN inputs, then N_OUT outputs, of
// widths W (in that order); operand i's tile starts at offset(i) elements.
template <typename S, int NIN, int... W>
struct RowTile {
  static_assert(sizeof...(W) == NIN + N_OUT, "one width per operand");
  static constexpr int N_IN = NIN;
  static constexpr int ROW = pitch_sum<W...>(NIN + N_OUT);  // staged elements per row
  static constexpr int R = tile_rows(ROW * static_cast<int>(sizeof(S)));
  static constexpr size_t SMEM = static_cast<size_t>(R) * ROW * sizeof(S);
  __host__ __device__ static constexpr int width(int i) { return pack_at<W...>(i); }
  __host__ __device__ static constexpr int pitch(int i) { return tile_pitch(width(i)); }
  __host__ __device__ static constexpr int offset(int i) { return R * pitch_sum<W...>(i); }
};

template <typename S, int DA, int DB, int ZD, bool PREC_FULL, bool HUBER_ROW>
using MsgTile = RowTile<S, N_MSG_IN, ZD * (DA + DB), DA + DB, ZD,
                        (PREC_FULL ? ZD * ZD : ZD) + (HUBER_ROW ? 1 : 0), 1, 1, DA, DA * DA, DB,
                        DB * DB, DA, DA * DA, DB, DB * DB, DA, DA * DA, DB, DB * DB>;
template <typename S, class M>
using RelinTile = RowTile<S, N_RELIN_IN, M::DA + M::DB, M::ZD, M::DA + M::DB,
                          M::ZD * (M::DA + M::DB), M::ZD, 1, 1, M::NA, M::DA + M::DB,
                          M::ZD * (M::DA + M::DB), M::ZD, 1>;

// Operand I moves by one bulk copy when its tile is one contiguous span of
// whole 16-byte units at a 16-byte boundary: a full tile of a contiguous
// operand (ld == w).  Its tile then keeps the operand's own row pitch w;
// otherwise the odd pitch.
template <class T, int I, typename S>
__device__ __forceinline__ bool bulk_ok(const S* p, int64_t ld, int64_t r0, int n) {
  constexpr int W = T::width(I);
  return W > 0 && ld == W && (n * W * static_cast<int>(sizeof(S))) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p + r0 * W) % 16 == 0;
}

// Bit I set: operand I (inputs, then the outputs at N_IN + j) moves by bulk
// copies.
template <class T, typename S, int N, size_t... I, size_t... J>
__device__ __forceinline__ unsigned bulk_mask(const RowArgs<S, N>& a, int64_t r0, int n,
                                              std::index_sequence<I...>,
                                              std::index_sequence<J...>) {
  unsigned mask = 0;
  ((mask |= bulk_ok<T, static_cast<int>(I)>(a.in[I], a.in_ld[I], r0, n) ? 1u << I : 0u), ...);
  ((mask |= bulk_ok<T, T::N_IN + static_cast<int>(J)>(a.out[J], a.out_ld[J], r0, n)
                ? 1u << (T::N_IN + J)
                : 0u),
   ...);
  return mask;
}

// This thread's row of operand I's tile.
template <class T, int I, typename S>
__device__ __forceinline__ S* row_of(S* tile, unsigned mask) {
  const int pitch = (mask >> I & 1u) ? T::width(I) : T::pitch(I);
  return tile + T::offset(I) + static_cast<int>(threadIdx.x) * pitch;
}

// Input I's tile, rows [r0, r0 + n) of the operand at `src` (leading
// stride ld), when it does not move in bulk: one cp.async per element,
// consecutive threads on consecutive elements.
template <class T, int I, typename S>
__device__ __forceinline__ void stage_in_op(S* tile, const S* __restrict__ src, int64_t ld,
                                            int64_t r0, int n) {
  constexpr int W = T::width(I), PW = T::pitch(I), OFF = T::offset(I);
  if constexpr (W > 0) {
    const S* base = src + r0 * ld;
    for (int e = threadIdx.x; e < n * W; e += T::R) {
      const int row = e / W, col = e - row * W;
      cp_async_elem(tile + OFF + row * PW + col, base + row * ld + col);
    }
  }
}

// Every input's tile: thread 0 issues the bulk copies, all threads the
// element copies; returns once all have landed.
template <class T, typename S, int N, size_t... I>
__device__ __forceinline__ void stage_in(S* tile, unsigned long long* bar, unsigned mask,
                                         const RowArgs<S, N>& a, int64_t r0, int n,
                                         std::index_sequence<I...>) {
  constexpr unsigned in_bits = (1u << N) - 1u;
  const bool lead = threadIdx.x == 0;
  if (mask & in_bits) {
    if (lead) mbar_init(bar, 1);
    __syncthreads();
    if (lead) {
      unsigned bytes = 0;
      ((bytes += (mask >> I & 1u) ? n * T::width(I) * static_cast<unsigned>(sizeof(S)) : 0u),
       ...);
      mbar_arrive_expect_tx(bar, bytes);
      ((mask >> I & 1u ? bulk_load(tile + T::offset(I), a.in[I] + r0 * T::width(I),
                                   n * T::width(I) * static_cast<unsigned>(sizeof(S)), bar)
                       : void()),
       ...);
    }
  }
  ((mask >> I & 1u ? void()
                   : stage_in_op<T, static_cast<int>(I)>(tile, a.in[I], a.in_ld[I], r0, n)),
   ...);
  cp_async_commit();
  cp_async_wait<0>();
  if (mask & in_bits) mbar_wait(bar, 0);
  __syncthreads();
}

__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&x)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

// Output J's tile (odd pitch) to rows [r0, r0 + n) of its contiguous
// [m, w] tensor, when it does not move in bulk: one span of n * w values by
// 16-byte stores (the span starts 16-byte aligned: r0 is a multiple of R
// and the C entries check the base), the last n * w mod V values one by
// one.
template <class T, int J, typename S>
__device__ __forceinline__ void store_out_op(const S* tile, S* __restrict__ out, int64_t r0,
                                             int n) {
  constexpr int I = T::N_IN + J;
  constexpr int W = T::width(I), PW = T::pitch(I), OFF = T::offset(I);
  constexpr int V = 16 / static_cast<int>(sizeof(S));
  S* dst = out + r0 * W;
  const int count = n * W, nv = count / V;
  for (int v = threadIdx.x; v < nv; v += T::R) {
    S x[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int e = v * V + q, row = e / W;
      x[q] = tile[OFF + row * PW + e - row * W];
    }
    store16(dst + v * V, x);
  }
  for (int e = nv * V + threadIdx.x; e < count; e += T::R) {
    const int row = e / W;
    dst[e] = tile[OFF + row * PW + e - row * W];
  }
}

// Every output's tile: after a barrier thread 0 issues the bulk copies and
// waits until they have read the tiles, all threads store the others.
template <class T, typename S, int N, size_t... J>
__device__ __forceinline__ void store_out(const S* tile, unsigned mask, const RowArgs<S, N>& a,
                                          int64_t r0, int n, std::index_sequence<J...>) {
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0 && (mask >> T::N_IN)) {
    ((mask >> (T::N_IN + J) & 1u
          ? bulk_store(a.out[J] + r0 * T::width(T::N_IN + J), tile + T::offset(T::N_IN + J),
                       n * T::width(T::N_IN + J) * static_cast<unsigned>(sizeof(S)))
          : void()),
     ...);
    bulk_wait_read();
  }
  ((mask >> (T::N_IN + J) & 1u ? void()
                               : store_out_op<T, static_cast<int>(J)>(tile, a.out[J], r0, n)),
   ...);
}

// The staged kernels' launch bounds name one block per SM: given the block
// size alone, ptxas trades registers for blocks per SM and spills at
// (3, 3, 3) and (1, 1, 1), where shared memory bounds the blocks anyway.

// Rows past m are neither loaded, computed nor stored.
template <class T>
__device__ __forceinline__ int tile_count(int64_t m, int64_t r0) {
  return m - r0 < T::R ? static_cast<int>(m - r0) : T::R;
}

template <typename S, int DA, int DB, int ZD, bool PREC_FULL, bool HUBER_ROW>
__global__ void __launch_bounds__(MsgTile<S, DA, DB, ZD, PREC_FULL, HUBER_ROW>::R, 1)
messages_staged_kernel(RowArgs<S, N_MSG_IN> a, int64_t m, MsgParams<S> p) {
  using T = MsgTile<S, DA, DB, ZD, PREC_FULL, HUBER_ROW>;
  extern __shared__ __align__(16) unsigned char tile_bytes[];
  __shared__ unsigned long long bar;
  S* tile = reinterpret_cast<S*>(tile_bytes);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * T::R;
  const int n = tile_count<T>(m, r0);
  const unsigned mask = bulk_mask<T>(a, r0, n, std::make_index_sequence<N_MSG_IN>{},
                                     std::make_index_sequence<N_OUT>{});
  stage_in<T>(tile, &bar, mask, a, r0, n, std::make_index_sequence<N_MSG_IN>{});
  if (static_cast<int>(threadIdx.x) < n) {
    const ExpandedBelief<S, DA, SmemRow> b0{row_of<T, 6>(tile, mask), row_of<T, 7>(tile, mask),
                                            0, 0, 0};
    const ExpandedBelief<S, DB, SmemRow> b1{row_of<T, 8>(tile, mask), row_of<T, 9>(tile, mask),
                                            0, 0, 0};
    messages_core<S, DA, DB, ZD, SmemRow, PREC_FULL, HUBER_ROW>(
        b0, b1, row_of<T, 0>(tile, mask), row_of<T, 1>(tile, mask), row_of<T, 2>(tile, mask),
        row_of<T, 3>(tile, mask), row_of<T, 4>(tile, mask), row_of<T, 5>(tile, mask),
        row_of<T, 10>(tile, mask), row_of<T, 11>(tile, mask), row_of<T, 12>(tile, mask),
        row_of<T, 13>(tile, mask), row_of<T, 14>(tile, mask), row_of<T, 15>(tile, mask),
        row_of<T, 16>(tile, mask), row_of<T, 17>(tile, mask), UniformLd{0}, 0, p);
  }
  store_out<T>(tile, mask, a, r0, n, std::make_index_sequence<N_OUT>{});
}

template <typename S, class M>
__global__ void __launch_bounds__(RelinTile<S, M>::R, 1)
relin_staged_kernel(RowArgs<S, N_RELIN_IN> a, int64_t m, S beta, S min_linear) {
  using T = RelinTile<S, M>;
  constexpr int TD = M::DA + M::DB;
  extern __shared__ __align__(16) unsigned char tile_bytes[];
  __shared__ unsigned long long bar;
  S* tile = reinterpret_cast<S*>(tile_bytes);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * T::R;
  const int n = tile_count<T>(m, r0);
  const unsigned mask = bulk_mask<T>(a, r0, n, std::make_index_sequence<N_RELIN_IN>{},
                                     std::make_index_sequence<N_OUT>{});
  stage_in<T>(tile, &bar, mask, a, r0, n, std::make_index_sequence<N_RELIN_IN>{});
  if (static_cast<int>(threadIdx.x) < n) {
    const S* xr = row_of<T, 0>(tile, mask);
    S x[TD];
#pragma unroll
    for (int i = 0; i < TD; ++i) x[i] = xr[i];
    relin_core<S, M, SmemRow>(
        x, row_of<T, 1>(tile, mask), row_of<T, 7>(tile, mask), row_of<T, 2>(tile, mask),
        row_of<T, 3>(tile, mask), row_of<T, 4>(tile, mask), row_of<T, 5>(tile, mask),
        row_of<T, 6>(tile, mask), row_of<T, 8>(tile, mask), row_of<T, 9>(tile, mask),
        row_of<T, 10>(tile, mask), row_of<T, 11>(tile, mask), UniformLd{0}, 0, beta,
        min_linear);
  }
  store_out<T>(tile, mask, a, r0, n, std::make_index_sequence<N_OUT>{});
}

// The dynamic shared memory of kernel K (tiles T), allowed once per
// instantiation (the process drives one card).
template <class T, class K>
int allow_tile_smem(K kernel) {
  static const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  return static_cast<int>(rc);
}

// -3: an output that is not a contiguous, 16-byte aligned [m, w] tensor.
template <class T, typename S, int N>
int check_staged_outputs(const RowArgs<S, N>& a) {
  for (int j = 0; j < N_OUT; ++j) {
    if (a.out_ld[j] != T::width(T::N_IN + j) || reinterpret_cast<uintptr_t>(a.out[j]) % 16)
      return -3;
  }
  return 0;
}

template <class T, class K, class... A>
int launch_staged(K kernel, int64_t m, cudaStream_t stream, const A&... args) {
  if (int rc = allow_tile_smem<T>(kernel)) return rc;
  const auto grid = static_cast<unsigned int>((m + T::R - 1) / T::R);
  kernel<<<grid, T::R, T::SMEM, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a staged kernel: rows per block, shared bytes per
// block, registers per thread, local-memory bytes per thread, resident
// blocks per SM.
template <class T, class K>
int staged_info(K kernel, int* info) {
  if (int rc = allow_tile_smem<T>(kernel)) return rc;
  cudaFuncAttributes fa{};
  cudaError_t rc = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T::R, T::SMEM);
  info[0] = T::R;
  info[1] = static_cast<int>(T::SMEM);
  info[2] = fa.numRegs;
  info[3] = static_cast<int>(fa.localSizeBytes);
  info[4] = blocks;
  return static_cast<int>(rc);
}

template <typename S, int DA, int DB, int ZD, bool PREC_FULL, bool HUBER_ROW>
int launch_messages_as(bool rm, const RowArgs<S, N_MSG_IN>& a, int64_t m,
                       const MsgParams<S>& p, cudaStream_t stream, int* info) {
  if (!rm) {
    if (info) return -2;
    messages_cm_kernel<S, DA, DB, ZD, PREC_FULL, HUBER_ROW>
        <<<n_blocks(m), BLOCK, 0, stream>>>(a, m, p);
    return static_cast<int>(cudaGetLastError());
  }
  using T = MsgTile<S, DA, DB, ZD, PREC_FULL, HUBER_ROW>;
  const auto kernel = messages_staged_kernel<S, DA, DB, ZD, PREC_FULL, HUBER_ROW>;
  if (info) return staged_info<T>(kernel, info);
  if (int rc = check_staged_outputs<T>(a)) return rc;
  return launch_staged<T>(kernel, m, stream, a, m, p);
}

// The messages kernel of one shape in one layout (rm: row-major, staged),
// or, given `info`, the staged kernel's figures (staged_info) and no launch.
template <typename S, int DA, int DB, int ZD>
int dispatch_messages(bool rm, bool prec_full, bool huber_row, const RowArgs<S, N_MSG_IN>& a,
                      int64_t m, const MsgParams<S>& p, cudaStream_t stream, int* info) {
  if (huber_row) {
    // Per-row thresholds go with diagonal precision only (the engine never
    // pairs them with a full one), so that pair is not instantiated.
    if (prec_full) return -2;
    return launch_messages_as<S, DA, DB, ZD, false, true>(rm, a, m, p, stream, info);
  }
  return prec_full ? launch_messages_as<S, DA, DB, ZD, true, false>(rm, a, m, p, stream, info)
                   : launch_messages_as<S, DA, DB, ZD, false, false>(rm, a, m, p, stream, info);
}

// The pose shapes' and the 9-dof BAL camera's dispatchers are compiled in
// sources of their own.
#define GBP_EXTERN_DISPATCH(S, DA, DB, ZD)                                                    \
  extern template int dispatch_messages<S, DA, DB, ZD>(                                       \
      bool, bool, bool, const RowArgs<S, N_MSG_IN>&, int64_t, const MsgParams<S>&,            \
      cudaStream_t, int*);
GBP_EXTERN_DISPATCH(float, 3, 3, 3)
GBP_EXTERN_DISPATCH(double, 3, 3, 3)
GBP_EXTERN_DISPATCH(float, 6, 6, 6)
GBP_EXTERN_DISPATCH(double, 6, 6, 6)
GBP_EXTERN_DISPATCH(float, 9, 3, 2)
GBP_EXTERN_DISPATCH(double, 9, 3, 2)
#undef GBP_EXTERN_DISPATCH

}  // namespace gbp
