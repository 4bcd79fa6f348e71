// The deterministic segment sum of the camera side (and of the generic
// sweep's scatter lowering) for Hopper (sm_90a).  The wrapper and the plain
// version are in gbp_tpu_torch/ops/messages.py; kernels allocate nothing
// (the wrapper passes the chunk partials' buffer) and launch on the
// caller's stream; the C entry returns cudaGetLastError().
//
// segsum_by_id
//   Replaces gbp_tpu/ops/messages_pallas.py `segsum_cm` (`_kernel_segsum`):
//   the sums the unfused, rows, generic, halo-ghost and streaming paths
//   launch (the 5th output of `fused_messages_cm_tab_ell` is computed in
//   the messages launch, messages.cu, and only its stage 2,
//   segsum_combine_kernel in table_kernels.cuh, is shared):
//   out[k, s] = sum over i in [offsets[s],
//   offsets[s + 1]) of comp_k[rows[i]], comp = me | ml, f = d + d * d
//   components, component-major operands [f, m] in and [f, n_seg] out (the
//   fast path) or row-major [m, ld] in and [n_seg, f] out (the generic
//   sweep).
//   Bound: device-memory bytes, the f message components read once; the
//   CSR and the outputs are small beside them.
//   The TPU kernel walks row tiles in order into one resident accumulator;
//   blocks here run in no order, so the sum is cut into chunk partials and
//   a second pass, both in a fixed order.  Two forms, picked by the wrapper
//   (`segsum_form`, ops/messages.py) from the layout, m, n_seg and the CSR's
//   length: chunked for component-major operands when the dense partials
//   [n_chunk, f, n_seg] stay within 1/8 of the messages' bytes at one chunk
//   per SM or more and the CSR lists at least half the rows, short
//   otherwise.
//   Chunked (long segments: the unfused and rows paths' camera-side sums).
//     Stage 1, one block per chunk of C consecutive factor rows: the
//     chunk's slice of each component (C contiguous values) streams into a
//     ring of shared-memory stages by 16-byte cp.async, up to three
//     components ahead of the sums, so each message byte is read once,
//     coalesced, and no load waits on an add.  The CSR lists each
//     segment's rows ascending, so segment s's rows inside the chunk are
//     one run of its list; its ends are found by binary searches, up to
//     four per thread in lockstep.  The runs' local row offsets are staged
//     in shared memory once and serve all f components (the row index is
//     read once per chunk, not once per component).  A group of G lanes
//     sums one (component, segment) run: lane l adds entries l, l + G, ...
//     in order, then a fixed __shfl_down_sync tree (G is set for runs of
//     about 4 G entries; the fast path's CSRs list valid rows only, so no
//     clone rows pile onto one camera).  Every (component, segment) of
//     part[chunk] = [f, n_seg] is written, zero for an empty run.  The
//     operands are 16-byte aligned, and m and their leading strides are
//     multiples of 16 bytes of values (the wrapper raises otherwise).  What
//     remains above the bound: the searches' latency at each block's start
//     and the shared-memory gathers of the sums (random rows of the slice,
//     bank conflicts).
//     Stage 2, a second launch from the same entry: out[idx] = the sum over
//     chunks of part[chunk][idx], in 16 phases (phase y adds chunks y,
//     y + 16, ... in order, then the 16 phase sums in order), neighbouring
//     threads on neighbouring idx.
//   Short (row-major operands; more segments than the dense partials allow;
//   a CSR listing few of the rows: the generic sweep, the halo paths'
//   ghost rows): one warp per (segment, component), its lanes striding over
//   the segment's rows in CSR order, then the fixed __shfl_down_sync tree;
//   suits segments of tens of rows.  Row-major operands stay here: a
//   chunk's component column is strided, and copying it value by value
//   measured slower than this form at the generic bench64 shape.
//   No floating-point atomics in either form: two runs give the same bits.
#include "async_copy.cuh"
#include "table_kernels.cuh"

namespace gbp {

constexpr int SEG_THREADS = 256;  // stage 1: eight warps per chunk

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

constexpr int SEARCHES = 4;  // binary searches a thread runs in lockstep

// Stage 1 (component-major operands): block c sums the rows [c * chunk,
// min((c + 1) * chunk, m)) into part[c] = [f, n_seg].  Shared memory: the
// ring [NS][chunk], then run [n_seg + 1] (each run's bounds in loc), first
// [n_seg] (each run's first CSR position), scan [SEG_THREADS], loc [chunk]
// (local row offsets, run after run).
template <typename S, int NS>
__global__ void __launch_bounds__(SEG_THREADS)
segsum_chunk_kernel(const S* __restrict__ me, int64_t me_ld, const S* __restrict__ ml,
                    int64_t ml_ld, int d, const int* __restrict__ rows,
                    const int* __restrict__ offsets, int n_seg, int64_t m, int chunk, int group,
                    S* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ring = reinterpret_cast<S*>(smem_raw);
  int* run = reinterpret_cast<int*>(ring + NS * chunk);
  int* first = run + n_seg + 1;
  int* scan = first + n_seg;
  unsigned short* loc = reinterpret_cast<unsigned short*>(scan + SEG_THREADS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = d + d * d;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int cn = static_cast<int>(m - c0 < chunk ? m - c0 : chunk);

  // Component k's slice of the chunk into stage k % NS by 16-byte copies
  // (cn is a multiple of V), closed as one group (an empty group past the
  // last component keeps the count even).
  auto issue = [&](int k) {
    if (k < f) {
      constexpr int V = 16 / sizeof(S);
      S* dst = ring + (k % NS) * chunk;
      const S* src = k < d ? me : ml;
      const int64_t ld = k < d ? me_ld : ml_ld;
      const S* base = src + (k < d ? k : k - d) * ld + c0;
      for (int i = tid; i < cn / V; i += SEG_THREADS) cp_async16(dst + i * V, base + i * V);
    }
    cp_async_commit();
  };
  for (int k = 0; k < NS - 1; ++k) issue(k);

  // Segment s's run: CSR positions [first[s], first[s] + length) whose rows
  // lie in the chunk.  Search i finds the first position of segment i / 2
  // whose row is at least c0 (i even) or c0 + cn (i odd), the rows
  // ascending there; a thread runs up to SEARCHES of them in lockstep, so
  // their loads are in flight together.  run[s + 1] holds the length for
  // now.
  for (int i0 = tid; i0 < 2 * n_seg; i0 += SEARCHES * SEG_THREADS) {
    int lo[SEARCHES], hi[SEARCHES];
    int64_t key[SEARCHES];
#pragma unroll
    for (int u = 0; u < SEARCHES; ++u) {
      const int i = i0 + u * SEG_THREADS;
      const int s = i >> 1;
      lo[u] = i < 2 * n_seg ? offsets[s] : 0;
      hi[u] = i < 2 * n_seg ? offsets[s + 1] : 0;
      key[u] = (i & 1) ? c0 + cn : c0;
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int u = 0; u < SEARCHES; ++u) {
        if (lo[u] < hi[u]) {
          const int mid = lo[u] + ((hi[u] - lo[u]) >> 1);
          if (rows[mid] < key[u]) {
            lo[u] = mid + 1;
          } else {
            hi[u] = mid;
          }
          more = more || lo[u] < hi[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SEARCHES; ++u) {
      const int i = i0 + u * SEG_THREADS;
      if (i < 2 * n_seg) {
        if (i & 1) {
          run[(i >> 1) + 1] = lo[u];
        } else {
          first[i >> 1] = lo[u];
        }
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < n_seg; s += SEG_THREADS) run[s + 1] -= first[s];
  __syncthreads();
  // run[s] = the lengths before s: every thread adds `per` consecutive
  // lengths, a Hillis-Steele scan of the threads' totals gives each its
  // offset, and the thread rewrites its lengths as running ends.
  const int per = (n_seg + SEG_THREADS - 1) / SEG_THREADS;
  const int s0 = tid * per < n_seg ? tid * per : n_seg;
  const int s1 = s0 + per < n_seg ? s0 + per : n_seg;
  int total = 0;
  for (int s = s0; s < s1; ++s) total += run[s + 1];
  scan[tid] = total;
  __syncthreads();
  for (int o = 1; o < SEG_THREADS; o <<= 1) {
    const int add = tid >= o ? scan[tid - o] : 0;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  int end = scan[tid] - total;
  for (int s = s0; s < s1; ++s) {
    end += run[s + 1];
    run[s + 1] = end;
  }
  if (tid == 0) run[0] = 0;
  __syncthreads();
  // The runs' local row offsets, one warp per segment.
  for (int s = warp; s < n_seg; s += SEG_THREADS / 32) {
    const int o = run[s], n = run[s + 1] - o, p = first[s];
    for (int j = lane; j < n; j += 32) loc[o + j] = static_cast<unsigned short>(rows[p + j] - c0);
  }
  // Groups of `group` lanes (a power of two up to 32), one (component,
  // segment) run each; the segment loop is uniform across a warp, so every
  // lane reaches the shuffles.
  const int per_warp = 32 / group;
  const int gi = lane / group, li = lane % group;
  S* out = part + static_cast<int64_t>(blockIdx.x) * f * n_seg;
  for (int k = 0; k < f; ++k) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(k + NS - 1);  // into the stage that component k - 1 used
    const S* v = ring + (k % NS) * chunk;
    for (int sb = warp * per_warp; sb < n_seg; sb += SEG_THREADS / 32 * per_warp) {
      const int s = sb + gi;
      const int o = s < n_seg ? run[s] : 0;
      const int n = s < n_seg ? run[s + 1] - o : 0;
      S acc = S(0.0);
      for (int j = li; j < n; j += group) acc += v[loc[o + j]];
      for (int off = group >> 1; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off, group);
      if (li == 0 && s < n_seg) out[static_cast<int64_t>(k) * n_seg + s] = acc;
    }
  }
}

template <typename S, int NS>
int launch_chunked(const S* me, int64_t me_ld, const S* ml, int64_t ml_ld, int d,
                   const int* rows, const int* offsets, int n_seg, int64_t m, int chunk,
                   int group, S* part, S* out, cudaStream_t st) {
  const int f = d + d * d;
  const int n_chunk = static_cast<int>((m + chunk - 1) / chunk);
  const size_t smem = static_cast<size_t>(NS) * chunk * sizeof(S) +
                      (2 * static_cast<size_t>(n_seg) + 1 + SEG_THREADS) * sizeof(int) +
                      static_cast<size_t>(chunk) * sizeof(unsigned short);
  const auto kernel = segsum_chunk_kernel<S, NS>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<n_chunk, SEG_THREADS, smem, st>>>(me, me_ld, ml, ml_ld, d, rows, offsets, n_seg, m,
                                             chunk, group, part);
  if (const cudaError_t rc = cudaGetLastError()) return static_cast<int>(rc);
  launch_combine(part, n_chunk, static_cast<int64_t>(f) * n_seg, out, st);
  return static_cast<int>(cudaGetLastError());
}

// chunk == 0: the short form; else the chunked form (component-major only,
// operands 16-byte aligned, m and the leading strides multiples of V) with
// `chunk` rows per block (a power of two, 256 to 8192, at least 8 * n_seg)
// and `group` lanes per run (a power of two up to 32); part
// holds ceil(m / chunk) * f * n_seg values.  A ring of four stages keeps
// up to four blocks of 256 threads on an SM at the fast path's chunks
// (more stages cost blocks per SM, measured); three where four would pass
// 128 KB.  -2: arguments out of range.
template <typename S>
int segsum(const S* me, int64_t me_ld, const S* ml, int64_t ml_ld, int d, int rm,
           const int* rows, const int* offsets, int n_seg, int64_t m, int chunk, int group,
           S* part, S* out, void* stream) {
  const int f = d + d * d;
  const auto st = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(n_seg) * f <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk) {
    constexpr int V = 16 / sizeof(S);
    const bool pow2 = (chunk & (chunk - 1)) == 0 && (group & (group - 1)) == 0;
    const bool aligned = reinterpret_cast<uintptr_t>(me) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(ml) % 16 == 0 && me_ld % V == 0 &&
                         ml_ld % V == 0 && m % V == 0;
    if (rm || !pow2 || !aligned || chunk < 256 || chunk > 8192 ||
        8 * static_cast<int64_t>(n_seg) > chunk || group < 1 || group > 32 || m <= 0)
      return -2;
    return 4 * static_cast<size_t>(chunk) * sizeof(S) <= 128 * 1024
               ? launch_chunked<S, 4>(me, me_ld, ml, ml_ld, d, rows, offsets, n_seg, m, chunk,
                                      group, part, out, st)
               : launch_chunked<S, 3>(me, me_ld, ml, ml_ld, d, rows, offsets, n_seg, m, chunk,
                                      group, part, out, st);
  }
  const int64_t threads = static_cast<int64_t>(n_seg) * f * 32;
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

#define GBP_SEGSUM_ENTRY(SFX, S)                                                           \
  extern "C" int gbp_segsum_by_id_##SFX(const S* me, int64_t me_ld, const S* ml,           \
                                        int64_t ml_ld, int d, int rm, const int* rows,     \
                                        const int* offsets, int n_seg, int64_t m, int chunk, \
                                        int group, S* part, S* out, void* stream) {        \
    return gbp::segsum<S>(me, me_ld, ml, ml_ld, d, rm, rows, offsets, n_seg, m, chunk,     \
                          group, part, out, stream);                                       \
  }

GBP_SEGSUM_ENTRY(f32, float)
GBP_SEGSUM_ENTRY(f64, double)
