// The belief update that ends a fast-path sweep (core/sweep_cm.py
// `_update_beliefs`) on a graph whose two slots lie on two variable blocks:
// beliefs = priors + the sums of the new messages, the means by the
// Jacobi-scaled closed-form solve of utils/smalllinalg.py
// (`scaled_sym_solve`).  The port's own kernel: the TPU reference does this
// in XLA between its Pallas calls.  The wrapper and plain version are
// `ops.messages.update_beliefs` / `update_beliefs_plain`.
//
// beliefs_kernel
//   One launch for both variable blocks.  Its first blocks take the
//   gathered slot's variables (cameras), whose message sums the messages
//   launch already returned ([d + d * d, n], a column a variable); the
//   others take the ELL slot's (landmarks), whose sums run here over each
//   variable's `deg` consecutive rows of the new messages [d, mp] and
//   [d * d, mp].  The gathered side is the ELL side at degree 1.
//   Bound: device-memory bytes.  Every ELL message component is read once,
//   the priors read and the beliefs written once (about 400 MB a sweep at
//   venice1778, 30 MB at bench64), against a few hundred flops a variable.
//   Design: a block owns `vars` consecutive variables of one side (their
//   groups of ELL rows are one contiguous span of each component).
//   (1) It issues cp.async copies of their priors and of its span of every
//   message component (about 768 rows, 36 KB at degree 6 or 64 in
//   float32) into shared memory, all in flight at once: the bytes in
//   flight are the staged rows of every resident block, not registers.
//   Where even one variable's rows exceed the shared memory (a degree of
//   thousands), the rows are read in place instead.  (2) For each
//   (component, variable) pair, L lanes read that variable's rows, L the
//   least power of two that leaves a lane at most 8 rows (a thread a pair
//   at degree 6, 8 lanes at degree 64: few shuffles a row, which bound this
//   step's instructions); each lane adds its rows l, l + L, ... in order,
//   the L lanes add their partials by an xor-shuffle tree, and the sum is
//   added onto the prior in shared memory.  (3) One thread a variable
//   solves from shared memory in the closed forms and the operation order
//   of smalllinalg.py (built with -fmad=false, so every product and sum
//   rounds as there; the CUDA reductions behind the plain version's small
//   sums may add in another order).  (4) The block writes eta, lam and mean
//   back as contiguous spans.  A fixed order throughout and no atomics:
//   reruns give the same bits.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "comp_linalg.cuh"

namespace gbp {

constexpr int BELIEF_THREADS = 128;
// Message rows a block of the ELL side aims at (36 KB staged in float32 at
// 12 components: 5 blocks an SM; 384 rows ran slower at degrees 6 and 64),
// and the shared memory a block may take (the default limit: no opt-in).
constexpr int BELIEF_ROWS = 768;
constexpr int BELIEF_SMEM = 48 * 1024;

__host__ __device__ constexpr int belief_vars_max(int d) { return d <= 3 ? 128 : 32; }

// One variable block's operands.  Sums: eta component c of variable v sums
// eta_src[c * ld + v * deg + k] over k < deg, lam likewise.
template <typename S>
struct BeliefSide {
  const S* eta_src;  // [d, ld]
  const S* lam_src;  // [d * d, ld]
  int64_t ld;
  int deg;
  int n;       // variables
  int vars;    // variables a block
  int blocks;
  int staged;  // row stride of the staged message rows in shared memory; 0: read in place
  int io;      // values of the priors / beliefs area: vars * (2 d + d * d), 16-byte rounded
  const S* prior_eta;  // [n, d]
  const S* prior_lam;  // [n, d, d]
  S* eta;              // [n, d]
  S* lam;              // [n, d, d]
  S* mean;             // [n, d]
};

// Lanes that sum one (component, variable) pair: the least power of two
// that leaves each lane at most 8 of the degree's rows, at most a warp (1 at
// degree 6, 8 at degree 64).
__host__ __device__ inline int belief_lanes(int deg) {
  int l = 1;
  while (l < 32 && l * 8 < deg) l *= 2;
  return l;
}

// Copies n values from device to shared memory by cp.async, 16 bytes at a
// time where both ends are 16-byte aligned, else a value at a time; the
// caller commits and waits.
template <typename S>
__device__ __forceinline__ void stage_span(S* dst, const S* src, int64_t n) {
  constexpr int VEC = 16 / sizeof(S);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int64_t nvec = aligned ? n / VEC : 0;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(dst + i * VEC, src + i * VEC);
  for (int64_t i = nvec * VEC + threadIdx.x; i < n; i += blockDim.x)
    cp_async_elem(dst + i, src + i);
}

// Block b of one side.  Shared memory: the io area ([vars * d] eta, then
// [vars * d * d] lam, then [vars * d] mean), then, staged, the block's
// message rows, component c at c * staged.
template <typename S, int D>
__device__ __forceinline__ void belief_block(const BeliefSide<S>& sd, int b, S* io) {
  constexpr int C = D + D * D;
  const int V = sd.vars, deg = sd.deg;
  const int64_t v0 = static_cast<int64_t>(b) * V;
  const int nv = static_cast<int>(sd.n - v0 < V ? sd.n - v0 : V);
  S* io_eta = io;
  S* io_lam = io + V * D;
  S* io_mean = io + V * C;
  S* stage = io + sd.io;
  // (1) The priors and, staged, the block's rows of every component, all
  // in flight at once.
  stage_span(io_eta, sd.prior_eta + v0 * D, static_cast<int64_t>(nv) * D);
  stage_span(io_lam, sd.prior_lam + v0 * D * D, static_cast<int64_t>(nv) * D * D);
  if (sd.staged) {
#pragma unroll 1
    for (int c = 0; c < C; ++c)
      stage_span(stage + c * sd.staged,
                 (c < D ? sd.eta_src + c * sd.ld : sd.lam_src + (c - D) * sd.ld) + v0 * deg,
                 static_cast<int64_t>(nv) * deg);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // (2) The sums, onto the priors: L lanes a (component, variable) pair,
  // the groups of a warp on consecutive variables of one component.
  const int L = belief_lanes(deg);
  const int groups = blockDim.x / L;
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const S* rows = sd.staged ? stage + c * sd.staged
                              : (c < D ? sd.eta_src + c * sd.ld : sd.lam_src + (c - D) * sd.ld) +
                                    v0 * deg;
    S* dst = c < D ? io_eta + c : io_lam + (c - D);
    const int dstride = c < D ? D : D * D;
    for (int vb = 0; vb < V; vb += groups) {
      const int v = vb + grp;
      S part = S(0);
      if (v < nv)
        for (int k = lane; k < deg; k += L) part = part + rows[static_cast<int64_t>(v) * deg + k];
      for (int off = L / 2; off > 0; off /= 2)
        part = part + __shfl_xor_sync(0xffffffffu, part, off);
      if (v < nv && lane == 0) dst[v * dstride] = dst[v * dstride] + part;
    }
  }
  __syncthreads();

  // (3) The solve, a thread a variable.
  const int t = threadIdx.x;
  if (t < nv) {
    S a[D][D], e[D], m[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      e[i] = io_eta[t * D + i];
#pragma unroll
      for (int j = 0; j < D; ++j) a[i][j] = io_lam[t * D * D + i * D + j];
    }
    scaled_sym_solve<S, D>(a, e, m);
#pragma unroll
    for (int i = 0; i < D; ++i) io_mean[t * D + i] = m[i];
  }
  __syncthreads();
  // (4) The beliefs back to device memory as contiguous spans.
  for (int i = threadIdx.x; i < nv * D; i += blockDim.x) {
    sd.eta[v0 * D + i] = io_eta[i];
    sd.mean[v0 * D + i] = io_mean[i];
  }
  for (int i = threadIdx.x; i < nv * D * D; i += blockDim.x) sd.lam[v0 * D * D + i] = io_lam[i];
}

template <typename S, int DG, int DE>
__global__ void __launch_bounds__(BELIEF_THREADS)
beliefs_kernel(const BeliefSide<S> gat, const BeliefSide<S> ell) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* io = reinterpret_cast<S*>(smem_raw);
  if (static_cast<int>(blockIdx.x) < gat.blocks)
    belief_block<S, DG>(gat, blockIdx.x, io);
  else
    belief_block<S, DE>(ell, blockIdx.x - gat.blocks, io);
}

// Shared bytes a block of this side takes.
template <typename S>
size_t belief_smem(const BeliefSide<S>& sd, int d) {
  const size_t rows = sd.staged ? static_cast<size_t>(sd.staged) * (d + d * d) : 0;
  return (sd.io + rows) * sizeof(S);
}

// A side's launch shape: up to belief_vars_max(d) variables a block, about
// BELIEF_ROWS message rows at degree > 1, fewer while the priors and the
// staged rows exceed BELIEF_SMEM; where even one variable's rows do not
// fit, the rows are read in place.
template <typename S>
BeliefSide<S> belief_side(const S* eta_src, const S* lam_src, int64_t ld, int deg, int n, int d,
                          const S* prior_eta, const S* prior_lam, S* eta, S* lam, S* mean) {
  constexpr int VEC = 16 / sizeof(S);
  auto round = [](int64_t x) { return static_cast<int>((x + VEC - 1) / VEC * VEC); };
  int vars = belief_vars_max(d);
  if (deg > 1) {
    const int fit = BELIEF_ROWS / deg;
    vars = fit < 1 ? 1 : (fit < vars ? fit : vars);
  }
  BeliefSide<S> sd{eta_src, lam_src, ld, deg, n, vars, 0, 0, 0,
                   prior_eta, prior_lam, eta, lam, mean};
  for (;; --sd.vars) {
    sd.io = round(static_cast<int64_t>(sd.vars) * (2 * d + d * d));
    sd.staged = round(static_cast<int64_t>(sd.vars) * deg);
    if (belief_smem(sd, d) <= BELIEF_SMEM) break;
    if (sd.vars == 1) {
      sd.vars = vars;
      sd.io = round(static_cast<int64_t>(vars) * (2 * d + d * d));
      sd.staged = 0;
      break;
    }
  }
  sd.blocks = (n + sd.vars - 1) / sd.vars;
  return sd;
}

// (d_e, d_g) -> calls f with the instantiated <d_g, d_e> pair; false for
// another shape.
template <class Fn>
bool with_belief_shape(int de, int dg, Fn&& f) {
#define GBP_BELIEF_SHAPE(E, G)                  \
  if (de == E && dg == G) {                     \
    f(std::integral_constant<int, G>{},         \
      std::integral_constant<int, E>{});        \
    return true;                                \
  }
  GBP_BELIEF_SHAPE(3, 6)
  GBP_BELIEF_SHAPE(6, 3)
  GBP_BELIEF_SHAPE(3, 9)
  GBP_BELIEF_SHAPE(9, 3)
  GBP_BELIEF_SHAPE(3, 3)
  GBP_BELIEF_SHAPE(6, 6)
#undef GBP_BELIEF_SHAPE
  return false;
}

template <typename S>
int update_beliefs(int de, int dg, const S* me, const S* ml, int64_t ld, int deg, int n_e,
                   const S* pe_e, const S* pl_e, S* eta_e, S* lam_e, S* mean_e,
                   const S* sum_g, int n_g, const S* pe_g, const S* pl_g, S* eta_g, S* lam_g,
                   S* mean_g, void* stream, int* info) {
  const BeliefSide<S> ell =
      belief_side<S>(me, ml, ld, deg, n_e, de, pe_e, pl_e, eta_e, lam_e, mean_e);
  const BeliefSide<S> gat = belief_side<S>(sum_g, sum_g + static_cast<int64_t>(dg) * n_g, n_g,
                                           1, n_g, dg, pe_g, pl_g, eta_g, lam_g, mean_g);
  int rc = 0;
  const bool known = with_belief_shape(de, dg, [&](auto g, auto e) {
    constexpr int G = decltype(g)::value, E = decltype(e)::value;
    const size_t smem_g = belief_smem(gat, G), smem_e = belief_smem(ell, E);
    const size_t smem = smem_g > smem_e ? smem_g : smem_e;
    const int blocks = gat.blocks + ell.blocks;
    if (info) {
      cudaFuncAttributes attr;
      rc = static_cast<int>(cudaFuncGetAttributes(&attr, beliefs_kernel<S, G, E>));
      info[0] = blocks;
      info[1] = gat.blocks;
      info[2] = gat.vars;
      info[3] = ell.vars;
      info[4] = static_cast<int>(smem);
      info[5] = attr.numRegs;
      info[6] = static_cast<int>(attr.localSizeBytes);
      info[7] = ell.staged;
      return;
    }
    if (blocks > 0)
      beliefs_kernel<S, G, E><<<blocks, BELIEF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          gat, ell);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

// de, dg, me, ml, ld, deg, n_e, prior_eta_e, prior_lam_e, eta_e, lam_e,
// mean_e, sum_g, n_g, prior_eta_g, prior_lam_g, eta_g, lam_g, mean_g,
// stream, info (NULL: launch; else int[8]: blocks, gathered-side blocks,
// variables a block on each side, shared bytes, registers, local bytes, the
// ELL side's staged row stride (0: read in place); no launch)
#define GBP_BELIEF_ENTRY(SFX, S)                                                             \
  extern "C" int gbp_update_beliefs_##SFX(                                                   \
      int de, int dg, const S* me, const S* ml, int64_t ld, int deg, int n_e, const S* pe_e, \
      const S* pl_e, S* eta_e, S* lam_e, S* mean_e, const S* sum_g, int n_g, const S* pe_g,  \
      const S* pl_g, S* eta_g, S* lam_g, S* mean_g, void* stream, int* info) {               \
    return gbp::update_beliefs<S>(de, dg, me, ml, ld, deg, n_e, pe_e, pl_e, eta_e, lam_e,    \
                                  mean_e, sum_g, n_g, pe_g, pl_g, eta_g, lam_g, mean_g,      \
                                  stream, info);                                             \
  }

GBP_BELIEF_ENTRY(f32, float)
GBP_BELIEF_ENTRY(f64, double)
