// The unfused table kernels for Hopper (sm_90a): the gathered slot from a
// table in shared memory, the ELL slot from expanded per-row operands that a
// separate expansion kernel writes.  This is the path of a prepared graph
// with `ell_fused=False`, which `prepare` takes by itself at ELL degree 1 (a
// pose chain without loop closures) and which A/B runs force.
//
// Layout, shapes and models as in messages.cu: component-major [F, mp], one
// thread per factor row, (d0, d1, z) = (6, 3, 2), (9, 3, 2), (3, 3, 3),
// (6, 6, 6), scalar or per-row Huber, either slot gathered.  The per-row arithmetic is messages_rows.cuh,
// the same code as every other kernel; the messages kernel is in
// table_kernels.cuh.  The wrappers and plain versions are in
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on the
// caller's stream; each C entry returns cudaGetLastError(), or -2 for a shape
// or model that is not instantiated.
//
// messages_cm_tab
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_messages_cm_tab`
//   (`_kernel_tab` + `_message_math`).
//   Bound: device-memory bytes and registers.  At (6, 3, 2) a row reads 18 +
//   9 + 2 + 2 + 1 + 1 state values, 12 expanded ELL-slot beliefs, 54 old
//   messages and its id, and writes 54; the register load is that of
//   messages_cm_tab_ell.
//   Design: as `messages_kernel` (the packed gathered-slot table staged in
//   shared memory, read by id), with the ELL slot's belief read from the
//   expanded operands be_o [d1, mp], bl_o [d1 * d1, mp] at column r, which
//   neighbouring threads read side by side.  No sum is folded in: the sweep
//   calls `segsum_by_id` on the outputs.
//
// relin_cm_tab
//   Replaces `fused_relin_cm_tab` (`_kernel_relin_tab` + `_relin_math`).
//   Bound: device-memory bytes (about 67 values per row at (6, 3, 2)).
//   Design: the gathered slot's means from the shared-memory mean table, the
//   ELL slot's from x_other [d1, mp].
//
// expand_ell_blk
//   Replaces `expand_ell_blk` (`_kernel_expand_blk`): out[k, r] =
//   tab[r / deg, k], the packed ELL-slot table [nv, f] expanded to [f, mp].
//   Bound: device-memory bytes: f * mp values written, the table read once.
//   Design: the TPU kernel exists because a broadcast over a degree that
//   does not divide the lane count is a slow relayout there, and it selects
//   rows by one-hot dots from per-tile slices.  Here one thread per output
//   row reads its variable's packed row, which the deg threads of a group
//   share through L1, and writes the f components coalesced; there is no
//   alignment to respect, so the sweep calls it at every degree.
#include "table_kernels.cuh"

namespace gbp {

template <typename S, class M>
__global__ void __launch_bounds__(BLOCK)
relin_tab_kernel(const S* __restrict__ x_other, const S* __restrict__ mtab, int n_g,
                 const int* __restrict__ gidx, const S* __restrict__ z,
                 const S* __restrict__ args, const S* __restrict__ lp, const S* __restrict__ jac,
                 const S* __restrict__ r0, const S* __restrict__ srel,
                 const S* __restrict__ act, S* __restrict__ olp, S* __restrict__ ojac,
                 S* __restrict__ or0, S* __restrict__ osrel, int64_t mp, int gslot, S beta,
                 S min_linear) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int dg = gathered_dofs<M>(gslot);
  for (int i = threadIdx.x; i < n_g * dg; i += blockDim.x) tab[i] = mtab[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  S x[M::DA + M::DB];
  slot_means<S, M>(tab + gidx[r] * dg, x_other + r, mp, gslot, x);
  relin_core<S, M, ColMajor>(x, z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel,
                             UniformLd{mp}, r, beta, min_linear);
}

template <typename S>
__global__ void __launch_bounds__(BLOCK)
expand_ell_kernel(const S* __restrict__ tab, int f, int deg, int64_t mp, S* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  const S* __restrict__ row = tab + (r / deg) * f;
  for (int k = 0; k < f; ++k) out[k * mp + r] = row[k];
}

template <typename S>
int relin_tab(int model, int gslot, const S* x_other, const S* mtab, int n_g, const int* gidx,
              const S* z, const S* args, const S* lp, const S* jac, const S* r0, const S* srel,
              const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, double beta,
              double min_linear, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const bool known = with_model(model, [&](auto m) {
    using M = decltype(m);
    const size_t smem = static_cast<size_t>(n_g) * gathered_dofs<M>(gslot) * sizeof(S);
    relin_tab_kernel<S, M><<<n_blocks(mp), BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        x_other, mtab, n_g, gidx, z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp,
        gslot, static_cast<S>(beta), static_cast<S>(min_linear));
  });
  return known ? static_cast<int>(cudaGetLastError()) : -2;
}

template <typename S>
int messages_tab(int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,
                 const int* gidx, const S* be_o, const S* bl_o, const S* jac, const S* lp,
                 const S* r0, const S* prec, const S* srel, const S* act, const S* me0,
                 const S* ml0, const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1,
                 int64_t mp, double eta_damping, double lam_damping, double num_undamped,
                 double floor, double jitter, int has_huber, double huber, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    launch_messages_tab<S, decltype(sh)>(huber_row != 0, btab, n_g, gidx, be_o, bl_o, o, mp, p,
                                         static_cast<cudaStream_t>(stream));
  });
  return known ? static_cast<int>(cudaGetLastError()) : -2;
}

template <typename S>
int expand_ell(const S* tab, int f, int deg, int64_t mp, S* out, void* stream) {
  if (mp <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  expand_ell_kernel<S><<<n_blocks(mp), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, f, deg, mp, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_UNFUSED_ENTRIES(SFX, S)                                                     \
  extern "C" int gbp_relin_cm_tab_##SFX(                                                \
      int model, int gslot, const S* x_other, const S* mtab, int n_g, const int* gidx,  \
      const S* z, const S* args, const S* lp, const S* jac, const S* r0, const S* srel, \
      const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, double beta,         \
      double min_linear, void* stream) {                                                \
    return gbp::relin_tab<S>(model, gslot, x_other, mtab, n_g, gidx, z, args, lp, jac,  \
                             r0, srel, act, olp, ojac, or0, osrel, mp, beta, min_linear, \
                             stream);                                                   \
  }                                                                                     \
  extern "C" int gbp_messages_cm_tab_##SFX(                                             \
      int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,         \
      const int* gidx, const S* be_o, const S* bl_o, const S* jac, const S* lp,         \
      const S* r0, const S* prec, const S* srel, const S* act, const S* me0, const S* ml0, \
      const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp,           \
      double eta_damping, double lam_damping, double num_undamped, double floor,        \
      double jitter, int has_huber, double huber, void* stream) {                       \
    return gbp::messages_tab<S>(da, db, zd, gslot, huber_row, btab, n_g, gidx, be_o,    \
                                bl_o, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, \
                                ol0, oe1, ol1, mp, eta_damping, lam_damping,            \
                                num_undamped, floor, jitter, has_huber, huber, stream); \
  }                                                                                     \
  extern "C" int gbp_expand_ell_blk_##SFX(const S* tab, int f, int deg, int64_t mp,     \
                                          S* out, void* stream) {                       \
    return gbp::expand_ell<S>(tab, f, deg, mp, out, stream);                            \
  }

GBP_UNFUSED_ENTRIES(f32, float)
GBP_UNFUSED_ENTRIES(f64, double)
