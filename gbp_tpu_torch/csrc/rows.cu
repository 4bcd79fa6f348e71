// The expanded-operand kernels for Hopper (sm_90a): both slots' beliefs
// arrive as per-factor operands instead of being read from a table.
//
// They serve the generic row-major sweep (core/sweep.py under
// message_form="pallas": operands [m, F], one row per factor) and the
// "rows" / "take1" modes of the component-major fast path
// (core/sweep_cm.py: operands [F, mp], for camera tables beyond shared
// memory on scenes without camera locality).  One body serves both
// layouts: every operand comes with its leading stride, and element
// (row r, component k) lies at r * ld + k (row-major) or k * ld + r
// (component-major), so neither entry launches a transpose and a slice of
// a wider packed array is taken in place.  Rows are bounds-checked; nothing
// is padded.  The per-row arithmetic is messages_rows.cuh, shared with
// messages.cu and windows.cu; the wrappers and plain versions are in
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on the
// caller's stream; each C entry returns cudaGetLastError(), or -2 for a
// combination that is not instantiated.
//
// messages_rows_kernel
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_messages_cm`
//   (component-major) and `fused_messages` (row-major; also the second call
//   of `fused_relin_messages`): `_kernel` + `_message_math`.
//   Bound: device-memory bytes, 141 values read and 54 written per row at
//   (6, 3, 2), and registers as in messages.cu.  The row-major entry has
//   each thread walk its own rows, so a warp's loads are strided by the
//   row width and lean on L1 to reuse the lines; staging a tile through
//   shared memory is later work.
//   Design: one thread per factor row, template on the slot dofs and the
//   measurement dim <DA, DB, ZD>; instantiated (6, 3, 2) (reprojection) and
//   (1, 1, 1) (scalar displacement).  (9, 3, 2), (3, 3, 3) and (6, 6, 6) are
//   further instantiations of this body.  Full precision and the per-row
//   Huber threshold are template parameters, so an instantiation that does
//   not use them pays nothing for them.
//
// relin_rows_kernel
//   Replaces `fused_relin_cm` (component-major) and the first call of
//   `fused_relin_messages` (row-major): `_kernel_relin` + `_relin_math` for
//   the `reprojection_normalized` model.
//   Bound: device-memory bytes, 42 values read and 30 written per row.
//   Design: the adjacent means are the expanded operand x; the beta
//   decision stays in separately rounded operations.
#include <type_traits>

#include "messages_rows.cuh"

namespace gbp {

constexpr int N_MSG_IN = 14;   // jac lp r0 prec srel act be0 bl0 be1 bl1 me0 ml0 me1 ml1
constexpr int N_RELIN_IN = 7;  // x z lp jac r0 srel act
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

template <typename S, int DA, int DB, int ZD, bool RM, bool PREC_FULL, bool HUBER_ROW>
__global__ void __launch_bounds__(BLOCK)
messages_rows_kernel(RowArgs<S, N_MSG_IN> a, int64_t m, MsgParams<S> p) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  using L = std::conditional_t<RM, RowMajor, ColMajor>;
  const ExpandedBelief<S, DA, L> b0{a.in[6], a.in[7], a.in_ld[6], a.in_ld[7], r};
  const ExpandedBelief<S, DB, L> b1{a.in[8], a.in[9], a.in_ld[8], a.in_ld[9], r};
  // Strides in MsgOp order: the six state operands, the four old messages,
  // the four outputs.
  const OpLds<N_MSG_OPS> ld{{a.in_ld[0], a.in_ld[1], a.in_ld[2], a.in_ld[3], a.in_ld[4],
                            a.in_ld[5], a.in_ld[10], a.in_ld[11], a.in_ld[12], a.in_ld[13],
                            a.out_ld[0], a.out_ld[1], a.out_ld[2], a.out_ld[3]}};
  messages_core<S, DA, DB, ZD, L, PREC_FULL, HUBER_ROW>(
      b0, b1, a.in[0], a.in[1], a.in[2], a.in[3], a.in[4], a.in[5], a.in[10], a.in[11],
      a.in[12], a.in[13], a.out[0], a.out[1], a.out[2], a.out[3], ld, r, p);
}

template <typename S, bool RM>
__global__ void __launch_bounds__(BLOCK)
relin_rows_kernel(RowArgs<S, N_RELIN_IN> a, int64_t m, S beta, S min_linear) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  using L = std::conditional_t<RM, RowMajor, ColMajor>;
  S x[T9];
#pragma unroll
  for (int i = 0; i < T9; ++i) x[i] = a.in[0][L::at(i, r, a.in_ld[0])];
  // Strides in RelinOp order: z lp jac r0 srel act, then the four outputs.
  const OpLds<N_RELIN_OPS> ld{{a.in_ld[1], a.in_ld[2], a.in_ld[3], a.in_ld[4], a.in_ld[5],
                              a.in_ld[6], a.out_ld[0], a.out_ld[1], a.out_ld[2], a.out_ld[3]}};
  relin_core<S, L>(x, a.in[1], a.in[2], a.in[3], a.in[4], a.in[5], a.in[6], a.out[0], a.out[1],
                   a.out[2], a.out[3], ld, r, beta, min_linear);
}

template <typename S, int DA, int DB, int ZD, bool RM, bool PREC_FULL>
int launch_messages(bool huber_row, const RowArgs<S, N_MSG_IN>& a, int64_t m,
                    const MsgParams<S>& p, cudaStream_t stream) {
  if (huber_row) {
    // Per-row thresholds go with diagonal precision only (the engine never
    // pairs them with a full one), so that pair is not instantiated.
    if constexpr (PREC_FULL) {
      return -2;
    } else {
      messages_rows_kernel<S, DA, DB, ZD, RM, false, true>
          <<<n_blocks(m), BLOCK, 0, stream>>>(a, m, p);
    }
  } else {
    messages_rows_kernel<S, DA, DB, ZD, RM, PREC_FULL, false>
        <<<n_blocks(m), BLOCK, 0, stream>>>(a, m, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int DA, int DB, int ZD>
int dispatch_messages(bool rm, bool prec_full, bool huber_row, const RowArgs<S, N_MSG_IN>& a,
                      int64_t m, const MsgParams<S>& p, cudaStream_t stream) {
  if (rm) {
    return prec_full ? launch_messages<S, DA, DB, ZD, true, true>(huber_row, a, m, p, stream)
                     : launch_messages<S, DA, DB, ZD, true, false>(huber_row, a, m, p, stream);
  }
  return prec_full ? launch_messages<S, DA, DB, ZD, false, true>(huber_row, a, m, p, stream)
                   : launch_messages<S, DA, DB, ZD, false, false>(huber_row, a, m, p, stream);
}

template <typename S>
int messages_rows(int da, int db, int zd, int rm, int prec_full, int huber_row,
                  const void* const* in, const int64_t* in_ld, void* const* out,
                  const int64_t* out_ld, int64_t m, double eta_damping, double lam_damping,
                  double num_undamped, double floor, double jitter, int has_huber,
                  double huber, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const auto a = row_args<S, N_MSG_IN>(in, in_ld, out, out_ld);
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const auto st = static_cast<cudaStream_t>(stream);
  if (da == 6 && db == 3 && zd == 2)
    return dispatch_messages<S, 6, 3, 2>(rm != 0, prec_full != 0, huber_row != 0, a, m, p, st);
  if (da == 1 && db == 1 && zd == 1)
    return dispatch_messages<S, 1, 1, 1>(rm != 0, prec_full != 0, huber_row != 0, a, m, p, st);
  return -2;
}

template <typename S>
int relin_rows(int rm, const void* const* in, const int64_t* in_ld, void* const* out,
               const int64_t* out_ld, int64_t m, double beta, double min_linear, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const auto a = row_args<S, N_RELIN_IN>(in, in_ld, out, out_ld);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rm) {
    relin_rows_kernel<S, true><<<n_blocks(m), BLOCK, 0, st>>>(
        a, m, static_cast<S>(beta), static_cast<S>(min_linear));
  } else {
    relin_rows_kernel<S, false><<<n_blocks(m), BLOCK, 0, st>>>(
        a, m, static_cast<S>(beta), static_cast<S>(min_linear));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_ROWS_ENTRIES(SFX, S)                                                              \
  extern "C" int gbp_messages_rows_##SFX(                                                     \
      int da, int db, int zd, int rm, int prec_full, int huber_row, const void* const* in,    \
      const int64_t* in_ld, void* const* out, const int64_t* out_ld, int64_t m,               \
      double eta_damping, double lam_damping, double num_undamped, double floor,              \
      double jitter, int has_huber, double huber, void* stream) {                             \
    return gbp::messages_rows<S>(da, db, zd, rm, prec_full, huber_row, in, in_ld, out,        \
                                 out_ld, m, eta_damping, lam_damping, num_undamped, floor,    \
                                 jitter, has_huber, huber, stream);                           \
  }                                                                                           \
  extern "C" int gbp_relin_rows_##SFX(int rm, const void* const* in, const int64_t* in_ld,    \
                                      void* const* out, const int64_t* out_ld, int64_t m,     \
                                      double beta, double min_linear, void* stream) {         \
    return gbp::relin_rows<S>(rm, in, in_ld, out, out_ld, m, beta, min_linear, stream);       \
  }

GBP_ROWS_ENTRIES(f32, float)
GBP_ROWS_ENTRIES(f64, double)
