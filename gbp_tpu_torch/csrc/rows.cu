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
//   measurement dim <DA, DB, ZD>; instantiated (6, 3, 2) (reprojection),
//   (1, 1, 1) (scalar displacement), (3, 3, 3) (SE(2) between), (6, 6, 6)
//   (SE(3) between) and (9, 3, 2) (the 9-dof BAL camera).  The pose shapes
//   and (9, 3, 2) are instantiated in sources of their own (rows_se2.cu,
//   rows_se3_f32.cu, rows_se3_f64.cu, bal9_rows_f32.cu, bal9_rows_f64.cu), so
//   that the compilers run side by side.  Full precision and the per-row Huber threshold are template
//   parameters, so an instantiation that does not use them pays nothing for
//   them.
//
// relin_rows_kernel
//   Replaces `fused_relin_cm` (component-major) and the first call of
//   `fused_relin_messages` (row-major): `_kernel_relin` + `_relin_math` for
//   the `reprojection_normalized`, `bal_reprojection_normalized`,
//   `bal_reprojection_intrinsics`, `se2_between` and `se3_between` models;
//   per-row factor arguments ride as the eighth operand.
//   Bound: device-memory bytes, 42 values read and 30 written per row at
//   (6, 3, 2).
//   Design: the adjacent means are the expanded operand x; the beta
//   decision stays in separately rounded operations.
#include "rows_kernels.cuh"

namespace gbp {

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
  if (da == 3 && db == 3 && zd == 3)
    return dispatch_messages<S, 3, 3, 3>(rm != 0, prec_full != 0, huber_row != 0, a, m, p, st);
  if (da == 6 && db == 6 && zd == 6)
    return dispatch_messages<S, 6, 6, 6>(rm != 0, prec_full != 0, huber_row != 0, a, m, p, st);
  if (da == 9 && db == 3 && zd == 2)
    return dispatch_messages<S, 9, 3, 2>(rm != 0, prec_full != 0, huber_row != 0, a, m, p, st);
  return -2;
}

template <typename S>
int relin_rows(int model, int rm, const void* const* in, const int64_t* in_ld, void* const* out,
               const int64_t* out_ld, int64_t m, double beta, double min_linear, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const auto a = row_args<S, N_RELIN_IN>(in, in_ld, out, out_ld);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool known = with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    if (rm) {
      relin_rows_kernel<S, M, true><<<n_blocks(m), BLOCK, 0, st>>>(
          a, m, static_cast<S>(beta), static_cast<S>(min_linear));
    } else {
      relin_rows_kernel<S, M, false><<<n_blocks(m), BLOCK, 0, st>>>(
          a, m, static_cast<S>(beta), static_cast<S>(min_linear));
    }
  });
  return known ? static_cast<int>(cudaGetLastError()) : -2;
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
  extern "C" int gbp_relin_rows_##SFX(int model, int rm, const void* const* in,               \
                                      const int64_t* in_ld, void* const* out,                 \
                                      const int64_t* out_ld, int64_t m, double beta,          \
                                      double min_linear, void* stream) {                      \
    return gbp::relin_rows<S>(model, rm, in, in_ld, out, out_ld, m, beta, min_linear,         \
                              stream);                                                        \
  }

GBP_ROWS_ENTRIES(f32, float)
GBP_ROWS_ENTRIES(f64, double)
