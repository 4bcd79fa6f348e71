// The expanded-operand kernels for Hopper (sm_90a): both slots' beliefs
// arrive as per-factor operands instead of being read from a table.
//
// They serve the generic row-major sweep (core/sweep.py under
// message_form="pallas": operands [m, F], one row per factor) and the
// "rows" / "take1" modes of the component-major fast path
// (core/sweep_cm.py: operands [F, mp], for camera tables beyond shared
// memory on scenes without camera locality).  Every operand comes with its
// leading stride, so neither entry launches a transpose and a slice of a
// wider packed array (the generic sweep's belief views: leading stride 48
// for cameras and 15 for landmarks, lam 24 bytes into the row) is taken in
// place.  Rows are bounds-checked; nothing is padded.  The per-row
// arithmetic is messages_rows.cuh, shared with messages.cu and windows.cu;
// the kernels and the tiles are in rows_kernels.cuh; the wrappers and plain
// versions are in gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing
// and launch on the caller's stream; each C entry returns
// cudaGetLastError(), -2 for a combination that is not instantiated, or -3
// for row-major outputs that are not contiguous and 16-byte aligned.
//
// Component-major (messages_cm_kernel, relin_cm_kernel): one thread per
// factor row reads its components in place, each warp load one coalesced
// span; 256 threads per block.
//
// Row-major (messages_staged_kernel, relin_staged_kernel): a block of R
// threads takes a tile of R rows.  Every input's tile is copied into shared
// memory, a contiguous span by one 1-D bulk copy (TMA), a strided view by
// cp.async, consecutive threads on consecutive elements (coalesced whatever
// the stride and alignment); the unchanged per-row bodies run on the tiles;
// the four outputs leave through tiles of their own, one contiguous span
// each.  R per shape and dtype (rows_kernels.cuh): 128 rows and 104,448
// bytes of tiles per block at (6, 3, 2) in float32, so that two blocks
// share an SM.  The outputs equal the component-major kernels' on the
// transposed operands bit for bit.
//
// messages_cm_kernel, messages_staged_kernel
//   Replace gbp_tpu/ops/messages_pallas.py `fused_messages_cm`
//   (component-major) and `fused_messages` (row-major; also the second call
//   of `fused_relin_messages`): `_kernel` + `_message_math`.
//   Bound: device-memory bytes, 141 values read and 54 written per row at
//   (6, 3, 2); the staged kernel also by the instructions that copy the
//   strided views element by element, and by its block's phases (stage,
//   compute, store) overlapping only across the two blocks of an SM.
//   Design: one thread per factor row, template on the slot dofs and the
//   measurement dim <DA, DB, ZD>; instantiated (6, 3, 2) (reprojection),
//   (1, 1, 1) (scalar displacement), (3, 3, 3) (SE(2) between), (6, 6, 6)
//   (SE(3) between) and (9, 3, 2) (the 9-dof BAL camera).  The pose shapes
//   and (9, 3, 2) are instantiated in sources of their own (rows_se2.cu,
//   rows_se3_f32.cu, rows_se3_f64.cu, bal9_rows_f32.cu, bal9_rows_f64.cu),
//   so that the compilers run side by side.  Full precision and the per-row
//   Huber threshold are template parameters, so an instantiation that does
//   not use them pays nothing for them.
//
// relin_cm_kernel, relin_staged_kernel
//   Replace `fused_relin_cm` (component-major) and the first call of
//   `fused_relin_messages` (row-major): `_kernel_relin` + `_relin_math` for
//   the `reprojection_normalized`, `bal_reprojection_normalized`,
//   `bal_reprojection_intrinsics`, `se2_between` and `se3_between` models;
//   per-row factor arguments ride as the eighth operand.
//   Bound: device-memory bytes, 42 values read and 30 written per row at
//   (6, 3, 2).
//   Design: the adjacent means are the expanded operand x; the beta
//   decision stays in separately rounded operations.  Relinearization and
//   messages stay two kernels, as in the reference: fused, the pair would
//   save the 30 values per row the first writes and the second reads again
//   (0.0183 ms at bench64), but stack the relinearization's 62-73 registers
//   on the messages kernel's.
#include "rows_kernels.cuh"

namespace gbp {

// The messages kernel of shape (da, db, zd) in one layout, or (info) the
// staged kernel's figures.
template <typename S>
int messages_shape(int da, int db, int zd, bool rm, bool prec_full, bool huber_row,
                   const RowArgs<S, N_MSG_IN>& a, int64_t m, const MsgParams<S>& p,
                   cudaStream_t st, int* info) {
  if (da == 6 && db == 3 && zd == 2)
    return dispatch_messages<S, 6, 3, 2>(rm, prec_full, huber_row, a, m, p, st, info);
  if (da == 1 && db == 1 && zd == 1)
    return dispatch_messages<S, 1, 1, 1>(rm, prec_full, huber_row, a, m, p, st, info);
  if (da == 3 && db == 3 && zd == 3)
    return dispatch_messages<S, 3, 3, 3>(rm, prec_full, huber_row, a, m, p, st, info);
  if (da == 6 && db == 6 && zd == 6)
    return dispatch_messages<S, 6, 6, 6>(rm, prec_full, huber_row, a, m, p, st, info);
  if (da == 9 && db == 3 && zd == 2)
    return dispatch_messages<S, 9, 3, 2>(rm, prec_full, huber_row, a, m, p, st, info);
  return -2;
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
  return messages_shape<S>(da, db, zd, rm != 0, prec_full != 0, huber_row != 0, a, m, p,
                           static_cast<cudaStream_t>(stream), nullptr);
}

template <typename S>
int relin_rows(int model, int rm, const void* const* in, const int64_t* in_ld, void* const* out,
               const int64_t* out_ld, int64_t m, double beta, double min_linear, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const auto a = row_args<S, N_RELIN_IN>(in, in_ld, out, out_ld);
  const auto st = static_cast<cudaStream_t>(stream);
  const S b = static_cast<S>(beta), ml = static_cast<S>(min_linear);
  int rc = -2;
  with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    if (!rm) {
      relin_cm_kernel<S, M><<<n_blocks(m), BLOCK, 0, st>>>(a, m, b, ml);
      rc = static_cast<int>(cudaGetLastError());
      return;
    }
    using T = RelinTile<S, M>;
    rc = check_staged_outputs<T>(a);
    if (rc == 0) rc = launch_staged<T>(relin_staged_kernel<S, M>, m, st, a, m, b, ml);
  });
  return rc;
}

template <typename S>
int relin_rows_info(int model, int* info) {
  int rc = -2;
  with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    rc = staged_info<RelinTile<S, M>>(relin_staged_kernel<S, M>, info);
  });
  return rc;
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
  }                                                                                           \
  /* info: rows per block, shared bytes per block, registers and local bytes */               \
  /* per thread, resident blocks per SM of the row-major (staged) kernel */                   \
  extern "C" int gbp_messages_rows_info_##SFX(int da, int db, int zd, int prec_full,          \
                                              int huber_row, int* info) {                     \
    return gbp::messages_shape<S>(da, db, zd, true, prec_full != 0, huber_row != 0, {}, 0,    \
                                  {}, nullptr, info);                                         \
  }                                                                                           \
  extern "C" int gbp_relin_rows_info_##SFX(int model, int* info) {                            \
    return gbp::relin_rows_info<S>(model, info);                                              \
  }

GBP_ROWS_ENTRIES(f32, float)
GBP_ROWS_ENTRIES(f64, double)
