// The windowed unfused table kernels for Hopper (sm_90a): the gathered
// slot from the tile's window of its table in shared memory, the ELL slot
// from expanded per-row operands (`expand_ell_blk`).  This is the path of a
// prepared graph whose camera windows engage with `ell_fused=False`, which
// `prepare` takes by itself at ELL degree 1 and which A/B runs force on
// large scenes (city, venice).
//
// Layout, shapes and models as in windows.cu: component-major [F, mp], rows
// cut into tiles of TILE = 1024, every gathered id of tile i inside the
// window [starts[i], starts[i] + w); (d0, d1, z) = (6, 3, 2), (9, 3, 2),
// (3, 3, 3), (6, 6, 6), scalar or per-row Huber, either slot gathered.  The per-row arithmetic is messages_rows.cuh and
// the messages kernel is in table_kernels.cuh, the same code as every other
// kernel.  The wrappers and plain versions are in
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on the
// caller's stream; each C entry returns cudaGetLastError(), a CUDA error of
// asking for dynamic shared memory, or -2 for a shape or model that is not
// instantiated.
//
// messages_cm_tabblk
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_messages_cm_tabblk`
//   (`_kernel_tab_blk` + `_message_math`).
//   Bound: device-memory bytes and registers.  At (6, 3, 2) a row reads its
//   18 + 9 + 2 + 2 + 1 + 1 state values, 12 expanded ELL-slot beliefs, 54
//   old messages and its id, and writes 54 (about 150 values per row, 0.28
//   GB at city's 451,584 rows in float32); the register load is that of
//   messages_cm_tab.
//   Design: as messages_cm_tabblk_ell (windows.cu; window_messages in
//   table_kernels.cuh), the other slot's expanded belief be_o / bl_o
//   staged with the unit's other operands; a row reads its gathered belief
//   at gidx[r] - start in its tile's window.  The TPU's per-tile window
//   stacks and one-hot dots become that index read; an id outside its
//   tile's window is a fault of the prepared graph and traps.
//   No camera sum is folded in: the sweep calls `segsum_cm_blk` and
//   `scatter_windows_cm` on the outputs.
//
// relin_cm_tabblk
//   Replaces `fused_relin_cm_tabblk` (`_kernel_relin_tab_blk` +
//   `_relin_math`).
//   Bound: device-memory bytes (about 67 values per row at (6, 3, 2)).
//   Design: the tile's window of the gathered slot's mean table in shared
//   memory, the other slot's means from x_other [d_o, mp], per-row factor
//   arguments (the BAL distortion) from args [n_args, mp].
#include "table_kernels.cuh"

namespace gbp {

template <typename S>
int relin_tabblk(int model, int gslot, const S* x_other, const S* mtab, int n_g,
                 const int* gidx, const int* starts, int win_w, const S* z, const S* args,
                 const S* lp, const S* jac, const S* r0, const S* srel, const S* act, S* olp,
                 S* ojac, S* or0, S* osrel, int64_t mp, double beta, double min_linear,
                 void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const int rc = launch_relin_tabblk<S, false>(
      model, gslot, x_other, mtab, n_g, gidx, starts, win_w, z, args, lp, jac, r0, srel, act,
      olp, ojac, or0, osrel, mp, beta, min_linear, static_cast<cudaStream_t>(stream),
      GhostTable<S>{});
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages_tabblk(int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,
                    const int* gidx, const int* starts, int win_w, const S* be_o,
                    const S* bl_o, const S* jac, const S* lp, const S* r0, const S* prec,
                    const S* srel, const S* act, const S* me0, const S* ml0, const S* me1,
                    const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp,
                    double eta_damping, double lam_damping, double num_undamped, double floor,
                    double jitter, int has_huber, double huber, void* stream, int* info) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  int rc = 0;
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    rc = launch_messages_tabblk<S, decltype(sh)>(huber_row != 0, btab, n_g, gidx, starts, win_w,
                                                 be_o, bl_o, o, mp, p,
                                                 static_cast<cudaStream_t>(stream),
                                                 GhostTable<S>{}, info);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_UNFUSED_WIN_ENTRIES(SFX, S)                                                     \
  extern "C" int gbp_relin_cm_tabblk_##SFX(                                                 \
      int model, int gslot, const S* x_other, const S* mtab, int n_g, const int* gidx,      \
      const int* starts, int win_w, const S* z, const S* args, const S* lp, const S* jac,   \
      const S* r0, const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel,          \
      int64_t mp, double beta, double min_linear, void* stream) {                           \
    return gbp::relin_tabblk<S>(model, gslot, x_other, mtab, n_g, gidx, starts, win_w, z,   \
                                args, lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp,    \
                                beta, min_linear, stream);                                  \
  }                                                                                         \
  extern "C" int gbp_messages_cm_tabblk_##SFX(                                              \
      int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,             \
      const int* gidx, const int* starts, int win_w, const S* be_o, const S* bl_o,          \
      const S* jac, const S* lp, const S* r0, const S* prec, const S* srel, const S* act,   \
      const S* me0, const S* ml0, const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1,       \
      S* ol1, int64_t mp, double eta_damping, double lam_damping, double num_undamped,      \
      double floor, double jitter, int has_huber, double huber, void* stream, int* info) {  \
    return gbp::messages_tabblk<S>(da, db, zd, gslot, huber_row, btab, n_g, gidx, starts,   \
                                   win_w, be_o, bl_o, jac, lp, r0, prec, srel, act, me0,    \
                                   ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, eta_damping,      \
                                   lam_damping, num_undamped, floor, jitter, has_huber,     \
                                   huber, stream, info);                                    \
  }

GBP_UNFUSED_WIN_ENTRIES(f32, float)
GBP_UNFUSED_WIN_ENTRIES(f64, double)
