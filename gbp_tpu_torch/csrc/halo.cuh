// The halo paths' windowed kernels for Hopper (sm_90a): the gathered slot of
// a partition's factors from two sources, the tile's window of the OWNED
// table in shared memory and the partition's ghost table in device memory.
// This is the path of `parallel/halo_cm.py` when a partition's camera
// windows engage (city and venice cut into partitions).  The entries are
// compiled once per float type, in halo_f32.cu and halo_f64.cu, side by
// side; the (9, 3, 2) messages instantiations in bal9_halo_*.cu.
//
// Layout, shapes and models as in windows.cu: component-major [F, mp] per
// partition, rows cut into tiles of TILE = 1024; every OWNED gathered id of
// tile i (id < n_own) lies in the window [starts[i], starts[i] + w); an id
// from n_own on names row id - n_own of the ghost table gtab [n_gt, f]
// (the partition's ghost beliefs, padded, then the duplicated beliefs of
// its cut cameras, which boundary landmarks owned elsewhere read).
// (d0, d1, z) = (6, 3, 2), (9, 3, 2), (3, 3, 3), (6, 6, 6), scalar or
// per-row Huber, either slot gathered for the equal-slot shapes.  The
// kernel bodies are those of windows.cu and unfused_win.cu with the ghost
// source switched on (template parameter GHOST, table_kernels.cuh); the
// per-row arithmetic is messages_rows.cuh.  Wrappers and plain versions:
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on
// the caller's stream; each C entry returns cudaGetLastError(), a CUDA
// error of asking for dynamic shared memory, or -2 for a shape or model
// that is not instantiated.
//
// What the TPU does, and what changes: its kernels rebuild the gathered
// slot's rows with two one-hot matrix dots that add, one over the tile's
// owned window and one over the whole ghost table shifted by n_own; a
// one-hot row of an id outside a table is exactly zero.  Here a row
// selects its source by id < n_own and reads one row of it; an id outside
// its window, or beyond the ghost table, traps.
//
// messages_cm_tabblkg_ell
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_messages_cm_tabblkg_ell`
//   (`_kernel_tab_blkg_ell`), the halo windowed path's default.
//   Bound: device-memory bytes and registers, as messages_cm_tabblk_ell
//   (about 100 values per row at (6, 3, 2)).
//   Design: as messages_cm_tabblk_ell (window_messages in
//   table_kernels.cuh) over the owned packed (eta | lam) table's windows;
//   the ELL slot is read at r / deg from the partition's packed ELL table
//   (the reference's per-tile ELL group windows are a VMEM device); the
//   ghost table (136 rows x 42 values, 22.8 KB, at city cut in two) is read
//   from device memory and stays in L2.  No sum is folded
//   in: the sweep calls `segsum_cm_blk` + `scatter_windows_cm` on the owned
//   ids and `segsum_by_id` on the ghost ids.
//
// relin_cm_tabblkg_ell
//   Replaces `fused_relin_cm_tabblkg_ell` (`_kernel_relin_tab_blkg_ell`).
//   Bound: device-memory bytes (about 67 values per row at (6, 3, 2)).
//   Design: the same with the mean tables and per-row factor arguments.
//
// messages_cm_tabblkg
//   Replaces `fused_messages_cm_tabblkg` (`_kernel_tab_blkg`): the
//   unfused form, the ELL slot from expanded operands be_o, bl_o
//   (`expand_ell_blk`).  Bound and design as messages_cm_tabblk.
//
// relin_cm_tabblkg
//   Replaces `fused_relin_cm_tabblkg` (`_kernel_relin_tab_blkg`): the other
//   slot's means from x_other [d_o, mp].  Bound and design as
//   relin_cm_tabblk.
#pragma once
#include "table_kernels.cuh"

namespace gbp {

template <typename S>
int relin_win_g(int model, int gslot, const S* cam_mean, int n_cam, const S* gtab, int n_gt,
                const S* lmk_mean, const int* gidx, const int* starts, int win_w, int n_own,
                const S* z, const S* args, const S* lp, const S* jac, const S* r0,
                const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp,
                int deg, double beta, double min_linear, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const int rc = launch_relin_win<S, true>(
      model, gslot, cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, args, lp, jac, r0, srel,
      act, olp, ojac, or0, osrel, mp, deg, beta, min_linear, static_cast<cudaStream_t>(stream),
      GhostTable<S>{gtab, n_gt, n_own});
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages_win_g(int da, int db, int zd, int gslot, int huber_row, const S* cam_tab,
                   int n_cam, const S* gtab, int n_gt, const S* lmk_tab, const int* gidx,
                   const int* starts, int win_w, int n_own, const S* jac, const S* lp,
                   const S* r0, const S* prec, const S* srel, const S* act, const S* me0,
                   const S* ml0, const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1, S* ol1,
                   int64_t mp, int deg, double eta_damping, double lam_damping,
                   double num_undamped, double floor, double jitter, int has_huber,
                   double huber, void* stream, int* info) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  int rc = 0;
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    rc = launch_messages_win<S, decltype(sh), true>(
        huber_row != 0, cam_tab, n_cam, lmk_tab, gidx, starts, win_w, o, mp, deg, p,
        static_cast<cudaStream_t>(stream), GhostTable<S>{gtab, n_gt, n_own}, info);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename S>
int relin_tabblk_g(int model, int gslot, const S* x_other, const S* mtab, int n_g,
                   const S* gtab, int n_gt, const int* gidx, const int* starts, int win_w,
                   int n_own, const S* z, const S* args, const S* lp, const S* jac, const S* r0,
                   const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp,
                   double beta, double min_linear, void* stream) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const int rc = launch_relin_tabblk<S, true>(
      model, gslot, x_other, mtab, n_g, gidx, starts, win_w, z, args, lp, jac, r0, srel, act,
      olp, ojac, or0, osrel, mp, beta, min_linear, static_cast<cudaStream_t>(stream),
      GhostTable<S>{gtab, n_gt, n_own});
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename S>
int messages_tabblk_g(int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,
                      const S* gtab, int n_gt, const int* gidx, const int* starts, int win_w,
                      int n_own, const S* be_o, const S* bl_o, const S* jac, const S* lp,
                      const S* r0, const S* prec, const S* srel, const S* act, const S* me0,
                      const S* ml0, const S* me1, const S* ml1, S* oe0, S* ol0, S* oe1,
                      S* ol1, int64_t mp, double eta_damping, double lam_damping,
                      double num_undamped, double floor, double jitter, int has_huber,
                      double huber, void* stream, int* info) {
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  int rc = 0;
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    rc = launch_messages_tabblk<S, decltype(sh), true>(
        huber_row != 0, btab, n_g, gidx, starts, win_w, be_o, bl_o, o, mp, p,
        static_cast<cudaStream_t>(stream), GhostTable<S>{gtab, n_gt, n_own}, info);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_HALO_ENTRIES(SFX, S)                                                               \
  extern "C" int gbp_relin_cm_tabblkg_ell_##SFX(                                               \
      int model, int gslot, const S* cam_mean, int n_cam, const S* gtab, int n_gt,             \
      const S* lmk_mean, const int* gidx, const int* starts, int win_w, int n_own,             \
      const S* z, const S* args, const S* lp, const S* jac, const S* r0, const S* srel,        \
      const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, int deg, double beta,       \
      double min_linear, void* stream) {                                                       \
    return gbp::relin_win_g<S>(model, gslot, cam_mean, n_cam, gtab, n_gt, lmk_mean, gidx,      \
                               starts, win_w, n_own, z, args, lp, jac, r0, srel, act, olp,     \
                               ojac, or0, osrel, mp, deg, beta, min_linear, stream);           \
  }                                                                                            \
  extern "C" int gbp_messages_cm_tabblkg_ell_##SFX(                                            \
      int da, int db, int zd, int gslot, int huber_row, const S* cam_tab, int n_cam,           \
      const S* gtab, int n_gt, const S* lmk_tab, const int* gidx, const int* starts,           \
      int win_w, int n_own, const S* jac, const S* lp, const S* r0, const S* prec,             \
      const S* srel, const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,     \
      S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, double eta_damping,                 \
      double lam_damping, double num_undamped, double floor, double jitter, int has_huber,     \
      double huber, void* stream, int* info) {                                                 \
    return gbp::messages_win_g<S>(da, db, zd, gslot, huber_row, cam_tab, n_cam, gtab, n_gt,    \
                                  lmk_tab, gidx, starts, win_w, n_own, jac, lp, r0, prec,      \
                                  srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, deg,  \
                                  eta_damping, lam_damping, num_undamped, floor, jitter,       \
                                  has_huber, huber, stream, info);                             \
  }                                                                                            \
  extern "C" int gbp_relin_cm_tabblkg_##SFX(                                                   \
      int model, int gslot, const S* x_other, const S* mtab, int n_g, const S* gtab,           \
      int n_gt, const int* gidx, const int* starts, int win_w, int n_own, const S* z,          \
      const S* args, const S* lp, const S* jac, const S* r0, const S* srel, const S* act,      \
      S* olp, S* ojac, S* or0, S* osrel, int64_t mp, double beta, double min_linear,           \
      void* stream) {                                                                          \
    return gbp::relin_tabblk_g<S>(model, gslot, x_other, mtab, n_g, gtab, n_gt, gidx, starts,  \
                                  win_w, n_own, z, args, lp, jac, r0, srel, act, olp, ojac,    \
                                  or0, osrel, mp, beta, min_linear, stream);                   \
  }                                                                                            \
  extern "C" int gbp_messages_cm_tabblkg_##SFX(                                                \
      int da, int db, int zd, int gslot, int huber_row, const S* btab, int n_g,                \
      const S* gtab, int n_gt, const int* gidx, const int* starts, int win_w, int n_own,       \
      const S* be_o, const S* bl_o, const S* jac, const S* lp, const S* r0, const S* prec,     \
      const S* srel, const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,     \
      S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, double eta_damping, double lam_damping,      \
      double num_undamped, double floor, double jitter, int has_huber, double huber,           \
      void* stream, int* info) {                                                               \
    return gbp::messages_tabblk_g<S>(da, db, zd, gslot, huber_row, btab, n_g, gtab, n_gt,      \
                                     gidx, starts, win_w, n_own, be_o, bl_o, jac, lp, r0,      \
                                     prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1,  \
                                     mp, eta_damping, lam_damping, num_undamped, floor,        \
                                     jitter, has_huber, huber, stream, info);                  \
  }
