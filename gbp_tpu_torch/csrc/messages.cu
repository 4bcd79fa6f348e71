// The fast path's full-table kernels for Hopper (sm_90a).
//
// Layout: component-major [F, mp], one thread per factor row, so the
// threads of a warp read neighbouring addresses of every component.  One
// slot (gslot) is gathered by id from a per-variable table staged in shared
// memory (cameras; landmarks on a graph with more cameras than landmarks;
// poses), the other is the ELL slot: row r belongs to variable r / deg
// (landmarks; cameras; the same poses).  Instantiated for (d0, d1, z) =
// (6, 3, 2) reprojection (normalized or BAL), (9, 3, 2) the 9-dof BAL
// camera (in bal9_table_*.cu; with the landmarks gathered, both camera
// shapes in lmk_table_*.cu), (3, 3, 3) SE(2) and (6, 6, 6) SE(3) between
// factors, each with either slot gathered, with a scalar or a per-row Huber
// threshold.  The per-row
// arithmetic is in messages_rows.cuh and the messages kernels are in
// table_kernels.cuh, shared with windows.cu, unfused.cu, unfused_win.cu and
// rows.cu; the wrappers and plain versions are in
// gbp_tpu_torch/ops/messages.py.  Kernels allocate nothing and launch on the
// caller's stream; each C entry returns cudaGetLastError(), or -2 for a
// shape or model that is not instantiated.
//
// relin_cm_tab_ell
//   Replaces gbp_tpu/ops/messages_pallas.py `fused_relin_cm_tab_ell`
//   (`_kernel_relin_tab_ell` + `_relin_math`).
//   Bound: device-memory bytes.  Per row it reads 9 + 18 + 2 + 2 + 1 + 1
//   components plus two table entries and writes 30, against a few hundred
//   flops (Rodrigues, the 2x9 Jacobian).
//   Design: the camera means (n_cam x 6) sit in shared memory, so the
//   per-row camera read is a shared-memory index instead of the TPU's
//   one-hot matrix dots; landmark means are read at r / deg, which
//   neighbouring threads share (deg rows per landmark), so they hit L1.
//   A model with per-row arguments (the BAL distortion) reads them from
//   args [n_args, mp] in the relinearizing branch only.
//
// messages_cm_tab_ell
//   Replaces `fused_messages_cm_tab_ell` (`_kernel_tab_ell` + `_message_math`
//   and, for its 5th output, `_segsum_partial_full`): the four new messages
//   and the gathered-slot sum of the new gathered-slot messages over the
//   rows the CSR (seg_rows, seg_offsets) lists, computed in the same launch
//   as the TPU kernel computes it; the kernel reads the CSR as a per-row
//   segment map (seg_ids: the row's segment, -1 where the CSR does not list
//   it), made once per prepared graph.
//   Bound: the latency of each row's dependent arithmetic at the warps its
//   registers leave an SM.  One thread holds a 6x6 cavity, its Jacobi-scaled
//   Schur-recursion inverse, the 2x9 Jacobian and the 6x6 message at once
//   (the -Xptxas -v report gives the registers and spill bytes), while the
//   bytes moved are ~100 components per row; only more warps hide that
//   latency.
//   Design (messages_kernel, table_kernels.cuh): blocks of 128 threads over
//   contiguous ranges of 128-row units, as many as the SMs hold at once
//   (q or q + 1 units a block), within 128 registers so that four blocks
//   (16 warps) share an SM in float32 with the cameras gathered (three with
//   the landmarks gathered; 256 threads, one block an SM, in float64 and at
//   12 dofs).  A block stages the packed table (n_cam x F) in shared memory
//   once; a row's landmark belief comes from row / deg.  The per-row
//   computation stays in one thread with fully unrolled fixed-size arrays;
//   masked rows keep their old message through a select.  The fold
//   (table_kernels.cuh, "the gathered-slot sum folded into the messages
//   launches") costs no barrier a unit: after each unit every warp adds its
//   listed rows onto its own slab, the rows of one camera first added among
//   their lanes by shuffles (bench64: a warp's 32 rows are one landmark's, 32
//   distinct cameras, so each row goes straight onto its camera's slot), and
//   the messages are never read back from device memory.  The table and
//   four warps' slabs of 64 cameras take 54.8 KB at bench64, within the 56
//   KB a block has at four blocks an SM; slots past that lie in device
//   memory (a 1,000-pose table's).  At most mp / (8 n_seg) blocks (the
//   wrapper's cap, `fold_max_blocks`), so the partials stay within 1/8 of
//   the messages, but never fewer than one per SM.  The same entry then
//   launches segsum_combine_kernel, which adds the blocks' partials in a
//   fixed order (16 phases).  Deterministic: no floating-point atomics; the
//   order is set by the launch plan.
#include "table_kernels.cuh"

namespace gbp {

template <typename S, class M>
__global__ void __launch_bounds__(BLOCK)
relin_kernel(const S* __restrict__ cam_mean, int n_cam,
             const S* __restrict__ lmk_mean, const int* __restrict__ gidx,
             const S* __restrict__ z, const S* __restrict__ args, const S* __restrict__ lp,
             const S* __restrict__ jac, const S* __restrict__ r0,
             const S* __restrict__ srel, const S* __restrict__ act,
             S* __restrict__ olp, S* __restrict__ ojac, S* __restrict__ or0,
             S* __restrict__ osrel, int64_t mp, int deg, int gslot, S beta,
             S min_linear) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tab = reinterpret_cast<S*>(smem_raw);
  const int dg = gathered_dofs<M>(gslot);
  for (int i = threadIdx.x; i < n_cam * dg; i += blockDim.x) tab[i] = cam_mean[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= mp) return;
  relin_row<S, M>(tab + gidx[r] * dg, lmk_mean, z, args, lp, jac, r0, srel, act, olp, ojac,
                  or0, osrel, mp, deg, gslot, r, beta, min_linear);
}

template <typename S>
int relin(int model, int gslot, const S* cam_mean, int n_cam, const S* lmk_mean, int nv,
          const int* gidx, const S* z, const S* args, const S* lp, const S* jac, const S* r0,
          const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel, int64_t mp, int deg,
          double beta, double min_linear, void* stream) {
  (void)nv;
  if (mp <= 0) return static_cast<int>(cudaGetLastError());
  const bool known = with_model(model, [&](auto m) {
    using M = decltype(m);
    const size_t smem = static_cast<size_t>(n_cam) * gathered_dofs<M>(gslot) * sizeof(S);
    relin_kernel<S, M><<<n_blocks(mp), BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        cam_mean, n_cam, lmk_mean, gidx, z, args, lp, jac, r0, srel, act, olp, ojac, or0,
        osrel, mp, deg, gslot, static_cast<S>(beta), static_cast<S>(min_linear));
  });
  return known ? static_cast<int>(cudaGetLastError()) : -2;
}

template <typename S>
int messages(int da, int db, int zd, int gslot, int huber_row, const S* cam_tab, int n_cam,
             const S* lmk_tab, int nv, const int* gidx,
             const S* jac, const S* lp, const S* r0, const S* prec, const S* srel,
             const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,
             S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, double eta_damping,
             double lam_damping, double num_undamped, double floor, double jitter,
             int has_huber, double huber, const int* seg_ids, int n_seg, S* part,
             int max_blocks, S* slab, S* out, void* stream, int* info) {
  (void)nv;
  if (mp <= 0 && !info) return static_cast<int>(cudaGetLastError());
  const auto p =
      msg_params<S>(eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber);
  const MsgOps<S> o{jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1};
  int rc = 0;
  const bool known = with_table_shape(da, db, zd, gslot, [&](auto sh) {
    rc = launch_messages_tab_ell<S, decltype(sh)>(
        huber_row != 0, cam_tab, n_cam, lmk_tab, gidx, o, mp, deg, p,
        static_cast<cudaStream_t>(stream), seg_ids, n_seg, part, max_blocks, slab, out, info);
  });
  if (!known) return -2;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace gbp

#define GBP_ENTRIES(SFX, S)                                                          \
  extern "C" int gbp_relin_cm_tab_ell_##SFX(                                         \
      int model, int gslot, const S* cam_mean, int n_cam, const S* lmk_mean, int nv, \
      const int* gidx, const S* z, const S* args, const S* lp, const S* jac,         \
      const S* r0, const S* srel, const S* act, S* olp, S* ojac, S* or0, S* osrel,   \
      int64_t mp, int deg, double beta, double min_linear, void* stream) {           \
    return gbp::relin<S>(model, gslot, cam_mean, n_cam, lmk_mean, nv, gidx, z, args, \
                         lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp, deg,     \
                         beta, min_linear, stream);                                  \
  }                                                                                  \
  extern "C" int gbp_messages_cm_tab_ell_##SFX(                                      \
      int da, int db, int zd, int gslot, int huber_row, const S* cam_tab, int n_cam, \
      const S* lmk_tab, int nv, const int* gidx,                                     \
      const S* jac, const S* lp, const S* r0, const S* prec, const S* srel,          \
      const S* act, const S* me0, const S* ml0, const S* me1, const S* ml1,          \
      S* oe0, S* ol0, S* oe1, S* ol1, int64_t mp, int deg, double eta_damping,       \
      double lam_damping, double num_undamped, double floor, double jitter,          \
      int has_huber, double huber, const int* seg_ids, int n_seg, S* part,           \
      int max_blocks, S* slab, S* out, void* stream, int* info) {                    \
    return gbp::messages<S>(da, db, zd, gslot, huber_row, cam_tab, n_cam, lmk_tab,   \
                            nv, gidx, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, \
                            oe0, ol0, oe1, ol1, mp, deg, eta_damping, lam_damping,   \
                            num_undamped, floor, jitter, has_huber, huber, seg_ids,  \
                            n_seg, part, max_blocks, slab, out, stream, info);       \
  }

GBP_ENTRIES(f32, float)
GBP_ENTRIES(f64, double)
