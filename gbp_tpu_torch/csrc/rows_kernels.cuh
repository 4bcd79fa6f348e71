// The expanded-operand kernels' templates (see rows.cu): the kernels, the
// operand bundle of one launch and the per-shape dispatcher, shared by
// rows.cu and the sources that instantiate the pose shapes.
#pragma once
#include <type_traits>

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

template <typename S, class M, bool RM>
__global__ void __launch_bounds__(BLOCK)
relin_rows_kernel(RowArgs<S, N_RELIN_IN> a, int64_t m, S beta, S min_linear) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  using L = std::conditional_t<RM, RowMajor, ColMajor>;
  constexpr int TD = M::DA + M::DB;
  S x[TD];
#pragma unroll
  for (int i = 0; i < TD; ++i) x[i] = a.in[0][L::at(i, r, a.in_ld[0])];
  // Strides in RelinOp order: z lp jac r0 srel act args, then the four
  // outputs.
  const OpLds<N_RELIN_OPS> ld{{a.in_ld[1], a.in_ld[2], a.in_ld[3], a.in_ld[4], a.in_ld[5],
                              a.in_ld[6], a.in_ld[7], a.out_ld[0], a.out_ld[1], a.out_ld[2],
                              a.out_ld[3]}};
  relin_core<S, M, L>(x, a.in[1], a.in[7], a.in[2], a.in[3], a.in[4], a.in[5], a.in[6],
                      a.out[0], a.out[1], a.out[2], a.out[3], ld, r, beta, min_linear);
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

// The pose shapes' and the 9-dof BAL camera's dispatchers are compiled in
// sources of their own.
extern template int dispatch_messages<float, 3, 3, 3>(bool, bool, bool,
                                                      const RowArgs<float, N_MSG_IN>&, int64_t,
                                                      const MsgParams<float>&, cudaStream_t);
extern template int dispatch_messages<double, 3, 3, 3>(bool, bool, bool,
                                                       const RowArgs<double, N_MSG_IN>&, int64_t,
                                                       const MsgParams<double>&, cudaStream_t);
extern template int dispatch_messages<float, 6, 6, 6>(bool, bool, bool,
                                                      const RowArgs<float, N_MSG_IN>&, int64_t,
                                                      const MsgParams<float>&, cudaStream_t);
extern template int dispatch_messages<double, 6, 6, 6>(bool, bool, bool,
                                                       const RowArgs<double, N_MSG_IN>&, int64_t,
                                                       const MsgParams<double>&, cudaStream_t);
extern template int dispatch_messages<float, 9, 3, 2>(bool, bool, bool,
                                                      const RowArgs<float, N_MSG_IN>&, int64_t,
                                                      const MsgParams<float>&, cudaStream_t);
extern template int dispatch_messages<double, 9, 3, 2>(bool, bool, bool,
                                                       const RowArgs<double, N_MSG_IN>&, int64_t,
                                                       const MsgParams<double>&, cudaStream_t);

}  // namespace gbp
