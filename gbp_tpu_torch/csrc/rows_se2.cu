// The expanded-operand messages kernel (rows.cu, rows_kernels.cuh)
// instantiated at (3, 3, 3), SE(2) between factors, float32 and float64: a source
// of its own, so that its compiler runs beside the others'.
#include "rows_kernels.cuh"

namespace gbp {

template int dispatch_messages<float, 3, 3, 3>(bool, bool, bool, const RowArgs<float, N_MSG_IN>&,
    int64_t, const MsgParams<float>&, cudaStream_t);
template int dispatch_messages<double, 3, 3, 3>(bool, bool, bool, const RowArgs<double, N_MSG_IN>&,
    int64_t, const MsgParams<double>&, cudaStream_t);

}  // namespace gbp
