// The expanded-operand messages kernels (rows.cu, rows_kernels.cuh), both layouts,
// instantiated at (6, 6, 6), SE(3) between factors, float32: a source
// of its own, so that its compiler runs beside the others'.
#include "rows_kernels.cuh"

namespace gbp {

template int dispatch_messages<float, 6, 6, 6>(bool, bool, bool, const RowArgs<float, N_MSG_IN>&,
    int64_t, const MsgParams<float>&, cudaStream_t, int*);

}  // namespace gbp
