// The expanded-operand messages kernels (rows.cu, rows_kernels.cuh), both layouts,
// instantiated at (6, 6, 6), SE(3) between factors, float64: a source
// of its own, so that its compiler runs beside the others'.
#include "rows_kernels.cuh"

namespace gbp {

template int dispatch_messages<double, 6, 6, 6>(bool, bool, bool, const RowArgs<double, N_MSG_IN>&,
    int64_t, const MsgParams<double>&, cudaStream_t, int*);

}  // namespace gbp
