// The expanded-operand messages kernel (rows.cu, rows_kernels.cuh)
// instantiated at (9, 3, 2), the 9-dof BAL camera of
// `bal_reprojection_intrinsics`, in float: a source of its own, so that its
// compiler runs beside the others'.
#include "rows_kernels.cuh"

namespace gbp {

template int dispatch_messages<float, 9, 3, 2>(bool, bool, bool, const RowArgs<float, N_MSG_IN>&,
    int64_t, const MsgParams<float>&, cudaStream_t);

}  // namespace gbp
