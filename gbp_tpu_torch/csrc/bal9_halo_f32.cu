// The halo paths' windowed messages kernels (halo.cuh, table_kernels.cuh)
// instantiated at (9, 3, 2), the 9-dof BAL camera of
// `bal_reprojection_intrinsics`, in float: a source of its own, so that its
// compiler runs beside the others'.
#include "table_kernels.cuh"

namespace gbp {

GBP_HALO_LAUNCHERS(, float, Bal9)

}  // namespace gbp
