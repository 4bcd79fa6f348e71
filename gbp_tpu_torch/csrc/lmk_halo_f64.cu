// The halo paths' windowed messages kernels (halo.cuh, table_kernels.cuh)
// instantiated at both camera shapes with the landmarks gathered, (6, 3, 2)
// and (9, 3, 2) with slot 1 gathered (the cameras in the ELL slot), in double:
// a source of its own, so that its compiler runs beside the others'.
#include "table_kernels.cuh"

namespace gbp {

GBP_HALO_LAUNCHERS(, double, Lmk6)
GBP_HALO_LAUNCHERS(, double, Lmk9)

}  // namespace gbp
