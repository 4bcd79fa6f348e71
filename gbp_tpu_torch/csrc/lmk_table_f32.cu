// The table families' messages kernels (table_kernels.cuh) instantiated at
// both camera shapes with the landmarks gathered, (6, 3, 2) and (9, 3, 2)
// with slot 1 gathered: the cameras in the ELL slot, which a graph with more
// cameras than landmarks gets.  In float: a source of its own, so that its
// compiler runs beside the others'.
#include "table_kernels.cuh"

namespace gbp {

GBP_TABLE_LAUNCHERS(, float, Lmk6)
GBP_TABLE_LAUNCHERS(, float, Lmk9)

}  // namespace gbp
