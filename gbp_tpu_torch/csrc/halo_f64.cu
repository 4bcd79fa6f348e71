// The halo paths' windowed kernels (halo.cuh) in double: a source of its own
// per float type, so that the two compilers run side by side.
#include "halo.cuh"

GBP_HALO_ENTRIES(f64, double)
