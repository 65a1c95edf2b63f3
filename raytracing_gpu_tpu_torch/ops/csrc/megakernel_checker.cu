// Forward megakernel instantiations for scenes with checker albedo and no
// perlin texture (device code: megakernel.cuh).  A translation unit of its
// own, so nvcc builds it beside the others.

#include "megakernel.cuh"

int launch_fwd_checker(const RtTables& t, const RtParams& p, float* out,
                       int* next_row, int* blocks_per_sm, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatChecker>(t, p, out, next_row,
                                             blocks_per_sm, s);
}
