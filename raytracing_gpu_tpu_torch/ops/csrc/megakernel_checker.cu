// Forward megakernel instantiations for scenes with checker albedo and no
// perlin texture (device code: megakernel.cuh).  A translation unit of its
// own, so nvcc builds it beside the others.

#include "megakernel.cuh"

int launch_fwd_checker(const RtTables& t, const RtParams& p, float* out_r,
                       float* out_g, float* out_b, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatChecker>(t, p, out_r, out_g, out_b, s);
}
