// Forward megakernel instantiations for scenes with triangles and solid or
// checker albedo (device code: megakernel.cuh).  A translation unit of its
// own, so nvcc builds it beside the others, and the instantiations without
// triangles carry none of the triangle walk.

#include "megakernel.cuh"

int launch_fwd_tri_solid(const RtTables& t, const RtParams& p, float* out,
                         int* next_row, int* blocks_per_sm, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatTriBvh>(t, p, out, next_row,
                                            blocks_per_sm, s);
}

int launch_fwd_tri_checker(const RtTables& t, const RtParams& p, float* out,
                           int* next_row, int* blocks_per_sm,
                           cudaStream_t s) {
  return rt::launch_fwd_family<kFeatTriBvh | kFeatChecker>(
      t, p, out, next_row, blocks_per_sm, s);
}
