// Forward megakernel instantiations for scenes with triangles and a noise,
// turbulence or marble texture, checker albedo included (device code:
// megakernel.cuh).

#include "megakernel.cuh"

int launch_fwd_tri_perlin(const RtTables& t, const RtParams& p, float* out,
                          int* next_row, int* blocks_per_sm, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatTriBvh | kFeatChecker | kFeatPerlin>(
      t, p, out, next_row, blocks_per_sm, s);
}
