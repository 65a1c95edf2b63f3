// Forward megakernel instantiations for scenes with a noise, turbulence or
// marble texture, checker albedo included (device code: megakernel.cuh).
// The perlin turbulence is the heaviest albedo (7 octaves x 8 hashed
// corners); it stays out of the other instantiations' registers.

#include "megakernel.cuh"

int launch_fwd_perlin(const RtTables& t, const RtParams& p, float* out,
                      int* next_row, int* blocks_per_sm, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatChecker | kFeatPerlin>(t, p, out, next_row,
                                                           blocks_per_sm, s);
}
