// Forward megakernel instantiations for scenes with a noise, turbulence or
// marble texture, checker albedo included (device code: megakernel.cuh).
// The perlin turbulence is the heaviest albedo (7 octaves x 8 hashed
// corners); it stays out of the other instantiations' registers.

#include "megakernel.cuh"

int launch_fwd_perlin(const RtTables& t, const RtParams& p, float* out_r,
                      float* out_g, float* out_b, cudaStream_t s) {
  return rt::launch_fwd_family<kFeatChecker | kFeatPerlin>(t, p, out_r, out_g,
                                                           out_b, s);
}
