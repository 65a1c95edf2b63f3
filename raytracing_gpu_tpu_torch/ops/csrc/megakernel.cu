// C entry points of the path-tracing megakernel (device code and design
// notes: megakernel.cuh), and the forward instantiations for scenes whose
// textures are all solid and that have no triangles.
//
// Entry points (plain C, bound with ctypes): rt_trace_pixels launches the
// forward kernel, picking the instantiation (and its translation unit) from
// p.features; rt_walk_packed_pixels the record kernel (no sphere or
// triangle BVH); rt_pcg_uniform writes uniform(base, salt) per lane so a
// test can hold the device RNG against the plain version; rt_error_string
// names a returned CUDA error.  Each entry returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for parameters the kernels do not take)
// and never synchronizes.

#include "megakernel.cuh"

int launch_fwd_solid(const RtTables& t, const RtParams& p, float* out_r,
                     float* out_g, float* out_b, cudaStream_t s) {
  return rt::launch_fwd_family<0>(t, p, out_r, out_g, out_b, s);
}

namespace {

template <unsigned F>
int launch_record(const RtTables& t, const RtParams& p, int32_t* out,
                  cudaStream_t stream) {
  size_t table_bytes;
  if (!rt::check_launch(p, &table_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n + rt::kThreads - 1) / rt::kThreads;
  rt::megakernel_record<F><<<blocks, rt::kThreads, table_bytes, stream>>>(
      t, p, out);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(rt::kThreads)
pcg_uniform_kernel(uint32_t seed_mix, int lanes, uint32_t salt,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  out[i] = rt::uniform01(rt::pcg_hash(static_cast<uint32_t>(i) ^ seed_mix),
                         salt);
}

}  // namespace

extern "C" int rt_trace_pixels(const float* rects, const float* boxes,
                               const float* spheres, const float* media,
                               const float* sph_nodes, const int* sph_links,
                               const int* sph_start, const float* tri_rows,
                               const float* tri_nodes, const int* tri_links,
                               const int* tri_start, RtParams p, float* out_r,
                               float* out_g, float* out_b, void* stream) {
  const RtTables t{rects,    boxes,     spheres,   media,
                   sph_nodes, sph_links, sph_start, tri_rows,
                   tri_nodes, tri_links, tri_start};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned feat = static_cast<unsigned>(p.features);
  const unsigned tex = feat & (kFeatChecker | kFeatPerlin);
  const bool tri = (feat & kFeatTriBvh) != 0;
  if (tex == 0)
    return (tri ? launch_fwd_tri_solid : launch_fwd_solid)(t, p, out_r, out_g,
                                                           out_b, s);
  if (tex == kFeatChecker)
    return (tri ? launch_fwd_tri_checker : launch_fwd_checker)(
        t, p, out_r, out_g, out_b, s);
  if (tex == (kFeatChecker | kFeatPerlin))
    return (tri ? launch_fwd_tri_perlin : launch_fwd_perlin)(t, p, out_r,
                                                             out_g, out_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_walk_packed_pixels(const float* rects, const float* boxes,
                                     const float* spheres, const float* media,
                                     const float* sph_nodes,
                                     const int* sph_links,
                                     const int* sph_start,
                                     const float* tri_rows,
                                     const float* tri_nodes,
                                     const int* tri_links,
                                     const int* tri_start, RtParams p,
                                     int32_t* out_packed, void* stream) {
  const RtTables t{rects,    boxes,     spheres,   media,
                   sph_nodes, sph_links, sph_start, tri_rows,
                   tri_nodes, tri_links, tri_start};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (static_cast<unsigned>(p.features)) {
    case 0: return launch_record<0>(t, p, out_packed, s);
    case kFeatSpheres: return launch_record<kFeatSpheres>(t, p, out_packed, s);
    case kFeatMedia: return launch_record<kFeatMedia>(t, p, out_packed, s);
    case kFeatSpheres | kFeatMedia:
      return launch_record<kFeatSpheres | kFeatMedia>(t, p, out_packed, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rt_pcg_uniform(int seed, int lanes, int salt, float* out,
                              void* stream) {
  if (lanes <= 0 || salt < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (lanes + rt::kThreads - 1) / rt::kThreads;
  pcg_uniform_kernel<<<blocks, rt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(seed) * rt::kSeedMix, lanes,
      static_cast<uint32_t>(salt), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
