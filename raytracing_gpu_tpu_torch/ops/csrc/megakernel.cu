// C entry points of the path-tracing megakernel (device code and design
// notes: megakernel.cuh), and the forward instantiations for scenes whose
// textures are all solid and that have no triangles.
//
// Entry points (plain C, bound with ctypes): rt_trace_chunk launches the
// forward kernel once for a whole sample chunk of camera rays, picking the
// instantiation (and its translation unit) from p.features;
// rt_trace_pixels launches it on one (sample, wave), a chunk of one sample
// and one wave with its seed given, and rt_trace_rays the same on ray
// planes (kernel 1c); rt_trace_occupancy reports how many blocks of the
// scene's forward instantiation an SM holds, for sizing the chunk's grid;
// rt_walk_chunk launches the record kernel once for a whole training chunk
// of camera rays (or a group of its waves), and rt_walk_packed_pixels and
// rt_walk_packed on one wave of camera rays and of ray planes
// (megakernel_record.cu), each with the hit-point planes and the uv planes
// when they are given; rt_walk_occupancy reports how many blocks of the
// scene's record instantiation an SM holds; rt_pcg_uniform writes
// uniform(base, salt) per lane so a test can hold the device RNG against
// the plain version; rt_error_string names a returned CUDA error.  The
// tables and the launch constants come by value (RtTables, RtParams).  Each
// entry returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for parameters the kernels do not take) and never synchronizes.

#include "megakernel.cuh"

int launch_fwd_solid(const RtTables& t, const RtParams& p, float* out,
                     int* next_row, int* blocks_per_sm, cudaStream_t s) {
  return rt::launch_fwd_family<0>(t, p, out, next_row, blocks_per_sm, s);
}

namespace {

__global__ void __launch_bounds__(rt::kThreads)
pcg_uniform_kernel(uint32_t seed_mix, int lanes, uint32_t salt,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  out[i] = rt::uniform01(rt::pcg_hash(static_cast<uint32_t>(i) ^ seed_mix),
                         salt);
}

int trace(const RtTables& t, const RtParams& p, float* out, int* next_row,
          int* blocks_per_sm, cudaStream_t s) {
  const unsigned feat = static_cast<unsigned>(p.features);
  const unsigned tex = feat & (kFeatChecker | kFeatPerlin);
  const bool tri = (feat & kFeatTriBvh) != 0;
  if (tex == 0)
    return (tri ? launch_fwd_tri_solid : launch_fwd_solid)(
        t, p, out, next_row, blocks_per_sm, s);
  if (tex == kFeatChecker)
    return (tri ? launch_fwd_tri_checker : launch_fwd_checker)(
        t, p, out, next_row, blocks_per_sm, s);
  if (tex == (kFeatChecker | kFeatPerlin))
    return (tri ? launch_fwd_tri_perlin : launch_fwd_perlin)(
        t, p, out, next_row, blocks_per_sm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// p.n rows of p.spp samples in waves of p.wave, at most p.grid blocks;
// `next_row` is a 4-byte counter that this entry zeroes on the stream.
extern "C" int rt_trace_chunk(RtTables t, RtParams p, float* out,
                              int* next_row, void* stream) {
  if (next_row == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.rays = nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(next_row, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return trace(t, p, out, next_row, nullptr, s);
}

// One wave of p.n rays, a block a kThreads rays (no counter).
extern "C" int rt_trace_pixels(RtTables t, RtParams p, float* out,
                               void* stream) {
  p.rays = nullptr;
  p.wave = p.n;
  p.spp = 1;
  p.grid = 0;
  return trace(t, p, out, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int rt_trace_rays(RtTables t, RtParams p, const float* rays,
                             float* out, void* stream) {
  if (rays == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.rays = rays;
  p.wave = p.n;
  p.spp = 1;
  p.grid = 0;
  return trace(t, p, out, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// The resident blocks an SM holds of the forward instantiation that p
// selects, with its tables in shared memory.
extern "C" int rt_trace_occupancy(RtTables t, RtParams p, int* blocks_per_sm) {
  if (blocks_per_sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return trace(t, p, nullptr, nullptr, blocks_per_sm, nullptr);
}

// One wave of the record kernel: p.n rays, a block a kThreads rays (no
// counter), its seed given.
static int walk_wave(RtParams p, const RtTables& t, const RecordOut& o,
              void* stream) {
  p.wave = p.n;
  p.waves = 1;
  p.wave0 = 0;
  p.grid = 0;
  return launch_walk(t, p, o, nullptr, nullptr,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int rt_walk_packed_pixels(RtTables t, RtParams p,
                                     int32_t* out_packed, float* out_px,
                                     float* out_py, float* out_pz,
                                     float* out_u, float* out_v,
                                     void* stream) {
  p.rays = nullptr;
  return walk_wave(p, t,
                   RecordOut{out_packed, out_px, out_py, out_pz, out_u, out_v},
                   stream);
}

extern "C" int rt_walk_packed(RtTables t, RtParams p, const float* rays,
                              int32_t* out_packed, float* out_px,
                              float* out_py, float* out_pz, float* out_u,
                              float* out_v, void* stream) {
  if (rays == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.rays = rays;
  return walk_wave(p, t,
                   RecordOut{out_packed, out_px, out_py, out_pz, out_u, out_v},
                   stream);
}

// p.n rays of whole waves of p.wave rays, waves p.wave0 .. of a chunk of
// p.waves waves a sample seeded from p.seed, at most p.grid blocks;
// `next_ray` is a 4-byte counter that this entry zeroes on the stream.
extern "C" int rt_walk_chunk(RtTables t, RtParams p, int32_t* out_packed,
                             float* out_px, float* out_py, float* out_pz,
                             float* out_u, float* out_v, int* next_ray,
                             void* stream) {
  if (next_ray == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.rays = nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return launch_walk(
      t, p, RecordOut{out_packed, out_px, out_py, out_pz, out_u, out_v},
      next_ray, nullptr, s);
}

// The resident blocks an SM holds of the record instantiation that p
// selects, with its tables in shared memory.
extern "C" int rt_walk_occupancy(RtTables t, RtParams p, int* blocks_per_sm) {
  if (blocks_per_sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rays = nullptr;
  return launch_walk(t, p,
                     RecordOut{nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr},
                     nullptr, blocks_per_sm, nullptr);
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
