// Record-mode megakernel instantiations (device code: megakernel.cuh): the
// packed plane and, when asked, the hit-point planes and the uv planes,
// over every geometry the forward kernel takes, the sphere and triangle
// BVHs included, for a whole training chunk in one launch or for one wave.
// A translation unit of its own, so nvcc builds it beside the forward ones.
// The record mode evaluates no albedo, so the instantiations are keyed on
// the geometry bits and kFeatTriBvh only: twelve of them.

#include "megakernel.cuh"

namespace {

// The record kernel's grid: a block a kThreads rays, capped at p.grid
// blocks when it is set (the card's resident blocks, `rt_walk_occupancy`).
template <unsigned F>
int launch_record(const RtTables& t, const RtParams& p, const RecordOut& o,
                  int* next_ray, int* blocks_per_sm, cudaStream_t stream) {
  size_t table_bytes;
  if (!rt::check_tables(t, p, &table_bytes) || p.wave <= 0 ||
      p.waves <= 0 || p.wave0 < 0 || p.grid < 0 || p.n % p.wave != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, rt::megakernel_record<F>, rt::kThreads, table_bytes));
  int blocks = (p.n + rt::kThreads - 1) / rt::kThreads;
  if (p.grid > 0 && p.grid < blocks) blocks = p.grid;
  // rays past the grid's first pass come from the counter, and a claim
  // (the grid's first pass plus one a thread) stays within int32
  const long long threads = static_cast<long long>(blocks) * rt::kThreads;
  if ((threads < p.n && next_ray == nullptr) ||
      p.n + threads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::megakernel_record<F><<<blocks, rt::kThreads, table_bytes, stream>>>(
      t, p, o, next_ray);
  return static_cast<int>(cudaGetLastError());
}

// The six geometry instantiations (no spheres, dense spheres or the sphere
// BVH, each with or without media), without or with triangles (TRI).
template <unsigned TRI>
int launch_record_family(const RtTables& t, const RtParams& p,
                         const RecordOut& o, int* next_ray,
                         int* blocks_per_sm, cudaStream_t s) {
  switch (static_cast<unsigned>(p.features) & kFeatGeometry) {
    case 0: return launch_record<TRI | 0>(t, p, o, next_ray, blocks_per_sm, s);
    case 1: return launch_record<TRI | 1>(t, p, o, next_ray, blocks_per_sm, s);
    case 2: return launch_record<TRI | 2>(t, p, o, next_ray, blocks_per_sm, s);
    case 3: return launch_record<TRI | 3>(t, p, o, next_ray, blocks_per_sm, s);
    case 4: return launch_record<TRI | 4>(t, p, o, next_ray, blocks_per_sm, s);
    case 6: return launch_record<TRI | 6>(t, p, o, next_ray, blocks_per_sm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

int launch_walk(const RtTables& t, const RtParams& p, const RecordOut& o,
                int* next_ray, int* blocks_per_sm, cudaStream_t s) {
  const unsigned feat = static_cast<unsigned>(p.features);
  const bool all_p = o.px != nullptr && o.py != nullptr && o.pz != nullptr;
  const bool no_p = o.px == nullptr && o.py == nullptr && o.pz == nullptr;
  const bool uv_ok = (o.u == nullptr) == (o.v == nullptr);
  if ((feat & ~(kFeatGeometry | kFeatTriBvh)) != 0 || !(all_p || no_p) ||
      !uv_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  return (feat & kFeatTriBvh)
             ? launch_record_family<kFeatTriBvh>(t, p, o, next_ray,
                                                 blocks_per_sm, s)
             : launch_record_family<0>(t, p, o, next_ray, blocks_per_sm, s);
}
