// Record-mode megakernel instantiations (device code: megakernel.cuh): the
// packed plane and, when asked, the hit-point planes and the uv planes,
// over every geometry the forward kernel takes, the sphere and triangle
// BVHs included.  A
// translation unit of its own, so nvcc builds it beside the forward ones.
// The record mode evaluates no albedo, so the instantiations are keyed on
// the geometry bits and kFeatTriBvh only: twelve of them.

#include "megakernel.cuh"

namespace {

// The optional output planes: the hit point's x, y, z and the uv.
struct Planes {
  float *px, *py, *pz, *u, *v;
};

template <unsigned F>
int launch_record(const RtTables& t, const RtParams& p, int32_t* out,
                  const Planes& o, cudaStream_t stream) {
  size_t table_bytes;
  if (!rt::check_tables(t, p, &table_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n + rt::kThreads - 1) / rt::kThreads;
  rt::megakernel_record<F><<<blocks, rt::kThreads, table_bytes, stream>>>(
      t, p, out, o.px, o.py, o.pz, o.u, o.v);
  return static_cast<int>(cudaGetLastError());
}

// The six geometry instantiations (no spheres, dense spheres or the sphere
// BVH, each with or without media), without or with triangles (TRI).
template <unsigned TRI>
int launch_record_family(const RtTables& t, const RtParams& p, int32_t* out,
                         const Planes& o, cudaStream_t s) {
  switch (static_cast<unsigned>(p.features) & kFeatGeometry) {
    case 0: return launch_record<TRI | 0>(t, p, out, o, s);
    case 1: return launch_record<TRI | 1>(t, p, out, o, s);
    case 2: return launch_record<TRI | 2>(t, p, out, o, s);
    case 3: return launch_record<TRI | 3>(t, p, out, o, s);
    case 4: return launch_record<TRI | 4>(t, p, out, o, s);
    case 6: return launch_record<TRI | 6>(t, p, out, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

int launch_walk(const RtTables& t, const RtParams& p, int32_t* out_packed,
                float* out_px, float* out_py, float* out_pz, float* out_u,
                float* out_v, cudaStream_t s) {
  const unsigned feat = static_cast<unsigned>(p.features);
  const bool all_p = out_px != nullptr && out_py != nullptr &&
                     out_pz != nullptr;
  const bool no_p = out_px == nullptr && out_py == nullptr &&
                    out_pz == nullptr;
  const bool uv_ok = (out_u == nullptr) == (out_v == nullptr);
  if ((feat & ~(kFeatGeometry | kFeatTriBvh)) != 0 || !(all_p || no_p) ||
      !uv_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes o{out_px, out_py, out_pz, out_u, out_v};
  return (feat & kFeatTriBvh)
             ? launch_record_family<kFeatTriBvh>(t, p, out_packed, o, s)
             : launch_record_family<0>(t, p, out_packed, o, s);
}
