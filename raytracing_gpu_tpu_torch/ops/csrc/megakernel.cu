// Path-tracing megakernel for Hopper (sm_90a), camera rays made in the
// kernel, in its two modes: forward radiance and the record walk.
//
// Replaces the TPU kernel `_make_kernel` launched by `_run`
// (raytracing_gpu_tpu/ops/pallas_trace.py:821-1643, pl.pallas_call at :1703)
// for the feature set the port covers: axis-aligned rects, boxes under
// rotate_y + translate, lambertian and diffuse_light materials, solid
// textures.  Two kernels share one closest-hit test, one camera and one
// lambertian scatter, so both modes trace the same paths with the same
// rounding:
//
// - megakernel_fwd, forward mode (shade=True, record=False, cam=...): per
//   ray radiance over the whole bounce loop (`PallasTracer.trace_pixels`).
// - megakernel_record, record mode (record=True, shade=False, cam=...): per
//   bounce one packed int32 word `mat | hit<<16 | cont<<17 | miss<<18`
//   (pallas_trace.py:1536-1541, `PallasTracer.walk_packed_pixels`).  The
//   Cornell feature set needs no hit point and no uv (need_p = need_uv =
//   False), so the packed plane is the only output.
//
// The host side and the plain PyTorch versions of both functions are in
// ../cuda_trace.py.
//
// Design.  One thread traces one ray of the wave and runs its own bounce
// loop, leaving it when its ray dies.  That is what the TPU tile computes:
// there a (64, 128) tile loops until all its lanes are dead, and a dead lane
// adds nothing (pallas_trace.py:1397-1398, 1626-1637).  In record mode the
// thread writes word b of its ray to out[b * n + i], so the 32 threads of a
// warp store one contiguous 128-byte line per bounce; after its path ends it
// writes 0 for its remaining bounces, which takes the place of the TPU
// kernel's pre-zeroed plane (:1558-1561) and writes every word exactly once.
// A TPU lane that died inside a tile that is still live re-intersects its
// frozen ray and stores that primitive's `mat` with its mask bits at zero;
// a thread here writes 0 instead.  The two differ in those mat bits only, and
// phase-2 shading ignores them (every mask is 0 there).
//
// What bounds it on Hopper.  Per-thread ALU work and divergence, not bytes:
// each ray tests the same 8 primitive records (6 rects, 2 boxes) at every
// bounce, draws its random numbers from a counter-based hash, and writes 12
// bytes at the end (forward) or 4 bytes per bounce (record).  So the records
// are staged once per block into shared memory, where every thread of a
// warp reads the same word at the same time (a broadcast), and the only
// device-memory traffic is the output stores.  Rays of a warp that die early
// leave their lanes idle until the warp's longest path ends; regrouping live
// rays is work for a later change.
//
// Rounding.  The build compiles this file with -fmad=false and without
// --use_fast_math, so every multiply and add rounds on its own, as in the
// plain versions and in XLA; the normal's length uses 1.0f / sqrtf(x), not
// rsqrtf.  cosf/sinf differ from XLA's and torch's by a few ulp, which is
// why the multi-bounce comparisons are stated per pixel.  A later change may
// turn contraction on behind a looser tolerance.
//
// The random numbers reproduce the JAX kernel's bit for bit: lane = thread
// index within the call, base = pcg(lane ^ uint32(seed) * 0x85EBCA6B), bounce
// b draws at base + uint32(b * 32) * 0x68E31DA4 and the camera at
// base + 0x7F4A7C15 * 0x68E31DA4, all uint32 arithmetic wrapping.
//
// Entry points (plain C, bound with ctypes): rt_trace_pixels launches the
// forward kernel; rt_walk_packed_pixels the record kernel; rt_pcg_uniform
// writes uniform(base, salt) per lane so a test can hold the device RNG
// against the plain version; rt_error_string names a returned CUDA error.
// Each entry returns cudaGetLastError() after its launch and never
// synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

// Keep in step with RtParams in ../build.py.
struct RtParams {
  float origin[3], llc[3], hor[3], ver[3], cu[3], cv[3];
  float lens_radius;
  float inv_w, inv_h;  // float32(1 / max(dim - 1, 1))
  float t_min;
  float bg[3];
  int img_h, img_w, pix_base, n, seed, max_depth, n_rects, n_boxes;
};

namespace {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-12f;
constexpr int kRectCols = 12;  // axis a0 a1 b0 b1 k kind c1rgb mat pad
constexpr int kBoxCols = 16;   // bmin3 bmax3 cos sin off3 kind c1rgb mat
constexpr int kDiffuseLight = 3;
constexpr int32_t kHitBit = 1 << 16;
constexpr int32_t kContBit = 1 << 17;
constexpr int32_t kMissBit = 1 << 18;
constexpr uint32_t kSeedMix = 0x85EBCA6Bu;
constexpr uint32_t kSaltMul = 0x9E3779B9u;
constexpr uint32_t kDrawMul = 0x68E31DA4u;
constexpr uint32_t kCamDraw = 0x7F4A7C15u * 0x68E31DA4u;  // wraps mod 2^32
constexpr float kTwoPi = 6.2831855f;                       // float32(2 pi)
constexpr int kThreads = 128;
constexpr size_t kMaxTableBytes = 48 * 1024;

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

// U[0, 1): the top 24 bits of the hash times 2^-24 (exact in float32).
__device__ __forceinline__ float uniform01(uint32_t base, uint32_t salt) {
  const uint32_t bits = pcg_hash(base + salt * kSaltMul);
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

// Sign-preserving divisor guard: |v| < 1e-12 becomes +-1e-12.
__device__ __forceinline__ float guard(float v) {
  return fabsf(v) < kEps ? (v >= 0.0f ? kEps : -kEps) : v;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The winner of the closest-hit test: t (kBig on a miss), outward normal,
// material kind, solid albedo and material id.
struct Hit {
  float t, nx, ny, nz, ar, ag, ab;
  int kind, mat;
};

// Copies the rect and box records into the block's shared memory; every
// thread of the block must call it.
__device__ __forceinline__ void stage_tables(const float* __restrict__ rects,
                                             const float* __restrict__ boxes,
                                             const RtParams& p, float* table) {
  const int rect_words = p.n_rects * kRectCols;
  const int box_words = p.n_boxes * kBoxCols;
  for (int k = threadIdx.x; k < rect_words; k += blockDim.x) table[k] = rects[k];
  for (int k = threadIdx.x; k < box_words; k += blockDim.x)
    table[rect_words + k] = boxes[k];
  __syncthreads();
}

// ---- thin-lens camera (pallas_trace.py:1569-1611) ----
// Pixel ids past the image clamp to its last pixel; row and column are plain
// integer division (the TPU kernel's float-reciprocal divide is a Mosaic
// workaround).  No shutter time: nothing in the ported feature set reads it.
__device__ __forceinline__ Ray camera_ray(const RtParams& p, int i,
                                          uint32_t rng_base) {
  const int last = p.img_h * p.img_w - 1;
  const int pix = min(p.pix_base + i, last);
  int row = pix / p.img_w;
  const int col = pix - row * p.img_w;
  row = min(row, p.img_h - 1);
  const uint32_t cdraw = rng_base + kCamDraw;
  const float su = (static_cast<float>(col) + uniform01(cdraw, 0u)) * p.inv_w;
  const float sv =
      (static_cast<float>(p.img_h - 1 - row) + uniform01(cdraw, 1u)) * p.inv_h;
  float offx = 0.0f, offy = 0.0f, offz = 0.0f;
  if (p.lens_radius != 0.0f) {
    const float theta = kTwoPi * uniform01(cdraw, 2u);
    const float rr = p.lens_radius * sqrtf(uniform01(cdraw, 3u));
    const float rdx = rr * cosf(theta);
    const float rdy = rr * sinf(theta);
    offx = p.cu[0] * rdx + p.cv[0] * rdy;
    offy = p.cu[1] * rdx + p.cv[1] * rdy;
    offz = p.cu[2] * rdx + p.cv[2] * rdy;
  }
  Ray r;
  r.ox = p.origin[0] + offx;
  r.oy = p.origin[1] + offy;
  r.oz = p.origin[2] + offz;
  r.dx = p.llc[0] + su * p.hor[0] + sv * p.ver[0] - r.ox;
  r.dy = p.llc[1] + su * p.hor[1] + sv * p.ver[1] - r.oy;
  r.dz = p.llc[2] + su * p.hor[2] + sv * p.ver[2] - r.oz;
  return r;
}

// ---- closest hit: rects, then boxes, strict < (:961-1043) ----
__device__ __forceinline__ Hit closest_hit(const float* srect,
                                           const float* sbox,
                                           const RtParams& p, const Ray& r) {
  Hit h;
  h.t = kBig;
  h.nx = h.ny = h.nz = 0.0f;
  h.ar = h.ag = h.ab = 0.0f;
  h.kind = 0;
  h.mat = 0;
  for (int k = 0; k < p.n_rects; ++k) {
    const float* q = srect + k * kRectCols;
    const int ax = static_cast<int>(q[0]);
    const float o_k = ax == 0 ? r.ox : (ax == 1 ? r.oy : r.oz);
    const float d_k = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
    const float t = (q[5] - o_k) / guard(d_k);
    // varying coordinates in ascending axis order: yz, xz, xy
    const float oa = ax == 0 ? r.oy : r.ox, da = ax == 0 ? r.dy : r.dx;
    const float ob = ax == 2 ? r.oy : r.oz, db = ax == 2 ? r.dy : r.dz;
    const float pa = oa + t * da;
    const float pb = ob + t * db;
    const bool ok = t >= p.t_min && pa >= q[1] && pa <= q[2] && pb >= q[3] &&
                    pb <= q[4];
    if (ok && t < h.t) {
      h.t = t;
      h.nx = ax == 0 ? 1.0f : 0.0f;
      h.ny = ax == 1 ? 1.0f : 0.0f;
      h.nz = ax == 2 ? 1.0f : 0.0f;
      h.kind = static_cast<int>(q[6]);
      h.ar = q[7];
      h.ag = q[8];
      h.ab = q[9];
      h.mat = static_cast<int>(q[10]);
    }
  }
  for (int k = 0; k < p.n_boxes; ++k) {
    // world -> object transform + slab test (box.h + hittable.h wrappers)
    const float* q = sbox + k * kBoxCols;
    const float c = q[6], s = q[7];
    const float ox_t = r.ox - q[8];
    const float oy_t = r.oy - q[9];
    const float oz_t = r.oz - q[10];
    const float ox2 = c * ox_t - s * oz_t;
    const float oz2 = s * ox_t + c * oz_t;
    const float dx2 = c * r.dx - s * r.dz;
    const float dz2 = s * r.dx + c * r.dz;
    const float ivx = 1.0f / guard(dx2);
    const float ivy = 1.0f / guard(r.dy);
    const float ivz = 1.0f / guard(dz2);
    const float tx0 = (q[0] - ox2) * ivx, tx1 = (q[3] - ox2) * ivx;
    const float ty0 = (q[1] - oy_t) * ivy, ty1 = (q[4] - oy_t) * ivy;
    const float tz0 = (q[2] - oz2) * ivz, tz1 = (q[5] - oz2) * ivz;
    const float tnx = fminf(tx0, tx1), tfx = fmaxf(tx0, tx1);
    const float tny = fminf(ty0, ty1), tfy = fmaxf(ty0, ty1);
    const float tnz = fminf(tz0, tz1), tfz = fmaxf(tz0, tz1);
    const float tn = fmaxf(fmaxf(tnx, tny), tnz);
    const float tf = fminf(fminf(tfx, tfy), tfz);
    const float t = tn >= p.t_min ? tn : tf;
    const bool ok = tf > fmaxf(tn, 0.0f) && t >= p.t_min;
    if (ok && t < h.t) {
      // face: the slab whose bound equals t, flipped when exiting
      const bool is_x = t == tnx || t == tfx;
      const bool is_y = t == tny || t == tfy;
      const bool exiting = t == tf;
      const float sx = ((dx2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sy = ((r.dy >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sz = ((dz2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float nobj_x = is_x ? sx : 0.0f;
      const float nobj_y = (!is_x && is_y) ? sy : 0.0f;
      const float nobj_z = (!is_x && !is_y) ? sz : 0.0f;
      h.t = t;
      h.nx = c * nobj_x + s * nobj_z;  // object -> world rotation
      h.ny = nobj_y;
      h.nz = (-s) * nobj_x + c * nobj_z;
      h.kind = static_cast<int>(q[11]);
      h.ar = q[12];
      h.ag = q[13];
      h.ab = q[14];
      h.mat = static_cast<int>(q[15]);
    }
  }
  return h;
}

// The next ray of a lambertian hit at bounce b: set_face_normal + normalize
// (:1413-1419), then n + unit_vector (:1445-1456), and the origin moved to
// the hit point (:1549-1554).
__device__ __forceinline__ void lambertian_bounce(uint32_t rng_base, int b,
                                                  const Hit& h, Ray& r) {
  const float flip =
      (r.dx * h.nx + r.dy * h.ny + r.dz * h.nz) < 0.0f ? 1.0f : -1.0f;
  const float nlen =
      1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-20f));
  const float nx = h.nx * flip * nlen;
  const float ny = h.ny * flip * nlen;
  const float nz = h.nz * flip * nlen;

  const uint32_t draw = rng_base + static_cast<uint32_t>(b * 32) * kDrawMul;
  const float z = 2.0f * uniform01(draw, 0u) - 1.0f;
  const float phi = kTwoPi * uniform01(draw, 1u);
  const float rxy = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  float ldx = nx + rxy * cosf(phi);
  float ldy = ny + rxy * sinf(phi);
  float ldz = nz + z;
  if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
    ldx = nx;
    ldy = ny;
    ldz = nz;
  }
  r.ox = r.ox + h.t * r.dx;
  r.oy = r.oy + h.t * r.dy;
  r.oz = r.oz + h.t * r.dz;
  r.dx = ldx;
  r.dy = ldy;
  r.dz = ldz;
}

__global__ void __launch_bounds__(kThreads)
megakernel_fwd(const float* __restrict__ rects, const float* __restrict__ boxes,
               const RtParams p, float* __restrict__ out_r,
               float* __restrict__ out_g, float* __restrict__ out_b) {
  extern __shared__ float table[];
  stage_tables(rects, boxes, p, table);
  const float* srect = table;
  const float* sbox = table + p.n_rects * kRectCols;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const uint32_t rng_base = pcg_hash(static_cast<uint32_t>(i) ^
                                     (static_cast<uint32_t>(p.seed) * kSeedMix));
  Ray r = camera_ray(p, i, rng_base);

  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int b = 0; b < p.max_depth; ++b) {
    const Hit h = closest_hit(srect, sbox, p, r);
    if (!(h.t < kBig * 0.5f)) {  // miss: background, then the path ends
      lr = lr + tr * p.bg[0];
      lg = lg + tg * p.bg[1];
      lb = lb + tb * p.bg[2];
      break;
    }
    if (h.kind == kDiffuseLight) {  // emission, then the path ends
      lr = lr + tr * h.ar;
      lg = lg + tg * h.ag;
      lb = lb + tb * h.ab;
      break;
    }
    // throughput (:1512-1519), then the next ray
    tr = tr * h.ar;
    tg = tg * h.ag;
    tb = tb * h.ab;
    lambertian_bounce(rng_base, b, h, r);
  }
  out_r[i] = lr;
  out_g[i] = lg;
  out_b[i] = lb;
}

__global__ void __launch_bounds__(kThreads)
megakernel_record(const float* __restrict__ rects,
                  const float* __restrict__ boxes, const RtParams p,
                  int32_t* __restrict__ out_packed) {
  extern __shared__ float table[];
  stage_tables(rects, boxes, p, table);
  const float* srect = table;
  const float* sbox = table + p.n_rects * kRectCols;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const uint32_t rng_base = pcg_hash(static_cast<uint32_t>(i) ^
                                     (static_cast<uint32_t>(p.seed) * kSeedMix));
  Ray r = camera_ray(p, i, rng_base);

  int32_t* out = out_packed + i;
  const size_t stride = static_cast<size_t>(p.n);
  bool alive = true;
  for (int b = 0; b < p.max_depth; ++b) {
    int32_t word = 0;  // a bounce after the path's end records nothing
    if (alive) {
      // hit, cont and miss as at pallas_trace.py:1397-1398 and :1512-1513
      const Hit h = closest_hit(srect, sbox, p, r);
      const bool hit = h.t < kBig * 0.5f;
      alive = hit && h.kind != kDiffuseLight;
      word = hit ? (h.mat | kHitBit | (alive ? kContBit : 0)) : kMissBit;
      if (alive) lambertian_bounce(rng_base, b, h, r);
    }
    out[b * stride] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
pcg_uniform_kernel(uint32_t seed_mix, int lanes, uint32_t salt,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  out[i] = uniform01(pcg_hash(static_cast<uint32_t>(i) ^ seed_mix), salt);
}

// False when `p` is outside what the kernels take; else sets the
// shared-memory bytes of the tables.
bool check_launch(const RtParams& p, size_t* table_bytes) {
  *table_bytes = (static_cast<size_t>(p.n_rects) * kRectCols +
                  static_cast<size_t>(p.n_boxes) * kBoxCols) * sizeof(float);
  return p.n > 0 && p.n_rects >= 0 && p.n_boxes >= 0 && p.img_h > 0 &&
         p.img_w > 0 && p.max_depth >= 0 && p.pix_base >= 0 &&
         *table_bytes <= kMaxTableBytes;
}

}  // namespace

extern "C" int rt_trace_pixels(const float* rects, const float* boxes,
                               RtParams p, float* out_r, float* out_g,
                               float* out_b, void* stream) {
  size_t table_bytes;
  if (!check_launch(p, &table_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n + kThreads - 1) / kThreads;
  megakernel_fwd<<<blocks, kThreads, table_bytes,
                   static_cast<cudaStream_t>(stream)>>>(rects, boxes, p, out_r,
                                                        out_g, out_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_walk_packed_pixels(const float* rects, const float* boxes,
                                     RtParams p, int32_t* out_packed,
                                     void* stream) {
  size_t table_bytes;
  if (!check_launch(p, &table_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n + kThreads - 1) / kThreads;
  megakernel_record<<<blocks, kThreads, table_bytes,
                      static_cast<cudaStream_t>(stream)>>>(rects, boxes, p,
                                                           out_packed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_pcg_uniform(int seed, int lanes, int salt, float* out,
                              void* stream) {
  if (lanes <= 0 || salt < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (lanes + kThreads - 1) / kThreads;
  pcg_uniform_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(seed) * kSeedMix, lanes,
      static_cast<uint32_t>(salt), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
