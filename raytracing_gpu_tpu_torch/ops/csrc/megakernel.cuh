// Path-tracing megakernel for Hopper (sm_90a) in its two modes, forward
// radiance and the record walk, each with its rays made in the kernel from
// the camera or read from ray planes.
//
// Replaces the TPU kernel `_make_kernel` launched by `_run`
// (raytracing_gpu_tpu/ops/pallas_trace.py:821-1643, pl.pallas_call at :1703):
// axis-aligned rects, boxes under
// rotate_y + translate, spheres (static, moving, hollow) in a dense loop up
// to 64 and through a threaded BVH above, triangles through a threaded BVH
// of their own, up to 16 constant media in a sphere or a box; lambertian,
// metal, dielectric,
// diffuse_light and isotropic materials; solid, checker, noise, turbulence
// and marble albedo; russian roulette and the shutter time.  Two kernels
// share one closest hit, one media test, one camera and one scatter, so
// both modes trace the same paths with the same rounding:
//
// - megakernel_fwd, forward mode (shade=True, record=False): per ray
//   radiance over the whole bounce loop, summed over a sample chunk in one
//   launch (the chunk of `compile_renderer`'s megakernel route), or over
//   one wave (`PallasTracer.trace_pixels`, and `__call__` on ray planes),
//   for scenes without image textures, whose atlas the torch shade reads
//   (as the JAX kernel refuses them, `supports_forward`, :229-234).
// - megakernel_record, record mode (record=True, shade=False): per bounce
//   one packed int32 word `mat | hit<<16 | cont<<17 | miss<<18`
//   (pallas_trace.py:1536-1541) and, for scenes whose checker or perlin
//   textures need it (need_p), the hit point in three float32 planes
//   (:1542-1545), and for scenes with image textures (need_uv) the
//   winner's u and v in two more (:1546-1548)
//   (`PallasTracer.walk_packed_pixels`, and `walk_packed` on ray planes).
//
// The rays: made in the kernel by the thin-lens camera (cam=..., kernel 1a
// and 1b), or, when RtParams.rays is set, read from one (7, n) float32 array
// of ray planes, o xyz, d xyz and the shutter time (cam=None, kernel 1c,
// :878-880, :1565-1567); a branch uniform across the launch, not a template
// bit.  Lane i's random numbers are the same function of i and the seed in
// both cases, as in the Pallas kernel's ray-plane mode (:902-907); the
// Pallas kernel pads the planes to whole (8, 128) tiles, and its first n
// lanes are these.
//
// This header holds the device code; the C entry points are in
// megakernel.cu, the forward instantiations are spread over five
// translation units (megakernel.cu: solid albedo; megakernel_checker.cu;
// megakernel_perlin.cu; megakernel_tri.cu and megakernel_tri_perlin.cu: the
// same families with triangles) and the record ones are in
// megakernel_record.cu; nvcc compiles them in parallel.  The host side and
// the plain PyTorch versions of both functions are in ../cuda_trace.py.
//
// Design.  One thread runs one path's bounce loop at a time, leaving it
// when the path dies.  That is what the TPU tile computes: there a (64, 128)
// tile loops until all its lanes are dead, and a dead lane adds nothing
// (pallas_trace.py:1397-1398, 1626-1637).
//
// The forward kernel computes a whole sample chunk in one launch: row r of
// its (n, 3) output is the sum over samples s = 0 .. spp - 1, added in that
// order from 0, of lane r % wave of wave (s, r / wave), seeded
// wave_seed(base, s, r / wave), which is the float32 sum the host added a
// wave at a time, bit for bit.  The TPU's chunk is a sequential map over
// (sample, wave) launches; on the H100 a 65,536-ray wave is 512 blocks, a
// quarter of what the card holds resident, and its lanes idle from their
// path's end to the warp's longest path's.  So the grid is persistent:
// what the card holds resident of the instantiation (its occupancy times
// the SMs, `rt_trace_occupancy`), each thread taking one row and then rows
// from an atomic counter, and tracing each row's samples in order.  When a
// path ends (a miss, a light, metal below the surface, russian roulette or
// the depth) its one radiance term has gone into the row's sum, and the
// thread starts the next sample's camera ray at once, or the next row's
// first after the row's last sample: its lane idles only when no row is
// left.  The bounce body stays one block of code that the warp's live
// lanes run together; ray generation is a branch that some lanes take.
// The per-wave entries are the same kernel on a chunk of one sample and
// one wave, its seed given, a block a 128 rays.  The tables are staged
// once a block, for the whole launch.
//
// The record kernel, likewise, walks every (sample, wave) of a training
// chunk in one launch (`rt_walk_chunk`): ray j of the launch is lane
// j % wave of wave wave0 + j / wave in the chunk's schedule order (sample
// s, wave bid), seeded wave_seed(base, s, bid), and it writes word b to
// out[((j / wave) * depth + b) * wave + j % wave], so the planes of wave
// (s, bid) are the (depth, wave) planes its own launch writes, and the 32
// threads of a warp holding neighbouring rays store one contiguous
// 128-byte line per bounce.  A wave's lanes idle on the H100 from their
// path's end to the warp's longest path's, and a 32,768-ray wave is 256
// blocks, two of the 16 an SM holds; so the grid is persistent, as the
// forward chunk's, and a thread takes the next ray from the counter when
// its path ends.  A thread writes 0 for the bounces after its path's end,
// which takes the place of the TPU kernel's pre-zeroed plane (:1558-1561).
// The per-wave entries are the same kernel on one wave, its seed given, a
// block a 128 rays.  A TPU lane that died inside a
// tile that is still live stores its frozen ray's `mat` with its mask bits
// at zero; a thread here writes 0 instead.  The hit-point planes hold
// o + t d (the expression `surface` computes) where the bounce hit, and 0
// on a miss and after the path's end, where the Pallas kernel leaves
// o + 1e30 d or a frozen ray's point: the shade multiplies those entries by
// 0 either way; so do the uv planes.
//
// The uv planes hold what the Pallas kernel carries through the closest
// hit's candidate order (:930-958): a rect winner's uv from its hit
// coordinates (:970-974), a sphere winner's rotate_y phase in u and a
// sphere flag (:1164-1169), a triangle winner's interpolated uv
// (:1235-1239), 0 for a medium winner (:1392-1395); after the media, a
// sphere winner's uv from its pre-flip outward normal through the
// polynomial acos and atan2 (`sphere_uv`, shared with the hit kernel,
// :1400-1410).  A box winner passes no uv in the Pallas kernel (:1041-1044),
// so it keeps the carried uv of the closest rect hit, or 0: a reference
// quirk kept here (the hit kernel computes the box face's uv instead, as
// the XLA engine does).  The closest hit carries only where the uv comes
// from (Hit.uv: the closest rect so far, or the winner's kind), and
// `hit_uv` computes the same values after the media, so a wave without uv
// planes does no uv arithmetic.  The planes are a runtime branch of the
// launch, as the hit-point planes are, not more instantiations.
//
// The kernels are templates over what the bake uses (kFeat* bits: dense
// spheres, media, the sphere BVH, the triangle BVH, checker albedo, perlin
// albedo), as the JAX kernel
// compiles unused texture families away (`tex_kinds`, :860-866): the
// Cornell box does not carry the sphere loop, the media test or the perlin
// turbulence (7 octaves x 8 hashed corners) in its registers.  The material
// kinds are a branch on the winner's kind: each thread computes only its
// own scatter.
//
// Every primitive record holds the same 12-float shading block (kind, c1,
// c2, scale, fuzz, ir, texk, mat: columns 9-20 of the JAX sphere rows,
// :175-177); the closest hit keeps a pointer to the winner's block instead
// of copying its fields.
//
// What bounds it on Hopper.  Per-thread ALU work, its latency and
// divergence, not bytes: each ray tests every primitive record at every
// bounce (a rect's IEEE divide, a box's three, of which 1 / guard(d.y) is
// every box's and is computed once a ray), draws its random numbers from a
// counter-based hash, and writes 12 bytes a row at the chunk's end
// (forward) or 4 bytes per bounce, 16 with the hit point, 8 more with uv
// (record).  So the records are staged once per block into shared memory,
// where every thread of a warp reads the same word at the same time (a
// broadcast), and the only
// device-memory traffic is the output stores and the ray planes' 28 bytes a
// ray.  A lane whose path has ended takes the next one (both chunk
// launches); a per-wave launch keeps it idle until its warp's longest path
// ends.  (On the H100 the record kernels' bounds come out by bytes, yet
// they ran at 1-3% of them a wave: the divergent walks and the idle
// lanes, not the stores, take the time.)
//
// The sphere BVH (kFeatSphereBvh, kernel 1d's sphere half: the packet walk
// of :1055-1103 over the leaf-contiguous table with leaves of 8,
// :1170-1180).  The TPU walks a (64, 128) tile with one scalar cursor and
// descends where any lane's box is hit; here each thread walks its own ray
// through the same preorder threading (hit_link after a hit box, miss_link
// after a missed one, -1 at the end), slab-testing a node against its own
// closest hit so far (`tn <= t`) and testing the real rows of a hit leaf.
// A lane of a TPU tile tests a leaf only where its own box mask holds, and
// a child's box lies inside its parent's, so both visit a lane's leaves in
// the same order and keep the same winner.  Both BVH walks serve both
// modes: the record instantiations are keyed on the geometry bits and
// kFeatTriBvh only, since the record mode evaluates no albedo.
//
// What bounds the sphere walk on Hopper.  Not bytes or operations (big_scene1's
// 32,768-ray training wave needs ~2.5 us of either): the latency of
// gathers that diverge once the lanes of a warp walk different nodes, each
// warp load touching up to 32 cache lines, and 8-row leaves (a quarter of
// big_scene1's rows are pads) tested by each lane alone.  So a node is one
// 32-byte record (lo xyz and the leaf's first row, hi xyz and its count of real
// rows) read as two float4s with its (hit, miss) link pair as one int2, a
// row's geometry is three float4 loads of its 96-byte row, a leaf tests
// only its real rows (pads sit at its tail), and the warp tests the
// leaves together (`warp_bvh_walk`): the lanes waiting in a leaf are
// served four at a time, a group of 8 lanes each, lane j testing row j of
// its owner's leaf against the owner's broadcast ray, and the group keeps
// the first least distance, which is the serial loop's winner bit for bit.
// Over every wave of a big_scene1 chunk that is 7-11% faster on the H100
// than each lane's own leaf loop over the same records (a wave of the
// image's upper rows, mostly sky, shows the reverse by 1-2%).  So a thread
// with no row left, or whose path has ended, stays in the walk until its
// warp is done (kWarpWalk); in the forward chunk a lane's path ends only
// for the next sample's to start, so the warp's lanes keep the groups full
// until the rows run out.  The tables (672 rows and
// 167 nodes for big_scene1) stay in device memory behind L1: staging them in
// shared memory would cap the scenes the kernel takes.  Rects, boxes and
// media are staged as before.
//
// The triangle BVH (kFeatTriBvh, kernel 1d's triangle half: the packet walk
// of :1187-1289 over the 40-column rows of :128-133, leaves of 4, preorder
// links).  A threaded walk over the same node records, after the spheres,
// one thread a ray with its own leaf loop (`bvh_walk`) over the leaf's real
// rows, with a strict `<` throughout.  (The leaves tested by the warp, as
// the sphere walk's are, by groups of 4 or 8 lanes: whole `triangles`
// chunks 13-35% slower on the H100, a backpack chunk 2-7% faster; a leaf
// holds at most 4 real rows, and a small mesh's lanes rarely wait in
// leaves together.)  Each candidate reads its 9 geometry
// floats (v0 e1 e2, three float4 loads) for Moller-Trumbore with the 1e-7
// determinant cut; the walk keeps only the winner's row and barycentrics
// (ub, vb), and the winner's vertex normals and shading columns are read
// once after the walk.  The normal is interpolated with the expression
// order of :1227-1234, so it rounds as the TPU kernel's per-candidate select
// did (it selects every column per candidate only because it has no
// gather).  The winner's shading block, in this header's order, goes into a
// 12-float array of the thread that the Hit points at.  A 100k-triangle
// mesh's table (~22 MB) and nodes (~1.5 MB) live in device memory: the JAX
// kernel's HBM-streamed leaf tier and its VMEM budget have no counterpart
// here.
//
// Rounding.  The build compiles this code with -fmad=false and without
// --use_fast_math, so every multiply and add rounds on its own, as in the
// plain versions and in XLA; the normal's and the direction's lengths use
// 1.0f / sqrtf(x), not rsqrtf.  cosf/sinf/logf/expf differ from XLA's and
// torch's CPU versions by an ulp here and there, which is why the
// multi-bounce comparisons with the JAX package are stated per pixel.  The
// constants the JAX kernel takes from Python doubles are rounded once to
// float32, on the host (the media records) or as static_cast<float>(double).
//
// The random numbers reproduce the JAX kernel's bit for bit: lane = thread
// index within the call, base = pcg(lane ^ uint32(seed) * 0x85EBCA6B), bounce
// b draws at base + uint32(b * 32) * 0x68E31DA4 (salts 0-1 lambertian, 3-5
// in_sphere, 7 dielectric choice, 8 russian roulette, 16 + i medium i) and
// the camera at base + 0x7F4A7C15 * 0x68E31DA4 (salts 0-1 jitter, 2-3 lens,
// 4 shutter time), all uint32 arithmetic wrapping.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Keep in step with RtParams in ../build.py.
struct RtParams {
  float origin[3], llc[3], hor[3], ver[3], cu[3], cv[3];
  float lens_radius;
  float inv_w, inv_h;  // float32(1 / max(dim - 1, 1))
  float t_min;
  float bg[3];
  float time0, time_span;  // shutter time: time0 + time_span * u if has_time
  int img_h, img_w, pix_base, n, seed, max_depth;
  int n_rects, n_boxes, n_spheres, n_sph_nodes, n_tri_rows, n_tri_nodes;
  int n_sphere_media, n_box_media;
  int has_time, rr_start, features;
  // The forward kernel's chunk: rows [0, n), each the sum of `spp` samples,
  // in waves of `wave` rows (see megakernel_fwd); at most `grid` blocks, 0
  // for one block a kThreads rows.  The per-wave entries set wave = n and
  // spp = 1 (rt_trace_pixels, rt_trace_rays).  The record kernel's chunk:
  // rays [0, n), whole waves of `wave` rays, wave0 + j / wave the wave of
  // ray j in the chunk's schedule order, `waves` waves a sample (see
  // megakernel_record); its per-wave entries set wave = n, waves = 1,
  // wave0 = 0.  Neither kernel reads the other's fields.
  int wave, spp, grid, wave0, waves;
  // kernel 1c: (7, n) ray planes o xyz, d xyz, tm; nullptr: camera rays.
  // The C entries set it (rt_trace_rays, rt_walk_packed).
  const float* rays;
};

// The record tables, in device memory (keep in step with RtTables in
// ../build.py).  A BVH is two arrays: one 32-byte record a node, two
// float4s (lo xyz and the leaf's first row as int bits, -1 on an internal
// node; hi xyz and the leaf's count of real rows as int bits), and its
// preorder (hit, miss) links, one int2 a node.  The sphere BVH's are read
// only by the kFeatSphereBvh instantiations, the triangle rows and their
// BVH's only by the kFeatTriBvh ones.  Every table is 16-byte aligned.
struct RtTables {
  const float* rects;
  const float* boxes;
  const float* spheres;
  const float* media;
  const float4* sph_nodes;
  const int2* sph_links;
  const float* tri_rows;
  const float4* tri_nodes;
  const int2* tri_links;
};

// Instantiation bits (FEAT_* in ../cuda_trace.py).
constexpr unsigned kFeatSpheres = 1, kFeatMedia = 2, kFeatSphereBvh = 4;
constexpr unsigned kFeatChecker = 8, kFeatPerlin = 16, kFeatTriBvh = 32;
constexpr unsigned kFeatGeometry = kFeatSpheres | kFeatMedia | kFeatSphereBvh;

// Forward launchers, one per albedo family without and with triangles, in
// five translation units: `features` selects the instantiation.  Each
// writes the (n, 3) row sums to `out` and claims rows past the grid's first
// pass from `*next_row` (zeroed by the caller; unused, and may be nullptr,
// when the grid covers every row); with `blocks_per_sm` set it launches
// nothing and reports how many blocks of the instantiation an SM holds.
int launch_fwd_solid(const RtTables& t, const RtParams& p, float* out,
                     int* next_row, int* blocks_per_sm, cudaStream_t s);
int launch_fwd_checker(const RtTables& t, const RtParams& p, float* out,
                       int* next_row, int* blocks_per_sm, cudaStream_t s);
int launch_fwd_perlin(const RtTables& t, const RtParams& p, float* out,
                      int* next_row, int* blocks_per_sm, cudaStream_t s);
int launch_fwd_tri_solid(const RtTables& t, const RtParams& p, float* out,
                         int* next_row, int* blocks_per_sm, cudaStream_t s);
int launch_fwd_tri_checker(const RtTables& t, const RtParams& p, float* out,
                           int* next_row, int* blocks_per_sm,
                           cudaStream_t s);
int launch_fwd_tri_perlin(const RtTables& t, const RtParams& p, float* out,
                          int* next_row, int* blocks_per_sm, cudaStream_t s);
// The record planes (megakernel_record): the packed words, and the hit
// point's x, y, z and the uv when a launch asks for them (else nullptr).
struct RecordOut {
  int32_t* packed;
  float *px, *py, *pz, *u, *v;
};

// The record launcher (megakernel_record.cu): `features` holds only the
// geometry bits and kFeatTriBvh; the hit-point planes are all three set or
// all three nullptr, and the uv planes both or neither.  Rays past the
// grid's first pass come from `*next_ray` (zeroed by the caller; may be
// nullptr when the grid covers every ray); with `blocks_per_sm` set it
// launches nothing and reports how many blocks of the instantiation an SM
// holds.
int launch_walk(const RtTables& t, const RtParams& p, const RecordOut& o,
                int* next_ray, int* blocks_per_sm, cudaStream_t s);

namespace rt {

constexpr float kBig = 1e30f;
constexpr float kEps = 1e-12f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kPerlinNorm = static_cast<float>(1.0 / 1.15);
constexpr float kRrFloor = static_cast<float>(0.05);
constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;  // every lane of a warp
constexpr size_t kMaxTableBytes = 48 * 1024;
constexpr int kMaxSpheres = 64;
constexpr int kMaxMedia = 16;
constexpr int kSphLeafK = 8;  // sphere rows per BVH leaf (`_SPH_LEAF_K`)
constexpr int kTriLeafK = 4;  // triangle rows per BVH leaf (`_TRI_LEAF_K`)
constexpr float kTriDet = 1e-7f;  // Moller-Trumbore determinant cut
static_assert(kSphLeafK == 8, "the warp tests four sphere leaves at once");

// record layouts (RECT_COLS ... in ../cuda_trace.py)
constexpr int kShKind = 0, kShC1 = 1, kShC2 = 4, kShScale = 7, kShFuzz = 8;
constexpr int kShIr = 9, kShTexk = 10, kShMat = 11;
constexpr int kRectCols = 18, kRectSh = 6;
constexpr int kBoxCols = 24, kBoxSh = 12;
constexpr int kSphCols = 24, kSphSh = 9;
constexpr int kSphUvPhase = 21;  // a sphere row's uv phase, past its shading
constexpr int kMedCols = 24, kMedSh = 12;
// triangle rows (`_TRI_*`, pallas_trace.py:128-133): v0 e1 e2 | n0 n1 n2 |
// uv0 uv1 uv2 | kind fuzz ir mat | c1 c2 scale texk | pad
constexpr int kTriCols = 40, kTriN0 = 9, kTriUv0 = 18, kTriKind = 24;
constexpr int kTriFuzz = 25;
constexpr int kTriIr = 26, kTriMat = 27, kTriC1 = 28, kTriC2 = 31;
constexpr int kTriScale = 34, kTriTexk = 35;

// material and texture kinds (scene/types.py)
constexpr int kMetal = 1, kDielectric = 2, kDiffuseLight = 3, kIsotropic = 4;
constexpr int kTexChecker = 1, kTexNoise = 2, kTexTurb = 3, kTexMarble = 4;

constexpr int32_t kHitBit = 1 << 16;
constexpr int32_t kContBit = 1 << 17;
constexpr int32_t kMissBit = 1 << 18;
constexpr uint32_t kSeedMix = 0x85EBCA6Bu;
constexpr uint32_t kSaltMul = 0x9E3779B9u;
constexpr uint32_t kDrawMul = 0x68E31DA4u;
constexpr uint32_t kCamDraw = 0x7F4A7C15u * 0x68E31DA4u;  // wraps mod 2^32
// a wave's seed: base + s * 7919 + bid * 104729 (`wave_seed`, cuda_trace.py)
constexpr uint32_t kWaveSample = 7919u, kWaveBatch = 104729u;

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

// float32(max(hi - lo, 1e-12)): the uv divisor the JAX kernel computes in
// Python doubles from float32 bounds, rounded once.
__device__ __forceinline__ float extent(float hi, float lo) {
  return fmaxf(hi - lo, kEps);
}

constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kHalfPi = static_cast<float>(3.14159265358979323846 / 2.0);
constexpr float kInvTwoPi =
    static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);

// Full-quadrant atan2 from the Abramowitz & Stegun 4.4.49 polynomial on
// [0, 1] (_atan2_poly, _atan_unit, :698-719).
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float z = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float z2 = z * z;
  float r = z * (0.9998660f +
                 z2 * (-0.3302995f +
                       z2 * (0.1801410f + z2 * (-0.0851330f + z2 * 0.0208351f))));
  if (ay > ax) r = kHalfPi - r;
  if (x < 0.0f) r = kPi - r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float acos_poly(float x) {
  return atan2_poly(sqrtf(fmaxf(1.0f - x * x, 0.0f)), x);
}

// A sphere's uv (get_sphere_uv, sphere.h:19-32) from its pre-flip outward
// normal, with its rotate_y `phase` added to u and the sum wrapped to
// [0, 1) as jnp.remainder(x, 1) does (the exact fmod, plus 1 below 0);
// both kernels' (:1400-1410, :2197-2201).
__device__ __forceinline__ void sphere_uv(float nx, float ny, float nz,
                                          float phase, float* u, float* v) {
  const float theta = acos_poly(fminf(fmaxf(-ny, -1.0f), 1.0f));
  const float phi = atan2_poly(-nz, nx) + kPi;
  float su = fmodf(phi * kInvTwoPi + phase, 1.0f);
  if (su < 0.0f) su = su + 1.0f;
  *u = su;
  *v = theta * kInvPi;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Where the winner's uv comes from (Hit.uv, `hit_uv`): a rect's index (>= 0),
// or one of these.
constexpr int kUvNone = -1, kUvSphere = -2, kUvTri = -3;

// The winner of the closest-hit test: t (kBig on a miss), outward normal,
// its shading block (nullptr on a miss), and the source of its uv: the
// closest rect so far, which a box winner keeps (see the header), or the
// winner's kind; a triangle winner's row and the barycentric weights of its
// vertices 1 and 2.  A kernel that writes no uv leaves these unread, and
// the compiler drops them.
struct Hit {
  float t, nx, ny, nz;
  const float* sh;
  int uv, tri;
  float bu, bv;
};

// Views of the tables: rects, boxes and media staged in shared memory; the
// spheres there too for the dense loop, in device memory under a BVH.
struct Tables {
  const float *rects, *boxes, *spheres, *media;
  const float4* sph_nodes;
  const int2* sph_links;
  const float* tri_rows;
  const float4* tri_nodes;
  const int2* tri_links;
};

// Copies the four tables into the block's shared memory; every thread of
// the block must call it.
__device__ __forceinline__ Tables stage_tables(const RtTables& t,
                                               const RtParams& p,
                                               float* smem) {
  const int rect_words = p.n_rects * kRectCols;
  const int box_words = p.n_boxes * kBoxCols;
  const int sph_words = p.n_sph_nodes > 0 ? 0 : p.n_spheres * kSphCols;
  const int med_words = (p.n_sphere_media + p.n_box_media) * kMedCols;
  Tables s;
  s.rects = smem;
  s.boxes = s.rects + rect_words;
  s.spheres = p.n_sph_nodes > 0 ? t.spheres : s.boxes + box_words;
  s.media = s.boxes + box_words + sph_words;
  s.sph_nodes = t.sph_nodes;
  s.sph_links = t.sph_links;
  s.tri_rows = t.tri_rows;
  s.tri_nodes = t.tri_nodes;
  s.tri_links = t.tri_links;
  for (int k = threadIdx.x; k < rect_words; k += blockDim.x) smem[k] = t.rects[k];
  for (int k = threadIdx.x; k < box_words; k += blockDim.x)
    smem[rect_words + k] = t.boxes[k];
  for (int k = threadIdx.x; k < sph_words; k += blockDim.x)
    smem[rect_words + box_words + k] = t.spheres[k];
  for (int k = threadIdx.x; k < med_words; k += blockDim.x)
    smem[rect_words + box_words + sph_words + k] = t.media[k];
  __syncthreads();
  return s;
}

// ---- thin-lens camera with shutter time (pallas_trace.py:1569-1611) ----
// Pixel ids past the image clamp to its last pixel; row and column are plain
// integer division (the TPU kernel's float-reciprocal divide is a Mosaic
// workaround).
__device__ __forceinline__ Ray camera_ray(const RtParams& p, int i,
                                          uint32_t rng_base, float* tm) {
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
  *tm = p.has_time ? p.time0 + p.time_span * uniform01(cdraw, 4u) : p.time0;
  Ray r;
  r.ox = p.origin[0] + offx;
  r.oy = p.origin[1] + offy;
  r.oz = p.origin[2] + offz;
  r.dx = p.llc[0] + su * p.hor[0] + sv * p.ver[0] - r.ox;
  r.dy = p.llc[1] + su * p.hor[1] + sv * p.ver[1] - r.oy;
  r.dz = p.llc[2] + su * p.hor[2] + sv * p.ver[2] - r.oz;
  return r;
}

// Lane i's ray from the ray planes (kernel 1c): rays[k * n + i] for o xyz,
// d xyz, tm.
__device__ __forceinline__ Ray plane_ray(const RtParams& p, int i,
                                         float* tm) {
  const float* q = p.rays + i;
  const size_t n = static_cast<size_t>(p.n);
  Ray r;
  r.ox = q[0];
  r.oy = q[n];
  r.oz = q[2 * n];
  r.dx = q[3 * n];
  r.dy = q[4 * n];
  r.dz = q[5 * n];
  *tm = q[6 * n];
  return r;
}

// A lane's first ray: from the ray planes when the launch has them, else
// from the camera.
__device__ __forceinline__ Ray first_ray(const RtParams& p, int i,
                                         uint32_t rng_base, float* tm) {
  return p.rays != nullptr ? plane_ray(p, i, tm)
                           : camera_ray(p, i, rng_base, tm);
}

// World -> object transform of a ray for a box record at q (bmin3 bmax3 cos
// sin off3), then the six slab distances: near/far per axis.  rotate_y
// leaves y alone, so `ivy`, 1 / guard(r.dy), is the same for every box and
// the caller computes it once a ray.
struct Slabs {
  float tnx, tfx, tny, tfy, tnz, tfz, dx2, dz2;
};

__device__ __forceinline__ Slabs box_slabs(const float* q, const Ray& r,
                                           float ivy) {
  const float c = q[6], s = q[7];
  const float ox_t = r.ox - q[8];
  const float oy_t = r.oy - q[9];
  const float oz_t = r.oz - q[10];
  const float ox2 = c * ox_t - s * oz_t;
  const float oz2 = s * ox_t + c * oz_t;
  Slabs b;
  b.dx2 = c * r.dx - s * r.dz;
  b.dz2 = s * r.dx + c * r.dz;
  const float ivx = 1.0f / guard(b.dx2);
  const float ivz = 1.0f / guard(b.dz2);
  const float tx0 = (q[0] - ox2) * ivx, tx1 = (q[3] - ox2) * ivx;
  const float ty0 = (q[1] - oy_t) * ivy, ty1 = (q[4] - oy_t) * ivy;
  const float tz0 = (q[2] - oz2) * ivz, tz1 = (q[5] - oz2) * ivz;
  b.tnx = fminf(tx0, tx1);
  b.tfx = fmaxf(tx0, tx1);
  b.tny = fminf(ty0, ty1);
  b.tfy = fmaxf(ty0, ty1);
  b.tnz = fminf(tz0, tz1);
  b.tfz = fmaxf(tz0, tz1);
  return b;
}

__device__ __forceinline__ Slabs box_slabs(const float* q, const Ray& r) {
  return box_slabs(q, r, 1.0f / guard(r.dy));
}

// The geometry of a sphere row (c0 xyz, c1 xyz, t0 t1 radius): read as
// nine floats from the dense loop's shared-memory table, or as three
// 16-byte loads of the 96-byte row from device memory under a BVH.
struct SphereGeom {
  float c0x, c0y, c0z, c1x, c1y, c1z, t0, t1, rad;
};

__device__ __forceinline__ SphereGeom sphere_geom(const float* q) {
  return SphereGeom{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8]};
}

__device__ __forceinline__ SphereGeom sphere_geom4(const float* q) {
  const float4* v = reinterpret_cast<const float4*>(q);
  const float4 a = v[0], b = v[1], c = v[2];
  return SphereGeom{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
}

// The nearest root past t_min of sphere g along the ray (sphere_candidate,
// :1105-1168), kBig where none: the center moves to the ray's shutter time,
// and an all-zero pad row of the BVH's leaf-contiguous table never hits
// (radius 0).  The moved center goes to c.
__device__ __forceinline__ float sphere_distance(const SphereGeom& g,
                                                 const Ray& r, float tm,
                                                 float a, float inv_a,
                                                 float t_min, float* cx,
                                                 float* cy, float* cz) {
  const float span = g.t1 - g.t0;
  const float denom = fabsf(span) < kEps ? 1.0f : span;
  const float frac = (tm - g.t0) / denom;
  *cx = g.c0x + frac * (g.c1x - g.c0x);
  *cy = g.c0y + frac * (g.c1y - g.c0y);
  *cz = g.c0z + frac * (g.c1z - g.c0z);
  const float ocx = r.ox - *cx, ocy = r.oy - *cy, ocz = r.oz - *cz;
  const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - g.rad * g.rad;
  const float disc = hb * hb - a * cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float near = (-hb - sq) * inv_a;
  const float far = (-hb + sq) * inv_a;
  const bool has = disc > 0.0f && fabsf(g.rad) > 0.0f;
  return (has && near >= t_min) ? near
         : ((has && far >= t_min) ? far : kBig);
}

// The outward normal of sphere g (center c) at distance t along the ray; a
// negative radius turns it inward.
__device__ __forceinline__ void sphere_normal(const SphereGeom& g,
                                              const Ray& r, float t, float cx,
                                              float cy, float cz, float* nx,
                                              float* ny, float* nz) {
  const float inv_r = 1.0f / (fabsf(g.rad) < kEps ? 1.0f : g.rad);
  *nx = (r.ox + t * r.dx - cx) * inv_r;
  *ny = (r.oy + t * r.dy - cy) * inv_r;
  *nz = (r.oz + t * r.dz - cz) * inv_r;
}

// One sphere row q of the dense loop against the ray, kept when strictly
// closer than h.
__device__ __forceinline__ void sphere_candidate(const float* q, const Ray& r,
                                                 float tm, float a,
                                                 float inv_a, float t_min,
                                                 Hit& h) {
  const SphereGeom g = sphere_geom(q);
  float cx, cy, cz;
  const float t = sphere_distance(g, r, tm, a, inv_a, t_min, &cx, &cy, &cz);
  if (t < kBig * 0.5f && t < h.t) {
    h.t = t;
    sphere_normal(g, r, t, cx, cy, cz, &h.nx, &h.ny, &h.nz);
    h.sh = q + kSphSh;
    h.uv = kUvSphere;
  }
}

// A BVH in device memory (see RtTables): the 32-byte node records and the
// (hit, miss) link pairs, `stride` pairs a node, of which the walk follows
// pair `link`: 0 of 1 in the megakernel's preorder threading, the ray's
// direction octant of 8 in the hit kernel's.
struct BvhNodes {
  const float4* rec;
  const int2* links;
  int stride, link;
};

// One node test of a walk (packet_walk, :1055-1103): the node is hit when
// its slab interval starts no farther than the closest hit so far
// (`t_best`); `start` is a hit leaf's first row (else -1) and `count` its
// real rows; `next` the link that the test picks.  Three loads: the two
// halves of the record and the link pair.
struct NodeVisit {
  int start, count, next;
};

__device__ __forceinline__ NodeVisit visit_node(const BvhNodes& nodes,
                                                int node, const Ray& r,
                                                float ivx, float ivy,
                                                float ivz, float t_min,
                                                float t_best) {
  const float4 lo = nodes.rec[2 * node];
  const float4 hi = nodes.rec[2 * node + 1];
  const int2 ln = nodes.links[node * nodes.stride + nodes.link];
  const float tx0 = (lo.x - r.ox) * ivx, tx1 = (hi.x - r.ox) * ivx;
  const float ty0 = (lo.y - r.oy) * ivy, ty1 = (hi.y - r.oy) * ivy;
  const float tz0 = (lo.z - r.oz) * ivz, tz1 = (hi.z - r.oz) * ivz;
  const float tn =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  const bool hit = tf >= fmaxf(tn, t_min) && tn <= t_best;
  const int first = __float_as_int(lo.w);
  NodeVisit v;
  v.start = hit ? first : -1;
  v.count = __float_as_int(hi.w);
  v.next = hit ? ln.x : ln.y;
  return v;
}

// The threaded walk of one ray by one thread: `leaf(first row, count)`
// tests a hit leaf's rows and may lower `t_best`.  The megakernel's
// triangle BVH (leaves of 4) takes it.
template <class Leaf>
__device__ __forceinline__ void bvh_walk(const BvhNodes& nodes, const Ray& r,
                                         float ivx, float ivy, float ivz,
                                         float t_min, const float& t_best,
                                         Leaf leaf) {
  int node = 0;
  while (node >= 0) {
    const NodeVisit v =
        visit_node(nodes, node, r, ivx, ivy, ivz, t_min, t_best);
    if (v.start >= 0) leaf(v.start, v.count);
    node = v.next;
  }
}

// A row that one lane tests for a leaf's owner: accepted (`ok`) when it
// beats the owner's closest hit, with its distance and three floats that
// the owner takes if it wins (a sphere's normal, a triangle's weights).
struct Cand {
  bool ok;
  float t, a, b, c;
};

// A float's order as an unsigned key (ties: -0 and +0 equal).
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The threaded walk of the warp's 32 rays, one a lane, with the leaves
// tested by the whole warp.  Each lane steps through its own ray's
// threading with the node test of `visit_node`; a lane with no node
// (`live` false: a dead ray, or a thread past the wave's end) only takes
// part.  In each step the lanes that reached a hit leaf are served, lowest
// lane first, 32 / G at a time: the warp splits into groups of G lanes,
// group g takes the g-th waiting lane's ray and closest hit, its lane j
// tests row `start + j` for j < count (`test(ray, owner, row, valid,
// t_best)`, called by every lane, which may broadcast more of the owner's
// state), and the group's least accepted distance wins, its lowest lane
// among equals.  That is the row a serial loop over the leaf with a strict
// `<` keeps, bit for bit; the owner lowers `t_best` to it and calls
// `take(row, t, a, b, c)`.  Every lane of the warp must call this function
// (the intrinsics name all 32), and a leaf holds at most G rows.
template <int G, class Test, class Take>
__device__ __forceinline__ void warp_bvh_walk(const BvhNodes& nodes,
                                              bool live, const Ray& r,
                                              float ivx, float ivy, float ivz,
                                              float t_min, float& t_best,
                                              Test test, Take take) {
  static_assert(G == 8 || G == 16 || G == 32, "groups tile the warp");
  constexpr int kOwners = 32 / G;  // leaves served a pass
  constexpr unsigned kGroupBits = G == 32 ? kFullMask : (1u << G) - 1u;
  const int lane = threadIdx.x & 31;
  const int group = lane / G;
  int node = live ? 0 : -1;
  while (__any_sync(kFullMask, node >= 0)) {
    int start = -1, count = 0;
    if (node >= 0) {
      const NodeVisit v =
          visit_node(nodes, node, r, ivx, ivy, ivz, t_min, t_best);
      start = v.start;
      count = v.count;
      node = v.next;
    }
    unsigned waiting = __ballot_sync(kFullMask, start >= 0);
    while (waiting != 0) {
      // this pass serves the first kOwners waiting lanes, group g the g-th
      unsigned mine = waiting;
      for (int g = 0; g < group; ++g) mine &= mine - 1u;
      const bool serving = mine != 0;
      const int owner = serving ? __ffs(mine) - 1 : lane;
      const int rank = __popc(waiting & ((1u << lane) - 1u));
      const bool served = ((waiting >> lane) & 1u) && rank < kOwners;
      for (int k = 0; k < kOwners; ++k) waiting &= waiting - 1u;
      Ray rb;
      rb.ox = __shfl_sync(kFullMask, r.ox, owner);
      rb.oy = __shfl_sync(kFullMask, r.oy, owner);
      rb.oz = __shfl_sync(kFullMask, r.oz, owner);
      rb.dx = __shfl_sync(kFullMask, r.dx, owner);
      rb.dy = __shfl_sync(kFullMask, r.dy, owner);
      rb.dz = __shfl_sync(kFullMask, r.dz, owner);
      const int first = __shfl_sync(kFullMask, start, owner);
      const int n = __shfl_sync(kFullMask, count, owner);
      const float tb = __shfl_sync(kFullMask, t_best, owner);
      const int j = lane - group * G;
      const Cand c = test(rb, owner, first + j, serving && j < n, tb);
      const unsigned key = c.ok ? order_key(c.t) : 0xffffffffu;
      unsigned least;
      if (G == 32) {
        least = __reduce_min_sync(kFullMask, key);
      } else {
        least = key;
        for (int off = G / 2; off > 0; off >>= 1)
          least = min(least, __shfl_xor_sync(kFullMask, least, off));
      }
      const unsigned won = __ballot_sync(kFullMask, c.ok && key == least);
      if (won != 0) {  // uniform across the warp
        // the lane that won in the group serving this lane, if any
        const int g = served ? rank : group;
        const unsigned gwon = (won >> (g * G)) & kGroupBits;
        const int w = gwon != 0 ? g * G + __ffs(gwon) - 1 : lane;
        const float t = __shfl_sync(kFullMask, c.t, w);
        const float ca = __shfl_sync(kFullMask, c.a, w);
        const float cb = __shfl_sync(kFullMask, c.b, w);
        const float cc = __shfl_sync(kFullMask, c.c, w);
        if (served && gwon != 0) {
          t_best = t;
          take(start + (w - g * G), t, ca, cb, cc);
        }
      }
    }
  }
}

// The threaded sphere-BVH walk (kernel 1d's sphere half, the leaves of
// :1170-1180) of the warp's rays over the leaf-contiguous table `spheres`,
// each against its closest hit so far h; every lane of the warp calls it,
// `live` false for a lane with no ray.  Shared by the megakernel (preorder
// links) and the hit kernel (octant links).
__device__ __forceinline__ void sphere_bvh_walk(const BvhNodes& nodes,
                                                const float* spheres,
                                                bool live, const Ray& r,
                                                float tm, float a,
                                                float inv_a, float t_min,
                                                Hit& h) {
  const float ivx = 1.0f / guard(r.dx);
  const float ivy = 1.0f / guard(r.dy);
  const float ivz = 1.0f / guard(r.dz);
  warp_bvh_walk<kSphLeafK>(
      nodes, live, r, ivx, ivy, ivz, t_min, h.t,
      [&](const Ray& rb, int owner, int row, bool valid, float tb) {
        const float tmb = __shfl_sync(kFullMask, tm, owner);
        const float ab = __shfl_sync(kFullMask, a, owner);
        const float inv_ab = __shfl_sync(kFullMask, inv_a, owner);
        Cand c{false, kBig, 0.0f, 0.0f, 0.0f};
        if (valid) {
          const SphereGeom g = sphere_geom4(spheres + row * kSphCols);
          float cx, cy, cz;
          const float t =
              sphere_distance(g, rb, tmb, ab, inv_ab, t_min, &cx, &cy, &cz);
          if (t < kBig * 0.5f && t < tb) {
            c.ok = true;
            c.t = t;
            sphere_normal(g, rb, t, cx, cy, cz, &c.a, &c.b, &c.c);
          }
        }
        return c;
      },
      [&](int row, float, float nx, float ny, float nz) {
        h.nx = nx;
        h.ny = ny;
        h.nz = nz;
        h.sh = spheres + row * kSphCols + kSphSh;
        h.uv = kUvSphere;
      });
}

// A triangle candidate's geometry v0 e1 e2, three 16-byte loads from a
// 16-byte aligned row: the hit kernel's 48-byte slot (v0 e1 e2 and three
// zeros) or the first 48 bytes of a megakernel row.
struct TriGeom {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ TriGeom tri_geom4(const float* q) {
  const float4* v = reinterpret_cast<const float4*>(q);
  const float4 a = v[0], b = v[1], c = v[2];
  return TriGeom{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
}

// Moller-Trumbore (reference triangle.h:120-178, :1193-1250) of one
// candidate g against the ray: true when it is hit at t >= t_min inside the
// triangle, with t and the barycentric weights (ub, vb) of vertices 1 and
// 2.  A degenerate triangle, or an all-zero pad row, fails the determinant
// cut.
__device__ __forceinline__ bool tri_candidate(const TriGeom& g, const Ray& r,
                                              float t_min, float* t,
                                              float* ub, float* vb) {
  const float hx = r.dy * g.e2z - r.dz * g.e2y;
  const float hy = r.dz * g.e2x - r.dx * g.e2z;
  const float hz = r.dx * g.e2y - r.dy * g.e2x;
  const float a = g.e1x * hx + g.e1y * hy + g.e1z * hz;
  const float f = 1.0f / (fabsf(a) < kTriDet ? kTriDet : a);
  const float sx = r.ox - g.v0x, sy = r.oy - g.v0y, sz = r.oz - g.v0z;
  *ub = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * g.e1z - sz * g.e1y;
  const float qy = sz * g.e1x - sx * g.e1z;
  const float qz = sx * g.e1y - sy * g.e1x;
  *vb = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  *t = f * (g.e2x * qx + g.e2y * qy + g.e2z * qz);
  return fabsf(a) > kTriDet && *ub >= 0.0f && *ub <= 1.0f && *vb >= 0.0f &&
         *ub + *vb <= 1.0f && *t >= t_min;
}

// The triangle walk of one ray (kernel 1d's triangle half, :1252-1289)
// after every other primitive, one thread a ray over the real rows of each
// hit leaf: a triangle strictly closer than h wins, its normal the vertex
// normals weighted by (1 - ub - vb, ub, vb) and its shading block copied
// into `tri_sh`, which h.sh then points at.
__device__ __forceinline__ void tri_bvh_walk(const Tables& s, const Ray& r,
                                             float t_min, float* tri_sh,
                                             Hit& h) {
  const float ivx = 1.0f / guard(r.dx);
  const float ivy = 1.0f / guard(r.dy);
  const float ivz = 1.0f / guard(r.dz);
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  bvh_walk(BvhNodes{s.tri_nodes, s.tri_links, 1, 0}, r, ivx, ivy, ivz, t_min,
           h.t, [&](int start, int count) {
             for (int k = 0; k < count; ++k) {
               float t, ub, vb;
               if (tri_candidate(tri_geom4(s.tri_rows + (start + k) * kTriCols),
                                 r, t_min, &t, &ub, &vb) &&
                   t < h.t) {
                 h.t = t;
                 best = start + k;
                 bu = ub;
                 bv = vb;
               }
             }
           });
  if (best < 0) return;
  const float* q = s.tri_rows + best * kTriCols + kTriN0;
  const float wb = 1.0f - bu - bv;
  h.nx = wb * q[0] + bu * q[3] + bv * q[6];
  h.ny = wb * q[1] + bu * q[4] + bv * q[7];
  h.nz = wb * q[2] + bu * q[5] + bv * q[8];
  q = s.tri_rows + best * kTriCols;
  h.uv = kUvTri;
  h.tri = best;
  h.bu = bu;
  h.bv = bv;
  tri_sh[kShKind] = q[kTriKind];
  for (int c = 0; c < 3; ++c) {
    tri_sh[kShC1 + c] = q[kTriC1 + c];
    tri_sh[kShC2 + c] = q[kTriC2 + c];
  }
  tri_sh[kShScale] = q[kTriScale];
  tri_sh[kShFuzz] = q[kTriFuzz];
  tri_sh[kShIr] = q[kTriIr];
  tri_sh[kShTexk] = q[kTriTexk];
  tri_sh[kShMat] = q[kTriMat];
  h.sh = tri_sh;
}

// Where the ray crosses rect row q's plane: t and the two varying
// coordinates, in ascending axis order (yz, xz, xy).
struct RectCross {
  float t, pa, pb;
  int ax;
};

__device__ __forceinline__ RectCross rect_cross(const float* q, const Ray& r) {
  RectCross c;
  c.ax = static_cast<int>(q[0]);
  const float o_k = c.ax == 0 ? r.ox : (c.ax == 1 ? r.oy : r.oz);
  const float d_k = c.ax == 0 ? r.dx : (c.ax == 1 ? r.dy : r.dz);
  c.t = (q[5] - o_k) / guard(d_k);
  const float oa = c.ax == 0 ? r.oy : r.ox, da = c.ax == 0 ? r.dy : r.dx;
  const float ob = c.ax == 2 ? r.oy : r.oz, db = c.ax == 2 ? r.dy : r.dz;
  c.pa = oa + c.t * da;
  c.pb = ob + c.t * db;
  return c;
}

// ---- closest hit: rects, boxes, spheres, then triangles, strict <
// (:961-1289); a triangle winner's shading block goes into `tri_sh`.  Every
// lane of the warp calls it, for the sphere-BVH walk; a lane with no ray
// (`live` false) tests nothing and gets a miss ----
template <unsigned F>
__device__ __forceinline__ Hit closest_hit(const Tables& s, const RtParams& p,
                                           const Ray& r, float tm,
                                           float* tri_sh, bool live) {
  Hit h;
  h.t = kBig;
  h.nx = h.ny = h.nz = 0.0f;
  h.sh = nullptr;
  h.uv = kUvNone;
  const int n_rects = live ? p.n_rects : 0;
  const int n_boxes = live ? p.n_boxes : 0;
  for (int k = 0; k < n_rects; ++k) {
    const float* q = s.rects + k * kRectCols;
    const RectCross c = rect_cross(q, r);
    const bool ok = c.t >= p.t_min && c.pa >= q[1] && c.pa <= q[2] &&
                    c.pb >= q[3] && c.pb <= q[4];
    if (ok && c.t < h.t) {
      h.t = c.t;
      h.nx = c.ax == 0 ? 1.0f : 0.0f;
      h.ny = c.ax == 1 ? 1.0f : 0.0f;
      h.nz = c.ax == 2 ? 1.0f : 0.0f;
      h.sh = q + kRectSh;
      h.uv = k;
    }
  }
  // every box's 1 / guard(r.dy) (box_slabs), only where there are boxes
  const float ivy = n_boxes > 0 ? 1.0f / guard(r.dy) : 0.0f;
  for (int k = 0; k < n_boxes; ++k) {
    // world -> object transform + slab test (box.h + hittable.h wrappers)
    const float* q = s.boxes + k * kBoxCols;
    const Slabs b = box_slabs(q, r, ivy);
    const float tn = fmaxf(fmaxf(b.tnx, b.tny), b.tnz);
    const float tf = fminf(fminf(b.tfx, b.tfy), b.tfz);
    const float t = tn >= p.t_min ? tn : tf;
    const bool ok = tf > fmaxf(tn, 0.0f) && t >= p.t_min;
    if (ok && t < h.t) {
      // face: the slab whose bound equals t, flipped when exiting
      const bool is_x = t == b.tnx || t == b.tfx;
      const bool is_y = t == b.tny || t == b.tfy;
      const bool exiting = t == tf;
      const float sx = ((b.dx2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sy = ((r.dy >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sz = ((b.dz2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float nobj_x = is_x ? sx : 0.0f;
      const float nobj_y = (!is_x && is_y) ? sy : 0.0f;
      const float nobj_z = (!is_x && !is_y) ? sz : 0.0f;
      const float c = q[6], sn = q[7];
      h.t = t;
      h.nx = c * nobj_x + sn * nobj_z;  // object -> world rotation
      h.ny = nobj_y;
      h.nz = (-sn) * nobj_x + c * nobj_z;
      h.sh = q + kBoxSh;  // no uv: the closest rect's stays (see the header)
    }
  }
  if (F & (kFeatSpheres | kFeatSphereBvh)) {
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / fmaxf(a, kEps);
    if (F & kFeatSpheres) {  // dense sphere loop
      for (int k = 0; k < (live ? p.n_spheres : 0); ++k)
        sphere_candidate(s.spheres + k * kSphCols, r, tm, a, inv_a, p.t_min,
                         h);
    } else {
      sphere_bvh_walk(BvhNodes{s.sph_nodes, s.sph_links, 1, 0}, s.spheres,
                      live, r, tm, a, inv_a, p.t_min, h);
    }
  }
  if ((F & kFeatTriBvh) && live) tri_bvh_walk(s, r, p.t_min, tri_sh, h);
  return h;
}

// The uv planes' value for the winner h of ray r (see the header): a rect's
// coordinates over its extents (:970-974), recomputed as the test computed
// them; a sphere's from its pre-flip outward normal and phase; a
// triangle's vertex uvs weighted as its normal (:1235-1239); 0 for a medium
// or a box with no rect before it.
template <unsigned F>
__device__ __forceinline__ void hit_uv(const Tables& s, const Ray& r,
                                       const Hit& h, float* u, float* v) {
  *u = 0.0f;
  *v = 0.0f;
  if (h.uv >= 0) {
    const float* q = s.rects + h.uv * kRectCols;
    const RectCross c = rect_cross(q, r);
    *u = (c.pa - q[1]) / extent(q[2], q[1]);
    *v = (c.pb - q[3]) / extent(q[4], q[3]);
  } else if ((F & (kFeatSpheres | kFeatSphereBvh)) && h.uv == kUvSphere) {
    sphere_uv(h.nx, h.ny, h.nz, h.sh[kSphUvPhase - kSphSh], u, v);
  } else if ((F & kFeatTriBvh) && h.uv == kUvTri) {
    const float* q = s.tri_rows + h.tri * kTriCols + kTriUv0;
    const float wb = 1.0f - h.bu - h.bv;
    *u = wb * q[0] + h.bu * q[2] + h.bv * q[4];
    *v = wb * q[1] + h.bu * q[3] + h.bv * q[5];
  }
}

// ---- constant media (constant_medium.h:34-70, :1297-1395) ----
// Per boundary: its [enter, exit] interval clipped by the closest solid
// hit, and an exponential free path drawn with salt 16 + index; the nearest
// scatter event wins over the surface, with the arbitrary normal (1, 0, 0).
// Record: nid | sphere: c0 xyz, c1 - c0 xyz, t0, 1 / (t1 - t0), radius^2,
// or box: bmin3 bmax3 cos sin off3 | shading; sphere media come first.
__device__ __forceinline__ void media_hit(const Tables& s, const RtParams& p,
                                          const Ray& r, float tm,
                                          uint32_t draw, Hit& h) {
  const float d_len = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const float inv_dlen = 1.0f / fmaxf(d_len, 1e-30f);
  float m_t = kBig;
  const float* m_sh = nullptr;
  const int n_media = p.n_sphere_media + p.n_box_media;
  const float ivy = p.n_box_media > 0 ? 1.0f / guard(r.dy) : 0.0f;
  for (int im = 0; im < n_media; ++im) {
    const float* q = s.media + im * kMedCols;
    float lo, hi;
    bool exists;
    if (im < p.n_sphere_media) {
      const float frac = (tm - q[7]) * q[8];
      const float ocx = r.ox - (q[1] + frac * q[4]);
      const float ocy = r.oy - (q[2] + frac * q[5]);
      const float ocz = r.oz - (q[3] + frac * q[6]);
      const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - q[9];
      const float disc = hb * hb - a * cc;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float inv_a = 1.0f / fmaxf(a, kEps);
      lo = (-hb - sq) * inv_a;
      hi = (-hb + sq) * inv_a;
      exists = disc > 0.0f;
    } else {
      const Slabs b = box_slabs(q + 1, r, ivy);
      lo = fmaxf(fmaxf(b.tnx, b.tny), b.tnz);
      hi = fminf(fminf(b.tfx, b.tfy), b.tfz);
      exists = hi > lo;
    }
    const float enter = fmaxf(lo, p.t_min);
    const float exit = fminf(hi, h.t);
    const float seg = (exit - enter) * d_len;
    const float u_fp = fmaxf(uniform01(draw, 16u + im), kEps);
    const float hit_dist = q[0] * logf(u_fp);
    const float t_m = enter + hit_dist * inv_dlen;
    if (exists && exit > enter && hit_dist <= seg && t_m < m_t) {
      m_t = t_m;
      m_sh = q + kMedSh;
    }
  }
  if (m_t < h.t) {
    h.t = m_t;
    h.nx = 1.0f;
    h.ny = 0.0f;
    h.nz = 0.0f;
    h.sh = m_sh;
    h.uv = kUvNone;
  }
}

// ---- hash-gradient perlin (scene/perlin.py, :732-779) ----
__device__ __forceinline__ uint32_t hash3(int i, int j, int k) {
  return pcg_hash(static_cast<uint32_t>(i) * 0x8DA6B343u ^
                  static_cast<uint32_t>(j) * 0xD8163841u ^
                  static_cast<uint32_t>(k) * 0xCB1AB31Fu);
}

__device__ __forceinline__ float grad_dot(uint32_t hash, float x, float y,
                                          float z) {
  const int h = static_cast<int>(hash & 15u);
  float u = h < 8 ? x : y;
  float v = h < 4 ? y : ((h == 12 || h == 14) ? x : z);
  u = (h & 1) == 0 ? u : -u;
  v = (h & 2) == 0 ? v : -v;
  return u + v;
}

__device__ inline float noise3(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float u = px - fx, v = py - fy, w = pz - fz;
  // float -> int truncates toward zero, as astype(int32); floors are exact
  const int i = static_cast<int>(fx);
  const int j = static_cast<int>(fy);
  const int k = static_cast<int>(fz);
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const float wi = di ? uu : (1.0f - uu);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wj = dj ? vv : (1.0f - vv);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float wk = dk ? ww : (1.0f - ww);
        const float g = grad_dot(hash3(i + di, j + dj, k + dk),
                                 u - static_cast<float>(di),
                                 v - static_cast<float>(dj),
                                 w - static_cast<float>(dk));
        accum = accum + wi * wj * wk * g;
      }
    }
  }
  return accum * kPerlinNorm;
}

__device__ inline float turb3(float px, float py, float pz) {
  float accum = 0.0f, weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    accum = accum + weight * noise3(px, py, pz);
    weight *= 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  return fabsf(accum);
}

// ---- deferred albedo of the winner at p (_deferred_albedo, :782-818) ----
template <unsigned F>
__device__ __forceinline__ void albedo(const float* sh, float px, float py,
                                       float pz, float& ar, float& ag,
                                       float& ab) {
  ar = sh[kShC1];
  ag = sh[kShC1 + 1];
  ab = sh[kShC1 + 2];
  if (!(F & (kFeatChecker | kFeatPerlin))) return;
  const int texk = static_cast<int>(sh[kShTexk]);
  const float scale = sh[kShScale];
  if ((F & kFeatChecker) && texk == kTexChecker) {
    const float sines =
        sinf(scale * px) * sinf(scale * py) * sinf(scale * pz);
    if (sines < 0.0f) {
      ar = sh[kShC2];
      ag = sh[kShC2 + 1];
      ab = sh[kShC2 + 2];
    }
  }
  if ((F & kFeatPerlin) && texk >= kTexNoise && texk <= kTexMarble) {
    const float spx = scale * px, spy = scale * py, spz = scale * pz;
    float gray;
    if (texk == kTexNoise) {
      gray = 0.5f * (1.0f + noise3(spx, spy, spz));
    } else {
      const float turb = turb3(spx, spy, spz);
      gray = texk == kTexTurb ? turb
                              : 0.5f * (1.0f + sinf(scale * pz + 10.0f * turb));
    }
    ar = ag = ab = gray;
  }
}

// Uniform direction on the sphere from salts salt, salt + 1 (_unit_vector).
__device__ __forceinline__ void unit_vector(uint32_t draw, uint32_t salt,
                                            float& x, float& y, float& z) {
  z = 2.0f * uniform01(draw, salt) - 1.0f;
  const float phi = kTwoPi * uniform01(draw, salt + 1u);
  const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  x = r * cosf(phi);
  y = r * sinf(phi);
}

// Uniform point in the unit ball from salts 3-5 (_in_sphere, :690-695):
// u^(1/3) as exp(log(u) / 3).
__device__ __forceinline__ void in_sphere(uint32_t draw, float& x, float& y,
                                          float& z) {
  unit_vector(draw, 3u, x, y, z);
  const float u = fmaxf(uniform01(draw, 5u), kEps);
  const float r = expf(logf(u) * kThird);
  x = r * x;
  y = r * y;
  z = r * z;
}

// The scattered direction of a hit of material `kind` (:1444-1513); false
// when the path ends there (metal below the surface).  n is the unit normal
// against the ray, `front` whether the ray met the outward normal's side.
__device__ __forceinline__ bool scatter(int kind, const float* sh, bool front,
                                        float nx, float ny, float nz,
                                        uint32_t draw, Ray& r) {
  float x, y, z;
  if (kind == kIsotropic) {
    in_sphere(draw, x, y, z);
  } else if (kind == kMetal || kind == kDielectric) {
    // reflect(unit(d), n)
    const float dlen =
        1.0f / sqrtf(fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-20f));
    const float udx = r.dx * dlen, udy = r.dy * dlen, udz = r.dz * dlen;
    const float dn = udx * nx + udy * ny + udz * nz;
    const float rx = udx - 2.0f * dn * nx;
    const float ry = udy - 2.0f * dn * ny;
    const float rz = udz - 2.0f * dn * nz;
    if (kind == kMetal) {
      in_sphere(draw, x, y, z);
      const float fuzz = sh[kShFuzz];
      x = rx + fuzz * x;
      y = ry + fuzz * y;
      z = rz + fuzz * z;
      if (!((x * nx + y * ny + z * nz) > 0.0f)) return false;
    } else {
      const float ir = sh[kShIr];
      const float ratio = front ? 1.0f / ir : ir;
      const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const bool cannot = ratio * sin_t > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float om = 1.0f - cos_t;
      const float om2 = om * om;
      const float schlick = r0 + (1.0f - r0) * om2 * om2 * om;
      if (cannot || schlick > uniform01(draw, 7u)) {
        x = rx;
        y = ry;
        z = rz;
      } else {
        const float perx = ratio * (udx + cos_t * nx);
        const float pery = ratio * (udy + cos_t * ny);
        const float perz = ratio * (udz + cos_t * nz);
        const float k2 =
            fmaxf(1.0f - (perx * perx + pery * pery + perz * perz), 0.0f);
        const float par = -sqrtf(k2);
        x = perx + par * nx;
        y = pery + par * ny;
        z = perz + par * nz;
      }
    }
  } else {  // lambertian: n + unit vector, n itself when degenerate
    unit_vector(draw, 0u, x, y, z);
    x = nx + x;
    y = ny + y;
    z = nz + z;
    if (fabsf(x) < 1e-8f && fabsf(y) < 1e-8f && fabsf(z) < 1e-8f) {
      x = nx;
      y = ny;
      z = nz;
    }
  }
  r.dx = x;
  r.dy = y;
  r.dz = z;
  return true;
}

// One bounce's surface: set_face_normal + normalize (:1413-1423) into n,
// the hit point into p; returns `front`.
__device__ __forceinline__ bool surface(const Hit& h, const Ray& r, float& nx,
                                        float& ny, float& nz, float& px,
                                        float& py, float& pz) {
  const bool front = (r.dx * h.nx + r.dy * h.ny + r.dz * h.nz) < 0.0f;
  const float flip = front ? 1.0f : -1.0f;
  const float nlen =
      1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-20f));
  nx = h.nx * flip * nlen;
  ny = h.ny * flip * nlen;
  nz = h.nz * flip * nlen;
  px = r.ox + h.t * r.dx;
  py = r.oy + h.t * r.dy;
  pz = r.oz + h.t * r.dz;
  return front;
}

// Closest hit over the surfaces, then the media, for bounce draw `draw`;
// every lane of the warp calls it (`closest_hit`).
template <unsigned F>
__device__ __forceinline__ Hit scene_hit(const Tables& s, const RtParams& p,
                                         const Ray& r, float tm,
                                         uint32_t draw, float* tri_sh,
                                         bool live) {
  Hit h = closest_hit<F>(s, p, r, tm, tri_sh, live);
  if ((F & kFeatMedia) && live) media_hit(s, p, r, tm, draw, h);
  return h;
}

__device__ __forceinline__ uint32_t draw_window(uint32_t rng_base, int b) {
  return rng_base + static_cast<uint32_t>(b * 32) * kDrawMul;
}

// With the sphere BVH (kWarpWalk), whose walk is the warp's, every thread
// stays until its whole warp is done: a thread whose path has ended, or
// that has no ray (no row or ray left in a chunk, past the wave's end),
// goes through each bounce's closest hit with no ray.  Without it a
// thread leaves when its work is done.
template <unsigned F>
constexpr bool kWarpWalk = (F & kFeatSphereBvh) != 0;

// One path of the forward kernel: its ray and shutter time, its random
// stream, throughput and bounce.  A path gains radiance once, where it ends
// on a miss or a light, so it carries none: that term goes straight into
// its row's sum (`bounce`).
struct Path {
  Ray r;
  float tm;
  uint32_t rng_base;
  float tr, tg, tb;
  int b;
};

// A row's sum over its samples so far.
struct Sum {
  float r, g, b;
};

// Starts the path of sample s of chunk row `row`: lane row % wave of wave
// bid = row / wave, seeded wave_seed(p.seed, s, bid) (uint32 arithmetic
// wrapping, as the int32 seed of a per-wave launch), its camera ray made
// for pixel p.pix_base + row, or read from the ray planes at `row`.
__device__ __forceinline__ void start_path(const RtParams& p, int row, int s,
                                           Path& q) {
  const int bid = row / p.wave;
  const uint32_t seed = static_cast<uint32_t>(p.seed) +
                        static_cast<uint32_t>(s) * kWaveSample +
                        static_cast<uint32_t>(bid) * kWaveBatch;
  q.rng_base = pcg_hash(static_cast<uint32_t>(row - bid * p.wave) ^
                        (seed * kSeedMix));
  q.r = first_ray(p, row, q.rng_base, &q.tm);
  q.tr = q.tg = q.tb = 1.0f;
  q.b = 0;
}

// Bounce q.b of a live path, after its closest hit h: the background on a
// miss and the emission on a light end it (:1432-1442), as does metal below
// the surface; else the scatter, the throughput (:1515-1519), russian
// roulette from bounce rr_start (:1521-1534) and the next ray.  Returns
// whether the path goes on, which it does not past max_depth.  The path's
// radiance, 0 + its one term, rounded as a per-wave launch writes it, is
// added to the row's sum `acc` where it ends; a path that ends with none
// adds nothing.
template <unsigned F>
__device__ __forceinline__ bool bounce(const RtParams& p, const Hit& h,
                                       uint32_t draw, Path& q, Sum& acc) {
  if (!(h.t < kBig * 0.5f)) {  // miss: background, then the path ends
    acc.r = acc.r + (0.0f + q.tr * p.bg[0]);
    acc.g = acc.g + (0.0f + q.tg * p.bg[1]);
    acc.b = acc.b + (0.0f + q.tb * p.bg[2]);
    return false;
  }
  float nx, ny, nz, px, py, pz, ar, ag, ab;
  const bool front = surface(h, q.r, nx, ny, nz, px, py, pz);
  albedo<F>(h.sh, px, py, pz, ar, ag, ab);
  const int kind = static_cast<int>(h.sh[kShKind]);
  if (kind == kDiffuseLight) {  // emission, then the path ends
    acc.r = acc.r + (0.0f + q.tr * ar);
    acc.g = acc.g + (0.0f + q.tg * ag);
    acc.b = acc.b + (0.0f + q.tb * ab);
    return false;
  }
  if (!scatter(kind, h.sh, front, nx, ny, nz, draw, q.r)) return false;
  if (kind != kDielectric) {
    q.tr = q.tr * ar;
    q.tg = q.tg * ag;
    q.tb = q.tb * ab;
  }
  if (p.rr_start > 0 && q.b >= p.rr_start) {  // uniform across the launch
    // go on with p = clip(max throughput, 0.05, 1), reweighted by 1 / p
    const float pr =
        fminf(fmaxf(fmaxf(q.tr, fmaxf(q.tg, q.tb)), kRrFloor), 1.0f);
    if (!(uniform01(draw, 8u) < pr)) return false;
    const float inv_p = 1.0f / pr;
    q.tr = q.tr * inv_p;
    q.tg = q.tg * inv_p;
    q.tb = q.tb * inv_p;
  }
  q.r.ox = px;
  q.r.oy = py;
  q.r.oz = pz;
  return ++q.b < p.max_depth;
}

// The forward kernel: row r of out (n x 3) is the sum over samples s = 0 ..
// spp - 1, added in that order from 0, of the radiance of lane r % wave of
// wave (s, r / wave), the in-order float32 sum the host adds a wave at a
// time.  The grid is persistent (at most what the card holds resident): a
// thread takes row blockIdx.x * kThreads + threadIdx.x, then rows from the
// counter `next_row`, and traces each row's samples in order; when a path
// ends it adds the radiance to its row's sum and starts the next sample's
// ray at once, so its lane idles only when no row is left.  The explicit
// minimum of one block an SM lets ptxas give each instantiation what its
// loop needs: left unstated, it held several to 56 or 64 registers and
// spilled 4-12 bytes (H100 build, CUDA 12.8), at no gain in time.
template <unsigned F>
__global__ void __launch_bounds__(kThreads, 1)
megakernel_fwd(const RtTables tables, const RtParams p,
               float* __restrict__ out, int* __restrict__ next_row) {
  extern __shared__ float smem[];
  const Tables s = stage_tables(tables, p, smem);
  const int stride = gridDim.x * blockDim.x;
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kWarpWalk<F> && row >= p.n) return;
  Path q{{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0u, 0.0f, 0.0f, 0.0f,
         0};
  bool alive = false;
  if (row < p.n) {
    start_path(p, row, 0, q);
    alive = p.max_depth > 0;
  }
  Sum acc{0.0f, 0.0f, 0.0f};  // the row's sum so far
  int smp = 0;                // the row's current sample
  float tri_sh[12];  // a triangle winner's shading block (kFeatTriBvh)
  for (;;) {
    const bool busy = row < p.n;
    if (kWarpWalk<F> ? !__any_sync(kFullMask, busy) : !busy) break;
    if (kWarpWalk<F> || alive) {
      const uint32_t draw = draw_window(q.rng_base, q.b);
      const Hit h = scene_hit<F>(s, p, q.r, q.tm, draw, tri_sh,
                                 kWarpWalk<F> ? alive : true);
      if (alive) alive = bounce<F>(p, h, draw, q, acc);
    }
    if (busy && !alive) {  // the path ended: on to the next sample or row
      if (++smp == p.spp) {
        out[3 * static_cast<size_t>(row)] = acc.r;
        out[3 * static_cast<size_t>(row) + 1] = acc.g;
        out[3 * static_cast<size_t>(row) + 2] = acc.b;
        row = stride < p.n ? stride + atomicAdd(next_row, 1) : p.n;
        smp = 0;
        acc = Sum{0.0f, 0.0f, 0.0f};
      }
      if (row < p.n) {
        start_path(p, row, smp, q);
        alive = p.max_depth > 0;
      }
    }
  }
}

// One ray of the record kernel: its ray and shutter time, its random
// stream, its bounce, and where its entries go.
struct RecordRay {
  Ray r;
  float tm;
  uint32_t rng_base;
  int b;
  size_t at;  // entry 0 of its planes; entry b is at + b * wave
};

// Starts ray j of a record launch: lane j % wave of wave w = wave0 +
// j / wave in the chunk's schedule order, sample s = w / waves and wave
// bid = w % waves of it, seeded wave_seed(p.seed, s, bid) (uint32
// arithmetic wrapping, as the int32 seed of a per-wave launch); its camera
// ray is made for pixel p.pix_base + bid * wave + lane, or read from the
// ray planes at that index (a launch of one wave).
__device__ __forceinline__ void start_record(const RtParams& p, int j,
                                             RecordRay& q) {
  const int wl = j / p.wave;
  const int lane = j - wl * p.wave;
  const int w = p.wave0 + wl;
  const int s = w / p.waves;
  const int bid = w - s * p.waves;
  const uint32_t seed = static_cast<uint32_t>(p.seed) +
                        static_cast<uint32_t>(s) * kWaveSample +
                        static_cast<uint32_t>(bid) * kWaveBatch;
  q.rng_base = pcg_hash(static_cast<uint32_t>(lane) ^ (seed * kSeedMix));
  q.r = first_ray(p, bid * p.wave + lane, q.rng_base, &q.tm);
  q.b = 0;
  q.at = static_cast<size_t>(wl) * p.max_depth * p.wave + lane;
}

// The record kernel: for ray j of the launch (see start_record), entry b
// of each plane, at ((j / wave) * max_depth + b) * wave + j % wave, is
// bounce b's packed word (hit, cont and miss as at pallas_trace.py:
// 1397-1398 and :1512-1513) and, when asked, its hit point and uv; a
// bounce after the path's end records 0 in every plane.  The grid is
// persistent (at most what the card holds resident, p.grid): a thread
// takes ray blockIdx.x * kThreads + threadIdx.x, then rays from the
// counter `next_ray`, and when a path ends writes its remaining entries and
// starts the next ray at once.  Which thread walks a ray changes none of
// its entries.
template <unsigned F>
__global__ void __launch_bounds__(kThreads, 1)
megakernel_record(const RtTables tables, const RtParams p, const RecordOut o,
                  int* __restrict__ next_ray) {
  extern __shared__ float smem[];
  const Tables s = stage_tables(tables, p, smem);
  const int stride = gridDim.x * blockDim.x;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kWarpWalk<F> && j >= p.n) return;
  RecordRay q{{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0u, 0, 0};
  bool alive = false;
  if (j < p.n) {
    start_record(p, j, q);
    alive = p.max_depth > 0;
  }
  const size_t wave = static_cast<size_t>(p.wave);
  const bool need_p = o.px != nullptr;  // uniform across the launch
  const bool need_uv = o.u != nullptr;  // uniform across the launch
  float tri_sh[12];  // a triangle winner's shading block (kFeatTriBvh)
  for (;;) {
    const bool busy = j < p.n;
    if (kWarpWalk<F> ? !__any_sync(kFullMask, busy) : !busy) break;
    if (kWarpWalk<F> || alive) {
      const uint32_t draw = draw_window(q.rng_base, q.b);
      const Hit h = scene_hit<F>(s, p, q.r, q.tm, draw, tri_sh,
                                 kWarpWalk<F> ? alive : true);
      if (alive) {
        int32_t word;
        float px = 0.0f, py = 0.0f, pz = 0.0f;  // the hit point, 0 on a miss
        float u = 0.0f, v = 0.0f;               // the winner's uv, likewise
        if (!(h.t < kBig * 0.5f)) {
          word = kMissBit;
          alive = false;
        } else {
          float nx, ny, nz;
          const bool front = surface(h, q.r, nx, ny, nz, px, py, pz);
          if (need_uv) hit_uv<F>(s, q.r, h, &u, &v);
          const int kind = static_cast<int>(h.sh[kShKind]);
          alive = kind != kDiffuseLight &&
                  scatter(kind, h.sh, front, nx, ny, nz, draw, q.r);
          word = static_cast<int32_t>(h.sh[kShMat]) | kHitBit |
                 (alive ? kContBit : 0);
          q.r.ox = px;
          q.r.oy = py;
          q.r.oz = pz;
        }
        const size_t at = q.at + q.b * wave;
        o.packed[at] = word;
        if (need_p) {
          o.px[at] = px;
          o.py[at] = py;
          o.pz[at] = pz;
        }
        if (need_uv) {
          o.u[at] = u;
          o.v[at] = v;
        }
        if (++q.b == p.max_depth) alive = false;
      }
    }
    if (busy && !alive) {  // the path ended: its remaining entries, the next
      for (int b = q.b; b < p.max_depth; ++b) {
        const size_t at = q.at + b * wave;
        o.packed[at] = 0;
        if (need_p) o.px[at] = o.py[at] = o.pz[at] = 0.0f;
        if (need_uv) o.u[at] = o.v[at] = 0.0f;
      }
      j = stride < p.n ? stride + atomicAdd(next_ray, 1) : p.n;
      if (j < p.n) {
        start_record(p, j, q);
        alive = p.max_depth > 0;
      }
    }
  }
}

// Whether a table the kernels read with 16-byte loads is 16-byte aligned.
inline bool aligned16(const void* t) {
  return reinterpret_cast<uintptr_t>(t) % 16 == 0;
}

// False when `p` is outside what the kernels take; else sets the
// shared-memory bytes of the tables.
inline bool check_launch(const RtParams& p, size_t* table_bytes) {
  const bool spheres = (p.features & kFeatSpheres) != 0;
  const bool media = (p.features & kFeatMedia) != 0;
  const bool bvh = (p.features & kFeatSphereBvh) != 0;
  const bool tri = (p.features & kFeatTriBvh) != 0;
  *table_bytes =
      (static_cast<size_t>(p.n_rects) * kRectCols +
       static_cast<size_t>(p.n_boxes) * kBoxCols +
       (bvh ? 0 : static_cast<size_t>(p.n_spheres) * kSphCols) +
       static_cast<size_t>(p.n_sphere_media + p.n_box_media) * kMedCols) *
      sizeof(float);
  return p.n > 0 && p.n_rects >= 0 && p.n_boxes >= 0 && p.img_h > 0 &&
         p.img_w > 0 && p.max_depth >= 0 && p.pix_base >= 0 &&
         p.rr_start >= 0 && p.n_spheres >= 0 && p.n_sph_nodes >= 0 &&
         p.n_sphere_media >= 0 && p.n_box_media >= 0 &&
         p.n_sphere_media + p.n_box_media <= kMaxMedia && !(spheres && bvh) &&
         spheres == (p.n_spheres > 0 && p.n_sph_nodes == 0) &&
         bvh == (p.n_sph_nodes > 0) &&
         (!bvh || p.n_spheres % kSphLeafK == 0) &&
         (bvh || p.n_spheres <= kMaxSpheres) &&
         media == (p.n_sphere_media + p.n_box_media > 0) &&
         tri == (p.n_tri_nodes > 0) && p.n_tri_rows >= 0 &&
         p.n_tri_rows % kTriLeafK == 0 && (!tri || p.n_tri_rows > 0) &&
         *table_bytes <= kMaxTableBytes;
}

// check_launch, and the BVH tables 16-byte aligned where they are read.
inline bool check_tables(const RtTables& t, const RtParams& p,
                         size_t* table_bytes) {
  const bool bvh = (p.features & kFeatSphereBvh) != 0;
  const bool tri = (p.features & kFeatTriBvh) != 0;
  return check_launch(p, table_bytes) &&
         (!bvh || (aligned16(t.spheres) && aligned16(t.sph_nodes) &&
                   aligned16(t.sph_links))) &&
         (!tri || (aligned16(t.tri_rows) && aligned16(t.tri_nodes) &&
                   aligned16(t.tri_links)));
}

// The forward kernel's grid: a block a kThreads rows, capped at p.grid
// blocks when it is set (the card's resident blocks, `rt_trace_occupancy`).
template <unsigned F>
int launch_fwd(const RtTables& t, const RtParams& p, float* out,
               int* next_row, int* blocks_per_sm, cudaStream_t stream) {
  size_t table_bytes;
  if (!check_tables(t, p, &table_bytes) || p.wave <= 0 || p.spp <= 0 ||
      p.grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, megakernel_fwd<F>, kThreads, table_bytes));
  int blocks = (p.n + kThreads - 1) / kThreads;
  if (p.grid > 0 && p.grid < blocks) blocks = p.grid;
  // rows past the grid's first pass come from the counter, and a claim
  // (the grid's first pass plus one a thread) stays within int32
  const long long threads = static_cast<long long>(blocks) * kThreads;
  if ((threads < p.n && next_row == nullptr) ||
      p.n + threads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  megakernel_fwd<F><<<blocks, kThreads, table_bytes, stream>>>(t, p, out,
                                                                next_row);
  return static_cast<int>(cudaGetLastError());
}

// The forward launcher of one albedo family, with or without triangles (TEX
// holds the texture bits and kFeatTriBvh): the six geometry instantiations
// over TEX (no spheres, dense spheres or the sphere BVH, each with or
// without media).  Russian roulette is a branch on p.rr_start, uniform
// across the launch, not an instantiation.
template <unsigned TEX>
int launch_fwd_family(const RtTables& t, const RtParams& p, float* out,
                      int* next_row, int* blocks_per_sm, cudaStream_t s) {
  switch (static_cast<unsigned>(p.features) & kFeatGeometry) {
    case 0: return launch_fwd<TEX | 0>(t, p, out, next_row, blocks_per_sm, s);
    case 1: return launch_fwd<TEX | 1>(t, p, out, next_row, blocks_per_sm, s);
    case 2: return launch_fwd<TEX | 2>(t, p, out, next_row, blocks_per_sm, s);
    case 3: return launch_fwd<TEX | 3>(t, p, out, next_row, blocks_per_sm, s);
    case 4: return launch_fwd<TEX | 4>(t, p, out, next_row, blocks_per_sm, s);
    case 6: return launch_fwd<TEX | 6>(t, p, out, next_row, blocks_per_sm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rt
