// The pure closest-hit kernel of the wavefront drivers, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_hit_kernel` launched by `_run_hit`
// (raytracing_gpu_tpu/ops/pallas_trace.py:1722-2263, pl.pallas_call at
// :2252; API `PallasTracer.hit` :2489-2517) for scenes without media: one
// closest hit per ray, no shading, no scatter, no random numbers.  Rects and
// boxes first (:1792-1875), then spheres, by a dense loop up to 64 rows
// (:1993-1998) or a walk of the sphere BVH above (:1927-1991), strict `<`
// throughout; then the triangle tier (:2000-2186), a walk of the packed
// geometry's BVH pruned by min(its own best, the closest hit so far); then
// the merge and finalize (:2187-2232): a triangle wins when strictly closer
// (`t1 < t2`), a sphere winner's uv comes from its pre-flip outward normal
// through the polynomial atan2/acos plus its rotate_y phase, the normal is
// faced against the ray and normalized.
//
// Outputs, per ray i of N (the wrapper is `Tracer.bind_hit` in
// ../cuda_trace.py, the plain version `hit_reference`): packed int32
// `mat | hit<<16 | miss<<18 | front<<19 | is_tri<<20 | is_sph<<21`;
// p (N, 3) = o + t d (t = 1e30 on a miss); u, v; normal (N, 3); slot.  A
// triangle winner has bit 20, its barycentric weights of vertices 1 and 2
// in u, v and its slot (the packed table's, mapped to the triangle by
// `tri_perm`) in slot; its mat and front bits and the normal stay the
// closest non-triangle hit's, as the TPU kernel leaves them, since the
// wavefront resolves a triangle from its attributes.  slot is 0 where no
// triangle wins (the TPU kernel writes its tier's best candidate there
// whether or not it won).  A dead lane writes zeros.  The TPU kernel
// zeroes only a tile with no live lane, and its dead lanes elsewhere carry
// the arithmetic of their frozen rays; the packed word is 0 there either
// way.
//
// Design.  One thread per ray.  The TPU kernel walks a (32, 128) packet with
// one scalar cursor and follows the threading of the packet's majority
// direction octant (sum of dx < 0, ...); here every thread follows its own
// ray's octant threading (`_octant_links`: near child first along the
// children's separating axis), so the near surface is found first and far
// subtrees prune against it.  A child's box lies inside its parent's, so a
// lane tests the same leaves in either walk, in another order; the closest
// hit is the same except where two rows tie exactly.
//
// The triangle tier.  Geometry only, leaves of 28 contiguous slots (the TPU
// kernel's two 128-lane rows of 14 triangles), pad slots all zero and at
// each leaf's tail; nodes as the sphere tier's.  Each candidate is the
// megakernel's `tri_candidate` (Moller-Trumbore, 1e-7 determinant cut); the
// walk keeps the winner's t, slot and barycentrics.  It starts from the
// closest non-triangle hit t2 and keeps a candidate only when strictly
// closer, which prunes and picks the same winner as the TPU kernel's own
// best t1 starting at 1e30 and pruned by min(t1, t2).  A ray through an
// edge that two triangles share hits both at one t: the first in the ray's
// own visit order wins, so the slot may differ from the TPU kernel's (which
// follows the packet's majority octant) while t agrees.  The kernel is a
// template on the tier, so a triangle-free scene carries none of its code
// or registers.
//
// What bounds it on Hopper.  Neither the card's bytes nor its operations:
// a ray reads 29 bytes and writes 40, and a config-5 step's ray tests ~23
// nodes (~25 operations each) and ~16 real triangle slots (~57 each), so
// the step's bound is ~3 us.  What takes the time is the latency of
// gathers that diverge once the lanes of a warp walk different nodes (a
// warp load then touches up to 32 cache lines, an L1 wavefront each), and
// leaf tests that one lane would run alone while the rest of its warp,
// mostly between leaves, waits: a leaf holds 28 slots, 30% of them pads.
// The design:
//
// - 16-byte records (`cuda_trace.device_tables`): a node is 32 bytes, two
//   float4s (lo xyz and the leaf's first slot as int bits; hi xyz and its
//   count of real slots), its 8 octant (hit, miss) pairs an int2 array
//   indexed node * 8 + octant, a triangle slot 48 bytes (v0 e1 e2 and 3
//   zeros); a sphere row's geometry is the first 48 of its 96 bytes.  A
//   node visit is 3 loads, a candidate 3.
// - A leaf tests its real slots only: pads sit at its tail and never hit.
// - The warp tests a leaf together (`rt::warp_bvh_walk`): each lane walks
//   its own ray, and in each step the lanes that reached a hit leaf are
//   served one at a time: lane j tests slot start + j against the owner's
//   broadcast ray, and a reduction picks the first least distance, the
//   strict-`<` loop's winner bit for bit.  A 28-slot leaf costs the warp
//   one candidate's latency, not 28.
// - Every thread enters the walks: a dead lane and a thread past n take
//   part with no node and write their zeros after it, so the warp-wide
//   intrinsics always see 32 lanes.
//
// The sphere BVH (big_scene1: 167 nodes, 672 rows in leaves of 8, 484
// real) walks the same way, its leaves served four at a time, a group of 8
// lanes each (one 28-slot triangle leaf a pass takes the whole warp).
// Rects and boxes are a broadcast read.
// Divergent walks within a warp stay the cost; the wavefront's sort by
// octant and origin keeps warps coherent.
//
// Rounding: as megakernel.cuh (-fmad=false, no fast math), and the normal's
// length is 1.0f / sqrtf(x).  XLA's rsqrt on the CPU, which the JAX golden
// ran, is within an ulp of that; the rest of the outputs round alike.

#include "megakernel.cuh"

namespace {

constexpr int kHitTriLeafK = 28;  // packed triangle slots per leaf
constexpr int kTriSlotCols = 12;  // v0 e1 e2 and 3 zeros per slot
constexpr int kOctants = 8;       // (hit, miss) link pairs per node
static_assert(kHitTriLeafK <= 32, "the warp tests a leaf's slots one a lane");

struct HitParams {
  const float* rects;
  const float* boxes;
  const float* spheres;
  const float4* nodes;
  const int2* links;
  const float* tri_slots;
  const float4* tri_nodes;
  const int2* tri_links;
  int n_rects, n_boxes, n_spheres, n_nodes, n_tri_slots, n_tri_nodes, n;
  float t_min;
};

// The closest winner so far: its distance, outward normal, material, uv
// (final for rects and boxes, the uv phase for spheres), and whether it is a
// sphere.
struct Best {
  float t, nx, ny, nz, u, v;
  int mat;
  bool sph;
};

__device__ __forceinline__ void take(Best& b, float t, float nx, float ny,
                                     float nz, float mat, float u, float v,
                                     bool sph) {
  b.t = t;
  b.nx = nx;
  b.ny = ny;
  b.nz = nz;
  b.mat = static_cast<int>(mat);
  b.u = u;
  b.v = v;
  b.sph = sph;
}

// The ray's own direction octant: bit 2 x negative, bit 1 y, bit 0 z.
__device__ __forceinline__ int octant(const rt::Ray& r) {
  return (r.dx < 0.0f ? 4 : 0) | (r.dy < 0.0f ? 2 : 0) |
         (r.dz < 0.0f ? 1 : 0);
}

template <bool kTri>
__global__ void __launch_bounds__(rt::kThreads)
hit_kernel(const HitParams hp, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tm_in,
           const uint8_t* __restrict__ alive, int32_t* __restrict__ packed,
           float* __restrict__ p_out, float* __restrict__ u_out,
           float* __restrict__ v_out, float* __restrict__ n_out,
           float* __restrict__ slot) {
  // every thread stays to the end: the BVH walks are the warp's
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < hp.n;
  const bool live = in && alive[i] != 0;
  rt::Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float tm = 0.0f;
  if (live) {
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    tm = tm_in[i];
  }
  const float t_min = hp.t_min;
  Best b;
  b.t = rt::kBig;
  b.nx = b.ny = b.nz = b.u = b.v = 0.0f;
  b.mat = 0;
  b.sph = false;

  for (int k = 0; k < (live ? hp.n_rects : 0); ++k) {
    const float* q = hp.rects + k * rt::kRectCols;
    const rt::RectCross c = rt::rect_cross(q, r);
    const bool ok = c.t >= t_min && c.pa >= q[1] && c.pa <= q[2] &&
                    c.pb >= q[3] && c.pb <= q[4];
    if (ok && c.t < b.t) {
      take(b, c.t, c.ax == 0 ? 1.0f : 0.0f, c.ax == 1 ? 1.0f : 0.0f,
           c.ax == 2 ? 1.0f : 0.0f, q[rt::kRectSh + rt::kShMat],
           (c.pa - q[1]) / rt::extent(q[2], q[1]),
           (c.pb - q[3]) / rt::extent(q[4], q[3]), false);
    }
  }
  for (int k = 0; k < (live ? hp.n_boxes : 0); ++k) {
    const float* q = hp.boxes + k * rt::kBoxCols;
    const rt::Slabs s = rt::box_slabs(q, r);
    const float tn = fmaxf(fmaxf(s.tnx, s.tny), s.tnz);
    const float tf = fminf(fminf(s.tfx, s.tfy), s.tfz);
    const float t = tn >= t_min ? tn : tf;
    const bool ok = tf > fmaxf(tn, 0.0f) && t >= t_min;
    if (ok && t < b.t) {
      const bool is_x = t == s.tnx || t == s.tfx;
      const bool is_y = t == s.tny || t == s.tfy;
      const bool exiting = t == tf;
      const float sx = ((s.dx2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sy = ((r.dy >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float sz = ((s.dz2 >= 0.0f) != exiting) ? -1.0f : 1.0f;
      const float nobj_x = is_x ? sx : 0.0f;
      const float nobj_y = (!is_x && is_y) ? sy : 0.0f;
      const float nobj_z = (!is_x && !is_y) ? sz : 0.0f;
      const float c = q[6], sn = q[7];
      // the hit point in object space, for the face's uv (box.h:14-27)
      const float ox2 = c * (r.ox - q[8]) - sn * (r.oz - q[10]);
      const float oz2 = sn * (r.ox - q[8]) + c * (r.oz - q[10]);
      const float ua = (ox2 + t * s.dx2 - q[0]) / rt::extent(q[3], q[0]);
      const float ub =
          ((r.oy - q[9]) + t * r.dy - q[1]) / rt::extent(q[4], q[1]);
      const float uc = (oz2 + t * s.dz2 - q[2]) / rt::extent(q[5], q[2]);
      take(b, t, c * nobj_x + sn * nobj_z, nobj_y, (-sn) * nobj_x + c * nobj_z,
           q[rt::kBoxSh + rt::kShMat], is_x ? ub : ua,
           (is_x || is_y) ? uc : ub, false);
    }
  }
  const int oct = octant(r);
  if (hp.n_spheres > 0) {  // uniform across the launch
    // the sphere rows (sph_cand, :1877-1925, the megakernel's
    // sphere_candidate) against the closest rect or box so far
    rt::Hit hs;
    hs.t = b.t;
    hs.nx = hs.ny = hs.nz = 0.0f;
    hs.sh = nullptr;
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / fmaxf(a, rt::kEps);
    if (hp.n_nodes == 0) {
      for (int k = 0; k < (live ? hp.n_spheres : 0); ++k)
        rt::sphere_candidate(hp.spheres + k * rt::kSphCols, r, tm, a, inv_a,
                             t_min, hs);
    } else {
      rt::sphere_bvh_walk(rt::BvhNodes{hp.nodes, hp.links, kOctants, oct},
                          hp.spheres, live, r, tm, a, inv_a, t_min, hs);
    }
    if (hs.sh != nullptr)  // a sphere row is the closest: its mat, uv phase
      take(b, hs.t, hs.nx, hs.ny, hs.nz, hs.sh[rt::kShMat],
           hs.sh[rt::kSphUvPhase - rt::kSphSh], 0.0f, true);
  }

  // ---- the triangle tier, from the closest non-triangle hit t2 = b.t ----
  float t_best = b.t, tu = 0.0f, tv = 0.0f;
  int slot_win = -1;
  if (kTri) {
    const float ivx = 1.0f / rt::guard(r.dx);
    const float ivy = 1.0f / rt::guard(r.dy);
    const float ivz = 1.0f / rt::guard(r.dz);
    rt::warp_bvh_walk<32>(
        rt::BvhNodes{hp.tri_nodes, hp.tri_links, kOctants, oct}, live, r,
        ivx, ivy, ivz, t_min, t_best,
        [&](const rt::Ray& rb, int, int s, bool valid, float tb) {
          rt::Cand c{false, rt::kBig, 0.0f, 0.0f, 0.0f};
          float t, ub, vb;
          if (valid &&
              rt::tri_candidate(rt::tri_geom4(hp.tri_slots + s * kTriSlotCols),
                                rb, t_min, &t, &ub, &vb) &&
              t < tb) {
            c.ok = true;
            c.t = t;
            c.a = ub;
            c.b = vb;
          }
          return c;
        },
        [&](int s, float, float ub, float vb, float) {
          slot_win = s;
          tu = ub;
          tv = vb;
        });
  }
  if (!in) return;
  if (!live) {
    packed[i] = 0;
    u_out[i] = v_out[i] = slot[i] = 0.0f;
    for (int k = 0; k < 3; ++k) p_out[3 * i + k] = n_out[3 * i + k] = 0.0f;
    return;
  }
  const bool tri = slot_win >= 0;  // strictly closer than every other hit
  if (tri) b.sph = false;
  const bool hit = t_best < rt::kBig * 0.5f;
  float u = b.u, v = b.v;
  if (b.sph) rt::sphere_uv(b.nx, b.ny, b.nz, b.u, &u, &v);
  const bool front = (r.dx * b.nx + r.dy * b.ny + r.dz * b.nz) < 0.0f;
  const float flip = front ? 1.0f : -1.0f;
  const float nlen =
      1.0f / sqrtf(fmaxf(b.nx * b.nx + b.ny * b.ny + b.nz * b.nz, 1e-20f));
  packed[i] = b.mat | (hit ? rt::kHitBit : 0) | (hit ? 0 : rt::kMissBit) |
              (front ? 1 << 19 : 0) | (tri ? 1 << 20 : 0) |
              (b.sph ? 1 << 21 : 0);
  p_out[3 * i] = r.ox + t_best * r.dx;
  p_out[3 * i + 1] = r.oy + t_best * r.dy;
  p_out[3 * i + 2] = r.oz + t_best * r.dz;
  u_out[i] = tri ? tu : u;
  v_out[i] = tri ? tv : v;
  slot[i] = tri ? static_cast<float>(slot_win) : 0.0f;
  n_out[3 * i] = b.nx * flip * nlen;
  n_out[3 * i + 1] = b.ny * flip * nlen;
  n_out[3 * i + 2] = b.nz * flip * nlen;
}

}  // namespace

// C entry (bound with ctypes): one launch over n rays on `stream`, never
// synchronizing; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take (a dense loop of
// more than 64 rows, a BVH table that is not whole leaves, triangle slots
// without nodes, a table read with 16-byte loads that is not 16-byte
// aligned).  A BVH is its node records (n_nodes x 32 bytes) and link pairs
// (n_nodes x 8 int2); a triangle slot is 12 floats.
extern "C" int rt_hit(const float* rects, const float* boxes,
                      const float* spheres, const float4* nodes,
                      const int2* links, const float* tri_slots,
                      const float4* tri_nodes, const int2* tri_links,
                      int n_rects, int n_boxes, int n_spheres, int n_nodes,
                      int n_tri_slots, int n_tri_nodes, int n, float t_min,
                      const float* o, const float* d, const float* tm,
                      const uint8_t* alive, int32_t* packed, float* p,
                      float* u, float* v, float* normal, float* slot,
                      void* stream) {
  const bool ok = n > 0 && n_rects >= 0 && n_boxes >= 0 && n_spheres >= 0 &&
                  n_nodes >= 0 &&
                  (n_nodes > 0 ? n_spheres % rt::kSphLeafK == 0 &&
                                     rt::aligned16(spheres) &&
                                     rt::aligned16(nodes) &&
                                     rt::aligned16(links)
                               : n_spheres <= rt::kMaxSpheres) &&
                  n_tri_slots >= 0 && n_tri_slots % kHitTriLeafK == 0 &&
                  (n_tri_nodes > 0) == (n_tri_slots > 0) &&
                  (n_tri_nodes == 0 ||
                   (rt::aligned16(tri_slots) && rt::aligned16(tri_nodes) &&
                    rt::aligned16(tri_links)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const HitParams hp{rects,     boxes,     spheres,     nodes,
                     links,     tri_slots, tri_nodes,   tri_links,
                     n_rects,   n_boxes,   n_spheres,   n_nodes,
                     n_tri_slots, n_tri_nodes, n,       t_min};
  const int blocks = (n + rt::kThreads - 1) / rt::kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tri_nodes > 0)
    hit_kernel<true><<<blocks, rt::kThreads, 0, s>>>(
        hp, o, d, tm, alive, packed, p, u, v, normal, slot);
  else
    hit_kernel<false><<<blocks, rt::kThreads, 0, s>>>(
        hp, o, d, tm, alive, packed, p, u, v, normal, slot);
  return static_cast<int>(cudaGetLastError());
}
