// Native BVH builder: the port's own copy of
// raytracing_gpu_tpu/native/bvh_builder.cpp, code unchanged, so both
// packages build the same topology from the same bounds.
//
// The reference builds its BVH in CUDA C++ on-device (bvh.h:163-345, single
// thread, merge sorts + complete-tree index arithmetic).  Here the build is
// host-side work: binned-SAH top-down construction emitting a flat
// preorder/threaded-link layout (node_min/node_max/hit_link/miss_link/
// leaf_prims).  Exposed with a C ABI and bound via ctypes.
//
// Build: ../native/__init__.py runs g++ -O3 -march=native -shared -fPIC
// -std=c++17 at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr float kBboxPad = 1e-4f;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float* bmin;
  const float* bmax;
  std::vector<Vec3> centroid;
  std::vector<Box> prim_box;
  std::vector<int32_t> ids;

  int leaf_size;
  int cap_nodes;
  float* node_min;
  float* node_max;
  int32_t* hit_link;
  int32_t* miss_link;
  int32_t* leaf_prims;
  int n_nodes = 0;
  bool overflow = false;

  Box prim(int i) const { return prim_box[i]; }

  // Emit a node slot; children/link fixup happens on return (preorder DFS).
  // Returns the node index, or -1 on overflow.
  int build(int32_t* first, int count) {
    if (overflow) return -1;
    if (n_nodes >= cap_nodes) {
      overflow = true;
      return -1;
    }
    int node = n_nodes++;
    Box bb;
    Box cb;  // centroid bounds for binning
    for (int i = 0; i < count; ++i) {
      bb.grow(prim(first[i]));
      cb.grow(centroid[first[i]]);
    }
    // degenerate-extent padding (reference triangle.h:80-93)
    Vec3 lo = bb.lo, hi = bb.hi;
    if (hi.x - lo.x < 1e-6f) { lo.x -= kBboxPad; hi.x += kBboxPad; }
    if (hi.y - lo.y < 1e-6f) { lo.y -= kBboxPad; hi.y += kBboxPad; }
    if (hi.z - lo.z < 1e-6f) { lo.z -= kBboxPad; hi.z += kBboxPad; }
    node_min[3 * node + 0] = lo.x;
    node_min[3 * node + 1] = lo.y;
    node_min[3 * node + 2] = lo.z;
    node_max[3 * node + 0] = hi.x;
    node_max[3 * node + 1] = hi.y;
    node_max[3 * node + 2] = hi.z;

    int mid = -1;
    if (count > leaf_size) mid = partition_sah(first, count, bb, cb);

    if (mid <= 0 || mid >= count) {
      // leaf (or split failed): store up to leaf_size prims; if SAH refused
      // to split an oversized range, fall back to a median split
      if (count > leaf_size) mid = median_split(first, count, cb);
      if (count <= leaf_size) {
        for (int i = 0; i < count; ++i) leaf_prims[node * leaf_size + i] = first[i];
        hit_link[node] = -2;  // patched to miss_link below
        return node;
      }
    }

    build(first, mid);
    build(first + mid, count - mid);
    hit_link[node] = node + 1;
    return node;
  }

  // Binned SAH split: returns the partition point, or -1 to make a leaf.
  // All THREE axes are binned and swept; the (axis, bin) pair with the
  // lowest surface-area cost wins (the single-longest-axis variant left
  // ~5% extra candidate work on the mesh scenes — swept round 5).
  int partition_sah(int32_t* first, int count, const Box& bb, const Box& cb) {
    const float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                          cb.hi.z - cb.lo.z};
    const float clo_all[3] = {cb.lo.x, cb.lo.y, cb.lo.z};
    const float inv_root_area = 1.0f / std::max(bb.area(), 1e-30f);

    float best_cost = 1e30f;
    int best_bin = -1, best_axis = -1;
    float best_scale = 0.0f;
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] < 1e-12f) continue;
      const float clo = clo_all[axis];
      const float scale = kBins / ext[axis];
      auto bin_of = [&](int id) {
        const Vec3& c = centroid[id];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = static_cast<int>((v - clo) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };

      Box bin_box[kBins];
      int bin_cnt[kBins] = {0};
      for (int i = 0; i < count; ++i) {
        int b = bin_of(first[i]);
        bin_box[b].grow(prim(first[i]));
        bin_cnt[b]++;
      }

      // sweep: best split between bins minimizing SAH cost on this axis
      Box right_acc[kBins];
      Box acc;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        right_acc[b] = acc;
      }
      Box left_acc;
      int left_n = 0;
      for (int b = 1; b < kBins; ++b) {
        left_acc.grow(bin_box[b - 1]);
        left_n += bin_cnt[b - 1];
        int right_n = count - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = 0.125f + (left_n * left_acc.area() +
                               right_n * right_acc[b].area()) * inv_root_area;
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
          best_axis = axis;
          best_scale = scale;
        }
      }
    }
    if (best_bin < 0) return -1;
    if (best_cost >= static_cast<float>(count) && count <= leaf_size) return -1;

    const float clo = clo_all[best_axis];
    auto bin_of_best = [&](int id) {
      const Vec3& c = centroid[id];
      float v = best_axis == 0 ? c.x : (best_axis == 1 ? c.y : c.z);
      int b = static_cast<int>((v - clo) * best_scale);
      return std::min(std::max(b, 0), kBins - 1);
    };
    int32_t* mid = std::partition(first, first + count, [&](int id) {
      return bin_of_best(id) < best_bin;
    });
    return static_cast<int>(mid - first);
  }

  int median_split(int32_t* first, int count, const Box& cb) {
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    int mid = count / 2;
    std::nth_element(first, first + mid, first + count, [&](int a, int b) {
      const Vec3& ca = centroid[a];
      const Vec3& cbv = centroid[b];
      float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
      float vb = axis == 0 ? cbv.x : (axis == 1 ? cbv.y : cbv.z);
      return va < vb;
    });
    return mid;
  }
};

// subtree-end fixup: preorder DFS means node i's subtree is [i, end_i);
// recompute ends with an explicit stack over the emitted topology.
void fix_links(Builder& b) {
  // reconstruct subtree extents: a node is a leaf iff hit_link == -2
  std::vector<int> end(b.n_nodes);
  // walk backwards: end[i] = i+1 for leaves; for internal nodes the right
  // child is the node after the left subtree: end[i] = end(right child).
  for (int i = b.n_nodes - 1; i >= 0; --i) {
    if (b.hit_link[i] == -2) {
      end[i] = i + 1;
    } else {
      int left = i + 1;
      int right = end[left];
      end[i] = end[right];
    }
  }
  for (int i = 0; i < b.n_nodes; ++i) {
    int miss = end[i] < b.n_nodes ? end[i] : -1;
    b.miss_link[i] = miss;
    if (b.hit_link[i] == -2) b.hit_link[i] = miss;
  }
}

}  // namespace

extern "C" {

// Returns node count, or -1 if cap_nodes was insufficient.
int rt_build_bvh(const float* bounds_min, const float* bounds_max, int n_prims,
                 int leaf_size, float* node_min, float* node_max,
                 int32_t* hit_link, int32_t* miss_link, int32_t* leaf_prims,
                 int cap_nodes) {
  if (n_prims <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.bmin = bounds_min;
  b.bmax = bounds_max;
  b.leaf_size = leaf_size;
  b.cap_nodes = cap_nodes;
  b.node_min = node_min;
  b.node_max = node_max;
  b.hit_link = hit_link;
  b.miss_link = miss_link;
  b.leaf_prims = leaf_prims;

  b.centroid.resize(n_prims);
  b.prim_box.resize(n_prims);
  b.ids.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    Vec3 lo{bounds_min[3 * i], bounds_min[3 * i + 1], bounds_min[3 * i + 2]};
    Vec3 hi{bounds_max[3 * i], bounds_max[3 * i + 1], bounds_max[3 * i + 2]};
    b.prim_box[i] = Box{lo, hi};
    b.centroid[i] = {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y),
                     0.5f * (lo.z + hi.z)};
    b.ids[i] = i;
  }
  std::memset(leaf_prims, 0xFF, sizeof(int32_t) * cap_nodes * leaf_size);

  b.build(b.ids.data(), n_prims);
  if (b.overflow) return -1;
  fix_links(b);
  return b.n_nodes;
}

}  // extern "C"
