// Native BVH builder for spt_tpu — the host-side scene-compile engine.
//
// Role: the equivalent of Embree's BVH construction (the
// reference's rtcCommitScene path, CPUPathTracer.cpp:328-404, builds its
// acceleration structure in native code on the host; so do we).  Python
// loads this via ctypes (spt_tpu/core/bvh.py) and falls back to a numpy
// median-split builder when the library cannot be built (it is built
// from this file into native/build/ at first use: spt_tpu/utils/native.py).
//
// Algorithm: top-down binned SAH (16 bins on the widest centroid axis,
// median-split fallback for degenerate distributions), emitting nodes in
// depth-first *preorder* with skip links — the stackless flattened layout
// the device traversal consumes (first child = i+1; skip[i] = preorder
// successor of i's subtree).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

struct Aabb {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void grow(const Aabb& b) {
    lo.x = std::min(lo.x, b.lo.x);
    lo.y = std::min(lo.y, b.lo.y);
    lo.z = std::min(lo.z, b.lo.z);
    hi.x = std::max(hi.x, b.hi.x);
    hi.y = std::max(hi.y, b.hi.y);
    hi.z = std::max(hi.z, b.hi.z);
  }
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x);
    lo.y = std::min(lo.y, p.y);
    lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x);
    hi.y = std::max(hi.y, p.y);
    hi.z = std::max(hi.z, p.z);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* centers;  // n*3
  const float* radii;    // n
  int max_leaf;

  std::vector<Aabb> prim_box;
  std::vector<Vec3> prim_centroid;

  // Output (preorder emission).
  std::vector<float> node_min, node_max;
  std::vector<int> node_skip, node_first, node_count;
  std::vector<int> prim_order;

  int emit(std::vector<int>& prims, int begin, int end) {
    int me = static_cast<int>(node_skip.size());
    Aabb box, cbox;
    for (int i = begin; i < end; ++i) {
      box.grow(prim_box[prims[i]]);
      cbox.grow(prim_centroid[prims[i]]);
    }
    node_min.insert(node_min.end(), {box.lo.x, box.lo.y, box.lo.z});
    node_max.insert(node_max.end(), {box.hi.x, box.hi.y, box.hi.z});
    node_skip.push_back(-1);
    node_first.push_back(0);
    node_count.push_back(0);

    int n = end - begin;
    bool make_leaf = n <= max_leaf;
    int mid = begin + n / 2;

    if (!make_leaf) {
      // Binned SAH over the widest centroid axis.
      float ext[3] = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                      cbox.hi.z - cbox.lo.z};
      int axis = 0;
      if (ext[1] > ext[0]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;
      float lo = axis == 0 ? cbox.lo.x : (axis == 1 ? cbox.lo.y : cbox.lo.z);
      float extent = ext[axis];

      auto centroid_axis = [&](int p) -> float {
        const Vec3& c = prim_centroid[p];
        return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      };

      if (extent > 1e-12f) {
        constexpr int kBins = 16;
        Aabb bin_box[kBins];
        int bin_cnt[kBins] = {0};
        float scale = kBins / extent;
        auto bin_of = [&](int p) {
          int b = static_cast<int>((centroid_axis(p) - lo) * scale);
          return std::min(std::max(b, 0), kBins - 1);
        };
        for (int i = begin; i < end; ++i) {
          int b = bin_of(prims[i]);
          bin_box[b].grow(prim_box[prims[i]]);
          bin_cnt[b]++;
        }
        // Sweep for the cheapest split plane.
        Aabb right_acc[kBins];
        Aabb acc;
        for (int b = kBins - 1; b >= 1; --b) {
          acc.grow(bin_box[b]);
          right_acc[b] = acc;
        }
        float best_cost = FLT_MAX;
        int best_split = -1;
        Aabb left_acc;
        int left_n = 0;
        for (int b = 1; b < kBins; ++b) {
          left_acc.grow(bin_box[b - 1]);
          left_n += bin_cnt[b - 1];
          int right_n = n - left_n;
          if (left_n == 0 || right_n == 0) continue;
          float cost = left_acc.half_area() * left_n +
                       right_acc[b].half_area() * right_n;
          if (cost < best_cost) {
            best_cost = cost;
            best_split = b;
          }
        }
        float leaf_cost = box.half_area() * n;
        if (best_split < 0) {
          // All centroids in one bin: median split by sort.
          std::sort(prims.begin() + begin, prims.begin() + end,
                    [&](int a2, int b2) {
                      return centroid_axis(a2) < centroid_axis(b2);
                    });
        } else if (n > max_leaf || best_cost < leaf_cost) {
          auto it = std::partition(prims.begin() + begin, prims.begin() + end,
                                   [&](int p) { return bin_of(p) < best_split; });
          mid = static_cast<int>(it - prims.begin());
          if (mid == begin || mid == end) mid = begin + n / 2;
        }
      } else {
        // Degenerate centroid spread: arbitrary balanced split.
        mid = begin + n / 2;
      }
    }

    if (make_leaf) {
      node_first[me] = static_cast<int>(prim_order.size());
      node_count[me] = n;
      for (int i = begin; i < end; ++i) prim_order.push_back(prims[i]);
    } else {
      emit(prims, begin, mid);
      emit(prims, mid, end);
    }
    node_skip[me] = static_cast<int>(node_skip.size());
    return me;
  }
};

}  // namespace

extern "C" int spt_build_bvh(const float* centers, const float* radii, int n,
                             int max_leaf, float* out_node_min,
                             float* out_node_max, int* out_node_skip,
                             int* out_node_first, int* out_node_count,
                             int* out_prim_idx) {
  if (n <= 0 || max_leaf <= 0) return -1;
  Builder b;
  b.centers = centers;
  b.radii = radii;
  b.max_leaf = max_leaf;
  b.prim_box.resize(n);
  b.prim_centroid.resize(n);
  for (int i = 0; i < n; ++i) {
    Vec3 c{centers[3 * i], centers[3 * i + 1], centers[3 * i + 2]};
    float r = radii[i];
    b.prim_centroid[i] = c;
    b.prim_box[i].lo = {c.x - r, c.y - r, c.z - r};
    b.prim_box[i].hi = {c.x + r, c.y + r, c.z + r};
  }
  std::vector<int> prims(n);
  for (int i = 0; i < n; ++i) prims[i] = i;

  b.node_min.reserve(6 * n);
  b.node_max.reserve(6 * n);
  b.emit(prims, 0, n);

  int n_nodes = static_cast<int>(b.node_skip.size());
  if (n_nodes > 2 * n) return -2;  // caller allocated 2n; SAH never exceeds it
  std::memcpy(out_node_min, b.node_min.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_node_max, b.node_max.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_node_skip, b.node_skip.data(), sizeof(int) * n_nodes);
  std::memcpy(out_node_first, b.node_first.data(), sizeof(int) * n_nodes);
  std::memcpy(out_node_count, b.node_count.data(), sizeof(int) * n_nodes);
  std::memcpy(out_prim_idx, b.prim_order.data(), sizeof(int) * n);
  return n_nodes;
}
