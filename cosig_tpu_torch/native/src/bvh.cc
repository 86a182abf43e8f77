// Native median-split BVH builder — C ABI, identical output to the Python
// reference implementation in cosig_tpu_torch/accel/bvh.py (which itself mirrors
// the algorithm of the reference's Assets/Services/BVH/BVHBuilder.cs:
// longest-axis median split at the AABB center, <=max_leaf tris per leaf,
// degenerate-partition bail-out, BFS flatten with contiguous children).
//
// Exact-match contract with the Python builder (tested): same stable
// centroid partition, same split rule, same BFS order, same triangle
// reordering. Differences would show up as test failures, not subtle
// image drift, because the cluster builder consumes leaf ranges directly.
//
// Build: cosig_tpu_torch/native/loader.py at first use
// (g++ -O3 -fPIC -std=c++17 -shared; no -march=native, no -ffast-math:
// the pivot and the bounds must round as numpy's float32 does).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Node {
  float bmin[3];
  float bmax[3];
  int left = -1;   // index into node pool; -1 for leaf
  int right = -1;
  int start = 0;   // range into the index array
  int count = 0;   // >0 for leaves after construction
};

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  const float* centers;
  int max_leaf;
  std::vector<int64_t> indices;
  std::vector<float> tri_min;  // [n,3]
  std::vector<float> tri_max;  // [n,3]
  std::vector<Node> pool;

  int build(int start, int count) {
    int node_id = (int)pool.size();
    pool.emplace_back();
    {
      Node& node = pool.back();
      float bmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
      float bmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
      for (int i = 0; i < count; i++) {
        int64_t t = indices[start + i];
        for (int a = 0; a < 3; a++) {
          bmin[a] = std::min(bmin[a], tri_min[t * 3 + a]);
          bmax[a] = std::max(bmax[a], tri_max[t * 3 + a]);
        }
      }
      std::memcpy(node.bmin, bmin, sizeof bmin);
      std::memcpy(node.bmax, bmax, sizeof bmax);
      node.start = start;
      node.count = count;
    }
    if (count <= max_leaf) return node_id;

    float size[3];
    for (int a = 0; a < 3; a++) size[a] = pool[node_id].bmax[a] - pool[node_id].bmin[a];
    int axis = 0;
    if (size[1] > size[0]) axis = 1;
    if (size[2] > size[axis]) axis = 2;
    float pivot = (pool[node_id].bmin[axis] + pool[node_id].bmax[axis]) * 0.5f;

    // Stable partition on centroid < pivot (matches the Python builder's
    // boolean-mask split; only set membership matters vs the reference's
    // two-pointer swap, BVHBuilder.cs:160-183).
    auto partition = [&](int ax, float piv) {
      auto mid_it = std::stable_partition(
          indices.begin() + start, indices.begin() + start + count,
          [&](int64_t t) { return centers[t * 3 + ax] < piv; });
      return (int)(mid_it - indices.begin());
    };
    int mid = partition(axis, pivot);
    if (mid == start || mid == start + count) {
      // Fallback: centroid-extent median split (see the Python builder for
      // the rationale — oversized triangles stretch node bounds).
      float cmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
      float cmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
      for (int i = 0; i < count; i++) {
        int64_t t = indices[start + i];
        for (int a = 0; a < 3; a++) {
          cmin[a] = std::min(cmin[a], centers[t * 3 + a]);
          cmax[a] = std::max(cmax[a], centers[t * 3 + a]);
        }
      }
      float cext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
      axis = 0;
      if (cext[1] > cext[0]) axis = 1;
      if (cext[2] > cext[axis]) axis = 2;
      pivot = (cmin[axis] + cmax[axis]) * 0.5f;
      mid = partition(axis, pivot);
      if (mid == start || mid == start + count) return node_id;  // degenerate
    }

    int left = build(start, mid - start);
    int right = build(mid, start + count - mid);
    pool[node_id].left = left;
    pool[node_id].right = right;
    pool[node_id].count = 0;
    return node_id;
  }
};

}  // namespace

extern "C" {

// Returns the number of flattened nodes, or -1 on error.
// Output arrays must have capacity for 2*n_tris nodes (node_min/node_max:
// 3 floats each) and n_tris entries for `order`.
int cosig_build_bvh(const float* v0, const float* v1, const float* v2,
                    const float* centers, int n_tris, int max_leaf,
                    float* node_min, float* node_max, int* left_or_first,
                    int* count, int* order) {
  if (n_tris <= 0 || max_leaf <= 0) return -1;

  Builder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.centers = centers;
  b.max_leaf = max_leaf;
  b.indices.resize(n_tris);
  for (int i = 0; i < n_tris; i++) b.indices[i] = i;
  b.tri_min.resize((size_t)n_tris * 3);
  b.tri_max.resize((size_t)n_tris * 3);
  for (int i = 0; i < n_tris; i++) {
    for (int a = 0; a < 3; a++) {
      float lo = std::min(v0[i * 3 + a], std::min(v1[i * 3 + a], v2[i * 3 + a]));
      float hi = std::max(v0[i * 3 + a], std::max(v1[i * 3 + a], v2[i * 3 + a]));
      b.tri_min[i * 3 + a] = lo;
      b.tri_max[i * 3 + a] = hi;
    }
  }
  b.pool.reserve((size_t)n_tris * 2);
  int root = b.build(0, n_tris);

  // BFS flatten: children occupy contiguous slots, right = left + 1
  // (BVHBuilder.cs:189-238). Leaf left_or_first points at the reordered
  // triangle range, appended in BFS order.
  std::queue<std::pair<int, int>> queue;  // (pool id, flat slot)
  int n_flat = 1;
  int n_order = 0;
  queue.push({root, 0});
  while (!queue.empty()) {
    auto [pid, slot] = queue.front();
    queue.pop();
    const Node& n = b.pool[pid];
    std::memcpy(node_min + (size_t)slot * 3, n.bmin, 12);
    std::memcpy(node_max + (size_t)slot * 3, n.bmax, 12);
    if (n.count > 0) {
      count[slot] = n.count;
      left_or_first[slot] = n_order;
      for (int k = 0; k < n.count; k++)
        order[n_order++] = (int)b.indices[n.start + k];
    } else {
      count[slot] = 0;
      int left_slot = n_flat;
      n_flat += 2;
      left_or_first[slot] = left_slot;
      queue.push({n.left, left_slot});
      queue.push({n.right, left_slot + 1});
    }
  }
  return n_flat;
}

}  // extern "C"
