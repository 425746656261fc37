// Host-side full-sweep SAH BVH builder.
//
// The port's copy of native/bvh_builder.cpp, statement for statement, so the
// cluster build (ops/clustered.py) gives the JAX package's arrays exactly.
// The reference builder's *algorithm* (BVH.hpp:90-206): binary BVH over primitive AABBs with a
// full-sweep surface-area-heuristic split — three axis-sorted index arrays,
// a right-to-left partial-cost sweep with chunked early exit, stable
// partition of the other axes via marks, leaf size 1, children ordered by
// area/size heuristics, and a final primitive reorder that removes the
// indirection. Build time is host-side and cold (scene edits only), so this
// is plain portable C++ rather than SIMD; the flattened node arrays it
// emits are cut into clusters on the host (ops/clustered.py).
//
// C ABI so ctypes can call it; all buffers are caller-allocated numpy.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Node {
  float mn[3];
  float mx[3];
  uint32_t first;   // child index (inner) or first prim (leaf)
  uint32_t count;   // 0 = inner, else prim count

  void reset() {
    mn[0] = mn[1] = mn[2] = 3.4e38f;
    mx[0] = mx[1] = mx[2] = -3.4e38f;
    first = count = 0;
  }
  void grow(const Node& o) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], o.mn[k]);
      mx[k] = std::max(mx[k], o.mx[k]);
    }
  }
  float half_area() const {
    float dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
    return dx * dy + dy * dz + dz * dx;
  }
  float centroid(int axis) const { return 0.5f * (mn[axis] + mx[axis]); }
};

struct Frame {
  uint32_t id, begin, count;
};

}  // namespace

extern "C" {

// mins/maxs: [n,3] f32 primitive bounds.
// Outputs (caller-allocated): node_min/node_max [max_nodes,3] f32,
// node_first/node_count [max_nodes] u32, prim_order [n] u32.
// Returns the number of nodes written, or -1 if max_nodes was too small.
// cost_ratio: node-intersection cost over prim cost (SplitHeuristic,
// BVH.hpp:70-83); log_cluster_size: prim-cluster granularity in the cost.
int32_t bvh_build(const float* mins, const float* maxs, uint32_t n,
                  float* node_min, float* node_max, uint32_t* node_first,
                  uint32_t* node_count, uint32_t* prim_order,
                  uint32_t max_nodes, float cost_ratio,
                  uint32_t log_cluster_size, uint32_t leaf_size) {
  if (n == 0) return 0;
  if (leaf_size == 0) leaf_size = 1;

  std::vector<Node> bboxes(n);
  for (uint32_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      bboxes[i].mn[k] = mins[i * 3 + k];
      bboxes[i].mx[k] = maxs[i * 3 + k];
    }
    bboxes[i].first = i;
    bboxes[i].count = 1;
  }

  // three axis-sorted id arrays (BVH.hpp:115-123)
  std::vector<uint32_t> ids(3 * size_t(n));
  for (int axis = 0; axis < 3; ++axis) {
    uint32_t* a = ids.data() + size_t(axis) * n;
    std::iota(a, a + n, 0u);
    std::sort(a, a + n, [&](uint32_t x, uint32_t y) {
      return bboxes[x].centroid(axis) < bboxes[y].centroid(axis);
    });
  }

  auto prim_cost = [&](size_t size) {
    return float((size + (size_t(1) << log_cluster_size) - 1) >>
                 log_cluster_size);
  };
  auto leaf_cost = [&](size_t size, float area) {
    return area * prim_cost(size);
  };
  auto non_split_cost = [&](size_t size, float area) {
    return area * (prim_cost(size) - cost_ratio);
  };

  std::vector<Node> nodes;
  nodes.reserve(2 * size_t(n) + 2);
  Node root;
  root.reset();
  for (const auto& b : bboxes) root.grow(b);
  nodes.push_back(root);

  std::vector<float> accum_cost(n);
  std::vector<uint8_t> marks(n);
  std::vector<Frame> stack;
  stack.push_back({0, 0, n});

  while (!stack.empty()) {
    Frame item = stack.back();
    stack.pop_back();
    Node& node = nodes[item.id];
    const size_t begin = item.begin, end = item.begin + item.count;

    // pick largest axis as the no-better-split fallback (BVH.hpp:144)
    int fallback_axis = 0;
    {
      float best = -1.f;
      for (int k = 0; k < 3; ++k) {
        float d = node.mx[k] - node.mn[k];
        if (d > best) { best = d; fallback_axis = k; }
      }
    }
    size_t best_pos = begin + (item.count + 1) / 2;
    int best_axis = fallback_axis;
    float best_cost = non_split_cost(item.count, node.half_area());
    bool found_split = false;

    if (item.count > leaf_size) {
      for (int axis = 0; axis < 3; ++axis) {
        const uint32_t* a = ids.data() + size_t(axis) * n;
        // right-to-left partial cost sweep, chunks of 32 with early exit
        // (BVH.hpp:146-161)
        size_t first_right = begin;
        {
          Node right;
          right.reset();
          float right_cost = 0.f;
          size_t i = end - 1;
          bool aborted = false;
          while (i > begin) {
            size_t chunk_lo = i - std::min(i - begin, size_t(32));
            for (; i > chunk_lo; --i) {
              right.grow(bboxes[a[i]]);
              accum_cost[i] = right_cost =
                  leaf_cost(end - i, right.half_area());
            }
            if (right_cost > best_cost) {
              first_right = i;
              aborted = true;
              break;
            }
          }
          if (!aborted) first_right = begin;
        }
        // left-to-right full cost (BVH.hpp:163-170)
        Node left;
        left.reset();
        for (size_t i = begin; i < end - 1; ++i) {
          left.grow(bboxes[a[i]]);
          if (i < first_right) continue;
          float lc = leaf_cost(i + 1 - begin, left.half_area());
          if (lc > best_cost) break;
          float cost = lc + accum_cost[i + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_pos = i + 1;
            best_axis = axis;
            found_split = true;
          }
        }
      }
    }

    if (item.count <= leaf_size ||
        (!found_split && item.count <= 8 * leaf_size)) {
      // leaf (also terminate un-splittable small runs to avoid degenerate
      // median splits on identical centroids)
      node.first = static_cast<uint32_t>(begin);
      node.count = static_cast<uint32_t>(item.count);
      continue;
    }

    // partition the other two axis arrays stably via marks (BVH.hpp:173-184)
    const uint32_t* best_ids = ids.data() + size_t(best_axis) * n;
    for (size_t i = begin; i < best_pos; ++i) marks[best_ids[i]] = 1;
    for (size_t i = best_pos; i < end; ++i) marks[best_ids[i]] = 0;
    for (int axis = 0; axis < 3; ++axis) {
      if (axis == best_axis) continue;
      uint32_t* a = ids.data() + size_t(axis) * n;
      std::stable_partition(a + begin, a + end,
                            [&](uint32_t id) { return marks[id] != 0; });
    }

    // children, ordered by area/size heuristics (BVH.hpp:186-198)
    auto reduce = [&](size_t from, size_t to) {
      Node r;
      r.reset();
      const uint32_t* a = ids.data();  // axis 0 view is fine post-partition
      for (size_t i = from; i < to; ++i) r.grow(bboxes[a[i]]);
      return r;
    };
    const size_t ranges[2][2] = {{begin, best_pos}, {best_pos, end}};
    Node children[2] = {reduce(begin, best_pos), reduce(best_pos, end)};
    size_t sort_area = children[0].half_area() < children[1].half_area();
    size_t sort_size =
        (ranges[0][1] - ranges[0][0]) < (ranges[1][1] - ranges[1][0]);
    size_t combined = sort_area ^ sort_size;

    const uint32_t first_child = static_cast<uint32_t>(nodes.size());
    if (nodes.size() + 2 > max_nodes) return -1;
    nodes[item.id].first = first_child;
    nodes[item.id].count = 0;
    nodes.push_back(children[sort_area]);
    nodes.push_back(children[1 - sort_area]);
    stack.push_back({static_cast<uint32_t>(first_child + combined),
                     static_cast<uint32_t>(ranges[sort_size][0]),
                     static_cast<uint32_t>(ranges[sort_size][1] -
                                           ranges[sort_size][0])});
    stack.push_back({static_cast<uint32_t>(first_child + (1 - combined)),
                     static_cast<uint32_t>(ranges[1 - sort_size][0]),
                     static_cast<uint32_t>(ranges[1 - sort_size][1] -
                                           ranges[1 - sort_size][0])});
  }

  if (nodes.size() > max_nodes) return -1;
  for (size_t i = 0; i < nodes.size(); ++i) {
    std::memcpy(node_min + i * 3, nodes[i].mn, 3 * sizeof(float));
    std::memcpy(node_max + i * 3, nodes[i].mx, 3 * sizeof(float));
    node_first[i] = nodes[i].first;
    node_count[i] = nodes[i].count;
  }
  // prim reorder to drop the indirection (BVH.hpp:201-205): axis-0 order
  std::memcpy(prim_order, ids.data(), n * sizeof(uint32_t));
  return static_cast<int32_t>(nodes.size());
}

}  // extern "C"
