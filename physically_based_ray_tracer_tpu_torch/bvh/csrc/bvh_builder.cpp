// Native binned-SAH BVH builder: the port's own copy of the JAX package's
// physically_based_ray_tracer_tpu/bvh/csrc/bvh_builder.cpp, the code
// unchanged, so that both packages build the same classic BVH (built by
// bvh/native.py with the same g++ flags).
//
// C++ counterpart of bvh/builder.py (same algorithm family as tinybvh's
// reference builder, Core/tiny_bvh.h:1841-1934: 8-bin centroid binning over
// 3 axes, prefix/suffix AABB sweeps, SAH cost A_L*N_L + A_R*N_R, explicit
// task stack). Emits the framework's Aila/Laine 2-wide layout directly:
// nodes_box (N,12): both children's AABBs; nodes_child (N,2): child codes
// (>=0 internal index, <0 leaf: m=-(c+1), first=m>>7, count=m&127);
// tris (P,9): leaf-contiguous v0/e1/e2 rows padded per leaf; prim_index (P).
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int BINS = 8;
constexpr int LEAF_COUNT_BITS = 7;
constexpr int LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1;

struct V3 {
  float x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return (&x)[i]; }
  float& operator[](int i) { return (&x)[i]; }
};

inline V3 vmin(const V3& a, const V3& b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
inline V3 vmax(const V3& a, const V3& b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) { lo = vmin(lo, o.lo); hi = vmax(hi, o.hi); }
  void grow(const V3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  float area() const {
    float ex = std::max(hi.x - lo.x, 0.f), ey = std::max(hi.y - lo.y, 0.f),
          ez = std::max(hi.z - lo.z, 0.f);
    return 2.f * (ex * ey + ey * ez + ez * ex);
  }
};

inline int32_t encode_leaf(int64_t first, int count) {
  return static_cast<int32_t>(-(((first << LEAF_COUNT_BITS) | count) + 1));
}

struct Builder {
  const float* tris;  // (T, 9): three corners
  int64_t T;
  int leaf_size;

  std::vector<AABB> prim_box;
  std::vector<V3> centroid;
  std::vector<int64_t> order;

  std::vector<float> nodes_box;      // N*12
  std::vector<int32_t> nodes_child;  // N*2
  std::vector<std::pair<int64_t, int64_t>> leaf_ranges;
  int64_t n_nodes = 0;

  AABB range_bounds(int64_t s, int64_t e) const {
    AABB b;
    for (int64_t i = s; i < e; ++i) b.grow(prim_box[order[i]]);
    return b;
  }

  int64_t alloc_node() {
    nodes_box.resize(nodes_box.size() + 12, 0.f);
    nodes_child.resize(nodes_child.size() + 2, 0);
    return n_nodes++;
  }

  void set_child_box(int64_t node, int side, const AABB& b) {
    float* p = &nodes_box[node * 12 + side * 6];
    p[0] = b.lo.x; p[1] = b.lo.y; p[2] = b.lo.z;
    p[3] = b.hi.x; p[4] = b.hi.y; p[5] = b.hi.z;
  }

  void make_leaf(int64_t node, int side, int64_t s, int64_t e) {
    int64_t first = static_cast<int64_t>(leaf_ranges.size()) * leaf_size;
    leaf_ranges.emplace_back(s, e);
    nodes_child[node * 2 + side] = encode_leaf(first, static_cast<int>(e - s));
  }

  // returns mid, or -1 for "make a leaf"
  int64_t split(int64_t s, int64_t e) {
    int64_t count = e - s;
    if (count <= leaf_size) return -1;

    V3 cmin(FLT_MAX, FLT_MAX, FLT_MAX), cmax(-FLT_MAX, -FLT_MAX, -FLT_MAX);
    for (int64_t i = s; i < e; ++i) {
      cmin = vmin(cmin, centroid[order[i]]);
      cmax = vmax(cmax, centroid[order[i]]);
    }
    V3 ext(cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z);
    if (ext.x <= 1e-12f && ext.y <= 1e-12f && ext.z <= 1e-12f)
      return s + count / 2;  // median fallback

    float best_cost = FLT_MAX;
    int best_axis = -1, best_bin = -1;
    for (int ax = 0; ax < 3; ++ax) {
      if (ext[ax] <= 1e-12f) continue;
      float scale = BINS * 0.9999f / ext[ax];
      AABB bb[BINS];
      int64_t cnt[BINS] = {0};
      for (int64_t i = s; i < e; ++i) {
        int b = static_cast<int>((centroid[order[i]][ax] - cmin[ax]) * scale);
        b = std::min(std::max(b, 0), BINS - 1);
        bb[b].grow(prim_box[order[i]]);
        cnt[b]++;
      }
      AABB lbox[BINS];
      int64_t lcnt[BINS];
      AABB acc;
      int64_t c_acc = 0;
      for (int b = 0; b < BINS; ++b) {
        acc.grow(bb[b]); c_acc += cnt[b];
        lbox[b] = acc; lcnt[b] = c_acc;
      }
      AABB racc;
      int64_t r_acc = 0;
      for (int b = BINS - 1; b >= 1; --b) {
        racc.grow(bb[b]); r_acc += cnt[b];
        if (lcnt[b - 1] == 0 || r_acc == 0) continue;
        float cost = lbox[b - 1].area() * lcnt[b - 1] + racc.area() * r_acc;
        if (cost < best_cost) { best_cost = cost; best_axis = ax; best_bin = b - 1; }
      }
    }
    if (best_axis < 0) return s + count / 2;

    float scale = BINS * 0.9999f / ext[best_axis];
    auto mid_it = std::partition(order.begin() + s, order.begin() + e,
        [&](int64_t p) {
          int b = static_cast<int>((centroid[p][best_axis] - cmin[best_axis]) * scale);
          b = std::min(std::max(b, 0), BINS - 1);
          return b <= best_bin;
        });
    int64_t mid = mid_it - order.begin();
    if (mid == s || mid == e) return s + count / 2;
    return mid;
  }

  void build() {
    prim_box.resize(T);
    centroid.resize(T);
    order.resize(T);
    for (int64_t i = 0; i < T; ++i) {
      const float* t = tris + i * 9;
      AABB b;
      b.grow(V3(t[0], t[1], t[2]));
      b.grow(V3(t[3], t[4], t[5]));
      b.grow(V3(t[6], t[7], t[8]));
      prim_box[i] = b;
      centroid[i] = V3((b.lo.x + b.hi.x) * .5f, (b.lo.y + b.hi.y) * .5f,
                       (b.lo.z + b.hi.z) * .5f);
      order[i] = i;
    }

    struct Task { int64_t s, e, parent; int side; };
    std::vector<Task> stack;
    alloc_node();  // root = 0
    stack.push_back({0, T, -1, -1});
    while (!stack.empty()) {
      Task t = stack.back();
      stack.pop_back();
      int64_t mid = split(t.s, t.e);
      if (mid < 0) {
        if (t.parent < 0) {  // whole scene one leaf: root with empty slot 1
          AABB b = range_bounds(t.s, t.e);
          set_child_box(0, 0, b);
          set_child_box(0, 1, b);
          make_leaf(0, 0, t.s, t.e);
          nodes_child[1] = encode_leaf(0, 0);
        } else {
          make_leaf(t.parent, t.side, t.s, t.e);
        }
        continue;
      }
      int64_t node = (t.parent < 0) ? 0 : alloc_node();
      if (t.parent >= 0) nodes_child[t.parent * 2 + t.side] = static_cast<int32_t>(node);
      set_child_box(node, 0, range_bounds(t.s, mid));
      set_child_box(node, 1, range_bounds(mid, t.e));
      if (mid - t.s <= leaf_size) make_leaf(node, 0, t.s, mid);
      else stack.push_back({t.s, mid, node, 0});
      if (t.e - mid <= leaf_size) make_leaf(node, 1, mid, t.e);
      else stack.push_back({mid, t.e, node, 1});
    }
  }
};

Builder* g_last = nullptr;

}  // namespace

extern "C" {

// Phase 1: build, return sizes. Call bvh_emit to fetch arrays, then bvh_free.
// Returns 0 on success.
int bvh_build(const float* tris, int64_t n_tris, int leaf_size,
              int64_t* out_n_nodes, int64_t* out_n_prims) {
  if (leaf_size < 1 || leaf_size > LEAF_COUNT_MASK || n_tris < 1) return -1;
  delete g_last;
  g_last = new Builder();
  g_last->tris = tris;
  g_last->T = n_tris;
  g_last->leaf_size = leaf_size;
  g_last->build();
  *out_n_nodes = g_last->n_nodes;
  *out_n_prims = static_cast<int64_t>(g_last->leaf_ranges.size()) * leaf_size;
  return 0;
}

int bvh_emit(float* nodes_box, int32_t* nodes_child, float* tris_out,
             int32_t* prim_index) {
  if (!g_last) return -1;
  Builder& b = *g_last;
  std::memcpy(nodes_box, b.nodes_box.data(), b.nodes_box.size() * sizeof(float));
  std::memcpy(nodes_child, b.nodes_child.data(),
              b.nodes_child.size() * sizeof(int32_t));
  int64_t cursor = 0;
  for (auto& r : b.leaf_ranges) {
    int64_t k = r.second - r.first;
    for (int64_t j = 0; j < b.leaf_size; ++j) {
      float* row = tris_out + (cursor + j) * 9;
      if (j < k) {
        int64_t p = b.order[r.first + j];
        const float* t = b.tris + p * 9;
        // v0, e1 = v1-v0, e2 = v2-v0
        row[0] = t[0]; row[1] = t[1]; row[2] = t[2];
        row[3] = t[3] - t[0]; row[4] = t[4] - t[1]; row[5] = t[5] - t[2];
        row[6] = t[6] - t[0]; row[7] = t[7] - t[1]; row[8] = t[8] - t[2];
        prim_index[cursor + j] = static_cast<int32_t>(p);
      } else {
        std::memset(row, 0, 9 * sizeof(float));
        prim_index[cursor + j] = -1;
      }
    }
    cursor += b.leaf_size;
  }
  return 0;
}

void bvh_free() {
  delete g_last;
  g_last = nullptr;
}

}  // extern "C"
