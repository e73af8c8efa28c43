// Native SBVH (spatial-split BVH) builder — the BuildHQ analogue.
//
// Implements the *algorithm family* of tinybvh's BuildHQ
// (Core/tiny_bvh.h:2027-2286: binned object SAH + spatial splits with
// triangle-slab clipping, overlap-gated, Stich et al. 2009) as an original
// fragment-based builder. Output is deliberately generic — an Aila/Laine
// 2-wide node table plus variable-length leaf segments of primitive
// references (duplicates allowed) — so Python packs it either into the
// classic BVHArrays layout (bvh/builder.py) or the dense-leaf Pallas layout
// (bvh/dense.py) without the C side knowing about either.
//
// C ABI for ctypes (no pybind11 in this image):
//   sbvh_build(tris, T, leaf_size, dense_mode, &n_nodes, &n_segs, &n_refs)
//   sbvh_emit(nodes_box N*12, children N*2, seg_off S+1, refs R)
//   sbvh_free()
// children codes: >= 0 internal node index; INT32_MIN absent slot;
// other < 0: leaf, segment = -(c+1).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int BINS = 8;              // HQBVHBINS (Core/tiny_bvh.h:92-125)
constexpr float C_TRAV = 1.0f;
constexpr float C_INT = 1.0f;
constexpr float OVERLAP_ALPHA = 1e-5f;  // spatial-split gate vs root area
constexpr int32_t ABSENT_CHILD = INT32_MIN;

struct V3 {
  float x = 0, y = 0, z = 0;
  float operator[](int i) const { return (&x)[i]; }
  float& operator[](int i) { return (&x)[i]; }
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) { lo = vmin(lo, o.lo); hi = vmax(hi, o.hi); }
  void grow(const V3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  bool empty() const { return lo.x > hi.x || lo.y > hi.y || lo.z > hi.z; }
  float area() const {
    if (empty()) return 0.f;
    float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
    return 2.f * (ex * ey + ey * ez + ez * ex);
  }
  AABB intersect(const AABB& o) const {
    AABB r;
    r.lo = vmax(lo, o.lo);
    r.hi = vmin(hi, o.hi);
    return r;
  }
};

// A primitive reference: the (possibly clipped) box of one triangle.
struct Frag {
  AABB box;
  int32_t prim;
};

// Clip the triangle's polygon to the slab a <= p[axis] <= b and return the
// AABB of the clipped polygon (Sutherland–Hodgman against the two planes;
// the role of tinybvh's ClipFrag, Core/tiny_bvh.h:2129 — reimplemented).
AABB clip_tri_slab(const float* t, int axis, float a, float b) {
  // polygon buffers (max 3 + 2 clips -> <= 5 verts each side, cap 8)
  V3 poly[2][8];
  int n[2];
  poly[0][0] = {t[0], t[1], t[2]};
  poly[0][1] = {t[3], t[4], t[5]};
  poly[0][2] = {t[6], t[7], t[8]};
  n[0] = 3;
  int cur = 0;
  // two half-space clips: p[axis] >= a, then p[axis] <= b
  for (int pass = 0; pass < 2; ++pass) {
    const float plane = pass == 0 ? a : b;
    const float sgn = pass == 0 ? 1.f : -1.f;   // keep sgn*(p-plane) >= 0
    int nxt = cur ^ 1;
    n[nxt] = 0;
    for (int i = 0; i < n[cur]; ++i) {
      const V3& p = poly[cur][i];
      const V3& q = poly[cur][(i + 1) % n[cur]];
      float dp = sgn * (p[axis] - plane);
      float dq = sgn * (q[axis] - plane);
      if (dp >= 0.f) poly[nxt][n[nxt]++] = p;
      if ((dp > 0.f && dq < 0.f) || (dp < 0.f && dq > 0.f)) {
        float w = dp / (dp - dq);
        poly[nxt][n[nxt]++] = {p.x + w * (q.x - p.x), p.y + w * (q.y - p.y),
                               p.z + w * (q.z - p.z)};
      }
    }
    cur = nxt;
    if (n[cur] == 0) return AABB{};  // fully outside: empty box
  }
  AABB out;
  for (int i = 0; i < n[cur]; ++i) out.grow(poly[cur][i]);
  return out;
}

struct HQBuilder {
  const float* tris;   // (T, 9) three corners
  int64_t T;
  int leaf_size;
  bool dense_mode;     // true: leaf as soon as count <= leaf_size
  int64_t ref_budget;  // extra references allowed by splitting

  std::vector<float> nodes_box;       // N*12
  std::vector<int32_t> children;      // N*2
  std::vector<std::vector<int32_t>> segments;
  int64_t n_nodes = 0;
  int64_t n_refs = 0;
  float root_area = 1.f;

  int64_t alloc_node() {
    nodes_box.resize(nodes_box.size() + 12, 0.f);
    children.resize(children.size() + 2, ABSENT_CHILD);
    return n_nodes++;
  }

  void set_child_box(int64_t node, int side, const AABB& b) {
    float* p = &nodes_box[node * 12 + side * 6];
    p[0] = b.lo.x; p[1] = b.lo.y; p[2] = b.lo.z;
    p[3] = b.hi.x; p[4] = b.hi.y; p[5] = b.hi.z;
  }

  void make_leaf(int64_t parent, int side, std::vector<Frag>& frags) {
    int32_t seg = static_cast<int32_t>(segments.size());
    segments.emplace_back();
    auto& s = segments.back();
    s.reserve(frags.size());
    for (const Frag& f : frags) s.push_back(f.prim);
    n_refs += static_cast<int64_t>(s.size());
    children[parent * 2 + side] = -(seg + 1);
  }

  struct Split {
    float cost = FLT_MAX;
    int axis = -1;
    bool spatial = false;
    float plane = 0.f;       // spatial: world plane position
    int bin = -1;            // object: centroid bin threshold
    V3 cmin;                 // object: centroid bounds + scale for binning
    float scale = 0.f;
    AABB lbox, rbox;
  };

  Split best_object_split(const std::vector<Frag>& frags) {
    Split out;
    V3 cmin{FLT_MAX, FLT_MAX, FLT_MAX}, cmax{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (const Frag& f : frags) {
      V3 c{(f.box.lo.x + f.box.hi.x) * .5f, (f.box.lo.y + f.box.hi.y) * .5f,
           (f.box.lo.z + f.box.hi.z) * .5f};
      cmin = vmin(cmin, c);
      cmax = vmax(cmax, c);
    }
    for (int ax = 0; ax < 3; ++ax) {
      float ext = cmax[ax] - cmin[ax];
      if (ext <= 1e-12f) continue;
      float scale = BINS * 0.9999f / ext;
      AABB bb[BINS];
      int64_t cnt[BINS] = {0};
      for (const Frag& f : frags) {
        float c = (f.box.lo[ax] + f.box.hi[ax]) * .5f;
        int b = std::min(std::max(int((c - cmin[ax]) * scale), 0), BINS - 1);
        bb[b].grow(f.box);
        cnt[b]++;
      }
      AABB lbox[BINS];
      int64_t lcnt[BINS];
      AABB acc;
      int64_t ca = 0;
      for (int b = 0; b < BINS; ++b) {
        acc.grow(bb[b]); ca += cnt[b];
        lbox[b] = acc; lcnt[b] = ca;
      }
      AABB racc;
      int64_t ra = 0;
      for (int b = BINS - 1; b >= 1; --b) {
        racc.grow(bb[b]); ra += cnt[b];
        if (lcnt[b - 1] == 0 || ra == 0) continue;
        float cost = lbox[b - 1].area() * lcnt[b - 1] + racc.area() * ra;
        if (cost < out.cost) {
          out.cost = cost; out.axis = ax; out.bin = b - 1;
          out.cmin = cmin; out.scale = scale;
          out.lbox = lbox[b - 1]; out.rbox = racc;
          out.spatial = false;
        }
      }
    }
    return out;
  }

  Split best_spatial_split(const std::vector<Frag>& frags, const AABB& nb) {
    Split out;
    for (int ax = 0; ax < 3; ++ax) {
      float ext = nb.hi[ax] - nb.lo[ax];
      if (ext <= 1e-12f) continue;
      float w = ext / BINS;
      AABB bb[BINS];
      int64_t entry[BINS] = {0}, exit_[BINS] = {0};
      for (const Frag& f : frags) {
        int b_lo = std::min(std::max(int((f.box.lo[ax] - nb.lo[ax]) / w), 0),
                            BINS - 1);
        int b_hi = std::min(std::max(int((f.box.hi[ax] - nb.lo[ax]) / w), b_lo),
                            BINS - 1);
        entry[b_lo]++;
        exit_[b_hi]++;
        if (b_lo == b_hi) {
          bb[b_lo].grow(f.box);
        } else {
          const float* t = tris + int64_t(f.prim) * 9;
          for (int b = b_lo; b <= b_hi; ++b) {
            AABB clipped = clip_tri_slab(t, ax, nb.lo[ax] + b * w,
                                         nb.lo[ax] + (b + 1) * w);
            clipped = clipped.intersect(f.box);
            if (!clipped.empty()) bb[b].grow(clipped);
          }
        }
      }
      AABB lbox[BINS];
      int64_t lcnt[BINS];
      AABB acc;
      int64_t ca = 0;
      for (int b = 0; b < BINS; ++b) {
        acc.grow(bb[b]); ca += entry[b];
        lbox[b] = acc; lcnt[b] = ca;
      }
      AABB racc;
      int64_t ra = 0;
      for (int b = BINS - 1; b >= 1; --b) {
        racc.grow(bb[b]); ra += exit_[b];
        if (lcnt[b - 1] == 0 || ra == 0) continue;
        float cost = lbox[b - 1].area() * lcnt[b - 1] + racc.area() * ra;
        if (cost < out.cost) {
          out.cost = cost; out.axis = ax; out.spatial = true;
          out.plane = nb.lo[ax] + b * w;
          out.lbox = lbox[b - 1]; out.rbox = racc;
        }
      }
    }
    return out;
  }

  // Partition frags by the chosen split into l/r (spatial may duplicate,
  // consuming ref_budget). Returns false if one side came out empty.
  bool partition(const std::vector<Frag>& frags, const Split& sp,
                 std::vector<Frag>& l, std::vector<Frag>& r) {
    if (!sp.spatial) {
      for (const Frag& f : frags) {
        float c = (f.box.lo[sp.axis] + f.box.hi[sp.axis]) * .5f;
        int b = std::min(std::max(int((c - sp.cmin[sp.axis]) * sp.scale), 0),
                         BINS - 1);
        (b <= sp.bin ? l : r).push_back(f);
      }
    } else {
      for (const Frag& f : frags) {
        if (f.box.hi[sp.axis] <= sp.plane) {
          l.push_back(f);
        } else if (f.box.lo[sp.axis] >= sp.plane) {
          r.push_back(f);
        } else if (ref_budget > 0) {
          const float* t = tris + int64_t(f.prim) * 9;
          AABB lb = clip_tri_slab(t, sp.axis, -FLT_MAX, sp.plane)
                        .intersect(f.box);
          AABB rb = clip_tri_slab(t, sp.axis, sp.plane, FLT_MAX)
                        .intersect(f.box);
          if (lb.empty() || rb.empty()) {
            // clip degenerated (flat tri on the plane): side by centroid
            float c = (f.box.lo[sp.axis] + f.box.hi[sp.axis]) * .5f;
            (c < sp.plane ? l : r).push_back(f);
          } else {
            l.push_back({lb, f.prim});
            r.push_back({rb, f.prim});
            --ref_budget;
          }
        } else {
          float c = (f.box.lo[sp.axis] + f.box.hi[sp.axis]) * .5f;
          (c < sp.plane ? l : r).push_back(f);
        }
      }
    }
    return !l.empty() && !r.empty();
  }

  static void median_partition(std::vector<Frag>& frags, const AABB& nb,
                               std::vector<Frag>& l, std::vector<Frag>& r) {
    int ax = 0;
    V3 e{nb.hi.x - nb.lo.x, nb.hi.y - nb.lo.y, nb.hi.z - nb.lo.z};
    if (e.y > e.x) ax = 1;
    if (e.z > e[ax]) ax = 2;
    size_t m = frags.size() / 2;
    std::nth_element(frags.begin(), frags.begin() + m, frags.end(),
                     [ax](const Frag& a, const Frag& b) {
                       return a.box.lo[ax] + a.box.hi[ax]
                            < b.box.lo[ax] + b.box.hi[ax];
                     });
    l.assign(frags.begin(), frags.begin() + m);
    r.assign(frags.begin() + m, frags.end());
  }

  void build() {
    std::vector<Frag> root;
    root.resize(T);
    AABB rb;
    for (int64_t i = 0; i < T; ++i) {
      const float* t = tris + i * 9;
      AABB b;
      b.grow(V3{t[0], t[1], t[2]});
      b.grow(V3{t[3], t[4], t[5]});
      b.grow(V3{t[6], t[7], t[8]});
      root[i] = {b, static_cast<int32_t>(i)};
      rb.grow(b);
    }
    root_area = std::max(rb.area(), 1e-30f);
    ref_budget = T;  // at most 2T references total (tinybvh reserves ~1.5T)

    struct Task {
      std::vector<Frag> frags;
      AABB box;
      int64_t parent;
      int side;
    };
    std::vector<Task> stack;
    alloc_node();  // root = 0
    stack.push_back({std::move(root), rb, -1, -1});

    while (!stack.empty()) {
      Task task = std::move(stack.back());
      stack.pop_back();
      int64_t count = static_cast<int64_t>(task.frags.size());

      bool force_leaf = false;
      std::vector<Frag> l, r;
      if (count == 1 || (dense_mode && count <= leaf_size)) {
        force_leaf = true;
      } else {
        Split sp = best_object_split(task.frags);
        if (sp.axis >= 0) {
          AABB ov = sp.lbox.intersect(sp.rbox);
          if (ov.area() > OVERLAP_ALPHA * root_area && ref_budget > 0) {
            Split ss = best_spatial_split(task.frags, task.box);
            if (ss.cost < sp.cost) sp = ss;
          }
        }
        if (sp.axis < 0) {
          // degenerate distribution (all centroids equal)
          if (count <= leaf_size) {
            force_leaf = true;
          } else {
            median_partition(task.frags, task.box, l, r);
          }
        } else {
          // SAH split-vs-leaf termination (tiny_bvh.h:1893 semantics); in
          // dense_mode leaf cost is a constant per visit so never applies
          if (!dense_mode && count <= leaf_size) {
            float leaf_cost = C_INT * task.box.area() * count;
            float split_cost = C_TRAV * task.box.area() + C_INT * sp.cost;
            if (split_cost >= leaf_cost) force_leaf = true;
          }
          if (!force_leaf) {
            bool ok = partition(task.frags, sp, l, r);
            // no-progress guard: a spatial split that duplicated every
            // fragment into both children would recurse forever
            if (ok && sp.spatial
                && (static_cast<int64_t>(l.size()) >= count
                    && static_cast<int64_t>(r.size()) >= count))
              ok = false;
            if (!ok) {
              l.clear(); r.clear();
              if (count <= leaf_size) force_leaf = true;
              else median_partition(task.frags, task.box, l, r);
            }
          }
        }
      }
      // hard cap: classic packing can't hold more than leaf_size refs
      if (force_leaf && count > leaf_size) {
        l.clear(); r.clear();
        median_partition(task.frags, task.box, l, r);
        force_leaf = false;
      }

      if (force_leaf) {
        if (task.parent < 0) {
          // whole scene in one leaf: root with the leaf in slot 0
          set_child_box(0, 0, task.box);
          set_child_box(0, 1, task.box);
          make_leaf(0, 0, task.frags);
        } else {
          make_leaf(task.parent, task.side, task.frags);
        }
        continue;
      }

      AABB lb2, rb2;
      for (const Frag& f : l) lb2.grow(f.box);
      for (const Frag& f : r) rb2.grow(f.box);
      int64_t node = task.parent < 0 ? 0 : alloc_node();
      if (task.parent >= 0)
        children[task.parent * 2 + task.side] = static_cast<int32_t>(node);
      set_child_box(node, 0, lb2);
      set_child_box(node, 1, rb2);
      task.frags.clear();
      task.frags.shrink_to_fit();
      stack.push_back({std::move(l), lb2, node, 0});
      stack.push_back({std::move(r), rb2, node, 1});
    }
  }
};

HQBuilder* g_hq = nullptr;

}  // namespace

extern "C" {

int sbvh_build(const float* tris, int64_t n_tris, int leaf_size,
               int dense_mode, int64_t* out_n_nodes, int64_t* out_n_segs,
               int64_t* out_n_refs) {
  if (leaf_size < 1 || n_tris < 1) return -1;
  delete g_hq;
  g_hq = new HQBuilder();
  g_hq->tris = tris;
  g_hq->T = n_tris;
  g_hq->leaf_size = leaf_size;
  g_hq->dense_mode = dense_mode != 0;
  g_hq->build();
  *out_n_nodes = g_hq->n_nodes;
  *out_n_segs = static_cast<int64_t>(g_hq->segments.size());
  *out_n_refs = g_hq->n_refs;
  return 0;
}

int sbvh_emit(float* nodes_box, int32_t* children, int64_t* seg_off,
              int32_t* refs) {
  if (!g_hq) return -1;
  HQBuilder& b = *g_hq;
  std::memcpy(nodes_box, b.nodes_box.data(), b.nodes_box.size() * sizeof(float));
  std::memcpy(children, b.children.data(), b.children.size() * sizeof(int32_t));
  int64_t cursor = 0;
  for (size_t s = 0; s < b.segments.size(); ++s) {
    seg_off[s] = cursor;
    std::memcpy(refs + cursor, b.segments[s].data(),
                b.segments[s].size() * sizeof(int32_t));
    cursor += static_cast<int64_t>(b.segments[s].size());
  }
  seg_off[b.segments.size()] = cursor;
  return 0;
}

void sbvh_free() {
  delete g_hq;
  g_hq = nullptr;
}

}  // extern "C"
