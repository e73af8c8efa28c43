// What the traversal kernels traverse_f32.cu (B1), traverse_bf16.cu (B2) and
// traverse_rows.cu (B3) share: the ray, the slab test and the f32
// Möller-Trumbore test, B1's leaf visitor (B3's too), and the node and TLAS
// phase (one thread per ray, a DenseBVH walked with a per-thread stack,
// leaves handed to a leaf visitor). B1 and B2 walk from the root; B3 walks
// once per warp while its rays are coherent and then hands each lane's state
// to the same walk. The wave engine's kernels (leaf_mt.cu, B4, and
// wave_scan.cu) take the f32 Möller-Trumbore test and the classic BVH's leaf
// code from here.
//
// Semantics copied exactly from the TPU kernels (ops/pallas_trace.py and
// ops/pallas_bf16.py of the JAX package): the sign-preserving 1e-20
// reciprocal, the slab test (tn <= tf && tf > 0 && tn < t_clip && t_clip > 0),
// rejection of ABSENT children by code, the child-code decoding, the instance
// enter (world ray transformed in the same operation order, RESTORE sentinel
// pushed) and restore, and the step bound max_steps = 8*N*(I+1)+64. A ray that
// hits the step bound or the stack cap is reported as truncated, never dropped
// silently. Compiled without fast math and with --fmad=false, so that the f32
// arithmetic matches the plain PyTorch versions bit for bit.
//
// The walk is the while-while loop of Aila and Laine ("Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009), non-speculative: a lane
// steps through nodes (instance enter and restore included) until it holds a
// triangle leaf or is done, the warp stays in that node loop while any lane
// still needs a node step, and then every lane that holds a leaf sweeps it
// together. A leaf sweep costs several node steps (c triangle tests in B1, c
// band candidates in B2), so batching them keeps the warp's lanes on the same
// kind of work instead of alternating node and leaf lanes. A lane that holds
// a leaf waits for it, so each ray visits the same nodes and leaves in the
// same order, under the same clip, as a lane walking alone: the outputs and
// the counted work of every ray are those of the one-step-per-iteration walk
// it replaces. Measured on the H100 and not kept (PERF.md): the first 16
// stack entries in shared memory, and persistent warps that take rays from a
// global counter; both were slower on co-sorted rays, whose warps finish
// together and whose local-memory stack stays in L1.
//
// A leaf visitor provides
//   float clip() const;                      the slab clip of the next node test
//   bool visit(int gv, int inst, const Ray&); sweep triangle leaf gv = group*8 +
//                                             log2(c) in the current ray space;
//                                             true ends the walk (ray done);
//   void on_node();                           called once per node step (a
//                                             no-op unless the visitor counts
//                                             work for the bound).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pbrt {

constexpr int NODE_F = 16;
constexpr int LEAF_W = 128;
constexpr int INST_F = 16;
constexpr int RESTORE_ID = (1 << 22) - 1;
constexpr int RESTORE_CODE = -(2 * RESTORE_ID + 2);
constexpr int ABSENT = -(1 << 30);
constexpr int DONE = 0x7FFFFFFF;
constexpr int STACK_CAP = 64;
constexpr int BLOCK = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;
// the classic BVH's leaf code (bvh/types.py, leaf_mt.cu and wave_scan.cu):
// c < 0 is a leaf, m = -(c + 1), first slot m >> LEAF_COUNT_BITS, count
// m & LEAF_COUNT_MASK
constexpr int LEAF_COUNT_BITS = 7;
constexpr int LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz;
};

__device__ __forceinline__ void decode_leaf(int code, int& first, int& count) {
  const int m = -(code + 1);
  first = m >> LEAF_COUNT_BITS;
  count = m & LEAF_COUNT_MASK;
}

__device__ __forceinline__ float rcp_safe(float d) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx,
                                        float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, rcp_safe(dx), rcp_safe(dy), rcp_safe(dz)};
}

// slab() and mt_f32() are the arithmetic that ops/trace.py UNIT_OPS counts
// for the kernels' bound (26 operations per slab test, 54 per triangle test
// with the t-clip compare): an edit here updates it there.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz,
                                     float hx, float hy, float hz, float t_clip,
                                     float* tn_out) {
  const float tx0 = (lx - r.ox) * r.rdx;
  const float tx1 = (hx - r.ox) * r.rdx;
  const float ty0 = (ly - r.oy) * r.rdy;
  const float ty1 = (hy - r.oy) * r.rdy;
  const float tz0 = (lz - r.oz) * r.rdz;
  const float tz1 = (hz - r.oz) * r.rdz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  *tn_out = tn;
  return (tn <= tf) && (tf > 0.0f) && (tn < t_clip) && (t_clip > 0.0f);
}

// the nine values of one f32 triangle: v0, e1 = v1 - v0, e2 = v2 - v0
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Asks L1 for the 128-byte lines of [p, p + bytes), all at once: a loop that
// then reads them one record after another waits for one memory latency
// instead of one each time it crosses into a new sector.
__device__ __forceinline__ void prefetch_l1(const void* p, int bytes) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(p) + bytes;
  for (uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127); a < end; a += 128)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(a));
}

// a per-triangle leaf record of DenseBVH.leaf_rec (B1, B3): three float4,
// [v0.xyz, prim], [e1.xyz, 0], [e2.xyz, 0], read as three 16-byte loads
__device__ __forceinline__ Tri tri_record(const float4* __restrict__ rec, float& prim) {
  const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  prim = a.w;
  return Tri{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
}

// Möller-Trumbore of ray r against triangle s, in the reference's operation
// order. Returns the accept: |det| > 1e-9, u, v >= 0, u + v <= 1, t > 0.
// Every kernel that tests f32 triangles (B1, B3, B4) uses this one function,
// whichever loader gave it the triangle, so their t values are bit-equal for
// the same ray and triangle.
__device__ __forceinline__ bool mt_f32(const Ray& r, const Tri& s, float& tt, float& uu,
                                       float& vv) {
  const float v0x = s.v0x, v0y = s.v0y, v0z = s.v0z;
  const float e1x = s.e1x, e1y = s.e1y, e1z = s.e1z;
  const float e2x = s.e2x, e2y = s.e2y, e2z = s.e2z;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > 1e-9f;
  const float inv = 1.0f / (det_ok ? det : 1.0f);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  uu = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > 0.0f;
}

// the object-space ray of instance row m (object-from-world 3x4) for world
// ray w, in the reference's operation order
__device__ __forceinline__ Ray enter_instance(const float* __restrict__ m, const Ray& w) {
  return make_ray(m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3],
                  m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7],
                  m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11],
                  m[0] * w.dx + m[1] * w.dy + m[2] * w.dz,
                  m[4] * w.dx + m[5] * w.dy + m[6] * w.dz,
                  m[8] * w.dx + m[9] * w.dy + m[10] * w.dz);
}

// B1's leaf visitor (B3's once its warp has split): tests the c distinct
// triangles (records 0..c-1) of a leaf group of DenseBVH.leaf_rec in f32.
// COUNT: also counts node steps, triangle tests and leaf visits (the counting
// instantiation, run once per ray set for the bound; the main path never).
template <bool CLOSEST, bool COUNT>
struct LeafF32 {
  const float4* __restrict__ rec;
  int rec_stride;  // records per group (C)
  float tmax;
  float t_best, best_u, best_v;
  int best_prim, best_inst;
  bool occluded;
  int n_node, n_tri, n_leaf;

  // occlusion mode leaves the walk as soon as it is occluded, so its clip is
  // tmax on every step it takes
  __device__ float clip() const { return CLOSEST ? t_best : tmax; }

  __device__ void on_node() {
    if (COUNT) ++n_node;
  }

  __device__ bool visit(int gv, int inst, const Ray& r) {
    const int count = 1 << (gv & 7);
    const float4* g = rec + (size_t)(gv >> 3) * rec_stride * 3;
    prefetch_l1(g, count * 48);
    if (COUNT) ++n_leaf;
    for (int j = 0; j < count; ++j) {
      if (COUNT) ++n_tri;
      float prim, tt, uu, vv;
      const bool ok = mt_f32(r, tri_record(g + 3 * j, prim), tt, uu, vv);
      if (CLOSEST) {
        if (ok && tt < t_best) {
          t_best = tt; best_u = uu; best_v = vv;
          best_prim = (int)prim;
          best_inst = inst;
        }
      } else if (ok && tt < tmax) {
        occluded = true;
        return true;
      }
    }
    return false;
  }
};

// The state of one ray's walk besides its stack: its ray (world space, or
// the entered instance's object space), stack pointer, where it is (a node,
// or a leaf or instance code), its instance, the steps it has taken, and
// whether it still walks. B1 and B2 start it at the root; B3 starts it where
// its warp left the shared walk. (The stack is a separate array: a struct
// holding it would be placed in local memory whole, its scalars too.)
struct Walk {
  Ray r;
  int sp, cur, inst, steps;
  bool live;
};

// Walks the tables for one ray from state w and its stack; returns true if
// the ray was truncated (step bound or stack cap). Every lane of a full warp
// calls it together (the node-loop votes name all 32 lanes): a lane that
// does not walk passes w.live = false. ORDERED: descend into the nearer child first
// (by the ray's own slab entry), else child 0 first. A node step, an
// instance enter or restore and a leaf visit each count one step against
// max_steps, checked before the step, as in the reference.
template <bool ORDERED, class Leaf>
__device__ __forceinline__ bool walk_from(const float* __restrict__ nodes,
                                          const float* __restrict__ inst16, int two_level,
                                          const Ray& world, int max_steps, Walk& w,
                                          int* stack, Leaf& leaf) {
  bool cut = false;
  while (__any_sync(FULL_MASK, w.live)) {
    // node loop: step until this lane holds a triangle leaf (w.cur) or is done
    bool at_leaf = false;
    while (__any_sync(FULL_MASK, w.live && !at_leaf)) {
      if (!w.live || at_leaf) continue;
      if (w.steps >= max_steps) {
        cut = true;
        w.live = false;
        continue;
      }
      int nxt = DONE;
      if (w.cur >= 0) {
        ++w.steps;
        leaf.on_node();
        const float4* np = reinterpret_cast<const float4*>(nodes + (size_t)w.cur * NODE_F);
        const float4 a = __ldg(np), b = __ldg(np + 1), c = __ldg(np + 2), e = __ldg(np + 3);
        const float t_clip = leaf.clip();
        const int c0 = (int)e.x, c1 = (int)e.y;
        float tn0, tn1;
        const bool h0 = slab(w.r, a.x, a.y, a.z, a.w, b.x, b.y, t_clip, &tn0) && c0 != ABSENT;
        const bool h1 = slab(w.r, b.z, b.w, c.x, c.y, c.z, c.w, t_clip, &tn1) && c1 != ABSENT;
        if (h0 && h1) {
          const bool swap = ORDERED && tn1 < tn0;
          if (w.sp >= STACK_CAP) {
            cut = true;
            w.live = false;
            continue;
          }
          stack[w.sp++] = swap ? c0 : c1;
          nxt = swap ? c1 : c0;
        } else if (h0) {
          nxt = c0;
        } else if (h1) {
          nxt = c1;
        }
      } else {
        const int v = -(w.cur + 1);
        if (!(two_level && (v & 1))) {
          at_leaf = true;  // a triangle leaf: swept below, with the warp
          continue;
        }
        ++w.steps;
        const int iid = v >> 1;
        if (iid == RESTORE_ID) {
          w.r = world;
          w.inst = -1;
        } else {
          if (w.sp >= STACK_CAP) {
            cut = true;
            w.live = false;
            continue;
          }
          stack[w.sp++] = RESTORE_CODE;
          const float* m = inst16 + (size_t)iid * INST_F;
          w.r = enter_instance(m, world);
          w.inst = iid;
          nxt = (int)m[12];
        }
      }
      if (nxt == DONE) {
        if (w.sp == 0) {
          w.live = false;
          continue;
        }
        nxt = stack[--w.sp];
      }
      w.cur = nxt;
    }
    // leaf phase: every lane that holds a leaf sweeps it, together
    if (at_leaf) {
      ++w.steps;
      if (leaf.visit((-(w.cur + 1)) >> 1, w.inst, w.r) || w.sp == 0)
        w.live = false;
      else
        w.cur = stack[--w.sp];
    }
  }
  return cut;
}

// Walks the tables for one ray from the root (B1, B2). A ray with
// tmax <= 0 passes no slab test and accepts no triangle, so it does not walk
// at all (a lane without a ray passes tmax = 0).
template <bool ORDERED, class Leaf>
__device__ __forceinline__ bool walk(const float* __restrict__ nodes,
                                     const float* __restrict__ inst16, int two_level,
                                     const Ray& world, float tmax, int max_steps,
                                     Leaf& leaf) {
  int stack[STACK_CAP];
  Walk w{world, 0, 0, -1, 0, tmax > 0.0f};
  return walk_from<ORDERED>(nodes, inst16, two_level, world, max_steps, w, stack, leaf);
}

inline int grid_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace pbrt
