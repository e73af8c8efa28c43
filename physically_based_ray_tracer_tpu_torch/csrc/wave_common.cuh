// What the wave engine's kernels share: the node scan's steps (wave_scan.cu,
// and wave_level.cu inside its loop) and the dense tile x leaf
// Möller-Trumbore sweep of kernel B4 (leaf_mt.cu, and wave_level.cu). One
// source for the maths, so that the standalone kernels and the fused level
// are bit-equal to each other and to the plain PyTorch versions
// (ops/wave_scan.py, ops/leaf_mt.py), compiled with --fmad=false.
//
// The scan step is the JAX package's _wave_node_scan step
// (physically_based_ray_tracer_tpu/ops/traverse_packet.py), operation for
// operation: the leaf append (or, with a full buffer, the stall on the leaf),
// the conservative interval slab of both children against the tile's origin
// box and reciprocal-direction interval, the masking of empty leaves, the
// near/far swap on d1 < d0, the push of the far child, and the pop. min and
// max propagate NaN as jnp.minimum / torch.minimum do (an all-NaN ray in a
// tile poisons its bounds in every version alike). A push at sp >=
// stack_depth is dropped, as in JAX, but counted in *truncated, and the pop
// then reads the clamped top slot.
//
// The sweep is B4's function: per ray, for each live slot l < n of the tile's
// leaf buffer and each triangle k < count of that leaf, in that order,
// mt_f32; closest mode takes the hit when t < min(t_best, tmax) (prim = the
// leaf's first slot + k), any mode sets occ when some live triangle is hit at
// 0 < t < tmax. The W threads of a tile stage its live triangles in shared
// memory, a round of `per_round` leaves at a time, and every thread then
// reads the same shared word (a broadcast).

#pragma once

#include "traverse_common.cuh"

namespace pbrt {

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ void iprod(float a_lo, float a_hi, float b_lo, float b_hi,
                                      float& lo, float& hi) {
  const float p1 = a_lo * b_lo, p2 = a_lo * b_hi, p3 = a_hi * b_lo, p4 = a_hi * b_hi;
  lo = nan_min(nan_min(p1, p2), nan_min(p3, p4));
  hi = nan_max(nan_max(p1, p2), nan_max(p3, p4));
}

// The classic BVH's node rows, read through the read-only path (device
// memory) or from a copy staged in shared memory.
struct GlobalNodes {
  const float* __restrict__ box;   // (N, 12)
  const int* __restrict__ child;   // (N, 2)
  __device__ __forceinline__ float b(int i) const { return __ldg(box + i); }
  __device__ __forceinline__ int c(int i) const { return __ldg(child + i); }
};

struct SharedNodes {
  const float* box;
  const int* child;
  __device__ __forceinline__ float b(int i) const { return box[i]; }
  __device__ __forceinline__ int c(int i) const { return child[i]; }
};

// One piece of _interval_slab: axis a of one child box, its two slab planes'
// t intervals -> lo (their lower bounds' min) and hi (their upper bounds' max).
__device__ __forceinline__ void slab_piece(float bmin, float bmax, float o_lo, float o_hi,
                                           float rd_lo, float rd_hi, float& lo, float& hi) {
  float t1_lo, t1_hi, t2_lo, t2_hi;
  iprod(bmin - o_hi, bmin - o_lo, rd_lo, rd_hi, t1_lo, t1_hi);
  iprod(bmax - o_hi, bmax - o_lo, rd_lo, rd_hi, t2_lo, t2_hi);
  lo = nan_min(t1_lo, t2_lo);
  hi = nan_max(t1_hi, t2_hi);
}

// The rest of _interval_slab: the pieces of axes 0, 1, 2 merged in that
// order into enter_lb (the lower bound of the rays' entry distance) and
// exit_ub; may_hit.
__device__ __forceinline__ bool slab_hit(float enter_lb, float exit_ub, float t_tile) {
  return (enter_lb <= exit_ub) && (exit_ub > 0.0f) && (enter_lb < t_tile);
}

// A scan step's box tests on one thread: both children of `node`, all six
// pieces. bounds = o_lo[3], o_hi[3], rd_lo[3], rd_hi[3].
struct SerialSlabs {
  __device__ __forceinline__ bool writer() const { return true; }
  __device__ __forceinline__ void sync() const {}
  template <class Nodes>
  __device__ __forceinline__ void test(const Nodes& nodes, int node, const float* bounds,
                                       float t_tile, float& d0, bool& h0, float& d1,
                                       bool& h1) const {
    float d[2], e[2];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int c = q / 3, a = q % 3, at = node * 12 + c * 6;
      float lo, hi;
      slab_piece(nodes.b(at + a), nodes.b(at + 3 + a), bounds[a], bounds[3 + a],
                 bounds[6 + a], bounds[9 + a], lo, hi);
      d[c] = a == 0 ? lo : nan_max(d[c], lo);
      e[c] = a == 0 ? hi : nan_min(e[c], hi);
    }
    d0 = d[0];
    d1 = d[1];
    h0 = slab_hit(d0, e[0], t_tile);
    h1 = slab_hit(d1, e[1], t_tile);
  }
};

// The same tests on the `width` lanes (>= 6, a power of two <= 32) of one
// warp segment that walk the same tile together: lane q < 6 computes piece q
// (child q / 3, axis q % 3), the pieces are exchanged by shuffles, and every
// lane merges them alike. Only the segment's first lane writes (`writer`).
struct LaneSlabs {
  unsigned mask;   // the segment's lanes
  int width, lane;
  __device__ __forceinline__ bool writer() const { return lane == 0; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <class Nodes>
  __device__ __forceinline__ void test(const Nodes& nodes, int node, const float* bounds,
                                       float t_tile, float& d0, bool& h0, float& d1,
                                       bool& h1) const {
    const int q = lane % 6, at = node * 12 + (q / 3) * 6, a = q % 3;
    float lo, hi;
    slab_piece(nodes.b(at + a), nodes.b(at + 3 + a), bounds[a], bounds[3 + a],
               bounds[6 + a], bounds[9 + a], lo, hi);
    // merged as they arrive, in axis order, so that two values are live
    float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float l = __shfl_sync(mask, lo, k, width), h = __shfl_sync(mask, hi, k, width);
      if (k == 0) { d0 = l; e0 = h; }
      else if (k < 3) { d0 = nan_max(d0, l); e0 = nan_min(e0, h); }
      else if (k == 3) { d1 = l; e1 = h; }
      else { d1 = nan_max(d1, l); e1 = nan_min(e1, h); }
    }
    h0 = slab_hit(d0, e0, t_tile);
    h1 = slab_hit(d1, e1, t_tile);
  }
};

__device__ __forceinline__ bool empty_leaf(int c) {
  int first, count;
  decode_leaf(c, first, count);
  return c < 0 && count == 0;
}

// One tile's node_steps scan steps. cur, sp, active are the tile's cursor,
// stack pointer and flag (updated); stk its stack_depth stack; leaves its
// leaf_cap buffer, of which the first nleaf (from 0) are written. `slabs`
// runs the box tests (SerialSlabs, or LaneSlabs on the lanes of a warp
// segment, each of which then holds the same state).
template <class Nodes, class Slabs>
__device__ __forceinline__ void scan_steps(const Nodes& nodes, int n_nodes,
                                           const float* bounds, float t_tile, int& cur,
                                           int& sp, bool& active, int* stk, int stack_depth,
                                           int* leaves, int& nleaf, int leaf_cap,
                                           int node_steps, int* truncated,
                                           const Slabs& slabs) {
  nleaf = 0;
  for (int step = 0; step < node_steps; ++step) {
    const bool is_leaf = cur < 0;
    const bool full = nleaf >= leaf_cap;
    if (is_leaf && active && !full) {
      if (slabs.writer()) leaves[nleaf] = cur;
      ++nleaf;
    }

    const int node = min(max((is_leaf || !active) ? 0 : cur, 0), n_nodes - 1);
    const int c0 = nodes.c(2 * node), c1 = nodes.c(2 * node + 1);
    float d0, d1;
    bool h0, h1;
    slabs.test(nodes, node, bounds, t_tile, d0, h0, d1, h1);
    h0 = h0 && !empty_leaf(c0);
    h1 = h1 && !empty_leaf(c1);
    const bool swap = d1 < d0;
    const int near = swap ? c1 : c0, far = swap ? c0 : c1;
    const bool near_hit = swap ? h1 : h0, far_hit = swap ? h0 : h1;
    const int internal_next = near_hit ? near : (far_hit ? far : DONE);
    if (near_hit && far_hit && active && !is_leaf) {
      if (sp < stack_depth) {
        if (slabs.writer()) stk[sp] = far;
      } else if (slabs.writer()) {
        atomicAdd(truncated, 1);
      }
      ++sp;
    }
    slabs.sync();   // the push is seen by every lane before the pop

    int nxt = is_leaf ? (full ? cur : DONE) : internal_next;
    const bool need_pop = nxt == DONE && active;
    const bool can_pop = need_pop && sp > 0;
    if (can_pop) {
      const int sp_pop = sp - 1;
      nxt = stk[min(sp_pop, stack_depth - 1)];
      sp = sp_pop;
    }
    active = active && !(need_pop && !can_pop);
    cur = active ? nxt : DONE;
  }
}

// The sweep of kernel B4 needs no merge between the parts of a tile: one
// group of threads holds all of a tile's rays.
struct NoMerge {
  __device__ __forceinline__ void begin_round(float) const {}
  __device__ __forceinline__ void start(float&, bool&) const {}
  __device__ __forceinline__ void end_round(float&, bool&) const {}
};

// The tile's rays against its n buffered leaves (codes), a round of
// per_round leaves at a time staged in `stage` (component c of column j at
// [c * stride + j], stride >= per_round * K). The tile's columns (leaf l,
// slot k: column l * K + k) are split among `parts` groups of `width`
// threads, each holding the tile's rays (one a thread, `lane` its rank):
// part p tests a contiguous share of each round's columns in column order,
// so the first minimum over the parts in part order is the first minimum in
// column order. `merge` (begin_round, start, end_round) hands the rays'
// state to the parts at a round's start and merges their results at its
// end; with one part it does nothing. Every thread of the block must call it
// with the same `rounds` (>= ceil(n / per_round)) and `parts`: the staging
// is fenced by __syncthreads. `ray` says whether this thread holds a ray (a
// group without a tile stages and tests nothing).
template <bool CLOSEST, class Merge>
__device__ __forceinline__ void sweep_leaves(const Ray& r, float tm, float& tb, float& ub,
                                             float& vb, int& pb, bool& occ,
                                             const int* codes, int n,
                                             const float* __restrict__ tris, int n_prims,
                                             int K, int per_round, int rounds, float* stage,
                                             int stride, int lane, int width, int part,
                                             int parts, bool ray, const Merge& merge) {
  for (int round = 0; round < rounds; ++round) {
    const int l0 = round * per_round;
    const int l1 = min(n, l0 + per_round);
    merge.begin_round(tb);
    // stage: the tile's threads read consecutive floats of the rows
    for (int j = part * width + lane; j < (l1 - l0) * K * 9; j += parts * width) {
      const int col = j / 9, comp = j - col * 9;
      int first, count;
      decode_leaf(codes[l0 + col / K], first, count);
      const int k = col % K;
      if (k < count) {
        const int row = min(first + k, n_prims - 1);
        stage[comp * stride + col] = tris[(size_t)row * 9 + comp];
      }
    }
    __syncthreads();
    merge.start(tb, occ);
    // this part's share of the round's columns [c0, c1), leaf by leaf
    const int cols = max(l1 - l0, 0) * K;
    const int share = (cols + parts - 1) / parts;
    const int c0 = min(cols, part * share), c1 = min(cols, c0 + share);
    int l = c0 / K, k = c0 - l * K, first = 0, count = 0;
    if (c0 < c1) {
      decode_leaf(codes[l0 + l], first, count);
      count = min(count, K);
    }
    for (int c = c0; ray && c < c1; ++c) {
      if (k < count) {
        const float* s = stage + c;
        const Tri tri{s[0], s[stride], s[2 * stride], s[3 * stride], s[4 * stride],
                      s[5 * stride], s[6 * stride], s[7 * stride], s[8 * stride]};
        float tt, uu, vv;
        const bool ok = mt_f32(r, tri, tt, uu, vv);
        if (CLOSEST) {
          if (ok && tt < fminf(tb, tm)) {
            tb = tt; ub = uu; vb = vv; pb = first + k;
          }
        } else {
          occ = occ || (ok && tt < tm);
        }
      }
      if (++k == K && c + 1 < c1) {
        k = 0;
        decode_leaf(codes[l0 + ++l], first, count);
        count = min(count, K);
      }
    }
    __syncthreads();
    merge.end_round(tb, occ);
  }
}

}  // namespace pbrt
