// Kernel B3: exact f32 BVH traversal of a DenseBVH (one- or two-level), one
// traversal per warp of 32 rays over the union of their paths, with one
// warp-shared stack.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_rows.py
// ::_kernel (traversal="pallas_rows"), in its two modes: closest hit (t, u, v,
// mesh-local prim, instance) and occlusion. It computes kernel B1's function
// (traverse_f32.cu) on B1's tables and schedules it as the TPU row kernel
// does: a group of co-sorted rays walks the tree once, and a node or leaf is
// visited when any ray of the group needs it. On the TPU the group is a
// 128-lane row of the (8, 128) vreg; here it is a warp of 32 rays. A row
// needs a tile-wide barrier on every step; a warp decides with one
// __any_sync, __all_sync or shuffle, so a block of 128 threads holds 4
// independent warps and the loop has no __syncthreads.
//
// Semantics copied from pallas_rows.py:
//  * Warp-uniform state: the current node, the stack pointer, the instance
//    and a stack of STACK_CAP entries in shared memory (64 ints per warp,
//    written by lane 0, read by all after __syncwarp) are the same in every
//    lane. All 32 lanes stay in the loop until the warp is done, so every
//    vote and shuffle sees a full mask. A lane past n_rays takes tmax = 0; a
//    lane with tmax <= 0 passes no slab test and never votes.
//  * Node step (:166-244): every lane loads the same node (four broadcast
//    float4 loads) and slab-tests both children with its own clip: t_best in
//    closest mode; in occlusion mode 0 once the lane is occluded, else tmax
//    (:179-182). A child is taken if any lane hits it and its code is not
//    ABSENT. When both are taken, the one with the smaller minimum entry over
//    the lanes that hit it goes first (swap = min_tn1 < min_tn0, fminf over
//    __shfl_xor_sync: a min is exact in any order) and the other is pushed;
//    when neither is, the warp pops, and finishes on an empty stack.
//  * Leaf (:246-352): every lane tests slots 0..c-1 of the group in B1's slot
//    order with B1's Möller-Trumbore (mt_f32) and accept rules: a strict
//    t < t_best in closest mode, t < tmax in occlusion mode. After each leaf
//    the occlusion warp finishes when __all_sync(occluded || tmax <= 0).
//  * Instances: on an instance code the whole warp pushes the RESTORE
//    sentinel and enters together, every lane transforming its own world ray
//    in B1's operation order; RESTORE puts every lane back on its world ray.
//  * Bounds: the walk stops at the TPU row kernel's step bound
//    max_steps = 16*N*(I+1)+256 (:388) per warp. The stack needs at most
//    stack_need entries (bvh/dense.py), the bound of one ray: the warp walks
//    the union tree depth-first and, like one ray, pushes at most one far
//    child per internal node on its current root-to-node path, plus one
//    RESTORE sentinel per instance entered on it. The wrapper refuses a table
//    whose stack_need exceeds STACK_CAP. A warp stopped by either bound adds
//    its live rays (in range, tmax > 0, not yet occluded) to the truncation
//    counter: nothing is dropped silently.
//
// What follows for the results. A lane tests every triangle its own ray would
// reach (a node its ray enters before its clip is entered by the warp) and
// possibly more; each test is B1's arithmetic on B1's inputs (the same
// object-space ray, the same mt_f32). So its closest t is the minimum over
// candidates that contain B1's, computed with the same operations: where
// B3 and B1 both find a hit, t is bit-equal to B1's. The prim and instance
// differ only on a t-tie, where visit order decides which equal candidate
// is kept. Occlusion is exactly equal. Built without fast math and with
// --fmad=false.
//
// What bounds it on an H100: dependent loads and the union work, not FLOPs
// or HBM bytes (the bench table sits in the 50 MB L2). A warp waits on each
// node or leaf it chooses, and pays for the union of its rays' paths. What
// the design does about it: control flow is uniform (no divergence: the
// warp runs one path), node and triangle loads are warp-uniform addresses
// (one broadcast transaction each instead of 32 scattered ones), and the
// callers co-sort rays (octant + Morton) so a warp's rays share most of
// their path. Whether that beats B1's one-stack-per-ray schedule is what
// the two kernels' times on the same rays say (PERF.md).
//
// Not carried over from the TPU kernel, because a warp has no use for them:
// the 8 rows per 1024-ray program with SMEM per-row stacks and cursors (a
// warp is the row here); the (8*16, 128) staging block and the MXU
// permutation matmul (:249-273) that moves each row's leaf group into vreg
// layout (a lane reads the group's rows directly); the pltpu.roll cyclic
// sweep over max_c columns (a lane tests slots 0..c-1, the same triangles:
// the c-block is tiled across the 128 columns with period c); the
// groups_hbm DMA path for more than 1280 groups (the tables sit in L2); the
// SMEM/VMEM placement.

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int WARPS = BLOCK / WARP;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Pushes code onto the warp's shared stack: lane 0 writes, after every lane
// has read the slot's previous entry (the __syncwarp).
__device__ __forceinline__ void push(int* stack, int& sp, int lane, int code) {
  __syncwarp();
  if (lane == 0) stack[sp] = code;
  ++sp;
}

// COUNT: also counts the warp's node steps, triangle tests and leaf visits,
// times 32 lanes: the work of the union walk (the counting instantiation,
// run once per ray set and reported beside the bound, which counts the work
// of B1's per-ray walk, the function's; the main path never).
template <bool CLOSEST, bool COUNT>
__global__ void __launch_bounds__(BLOCK)
traverse_rows_kernel(const float* __restrict__ nodes, const float* __restrict__ groups,
                     const float* __restrict__ inst16, int two_level,
                     const float* __restrict__ orig, const float* __restrict__ dir,
                     const float* __restrict__ tmax_in, int n_rays, int max_steps,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ prim_out,
                     int* __restrict__ inst_out, uint8_t* __restrict__ occ_out,
                     int* __restrict__ truncated,
                     unsigned long long* __restrict__ counters) {
  __shared__ int warp_stacks[WARPS][STACK_CAP];
  int* stack = warp_stacks[threadIdx.x / WARP];
  const int lane = threadIdx.x % WARP;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  // a lane past n_rays rides along with tmax = 0: it never votes or accepts
  const Ray world = in_range ? make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                                        dir[3 * i], dir[3 * i + 1], dir[3 * i + 2])
                             : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  const float tmax = in_range ? tmax_in[i] : 0.0f;

  Ray r = world;  // world space, or the entered instance's object space
  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, best_inst = -1;
  bool occluded = false;
  // warp-uniform walk state
  int sp = 0, cur = 0, inst = -1, steps = 0;
  bool cut = false;
  unsigned long long n_node = 0, n_tri = 0, n_leaf = 0;

  while (true) {
    if (steps >= max_steps) {
      cut = true;
      break;
    }
    ++steps;
    int nxt = DONE;
    if (cur >= 0) {
      if (COUNT) ++n_node;
      const float4* np = reinterpret_cast<const float4*>(nodes + (size_t)cur * NODE_F);
      const float4 a = __ldg(np), b = __ldg(np + 1), c = __ldg(np + 2), e = __ldg(np + 3);
      const float t_clip = CLOSEST ? t_best : (occluded ? 0.0f : tmax);
      const int c0 = (int)e.x, c1 = (int)e.y;
      float tn0, tn1;
      const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, t_clip, &tn0);
      const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, t_clip, &tn1);
      const bool take0 = __any_sync(FULL, h0) && c0 != ABSENT;
      const bool take1 = __any_sync(FULL, h1) && c1 != ABSENT;
      if (take0 && take1) {
        const bool swap = warp_min(h1 ? tn1 : BIG) < warp_min(h0 ? tn0 : BIG);
        if (sp >= STACK_CAP) {
          cut = true;
          break;
        }
        push(stack, sp, lane, swap ? c0 : c1);
        nxt = swap ? c1 : c0;
      } else if (take0) {
        nxt = c0;
      } else if (take1) {
        nxt = c1;
      }
    } else {
      const int v = -(cur + 1);
      if (two_level && (v & 1)) {
        const int iid = v >> 1;
        if (iid == RESTORE_ID) {
          r = world;
          inst = -1;
        } else {
          if (sp >= STACK_CAP) {
            cut = true;
            break;
          }
          push(stack, sp, lane, RESTORE_CODE);
          const float* m = inst16 + (size_t)iid * INST_F;
          r = enter_instance(m, world);
          inst = iid;
          nxt = (int)m[12];
        }
      } else {
        const int gv = v >> 1;
        const int count = 1 << (gv & 7);
        const float* g = groups + (size_t)(gv >> 3) * GROUP_ROWS * LEAF_W;
        if (COUNT) {
          ++n_leaf;
          n_tri += count;
        }
        for (int j = 0; j < count; ++j) {
          float tt, uu, vv;
          const bool ok = mt_f32(r, tri_rows(g + j), tt, uu, vv);
          if (CLOSEST) {
            if (ok && tt < t_best) {
              t_best = tt;
              best_u = uu;
              best_v = vv;
              best_prim = (int)g[j + 9 * LEAF_W];
              best_inst = inst;
            }
          } else if (ok && tt < tmax) {
            occluded = true;
          }
        }
        // the occlusion warp is done when every lane is occluded or idle
        if (!CLOSEST && __all_sync(FULL, occluded || tmax <= 0.0f)) break;
      }
    }
    if (nxt == DONE) {
      if (sp == 0) break;
      __syncwarp();  // lane 0's last push is visible to every lane
      nxt = stack[--sp];
    }
    cur = nxt;
  }

  if (cut) {
    const bool live = in_range && tmax > 0.0f && !(!CLOSEST && occluded);
    const unsigned live_lanes = __ballot_sync(FULL, live);
    if (lane == 0 && live_lanes) atomicAdd(truncated, __popc(live_lanes));
  }
  if (COUNT && lane == 0) {
    atomicAdd(counters, n_node * WARP);
    atomicAdd(counters + 1, n_tri * WARP);
    atomicAdd(counters + 2, n_leaf * WARP);
  }
  if (!in_range) return;
  if (CLOSEST) {
    t_out[i] = t_best;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = best_prim;
    inst_out[i] = best_inst;
  } else {
    occ_out[i] = occluded ? 1 : 0;
  }
}

template <bool CLOSEST, bool COUNT>
int launch(const void* nodes, const void* groups, const void* inst16, int two_level,
           const void* orig, const void* dir, const void* tmax, int n_rays, int max_steps,
           void* t_out, void* u_out, void* v_out, void* prim_out, void* inst_out,
           void* occ_out, void* truncated, void* counters, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_rows_kernel<CLOSEST, COUNT>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(nodes), static_cast<const float*>(groups),
          static_cast<const float*>(inst16), two_level, static_cast<const float*>(orig),
          static_cast<const float*>(dir), static_cast<const float*>(tmax), n_rays,
          max_steps, static_cast<float*>(t_out), static_cast<float*>(u_out),
          static_cast<float*>(v_out), static_cast<int*>(prim_out),
          static_cast<int*>(inst_out), static_cast<uint8_t*>(occ_out),
          static_cast<int*>(truncated), static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pbrt_trace_rows_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (tmax where nothing was hit), u, v,
// mesh-local prim (-1 = miss), instance (-1 = miss or single-level).
int pbrt_trace_closest_rows(const void* nodes, const void* groups, const void* inst16,
                            int two_level, const void* orig, const void* dir,
                            const void* tmax, int n_rays, int max_steps, void* t_out,
                            void* u_out, void* v_out, void* prim_out, void* inst_out,
                            void* truncated, void* stream) {
  return launch<true, false>(nodes, groups, inst16, two_level, orig, dir, tmax, n_rays,
                             max_steps, t_out, u_out, v_out, prim_out, inst_out, nullptr,
                             truncated, nullptr, stream);
}

// Occlusion: occ_out (n,) uint8, 1 where a hit exists with 0 < t < tmax.
int pbrt_trace_any_rows(const void* nodes, const void* groups, const void* inst16,
                        int two_level, const void* orig, const void* dir,
                        const void* tmax, int n_rays, int max_steps, void* occ_out,
                        void* truncated, void* stream) {
  return launch<false, false>(nodes, groups, inst16, two_level, orig, dir, tmax, n_rays,
                              max_steps, nullptr, nullptr, nullptr, nullptr, nullptr,
                              occ_out, truncated, nullptr, stream);
}

// The counting instantiation of either mode (closest != 0: closest hit):
// the same outputs, plus counters[0..2] += node steps, triangle tests and
// leaf visits of this launch, each warp's times 32 lanes (unsigned 64-bit,
// zeroed by the caller).
int pbrt_trace_count_rows(const void* nodes, const void* groups, const void* inst16,
                          int two_level, const void* orig, const void* dir,
                          const void* tmax, int n_rays, int max_steps, int closest,
                          void* t_out, void* u_out, void* v_out, void* prim_out,
                          void* inst_out, void* occ_out, void* truncated, void* counters,
                          void* stream) {
  auto fn = closest ? launch<true, true> : launch<false, true>;
  return fn(nodes, groups, inst16, two_level, orig, dir, tmax, n_rays, max_steps, t_out,
            u_out, v_out, prim_out, inst_out, occ_out, truncated, counters, stream);
}

}  // extern "C"
