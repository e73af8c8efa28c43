// Kernel B3: exact f32 BVH traversal of a DenseBVH (one- or two-level), one
// traversal per warp of 32 rays while the warp's rays are coherent, then one
// per ray.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_rows.py
// ::_kernel (traversal="pallas_rows"), in its two modes: closest hit (t, u, v,
// mesh-local prim, instance) and occlusion. It computes kernel B1's function
// (traverse_f32.cu) on B1's tables (nodes16, leaf_rec, inst16). The TPU row
// kernel walks the tree once for a group of co-sorted rays and visits a node
// or leaf when any ray of the group needs it; it cut the group from a
// 1024-ray tile to a 128-lane row because the union of a group's paths grows
// with the group. On the card the group is a warp, and the walk is shared
// only while it pays: near the root most of a warp's rays enter the same
// nodes, so one walk serves them all with warp-uniform loads and no
// divergence; deeper down the rays part, and a walk over the union of their
// paths makes every lane run the slab and triangle tests of nodes and leaves
// only a few lanes need. So the warp splits there and each lane walks on
// alone, as B1 does (hybrid packet / single-ray traversal).
//
// Shared phase (semantics of pallas_rows.py):
//  * Warp-uniform state: the current node, the stack pointer, the instance
//    and a stack of STACK_CAP entries in shared memory (64 ints per warp,
//    written by lane 0, read by all after __syncwarp) are the same in every
//    lane. A lane past n_rays takes tmax = 0; a lane with tmax <= 0 passes
//    no slab test and never votes.
//  * Node step (:166-244): every lane loads the same node (four broadcast
//    float4 loads) and slab-tests both children with its own clip: t_best in
//    closest mode; in occlusion mode 0 once the lane is occluded, else tmax
//    (:179-182). A child is taken if any lane hits it and its code is not
//    ABSENT. When both are taken, the one with the smaller minimum entry over
//    the lanes that hit it goes first and the other is pushed; when neither
//    is, the warp pops, and finishes on an empty stack. The minimum is one
//    __reduce_min_sync (redux.sync) of order_key(tn), an integer image of the
//    float that keeps its order, so swap equals fminf's min_tn1 < min_tn0 on
//    every entry the slab gives (chip_smoke.py checks the image on every
//    float32 that is not a NaN).
//  * Leaf (:246-352): every lane tests records 0..c-1 of the leaf's group
//    (B1's records and slot order, the leaf first prefetched into L1) with
//    B1's mt_f32 and accept rules: a strict t < t_best in closest mode, t <
//    tmax in occlusion mode. After each leaf the occlusion warp finishes
//    when __all_sync(occluded || tmax <= 0).
//  * Instances: on an instance code the whole warp pushes the RESTORE
//    sentinel and enters together, every lane transforming its own world ray
//    in B1's operation order; RESTORE puts every lane back on its world ray.
//
// Split: at each node step the warp counts its walking lanes (tmax > 0, not
// yet occluded) whose own ray does not hit exactly the children the warp
// takes: lanes the shared step would make test a subtree their own walk
// skips, or keep waiting on a subtree they do not enter. While fewer than
// SPLIT_LANES lanes are off the warp's step, the shared walk costs only
// those lanes work their own walk would not do (none at SPLIT_LANES = 1).
// When the count reaches SPLIT_LANES at a step the warp takes for some
// lane, the warp leaves the shared walk as a whole (the walk's votes need
// every lane): each lane copies the shared stack into its own, keeps its
// ray, instance, t_best / occluded and the warp's step count, and walks on
// from that node with B1's ordered walk and warp-batched leaf visits
// (traverse_common.cuh walk_from, B1's leaf visitor). A lane whose ray misses
// the node still pops the far children pushed above it; only a lane with
// tmax <= 0, or already occluded in occlusion mode, enters the walk as done.
// The test and SPLIT_LANES were chosen by measurement on the three ray sets
// against the count of lanes that hit a child (split below 4 to 33 of them)
// and never splitting (time_kernels.py --rows-split, PERF.md): one
// constant, with no switch.
//
// Bounds: the walk stops at the TPU row kernel's step bound
// max_steps = 16*N*(I+1)+256 (:388), per warp and then per lane (a lane keeps
// the warp's count). The stack needs at most stack_need entries
// (bvh/dense.py), the bound of one ray: the shared walk goes depth-first and,
// like one ray, pushes at most one far child per internal node on its
// current root-to-node path plus one RESTORE sentinel per instance entered
// on it; a lane that splits copies those entries and then, like one ray,
// pushes at most one per node below. The wrapper refuses a table whose
// stack_need exceeds STACK_CAP. A ray stopped by either bound adds to the
// truncation counter (in the shared phase: the warp's live rays, in range,
// tmax > 0, not yet occluded): nothing is dropped silently.
//
// What follows for the results. A lane tests every triangle its own ray
// would reach (a node its ray enters before its clip is entered by the warp,
// or left on the stack it takes over) and possibly more; each test is B1's
// arithmetic on B1's inputs (the same object-space ray, the same Tri from the
// same record, mt_f32). So its closest t is the minimum over candidates that
// contain B1's, computed with the same operations: where B3 and B1 both find
// a hit, t is bit-equal to B1's. The prim and instance differ only on a
// t-tie, where visit order decides which equal candidate is kept. Occlusion
// is exactly equal. Built without fast math and with --fmad=false.
//
// What bounds it on an H100: dependent loads and the work the schedule
// makes, not FLOPs or HBM bytes (the bench table sits in the 50 MB L2). A
// shared step costs one node for 32 lanes; a union walk over incoherent rays
// costs many times the work their own walks need (PERF.md: 6.7-11.6x on
// bounce and shadow rays before the split). The split bounds that waste, and
// the callers co-sort rays (octant + Morton) so a warp's rays share the top
// of their paths.
//
// Not carried over from the TPU kernel, because a warp has no use for them:
// the 8 rows per 1024-ray program with SMEM per-row stacks and cursors (a
// warp is the row here); the (8*16, 128) staging block and the MXU
// permutation matmul (:249-273) that moves each row's leaf group into vreg
// layout (a lane reads the leaf's records directly); the pltpu.roll cyclic
// sweep over max_c columns (a lane tests records 0..c-1, the same
// triangles: the c-block is tiled across the 128 columns with period c); the
// groups_hbm DMA path for more than 1280 groups (the tables sit in L2); the
// SMEM/VMEM placement.

#include <limits.h>

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int WARPS = BLOCK / WARP;
constexpr float BIG = 1e30f;
// the warp splits at a node step that it takes for some lane and that at
// least this many walking lanes would not take so
constexpr int SPLIT_LANES = 1;

// An integer image of a float that is not a NaN, in the same order: a < b
// exactly when order_key(a) < order_key(b), and -0.0 and +0.0 get one key, as
// fminf and < treat them. Non-negative floats keep their bits; a negative
// float's magnitude bits are flipped, so a larger magnitude gives a smaller
// key.
__device__ __forceinline__ int order_key(float x) {
  int b = __float_as_int(x);
  if (b == INT_MIN) b = 0;  // -0.0
  return b ^ ((b >> 31) & INT_MAX);
}

// Pushes code onto the warp's shared stack: lane 0 writes, after every lane
// has read the slot's previous entry (the __syncwarp).
__device__ __forceinline__ void push(int* stack, int& sp, int lane, int code) {
  __syncwarp();
  if (lane == 0) stack[sp] = code;
  ++sp;
}

// COUNT: also counts each lane's node steps (in the shared phase every lane
// counts the warp's step), triangle tests and leaf visits, and the warps
// that split (the counting instantiation, run once per ray set and reported
// beside the bound, which counts the work of B1's per-ray walk, the
// function's; the main path never).
template <bool CLOSEST, bool COUNT>
__global__ void __launch_bounds__(BLOCK)
traverse_rows_kernel(const float* __restrict__ nodes, const float4* __restrict__ leaf_rec,
                     int rec_stride, const float* __restrict__ inst16, int two_level,
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
  const int key_big = order_key(BIG);

  LeafF32<CLOSEST, COUNT> leaf{leaf_rec, rec_stride, tmax, tmax, 0.0f, 0.0f,
                               -1, -1, false, 0, 0, 0};
  // a lane walks while its ray may still be hit: tmax > 0 and, in occlusion
  // mode, not yet occluded
  const auto walking = [&] { return tmax > 0.0f && !(!CLOSEST && leaf.occluded); };
  // the shared phase keeps cur, sp, inst and steps warp-uniform in w (the
  // stack in shared memory); w.r is the lane's own ray
  Walk w{world, 0, 0, -1, 0, false};
  bool cut = false, split = false;

  while (true) {
    if (w.steps >= max_steps) {
      cut = true;
      break;
    }
    ++w.steps;
    int nxt = DONE;
    if (w.cur >= 0) {
      leaf.on_node();  // every lane counts the warp's step
      const float4* np = reinterpret_cast<const float4*>(nodes + (size_t)w.cur * NODE_F);
      const float4 a = __ldg(np), b = __ldg(np + 1), c = __ldg(np + 2), e = __ldg(np + 3);
      const float t_clip = CLOSEST ? leaf.t_best : (leaf.occluded ? 0.0f : tmax);
      const int c0 = (int)e.x, c1 = (int)e.y;
      float tn0, tn1;
      const bool h0 = slab(w.r, a.x, a.y, a.z, a.w, b.x, b.y, t_clip, &tn0) && c0 != ABSENT;
      const bool h1 = slab(w.r, b.z, b.w, c.x, c.y, c.z, c.w, t_clip, &tn1) && c1 != ABSENT;
      const unsigned take0 = __ballot_sync(FULL, h0), take1 = __ballot_sync(FULL, h1);
      // the split test: walking lanes whose own step here differs from the
      // warp's (time_kernels.py --rows-split builds copies with other tests)
      const unsigned off_step =
          __ballot_sync(FULL, walking() && (h0 != (take0 != 0u) || h1 != (take1 != 0u)));
      if ((take0 | take1) && __popc(off_step) >= SPLIT_LANES) {
        --w.steps;  // each lane's own walk takes this node's step
        split = true;
        break;
      }
      if (take0 && take1) {
        const bool swap = __reduce_min_sync(FULL, h1 ? order_key(tn1) : key_big)
                          < __reduce_min_sync(FULL, h0 ? order_key(tn0) : key_big);
        if (w.sp >= STACK_CAP) {
          cut = true;
          break;
        }
        push(stack, w.sp, lane, swap ? c0 : c1);
        nxt = swap ? c1 : c0;
      } else if (take0) {
        nxt = c0;
      } else if (take1) {
        nxt = c1;
      }
    } else {
      const int v = -(w.cur + 1);
      if (two_level && (v & 1)) {
        const int iid = v >> 1;
        if (iid == RESTORE_ID) {
          w.r = world;
          w.inst = -1;
        } else {
          if (w.sp >= STACK_CAP) {
            cut = true;
            break;
          }
          push(stack, w.sp, lane, RESTORE_CODE);
          const float* m = inst16 + (size_t)iid * INST_F;
          w.r = enter_instance(m, world);
          w.inst = iid;
          nxt = (int)m[12];
        }
      } else {
        // every lane tests every record of the leaf: the warp waits on its
        // slowest lane anyway (B1's visitor here, which returns at a lane's
        // first occluding hit, made ptxas spill)
        const int gv = v >> 1;
        const int count = 1 << (gv & 7);
        const float4* g = leaf_rec + (size_t)(gv >> 3) * rec_stride * 3;
        prefetch_l1(g, count * 48);
        if (COUNT) {
          ++leaf.n_leaf;
          leaf.n_tri += count;
        }
        for (int j = 0; j < count; ++j) {
          float prim, tt, uu, vv;
          const bool ok = mt_f32(w.r, tri_record(g + 3 * j, prim), tt, uu, vv);
          if (CLOSEST) {
            if (ok && tt < leaf.t_best) {
              leaf.t_best = tt;
              leaf.best_u = uu;
              leaf.best_v = vv;
              leaf.best_prim = (int)prim;
              leaf.best_inst = w.inst;
            }
          } else if (ok && tt < tmax) {
            leaf.occluded = true;
          }
        }
        // the occlusion warp is done when every lane is occluded or idle
        if (!CLOSEST && __all_sync(FULL, leaf.occluded || tmax <= 0.0f)) break;
      }
    }
    if (nxt == DONE) {
      if (w.sp == 0) break;
      __syncwarp();  // lane 0's last push is visible to every lane
      nxt = stack[--w.sp];
    }
    w.cur = nxt;
  }

  if (cut) {
    const unsigned live_lanes = __ballot_sync(FULL, walking());
    if (lane == 0 && live_lanes) atomicAdd(truncated, __popc(live_lanes));
  }
  if (split) {
    __syncwarp();  // lane 0's pushes are visible to every lane
    int own[STACK_CAP];
    for (int k = 0; k < w.sp; ++k) own[k] = stack[k];
    w.live = walking();
    if (walk_from<true>(nodes, inst16, two_level, world, max_steps, w, own, leaf))
      atomicAdd(truncated, 1);
  }
  if (COUNT) {
    if (lane == 0 && split) atomicAdd(counters + 3, 1ull);
    atomicAdd(counters, (unsigned long long)leaf.n_node);
    atomicAdd(counters + 1, (unsigned long long)leaf.n_tri);
    atomicAdd(counters + 2, (unsigned long long)leaf.n_leaf);
  }
  if (!in_range) return;
  if (CLOSEST) {
    t_out[i] = leaf.t_best;
    u_out[i] = leaf.best_u;
    v_out[i] = leaf.best_v;
    prim_out[i] = leaf.best_prim;
    inst_out[i] = leaf.best_inst;
  } else {
    occ_out[i] = leaf.occluded ? 1 : 0;
  }
}

template <bool CLOSEST, bool COUNT>
int launch(const void* nodes, const void* leaf_rec, int rec_stride, const void* inst16,
           int two_level, const void* orig, const void* dir, const void* tmax, int n_rays,
           int max_steps, void* t_out, void* u_out, void* v_out, void* prim_out,
           void* inst_out, void* occ_out, void* truncated, void* counters, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_rows_kernel<CLOSEST, COUNT>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(nodes), static_cast<const float4*>(leaf_rec),
          rec_stride, static_cast<const float*>(inst16), two_level,
          static_cast<const float*>(orig), static_cast<const float*>(dir),
          static_cast<const float*>(tmax), n_rays, max_steps, static_cast<float*>(t_out),
          static_cast<float*>(u_out), static_cast<float*>(v_out),
          static_cast<int*>(prim_out), static_cast<int*>(inst_out),
          static_cast<uint8_t*>(occ_out), static_cast<int*>(truncated),
          static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

__global__ void order_key_kernel(const float* __restrict__ x, int* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = order_key(x[i]);
}

}  // namespace

extern "C" {

int pbrt_trace_rows_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (tmax where nothing was hit), u, v,
// mesh-local prim (-1 = miss), instance (-1 = miss or single-level).
// leaf_rec: (G*C, 12) f32, 16-byte aligned; rec_stride = C.
int pbrt_trace_closest_rows(const void* nodes, const void* leaf_rec, int rec_stride,
                            const void* inst16, int two_level, const void* orig,
                            const void* dir, const void* tmax, int n_rays, int max_steps,
                            void* t_out, void* u_out, void* v_out, void* prim_out,
                            void* inst_out, void* truncated, void* stream) {
  return launch<true, false>(nodes, leaf_rec, rec_stride, inst16, two_level, orig, dir,
                             tmax, n_rays, max_steps, t_out, u_out, v_out, prim_out,
                             inst_out, nullptr, truncated, nullptr, stream);
}

// Occlusion: occ_out (n,) uint8, 1 where a hit exists with 0 < t < tmax.
int pbrt_trace_any_rows(const void* nodes, const void* leaf_rec, int rec_stride,
                        const void* inst16, int two_level, const void* orig,
                        const void* dir, const void* tmax, int n_rays, int max_steps,
                        void* occ_out, void* truncated, void* stream) {
  return launch<false, false>(nodes, leaf_rec, rec_stride, inst16, two_level, orig, dir,
                              tmax, n_rays, max_steps, nullptr, nullptr, nullptr, nullptr,
                              nullptr, occ_out, truncated, nullptr, stream);
}

// The counting instantiation of either mode (closest != 0: closest hit):
// the same outputs, plus counters[0..3] += node steps, triangle tests, leaf
// visits and warps that split, of this launch, as traverse_rows_kernel counts
// them (unsigned 64-bit, zeroed by the caller).
int pbrt_trace_count_rows(const void* nodes, const void* leaf_rec, int rec_stride,
                          const void* inst16, int two_level, const void* orig,
                          const void* dir, const void* tmax, int n_rays, int max_steps,
                          int closest, void* t_out, void* u_out, void* v_out,
                          void* prim_out, void* inst_out, void* occ_out, void* truncated,
                          void* counters, void* stream) {
  auto fn = closest ? launch<true, true> : launch<false, true>;
  return fn(nodes, leaf_rec, rec_stride, inst16, two_level, orig, dir, tmax, n_rays,
            max_steps, t_out, u_out, v_out, prim_out, inst_out, occ_out, truncated,
            counters, stream);
}

// out[i] = order_key(x[i]) for n f32 values: the image the shared phase
// takes its nearer-child minimum over, for chip_smoke.py's check of it
// against the float order.
int pbrt_rows_order_keys(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int grid = n / 256 + 1 < 132 * 32 ? n / 256 + 1 : 132 * 32;
  order_key_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
