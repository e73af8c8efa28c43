// Kernel B1: exact f32 BVH traversal of a DenseBVH (one- or two-level), one
// thread per ray.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_trace.py
// ::_traverse_kernel (the "f32 engine", leaf_precision="f32"), in its two
// modes: closest hit (t, u, v, mesh-local prim, instance) and occlusion.
// Tables: nodes16 (N*16 f32) and inst16 (I*16 f32, [0:12] object-from-world
// 3x4, [12] BLAS root), the JAX package's own, byte for byte (bvh/dense.py
// layouts); and leaf_rec, a table derived from the JAX package's groups (G*16
// x 128 f32, rows 0..8 = v0/e1/e2, row 9 = prim id) once per DenseBVH: one
// 48-byte record per (group, slot j < C), [v0.xyz, prim], [e1.xyz, 0],
// [e2.xyz, 0], C records per group (C = the largest leaf period).
//
// What bounds it on an H100: dependent loads and warp divergence, not FLOPs.
// Every step of a ray waits on the node or leaf it just chose, and the 32 rays
// of a warp walk different paths. The whole bench table (2.96 MB of groups +
// 24 KB of nodes) sits in the 50 MB L2, so device memory bandwidth is not the
// limit either.
//
// What the design does about it: it keeps a ray's whole state in registers
// plus a 64-entry stack in local memory (L1-resident) and loads a node as four
// 16-byte vector loads through the read-only path. The walk (traverse_common.cuh)
// batches the warp's leaf visits: lanes step through nodes until each holds a
// leaf or is done, then sweep their leaves together, instead of alternating
// node lanes and leaf lanes every iteration. A leaf visit tests only the c
// distinct triangles of a leaf (records 0..c-1 of its group) instead of the
// TPU's 128-lane cyclic sweep, each with three 16-byte loads of its record
// instead of nine 4-byte loads from rows 512 bytes apart; the visit first
// asks L1 for all of the leaf's records, so that a lane walking alone (the
// bf16 engine's retest of a few uncertain lanes) waits for one memory
// latency a leaf rather than one a record. The callers
// co-sort rays by octant + Morton code (ops/trace.py) so that neighbouring
// threads take similar paths. The warp-shared-stack schedule of the same
// function is kernel B3 (traverse_rows.cu).
//
// Not carried over from the TPU kernel, because a GPU thread has no use for
// them: the 1024-ray tile with one shared SMEM stack and tile-wide any/min
// decisions, the pltpu.roll cyclic lane sweep, the HBM leaf-queue DMA
// ping-pong, and the SMEM/VMEM placement limits.
//
// Semantics copied exactly from the TPU kernel: the node and TLAS phase of
// traverse_common.cuh (shared with the bf16 kernel), and Möller-Trumbore
// (mt_f32, shared with B3 and B4) with |det| > 1e-9, u, v >= 0, u + v <= 1,
// t > 0, a strict t < t_best in closest mode and t < tmax in occlusion mode.
// Built without fast math and with --fmad=false so that it matches the plain
// PyTorch version (ops/trace.py) to the last bit, except on exact t-ties.
// Both modes descend into the nearer child first.

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

template <bool CLOSEST, bool COUNT>
__global__ void __launch_bounds__(BLOCK)
traverse_kernel(const float* __restrict__ nodes, const float4* __restrict__ leaf_rec,
                int rec_stride, const float* __restrict__ inst16, int two_level,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax_in, int n_rays, int max_steps,
                float* __restrict__ t_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ prim_out,
                int* __restrict__ inst_out, uint8_t* __restrict__ occ_out,
                int* __restrict__ truncated, unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past n_rays rides along with tmax = 0 (the walk votes per warp)
  const bool in_range = i < n_rays;
  const Ray world = in_range ? make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                                        dir[3 * i], dir[3 * i + 1], dir[3 * i + 2])
                             : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  const float tmax = in_range ? tmax_in[i] : 0.0f;
  LeafF32<CLOSEST, COUNT> leaf{leaf_rec, rec_stride, tmax, tmax, 0.0f, 0.0f,
                               -1, -1, false, 0, 0, 0};
  if (walk<true>(nodes, inst16, two_level, world, tmax, max_steps, leaf))
    atomicAdd(truncated, 1);
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
  if (COUNT) {
    atomicAdd(counters, (unsigned long long)leaf.n_node);
    atomicAdd(counters + 1, (unsigned long long)leaf.n_tri);
    atomicAdd(counters + 2, (unsigned long long)leaf.n_leaf);
  }
}

template <bool CLOSEST, bool COUNT>
int launch(const void* nodes, const void* leaf_rec, int rec_stride, const void* inst16,
           int two_level, const void* orig, const void* dir, const void* tmax, int n_rays,
           int max_steps, void* t_out, void* u_out, void* v_out, void* prim_out,
           void* inst_out, void* occ_out, void* truncated, void* counters, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_kernel<CLOSEST, COUNT>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const float4*>(leaf_rec), rec_stride,
      static_cast<const float*>(inst16), two_level, static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(tmax), n_rays, max_steps,
      static_cast<float*>(t_out), static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(prim_out), static_cast<int*>(inst_out),
      static_cast<uint8_t*>(occ_out), static_cast<int*>(truncated),
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pbrt_trace_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (tmax where nothing was hit), u, v,
// mesh-local prim (-1 = miss), instance (-1 = miss or single-level).
// leaf_rec: (G*C, 12) f32, 16-byte aligned; rec_stride = C.
int pbrt_trace_closest_f32(const void* nodes, const void* leaf_rec, int rec_stride,
                           const void* inst16, int two_level, const void* orig,
                           const void* dir, const void* tmax, int n_rays, int max_steps,
                           void* t_out, void* u_out, void* v_out, void* prim_out,
                           void* inst_out, void* truncated, void* stream) {
  return launch<true, false>(nodes, leaf_rec, rec_stride, inst16, two_level, orig, dir,
                             tmax, n_rays, max_steps, t_out, u_out, v_out, prim_out,
                             inst_out, nullptr, truncated, nullptr, stream);
}

// Occlusion: occ_out (n,) uint8, 1 where a hit exists with 0 < t < tmax.
int pbrt_trace_any_f32(const void* nodes, const void* leaf_rec, int rec_stride,
                       const void* inst16, int two_level, const void* orig, const void* dir,
                       const void* tmax, int n_rays, int max_steps, void* occ_out,
                       void* truncated, void* stream) {
  return launch<false, false>(nodes, leaf_rec, rec_stride, inst16, two_level, orig, dir,
                              tmax, n_rays, max_steps, nullptr, nullptr, nullptr, nullptr,
                              nullptr, occ_out, truncated, nullptr, stream);
}

// The counting instantiation of either mode (closest != 0: closest hit):
// the same outputs, plus counters[0..2] += node steps, triangle tests and
// leaf visits of this launch (unsigned 64-bit, zeroed by the caller).
int pbrt_trace_count_f32(const void* nodes, const void* leaf_rec, int rec_stride,
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

}  // extern "C"
