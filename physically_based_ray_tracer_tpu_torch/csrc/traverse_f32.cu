// Exact f32 BVH traversal of a DenseBVH (one- or two-level), one thread per ray.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_trace.py
// ::_traverse_kernel (the "f32 engine", leaf_precision="f32"), in its two
// modes: closest hit (t, u, v, mesh-local prim, instance) and occlusion.
// The tables are the JAX package's own, byte for byte (bvh/dense.py layouts):
// nodes16 (N*16 f32), groups (G*16 x 128 f32, rows 0..8 = v0/e1/e2, row 9 =
// prim id), inst16 (I*16 f32, [0:12] object-from-world 3x4, [12] BLAS root).
//
// What bounds it on an H100: dependent loads and warp divergence, not FLOPs.
// Every step of a ray waits on the node or leaf it just chose, and the 32 rays
// of a warp walk different paths. The whole bench table (2.96 MB of groups +
// 24 KB of nodes) sits in the 50 MB L2, so device memory bandwidth is not the
// limit either.
//
// What this simple design does about it: it keeps a ray's whole state in
// registers plus a 64-entry stack in local memory (L1-resident), loads a node
// as four 16-byte vector loads through the read-only path, and tests only the
// c distinct triangles of a leaf (slots 0..c-1 of its group) instead of the
// TPU's 128-lane cyclic sweep. The callers co-sort rays by octant + Morton
// code (ops/trace.py) so that neighbouring threads take similar paths. What
// later PRs may do: an AoS leaf repack (one 48-byte record per triangle
// instead of 10 rows 512 bytes apart), a warp-shared stack (the analogue of
// the TPU's pallas_rows kernel), persistent threads that fetch new rays as
// others finish.
//
// Not carried over from the TPU kernel, because a GPU thread has no use for
// them: the 1024-ray tile with one shared SMEM stack and tile-wide any/min
// decisions, the pltpu.roll cyclic lane sweep, the HBM leaf-queue DMA
// ping-pong, and the SMEM/VMEM placement limits.
//
// Semantics copied exactly from the TPU kernel: the sign-preserving 1e-20
// reciprocal, the slab test (tn <= tf && tf > 0 && tn < t_clip && t_clip > 0),
// rejection of ABSENT children by code, near-first descent, the child-code
// decoding, the instance enter (world ray transformed in the same operation
// order, RESTORE sentinel pushed) and restore, Möller-Trumbore with
// |det| > 1e-9, u, v >= 0, u + v <= 1, t > 0, a strict t < t_best in closest
// mode and t < tmax in occlusion mode, and the step bound
// max_steps = 8*N*(I+1)+64. Built without fast math and with --fmad=false so
// that it matches the plain PyTorch version (ops/trace.py) to the last bit,
// except on exact t-ties. A ray that hits the step bound or the stack cap is
// counted in *truncated, never dropped silently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NODE_F = 16;
constexpr int GROUP_ROWS = 16;
constexpr int LEAF_W = 128;
constexpr int INST_F = 16;
constexpr int RESTORE_ID = (1 << 22) - 1;
constexpr int RESTORE_CODE = -(2 * RESTORE_ID + 2);
constexpr int ABSENT = -(1 << 30);
constexpr int DONE = 0x7FFFFFFF;
constexpr int STACK_CAP = 64;
constexpr int BLOCK = 128;

__device__ __forceinline__ float rcp_safe(float d) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}

__device__ __forceinline__ bool slab(float ox, float oy, float oz, float rdx,
                                     float rdy, float rdz, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float t_clip, float* tn_out) {
  const float tx0 = (lx - ox) * rdx;
  const float tx1 = (hx - ox) * rdx;
  const float ty0 = (ly - oy) * rdy;
  const float ty1 = (hy - oy) * rdy;
  const float tz0 = (lz - oz) * rdz;
  const float tz1 = (hz - oz) * rdz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  *tn_out = tn;
  return (tn <= tf) && (tf > 0.0f) && (tn < t_clip) && (t_clip > 0.0f);
}

template <bool CLOSEST>
__global__ void __launch_bounds__(BLOCK)
traverse_kernel(const float* __restrict__ nodes, const float* __restrict__ groups,
                const float* __restrict__ inst16, int two_level,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax_in, int n_rays, int max_steps,
                float* __restrict__ t_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ prim_out,
                int* __restrict__ inst_out, uint8_t* __restrict__ occ_out,
                int* __restrict__ truncated) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  const float wx = orig[3 * i], wy = orig[3 * i + 1], wz = orig[3 * i + 2];
  const float wdx = dir[3 * i], wdy = dir[3 * i + 1], wdz = dir[3 * i + 2];
  const float tmax = tmax_in[i];
  const float wrdx = rcp_safe(wdx), wrdy = rcp_safe(wdy), wrdz = rcp_safe(wdz);

  // current ray: world space, or the entered instance's object space
  float ox = wx, oy = wy, oz = wz, dx = wdx, dy = wdy, dz = wdz;
  float rdx = wrdx, rdy = wrdy, rdz = wrdz;

  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, best_inst = -1;
  bool occluded = false, trunc = false;

  int stack[STACK_CAP];
  int sp = 0, cur = 0, inst = -1, steps = 0;

  // a ray with tmax <= 0 passes no slab test and accepts no triangle
  while (tmax > 0.0f) {
    if (steps >= max_steps) { trunc = true; break; }
    ++steps;
    int nxt = DONE;
    if (cur >= 0) {
      const float4* np = reinterpret_cast<const float4*>(nodes + (size_t)cur * NODE_F);
      const float4 a = __ldg(np), b = __ldg(np + 1), c = __ldg(np + 2), e = __ldg(np + 3);
      // occlusion mode leaves the loop as soon as it is occluded, so its clip
      // is tmax on every step it takes
      const float t_clip = CLOSEST ? t_best : tmax;
      const int c0 = (int)e.x, c1 = (int)e.y;
      float tn0, tn1;
      const bool h0 = slab(ox, oy, oz, rdx, rdy, rdz, a.x, a.y, a.z, a.w, b.x, b.y,
                           t_clip, &tn0) && c0 != ABSENT;
      const bool h1 = slab(ox, oy, oz, rdx, rdy, rdz, b.z, b.w, c.x, c.y, c.z, c.w,
                           t_clip, &tn1) && c1 != ABSENT;
      if (h0 && h1) {
        const bool swap = tn1 < tn0;
        if (sp >= STACK_CAP) { trunc = true; break; }
        stack[sp++] = swap ? c0 : c1;
        nxt = swap ? c1 : c0;
      } else if (h0) {
        nxt = c0;
      } else if (h1) {
        nxt = c1;
      }
    } else {
      const int v = -(cur + 1);
      if (two_level && (v & 1)) {
        const int iid = v >> 1;
        if (iid == RESTORE_ID) {
          ox = wx; oy = wy; oz = wz; dx = wdx; dy = wdy; dz = wdz;
          rdx = wrdx; rdy = wrdy; rdz = wrdz;
          inst = -1;
        } else {
          if (sp >= STACK_CAP) { trunc = true; break; }
          stack[sp++] = RESTORE_CODE;
          const float* m = inst16 + (size_t)iid * INST_F;
          ox = m[0] * wx + m[1] * wy + m[2] * wz + m[3];
          oy = m[4] * wx + m[5] * wy + m[6] * wz + m[7];
          oz = m[8] * wx + m[9] * wy + m[10] * wz + m[11];
          dx = m[0] * wdx + m[1] * wdy + m[2] * wdz;
          dy = m[4] * wdx + m[5] * wdy + m[6] * wdz;
          dz = m[8] * wdx + m[9] * wdy + m[10] * wdz;
          rdx = rcp_safe(dx); rdy = rcp_safe(dy); rdz = rcp_safe(dz);
          inst = iid;
          nxt = (int)m[12];
        }
      } else {
        // triangle leaf: v >> 1 = group * 8 + log2(period c)
        const int gv = v >> 1;
        const int count = 1 << (gv & 7);
        const float* g = groups + (size_t)(gv >> 3) * GROUP_ROWS * LEAF_W;
        for (int j = 0; j < count; ++j) {
          const float* s = g + j;
          const float v0x = s[0 * LEAF_W], v0y = s[1 * LEAF_W], v0z = s[2 * LEAF_W];
          const float e1x = s[3 * LEAF_W], e1y = s[4 * LEAF_W], e1z = s[5 * LEAF_W];
          const float e2x = s[6 * LEAF_W], e2y = s[7 * LEAF_W], e2z = s[8 * LEAF_W];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool det_ok = fabsf(det) > 1e-9f;
          const float inv = 1.0f / (det_ok ? det : 1.0f);
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float uu = (tx * px + ty * py + tz * pz) * inv;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (dx * qx + dy * qy + dz * qz) * inv;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
          const bool ok = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                          tt > 0.0f;
          if (CLOSEST) {
            if (ok && tt < t_best) {
              t_best = tt; best_u = uu; best_v = vv;
              best_prim = (int)s[9 * LEAF_W];
              best_inst = inst;
            }
          } else if (ok && tt < tmax) {
            occluded = true;
            break;
          }
        }
        if (!CLOSEST && occluded) break;
      }
    }
    if (nxt == DONE) {
      if (sp == 0) break;
      nxt = stack[--sp];
    }
    cur = nxt;
  }

  if (trunc) atomicAdd(truncated, 1);
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

inline int grid_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" {

int pbrt_trace_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (tmax where nothing was hit), u, v,
// mesh-local prim (-1 = miss), instance (-1 = miss or single-level).
int pbrt_trace_closest_f32(const void* nodes, const void* groups, const void* inst16,
                           int two_level, const void* orig, const void* dir,
                           const void* tmax, int n_rays, int max_steps, void* t_out,
                           void* u_out, void* v_out, void* prim_out, void* inst_out,
                           void* truncated, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_kernel<true><<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const float*>(groups),
      static_cast<const float*>(inst16), two_level, static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(tmax), n_rays, max_steps,
      static_cast<float*>(t_out), static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(prim_out), static_cast<int*>(inst_out), nullptr,
      static_cast<int*>(truncated));
  return static_cast<int>(cudaGetLastError());
}

// Occlusion: occ_out (n,) uint8, 1 where a hit exists with 0 < t < tmax.
int pbrt_trace_any_f32(const void* nodes, const void* groups, const void* inst16,
                       int two_level, const void* orig, const void* dir,
                       const void* tmax, int n_rays, int max_steps, void* occ_out,
                       void* truncated, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_kernel<false><<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const float*>(groups),
      static_cast<const float*>(inst16), two_level, static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(tmax), n_rays, max_steps,
      nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<uint8_t*>(occ_out),
      static_cast<int*>(truncated));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
