// Kernel B4: the wave engine's dense tile x leaf Möller-Trumbore, one block
// per ray tile, one thread per ray.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_mt.py
// ::_make_kernel (via leaf_intersect_pallas), the dense leaf phase of the
// wave engine (traversal="wave", dense="mt"), in its two modes:
//   closest: per ray, for each live slot l < nleaf of the tile's leaf buffer
//     and each triangle k < count of that leaf, in that order, Möller-Trumbore
//     with |det| > 1e-9, u, v >= 0, u + v <= 1, t > 0, taken when
//     t < min(t_best, tmax); prim = the leaf's first slot + k;
//   any: occ |= some live triangle is hit with 0 < t < tmax (the occlusion
//     half of the wave's dense phase, ops/traverse_packet.py::_wave_run).
// Inputs: rays (T, W, 3) f32, tmax (T, W) f32, leaf codes (T, L) i32 (-1
// empty), nleaf (T,) i32, the classic BVH's triangle rows (P, 9) f32 (v0, e1,
// e2). State (t, u, v f32, prim i32 / occ u8, each (T, W)) is updated in place.
//
// What bounds it on an H100: per ray it does L*K triangle tests of ~54 f32
// operations on registers against data every ray of the tile shares, so it
// is operation-bound in principle; at the frame's shapes (960 tiles of 128
// rays, <= 64 triangles a tile, a few microseconds of work) one launch is
// dominated by its own launch latency and the host that drives a wave.
//
// What this simple design does about it: the block stages its tile's live
// triangles once in shared memory (a (9, 128) block, column l*K + k; rounds of
// 128/K leaves when more are buffered), so each triangle row is read from
// device memory once per tile instead of once per ray, and every thread then
// reads the same shared word (a broadcast): sweep_leaves of wave_common.cuh,
// which the fused level kernel wave_level.cu runs too (the wave engine's
// dense="mt" path; this kernel stays the counterpart of
// leaf_intersect_pallas, ops/leaf_mt.py). A tile with no buffered leaf
// exits at once. The arithmetic is mt_f32 of traverse_common.cuh, whose
// expressions are the reference's mt_dense one for one (the reciprocal of a
// rejected det is 1 instead of 0, which never reaches an accept), compiled
// with --fmad=false: the result equals the plain PyTorch version
// (ops/leaf_mt.py) bit for bit.
//
// Not carried over from the TPU kernel, because a GPU block has no use for
// them: the scalar-prefetched leaf table that lets the DMA address be known
// before the body runs (a block reads its own codes), the per-leaf HBM->VMEM
// DMA and its semaphore (shared-memory staging), and the rays-on-lanes
// (3, W) layout (a thread holds its own ray).

#include "wave_common.cuh"

namespace {

using namespace pbrt;

constexpr int MAX_WIDTH = 1024;

template <bool CLOSEST>
__global__ void __launch_bounds__(MAX_WIDTH)
leaf_mt_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tmax_in, float* __restrict__ t_io,
               float* __restrict__ u_io, float* __restrict__ v_io,
               int* __restrict__ prim_io, uint8_t* __restrict__ occ_io,
               const int* __restrict__ leafbuf, const int* __restrict__ nleaf,
               const float* __restrict__ tris, int n_prims, int width, int leaf_cap,
               int leaf_size) {
  __shared__ float tri[9 * LEAF_W];   // component c of column j at [c * LEAF_W + j]
  const int tile = blockIdx.x;
  const int n = min(nleaf[tile], leaf_cap);
  if (n <= 0) return;   // the same for every thread of the block
  const size_t i = (size_t)tile * width + threadIdx.x;
  // the slab reciprocals are unused here
  const Ray r{orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
              dir[3 * i], dir[3 * i + 1], dir[3 * i + 2], 0.0f, 0.0f, 0.0f};
  const float tm = tmax_in[i];
  float tb = 0.0f, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  if (CLOSEST) {
    tb = t_io[i]; ub = u_io[i]; vb = v_io[i]; pb = prim_io[i];
  } else {
    occ = occ_io[i] != 0;
  }
  const int per_round = LEAF_W / leaf_size;   // leaf_size: 1..LEAF_W
  sweep_leaves<CLOSEST>(r, tm, tb, ub, vb, pb, occ, leafbuf + (size_t)tile * leaf_cap, n,
                        tris, n_prims, leaf_size, per_round,
                        (n + per_round - 1) / per_round, tri, LEAF_W, threadIdx.x,
                        blockDim.x, 0, 1, true, NoMerge{});
  if (CLOSEST) {
    t_io[i] = tb; u_io[i] = ub; v_io[i] = vb; prim_io[i] = pb;
  } else {
    occ_io[i] = occ ? 1 : 0;
  }
}

bool bad_shape(int n_tiles, int width, int leaf_cap, int leaf_size) {
  return width < 1 || width > MAX_WIDTH || leaf_cap < 1 || leaf_size < 1 ||
         leaf_size > LEAF_W || n_tiles < 0;
}

}  // namespace

extern "C" {

const char* pbrt_leaf_mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest entry: t, u, v (T, W) f32 and prim (T, W) i32 updated in place.
int pbrt_leaf_mt_closest(const void* orig, const void* dir, const void* tmax, void* t,
                         void* u, void* v, void* prim, const void* leafbuf,
                         const void* nleaf, const void* tris, int n_prims, int n_tiles,
                         int width, int leaf_cap, int leaf_size, void* stream) {
  if (bad_shape(n_tiles, width, leaf_cap, leaf_size)) return cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  leaf_mt_kernel<true><<<n_tiles, width, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const float*>(tmax), static_cast<float*>(t), static_cast<float*>(u),
      static_cast<float*>(v), static_cast<int*>(prim), nullptr,
      static_cast<const int*>(leafbuf), static_cast<const int*>(nleaf),
      static_cast<const float*>(tris), n_prims, width, leaf_cap, leaf_size);
  return static_cast<int>(cudaGetLastError());
}

// Any entry: occ (T, W) uint8 (bool) updated in place.
int pbrt_leaf_mt_any(const void* orig, const void* dir, const void* tmax, void* occ,
                     const void* leafbuf, const void* nleaf, const void* tris, int n_prims,
                     int n_tiles, int width, int leaf_cap, int leaf_size, void* stream) {
  if (bad_shape(n_tiles, width, leaf_cap, leaf_size)) return cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  leaf_mt_kernel<false><<<n_tiles, width, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const float*>(tmax), nullptr, nullptr, nullptr, nullptr,
      static_cast<uint8_t*>(occ), static_cast<const int*>(leafbuf),
      static_cast<const int*>(nleaf), static_cast<const float*>(tris), n_prims, width,
      leaf_cap, leaf_size);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
