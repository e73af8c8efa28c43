// The wave engine's node scan, one thread per ray tile: node_steps node-only
// traversal steps of the classic 2-wide BVH per launch, buffering leaf codes
// for the dense leaf phase (kernel B4, leaf_mt.cu).
//
// Not a TPU kernel: it replaces XLA code, the lax.scan of
// physically_based_ray_tracer_tpu/ops/traverse_packet.py::_wave_node_scan.
// The port runs it as one kernel a wave because a scan of PyTorch operators
// costs ~45 launches per step, minutes per bench frame. The steps are
// scan_steps of wave_common.cuh (JAX's step, operation for operation), which
// the fused level kernel wave_level.cu runs too. The wave engine launches
// this kernel only for dense="woop"; with dense="mt" the scan runs inside
// wave_level.cu.
//
// What bounds it: latency. One thread walks one tile's cursor through
// dependent node loads, and a launch holds only as many threads as tiles
// (960 at level 0 of a bench chunk, 120 below). It keeps the tile's bounds,
// cursor and leaf count in registers and its stack and leaf buffer in device
// memory (L1/L2-resident), and reads nodes through the read-only path.

#include "wave_common.cuh"

namespace {

using namespace pbrt;

__global__ void __launch_bounds__(BLOCK)
wave_scan_kernel(const float* __restrict__ nodes_box, const int* __restrict__ nodes_child,
                 int n_nodes, const float* __restrict__ o_lo_in,
                 const float* __restrict__ o_hi_in, const float* __restrict__ rd_lo_in,
                 const float* __restrict__ rd_hi_in, const float* __restrict__ t_tile_in,
                 int* __restrict__ cur_io, int* __restrict__ sp_io, int* __restrict__ stack,
                 uint8_t* __restrict__ active_io, int* __restrict__ nleaf_out,
                 int* __restrict__ leafbuf_out, int n_tiles, int stack_depth, int leaf_cap,
                 int node_steps, int* __restrict__ truncated) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles) return;
  float bounds[12];   // o_lo, o_hi, rd_lo, rd_hi
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bounds[a] = o_lo_in[3 * tile + a];
    bounds[3 + a] = o_hi_in[3 * tile + a];
    bounds[6 + a] = rd_lo_in[3 * tile + a];
    bounds[9 + a] = rd_hi_in[3 * tile + a];
  }
  int cur = cur_io[tile], sp = sp_io[tile], nleaf = 0;
  bool active = active_io[tile] != 0;
  int* leaves = leafbuf_out + (size_t)tile * leaf_cap;
  for (int l = 0; l < leaf_cap; ++l) leaves[l] = -1;
  scan_steps(GlobalNodes{nodes_box, nodes_child}, n_nodes, bounds, t_tile_in[tile], cur, sp,
             active, stack + (size_t)tile * stack_depth, stack_depth, leaves, nleaf,
             leaf_cap, node_steps, truncated, SerialSlabs{});
  cur_io[tile] = cur;
  sp_io[tile] = sp;
  active_io[tile] = active ? 1 : 0;
  nleaf_out[tile] = nleaf;
}

}  // namespace

extern "C" {

const char* pbrt_wave_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One wave's node scan. cur, sp (T,) i32, stack (T, stack_depth) i32 and
// active (T,) u8 are updated in place; nleaf (T,) i32 and leafbuf
// (T, leaf_cap) i32 (-1 past nleaf) are written.
int pbrt_wave_scan(const void* nodes_box, const void* nodes_child, const void* o_lo,
                   const void* o_hi, const void* rd_lo, const void* rd_hi,
                   const void* t_tile, int n_nodes, void* cur, void* sp, void* stack,
                   void* active, void* nleaf, void* leafbuf, int n_tiles, int stack_depth,
                   int leaf_cap, int node_steps, void* truncated, void* stream) {
  if (n_tiles < 0 || n_nodes < 1 || stack_depth < 1 || leaf_cap < 1 || node_steps < 0)
    return cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  wave_scan_kernel<<<grid_for(n_tiles), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes_box), static_cast<const int*>(nodes_child), n_nodes,
      static_cast<const float*>(o_lo), static_cast<const float*>(o_hi),
      static_cast<const float*>(rd_lo), static_cast<const float*>(rd_hi),
      static_cast<const float*>(t_tile), static_cast<int*>(cur), static_cast<int*>(sp),
      static_cast<int*>(stack), static_cast<uint8_t*>(active), static_cast<int*>(nleaf),
      static_cast<int*>(leafbuf), n_tiles, stack_depth, leaf_cap, node_steps,
      static_cast<int*>(truncated));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
