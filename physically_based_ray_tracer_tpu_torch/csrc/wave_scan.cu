// The wave engine's node scan, one thread per ray tile: node_steps node-only
// traversal steps of the classic 2-wide BVH per launch, buffering leaf codes
// for the dense leaf phase (kernel B4, leaf_mt.cu).
//
// Not a TPU kernel: it replaces XLA code, the lax.scan of
// physically_based_ray_tracer_tpu/ops/traverse_packet.py::_wave_node_scan.
// The port runs it as one kernel a wave because a scan of PyTorch operators
// costs ~45 launches per step, minutes per bench frame. Each step is JAX's
// logic, operation for operation: the leaf append (or, with a full buffer,
// the stall on the leaf), the conservative interval slab of both children
// against the tile's origin box and reciprocal-direction interval, the masking
// of empty leaves, the near/far swap on d1 < d0, the push of the far child,
// and the pop. min and max propagate NaN as jnp.minimum / torch.minimum do
// (an all-NaN ray in a tile poisons its bounds in every version alike).
// A push at sp >= stack_depth is dropped, as in JAX, but counted in
// *truncated, and the pop then reads the clamped top slot.
//
// What bounds it: latency. One thread walks one tile's cursor through
// dependent node loads, and a launch holds only as many threads as tiles
// (960 at level 0 of a bench chunk, 120 below). It keeps the tile's bounds,
// cursor and leaf count in registers and its stack and leaf buffer in device
// memory (L1/L2-resident), and reads nodes through the read-only path.

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

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

// _interval_slab: box = (min xyz, max xyz); returns may_hit, *enter = the
// lower bound of the rays' entry distance
__device__ __forceinline__ bool interval_slab(const float* __restrict__ box,
                                              const float* o_lo, const float* o_hi,
                                              const float* rd_lo, const float* rd_hi,
                                              float t_tile, float* enter) {
  float enter_lb = 0.0f, exit_ub = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float bmin = __ldg(box + a), bmax = __ldg(box + 3 + a);
    float t1_lo, t1_hi, t2_lo, t2_hi;
    iprod(bmin - o_hi[a], bmin - o_lo[a], rd_lo[a], rd_hi[a], t1_lo, t1_hi);
    iprod(bmax - o_hi[a], bmax - o_lo[a], rd_lo[a], rd_hi[a], t2_lo, t2_hi);
    const float lo = nan_min(t1_lo, t2_lo), hi = nan_max(t1_hi, t2_hi);
    enter_lb = a == 0 ? lo : nan_max(enter_lb, lo);
    exit_ub = a == 0 ? hi : nan_min(exit_ub, hi);
  }
  *enter = enter_lb;
  return (enter_lb <= exit_ub) && (exit_ub > 0.0f) && (enter_lb < t_tile);
}

__device__ __forceinline__ bool empty_leaf(int c) {
  int first, count;
  decode_leaf(c, first, count);
  return c < 0 && count == 0;
}

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
  float o_lo[3], o_hi[3], rd_lo[3], rd_hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o_lo[a] = o_lo_in[3 * tile + a];
    o_hi[a] = o_hi_in[3 * tile + a];
    rd_lo[a] = rd_lo_in[3 * tile + a];
    rd_hi[a] = rd_hi_in[3 * tile + a];
  }
  const float t_tile = t_tile_in[tile];
  int cur = cur_io[tile], sp = sp_io[tile], nleaf = 0;
  bool active = active_io[tile] != 0;
  int* stk = stack + (size_t)tile * stack_depth;
  int* leaves = leafbuf_out + (size_t)tile * leaf_cap;
  for (int l = 0; l < leaf_cap; ++l) leaves[l] = -1;

  for (int step = 0; step < node_steps; ++step) {
    const bool is_leaf = cur < 0;
    const bool full = nleaf >= leaf_cap;
    if (is_leaf && active && !full) leaves[nleaf++] = cur;

    const int node = min(max((is_leaf || !active) ? 0 : cur, 0), n_nodes - 1);
    const float* box = nodes_box + (size_t)node * 12;
    const int c0 = __ldg(nodes_child + 2 * node), c1 = __ldg(nodes_child + 2 * node + 1);
    float d0, d1;
    const bool h0 = interval_slab(box, o_lo, o_hi, rd_lo, rd_hi, t_tile, &d0) && !empty_leaf(c0);
    const bool h1 = interval_slab(box + 6, o_lo, o_hi, rd_lo, rd_hi, t_tile, &d1) &&
                    !empty_leaf(c1);
    const bool swap = d1 < d0;
    const int near = swap ? c1 : c0, far = swap ? c0 : c1;
    const bool near_hit = swap ? h1 : h0, far_hit = swap ? h0 : h1;
    const int internal_next = near_hit ? near : (far_hit ? far : DONE);
    if (near_hit && far_hit && active && !is_leaf) {
      if (sp < stack_depth) stk[sp] = far;
      else atomicAdd(truncated, 1);
      ++sp;
    }

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
