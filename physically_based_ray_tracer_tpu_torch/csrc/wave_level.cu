// The wave engine's cascade level in one launch: the loop of
// physically_based_ray_tracer_tpu/ops/traverse_packet.py::_wave_run for
// dense="mt", run on the card with no host sync per wave:
//
//   while (count(active) > min_active  and  waves < max_waves):
//     node scan      (node_steps steps a tile, up to leaf_cap leaves buffered)
//     dense phase    (kernel B4's function over the buffered leaves)
//     tile update    (t_tile; any mode: tiles whose rays are all occluded or
//                     dead retire)
//
// min_active = 0 makes the test any(active). The test runs before the first
// wave, so a level may run no wave. Port-only: it fuses the port's node-scan
// kernel (wave_scan.cu, which replaces XLA's lax.scan) with kernel B4
// (leaf_mt.cu, which replaces pallas_mt.py::_make_kernel) and the torch tile
// update; the JAX reference runs the same loop as one lax.while_loop. Every
// wave equals the plain per-wave loop (ops/wave_level.py::plain_run_level)
// bit for bit, and the level runs as many waves: the scan and the sweep are
// scan_steps and sweep_leaves of wave_common.cuh, which the standalone
// kernels run too, and the reductions propagate NaN as torch.amax does.
//
// What bounds it on an H100: latency. Per wave a tile does node_steps
// dependent node steps, then at most leaf_cap * leaf_size triangle tests per
// ray (~54 f32 operations each); the level's operations
// (its bound, chip_smoke.py) take microseconds a wave at the card's peak,
// while the per-wave loop on the host paid a launch of each kernel, ~8 torch
// launches and a host sync per wave (~165 us of wall time).
//
// The design:
// - One cooperative launch (cudaLaunchCooperativeKernel; grid.sync() is
//   legal), one block of THREADS threads per SM at most (occupancy x SMs, and
//   no more blocks than tiles). A refused launch returns its error.
// - Block b of G holds `held` tiles at once (the least power of two that
//   places every tile, at most THREADS / W), tile slot a of round r being
//   tile b + G * (a + held * r), so the tiles spread over every SM. Each
//   tile has THREADS / (W * held) groups of W threads (W = the tile width, a
//   power of two, 8..THREADS), each holding the tile's rays, one a thread:
//   its parts. A wide level (960 tiles: 8 a block) has one part a tile; a
//   narrow one (120 tiles: one a block) splits each round's triangle
//   columns among 8 parts, so that 32 warps and not 4 sweep a tile (one
//   warp a scheduler cannot hide the latency of a test's dependent
//   operations). Part p tests a contiguous share of the columns in column
//   order; part 0 then takes the first part, in part order, whose best t
//   beats its own (the first minimum in column order, as the sequential
//   take) or ORs the hits (PartMerge). Where every tile has a slot (one
//   round, as on the bench), a ray's o and d (and occ) stay in registers
//   for the whole level, its tmax, t, u, v, prim and the tile's scan state
//   in shared memory: read once at entry, written once at exit. Otherwise
//   the slots loop over their tiles each wave, with the state in device
//   memory.
// - Shared memory: the classic BVH's node rows (nodes_box 48 B + nodes_child
//   8 B), staged once per launch where the table fits beside the per-tile
//   buffers (3,197 nodes = 179,032 B on the bench), else read through the
//   read-only path (both instantiated); per tile slot the tile's stack, leaf
//   buffer, bounds, t_tile, cursor, sp, active flag and leaf count, and the
//   staged triangles of its buffered leaves; per thread tmax, t, u, v, prim
//   and the merge's word. The scan's dependent loads then hit shared memory instead
//   of L2. The triangle rows (bvh.tris, 1.84 MB on the bench) stay resident
//   in L2.
// - One wave: the first min(W, 32) lanes of each tile run its scan together
//   (LaneSlabs: six lanes compute the six axis pieces of a step's two box
//   tests, shuffle them and merge them alike, so a step's dependent chain is
//   one piece long and not six; the first lane writes); __syncthreads; the
//   tile's parts stage and sweep its leaves (sweep_leaves); a group reduction
//   gives t_tile (NaN-propagating max, as torch.amax) and, in any mode,
//   all(occ | tmax <= 0); the block adds its active tiles to a device
//   counter; grid.sync(); every block reads the same count and takes the same
//   exit decision. The counter is two monotonic slots used by wave parity:
//   a slot is added to again only after the next grid.sync, by which time
//   every block has read it, so no second sync a wave is needed to clear it.
//   One more grid.sync at the end lets block 0 zero both slots for the next
//   launch, and add the waves run to the caller's wave counter.
// - Pushes past stack_depth are counted in *truncated, as by wave_scan.cu.

#include <cooperative_groups.h>
#include <limits.h>

#include <algorithm>

#include "wave_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pbrt;

constexpr int THREADS = 1024;
// per-tile slot in shared memory, after its stack (stack_depth words) and
// leaf buffer (leaf_cap words): bounds (o_lo, o_hi, rd_lo, rd_hi), t_tile,
// cur, sp, active, nleaf
constexpr int S_BOUNDS = 0, S_TTILE = 12, S_CUR = 13, S_SP = 14, S_ACT = 15, S_NLEAF = 16;
constexpr int SLOT_SCALARS = 17;
constexpr int NODE_WORDS = 14;   // 12 box floats + 2 child ints

struct Params {
  const float* nodes_box;
  const int* nodes_child;
  const float* orig;
  const float* dir;
  const float* tmax;
  const float* o_lo;
  const float* o_hi;
  const float* rd_lo;
  const float* rd_hi;
  float* t_tile;
  int* cur;
  int* sp;
  int* stack;
  uint8_t* active;
  float* t;
  float* u;
  float* v;
  int* prim;
  uint8_t* occ;
  const float* tris;
  int* truncated;
  unsigned long long* counts;   // two slots, zero between launches
  unsigned long long* waves;    // the mode's wave counter
  int n_nodes, n_prims, n_tiles, width, stack_depth, leaf_cap, leaf_size, node_steps;
  int min_active, max_waves, per_round, stride, leaf_rounds;
};

// Merges the parts of a tile after a round of its sweep (sweep_leaves):
// part 0's threads hold the rays' state (t in a register through the sweep,
// u, v, prim at their own slots of the per-thread arrays); the other parts
// start each round from part 0's t (closest) or from no hit (any), and part
// 0 takes the first part, in part order, whose best t beats its own, or ORs
// the hits.
template <bool CLOSEST>
struct PartMerge {
  float* cand;   // THREADS words: a part's t (closest) or hit flag (any)
  float* u;
  float* v;
  int* prim;
  int tid, tid0, width, part, parts;
  bool ray;
  __device__ __forceinline__ void begin_round(float tb) const {
    if (CLOSEST && parts > 1 && part == 0) cand[tid] = tb;
  }
  __device__ __forceinline__ void start(float& tb, bool& occ) const {
    if (parts > 1 && part != 0) {
      if (CLOSEST) tb = cand[tid0];
      else occ = false;
    }
  }
  __device__ __forceinline__ void end_round(float& tb, bool& occ) const {
    if (parts == 1) return;
    if (CLOSEST) cand[tid] = tb;
    else reinterpret_cast<int*>(cand)[tid] = occ ? 1 : 0;
    __syncthreads();
    if (part != 0 || !ray) return;
    if (CLOSEST) {
      int w = 0;
      for (int q = 1; q < parts; ++q) {
        const float c = cand[tid0 + q * width];
        if (c < tb) {
          tb = c;
          w = q;
        }
      }
      if (w) {
        u[tid] = u[tid + w * width];
        v[tid] = v[tid + w * width];
        prim[tid] = prim[tid + w * width];
      }
    } else {
      for (int q = 1; q < parts; ++q)
        occ = occ || reinterpret_cast<const int*>(cand)[tid0 + q * width] != 0;
    }
  }
};

template <bool CLOSEST, bool SMEM_NODES>
__global__ void __launch_bounds__(THREADS, 1) wave_level_kernel(const Params p) {
  extern __shared__ __align__(16) int smem[];
  // thread 0's exit test: the count it read, each counter slot's last value
  __shared__ unsigned long long s_count, s_seen[2];
  cg::grid_group grid = cg::this_grid();

  const int W = p.width, S = p.stack_depth, L = p.leaf_cap;
  const int groups = THREADS / W;
  const int g = threadIdx.x / W, lane = threadIdx.x - g * W;
  // tiles a block holds at once (a power of two; as many as a round needs)
  // and the parts each tile's columns are split into
  int held = 1;
  while (held < groups && held * gridDim.x < p.n_tiles) held *= 2;
  const int parts = groups / held;
  const int at = g / parts, part = g - at * parts;
  const int tid0 = at * parts * W + lane;   // the thread of part 0 on this ray
  const bool leader = lane == 0 && part == 0;
  // the scan's box tests run on the tile's first min(W, 32) lanes together
  const int seg = min(W, 32);
  const unsigned seg_mask =
      seg == 32 ? FULL_MASK : ((1u << seg) - 1) << ((threadIdx.x & 31) & ~(seg - 1));
  const LaneSlabs slabs{seg_mask, seg, lane};
  const int n_nodes_s = SMEM_NODES ? p.n_nodes : 0;
  float* nbox = reinterpret_cast<float*>(smem);
  int* nchild = smem + 12 * n_nodes_s;
  const int slot_words = S + L + SLOT_SCALARS;
  int* slot = nchild + 2 * n_nodes_s + at * slot_words;
  int* const stk = slot;
  int* const leaves = slot + S;
  int* const sc = slot + S + L;
  float* const scf = reinterpret_cast<float*>(sc);
  float* stage = reinterpret_cast<float*>(nchild + 2 * n_nodes_s + groups * slot_words);
  float* red = stage + groups * 9 * p.stride;   // THREADS / 32 maxima
  int* red_all = reinterpret_cast<int*>(red + THREADS / 32);
  // per thread: t, u, v and prim (closest mode; a ray's own at its part-0
  // thread) and tmax, kept here and not in registers, which the 64-register
  // budget of a 1024-thread block cannot spare through the scan; and the
  // merge's word
  float* const u_all = reinterpret_cast<float*>(red_all + THREADS / 32);
  float* const v_all = u_all + THREADS;
  int* const prim_all = reinterpret_cast<int*>(v_all + THREADS);
  float* const cand = reinterpret_cast<float*>(prim_all + THREADS);
  float& tm = cand[THREADS + threadIdx.x];       // the ray's tmax
  float& t_own = cand[2 * THREADS + threadIdx.x];  // and its t (closest mode)
  float& ub = u_all[threadIdx.x];
  float& vb = v_all[threadIdx.x];
  int& pb = prim_all[threadIdx.x];
  stage += at * 9 * p.stride;

  if (SMEM_NODES) {
    for (int i = threadIdx.x; i < 12 * p.n_nodes; i += THREADS) nbox[i] = p.nodes_box[i];
    for (int i = threadIdx.x; i < 2 * p.n_nodes; i += THREADS) nchild[i] = p.nodes_child[i];
  }
  const GlobalNodes gnodes{p.nodes_box, p.nodes_child};
  const SharedNodes snodes{nbox, nchild};

  const int per_launch = gridDim.x * held;
  const int rounds = (p.n_tiles + per_launch - 1) / per_launch;
  const bool resident = rounds == 1;
  auto tile_of = [&](int r) { return blockIdx.x + gridDim.x * (at + held * r); };

  // a thread's ray and its state
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool oc = false;

  auto load_tile = [&](int tile) {
    const size_t i = (size_t)tile * W + lane;
    ray.ox = p.orig[3 * i]; ray.oy = p.orig[3 * i + 1]; ray.oz = p.orig[3 * i + 2];
    ray.dx = p.dir[3 * i]; ray.dy = p.dir[3 * i + 1]; ray.dz = p.dir[3 * i + 2];
    tm = p.tmax[i];
    if (part != 0) return;
    for (int j = lane; j < S; j += W) stk[j] = p.stack[(size_t)tile * S + j];
    for (int a = lane; a < 3; a += W) {
      scf[S_BOUNDS + a] = p.o_lo[3 * tile + a];
      scf[S_BOUNDS + 3 + a] = p.o_hi[3 * tile + a];
      scf[S_BOUNDS + 6 + a] = p.rd_lo[3 * tile + a];
      scf[S_BOUNDS + 9 + a] = p.rd_hi[3 * tile + a];
    }
    if (leader) {
      scf[S_TTILE] = p.t_tile[tile];
      sc[S_CUR] = p.cur[tile];
      sc[S_SP] = p.sp[tile];
      sc[S_ACT] = p.active[tile];
    }
    if (CLOSEST) {
      t_own = p.t[i]; ub = p.u[i]; vb = p.v[i]; pb = p.prim[i];
    } else {
      oc = p.occ[i] != 0;
    }
  };
  // the state a level changes (bounds and rays are read-only)
  auto store_tile = [&](int tile) {
    if (part != 0) return;
    for (int j = lane; j < S; j += W) p.stack[(size_t)tile * S + j] = stk[j];
    if (leader) {
      p.t_tile[tile] = scf[S_TTILE];
      p.cur[tile] = sc[S_CUR];
      p.sp[tile] = sc[S_SP];
      p.active[tile] = sc[S_ACT] ? 1 : 0;
    }
    const size_t i = (size_t)tile * W + lane;
    if (CLOSEST) {
      p.t[i] = t_own; p.u[i] = ub; p.v[i] = vb; p.prim[i] = pb;
    } else {
      p.occ[i] = oc ? 1 : 0;
    }
  };

  // the level's exit test: every block adds its active tiles to the slot of
  // this check's parity and reads the sum after grid.sync()
  if (threadIdx.x == 0) s_seen[0] = s_seen[1] = 0ull;
  int check = 0;
  auto go_on = [&](int block_active, int waves) {
    if (threadIdx.x == 0) atomicAdd(p.counts + (check & 1), (unsigned long long)block_active);
    grid.sync();
    if (threadIdx.x == 0) {
      const unsigned long long v =
          *reinterpret_cast<volatile unsigned long long*>(p.counts + (check & 1));
      s_count = v - s_seen[check & 1];
      s_seen[check & 1] = v;
    }
    __syncthreads();
    ++check;
    return s_count > (unsigned long long)p.min_active && waves < p.max_waves;
  };

  int block_active = 0;
  for (int r = 0; r < rounds; ++r) {
    const int tile = tile_of(r);
    block_active += __syncthreads_count(leader && tile < p.n_tiles && p.active[tile] != 0);
  }
  const int tile0 = tile_of(0);
  if (resident && tile0 < p.n_tiles) load_tile(tile0);
  // (the staged nodes and the slots are fenced by the __syncthreads of the
  // check and of the first round)
  int waves = 0;
  bool more = go_on(block_active, waves);
  while (more) {
    block_active = 0;
    for (int r = 0; r < rounds; ++r) {
      const int tile = tile_of(r);
      const bool valid = tile < p.n_tiles;
      if (!resident) {
        if (valid) load_tile(tile);
        __syncthreads();
      }
      // 1. the tile's scan, on the first (up to 32) lanes of its part 0
      if (part == 0 && lane < 32 && valid) {
        int cur = sc[S_CUR], sp = sc[S_SP], nleaf = 0;
        bool act = sc[S_ACT] != 0;
        if (SMEM_NODES)
          scan_steps(snodes, p.n_nodes, scf + S_BOUNDS, scf[S_TTILE], cur, sp, act, stk, S,
                     leaves, nleaf, L, p.node_steps, p.truncated, slabs);
        else
          scan_steps(gnodes, p.n_nodes, scf + S_BOUNDS, scf[S_TTILE], cur, sp, act, stk, S,
                     leaves, nleaf, L, p.node_steps, p.truncated, slabs);
        if (leader) {
          sc[S_CUR] = cur;
          sc[S_SP] = sp;
          sc[S_ACT] = act ? 1 : 0;
          sc[S_NLEAF] = nleaf;
        }
      }
      __syncthreads();
      // 2. the dense phase over the leaves it buffered (a tile the scan
      // retired this wave included)
      const PartMerge<CLOSEST> merge{cand, u_all, v_all, prim_all, (int)threadIdx.x, tid0,
                                     W, part, parts, valid};
      float tb = CLOSEST ? t_own : 0.0f;
      sweep_leaves<CLOSEST>(ray, tm, tb, ub, vb, pb, oc, leaves, valid ? sc[S_NLEAF] : 0,
                            p.tris, p.n_prims, p.leaf_size, p.per_round, p.leaf_rounds,
                            stage, p.stride, lane, W, part, parts, valid, merge);
      // 3. the tile update: t_tile = amax(min(t, tmax)) (closest) or
      // amax(where(~occ, tmax, 0)) and all(occ | tmax <= 0) (any)
      if (CLOSEST) t_own = tb;
      float m = CLOSEST ? nan_min(tb, tm) : (oc ? 0.0f : tm);
      int all = CLOSEST ? 1 : (oc || tm <= 0.0f);
      for (int off = min(W, 32) / 2; off > 0; off >>= 1) {
        m = nan_max(m, __shfl_xor_sync(FULL_MASK, m, off));
        all = all & __shfl_xor_sync(FULL_MASK, all, off);
      }
      if (W > 32) {
        if ((threadIdx.x & 31) == 0) {
          red[threadIdx.x / 32] = m;
          red_all[threadIdx.x / 32] = all;
        }
        __syncthreads();
        if (leader) {
          for (int w = 1; w < W / 32; ++w) {
            m = nan_max(m, red[threadIdx.x / 32 + w]);
            all &= red_all[threadIdx.x / 32 + w];
          }
        }
      }
      if (leader && valid) {
        scf[S_TTILE] = m;
        if (!CLOSEST && all) sc[S_ACT] = 0;
      }
      block_active += __syncthreads_count(leader && valid && sc[S_ACT] != 0);
      if (!resident && valid) store_tile(tile);
    }
    ++waves;
    more = go_on(block_active, waves);
  }
  if (resident && tile0 < p.n_tiles) store_tile(tile0);
  grid.sync();   // every block has read both slots
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.counts[0] = 0ull;
    p.counts[1] = 0ull;
    atomicAdd(p.waves, (unsigned long long)waves);
  }
}

template <bool CLOSEST, bool SMEM_NODES>
int launch(const Params& p, int smem, int device, int* grid_out, cudaStream_t stream) {
  auto kern = wave_level_kernel<CLOSEST, SMEM_NODES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(per_sm * sms, p.n_tiles);
  *grid_out = grid;
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid), dim3(THREADS),
                                    argv, smem, stream);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pbrt_wave_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pbrt_wave_level_threads() { return THREADS; }

// One cascade level. State updated in place: t_tile (T,) f32, cur, sp (T,)
// i32, stack (T, stack_depth) i32, active (T,) u8, and t, u, v (T, W) f32 +
// prim (T, W) i32 (closest, occ null) or occ (T, W) u8 (any, t..prim null).
// counts: two u64 slots that are zero (and left zero); waves: the u64 the
// waves run are added to. *smem_nodes_out: 1 if the node table was staged in
// shared memory; *grid_out: the blocks launched. max_waves < 0: unbounded.
int pbrt_wave_level(const void* nodes_box, const void* nodes_child, int n_nodes,
                    const void* orig, const void* dir, const void* tmax, const void* o_lo,
                    const void* o_hi, const void* rd_lo, const void* rd_hi, void* t_tile,
                    void* cur, void* sp, void* stack, void* active, void* t, void* u, void* v,
                    void* prim, void* occ, const void* tris, int n_prims, int n_tiles,
                    int width, int stack_depth, int leaf_cap, int leaf_size, int node_steps,
                    int min_active, int max_waves, void* truncated, void* counts, void* waves,
                    int device, void* smem_nodes_out, void* grid_out, void* stream) {
  if (n_tiles < 0 || n_nodes < 1 || n_prims < 1 || width < 8 || width > THREADS ||
      (width & (width - 1)) != 0 || stack_depth < 1 || leaf_cap < 1 || leaf_size < 1 ||
      leaf_size > LEAF_W || node_steps < 0 || min_active < 0)
    return cudaErrorInvalidValue;
  *static_cast<int*>(smem_nodes_out) = 0;
  *static_cast<int*>(grid_out) = 0;
  if (n_tiles == 0) return 0;
  Params p{};
  p.nodes_box = static_cast<const float*>(nodes_box);
  p.nodes_child = static_cast<const int*>(nodes_child);
  p.orig = static_cast<const float*>(orig);
  p.dir = static_cast<const float*>(dir);
  p.tmax = static_cast<const float*>(tmax);
  p.o_lo = static_cast<const float*>(o_lo);
  p.o_hi = static_cast<const float*>(o_hi);
  p.rd_lo = static_cast<const float*>(rd_lo);
  p.rd_hi = static_cast<const float*>(rd_hi);
  p.t_tile = static_cast<float*>(t_tile);
  p.cur = static_cast<int*>(cur);
  p.sp = static_cast<int*>(sp);
  p.stack = static_cast<int*>(stack);
  p.active = static_cast<uint8_t*>(active);
  p.t = static_cast<float*>(t);
  p.u = static_cast<float*>(u);
  p.v = static_cast<float*>(v);
  p.prim = static_cast<int*>(prim);
  p.occ = static_cast<uint8_t*>(occ);
  p.tris = static_cast<const float*>(tris);
  p.truncated = static_cast<int*>(truncated);
  p.counts = static_cast<unsigned long long*>(counts);
  p.waves = static_cast<unsigned long long*>(waves);
  p.n_nodes = n_nodes;
  p.n_prims = n_prims;
  p.n_tiles = n_tiles;
  p.width = width;
  p.stack_depth = stack_depth;
  p.leaf_cap = leaf_cap;
  p.leaf_size = leaf_size;
  p.node_steps = node_steps;
  p.min_active = min_active;
  p.max_waves = max_waves < 0 ? INT_MAX : max_waves;
  p.per_round = std::min(leaf_cap, LEAF_W / leaf_size);
  p.stride = p.per_round * leaf_size;
  p.leaf_rounds = (leaf_cap + p.per_round - 1) / p.per_round;

  const int groups = THREADS / width;
  const long long rest = 4ll * groups * (stack_depth + leaf_cap + SLOT_SCALARS) +
                         4ll * groups * 9 * p.stride + 8ll * (THREADS / 32) + 24ll * THREADS;
  const long long nodes = 4ll * NODE_WORDS * n_nodes;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  // the block's static shared memory (the exit test's words) comes off the top
  optin -= 64;
  if (rest > optin) return cudaErrorInvalidValue;
  const bool closest = occ == nullptr;
  const bool smem_nodes = rest + nodes <= optin;
  *static_cast<int*>(smem_nodes_out) = smem_nodes ? 1 : 0;
  const int smem = static_cast<int>(smem_nodes ? rest + nodes : rest);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* g = static_cast<int*>(grid_out);
  if (closest)
    return smem_nodes ? launch<true, true>(p, smem, device, g, s)
                      : launch<true, false>(p, smem, device, g, s);
  return smem_nodes ? launch<false, true>(p, smem, device, g, s)
                    : launch<false, false>(p, smem, device, g, s);
}

}  // extern "C"
