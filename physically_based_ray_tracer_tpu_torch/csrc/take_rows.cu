// The backward of the row gather take_rows(table, idx) (ops/take_rows.py):
// a deterministic segmented sum of the gathered rows' cotangents,
//   grad_table[p] = sum over b with idx[b] == p of grad[b],
// over the indices sorted stably (sorted keys, permutation), in two passes.
//
// Replaces no TPU kernel: the JAX package's gather (jnp.take) transposes to
// an XLA scatter-add. It takes the place of PyTorch's backward of advanced
// indexing (index_put_ with accumulate, indexing_backward_kernel), which
// walks all duplicates of one row serially in one warp. The main path's
// gathers have very long runs of duplicates (the inverse step's hit gather
// clamps every missed and dead lane to row 0), so that kernel's time was
// the longest run's serial chain, not bytes.
//
// What bounds it on an H100: bytes. It reads each gathered row once (N x C
// floats, in sorted order, so each row read is a random row of the
// cotangent), the keys (4 B) and the permutation (8 B) once, and writes
// each gathered table row once; a few operations per float. For the
// inverse step's hit gather (N = 131,072, C = 51) that is ~29 MB, ~9 us at
// 3.35 TB/s.
//
// What this design does about long runs: the sorted positions are cut into
// fixed tiles of TILE positions; C threads of a block (one per column) walk
// one tile in sorted order with CHUNK rows' loads in flight, so a thread's
// serial chain is at most TILE rows whatever the runs. A run wholly inside
// a tile is written straight to the table. A tile's first and last runs,
// which may cross its edges, go to a (tiles, 2, C) partials buffer; the
// second pass sums each crossing run's partials: the tile where the run
// starts finds the last tile it reaches by a binary search over the tiles'
// first keys, its block's threads split those tiles between them (CHUNK
// loads in flight each), and one thread per column adds their sums in a
// fixed order. No atomics: every sum is taken in an order fixed by the
// inputs, so two calls give the same bits. A run inside one tile is summed
// in ascending gather order, as the plain version (index_add_ on the CPU)
// sums it. Rows never gathered are left as the caller made them (zeros).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;    // sorted positions per tile
constexpr int CHUNK = 16;    // rows (or partials) a thread has in flight together
constexpr int BLOCK = 256;   // threads per block at most: BLOCK / cw tiles of cw columns

// The run structure at a tile's edges.
struct Edges {
  int s, e, k_first, k_last;
  bool single, cross_l, cross_r;
};

__device__ __forceinline__ Edges tile_edges(const int* __restrict__ keys, int n, int tile) {
  Edges t;
  t.s = tile * TILE;
  t.e = min(t.s + TILE, n);
  t.k_first = keys[t.s];
  t.k_last = keys[t.e - 1];
  t.single = t.k_first == t.k_last;
  t.cross_l = t.s > 0 && keys[t.s - 1] == t.k_first;
  t.cross_r = t.e < n && keys[t.e] == t.k_last;
  return t;
}

// A finished run of key k: straight to the table, or to its tile's partial
// slot when it may cross an edge (slot 0 the first run, 1 the last).
__device__ __forceinline__ void flush(const Edges& t, bool first, bool last, int k, float acc,
                                      int col, int c, int tile, float* __restrict__ out,
                                      float* __restrict__ partials) {
  int slot = -1;
  if (first && last) {
    if (t.cross_l || t.cross_r) slot = 0;
  } else if (first) {
    if (t.cross_l) slot = 0;
  } else if (last) {
    if (t.cross_r) slot = 1;
  }
  if (slot < 0) {
    out[(size_t)k * c + col] = acc;
  } else {
    partials[((size_t)tile * 2 + slot) * c + col] = acc;
  }
}

__global__ void __launch_bounds__(BLOCK)
tile_pass(const float* __restrict__ grad, const int* __restrict__ keys,
          const int64_t* __restrict__ perm, float* __restrict__ out,
          float* __restrict__ partials, int n, int c, int n_tiles, int cw) {
  const int groups = blockDim.x / cw;
  const int g = threadIdx.x / cw;
  const int tile = blockIdx.x * groups + g;
  if (g >= groups || tile >= n_tiles) return;
  const Edges t = tile_edges(keys, n, tile);
  for (int col = threadIdx.x % cw; col < c; col += cw) {
    float acc = 0.0f;
    int cur = t.k_first;
    bool first = true;
    for (int j0 = t.s; j0 < t.e; j0 += CHUNK) {
      int kk[CHUNK];
      float v[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = j0 + u;
        if (j < t.e) {
          kk[u] = keys[j];
          v[u] = grad[(size_t)perm[j] * c + col];
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (j0 + u < t.e) {
          if (kk[u] != cur) {
            flush(t, first, false, cur, acc, col, c, tile, out, partials);
            cur = kk[u];
            acc = 0.0f;
            first = false;
          }
          acc += v[u];
        }
      }
    }
    flush(t, first, true, cur, acc, col, c, tile, out, partials);
  }
}

// One block per tile; only the blocks of tiles that own a crossing run go
// past the edge test. Thread (y, col) of the owner's block sums the first-run
// partials of tiles tile+1+y, tile+1+y+ny, ... in that order; then thread
// (0, col) adds the owner's own partial and the ny sums in y order.
__global__ void __launch_bounds__(BLOCK)
carry_pass(const int* __restrict__ keys, const float* __restrict__ partials,
           float* __restrict__ out, int n, int c, int n_tiles, int cw) {
  __shared__ float sums[BLOCK];
  const int tile = blockIdx.x;
  const Edges t = tile_edges(keys, n, tile);
  // this tile owns its last run's sum when that run crosses its right edge
  // and starts inside it (the same for every thread of the block)
  if (!t.cross_r || (t.single && t.cross_l)) return;
  const int k = t.k_last;
  // the last tile whose first key is k: tiles tile+1 .. hi all start with k
  int lo = tile + 1, hi = n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (keys[(size_t)mid * TILE] == k) lo = mid; else hi = mid - 1;
  }
  const int last = lo;
  const int ny = blockDim.x / cw;
  const int y = threadIdx.x / cw;
  const int lane = threadIdx.x % cw;
  for (int c0 = 0; c0 < c; c0 += cw) {
    const int col = c0 + lane;
    float acc = 0.0f;
    if (y < ny && col < c) {
      for (int t0 = tile + 1 + y; t0 <= last; t0 += CHUNK * ny) {
        float v[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const int tt = t0 + u * ny;
          if (tt <= last) v[u] = partials[(size_t)tt * 2 * c + col];
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          if (t0 + u * ny <= last) acc += v[u];
        }
      }
    }
    sums[threadIdx.x] = acc;
    __syncthreads();
    if (y == 0 && col < c) {
      float total = partials[((size_t)tile * 2 + (t.single ? 0 : 1)) * c + col];
      for (int j = 0; j < ny; ++j) total += sums[j * cw + lane];
      out[(size_t)k * c + col] = total;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* pbrt_take_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pbrt_take_rows_tile() { return TILE; }

// grad (n, c) f32, keys (n,) i32 sorted ascending in [0, rows), perm (n,) i64
// (stable sort's permutation), out (rows, c) f32 zeroed by the caller,
// partials (ceil(n / TILE), 2, c) f32 scratch.
int pbrt_take_rows_backward(const void* grad, const void* keys, const void* perm, void* out,
                            void* partials, int n, int c, void* stream) {
  if (n < 0 || c < 1) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int cw = c < BLOCK ? c : BLOCK;
  const int groups = BLOCK / cw;
  const int blocks = (n_tiles + groups - 1) / groups;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_pass<<<blocks, groups * cw, 0, s>>>(
      static_cast<const float*>(grad), static_cast<const int*>(keys),
      static_cast<const int64_t*>(perm), static_cast<float*>(out),
      static_cast<float*>(partials), n, c, n_tiles, cw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_pass<<<n_tiles, groups * cw, 0, s>>>(
      static_cast<const int*>(keys), static_cast<const float*>(partials),
      static_cast<float*>(out), n, c, n_tiles, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
