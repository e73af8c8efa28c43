// Kernel B2: the bf16 engine's BVH traversal of a DenseBVH (one- or
// two-level), one thread per ray.
//
// Replaces the TPU kernel physically_based_ray_tracer_tpu/ops/pallas_bf16.py
// ::_traverse_kernel (leaf_precision="bf16", the RenderConfig default), in its
// two modes. Closest: the bf16 best t (apron-penalised, as f32), the winner key
// gk = ((group*8 + log2 c)*64 + k)*2 + band and the instance (-1 = none).
// Occlusion: a certain mask (inside a triangle by more than the apron) and an
// uncertain mask (an accept in the apron zone); the wrapper
// (ops/trace_bf16.py) resolves uncertain lanes with the exact f32 kernel B1.
// Tables: nodes16 and inst16 as for B1; groups_bf2 (G x 128 x 32 bf16), the
// JAX package's groups_bf (G*32 x 128, row 2*i+b = leaf-local component i of
// band b, pre-rolled by (b*c)/2 lanes) with each column's 32 rows made
// contiguous, a permutation of its bytes built once per DenseBVH; glo (G*8 f32,
// group boxes [lo.xyz, 0, hi.xyz, 0]).
//
// The node and TLAS phase is B1's (traverse_common.cuh: the warp steps
// through nodes until each lane holds a leaf or is done, then sweeps the held
// leaves together), ordered by the ray's own slab entry in closest mode and in
// child order in occlusion mode. The leaf visit computes what the TPU
// kernel's leaf_visit computes for one lane: the f32 re-origin at the group
// box entry (tn_g clamped at 0) with the per-lane box gate tn_g <= tf_g &&
// tf_g >= 0; then count2 = max(c/2, 1) iterations of the bf16 Möller-Trumbore
// with its arithmetic accept masks on both bands. Thread i sweeps as lane i
// mod 128: at iteration k, band b reads column (lane - k) mod 128 of the band
// rows, which is the triangle the TPU lane tests after k rolls, so the winner
// key decodes as the reference's does. Closest-mode tie rules as the
// reference: a band starts at bf16(running best); within a band a later k
// wins an equal candidate below 9e29; the band merge takes the larger key on
// equal t; a visit replaces the running best only if strictly smaller. The
// running best is also the slab clip. Occlusion keeps the certain / uncertain
// maxima of the reference's t-window ramps and ends a ray as soon as it is
// certain (the per-thread form of the tile-wide done test).
//
// What bounded the first design (bf16 emulated in f32) on an H100: each band
// candidate ran its ~66 bf16 operations as f32 operations each followed by a
// rounding to bf16 (two instructions), the two bands one after the other, with
// 18 separate 16-bit loads; it ran at under 1% of its bound, several times
// B1's time on the same rays. What this design does about it:
//  * both bands in one packed sweep, as the TPU kernel's _dup2 vreg does: band
//    0 in the low and band 1 in the high half of __nv_bfloat162 values, each
//    bf16 operation one native bf16x2 instruction (__hmul2_rn, __hadd2_rn,
//    __hsub2_rn, __hmin2, __hmax2, __habs2) for both bands;
//  * a candidate pair's 9 components x 2 bands are one 64-byte column record
//    of groups_bf2 (word i = rows 2i and 2i+1: band 0 low, band 1 high), read
//    as three 16-byte loads instead of 18 two-byte loads (loading and packing
//    the two rows of each component from groups_bf itself was measured and
//    not kept: slower where a ray sweeps many candidates, PERF.md);
//  * the leaf visits of a warp run together (the shared walk above), and a
//    visit first asks L1 for all the records it will read, so that a lane
//    sweeping alone waits for one memory latency a leaf, not one a record.
// What stays f32, once per leaf: the group-box gate and the re-origin; and
// once per band: the reciprocal (an f32 divide rounded to bf16), and the
// closest-mode key compares and the band merge (exact in any format).
//
// Arithmetic, bit for bit the plain version's (ops/trace_bf16.py), which, as
// PyTorch and XLA do on the CPU, computes each bf16 operation in f32 and
// rounds the result to bf16. For an add, a subtract or a multiply of two bf16
// operands that is one correctly rounded bf16 operation: the f32 rounding
// keeps 24 bits, at least 2*8 + 2, and rounding twice to p and then p' >= 2p +
// 2 bits equals rounding once to p (Figueroa, "When is double rounding
// innocuous?", 1995); every such operation here has two bf16 operands. A
// fused multiply-add rounds once where the CPU rounds twice, so it is never
// used: the _rn intrinsics are the non-contracting forms (plain __hmul2 /
// __hadd2 may be fused into an FMA), and the build passes --fmad=false. min,
// max and abs of bf16 values are exact. pbrt_bf16x2_check runs the same
// helpers over all 2^32 operand pairs against the f32-then-round emulation
// (chip_smoke.py gates on 0 mismatches). So the kernel matches its plain
// version bit for bit, and results differ only where the order groups are
// visited in decides (t-ties across groups, and a group the f32 slab clip
// prunes while its bf16 candidate rounds below the clip). Built without fast
// math.
//
// What bounds it now: as B1, dependent loads and warp divergence; a leaf of
// period c costs max(c/2, 1) packed passes, each the ~85 bf16 operations
// that ops/trace_bf16.py UNIT_OPS counts for one band.
//
// Not carried over from the TPU kernel, because a GPU thread has no use for
// them: the 1024-ray tile and its tile-wide any/min decisions; the packed
// (16,128) vreg layout (a thread packs its own two bands); pltpu.roll (a
// thread reads column (lane-k) mod 128 instead); the HBM leaf-queue DMA
// ping-pong; SMEM_NODE_LIMIT and VMEM_BF_GROUP_LIMIT (GLO_SMEM_LIMIT survives
// only as the integrator's engine choice, for parity); the PBRT_BF16_* debug
// hooks; REFINE_WIN > 1 and PBRT_BF16_DECODE_TILE (decode options of the
// wrapper).

#include <cuda_bf16.h>
#include <string.h>

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

using bf2 = __nv_bfloat162;

constexpr int BF_ROWS = 32;

// The packed operations of the sweep, band 0 in the low half, band 1 in the
// high half. pbrt_bf16x2_check holds each against the f32-then-round
// emulation over all operand pairs: the sweep uses these and nothing else.
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf2 sub2(bf2 a, bf2 b) { return __hsub2_rn(a, b); }
__device__ __forceinline__ bf2 min2(bf2 a, bf2 b) { return __hmin2(a, b); }
__device__ __forceinline__ bf2 max2(bf2 a, bf2 b) { return __hmax2(a, b); }
__device__ __forceinline__ bf2 abs2(bf2 a) { return __habs2(a); }

__device__ __forceinline__ bf2 clamp01(bf2 x, bf2 one, bf2 zero) {
  return max2(min2(x, one), zero);
}

// both halves: x rounded to bf16 (nearest even)
__device__ __forceinline__ bf2 bcast(float x) { return __float2bfloat162_rn(x); }

__device__ __forceinline__ bf2 as_bf2(uint32_t w) {
  bf2 x;
  memcpy(&x, &w, sizeof(x));
  return x;
}

__device__ __forceinline__ uint32_t bits(bf2 x) {
  uint32_t w;
  memcpy(&w, &x, sizeof(w));
  return w;
}

// the reference's bf16 constants (ops/pallas_bf16.py _bf), in both halves
struct Consts {
  bf2 eps_det, k1e4, k1e8, k001, apron, inv_apron, k005, k1e30, one, zero;
  __device__ Consts()
      : eps_det(bcast(1e-8f)), k1e4(bcast(1e4f)), k1e8(bcast(1e8f)), k001(bcast(0.01f)),
        apron(bcast(0.02f)), inv_apron(bcast(50.0f)), k005(bcast(0.05f)),
        k1e30(bcast(1e30f)), one(bcast(1.0f)), zero(bcast(0.0f)) {}
};

struct MT {
  bf2 tt, m, r_in, min_uv;
};

// 2-band bf16 Möller-Trumbore of one candidate pair (ops/pallas_bf16.py
// _bf16_mt), in the reference's operation order: local t, the u/v/det accept
// mask, the apron interiorness ramp, min barycentric. c: v0, e1, e2 (x, y, z
// each). ops/trace_bf16.py UNIT_OPS counts this arithmetic and
// LeafBf16::visit's for the bound (per band): an edit here updates it there.
__device__ __forceinline__ MT bf16_mt(bf2 ox, bf2 oy, bf2 oz, bf2 dx, bf2 dy, bf2 dz,
                                      const bf2* c, const Consts& K) {
  const bf2 v0x = c[0], v0y = c[1], v0z = c[2];
  const bf2 e1x = c[3], e1y = c[4], e1z = c[5];
  const bf2 e2x = c[6], e2y = c[7], e2z = c[8];
  const bf2 px = sub2(mul2(dy, e2z), mul2(dz, e2y));
  const bf2 py = sub2(mul2(dz, e2x), mul2(dx, e2z));
  const bf2 pz = sub2(mul2(dx, e2y), mul2(dy, e2x));
  const bf2 det = add2(add2(mul2(e1x, px), mul2(e1y, py)), mul2(e1z, pz));
  const bf2 adet = abs2(det);
  const bf2 dm = max2(adet, K.eps_det);
  // the reciprocal: an IEEE f32 divide per band, rounded to bf16
  const bf2 r = __floats2bfloat162_rn(1.0f / __low2float(dm), 1.0f / __high2float(dm));
  const bf2 inv = mul2(mul2(det, r), r);
  const bf2 tx = sub2(ox, v0x), ty = sub2(oy, v0y), tz = sub2(oz, v0z);
  const bf2 uu = mul2(add2(add2(mul2(tx, px), mul2(ty, py)), mul2(tz, pz)), inv);
  const bf2 qx = sub2(mul2(ty, e1z), mul2(tz, e1y));
  const bf2 qy = sub2(mul2(tz, e1x), mul2(tx, e1z));
  const bf2 qz = sub2(mul2(tx, e1y), mul2(ty, e1x));
  const bf2 vv = mul2(add2(add2(mul2(dx, qx), mul2(dy, qy)), mul2(dz, qz)), inv);
  MT out;
  out.tt = mul2(add2(add2(mul2(e2x, qx), mul2(e2y, qy)), mul2(e2z, qz)), inv);
  out.min_uv = min2(min2(uu, vv), sub2(sub2(K.one, uu), vv));
  const bf2 m = clamp01(mul2(add2(out.min_uv, K.apron), K.k1e4), K.one, K.zero);
  const bf2 m_det = clamp01(sub2(mul2(adet, K.k1e8), K.k001), K.one, K.zero);
  out.r_in = clamp01(add2(mul2(out.min_uv, K.inv_apron), K.one), K.one, K.zero);
  out.m = mul2(m, m_det);
  return out;
}

// Asks L1 for the column records of groups_bf2 a visit of count2 iterations
// reads: columns lane, lane - 1, ..., lane - count2 + 1 (mod 128), one or two
// contiguous ranges of 64-byte records.
__device__ __forceinline__ void prefetch_pairs(const uint16_t* __restrict__ table, int g,
                                               int lane, int count2) {
  const uint16_t* base = table + (size_t)g * LEAF_W * BF_ROWS;
  const int lo = lane - count2 + 1;
  if (lo >= 0) {
    prefetch_l1(base + lo * BF_ROWS, count2 * 64);
  } else {
    prefetch_l1(base, (lane + 1) * 64);
    prefetch_l1(base + (LEAF_W + lo) * BF_ROWS, -lo * 64);
  }
}

// The 9 components x 2 bands of the candidate pair in column col of a group:
// word i of the column's record in groups_bf2, read as three 16-byte loads.
__device__ __forceinline__ void load_pair(const uint16_t* __restrict__ table, int g,
                                          int col, bf2* c) {
  const uint4* rec =
      reinterpret_cast<const uint4*>(table + ((size_t)g * LEAF_W + col) * BF_ROWS);
  const uint4 a = __ldg(rec), b = __ldg(rec + 1), e = __ldg(rec + 2);
  c[0] = as_bf2(a.x); c[1] = as_bf2(a.y); c[2] = as_bf2(a.z);
  c[3] = as_bf2(a.w); c[4] = as_bf2(b.x); c[5] = as_bf2(b.y);
  c[6] = as_bf2(b.z); c[7] = as_bf2(b.w); c[8] = as_bf2(e.x);
}

// COUNT: also counts node steps, band candidates and leaf visits (the
// counting instantiation, run once per ray set for the bound; the main path
// never). Candidates are counted per band, as the reference sweeps them: an
// occlusion sweep that band 0 of a pair makes certain ends before band 1.
template <bool CLOSEST, bool COUNT>
struct LeafBf16 {
  const uint16_t* __restrict__ table;  // groups_bf2
  const float* __restrict__ glo;
  int lane;
  float tmax;
  bf2 tmax16;
  Consts K;
  float t_best;       // closest: f32 value of the bf16 running best (starts at tmax)
  int best_gk, best_inst;
  bf2 cert, unc;      // occlusion: per band, maxima of the certain / uncertain accepts
  int n_node, n_tri, n_leaf;

  __device__ float clip() const { return CLOSEST ? t_best : tmax; }

  __device__ void on_node() {
    if (COUNT) ++n_node;
  }

  __device__ bool visit(int gv, int inst, const Ray& r) {
    const int g = gv >> 3;
    const int log2c = gv & 7;
    const int count2 = 1 << max(log2c - 1, 0);
    if (COUNT) ++n_leaf;
    // f32 re-origin at the group box entry, and the lane's own box gate
    const float* b = glo + (size_t)g * 8;
    const float gx = __ldg(b), gy = __ldg(b + 1), gz = __ldg(b + 2);
    const float hx = __ldg(b + 4), hy = __ldg(b + 5), hz = __ldg(b + 6);
    const float tx0 = (gx - r.ox) * r.rdx, tx1 = (hx - r.ox) * r.rdx;
    const float ty0 = (gy - r.oy) * r.rdy, ty1 = (hy - r.oy) * r.rdy;
    const float tz0 = (gz - r.oz) * r.rdz, tz1 = (hz - r.oz) * r.rdz;
    float tn_g = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    tn_g = fmaxf(tn_g, 0.0f);
    const float tf_g = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    const bf2 bm = (tn_g <= tf_g && tf_g >= 0.0f) ? K.one : K.zero;
    const bf2 ox = bcast(r.ox + tn_g * r.dx - gx);
    const bf2 oy = bcast(r.oy + tn_g * r.dy - gy);
    const bf2 oz = bcast(r.oz + tn_g * r.dz - gz);
    const bf2 dx = bcast(r.dx), dy = bcast(r.dy), dz = bcast(r.dz);
    const bf2 tn16 = bcast(tn_g);

    prefetch_pairs(table, g, lane, count2);
    bf2 t16;
    int gk16[2];
    if (CLOSEST) {
      t16 = bcast(t_best);
      gk16[0] = gk16[1] = -1;
    }
    for (int k = 0; k < count2; ++k) {
      bf2 c[9];
      load_pair(table, g, (lane - k) & (LEAF_W - 1), c);
      const MT mt = bf16_mt(ox, oy, oz, dx, dy, dz, c, K);
      const bf2 m = mul2(mt.m, bm);
      const bf2 t_glob = add2(tn16, mt.tt);
      if (CLOSEST) {
        if (COUNT) n_tri += 2;
        const bf2 mm = mul2(m, clamp01(mul2(t_glob, K.k1e4), K.one, K.zero));
        const bf2 pen = add2(K.one, mul2(K.k005, sub2(K.one, mt.r_in)));
        const bf2 t_cand = add2(mul2(max2(t_glob, K.zero), pen),
                                mul2(sub2(K.one, mm), K.k1e30));
        const bf2 t_new = min2(t16, t_cand);
        const float c0 = __low2float(t_cand), c1 = __high2float(t_cand);
        if (c0 <= __low2float(t_new) && c0 < 9e29f) gk16[0] = (gv * 64 + k) * 2;
        if (c1 <= __high2float(t_new) && c1 < 9e29f) gk16[1] = (gv * 64 + k) * 2 + 1;
        t16 = t_new;
      } else {
        const bf2 win = mul2(clamp01(mul2(t_glob, K.k1e4), K.one, K.zero),
                             clamp01(mul2(sub2(tmax16, t_glob), K.k1e4), K.one, K.zero));
        const bf2 m_cert = clamp01(mul2(sub2(mt.min_uv, K.apron), K.k1e4), K.one, K.zero);
        cert = max2(cert, mul2(mul2(m, m_cert), win));
        unc = max2(unc, mul2(m, win));
        // before this pair both maxima were <= 0.5, so band 0 alone decides
        // whether the reference's sweep stopped before band 1
        if (COUNT) n_tri += __low2float(cert) > 0.5f ? 1 : 2;
        // certain: the ray is done (band 1's accept was computed with band
        // 0's; where band 0 is certain, its uncertain max is > 0.5 as well)
        if (__low2float(cert) > 0.5f || __high2float(cert) > 0.5f) return true;
      }
    }
    if (CLOSEST) {
      // band merge: the smaller t, the larger key on equal t
      const float t0 = __low2float(t16), t1 = __high2float(t16);
      const float t8 = fminf(t0, t1);
      const int k0 = t0 == t8 ? gk16[0] : -1;
      const int k1 = t1 == t8 ? gk16[1] : -1;
      const int gk8 = max(k0, k1);
      if (t8 < t_best && gk8 >= 0) {
        t_best = t8;
        best_gk = gk8;
        best_inst = inst;
      }
    }
    return false;
  }
};

template <bool CLOSEST, bool COUNT>
__global__ void __launch_bounds__(BLOCK)
traverse_bf16_kernel(const float* __restrict__ nodes, const uint16_t* __restrict__ table,
                     const float* __restrict__ glo, const float* __restrict__ inst16,
                     int two_level, const float* __restrict__ orig,
                     const float* __restrict__ dir, const float* __restrict__ tmax_in,
                     int n_rays, int max_steps, float* __restrict__ t_out,
                     int* __restrict__ gk_out, int* __restrict__ inst_out,
                     uint8_t* __restrict__ cert_out, uint8_t* __restrict__ unc_out,
                     int* __restrict__ truncated,
                     unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past n_rays rides along with tmax = 0 (the walk votes per warp)
  const bool in_range = i < n_rays;
  const Ray world = in_range ? make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                                        dir[3 * i], dir[3 * i + 1], dir[3 * i + 2])
                             : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  const float tmax = in_range ? tmax_in[i] : 0.0f;
  LeafBf16<CLOSEST, COUNT> leaf;
  leaf.table = table;
  leaf.glo = glo;
  leaf.lane = i & (LEAF_W - 1);
  leaf.tmax = tmax;
  leaf.tmax16 = bcast(tmax);
  leaf.t_best = tmax;
  leaf.best_gk = -1;
  leaf.best_inst = -1;
  leaf.cert = leaf.unc = leaf.K.zero;
  leaf.n_node = leaf.n_tri = leaf.n_leaf = 0;
  if (walk<CLOSEST>(nodes, inst16, two_level, world, tmax, max_steps, leaf))
    atomicAdd(truncated, 1);
  if (!in_range) return;
  if (CLOSEST) {
    t_out[i] = leaf.t_best;
    gk_out[i] = leaf.best_gk;
    inst_out[i] = leaf.best_inst;
  } else {
    cert_out[i] = fmaxf(__low2float(leaf.cert), __high2float(leaf.cert)) > 0.5f ? 1 : 0;
    unc_out[i] = fmaxf(__low2float(leaf.unc), __high2float(leaf.unc)) > 0.5f ? 1 : 0;
  }
  if (COUNT) {
    atomicAdd(counters, (unsigned long long)leaf.n_node);
    atomicAdd(counters + 1, (unsigned long long)leaf.n_tri);
    atomicAdd(counters + 2, (unsigned long long)leaf.n_leaf);
  }
}

template <bool CLOSEST, bool COUNT>
int launch(const void* nodes, const void* table, const void* glo, const void* inst16,
           int two_level, const void* orig, const void* dir, const void* tmax, int n_rays,
           int max_steps, void* t_out, void* gk_out, void* inst_out, void* cert_out,
           void* unc_out, void* truncated, void* counters, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_bf16_kernel<CLOSEST, COUNT>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const uint16_t*>(table),
      static_cast<const float*>(glo), static_cast<const float*>(inst16), two_level,
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const float*>(tmax), n_rays, max_steps, static_cast<float*>(t_out),
      static_cast<int*>(gk_out), static_cast<int*>(inst_out),
      static_cast<uint8_t*>(cert_out), static_cast<uint8_t*>(unc_out),
      static_cast<int*>(truncated), static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// The exhaustive check of the packed operations: thread words w < 2^31 hold
// the operand pairs (a, b) and (a, b + 1), a = w >> 15, b = 2 * (w & 0x7fff),
// in the low and high halves, so every pair of bf16 bit patterns is tested
// once per binary operation (abs: its operand b, every pattern 2^16 times).
// Each result is compared with f32 arithmetic on the same operands rounded
// by __float2bfloat16_rn; all NaNs count as one class.
constexpr int N_CHECK_OPS = 6;  // mul, add, sub, min, max, abs

__device__ __forceinline__ bool same(uint32_t got, float want) {
  const uint32_t w = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(want)));
  const bool nan_got = (got & 0x7fffu) > 0x7f80u, nan_want = (w & 0x7fffu) > 0x7f80u;
  return nan_got || nan_want ? nan_got == nan_want : got == w;
}

__global__ void bf16x2_check_kernel(unsigned long long* __restrict__ mismatches) {
  unsigned long long bad[N_CHECK_OPS] = {};
  const unsigned long long n_words = 1ull << 31;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long w = blockIdx.x * blockDim.x + threadIdx.x; w < n_words;
       w += stride) {
    const uint32_t a = static_cast<uint32_t>(w >> 15);
    const uint32_t b = static_cast<uint32_t>(w & 0x7fffu) * 2u;
    const bf2 A = as_bf2(a | (a << 16)), B = as_bf2(b | ((b + 1u) << 16));
    const bf2 got[N_CHECK_OPS] = {mul2(A, B), add2(A, B), sub2(A, B),
                                  min2(A, B), max2(A, B), abs2(B)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = h ? __high2float(A) : __low2float(A);
      const float y = h ? __high2float(B) : __low2float(B);
      const float want[N_CHECK_OPS] = {x * y, x + y, x - y, fminf(x, y), fmaxf(x, y),
                                       fabsf(y)};
#pragma unroll
      for (int op = 0; op < N_CHECK_OPS; ++op) {
        const uint32_t g = h ? bits(got[op]) >> 16 : bits(got[op]) & 0xffffu;
        bad[op] += same(g, want[op]) ? 0 : 1;
      }
    }
  }
#pragma unroll
  for (int op = 0; op < N_CHECK_OPS; ++op)
    if (bad[op]) atomicAdd(mismatches + op, bad[op]);
}

}  // namespace

extern "C" {

int pbrt_trace_bf16_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (f32 of the bf16 best; tmax where nothing
// was accepted), gk (winner key, -1 = none), inst (-1 = none or single-level).
// table: groups_bf2 (G x 128 x 32 bf16, 16-byte aligned).
int pbrt_trace_closest_bf16(const void* nodes, const void* table, const void* glo,
                            const void* inst16, int two_level, const void* orig,
                            const void* dir, const void* tmax, int n_rays, int max_steps,
                            void* t_out, void* gk_out, void* inst_out, void* truncated,
                            void* stream) {
  return launch<true, false>(nodes, table, glo, inst16, two_level, orig, dir, tmax, n_rays,
                             max_steps, t_out, gk_out, inst_out, nullptr, nullptr,
                             truncated, nullptr, stream);
}

// Occlusion. Outputs (n,) uint8 each: certain, uncertain.
int pbrt_trace_any_bf16(const void* nodes, const void* table, const void* glo,
                        const void* inst16, int two_level, const void* orig,
                        const void* dir, const void* tmax, int n_rays, int max_steps,
                        void* cert_out, void* unc_out, void* truncated, void* stream) {
  return launch<false, false>(nodes, table, glo, inst16, two_level, orig, dir, tmax,
                              n_rays, max_steps, nullptr, nullptr, nullptr, cert_out,
                              unc_out, truncated, nullptr, stream);
}

// The counting instantiation of either mode (closest != 0: closest hit):
// the same outputs, plus counters[0..2] += node steps, band candidates and
// leaf visits of this launch (unsigned 64-bit, zeroed by the caller).
int pbrt_trace_count_bf16(const void* nodes, const void* table, const void* glo,
                          const void* inst16, int two_level, const void* orig,
                          const void* dir, const void* tmax, int n_rays, int max_steps,
                          int closest, void* t_out, void* gk_out, void* inst_out,
                          void* cert_out, void* unc_out, void* truncated, void* counters,
                          void* stream) {
  auto fn = closest ? launch<true, true> : launch<false, true>;
  return fn(nodes, table, glo, inst16, two_level, orig, dir, tmax, n_rays, max_steps,
            t_out, gk_out, inst_out, cert_out, unc_out, truncated, counters, stream);
}

// The exhaustive check of the sweep's packed operations: mismatches[op] (6
// unsigned 64-bit counters, zeroed by the caller) += the results of mul, add,
// sub, min, max and abs that differ from the f32-then-round emulation.
int pbrt_bf16x2_check(void* mismatches, void* stream) {
  bf16x2_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
