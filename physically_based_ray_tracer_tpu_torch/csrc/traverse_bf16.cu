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
// Tables: nodes16 and inst16 as for B1; groups_bf (G*32 x 128 bf16, row 2*i+b
// = leaf-local component i pre-rolled by (b*c)/2 lanes); glo (G*8 f32, group
// boxes [lo.xyz, 0, hi.xyz, 0]).
//
// The node and TLAS phase is B1's (traverse_common.cuh), ordered by the ray's
// own slab entry in closest mode and in child order in occlusion mode. The
// leaf visit computes what the TPU kernel's leaf_visit computes for one lane:
// the f32 re-origin at the group box entry (tn_g clamped at 0) with the
// per-lane box gate tn_g <= tf_g && tf_g >= 0; then count2 = max(c/2, 1)
// iterations x 2 bands of the bf16 Möller-Trumbore with its arithmetic accept
// masks. Thread i sweeps as lane i mod 128: at iteration k, band b reads
// column (lane - k) mod 128 of the band rows, which is the triangle the TPU
// lane tests after k rolls, so the winner key decodes as the reference's does.
// Closest-mode tie rules as the reference: a band starts at bf16(running
// best); within a band a later k wins an equal candidate below 9e29; the band
// merge takes the larger key on equal t; a visit replaces the running best
// only if strictly smaller. The running best is also the slab clip. Occlusion
// keeps the certain / uncertain maxima of the reference's t-window ramps and
// ends a ray as soon as it is certain (the per-thread form of the tile-wide
// done test).
//
// Arithmetic: every bf16 operation is an f32 operation rounded to bf16 with
// __float2bfloat16_rn, in the reference's operation order, as PyTorch and XLA
// compute bf16 on the CPU; the reciprocal is an IEEE f32 divide, rounded. So
// the kernel matches its plain version (ops/trace_bf16.py) bit for bit, and
// results differ only where the order groups are visited in decides (t-ties
// across groups, and a group the f32 slab clip prunes while its bf16
// candidate rounds below the clip). Native __hadd/__hmul/__hfma round once
// where the CPU frameworks round twice, so they are not used; a faster
// native-bf16 variant is later work. Built without fast math, --fmad=false.
//
// What bounds it on an H100: like B1, dependent loads and warp divergence;
// on top, each candidate costs ~60 f32 operations and ~45 roundings to bf16,
// and a leaf of period c costs c candidates (2 for c = 1).
//
// Not carried over from the TPU kernel, because a GPU thread has no use for
// them: the 1024-ray tile and its tile-wide any/min decisions; _dup2 and the
// packed (16,128) bf16 vreg; pltpu.roll (a thread reads column (lane-k) mod
// 128 instead); the HBM leaf-queue DMA ping-pong; SMEM_NODE_LIMIT and
// VMEM_BF_GROUP_LIMIT (GLO_SMEM_LIMIT survives only as the integrator's
// engine choice, for parity); the PBRT_BF16_* debug hooks; REFINE_WIN > 1 and
// PBRT_BF16_DECODE_TILE (decode options of the wrapper).

#include <cuda_bf16.h>

#include "traverse_common.cuh"

namespace {

using namespace pbrt;

constexpr int BF_ROWS = 32;

// round an f32 value to bf16 (nearest even), kept as f32
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clamp01(float x) { return fmaxf(fminf(x, 1.0f), 0.0f); }

__device__ __forceinline__ float load_bf(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// the reference's bf16 constants (ops/pallas_bf16.py _bf)
struct Consts {
  float eps_det, k1e4, k1e8, k001, apron, inv_apron, k005, k1e30;
  __device__ Consts()
      : eps_det(bf(1e-8f)), k1e4(bf(1e4f)), k1e8(bf(1e8f)), k001(bf(0.01f)),
        apron(bf(0.02f)), inv_apron(bf(50.0f)), k005(bf(0.05f)), k1e30(bf(1e30f)) {}
};

struct MT {
  float tt, m, r_in, min_uv;
};

// 2-band bf16 Möller-Trumbore of one candidate (ops/pallas_bf16.py _bf16_mt):
// local t, the u/v/det accept mask, the apron interiorness ramp, min barycentric.
// ops/trace_bf16.py UNIT_OPS counts this arithmetic and LeafBf16::visit's for
// the bound: an edit here updates it there.
__device__ __forceinline__ MT bf16_mt(float ox, float oy, float oz, float dx, float dy,
                                      float dz, const float* c, const Consts& K) {
  const float v0x = c[0], v0y = c[1], v0z = c[2];
  const float e1x = c[3], e1y = c[4], e1z = c[5];
  const float e2x = c[6], e2y = c[7], e2z = c[8];
  const float px = bf(bf(dy * e2z) - bf(dz * e2y));
  const float py = bf(bf(dz * e2x) - bf(dx * e2z));
  const float pz = bf(bf(dx * e2y) - bf(dy * e2x));
  const float det = bf(bf(bf(e1x * px) + bf(e1y * py)) + bf(e1z * pz));
  const float adet = fabsf(det);
  const float r = bf(1.0f / fmaxf(adet, K.eps_det));
  const float inv = bf(bf(det * r) * r);
  const float tx = bf(ox - v0x), ty = bf(oy - v0y), tz = bf(oz - v0z);
  const float uu = bf(bf(bf(bf(tx * px) + bf(ty * py)) + bf(tz * pz)) * inv);
  const float qx = bf(bf(ty * e1z) - bf(tz * e1y));
  const float qy = bf(bf(tz * e1x) - bf(tx * e1z));
  const float qz = bf(bf(tx * e1y) - bf(ty * e1x));
  const float vv = bf(bf(bf(bf(dx * qx) + bf(dy * qy)) + bf(dz * qz)) * inv);
  const float tt = bf(bf(bf(bf(e2x * qx) + bf(e2y * qy)) + bf(e2z * qz)) * inv);
  MT out;
  out.min_uv = fminf(fminf(uu, vv), bf(bf(1.0f - uu) - vv));
  const float m = clamp01(bf(bf(out.min_uv + K.apron) * K.k1e4));
  const float m_det = clamp01(bf(bf(adet * K.k1e8) - K.k001));
  out.r_in = clamp01(bf(bf(out.min_uv * K.inv_apron) + 1.0f));
  out.m = bf(m * m_det);
  out.tt = tt;
  return out;
}

// COUNT: also counts node steps, band candidates and leaf visits (the
// counting instantiation, run once per ray set for the bound; the main path
// never).
template <bool CLOSEST, bool COUNT>
struct LeafBf16 {
  const uint16_t* __restrict__ groups_bf;
  const float* __restrict__ glo;
  int lane;
  float tmax, tmax16;
  Consts K;
  float t_best;       // closest: f32 value of the bf16 running best (starts at tmax)
  int best_gk, best_inst;
  float cert, unc;    // occlusion: maxima of the certain / uncertain accepts
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
    const float bm = (tn_g <= tf_g && tf_g >= 0.0f) ? 1.0f : 0.0f;
    const float ox = bf(r.ox + tn_g * r.dx - gx);
    const float oy = bf(r.oy + tn_g * r.dy - gy);
    const float oz = bf(r.oz + tn_g * r.dz - gz);
    const float dx = bf(r.dx), dy = bf(r.dy), dz = bf(r.dz);
    const float tn16 = bf(tn_g);
    const uint16_t* base = groups_bf + (size_t)g * BF_ROWS * LEAF_W;

    float t16[2];
    int gk16[2];
    if (CLOSEST) {
      t16[0] = t16[1] = bf(t_best);
      gk16[0] = gk16[1] = -1;
    }
    for (int k = 0; k < count2; ++k) {
      const int col = (lane - k) & (LEAF_W - 1);
#pragma unroll
      for (int band = 0; band < 2; ++band) {
        if (COUNT) ++n_tri;
        float c[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] = load_bf(base + (2 * i + band) * LEAF_W + col);
        const MT mt = bf16_mt(ox, oy, oz, dx, dy, dz, c, K);
        const float m = bf(mt.m * bm);
        const float t_glob = bf(tn16 + mt.tt);
        if (CLOSEST) {
          const float mm = bf(m * clamp01(bf(t_glob * K.k1e4)));
          const float pen = bf(1.0f + bf(K.k005 * bf(1.0f - mt.r_in)));
          const float t_cand = bf(bf(fmaxf(t_glob, 0.0f) * pen) + bf(bf(1.0f - mm) * K.k1e30));
          const float t_new = fminf(t16[band], t_cand);
          if (t_cand <= t_new && t_cand < 9e29f) gk16[band] = (gv * 64 + k) * 2 + band;
          t16[band] = t_new;
        } else {
          const float win = bf(clamp01(bf(t_glob * K.k1e4)) *
                               clamp01(bf(bf(tmax16 - t_glob) * K.k1e4)));
          const float m_cert = clamp01(bf(bf(mt.min_uv - K.apron) * K.k1e4));
          cert = fmaxf(cert, bf(bf(m * m_cert) * win));
          unc = fmaxf(unc, bf(m * win));
          if (cert > 0.5f) return true;  // certain: the ray is done
        }
      }
    }
    if (CLOSEST) {
      // band merge: the smaller t, the larger key on equal t
      const float t8 = fminf(t16[0], t16[1]);
      const int k0 = t16[0] == t8 ? gk16[0] : -1;
      const int k1 = t16[1] == t8 ? gk16[1] : -1;
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
traverse_bf16_kernel(const float* __restrict__ nodes, const uint16_t* __restrict__ groups_bf,
                     const float* __restrict__ glo, const float* __restrict__ inst16,
                     int two_level, const float* __restrict__ orig,
                     const float* __restrict__ dir, const float* __restrict__ tmax_in,
                     int n_rays, int max_steps, float* __restrict__ t_out,
                     int* __restrict__ gk_out, int* __restrict__ inst_out,
                     uint8_t* __restrict__ cert_out, uint8_t* __restrict__ unc_out,
                     int* __restrict__ truncated,
                     unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray world = make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
  const float tmax = tmax_in[i];
  LeafBf16<CLOSEST, COUNT> leaf;
  leaf.groups_bf = groups_bf;
  leaf.glo = glo;
  leaf.lane = i & (LEAF_W - 1);
  leaf.tmax = tmax;
  leaf.tmax16 = bf(tmax);
  leaf.t_best = tmax;
  leaf.best_gk = -1;
  leaf.best_inst = -1;
  leaf.cert = 0.0f;
  leaf.unc = 0.0f;
  leaf.n_node = leaf.n_tri = leaf.n_leaf = 0;
  if (walk<CLOSEST>(nodes, inst16, two_level, world, tmax, max_steps, leaf))
    atomicAdd(truncated, 1);
  if (CLOSEST) {
    t_out[i] = leaf.t_best;
    gk_out[i] = leaf.best_gk;
    inst_out[i] = leaf.best_inst;
  } else {
    cert_out[i] = leaf.cert > 0.5f ? 1 : 0;
    unc_out[i] = leaf.unc > 0.5f ? 1 : 0;
  }
  if (COUNT) {
    atomicAdd(counters, (unsigned long long)leaf.n_node);
    atomicAdd(counters + 1, (unsigned long long)leaf.n_tri);
    atomicAdd(counters + 2, (unsigned long long)leaf.n_leaf);
  }
}

}  // namespace

extern "C" {

int pbrt_trace_bf16_stack_cap() { return STACK_CAP; }

const char* pbrt_trace_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Closest hit. Outputs (n,) each: t (f32 of the bf16 best; tmax where nothing
// was accepted), gk (winner key, -1 = none), inst (-1 = none or single-level).
int pbrt_trace_closest_bf16(const void* nodes, const void* groups_bf, const void* glo,
                            const void* inst16, int two_level, const void* orig,
                            const void* dir, const void* tmax, int n_rays, int max_steps,
                            void* t_out, void* gk_out, void* inst_out, void* truncated,
                            void* stream) {
  if (n_rays <= 0) return 0;
  traverse_bf16_kernel<true, false>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(nodes), static_cast<const uint16_t*>(groups_bf),
          static_cast<const float*>(glo), static_cast<const float*>(inst16), two_level,
          static_cast<const float*>(orig), static_cast<const float*>(dir),
          static_cast<const float*>(tmax), n_rays, max_steps, static_cast<float*>(t_out),
          static_cast<int*>(gk_out), static_cast<int*>(inst_out), nullptr, nullptr,
          static_cast<int*>(truncated), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Occlusion. Outputs (n,) uint8 each: certain, uncertain.
int pbrt_trace_any_bf16(const void* nodes, const void* groups_bf, const void* glo,
                        const void* inst16, int two_level, const void* orig,
                        const void* dir, const void* tmax, int n_rays, int max_steps,
                        void* cert_out, void* unc_out, void* truncated, void* stream) {
  if (n_rays <= 0) return 0;
  traverse_bf16_kernel<false, false>
      <<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(nodes), static_cast<const uint16_t*>(groups_bf),
          static_cast<const float*>(glo), static_cast<const float*>(inst16), two_level,
          static_cast<const float*>(orig), static_cast<const float*>(dir),
          static_cast<const float*>(tmax), n_rays, max_steps, nullptr, nullptr, nullptr,
          static_cast<uint8_t*>(cert_out), static_cast<uint8_t*>(unc_out),
          static_cast<int*>(truncated), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The counting instantiation of either mode (closest != 0: closest hit):
// the same outputs, plus counters[0..2] += node steps, band candidates and
// leaf visits of this launch (unsigned 64-bit, zeroed by the caller).
int pbrt_trace_count_bf16(const void* nodes, const void* groups_bf, const void* glo,
                          const void* inst16, int two_level, const void* orig,
                          const void* dir, const void* tmax, int n_rays, int max_steps,
                          int closest, void* t_out, void* gk_out, void* inst_out,
                          void* cert_out, void* unc_out, void* truncated, void* counters,
                          void* stream) {
  if (n_rays <= 0) return 0;
  auto kernel = closest ? traverse_bf16_kernel<true, true> : traverse_bf16_kernel<false, true>;
  kernel<<<grid_for(n_rays), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const uint16_t*>(groups_bf),
      static_cast<const float*>(glo), static_cast<const float*>(inst16), two_level,
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const float*>(tmax), n_rays, max_steps, static_cast<float*>(t_out),
      static_cast<int*>(gk_out), static_cast<int*>(inst_out),
      static_cast<uint8_t*>(cert_out), static_cast<uint8_t*>(unc_out),
      static_cast<int*>(truncated), static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
