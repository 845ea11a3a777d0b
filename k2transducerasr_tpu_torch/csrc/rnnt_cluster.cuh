// What the two transducer searches share (csrc/rnnt_greedy.cu, G, and
// csrc/rnnt_beam.cu, B): each runs one lane on a thread-block cluster of kCL
// blocks on Hopper (sm_90a); the blocks exchange partial results through
// distributed shared memory, and each holds its share of the joiner's
// weights in shared memory where they fit (bulk copies completing on
// mbarriers), streaming the rest through rings of stages.
//
// Weight layouts (decode/rnnt_greedy.py::greedy_operands): W_out in 8-column
// n-tiles (bf16: mma.sync B fragments [Vp/8][Jp/16][32][4]; float32
// [Vp/8][Jp][8]), decoder_proj.w in 8-column chunks [Jp/8][D][8]; rank r owns
// the contiguous units [share_lo(n, r), share_lo(n, r + 1)) of each.
//
// place_weights() decides, from the shared memory left beside a kernel's
// fixed parts, which units stay resident and how the rest stream: every
// unit resident if all fit; else decoder_proj streams, and W_out too unless
// its whole share fits beside decoder_proj's smallest ring, each through a
// ring of `depth` stages of ~kStage bytes filled ahead by bulk copies.  Two
// stages let a stage load while the other is read; where two do not fit
// (wide float32 joiners) one stage is loaded after the last was read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace rnnt {

using bf16 = __nv_bfloat16;

constexpr int kCL = 8;  // blocks per cluster (the portable maximum)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // rows of a joiner tile: the mma's M
constexpr int kStage = 32768;  // a streamed stage's target bytes
constexpr int kG = 2;          // bf16: n-tiles of a logits work item
// mbarriers: two per weight ring, one for the resident load
constexpr int kBarW = 0, kBarD = 2, kBarRes = 4;
constexpr int kBars = 5;

struct Cand {
  float v;
  int i;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int floor_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// rank r's share of n units: [share_lo(n, r), share_lo(n, r + 1)), the
// first n % kCL ranks one unit more (decode/rnnt_greedy.py::rank_ranges)
__host__ __device__ inline int share_lo(int n, int r) {
  return r * (n / kCL) + (r < n % kCL ? r : n % kCL);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index —
// the first maximum, as torch.argmax takes it, and the order of a stable
// descending sort and of jax.lax.top_k (a NaN counts as the maximum)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void shfl_best(float& v, int& i, int offset) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, offset);
  const int oi = __shfl_xor_sync(0xffffffffu, i, offset);
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t c;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(c));
  return (int)c;
}

// every thread of every block of the cluster; the release/acquire pair
// makes the remote shared-memory writes before it visible after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// p (in this block's shared memory) as the same offset in block `rank`'s
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, Cand c) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(__float_as_uint(c.v)), "r"(c.i)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The asynchronous remote stores: the value lands at `addr` (a cluster
// address, mapa) and completes its bytes as a transaction on the mbarrier at
// `bar` (a cluster address in the same block as addr); the receiver waits on
// that mbarrier, not on a cluster barrier.
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, Cand c, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(__float_as_uint(c.v)), "r"(c.i), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global memory into this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one thread: the bar's one arrival, expecting `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the shared memory about to be refilled by a bulk copy was last read by
// ordinary loads (ordered before by a __syncthreads)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The joiner on the tensor cores (bf16).  sA is the tile [kRows][Jp + 8]
// (8 elements of pad put ldmatrix's rows on distinct banks); W holds `count`
// n-tiles in fragment order, [count][Jp/16][32] uint2, the first at column
// col0.  Work items are (kG n-tiles, k-slice): where the share has few
// n-tiles, the J sum of each is split into k-slices until there is about
// one item a warp (partials through `scratch`, added in k-slice order).
// Each n-tile keeps two accumulator chains, the even and the odd k-steps,
// added at the end.  epi(c0, acc) takes each n-tile's sums in the m16n8
// layout: acc[e] is row lane / 4 + 8 (e / 2), column c0 + 2 (lane % 4) +
// e % 2.  `sync_after`: another pass reuses scratch.

template <class Epi>
__device__ __forceinline__ void logits_bf16(int Jp, const uint2* W, int count, int col0,
                                            const bf16* sA, float4* scratch, bool sync_after,
                                            Epi&& epi) {
  if (count <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KS = Jp / 16, AS = Jp + 8;
  const int groups = (count + kG - 1) / kG;
  const int ksl = max(1, min(kWarps / groups, KS));
  const bf16* pa = sA + (lane & 15) * AS + (lane >> 4) * 8;
  for (int it = warp; it < groups * ksl; it += kWarps) {
    const int g = it / ksl, s = it - g * ksl;
    const int q0 = kG * g, k0 = s * KS / ksl, k1 = (s + 1) * KS / ksl;
    const uint2* w = W + (size_t)q0 * KS * 32 + lane;
    float acc[kG][2][4] = {};
    for (int ks = k0; ks < k1; ks += 2) {
      uint32_t af[4];
      ldsm_x4(af, pa + ks * 16);
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        if (q0 + q < count) {
          const uint2 b = w[((size_t)q * KS + ks) * 32];
          mma_bf16(acc[q][0], af, b.x, b.y);
        }
      }
      if (ks + 1 < k1) {
        ldsm_x4(af, pa + (ks + 1) * 16);
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          if (q0 + q < count) {
            const uint2 b = w[((size_t)q * KS + ks + 1) * 32];
            mma_bf16(acc[q][1], af, b.x, b.y);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = acc[q][0][e] + acc[q][1][e];
      if (ksl == 1) {
        if (q0 + q < count) epi(col0 + (q0 + q) * 8, c);
      } else {
        scratch[((size_t)it * kG + q) * 32 + lane] = make_float4(c[0], c[1], c[2], c[3]);
      }
    }
  }
  if (ksl > 1) {
    __syncthreads();
    for (int q = warp; q < count; q += kWarps) {  // [item][kG][32]
      const float4* part = scratch + ((size_t)(q / kG) * ksl * kG + q % kG) * 32 + lane;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < ksl; ++s) {
        const float4 x = part[(size_t)s * kG * 32];
        c[0] += x.x;
        c[1] += x.y;
        c[2] += x.z;
        c[3] += x.w;
      }
      epi(col0 + q * 8, c);
    }
    if (sync_after) __syncthreads();
  }
}

// A decoder refresh's product for one 8-column chunk of decoder_proj.w
// ([D][8] in the compute dtype at Wc) with a decoder output x [D], by one
// warp: lane l sums rows l, l + 32, ...; then a transposing shuffle tree (9
// shuffles for the 8 columns) leaves column chunk_col(l) summed over the
// warp in lanes l % 4 == 0.

__device__ __forceinline__ int chunk_col(int lane) {
  return ((lane & 16) ? 4 : 0) + ((lane & 8) ? 2 : 0) + ((lane & 4) ? 1 : 0);
}

template <bool BF>
__device__ __forceinline__ float chunk_dot(const unsigned char* Wc, const float* x, int D,
                                           int lane) {
  float acc[8] = {};
#pragma unroll 4
  for (int d = lane; d < D; d += 32) {
    const float xd = x[d];
    float w[8];
    if (BF) {
      const uint4 raw = *reinterpret_cast<const uint4*>(Wc + (size_t)d * 16);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(h2[e]);
        w[2 * e] = f2.x;
        w[2 * e + 1] = f2.y;
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(Wc + (size_t)d * 32);
      const float4 w0 = src[0], w1 = src[1];
      w[0] = w0.x, w[1] = w0.y, w[2] = w0.z, w[3] = w0.w;
      w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(xd, w[e], acc[e]);
  }
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float v4[4], v2[2];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v4[e] = (h16 ? acc[e + 4] : acc[e]) +
            __shfl_xor_sync(0xffffffffu, h16 ? acc[e] : acc[e + 4], 16);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    v2[e] = (h8 ? v4[e + 2] : v4[e]) + __shfl_xor_sync(0xffffffffu, h8 ? v4[e] : v4[e + 2], 8);
  float v1 = (h4 ? v2[1] : v2[0]) + __shfl_xor_sync(0xffffffffu, h4 ? v2[0] : v2[1], 4);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
  return v1 + __shfl_xor_sync(0xffffffffu, v1, 1);
}

// ---------------------------------------------------------------------------
// Shared-memory layout.  A kernel places its fixed parts first (Layout), then
// place_weights() its weight shares; the same for every rank.

struct Layout {
  int at = round_up(kBars * 8, 16);  // the mbarriers come first
  int place(int bytes) {
    const int here = at;
    at = round_up(at + bytes, 128);
    return here;
  }
};

struct WeightPlan {
  int res_w, res_d;  // n-tiles / chunks of a share held resident
  int sw, sd;        // units per streamed stage (0: that weight does not stream)
  int depth;         // stages of each ring (2, or 1 where two do not fit)
  int uw, ud;        // bytes of one n-tile of W_out / one chunk of decoder_proj.w
  int wres, wring, dres, dring, bytes;
};

// ntw, ntd: the most n-tiles and chunks a rank owns
inline bool place_weights(WeightPlan& p, Layout& L, int ntw, int ntd, int limit) {
  const int fixed = L.at;
  auto fits = [&](long long bytes) { return fixed + bytes + 128 * 6 <= limit; };
  const long long all = (long long)ntw * p.uw + (long long)ntd * p.ud;
  p.res_w = p.res_d = p.sw = p.sd = 0;
  p.depth = 2;
  if (fits(all)) {
    p.res_w = ntw, p.res_d = ntd;
  } else {
    bool placed = false;
    for (int depth = 2; depth >= 1 && !placed; --depth) {
      // W_out keeps its whole share where that fits beside decoder_proj's
      // smallest ring, else it streams too; then each weight's resident part
      // fills the memory left beside the rings, W_out's first
      int sw = fits((long long)ntw * p.uw + (long long)depth * p.ud)
                   ? 0
                   : std::max(1, std::min(ntw, kStage / p.uw));
      int sd = std::max(1, std::min(ntd, kStage / p.ud));
      const long long keep = sw ? 0 : (long long)ntw * p.uw;
      auto ring_bytes = [&]() { return (long long)depth * ((long long)sw * p.uw + (long long)sd * p.ud); };
      while (sw > 1 && !fits(keep + ring_bytes())) --sw;
      while (sd > 1 && !fits(keep + ring_bytes())) --sd;
      const long long rings = ring_bytes();
      if (!fits(keep + rings)) continue;
      p.depth = depth, p.sw = sw, p.sd = sd;
      const int max_w = sw ? ntw - 1 : ntw;
      while (p.res_w < max_w && fits(rings + (p.res_w + 1LL) * p.uw)) ++p.res_w;
      while (p.res_d + 1 < ntd && fits(rings + (long long)p.res_w * p.uw + (p.res_d + 1LL) * p.ud))
        ++p.res_d;
      placed = true;
    }
    if (!placed) return false;
  }
  p.wres = L.place(p.res_w * p.uw);
  p.wring = L.place(p.depth * p.sw * p.uw);
  p.dres = L.place(p.res_d * p.ud);
  p.dring = L.place(p.depth * p.sd * p.ud);
  p.bytes = L.at;
  return p.bytes <= limit;
}

inline int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

// One lane's weight shares: which units rank `rank` owns, how many are
// resident and how many stream per pass, and the ring's stage issue (one
// thread) and wait.  `k` counts the stages a ring has consumed; stage k is
// unit group k % stages of the streamed units, in ring slot k % depth.
struct Shares {
  int w0, nw, c0, nd;        // first n-tile / chunk and how many this rank owns
  int w_res, w_str, d_res, d_str;
  int w_st, d_st;            // stages per pass over the streamed units
  const unsigned char *out_w, *dec_w;

  __device__ Shares(const WeightPlan& P, int NT, int NCH, int rank, const void* ow, const void* dw)
      : out_w(static_cast<const unsigned char*>(ow)), dec_w(static_cast<const unsigned char*>(dw)) {
    w0 = share_lo(NT, rank), nw = share_lo(NT, rank + 1) - w0;
    c0 = share_lo(NCH, rank), nd = share_lo(NCH, rank + 1) - c0;
    w_res = min(P.res_w, nw), w_str = nw - w_res;
    d_res = min(P.res_d, nd), d_str = nd - d_res;
    w_st = w_str > 0 ? (w_str + P.sw - 1) / P.sw : 0;
    d_st = d_str > 0 ? (d_str + P.sd - 1) / P.sd : 0;
  }

  __device__ void issue_w(const WeightPlan& P, unsigned char* wring, uint64_t* bars, int k) const {
    const int u = (k % w_st) * P.sw, n = min(P.sw, w_str - u), slot = k % P.depth;
    uint64_t* bar = bars + kBarW + slot;
    fence_async();
    mbar_expect(bar, (uint32_t)n * P.uw);
    bulk_load(wring + (size_t)slot * P.sw * P.uw, out_w + (size_t)(w0 + w_res + u) * P.uw,
              (uint32_t)n * P.uw, bar);
  }
  __device__ void issue_d(const WeightPlan& P, unsigned char* dring, uint64_t* bars, int k) const {
    const int u = (k % d_st) * P.sd, n = min(P.sd, d_str - u), slot = k % P.depth;
    uint64_t* bar = bars + kBarD + slot;
    fence_async();
    mbar_expect(bar, (uint32_t)n * P.ud);
    bulk_load(dring + (size_t)slot * P.sd * P.ud, dec_w + (size_t)(c0 + d_res + u) * P.ud,
              (uint32_t)n * P.ud, bar);
  }
};

__device__ __forceinline__ void ring_wait(uint64_t* bars, int which, int depth, int k) {
  mbar_wait(bars + which + k % depth, (uint32_t)(k / depth) & 1u);
}

}  // namespace rnnt
