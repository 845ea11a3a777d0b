// One 64-query x 64-key tile of masked relative-position attention scores,
// in float32, on Hopper's tensor cores (sm_90a), from bfloat16 operands.
//
// The shared body of both bf16 kernels, as the TPU kernels share one:
// it replaces k2transducerasr_tpu/ops/attention_pallas.py::_masked_scores,
// the body of relpos_attn_probs (K1, csrc/relpos_attn_probs.cu) and of
// relpos_attn_ctx (K2, csrc/relpos_attn_ctx.cu).  For query row t and key s:
//
//     score[t, s] = q[t] . k[s]  +  pos_q[t] . pos_k[(T-1) - t + s]
//     score[t, s] = NEG_INF (-1e9)  unless  s < min(lens[b], S), s >= kv_start[b]
//                   and, with chunk > 0, s in [cs - left, cs + chunk), cs = (t/chunk)*chunk
//     score[t, s] = -inf  for s >= S (padding keys of the last tile: they drop out)
//
// The offset into the DESCENDING rel-pos table pos_k [R = T+S-1, H, pd] is
// T-1, not S-1: the queries are the last T positions of the keys.
//
// Tile design.  A block of 4 warps (128 threads) owns (b, h, 64 query rows);
// warp w owns rows t0+16w .. t0+16w+15 and keeps them in registers as
// mma A fragments for the whole key loop.  Key tiles of 64 keys, and the
// 127 pos_k rows (padded to 128) that the block's rows read for that tile,
// are staged in shared memory by the caller with cp.async (stage() below),
// double-buffered so that tile n+1 loads while tile n computes.
//   * q.k: mma.sync m16n8k16 bf16 -> f32, B fragments by ldmatrix.
//   * the position term: row t reads pos_k rows that slide with t.  Warp w
//     needs the 79 consecutive rows from base_w = (T-1) - (t0+16w+15) + s0
//     on, so it computes M_w = pos_q[16 rows] . pos_k[base_w .. base_w+79]^T,
//     a 16 x 80 product (10 n-tiles, 1.25x the diagonal's work), writes it to
//     a per-warp f32 scratch and reads it back skewed:
//         score[i, j] += M_w[i, 15 - i + j].
//     That is the rel-shift as math; the TPU kernel's strided roll is a TPU
//     workaround and has no counterpart here.
//   * narrow heads: q/pos widths are zero-padded to a multiple of 16 in
//     shared memory (zipformer2's pd = 4 is one k-step on zeros).
//   * masks are key-side only and applied per accumulator element from the
//     (row, column) the m16n8 fragment layout gives each thread.
// Why mma.sync and not wgmma: the skew and the masks need each warp's
// 16-row slab of scores in registers with a known layout; mma.sync gives
// exactly that with no descriptors, and its B operands come from ldmatrix
// on padded rows without the swizzled layouts wgmma needs.  At these
// shapes (64-wide heads at most) the kernels are bound by exps, shared
// memory traffic and, for K1, the probs' bytes, not by the tensor-core rate.
//
// float32 inputs do not come here: tensor cores would round them to TF32.
// Each kernel keeps its CUDA-core float32 body for them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace relpos {

constexpr int kMaxDevices = 64;

// Lets Kernel take `smem` bytes of dynamic shared memory on the current
// device (with all of L1 as shared memory if max_carveout).  Each
// cudaFuncSetAttribute costs host time, which the card spends idle on a
// launch from an empty queue, so the attributes are set only when a launch
// needs more than the device allows the kernel already: once per kernel and
// device on the main path.
template <auto Kernel>
cudaError_t allow_smem(size_t smem, bool max_carveout) {
  static std::mutex mu;
  static size_t allowed[kMaxDevices];  // bytes set so far; 0 = not yet set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

// lens[b] and kv_start[b]; a null pointer means "all S keys" and "from 0"
__device__ __forceinline__ int lane_limit(const int* lens, int b, int S) {
  return lens ? min(lens[b], S) : S;
}

__device__ __forceinline__ int lane_start(const int* kv_start, int b) {
  return kv_start ? kv_start[b] : 0;
}

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e9f;  // ops/layers.NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = 4;          // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kWin = kBQ + kBK;    // pos_k rows a key tile reads (127), padded
constexpr int kMwStride = 88;      // floats per row of a warp's 16 x 80 scratch
constexpr int kScratchFloats = kWarps * 16 * kMwStride;

// bf16 elements per shared-memory row of a D-wide operand: 16 bytes of pad
// put the 8 rows of an ldmatrix on 8 distinct 16-byte bank groups
template <int D>
__host__ __device__ constexpr int row_elems() {
  return D + 8;
}

// first pos_k row of the block's window for key tile s0: query t0+kBQ-1,
// key s0 -> (T-1) - (t0+kBQ-1) + s0
__device__ __forceinline__ int pos_window_first(int T, int t0, int s0) {
  return (T - 1) - (t0 + kBQ - 1) + s0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// asynchronous copy of BYTES (16, 8 or 4) global -> shared; zeros when !fill
template <int BYTES>
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src, bool fill) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(fill ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(fill ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats -> one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows first .. first+NROWS-1 of a strided global array (row g at
// base + g*stride, w elements wide) into shared rows of row_elems<D>(),
// zero-filling rows outside [lo, hi); columns w .. D-1 are zeroed once by
// zero_columns and never written here.  kThreads / NROWS threads share a
// row.  V elements per copy: 8 and 2 are 16- and 4-byte cp.async copies
// (w % V == 0, rows aligned to 2V bytes), to be committed by the caller; 1
// is plain element loads (odd widths).
template <int D, int V, int NROWS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* base, long long stride, int first,
                                      int lo, int hi, int w) {
  static_assert(NROWS <= kThreads && kThreads % NROWS == 0, "whole rows per thread group");
  constexpr int kPerRow = kThreads / NROWS;
  const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow, row = first + r;
  const bool ok = row >= lo && row < hi;
  bf16* d = dst + r * row_elems<D>();
  const bf16* src = ok ? base + row * stride : base;
  const int chunks = w / V;
#pragma unroll
  for (int c = part; c < D / V; c += kPerRow) {
    if (c >= chunks) break;
    if constexpr (V > 1)
      cp_async<2 * V>(d + V * c, ok ? src + V * c : src, ok);
    else
      d[c] = ok ? src[c] : __float2bfloat16(0.f);
  }
}

// zero columns w .. D-1 of nrows shared rows of row_elems<D>()
template <int D>
__device__ __forceinline__ void zero_columns(bf16* dst, int nrows, int w) {
  const int pad = D - w;
  for (int i = threadIdx.x; i < nrows * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * row_elems<D>() + w + (i - r * pad)] = __float2bfloat16(0.f);
  }
}

// Elements per copy (8, 2 or 1) for rows of width w starting at p
inline int copy_elems(int w, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (w % 8 == 0 && a % 16 == 0) return 8;
  if (w % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

// Calls f(QV, PV) with the template copy widths of the q operands (qv) and
// the position operands (pv): (8, 8), (8, 2), (2, 2) or (1, 1); a narrower
// width is valid wherever a wider one is.
template <typename F>
cudaError_t with_copy_widths(int qv, int pv, F&& f) {
  using V1 = std::integral_constant<int, 1>;
  using V2 = std::integral_constant<int, 2>;
  using V8 = std::integral_constant<int, 8>;
  if (qv == 1 || pv == 1) return f(V1{}, V1{});
  if (qv == 2) return f(V2{}, V2{});
  return pv == 2 ? f(V8{}, V2{}) : f(V8{}, V8{});
}

// A fragments of one warp's 16 rows (of a [kBQ][row_elems<D>()] shared
// array), k-steps of 16 columns
template <int D>
__device__ __forceinline__ void load_rows(uint32_t (&a)[D / 16][4], const bf16* s, int warp,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(a[ks], s + (16 * warp + (lane & 15)) * row_elems<D>() + 16 * ks + (lane >> 4) * 8);
}

// Key-side masks of one block (b, t0): fragment row 0 is query t0+16w+gid,
// row 1 is that + 8.
struct KeyMask {
  int S, limit, start, chunk, left;
  int cs[2];  // chunk start of the thread's two rows

  __device__ __forceinline__ KeyMask(int S_, const int* lens, const int* kv_start, int b,
                                     int chunk_, int left_, int t_row0)
      : S(S_), limit(lane_limit(lens, b, S_)), start(lane_start(kv_start, b)), chunk(chunk_),
        left(left_) {
    cs[0] = chunk > 0 ? (t_row0 / chunk) * chunk : 0;
    cs[1] = chunk > 0 ? ((t_row0 + 8) / chunk) * chunk : 0;
  }

  // every key of the tile s0 .. s0+kBK-1 is valid for both of the thread's rows
  __device__ __forceinline__ bool all_valid(int s0) const {
    bool ok = s0 >= start && s0 + kBK <= limit;
    if (chunk > 0)
      ok = ok && s0 >= max(cs[0], cs[1]) - left && s0 + kBK <= min(cs[0], cs[1]) + chunk;
    return ok;
  }

  __device__ __forceinline__ float operator()(float x, int s, int half) const {
    if (s >= S) return -INFINITY;
    bool valid = s < limit && s >= start;
    if (chunk > 0) valid = valid && s >= cs[half] - left && s <= cs[half] + chunk - 1;
    return valid ? x : kNegInf;
  }
};

// The warp's 16 x 64 tile of masked scores for keys s0 .. s0+63, in the
// m16n8 accumulator layout: sc[j][0..1] is row gid (= lane/4), keys
// s0 + 8j + 2*(lane%4) + {0, 1}; sc[j][2..3] the same keys of row gid + 8.
// In three pieces, so that heads wider than 64 can add their 64-wide chunks
// into the same accumulators (qk_products and pos_products once per chunk,
// skew_and_mask once):
//   qa, pa: the warp's q and pos_q rows (load_rows)
//   sk:     [kBK][row_elems<QD>()] the key tile
//   spk_lo, spk_hi: [kBK][row_elems<PD>()] each, the window's pos_k rows
//           from pos_window_first(T, t0, s0): rows 0-63 and rows 64-127
//   m:      M_w, the warp's 16 x 80 position product (10 n-tiles)
//   mw:     the warp's [16][kMwStride] f32 scratch

// ldmatrix x4 of 16 rows x 16 columns as two n-tiles' B fragments: lanes
// 0-7 rows 0-7 cols 0-7, 8-15 rows 0-7 cols 8-15, 16-23 rows 8-15 cols 0-7,
// 24-31 rows 8-15 cols 8-15
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// sc += q . k^T over the QD columns of the tile
template <int QD>
__device__ __forceinline__ void qk_products(float (&sc)[8][4], const uint32_t (&qa)[QD / 16][4],
                                            const bf16* sk, int lane) {
#pragma unroll
  for (int ks = 0; ks < QD / 16; ++ks)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, sk + (16 * p + b_row(lane)) * row_elems<QD>() + 16 * ks + b_col(lane));
      mma_bf16(sc[2 * p], qa[ks], b[0], b[1]);
      mma_bf16(sc[2 * p + 1], qa[ks], b[2], b[3]);
    }
}

// m += pos_q[16 rows] . pos_k[window rows base .. base+79]^T over PD columns
template <int PD>
__device__ __forceinline__ void pos_products(float (&m)[10][4], const uint32_t (&pa)[PD / 16][4],
                                             const bf16* spk_lo, const bf16* spk_hi, int warp,
                                             int lane) {
  const int base = (kBQ - 16) - 16 * warp;  // base_w within the block's window
#pragma unroll
  for (int ks = 0; ks < PD / 16; ++ks)
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      uint32_t b[4];
      const int r0 = base + 16 * p;  // 16 rows in one half of the window
      const bf16* half =
          r0 < kBK ? spk_lo + r0 * row_elems<PD>() : spk_hi + (r0 - kBK) * row_elems<PD>();
      ldsm_x4(b, half + b_row(lane) * row_elems<PD>() + 16 * ks + b_col(lane));
      mma_bf16(m[2 * p], pa[ks], b[0], b[1]);
      mma_bf16(m[2 * p + 1], pa[ks], b[2], b[3]);
    }
}

// sc += the skewed M_w (through the scratch), then the key masks
__device__ __forceinline__ void skew_and_mask(float (&sc)[8][4], const float (&m)[10][4],
                                              float* mw, int lane, int s0, const KeyMask& mask) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    *reinterpret_cast<float2*>(mw + gid * kMwStride + 8 * j + 2 * tig) = make_float2(m[j][0], m[j][1]);
    *reinterpret_cast<float2*>(mw + (gid + 8) * kMwStride + 8 * j + 2 * tig) =
        make_float2(m[j][2], m[j][3]);
  }
  __syncwarp();
  // skewed read: row i, key j -> M_w[i][15 - i + j]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * tig + e;
      sc[j][e] += mw[gid * kMwStride + 15 - gid + c];
      sc[j][2 + e] += mw[(gid + 8) * kMwStride + 7 - gid + c];
    }
  __syncwarp();  // the scratch is free again

  if (mask.all_valid(s0)) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = s0 + 8 * j + 2 * tig + e;
      sc[j][e] = mask(sc[j][e], s, 0);
      sc[j][2 + e] = mask(sc[j][2 + e], s, 1);
    }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// The whole tile for heads of at most 64 (one chunk)
template <int QD, int PD>
__device__ __forceinline__ void masked_scores(float (&sc)[8][4], const uint32_t (&qa)[QD / 16][4],
                                              const uint32_t (&pa)[PD / 16][4], const bf16* sk,
                                              const bf16* spk_lo, const bf16* spk_hi, float* mw,
                                              int warp, int lane,
                                              int s0, const KeyMask& mask) {
  zero_acc(sc);
  qk_products<QD>(sc, qa, sk, lane);
  float m[10][4];
  zero_acc(m);
  pos_products<PD>(m, pa, spk_lo, spk_hi, warp, lane);
  skew_and_mask(sc, m, mw, lane, s0, mask);
}

// Heads wider than 64 run in 64-wide chunks (kChunk): chunk c of a row is
// its columns 64c .. 64c+63, staged with this width into rows of
// row_elems<kChunk>() (the last chunk zero-padded)
constexpr int kChunk = 64;

__host__ __device__ constexpr int chunks(int width) { return (width + kChunk - 1) / kChunk; }

__host__ __device__ constexpr int chunk_width(int width, int c) {
  return width - kChunk * c < kChunk ? width - kChunk * c : kChunk;
}

// stage() of chunk c of rows first .. first+NROWS-1 (row g at base + g *
// stride, `width` wide) into rows of row_elems<kChunk>(); a last chunk
// narrower than kChunk gets its pad columns zeroed
template <int V, int NROWS>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* base, long long stride,
                                            int first, int lo, int hi, int width, int c) {
  const int w = chunk_width(width, c);
  if (w < kChunk) zero_columns<kChunk>(dst, NROWS, w);
  stage<kChunk, V, NROWS>(dst, base + kChunk * c, stride, first, lo, hi, w);
}

// Every chunk of the block's kBQ query rows from t0, chunk c at dst + c *
// kBQ * row_elems<kChunk>()
template <int V>
__device__ __forceinline__ void stage_query_chunks(bf16* dst, const bf16* base, long long stride,
                                                   int t0, int T, int width) {
  for (int c = 0; c < chunks(width); ++c)
    stage_chunk<V, kBQ>(dst + c * kBQ * row_elems<kChunk>(), base, stride, t0, 0, T, width, c);
}

// max / sum over the 4 lanes that share a fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace relpos
