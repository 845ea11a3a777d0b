// Relative-position attention context for Hopper (sm_90a).
//
// Replaces the TPU kernel k2transducerasr_tpu/ops/attention_pallas.py::
// relpos_attn_ctx (bodies _masked_scores and _kernel_ctx).  Per (b, h, query
// row t), in float32:
//
//     score[s] = q[t] . k[s]  +  pos_q[t] . pos_k[(T-1) - t + s]
//     score[s] = NEG_INF  unless  s < min(lens[b], S), s >= kv_start[b] and,
//                with chunk > 0 (T == S), s in [cs - left, cs + chunk), cs = (t/chunk)*chunk
//     ctx[b, t, h, :] = sum_s softmax(score)[s] * v[s]        -> out dtype (f32 or bf16)
//
// The offset into the DESCENDING rel-pos table pos_k [R = T+S-1, H, pd] is
// T-1, not S-1 (the queries are the last T positions of the keys).  Masks
// are key-side only, like the TPU kernel; NEG_INF is the finite -1e9, so a
// row whose keys are all masked gives the mean of v over all S.  No [T, S]
// tensor is written: the probabilities live in registers and shared memory.
//
// Rounding: the softmax is ONLINE (a running max and sum per row, the
// accumulator rescaled when the max grows), and the probabilities stay in
// float32 through the product with v.  The plain version (and the TPU
// kernel) rounds the normalised probabilities to v's dtype before that
// product.  In float32 the two are the same function up to summation order;
// with bf16 inputs they differ by at most 2^-9 * max|v| per output before
// its final rounding (the size of one bf16 rounding of a probability, summed
// over probabilities that add to 1).
//
// What bounds it on an H100: operations.  A call does 2*B*H*T*S*(qd+pd+vd)
// flops and moves ~5*B*T*H*64 values; at the conformer flagship shape (B=16,
// T=S=767, H=8, 64-wide heads, bf16) that is 28.9 GFLOP against 64 MB:
// 0.029 ms at the bf16 tensor-core peak, 0.019 ms at 3.35 TB/s.  This first
// design is far from that: it runs on the CUDA cores, and each 16 FMAs of a
// thread's 4x4 micro-tile wait on two or three 16-byte shared-memory loads,
// so shared-memory bandwidth, not the FMA units, limits it.
//
// Design (simple and right first; wgmma/TMA are later work):
//   * one block of 256 threads per (b, h, 64 query rows); the loop over keys
//     goes in tiles of 64, so no limit on S and shared memory stays
//     ~112 KB at 64-wide heads (two blocks per SM);
//   * the block's q and pos_q rows are staged once, transposed, in shared
//     memory; each key tile stages k (transposed), v, and the
//     64 + 64 - 1 rows of pos_k that the block's rows read for that tile
//     (the skew is index arithmetic into that window, as in K1);
//   * thread (ty, tx) owns the 4x4 micro-tile of rows 4ty.. and keys 4tx..:
//     its scores are float4-broadcast outer products from shared memory;
//     the 16 threads of a row form one half-warp, which reduces the row max
//     with shuffles;
//   * the tile's probabilities go to shared memory and the same thread
//     accumulates ctx for rows 4ty.. and value columns 4tx.. in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e9f;  // ops/layers.NEG_INF
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kVD = 64;           // widest value head
constexpr int kWin = kBQ + kBK;   // pos_k window rows per tile (kBQ + kBK - 1 used)
constexpr int kThreads = 256;     // 16 x 16 threads, a 4x4 micro-tile each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// DK: the q/pos contraction length in shared memory (qd, pd <= DK, zero-padded)
template <int DK>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)DK * (2 * kBQ + kBK + kWin) + (size_t)kBK * kVD +
                          (size_t)kBK * kBQ);
}

// max / sum over the 16 lanes of a half-warp (the threads that share a row)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Tin, typename Tout, int DK>
__global__ void __launch_bounds__(kThreads, 2)
relpos_attn_ctx_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                       const Tin* __restrict__ pq, const Tin* __restrict__ pk,
                       const Tin* __restrict__ v, const int* __restrict__ lens,
                       const int* __restrict__ kv_start, Tout* __restrict__ out, int T, int S,
                       int H, int qd, int pd, int vd, int chunk, int left) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [DK][kBQ]   q rows, transposed
  float* sPQ = sQ + DK * kBQ;   // [DK][kBQ]   pos_q rows, transposed
  float* sK = sPQ + DK * kBQ;   // [DK][kBK]   key tile, transposed
  float* sPK = sK + DK * kBK;   // [DK][kWin]  pos_k window of the tile, transposed
  float* sV = sPK + DK * kWin;  // [kBK][kVD]  value tile
  float* sP = sV + kBK * kVD;   // [kBK][kBQ]  the tile's probabilities, transposed

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys 4tx..4tx+3 of a tile, then ctx columns 4tx..4tx+3
  const int ty = tid / 16;  // query rows t0 + 4ty .. t0 + 4ty + 3
  const int R = T + S - 1;

  for (int i = tid; i < DK * kBQ; i += kThreads) {
    const int d = i / kBQ, t = t0 + i % kBQ;
    const size_t row = ((size_t)b * T + t) * H + h;
    sQ[i] = (t < T && d < qd) ? to_f32(q[row * qd + d]) : 0.f;
    sPQ[i] = (t < T && d < pd) ? to_f32(pq[row * pd + d]) : 0.f;
  }

  const int limit = min(lens[b], S);
  const int start = kv_start[b];
  int cs[4];  // chunk start of each row
#pragma unroll
  for (int i = 0; i < 4; ++i) cs[i] = chunk > 0 ? ((t0 + 4 * ty + i) / chunk) * chunk : 0;

  float m_run[4], l_part[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and sQ/sPQ are staged)
    for (int i = tid; i < DK * kBK; i += kThreads) {
      const int d = i / kBK, s = s0 + i % kBK;
      sK[i] = (s < S && d < qd) ? to_f32(k[(((size_t)b * S + s) * H + h) * qd + d]) : 0.f;
    }
    // window row w is pos_k row m_base + w: query t, key s -> (T-1) - t + s
    const int m_base = T - t0 - kBQ + s0;
    for (int i = tid; i < DK * kWin; i += kThreads) {
      const int d = i / kWin, m = m_base + i % kWin;
      sPK[i] = (m >= 0 && m < R && d < pd) ? to_f32(pk[((size_t)m * H + h) * pd + d]) : 0.f;
    }
    for (int i = tid; i < kBK * kVD; i += kThreads) {
      const int c = i / kVD, e = i % kVD, s = s0 + c;
      sV[i] = (s < S && e < vd) ? to_f32(v[(((size_t)b * S + s) * H + h) * vd + e]) : 0.f;
    }
    __syncthreads();

    float sc[4][4], ps[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = ps[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQ + d * kBQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(sK + d * kBK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }
    // row 4ty+i, key 4tx+j -> window row (kBQ-1 - (4ty+i)) + 4tx+j = base + 3 - i + j
    const int base = kBQ - 4 - 4 * ty + 4 * tx;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sPQ + d * kBQ + 4 * ty);
      const float4 w0 = *reinterpret_cast<const float4*>(sPK + d * kWin + base);
      const float4 w1 = *reinterpret_cast<const float4*>(sPK + d * kWin + base + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[i][j] = fmaf(av[i], wv[3 - i + j], ps[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 4 * tx + j;
        bool valid = s < limit && s >= start;
        if (chunk > 0) valid = valid && s >= cs[i] - left && s <= cs[i] + chunk - 1;
        // keys past S are not keys at all: exp(-inf) = 0 leaves them out
        sc[i][j] = s >= S ? -INFINITY : (valid ? sc[i][j] + ps[i][j] : kNegInf);
        mx = fmaxf(mx, sc[i][j]);
      }
      // finite: key s0 < S is in every tile
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float rescale = expf(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
      l_part[i] *= rescale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= rescale;
        sc[i][j] = expf(sc[i][j] - m_new);
        l_part[i] += sc[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (4 * tx + j) * kBQ + 4 * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(sP + c * kBQ + 4 * ty);
      const float4 w = *reinterpret_cast<const float4*>(sV + c * kVD + 4 * tx);
      const float pv[4] = {p.x, p.y, p.z, p.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum(l_part[i]);
    const int t = t0 + 4 * ty + i;
    if (t >= T) continue;
    Tout* o = out + (((size_t)b * T + t) * H + h) * vd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * tx + j;
      if (e < vd) o[e] = from_f32<Tout>(acc[i][j] / l);
    }
  }
}

template <typename Tin, typename Tout, int DK>
cudaError_t launch(const void* q, const void* k, const void* pq, const void* pk, const void* v,
                   const int* lens, const int* kv_start, void* out, int B, int T, int S, int H,
                   int qd, int pd, int vd, int chunk, int left, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK>();
  auto kern = relpos_attn_ctx_kernel<Tin, Tout, DK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k), static_cast<const Tin*>(pq),
      static_cast<const Tin*>(pk), static_cast<const Tin*>(v), lens, kv_start,
      static_cast<Tout*>(out), T, S, H, qd, pd, vd, chunk, left);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t dispatch_dk(const void* q, const void* k, const void* pq, const void* pk,
                        const void* v, const int* lens, const int* kv_start, void* out, int B,
                        int T, int S, int H, int qd, int pd, int vd, int chunk, int left,
                        cudaStream_t stream) {
  const int dk = qd > pd ? qd : pd;
  if (dk <= 16)
    return launch<Tin, Tout, 16>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd,
                                 chunk, left, stream);
  if (dk <= 32)
    return launch<Tin, Tout, 32>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd,
                                 chunk, left, stream);
  return launch<Tin, Tout, 64>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd,
                               chunk, left, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, pos_q, pos_k and v share
// one).  Returns the launch's cudaError_t (0 on success); the wrapper
// validates shapes, dtypes and the qd/pd/vd <= 64 limit.
extern "C" int k2t_relpos_attn_ctx(const void* q, const void* k, const void* pq, const void* pk,
                                   const void* v, const void* lens, const void* kv_start,
                                   void* out, int B, int T, int S, int H, int qd, int pd, int vd,
                                   int chunk, int left, int in_dtype, int out_dtype,
                                   void* stream) {
  const int* ln = static_cast<const int*>(lens);
  const int* ks = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qd > 64 || pd > 64 || vd > kVD) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return dispatch_dk<float, float>(q, k, pq, pk, v, ln, ks, out, B, T, S, H, qd, pd, vd,
                                     chunk, left, st);
  if (in_dtype == 0 && out_dtype == 1)
    return dispatch_dk<float, __nv_bfloat16>(q, k, pq, pk, v, ln, ks, out, B, T, S, H, qd, pd,
                                             vd, chunk, left, st);
  if (in_dtype == 1 && out_dtype == 0)
    return dispatch_dk<__nv_bfloat16, float>(q, k, pq, pk, v, ln, ks, out, B, T, S, H, qd, pd,
                                             vd, chunk, left, st);
  if (in_dtype == 1 && out_dtype == 1)
    return dispatch_dk<__nv_bfloat16, __nv_bfloat16>(q, k, pq, pk, v, ln, ks, out, B, T, S, H,
                                                     qd, pd, vd, chunk, left, st);
  return (int)cudaErrorInvalidValue;
}
