// Relative-position attention probabilities for Hopper (sm_90a).
//
// Replaces the TPU kernel k2transducerasr_tpu/ops/attention_pallas.py::
// relpos_attn_probs (bodies _masked_scores and _kernel).  Per (b, h, query
// row t), in float32:
//
//     scores[s] = q[t] . k[s]  +  pos_q[t] . pos_k[(T-1) - t + s]
//     scores[s] = NEG_INF  unless  s < min(lens[b], S), s >= kv_start[b] and,
//                 with chunk > 0 (T == S), s in [cs - left, cs + chunk), cs = (t/chunk)*chunk
//     probs[b, h, t, :] = softmax(scores)          -> out dtype (f32 or bf16)
//
// The pos term is the skew of pos_q @ pos_k^T over the DESCENDING rel-pos
// table pos_k [R = T+S-1, H, pd]; it is done as index arithmetic into a
// window of pos_k staged in shared memory, so no [T, R] tile is ever made.
// The pos dot runs as pd float32 FMAs in order j = 0..pd-1, as the TPU
// kernel's pos_vpu path does.  Masks are key-side only, like the TPU kernel.
//
// What bounds it on an H100: writing the probs.  A call reads 2*B*T*H*qd
// q/k values plus small pos tensors and writes B*H*T*S probs; at the
// flagship's stack-0 shape (B=16, T=S=1532, H=4, qd=32) that is ~300 MB of
// bf16 output against ~6 MB of input, ~0.09 ms at 3.35 TB/s.  The products
// are 2*B*H*T*S*(qd+pd) flops, far below the tensor-core roof.
//
// Design (simple and right first; wgmma/TMA and a fused consumer are later
// work):
//   * one block of 256 threads per (b, h, block of `rows` query rows);
//   * the block's q rows and pos_q rows sit in shared memory (zero-padded to
//     whole float4s) and are read as broadcast float4s;
//   * each thread owns one key column at a time and holds that key's qd
//     values in registers, so k is read once per block, straight from L2;
//   * the score rows [rows][S] stay in shared memory in float32, then one
//     warp per row takes the row max and sum and writes exp(x - max) / sum
//     with consecutive lanes on consecutive columns (coalesced stores).
// `rows` is chosen by the wrapper so the score rows fit shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e9f;  // ops/layers.NEG_INF
constexpr int kMaxQd = 64;        // q row stride in shared memory
constexpr int kMaxPd = 8;         // pos_q row stride in shared memory
constexpr int kThreads = 256;

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

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) / 4 * 4; }

// must match _smem_bytes() in ops/attention_cuda.py
size_t smem_bytes(int rows, int s, int pd) {
  return sizeof(float) * ((size_t)rows * kMaxQd + (size_t)rows * kMaxPd +
                          (size_t)(s + rows - 1) * round4(pd) + (size_t)rows * s);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// QD: register length of one key vector (qd <= QD, zero-padded).
template <typename Tin, typename Tout, int QD>
__global__ void __launch_bounds__(kThreads)
relpos_attn_probs_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                         const Tin* __restrict__ pq, const Tin* __restrict__ pk,
                         const int* __restrict__ lens, const int* __restrict__ kv_start,
                         Tout* __restrict__ out, int T, int S, int H, int qd, int pd,
                         int chunk, int left, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);
  const int pd4 = round4(pd);
  const int nm = S + nrows - 1;      // pos_k rows this block reads
  const int m_lo = T - t0 - nrows;   // first of them: (T-1) - (t0 + nrows - 1)

  float* sq = smem;                  // [rows][kMaxQd]
  float* spq = sq + rows * kMaxQd;   // [rows][kMaxPd]
  float* spk = spq + rows * kMaxPd;  // [nm][pd4]
  float* sc = spk + (S + rows - 1) * pd4;  // [rows][S] scores, then exp

  for (int i = threadIdx.x; i < rows * kMaxQd; i += blockDim.x) {
    const int r = i / kMaxQd, d = i % kMaxQd;
    sq[i] = (r < nrows && d < qd)
                ? to_f32(q[(((size_t)b * T + t0 + r) * H + h) * qd + d]) : 0.f;
  }
  for (int i = threadIdx.x; i < rows * kMaxPd; i += blockDim.x) {
    const int r = i / kMaxPd, j = i % kMaxPd;
    spq[i] = (r < nrows && j < pd)
                 ? to_f32(pq[(((size_t)b * T + t0 + r) * H + h) * pd + j]) : 0.f;
  }
  for (int i = threadIdx.x; i < nm * pd4; i += blockDim.x) {
    const int m = i / pd4, j = i % pd4;
    spk[i] = j < pd ? to_f32(pk[((size_t)(m_lo + m) * H + h) * pd + j]) : 0.f;
  }
  __syncthreads();

  const int limit = min(lens[b], S);
  const int start = kv_start[b];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float kr[QD];
    const Tin* kp = k + (((size_t)b * S + s) * H + h) * qd;
#pragma unroll
    for (int d = 0; d < QD; ++d) kr[d] = d < qd ? to_f32(kp[d]) : 0.f;
    const bool key_ok = s < limit && s >= start;
    for (int r = 0; r < nrows; ++r) {
      const float4* q4 = reinterpret_cast<const float4*>(sq + r * kMaxQd);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < QD / 4; ++d4) {
        const float4 v = q4[d4];
        acc = fmaf(v.x, kr[4 * d4 + 0], acc);
        acc = fmaf(v.y, kr[4 * d4 + 1], acc);
        acc = fmaf(v.z, kr[4 * d4 + 2], acc);
        acc = fmaf(v.w, kr[4 * d4 + 3], acc);
      }
      // skew: query t0+r, key s -> pos_k row (T-1) - (t0+r) + s
      const float4* pk4 = reinterpret_cast<const float4*>(spk + (nrows - 1 - r + s) * pd4);
      const float4* pq4 = reinterpret_cast<const float4*>(spq + r * kMaxPd);
      float m = 0.f;
      for (int j4 = 0; j4 < pd4 / 4; ++j4) {
        const float4 a = pq4[j4], c = pk4[j4];
        m = fmaf(a.x, c.x, m);
        m = fmaf(a.y, c.y, m);
        m = fmaf(a.z, c.z, m);
        m = fmaf(a.w, c.w, m);
      }
      bool valid = key_ok;
      if (chunk > 0) {
        const int cs = ((t0 + r) / chunk) * chunk;
        valid = valid && s <= cs + chunk - 1 && s >= cs - left;
      }
      sc[r * S + s] = valid ? acc + m : kNegInf;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nrows; r += blockDim.x / 32) {
    float* row = sc + r * S;
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    Tout* o = out + (((size_t)b * H + h) * T + t0 + r) * S;
    for (int s = lane; s < S; s += 32) o[s] = from_f32<Tout>(row[s] / sum);
  }
}

template <typename Tin, typename Tout, int QD>
cudaError_t launch(const void* q, const void* k, const void* pq, const void* pk,
                   const int* lens, const int* kv_start, void* out, int B, int T, int S,
                   int H, int qd, int pd, int chunk, int left, int rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, S, pd);
  auto kern = relpos_attn_probs_kernel<Tin, Tout, QD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + rows - 1) / rows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k), static_cast<const Tin*>(pq),
      static_cast<const Tin*>(pk), lens, kv_start, static_cast<Tout*>(out), T, S, H, qd, pd,
      chunk, left, rows);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t dispatch_qd(const void* q, const void* k, const void* pq, const void* pk,
                        const int* lens, const int* kv_start, void* out, int B, int T,
                        int S, int H, int qd, int pd, int chunk, int left, int rows,
                        cudaStream_t stream) {
  if (qd <= 32)
    return launch<Tin, Tout, 32>(q, k, pq, pk, lens, kv_start, out, B, T, S, H, qd, pd,
                                 chunk, left, rows, stream);
  return launch<Tin, Tout, kMaxQd>(q, k, pq, pk, lens, kv_start, out, B, T, S, H, qd, pd,
                                   chunk, left, rows, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 on success); the wrapper validates shapes, dtypes and qd/pd limits.
extern "C" int k2t_relpos_attn_probs(const void* q, const void* k, const void* pq,
                                     const void* pk, const void* lens, const void* kv_start,
                                     void* out, int B, int T, int S, int H, int qd, int pd,
                                     int chunk, int left, int rows, int in_dtype,
                                     int out_dtype, void* stream) {
  const int* ln = static_cast<const int*>(lens);
  const int* ks = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qd > kMaxQd || pd > kMaxPd || rows <= 0) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return dispatch_qd<float, float>(q, k, pq, pk, ln, ks, out, B, T, S, H, qd, pd, chunk,
                                     left, rows, st);
  if (in_dtype == 0 && out_dtype == 1)
    return dispatch_qd<float, __nv_bfloat16>(q, k, pq, pk, ln, ks, out, B, T, S, H, qd, pd,
                                             chunk, left, rows, st);
  if (in_dtype == 1 && out_dtype == 0)
    return dispatch_qd<__nv_bfloat16, float>(q, k, pq, pk, ln, ks, out, B, T, S, H, qd, pd,
                                             chunk, left, rows, st);
  if (in_dtype == 1 && out_dtype == 1)
    return dispatch_qd<__nv_bfloat16, __nv_bfloat16>(q, k, pq, pk, ln, ks, out, B, T, S, H,
                                                     qd, pd, chunk, left, rows, st);
  return (int)cudaErrorInvalidValue;
}
