// Bias + Swoosh for Hopper (sm_90a): the zipformer2 encoder's activations.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the bias add, the Swoosh
// and the cast into the product's epilogue by itself.  Eager PyTorch runs
// the same chain as one kernel per op (the bias add, the cast, then ten for
// the Swoosh: sub, abs, neg, exp, log1p, clamp, add, mul, sub, sub), each
// reading and writing the whole tensor.  Per element, in float32:
//
//     z   = y + bias[c]                 (no add without a bias)
//     t   = z - shift
//     out = (max(t, 0) + log1p(exp(-|t|))) - 0.08 z - offset   -> out dtype
//
// SwooshL: shift 4, offset 0.035; SwooshR: shift 1, offset 0.313261687
// (ops/layers.py::swoosh_l, swoosh_r; softplus in the reference's form).
// Every step is rounded as the plain version (ops/activations_cuda.py::
// bias_swoosh_reference) rounds it in float32: the product 0.08 z by
// __fmul_rn, so that no FMA contracts it into the subtraction; expf and
// log1pf are CUDA's accurate ones, as PyTorch's exp and log1p on the card.
// The result is rounded once, to bf16 or float32.  Three pairings of y
// and out: float32 -> float32, float32 -> bf16, bf16 -> bf16 (a bf16 y
// comes from a product under a bf16 compute dtype, whose output is bf16).
//
// Layout.  y and out hold n elements that fill one dense block of memory,
// in the same order (the wrapper allocates out with y's strides).  The
// channel axis C has stride sC in that block, so element i has channel
// (i / sC) % C: sC = 1 for channels last (a product's [rows, C]), sC = T
// for a depthwise convolution's [B, C, T] seen as [B, T, C], sC = H * W
// for an NCHW convolution seen as NHWC.  So no site copies its tensor into
// another layout first.
//
// What bounds it on an H100: bytes.  One read of y and one write of out,
// (in + out bytes) / 3.35 TB/s: a bf16 [20 x 1496, 512] product ~18 us.
// The kernel walks the block in groups of 8 elements, a thread a group,
// grid-stride, with enough blocks for every SM: 16-byte loads and stores
// (one of bf16, two of float32) when both pointers are 16-byte aligned,
// element loads otherwise and for the last n % 8 elements.  Channels last
// with C % 8 == 0 (and the bias 16-byte aligned) reads a group's 8 biases
// as two float4; any other layout walks the channel element by element
// from one division per group.  The bias is read through the read-only
// cache.  No shared memory.  Per element the Swoosh costs some 40 float32
// instructions (expf and log1pf), near the issue rate that 4 bytes an
// element at 3.35 TB/s asks of 132 SMs: the arithmetic is kept exact
// rather than approximated to stay under it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // elements per thread and step: 16 bytes of bf16
constexpr int kBlocksPerSM = 8;

struct Args {
  const void* y;
  const float* bias;  // [C] or null
  void* out;
  unsigned n, C, sC;
  float shift, offset;
};

__device__ __forceinline__ float swoosh(float z, float shift, float offset) {
  const float t = z - shift;
  const float sp = fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)));
  return (sp - __fmul_rn(0.08f, z)) - offset;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 elements at a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&v)[kGroup]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kGroup]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kGroup / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kGroup]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kGroup]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kGroup / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// kVec: 16-byte loads and stores of whole groups.  kRows: channels last with
// C % 8 == 0 and an aligned bias, so a group's channels are c0 .. c0 + 7.
template <typename Tin, typename Tout, bool kVec, bool kRows>
__global__ void __launch_bounds__(kThreads) k2t_bias_swoosh_kernel(Args a) {
  const Tin* __restrict__ y = static_cast<const Tin*>(a.y);
  Tout* __restrict__ out = static_cast<Tout*>(a.out);
  const unsigned groups = (a.n + kGroup - 1) / kGroup;
  const unsigned step = gridDim.x * kThreads;
  for (unsigned g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += step) {
    const unsigned i0 = g * kGroup;
    const unsigned m = min(a.n - i0, (unsigned)kGroup);
    float v[kGroup];
    if (kVec && m == kGroup) {
      load8(y + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) v[j] = (unsigned)j < m ? to_float(y[i0 + j]) : 0.f;
    }
    if (a.bias != nullptr) {
      if (kRows) {
        float b[kGroup];
        load8(a.bias + i0 % a.C, b);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) v[j] += b[j];
      } else {
        const unsigned q = i0 / a.sC;
        unsigned r = i0 - q * a.sC, c = q % a.C;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          v[j] += __ldg(a.bias + c);
          if (++r == a.sC) {
            r = 0;
            if (++c == a.C) c = 0;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = swoosh(v[j], a.shift, a.offset);
    if (kVec && m == kGroup) {
      store8(out + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if ((unsigned)j < m) out[i0 + j] = from_float<Tout>(v[j]);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t run(const Args& a, bool vec, bool rows, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const unsigned groups = (a.n + kGroup - 1) / kGroup;
  const unsigned blocks = min((groups + kThreads - 1) / kThreads, (unsigned)(sms * kBlocksPerSM));
  if (vec && rows)
    k2t_bias_swoosh_kernel<Tin, Tout, true, true><<<blocks, kThreads, 0, st>>>(a);
  else if (vec)
    k2t_bias_swoosh_kernel<Tin, Tout, true, false><<<blocks, kThreads, 0, st>>>(a);
  else
    k2t_bias_swoosh_kernel<Tin, Tout, false, false><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// out = swoosh_kind(y + bias) over n elements, channel (i / sC) % C of C;
// kind 0 = SwooshL, 1 = SwooshR; dtypes 0 = float32, 1 = bf16, bf16 in only
// with bf16 out.  bias may be null.  Launches nothing for n == 0.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for arguments out of
// range: n >= 2^31, C or sC 0, bf16 in with float32 out).
extern "C" int k2t_bias_swoosh(const void* y, const void* bias, void* out, long long n, int C,
                               long long sC, int kind, int in_dtype, int out_dtype, void* stream) {
  if (n < 0 || n >= (1ll << 31) || C < 1 || sC < 1 || sC >= (1ll << 31) || kind < 0 || kind > 1 ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 || in_dtype > out_dtype)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Args a{y, static_cast<const float*>(bias), out, (unsigned)n, (unsigned)C, (unsigned)sC,
               kind == 0 ? 4.f : 1.f, kind == 0 ? 0.035f : 0.313261687f};
  const bool vec = aligned16(y) && aligned16(out);
  const bool rows = sC == 1 && C % kGroup == 0 && (bias == nullptr || aligned16(bias));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) return (int)run<__nv_bfloat16, __nv_bfloat16>(a, vec, rows, st);
  if (out_dtype == 1) return (int)run<float, __nv_bfloat16>(a, vec, rows, st);
  return (int)run<float, float>(a, vec, rows, st);
}
