// LayerNorm for Hopper (sm_90a): the conformer's and the LSTM's norms.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the norm's chain by
// itself.  Eager PyTorch runs ops/norm_cuda.py::layernorm_reference as ten
// kernels (the upcast, the mean, the variance, the eps add, the rsqrt, the
// subtraction, the multiply by rsqrt, the scale, the bias, the cast), eight
// of them over the whole tensor in float32: ~52 bytes an element where one
// read and one write of bf16 need 4.  Per row of D elements, in float32:
//
//     mean = sum(x) / D
//     var  = sum((x - mean)^2) / D          (population variance)
//     out  = ((x - mean) * rsqrt(var + eps)) * scale[c] + bias[c]  -> x's dtype
//
// Each step is rounded as the plain version rounds it: the products by
// __fmul_rn and the sums by __fadd_rn, so that no FMA contracts a step;
// rsqrtf is what PyTorch's rsqrt runs on the card; the result is rounded
// once, to bf16 or float32.  Only the summation order of the mean and the
// variance differs from the plain version on the card.
//
// Layout.  x holds `rows` rows of D elements, each dense, row r at r *
// stride elements (stride >= D); out is dense [rows, D]; scale and bias
// float32 [D].  x and out share one dtype: float32 or bf16.
//
// What bounds it on an H100: bytes.  One read of x and one write of out:
// the conformer's [20 x 767, 512] bf16 call moves 31.4 MB, 9.4 us at 3.35
// TB/s.  The design is one pass.  A warp takes a row and holds it in
// registers: NG groups of 8 elements a lane (D <= 256 NG; the conformer's
// 512 is two 16-byte bf16 loads a lane, four of float32).  Warp shuffles
// sum the mean; a second pass over the registers sums the centred squares,
// so the variance is the stable two-pass one, with no E[x^2] - E[x]^2.
// scale and bias come through the read-only cache; stores are 16-byte.
// Eight warps make a block and the blocks cover the rows (15,340 rows:
// 1,918 blocks).  D % 8 != 0, a stride that is not a multiple of 8 or a
// pointer off a 16-byte boundary takes the scalar loop of the same kernel:
// element c of a row in lane c % 32.  D above 1024 is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;  // elements a vector group: 16 bytes of bf16
constexpr int kMaxD = 1024;

struct Args {
  const void* x;
  const float* scale;
  const float* bias;
  void* out;
  long long rows, stride;
  int D;
  float eps;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 elements at a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kGroup / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kGroup / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The column of a lane's element j: kVec, group j / 8 of the lane's NG at
// columns (group * 32 + lane) * 8 ...; scalar, column j * 32 + lane.
template <bool kVec>
__device__ __forceinline__ int column(int j, int lane) {
  return kVec ? ((j / kGroup) * 32 + lane) * kGroup + j % kGroup : j * 32 + lane;
}

template <typename T, int NG, bool kVec>
__global__ void __launch_bounds__(kThreads) k2t_layernorm_kernel(Args a) {
  constexpr int kN = NG * kGroup;  // elements a lane holds
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp: a row is a warp's
  const int lane = threadIdx.x % 32;
  const int D = a.D;
  const T* __restrict__ x = static_cast<const T*>(a.x) + row * a.stride;
  T* __restrict__ out = static_cast<T*>(a.out) + row * D;

  float v[kN];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (kVec) {
      const int c0 = column<true>(g * kGroup, lane);
      if (c0 < D) {
        load8(x + c0, v + g * kGroup);
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[g * kGroup + k] = 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int c = column<false>(g * kGroup + k, lane);
        v[g * kGroup + k] = c < D ? to_float(x[c]) : 0.f;
      }
    }
  }

  float s = 0.f;  // the columns past D hold 0
#pragma unroll
  for (int j = 0; j < kN; ++j) s = __fadd_rn(s, v[j]);
  const float mean = __fdiv_rn(warp_sum(s), (float)D);

  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (column<kVec>(j, lane) < D) {
      v[j] = __fsub_rn(v[j], mean);  // x - mean, kept for the output
      q = __fadd_rn(q, __fmul_rn(v[j], v[j]));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)D), a.eps));

#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float* y = v + g * kGroup;
    if (kVec) {
      const int c0 = column<true>(g * kGroup, lane);
      if (c0 < D) {
        float sc[kGroup], b[kGroup];
        load8(a.scale + c0, sc);
        load8(a.bias + c0, b);
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          y[k] = __fadd_rn(__fmul_rn(__fmul_rn(y[k], rstd), sc[k]), b[k]);
        store8(out + c0, y);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int c = column<false>(g * kGroup + k, lane);
        if (c < D)
          out[c] = from_float<T>(
              __fadd_rn(__fmul_rn(__fmul_rn(y[k], rstd), __ldg(a.scale + c)), __ldg(a.bias + c)));
      }
    }
  }
}

template <typename T, int NG>
cudaError_t run_width(const Args& a, bool vec, cudaStream_t st) {
  const unsigned blocks = (unsigned)((a.rows + kWarps - 1) / kWarps);
  if (vec)
    k2t_layernorm_kernel<T, NG, true><<<blocks, kThreads, 0, st>>>(a);
  else
    k2t_layernorm_kernel<T, NG, false><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, bool vec, cudaStream_t st) {
  if (a.D <= 32 * kGroup) return run_width<T, 1>(a, vec, st);
  if (a.D <= 64 * kGroup) return run_width<T, 2>(a, vec, st);
  return run_width<T, 4>(a, vec, st);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// out[r, :] = LayerNorm(x[r * stride : r * stride + D]) * scale + bias for r
// < rows; dtype 0 = float32, 1 = bf16 (x and out).  Launches nothing for
// rows == 0.  Returns the launch's cudaError_t (cudaErrorInvalidValue for
// arguments out of range: rows >= 2^31, D outside 1..1024, stride < D, a
// null scale or bias).
extern "C" int k2t_layernorm(const void* x, const void* scale, const void* bias, void* out,
                             long long rows, int D, long long stride, float eps, int dtype,
                             void* stream) {
  if (rows < 0 || rows >= (1ll << 31) || D < 1 || D > kMaxD || stride < D || dtype < 0 ||
      dtype > 1 || scale == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Args a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), out,
               rows, stride, D, eps};
  const bool vec = D % kGroup == 0 && stride % kGroup == 0 && aligned16(x) && aligned16(out) &&
                   aligned16(scale) && aligned16(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, vec, st);
  return (int)run<float>(a, vec, st);
}
