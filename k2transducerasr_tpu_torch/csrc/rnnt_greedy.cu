// Batched RNN-T greedy search for Hopper (sm_90a): one launch runs every
// lane's whole search on the card.
//
// Replaces the device loop of k2transducerasr_tpu/decode/rnnt_greedy.py::
// greedy_frames_skip, the lax.while_loop at :138-233 (no Pallas kernel is
// behind it: XLA compiles the loop, its condition evaluated on the device).
// The port's plain version, a Python loop with one host sync per trip, is
// decode/rnnt_greedy.py::greedy_frames_skip_reference; the result does not
// depend on how frames are grouped into trips, so this kernel groups them
// as suits it.  Per lane, over frames t < min(enc_lens[b], T):
//
//     logits = W_out . tanh(enc_proj[t] + dec_proj) + b_out      (joiner)
//     y      = argmax(logits), the first maximum
//     emit iff y is not blankish (blank, unk = 2, and sos = 1 with
//              skip_sos) and the token buffer is not full; then
//              tokens[count] = y, timestamps[count] = frame_offset + t,
//              count += 1, trailing = 0, hyp shifts y in, and
//     dec_proj = decoder_proj(relu(sum_c tables[c][hyp[c]]))      (refresh)
//     else trailing += 1.
//
// bf16 (dtype 1) rounds where ops/layers.apply_linear and joiner.joint_logits
// round: enc_proj + dec_proj to bf16, tanh to bf16, the product accumulated
// in float32 and rounded to bf16, the bias added in float32 and rounded again;
// the argmax is over those bf16 values.  The refresh rounds the decoder output
// to bf16 before its product, and the product and the sum with the bias the
// same way.  float32 (dtype 0) is float32 throughout.
//
// Design.  Lanes are independent, so one block of 512 threads per lane
// loops over its frames with all state in shared memory and registers.  Per
// tile of 16 frames it stages tanh(enc + dec) in shared memory and multiplies
// it by W_out in n-tiles of 8 columns: on the tensor cores for bf16
// (mma.sync m16n8k16, A by ldmatrix, B pre-packed in fragment order by
// greedy_operands so that a warp reads 256 contiguous bytes per fragment) and
// on the CUDA cores for float32 (tensor cores would round to TF32).  Each
// thread keeps a running (max, first index) per row, reduced across the
// block, so no [16, V] logits reach memory.  At the first frame of the tile
// whose argmax is not blankish the lane emits, refreshes dec_proj (a gather
// of the folded context tables and a GEMV over decoder_proj split 8 columns
// by D/parts rows per thread), and starts the next tile at the frame after
// it; a tile with no candidate is consumed as blanks.  The loops that read
// device memory are unrolled so that several loads are in flight per thread
// (a step is a chain of L2 round trips); the order of each thread's sums
// does not change.
//
// What bounds it on an H100.  The minimum work is one joiner row per valid
// frame (2 J V flops) and one refresh per emission (2 D J flops); the
// minimum bytes are the valid frames, the weights once, the table rows the
// emissions gather and 16 bytes per emission: ~13 MB for a bf16 16 x 30 s
// batch, ~4 us at 3.35 TB/s, against ~13 us of tensor-core time.  The
// kernel is far from that: each emission is a dependent step (the next
// frame's logits need the refreshed decoder), so a lane is a chain of ~one
// tile and one refresh per emitted token, each re-reading W_out and
// decoder_proj (1 MB in bf16 at J = D = 512, V = 500) from L2 on one SM.
// With random weights, which emit on almost every frame, 15 of a tile's 16
// rows are recomputed after the emission.  Only B of the 132 SMs work.
// Splitting V over a cluster of blocks, keeping the weights in the
// cluster's shared memory, and sizing the tile by the emission rate are
// later work.

#include "relpos_scores.cuh"  // relpos::allow_smem

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // frames per tile: the mma's M
constexpr int kNT = 4;     // n-tiles a warp multiplies per A fragment
constexpr int kMaxCtx = 8;
constexpr int kMaxJ = 1024;
constexpr int kMaxD = 1024;

struct Args {
  const void* enc;            // [B, T, J] enc_proj
  const long long* lens;      // [B]
  const long long* offset;    // [B] frame_offset
  const float* tables;        // [C, V, D] folded context tables
  const void* dec_w;          // [D, Jp] decoder_proj.w (bf16 or float32)
  const float* dec_b;         // [Jp]
  const void* out_w;          // bf16: [Vp/8][Jp/16][32][4] fragments; f32: [Jp][Vp]
  const float* out_b;         // [Vp]
  const long long* hyp_in;    // [B, C]  the state the search starts from
  const void* dec_proj_in;    // [B, J]  (bf16 or float32)
  const long long* count_in;  // [B]
  const long long* trailing_in;  // [B]
  long long* hyp;             // [B, C]  the state it ends in
  void* dec_proj;             // [B, J]
  long long* count;           // [B]
  long long* trailing;        // [B]
  long long* tokens;          // [B, K]  updated in place: the new slots only
  long long* timestamps;      // [B, K]
  int T, J, Jp, D, V, Vp, C, K, blank, skip_sos;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (v, i) beats (bv, bi): a larger logit, or an equal one at a lower index —
// the first maximum, as torch.argmax takes it (a NaN counts as the maximum)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ bool blankish(int y, const Args& a) {
  return y == a.blank || y == 2 || (a.skip_sos && y == 1);
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

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory: floats dproj[Jp], dout[round4(D)], part[kThreads * 8],
// red_v[kWarps * kRows]; ints red_i[kWarps * kRows], ys[kRows]; then, 16-byte
// aligned, the tile: bf16 [kRows][Jp + 8] (8 elements of pad put ldmatrix's
// rows on distinct banks) or float32 [Jp][kRows] (a frame's 16 rows of one
// column side by side, read as float4s)
__host__ __device__ inline size_t head_bytes(int Jp, int D) {
  const size_t words = (size_t)Jp + round_up(D, 4) + kThreads * 8 + 2 * kWarps * kRows + kRows;
  return round_up((int)(words * 4), 16);
}

template <bool BF>
__host__ __device__ inline size_t smem_bytes(int Jp, int D) {
  return head_bytes(Jp, D) + (BF ? (size_t)kRows * (Jp + 8) * 2 : (size_t)Jp * kRows * 4);
}

// One tile's joiner on the tensor cores: this thread's best (logit, index)
// for rows lane / 4 and lane / 4 + 8 over its columns.
__device__ __forceinline__ void tile_logits_bf16(const Args& a, const bf16* sA, float (&bv)[2],
                                                 int (&bi)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  const int KS = a.Jp / 16, NT = a.Vp / 8, AS = a.Jp + 8;
  const uint2* W = static_cast<const uint2*>(a.out_w);
  for (int nt0 = warp * kNT; nt0 < NT; nt0 += kWarps * kNT) {
    float acc[kNT][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, sA + (lane & 15) * AS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        if (nt0 + q < NT) {
          const uint2 w = __ldg(W + ((size_t)(nt0 + q) * KS + ks) * 32 + lane);
          mma_bf16(acc[q], af, w.x, w.y);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (nt0 + q) * 8 + 2 * tig + (e & 1);
        if (nt0 + q < NT && col < a.V) {
          const float logit = bf16_round(bf16_round(acc[q][e]) + a.out_b[col]);
          if (better(logit, col, bv[e >> 1], bi[e >> 1])) {
            bv[e >> 1] = logit;
            bi[e >> 1] = col;
          }
        }
      }
    }
  }
}

// One tile's joiner on the CUDA cores: this thread's best per row over its
// columns v = threadIdx.x + k * kThreads, each an in-order sum over J.
__device__ __forceinline__ void tile_logits_f32(const Args& a, const float* sAt,
                                                float (&bv)[kRows], int (&bi)[kRows]) {
  const float* W = static_cast<const float*>(a.out_w);
  for (int v = threadIdx.x; v < a.V; v += kThreads) {
    float acc[kRows] = {};
#pragma unroll 4
    for (int j = 0; j < a.J; ++j) {
      const float w = __ldg(W + (size_t)j * a.Vp + v);
      const float4* x = reinterpret_cast<const float4*>(sAt + j * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 xv = x[r4];
        acc[4 * r4 + 0] = fmaf(xv.x, w, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(xv.y, w, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(xv.z, w, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(xv.w, w, acc[4 * r4 + 3]);
      }
    }
    const float bias = a.out_b[v];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float logit = acc[r] + bias;
      if (better(logit, v, bv[r], bi[r])) {
        bv[r] = logit;
        bi[r] = v;
      }
    }
  }
}

__device__ __forceinline__ void shfl_best(float& v, int& i, int offset) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, offset);
  const int oi = __shfl_xor_sync(0xffffffffu, i, offset);
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1) rnnt_greedy_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dproj = reinterpret_cast<float*>(smem);
  float* dout = dproj + a.Jp;
  float* part = dout + round_up(a.D, 4);
  float* red_v = part + kThreads * 8;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kRows);
  int* ys = red_i + kWarps * kRows;
  unsigned char* tile = smem + head_bytes(a.Jp, a.D);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = (int)min(max(a.lens[b], 0LL), (long long)a.T);
  const long long offset = a.offset[b];
  for (int j = tid; j < a.Jp; j += kThreads) {
    float x = 0.f;
    if (j < a.J) {
      const size_t at = (size_t)b * a.J + j;
      x = BF ? __bfloat162float(static_cast<const bf16*>(a.dec_proj_in)[at])
             : static_cast<const float*>(a.dec_proj_in)[at];
    }
    dproj[j] = x;
  }
  int hyp[kMaxCtx];
#pragma unroll
  for (int c = 0; c < kMaxCtx; ++c) hyp[c] = c < a.C ? (int)a.hyp_in[(size_t)b * a.C + c] : 0;
  long long count = a.count_in[b], trailing = a.trailing_in[b];
  __syncthreads();

  int t = 0;
  while (t < len) {
    if (count >= a.K) {  // a full buffer: every frame left counts as a blank
      trailing += len - t;
      break;
    }
    const int rows = min(kRows, len - t);
    // stage the joiner's input for frames t .. t + rows - 1 (zeros past them)
    if (BF) {
      bf16* sA = reinterpret_cast<bf16*>(tile);
      const bf16* enc = static_cast<const bf16*>(a.enc) + ((size_t)b * a.T + t) * a.J;
#pragma unroll 4
      for (int i = tid; i < kRows * a.Jp; i += kThreads) {
        const int r = i / a.Jp, j = i - r * a.Jp;
        float x = 0.f;
        if (r < rows && j < a.J)
          x = tanhf(bf16_round(__bfloat162float(enc[(size_t)r * a.J + j]) + dproj[j]));
        sA[r * (a.Jp + 8) + j] = __float2bfloat16_rn(x);
      }
    } else {
      float* sAt = reinterpret_cast<float*>(tile);
      const float* enc = static_cast<const float*>(a.enc) + ((size_t)b * a.T + t) * a.J;
#pragma unroll 4
      for (int i = tid; i < kRows * a.Jp; i += kThreads) {
        const int r = i % kRows, j = i / kRows;
        sAt[i] = (r < rows && j < a.J) ? tanhf(enc[(size_t)r * a.J + j] + dproj[j]) : 0.f;
      }
    }
    __syncthreads();

    // each row's first maximum: per thread, per warp, then over the warps
    if (BF) {
      float bv[2] = {-INFINITY, -INFINITY};
      int bi[2] = {INT_MAX, INT_MAX};
      tile_logits_bf16(a, reinterpret_cast<const bf16*>(tile), bv, bi);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        shfl_best(bv[r], bi[r], 1);
        shfl_best(bv[r], bi[r], 2);
      }
      if ((lane & 3) == 0) {
        const int gid = lane >> 2;
        red_v[warp * kRows + gid] = bv[0];
        red_i[warp * kRows + gid] = bi[0];
        red_v[warp * kRows + gid + 8] = bv[1];
        red_i[warp * kRows + gid + 8] = bi[1];
      }
    } else {
      float bv[kRows];
      int bi[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bv[r] = -INFINITY;
        bi[r] = INT_MAX;
      }
      tile_logits_f32(a, reinterpret_cast<const float*>(tile), bv, bi);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        for (int o = 16; o > 0; o >>= 1) shfl_best(bv[r], bi[r], o);
        if (lane == 0) {
          red_v[warp * kRows + r] = bv[r];
          red_i[warp * kRows + r] = bi[r];
        }
      }
    }
    __syncthreads();
    if (tid < kRows) {
      float v = red_v[tid];
      int i = red_i[tid];
      for (int w = 1; w < kWarps; ++w)
        if (better(red_v[w * kRows + tid], red_i[w * kRows + tid], v, i)) {
          v = red_v[w * kRows + tid];
          i = red_i[w * kRows + tid];
        }
      ys[tid] = i;
    }
    __syncthreads();

    int f = -1;  // the tile's first candidate
    for (int r = 0; r < rows; ++r)
      if (!blankish(ys[r], a)) {
        f = r;
        break;
      }
    if (f < 0) {  // the whole tile is blank
      trailing += rows;
      t += rows;
      continue;
    }
    const int y = ys[f];
    if (tid == 0) {
      a.tokens[(size_t)b * a.K + count] = y;
      a.timestamps[(size_t)b * a.K + count] = offset + t + f;
    }
    ++count;
    trailing = 0;
#pragma unroll
    for (int c = 0; c + 1 < kMaxCtx; ++c)
      if (c + 1 < a.C) hyp[c] = hyp[c + 1];
#pragma unroll
    for (int c = 0; c < kMaxCtx; ++c)
      if (c == a.C - 1) hyp[c] = y;

    // refresh: dout = relu(sum_c tables[c][hyp[c]]), then decoder_proj
    for (int d = tid; d < a.D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCtx; ++c) {
        if (c < a.C) {
          const int h = hyp[c] < 0 ? a.blank : hyp[c];
          const float x = a.tables[((size_t)c * a.V + h) * a.D + d];
          s = c == 0 ? x : s + x;
        }
      }
      s = fmaxf(s, 0.f);
      dout[d] = BF ? bf16_round(s) : s;
    }
    __syncthreads();
    {
      const int nch = a.Jp / 8, parts = kThreads / nch;
      const int chunk = tid % nch, p = tid / nch;
      if (p < parts) {
        float acc[8] = {};
#pragma unroll 4
        for (int d = p; d < a.D; d += parts) {
          const float x = dout[d];
          float w[8];
          if (BF) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                static_cast<const bf16*>(a.dec_w) + (size_t)d * a.Jp + chunk * 8);
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f2 = __bfloat1622float2(h2[e]);
              w[2 * e] = f2.x;
              w[2 * e + 1] = f2.y;
            }
          } else {
            const float4* src = reinterpret_cast<const float4*>(
                static_cast<const float*>(a.dec_w) + (size_t)d * a.Jp + chunk * 8);
            const float4 w0 = src[0], w1 = src[1];
            w[0] = w0.x, w[1] = w0.y, w[2] = w0.z, w[3] = w0.w;
            w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(x, w[e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) part[p * a.Jp + chunk * 8 + e] = acc[e];
      }
      __syncthreads();
      for (int j = tid; j < a.J; j += kThreads) {
        float s = 0.f;
        for (int q = 0; q < parts; ++q) s += part[q * a.Jp + j];
        dproj[j] = BF ? bf16_round(bf16_round(s) + a.dec_b[j]) : s + a.dec_b[j];
      }
      __syncthreads();
    }
    t += f + 1;
  }

  for (int j = tid; j < a.J; j += kThreads) {
    const size_t at = (size_t)b * a.J + j;
    if (BF)
      static_cast<bf16*>(a.dec_proj)[at] = __float2bfloat16_rn(dproj[j]);
    else
      static_cast<float*>(a.dec_proj)[at] = dproj[j];
  }
  if (tid == 0) {
    for (int c = 0; c < a.C; ++c) a.hyp[(size_t)b * a.C + c] = hyp[c];
    a.count[b] = count;
    a.trailing[b] = trailing;
  }
}

template <bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<BF>(a.Jp, a.D);
  // set once per kernel and device, not per launch
  const cudaError_t err = relpos::allow_smem<rnnt_greedy_kernel<BF>>(smem, false);
  if (err != cudaSuccess) return err;
  rnnt_greedy_kernel<BF><<<B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (enc_proj, dec_proj and dec_w; the
// tables and biases are float32 either way).  out_w is [Jp][Vp] float32 or
// [Vp/8][Jp/16][32][4] bf16 (decode/rnnt_greedy.py::pack_mma_b), with
// Jp = J rounded up to 16 and Vp = V rounded up to 8, zero padded.  The
// search reads hyp, dec_proj, count and trailing from the *_in buffers and
// writes them to the others; it writes its emissions into tokens and
// timestamps in place.  Takes B, V, K >= 1, J, D <= 1024 and 1 <= C <= 8;
// returns the launch's cudaError_t (0 on success).
extern "C" int k2t_rnnt_greedy(const void* enc, const void* lens, const void* offset,
                               const void* tables, const void* dec_w, const void* dec_b,
                               const void* out_w, const void* out_b, const void* hyp_in,
                               const void* dec_proj_in, const void* count_in,
                               const void* trailing_in, void* hyp, void* dec_proj, void* count,
                               void* trailing, void* tokens, void* timestamps, int B, int T,
                               int J, int D, int V, int C, int K, int blank, int skip_sos,
                               int dtype, void* stream) {
  if (B < 1 || T < 0 || J < 1 || J > kMaxJ || D < 1 || D > kMaxD || V < 1 || C < 1 ||
      C > kMaxCtx || K < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{enc, static_cast<const long long*>(lens), static_cast<const long long*>(offset),
               static_cast<const float*>(tables), dec_w, static_cast<const float*>(dec_b),
               out_w, static_cast<const float*>(out_b), static_cast<const long long*>(hyp_in),
               dec_proj_in, static_cast<const long long*>(count_in),
               static_cast<const long long*>(trailing_in), static_cast<long long*>(hyp),
               dec_proj, static_cast<long long*>(count), static_cast<long long*>(trailing),
               static_cast<long long*>(tokens), static_cast<long long*>(timestamps), T, J,
               round_up(J, 16), D, V, round_up(V, 8), C, K, blank, skip_sos};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<true>(a, B, st) : launch<false>(a, B, st));
}
