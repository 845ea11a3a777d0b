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
// table pos_k [R = T+S-1, H, pd]; no [T, R] tensor is ever made.  Masks are
// key-side only, like the TPU kernel.  Two bodies, chosen by the operands'
// dtype inside the one exported function (no flag, no fallback):
//
// bfloat16 inputs: tensor cores, two passes over key tiles.  The scores of
// a 64 x 64 tile come from the shared body in relpos_scores.cuh (mma.sync
// m16n8k16 with ldmatrix; the position term a 16 x 80 product per warp read
// back skewed; see its note for the tile design and why mma.sync).  Pass 1
// runs it over every key tile and keeps only each row's running max and sum
// in registers; pass 2 recomputes each tile and writes exp(score - max) /
// sum.  Recomputing doubles the products, which the tensor cores absorb;
// in exchange no score row lives in shared memory, so any S runs.  Each
// warp's 16 x 64 probs tile is staged through its shared scratch, so that
// consecutive lanes store consecutive columns of one row (2-byte stores:
// rows of [B, H, T, S] start 16-byte aligned only when S % 8 == 0, and the
// flagship's S = 383 is odd; on an H100 these beat aligned 4-byte pairs
// with a scalar head, whose strided scratch reads cost more than the
// stores save).  k and pos_k tiles are double-buffered: tile
// n+1 loads while tile n computes, by cp.async of 16 bytes where the rows
// allow it (widths that are multiples of 8), else of 4 bytes (even widths,
// as zipformer2's pd = 4), else plain element loads (odd widths), chosen at
// launch by template per operand group; the zero pad columns are written
// once.
//
// float32 inputs: the CUDA-core body below (tensor cores would round f32 to
// TF32, which the exact float32 paths on the card forbid).  One block of 256
// threads per (b, h, `rows` <= 8 query rows), over tiles of 256 keys: each
// thread scores one key of the tile for every row (the tile's pos_k rows
// staged in shared memory), then one warp per row writes the raw scores to
// its output row, coalesced, and folds them into the row's running max and
// sum.  A second pass reads the row back and rescales it in place to
// exp(score - max) / sum.  Each score is computed once, and shared memory
// holds one tile, not whole score rows, so any S runs, with pd up to 64;
// the price is one more write and read of the float32 probs, which the
// scores' FMAs outweigh.  Its output is float32; the wrapper casts for a
// bf16 output.  Its pos dot runs as pd float32 FMAs in order, as the TPU
// kernel's pos_vpu path does.
//
// What bounds it on an H100: writing the probs.  A call reads 2*B*T*H*qd
// q/k values plus small pos tensors and writes B*H*T*S probs; at the
// flagship's stack-0 shape (B=16, T=S=1532, H=4, qd=32) that is ~300 MB of
// bf16 output against ~6 MB of input, ~0.09 ms at 3.35 TB/s.  The products
// are 2*B*H*T*S*(qd+pd) flops, far below the tensor-core roof.  The bf16
// body's own limit, by count, comes before the bytes: shared-memory
// traffic (the skew's scratch round trip, and pass 2's probs staging) and
// two exps per probability (one per pass).

#include "relpos_scores.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include <algorithm>

namespace {

namespace tc {

namespace rp = relpos;
using rp::bf16;

struct Args {
  const bf16 *q, *k, *pq, *pk;
  const int *lens, *kv_start;
  void* out;
  int out_f32, T, S, H, qd, pd, chunk, left;
};

// One key tile's scores sc through pass 1 (i < n_tiles: the rows' running
// max and sum) or pass 2 (exp(score - max) / sum written out, through the
// warp's scratch mw)
__device__ __forceinline__ void passes(const Args& a, int i, int n_tiles, int s0,
                                       float (&sc)[8][4], float (&m_run)[2], float (&l_part)[2],
                                       float (&inv_l)[2], float* mw, int b, int h, int t0,
                                       int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int T = a.T, S = a.S;
  constexpr int kBK = rp::kBK;
  if (i < n_tiles) {
    // pass 1: running max and sum; fragment row r is sc[j][2r], sc[j][2r+1]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = rp::quad_max(mx);  // finite: key s0 < S is in every tile
      float l = l_part[r] * exp2f((m_run[r] - mx) * rp::kLog2e);  // 0 on the first tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) l += exp2f((sc[j][2 * r + e] - mx) * rp::kLog2e);
      m_run[r] = mx;
      l_part[r] = l;
    }
  } else {
    if (i == n_tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / rp::quad_sum(l_part[r]);
    }
    // pass 2: exp(score - max) / sum, through the scratch
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f((sc[j][2 * r] - m_run[r]) * rp::kLog2e) * inv_l[r];
        const float p1 = exp2f((sc[j][2 * r + 1] - m_run[r]) * rp::kLog2e) * inv_l[r];
        *reinterpret_cast<float2*>(mw + (gid + 8 * r) * rp::kMwStride + 8 * j + 2 * tig) =
            make_float2(p0, p1);
      }
    __syncwarp();
    // row rr of the warp, columns lane and lane + 32
    const long long first = (((long long)b * a.H + h) * T + t0 + 16 * warp) * S + s0;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      if (t0 + 16 * warp + rr >= T) break;
#pragma unroll
      for (int c = lane; c < kBK; c += 32) {
        if (s0 + c >= S) break;
        const float x = mw[rr * rp::kMwStride + c];
        if (a.out_f32)
          static_cast<float*>(a.out)[first + rr * S + c] = x;
        else
          static_cast<bf16*>(a.out)[first + rr * S + c] = __float2bfloat16_rn(x);
      }
    }
    __syncwarp();  // the scratch is free for the next tile's position term
  }
}

// QD, PD: q and pos widths, zero-padded in shared memory.  QV, PV:
// elements per copy (stage()) of q and k rows, and of pos_q and pos_k rows.
template <int QD, int PD, int QV, int PV>
__global__ void __launch_bounds__(rp::kThreads, 2) relpos_attn_probs_tc(const Args a) {
  constexpr int REQ = rp::row_elems<QD>(), REP = rp::row_elems<PD>();
  constexpr int kBQ = rp::kBQ, kBK = rp::kBK, kWin = rp::kWin;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);  // [kWarps][16][kMwStride]
  bf16* sQ = reinterpret_cast<bf16*>(smem);         // [kBQ][REQ], aliases the scratch
  bf16* sPQ = sQ + kBQ * REQ;                       // [kBQ][REP], until the fragments load
  bf16* sK = reinterpret_cast<bf16*>(smem + sizeof(float) * rp::kScratchFloats);  // [2][kBK][REQ]
  bf16* sPK = sK + 2 * kBK * REQ;  // [2][kWin][REP] pos_k window of the tile

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int T = a.T, S = a.S;
  const long long q_stride = (long long)a.H * a.qd, p_stride = (long long)a.H * a.pd;
  // row t of (b, h) at base + t * stride
  const bf16* qb = a.q + ((long long)b * T * a.H + h) * a.qd;
  const bf16* kb = a.k + ((long long)b * S * a.H + h) * a.qd;
  const bf16* pqb = a.pq + ((long long)b * T * a.H + h) * a.pd;
  const bf16* pkb = a.pk + (long long)h * a.pd;

  auto stage_tile = [&](int buf, int s0) {
    rp::stage<QD, QV, kBK>(sK + buf * kBK * REQ, kb, q_stride, s0, 0, S, a.qd);
    rp::stage<PD, PV, kWin>(sPK + buf * kWin * REP, pkb, p_stride,
                            rp::pos_window_first(T, t0, s0), 0, T + S - 1, a.pd);
  };
  rp::zero_columns<QD>(sQ, kBQ, a.qd);
  rp::zero_columns<PD>(sPQ, kBQ, a.pd);
  rp::zero_columns<QD>(sK, 2 * kBK, a.qd);
  rp::zero_columns<PD>(sPK, 2 * kWin, a.pd);
  rp::stage<QD, QV, kBQ>(sQ, qb, q_stride, t0, 0, T, a.qd);
  rp::stage<PD, PV, kBQ>(sPQ, pqb, p_stride, t0, 0, T, a.pd);
  rp::cp_async_commit();
  stage_tile(0, 0);
  rp::cp_async_commit();
  rp::cp_async_wait<1>();  // the query rows
  __syncthreads();
  uint32_t qa[QD / 16][4], pa[PD / 16][4];
  rp::load_rows<QD>(qa, sQ, warp, lane);
  rp::load_rows<PD>(pa, sPQ, warp, lane);
  __syncthreads();  // the scratch is free

  const rp::KeyMask mask(S, a.lens, a.kv_start, b, a.chunk, a.left, t0 + 16 * warp + gid);
  float* mw = scratch + warp * 16 * rp::kMwStride;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};

  // steps 0 .. n_tiles-1: pass 1; n_tiles .. 2*n_tiles-1: pass 2, same tiles
  const int n_tiles = (S + kBK - 1) / kBK;
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const int s0 = (i < n_tiles ? i : i - n_tiles) * kBK, buf = i & 1;
    if (i + 1 < 2 * n_tiles) stage_tile(buf ^ 1, (i + 1 < n_tiles ? i + 1 : i + 1 - n_tiles) * kBK);
    rp::cp_async_commit();
    rp::cp_async_wait<1>();  // step i's tile has landed
    __syncthreads();

    float sc[8][4];
    const bf16* win = sPK + buf * kWin * REP;
    rp::masked_scores<QD, PD>(sc, qa, pa, sK + buf * kBK * REQ, win, win + kBK * REP, mw, warp,
                              lane, s0, mask);

    passes(a, i, n_tiles, s0, sc, m_run, l_part, inv_l, mw, b, h, t0, warp, lane);
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }
}

// Heads wider than 64 (qd or pd): the same two passes, each key tile's
// scores summed over the 64-wide chunks of q . k and of pos_q . pos_k
// (rp::kChunk) into the same accumulators.  Every chunk of the block's q
// and pos_q rows stays in shared memory; each (tile, chunk) step stages one
// chunk of the key tile and of its pos_k window and waits for it (no double
// buffering: the narrow heads of every main path do not come here).
template <int QV, int PV>
__global__ void __launch_bounds__(rp::kThreads, 1) relpos_attn_probs_tc_wide(const Args a) {
  constexpr int RE = rp::row_elems<rp::kChunk>(), W = rp::kChunk;
  constexpr int kBQ = rp::kBQ, kBK = rp::kBK, kWin = rp::kWin;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = rp::chunks(a.qd), np = rp::chunks(a.pd), nc = max(nq, np);
  float* scratch = reinterpret_cast<float*>(smem);  // [kWarps][16][kMwStride]
  bf16* sQ = reinterpret_cast<bf16*>(smem + sizeof(float) * rp::kScratchFloats);  // [nq][kBQ][RE]
  bf16* sPQ = sQ + nq * kBQ * RE;  // [np][kBQ][RE]
  bf16* sK = sPQ + np * kBQ * RE;  // [kBK][RE] a chunk of the key tile
  bf16* sPK = sK + kBK * RE;       // [kWin][RE] a chunk of its pos_k window

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.T, S = a.S;
  const long long q_stride = (long long)a.H * a.qd, p_stride = (long long)a.H * a.pd;
  const bf16* qb = a.q + ((long long)b * T * a.H + h) * a.qd;
  const bf16* kb = a.k + ((long long)b * S * a.H + h) * a.qd;
  const bf16* pqb = a.pq + ((long long)b * T * a.H + h) * a.pd;
  const bf16* pkb = a.pk + (long long)h * a.pd;

  rp::stage_query_chunks<QV>(sQ, qb, q_stride, t0, T, a.qd);
  rp::stage_query_chunks<PV>(sPQ, pqb, p_stride, t0, T, a.pd);
  rp::cp_async_commit();

  const rp::KeyMask mask(S, a.lens, a.kv_start, b, a.chunk, a.left, t0 + 16 * warp + (lane >> 2));
  float* mw = scratch + warp * 16 * rp::kMwStride;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  const int n_tiles = (S + kBK - 1) / kBK;
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const int s0 = (i < n_tiles ? i : i - n_tiles) * kBK;
    float sc[8][4], m[10][4];
    rp::zero_acc(sc);
    rp::zero_acc(m);
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // every warp is done with the last chunk
      if (c < nq) rp::stage_chunk<QV, kBK>(sK, kb, q_stride, s0, 0, S, a.qd, c);
      if (c < np)
        rp::stage_chunk<PV, kWin>(sPK, pkb, p_stride, rp::pos_window_first(T, t0, s0), 0,
                                  T + S - 1, a.pd, c);
      rp::cp_async_commit();
      rp::cp_async_wait<0>();
      __syncthreads();
      if (c < nq) {
        uint32_t qa[W / 16][4];
        rp::load_rows<W>(qa, sQ + c * kBQ * RE, warp, lane);
        rp::qk_products<W>(sc, qa, sK, lane);
      }
      if (c < np) {
        uint32_t pa[W / 16][4];
        rp::load_rows<W>(pa, sPQ + c * kBQ * RE, warp, lane);
        rp::pos_products<W>(m, pa, sPK, sPK + kBK * RE, warp, lane);
      }
    }
    rp::skew_and_mask(sc, m, mw, lane, s0, mask);
    passes(a, i, n_tiles, s0, sc, m_run, l_part, inv_l, mw, b, h, t0, warp, lane);
  }
}

template <int QD, int PD, int QV, int PV>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int REQ = rp::row_elems<QD>(), REP = rp::row_elems<PD>();
  static_assert(rp::kBQ * (REQ + REP) * sizeof(bf16) <= sizeof(float) * rp::kScratchFloats,
                "the query rows are staged in the scratch");
  constexpr size_t smem = sizeof(float) * rp::kScratchFloats +
                          sizeof(bf16) * (2 * rp::kBK * REQ + 2 * rp::kWin * REP);
  // all of the SM's L1 as shared memory, or fewer blocks fit an SM
  const cudaError_t err = rp::allow_smem<relpos_attn_probs_tc<QD, PD, QV, PV>>(smem, true);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + rp::kBQ - 1) / rp::kBQ, a.H, B);
  relpos_attn_probs_tc<QD, PD, QV, PV><<<grid, rp::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QD, int PD>
cudaError_t launch_widths(const Args& a, int B, cudaStream_t stream) {
  const int qv = std::min(rp::copy_elems(a.qd, a.q), rp::copy_elems(a.qd, a.k));
  const int pv = std::min(rp::copy_elems(a.pd, a.pq), rp::copy_elems(a.pd, a.pk));
  return rp::with_copy_widths(qv, pv, [&](auto QV, auto PV) {
    return launch<QD, PD, decltype(QV)::value, decltype(PV)::value>(a, B, stream);
  });
}

template <int QD>
cudaError_t launch_pd(const Args& a, int B, cudaStream_t stream) {
  if (a.pd <= 16) return launch_widths<QD, 16>(a, B, stream);
  return launch_widths<QD, 64>(a, B, stream);
}

size_t wide_smem(int qd, int pd) {
  return sizeof(float) * rp::kScratchFloats +
         sizeof(bf16) * rp::row_elems<rp::kChunk>() *
             ((rp::chunks(qd) + rp::chunks(pd)) * rp::kBQ + rp::kBK + rp::kWin);
}

template <int QV, int PV>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = wide_smem(a.qd, a.pd);
  const cudaError_t err = rp::allow_smem<relpos_attn_probs_tc_wide<QV, PV>>(smem, true);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + rp::kBQ - 1) / rp::kBQ, a.H, B);
  relpos_attn_probs_tc_wide<QV, PV><<<grid, rp::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const Args& a, int B, cudaStream_t stream) {
  if (a.qd > 64 || a.pd > 64) {
    const int qv = std::min(rp::copy_elems(a.qd, a.q), rp::copy_elems(a.qd, a.k));
    const int pv = std::min(rp::copy_elems(a.pd, a.pq), rp::copy_elems(a.pd, a.pk));
    return rp::with_copy_widths(qv, pv, [&](auto QV, auto PV) {
      return launch_wide<decltype(QV)::value, decltype(PV)::value>(a, B, stream);
    });
  }
  if (a.qd <= 16) return launch_pd<16>(a, B, stream);
  if (a.qd <= 32) return launch_pd<32>(a, B, stream);
  return launch_pd<64>(a, B, stream);
}

}  // namespace tc

namespace cuda_core {

constexpr float kNegInf = -1e9f;  // ops/layers.NEG_INF
constexpr int kMaxQd = 64;        // q row stride in shared memory
constexpr int kMaxPd = 64;        // pos_q row stride in shared memory
constexpr int kMaxRows = 8;       // query rows per block: one warp each
constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // keys per tile: one per thread

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) / 4 * 4; }

// must match _smem_bytes() in ops/attention_cuda.py
size_t smem_bytes(int rows, int pd) {
  return sizeof(float) * ((size_t)rows * kMaxQd + (size_t)rows * kMaxPd +
                          (size_t)(kTile + rows - 1) * round4(pd) + (size_t)rows * kTile);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1 for one row of a tile (a warp): the raw scores written to the
// output row, coalesced, and folded into its running max and sum
__device__ __forceinline__ void fold_row(const float* row, float* o, int s0, int S, int lane,
                                         float& m_run, float& l_run) {
  float mx = -INFINITY;
  for (int c = lane; c < kTile; c += 32) {
    mx = fmaxf(mx, row[c]);
    if (s0 + c < S) o[s0 + c] = row[c];
  }
  const float m_new = fmaxf(m_run, warp_max(mx));  // finite: key s0 < S is in the tile
  float sum = 0.f;
  for (int c = lane; c < kTile; c += 32) sum += expf(row[c] - m_new);
  l_run = l_run * expf(m_run - m_new) + warp_sum(sum);  // 0 on the first tile
  m_run = m_new;
}

// QD: register length of one key vector (qd <= QD, zero-padded).
template <int QD>
__global__ void __launch_bounds__(kThreads)
relpos_attn_probs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ pq, const float* __restrict__ pk,
                         const int* __restrict__ lens, const int* __restrict__ kv_start,
                         float* __restrict__ out, int T, int S, int H, int qd, int pd,
                         int chunk, int left, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);
  const int pd4 = round4(pd);
  const int n_pos = T + S - 1;       // rows of pos_k
  const int m_lo = T - t0 - nrows;   // pos_k row of (query t0 + nrows - 1, key 0)

  float* sq = smem;                  // [rows][kMaxQd]
  float* spq = sq + rows * kMaxQd;   // [rows][kMaxPd]
  float* spk = spq + rows * kMaxPd;  // [kTile + rows - 1][pd4]: the tile's pos_k rows
  float* sc = spk + (kTile + rows - 1) * pd4;  // [rows][kTile] the tile's scores

  for (int i = threadIdx.x; i < rows * kMaxQd; i += blockDim.x) {
    const int r = i / kMaxQd, d = i % kMaxQd;
    sq[i] = (r < nrows && d < qd)
                ? q[(((size_t)b * T + t0 + r) * H + h) * qd + d] : 0.f;
  }
  for (int i = threadIdx.x; i < rows * kMaxPd; i += blockDim.x) {
    const int r = i / kMaxPd, j = i % kMaxPd;
    spq[i] = (r < nrows && j < pd)
                 ? pq[(((size_t)b * T + t0 + r) * H + h) * pd + j] : 0.f;
  }

  const int limit = relpos::lane_limit(lens, b, S);
  const int start = relpos::lane_start(kv_start, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* o = out + (((size_t)b * H + h) * T + t0 + warp) * S;  // warp r's row r
  float m_run = -INFINITY, l_run = 0.f;  // its running max and sum
  // pass 1, tile by tile: score, write the raw scores to the row, fold them
  // into its running max and sum
  for (int s0 = 0; s0 < S; s0 += kTile) {
    __syncthreads();  // the last tile's pos rows and scores are free
    for (int x = threadIdx.x; x < (kTile + nrows - 1) * pd4; x += blockDim.x) {
      const int m = x / pd4, j = x % pd4, row = m_lo + s0 + m;
      spk[x] = (j < pd && row < n_pos) ? pk[((size_t)row * H + h) * pd + j] : 0.f;
    }
    __syncthreads();

    const int s = s0 + threadIdx.x;
    if (s < S) {
      float kr[QD];
      const float* kp = k + (((size_t)b * S + s) * H + h) * qd;
#pragma unroll
      for (int d = 0; d < QD; ++d) kr[d] = d < qd ? kp[d] : 0.f;
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
        const float4* pk4 =
            reinterpret_cast<const float4*>(spk + (nrows - 1 - r + threadIdx.x) * pd4);
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
        sc[r * kTile + threadIdx.x] = valid ? acc + m : kNegInf;
      }
    } else {
      for (int r = 0; r < nrows; ++r) sc[r * kTile + threadIdx.x] = -INFINITY;  // no key
    }
    __syncthreads();

    if (warp < nrows) fold_row(sc + warp * kTile, o, s0, S, lane, m_run, l_run);
  }
  // pass 2: exp(score - max) / sum in place; each lane reads back only the
  // columns it wrote (s = lane mod 32, as kTile is a multiple of 32)
  if (warp < nrows)
    for (int s = lane; s < S; s += 32) o[s] = expf(o[s] - m_run) / l_run;
}

template <int QD>
cudaError_t launch(const float* q, const float* k, const float* pq, const float* pk,
                   const int* lens, const int* kv_start, float* out, int B, int T, int S,
                   int H, int qd, int pd, int chunk, int left, int rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, pd);
  const cudaError_t err = relpos::allow_smem<relpos_attn_probs_kernel<QD>>(smem, false);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + rows - 1) / rows, H, B);
  relpos_attn_probs_kernel<QD><<<grid, kThreads, smem, stream>>>(
      q, k, pq, pk, lens, kv_start, out, T, S, H, qd, pd, chunk, left, rows);
  return cudaGetLastError();
}

// Heads wider than 64 (qd or pd): the same passes over 64-wide chunks.  The
// block's q and pos_q rows sit whole in shared memory ([rows][64 nq] and
// [rows][64 np]); a thread takes its key 64 values at a time in registers,
// and the tile's pos_k rows are staged 64 columns at a time; each row's two
// sums run on across the chunks in column order.
size_t wide_smem_bytes(int rows, int qd, int pd) {
  return sizeof(float) * ((size_t)rows * 64 * (size_t)((qd + 63) / 64 + (pd + 63) / 64) +
                          (size_t)(kTile + rows - 1) * 64 + (size_t)rows * kTile);
}

__global__ void __launch_bounds__(kThreads)
relpos_attn_probs_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ pq, const float* __restrict__ pk,
                       const int* __restrict__ lens, const int* __restrict__ kv_start,
                       float* __restrict__ out, int T, int S, int H, int qd, int pd, int chunk,
                       int left, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);
  const int nq = (qd + 63) / 64, np = (pd + 63) / 64, qw = 64 * nq, pw = 64 * np;
  const int n_pos = T + S - 1, m_lo = T - t0 - nrows;
  float* sq = smem;                            // [rows][qw]
  float* spq = sq + rows * qw;                 // [rows][pw]
  float* spk = spq + rows * pw;                // [kTile + rows - 1][64] a chunk of pos_k rows
  float* sc = spk + (kTile + rows - 1) * 64;   // [rows][kTile] the tile's scores

  for (int i = threadIdx.x; i < rows * qw; i += blockDim.x) {
    const int r = i / qw, d = i % qw;
    sq[i] = (r < nrows && d < qd) ? q[(((size_t)b * T + t0 + r) * H + h) * qd + d] : 0.f;
  }
  for (int i = threadIdx.x; i < rows * pw; i += blockDim.x) {
    const int r = i / pw, j = i % pw;
    spq[i] = (r < nrows && j < pd) ? pq[(((size_t)b * T + t0 + r) * H + h) * pd + j] : 0.f;
  }

  const int limit = relpos::lane_limit(lens, b, S);
  const int start = relpos::lane_start(kv_start, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* o = out + (((size_t)b * H + h) * T + t0 + warp) * S;
  float m_run = -INFINITY, l_run = 0.f;
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int s = s0 + threadIdx.x;
    float acc[kMaxRows], mp[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = mp[r] = 0.f;
    if (s < S) {
      const float* kp = k + (((size_t)b * S + s) * H + h) * qd;
      for (int c = 0; c < nq; ++c) {
        float kr[64];
#pragma unroll
        for (int d = 0; d < 64; ++d) kr[d] = 64 * c + d < qd ? kp[64 * c + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r >= nrows) break;
          const float4* q4 = reinterpret_cast<const float4*>(sq + r * qw + 64 * c);
#pragma unroll
          for (int d4 = 0; d4 < 16; ++d4) {
            const float4 v = q4[d4];
            acc[r] = fmaf(v.x, kr[4 * d4 + 0], acc[r]);
            acc[r] = fmaf(v.y, kr[4 * d4 + 1], acc[r]);
            acc[r] = fmaf(v.z, kr[4 * d4 + 2], acc[r]);
            acc[r] = fmaf(v.w, kr[4 * d4 + 3], acc[r]);
          }
        }
      }
    }
    for (int c = 0; c < np; ++c) {
      __syncthreads();  // the last chunk's pos rows and the last tile's scores are read
      for (int x = threadIdx.x; x < (kTile + nrows - 1) * 64; x += blockDim.x) {
        const int m = x / 64, j = 64 * c + x % 64, row = m_lo + s0 + m;
        spk[x] = (j < pd && row < n_pos) ? pk[((size_t)row * H + h) * pd + j] : 0.f;
      }
      __syncthreads();
      if (s < S) {
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r >= nrows) break;
          // skew: query t0+r, key s -> pos_k row (T-1) - (t0+r) + s
          const float4* pk4 = reinterpret_cast<const float4*>(spk + (nrows - 1 - r + threadIdx.x) * 64);
          const float4* pq4 = reinterpret_cast<const float4*>(spq + r * pw + 64 * c);
#pragma unroll 4
          for (int j4 = 0; j4 < 16; ++j4) {
            const float4 x = pq4[j4], y = pk4[j4];
            mp[r] = fmaf(x.x, y.x, mp[r]);
            mp[r] = fmaf(x.y, y.y, mp[r]);
            mp[r] = fmaf(x.z, y.z, mp[r]);
            mp[r] = fmaf(x.w, y.w, mp[r]);
          }
        }
      }
    }
    const bool key_ok = s < S && s < limit && s >= start;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nrows) break;
      bool valid = key_ok;
      if (chunk > 0) {
        const int cs = ((t0 + r) / chunk) * chunk;
        valid = valid && s <= cs + chunk - 1 && s >= cs - left;
      }
      sc[r * kTile + threadIdx.x] = s >= S ? -INFINITY : (valid ? acc[r] + mp[r] : kNegInf);
    }
    __syncthreads();
    if (warp < nrows) fold_row(sc + warp * kTile, o, s0, S, lane, m_run, l_run);
  }
  if (warp < nrows)
    for (int s = lane; s < S; s += 32) o[s] = expf(o[s] - m_run) / l_run;
}

cudaError_t launch_wide(const float* q, const float* k, const float* pq, const float* pk,
                        const int* lens, const int* kv_start, float* out, int B, int T, int S,
                        int H, int qd, int pd, int chunk, int left, int rows,
                        cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(rows, qd, pd);
  const cudaError_t err = relpos::allow_smem<relpos_attn_probs_wide>(smem, false);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + rows - 1) / rows, H, B);
  relpos_attn_probs_wide<<<grid, kThreads, smem, stream>>>(q, k, pq, pk, lens, kv_start, out, T,
                                                            S, H, qd, pd, chunk, left, rows);
  return cudaGetLastError();
}

cudaError_t dispatch_qd(const float* q, const float* k, const float* pq, const float* pk,
                        const int* lens, const int* kv_start, float* out, int B, int T, int S,
                        int H, int qd, int pd, int chunk, int left, int rows,
                        cudaStream_t stream) {
  if (qd > kMaxQd || pd > kMaxPd)
    return launch_wide(q, k, pq, pk, lens, kv_start, out, B, T, S, H, qd, pd, chunk, left, rows,
                       stream);
  if (qd <= 32)
    return launch<32>(q, k, pq, pk, lens, kv_start, out, B, T, S, H, qd, pd, chunk, left, rows,
                      stream);
  return launch<kMaxQd>(q, k, pq, pk, lens, kv_start, out, B, T, S, H, qd, pd, chunk, left,
                        rows, stream);
}

}  // namespace cuda_core

// the widest q and pos heads either body takes (the bf16 chunked body's
// shared memory: 9 KB per 64-wide chunk of q or pos beside 49 KB)
constexpr int kMaxWidth = 512;

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  bfloat16 inputs run the
// tensor-core body (any S, either output dtype; `rows` unused), float32
// inputs the CUDA-core body (any S, `rows` <= 8 query rows per block,
// float32 output only).  Both take qd, pd <= kMaxWidth (512): heads wider
// than 64 run their bodies' chunked forms.  A null `lens` means
// every key is valid, a null `kv_start` means 0.  Returns the launch's
// cudaError_t (0 on success); the wrapper validates shapes, dtypes and
// these limits.
extern "C" int k2t_relpos_attn_probs(const void* q, const void* k, const void* pq,
                                     const void* pk, const void* lens, const void* kv_start,
                                     void* out, int B, int T, int S, int H, int qd, int pd,
                                     int chunk, int left, int rows, int in_dtype,
                                     int out_dtype, void* stream) {
  const int* ln = static_cast<const int*>(lens);
  const int* ks = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (qd < 1 || pd < 1 || qd > kMaxWidth || pd > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (in_dtype == 1) {
    using tc::bf16;
    const tc::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(pq), static_cast<const bf16*>(pk), ln, ks, out,
                     out_dtype == 0, T, S, H, qd, pd, chunk, left};
    return (int)tc::run(a, B, st);
  }
  if (in_dtype != 0 || out_dtype != 0 || rows <= 0 || rows > cuda_core::kMaxRows)
    return (int)cudaErrorInvalidValue;
  return (int)cuda_core::dispatch_qd(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(pq),
      static_cast<const float*>(pk), ln, ks, static_cast<float*>(out), B, T, S, H, qd, pd, chunk,
      left, rows, st);
}
