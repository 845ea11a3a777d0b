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
// tensor is written.  Two bodies, chosen by the operands' dtype inside the
// one exported function (no flag, no fallback between them):
//
// bfloat16 inputs: tensor cores, FlashAttention-2 style.  The scores of a
// 64 x 64 tile come from the shared body in relpos_scores.cuh (mma.sync
// m16n8k16, the position term as a 16 x 80 product per warp read back
// skewed; see its note for the tile design and why mma.sync).  Per row,
// a running max and sum stay in registers, quad-reduced with shuffles (four
// lanes share a row of the m16n8 layout); the accumulator is rescaled when
// the max grows.  The tile's unnormalised probabilities are rounded to bf16
// in registers, where the C fragments of two n-tiles are the A fragment of
// the next m16n8k16, and P.V runs on the tensor cores with V from shared
// memory by ldmatrix.trans.  The division by the row sum comes last.  k and
// v tiles are double-buffered: tile n+1 loads while tile n computes, by
// cp.async of 16 bytes where the rows allow it (qd, pd, vd multiples of 8),
// else of 4 bytes (even widths), else plain element loads (odd widths),
// chosen at launch by template per operand group; the zero pad columns are
// written once.  Key tile n reads the 128 pos_k rows of slabs n and n+1 (64
// rows each), kept in a ring of three, so each tile loads one new slab.
// Shared memory 85 KB at 64-wide heads (two blocks per SM).
//
// Rounding (bf16): the kernel rounds the UNNORMALISED probabilities to bf16
// before P.V; the plain version (and the TPU kernel) rounds the normalised
// ones.  Each side is within 2^-9 * max|v| of the exact product, so the two
// differ by at most 2^-8 * max|v| per output before its final rounding (one
// bf16 ulp): the check on the card states 2^-8 * max|v| + one ulp.
//
// float32 inputs: the CUDA-core body below, unchanged from the first port
// (tensor cores would round f32 to TF32, which the exact float32 paths on
// the card forbid).  One block of 256 threads per (b, h, 64 query rows),
// 4x4 micro-tiles of float4-broadcast outer products from shared memory,
// the probabilities kept in f32 through the product with v: the same
// function as the plain version up to summation order.
//
// What bounds it on an H100: operations.  A call does 2*B*H*T*S*(qd+pd+vd)
// flops and moves ~5*B*T*H*64 values; at the conformer flagship shape (B=16,
// T=S=767, H=8, 64-wide heads, bf16) that is 28.9 GFLOP against 64 MB:
// 0.029 ms at the bf16 tensor-core peak, 0.019 ms at 3.35 TB/s.  The bf16
// body's own limit, by count, is shared-memory traffic: each warp loads its
// own copy of the K, pos_k and V fragments by ldmatrix, and the skew makes
// a round trip through the scratch; then the exps (one per score).  The
// f32 body is shared-memory-bound on the CUDA cores (0.43 ms is its f32
// bound).

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
  const bf16 *q, *k, *pq, *pk, *v;
  const int *lens, *kv_start;
  void* out;
  int out_f32, T, S, H, qd, pd, vd, chunk, left;
};

// The online softmax over one key tile's scores sc (fragment row r of the
// thread is sc[j][2r], sc[j][2r+1]), then P (bf16, unnormalised) . V into
// acc, V the tile's [kBK][row_elems<DK>()] values in shared memory
template <int DK>
__device__ __forceinline__ void softmax_pv(float (&sc)[8][4], float (&m_run)[2],
                                           float (&l_part)[2], float (&acc)[DK / 8][4],
                                           const bf16* vt, int lane) {
  constexpr int RE = rp::row_elems<DK>(), kBK = rp::kBK;
  // online softmax; fragment row r of the thread is sc[j][2r], sc[j][2r+1]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_run[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    mx = rp::quad_max(mx);  // finite: key s0 < S is in every tile
    const float rescale = exp2f((m_run[r] - mx) * rp::kLog2e);  // 0 on the first tile
    m_run[r] = mx;
    l_part[r] *= rescale;
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      acc[c][2 * r] *= rescale;
      acc[c][2 * r + 1] *= rescale;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f((sc[j][2 * r + e] - mx) * rp::kLog2e);
        sc[j][2 * r + e] = p;
        l_part[r] += p;
      }
  }

  // P (bf16, unnormalised) . V: n-tiles 2kk and 2kk+1 of the scores are the
  // A fragment of keys 16kk .. 16kk+15
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t pf[4] = {rp::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                            rp::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                            rp::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                            rp::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DK / 16; ++np) {
      // lanes 0-7 keys 0-7 cols 0-7, 8-15 keys 8-15 cols 0-7, 16-23 keys
      // 0-7 cols 8-15, 24-31 keys 8-15 cols 8-15; transposed on the way
      uint32_t bv[4];
      rp::ldsm_x4_trans(bv, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RE +
                                16 * np + (lane >> 4) * 8);
      rp::mma_bf16(acc[2 * np], pf, bv[0], bv[1]);
      rp::mma_bf16(acc[2 * np + 1], pf, bv[2], bv[3]);
    }
  }
}

// ctx columns col0 + 8c + 2 tig + e (< vd) of the warp's rows: acc / row sum
template <int DK>
__device__ __forceinline__ void write_ctx(const Args& a, const float (&acc)[DK / 8][4],
                                          const float (&l_part)[2], int b, int h, int t0,
                                          int warp, int lane, int col0) {
  const int gid = lane >> 2, tig = lane & 3, T = a.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / rp::quad_sum(l_part[r]);
    const int t = t0 + 16 * warp + gid + 8 * r;
    if (t >= T) continue;
    const long long row = (((long long)b * T + t) * a.H + h) * a.vd;
#pragma unroll
    for (int c = 0; c < DK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * c + 2 * tig + e;
        if (col >= a.vd) continue;
        const float x = acc[c][2 * r + e] * inv;
        if (a.out_f32)
          static_cast<float*>(a.out)[row + col] = x;
        else
          static_cast<bf16*>(a.out)[row + col] = __float2bfloat16_rn(x);
      }
  }
}

// DK: q, pos and value widths, zero-padded to DK in shared memory.
// QV, PV: elements per copy (stage()) of q, k and v rows, and of pos_q and
// pos_k rows.
template <int DK, int QV, int PV>
__global__ void __launch_bounds__(rp::kThreads, 2) relpos_attn_ctx_tc(const Args a) {
  constexpr int RE = rp::row_elems<DK>();
  constexpr int kBQ = rp::kBQ, kBK = rp::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);  // [kWarps][16][kMwStride]
  bf16* sQ = reinterpret_cast<bf16*>(smem);         // [kBQ][RE], aliases the scratch
  bf16* sPQ = sQ + kBQ * RE;                        // [kBQ][RE], until the fragments load
  bf16* sK = reinterpret_cast<bf16*>(smem + sizeof(float) * rp::kScratchFloats);  // [2][kBK][RE]
  bf16* sPK = sK + 2 * kBK * RE;  // [3][kBK][RE] ring of pos_k slabs
  bf16* sV = sPK + 3 * kBK * RE;   // [2][kBK][RE]

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int T = a.T, S = a.S;
  const long long q_stride = (long long)a.H * a.qd, p_stride = (long long)a.H * a.pd,
                  v_stride = (long long)a.H * a.vd;
  // row t of (b, h) at base + t * stride
  const bf16* qb = a.q + ((long long)b * T * a.H + h) * a.qd;
  const bf16* kb = a.k + ((long long)b * S * a.H + h) * a.qd;
  const bf16* pqb = a.pq + ((long long)b * T * a.H + h) * a.pd;
  const bf16* pkb = a.pk + (long long)h * a.pd;
  const bf16* vb = a.v + ((long long)b * S * a.H + h) * a.vd;

  // Key tile n reads the pos_k window of 128 rows from win0 + n*kBK: slabs n
  // and n+1 of 64 rows, kept in a ring of three, so each tile loads one slab
  const int win0 = rp::pos_window_first(T, t0, 0);
  auto stage_slab = [&](int n) {
    rp::stage<DK, PV, kBK>(sPK + (n % 3) * kBK * RE, pkb, p_stride, win0 + n * kBK, 0, T + S - 1,
                           a.pd);
  };
  auto stage_tile = [&](int buf, int s0) {
    rp::stage<DK, QV, kBK>(sK + buf * kBK * RE, kb, q_stride, s0, 0, S, a.qd);
    rp::stage<DK, QV, kBK>(sV + buf * kBK * RE, vb, v_stride, s0, 0, S, a.vd);
  };
  rp::zero_columns<DK>(sQ, kBQ, a.qd);
  rp::zero_columns<DK>(sPQ, kBQ, a.pd);
  rp::zero_columns<DK>(sK, 2 * kBK, a.qd);
  rp::zero_columns<DK>(sPK, 3 * kBK, a.pd);
  rp::zero_columns<DK>(sV, 2 * kBK, a.vd);
  rp::stage<DK, QV, kBQ>(sQ, qb, q_stride, t0, 0, T, a.qd);
  rp::stage<DK, PV, kBQ>(sPQ, pqb, p_stride, t0, 0, T, a.pd);
  rp::cp_async_commit();
  stage_tile(0, 0);
  stage_slab(0);
  stage_slab(1);
  rp::cp_async_commit();
  rp::cp_async_wait<1>();  // the query rows
  __syncthreads();
  uint32_t qa[DK / 16][4], pa[DK / 16][4];
  rp::load_rows<DK>(qa, sQ, warp, lane);
  rp::load_rows<DK>(pa, sPQ, warp, lane);
  __syncthreads();  // the scratch is free

  const rp::KeyMask mask(S, a.lens, a.kv_start, b, a.chunk, a.left, t0 + 16 * warp + gid);
  float* mw = scratch + warp * 16 * rp::kMwStride;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = (S + kBK - 1) / kBK;
  for (int n = 0; n < n_tiles; ++n) {
    const int s0 = n * kBK, buf = n & 1;
    if (n + 1 < n_tiles) {
      stage_tile(buf ^ 1, s0 + kBK);
      stage_slab(n + 2);  // its slot held slab n-1, which tile n-1 was the last to read
    }
    rp::cp_async_commit();
    rp::cp_async_wait<1>();  // tile n has landed
    __syncthreads();

    float sc[8][4];
    rp::masked_scores<DK, DK>(sc, qa, pa, sK + buf * kBK * RE, sPK + (n % 3) * kBK * RE,
                              sPK + ((n + 1) % 3) * kBK * RE, mw, warp, lane, s0, mask);

    softmax_pv<DK>(sc, m_run, l_part, acc, sV + buf * kBK * RE, lane);
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }

  write_ctx<DK>(a, acc, l_part, b, h, t0, warp, lane, 0);
}

// Heads wider than 64 (qd, pd or vd): the scores of each key tile summed
// over the 64-wide chunks of q . k and of pos_q . pos_k (rp::kChunk) into
// the same accumulators, and P . V over one 64-wide column tile of v per
// block (grid.y = H x column tiles: each block recomputes its rows' scores).
// Every chunk of the block's q and pos_q rows stays in shared memory; each
// (tile, chunk) step stages one chunk of keys and of the pos_k window (and,
// at chunk 0, the tile's v columns) and waits for it.
template <int QV, int PV>
__global__ void __launch_bounds__(rp::kThreads, 1) relpos_attn_ctx_tc_wide(const Args a) {
  constexpr int RE = rp::row_elems<rp::kChunk>(), W = rp::kChunk;
  constexpr int kBQ = rp::kBQ, kBK = rp::kBK, kWin = rp::kWin;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = rp::chunks(a.qd), np = rp::chunks(a.pd), nc = max(nq, np);
  const int nvt = rp::chunks(a.vd);
  float* scratch = reinterpret_cast<float*>(smem);  // [kWarps][16][kMwStride]
  bf16* sQ = reinterpret_cast<bf16*>(smem + sizeof(float) * rp::kScratchFloats);  // [nq][kBQ][RE]
  bf16* sPQ = sQ + nq * kBQ * RE;  // [np][kBQ][RE]
  bf16* sK = sPQ + np * kBQ * RE;  // [kBK][RE] a chunk of the key tile
  bf16* sPK = sK + kBK * RE;       // [kWin][RE] a chunk of its pos_k window
  bf16* sV = sPK + kWin * RE;      // [kBK][RE] the tile's v columns of this block

  const int b = blockIdx.z, h = blockIdx.y / nvt, vt = blockIdx.y % nvt, t0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.T, S = a.S;
  const long long q_stride = (long long)a.H * a.qd, p_stride = (long long)a.H * a.pd,
                  v_stride = (long long)a.H * a.vd;
  const bf16* qb = a.q + ((long long)b * T * a.H + h) * a.qd;
  const bf16* kb = a.k + ((long long)b * S * a.H + h) * a.qd;
  const bf16* pqb = a.pq + ((long long)b * T * a.H + h) * a.pd;
  const bf16* pkb = a.pk + (long long)h * a.pd;
  const bf16* vb = a.v + ((long long)b * S * a.H + h) * a.vd + vt * W;
  const int wv = rp::chunk_width(a.vd, vt);

  rp::stage_query_chunks<QV>(sQ, qb, q_stride, t0, T, a.qd);
  rp::stage_query_chunks<PV>(sPQ, pqb, p_stride, t0, T, a.pd);
  rp::zero_columns<W>(sV, kBK, wv);  // every tile's v rows are wv wide
  rp::cp_async_commit();

  const rp::KeyMask mask(S, a.lens, a.kv_start, b, a.chunk, a.left, t0 + 16 * warp + (lane >> 2));
  float* mw = scratch + warp * 16 * rp::kMwStride;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  float acc[W / 8][4];
  rp::zero_acc(acc);
  const int n_tiles = (S + kBK - 1) / kBK;
  for (int n = 0; n < n_tiles; ++n) {
    const int s0 = n * kBK;
    float sc[8][4], m[10][4];
    rp::zero_acc(sc);
    rp::zero_acc(m);
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // every warp is done with the last chunk (and tile's values)
      if (c < nq) rp::stage_chunk<QV, kBK>(sK, kb, q_stride, s0, 0, S, a.qd, c);
      if (c < np)
        rp::stage_chunk<PV, kWin>(sPK, pkb, p_stride, rp::pos_window_first(T, t0, s0), 0,
                                  T + S - 1, a.pd, c);
      if (c == 0) rp::stage<W, QV, kBK>(sV, vb, v_stride, s0, 0, S, wv);
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
    softmax_pv<W>(sc, m_run, l_part, acc, sV, lane);
  }
  write_ctx<W>(a, acc, l_part, b, h, t0, warp, lane, vt * W);
}

template <int QV, int PV>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * rp::kScratchFloats +
                      sizeof(bf16) * rp::row_elems<rp::kChunk>() *
                          ((rp::chunks(a.qd) + rp::chunks(a.pd)) * rp::kBQ + 2 * rp::kBK + rp::kWin);
  const cudaError_t err = rp::allow_smem<relpos_attn_ctx_tc_wide<QV, PV>>(smem, true);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + rp::kBQ - 1) / rp::kBQ, a.H * rp::chunks(a.vd), B);
  relpos_attn_ctx_tc_wide<QV, PV><<<grid, rp::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DK, int QV, int PV>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int RE = rp::row_elems<DK>();
  static_assert(2 * rp::kBQ * RE * sizeof(bf16) <= sizeof(float) * rp::kScratchFloats,
                "the query rows are staged in the scratch");
  constexpr size_t smem = sizeof(float) * rp::kScratchFloats +
                          sizeof(bf16) * RE * (2 * rp::kBK + 3 * rp::kBK + 2 * rp::kBK);
  // all of the SM's L1 as shared memory, or fewer blocks fit an SM
  const cudaError_t err = rp::allow_smem<relpos_attn_ctx_tc<DK, QV, PV>>(smem, true);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + rp::kBQ - 1) / rp::kBQ, a.H, B);
  relpos_attn_ctx_tc<DK, QV, PV><<<grid, rp::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_widths(const Args& a, int B, cudaStream_t stream) {
  const int qv = std::min({rp::copy_elems(a.qd, a.q), rp::copy_elems(a.qd, a.k),
                           rp::copy_elems(a.vd, a.v)});
  const int pv = std::min(rp::copy_elems(a.pd, a.pq), rp::copy_elems(a.pd, a.pk));
  return rp::with_copy_widths(qv, pv, [&](auto QV, auto PV) {
    return launch<DK, decltype(QV)::value, decltype(PV)::value>(a, B, stream);
  });
}

cudaError_t run(const Args& a, int B, cudaStream_t stream) {
  const int dk = std::max({a.qd, a.pd, a.vd});
  if (dk > 64) {
    const int qv = std::min({rp::copy_elems(a.qd, a.q), rp::copy_elems(a.qd, a.k),
                             rp::copy_elems(a.vd, a.v)});
    const int pv = std::min(rp::copy_elems(a.pd, a.pq), rp::copy_elems(a.pd, a.pk));
    return rp::with_copy_widths(qv, pv, [&](auto QV, auto PV) {
      return launch_wide<decltype(QV)::value, decltype(PV)::value>(a, B, stream);
    });
  }
  if (dk <= 16) return launch_widths<16>(a, B, stream);
  if (dk <= 32) return launch_widths<32>(a, B, stream);
  return launch_widths<64>(a, B, stream);
}

}  // namespace tc

namespace cuda_core {

constexpr float kNegInf = -1e9f;  // ops/layers.NEG_INF
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kVD = 64;           // widest value head
constexpr int kWin = kBQ + kBK;   // pos_k window rows per tile (kBQ + kBK - 1 used)
constexpr int kThreads = 256;     // 16 x 16 threads, a 4x4 micro-tile each

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

// The tile's scores sc + ps, masked, into the online softmax of the
// thread's four rows, then P . V into acc (sP stages the probabilities, sV
// holds the tile's values)
__device__ __forceinline__ void softmax_pv(float (&sc)[4][4], const float (&ps)[4][4],
                                           float (&m_run)[4], float (&l_part)[4],
                                           float (&acc)[4][4], float* sP, const float* sV, int s0,
                                           int S, int limit, int start, const int (&cs)[4],
                                           int chunk, int left, int tx, int ty) {
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

template <typename Tout, int DK>
__global__ void __launch_bounds__(kThreads, 2)
relpos_attn_ctx_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ pq, const float* __restrict__ pk,
                       const float* __restrict__ v, const int* __restrict__ lens,
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
    sQ[i] = (t < T && d < qd) ? q[row * qd + d] : 0.f;
    sPQ[i] = (t < T && d < pd) ? pq[row * pd + d] : 0.f;
  }

  const int limit = relpos::lane_limit(lens, b, S);
  const int start = relpos::lane_start(kv_start, b);
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
      sK[i] = (s < S && d < qd) ? k[(((size_t)b * S + s) * H + h) * qd + d] : 0.f;
    }
    // window row w is pos_k row m_base + w: query t, key s -> (T-1) - t + s
    const int m_base = T - t0 - kBQ + s0;
    for (int i = tid; i < DK * kWin; i += kThreads) {
      const int d = i / kWin, m = m_base + i % kWin;
      sPK[i] = (m >= 0 && m < R && d < pd) ? pk[((size_t)m * H + h) * pd + d] : 0.f;
    }
    for (int i = tid; i < kBK * kVD; i += kThreads) {
      const int c = i / kVD, e = i % kVD, s = s0 + c;
      sV[i] = (s < S && e < vd) ? v[(((size_t)b * S + s) * H + h) * vd + e] : 0.f;
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

    softmax_pv(sc, ps, m_run, l_part, acc, sP, sV, s0, S, limit, start, cs, chunk, left, tx, ty);
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

// Heads wider than 64: the same body with the q, pos and key rows staged 64
// columns at a time (each product summed over the chunks in column order)
// and one 64-wide column tile of v per block (grid.y = H x column tiles).
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 2)
relpos_attn_ctx_wide(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ pq, const float* __restrict__ pk,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     const int* __restrict__ kv_start, Tout* __restrict__ out, int T, int S, int H,
                     int qd, int pd, int vd, int chunk, int left) {
  constexpr int DK = 64;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [DK][kBQ]   a chunk of the q rows, transposed
  float* sPQ = sQ + DK * kBQ;   // [DK][kBQ]   ... of the pos_q rows
  float* sK = sPQ + DK * kBQ;   // [DK][kBK]   ... of the key tile
  float* sPK = sK + DK * kBK;   // [DK][kWin]  ... of its pos_k window
  float* sV = sPK + DK * kWin;  // [kBK][kVD]  the tile's v columns of this block
  float* sP = sV + kBK * kVD;   // [kBK][kBQ]  the tile's probabilities, transposed

  const int nvt = (vd + kVD - 1) / kVD, nc = (max(qd, pd) + DK - 1) / DK;
  const int b = blockIdx.z, h = blockIdx.y / nvt, vt = blockIdx.y % nvt;
  const int t0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int R = T + S - 1;
  const int limit = relpos::lane_limit(lens, b, S);
  const int start = relpos::lane_start(kv_start, b);
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
    float sc[4][4], ps[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = ps[i][j] = 0.f;
    const int m_base = T - t0 - kBQ + s0;  // window row w is pos_k row m_base + w
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // the last chunk's (and tile's) readers are done
      for (int i = tid; i < DK * kBQ; i += kThreads) {
        const int d = DK * c + i / kBQ, t = t0 + i % kBQ;
        const size_t row = ((size_t)b * T + t) * H + h;
        sQ[i] = (t < T && d < qd) ? q[row * qd + d] : 0.f;
        sPQ[i] = (t < T && d < pd) ? pq[row * pd + d] : 0.f;
      }
      for (int i = tid; i < DK * kBK; i += kThreads) {
        const int d = DK * c + i / kBK, s = s0 + i % kBK;
        sK[i] = (s < S && d < qd) ? k[(((size_t)b * S + s) * H + h) * qd + d] : 0.f;
      }
      for (int i = tid; i < DK * kWin; i += kThreads) {
        const int d = DK * c + i / kWin, m = m_base + i % kWin;
        sPK[i] = (m >= 0 && m < R && d < pd) ? pk[((size_t)m * H + h) * pd + d] : 0.f;
      }
      if (c == 0)
        for (int i = tid; i < kBK * kVD; i += kThreads) {
          const int cc = i / kVD, e = kVD * vt + i % kVD, s = s0 + cc;
          sV[i] = (s < S && e < vd) ? v[(((size_t)b * S + s) * H + h) * vd + e] : 0.f;
        }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(sQ + d * kBQ + 4 * ty);
        const float4 w = *reinterpret_cast<const float4*>(sK + d * kBK + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], wv[j], sc[i][j]);
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
    }
    softmax_pv(sc, ps, m_run, l_part, acc, sP, sV, s0, S, limit, start, cs, chunk, left, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum(l_part[i]);
    const int t = t0 + 4 * ty + i;
    if (t >= T) continue;
    Tout* o = out + (((size_t)b * T + t) * H + h) * vd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = kVD * vt + 4 * tx + j;
      if (e < vd) o[e] = from_f32<Tout>(acc[i][j] / l);
    }
  }
}

template <typename Tout, int DK>
cudaError_t launch(const float* q, const float* k, const float* pq, const float* pk,
                   const float* v, const int* lens, const int* kv_start, void* out, int B, int T,
                   int S, int H, int qd, int pd, int vd, int chunk, int left,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK>();
  const cudaError_t err = relpos::allow_smem<relpos_attn_ctx_kernel<Tout, DK>>(smem, true);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  relpos_attn_ctx_kernel<Tout, DK><<<grid, kThreads, smem, stream>>>(
      q, k, pq, pk, v, lens, kv_start, static_cast<Tout*>(out), T, S, H, qd, pd, vd, chunk, left);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t dispatch_dk(const float* q, const float* k, const float* pq, const float* pk,
                        const float* v, const int* lens, const int* kv_start, void* out, int B,
                        int T, int S, int H, int qd, int pd, int vd, int chunk, int left,
                        cudaStream_t stream) {
  const int dk = qd > pd ? qd : pd;
  if (dk > 64 || vd > kVD) {
    constexpr size_t smem = smem_bytes<64>();
    const cudaError_t err = relpos::allow_smem<relpos_attn_ctx_wide<Tout>>(smem, true);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kBQ - 1) / kBQ, H * ((vd + kVD - 1) / kVD), B);
    relpos_attn_ctx_wide<Tout><<<grid, kThreads, smem, stream>>>(
        q, k, pq, pk, v, lens, kv_start, static_cast<Tout*>(out), T, S, H, qd, pd, vd, chunk,
        left);
    return cudaGetLastError();
  }
  if (dk <= 16)
    return launch<Tout, 16>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd, chunk,
                            left, stream);
  if (dk <= 32)
    return launch<Tout, 32>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd, chunk,
                            left, stream);
  return launch<Tout, 64>(q, k, pq, pk, v, lens, kv_start, out, B, T, S, H, qd, pd, vd, chunk,
                          left, stream);
}

}  // namespace cuda_core

// the widest q, pos and value heads either body takes (the bf16 chunked
// body's shared memory: 9 KB per 64-wide chunk of q or pos beside 58 KB)
constexpr int kMaxWidth = 512;

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, pos_q, pos_k and v share
// one).  bfloat16 inputs run the tensor-core body, float32 inputs the
// CUDA-core body; heads wider than 64 run their bodies' chunked forms, up
// to qd, pd, vd <= kMaxWidth (512).  A null `lens` means every key is
// valid, a null `kv_start` means 0.  Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue past the widths); the wrapper validates
// shapes and dtypes.
extern "C" int k2t_relpos_attn_ctx(const void* q, const void* k, const void* pq, const void* pk,
                                   const void* v, const void* lens, const void* kv_start,
                                   void* out, int B, int T, int S, int H, int qd, int pd, int vd,
                                   int chunk, int left, int in_dtype, int out_dtype,
                                   void* stream) {
  const int* ln = static_cast<const int*>(lens);
  const int* ks = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qd < 1 || pd < 1 || vd < 1 || qd > kMaxWidth || pd > kMaxWidth || vd > kMaxWidth ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 1) {
    using tc::bf16;
    const tc::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(pq), static_cast<const bf16*>(pk),
                     static_cast<const bf16*>(v), ln, ks, out, out_dtype == 0, T, S, H, qd, pd,
                     vd, chunk, left};
    return (int)tc::run(a, B, st);
  }
  if (in_dtype != 0) return (int)cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fpq = static_cast<const float*>(pq), *fpk = static_cast<const float*>(pk),
              *fv = static_cast<const float*>(v);
  if (out_dtype == 0)
    return cuda_core::dispatch_dk<float>(fq, fk, fpq, fpk, fv, ln, ks, out, B, T, S, H, qd, pd, vd,
                                         chunk, left, st);
  return cuda_core::dispatch_dk<__nv_bfloat16>(fq, fk, fpq, fpk, fv, ln, ks, out, B, T, S, H, qd,
                                               pd, vd, chunk, left, st);
}
