// Batched RNN-T greedy search for Hopper (sm_90a): one launch runs every
// lane's whole search on the card, each lane on one thread-block cluster.
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
// What bounds it on an H100.  The least work is one joiner row per valid
// frame (2 J V flops) and one refresh per emission (2 D J flops), ~13 us of
// tensor-core time for a bf16 16 x 30 s batch.  The search cannot get near
// it: each emission is a dependent step (the next frame's logits need the
// refreshed decoder), so a lane is a chain of ~one step per emitted token,
// and the batch takes its longest chain's time.  What bounds the design is
// the latency of one step, a chain of block-wide phases rather than any
// unit's throughput: the staging of the joiner's input, the tensor-core
// product and its reductions, two cluster barriers, one gather of the
// context tables from L2 and the decoder projection.  The design keeps the
// weights out of that chain (resident), lets the staging follow the
// emission rate, gives each decoder_proj chunk to one warp (no barrier in
// the refresh).
// Where fewer clusters fit the card at once than there are lanes
// (cudaOccupancyMaxActiveClusters), the lanes run in waves: on an H100 SXM
// (132 SMs) it reports 15 clusters of 8 at one block per SM, not the 16 that
// 128 SMs would hold, since a cluster must lie in one GPC; so a batch of 16
// lanes takes two waves, about twice the time of 15.
//
// Design.  Lane b runs on cluster b of kCL = 8 blocks (B x 8 blocks, one
// block per SM: 512 threads and up to ~225 KB of shared memory each).  Rank r
// owns a contiguous share of W_out's 8-column n-tiles and of decoder_proj's
// 8-column chunks (greedy_operands lays each weight out so that every share
// is one contiguous range), and copies it into its shared memory once per
// launch with bulk copies (cp.async.bulk, completion on an mbarrier): no
// step reads a weight from L2 where it fits.  Where a share does not fit
// (float32 at the flagship, J or D = 1024, a vocabulary of thousands), the
// rest streams from L2 every step through a ring of two stages of ~32 KB
// (one where two do not fit beside the fixed parts: wide float32 joiners)
// filled by bulk copies, which runs ahead across steps (the weights do not
// change); rnnt_cluster.cuh holds the placement and the helpers G shares
// with the beam search (rnnt_beam.cu).  The context is a ring of C tokens
// in shared memory, so any context size runs; staging takes any J (past
// 1024 columns a thread stages several column pairs of a row).  enc_proj's
// frames are read from global memory as the tile is staged (bulk-copying
// them ahead through a ring gained under 2% on an H100).  One step of a lane, every rank in lockstep:
//   1. stage tanh(enc + dec_proj) for the next `rows` frames (up to the
//      mma's 16; after an emission at offset f of the tile, 2 (f + 1)
//      rounded up to 4, doubling after a blank tile: the staging follows
//      the emission rate);
//   2. the rank's logits: bf16 by mma.sync m16n8k16 (A by ldmatrix, B from
//      shared memory in fragment order), the J sum split over warps where
//      the share has few n-tiles; float32 on the CUDA cores (tensor cores
//      would round to TF32); a running first maximum per row;
//   3. each row's (value, index) pushed into this rank's slot in every
//      rank's shared memory (st.shared::cluster), double-buffered by step,
//      then a cluster barrier (release/acquire);
//   4. every warp of every rank reduces the kCL partials in rank order with
//      better(): all derive the same y and first candidate f and take the
//      same branch (blank tile, full buffer, emission or end);
//   5. on an emission rank 0 writes the token and timestamp; each rank
//      gathers the C folded-table rows, computes its decoder_proj columns
//      (a warp per 8-column chunk) and pushes them into every rank's
//      dec_proj, then a cluster barrier.
// Each logit's J sum and each decoder_proj output's D sum stays inside one
// rank, in a fixed order.  Every path ends at a cluster barrier after the
// rank's bulk copies have landed, so no block leaves while another can
// still write its shared memory.

#include "relpos_scores.cuh"  // relpos::allow_smem
#include "rnnt_cluster.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace rnnt;

// Where each part of a block's shared memory lies (bytes) and how much of
// each weight share is resident; the same for every rank (make_plan).
struct Plan : WeightPlan {
  int dproj, dout, hist, slots, red, scratch, bias_w, bias_d, tile;
};

struct Args {
  const void* enc;            // [B, T, J] enc_proj
  const long long* lens;      // [B]
  const long long* offset;    // [B] frame_offset
  const float* tables;        // [C, V, D] folded context tables
  const void* dec_w;          // [Jp/8, D, 8] decoder_proj.w by 8-column chunk
  const float* dec_b;         // [Jp]
  const void* out_w;          // bf16: [Vp/8, Jp/16, 32, 4] fragments; f32: [Vp/8, Jp, 8]
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
  Plan p;
};

__device__ __forceinline__ bool blankish(int y, const Args& a) {
  return y == a.blank || y == 2 || (a.skip_sos && y == 1);
}

__device__ __forceinline__ void take(float logit, int col, float& bv, int& bi) {
  if (better(logit, col, bv, bi)) {
    bv = logit;
    bi = col;
  }
}

// ---------------------------------------------------------------------------
// The bf16 joiner's epilogue (rnnt_cluster.cuh::logits_bf16): each thread
// keeps its best (logit, index) for rows lane / 4 and lane / 4 + 8.

__device__ __forceinline__ void finish_bf16(const Args& a, int c0, const float (&acc)[4],
                                            const float* bias, float (&bv)[2], int (&bi)[2]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = c0 + 2 * tig + (e & 1);
    if (col < a.V) take(bf16_round(bf16_round(acc[e]) + bias[col]), col, bv[e >> 1], bi[e >> 1]);
  }
}

// ---------------------------------------------------------------------------
// The joiner on the CUDA cores (float32).  sAt is the tile [Jp][kRows], the
// 4-row group g of column j stored at group g ^ ((j >> 1) & 3), so that the
// four columns a warp reads at once fall on distinct banks; W holds `count`
// n-tiles [count][Jp][8].  A warp multiplies one n-tile over one k-slice (a
// multiple of 16 of J): lane (s, c) = (lane / 8, lane % 8) sums column c
// over j = s mod 4, where the swizzle of j alternates between s / 2 and
// s / 2 ^ 2.  NR4 row groups of 4 are computed (the staged rows).  Lanes
// 0-7 keep their column's best per row in bv[16] (slices of whole J); for
// split slices each thread keeps one row (threadIdx.x / 8 % 16) in bv1.

__device__ __forceinline__ const float* swz(const float* sAt, int j, int g) {
  return sAt + j * kRows + ((g ^ ((j >> 1) & 3)) << 2);
}

template <int NR4>
__device__ __forceinline__ void logits_f32(const Args& a, const float* W, int count, int col0,
                                           const float* sAt, float* scratch, const float* bias,
                                           bool sync_after, float (&bv)[kRows], int (&bi)[kRows],
                                           float& bv1, int& bi1) {
  if (count <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane & 7, s = lane >> 3;
  const int Jp = a.Jp, KS = Jp / 16;
  int ksl = floor_pow2(max(1, kWarps / count));  // k-slices: a power of two dividing KS
  while (KS % ksl) ksl /= 2;
  const int span = Jp / ksl;
  const int m = s >> 1;
  for (int it = warp; it < count * ksl; it += kWarps) {
    const int q = it / ksl, j0 = (it - q * ksl) * span;
    float acc[NR4 * 4];
#pragma unroll
    for (int r = 0; r < NR4 * 4; ++r) acc[r] = 0.f;
    const float* w = W + ((size_t)q * Jp + j0 + s) * 8 + c;
    const float* x = sAt + (j0 + s) * kRows;
#pragma unroll 2
    for (int i = 0; i < span / 8; ++i, w += 64, x += 8 * kRows) {
      const float w0 = w[0], w1 = w[32];
#pragma unroll
      for (int g = 0; g < NR4; ++g) {
        const float4 x0 = *reinterpret_cast<const float4*>(x + ((g ^ m) << 2));
        const float4 x1 = *reinterpret_cast<const float4*>(x + 4 * kRows + ((g ^ m ^ 2) << 2));
        acc[4 * g + 0] = fmaf(x1.x, w1, fmaf(x0.x, w0, acc[4 * g + 0]));
        acc[4 * g + 1] = fmaf(x1.y, w1, fmaf(x0.y, w0, acc[4 * g + 1]));
        acc[4 * g + 2] = fmaf(x1.z, w1, fmaf(x0.z, w0, acc[4 * g + 2]));
        acc[4 * g + 3] = fmaf(x1.w, w1, fmaf(x0.w, w0, acc[4 * g + 3]));
      }
    }
#pragma unroll
    for (int r = 0; r < NR4 * 4; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
    }
    if (s == 0) {
      const int col = col0 + q * 8 + c;
      if (ksl == 1) {
        if (col < a.V) {
          const float b = bias[col];
#pragma unroll
          for (int r = 0; r < NR4 * 4; ++r) take(acc[r] + b, col, bv[r], bi[r]);
        }
      } else {
        float* out = scratch + (size_t)it * kRows * 8 + c;  // [item][kRows][8]
#pragma unroll
        for (int r = 0; r < NR4 * 4; ++r) out[r * 8] = acc[r];
      }
    }
  }
  if (ksl > 1) {
    __syncthreads();
    const int r = (threadIdx.x >> 3) & (kRows - 1), cc = threadIdx.x & 7;
    if (r < NR4 * 4) {
      for (int q = threadIdx.x >> 7; q < count; q += kThreads / 128) {
        const int col = col0 + q * 8 + cc;
        if (col < a.V) {
          float sum = 0.f;
          for (int sl = 0; sl < ksl; ++sl) sum += scratch[((size_t)(q * ksl + sl) * kRows + r) * 8 + cc];
          take(sum + bias[col], col, bv1, bi1);
        }
      }
    }
    if (sync_after) __syncthreads();
  }
}

__device__ __forceinline__ void logits_f32_rows(int rows, const Args& a, const float* W,
                                                int count, int col0, const float* sAt,
                                                float* scratch, const float* bias,
                                                bool sync_after, float (&bv)[kRows],
                                                int (&bi)[kRows], float& bv1, int& bi1) {
  switch ((rows + 3) / 4) {
    case 1: logits_f32<1>(a, W, count, col0, sAt, scratch, bias, sync_after, bv, bi, bv1, bi1); break;
    case 2: logits_f32<2>(a, W, count, col0, sAt, scratch, bias, sync_after, bv, bi, bv1, bi1); break;
    case 3: logits_f32<3>(a, W, count, col0, sAt, scratch, bias, sync_after, bv, bi, bv1, bi1); break;
    default: logits_f32<4>(a, W, count, col0, sAt, scratch, bias, sync_after, bv, bi, bv1, bi1); break;
  }
}

// ---------------------------------------------------------------------------
// The refresh's decoder_proj columns: `count` chunks of 8 columns (the
// first chunk0), each [D][8] in the compute dtype at W, times dout; warp w
// takes chunks w, w + kWarps, ... (rnnt_cluster.cuh::chunk_dot), and lanes
// l % 4 == 0 add the bias (bias[j], decoder_proj.b at the global column)
// and push it into every rank's dproj.  No barrier.

template <bool BF>
__device__ __forceinline__ void refresh_cols(const Args& a, const unsigned char* W, int count,
                                             int chunk0, const float* dout, const float* bias,
                                             float* dproj) {
  const int lane = threadIdx.x % 32;
  for (int ch = threadIdx.x / 32; ch < count; ch += kWarps) {  // one pass below 16 chunks
    const float v1 = chunk_dot<BF>(W + (size_t)ch * a.D * (BF ? 16 : 32), dout, a.D, lane);
    const int j = (chunk0 + ch) * 8 + chunk_col(lane);
    if ((lane & 3) == 0 && j < a.J) {
      const float v = BF ? bf16_round(bf16_round(v1) + bias[j]) : v1 + bias[j];
#pragma unroll
      for (int dst = 0; dst < kCL; ++dst) st_cluster(map_rank(dproj + j, dst), v);
    }
  }
}

// ---------------------------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1) rnnt_greedy_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& P = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* dproj = reinterpret_cast<float*>(smem + P.dproj);
  float* dout = reinterpret_cast<float*>(smem + P.dout);
  Cand* slots = reinterpret_cast<Cand*>(smem + P.slots);  // [2][kCL][kRows]
  Cand* red = reinterpret_cast<Cand*>(smem + P.red);      // [kRows][kWarps]
  float* scratch = reinterpret_cast<float*>(smem + P.scratch);
  float* bias_w = reinterpret_cast<float*>(smem + P.bias_w);  // output.b, this rank's columns
  float* bias_d = reinterpret_cast<float*>(smem + P.bias_d);  // decoder_proj.b, likewise
  unsigned char* tile = smem + P.tile;
  unsigned char* wres = smem + P.wres;
  unsigned char* wring = smem + P.wring;
  unsigned char* dres = smem + P.dres;
  unsigned char* dring = smem + P.dring;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cluster_rank(), b = cluster_index();
  const int len = (int)min(max(a.lens[b], 0LL), (long long)a.T);
  const long long offset = a.offset[b];

  // this rank's shares: resident first, the rest streamed in stages (w_st
  // stages per step, d_st per refresh)
  const Shares sh(P, a.Vp / 8, a.Jp / 8, rank, a.out_w, a.dec_w);
  const int w0 = sh.w0, nw = sh.nw, c0 = sh.c0, nd = sh.nd;
  const int w_res = sh.w_res, w_str = sh.w_str, d_res = sh.d_res, d_str = sh.d_str;
  const int w_st = sh.w_st, d_st = sh.d_st;
  const unsigned char* out_w = sh.out_w;
  const unsigned char* dec_w = sh.dec_w;
  auto issue_w = [&](int k) { sh.issue_w(P, wring, bars, k); };
  auto issue_d = [&](int k) { sh.issue_d(P, dring, bars, k); };
  int* hist = reinterpret_cast<int*>(smem + P.hist);  // the context, a ring of C tokens

  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t res_bytes = (uint32_t)(w_res * P.uw + d_res * P.ud);
  if (tid == 0) {
    if (res_bytes) {
      mbar_expect(bars + kBarRes, res_bytes);
      if (w_res) bulk_load(wres, out_w + (size_t)w0 * P.uw, (uint32_t)w_res * P.uw, bars + kBarRes);
      if (d_res) bulk_load(dres, dec_w + (size_t)c0 * P.ud, (uint32_t)d_res * P.ud, bars + kBarRes);
    }
    for (int k = 0; k < P.depth; ++k) {
      if (w_st) issue_w(k);
      if (d_st) issue_d(k);
    }
  }
  for (int i = tid; i < nw * 8; i += kThreads) bias_w[i] = a.out_b[w0 * 8 + i];
  for (int i = tid; i < nd * 8; i += kThreads) bias_d[i] = a.dec_b[c0 * 8 + i];
  for (int j = tid; j < a.Jp; j += kThreads) {
    float x = 0.f;
    if (j < a.J) {
      const size_t at = (size_t)b * a.J + j;
      x = BF ? __bfloat162float(static_cast<const bf16*>(a.dec_proj_in)[at])
             : static_cast<const float*>(a.dec_proj_in)[at];
    }
    dproj[j] = x;
  }
  {
    const int words = BF ? kRows * (a.Jp + 8) / 2 : a.Jp * kRows;
    for (int i = tid; i < words; i += kThreads) reinterpret_cast<float*>(tile)[i] = 0.f;
  }
  // context token c is hist[(head + c) % C]; an emission overwrites the
  // oldest, hist[head], and moves head on
  for (int c = tid; c < a.C; c += kThreads) hist[c] = (int)a.hyp_in[(size_t)b * a.C + c];
  int head = 0;
  long long count = a.count_in[b], trailing = a.trailing_in[b];
  if (res_bytes) mbar_wait(bars + kBarRes, 0);
  cluster_sync();  // every block of the cluster has started and holds its state

  int t = 0, rows_cap = kRows, step = 0;
  int kw = 0, kd = 0;  // ring stages consumed
  // bf16 staging: `per_row` column pairs of a tile row, rows r0, r0 + rstep,
  // ...; past 1024 columns (per_row > kThreads) each thread takes column
  // pairs tid, tid + kThreads, ... of every row
  const int per_row = a.Jp / 2, rstep = max(1, kThreads / per_row);
  const int r0 = per_row <= kThreads ? tid / per_row : 0;
  const int jpair0 = per_row <= kThreads ? tid % per_row : tid;
  while (t < len) {
    if (count >= a.K) {  // a full buffer: every frame left counts as a blank
      trailing += len - t;
      break;
    }
    const int rows = min(rows_cap, len - t);

    // 1. stage the joiner's input for frames t .. t + rows - 1
    if (BF) {
      bf16* sA = reinterpret_cast<bf16*>(tile);
      for (int jpair = jpair0; r0 < rstep && jpair < per_row; jpair += kThreads) {
        const int j = 2 * jpair;
        const float d0 = dproj[j], d1 = dproj[j + 1];
        const bf16* enc = static_cast<const bf16*>(a.enc) + ((size_t)b * a.T + t) * a.J;
        // two rows at a time, so that their tanh chains overlap
        for (int r = r0; r < rows; r += 2 * rstep) {
          const int r2 = r + rstep;
          const bool two = r2 < rows;
          const bf16* p = enc + (size_t)r * a.J;
          const bf16* q = enc + (size_t)(two ? r2 : r) * a.J;
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          if (j < a.J) {
            x[0] = __bfloat162float(p[j]);
            x[2] = __bfloat162float(q[j]);
          }
          if (j + 1 < a.J) {
            x[1] = __bfloat162float(p[j + 1]);
            x[3] = __bfloat162float(q[j + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = (j + (e & 1) < a.J) ? tanhf(bf16_round(x[e] + ((e & 1) ? d1 : d0))) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(sA + r * (a.Jp + 8) + j) = __floats2bfloat162_rn(x[0], x[1]);
          if (two)
            *reinterpret_cast<__nv_bfloat162*>(sA + r2 * (a.Jp + 8) + j) =
                __floats2bfloat162_rn(x[2], x[3]);
        }
      }
    } else {
      float* sAt = reinterpret_cast<float*>(tile);
      const int rr = tid & 3;
      for (int g = 0; 4 * g < rows; ++g) {
        const int r = 4 * g + rr;
        if (r >= rows) continue;
        const float* src = static_cast<const float*>(a.enc) + ((size_t)b * a.T + t + r) * a.J;
        for (int j = tid >> 2; j < a.Jp; j += kThreads / 4)
          const_cast<float*>(swz(sAt, j, g))[rr] = j < a.J ? tanhf(src[j] + dproj[j]) : 0.f;
      }
    }
    __syncthreads();

    // 2. this rank's best (logit, index) per row over its columns
    if (BF) {
      float bv[2] = {-INFINITY, -INFINITY};
      int bi[2] = {INT_MAX, INT_MAX};
      const bf16* sA = reinterpret_cast<const bf16*>(tile);
      float4* sc = reinterpret_cast<float4*>(scratch);
      const float* ob = bias_w - w0 * 8;  // indexed by global column
      auto take_best = [&](int c0, const float (&acc)[4]) { finish_bf16(a, c0, acc, ob, bv, bi); };
      logits_bf16(a.Jp, reinterpret_cast<const uint2*>(wres), w_res, w0 * 8, sA, sc, w_st > 0,
                  take_best);
      for (int g = 0; g < w_st; ++g, ++kw) {
        ring_wait(bars, kBarW, P.depth, kw);
        const int u = g * P.sw;
        logits_bf16(a.Jp, reinterpret_cast<const uint2*>(wring + (size_t)(kw % P.depth) * P.sw * P.uw),
                    min(P.sw, w_str - u), (w0 + w_res + u) * 8, sA, sc, false, take_best);
        __syncthreads();
        if (tid == 0) issue_w(kw + P.depth);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        shfl_best(bv[r], bi[r], 1);
        shfl_best(bv[r], bi[r], 2);
      }
      if ((lane & 3) == 0) {
        red[(lane / 4) * kWarps + warp] = Cand{bv[0], bi[0]};
        red[(lane / 4 + 8) * kWarps + warp] = Cand{bv[1], bi[1]};
      }
    } else {
      float bv[kRows], bv1 = -INFINITY;
      int bi[kRows], bi1 = INT_MAX;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bv[r] = -INFINITY;
        bi[r] = INT_MAX;
      }
      const float* sAt = reinterpret_cast<const float*>(tile);
      const float* ob = bias_w - w0 * 8;
      logits_f32_rows(rows, a, reinterpret_cast<const float*>(wres), w_res, w0 * 8, sAt, scratch,
                      ob, w_st > 0, bv, bi, bv1, bi1);
      for (int g = 0; g < w_st; ++g, ++kw) {
        ring_wait(bars, kBarW, P.depth, kw);
        const int u = g * P.sw;
        logits_f32_rows(rows, a,
                        reinterpret_cast<const float*>(wring + (size_t)(kw % P.depth) * P.sw * P.uw),
                        min(P.sw, w_str - u), (w0 + w_res + u) * 8, sAt, scratch, ob, false, bv,
                        bi, bv1, bi1);
        __syncthreads();
        if (tid == 0) issue_w(kw + P.depth);
      }
      // each staged row's best over lanes 0-7 (bv), then each 8-lane
      // group's row (bv1) merged in
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          for (int o = 1; o < 8; o <<= 1) shfl_best(bv[r], bi[r], o);
          if (lane == 0) red[r * kWarps + warp] = Cand{bv[r], bi[r]};
        }
      }
      for (int o = 1; o < 8; o <<= 1) shfl_best(bv1, bi1, o);
      __syncwarp();
      const int myrow = (tid >> 3) & (kRows - 1);
      if ((lane & 7) == 0 && myrow < rows) {
        Cand& c = red[myrow * kWarps + warp];
        if (better(bv1, bi1, c.v, c.i)) c = Cand{bv1, bi1};
      }
    }
    __syncthreads();

    // 3. push each row's best into this rank's slot in every rank
    const int par = step & 1;
    ++step;
    if (tid < kRows * kWarps) {  // row tid / 16 over the warps (lanes of a half-warp)
      const int r = tid / kWarps, w = tid % kWarps;
      Cand c = red[r * kWarps + w];
#pragma unroll
      for (int o = kWarps / 2; o > 0; o >>= 1) shfl_best(c.v, c.i, o);
      if (w < kCL) st_cluster(map_rank(slots + (par * kCL + rank) * kRows + r, w), c);
    }
    cluster_sync();

    // 4. every warp: each row's first maximum over the ranks, the first
    // candidate row f and its token y (the same in every warp and rank)
    Cand best{-INFINITY, INT_MAX};
    if (lane < kRows)
      for (int src = 0; src < kCL; ++src) {
        const Cand o = slots[(par * kCL + src) * kRows + lane];
        if (better(o.v, o.i, best.v, best.i)) best = o;
      }
    const unsigned cand = __ballot_sync(0xffffffffu, lane < rows && !blankish(best.i, a));
    const int f = cand ? __ffs(cand) - 1 : -1;
    if (f < 0) {  // the whole tile is blank
      trailing += rows;
      t += rows;
      rows_cap = min(kRows, 2 * rows_cap);
      continue;
    }
    const int y = __shfl_sync(0xffffffffu, best.i, f);

    // 5. emit, then refresh dec_proj
    if (rank == 0 && tid == 0) {
      a.tokens[(size_t)b * a.K + count] = y;
      a.timestamps[(size_t)b * a.K + count] = offset + t + f;
    }
    ++count;
    trailing = 0;
    // dout = relu(sum_c tables[c][hyp[c]]) over the new context: the old
    // context's tokens 1 .. C-1, then y
    for (int d = tid; d < a.D; d += kThreads) {
      float s = 0.f;
      for (int c = 0; c < a.C; ++c) {
        int h = y;
        if (c + 1 < a.C) {
          const int at = head + 1 + c;
          h = hist[at < a.C ? at : at - a.C];
        }
        h = h < 0 ? a.blank : h;
        const float x = __ldg(a.tables + ((size_t)c * a.V + h) * a.D + d);
        s = c == 0 ? x : s + x;
      }
      s = fmaxf(s, 0.f);
      dout[d] = BF ? bf16_round(s) : s;
    }
    __syncthreads();  // also: every thread has read the context
    if (tid == 0) hist[head] = y;
    head = head + 1 < a.C ? head + 1 : 0;
    const float* db = bias_d - c0 * 8;  // indexed by global column
    refresh_cols<BF>(a, dres, d_res, c0, dout, db, dproj);
    for (int g = 0; g < d_st; ++g, ++kd) {
      ring_wait(bars, kBarD, P.depth, kd);
      const int u = g * P.sd;
      refresh_cols<BF>(a, dring + (size_t)(kd % P.depth) * P.sd * P.ud, min(P.sd, d_str - u),
                       c0 + d_res + u, dout, db, dproj);
      __syncthreads();  // the stage's ring slot is read: refill it
      if (tid == 0) issue_d(kd + P.depth);
    }
    cluster_sync();
    t += f + 1;
    rows_cap = min(kRows, max(4, round_up(2 * (f + 1), 4)));
  }

  // every bulk copy still in flight lands before the block may exit
  if (tid == 0) {
    for (int k = kw; k < kw + P.depth && w_st; ++k) ring_wait(bars, kBarW, P.depth, k);
    for (int k = kd; k < kd + P.depth && d_st; ++k) ring_wait(bars, kBarD, P.depth, k);
  }
  if (rank == 0) {
    for (int j = tid; j < a.J; j += kThreads) {
      const size_t at = (size_t)b * a.J + j;
      if (BF)
        static_cast<bf16*>(a.dec_proj)[at] = __float2bfloat16_rn(dproj[j]);
      else
        static_cast<float*>(a.dec_proj)[at] = dproj[j];
    }
    for (int c = tid; c < a.C; c += kThreads) {
      const int at = head + c;
      a.hyp[(size_t)b * a.C + c] = hist[at < a.C ? at : at - a.C];
    }
    if (tid == 0) {
      a.count[b] = count;
      a.trailing[b] = trailing;
    }
  }
  __syncthreads();
  cluster_sync();  // no block leaves while another may still write its shared memory
}

// ---------------------------------------------------------------------------
// The plan: shared-memory layout and residency, from the shapes and the
// device's per-block limit.  Each rank holds ceil(units / kCL) units at most.
// Fixed parts first (barriers, dec_proj, the decoder output, the context,
// the partial slots, the reduction, the scratch, the tile); then the weights
// (rnnt_cluster.cuh::place_weights): every weight resident if it fits, else
// the rest streamed.

template <bool BF>
bool make_plan(int J, int D, int V, int C, int limit, Plan& p) {
  const int Jp = round_up(J, 16), Vp = round_up(V, 8), esz = BF ? 2 : 4;
  const int ntw = (Vp / 8 + kCL - 1) / kCL, ntd = (Jp / 8 + kCL - 1) / kCL;
  p = Plan{};
  p.uw = BF ? Jp / 16 * 256 : Jp * 32;
  p.ud = D * 8 * esz;
  Layout L;
  p.dproj = L.place(Jp * 4);
  p.dout = L.place(round_up(D, 4) * 4);
  p.hist = L.place(C * 4);
  p.slots = L.place(2 * kCL * kRows * (int)sizeof(Cand));
  p.red = L.place(kWarps * kRows * (int)sizeof(Cand));
  p.scratch = L.place(BF ? kWarps * kG * 32 * 16 : kWarps * kRows * 8 * 4);
  p.bias_w = L.place(ntw * 8 * 4);
  p.bias_d = L.place(ntd * 8 * 4);
  p.tile = L.place(BF ? kRows * (Jp + 8) * 2 : Jp * kRows * 4);
  return place_weights(p, L, ntw, ntd, limit);
}

template <bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  // set once per kernel and device, not per launch
  cudaError_t err = relpos::allow_smem<rnnt_greedy_kernel<BF>>(a.p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rnnt_greedy_kernel<BF>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BF>
cudaError_t describe(const Plan& p, long long* out) {
  cudaError_t err = relpos::allow_smem<rnnt_greedy_kernel<BF>>(p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, rnnt_greedy_kernel<BF>, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, rnnt_greedy_kernel<BF>);
  if (err != cudaSuccess) return err;
  out[7] = clusters;
  out[8] = fa.numRegs;
  out[9] = (long long)fa.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (enc_proj, dec_proj and dec_w; the
// tables and biases are float32 either way).  out_w is [Vp/8, Jp/16, 32, 4]
// bf16 mma fragments (decode/rnnt_greedy.py::pack_mma_b) or [Vp/8, Jp, 8]
// float32, dec_w [Jp/8, D, 8], with Jp = J rounded up to 16 and Vp = V
// rounded up to 8, zero padded (decode/rnnt_greedy.py::greedy_operands).
// The search reads hyp, dec_proj, count and trailing from the *_in buffers
// and writes them to the others; it writes its emissions into tokens and
// timestamps in place.  Takes B, V, K, C >= 1 and any J and D whose fixed
// parts (make_plan) leave room for one stage of each weight beside them in
// a block's shared memory (on an H100, J = D up to ~1,600 in float32 and
// ~3,000 in bf16); returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for shapes it does not take).
extern "C" int k2t_rnnt_greedy(const void* enc, const void* lens, const void* offset,
                               const void* tables, const void* dec_w, const void* dec_b,
                               const void* out_w, const void* out_b, const void* hyp_in,
                               const void* dec_proj_in, const void* count_in,
                               const void* trailing_in, void* hyp, void* dec_proj, void* count,
                               void* trailing, void* tokens, void* timestamps, int B, int T,
                               int J, int D, int V, int C, int K, int blank, int skip_sos,
                               int dtype, void* stream) {
  if (B < 1 || T < 0 || J < 1 || D < 1 || V < 1 || C < 1 || K < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int limit = smem_limit();
  if (!(dtype ? make_plan<true>(J, D, V, C, limit, p) : make_plan<false>(J, D, V, C, limit, p)))
    return (int)cudaErrorInvalidValue;
  const Args a{enc, static_cast<const long long*>(lens), static_cast<const long long*>(offset),
               static_cast<const float*>(tables), dec_w, static_cast<const float*>(dec_b),
               out_w, static_cast<const float*>(out_b), static_cast<const long long*>(hyp_in),
               dec_proj_in, static_cast<const long long*>(count_in),
               static_cast<const long long*>(trailing_in), static_cast<long long*>(hyp),
               dec_proj, static_cast<long long*>(count), static_cast<long long*>(trailing),
               static_cast<long long*>(tokens), static_cast<long long*>(timestamps), T, J,
               round_up(J, 16), D, V, round_up(V, 8), C, K, blank, skip_sos, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<true>(a, B, st) : launch<false>(a, B, st));
}

// What a launch at these shapes would use, for logs: out[0..10] = shared
// memory bytes per block, resident n-tiles of W_out and chunks of
// decoder_proj per rank, units per streamed stage of each, the most n-tiles
// and chunks a rank owns, cudaOccupancyMaxActiveClusters, the kernel's
// registers per thread and local (spill) bytes, and the rings' stages.
extern "C" int k2t_rnnt_greedy_plan(int J, int D, int V, int C, int dtype, long long* out) {
  if (J < 1 || D < 1 || V < 1 || C < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int limit = smem_limit();
  if (!(dtype ? make_plan<true>(J, D, V, C, limit, p) : make_plan<false>(J, D, V, C, limit, p)))
    return (int)cudaErrorInvalidValue;
  const int Jp = round_up(J, 16), Vp = round_up(V, 8);
  out[0] = p.bytes, out[1] = p.res_w, out[2] = p.res_d, out[3] = p.sw, out[4] = p.sd;
  out[5] = (Vp / 8 + kCL - 1) / kCL, out[6] = (Jp / 8 + kCL - 1) / kCL;
  out[10] = p.depth;
  return (int)(dtype ? describe<true>(p, out) : describe<false>(p, out));
}
