// Batched RNN-T modified beam search for Hopper (sm_90a): one launch runs
// every lane's whole search on the card, each lane on one thread-block
// cluster, K beams per lane.
//
// Replaces the device loop of k2transducerasr_tpu/decode/rnnt_beam.py::
// beam_frames_skip, the lax.while_loop at :160-327 (no Pallas kernel is
// behind it: XLA compiles the loop).  The port's plain version, a Python loop
// with one host sync per trip, is decode/rnnt_beam.py::
// beam_frames_skip_reference.  This kernel runs the same algorithm, trip by
// trip, with each trip's window evaluated one frame at a time, so that its
// decisions, its sums and its tie rules are the plain version's:
//
//   A trip starts at frame t_ptr, over the window [s, s + W) with
//   s = clip(t_ptr, 0, T - W), W = min(T, window); its frames are
//   t_ptr .. min(s + W, len) - 1.  At each of them, for every beam k:
//     logits_k = W_out . tanh(enc_proj[t] + dec_proj_k) + b_out
//     logp_k   = (logits_k - max) - log(sum exp(logits_k - max))  (float32),
//                with <unk> = 2 (and <sos/eos> = 1 under skip_sos) at NEG_INF
//     cumi_k  += logp_k[blank];   cume_k = cumi_k - logp_k[blank]
//   The frame may emit iff  max_{k, v != blank} (score_k + cume_k) + logp_k[v]
//   >= min_k score_k + cumi_k.  At the first frame that may, the step: the
//   beams sorted by score_k + cume_k (stable, descending), the K best of the
//   K V candidates (score_k + cume_k) + logp_k[v] in the order (value
//   descending, flat index i V + v ascending, i the sorted position), each
//   new beam taking its parent's state; a non-blank token appends (stored
//   only while the parent's buffer has room, kept in the context either
//   way) and refreshes the beam's decoder output from the folded context
//   tables.  The next trip starts at the next frame.  A trip that reaches
//   its window's end with no such frame folds: scores += cumi, the beams
//   re-sorted by them.  Past a lane's length nothing changes.
//
// bf16 (dtype 1) rounds where joiner.joint_logits and project_decoder
// round (enc + dec_proj, tanh, the product, the sum with the bias; the
// decoder output before its product); the log-softmax and the scores are
// float32 in both dtypes.
//
// What bounds it on an H100.  The least work is K joiner rows per valid
// frame (2 K J V flops) and one decoder refresh per emitting beam (2 D J),
// ~50 us of tensor-core time for a bf16 16 x 30 s batch at K = 4.  As in the
// greedy search, each step is dependent on the last (the next frame's
// logits need the refreshed decoder outputs), so a lane is a chain of one
// step per frame and the design is bound by a step's latency: the staging,
// the tensor-core product, the log-softmax's partials exchanged across the
// cluster, the top K, a second exchange, the refresh and a third.
//
// Design (rnnt_cluster.cuh, as rnnt_greedy.cu).  Lane b runs on cluster b of
// kCL = 8 blocks of 512 threads; rank r owns a contiguous share of W_out's
// n-tiles and of decoder_proj's chunks, resident in its shared memory where
// they fit, streamed through rings where they do not.  Every rank holds all
// K beams' decoder outputs (two buffers: this frame's and the next) and the
// small beam state, and derives every decision identically.  Per frame:
//   1. stage tanh(enc[t] + dec_proj_k) for the K beams (rows of one tile);
//   2. the rank's logits for its columns, all K rows (bf16: mma.sync; float32:
//      CUDA cores), kept in shared memory;
//   3. per row, the rank's (max, sum of exps) and, from the rank that owns
//      the blank column, the blank logit, pushed to every rank; a barrier;
//   4. every rank merges the 8 partials in rank order: the log-sum-exp, the
//      blank log-probs, the trip's sums, the beams' sort orders;
//   5. each rank's K best candidates (a warp per row, then one warp over the
//      rows) and its best non-blank value, pushed to every rank; a barrier;
//   6. every rank merges the 8 lists in rank order into the K best, and
//      takes the same branch: no step, an emission step or a window's end;
//   7. a step writes the new beams' state (parent gather) into the other
//      buffer; the emitting beams' decoder outputs are recomputed (a warp per
//      (beam, 8-column chunk)) and pushed into every rank; a barrier.
// The token buffers are not copied per step: rank 0 writes each frame's
// choices ((parent, token, stored, step kind) per new beam) into `steps`
// [B, T, K], and at the end walks each final beam's ancestry back through
// them, writing its new tokens and timestamps behind its launch-start
// ancestor's buffer row (copied whole).  With `values`, the beams' scores
// after each frame are written beside them; testing.py::beam_replay reads
// both.

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

constexpr int kMaxBeams = kRows;  // the beams are the rows of one joiner tile
constexpr float kNegInf = -1e30f;  // decode/rnnt_beam.py NEG_INF
constexpr int kUnk = 2;

// one lane's small beam state, the same in every rank
struct BeamSmem {
  long long cnt[2][kMaxBeams];  // tokens stored per beam (this buffer, the next)
  float score[2][kMaxBeams];
  int anc[2][kMaxBeams];        // the beam this one descends from at the launch's start
  float cumi[kMaxBeams];        // the trip's blank log-probs summed, this frame's included
  float cume[kMaxBeams];        // ... and without it
  float mrow[kMaxBeams];        // each row's max logit
  float lse[kMaxBeams];         // log of its sum of exps
  float foldv[kMaxBeams];       // score + cumi
  int inv[kMaxBeams];           // beam k's position sorted by score + cume
  int perm[kMaxBeams];          // the beam at each position of that order
  int fperm[kMaxBeams];         // ... of the order by score + cumi
  float rowmax[kMaxBeams];      // each row's best non-blank candidate in this rank
  int parent[kMaxBeams], token[kMaxBeams];  // the step's new beams
  float value[kMaxBeams];
  int emitters[kMaxBeams];
  int n_emit, kind;             // kind: 0 no step, 1 an emission step, 2 a window's end
  float min_blank;
};
static_assert(sizeof(BeamSmem) == 1360, "decode/rnnt_beam.py::_BEAM_SMEM mirrors this size");

struct Plan : WeightPlan {
  int ls;  // the logits' row stride: the most columns a rank owns
  int dproj, dout, hist, beam, part, top, rowtop, logits, scratch, bias_w, bias_d, tile;
};

struct Args {
  const void* enc;              // [B, T, J] enc_proj
  const long long* lens;        // [B]
  const long long* offset;      // [B] frame_offset
  const float* tables;          // [C, V, D] folded context tables
  const void* dec_w;            // [Jp/8, D, 8]
  const float* dec_b;           // [Jp]
  const void* out_w;            // bf16: [Vp/8, Jp/16, 32, 4] fragments; f32: [Vp/8, Jp, 8]
  const float* out_b;           // [Vp]
  const long long* hyp_in;      // [B, K, C]  the state the search starts from
  const void* dec_proj_in;      // [B, K, J]
  const float* score_in;        // [B, K]
  const long long* count_in;    // [B, K]
  const long long* tokens_in;   // [B, K, U]
  const long long* ts_in;       // [B, K, U]
  long long* hyp;               // [B, K, C]  the state it ends in
  void* dec_proj;               // [B, K, J]
  float* score;                 // [B, K]
  long long* count;             // [B, K]
  long long* tokens;            // [B, K, U]
  long long* timestamps;        // [B, K, U]
  int* steps;                   // [B, T, K] each frame's choices
  float* values;                // [B, T, K] the scores after each frame, or null
  int T, W, J, Jp, D, V, Vp, C, K, U, blank, skip_sos;
  Plan p;
};

__device__ __forceinline__ bool forbidden(int v, const Args& a) {
  return v == kUnk || (a.skip_sos && v == 1);
}

// steps[] entries: (token << 7) | (kind << 5) | (stored << 4) | parent
__device__ __forceinline__ int step_entry(int token, int kind, int stored, int parent) {
  return (token << 7) | (kind << 5) | (stored << 4) | parent;
}

__device__ __forceinline__ Cand shfl_cand(Cand c, int src) {
  return Cand{__shfl_sync(0xffffffffu, c.v, src), __shfl_sync(0xffffffffu, c.i, src)};
}

// One warp: the K best of n candidates get(i), i < n, in the order of
// better(); lane r < K returns the r-th (the sentinel {-inf, INT_MAX} where
// fewer than r + 1 exist).  Each round takes the best of those after the
// last one taken.
template <class Get>
__device__ __forceinline__ Cand warp_top_k(int K, int n, Get get) {
  const int lane = threadIdx.x & 31;
  Cand prev{INFINITY, -1}, mine{-INFINITY, INT_MAX};
  for (int r = 0; r < K; ++r) {
    Cand best{-INFINITY, INT_MAX};
    for (int i = lane; i < n; i += 32) {
      const Cand c = get(i);
      if (better(prev.v, prev.i, c.v, c.i) && better(c.v, c.i, best.v, best.i)) best = c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) shfl_best(best.v, best.i, o);
    if (lane == r) mine = best;
    prev = best;
  }
  return mine;
}

// ---------------------------------------------------------------------------
// The bf16 joiner's epilogue (rnnt_cluster.cuh::logits_bf16): every logit of
// the K rows kept, L[row][col - lcol0]; bias[col] is output.b at the global
// column.

__device__ __forceinline__ void store_bf16(const Args& a, int c0, const float (&acc)[4],
                                           const float* bias, float* L, int lcol0) {
  const int lane = threadIdx.x & 31, tig = lane & 3, r = lane >> 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r + 8 * (e >> 1), col = c0 + 2 * tig + (e & 1);
    if (row < a.K && col < a.V)
      L[row * a.p.ls + col - lcol0] = bf16_round(bf16_round(acc[e]) + bias[col]);
  }
}

// The joiner on the CUDA cores (float32): sA is [K][Jp]; W holds `count`
// n-tiles [count][Jp][8].  A thread per (column, row), the J sum in four
// chains.
__device__ __forceinline__ void logits_f32(const Args& a, const float* W, int count, int col0,
                                           const float* sA, const float* bias, float* L,
                                           int lcol0) {
  const int n = count * 8 * a.K;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i % a.K, cl = i / a.K, col = col0 + cl;
    if (col >= a.V) continue;
    const float* w = W + (size_t)(cl >> 3) * a.Jp * 8 + (cl & 7);
    const float* x = sA + (size_t)k * a.Jp;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + 4 <= a.J; j += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(x[j + e], w[(size_t)(j + e) * 8], acc[e]);
    }
    for (; j < a.J; ++j) acc[0] = fmaf(x[j], w[(size_t)j * 8], acc[0]);
    L[k * a.p.ls + col - lcol0] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + bias[col];
  }
}

// ---------------------------------------------------------------------------
// The refresh of the emitting beams' decoder outputs: `count` chunks of 8
// columns (the first chunk0), each [D][8] in the compute dtype at W, times
// dout[e] (emitter e's decoder output).  A warp per (emitter, chunk)
// (rnnt_cluster.cuh::chunk_dot); lanes l % 4 == 0 add the bias and push
// the column into every rank's next buffer.

template <bool BF>
__device__ __forceinline__ void refresh_beams(const Args& a, const unsigned char* W, int count,
                                              int chunk0, const float* dout, int dstride,
                                              const float* bias, float* dnext,
                                              const int* emitters, int n_emit) {
  const int lane = threadIdx.x % 32;
  for (int it = threadIdx.x / 32; it < n_emit * count; it += kWarps) {
    const int e = it / count, ch = it - e * count;
    const float v1 = chunk_dot<BF>(W + (size_t)ch * a.D * (BF ? 16 : 32),
                                   dout + (size_t)e * dstride, a.D, lane);
    const int j = (chunk0 + ch) * 8 + chunk_col(lane);
    if ((lane & 3) == 0 && j < a.J) {
      const float v = BF ? bf16_round(bf16_round(v1) + bias[j]) : v1 + bias[j];
      float* dst = dnext + (size_t)emitters[e] * a.Jp + j;
#pragma unroll
      for (int r = 0; r < kCL; ++r) st_cluster(map_rank(dst, r), v);
    }
  }
}

// ---------------------------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1) rnnt_beam_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& P = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* dproj = reinterpret_cast<float*>(smem + P.dproj);  // [2][K][Jp]
  float* dout = reinterpret_cast<float*>(smem + P.dout);    // [K][Dp]
  int* hist = reinterpret_cast<int*>(smem + P.hist);        // [2][K][C] contexts
  BeamSmem& s = *reinterpret_cast<BeamSmem*>(smem + P.beam);
  float4* part = reinterpret_cast<float4*>(smem + P.part);  // [2][kCL][kRows]
  Cand* top = reinterpret_cast<Cand*>(smem + P.top);        // [2][kCL][kRows + 1]
  Cand* rowtop = reinterpret_cast<Cand*>(smem + P.rowtop);  // [kRows][kRows]
  float* L = reinterpret_cast<float*>(smem + P.logits);     // [K][ls]
  float4* scratch = reinterpret_cast<float4*>(smem + P.scratch);
  float* bias_w = reinterpret_cast<float*>(smem + P.bias_w);  // output.b, this rank's columns
  float* bias_d = reinterpret_cast<float*>(smem + P.bias_d);  // decoder_proj.b, likewise
  unsigned char* tile = smem + P.tile;
  unsigned char* wres = smem + P.wres;
  unsigned char* wring = smem + P.wring;
  unsigned char* dres = smem + P.dres;
  unsigned char* dring = smem + P.dring;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cluster_rank(), b = cluster_index();
  const int K = a.K, V = a.V, Jp = a.Jp, C = a.C;
  const int Dp = round_up(a.D, 4);
  const int len = (int)min(max(a.lens[b], 0LL), (long long)a.T);
  const long long offset = a.offset[b];

  const Shares sh(P, a.Vp / 8, a.Jp / 8, rank, a.out_w, a.dec_w);
  const int col0 = sh.w0 * 8, col1 = min(V, (sh.w0 + sh.nw) * 8);  // this rank's columns
  int owner = 0;  // the rank whose share holds the blank column
  while (owner + 1 < kCL && share_lo(a.Vp / 8, owner + 1) * 8 <= a.blank) ++owner;
  auto issue_w = [&](int k) { sh.issue_w(P, wring, bars, k); };
  auto issue_d = [&](int k) { sh.issue_d(P, dring, bars, k); };

  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t res_bytes = (uint32_t)(sh.w_res * P.uw + sh.d_res * P.ud);
  if (tid == 0) {
    if (res_bytes) {
      mbar_expect(bars + kBarRes, res_bytes);
      if (sh.w_res)
        bulk_load(wres, sh.out_w + (size_t)sh.w0 * P.uw, (uint32_t)sh.w_res * P.uw, bars + kBarRes);
      if (sh.d_res)
        bulk_load(dres, sh.dec_w + (size_t)sh.c0 * P.ud, (uint32_t)sh.d_res * P.ud, bars + kBarRes);
    }
    for (int k = 0; k < P.depth; ++k) {
      if (sh.w_st) issue_w(k);
      if (sh.d_st) issue_d(k);
    }
  }
  for (int i = tid; i < sh.nw * 8; i += kThreads) bias_w[i] = a.out_b[col0 + i];
  for (int i = tid; i < sh.nd * 8; i += kThreads) bias_d[i] = a.dec_b[sh.c0 * 8 + i];
  for (int i = tid; i < K * Jp; i += kThreads) {
    const int k = i / Jp, j = i - k * Jp;
    float x = 0.f;
    if (j < a.J) {
      const size_t at = ((size_t)b * K + k) * a.J + j;
      x = BF ? __bfloat162float(static_cast<const bf16*>(a.dec_proj_in)[at])
             : static_cast<const float*>(a.dec_proj_in)[at];
    }
    dproj[i] = x;
  }
  for (int i = tid; i < K * C; i += kThreads) hist[i] = (int)a.hyp_in[(size_t)b * K * C + i];
  {
    const int words = BF ? kRows * (Jp + 8) / 2 : K * Jp;
    for (int i = tid; i < words; i += kThreads) reinterpret_cast<float*>(tile)[i] = 0.f;
  }
  if (tid < K) {
    s.score[0][tid] = a.score_in[(size_t)b * K + tid];
    s.cnt[0][tid] = a.count_in[(size_t)b * K + tid];
    s.anc[0][tid] = tid;
  }
  if (res_bytes) mbar_wait(bars + kBarRes, 0);
  cluster_sync();  // every block of the cluster has started and holds its state

  const float* ob = bias_w - col0;   // indexed by global column
  const float* db = bias_d - sh.c0 * 8;
  int cur = 0, kw = 0, kd = 0;       // the beams' buffer; ring stages consumed
  int trip_end = 0;                  // the current trip's frames end here
  for (int t = 0; t < len; ++t) {
    const int par = t & 1;           // the exchange slots' buffer
    const bool fresh = t >= trip_end;  // a trip starts at t
    if (fresh) trip_end = min(min(t, a.T - a.W) + a.W, len);
    const float* dcur = dproj + (size_t)cur * K * Jp;

    // 1. stage the joiner's input: row k = tanh(enc[t] + dec_proj_k)
    if (BF) {
      bf16* sA = reinterpret_cast<bf16*>(tile);
      const bf16* enc = static_cast<const bf16*>(a.enc) + ((size_t)b * a.T + t) * a.J;
      const int half = Jp / 2;
      for (int i = tid; i < K * half; i += kThreads) {
        const int k = i / half, j = 2 * (i - k * half);
        const float* d = dcur + (size_t)k * Jp;
        const float x0 = j < a.J ? tanhf(bf16_round(__bfloat162float(enc[j]) + d[j])) : 0.f;
        const float x1 = j + 1 < a.J ? tanhf(bf16_round(__bfloat162float(enc[j + 1]) + d[j + 1])) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(sA + k * (Jp + 8) + j) = __floats2bfloat162_rn(x0, x1);
      }
    } else {
      float* sA = reinterpret_cast<float*>(tile);
      const float* enc = static_cast<const float*>(a.enc) + ((size_t)b * a.T + t) * a.J;
      for (int i = tid; i < K * Jp; i += kThreads) {
        const int k = i / Jp, j = i - k * Jp;
        sA[i] = j < a.J ? tanhf(enc[j] + dcur[i]) : 0.f;
      }
    }
    __syncthreads();

    // 2. this rank's logits, every row
    if (BF) {
      const bf16* sA = reinterpret_cast<const bf16*>(tile);
      auto keep = [&](int c0, const float (&acc)[4]) { store_bf16(a, c0, acc, ob, L, col0); };
      logits_bf16(Jp, reinterpret_cast<const uint2*>(wres), sh.w_res, col0, sA, scratch,
                  sh.w_st > 0, keep);
      for (int g = 0; g < sh.w_st; ++g, ++kw) {
        ring_wait(bars, kBarW, P.depth, kw);
        const int u = g * P.sw;
        logits_bf16(Jp, reinterpret_cast<const uint2*>(wring + (size_t)(kw % P.depth) * P.sw * P.uw),
                    min(P.sw, sh.w_str - u), col0 + (sh.w_res + u) * 8, sA, scratch, false, keep);
        __syncthreads();
        if (tid == 0) issue_w(kw + P.depth);
      }
    } else {
      const float* sA = reinterpret_cast<const float*>(tile);
      logits_f32(a, reinterpret_cast<const float*>(wres), sh.w_res, col0, sA, ob, L, col0);
      for (int g = 0; g < sh.w_st; ++g, ++kw) {
        ring_wait(bars, kBarW, P.depth, kw);
        const int u = g * P.sw;
        logits_f32(a, reinterpret_cast<const float*>(wring + (size_t)(kw % P.depth) * P.sw * P.uw),
                   min(P.sw, sh.w_str - u), col0 + (sh.w_res + u) * 8, sA, ob, L, col0);
        __syncthreads();
        if (tid == 0) issue_w(kw + P.depth);
      }
    }
    __syncthreads();

    // 3. each row's (max, sum of exps) over this rank's columns, and the
    // blank logit from its owner, pushed into this rank's slot everywhere
    if (warp < K) {
      const float* row = L + warp * P.ls - col0;
      float m = -INFINITY;
      for (int c = col0 + lane; c < col1; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int c = col0 + lane; c < col1; c += 32) sum += expf(row[c] - m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float lb = rank == owner ? row[a.blank] : 0.f;
      if (lane < kCL) st_cluster(map_rank(part + (par * kCL + rank) * kRows + warp, lane),
                                 make_float4(m, sum, lb, 0.f));
    }
    cluster_sync();

    // 4. (warp 0, lane k) row k's log-sum-exp merged over the ranks in rank
    // order, its blank log-prob, the trip's sums and the two sort orders
    if (warp == 0) {
      const int k = lane;
      float sk = 0.f, fv = 0.f, mb = INFINITY;
      if (k < K) {
        const float4* pk = part + par * kCL * kRows + k;
        float M = -INFINITY;
        for (int r = 0; r < kCL; ++r) M = fmaxf(M, pk[r * kRows].x);
        float S = 0.f;
        for (int r = 0; r < kCL; ++r) S += pk[r * kRows].y * expf(pk[r * kRows].x - M);
        const float ls = logf(S);
        const float blp = forbidden(a.blank, a) ? kNegInf : (pk[owner * kRows].z - M) - ls;
        const float ci = (fresh ? 0.f : s.cumi[k]) + blp, ce = ci - blp;
        s.cumi[k] = ci;
        s.cume[k] = ce;
        s.mrow[k] = M;
        s.lse[k] = ls;
        sk = s.score[cur][k] + ce;
        fv = s.score[cur][k] + ci;
        mb = fv;
        s.foldv[k] = fv;
      }
      int pos = 0, fpos = 0;
      for (int j = 0; j < K; ++j) {
        const float skj = __shfl_sync(0xffffffffu, sk, j), fvj = __shfl_sync(0xffffffffu, fv, j);
        pos += better(skj, j, sk, k);
        fpos += better(fvj, j, fv, k);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mb = fminf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      if (k < K) {
        s.inv[k] = pos;
        s.perm[pos] = k;
        s.fperm[fpos] = k;
      }
      if (lane == 0) s.min_blank = mb;
    }
    __syncthreads();

    // 5. (warp k) row k's K best candidates in this rank, by the sorted
    // order's flat index, and its best non-blank value
    if (warp < K) {
      const int k = warp;
      const float* row = L + k * P.ls - col0;
      const float base = s.score[cur][k] + s.cume[k], M = s.mrow[k], ls = s.lse[k];
      const int flat0 = s.inv[k] * V;
      auto cand = [&](int c) {
        const float lp = forbidden(c, a) ? kNegInf : (row[c] - M) - ls;
        return base + lp;
      };
      const Cand mine = warp_top_k(K, col1 - col0, [&](int i) {
        return Cand{cand(col0 + i), flat0 + col0 + i};
      });
      if (lane < K) rowtop[k * kRows + lane] = mine;
      float mx = -INFINITY;
      for (int c = col0 + lane; c < col1; c += 32)
        if (c != a.blank) mx = fmaxf(mx, cand(c));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) s.rowmax[k] = mx;
    }
    __syncthreads();

    // 6a. (warp 0) this rank's K best over the rows and its best non-blank,
    // pushed into its slot everywhere
    if (warp == 0) {
      const Cand mine = warp_top_k(K, K * K, [&](int i) {
        return rowtop[(i / K) * kRows + i % K];
      });
      float mx = -INFINITY;
      for (int k = 0; k < K; ++k) mx = fmaxf(mx, s.rowmax[k]);
      Cand* slot = top + (par * kCL + rank) * (kRows + 1);
      if (lane < K)
        for (int r = 0; r < kCL; ++r) st_cluster(map_rank(slot + lane, r), mine);
      if (lane == K)
        for (int r = 0; r < kCL; ++r) st_cluster(map_rank(slot + kRows, r), Cand{mx, 0});
    }
    cluster_sync();

    // 6b. (warp 0, lane k') the frame's branch and, on a step, new beam k'
    if (warp == 0) {
      const Cand* slots = top + par * kCL * (kRows + 1);
      float gmax = -INFINITY;
      for (int r = 0; r < kCL; ++r) gmax = fmaxf(gmax, slots[r * (kRows + 1) + kRows].v);
      const int kind = gmax >= s.min_blank ? 1 : (t == trip_end - 1 ? 2 : 0);
      const Cand best = warp_top_k(kind == 1 ? K : 0, kCL * K, [&](int i) {
        return slots[(i / K) * (kRows + 1) + i % K];
      });
      const int k = lane;
      int parent = k, tok = a.blank, stored = 0;
      float value = k < K ? s.score[cur][k] : 0.f;
      if (kind == 1) {
        const int sp = best.i / V;
        parent = k < K ? s.perm[sp] : 0;
        tok = best.i - sp * V;
        value = best.v;
      } else if (kind == 2) {
        parent = k < K ? s.fperm[k] : 0;
        value = k < K ? s.foldv[parent] : 0.f;
      }
      const bool emit = k < K && kind == 1 && tok != a.blank;
      const unsigned mask = __ballot_sync(0xffffffffu, emit);
      if (k < K) {
        const int nxt = cur ^ 1;
        stored = emit && s.cnt[cur][parent] < a.U;
        if (kind) {
          s.parent[k] = parent;
          s.token[k] = tok;
          s.value[k] = value;
          s.score[nxt][k] = value;
          s.cnt[nxt][k] = s.cnt[cur][parent] + stored;
          s.anc[nxt][k] = s.anc[cur][parent];
          if (emit) s.emitters[__popc(mask & ((1u << k) - 1))] = k;
        }
        if (rank == 0) {
          const size_t at = ((size_t)b * a.T + t) * K + k;
          a.steps[at] = step_entry(tok, kind, stored, parent);
          if (a.values) a.values[at] = value;
        }
      }
      if (lane == 0) {
        s.kind = kind;
        s.n_emit = __popc(mask);
      }
    }
    __syncthreads();

    // 7. the step: the new beams' contexts and decoder outputs
    const int kind = s.kind;
    if (kind == 0) continue;
    const int nxt = cur ^ 1, n_emit = s.n_emit;
    float* dnext = dproj + (size_t)nxt * K * Jp;
    for (int i = tid; i < K * C; i += kThreads) {
      const int k = i / C, c = i - k * C, p = s.parent[k];
      const bool emit = kind == 1 && s.token[k] != a.blank;
      const int* hp = hist + ((size_t)cur * K + p) * C;
      hist[(size_t)nxt * K * C + i] = emit ? (c + 1 < C ? hp[c + 1] : s.token[k]) : hp[c];
    }
    for (int i = tid; i < K * Jp; i += kThreads) {
      const int k = i / Jp, j = i - k * Jp;
      if (!(kind == 1 && s.token[k] != a.blank)) dnext[i] = dcur[(size_t)s.parent[k] * Jp + j];
    }
    if (n_emit) {
      // dout[e] = relu(sum_c tables[c][h_c]), h the emitter's new context
      for (int i = tid; i < n_emit * a.D; i += kThreads) {
        const int e = i / a.D, d = i - e * a.D, k = s.emitters[e];
        const int* hp = hist + ((size_t)cur * K + s.parent[k]) * C;
        float sum = 0.f;
        for (int c = 0; c < C; ++c) {
          int h = c + 1 < C ? hp[c + 1] : s.token[k];
          h = h < 0 ? a.blank : h;
          const float x = __ldg(a.tables + ((size_t)c * V + h) * a.D + d);
          sum = c == 0 ? x : sum + x;
        }
        sum = fmaxf(sum, 0.f);
        dout[(size_t)e * Dp + d] = BF ? bf16_round(sum) : sum;
      }
      __syncthreads();
      refresh_beams<BF>(a, dres, sh.d_res, sh.c0, dout, Dp, db, dnext, s.emitters, n_emit);
      for (int g = 0; g < sh.d_st; ++g, ++kd) {
        ring_wait(bars, kBarD, P.depth, kd);
        const int u = g * P.sd;
        refresh_beams<BF>(a, dring + (size_t)(kd % P.depth) * P.sd * P.ud,
                          min(P.sd, sh.d_str - u), sh.c0 + sh.d_res + u, dout, Dp, db, dnext,
                          s.emitters, n_emit);
        __syncthreads();  // the stage's ring slot is read: refill it
        if (tid == 0) issue_d(kd + P.depth);
      }
      cluster_sync();
    } else {
      __syncthreads();
    }
    cur = nxt;
    trip_end = t + 1;  // the next frame starts a trip
  }

  // every bulk copy still in flight lands, and no remote write is pending,
  // before a block may exit
  if (tid == 0) {
    for (int k = kw; k < kw + P.depth && sh.w_st; ++k) ring_wait(bars, kBarW, P.depth, k);
    for (int k = kd; k < kd + P.depth && sh.d_st; ++k) ring_wait(bars, kBarD, P.depth, k);
  }
  __syncthreads();
  cluster_sync();
  if (rank != 0) return;

  const float* dfin = dproj + (size_t)cur * K * Jp;
  for (int i = tid; i < K * a.J; i += kThreads) {
    const int k = i / a.J, j = i - k * a.J;
    const size_t at = (size_t)b * K * a.J + i;
    if (BF)
      static_cast<bf16*>(a.dec_proj)[at] = __float2bfloat16_rn(dfin[(size_t)k * Jp + j]);
    else
      static_cast<float*>(a.dec_proj)[at] = dfin[(size_t)k * Jp + j];
  }
  for (int i = tid; i < K * C; i += kThreads)
    a.hyp[(size_t)b * K * C + i] = hist[(size_t)cur * K * C + i];
  if (tid < K) {
    a.score[(size_t)b * K + tid] = s.score[cur][tid];
    a.count[(size_t)b * K + tid] = s.cnt[cur][tid];
  }
  // each final beam's buffers: its ancestor's row, then the tokens stored
  // along its ancestry, walked back through the frames' choices
  if (warp < K) {
    const int k = warp, anc = s.anc[cur][k];
    const size_t src = ((size_t)b * K + anc) * a.U, dst = ((size_t)b * K + k) * a.U;
    for (int u = lane; u < a.U; u += 32) {
      a.tokens[dst + u] = a.tokens_in[src + u];
      a.timestamps[dst + u] = a.ts_in[src + u];
    }
    __syncwarp();
    if (lane == 0) {
      long long pos = s.cnt[cur][k];
      int idx = k;
      for (int t = len - 1; t >= 0; --t) {
        const int e = a.steps[((size_t)b * a.T + t) * K + idx];
        if ((e >> 4) & 1) {
          --pos;
          a.tokens[dst + pos] = e >> 7;
          a.timestamps[dst + pos] = offset + t;
        }
        idx = e & 15;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The plan: the fixed parts (barriers, both buffers of decoder outputs, the
// emitters' decoder outputs, the contexts, the beam state, the two exchanges'
// slots, the rows' best candidates, the logits, the scratch, the biases,
// the tile), then the weights (rnnt_cluster.cuh::place_weights).  Mirrored
// by decode/rnnt_beam.py::plan_bytes.

template <bool BF>
bool make_plan(int J, int D, int V, int C, int K, int limit, Plan& p) {
  const int Jp = round_up(J, 16), Vp = round_up(V, 8), esz = BF ? 2 : 4;
  const int ntw = (Vp / 8 + kCL - 1) / kCL, ntd = (Jp / 8 + kCL - 1) / kCL;
  p = Plan{};
  p.uw = BF ? Jp / 16 * 256 : Jp * 32;
  p.ud = D * 8 * esz;
  p.ls = ntw * 8;
  Layout L;
  p.dproj = L.place(2 * K * Jp * 4);
  p.dout = L.place(K * round_up(D, 4) * 4);
  p.hist = L.place(2 * K * C * 4);
  p.beam = L.place((int)sizeof(BeamSmem));
  p.part = L.place(2 * kCL * kRows * 16);
  p.top = L.place(2 * kCL * (kRows + 1) * (int)sizeof(Cand));
  p.rowtop = L.place(kRows * kRows * (int)sizeof(Cand));
  p.logits = L.place(K * p.ls * 4);
  p.scratch = L.place(BF ? kWarps * kG * 32 * 16 : 0);
  p.bias_w = L.place(ntw * 8 * 4);
  p.bias_d = L.place(ntd * 8 * 4);
  p.tile = L.place(BF ? kRows * (Jp + 8) * 2 : K * Jp * 4);
  return place_weights(p, L, ntw, ntd, limit);
}

template <bool BF>
cudaLaunchConfig_t config(const Plan& p, int B, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  // set once per kernel and device, not per launch
  cudaError_t err = relpos::allow_smem<rnnt_beam_kernel<BF>>(a.p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BF>(a.p, B, attr, stream);
  err = cudaLaunchKernelEx(&cfg, rnnt_beam_kernel<BF>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BF>
cudaError_t describe(const Plan& p, long long* out) {
  cudaError_t err = relpos::allow_smem<rnnt_beam_kernel<BF>>(p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BF>(p, 1, attr, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, rnnt_beam_kernel<BF>, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, rnnt_beam_kernel<BF>);
  if (err != cudaSuccess) return err;
  out[7] = clusters;
  out[8] = fa.numRegs;
  out[9] = (long long)fa.localSizeBytes;
  return cudaSuccess;
}

bool plan_for(int J, int D, int V, int C, int K, int dtype, Plan& p) {
  const int limit = smem_limit();
  return dtype ? make_plan<true>(J, D, V, C, K, limit, p) : make_plan<false>(J, D, V, C, K, limit, p);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (enc_proj, dec_proj and dec_w; the
// tables, biases and scores are float32 either way); the weights as
// rnnt_greedy.cu takes them (decode/rnnt_greedy.py::greedy_operands).  The
// search reads the *_in buffers and writes the others whole; `steps` [B, T, K]
// int32 is its scratch (each frame's choices), `values` [B, T, K] float32
// (may be null) the scores after each frame.  W is the trips' window
// (min(T, window)).  Takes B, V, C, U >= 1, 1 <= K <= 16, T >= W >= 1 and
// the J and D whose plan fits a block's shared memory; returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for shapes it does not
// take).
extern "C" int k2t_rnnt_beam(const void* enc, const void* lens, const void* offset,
                             const void* tables, const void* dec_w, const void* dec_b,
                             const void* out_w, const void* out_b, const void* hyp_in,
                             const void* dec_proj_in, const void* score_in, const void* count_in,
                             const void* tokens_in, const void* ts_in, void* hyp, void* dec_proj,
                             void* score, void* count, void* tokens, void* timestamps, void* steps,
                             void* values, int B, int T, int W, int J, int D, int V, int C, int K,
                             int U, int blank, int skip_sos, int dtype, void* stream) {
  if (B < 1 || T < 1 || W < 1 || W > T || J < 1 || D < 1 || V < 1 || C < 1 || K < 1 ||
      K > kMaxBeams || U < 1 || blank < 0 || blank >= V || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(J, D, V, C, K, dtype, p)) return (int)cudaErrorInvalidValue;
  const Args a{enc, static_cast<const long long*>(lens), static_cast<const long long*>(offset),
               static_cast<const float*>(tables), dec_w, static_cast<const float*>(dec_b),
               out_w, static_cast<const float*>(out_b), static_cast<const long long*>(hyp_in),
               dec_proj_in, static_cast<const float*>(score_in),
               static_cast<const long long*>(count_in), static_cast<const long long*>(tokens_in),
               static_cast<const long long*>(ts_in), static_cast<long long*>(hyp), dec_proj,
               static_cast<float*>(score), static_cast<long long*>(count),
               static_cast<long long*>(tokens), static_cast<long long*>(timestamps),
               static_cast<int*>(steps), static_cast<float*>(values), T, W, J, round_up(J, 16), D,
               V, round_up(V, 8), C, K, U, blank, skip_sos, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<true>(a, B, st) : launch<false>(a, B, st));
}

// What a launch at these shapes would use, for logs: out[0..10] as
// rnnt_greedy.cu's k2t_rnnt_greedy_plan (shared memory bytes per block,
// resident and streamed units, the most units a rank owns, clusters at once,
// registers, local bytes, the rings' stages).
extern "C" int k2t_rnnt_beam_plan(int J, int D, int V, int C, int K, int dtype, long long* out) {
  if (J < 1 || D < 1 || V < 1 || C < 1 || K < 1 || K > kMaxBeams || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(J, D, V, C, K, dtype, p)) return (int)cudaErrorInvalidValue;
  const int Jp = round_up(J, 16), Vp = round_up(V, 8);
  out[0] = p.bytes, out[1] = p.res_w, out[2] = p.res_d, out[3] = p.sw, out[4] = p.sd;
  out[5] = (Vp / 8 + kCL - 1) / kCL, out[6] = (Jp / 8 + kCL - 1) / kCL;
  out[10] = p.depth;
  return (int)(dtype ? describe<true>(p, out) : describe<false>(p, out));
}
