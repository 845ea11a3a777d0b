// Batched RNN-T modified beam search for Hopper (sm_90a): one launch runs
// every lane's whole search on the card, P lanes on each thread-block
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
// ~50 us of tensor-core time for a bf16 16 x 30 s batch at K = 4.  Each
// step depends on the last (the next frame's logits need the refreshed
// decoder outputs), so a lane is a chain of one step per frame and the
// design is bound by a frame's latency: the staging, the product, one
// exchange across the cluster, the top K and, on an emission frame, the
// refresh and its exchange.
//
// Design (rnnt_cluster.cuh, as rnnt_greedy.cu).  A cluster of kCL = 8 blocks
// of 512 threads carries P lanes (the host's choice: the fewest that let
// every lane run in one wave of clusters, P K <= 16); their P K beams are
// the rows of one joiner tile, row p K + k.  Rank r owns a contiguous share
// of W_out's n-tiles and of decoder_proj's chunks, resident in its shared
// memory where they fit, streamed through rings where they do not, read
// once per frame for all P lanes.  Every rank holds every lane's beams'
// decoder outputs (two buffers a lane: this step's and the next) and the
// small beam state, and derives every decision identically.  The cluster
// runs frame t while any of its lanes has frames left; a lane past its
// length takes no step.  Per frame:
//   1. stage tanh(enc[t] + dec_proj) for the live lanes' rows (16 bytes a
//      thread; the next frame's rows of enc prefetched into L1);
//   2. the rank's logits for its columns, every row (bf16: mma.sync;
//      float32: CUDA cores, a thread per column for all rows);
//   3. (a warp per row) the row's (max, sum of exps, blank logit, best
//      allowed non-blank logit) over the rank's columns and its K best
//      columns by (logit descending, column ascending; the forbidden ones
//      after every allowed one), pushed to every rank: the one exchange.
//      Within a row a candidate's value base + ((logit - M) - lse) does not
//      decrease with the logit, so these lists hold each rank's K best by
//      value before M and lse are known;
//   4. (a warp per row) every rank merges the 8 partials in rank order: the
//      log-sum-exp, the blank log-prob, the trip's sums, the row's best
//      non-blank value (the emission test is exact: the max of a
//      non-decreasing function is the function of the max), and the row's K
//      best of the 8 K pushed candidates by (value, column); then (a warp
//      per lane) the beams' sort orders, the branch (no step, an emission
//      step or a window's end) and, on a step, the K best of the rows' by
//      (value, flat index).  Exactness at the cut: a value can collapse two
//      logits (an ulp of a score of thousands is ~2.4e-4); a candidate a
//      rank did not push can only belong in the K best where its list's
//      last pushed value equals the K-th chosen one.  Such a frame is
//      ambiguous: for that lane, every rank takes a second exchange, each
//      rank's K best by (value, flat index), as the design of two exchanges
//      pushed them, and merges those.  Every rank sees the same merged
//      data, so all take the same branch.  A top K of up to 128 candidates
//      ranks them all pairwise in one pass (warp_top_k);
//   5. a step writes the new beams' state (parent gather) into the other
//      buffer; the emitting beams' decoder outputs are recomputed (bf16 with
//      D a multiple of 16: mma.sync, a warp per 8-column chunk; else a warp
//      per (beam, chunk) on the CUDA cores) and pushed into every rank.
// Each push is an st.async that completes its bytes on the receiving rank's
// mbarrier; a rank waits on its own mbarrier for the bytes that the frame's
// branch makes every rank send (the live rows, the ambiguous lanes, the
// emitting beams), not for all 4,096 threads of the cluster.  The cluster
// barriers left are the one at the start and the one before exit.
// The token buffers are not copied per step: each lane's frame choices
// ((parent, token, stored, step kind) per new beam) go into `steps` [B, T,
// K], and at the end each final beam's ancestry is walked back through them,
// writing its new tokens and timestamps behind its launch-start ancestor's
// buffer row (copied whole).  With `values`, the beams' scores after each
// frame are written beside them; testing.py::beam_replay reads both.

#include "relpos_scores.cuh"  // relpos::allow_smem
#include "rnnt_cluster.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace rnnt;

constexpr int kMaxBeams = kRows;  // a cluster's beams are the rows of one joiner tile
constexpr int kMaxLanes = kRows;  // lanes per cluster: P K <= kRows
constexpr float kNegInf = -1e30f;  // decode/rnnt_beam.py NEG_INF
constexpr int kUnk = 2;
constexpr int kNone = INT_MAX;     // an empty list entry's column
// the beam's own mbarriers: the exchange's two (by frame parity), the
// second exchange's two and the refresh's two (by their own counts)
constexpr int kXBar = 0, kSBar = 2, kRBar = 4, kBeamBars = 6;

// The slots and their mbarriers are double-buffered, and no barrier guards
// them.  What makes that safe: a rank pushes a use n + 1 of an exchange only
// after its own reads of use n's slots are done (a block barrier lies
// between), and waits for all 8 ranks' data of use n + 1 before it moves
// on.  So a rank that pushes use n + 2 into slot n % 2 has received every
// rank's use n + 1, which each pushed after reading use n; and the mbarrier
// of slot n % 2 has completed use n's phase at every receiver.  The refresh
// writes straight into the decoder-output buffers under the same rule (a
// lane's buffer that a refresh overwrites was last read in an earlier
// frame, before the reader's next exchange push).

// a cluster's small beam state, the same in every rank
struct BeamSmem {
  // by row p K + k (lane p's beam k)
  long long cnt[2][kRows];      // tokens stored per beam (this buffer, the next)
  long long offset[kMaxLanes];  // by lane: frame_offset
  float score[2][kRows];
  int anc[2][kRows];            // the beam this one descends from at the launch's start
  float cumi[kRows];            // the trip's blank log-probs summed, this frame's included
  float cume[kRows];            // ... and without it
  float mrow[kRows];            // each row's max logit
  float lse[kRows];             // log of its sum of exps
  float base[kRows];            // score + cume
  float foldv[kRows];           // score + cumi
  float rowmax[kRows];          // each row's best non-blank candidate
  float rowlast[kRows];         // the largest last value of the row's full pushed lists
  int inv[kRows];               // beam k's position in its lane's order by score + cume
  int perm[kRows];              // lane p's beam at position i of that order: [p K + i]
  int fperm[kRows];             // ... of the order by score + cumi
  int parent[kRows], token[kRows];  // the step's new beams
  float value[kRows];
  int emit[kRows];              // the new beam appends a token
  // by lane p
  int lane[kMaxLanes], len[kMaxLanes], trip_end[kMaxLanes];
  int kind[kMaxLanes];          // 0 no step, 1 an emission step, 2 a window's end
  int amb[kMaxLanes];           // the step's K best need the second exchange
  int second[kMaxLanes];        // frames that took it
};
static_assert(sizeof(BeamSmem) == 1984, "decode/rnnt_beam.py::_BEAM_SMEM mirrors this size");

struct Plan : WeightPlan {
  int ls;  // the logits' row stride: the most columns a rank owns
  int lanes, rows;  // P, P K
  int xbars, dproj, hist, beam, part, lists, fb, rowtop, sel, logits, bias_w, bias_d, tile, scratch,
      dout;
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
  int* second;                  // [B] frames that took the second exchange, or null
  int B, T, W, J, Jp, D, V, Vp, C, K, U, blank, skip_sos;
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int nth_bit(unsigned m, int e) {
  for (; e > 0; --e) m &= m - 1;
  return __ffs(m) - 1;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the phase of bar with this parity has completed.  A wait of
// kWaitTrapNs of wall time (a protocol fault: bytes that never come) traps:
// the launch fails, and the trap's error ends the process's CUDA context,
// instead of the card hanging.  The limit is wall time, far past any frame
// (microseconds), so a card shared with other work or time-sliced only
// slows the search.
constexpr unsigned long long kWaitTrapNs = 60ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  unsigned long long t0 = 0;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) break;
    const unsigned long long now = globaltimer_ns();
    if (!t0)
      t0 = now;
    else if (now - t0 > kWaitTrapNs)
      __trap();
  }
}

// A value as a 32-bit key whose unsigned order is better()'s: every NaN the
// largest, -0 as +0; 0 is no value's key
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One warp: the K best of n candidates get(i), i < n (distinct indices), in
// the order of better(); lane r < K returns the r-th (the sentinel {-inf,
// INT_MAX} where fewer than r + 1 exist).
//
// Up to 128 candidates: each lane keys its share once, in registers, and
// counts for each how many of the n beat it (all pairs, through shuffles
// that do not wait on one another); the candidate beaten by r others is the
// r-th, and goes through the warp's slots to lane r.  Past that: K rounds, each taking the best of those after the last
// one taken (the largest key, then the lowest index, by two warp
// reductions), keying the candidates again each round.
template <class Get>
__device__ __forceinline__ Cand warp_top_k_rounds(int K, int n, Get get) {
  const int lane = threadIdx.x & 31;
  unsigned pk = 0xffffffffu;  // the last one taken
  int pi = -1;
  Cand mine{-INFINITY, INT_MAX};
  for (int r = 0; r < K; ++r) {
    unsigned bk = 0;  // this lane's best after it
    int bi = INT_MAX;
    float bv = -INFINITY;
    for (int i = lane; i < n; i += 32) {
      const Cand c = get(i);
      const unsigned k = order_key(c.v);
      if ((k < pk || (k == pk && c.i > pi)) && (k > bk || (k == bk && c.i < bi))) {
        bk = k;
        bi = c.i;
        bv = c.v;
      }
    }
    const unsigned mk = __reduce_max_sync(0xffffffffu, bk);
    const int mi = __reduce_min_sync(0xffffffffu, bk == mk ? bi : INT_MAX);
    const unsigned at = __ballot_sync(0xffffffffu, bk == mk && bi == mi);
    const float mv = __shfl_sync(0xffffffffu, bv, __ffs(at) - 1);
    if (lane == r && mk) mine = Cand{mv, mi};
    pk = mk;
    pi = mi;
  }
  return mine;
}

template <int NPL, class Get>
__device__ __forceinline__ Cand warp_top_k_pairs(int K, int n, Get get, Cand* slot) {
  const int lane = threadIdx.x & 31;
  unsigned key[NPL];  // 0: no candidate (it loses to every one)
  int idx[NPL], beaten[NPL];
  float val[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int i = lane + 32 * j;
    key[j] = 0, idx[j] = INT_MAX, val[j] = -INFINITY, beaten[j] = 0;
    if (i < n) {
      const Cand c = get(i);
      key[j] = order_key(c.v), idx[j] = c.i, val[j] = c.v;
    }
  }
#pragma unroll
  for (int j2 = 0; j2 < NPL; ++j2) {
#pragma unroll 8
    for (int src = 0; src < 32; ++src) {
      const unsigned ok = __shfl_sync(0xffffffffu, key[j2], src);
      const int oi = __shfl_sync(0xffffffffu, idx[j2], src);
#pragma unroll
      for (int j = 0; j < NPL; ++j) beaten[j] += ok > key[j] || (ok == key[j] && oi < idx[j]);
    }
  }
  if (lane < K) slot[lane] = Cand{-INFINITY, INT_MAX};
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NPL; ++j)
    if (key[j] && beaten[j] < K) slot[beaten[j]] = Cand{val[j], idx[j]};
  __syncwarp();
  const Cand mine = lane < K ? slot[lane] : Cand{-INFINITY, INT_MAX};
  __syncwarp();
  return mine;
}

// the warp's K best (above); `slot` is kRows entries of the warp's scratch
template <class Get>
__device__ __forceinline__ Cand warp_top_k(int K, int n, Get get, Cand* slot) {
  if (n <= 32) return warp_top_k_pairs<1>(K, n, get, slot);
  if (n <= 64) return warp_top_k_pairs<2>(K, n, get, slot);
  if (n <= 128) return warp_top_k_pairs<4>(K, n, get, slot);
  return warp_top_k_rounds(K, n, get);
}

// One warp: `mine` (lane e < K holds entry e) into entries [0, K) at `slot`
// in every rank, each completing on that rank's mbarrier `bar`
__device__ __forceinline__ void push_list(Cand mine, int K, const Cand* slot, const uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < kCL * K; i0 += 32) {
    const int i = i0 + lane, e = i % K, q = i / K;
    const Cand c = shfl_cand(mine, e);
    if (i < kCL * K) st_async(map_rank(slot + e, q), c, map_rank(bar, q));
  }
}

// ---------------------------------------------------------------------------
// The bf16 joiner's epilogue (rnnt_cluster.cuh::logits_bf16): every logit of
// the rows kept, L[row][col - lcol0]; bias[col] is output.b at the global
// column.

__device__ __forceinline__ void store_bf16(const Args& a, int rows, int c0, const float (&acc)[4],
                                           const float* bias, float* L, int lcol0) {
  const int lane = threadIdx.x & 31, tig = lane & 3, r = lane >> 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r + 8 * (e >> 1), col = c0 + 2 * tig + (e & 1);
    if (row < rows && col < a.V)
      L[row * a.p.ls + col - lcol0] = bf16_round(bf16_round(acc[e]) + bias[col]);
  }
}

// The joiner on the CUDA cores (float32): sA is [RT][Jp] (rows past `rows`
// zero); W holds `count` n-tiles [count][Jp][8].  A thread per column reads
// its column once for all rows; each row's J sum runs in four chains
// (j = e mod 4), as a thread per (column, row) sums it, so every
// logit is bit for bit the same.
template <int RT>
__device__ __forceinline__ void logits_f32(const Args& a, int rows, const float* W, int count,
                                           int col0, const float* sA, const float* bias,
                                           float* L, int lcol0) {
  for (int cl = threadIdx.x; cl < count * 8; cl += kThreads) {
    const int col = col0 + cl;
    if (col >= a.V) continue;
    const float* w = W + (size_t)(cl >> 3) * a.Jp * 8 + (cl & 7);
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    int j = 0;
    for (; j + 4 <= a.J; j += 4) {
      const float w0 = w[(size_t)j * 8], w1 = w[(size_t)(j + 1) * 8], w2 = w[(size_t)(j + 2) * 8],
                  w3 = w[(size_t)(j + 3) * 8];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sA + (size_t)r * a.Jp + j);
        acc[r][0] = fmaf(x.x, w0, acc[r][0]);
        acc[r][1] = fmaf(x.y, w1, acc[r][1]);
        acc[r][2] = fmaf(x.z, w2, acc[r][2]);
        acc[r][3] = fmaf(x.w, w3, acc[r][3]);
      }
    }
    for (; j < a.J; ++j) {
      const float wj = w[(size_t)j * 8];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r][0] = fmaf(sA[(size_t)r * a.Jp + j], wj, acc[r][0]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < rows)
        L[r * a.p.ls + col - lcol0] = ((acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3])) + bias[col];
  }
}

// ---------------------------------------------------------------------------
// The refresh of the emitting beams' decoder outputs: `count` chunks of 8
// columns (the first chunk0), each [D][8] in the compute dtype at W, times
// dout[e] (emitter e's decoder output; emitter e is row nth_bit(emask, e)).
// A warp per (emitter, chunk) (rnnt_cluster.cuh::chunk_dot, which leaves
// column c in lane 4 c); lane l < 8 (bf16: the 8 columns) or < 16 (float32:
// half the chunk each) gathers 16 bytes and pushes them into rank l % 8's
// next buffer, completing on its mbarrier `bar`.

template <bool BF, class DT>
__device__ __forceinline__ void refresh_beams(const Args& a, const unsigned char* W, int count,
                                              int chunk0, const float* dout, int dstride,
                                              const float* bias, DT* dproj, unsigned emask,
                                              int n_emit, unsigned curmask, const uint64_t* bar) {
  const int lane = threadIdx.x % 32, K = a.K;
  constexpr int kPer = 16 / sizeof(DT);  // columns a 16-byte push carries: 8 bf16, 4 float32
  const int h = BF ? 0 : (lane >> 3) & 1;  // float32: lanes 8-15 push the chunk's second half
  for (int it = threadIdx.x / 32; it < n_emit * count; it += kWarps) {
    const int e = it / count, ch = it - e * count;
    const float v1 = chunk_dot<BF>(W + (size_t)ch * a.D * (BF ? 16 : 32),
                                   dout + (size_t)e * dstride, a.D, lane);
    float x[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float y = __shfl_sync(0xffffffffu, v1, 4 * (kPer * h + i));
      const int j = (chunk0 + ch) * 8 + kPer * h + i;
      x[i] = j < a.J ? (BF ? bf16_round(bf16_round(y) + bias[j]) : y + bias[j]) : 0.f;
    }
    float4 v;
    if (BF) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      v = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                      __uint_as_float(w[3]));
    } else {
      v = make_float4(x[0], x[1], x[2], x[3]);
    }
    if (lane < 8 * (8 / kPer)) {
      const int r = nth_bit(emask, e), p = r / K, k = r - p * K;
      const int nxt = ((curmask >> p) & 1) ^ 1, q = lane & 7;
      DT* dst = dproj + ((size_t)(p * 2 + nxt) * K + k) * a.Jp + (chunk0 + ch) * 8 + kPer * h;
      st_async(map_rank(dst, q), v, map_rank(bar, q));
    }
  }
}

// The same on the tensor cores (bf16, D a multiple of 16): sA [16][D + 8]
// holds emitter e's decoder output in row e (the A operand, ldmatrix);
// each chunk [D][8] is the B operand (k = d, n = column: ldmatrix .trans).
// A warp per chunk, the D sum in two chains (even and odd k-steps); the
// four lanes of a quad hold a row's 8 columns, gather them, and push them
// into two ranks each.

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void refresh_mma(const Args& a, const unsigned char* W, int count,
                                            int chunk0, const bf16* sA, const float* bias,
                                            bf16* dproj, unsigned emask, int n_emit,
                                            unsigned curmask, const uint64_t* bar) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = a.K, q = lane & 3;
  const int AS = a.D + 8, KS = a.D / 16;
  const bf16* pa = sA + (lane & 15) * AS + (lane >> 4) * 8;
  for (int ch = warp; ch < count; ch += kWarps) {
    const bf16* w = reinterpret_cast<const bf16*>(W) + ((size_t)ch * a.D + (lane & 15)) * 8;
    float acc[2][4] = {};
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4], b[2];
      ldsm_x4(af, pa + ks * 16);
      ldsm_x2_trans(b, w + (size_t)ks * 16 * 8);
      mma_bf16(acc[ks & 1], af, b[0], b[1]);
    }
    // lane: rows lane / 4 (h = 0) and lane / 4 + 8 (h = 1), columns 2 q + {0, 1}
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = (chunk0 + ch) * 8 + 2 * q + e;
        const float v = acc[0][2 * h + e] + acc[1][2 * h + e];
        y[e] = j < a.J ? bf16_round(bf16_round(v) + bias[j]) : 0.f;
      }
      const __nv_bfloat162 y2 = __floats2bfloat162_rn(y[0], y[1]);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(&y2);
      uint32_t w4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w4[i] = __shfl_sync(0xffffffffu, word, (lane & ~3) + i);
      const int e = lane / 4 + 8 * h;
      if (e < n_emit) {
        const int r = nth_bit(emask, e), p = r / K, k = r - p * K;
        bf16* dst = dproj + ((size_t)(p * 2 + (((curmask >> p) & 1) ^ 1)) * K + k) * a.Jp +
                    (chunk0 + ch) * 8;
        const float4 v = make_float4(__uint_as_float(w4[0]), __uint_as_float(w4[1]),
                                     __uint_as_float(w4[2]), __uint_as_float(w4[3]));
#pragma unroll
        for (int i = 0; i < 2; ++i) st_async(map_rank(dst, 2 * q + i), v, map_rank(bar, 2 * q + i));
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <bool BF, int RT>
__global__ void __launch_bounds__(kThreads, 1) rnnt_beam_kernel(const Args a) {
  using DT = typename std::conditional<BF, bf16, float>::type;  // a decoder output's element
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& P = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* xb = reinterpret_cast<uint64_t*>(smem + P.xbars);
  DT* dproj = reinterpret_cast<DT*>(smem + P.dproj);        // [NL][2][K][Jp]
  float* dout = reinterpret_cast<float*>(smem + P.dout);    // [R][Dp], over the tile
  int* hist = reinterpret_cast<int*>(smem + P.hist);        // [NL][2][K][C] contexts
  BeamSmem& s = *reinterpret_cast<BeamSmem*>(smem + P.beam);
  float4* part = reinterpret_cast<float4*>(smem + P.part);  // [2][kCL][R] (max, sum, blank, nb)
  Cand* lists = reinterpret_cast<Cand*>(smem + P.lists);    // [2][kCL][R][K] (logit, column)
  Cand* fb = reinterpret_cast<Cand*>(smem + P.fb);          // [2][kCL][NL][K] (value, flat)
  Cand* rowtop = reinterpret_cast<Cand*>(smem + P.rowtop);  // [R][K]
  Cand* sel = reinterpret_cast<Cand*>(smem + P.sel);        // [kWarps][kRows] top-K scratch
  float* L = reinterpret_cast<float*>(smem + P.logits);     // [R][ls]
  float4* scratch = reinterpret_cast<float4*>(smem + P.scratch);
  float* bias_w = reinterpret_cast<float*>(smem + P.bias_w);  // output.b, this rank's columns
  float* bias_d = reinterpret_cast<float*>(smem + P.bias_d);  // decoder_proj.b, likewise
  unsigned char* tile = smem + P.tile;
  unsigned char* wres = smem + P.wres;
  unsigned char* wring = smem + P.wring;
  unsigned char* dres = smem + P.dres;
  unsigned char* dring = smem + P.dring;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cluster_rank(), cl = cluster_index();
  const int K = a.K, V = a.V, Jp = a.Jp, C = a.C, NL = P.lanes, R = P.rows;
  const int Dp = round_up(a.D, 4);
  const int nl = min(NL, a.B - cl * NL);  // the lanes this cluster carries
  auto drow = [&](int p, int buf, int k) { return dproj + ((size_t)(p * 2 + buf) * K + k) * Jp; };
  auto hrow = [&](int p, int buf, int k) { return hist + ((size_t)(p * 2 + buf) * K + k) * C; };

  const Shares sh(P, a.Vp / 8, a.Jp / 8, rank, a.out_w, a.dec_w);
  const int col0 = sh.w0 * 8, col1 = min(V, (sh.w0 + sh.nw) * 8);  // this rank's columns
  int owner = 0;  // the rank whose share holds the blank column
  while (owner + 1 < kCL && share_lo(a.Vp / 8, owner + 1) * 8 <= a.blank) ++owner;
  auto ncols = [&](int q) {  // rank q's columns
    return min(V, share_lo(a.Vp / 8, q + 1) * 8) - min(V, share_lo(a.Vp / 8, q) * 8);
  };
  // a forbidden non-blank column exists: the rows' best non-blank candidate
  // is at least base + NEG_INF
  const bool forb_nb = (V > kUnk && a.blank != kUnk) || (a.skip_sos && V > 1 && a.blank != 1);
  auto issue_w = [&](int k) { sh.issue_w(P, wring, bars, k); };
  auto issue_d = [&](int k) { sh.issue_d(P, dring, bars, k); };

  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i);
    for (int i = 0; i < kBeamBars; ++i) mbar_init(xb + i);
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
  // the cluster's lanes: with P > 1, the lanes ranked by length (the
  // longest first, ties by index), cluster c taking ranks c P .. c P + P - 1,
  // so that lanes of like lengths share a cluster (the host reads no length)
  auto len_of = [&](int b) { return (int)min(max(a.lens[b], 0LL), (long long)a.T); };
  if (NL == 1) {
    if (tid == 0) s.lane[0] = cl;
  } else {
    for (int i = tid; i < a.B; i += kThreads) {
      const int li = len_of(i);
      int rk = 0;
      for (int j = 0; j < a.B; ++j) {
        const int lj = len_of(j);
        rk += lj > li || (lj == li && j < i);
      }
      if (rk >= cl * NL && rk < cl * NL + NL) s.lane[rk - cl * NL] = i;
    }
  }
  __syncthreads();
  for (int i = tid; i < sh.nw * 8; i += kThreads) bias_w[i] = a.out_b[col0 + i];
  for (int i = tid; i < sh.nd * 8; i += kThreads) bias_d[i] = a.dec_b[sh.c0 * 8 + i];
  for (int i = tid; i < R * Jp; i += kThreads) {
    const int r = i / Jp, j = i - r * Jp, p = r / K, k = r - p * K;
    DT x{};  // zero
    if (p < nl && j < a.J)
      x = static_cast<const DT*>(a.dec_proj_in)[((size_t)s.lane[p] * K + k) * a.J + j];
    drow(p, 0, k)[j] = x;
  }
  for (int i = tid; i < R * C; i += kThreads) {
    const int r = i / C, c = i - r * C, p = r / K, k = r - p * K;
    hrow(p, 0, k)[c] = p < nl ? (int)a.hyp_in[((size_t)s.lane[p] * K + k) * C + c] : 0;
  }
  {
    const int words = BF ? kRows * (Jp + 8) / 2 : RT * Jp;
    for (int i = tid; i < words; i += kThreads) reinterpret_cast<float*>(tile)[i] = 0.f;
  }
  if (tid < R) {
    const int p = tid / K, k = tid - p * K;
    const size_t at = p < nl ? (size_t)s.lane[p] * K + k : 0;
    s.score[0][tid] = p < nl ? a.score_in[at] : 0.f;
    s.cnt[0][tid] = p < nl ? a.count_in[at] : 0;
    s.anc[0][tid] = k;
  }
  if (tid < NL) {
    const int p = tid;
    s.len[p] = p < nl ? len_of(s.lane[p]) : 0;
    s.offset[p] = p < nl ? a.offset[s.lane[p]] : 0;
    s.trip_end[p] = 0;
    s.second[p] = 0;
  }
  if (res_bytes) mbar_wait(bars + kBarRes, 0);
  cluster_sync();  // every block of the cluster has started and holds its state

  int frames = 0;  // the cluster's frames: its longest lane's
  for (int p = 0; p < NL; ++p) frames = max(frames, s.len[p]);
  const float* ob = bias_w - col0;   // indexed by global column
  const float* db = bias_d - sh.c0 * 8;
  const uint32_t row_bytes = 16 + 8 * K;  // what a rank pushes per row in the exchange
  // the frames' rows of enc_proj in 16-byte pieces
  const bool vec_enc = a.J % (BF ? 8 : 4) == 0 && (reinterpret_cast<uintptr_t>(a.enc) & 15) == 0;
  unsigned curmask = 0;  // bit p: lane p's beams are in buffer 1
  int kw = 0, kd = 0;    // ring stages consumed
  int n2 = 0, nr = 0;    // second exchanges and refreshes so far
  for (int t = 0; t < frames; ++t) {
    const int par = t & 1;  // the exchange's slots and mbarrier
    unsigned live = 0;      // bit p: lane p has frame t
    for (int p = 0; p < NL; ++p) live |= (unsigned)(t < s.len[p]) << p;
    auto row_live = [&](int r) { return r < R && ((live >> (r / K)) & 1); };
    if (tid == 0) mbar_expect(xb + kXBar + par, kCL * __popc(live) * K * row_bytes);

    // 1. stage the joiner's input: row p K + k = tanh(enc_p[t] + dec_proj_pk),
    // 16 bytes a thread where the rows allow; the next frame's rows of enc
    // are prefetched into L1
    if (BF && vec_enc) {
      bf16* sA = reinterpret_cast<bf16*>(tile);
      const int groups = Jp / 8;
      for (int i = tid; i < R * groups; i += kThreads) {
        const int r = i / groups, j = 8 * (i - r * groups), p = r / K;
        if (!((live >> p) & 1)) continue;
        const bf16* enc = static_cast<const bf16*>(a.enc) + ((size_t)s.lane[p] * a.T + t) * a.J;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (j < a.J) {
          const uint4 e8 = __ldg(reinterpret_cast<const uint4*>(enc + j));
          const uint4 d8 = *reinterpret_cast<const uint4*>(drow(p, (curmask >> p) & 1, r - p * K) + j);
          const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&e8);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d8);
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 ef = __bfloat1622float2(e2[u]), df = __bfloat1622float2(d2[u]);
            o2[u] = __floats2bfloat162_rn(tanhf(bf16_round(ef.x + df.x)),
                                          tanhf(bf16_round(ef.y + df.y)));
          }
          if (r - p * K == 0 && j % 64 == 0 && t + 1 < s.len[p])
            asm volatile("prefetch.global.L1 [%0];\n" ::"l"(enc + a.J + j));
        }
        *reinterpret_cast<uint4*>(sA + r * (Jp + 8) + j) = out;
      }
    } else if (vec_enc) {
      float* sA = reinterpret_cast<float*>(tile);
      const int groups = Jp / 4;
      for (int i = tid; i < R * groups; i += kThreads) {
        const int r = i / groups, j = 4 * (i - r * groups), p = r / K;
        if (!((live >> p) & 1)) continue;
        const float* enc = static_cast<const float*>(a.enc) + ((size_t)s.lane[p] * a.T + t) * a.J;
        float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < a.J) {
          const float4 e4 = __ldg(reinterpret_cast<const float4*>(enc + j));
          const float4 d4 =
              *reinterpret_cast<const float4*>(drow(p, (curmask >> p) & 1, r - p * K) + j);
          out = make_float4(tanhf(e4.x + to_f(d4.x)), tanhf(e4.y + to_f(d4.y)),
                            tanhf(e4.z + to_f(d4.z)), tanhf(e4.w + to_f(d4.w)));
          if (r - p * K == 0 && j % 32 == 0 && t + 1 < s.len[p])
            asm volatile("prefetch.global.L1 [%0];\n" ::"l"(enc + a.J + j));
        }
        *reinterpret_cast<float4*>(sA + r * Jp + j) = out;
      }
    } else if (BF) {
      bf16* sA = reinterpret_cast<bf16*>(tile);
      const int half = Jp / 2;
      for (int i = tid; i < R * half; i += kThreads) {
        const int r = i / half, j = 2 * (i - r * half), p = r / K;
        if (!((live >> p) & 1)) continue;
        const DT* d = drow(p, (curmask >> p) & 1, r - p * K);
        const bf16* enc = static_cast<const bf16*>(a.enc) + ((size_t)s.lane[p] * a.T + t) * a.J;
        const float x0 = j < a.J ? tanhf(bf16_round(__bfloat162float(enc[j]) + to_f(d[j]))) : 0.f;
        const float x1 =
            j + 1 < a.J ? tanhf(bf16_round(__bfloat162float(enc[j + 1]) + to_f(d[j + 1]))) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(sA + r * (Jp + 8) + j) = __floats2bfloat162_rn(x0, x1);
      }
    } else {
      float* sA = reinterpret_cast<float*>(tile);
      for (int i = tid; i < R * Jp; i += kThreads) {
        const int r = i / Jp, j = i - r * Jp, p = r / K;
        if (!((live >> p) & 1)) continue;
        const DT* d = drow(p, (curmask >> p) & 1, r - p * K);
        const float* enc = static_cast<const float*>(a.enc) + ((size_t)s.lane[p] * a.T + t) * a.J;
        sA[i] = j < a.J ? tanhf(enc[j] + to_f(d[j])) : 0.f;
      }
    }
    __syncthreads();

    // 2. this rank's logits, every row
    if (BF) {
      const bf16* sA = reinterpret_cast<const bf16*>(tile);
      auto keep = [&](int c0, const float (&acc)[4]) { store_bf16(a, R, c0, acc, ob, L, col0); };
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
      logits_f32<RT>(a, R, reinterpret_cast<const float*>(wres), sh.w_res, col0, sA, ob, L, col0);
      for (int g = 0; g < sh.w_st; ++g, ++kw) {
        ring_wait(bars, kBarW, P.depth, kw);
        const int u = g * P.sw;
        logits_f32<RT>(a, R, reinterpret_cast<const float*>(wring + (size_t)(kw % P.depth) * P.sw * P.uw),
                       min(P.sw, sh.w_str - u), col0 + (sh.w_res + u) * 8, sA, ob, L, col0);
        __syncthreads();
        if (tid == 0) issue_w(kw + P.depth);
      }
    }
    __syncthreads();

    // 3. (warp r) row r's partials over this rank's columns and its K best
    // columns by logit, pushed into this rank's slots everywhere
    if (row_live(warp)) {
      const int r = warp;
      const float* row = L + r * P.ls - col0;
      float m = -INFINITY, nb = -INFINITY;
      for (int c = col0 + lane; c < col1; c += 32) {
        m = fmaxf(m, row[c]);
        if (c != a.blank && !forbidden(c, a)) nb = fmaxf(nb, row[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        nb = fmaxf(nb, __shfl_xor_sync(0xffffffffu, nb, o));
      }
      float sum = 0.f;
      for (int c = col0 + lane; c < col1; c += 32) sum += expf(row[c] - m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float lb = rank == owner ? row[a.blank] : 0.f;
      const Cand mine = warp_top_k(K, col1 - col0, [&](int i) {
        const int c = col0 + i;
        return Cand{forbidden(c, a) ? -INFINITY : row[c], c};
      }, sel + warp * kRows);
      const uint64_t* bar = xb + kXBar + par;
      if (lane < kCL)
        st_async(map_rank(part + (par * kCL + rank) * R + r, lane), make_float4(m, sum, lb, nb),
                 map_rank(bar, lane));
      push_list(mine, K, lists + ((size_t)(par * kCL + rank) * R + r) * K, bar);
    }
    mbar_wait_or_trap(xb + kXBar + par, (uint32_t)(t >> 1) & 1u);

    // 4. (warp r) row r's partials merged over the ranks in rank order: its
    // log-sum-exp, blank log-prob, the trip's sums, its best non-blank
    // candidate, its K best pushed candidates by (value, column) and the
    // largest last value of its full lists
    if (row_live(warp)) {
      const int r = warp, p = r / K;
      const float4* pk = part + par * kCL * R + r;
      float M = -INFINITY, gl = -INFINITY;
      for (int q = 0; q < kCL; ++q) {
        M = fmaxf(M, pk[q * R].x);
        gl = fmaxf(gl, pk[q * R].w);
      }
      float S = 0.f;
      for (int q = 0; q < kCL; ++q) S += pk[q * R].y * expf(pk[q * R].x - M);
      const float ls = logf(S);
      const float blp = forbidden(a.blank, a) ? kNegInf : (pk[owner * R].z - M) - ls;
      const bool fresh = t >= s.trip_end[p];
      const float ci = (fresh ? 0.f : s.cumi[r]) + blp, ce = ci - blp;
      const float sc = s.score[(curmask >> p) & 1][r], base = sc + ce;
      float rmax = base + ((gl - M) - ls);
      if (forb_nb) rmax = fmaxf(rmax, base + kNegInf);
      auto value = [&](Cand c) {
        return c.i == kNone ? -INFINITY : forbidden(c.i, a) ? base + kNegInf : base + ((c.v - M) - ls);
      };
      const Cand* lr = lists + (size_t)par * kCL * R * K + (size_t)r * K;  // rank q's at + q R K
      const Cand best = warp_top_k(K, kCL * K, [&](int i) {
        const Cand c = lr[(size_t)(i / K) * R * K + i % K];
        return Cand{value(c), c.i};
      }, sel + warp * kRows);
      if (lane < K) rowtop[r * K + lane] = best;
      float last = -INFINITY;  // a full list: the rank has columns it did not push
      if (lane < kCL && ncols(lane) > K) last = value(lr[(size_t)lane * R * K + K - 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) last = fmaxf(last, __shfl_xor_sync(0xffffffffu, last, o));
      if (lane == 0) {
        s.cumi[r] = ci;
        s.cume[r] = ce;
        s.mrow[r] = M;
        s.lse[r] = ls;
        s.base[r] = base;
        s.foldv[r] = sc + ci;
        s.rowmax[r] = rmax;
        s.rowlast[r] = last;
      }
    }
    __syncthreads();

    // 5. (warp p, lane k) lane p's branch and, on a step, new beam k: the K
    // best of its rows' lists by (value, flat index)
    auto finish = [&](int p, int kind, Cand best) {
      const int k = lane, r = p * K + k, cur = (curmask >> p) & 1;
      int parent = k, tok = a.blank, stored = 0;
      float value = k < K ? s.score[cur][r] : 0.f;
      if (kind == 1) {
        const int sp = best.i / V;
        parent = k < K ? s.perm[p * K + sp] : 0;
        tok = best.i - sp * V;
        value = best.v;
      } else if (kind == 2) {
        parent = k < K ? s.fperm[p * K + k] : 0;
        value = k < K ? s.foldv[p * K + parent] : 0.f;
      }
      if (k < K) {
        const bool emit = kind == 1 && tok != a.blank;
        const int nxt = cur ^ 1, rp = p * K + parent;
        stored = emit && s.cnt[cur][rp] < a.U;
        if (kind) {
          s.parent[r] = parent;
          s.token[r] = tok;
          s.value[r] = value;
          s.emit[r] = emit;
          s.score[nxt][r] = value;
          s.cnt[nxt][r] = s.cnt[cur][rp] + stored;
          s.anc[nxt][r] = s.anc[cur][rp];
        }
        if (rank == p % kCL) {
          const size_t at = ((size_t)s.lane[p] * a.T + t) * K + k;
          a.steps[at] = step_entry(tok, kind, stored, parent);
          if (a.values) a.values[at] = value;
        }
      }
    };
    if (warp < NL) {
      const int p = warp, k = lane, r = p * K + k;
      if (!((live >> p) & 1)) {
        if (lane == 0) s.kind[p] = s.amb[p] = 0;
      } else {
        const float sk = k < K ? s.base[r] : 0.f, fv = k < K ? s.foldv[r] : 0.f;
        float mb = k < K ? fv : INFINITY, gmax = k < K ? s.rowmax[r] : -INFINITY;
        int pos = 0, fpos = 0;
        for (int j = 0; j < K; ++j) {
          const float skj = __shfl_sync(0xffffffffu, sk, j), fvj = __shfl_sync(0xffffffffu, fv, j);
          pos += better(skj, j, sk, k);
          fpos += better(fvj, j, fv, k);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mb = fminf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
          gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
        }
        if (k < K) {
          s.inv[r] = pos;
          s.perm[p * K + pos] = k;
          s.fperm[p * K + fpos] = k;
        }
        int te = s.trip_end[p];
        if (t >= te) te = min(min(t, a.T - a.W) + a.W, s.len[p]);  // a trip starts at t
        const int kind = gmax >= mb ? 1 : (t == te - 1 ? 2 : 0);
        __syncwarp();
        Cand best{-INFINITY, kNone};
        bool amb = false;
        if (kind == 1) {
          best = warp_top_k(K, K * K, [&](int i) {
            const int kk = i / K;
            const Cand c = rowtop[(p * K + kk) * K + i % K];
            return Cand{c.v, c.i == kNone ? kNone : s.inv[p * K + kk] * V + c.i};
          }, sel + warp * kRows);
          const float vk = __shfl_sync(0xffffffffu, best.v, K - 1);
          amb = __any_sync(0xffffffffu, k < K && !(s.rowlast[r] < vk));
        }
        if (lane == 0) {
          s.kind[p] = kind;
          s.amb[p] = amb;
          s.trip_end[p] = kind ? t + 1 : te;  // after a step, the next frame starts a trip
        }
        if (!amb) finish(p, kind, best);
      }
    }
    __syncthreads();
    unsigned stepmask = 0, ambmask = 0;
    for (int p = 0; p < NL; ++p) {
      stepmask |= (unsigned)(s.kind[p] != 0) << p;
      ambmask |= (unsigned)(s.amb[p] != 0) << p;
    }

    // 5b. an ambiguous lane's second exchange: each rank's K best by (value,
    // flat index), a warp per row and then per lane, pushed and merged
    if (ambmask) {
      const int sp = n2 & 1;
      if (tid == 0) mbar_expect(xb + kSBar + sp, kCL * __popc(ambmask) * K * 8);
      if (warp < R && ((ambmask >> (warp / K)) & 1)) {
        const int r = warp;
        const float* row = L + r * P.ls - col0;
        const float base = s.base[r], M = s.mrow[r], ls = s.lse[r];
        const int flat0 = s.inv[r] * V;
        const Cand mine = warp_top_k(K, col1 - col0, [&](int i) {
          const int c = col0 + i;
          return Cand{forbidden(c, a) ? base + kNegInf : base + ((row[c] - M) - ls), flat0 + c};
        }, sel + warp * kRows);
        if (lane < K) rowtop[r * K + lane] = mine;
      }
      __syncthreads();
      if (warp < NL && ((ambmask >> warp) & 1)) {
        const int p = warp;
        const Cand mine = warp_top_k(K, K * K, [&](int i) {
          return rowtop[(p * K + i / K) * K + i % K];
        }, sel + warp * kRows);
        push_list(mine, K, fb + ((size_t)(sp * kCL + rank) * NL + p) * K, xb + kSBar + sp);
      }
      mbar_wait_or_trap(xb + kSBar + sp, (uint32_t)(n2 >> 1) & 1u);
      if (warp < NL && ((ambmask >> warp) & 1)) {
        const int p = warp;
        const Cand best = warp_top_k(K, kCL * K, [&](int i) {
          return fb[((size_t)(sp * kCL + i / K) * NL + p) * K + i % K];
        }, sel + warp * kRows);
        finish(p, 1, best);
        if (lane == 0) ++s.second[p];
      }
      __syncthreads();
      ++n2;
    }
    if (!stepmask) continue;

    // 6. the step: the new beams' contexts and decoder outputs
    unsigned emask = 0, cmask = 0;  // the rows whose new beam emits, and the others that step
    for (int r = 0; r < R; ++r) {
      if (!((stepmask >> (r / K)) & 1)) continue;
      if (s.emit[r])
        emask |= 1u << r;
      else
        cmask |= 1u << r;
    }
    const int n_emit = __popc(emask);
    for (int i = tid; i < R * C; i += kThreads) {
      const int r = i / C, c = i - r * C, p = r / K;
      if (!((stepmask >> p) & 1)) continue;
      const int cur = (curmask >> p) & 1;
      const int* hp = hrow(p, cur, s.parent[r]);
      hrow(p, cur ^ 1, r - p * K)[c] =
          (emask >> r) & 1 ? (c + 1 < C ? hp[c + 1] : s.token[r]) : hp[c];
    }
    const int pieces = Jp * (int)sizeof(DT) / 16;  // a row of decoder outputs, 16 bytes a piece
    for (int i = tid; i < __popc(cmask) * pieces; i += kThreads) {
      const int e = i / pieces, w = i - e * pieces, r = nth_bit(cmask, e), p = r / K;
      const int cur = (curmask >> p) & 1;
      reinterpret_cast<uint4*>(drow(p, cur ^ 1, r - p * K))[w] =
          reinterpret_cast<const uint4*>(drow(p, cur, s.parent[r]))[w];
    }
    if (n_emit) {
      const int rp = nr & 1;
      if (tid == 0) mbar_expect(xb + kRBar + rp, (uint32_t)(n_emit * Jp * sizeof(DT)));
      // emitter e's decoder output relu(sum_c tables[c][h_c]), h its new
      // context, 4 columns a thread where the rows allow: into dA (the
      // tensor cores' A tile) or dout
      const bool mma = BF && a.D % 16 == 0;
      const int vec = a.D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.tables) & 15) == 0 ? 4 : 1;
      const int per = a.D / vec;
      bf16* dA = reinterpret_cast<bf16*>(dout);  // [16][D + 8]
      for (int i = tid; i < n_emit * per; i += kThreads) {
        const int e = i / per, d0 = (i - e * per) * vec, r = nth_bit(emask, e), p = r / K;
        const int* hp = hrow(p, (curmask >> p) & 1, s.parent[r]);
        float sum[4];
        for (int c = 0; c < C; ++c) {
          int h = c + 1 < C ? hp[c + 1] : s.token[r];
          h = h < 0 ? a.blank : h;
          const float* src = a.tables + ((size_t)c * V + h) * a.D + d0;
          float x[4];
          if (vec == 4) {
            const float4 x4 = __ldg(reinterpret_cast<const float4*>(src));
            x[0] = x4.x, x[1] = x4.y, x[2] = x4.z, x[3] = x4.w;
          } else {
            x[0] = x[1] = x[2] = x[3] = __ldg(src);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) sum[u] = c == 0 ? x[u] : sum[u] + x[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= vec) break;
          const float y = fmaxf(sum[u], 0.f);
          if (mma)
            dA[(size_t)e * (a.D + 8) + d0 + u] = __float2bfloat16_rn(y);
          else
            dout[(size_t)e * Dp + d0 + u] = BF ? bf16_round(y) : y;
        }
      }
      __syncthreads();
      auto refresh = [&](const unsigned char* W, int count, int chunk0) {
        if constexpr (BF) {
          if (mma) {
            refresh_mma(a, W, count, chunk0, dA, db, dproj, emask, n_emit, curmask,
                        xb + kRBar + rp);
            return;
          }
        }
        refresh_beams<BF>(a, W, count, chunk0, dout, Dp, db, dproj, emask, n_emit, curmask,
                          xb + kRBar + rp);
      };
      refresh(dres, sh.d_res, sh.c0);
      for (int g = 0; g < sh.d_st; ++g, ++kd) {
        ring_wait(bars, kBarD, P.depth, kd);
        const int u = g * P.sd;
        refresh(dring + (size_t)(kd % P.depth) * P.sd * P.ud, min(P.sd, sh.d_str - u),
                sh.c0 + sh.d_res + u);
        __syncthreads();  // the stage's ring slot is read: refill it
        if (tid == 0) issue_d(kd + P.depth);
      }
      mbar_wait_or_trap(xb + kRBar + rp, (uint32_t)(nr >> 1) & 1u);
      ++nr;
    }
    __syncthreads();  // the copied rows, before the next frame stages them
    curmask ^= stepmask;
  }

  // every bulk copy still in flight lands, and no remote write is pending,
  // before a block may exit
  if (tid == 0) {
    for (int k = kw; k < kw + P.depth && sh.w_st; ++k) ring_wait(bars, kBarW, P.depth, k);
    for (int k = kd; k < kd + P.depth && sh.d_st; ++k) ring_wait(bars, kBarD, P.depth, k);
  }
  __syncthreads();
  cluster_sync();

  // lane p's outputs from rank p % kCL, which wrote its frames' choices
  for (int p = rank; p < nl; p += kCL) {
    const int b = s.lane[p], cur = (curmask >> p) & 1;
    for (int i = tid; i < K * a.J; i += kThreads) {
      const int k = i / a.J, j = i - k * a.J;
      const size_t at = (size_t)b * K * a.J + i;
      static_cast<DT*>(a.dec_proj)[at] = drow(p, cur, k)[j];
    }
    for (int i = tid; i < K * C; i += kThreads)
      a.hyp[(size_t)b * K * C + i] = hrow(p, cur, 0)[i];
    if (tid < K) {
      a.score[(size_t)b * K + tid] = s.score[cur][p * K + tid];
      a.count[(size_t)b * K + tid] = s.cnt[cur][p * K + tid];
    }
    if (tid == 0 && a.second) a.second[b] = s.second[p];
    // each final beam's buffers: its ancestor's row, then the tokens stored
    // along its ancestry, walked back through the frames' choices
    if (warp < K) {
      const int k = warp, anc = s.anc[cur][p * K + k];
      const size_t src = ((size_t)b * K + anc) * a.U, dst = ((size_t)b * K + k) * a.U;
      for (int u = lane; u < a.U; u += 32) {
        a.tokens[dst + u] = a.tokens_in[src + u];
        a.timestamps[dst + u] = a.ts_in[src + u];
      }
      __syncwarp();
      if (lane == 0) {
        long long pos = s.cnt[cur][p * K + k];
        int idx = k;
        for (int t = s.len[p] - 1; t >= 0; --t) {
          const int e = a.steps[((size_t)b * a.T + t) * K + idx];
          if ((e >> 4) & 1) {
            --pos;
            a.tokens[dst + pos] = e >> 7;
            a.timestamps[dst + pos] = s.offset[p] + t;
          }
          idx = e & 15;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The plan: the fixed parts (barriers, each lane's two buffers of decoder
// outputs in the compute dtype, the contexts, the beam state, the
// exchange's partials and lists, the second exchange's lists, the rows' best
// candidates, the warps' top-K slots, the logits, the biases, and one region for the tile with the
// scratch or the emitters' decoder outputs), then the weights
// (rnnt_cluster.cuh::place_weights).  Mirrored by
// decode/rnnt_beam.py::plan_bytes.

// float32: the joiner tile's rows, R rounded up to 4, 8 or 16 (the logits'
// accumulators per thread)
inline int f32_rows(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : 16; }

template <bool BF>
bool make_plan(int J, int D, int V, int C, int K, int NL, int limit, Plan& p) {
  const int Jp = round_up(J, 16), Vp = round_up(V, 8), esz = BF ? 2 : 4, R = NL * K;
  const int ntw = (Vp / 8 + kCL - 1) / kCL, ntd = (Jp / 8 + kCL - 1) / kCL;
  p = Plan{};
  p.uw = BF ? Jp / 16 * 256 : Jp * 32;
  p.ud = D * 8 * esz;
  p.ls = ntw * 8;
  p.lanes = NL;
  p.rows = R;
  Layout L;
  p.xbars = L.place(kBeamBars * 8);
  p.dproj = L.place(NL * 2 * K * Jp * esz);
  p.hist = L.place(NL * 2 * K * C * 4);
  p.beam = L.place((int)sizeof(BeamSmem));
  p.part = L.place(2 * kCL * R * 16);
  p.lists = L.place(2 * kCL * R * K * (int)sizeof(Cand));
  p.fb = L.place(2 * kCL * NL * K * (int)sizeof(Cand));
  p.rowtop = L.place(R * K * (int)sizeof(Cand));
  p.sel = L.place(kWarps * kRows * (int)sizeof(Cand));
  p.logits = L.place(R * p.ls * 4);
  p.bias_w = L.place(ntw * 8 * 4);
  p.bias_d = L.place(ntd * 8 * 4);
  // the tile and the bf16 product's scratch are dead from the logits to the
  // next frame's staging, the emitters' decoder outputs only in the refresh
  // between: one region holds both
  const int tile = round_up(BF ? kRows * (Jp + 8) * 2 : f32_rows(R) * Jp * 4, 128);
  const int scratch = BF ? kWarps * kG * 32 * 16 : 0;
  p.tile = L.place(std::max({tile + scratch, R * round_up(D, 4) * 4, BF ? kRows * (D + 8) * 2 : 0}));
  p.scratch = p.tile + tile;
  p.dout = p.tile;
  return place_weights(p, L, ntw, ntd, limit);
}

cudaLaunchConfig_t config(const Plan& p, int clusters, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCL);
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

template <bool BF, int RT>
cudaError_t launch_t(const Args& a, int clusters, cudaStream_t stream) {
  // set once per kernel and device, not per launch
  cudaError_t err = relpos::allow_smem<rnnt_beam_kernel<BF, RT>>(a.p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a.p, clusters, attr, stream);
  err = cudaLaunchKernelEx(&cfg, rnnt_beam_kernel<BF, RT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BF, int RT>
cudaError_t describe_t(const Plan& p, long long* out) {
  cudaError_t err = relpos::allow_smem<rnnt_beam_kernel<BF, RT>>(p.bytes, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, 1, attr, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, rnnt_beam_kernel<BF, RT>, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, rnnt_beam_kernel<BF, RT>);
  if (err != cudaSuccess) return err;
  out[7] = clusters;
  out[8] = fa.numRegs;
  out[9] = (long long)fa.localSizeBytes;
  return cudaSuccess;
}

// the kernel of a dtype and a plan (float32: by the tile's rows)
cudaError_t launch(const Args& a, int dtype, int clusters, cudaStream_t stream) {
  if (dtype) return launch_t<true, 16>(a, clusters, stream);
  const int rt = f32_rows(a.p.rows);
  return rt == 4 ? launch_t<false, 4>(a, clusters, stream)
                 : rt == 8 ? launch_t<false, 8>(a, clusters, stream)
                           : launch_t<false, 16>(a, clusters, stream);
}

cudaError_t describe(const Plan& p, int dtype, long long* out) {
  if (dtype) return describe_t<true, 16>(p, out);
  const int rt = f32_rows(p.rows);
  return rt == 4 ? describe_t<false, 4>(p, out)
                 : rt == 8 ? describe_t<false, 8>(p, out) : describe_t<false, 16>(p, out);
}

bool plan_for(int J, int D, int V, int C, int K, int NL, int dtype, Plan& p) {
  const int limit = smem_limit();
  return dtype ? make_plan<true>(J, D, V, C, K, NL, limit, p)
               : make_plan<false>(J, D, V, C, K, NL, limit, p);
}

bool lanes_ok(int K, int NL) { return NL >= 1 && NL <= kMaxLanes && NL * K <= kRows; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (enc_proj, dec_proj and dec_w; the
// tables, biases and scores are float32 either way); the weights as
// rnnt_greedy.cu takes them (decode/rnnt_greedy.py::greedy_operands).  The
// search reads the *_in buffers and writes the others whole; `steps` [B, T, K]
// int32 is its scratch (each frame's choices), `values` [B, T, K] float32
// (may be null) the scores after each frame.  W is the trips' window
// (min(T, window)).  `lanes` (P): the lanes each cluster carries, P K <= 16;
// `second` [B] int32 (may be null)
// receives each lane's count of frames that took the second exchange.
// Takes B, V, C, U >= 1, 1 <= K <= 16, T >= W >= 1 and the J and D whose
// plan fits a block's shared memory; returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for shapes it does not take).
extern "C" int k2t_rnnt_beam(const void* enc, const void* lens, const void* offset,
                             const void* tables, const void* dec_w, const void* dec_b,
                             const void* out_w, const void* out_b, const void* hyp_in,
                             const void* dec_proj_in, const void* score_in, const void* count_in,
                             const void* tokens_in, const void* ts_in, void* hyp, void* dec_proj,
                             void* score, void* count, void* tokens, void* timestamps, void* steps,
                             void* values, int B, int T, int W, int J, int D, int V, int C, int K,
                             int U, int blank, int skip_sos, int dtype, void* stream,
                             void* second, int lanes) {
  if (B < 1 || T < 1 || W < 1 || W > T || J < 1 || D < 1 || V < 1 || C < 1 || K < 1 ||
      K > kMaxBeams || U < 1 || blank < 0 || blank >= V || (dtype != 0 && dtype != 1) ||
      !lanes_ok(K, lanes))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(J, D, V, C, K, lanes, dtype, p)) return (int)cudaErrorInvalidValue;
  const Args a{enc, static_cast<const long long*>(lens), static_cast<const long long*>(offset),
               static_cast<const float*>(tables), dec_w, static_cast<const float*>(dec_b),
               out_w, static_cast<const float*>(out_b), static_cast<const long long*>(hyp_in),
               dec_proj_in, static_cast<const float*>(score_in),
               static_cast<const long long*>(count_in), static_cast<const long long*>(tokens_in),
               static_cast<const long long*>(ts_in), static_cast<long long*>(hyp), dec_proj,
               static_cast<float*>(score), static_cast<long long*>(count),
               static_cast<long long*>(tokens), static_cast<long long*>(timestamps),
               static_cast<int*>(steps), static_cast<float*>(values),
               static_cast<int*>(second), B, T, W, J,
               round_up(J, 16), D, V, round_up(V, 8), C, K, U, blank, skip_sos, p};
  return (int)launch(a, dtype, (B + lanes - 1) / lanes, static_cast<cudaStream_t>(stream));
}

// What a launch at these shapes with `lanes` lanes per cluster would use, for
// logs and the host's choice of P: out[0..10] as rnnt_greedy.cu's
// k2t_rnnt_greedy_plan (shared memory bytes per block, resident and streamed
// units, the most units a rank owns, clusters at once, registers, local
// bytes, the rings' stages).
extern "C" int k2t_rnnt_beam_plan(int J, int D, int V, int C, int K, int dtype, long long* out,
                                  int lanes) {
  if (J < 1 || D < 1 || V < 1 || C < 1 || K < 1 || K > kMaxBeams || (dtype != 0 && dtype != 1) ||
      !lanes_ok(K, lanes))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(J, D, V, C, K, lanes, dtype, p)) return (int)cudaErrorInvalidValue;
  const int Jp = round_up(J, 16), Vp = round_up(V, 8);
  out[0] = p.bytes, out[1] = p.res_w, out[2] = p.res_d, out[3] = p.sw, out[4] = p.sd;
  out[5] = (Vp / 8 + kCL - 1) / kCL, out[6] = (Jp / 8 + kCL - 1) / kCL;
  out[10] = p.depth;
  return (int)describe(p, dtype, out);
}
