"""Batched RNN-T modified beam search (icefall ``modified_beam_search``) —
PyTorch port of ``k2transducerasr_tpu/decode/rnnt_beam.py``.

K hypotheses per lane live on the device as one ``BeamState``: context
tokens, projected decoder outputs, scores and token/timestamp buffers, each
``[B, K, ...]``.  One expansion per frame: joint log-probs of every beam,
plus the beam scores, then the top K of the K*V candidates, a gather of
each new beam's parent state and a masked token append.

``beam_frames_skip`` is the production path: each trip evaluates the joiner
over a window of frames for every beam, skips the frames where the top K
are provably all blank in closed form, and takes the exact per-frame step
at the first frame that may emit.  The reference runs it as one
``lax.while_loop`` on the device; here, for CUDA tensors, it is one launch
of a hand-written kernel (``csrc/rnnt_beam.cu``) that runs every lane's
whole search on the card, trip by trip, so a caller that queues it does
not wait.  For CPU tensors it runs ``beam_frames_skip_reference``, the
plain version: the same trips as a Python loop with one host sync per trip
(the loop condition).  ``beam_frames`` (one step per frame) is the oracle
both are tested against.

The kernel takes the greedy kernel's operands (``rnnt_greedy.greedy_operands``:
one copy of the weights serves both searches) and runs P lanes on each
cluster of ``rnnt_greedy.CLUSTER`` blocks (``lanes_per_cluster``: the fewest
that let the batch run in one wave of clusters; the kernel pairs lanes of
like lengths itself).  It records each frame's choices (``BeamTrace``);
``k2transducerasr_tpu_torch.testing.beam_replay`` holds a bf16 search to the
plain ops through them.

Ordering: ``jax.lax.top_k`` puts equal values lower index first, and
``torch.topk`` orders ties arbitrarily.  Ties are common here (the dead
beams all sit at ``NEG_INF``, bf16 logits repeat values), and the order
decides the parents, the n-best order and which candidate takes the K-th
slot; so every top-K and re-sort is a stable descending sort, and the best
beam is the first maximum.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from k2transducerasr_tpu_torch.decode import rnnt_greedy
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.ops import cuda_build
from k2transducerasr_tpu_torch.runtime.checkpoint import tree_map

NEG_INF = -1e30
_UNK = 2
MAX_BEAMS = 16  # what the kernel takes (csrc/rnnt_beam.cu kMaxBeams): the rows of one tile
# k2t_rnnt_beam: the pointers, the ints, the stream, then (second, lanes);
# k2t_rnnt_beam_plan: the shapes, the dtype, out, then lanes
_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2
             + [ctypes.c_int])
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
# the kinds of a frame in a BeamTrace: no step, an emission step (the exact
# per-frame step at a frame that may emit), a window's end (the fold)
STEP_NONE, STEP_EMIT, STEP_FOLD = 0, 1, 2


@dataclasses.dataclass
class BeamState:
    hyp: torch.Tensor  # [B, K, context_size] int64
    dec_proj: torch.Tensor  # [B, K, joiner_dim]
    score: torch.Tensor  # [B, K] float32 — cumulative log-prob
    tokens: torch.Tensor  # [B, K, U] int64
    timestamps: torch.Tensor  # [B, K, U] int64
    count: torch.Tensor  # [B, K] int64


def init_state(dec_params, dec_cfg: decoder_mod.DecoderConfig, join_params, batch: int,
               num_active_paths: int = 4, max_tokens: int = 1024,
               compute_dtype=None) -> BeamState:
    """Every beam starts from the blank context; only beam 0 is live, the
    others start at ``NEG_INF`` so the first top-K fans out."""
    k = num_active_paths
    dev = dec_params["embedding"]["table"].device
    hyp = torch.full((batch * k, dec_cfg.context_size), dec_cfg.blank_id, dtype=torch.int64,
                     device=dev)
    dec_out = decoder_mod.forward(dec_params, dec_cfg, hyp)
    dec_proj = joiner_mod.project_decoder(join_params, dec_out, compute_dtype)
    score = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=dev)
    score[:, 0] = 0.0
    zeros = torch.zeros((batch, k, max_tokens), dtype=torch.int64, device=dev)
    return BeamState(
        hyp=hyp.reshape(batch, k, -1),
        dec_proj=dec_proj.reshape(batch, k, -1),
        score=score,
        tokens=zeros,
        timestamps=zeros.clone(),
        count=torch.zeros((batch, k), dtype=torch.int64, device=dev),
    )


@dataclasses.dataclass
class BeamTrace:
    """Each frame's choices of a search, per lane and new beam k: ``steps``
    [B, T, K] int32 ``(token << 7) | (kind << 5) | (stored << 4) | parent``
    (``kind``: STEP_NONE, STEP_EMIT or STEP_FOLD; ``parent``: the beam, in
    the order before the frame, that new beam k continues; ``stored``: its
    token went into the buffer), ``values`` [B, T, K] float32 the beams'
    scores after the frame.  Frames at or past a lane's length are not
    written.  ``second`` [B] int32 (or None): the kernel's count, per lane,
    of the emission steps whose K best took its second exchange (a near-tie
    at the cut; the plain version leaves it as it was)."""

    steps: torch.Tensor
    values: torch.Tensor
    second: torch.Tensor | None = None

    @staticmethod
    def empty(b: int, t: int, k: int, device) -> "BeamTrace":
        return BeamTrace(torch.zeros((b, t, k), dtype=torch.int32, device=device),
                         torch.zeros((b, t, k), dtype=torch.float32, device=device),
                         torch.zeros((b,), dtype=torch.int32, device=device))

    def fields(self):
        """(parent, stored, kind, token) [B, T, K] int64."""
        e = self.steps.long()
        return e & 15, (e >> 4) & 1, (e >> 5) & 3, e >> 7


def _top_k(x: torch.Tensor, k: int):
    """The top ``k`` of the last axis, ties to the lower index (the order of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _log_probs(logits: torch.Tensor, extra_skip_sos: bool) -> torch.Tensor:
    """float32 log-softmax over the vocabulary with the tokens no beam may
    emit at ``NEG_INF``: <unk>=2, and <sos/eos>=1 with ``extra_skip_sos``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ids = torch.arange(logp.shape[-1], device=logp.device)
    forbid = (ids == _UNK) | ((ids == 1) & extra_skip_sos)
    return logp.masked_fill(forbid, NEG_INF)


def _keep(keep: torch.Tensor, old: BeamState, new: BeamState) -> BeamState:
    """Lanes with ``keep`` [B] take ``old`` whole, the others ``new``."""
    return tree_map(lambda o, n: torch.where(keep.view(-1, *[1] * (n.ndim - 1)), o, n), old, new)


def _expand(st: BeamState, tables, dec_cfg, join_params, parent, token, emit, frame,
            score, compute_dtype) -> BeamState:
    """New beam k takes beam ``parent[:, k]``'s state; where ``emit`` it
    appends ``token`` at ``frame`` and refreshes its decoder output.  A beam
    whose token buffer is full keeps the token in its context but does not
    store it."""
    b, k = parent.shape
    lane = torch.arange(b, device=parent.device)[:, None]
    beam = torch.arange(k, device=parent.device)[None, :]
    hyp_p, dec_proj_p = st.hyp[lane, parent], st.dec_proj[lane, parent]
    tokens, timestamps = st.tokens[lane, parent], st.timestamps[lane, parent]  # copies
    count_p = st.count[lane, parent]
    max_tokens = tokens.shape[2]

    hyp = torch.where(emit[:, :, None], torch.cat([hyp_p[:, :, 1:], token[:, :, None]], dim=2),
                      hyp_p)
    dec_out = decoder_mod.forward_from_tables(tables, dec_cfg, hyp.reshape(b * k, -1))
    dec_proj_new = joiner_mod.project_decoder(join_params, dec_out, compute_dtype)
    dec_proj = torch.where(emit[:, :, None], dec_proj_new.reshape(b, k, -1), dec_proj_p)

    can_store = emit & (count_p < max_tokens)
    pos = torch.clamp(count_p, max=max_tokens - 1)
    tokens[lane, beam, pos] = torch.where(can_store, token, tokens[lane, beam, pos])
    timestamps[lane, beam, pos] = torch.where(can_store, frame, timestamps[lane, beam, pos])
    return BeamState(hyp, dec_proj, score, tokens, timestamps, count_p + can_store.long())


def beam_frames(dec_params, dec_cfg, join_params, state: BeamState, enc_proj, enc_lens,
                frame_offset, extra_skip_sos: bool = False, compute_dtype=None) -> BeamState:
    """Advance the beams over ``T`` encoder frames, one expansion per frame
    (the oracle).  enc_proj: [B, T, J]; lanes past their ``enc_lens`` keep
    their beams whole."""
    b, t_max, _ = enc_proj.shape
    k = state.score.shape[1]
    dev = enc_proj.device
    enc_lens = enc_lens.to(dev, torch.int64)
    frame_offset = frame_offset.to(dev, torch.int64)
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = state
    for t in range(t_max):
        logits = joiner_mod.joint_logits(join_params, enc_proj[:, t, None, :], st.dec_proj,
                                         compute_dtype)  # [B, K, V]
        v = logits.shape[-1]
        cand = st.score[:, :, None] + _log_probs(logits, extra_skip_sos)
        top_val, top_idx = _top_k(cand.reshape(b, k * v), k)
        parent, token = top_idx // v, top_idx % v
        valid = t < enc_lens  # [B]
        emit = (token != dec_cfg.blank_id) & valid[:, None]
        new = _expand(st, tables, dec_cfg, join_params, parent, token, emit,
                      frame_offset[:, None] + t, top_val, compute_dtype)
        st = _keep(~valid, st, new)
    return st


def beam_frames_skip_reference(dec_params, dec_cfg, join_params, state: BeamState, enc_proj,
                               enc_lens, frame_offset, extra_skip_sos: bool = False,
                               compute_dtype=None, window: int = 64,
                               trace: BeamTrace | None = None) -> BeamState:
    """The plain version of ``beam_frames_skip``: blank-skipping modified
    beam search — the same results as ``beam_frames`` in
    max-over-lanes(#emission frames + ceil(T/window)) trips instead of T, as
    a Python loop with one host sync per trip (the loop condition).

    While no beam emits, the decoder states do not change, so one trip
    evaluates the joiner over a window of W frames for every beam
    ([B, K, W, J] x [J, V]) and finds the first frame that may emit in
    closed form.  With the blank log-probs summed from each lane's pointer:
      * blank candidate at window frame w: bv_k(w) = score_k + cumsum_k(w);
      * best non-blank candidate at w:
        nv(w) = max_{k, v != blank} score_k + cumsum_k(w - 1) + logp_k(w)[v];
      * w may emit only if nv(w) >= min_k bv_k(w); otherwise the top K at w
        are the K blank extensions.
    The frames before the first such w* add their blank log-probs to the
    scores and re-sort the beams (a stable descending sort: the per-frame
    top-K's order); the exact per-frame step then runs at w*, in the sorted
    beam order, and maps back through the sort.  A trigger that fires
    without an emission costs a trip, never a result.  Each trip adds one
    to ``beam_frames_skip.trips``.  ``trace``: each frame's choices are
    written into it (a test's record, as the kernel keeps them)."""
    b, t_max, _ = enc_proj.shape
    k = state.score.shape[1]
    dev = enc_proj.device
    blank = dec_cfg.blank_id
    lane = torch.arange(b, device=dev)
    beam = torch.arange(k, device=dev)[None, :]
    w = min(t_max, window)
    ar = torch.arange(w, device=dev)
    enc_lens = enc_lens.to(dev, torch.int64)
    frame_offset = frame_offset.to(dev, torch.int64)
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = state
    t_ptr = torch.zeros((b,), dtype=torch.int64, device=dev)
    while bool(torch.any(t_ptr < enc_lens)):  # the one host sync per trip
        beam_frames_skip.trips += 1
        active = t_ptr < enc_lens
        start = torch.clamp(t_ptr, 0, t_max - w)  # [B] window start per lane
        abs_t = start[:, None] + ar[None, :]  # [B, W]
        win = enc_proj[lane[:, None], abs_t]  # [B, W, J]
        logits = joiner_mod.joint_logits(join_params, win[:, None], st.dec_proj[:, :, None, :],
                                         compute_dtype)  # [B, K, W, V]
        v = logits.shape[-1]
        logp = _log_probs(logits, extra_skip_sos)

        in_range = (abs_t >= t_ptr[:, None]) & (abs_t < enc_lens[:, None])  # [B, W]
        blank_lp = torch.where(in_range[:, None, :], logp[..., blank], 0.0)  # [B, K, W]
        cum_incl = torch.cumsum(blank_lp, dim=2)
        cum_excl = cum_incl - blank_lp
        min_blank = (st.score[:, :, None] + cum_incl).amin(dim=1)  # [B, W]
        nb_lp = logp.clone()
        nb_lp[..., blank] = NEG_INF
        nv = st.score[:, :, None, None] + cum_excl[..., None] + nb_lp  # [B, K, W, V]
        may_emit = (nv.amax(dim=(1, 3)) >= min_blank) & in_range  # [B, W]
        has = torch.any(may_emit, dim=1)
        w_star = torch.where(has, torch.where(may_emit, ar, w).amin(dim=1), 0)  # [B]

        # the closed-form skip over the all-blank frames before w* (the whole
        # in-range window when no frame may emit), then the re-sort
        skip_cum = torch.where(has[:, None], cum_excl[lane, :, w_star], cum_incl[:, :, -1])
        score_sorted, perm = torch.sort(st.score + skip_cum, dim=1, descending=True,
                                        stable=True)

        # the exact per-frame step at w*, in sorted beam order
        lp_sorted = logp[lane, :, w_star][lane[:, None], perm]  # [B, K, V]
        cand = score_sorted[:, :, None] + lp_sorted
        top_val, top_idx = _top_k(cand.reshape(b, k * v), k)
        emit_lane = (has & active)[:, None]
        parent = perm.gather(1, torch.where(emit_lane, top_idx // v, beam))  # original order
        token = torch.where(emit_lane, top_idx % v, blank)
        score = torch.where(emit_lane, top_val, score_sorted)
        frame = start + w_star  # [B] absolute emission frame
        emit = (token != blank) & emit_lane
        new = _expand(st, tables, dec_cfg, join_params, parent, token, emit,
                      (frame_offset + frame)[:, None], score, compute_dtype)
        # lanes out of frames keep their beams whole
        scanned_to = torch.minimum(start + w, enc_lens)
        if trace is not None:
            stored = (new.count - st.count.gather(1, parent)).to(torch.int64)
            step_at = torch.where(has, frame, scanned_to - 1)
            _record(trace, st.score, t_ptr, step_at, active, parent, token,
                    torch.where(has, STEP_EMIT, STEP_FOLD), stored, score, blank)
        st = _keep(~active, st, new)
        t_ptr = torch.where(active, torch.where(has, frame + 1, scanned_to), t_ptr)
    return st


def _record(trace: BeamTrace, old_score, t_ptr, step_at, active, parent, token, kind, stored,
            score, blank):
    """One trip into ``trace``: frames t_ptr .. step_at - 1 of the active
    lanes keep their beams (STEP_NONE, the blank token, their scores), the
    step at step_at."""
    b, t, k = trace.steps.shape
    ts = torch.arange(t, device=t_ptr.device)[None, :]
    beam = torch.arange(k, device=t_ptr.device)[None, None, :]
    idle = (active[:, None] & (ts >= t_ptr[:, None]) & (ts < step_at[:, None]))[..., None]
    keep = (blank << 7) | (STEP_NONE << 5) | beam
    trace.steps.copy_(torch.where(idle, keep.to(torch.int32), trace.steps))
    trace.values.copy_(torch.where(idle, old_score[:, None, :], trace.values))
    lanes = active.nonzero()[:, 0]
    entry = (token << 7) | (kind[:, None] << 5) | (stored << 4) | parent
    trace.steps[lanes, step_at[lanes]] = entry[lanes].to(torch.int32)
    trace.values[lanes, step_at[lanes]] = score[lanes]


def beam_frames_skip(dec_params, dec_cfg, join_params, state: BeamState, enc_proj, enc_lens,
                     frame_offset, extra_skip_sos: bool = False, compute_dtype=None,
                     window: int = 64, operands: "rnnt_greedy.GreedyOperands | None" = None,
                     trace: BeamTrace | None = None) -> BeamState:
    """Blank-skipping modified beam search over ``T`` encoder frames — the
    same results as ``beam_frames``.  enc_proj: [B, T, J] joiner-projected
    encoder frames.

    CPU tensors run the plain version (``beam_frames_skip_reference``,
    ``window`` frames per trip).  CUDA tensors launch the kernel once, with
    no host sync, or raise ``ValueError`` for what it does not take; there is
    no fallback.  The kernel runs the same trips (``window`` sets their
    windows).  ``operands``: ``rnnt_greedy.greedy_operands(dec_params,
    dec_cfg, join_params, compute_dtype)``, built here when not given.
    ``trace``: a ``BeamTrace.empty(B, T, K, device)`` that receives each
    frame's choices.  The kernel runs P lanes on each cluster, P chosen by
    ``lanes_per_cluster`` from B, K and the clusters the card runs at once.
    ``beam_frames_skip.launches`` counts
    the kernel's launches (one per call, a grid of ceil(B / P) clusters; a
    CUDA graph's replay adds the launches its capture recorded,
    ``runtime/program.py``); ``beam_frames_skip.trips`` the plain version's
    trips."""
    if enc_proj.device.type == "cpu":
        return beam_frames_skip_reference(dec_params, dec_cfg, join_params, state, enc_proj,
                                          enc_lens, frame_offset, extra_skip_sos, compute_dtype,
                                          window, trace)
    if enc_proj.device.type != "cuda":
        raise ValueError(f"beam_frames_skip: unsupported device {enc_proj.device}")
    if operands is None:
        operands = rnnt_greedy.greedy_operands(dec_params, dec_cfg, join_params, compute_dtype)
    return _launch_kernel(operands, dec_cfg, state, enc_proj, enc_lens, frame_offset,
                          extra_skip_sos, compute_dtype, window, trace)


beam_frames_skip.trips = 0
beam_frames_skip.launches = 0


def lanes_per_cluster(batch: int, beams: int, clusters_at_once) -> int:
    """P, the lanes each cluster of the kernel carries: the fewest that let
    all ``batch`` lanes run in one wave of clusters, at most 16 // ``beams``
    (their P K beams are the rows of one joiner tile).  Where no P gives
    one wave, the P with the fewest waves (the fewest lanes among equals).
    ``clusters_at_once(p)``: the clusters that run at once with p lanes
    each (the card's ``cudaOccupancyMaxActiveClusters`` at that plan), 0
    where the plan does not fit; a larger P's plan never needs less shared
    memory, so the search stops there."""
    best = (None, 1)
    for p in range(1, max(1, MAX_BEAMS // beams) + 1):
        n = clusters_at_once(p)
        if n < 1:
            break
        waves = -(-(-(-batch // p)) // n)
        if best[0] is None or waves < best[0]:
            best = (waves, p)
        if waves == 1:
            break
    return best[1]


@functools.lru_cache(maxsize=None)
def _clusters_at_once(device_index: int, j: int, d: int, v: int, c: int, k: int, dtype_code: int,
                      lanes: int) -> int:
    """The kernel's clusters at once on this card at these shapes with
    ``lanes`` lanes a cluster; 0 where its plan does not fit."""
    out = (ctypes.c_longlong * len(rnnt_greedy.PLAN_KEYS))()
    fn = cuda_build.function("rnnt_beam", "k2t_rnnt_beam_plan", _PLAN_ARGTYPES)
    with torch.cuda.device(device_index):
        err = fn(j, d, v, c, k, dtype_code, ctypes.addressof(out), lanes)
    if err == cuda_build._INVALID_VALUE:
        return 0
    if err != 0:
        raise RuntimeError(f"rnnt_beam plan failed: cudaError {err}")
    return int(out[rnnt_greedy.PLAN_KEYS.index("max_active_clusters")])


def kernel_lanes(batch: int, joiner_dim: int, decoder_dim: int, vocab: int, context: int,
                 beams: int, compute_dtype=None, device=None) -> dict:
    """The wrapper's launch shape on the card for ``batch`` lanes: ``lanes``
    (P, ``lanes_per_cluster``), ``clusters``, ``clusters_at_once`` at that
    P, and ``waves``.  Needs the card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return _kernel_lanes(batch, idx, joiner_dim, decoder_dim, vocab, context, beams,
                         rnnt_greedy._DTYPE_CODE[compute_dtype])


@functools.lru_cache(maxsize=None)
def _kernel_lanes(batch, device_index, j, d, v, c, k, dtype_code) -> dict:
    at_once = functools.partial(_clusters_at_once, device_index, j, d, v, c, k, dtype_code)
    p = lanes_per_cluster(batch, k, at_once)
    clusters = -(-batch // p)
    n = at_once(p)
    return dict(lanes=p, clusters=clusters, clusters_at_once=n, waves=-(-clusters // max(n, 1)))


def _launch_kernel(ops, dec_cfg, state: BeamState, enc_proj, enc_lens, frame_offset,
                   extra_skip_sos, compute_dtype, window, trace) -> BeamState:
    b, t_max, j = enc_proj.shape
    dev = enc_proj.device
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    c, v, d = ops.tables.shape
    k = state.score.shape[1] if state.score.dim() == 2 else 0
    u = state.tokens.shape[-1]
    if ops.compute_dtype != compute_dtype:
        raise ValueError(f"beam kernel: operands built for {ops.compute_dtype}, "
                         f"called with {compute_dtype}")
    if enc_proj.dtype != dtype or state.dec_proj.dtype != dtype:
        raise ValueError(f"beam kernel: enc_proj {enc_proj.dtype} and dec_proj "
                         f"{state.dec_proj.dtype} must be {dtype}")
    if not 1 <= k <= MAX_BEAMS:
        raise ValueError(f"beam kernel takes 1..{MAX_BEAMS} beams, got {k}")
    if (j != ops.joiner_dim or tuple(state.dec_proj.shape) != (b, k, j)
            or tuple(state.hyp.shape) != (b, k, c) or tuple(state.count.shape) != (b, k)
            or state.tokens.shape != state.timestamps.shape
            or tuple(state.tokens.shape) != (b, k, u) or u < 1):
        raise ValueError(f"beam kernel: enc_proj {tuple(enc_proj.shape)}, hyp "
                         f"{tuple(state.hyp.shape)}, dec_proj {tuple(state.dec_proj.shape)}, "
                         f"count {tuple(state.count.shape)}, tokens {tuple(state.tokens.shape)}, "
                         f"operands J={ops.joiner_dim} context {c}")
    if state.score.dtype != torch.float32:
        raise ValueError(f"beam kernel: score must be float32, got {state.score.dtype}")
    tensors = (enc_proj, ops.tables, ops.dec_w, ops.dec_b, ops.out_w, ops.out_b, state.hyp,
               state.dec_proj, state.score, state.count, state.tokens, state.timestamps)
    if any(x.device != dev for x in tensors):
        raise ValueError("beam kernel: operands and state must be on enc_proj's device")
    if any(not w.is_contiguous() or w.data_ptr() % 16 for w in (ops.out_w, ops.dec_w)):
        raise ValueError("beam kernel: out_w and dec_w must be contiguous and 16-byte aligned "
                         "(the blocks copy their shares in bulk)")
    second = None if trace is None else trace.second
    if trace is not None and (tuple(trace.steps.shape) != (b, t_max, k)
                              or trace.steps.dtype != torch.int32
                              or tuple(trace.values.shape) != (b, t_max, k)
                              or trace.values.dtype != torch.float32
                              or not trace.steps.is_contiguous()
                              or not trace.values.is_contiguous()
                              or trace.steps.device != dev or trace.values.device != dev
                              or (second is not None and (
                                  tuple(second.shape) != (b,) or second.dtype != torch.int32
                                  or not second.is_contiguous() or second.device != dev))):
        raise ValueError(f"beam kernel: trace must be BeamTrace.empty({b}, {t_max}, {k}) on "
                         f"{dev}")
    if b == 0 or t_max == 0:
        return tree_map(torch.clone, state)

    def lane_ints(x):
        return torch.as_tensor(x, device=dev).to(torch.int64).expand(b).contiguous()

    enc, lens, offset = enc_proj.contiguous(), lane_ints(enc_lens), lane_ints(frame_offset)
    code = rnnt_greedy._DTYPE_CODE[compute_dtype]
    # P lanes a cluster; the kernel pairs lanes of like lengths itself
    lanes = kernel_lanes(b, j, d, v, c, k, compute_dtype, dev)["lanes"]
    if not 1 <= lanes <= MAX_BEAMS // k:
        raise ValueError(f"beam kernel: lanes_per_cluster must be 1..{MAX_BEAMS // k} at "
                         f"{k} beams, got {lanes}")
    src = [x.to(want).contiguous() for x, want in (
        (state.hyp, torch.int64), (state.dec_proj, dtype), (state.score, torch.float32),
        (state.count, torch.int64), (state.tokens, torch.int64),
        (state.timestamps, torch.int64))]
    hyp, dec_proj, score, count, tokens, timestamps = (torch.empty_like(x) for x in src)
    out = BeamState(hyp, dec_proj, score, tokens, timestamps, count)
    steps = (trace.steps if trace is not None
             else torch.empty((b, t_max, k), dtype=torch.int32, device=dev))
    fn = cuda_build.function("rnnt_beam", "k2t_rnnt_beam", _ARGTYPES)
    cuda_build.launch("rnnt_beam", fn, dev,
                      enc.data_ptr(), lens.data_ptr(), offset.data_ptr(),
                      ops.tables.data_ptr(), ops.dec_w.data_ptr(), ops.dec_b.data_ptr(),
                      ops.out_w.data_ptr(), ops.out_b.data_ptr(),
                      *(x.data_ptr() for x in src),
                      *(x.data_ptr() for x in (out.hyp, out.dec_proj, out.score, out.count,
                                               out.tokens, out.timestamps)),
                      steps.data_ptr(), None if trace is None else trace.values.data_ptr(),
                      b, t_max, min(t_max, window), j, d, v, c, k, u, dec_cfg.blank_id,
                      int(extra_skip_sos), code,
                      tail=(None if second is None else second.data_ptr(), lanes))
    beam_frames_skip.launches += 1
    return out


# csrc/rnnt_beam.cu's fixed shared-memory parts per block (make_plan), for
# plan_bytes; _BEAM_SMEM is sizeof(BeamSmem)
_BEAM_SMEM = 1984
_CAND, _KERNEL_WARPS, _G, _BEAM_BARS = 8, 16, 2, 6


def plan_bytes(joiner_dim: int, decoder_dim: int, vocab: int, context: int, beams: int,
               compute_dtype=None, limit: int = 232448, lanes: int = 1) -> dict:
    """csrc/rnnt_beam.cu's make_plan on the host: the shared memory of one
    block of the kernel's cluster at these shapes with ``lanes`` lanes a
    cluster, and where the weights live, for a per-block limit of ``limit``
    bytes (an H100's: 227 KB).  Returns None where nothing fits (the kernel
    refuses the shapes)."""
    bf = compute_dtype is not None
    jp, vp = -(-joiner_dim // 16) * 16, -(-vocab // 8) * 8
    cl, tile_rows, rows = rnnt_greedy.CLUSTER, 16, lanes * beams
    f32_rows = 4 if rows <= 4 else 8 if rows <= 8 else 16
    ntw, ntd = -(-(vp // 8) // cl), -(-(jp // 8) // cl)
    uw = jp // 16 * 256 if bf else jp * 32
    ud = decoder_dim * 8 * (2 if bf else 4)
    at = 48  # the weight rings' mbarriers

    def place(n):
        nonlocal at
        here, at = at, -(-(at + n) // 128) * 128
        return here

    tile = -(-(tile_rows * (jp + 8) * 2 if bf else f32_rows * jp * 4) // 128) * 128
    scratch = _KERNEL_WARPS * _G * 32 * 16 if bf else 0
    for n in (_BEAM_BARS * 8, lanes * 2 * beams * jp * (2 if bf else 4),
              lanes * 2 * beams * context * 4, _BEAM_SMEM, 2 * cl * rows * 16,
              2 * cl * rows * beams * _CAND, 2 * cl * lanes * beams * _CAND, rows * beams * _CAND,
              _KERNEL_WARPS * tile_rows * _CAND, rows * ntw * 8 * 4, ntw * 8 * 4, ntd * 8 * 4,
              max(tile + scratch, rows * -(-decoder_dim // 4) * 4 * 4,
                  tile_rows * (decoder_dim + 8) * 2 if bf else 0)):
        place(n)
    fixed = at

    def fits(n):
        return fixed + n + 128 * 6 <= limit

    plan = dict(fixed_bytes=fixed, res_w=0, res_d=0, sw=0, sd=0, depth=2)
    if fits(ntw * uw + ntd * ud):
        plan.update(res_w=ntw, res_d=ntd)
    else:
        for depth in (2, 1):
            sw = 0 if fits(ntw * uw + depth * ud) else max(1, min(ntw, 32768 // uw))
            sd = max(1, min(ntd, 32768 // ud))
            keep = 0 if sw else ntw * uw
            while sw > 1 and not fits(keep + depth * (sw * uw + sd * ud)):
                sw -= 1
            while sd > 1 and not fits(keep + depth * (sw * uw + sd * ud)):
                sd -= 1
            rings = depth * (sw * uw + sd * ud)
            if not fits(keep + rings):
                continue
            res_w, res_d = 0, 0
            while res_w < (ntw - 1 if sw else ntw) and fits(rings + (res_w + 1) * uw):
                res_w += 1
            while res_d + 1 < ntd and fits(rings + res_w * uw + (res_d + 1) * ud):
                res_d += 1
            plan.update(res_w=res_w, res_d=res_d, sw=sw, sd=sd, depth=depth)
            break
        else:
            return None
    for n in (plan["res_w"] * uw, plan["depth"] * plan["sw"] * uw, plan["res_d"] * ud,
              plan["depth"] * plan["sd"] * ud):
        place(n)
    plan.update(smem_bytes=at, ntiles_per_rank=ntw, chunks_per_rank=ntd)
    return plan if at <= limit else None


def kernel_plan(joiner_dim: int, decoder_dim: int, vocab: int, context: int, beams: int,
                compute_dtype=None, lanes: int = 1) -> dict:
    """What the kernel would use on the current card at these shapes with
    ``lanes`` lanes a cluster (its C entry ``k2t_rnnt_beam_plan``), with the
    keys of ``rnnt_greedy.kernel_plan``.  Needs the card."""
    out = (ctypes.c_longlong * len(rnnt_greedy.PLAN_KEYS))()
    fn = cuda_build.function("rnnt_beam", "k2t_rnnt_beam_plan", _PLAN_ARGTYPES)
    err = fn(joiner_dim, decoder_dim, vocab, context, beams,
             rnnt_greedy._DTYPE_CODE[compute_dtype], ctypes.addressof(out), lanes)
    if err != 0:
        raise RuntimeError(f"rnnt_beam plan failed: cudaError {err}")
    return dict(zip(rnnt_greedy.PLAN_KEYS, list(out)))


def rnnt_beam_search(dec_params, dec_cfg, join_params, enc_out, enc_lens,
                     num_active_paths: int = 4, max_tokens: int = 1024,
                     extra_skip_sos: bool = False, compute_dtype=None):
    """Whole-utterance modified beam search -> (tokens [B, U], timestamps
    [B, U], count [B]) of each lane's best beam."""
    b = enc_out.shape[0]
    enc_proj = joiner_mod.project_encoder(join_params, enc_out, compute_dtype)
    state = init_state(dec_params, dec_cfg, join_params, b, num_active_paths, max_tokens,
                       compute_dtype)
    zero = torch.zeros((b,), dtype=torch.int64, device=enc_out.device)
    final = beam_frames_skip(dec_params, dec_cfg, join_params, state, enc_proj, enc_lens, zero,
                             extra_skip_sos, compute_dtype)
    return best_beam(final)


def best_beam(state: BeamState):
    """(tokens [B, U], timestamps [B, U], count [B]) of each lane's first
    highest-scoring beam."""
    lane = torch.arange(state.score.shape[0], device=state.score.device)
    best = torch.argmax(state.score, dim=1)
    return state.tokens[lane, best], state.timestamps[lane, best], state.count[lane, best]


def nbest_beams(state: BeamState):
    """All K beams per lane, best first (ties in beam order): (tokens
    [B, K, U], timestamps [B, K, U], count [B, K], score [B, K])."""
    score, order = torch.sort(state.score, dim=1, descending=True, stable=True)
    lane = torch.arange(state.score.shape[0], device=state.score.device)[:, None]
    return state.tokens[lane, order], state.timestamps[lane, order], state.count[lane, order], \
        score
