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
at the first frame that may emit.  The reference runs it as a
``lax.while_loop``; here it is a Python loop with one host sync per trip
(``rnnt_greedy.greedy_frames_skip`` runs its loop as one CUDA kernel on the
card; this search has no kernel yet).  ``beam_frames`` (one step per
frame) is the oracle it is tested against.

Ordering: ``jax.lax.top_k`` puts equal values lower index first, and
``torch.topk`` orders ties arbitrarily.  Ties are common here (the dead
beams all sit at ``NEG_INF``, bf16 logits repeat values), and the order
decides the parents, the n-best order and which candidate takes the K-th
slot; so every top-K and re-sort is a stable descending sort, and the best
beam is the first maximum.
"""

from __future__ import annotations

import dataclasses

import torch

from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.runtime.checkpoint import tree_map

NEG_INF = -1e30
_UNK = 2


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


def beam_frames_skip(dec_params, dec_cfg, join_params, state: BeamState, enc_proj, enc_lens,
                     frame_offset, extra_skip_sos: bool = False, compute_dtype=None,
                     window: int = 64) -> BeamState:
    """Blank-skipping modified beam search — the same results as
    ``beam_frames`` in max-over-lanes(#emission frames + ceil(T/window))
    trips instead of T.

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
    to ``beam_frames_skip.trips``."""
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
        st = _keep(~active, st, new)
        scanned_to = torch.minimum(start + w, enc_lens)
        t_ptr = torch.where(active, torch.where(has, frame + 1, scanned_to), t_ptr)
    return st


beam_frames_skip.trips = 0


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
