"""Batched RNN-T greedy search — PyTorch port of
``k2transducerasr_tpu/decode/rnnt_greedy.py``.

``greedy_frames_skip`` is the production path: each trip evaluates the
joiner over a window of frames for every lane, emits at each lane's first
non-blank argmax, refreshes the decoder, and moves that lane's frame pointer
past the emission.  The reference runs it as a ``lax.while_loop`` on the
device; here it is a Python loop with one host sync per trip (the loop
condition).  ``greedy_frames`` (one step per frame) is the oracle it is
tested against.

Semantics (as the reference): blank=0, sos/eos=1, unk=2; emission skips
{blank, unk} (and 1 with ``extra_skip_sos``); max one symbol per frame;
timestamps are emission frame indices (+ ``frame_offset``); lanes past their
``enc_lens`` or with a full token buffer do not emit.  The token buffers are
updated in place (the reference's functional ``.at[].set``).
"""

from __future__ import annotations

import dataclasses

import torch

from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod

_UNK = 2


@dataclasses.dataclass
class GreedyState:
    hyp: torch.Tensor  # [B, context_size] int64 — last context tokens
    dec_proj: torch.Tensor  # [B, joiner_dim] — projected decoder output for hyp
    tokens: torch.Tensor  # [B, K] int64 — emitted tokens
    timestamps: torch.Tensor  # [B, K] int64 — emission frame index
    count: torch.Tensor  # [B] int64 — number of emitted tokens
    trailing_blanks: torch.Tensor  # [B] int64 — consecutive blank frames


def init_state(dec_params, dec_cfg: decoder_mod.DecoderConfig, join_params, batch: int,
               max_tokens: int = 1024, compute_dtype=None) -> GreedyState:
    dev = dec_params["embedding"]["table"].device
    hyp = torch.full((batch, dec_cfg.context_size), dec_cfg.blank_id, dtype=torch.int64,
                     device=dev)
    dec_out = decoder_mod.forward(dec_params, dec_cfg, hyp)
    zeros = torch.zeros((batch, max_tokens), dtype=torch.int64, device=dev)
    return GreedyState(
        hyp=hyp,
        dec_proj=joiner_mod.project_decoder(join_params, dec_out, compute_dtype),
        tokens=zeros,
        timestamps=zeros.clone(),
        count=torch.zeros((batch,), dtype=torch.int64, device=dev),
        trailing_blanks=torch.zeros((batch,), dtype=torch.int64, device=dev),
    )


def _emit(st: GreedyState, tables, dec_cfg, join_params, emit, y, frame, compute_dtype):
    """Apply one emission step: lanes with ``emit`` append ``y`` at
    ``frame`` and refresh their decoder output."""
    lane = torch.arange(st.hyp.shape[0], device=st.hyp.device)
    max_tokens = st.tokens.shape[1]
    new_hyp = torch.cat([st.hyp[:, 1:], y[:, None]], dim=1)
    hyp = torch.where(emit[:, None], new_hyp, st.hyp)
    dec_out = decoder_mod.forward_from_tables(tables, dec_cfg, hyp)
    dec_proj_new = joiner_mod.project_decoder(join_params, dec_out, compute_dtype)
    dec_proj = torch.where(emit[:, None], dec_proj_new, st.dec_proj)
    pos = torch.clamp(st.count, max=max_tokens - 1)
    st.tokens[lane, pos] = torch.where(emit, y, st.tokens[lane, pos])
    st.timestamps[lane, pos] = torch.where(emit, frame, st.timestamps[lane, pos])
    return hyp, dec_proj, st.count + emit.long()


def _blankish(y, extra_skip_sos: bool, blank: int):
    out = (y == blank) | (y == _UNK)
    return out | (y == 1) if extra_skip_sos else out


def greedy_frames(dec_params, dec_cfg, join_params, state: GreedyState, enc_proj, enc_lens,
                  frame_offset, extra_skip_sos: bool = False, compute_dtype=None) -> GreedyState:
    """Advance greedy decode over ``T`` encoder frames, one step per frame
    (the oracle).  enc_proj: [B, T, J] joiner-projected encoder frames."""
    t_max = enc_proj.shape[1]
    max_tokens = state.tokens.shape[1]
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = dataclasses.replace(state, tokens=state.tokens.clone(),
                             timestamps=state.timestamps.clone())
    for t in range(t_max):
        logits = joiner_mod.joint_logits(join_params, enc_proj[:, t], st.dec_proj, compute_dtype)
        y = torch.argmax(logits, dim=-1)
        valid = t < enc_lens
        emit = valid & ~_blankish(y, extra_skip_sos, dec_cfg.blank_id) & (st.count < max_tokens)
        hyp, dec_proj, count = _emit(st, tables, dec_cfg, join_params, emit, y,
                                     frame_offset + t, compute_dtype)
        trailing = torch.where(
            valid, torch.where(emit, 0, st.trailing_blanks + 1), st.trailing_blanks
        )
        st = GreedyState(hyp, dec_proj, st.tokens, st.timestamps, count, trailing)
    return st


def greedy_frames_skip(dec_params, dec_cfg, join_params, state: GreedyState, enc_proj,
                       enc_lens, frame_offset, extra_skip_sos: bool = False,
                       compute_dtype=None, window: int = 64) -> GreedyState:
    """Blank-skipping greedy decode — identical results to ``greedy_frames``
    in max-over-lanes(#tokens + ceil(T/window)) trips instead of T.

    Per trip: each lane's window starts at ``clip(t_ptr, 0, T - w)``; the
    first non-blank argmax at or after ``t_ptr`` (and before ``enc_lens``)
    is the candidate; a lane with none consumes its window as blanks, and a
    candidate blocked by a full token buffer counts as a blank too."""
    b, t_max, _ = enc_proj.shape
    dev = enc_proj.device
    max_tokens = state.tokens.shape[1]
    lane = torch.arange(b, device=dev)
    w = min(t_max, window)
    ar = torch.arange(w, device=dev)
    enc_lens = enc_lens.to(dev, torch.int64)
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = dataclasses.replace(state, tokens=state.tokens.clone(),
                             timestamps=state.timestamps.clone())
    t_ptr = torch.zeros((b,), dtype=torch.int64, device=dev)
    while bool(torch.any(t_ptr < enc_lens)):  # the one host sync per trip
        start = torch.clamp(t_ptr, 0, t_max - w)  # [B] window start per lane
        abs_t = start[:, None] + ar[None, :]  # [B, W]
        win = enc_proj[lane[:, None], abs_t]  # [B, W, J]
        logits = joiner_mod.joint_logits(join_params, win, st.dec_proj[:, None, :],
                                         compute_dtype)  # [B, W, V]
        y = torch.argmax(logits, dim=-1)  # [B, W]
        active = t_ptr < enc_lens
        cand = (~_blankish(y, extra_skip_sos, dec_cfg.blank_id)
                & (abs_t >= t_ptr[:, None]) & (abs_t < enc_lens[:, None]))
        has = torch.any(cand, dim=1)
        # first candidate's offset in the window; 0 when the lane has none
        first_rel = torch.where(has, torch.where(cand, ar, w).amin(dim=1), 0)
        first = start + first_rel
        emit = has & active & (st.count < max_tokens)
        hyp, dec_proj, count = _emit(st, tables, dec_cfg, join_params, emit,
                                     y[lane, first_rel], frame_offset + first, compute_dtype)
        # frames scanned this trip end at the window edge (or the lane's
        # length); every frame consumed without an emission was a blank
        scanned_to = torch.minimum(start + w, enc_lens)
        t_new = torch.where(active, torch.where(emit, first + 1, scanned_to), t_ptr)
        trailing = torch.where(
            active,
            torch.where(emit, 0, st.trailing_blanks + (scanned_to - t_ptr)),
            st.trailing_blanks,
        )
        st = GreedyState(hyp, dec_proj, st.tokens, st.timestamps, count, trailing)
        t_ptr = t_new
    return st


def rnnt_greedy_search(dec_params, dec_cfg: decoder_mod.DecoderConfig, join_params,
                       join_cfg: joiner_mod.JoinerConfig, enc_out, enc_lens,
                       max_tokens: int = 1024, extra_skip_sos: bool = False,
                       compute_dtype=None):
    """Offline whole-utterance greedy search over enc_out [B, T, encoder_dim]
    (the joiner projection, then ``greedy_frames_skip`` from frame 0):
    returns (tokens, timestamps, count).  ``join_cfg`` is unused, as in the
    reference's signature."""
    b = enc_out.shape[0]
    enc_proj = joiner_mod.project_encoder(join_params, enc_out, compute_dtype)
    state = init_state(dec_params, dec_cfg, join_params, b, max_tokens, compute_dtype)
    zero = torch.zeros((b,), dtype=torch.int64, device=enc_out.device)
    final = greedy_frames_skip(dec_params, dec_cfg, join_params, state, enc_proj, enc_lens, zero,
                               extra_skip_sos, compute_dtype)
    return final.tokens, final.timestamps, final.count


def extract_results(tokens, timestamps, count) -> list[tuple[list[int], list[int]]]:
    """Token buffers -> per-lane Python lists (one device-to-host copy each)."""
    tokens, timestamps, count = tokens.cpu(), timestamps.cpu(), count.cpu()
    out = []
    for b in range(tokens.shape[0]):
        n = int(count[b])
        out.append((tokens[b, :n].tolist(), timestamps[b, :n].tolist()))
    return out
