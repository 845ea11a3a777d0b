"""Batched CTC greedy decoding — PyTorch port of
``k2transducerasr_tpu/decode/ctc_greedy.py``.

Per frame the argmax of the log-probs; repeats collapse, blanks drop, and a
token's timestamp is its frame index (+ ``frame_offset``).  The whole pass
is vectorised: one argmax over [B, T, V], a shifted compare for the
collapse and a cumsum-scatter compaction, with no per-frame loop.  Across
chunks ``prev`` carries the last valid frame's argmax, so repeats collapse
across chunk boundaries, and ``trailing_blanks`` counts the blank frames at
the tail (the endpoint rules read it).  Emissions past ``max_tokens`` are
dropped.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CtcState:
    tokens: torch.Tensor  # [B, U] int64
    timestamps: torch.Tensor  # [B, U] int64
    count: torch.Tensor  # [B] int64
    prev: torch.Tensor  # [B] int64 — last valid frame's argmax
    trailing_blanks: torch.Tensor  # [B] int64


def init_state(batch: int, max_tokens: int = 1024, blank_id: int = 0,
               device: str | torch.device = "cpu") -> CtcState:
    zeros = torch.zeros((batch, max_tokens), dtype=torch.int64, device=device)
    return CtcState(
        tokens=zeros,
        timestamps=zeros.clone(),
        count=torch.zeros((batch,), dtype=torch.int64, device=device),
        prev=torch.full((batch,), blank_id, dtype=torch.int64, device=device),
        trailing_blanks=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def ctc_frames(state: CtcState, log_probs: torch.Tensor, lens, frame_offset,
               blank_id: int = 0) -> CtcState:
    """Decode ``T`` frames of log-probs [B, T, V]; frames at or past a
    lane's ``lens`` are not decoded."""
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    max_tokens = state.tokens.shape[1]
    lens = lens.to(dev, torch.int64)
    frame_offset = frame_offset.to(dev, torch.int64)
    ar = torch.arange(t_max, device=dev)
    y = torch.argmax(log_probs, dim=-1)  # [B, T], the first index on ties
    valid = ar[None, :] < lens[:, None]

    prev = torch.cat([state.prev[:, None], y[:, :-1]], dim=1)
    emit = valid & (y != blank_id) & (y != prev)

    # each emission's slot = count + emissions before it; the others, and
    # emissions past the buffer, go to a spare column that is cut off
    pos = state.count[:, None] + torch.cumsum(emit, dim=1) - 1
    pos = torch.where(emit, pos, max_tokens).clamp(max=max_tokens)
    spare = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    tokens = torch.cat([state.tokens, spare], dim=1).scatter_(1, pos, y)[:, :max_tokens]
    ts = frame_offset[:, None] + ar[None, :]
    timestamps = torch.cat([state.timestamps, spare], dim=1).scatter_(1, pos, ts)[:, :max_tokens]
    count = torch.clamp(state.count + emit.sum(dim=1), max=max_tokens)

    any_valid = lens > 0
    last = y.gather(1, torch.clamp(lens - 1, 0, max(t_max - 1, 0))[:, None])[:, 0]
    new_prev = torch.where(any_valid, last, state.prev)

    # trailing blanks: the blank run at the valid tail, or all of this
    # chunk's valid frames on top of the carried run when none emitted
    last_nonblank = torch.where(valid & (y != blank_id), ar, -1).amax(dim=1)  # -1 if none
    trailing = torch.where(
        last_nonblank >= 0,
        lens - 1 - last_nonblank,
        state.trailing_blanks + torch.where(any_valid, lens, 0),
    )
    return CtcState(tokens, timestamps, count, new_prev, trailing)


def ctc_greedy_search(log_probs: torch.Tensor, lens, blank_id: int = 0,
                      max_tokens: int = 1024):
    """Offline whole-utterance CTC greedy -> (tokens, timestamps, count)."""
    b = log_probs.shape[0]
    state = init_state(b, max_tokens, blank_id, log_probs.device)
    zero = torch.zeros((b,), dtype=torch.int64, device=log_probs.device)
    final = ctc_frames(state, log_probs, lens, zero, blank_id)
    return final.tokens, final.timestamps, final.count
