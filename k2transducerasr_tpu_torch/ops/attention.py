"""Relative-position attention helpers — PyTorch port of
``k2transducerasr_tpu/ops/attention.py``.

Position scores are computed against DESCENDING relative positions
r = (S-1) .. -(T-1), so the score of query t for key s sits at column
``(T-1) - t + s`` of the ``[T, R]`` table (R = T+S-1).  The reference
realizes that skew with pad+reshape (fast on a TPU); here it is a strided
view of the contiguous table, which costs nothing on any device.
"""

from __future__ import annotations

import math

import torch


def descending_rel_positions(t_q: int, s_kv: int, device=None) -> torch.Tensor:
    """Relative positions r = (S-1) .. -(T-1), descending (float32)."""
    return torch.arange(s_kv - 1, -t_q, -1, dtype=torch.float32, device=device)


def sinusoidal_rel_pos(t_q: int, s_kv: int, dim: int, device=None) -> torch.Tensor:
    """[R, dim] Transformer-XL sinusoidal embeddings of the DESCENDING
    relative positions, interleaved sin/cos (pe[:, 0::2] = sin(r*div_i),
    pe[:, 1::2] = cos(r*div_i), div_i = 10000^(-2i/dim): the espnet/icefall
    RelPositionalEncoding layout of conformer and zipformer v1)."""
    r = descending_rel_positions(t_q, s_kv, device)
    inv = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    ang = r[:, None] * inv[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=2).reshape(len(r), dim)


def chunk_causal_mask(t: int, chunk: int, left: int, device=None) -> torch.Tensor:
    """[t, t] bool self-attention pattern: query i attends key j iff j is in
    [chunk_start(i) - left, chunk_start(i) + chunk)."""
    q = torch.arange(t, device=device)[:, None]
    s = torch.arange(t, device=device)[None, :]
    cs = (q // chunk) * chunk
    return (s <= cs + chunk - 1) & (s >= cs - left)


def rel_shift(bd_desc: torch.Tensor, s_kv: int) -> torch.Tensor:
    """bd_desc: [..., T, R] position scores whose last axis follows
    ``descending_rel_positions`` (R = T + S - 1).  Returns [..., T, S] with
    ``out[t, s] = bd_desc[t, (T-1) - t + s]``: element (t, s) lies at flat
    offset ``(T-1) + t*(R-1) + s`` of the contiguous table, so the result is
    a strided view (queries are the last T positions of the kv sequence)."""
    x = bd_desc.contiguous()
    *lead, t, r = x.shape
    if r != t + s_kv - 1:
        raise ValueError(f"rel table width {r} != t+s-1 ({t}+{s_kv}-1)")
    return x.as_strided(
        (*lead, t, s_kv), (*x.stride()[:-2], r - 1, 1), x.storage_offset() + t - 1
    )
