"""Stateless RNN-T prediction network (icefall "Decoder") — PyTorch port of
``k2transducerasr_tpu/models/decoder.py``: token embedding, a grouped 1-D
convolution over the ``context_size`` previous tokens, ReLU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    decoder_dim: int = 512
    context_size: int = 2
    blank_id: int = 0


def init_params(rng: np.random.Generator, cfg: DecoderConfig) -> dict:
    """numpy tree with the reference init's shapes (embedding ~ N(0, 1))."""
    p = {"embedding": L.init_embedding(rng, cfg.vocab_size, cfg.decoder_dim)}
    if cfg.context_size > 1:
        groups = max(1, cfg.decoder_dim // 4)
        p["conv"] = L.init_conv1d(rng, cfg.decoder_dim, cfg.decoder_dim, cfg.context_size,
                                groups=groups, bias=False)
    return p


def forward(params, cfg: DecoderConfig, y: torch.Tensor) -> torch.Tensor:
    """y: [B, context_size] int (left-padded history) -> [B, decoder_dim].
    Negative ids embed as the blank id."""
    y = torch.where(y < 0, cfg.blank_id, y)
    emb = L.apply_embedding(params["embedding"], y)  # [B, ctx, D]
    if cfg.context_size > 1:
        # groups derived from the weight layout [k, in/groups, out]
        groups = cfg.decoder_dim // params["conv"]["w"].shape[1]
        out = L.apply_conv1d(params["conv"], emb, groups=groups, padding="VALID")[:, 0, :]
    else:
        out = emb[:, -1, :]
    return torch.relu(out)


def context_tables(params, cfg: DecoderConfig) -> tuple:
    """Fold embedding + grouped context conv into ``context_size`` tables
    ``T_t [V, D]`` with ``forward(y) == relu(sum_t T_t[y[:, t]])`` (up to
    float32 summation order) — the decode loop's decoder refresh becomes row
    gathers and an add."""
    emb = params["embedding"]["table"]  # [V, D]
    if cfg.context_size == 1:
        return (emb,)
    w = params["conv"]["w"]  # [k, in/groups, D_out]
    k, gi, d_out = w.shape
    groups = emb.shape[1] // gi
    go = d_out // groups
    v = emb.shape[0]
    emb_g = emb.reshape(v, groups, gi)
    return tuple(
        torch.einsum("vji,ijo->vjo", emb_g, w[t].reshape(gi, groups, go)).reshape(v, d_out)
        for t in range(k)
    )


def forward_from_tables(tables, cfg: DecoderConfig, y: torch.Tensor) -> torch.Tensor:
    """y: [B, context_size] int -> [B, decoder_dim] from ``context_tables``."""
    y = torch.where(y < 0, cfg.blank_id, y)
    out = tables[0][y[:, 0]]
    for t in range(1, len(tables)):
        out = out + tables[t][y[:, t]]
    return torch.relu(out)


def forward_sequence(params, cfg: DecoderConfig, ys: torch.Tensor) -> torch.Tensor:
    """ys: [B, U] label sequence -> [B, U, decoder_dim], the history
    left-padded with blanks (a rescoring utility; negative ids embed as
    the blank id)."""
    pad = torch.full((ys.shape[0], cfg.context_size - 1), cfg.blank_id, dtype=ys.dtype,
                     device=ys.device)
    hist = torch.cat([pad, torch.where(ys < 0, cfg.blank_id, ys)], dim=1)
    emb = L.apply_embedding(params["embedding"], hist)
    if cfg.context_size > 1:
        groups = cfg.decoder_dim // params["conv"]["w"].shape[1]
        emb = L.apply_conv1d(params["conv"], emb, groups=groups, padding="VALID")
    return torch.relu(emb)


class Decoder(ParamTree):
    def __init__(self, cfg: DecoderConfig, tree: dict, device="cpu"):
        super().__init__(tree, device)
        self.cfg = cfg

    def forward(self, y):
        return forward(self, self.cfg, y)

