"""RNN-T joint network (icefall "Joiner") — PyTorch port of
``k2transducerasr_tpu/models/joiner.py``:

    logits = W_out @ tanh(P_enc(enc) + P_dec(dec))

The two input projections are separate so the decode loop hoists them:
``project_encoder`` runs once over the whole encoder output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class JoinerConfig:
    encoder_dim: int
    decoder_dim: int
    joiner_dim: int
    vocab_size: int


def init_params(rng: np.random.Generator, cfg: JoinerConfig) -> dict:
    return {
        "encoder_proj": L.init_linear(rng, cfg.encoder_dim, cfg.joiner_dim),
        "decoder_proj": L.init_linear(rng, cfg.decoder_dim, cfg.joiner_dim),
        "output": L.init_linear(rng, cfg.joiner_dim, cfg.vocab_size),
    }


def project_encoder(params, enc_out, compute_dtype=None):
    """[..., encoder_dim] -> [..., joiner_dim]; hoisted out of the loop."""
    return L.apply_linear(params["encoder_proj"], enc_out, compute_dtype)


def project_decoder(params, dec_out, compute_dtype=None):
    return L.apply_linear(params["decoder_proj"], dec_out, compute_dtype)


def joint_logits(params, enc_proj, dec_proj, compute_dtype=None):
    """enc_proj/dec_proj: broadcast-compatible [..., joiner_dim] (already
    projected) -> logits [..., vocab]."""
    return L.apply_linear(params["output"], torch.tanh(enc_proj + dec_proj), compute_dtype)


def forward(params, enc_out, dec_out, project_input: bool = True, compute_dtype=None):
    """The reference-shaped entry: raw (or, with ``project_input=False``,
    already projected) activations -> logits."""
    if project_input:
        enc_out = project_encoder(params, enc_out, compute_dtype)
        dec_out = project_decoder(params, dec_out, compute_dtype)
    return joint_logits(params, enc_out, dec_out, compute_dtype)


class Joiner(ParamTree):
    def __init__(self, cfg: JoinerConfig, tree: dict, device="cpu"):
        super().__init__(tree, device)
        self.cfg = cfg

    def forward(self, enc_proj, dec_proj, compute_dtype=None):
        return joint_logits(self, enc_proj, dec_proj, compute_dtype)
