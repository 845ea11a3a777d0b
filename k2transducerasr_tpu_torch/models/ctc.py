"""CTC output head — PyTorch port of ``k2transducerasr_tpu/models/ctc.py``:
one linear over the encoder output, then a float32 log-softmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class CtcConfig:
    encoder_dim: int
    vocab_size: int


def init_params(rng: np.random.Generator, cfg: CtcConfig) -> dict:
    return {"output": L.init_linear(rng, cfg.encoder_dim, cfg.vocab_size)}


def log_probs(params, enc_out: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """enc_out [B, T, D] -> log-probs [B, T, V], float32."""
    logits = L.apply_linear(params["output"], enc_out, compute_dtype)
    return torch.log_softmax(logits.float(), dim=-1)


class Ctc(ParamTree):
    def __init__(self, cfg: CtcConfig, tree: dict, device="cpu"):
        super().__init__(tree, device)
        self.cfg = cfg

    def forward(self, enc_out, compute_dtype=None):
        return log_probs(self, enc_out, compute_dtype)
