"""ModelBundle: everything a recognizer needs, loadable from a model dir —
port of ``k2transducerasr_tpu/runtime/bundle.py``.  The encoder, decoder
and joiner are ``nn.Module``s on one device."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from k2transducerasr_tpu_torch.frontend.fbank import FbankConfig
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.models.registry import get_encoder
from k2transducerasr_tpu_torch.runtime import checkpoint
from k2transducerasr_tpu_torch.runtime.device import resolve_device
from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable


@dataclasses.dataclass
class ModelBundle:
    model_type: str
    encoder_cfg: Any
    encoder: torch.nn.Module
    decoder: decoder_mod.Decoder
    joiner: joiner_mod.Joiner
    tokens: SymbolTable
    frontend_cfg: FbankConfig
    device: torch.device

    @property
    def decoder_cfg(self) -> decoder_mod.DecoderConfig:
        return self.decoder.cfg

    @property
    def joiner_cfg(self) -> joiner_mod.JoinerConfig:
        return self.joiner.cfg

    @property
    def vocab_size(self) -> int:
        return self.decoder_cfg.vocab_size

    @classmethod
    def from_params(cls, model_type: str, encoder_cfg, params: dict, tokens: SymbolTable,
                    frontend_cfg: FbankConfig, decoder_cfg: decoder_mod.DecoderConfig,
                    joiner_cfg: joiner_mod.JoinerConfig,
                    device: str | torch.device = "cuda") -> "ModelBundle":
        """Build from a numpy parameter tree {"encoder", "decoder", "joiner"}
        (``load_params`` or the JAX package's ``bundle.params``)."""
        dev = resolve_device(device)
        enc_mod = get_encoder(model_type)
        return cls(
            model_type=model_type,
            encoder_cfg=encoder_cfg,
            encoder=enc_mod.Encoder(encoder_cfg, params["encoder"], dev),
            decoder=decoder_mod.Decoder(decoder_cfg, params["decoder"], dev),
            joiner=joiner_mod.Joiner(joiner_cfg, params["joiner"], dev),
            tokens=tokens,
            frontend_cfg=frontend_cfg,
            device=dev,
        )

    @classmethod
    def from_dir(cls, model_dir: str, device: str | torch.device = "cuda",
                 accuracy: str = "") -> "ModelBundle":
        """Load a model dir written by either package's ``ModelBundle.save``."""
        dev = resolve_device(device)
        files = checkpoint.model_dir_files(model_dir, accuracy)
        raw = checkpoint.load_config(files["config"])
        model_type = raw["model_type"]
        enc_mod = get_encoder(model_type)
        return cls.from_params(
            model_type,
            enc_mod.Config(**raw["encoder"]),
            checkpoint.load_params(files["params"]),
            SymbolTable.from_file(files["tokens"]),
            FbankConfig(**raw.get("frontend", {})),
            decoder_mod.DecoderConfig(**raw["decoder"]),
            joiner_mod.JoinerConfig(**raw["joiner"]),
            dev,
        )

    @classmethod
    def random(cls, model_type: str, encoder_cfg, vocab_size: int, seed: int = 0,
               decoder_dim: int = 512, joiner_dim: int = 512, context_size: int = 2,
               symbols: list[str] | None = None, frontend_cfg: FbankConfig | None = None,
               device: str | torch.device = "cuda") -> "ModelBundle":
        """Random-weight bundle from a numpy seed (benchmarking and the card's
        checks without real weights or JAX).  Same shapes and scales as the
        JAX package's ``ModelBundle.random``; other values."""
        enc_mod = get_encoder(model_type)
        rng = np.random.default_rng(seed)
        decoder_cfg = decoder_mod.DecoderConfig(
            vocab_size=vocab_size, decoder_dim=decoder_dim, context_size=context_size
        )
        joiner_cfg = joiner_mod.JoinerConfig(
            encoder_dim=enc_mod.output_dim(encoder_cfg), decoder_dim=decoder_dim,
            joiner_dim=joiner_dim, vocab_size=vocab_size,
        )
        params = {
            "encoder": enc_mod.init_params(rng, encoder_cfg),
            "decoder": decoder_mod.init_params(rng, decoder_cfg),
            "joiner": joiner_mod.init_params(rng, joiner_cfg),
        }
        if symbols is None:
            symbols = ["<blk>", "<sos/eos>", "<unk>"] + [f"tok{i}" for i in range(3, vocab_size)]
        return cls.from_params(model_type, encoder_cfg, params, SymbolTable(symbols),
                               frontend_cfg or FbankConfig(), decoder_cfg, joiner_cfg, device)
