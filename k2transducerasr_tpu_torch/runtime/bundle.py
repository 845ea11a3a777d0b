"""ModelBundle: everything a recognizer needs, loadable from and saved to a
model dir — port of ``k2transducerasr_tpu/runtime/bundle.py``.  The encoder
and either the decoder and joiner (a transducer) or the CTC head (a ``*ctc``
model type) are ``nn.Module``s on one device."""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from k2transducerasr_tpu_torch.frontend.fbank import FbankConfig
from k2transducerasr_tpu_torch.models import ctc as ctc_mod
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.models.registry import get_encoder, is_ctc
from k2transducerasr_tpu_torch.ops.layers import quantize_tree_int8
from k2transducerasr_tpu_torch.parallel.sharding import shard_params
from k2transducerasr_tpu_torch.runtime import checkpoint
from k2transducerasr_tpu_torch.runtime.device import resolve_device
from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable


@dataclasses.dataclass
class ModelBundle:
    model_type: str
    encoder_cfg: Any
    encoder: torch.nn.Module
    tokens: SymbolTable
    frontend_cfg: FbankConfig
    device: torch.device
    decoder: decoder_mod.Decoder | None = None
    joiner: joiner_mod.Joiner | None = None
    ctc: ctc_mod.Ctc | None = None

    @property
    def decoder_cfg(self) -> decoder_mod.DecoderConfig | None:
        return None if self.decoder is None else self.decoder.cfg

    @property
    def joiner_cfg(self) -> joiner_mod.JoinerConfig | None:
        return None if self.joiner is None else self.joiner.cfg

    @property
    def ctc_cfg(self) -> ctc_mod.CtcConfig | None:
        return None if self.ctc is None else self.ctc.cfg

    @property
    def is_ctc(self) -> bool:
        return is_ctc(self.model_type)

    @property
    def params(self) -> dict:
        """The parameter tree as the JAX package's ``bundle.params`` holds
        it: {"encoder", "decoder", "joiner"} or {"encoder", "ctc"}, as dicts
        and lists of this bundle's tensors."""
        heads = ("ctc",) if self.is_ctc else ("decoder", "joiner")
        return {"encoder": self.encoder.tree(), **{h: getattr(self, h).tree() for h in heads}}

    @property
    def vocab_size(self) -> int:
        return self.ctc_cfg.vocab_size if self.is_ctc else self.decoder_cfg.vocab_size

    @classmethod
    def from_params(cls, model_type: str, encoder_cfg, params: dict, tokens: SymbolTable,
                    frontend_cfg: FbankConfig,
                    decoder_cfg: decoder_mod.DecoderConfig | None = None,
                    joiner_cfg: joiner_mod.JoinerConfig | None = None,
                    device: str | torch.device = "cuda",
                    ctc_cfg: ctc_mod.CtcConfig | None = None) -> "ModelBundle":
        """Build from a numpy parameter tree: {"encoder", "decoder",
        "joiner"} for a transducer, {"encoder", "ctc"} for a CTC model type
        (``load_params`` or the JAX package's ``bundle.params``)."""
        dev = resolve_device(device)
        enc_mod = get_encoder(model_type)
        heads = ({"ctc": ctc_mod.Ctc(ctc_cfg, params["ctc"], dev)} if is_ctc(model_type) else
                 {"decoder": decoder_mod.Decoder(decoder_cfg, params["decoder"], dev),
                  "joiner": joiner_mod.Joiner(joiner_cfg, params["joiner"], dev)})
        return cls(
            model_type=model_type,
            encoder_cfg=encoder_cfg,
            encoder=enc_mod.Encoder(encoder_cfg, params["encoder"], dev),
            tokens=tokens,
            frontend_cfg=frontend_cfg,
            device=dev,
            **heads,
        )

    @classmethod
    def from_dir(cls, model_dir: str, device: str | torch.device = "cuda",
                 accuracy: str = "") -> "ModelBundle":
        """Load a model dir written by either package's ``ModelBundle.save``
        (its config.json holds only the heads the model type has)."""
        dev = resolve_device(device)
        files = checkpoint.model_dir_files(model_dir, accuracy)
        raw = checkpoint.load_config(files["config"])
        model_type = raw["model_type"]
        enc_mod = get_encoder(model_type)
        if is_ctc(model_type):
            heads = {"ctc_cfg": ctc_mod.CtcConfig(**raw["ctc"])}
        else:
            heads = {"decoder_cfg": decoder_mod.DecoderConfig(**raw["decoder"]),
                     "joiner_cfg": joiner_mod.JoinerConfig(**raw["joiner"])}
        return cls.from_params(
            model_type,
            enc_mod.Config(**raw["encoder"]),
            checkpoint.load_params(files["params"]),
            SymbolTable.from_file(files["tokens"]),
            FbankConfig(**raw.get("frontend", {})),
            device=dev,
            **heads,
        )

    def save(self, model_dir: str) -> None:
        """Write config.json, params.npz and tokens.txt as the JAX package's
        ``ModelBundle.save`` does; the parameters come back to the host."""
        os.makedirs(model_dir, exist_ok=True)
        checkpoint.save_config(
            os.path.join(model_dir, "config.json"),
            self.model_type,
            {
                "encoder": self.encoder_cfg,
                "decoder": self.decoder_cfg,
                "joiner": self.joiner_cfg,
                "ctc": self.ctc_cfg,
                "frontend": self.frontend_cfg,
            },
        )
        checkpoint.save_params(os.path.join(model_dir, "params.npz"),
                               checkpoint.tree_to_numpy(self.params))
        with open(os.path.join(model_dir, "tokens.txt"), "w", encoding="utf-8") as f:
            for i in range(len(self.tokens)):
                f.write(f"{self.tokens[i]} {i}\n")

    def int8_encoder(self) -> torch.nn.Module:
        """The encoder with its linears quantized by ``quantize_tree_int8``
        (``accuracy="int8"``), built on the bundle's device from its
        tensors; the leaves that stay float are shared with ``encoder``."""
        qtree = quantize_tree_int8(self.encoder.tree())
        return get_encoder(self.model_type).Encoder(self.encoder_cfg, qtree, self.device)

    def compute_modules(self, accuracy: str | None = None, mesh=None):
        """(encoder, CTC head or None) as a recognizer runs them: the
        encoder quantized under ``accuracy="int8"`` (first, as the JAX
        package does), and under a ``mesh`` this rank's shards of both
        (``parallel/sharding.shard_params``; the decoder and joiner stay
        whole and are the bundle's own)."""
        if mesh is None:
            return (self.int8_encoder() if accuracy == "int8" else self.encoder), self.ctc
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh is on {mesh.device_type}, bundle on {self.device.type}")
        params = self.params
        if accuracy == "int8":
            params["encoder"] = quantize_tree_int8(params["encoder"])
        params = shard_params(params, mesh)
        enc = get_encoder(self.model_type).Encoder(self.encoder_cfg, params["encoder"],
                                                   self.device)
        ctc = ctc_mod.Ctc(self.ctc_cfg, params["ctc"], self.device) if self.is_ctc else None
        return enc, ctc

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
        enc_dim = enc_mod.output_dim(encoder_cfg)
        params = {"encoder": enc_mod.init_params(rng, encoder_cfg)}
        if is_ctc(model_type):
            heads = {"ctc_cfg": ctc_mod.CtcConfig(encoder_dim=enc_dim, vocab_size=vocab_size)}
            params["ctc"] = ctc_mod.init_params(rng, heads["ctc_cfg"])
        else:
            heads = {
                "decoder_cfg": decoder_mod.DecoderConfig(
                    vocab_size=vocab_size, decoder_dim=decoder_dim, context_size=context_size),
                "joiner_cfg": joiner_mod.JoinerConfig(
                    encoder_dim=enc_dim, decoder_dim=decoder_dim, joiner_dim=joiner_dim,
                    vocab_size=vocab_size),
            }
            params["decoder"] = decoder_mod.init_params(rng, heads["decoder_cfg"])
            params["joiner"] = joiner_mod.init_params(rng, heads["joiner_cfg"])
        if symbols is None:
            symbols = ["<blk>", "<sos/eos>", "<unk>"] + [f"tok{i}" for i in range(3, vocab_size)]
        return cls.from_params(model_type, encoder_cfg, params, SymbolTable(symbols),
                               frontend_cfg or FbankConfig(), device=device, **heads)
