"""The system under test, built from a configuration file and the seed's
weights: the PyTorch and CUDA package's ``ModelBundle`` and its offline or
streaming recognizer.  Nothing else of the benchmark imports the system."""

from __future__ import annotations

import copy

import torch

from k2transducerasr_tpu_torch.frontend.fbank import FbankConfig
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.models.registry import get_encoder
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer
from k2transducerasr_tpu_torch.runtime.online import OnlineRecognizer
from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def symbols(vocab: int) -> list[str]:
    """A BPE-like table: blank, sos/eos, unk, then word-initial pieces
    (every third) and continuations."""
    out = ["<blk>", "<sos/eos>", "<unk>"]
    for i in range(3, vocab):
        out.append(f"▁w{i}" if i % 3 == 0 else f"p{i}")
    return out


def configs(cfg: dict):
    enc_mod = get_encoder(cfg["model_type"])
    ecfg = enc_mod.Config(**cfg["encoder"])
    dcfg = decoder_mod.DecoderConfig(vocab_size=cfg["vocab_size"], **cfg["decoder"])
    jcfg = joiner_mod.JoinerConfig(encoder_dim=enc_mod.output_dim(ecfg),
                                   decoder_dim=dcfg.decoder_dim,
                                   joiner_dim=cfg["joiner"]["joiner_dim"],
                                   vocab_size=cfg["vocab_size"])
    return enc_mod, ecfg, dcfg, jcfg


def init_fns(cfg: dict) -> dict:
    """The system's initializers, bound to the configuration: what
    ``weights.make_tree`` records the tree's shapes from."""
    enc_mod, ecfg, dcfg, jcfg = configs(cfg)
    return {"encoder": lambda rng: enc_mod.init_params(rng, ecfg),
            "decoder": lambda rng: decoder_mod.init_params(rng, dcfg),
            "joiner": lambda rng: joiner_mod.init_params(rng, jcfg)}


def build(cfg: dict, tree: dict, device):
    """-> the recognizer the configuration states, on ``device``, holding
    ``tree``'s tensors (a shallow copy of the tree: its leaves are shared,
    never written).  Every key of the configuration's ``recognizer`` but
    ``kind`` is the recognizer's keyword of that name (``frame_bucket``,
    ``max_lanes``, ``accuracy``, ``max_active_paths``, ...)."""
    enc_mod, ecfg, dcfg, jcfg = configs(cfg)
    bundle = ModelBundle.from_params(
        cfg["model_type"], ecfg, copy.copy(tree), SymbolTable(symbols(cfg["vocab_size"])),
        FbankConfig(**cfg["frontend"]), decoder_cfg=dcfg, joiner_cfg=jcfg, device=device)
    options = dict(cfg["recognizer"])  # the recognizer's own options, by name
    kind = options.pop("kind")
    cls = OfflineRecognizer if kind == "offline" else OnlineRecognizer
    return cls(bundle, decoding_method=cfg["decoding_method"],
               compute_dtype=DTYPES[cfg["compute_dtype"]], device=device, **options)
