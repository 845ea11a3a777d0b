"""Encoder-family registry (port of ``k2transducerasr_tpu/models/registry.py``).

Each family is a module with the reference's functional surface, so the
recognizers stay family-agnostic:

    Config, init_params(rng, cfg), output_dim(cfg), Encoder (nn.Module)
    forward(params, cfg, x, lens)          -> (enc_out [B,T',D], out_lens)
    init_state(cfg, batch, device)         -> streaming state tree
    streaming_step(params, cfg, state, chunk, compute_dtype)
                                           -> (enc_out, new_state)
    output_chunk_len(cfg)                  -> output frames per step

Every family of the reference is ported: conformer, LSTM, zipformer v1,
zipformer2 and zipformer2-CTC (the zipformer2 encoder under a CTC head).
"""

from __future__ import annotations

import importlib

_PORTED = {
    "conformer": "k2transducerasr_tpu_torch.models.conformer",
    "lstm": "k2transducerasr_tpu_torch.models.lstm",
    "zipformer": "k2transducerasr_tpu_torch.models.zipformer",
    "zipformer2": "k2transducerasr_tpu_torch.models.zipformer2",
    # the CTC head replaces decoder and joiner; the encoder is zipformer2's
    "zipformer2ctc": "k2transducerasr_tpu_torch.models.zipformer2",
}


def get_encoder(model_type: str):
    if model_type not in _PORTED:
        raise ValueError(f"unknown model_type {model_type!r}; expected one of {sorted(_PORTED)}")
    return importlib.import_module(_PORTED[model_type])


def is_ctc(model_type: str) -> bool:
    return model_type.endswith("ctc")
