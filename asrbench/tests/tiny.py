"""Tiny cells for the CPU tests: the benchmark's configurations at small
widths and its mixes at short lengths, run on the CPU, where the system runs
its plain versions."""

from __future__ import annotations

import copy
import json
import os

from asrbench.core.spec import BENCH_DIR, Cell

TINY_ENCODER = {
    "num_encoder_layers": [1, 1],
    "encoder_dims": [32, 48],
    "downsampling_factors": [1, 2],
    "num_heads": [2, 2],
    "feedforward_dims": [48, 64],
    "cnn_module_kernels": [7, 7],
    "query_head_dim": 8,
    "value_head_dim": 4,
    "pos_head_dim": 2,
    "pos_dim": 8,
    "embed_channels": [4, 8, 16],
}


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def config(streaming: bool, compute_dtype="float32") -> dict:
    name = "zipformer2_librispeech_medium" + ("_streaming" if streaming else "")
    cfg = copy.deepcopy(_load("configs", name))
    cfg["encoder"].update(TINY_ENCODER)
    cfg["decoder"]["decoder_dim"] = 32
    cfg["joiner"]["joiner_dim"] = 32
    cfg["vocab_size"] = 50
    cfg["compute_dtype"] = compute_dtype
    cfg["emission"].update(calibration_clips=2, calibration_s=4.0)
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(_load("traffic", name))
    if m["loop"] == "offline_batches":
        m.update(rows=3, segment_s=3.0, distinct_batches=2, check_requests=3, trace_s=0.5)
    else:
        m.update(streams=3, max_lanes=4, distinct_sessions=4,
                 session_s={"dist": "uniform", "min": 1.5, "max": 3.0}, check_sessions=2, lead_s=0.5,
                 trace_s=0.5)
    return m


def cell(config_: dict, mix_: dict, name="tiny", limit: float = 1e-3) -> Cell:
    """A cell of the tiny widths: float32 on the CPU reads a gap of 0 (the
    limit only has to be above that)."""
    return Cell(name, 1, config_, mix_,
                [{"name": "setup_s", "unit": "s"},
                 {"name": "offline_audio_s_per_s", "unit": "audio-s/s"},
                 {"name": "stream_chunk_p95_ms", "unit": "ms"}], [],
                {"max_logit_gap": limit})
