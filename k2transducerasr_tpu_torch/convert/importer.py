"""ONNX export -> model directory converter — the port's copy of
``k2transducerasr_tpu/convert/importer.py``; the directory it writes loads
into either package.

Maps a k2/icefall ONNX export (encoder.onnx / decoder.onnx / joiner.onnx +
tokens.txt — the reference's input format) to this framework's model-dir
layout (config.json + params.npz + tokens.txt, see runtime/checkpoint.py).

Three stages:
  1. metadata -> configs: the ONNX CustomMetadataMap keys the reference
     parses (``OnlineModel.cs:32-183`` / ``OfflineModel.cs:31-71``:
     model_type, decode_chunk_len, T/pad_length, per-stack
     num_encoder_layers/encoder_dims/attention_dims/cnn_module_kernels/
     left_context_len, zipformer2 query/value_head_dims + num_heads, lstm
     d_model/rnn_hidden_size, conformer encoder_dim/chunk_size/left_context,
     decoder context_size/vocab_size, joiner joiner_dim) become the
     corresponding Config dataclasses here.
  2. initializers -> params: QDQ int8 weights are dequantized
     (onnx_proto.OnnxModel.dequantized), then the JAX package's layout
     transforms
     (Linear [out,in] -> [in,out]; Conv1d [out,in/g,k] -> [k,in/g,out];
     Conv2d [out,in,kh,kw] -> [kh,kw,in,out]).
  3. name mapping: decoder/joiner exports have a stable tiny surface and
     map exactly; encoder mapping tables are per-family and best-effort —
     unmapped names are reported loudly rather than silently dropped.

An encoder leaf that no initializer sets keeps its initial value from the
family's ``init_params`` (numpy seed 0); those values differ from the JAX
package's (``jax.random``), so ``IMPORT_REPORT.txt`` names every such leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from k2transducerasr_tpu_torch.convert import onnx_proto
from k2transducerasr_tpu_torch.models.registry import get_encoder
from k2transducerasr_tpu_torch.runtime.checkpoint import flatten_params


def _ints(csv: str) -> tuple:
    return tuple(int(x) for x in csv.replace(" ", ",").split(",") if x != "")


def linear_w(a: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> [in, out]."""
    return np.ascontiguousarray(a.T)


def conv1d_w(a: np.ndarray) -> np.ndarray:
    """torch Conv1d [out, in/g, k] -> [k, in/g, out]."""
    return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))


def conv2d_w(a: np.ndarray) -> np.ndarray:
    """torch Conv2d [out, in, kh, kw] -> [kh, kw, in, out]."""
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))


def template(init_params, cfg) -> tuple[dict, dict]:
    """A family's initial numpy tree (numpy seed 0), which a map overwrites
    leaf by leaf, and its flat leaves (kept to tell which stay)."""
    params = init_params(np.random.default_rng(0), cfg)
    return params, flatten_params(params)


def left_at_initial(params, initial: dict) -> list[str]:
    """The dotted paths of the leaves of ``params`` that are still the
    template's own arrays (``None`` slots are no leaves)."""
    return [k for k, v in flatten_params(params).items() if v is initial.get(k)]


# ---------------------------------------------------------------------------
# metadata -> configs
# ---------------------------------------------------------------------------


def detect_model_type(metadata: dict[str, str]) -> str:
    mt = metadata.get("model_type", "")
    comment = metadata.get("comment", "")
    # the reference rewrites zipformer2 + "ctc" comment to zipformer2ctc
    # (OfflineModel.cs:56-62)
    if mt == "zipformer2" and "ctc" in comment.lower():
        return "zipformer2ctc"
    return mt


def encoder_config_from_metadata(metadata: dict[str, str]):
    """Build the encoder Config for the detected family from the reference's
    metadata keys.  Streaming exports carry decode_chunk_len etc.; offline
    exports carry only the family name (configs then use family defaults)."""
    mt = detect_model_type(metadata)
    streaming = "decode_chunk_len" in metadata

    if mt in ("zipformer2", "zipformer2ctc"):
        from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

        kw = {}
        if "num_encoder_layers" in metadata:
            kw["num_encoder_layers"] = _ints(metadata["num_encoder_layers"])
        if "encoder_dims" in metadata:
            kw["encoder_dims"] = _ints(metadata["encoder_dims"])
        if "cnn_module_kernels" in metadata:
            kw["cnn_module_kernels"] = _ints(metadata["cnn_module_kernels"])
        if "num_heads" in metadata:
            kw["num_heads"] = _ints(metadata["num_heads"])
        if "query_head_dims" in metadata:
            kw["query_head_dim"] = _ints(metadata["query_head_dims"])[0]
        if "value_head_dims" in metadata:
            kw["value_head_dim"] = _ints(metadata["value_head_dims"])[0]
        if streaming:
            kw["causal"] = True
            kw["chunk_size"] = int(metadata["decode_chunk_len"]) // 2
            if "left_context_len" in metadata:
                lc = _ints(metadata["left_context_len"])
                kw["left_context_frames"] = lc[0]
        return Zipformer2Config(**kw)

    if mt == "zipformer":
        from k2transducerasr_tpu_torch.models.zipformer import ZipformerConfig

        kw = {}
        if "num_encoder_layers" in metadata:
            kw["num_encoder_layers"] = _ints(metadata["num_encoder_layers"])
        if "encoder_dims" in metadata:
            kw["encoder_dims"] = _ints(metadata["encoder_dims"])
        if "attention_dims" in metadata:
            kw["attention_dims"] = _ints(metadata["attention_dims"])
        if "cnn_module_kernels" in metadata:
            kw["cnn_module_kernels"] = _ints(metadata["cnn_module_kernels"])
        if streaming:
            kw["causal"] = True
            kw["chunk_size"] = int(metadata["decode_chunk_len"]) // 2
            if "left_context_len" in metadata:
                kw["left_context_frames"] = _ints(metadata["left_context_len"])[0]
        return ZipformerConfig(**kw)

    if mt == "lstm":
        from k2transducerasr_tpu_torch.models.lstm import LstmConfig

        kw = {}
        if "d_model" in metadata:
            kw["d_model"] = int(metadata["d_model"])
        if "rnn_hidden_size" in metadata:
            kw["rnn_hidden_size"] = int(metadata["rnn_hidden_size"])
        if "num_encoder_layers" in metadata:
            v = metadata["num_encoder_layers"]
            kw["num_layers"] = _ints(v)[0] if "," in v else int(v)
        return LstmConfig(**kw)

    if mt == "conformer":
        from k2transducerasr_tpu_torch.models.conformer import ConformerConfig

        kw = {}
        if "encoder_dim" in metadata:
            kw["d_model"] = int(metadata["encoder_dim"])
        if "num_encoder_layers" in metadata:
            kw["num_layers"] = int(metadata["num_encoder_layers"])
        if "cnn_module_kernel" in metadata:
            kw["cnn_kernel"] = int(metadata["cnn_module_kernel"])
        if streaming or "chunk_size" in metadata:
            kw["causal"] = True
            if "chunk_size" in metadata:
                kw["chunk_size"] = int(metadata["chunk_size"])
            if "left_context" in metadata:
                kw["left_context"] = int(metadata["left_context"])
        return ConformerConfig(**kw)

    raise ValueError(f"unknown model_type in metadata: {metadata.get('model_type')!r}")


def decoder_config_from_metadata(metadata: dict[str, str]):
    from k2transducerasr_tpu_torch.models.decoder import DecoderConfig

    return DecoderConfig(
        vocab_size=int(metadata["vocab_size"]),
        context_size=int(metadata.get("context_size", 2)),
        decoder_dim=0,  # filled from the embedding weight at import time
    )


# ---------------------------------------------------------------------------
# decoder / joiner weight import (stable export surface)
# ---------------------------------------------------------------------------


def import_decoder(model: onnx_proto.OnnxModel):
    """decoder.onnx -> (params, DecoderConfig).  icefall exports the
    stateless decoder as embedding (+ grouped conv when context>1)."""
    weights = model.dequantized()
    emb = _find(weights, ["embedding.weight", "decoder.embedding.weight"])
    conv = _find(weights, ["conv.weight", "decoder.conv.weight"], required=False)
    meta = model.metadata
    vocab, dim = emb.shape
    from k2transducerasr_tpu_torch.models.decoder import DecoderConfig

    context = int(meta.get("context_size", 2 if conv is not None else 1))
    cfg = DecoderConfig(vocab_size=vocab, decoder_dim=dim, context_size=context)
    params = {"embedding": {"table": emb.astype(np.float32)}}
    if conv is not None:
        params["conv"] = {"w": conv1d_w(conv).astype(np.float32)}
    return params, cfg


def import_joiner(model: onnx_proto.OnnxModel, encoder_dim=None, decoder_dim=None):
    weights = model.dequantized()
    enc_w = _find(weights, ["encoder_proj.weight", "joiner.encoder_proj.weight"])
    dec_w = _find(weights, ["decoder_proj.weight", "joiner.decoder_proj.weight"])
    out_w = _find(weights, ["output_linear.weight", "joiner.output_linear.weight"])
    from k2transducerasr_tpu_torch.models.joiner import JoinerConfig

    cfg = JoinerConfig(
        encoder_dim=enc_w.shape[1],
        decoder_dim=dec_w.shape[1],
        joiner_dim=enc_w.shape[0],
        vocab_size=out_w.shape[0],
    )
    params = {
        "encoder_proj": {"w": linear_w(enc_w)},
        "decoder_proj": {"w": linear_w(dec_w)},
        "output": {"w": linear_w(out_w)},
    }
    for name, keys in (
        ("encoder_proj", ["encoder_proj.bias", "joiner.encoder_proj.bias"]),
        ("decoder_proj", ["decoder_proj.bias", "joiner.decoder_proj.bias"]),
        ("output", ["output_linear.bias", "joiner.output_linear.bias"]),
    ):
        b = _find(weights, keys, required=False)
        if b is not None:
            params[name]["b"] = b.astype(np.float32)
    return params, cfg


def import_ctc_head(weights: dict[str, np.ndarray]):
    """Extract the CTC classifier from a fused zipformer2-CTC export.

    The reference treats the fused model as a black box whose output[0] is
    log-probs [B,T,V] (``OfflineProjOfZipformer2ctc.cs:48-92``).  Inside the
    graph that head is icefall's ``ctc_output`` Sequential(Dropout, Linear,
    LogSoftmax) — its single Linear is serialized as
    ``ctc_output.1.{weight,bias}`` (index varies by export wrapper, so any
    ``ctc_output[.N].weight`` suffix is accepted).

    Returns (params, vocab_size, used_names).
    """
    import re

    w_name = b_name = None
    for k in weights:
        if re.search(r"ctc_output\.(?:\d+\.)?weight$", k):
            w_name = k
        elif re.search(r"ctc_output\.(?:\d+\.)?bias$", k):
            b_name = k
    if w_name is None:
        raise KeyError(
            "fused CTC export has no ctc_output.*.weight initializer "
            f"(among {len(weights)}: {sorted(weights)[:8]} ...)"
        )
    w = weights[w_name]
    params = {"output": {"w": linear_w(w).astype(np.float32)}}
    used = [w_name]
    if b_name is not None:
        params["output"]["b"] = weights[b_name].astype(np.float32)
        used.append(b_name)
    return params, int(w.shape[0]), used


def export_model_dir(bundle, dst_dir: str) -> None:
    """Write a non-causal zipformer2 transducer bundle as an icefall-style
    ONNX dir — encoder.onnx, decoder.onnx and joiner.onnx (metadata and
    initializers only) and tokens.txt — the input ``convert_model_dir``
    takes, for synthetic conversions (chip_smoke.py, the tests).  The
    metadata carries what icefall's does; the config must be one it
    describes (the default downsampling factors)."""
    import os

    from k2transducerasr_tpu_torch.convert.zipformer2_map import export_zipformer2_weights
    from k2transducerasr_tpu_torch.runtime.checkpoint import tree_to_numpy

    cfg = bundle.encoder_cfg
    if bundle.model_type != "zipformer2" or cfg.downsampling_factors != (
            1, 2, 4, 8, 4, 2)[:len(cfg.encoder_dims)]:
        raise ValueError("export_model_dir takes a zipformer2 transducer with the default "
                         "downsampling factors")

    def csv(v):
        return ",".join(str(x) for x in v)

    meta = {"model_type": "zipformer2", "num_encoder_layers": csv(cfg.num_encoder_layers),
            "encoder_dims": csv(cfg.encoder_dims),
            "cnn_module_kernels": csv(cfg.cnn_module_kernels), "num_heads": csv(cfg.num_heads),
            "query_head_dims": str(cfg.query_head_dim),
            "value_head_dims": str(cfg.value_head_dim)}
    dec, join = tree_to_numpy(bundle.decoder.tree()), tree_to_numpy(bundle.joiner.tree())
    dec_w = {"embedding.weight": dec["embedding"]["table"]}
    if "conv" in dec:
        dec_w["conv.weight"] = np.transpose(dec["conv"]["w"], (2, 1, 0))
    join_w = {}
    for name, node in (("encoder_proj", "encoder_proj"), ("decoder_proj", "decoder_proj"),
                       ("output_linear", "output")):
        join_w[f"{name}.weight"] = join[node]["w"].T
        if "b" in join[node]:
            join_w[f"{name}.bias"] = join[node]["b"]
    dcfg = bundle.decoder_cfg
    files = {
        "encoder.onnx": (meta, export_zipformer2_weights(tree_to_numpy(bundle.encoder.tree()),
                                                         cfg)),
        "decoder.onnx": ({"context_size": str(dcfg.context_size),
                          "vocab_size": str(dcfg.vocab_size)}, dec_w),
        "joiner.onnx": ({"joiner_dim": str(bundle.joiner_cfg.joiner_dim)}, join_w),
    }
    os.makedirs(dst_dir, exist_ok=True)
    for name, (m, weights) in files.items():
        with open(os.path.join(dst_dir, name), "wb") as f:
            f.write(onnx_proto.encode_model(m, weights))
    with open(os.path.join(dst_dir, "tokens.txt"), "w", encoding="utf-8") as f:
        for i in range(len(bundle.tokens)):
            f.write(f"{bundle.tokens[i]} {i}\n")


def _find(weights: dict[str, np.ndarray], names: list[str], required: bool = True):
    for n in names:
        if n in weights:
            return weights[n]
    # suffix match (export prefixes vary)
    for key in weights:
        for n in names:
            if key.endswith(n):
                return weights[key]
    if required:
        raise KeyError(
            f"none of {names} found among {len(weights)} initializers "
            f"(sample: {sorted(weights)[:8]})"
        )
    return None


# ---------------------------------------------------------------------------
# top-level conversion
# ---------------------------------------------------------------------------


def convert_model_dir(src_dir: str, dst_dir: str) -> None:
    """Convert a reference-style ONNX model directory (encoder/decoder/
    joiner .onnx + tokens.txt — discovery rules as in
    Examples/OnlineRecognizer.cs:41-77) to a framework model dir.

    Encoder weight import is per-family and may report unmapped names; the
    directory is still written with mapped weights plus an import report.
    """
    import glob
    import os

    def pick(patterns):
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(src_dir, pat)))
            # prefer non-quantized when both exist
            for h in hits:
                if "int8" not in h:
                    return h
            if hits:
                return hits[0]
        return None

    enc_path = pick(["encoder*.onnx", "model*.onnx"])
    dec_path = pick(["decoder*.onnx"])
    join_path = pick(["joiner*.onnx"])
    tok_path = pick(["tokens*.txt"])
    if enc_path is None or tok_path is None:
        raise FileNotFoundError(f"no encoder/tokens found in {src_dir}")

    enc_model = onnx_proto.load(enc_path)
    metadata = enc_model.metadata
    model_type = detect_model_type(metadata)
    enc_cfg = encoder_config_from_metadata(metadata)
    # "feature" metadata: fbank (default) or whisper (hanning, centered
    # frames — OfflineStream.cs:27-32)
    from k2transducerasr_tpu_torch.frontend.fbank import FbankConfig

    frontend_cfg = (
        FbankConfig.whisper()
        if metadata.get("feature") == "whisper"
        else FbankConfig()
    )

    report: list[str] = []
    ctc_params = ctc_vocab = None
    deq = enc_model.dequantized()
    if model_type in ("zipformer2", "zipformer2ctc"):
        from k2transducerasr_tpu_torch.convert.zipformer2_map import (
            infer_config_refinements,
            map_zipformer2_weights,
        )

        enc_cfg = infer_config_refinements(enc_cfg, deq)
        enc_params, mapped, unmapped, kept = map_zipformer2_weights(enc_cfg, deq)
        if model_type.endswith("ctc"):
            # the fused export carries the classifier head alongside the
            # encoder — pull it out and count its names as mapped
            ctc_params, ctc_vocab, used = import_ctc_head(deq)
            mapped.extend(used)
            unmapped = [n for n in unmapped if n not in used]
            report.append(f"ctc head: imported {used} (vocab {ctc_vocab})")
        report.append(
            f"encoder: mapped {len(mapped)}/{len(mapped) + len(unmapped)} "
            f"initializers from {os.path.basename(enc_path)}"
        )
        if unmapped:
            report.append("UNMAPPED encoder weights (import may be incomplete):")
            report.extend(f"  {n}" for n in sorted(unmapped)[:200])
    elif model_type == "zipformer":
        from k2transducerasr_tpu_torch.convert.zipformer1_map import map_zipformer1_weights

        enc_params, mapped, unmapped, kept = map_zipformer1_weights(enc_cfg, deq)
        report.append(
            f"encoder: mapped {len(mapped)}/{len(mapped) + len(unmapped)} "
            f"initializers from {os.path.basename(enc_path)}"
        )
        if unmapped:
            report.append("UNMAPPED encoder weights (import may be incomplete):")
            report.extend(f"  {n}" for n in sorted(unmapped)[:200])
    elif model_type in ("conformer", "lstm"):
        from k2transducerasr_tpu_torch.convert.family_maps import (
            infer_conformer_refinements,
            infer_lstm_refinements,
            map_conformer_weights,
            map_lstm_weights,
        )

        if model_type == "conformer":
            enc_cfg = infer_conformer_refinements(enc_cfg, deq)
            fn = map_conformer_weights
        else:
            enc_cfg = infer_lstm_refinements(enc_cfg, deq)
            fn = map_lstm_weights
        enc_params, mapped, unmapped, kept = fn(enc_cfg, deq)
        report.append(
            f"encoder: mapped {len(mapped)}/{len(mapped) + len(unmapped)} "
            f"initializers from {os.path.basename(enc_path)}"
        )
        if unmapped:
            report.append("UNMAPPED encoder weights (import may be incomplete):")
            report.extend(f"  {n}" for n in sorted(unmapped)[:200])

    from k2transducerasr_tpu_torch.models import ctc as ctc_mod
    from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
    from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable

    if kept:
        report.append(f"encoder leaves left at their initial value ({len(kept)}; "
                      "random, not from the export):")
        report.extend(f"  encoder.{k}" for k in kept)
    # the heads' configs as the JAX package's ModelBundle.random builds them
    enc_dim = get_encoder(model_type).output_dim(enc_cfg)
    params = {"encoder": enc_params}
    if model_type.endswith("ctc"):
        vocab = ctc_vocab or int(metadata.get("vocab_size", 500))
        heads = {"ctc_cfg": ctc_mod.CtcConfig(encoder_dim=enc_dim, vocab_size=vocab)}
        if ctc_params is None:
            ctc_params = ctc_mod.init_params(np.random.default_rng(0), heads["ctc_cfg"])
            report.append("ctc head left at its initial value (random, not from the export)")
        params["ctc"] = ctc_params
    else:
        params["decoder"], dec_cfg = import_decoder(onnx_proto.load(dec_path))
        params["joiner"], join_cfg = import_joiner(onnx_proto.load(join_path))
        heads = {"decoder_cfg": dec_cfg, "joiner_cfg": dataclasses.replace(
            join_cfg, encoder_dim=enc_dim, decoder_dim=dec_cfg.decoder_dim,
            vocab_size=dec_cfg.vocab_size)}
    bundle = ModelBundle.from_params(model_type, enc_cfg, params, SymbolTable.from_file(tok_path),
                                     frontend_cfg, device="cpu", **heads)

    os.makedirs(dst_dir, exist_ok=True)
    bundle.save(dst_dir)
    with open(os.path.join(dst_dir, "IMPORT_REPORT.txt"), "w") as f:
        f.write("\n".join(report) + "\n")
