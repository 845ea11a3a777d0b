"""What the benchmark knows of the ``zipformer`` model type (zipformer v1,
icefall's ``pruned_transducer_stateless7`` and its ``_streaming`` variant):
its plain reference (``asrbench/reference/zipformer1.py``) loaded from the
benchmark's weights, the work of a streaming step counted from the
configuration's shapes (FLOPs, K1's least time, the freeze's least time a
lane), one lane's encoder-state bytes, and the ranges the weights draw its
constant leaves from.

The exports are those of every model type's file (``CONSTANT_RANGES``,
``output_dim``, ``build``, ``encode``, ``offline_work``, ``stream_work``),
and ``state_bytes``, which the freeze's bound counts.  Streaming only: no
offline v1 cell exists, and ``offline_work`` raises.
"""

from __future__ import annotations

import functools
import types

import torch

from asrbench.core import yardstick as Y
from asrbench.reference import zipformer1 as Z

# leaf name -> (low, high) for the leaves the system's init sets to a constant
CONSTANT_RANGES = {
    "eps_log": (-2.5, -1.5),  # BasicNorm's log eps (init log 0.25; the embed's is fixed in icefall)
    "bypass_scale": (0.3, 0.7),  # a layer's scalar bypass (init 0.5)
    "weight1": (0.05, 0.5),  # SimpleCombiner's weight of its first input (init 0)
    # the None slot of a stack without a U-Net skip: the weights draw a
    # number for it, which the system's encoder drops (it keeps None there)
    "skip_combiners": (0.0, 1.0),
}

OFFLINE = "the zipformer model type is streaming only in the benchmark: no offline cell"


def encoder_cfg(cfg: dict) -> types.SimpleNamespace:
    enc = dict(cfg["encoder"])
    enc["feature_dim"] = cfg["frontend"]["num_mel_bins"]
    return types.SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in enc.items()})


def output_dim(cfg: dict) -> int:
    return cfg["encoder"]["encoder_dims"][-1]


def build(cfg: dict, tree: dict, device) -> torch.nn.Module:
    """The reference encoder on ``device``, float32, its weights copied from
    the benchmark's encoder tree (the system's layout) into icefall's."""
    e = encoder_cfg(cfg)
    with torch.device("meta"):  # no initialisation: every weight is loaded below
        model = Z.OracleModel(e)
    model = model.to_empty(device=device).eval()
    model.load_state_dict(oracle_state(e, tree), strict=True)
    return model


def encode(model: torch.nn.Module, cfg: dict, feats: torch.Tensor,
           streaming: bool) -> torch.Tensor:
    """feats [T, F] of one utterance -> encoder frames [T', D].  Streaming:
    the chunk-causal forward with bounded left context over the raw frames
    the streamed windows covered (windows of 2 chunk + 7 frames, 2 chunk
    apart: icefall's simulated streaming), the embed cut to the whole
    chunks the windows produced and the output to theirs.  Offline: the
    whole utterance, under the same chunk-causal mask when the
    configuration is causal (icefall decodes its streaming model offline so)."""
    device = next(model.parameters()).device
    x = feats[None].to(device, torch.float32)
    e = cfg["encoder"]
    chunk, left = (e["chunk_size"], e["left_context_frames"]) if e["causal"] else (-1, -1)
    if not streaming:
        out, out_lens = model(x, torch.tensor([x.shape[1]], device=device), chunk, left)
        return out[0, : int(out_lens[0])]
    chunks = (x.shape[1] - 7) // (2 * chunk)
    emb = model.encoder_embed(x)[:, : chunks * chunk]
    frames = torch.tensor([emb.shape[1]], device=device)
    out, _ = model.encoder(emb.permute(1, 0, 2), frames, chunk, left)
    return out.permute(1, 0, 2)[0, : chunks * chunk // e["output_downsampling_factor"]]


# ---------------------------------------------------------------------------
# the work of a step and the state of a lane, from the configuration's shapes
# ---------------------------------------------------------------------------


def _stack_shapes(e) -> list:
    """Per stack: (layers, query frames of a step, keys of a step, heads,
    query head dim, left-context frames)."""
    out = []
    for s, ds in enumerate(e.downsampling_factors):
        t = max(1, e.chunk_size // ds)
        left = max(1, e.left_context_frames // ds)
        out.append((e.num_encoder_layers[s], t, left + t, e.num_heads[s],
                    e.attention_dims[s] // e.num_heads[s], left))
    return out


def state_bytes(cfg: dict) -> int:
    """One lane's encoder state, bytes: per layer, float32 ``len`` [1],
    ``avg`` [D], ``key`` [left, adim], ``val1`` and ``val2`` [left, adim/2],
    ``conv1`` and ``conv2`` [kernel - 1, D]; and the int64 ``processed``."""
    e = encoder_cfg(cfg)
    floats = 0
    for s, (layers, _, _, _, _, left) in enumerate(_stack_shapes(e)):
        d, adim, k = e.encoder_dims[s], e.attention_dims[s], e.cnn_module_kernels[s]
        floats += layers * (1 + d + left * adim + 2 * left * (adim // 2) + 2 * (k - 1) * d)
    return 4 * floats + 8


def offline_work(cfg: dict, rows: int, raw_frames: int, padded_frames: int, dtype, bandwidth,
                 count_flops: bool) -> dict:
    raise ValueError(OFFLINE)


def stream_work(cfg: dict, lanes: int, dtype, bandwidth, count_flops: bool) -> dict:
    """One streaming step over a pool of ``lanes``: each chunk's encoder
    frames and FLOPs, and under ``bounds`` (ms) K1's least time over the
    whole pool (one call a layer, each stack's chunk of queries against
    its left context and chunk of keys) and the freeze's least time for
    one stepped lane (``freeze_per_lane``: its new state read once and
    written once into the pool)."""
    e = encoder_cfg(cfg)
    k1 = 0.0
    for layers, t, s, h, qd, _ in _stack_shapes(e):
        nb, ops = Y.k1_bytes_ops(lanes, t, s, h, dtype, dtype, qd, e.pos_dim)
        k1 += layers * Y.bound(nb, ops, dtype, bandwidth)[0]
    return {"out_frames": e.chunk_size // e.output_downsampling_factor,
            "flops": stream_chunk_flops(e) if count_flops else 0.0,
            "bounds": {"k1": k1, "freeze_per_lane": 2 * state_bytes(cfg) / bandwidth * 1e3}}


@functools.lru_cache(maxsize=16)
def _chunk_flops(ecfg_items: tuple) -> float:
    e = types.SimpleNamespace(**dict(ecfg_items))
    n = e.left_context_frames // e.chunk_size + 1
    with torch.device("meta"):
        model = Z.OracleModel(e).eval()
        x = torch.zeros((1, 2 * e.chunk_size + 7, e.feature_dim))
        h = torch.zeros((n * e.chunk_size, 1, e.encoder_dims[0]))
        lens = torch.full((1,), n * e.chunk_size)
    embed = Y.flop_count(lambda: model.encoder_embed(x))
    stacks = Y.flop_count(lambda: model.encoder(h, lens, e.chunk_size, e.left_context_frames))
    return float(embed + stacks / n)


def stream_chunk_flops(e) -> float:
    """FLOPs of one streamed chunk with its full left context, as
    ``FlopCounterMode`` counts the reference: its embed over one window,
    and the chunk-causal stacks over left/chunk + 1 chunks, whose every
    chunk does a chunk's work against as many keys, divided by the chunks
    (as zipformer2's count)."""
    return _chunk_flops(tuple(sorted(vars(e).items())))


# ---------------------------------------------------------------------------
# the benchmark's weights in the reference's layout
# ---------------------------------------------------------------------------


def oracle_state(e, tree: dict) -> dict:
    """The encoder tree (the system's layout: linears [in, out], convs
    [k, in/g, out] and HWIO, ``in_proj`` packing [q | k | v | pos_q], the
    second value path as ``v2``/``out2``) -> the reference's ``state_dict``."""
    out = {}

    def t(x):
        return x.detach().to(torch.float32).clone()

    def lin(prefix, p):
        out[prefix + ".weight"] = t(p["w"]).t().contiguous()
        if "b" in p:
            out[prefix + ".bias"] = t(p["b"])

    def conv1d(prefix, p):  # a [in, out] linear as a k = 1 conv, or [k, in/g, out]
        w = t(p["w"])
        out[prefix + ".weight"] = (w.t()[:, :, None] if w.dim() == 2 else w.permute(2, 1, 0)
                                   ).contiguous()
        out[prefix + ".bias"] = t(p["b"])

    emb = tree["embed"]
    for i, name in zip((0, 2, 4), ("conv1", "conv2", "conv3")):
        out[f"encoder_embed.conv.{i}.weight"] = t(emb[name]["w"]).permute(3, 2, 0, 1).contiguous()
        out[f"encoder_embed.conv.{i}.bias"] = t(emb[name]["b"])
    lin("encoder_embed.out", emb["out"])
    out["encoder_embed.out_norm.eps"] = t(emb["out_norm"]["eps_log"]).reshape(())
    names = {"self_attn.in_proj": "in_proj", "self_attn.in_proj2": "v2",
             "self_attn.out_proj": "out1", "self_attn.out_proj2": "out2",
             "self_attn.linear_pos": "pos_proj"}
    for s, stack in enumerate(tree["stacks"]):
        ds = e.downsampling_factors[s]
        pre = f"encoder.encoders.{s}."
        enc = pre + ("encoder." if ds > 1 else "")
        for li, layer in enumerate(stack["layers"]):
            base = f"{enc}layers.{li}."
            for name, key in names.items():
                lin(base + name, layer["attn"][key])
            lin(base + "pooling.proj", layer["pooling"]["proj"])
            for k in (1, 2, 3):
                lin(f"{base}feed_forward{k}.in_proj", layer[f"ff{k}"]["w1"])
                lin(f"{base}feed_forward{k}.out_proj", layer[f"ff{k}"]["w2"])
            for k in (1, 2):
                c = layer[f"conv{k}"]
                for mod, key in (("pointwise_conv1", "pw1"), ("depthwise_conv", "dw"),
                                 ("pointwise_conv2", "pw2")):
                    conv1d(f"{base}conv_module{k}.{mod}", c[key])
            out[base + "norm_final.eps"] = t(layer["norm"]["eps_log"]).reshape(())
            out[base + "bypass_scale"] = t(layer["bypass_scale"]).reshape(())
        if ds > 1:
            out[pre + "downsample.query"] = t(stack["downsample"]["query"])
            if "extra_proj" in stack["downsample"]:
                lin(pre + "downsample.extra_proj", stack["downsample"]["extra_proj"])
            out[pre + "upsample.bias"] = t(stack["upsample_bias"])
            out[pre + "out_combiner.weight1"] = t(stack["out_combiner"]["weight1"]).reshape(())
    for i, j in enumerate(Z.skip_sources(e.downsampling_factors)):
        if j is not None:
            out[f"encoder.skip_modules.{i}.weight1"] = \
                t(tree["skip_combiners"][i]["weight1"]).reshape(())
    out["encoder.downsample_output.query"] = t(tree["downsample_output"]["query"])
    return out
