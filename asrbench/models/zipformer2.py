"""What the benchmark knows of the ``zipformer2`` model type: its plain
reference (``asrbench/reference/zipformer2.py``, icefall's encoder) loaded
from the benchmark's weights, the work of an offline batch or a streaming
step counted from the configuration's shapes, and the ranges the weights
draw its constant leaves from.

A model type's file exports ``CONSTANT_RANGES``, ``output_dim``, ``build``,
``encode``, ``offline_work`` and ``stream_work``; the harness, the weights
and the check call nothing else of it, so another model type is another
file of this folder, named as its configuration's ``model_type``.
"""

from __future__ import annotations

import functools
import types

import torch

from asrbench.core import yardstick as Y
from asrbench.reference import zipformer2 as Z

# leaf name -> (low, high) for the leaves the system's init sets to a constant
CONSTANT_RANGES = {
    "bypass": (0.3, 0.7),
    "bypass_mid": (0.3, 0.7),
    "bypass_out": (0.3, 0.7),
    "chunk_scale": (-0.2, 0.2),
    "downsample_weights": (-1.0, 1.0),
    "downsample_output_weights": (-1.0, 1.0),
    "bias": (-0.1, 0.1),  # BiasNorm's bias
    "log_scale": (-0.2, 0.2),
}


def encoder_cfg(cfg: dict) -> types.SimpleNamespace:
    enc = dict(cfg["encoder"])
    enc["feature_dim"] = cfg["frontend"]["num_mel_bins"]
    return types.SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in enc.items()})


def output_dim(cfg: dict) -> int:
    return max(cfg["encoder"]["encoder_dims"])


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
    """feats [T, F] of one utterance -> encoder frames [T', D].  Offline: the
    whole utterance.  Streaming: the chunk-causal forward with bounded left
    context over the raw frames the streamed windows covered (icefall's
    simulated streaming), cut to the whole chunks the windows produced."""
    device = next(model.parameters()).device
    x = feats[None].to(device, torch.float32)
    lens = torch.tensor([x.shape[1]], device=device)
    if not streaming:
        out, out_lens = model(x, lens)
        return out[0, : int(out_lens[0])]
    e = cfg["encoder"]
    chunk = e["chunk_size"]
    chunks = (x.shape[1] - 13) // (2 * chunk)
    emb = model.encoder_embed(x)[:, : chunks * chunk]
    frames = torch.tensor([emb.shape[1]], device=device)
    out, _ = model.encoder(emb.permute(1, 0, 2), frames, chunk, e["left_context_frames"])
    return out.permute(1, 0, 2)[0, : chunks * chunk // 2]


# ---------------------------------------------------------------------------
# the work of a batch or a step, from the configuration's shapes
# ---------------------------------------------------------------------------


def out_frames(raw_frames: int) -> int:
    """Encoder output frames of an utterance of ``raw_frames`` feature
    frames: the embed's (T - 7) // 2, then the final downsampling by 2."""
    return -(-max((raw_frames - 7) // 2, 0) // 2)


def _k1_bound_ms(e, rows: int, frames_at: list, keys_at: list, dtype, bandwidth) -> float:
    """K1's least time over one replay: one call per layer, at each stack's
    query and key frames."""
    total = 0.0
    for s, layers in enumerate(e.num_encoder_layers):
        nb, ops = Y.k1_bytes_ops(rows, frames_at[s], keys_at[s], e.num_heads[s], dtype, dtype,
                                 e.query_head_dim, e.pos_head_dim)
        total += layers * Y.bound(nb, ops, dtype, bandwidth)[0]
    return total


def offline_work(cfg: dict, rows: int, raw_frames: int, padded_frames: int, dtype, bandwidth,
                 count_flops: bool) -> dict:
    """One offline batch of ``rows`` utterances of ``raw_frames`` feature
    frames, padded to ``padded_frames``: each row's encoder frames and
    FLOPs, and K1's least time (``bounds``, ms) at the padded shapes the
    replay runs."""
    e = encoder_cfg(cfg)
    t0 = (padded_frames - 7) // 2
    at = [-(-t0 // ds) for ds in e.downsampling_factors]
    return {"out_frames": out_frames(raw_frames),
            "flops": encoder_flops(e, raw_frames) if count_flops else 0.0,
            "bounds": {"k1": _k1_bound_ms(e, rows, at, at, dtype, bandwidth)}}


def stream_work(cfg: dict, lanes: int, dtype, bandwidth, count_flops: bool) -> dict:
    """One streaming step over a pool of ``lanes``: each chunk's encoder
    frames and FLOPs, and K1's least time over the whole pool (``bounds``,
    ms)."""
    e = encoder_cfg(cfg)
    q = [max(1, e.chunk_size // ds) for ds in e.downsampling_factors]
    k = [max(1, e.left_context_frames // ds) + max(1, e.chunk_size // ds)
         for ds in e.downsampling_factors]
    return {"out_frames": e.chunk_size // 2,
            "flops": stream_chunk_flops(e) if count_flops else 0.0,
            "bounds": {"k1": _k1_bound_ms(e, lanes, q, k, dtype, bandwidth)}}


@functools.lru_cache(maxsize=64)
def _model_poly(ecfg_items: tuple) -> tuple:
    """Per stack, the coefficients (c0, c1, c2) of one layer's FLOPs in its
    frame count T (c0 + c1 T + c2 T^2: the linears and convolutions grow
    with T, the scores with T^2, the positional projection with 2T - 1),
    from three counts of one reference layer on the meta device."""
    e = types.SimpleNamespace(**dict(ecfg_items))
    polys = []
    for s, dim in enumerate(e.encoder_dims):
        with torch.device("meta"):
            layer = Z.Zipformer2EncoderLayer(
                dim, e.pos_dim, e.num_heads[s], e.query_head_dim, e.pos_head_dim,
                e.value_head_dim, e.feedforward_dims[s], e.cnn_module_kernels[s], e.causal)
            pos = Z.CompactRelPositionalEncoding(e.pos_dim)
        ts = (16, 32, 64)
        counts = []
        for t in ts:
            x = torch.zeros((t, 1, dim), device="meta")
            chunk = t if e.causal else -1
            counts.append(Y.flop_count(lambda: layer(x, pos(x), chunk_size=chunk)))
        a = torch.tensor([[1.0, t, t * t] for t in ts], dtype=torch.float64)
        polys.append(tuple(torch.linalg.solve(a, torch.tensor(counts, dtype=torch.float64))
                           .tolist()))
    return tuple(polys)


def _embed_flops(e, raw_frames: int) -> int:
    with torch.device("meta"):
        embed = Z.Conv2dSubsampling(e.feature_dim, e.encoder_dims[0], *e.embed_channels)
        x = torch.zeros((1, raw_frames, e.feature_dim))
    return Y.flop_count(lambda: embed(x))


def _stacks_flops(e, t0: int) -> float:
    """The stacks' FLOPs over ``t0`` embedded frames (the downsampling,
    upsampling and channel stitching do no products)."""
    total = 0.0
    for s, (c0, c1, c2) in enumerate(_model_poly(tuple(sorted(vars(e).items())))):
        t = -(-t0 // e.downsampling_factors[s])
        total += e.num_encoder_layers[s] * (c0 + c1 * t + c2 * t * t)
    return total


def encoder_flops(e, raw_frames: int) -> float:
    """Matmul and convolution FLOPs of the reference encoder over one
    utterance of ``raw_frames`` feature frames (offline), as
    ``FlopCounterMode`` counts them; ``e`` is ``encoder_cfg``'s."""
    return _embed_flops(e, int(raw_frames)) + _stacks_flops(e, (int(raw_frames) - 7) // 2)


def stream_chunk_flops(e) -> float:
    """FLOPs of one streamed chunk with its full left context: the
    chunk-causal forward over left/chunk + 1 chunks, whose every chunk does
    a chunk's work against as many keys, divided by the chunks; its embed
    over one window."""
    n = e.left_context_frames // e.chunk_size + 1
    return (_embed_flops(e, 2 * e.chunk_size + 13)
            + _stacks_flops(e, n * e.chunk_size) / n)


# ---------------------------------------------------------------------------
# the benchmark's weights in the reference's layout
# ---------------------------------------------------------------------------


def oracle_state(e, tree: dict) -> dict:
    """The encoder tree (the system's layout: linears [in, out], convs
    [k, in/g, out] and HWIO, the ConvNeXt depthwise weight as a dense
    diagonal, chunk scales [2, k, D]) -> the reference's ``state_dict``."""
    out = {}

    def t(x):
        return x.detach().to(torch.float32).clone()

    def lin(prefix, p):
        out[prefix + ".weight"] = t(p["w"]).t().contiguous()
        if "b" in p:
            out[prefix + ".bias"] = t(p["b"])

    emb = tree["embed"]
    for i, name in zip((0, 2, 4), ("conv1", "conv2", "conv3")):
        out[f"encoder_embed.conv.{i}.weight"] = t(emb[name]["w"]).permute(3, 2, 0, 1).contiguous()
        out[f"encoder_embed.conv.{i}.bias"] = t(emb[name]["b"])
    dw = t(emb["convnext_dw"]["w"])  # [7, 7, C, C], the diagonal is the depthwise weight
    out["encoder_embed.convnext.depthwise_conv.weight"] = \
        torch.diagonal(dw, dim1=2, dim2=3).permute(2, 0, 1)[:, None].contiguous()
    out["encoder_embed.convnext.depthwise_conv.bias"] = t(emb["convnext_dw"]["b"])
    for k in (1, 2):
        p = emb[f"convnext_pw{k}"]
        out[f"encoder_embed.convnext.pointwise_conv{k}.weight"] = \
            t(p["w"]).t()[:, :, None, None].contiguous()
        out[f"encoder_embed.convnext.pointwise_conv{k}.bias"] = t(p["b"])
    lin("encoder_embed.out", emb["out"])
    out["encoder_embed.out_norm.bias"] = t(emb["out_norm"]["bias"])
    out["encoder_embed.out_norm.log_scale"] = t(emb["out_norm"]["log_scale"]).reshape(())
    names = {
        "self_attn_weights.in_proj": ("attn_weights", "in_proj"),
        "self_attn_weights.linear_pos": ("attn_weights", "pos_proj"),
        "self_attn1.in_proj": ("self_attn1", "v"), "self_attn1.out_proj": ("self_attn1", "out"),
        "self_attn2.in_proj": ("self_attn2", "v"), "self_attn2.out_proj": ("self_attn2", "out"),
        "nonlin_attention.in_proj": ("nonlin_attn", "in_proj"),
        "nonlin_attention.out_proj": ("nonlin_attn", "out"),
        "feed_forward1.in_proj": ("ff1", "w1"), "feed_forward1.out_proj": ("ff1", "w2"),
        "feed_forward2.in_proj": ("ff2", "w1"), "feed_forward2.out_proj": ("ff2", "w2"),
        "feed_forward3.in_proj": ("ff3", "w1"), "feed_forward3.out_proj": ("ff3", "w2"),
        "conv_module1.in_proj": ("conv1", "in_proj"), "conv_module1.out_proj": ("conv1", "out"),
        "conv_module2.in_proj": ("conv2", "in_proj"), "conv_module2.out_proj": ("conv2", "out"),
    }
    for s, stack in enumerate(tree["stacks"]):
        wrap = "" if e.downsampling_factors[s] == 1 else "encoder."
        for li, layer in enumerate(stack["layers"]):
            base = f"encoder.encoders.{s}.{wrap}layers.{li}."
            for name, (a, b) in names.items():
                lin(base + name, layer[a][b])
            for which, mod in (("conv1", "conv_module1"), ("conv2", "conv_module2")):
                c = layer[which]
                pre = base + mod + ".depthwise_conv"
                if e.causal:
                    for src, dst in (("causal_dw", "causal_conv"), ("chunk_dw", "chunkwise_conv")):
                        out[f"{pre}.{dst}.weight"] = t(c[src]["w"]).permute(2, 1, 0).contiguous()
                        out[f"{pre}.{dst}.bias"] = t(c[src]["b"])
                    out[f"{pre}.chunkwise_conv_scale"] = \
                        t(c["chunk_scale"]).permute(0, 2, 1).contiguous()
                else:
                    out[f"{pre}.weight"] = t(c["dw"]["w"]).permute(2, 1, 0).contiguous()
                    out[f"{pre}.bias"] = t(c["dw"]["b"])
            out[base + "norm.bias"] = t(layer["norm"]["bias"])
            out[base + "norm.log_scale"] = t(layer["norm"]["log_scale"]).reshape(())
            out[base + "bypass.bypass_scale"] = t(layer["bypass"])
            out[base + "bypass_mid.bypass_scale"] = t(layer["bypass_mid"])
        if e.downsampling_factors[s] > 1:
            out[f"encoder.encoders.{s}.downsample.bias"] = t(stack["downsample_weights"])
            out[f"encoder.encoders.{s}.out_combiner.bypass_scale"] = t(stack["bypass_out"])
    out["encoder.downsample_output.bias"] = t(tree["downsample_output_weights"])
    return out
