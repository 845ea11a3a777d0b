"""What the benchmark knows of the ``conformer`` model type: its plain
reference (``asrbench/reference/conformer.py``, icefall's
``pruned_transducer_stateless`` conformer) loaded from the benchmark's
weights, the work of an offline batch counted from the configuration's
shapes, K2's least bytes and operations, and the ranges the weights draw
its constant leaves from.

The exports are those of every model type's file (``CONSTANT_RANGES``,
``output_dim``, ``build``, ``encode``, ``offline_work``, ``stream_work``),
and ``k2_bytes_ops``, K2's count, which sits here beside the only model
type that runs K2.  Offline only: no streaming conformer cell exists, and
``stream_work`` and a streaming ``encode`` raise.
"""

from __future__ import annotations

import functools
import types

import torch

from asrbench.core import yardstick as Y
from asrbench.reference import conformer as C

# leaf name -> (low, high) for the leaves the system's init sets to a constant
CONSTANT_RANGES = {
    "scale": (0.5, 1.5),  # LayerNorm's and the folded BatchNorm's scale
    "bias": (-0.1, 0.1),  # their bias
    "u": (-0.3, 0.3),  # pos_bias_u (icefall's xavier bound at 8 heads of 64: 0.29)
    "v_bias": (-0.3, 0.3),  # pos_bias_v
}

STREAMING = "the conformer model type is offline only in the benchmark: no streaming cell"


def encoder_cfg(cfg: dict) -> types.SimpleNamespace:
    enc = dict(cfg["encoder"])
    enc["feature_dim"] = cfg["frontend"]["num_mel_bins"]
    return types.SimpleNamespace(**enc)


def output_dim(cfg: dict) -> int:
    return cfg["encoder"]["d_model"]


def build(cfg: dict, tree: dict, device) -> torch.nn.Module:
    """The reference encoder on ``device``, float32, its weights copied from
    the benchmark's encoder tree (the system's layout) into icefall's."""
    e = encoder_cfg(cfg)
    with torch.device("meta"):  # no initialisation: every weight is loaded below
        model = C.OracleConformer(e)
    model = model.to_empty(device=device).eval()
    model.load_state_dict(oracle_state(tree), strict=True)
    return model


def encode(model: torch.nn.Module, cfg: dict, feats: torch.Tensor,
           streaming: bool) -> torch.Tensor:
    """feats [T, F] of one utterance -> encoder frames [T', D], the whole
    utterance offline."""
    if streaming:
        raise ValueError(STREAMING)
    device = next(model.parameters()).device
    x = feats[None].to(device, torch.float32)
    out, out_lens = model(x, torch.tensor([x.shape[1]], device=device))
    return out[0, : int(out_lens[0])]


# ---------------------------------------------------------------------------
# the work of a batch, from the configuration's shapes
# ---------------------------------------------------------------------------


def out_frames(raw_frames: int) -> int:
    """Encoder output frames of an utterance of ``raw_frames`` feature
    frames: two VALID stride-2 3x3 convs, ((T - 1) // 2 - 1) // 2."""
    return max(((raw_frames - 1) // 2 - 1) // 2, 0)


def k2_bytes_ops(b, t, s, h, dh, dtype):
    """K2 (``relpos_attn_ctx``) at one call's shapes: q, pos_q [b, t, h, dh]
    and k, v [b, s, h, dh] read once, pos_k over the t + s - 1 relative
    positions [t + s - 1, h, dh], the lanes' int32 lengths, ctx [b, t, h,
    dh] written once; 2 b h t s dh operations for each of the content
    scores, the position scores and P.V."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * t * h * dh + 2 * b * s * h * dh + (t + s - 1) * h * dh
              + b * t * h * dh) * e + 4 * b
    return nbytes, 3 * 2 * b * h * t * s * dh


def offline_work(cfg: dict, rows: int, raw_frames: int, padded_frames: int, dtype, bandwidth,
                 count_flops: bool) -> dict:
    """One offline batch of ``rows`` utterances of ``raw_frames`` feature
    frames, padded to ``padded_frames``: each row's encoder frames and
    FLOPs, and K2's least time (``bounds``, ms): one call a layer at the
    padded frames the replay runs."""
    e = encoder_cfg(cfg)
    t = out_frames(padded_frames)
    nb, ops = k2_bytes_ops(rows, t, t, e.num_heads, e.d_model // e.num_heads, dtype)
    return {"out_frames": out_frames(raw_frames),
            "flops": encoder_flops(e, raw_frames) if count_flops else 0.0,
            "bounds": {"k2": e.num_layers * Y.bound(nb, ops, dtype, bandwidth)[0]}}


def stream_work(cfg: dict, lanes: int, dtype, bandwidth, count_flops: bool) -> dict:
    raise ValueError(STREAMING)


@functools.lru_cache(maxsize=64)
def _flops(ecfg_items: tuple, raw_frames: int) -> float:
    """The embed's FLOPs and one layer's, times the layers, over one
    utterance of ``raw_frames`` on the meta device."""
    e = types.SimpleNamespace(**dict(ecfg_items))
    with torch.device("meta"):
        embed = C.Conv2dSubsampling(e.feature_dim, e.d_model)
        layer = C.ConformerEncoderLayer(e.d_model, e.num_heads, e.ff_dim, e.cnn_kernel,
                                        e.causal).eval()
        x = torch.zeros((1, raw_frames, e.feature_dim))
        t = out_frames(raw_frames)
        h = torch.zeros((1, t, e.d_model))
        pos = C.rel_positional_encoding(t, t, e.d_model, "meta")
        valid = torch.ones((1, t), dtype=torch.bool)
    mask = valid[:, None, :] & valid[:, :, None]
    return float(Y.flop_count(lambda: embed(x))
                 + e.num_layers * Y.flop_count(lambda: layer(h, pos, mask, pad_mask=valid)))


def encoder_flops(e, raw_frames: int) -> float:
    """Matmul and convolution FLOPs of the reference encoder over one
    utterance of ``raw_frames`` feature frames, as ``FlopCounterMode``
    counts them; ``e`` is ``encoder_cfg``'s."""
    return _flops(tuple(sorted(vars(e).items())), int(raw_frames))


# ---------------------------------------------------------------------------
# the benchmark's weights in the reference's layout
# ---------------------------------------------------------------------------


def oracle_state(tree: dict) -> dict:
    """The encoder tree (the system's layout: linears [in, out], convs
    [k, in/g, out] and HWIO, q/k/v apart, BatchNorm folded to scale and
    bias) -> the reference's ``state_dict``: q/k/v packed into ``in_proj``,
    the folded BatchNorm as running statistics (mean 0, var 1 - eps) under
    its scale and bias, which reproduce it."""
    out = {}

    def t(x):
        return x.detach().to(torch.float32).clone()

    def lin(prefix, p):
        out[prefix + ".weight"] = t(p["w"]).t().contiguous()
        if "b" in p:
            out[prefix + ".bias"] = t(p["b"])

    def conv1d(prefix, p):
        out[prefix + ".weight"] = t(p["w"]).permute(2, 1, 0).contiguous()
        out[prefix + ".bias"] = t(p["b"])

    def norm(prefix, p):
        out[prefix + ".weight"] = t(p["scale"])
        out[prefix + ".bias"] = t(p["bias"])

    sub = tree["subsample"]
    for i, name in zip((0, 2), ("conv1", "conv2")):
        out[f"encoder_embed.conv.{i}.weight"] = t(sub[name]["w"]).permute(3, 2, 0, 1).contiguous()
        out[f"encoder_embed.conv.{i}.bias"] = t(sub[name]["b"])
    lin("encoder_embed.out", sub["out"])
    for li, layer in enumerate(tree["layers"]):
        base = f"encoder.layers.{li}."
        a = layer["attn"]
        out[base + "self_attn.in_proj_weight"] = torch.cat(
            [t(a[n]["w"]).t() for n in ("q", "k", "v")]).contiguous()
        out[base + "self_attn.in_proj_bias"] = torch.cat([t(a[n]["b"]) for n in ("q", "k", "v")])
        lin(base + "self_attn.out_proj", a["out"])
        lin(base + "self_attn.linear_pos", a["pos"])
        out[base + "self_attn.pos_bias_u"] = t(a["u"])
        out[base + "self_attn.pos_bias_v"] = t(a["v_bias"])
        for mod, ff in (("feed_forward_macaron", "ff1"), ("feed_forward", "ff2")):
            lin(f"{base}{mod}.0", layer[ff]["w1"])
            lin(f"{base}{mod}.3", layer[ff]["w2"])
        c = layer["conv"]
        for mod, key in (("pointwise_conv1", "pw1"), ("depthwise_conv", "dw"),
                         ("pointwise_conv2", "pw2")):
            conv1d(f"{base}conv_module.{mod}", c[key])
        bn = f"{base}conv_module.norm"
        norm(bn, c["bn"])
        d = c["bn"]["scale"].shape[0]
        dev = c["bn"]["scale"].device
        out[bn + ".running_mean"] = torch.zeros(d, device=dev)
        # + BatchNorm1d's eps (1e-5) is 1 exactly in float32
        out[bn + ".running_var"] = torch.full((d,), 1.0 - 1e-5, device=dev)
        out[bn + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=dev)
        for mod, key in (("norm_ff_macaron", ("ff1", "ln")), ("norm_mha", ("attn", "ln")),
                         ("norm_conv", ("conv", "ln")), ("norm_ff", ("ff2", "ln")),
                         ("norm_final", ("norm_final",))):
            p = layer
            for k in key:
                p = p[k]
            norm(base + mod, p)
    return out
