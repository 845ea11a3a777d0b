"""Zipformer2 encoder weight mapping: icefall ONNX export names -> params.

icefall's ONNX export serializes the torch module tree, so initializer
names follow the state_dict paths of (encoder_embed, encoder).  This module
maps those to the port's numpy tree (models/zipformer2.init_params) with
the JAX package's layout transforms — the port's copy of
``k2transducerasr_tpu/convert/zipformer2_map.py``.

Name patterns are matched by SUFFIX with tolerant prefixes (exports differ
in wrapper prefixes).  Everything matched is converted; everything not
matched is returned so the caller can report it — no silent drops.

NOTE: exact Sequential indices inside encoder_embed.conv differ between
icefall revisions; both the (0,3,6) and (0,2,4) layouts are accepted.
"""

from __future__ import annotations

import re

import numpy as np

from k2transducerasr_tpu_torch.convert.importer import (
    conv1d_w,
    conv2d_w,
    left_at_initial,
    linear_w,
    template,
)
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config, init_params


def _set(tree, path: list, value: np.ndarray, expect_shape=True):
    node = tree
    for p in path[:-1]:
        node = node[p]
    old = node[path[-1]]
    if expect_shape and tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'.'.join(map(str, path))}: "
            f"model {tuple(old.shape)} vs import {tuple(value.shape)}"
        )
    node[path[-1]] = value.astype(np.float32)


# icefall layer submodule -> (the tree's node, its linear)
_LAYER_MAP = {
    "self_attn_weights.in_proj": ("attn_weights", "in_proj"),
    "self_attn_weights.linear_pos": ("attn_weights", "pos_proj"),
    "self_attn1.in_proj": ("self_attn1", "v"),
    "self_attn1.out_proj": ("self_attn1", "out"),
    "self_attn2.in_proj": ("self_attn2", "v"),
    "self_attn2.out_proj": ("self_attn2", "out"),
    "nonlin_attention.in_proj": ("nonlin_attn", "in_proj"),
    "nonlin_attention.out_proj": ("nonlin_attn", "out"),
    "feed_forward1.in_proj": ("ff1", "w1"),
    "feed_forward1.out_proj": ("ff1", "w2"),
    "feed_forward2.in_proj": ("ff2", "w1"),
    "feed_forward2.out_proj": ("ff2", "w2"),
    "feed_forward3.in_proj": ("ff3", "w1"),
    "feed_forward3.out_proj": ("ff3", "w2"),
    "conv_module1.in_proj": ("conv1", "in_proj"),
    "conv_module1.out_proj": ("conv1", "out"),
    "conv_module2.in_proj": ("conv2", "in_proj"),
    "conv_module2.out_proj": ("conv2", "out"),
}


def infer_config_refinements(
    cfg: Zipformer2Config, weights: dict[str, np.ndarray]
) -> Zipformer2Config:
    """The reference's ONNX metadata omits several hyperparameters (embed
    conv channels, feedforward dims, pos dims, downsampling factors) — they
    are fixed in icefall.  Recover them from weight shapes so imports of
    non-default exports still line up."""
    import dataclasses

    kw = {}
    conv_idx = sorted(
        {
            int(m.group(1))
            for k in weights
            for m in [re.search(r"encoder_embed\.conv\.(\d+)\.weight$", k)]
            if m
        }
    )
    if len(conv_idx) == 3:
        chans = tuple(
            weights[f"encoder_embed.conv.{i}.weight"].shape[0] for i in conv_idx
        )
        kw["embed_channels"] = chans
    n_stacks = len(cfg.num_encoder_layers)
    if len(cfg.downsampling_factors) != n_stacks:
        kw["downsampling_factors"] = (1, 2, 4, 8, 4, 2)[:n_stacks]
    ff = []
    for s in range(n_stacks):
        for key in (
            f"encoder.encoders.{s}.layers.0.feed_forward1.in_proj.weight",
            f"encoder.encoders.{s}.encoder.layers.0.feed_forward1.in_proj.weight",
        ):
            if key in weights:
                ff.append(int(weights[key].shape[0]))
                break
        else:
            ff = None
            break
    if ff:
        kw["feedforward_dims"] = tuple(ff)
    for key in (
        "encoder.encoders.0.layers.0.self_attn_weights.linear_pos.weight",
        "encoder.encoders.0.encoder.layers.0.self_attn_weights.linear_pos.weight",
    ):
        if key in weights:
            out_dim, pos_dim = weights[key].shape
            kw["pos_dim"] = int(pos_dim)
            kw["pos_head_dim"] = int(out_dim) // cfg.num_heads[0]
            break
    return dataclasses.replace(cfg, **kw) if kw else cfg


def map_zipformer2_weights(
    cfg: Zipformer2Config, weights: dict[str, np.ndarray]
) -> tuple[dict, list[str], list[str], list[str]]:
    """Returns (params, mapped_names, unmapped_names, left_at_init).  ``params`` starts
    from init_params(numpy seed 0) and is overwritten leaf by leaf; callers
    should treat any unmapped ENCODER weight as an import failure.
    ``left_at_init`` names the leaves no weight set."""
    params, initial = template(init_params, cfg)
    mapped: list[str] = []
    unmapped: list[str] = []

    embed_conv_slots = {}  # ordinal -> param name
    for ordinal, name in enumerate(["conv1", "conv2", "conv3"]):
        embed_conv_slots[ordinal] = name

    # collect embed conv indices actually present, in order
    conv_idx = sorted(
        {
            int(m.group(1))
            for k in weights
            for m in [re.search(r"encoder_embed\.conv\.(\d+)\.weight$", k)]
            if m
        }
    )

    def embed_conv_name(idx: int):
        try:
            return embed_conv_slots[conv_idx.index(idx)]
        except ValueError:
            return None

    rules: list[tuple[re.Pattern, callable]] = []

    def rule(pattern):
        def deco(fn):
            rules.append((re.compile(pattern), fn))
            return fn

        return deco

    @rule(r"encoder_embed\.conv\.(\d+)\.(weight|bias)$")
    def _embed_conv(m, v):
        name = embed_conv_name(int(m.group(1)))
        if name is None:
            return False
        if m.group(2) == "weight":
            _set(params, ["embed", name, "w"], conv2d_w(v))
        else:
            _set(params, ["embed", name, "b"], v)
        return True

    @rule(r"encoder_embed\.convnext\.depthwise_conv\.(weight|bias)$")
    def _convnext_dw(m, v):
        if m.group(1) == "weight":
            # torch depthwise Conv2d [C,1,7,7] -> dense diagonal [7,7,C,C]
            c = v.shape[0]
            dense = np.zeros((v.shape[2], v.shape[3], c, c), np.float32)
            for ch in range(c):
                dense[:, :, ch, ch] = v[ch, 0]
            _set(params, ["embed", "convnext_dw", "w"], dense)
        else:
            _set(params, ["embed", "convnext_dw", "b"], v)
        return True

    @rule(r"encoder_embed\.convnext\.pointwise_conv1\.(weight|bias)$")
    def _convnext_pw1(m, v):
        if m.group(1) == "weight":
            # torch 1x1 Conv2d [O,C,1,1] -> linear [C,O]
            _set(params, ["embed", "convnext_pw1", "w"], linear_w(v[:, :, 0, 0]))
        else:
            _set(params, ["embed", "convnext_pw1", "b"], v)
        return True

    @rule(r"encoder_embed\.convnext\.pointwise_conv2\.(weight|bias)$")
    def _convnext_pw2(m, v):
        if m.group(1) == "weight":
            _set(params, ["embed", "convnext_pw2", "w"], linear_w(v[:, :, 0, 0]))
        else:
            _set(params, ["embed", "convnext_pw2", "b"], v)
        return True

    @rule(r"encoder_embed\.out\.(weight|bias)$")
    def _embed_out(m, v):
        if m.group(1) == "weight":
            _set(params, ["embed", "out", "w"], linear_w(v))
        else:
            _set(params, ["embed", "out", "b"], v)
        return True

    @rule(r"encoder_embed\.out_norm\.(bias|log_scale)$")
    def _embed_norm(m, v):
        _set(params, ["embed", "out_norm", m.group(1)], v, expect_shape=False)
        return True


    @rule(
        r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.([\w.]+)\.(weight|bias)$"
    )
    def _layer(m, v):
        s, l, inner, kind = int(m.group(1)), int(m.group(2)), m.group(3), m.group(4)
        layer = params["stacks"][s]["layers"][l]
        if inner in _LAYER_MAP:
            a, b_ = _LAYER_MAP[inner]
            key = "w" if kind == "weight" else "b"
            _set(
                params,
                ["stacks", s, "layers", l, a, b_, key],
                linear_w(v) if kind == "weight" else v,
            )
            return True
        if inner in ("conv_module1.depthwise_conv", "conv_module2.depthwise_conv"):
            # offline (non-causal) export: plain depthwise nn.Conv1d
            which = "conv1" if inner.startswith("conv_module1") else "conv2"
            if kind == "weight":
                _set(params, ["stacks", s, "layers", l, which, "dw", "w"], conv1d_w(v))
            else:
                _set(params, ["stacks", s, "layers", l, which, "dw", "b"], v)
            return True
        cc = re.fullmatch(
            r"conv_module(1|2)\.depthwise_conv\.(causal_conv|chunkwise_conv)", inner
        )
        if cc:
            # streaming export: ChunkCausalDepthwiseConv1d's two convs
            which = "conv1" if cc.group(1) == "1" else "conv2"
            tgt = "causal_dw" if cc.group(2) == "causal_conv" else "chunk_dw"
            key = "w" if kind == "weight" else "b"
            _set(
                params,
                ["stacks", s, "layers", l, which, tgt, key],
                conv1d_w(v) if kind == "weight" else v,
            )
            return True
        del layer
        return False

    @rule(
        r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\."
        r"conv_module(1|2)\.depthwise_conv\.chunkwise_conv_scale$"
    )
    def _chunk_scale(m, v):
        # torch [2, C, k] -> [2, k, D]
        s, l = int(m.group(1)), int(m.group(2))
        which = "conv1" if m.group(3) == "1" else "conv2"
        _set(
            params,
            ["stacks", s, "layers", l, which, "chunk_scale"],
            np.transpose(v, (0, 2, 1)),
        )
        return True

    @rule(r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.norm\.(bias|log_scale)$")
    def _layer_norm(m, v):
        s, l = int(m.group(1)), int(m.group(2))
        _set(params, ["stacks", s, "layers", l, "norm", m.group(3)], v, expect_shape=False)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.bypass(_mid)?\.bypass_scale$")
    def _bypass(m, v):
        s, l = int(m.group(1)), int(m.group(2))
        key = "bypass_mid" if m.group(3) else "bypass"
        _set(params, ["stacks", s, "layers", l, key], v)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.downsample\.bias$")
    def _ds(m, v):
        _set(params, ["stacks", int(m.group(1)), "downsample_weights"], v)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.out_combiner\.bypass_scale$")
    def _out_comb(m, v):
        _set(params, ["stacks", int(m.group(1)), "bypass_out"], v)
        return True

    @rule(r"encoder\.downsample_output\.bias$")
    def _ds_out(m, v):
        _set(params, ["downsample_output_weights"], v)
        return True

    for name, value in weights.items():
        hit = False
        for pattern, fn in rules:
            m = pattern.search(name)
            if m:
                try:
                    hit = bool(fn(m, np.asarray(value)))
                except (KeyError, IndexError) as e:
                    raise ValueError(f"mapping {name!r} failed: {e}") from e
                if hit:
                    break
        (mapped if hit else unmapped).append(name)
    return params, mapped, unmapped, left_at_initial(params, initial)


def export_zipformer2_weights(params, cfg: Zipformer2Config) -> dict[str, np.ndarray]:
    """The inverse of ``map_zipformer2_weights`` for a non-causal encoder:
    a numpy tree -> icefall's export names and torch layouts (the input of
    synthetic conversions, ``importer.export_model_dir``)."""
    if cfg.causal:
        raise ValueError("export_zipformer2_weights takes a non-causal config")

    def lin(w):
        return np.ascontiguousarray(np.asarray(w).T)

    w = {}
    emb = params["embed"]
    for i, name in zip((0, 3, 6), ("conv1", "conv2", "conv3")):
        w[f"encoder_embed.conv.{i}.weight"] = np.transpose(emb[name]["w"], (3, 2, 0, 1))
        w[f"encoder_embed.conv.{i}.bias"] = emb[name]["b"]
    dw = np.asarray(emb["convnext_dw"]["w"])  # dense diagonal [7, 7, C, C] -> [C, 1, 7, 7]
    w["encoder_embed.convnext.depthwise_conv.weight"] = np.stack(
        [dw[:, :, c, c] for c in range(dw.shape[-1])])[:, None]
    w["encoder_embed.convnext.depthwise_conv.bias"] = emb["convnext_dw"]["b"]
    for name in ("convnext_pw1", "convnext_pw2"):
        pre = "encoder_embed.convnext.pointwise_conv" + name[-1]
        w[pre + ".weight"] = lin(emb[name]["w"])[:, :, None, None]
        w[pre + ".bias"] = emb[name]["b"]
    w["encoder_embed.out.weight"] = lin(emb["out"]["w"])
    w["encoder_embed.out.bias"] = emb["out"]["b"]
    w["encoder_embed.out_norm.bias"] = emb["out_norm"]["bias"]
    w["encoder_embed.out_norm.log_scale"] = emb["out_norm"]["log_scale"]
    for s, stack in enumerate(params["stacks"]):
        wrap = "" if cfg.downsampling_factors[s] == 1 else "encoder."
        for l, layer in enumerate(stack["layers"]):
            base = f"encoder.encoders.{s}.{wrap}layers.{l}."
            for inner, (a, b) in _LAYER_MAP.items():
                w[base + inner + ".weight"] = lin(layer[a][b]["w"])
                if "b" in layer[a][b]:
                    w[base + inner + ".bias"] = layer[a][b]["b"]
            for which, mod in (("conv1", "conv_module1"), ("conv2", "conv_module2")):
                w[base + mod + ".depthwise_conv.weight"] = np.transpose(
                    layer[which]["dw"]["w"], (2, 1, 0))
                w[base + mod + ".depthwise_conv.bias"] = layer[which]["dw"]["b"]
            w[base + "norm.bias"] = layer["norm"]["bias"]
            w[base + "norm.log_scale"] = layer["norm"]["log_scale"]
            w[base + "bypass.bypass_scale"] = layer["bypass"]
            w[base + "bypass_mid.bypass_scale"] = layer["bypass_mid"]
        if "downsample_weights" in stack:
            w[f"encoder.encoders.{s}.downsample.bias"] = stack["downsample_weights"]
            w[f"encoder.encoders.{s}.out_combiner.bypass_scale"] = stack["bypass_out"]
    w["encoder.downsample_output.bias"] = params["downsample_output_weights"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in w.items()}
