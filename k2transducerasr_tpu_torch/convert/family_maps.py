"""Encoder weight maps for the conformer and LSTM families.

Same contract as convert/zipformer2_map.py: suffix-matched icefall
state-dict names -> the port's numpy tree with the JAX package's layout
transforms (the port's copy of ``k2transducerasr_tpu/convert/family_maps.py``);
unmapped names returned for loud reporting; shape mismatches raise.

Notes on the reference graphs:
  * conformer: packed qkv ``self_attn.in_proj_weight [3D, D]`` splits into
    the framework's separate q/k/v linears; ``linear_pos``, ``pos_bias_u/v``
    map to the rel-pos projection and content/position biases; the conv
    module's BatchNorm running stats FOLD into inference scale/bias.
  * lstm: torch LSTM tensors (weight_ih/hh/hr, bias_ih+bias_hh summed) map
    onto the hoisted-projection layout (wx/wh/wp/b); torch gate order
    i,f,g,o matches the framework's split.
"""

from __future__ import annotations

import re

import numpy as np

from k2transducerasr_tpu_torch.convert.importer import (
    conv2d_w,
    left_at_initial,
    linear_w,
    template,
)


def _set(tree, path, value, expect_shape=True):
    node = tree
    for p in path[:-1]:
        node = node[p]
    old = node[path[-1]]
    if expect_shape and tuple(old.shape) != tuple(np.shape(value)):
        raise ValueError(
            f"shape mismatch at {'.'.join(map(str, path))}: "
            f"model {tuple(old.shape)} vs import {tuple(np.shape(value))}"
        )
    node[path[-1]] = np.asarray(value, np.float32)


def _run_rules(params, initial, weights, rules):
    """-> (params, mapped, unmapped, left_at_init): ``initial`` is the
    template's flat leaves (``importer.template``)."""
    mapped, unmapped = [], []
    deferred = {}
    for name, value in weights.items():
        hit = False
        for pattern, fn in rules:
            m = pattern.search(name)
            if m:
                hit = bool(fn(m, np.asarray(value), deferred))
                if hit:
                    break
        (mapped if hit else unmapped).append(name)
    # second pass for combined tensors (e.g. lstm bias_ih + bias_hh)
    for fn in deferred.pop("__finalize__", []):
        fn()
    return params, mapped, unmapped, left_at_initial(params, initial)


def infer_lstm_refinements(cfg, weights):
    """Recover hyperparameters the reference metadata omits from weight
    shapes (ff_dim)."""
    import dataclasses

    kw = {}
    k = "encoder.layers.0.feed_forward.0.weight"
    for name in weights:
        if name.endswith(k) or name.endswith("layers.0.feed_forward.0.weight"):
            kw["ff_dim"] = int(weights[name].shape[0])
            break
    return dataclasses.replace(cfg, **kw) if kw else cfg


def infer_conformer_refinements(cfg, weights):
    import dataclasses

    kw = {}
    for name, v in weights.items():
        if name.endswith("layers.0.feed_forward.0.weight"):
            kw["ff_dim"] = int(v.shape[0])
            break
    return dataclasses.replace(cfg, **kw) if kw else cfg


# ---------------------------------------------------------------------------
# Conformer
# ---------------------------------------------------------------------------


def map_conformer_weights(cfg, weights):
    from k2transducerasr_tpu_torch.models.conformer import init_params

    params, initial = template(init_params, cfg)
    rules = []

    def rule(pat):
        def deco(fn):
            rules.append((re.compile(pat), fn))
            return fn

        return deco

    conv_idx = sorted(
        {
            int(m.group(1))
            for k in weights
            for m in [re.search(r"encoder_embed\.conv\.(\d+)\.weight$", k)]
            if m
        }
    )

    @rule(r"encoder_embed\.conv\.(\d+)\.(weight|bias)$")
    def _econv(m, v, d):
        try:
            name = ("conv1", "conv2")[conv_idx.index(int(m.group(1)))]
        except (ValueError, IndexError):
            return False
        key = "w" if m.group(2) == "weight" else "b"
        _set(params, ["subsample", name, key], conv2d_w(v) if key == "w" else v)
        return True

    @rule(r"encoder_embed\.out\.(weight|bias)$")
    def _eout(m, v, d):
        key = "w" if m.group(1) == "weight" else "b"
        _set(params, ["subsample", "out", key], linear_w(v) if key == "w" else v)
        return True

    ln_map = {
        "norm_ff_macaron": ("ff1", "ln"),
        "norm_mha": ("attn", "ln"),
        "norm_conv": ("conv", "ln"),
        "norm_ff": ("ff2", "ln"),
        "norm_final": ("norm_final",),
    }
    ff_map = {
        ("feed_forward_macaron", 0): ("ff1", "w1"),
        ("feed_forward_macaron", 3): ("ff1", "w2"),
        ("feed_forward", 0): ("ff2", "w1"),
        ("feed_forward", 3): ("ff2", "w2"),
    }

    @rule(r"encoder\.layers\.(\d+)\.(feed_forward(?:_macaron)?)\.(\d+)\.(weight|bias)$")
    def _ff(m, v, d):
        l, which, idx, kind = int(m.group(1)), m.group(2), int(m.group(3)), m.group(4)
        tgt = ff_map.get((which, idx)) or ff_map.get((which, 0 if idx < 2 else 3))
        if tgt is None:
            return False
        key = "w" if kind == "weight" else "b"
        _set(params, ["layers", l, *tgt, key], linear_w(v) if key == "w" else v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.(norm_\w+)\.(weight|bias)$")
    def _ln(m, v, d):
        l, which, kind = int(m.group(1)), m.group(2), m.group(3)
        tgt = ln_map.get(which)
        if tgt is None:
            return False
        key = "scale" if kind == "weight" else "bias"
        _set(params, ["layers", l, *tgt, key], v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.self_attn\.in_proj_(weight|bias)$")
    def _qkv(m, v, d):
        l, kind = int(m.group(1)), m.group(2)
        third = v.shape[0] // 3
        for i, name in enumerate(("q", "k", "v")):
            piece = v[i * third : (i + 1) * third]
            key = "w" if kind == "weight" else "b"
            _set(params, ["layers", l, "attn", name, key],
                 linear_w(piece) if kind == "weight" else piece)
        return True

    @rule(r"encoder\.layers\.(\d+)\.self_attn\.linear_pos\.weight$")
    def _pos(m, v, d):
        _set(params, ["layers", int(m.group(1)), "attn", "pos", "w"], linear_w(v))
        return True

    @rule(r"encoder\.layers\.(\d+)\.self_attn\.pos_bias_(u|v)$")
    def _posb(m, v, d):
        key = "u" if m.group(2) == "u" else "v_bias"
        _set(params, ["layers", int(m.group(1)), "attn", key], v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)$")
    def _attnout(m, v, d):
        key = "w" if m.group(2) == "weight" else "b"
        _set(params, ["layers", int(m.group(1)), "attn", "out", key],
             linear_w(v) if key == "w" else v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.conv_module\.pointwise_conv(1|2)\.(weight|bias)$")
    def _pw(m, v, d):
        l, which, kind = int(m.group(1)), m.group(2), m.group(3)
        name = "pw1" if which == "1" else "pw2"
        if kind == "weight":
            # torch Conv1d 1x [O, I, 1] -> framework conv1d [1, I, O]
            _set(params, ["layers", l, "conv", name, "w"],
                 np.transpose(v, (2, 1, 0)))
        else:
            _set(params, ["layers", l, "conv", name, "b"], v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.conv_module\.depthwise_conv\.(weight|bias)$")
    def _dw(m, v, d):
        l, kind = int(m.group(1)), m.group(2)
        if kind == "weight":
            _set(params, ["layers", l, "conv", "dw", "w"], np.transpose(v, (2, 1, 0)))
        else:
            _set(params, ["layers", l, "conv", "dw", "b"], v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.conv_module\.(?:batch_norm|norm)\.(weight|bias|running_mean|running_var|num_batches_tracked)$")
    def _bn(m, v, d):
        l, kind = int(m.group(1)), m.group(2)
        if kind == "num_batches_tracked":
            return True
        slot = d.setdefault(("bn", l), {})
        slot[kind] = v

        def finalize(l=l, slot=slot):
            eps = 1e-5
            var = slot.get("running_var")
            mean = slot.get("running_mean")
            gamma = slot.get("weight")
            beta = slot.get("bias")
            if var is None:  # no running stats exported -> plain affine
                scale = gamma if gamma is not None else np.ones_like(beta)
                bias = beta if beta is not None else np.zeros_like(scale)
            else:
                scale = (gamma if gamma is not None else 1.0) / np.sqrt(var + eps)
                bias = (beta if beta is not None else 0.0) - (mean * scale)
            _set(params, ["layers", l, "conv", "bn", "scale"], scale)
            _set(params, ["layers", l, "conv", "bn", "bias"], bias)

        fins = d.setdefault("__finalize__", [])
        # replace any previous finalizer for this layer (idempotent)
        d[("bn_fin", l)] = finalize
        if finalize not in fins:
            fins[:] = [f for f in fins if getattr(f, "_l", None) != l]
            finalize._l = l
            fins.append(finalize)
        return True

    return _run_rules(params, initial, weights, rules)


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def map_lstm_weights(cfg, weights):
    from k2transducerasr_tpu_torch.models.lstm import init_params

    params, initial = template(init_params, cfg)
    rules = []

    def rule(pat):
        def deco(fn):
            rules.append((re.compile(pat), fn))
            return fn

        return deco

    conv_idx = sorted(
        {
            int(m.group(1))
            for k in weights
            for m in [re.search(r"encoder_embed\.conv\.(\d+)\.weight$", k)]
            if m
        }
    )

    @rule(r"encoder_embed\.conv\.(\d+)\.(weight|bias)$")
    def _econv(m, v, d):
        try:
            name = ("conv1", "conv2")[conv_idx.index(int(m.group(1)))]
        except (ValueError, IndexError):
            return False
        key = "w" if m.group(2) == "weight" else "b"
        _set(params, ["subsample", name, key], conv2d_w(v) if key == "w" else v)
        return True

    @rule(r"encoder_embed\.out\.(weight|bias)$")
    def _eout(m, v, d):
        key = "w" if m.group(1) == "weight" else "b"
        _set(params, ["subsample", "out", key], linear_w(v) if key == "w" else v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.lstm\.weight_(ih|hh|hr)_l0$")
    def _lw(m, v, d):
        l, which = int(m.group(1)), m.group(2)
        tgt = {"ih": "wx", "hh": "wh", "hr": "wp"}[which]
        _set(params, ["layers", l, "lstm", tgt], v.T)
        return True

    @rule(r"encoder\.layers\.(\d+)\.lstm\.bias_(ih|hh)_l0$")
    def _lb(m, v, d):
        l = int(m.group(1))
        slot = d.setdefault(("lstm_b", l), {})
        slot[m.group(2)] = v

        def finalize(l=l, slot=slot):
            b = slot.get("ih", 0.0) + slot.get("hh", 0.0)
            _set(params, ["layers", l, "lstm", "b"], b)

        fins = d.setdefault("__finalize__", [])
        fins[:] = [f for f in fins if getattr(f, "_l", None) != ("lstm_b", l)]
        finalize._l = ("lstm_b", l)
        fins.append(finalize)
        return True

    @rule(r"encoder\.layers\.(\d+)\.feed_forward\.(\d+)\.(weight|bias)$")
    def _ff(m, v, d):
        l, idx, kind = int(m.group(1)), int(m.group(2)), m.group(3)
        tgt = "w1" if idx < 2 else "w2"
        key = "w" if kind == "weight" else "b"
        _set(params, ["layers", l, "ff", tgt, key], linear_w(v) if key == "w" else v)
        return True

    @rule(r"encoder\.layers\.(\d+)\.norm_final\.(weight|bias)$")
    def _nf(m, v, d):
        key = "scale" if m.group(2) == "weight" else "bias"
        _set(params, ["layers", int(m.group(1)), "norm_final", key], v)
        return True

    return _run_rules(params, initial, weights, rules)
