"""Zipformer v1 encoder weight mapping (icefall pruned_transducer_stateless7).

Export state_dict / initializer names -> the port's models/zipformer numpy
tree (the port's copy of ``k2transducerasr_tpu/convert/zipformer1_map.py``).
Name patterns per the st7 module tree: per layer ``self_attn.in_proj``
(packed [q(adim) | k(adim) | v(adim/2) | pos_q(H*pos_dim)]),
``self_attn.linear_pos`` / ``in_proj2`` / ``out_proj`` / ``out_proj2``
(the attention-weight-reuse value paths), ``pooling.proj``,
``conv_module{1,2}.pointwise_conv1 / depthwise_conv / pointwise_conv2``,
``feed_forward{1,2,3}.in_proj / out_proj``, ``norm_final.eps`` (BasicNorm
stores log-eps), ``bypass_scale``.  Stack-level: ``downsample.query`` /
``downsample.extra_proj``, ``upsample.bias``, ``out_combiner.weight1``;
model-level ``skip_modules.{i}.weight1`` and ``downsample_output.query``.
Held against the JAX package's map on the icefall oracle's state_dict
(tests/test_torch_convert.py).
"""

from __future__ import annotations

import re

from k2transducerasr_tpu_torch.convert.family_maps import _run_rules, _set
from k2transducerasr_tpu_torch.convert.importer import conv1d_w, conv2d_w, linear_w, template


def map_zipformer1_weights(cfg, weights):
    from k2transducerasr_tpu_torch.models.zipformer import init_params

    # (None skip_combiners entries stay None: an empty node)
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
            name = ("conv1", "conv2", "conv3")[conv_idx.index(int(m.group(1)))]
        except (ValueError, IndexError):
            return False
        key = "w" if m.group(2) == "weight" else "b"
        _set(params, ["embed", name, key], conv2d_w(v) if key == "w" else v)
        return True

    @rule(r"encoder_embed\.out\.(weight|bias)$")
    def _eout(m, v, d):
        key = "w" if m.group(1) == "weight" else "b"
        _set(params, ["embed", "out", key], linear_w(v) if key == "w" else v)
        return True

    @rule(r"encoder_embed\.out_norm\.eps$")
    def _eoutnorm(m, v, d):
        # BasicNorm serializes LOG eps (icefall: torch.tensor(eps).log())
        _set(params, ["embed", "out_norm", "eps_log"], v, expect_shape=False)
        return True

    lin_map = {
        "self_attn.in_proj": ("attn", "in_proj"),
        "self_attn.linear_pos": ("attn", "pos_proj"),
        "self_attn.in_proj2": ("attn", "v2"),
        "self_attn.out_proj": ("attn", "out1"),
        "self_attn.out_proj2": ("attn", "out2"),
        "pooling.proj": ("pooling", "proj"),
        "feed_forward1.in_proj": ("ff1", "w1"),
        "feed_forward1.out_proj": ("ff1", "w2"),
        "feed_forward2.in_proj": ("ff2", "w1"),
        "feed_forward2.out_proj": ("ff2", "w2"),
        "feed_forward3.in_proj": ("ff3", "w1"),
        "feed_forward3.out_proj": ("ff3", "w2"),
    }

    @rule(
        r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.([\w.]+?)\.(weight|bias)$"
    )
    def _layer(m, v, d):
        s, l, inner, kind = int(m.group(1)), int(m.group(2)), m.group(3), m.group(4)
        if inner in lin_map:
            a, b_ = lin_map[inner]
            key = "w" if kind == "weight" else "b"
            _set(
                params,
                ["stacks", s, "layers", l, a, b_, key],
                linear_w(v) if kind == "weight" else v,
            )
            return True
        cm = re.fullmatch(
            r"conv_module(1|2)\.(pointwise_conv1|depthwise_conv|pointwise_conv2)", inner
        )
        if cm:
            which = "conv1" if cm.group(1) == "1" else "conv2"
            tgt = {
                "pointwise_conv1": "pw1",
                "depthwise_conv": "dw",
                "pointwise_conv2": "pw2",
            }[cm.group(2)]
            if kind == "weight":
                if tgt == "dw":
                    _set(params, ["stacks", s, "layers", l, which, tgt, "w"], conv1d_w(v))
                else:
                    vv = v[:, :, 0] if v.ndim == 3 else v
                    _set(params, ["stacks", s, "layers", l, which, tgt, "w"], linear_w(vv))
            else:
                _set(params, ["stacks", s, "layers", l, which, tgt, "b"], v)
            return True
        return False

    @rule(r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.norm_final\.eps(_log)?$")
    def _norm(m, v, d):
        s, l = int(m.group(1)), int(m.group(2))
        _set(params, ["stacks", s, "layers", l, "norm", "eps_log"], v, expect_shape=False)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.(?:encoder\.)?layers\.(\d+)\.bypass_scale$")
    def _bypass(m, v, d):
        s, l = int(m.group(1)), int(m.group(2))
        _set(params, ["stacks", s, "layers", l, "bypass_scale"], v, expect_shape=False)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.downsample\.query$")
    def _ds_query(m, v, d):
        s = int(m.group(1))
        if "downsample" not in params["stacks"][s]:
            return False
        _set(params, ["stacks", s, "downsample", "query"], v)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.downsample\.extra_proj\.weight$")
    def _ds_extra(m, v, d):
        s = int(m.group(1))
        if "extra_proj" not in params["stacks"][s].get("downsample", {}):
            return False
        _set(params, ["stacks", s, "downsample", "extra_proj", "w"], linear_w(v))
        return True

    @rule(r"encoder\.encoders\.(\d+)\.upsample\.bias$")
    def _up(m, v, d):
        s = int(m.group(1))
        if "upsample_bias" not in params["stacks"][s]:
            return False
        _set(params, ["stacks", s, "upsample_bias"], v)
        return True

    @rule(r"encoder\.encoders\.(\d+)\.out_combiner\.weight1$")
    def _comb(m, v, d):
        s = int(m.group(1))
        if "out_combiner" not in params["stacks"][s]:
            return False
        _set(params, ["stacks", s, "out_combiner", "weight1"], v, expect_shape=False)
        return True

    @rule(r"encoder\.skip_modules\.(\d+)\.weight1$")
    def _skip(m, v, d):
        s = int(m.group(1))
        if params["skip_combiners"][s] is None:
            return False
        _set(params, ["skip_combiners", s, "weight1"], v, expect_shape=False)
        return True

    @rule(r"encoder\.downsample_output\.query$")
    def _dso(m, v, d):
        _set(params, ["downsample_output", "query"], v)
        return True

    @rule(r"encoder\.downsample_output\.extra_proj\.weight$")
    def _dso_extra(m, v, d):
        if "extra_proj" not in params["downsample_output"]:
            return False
        _set(params, ["downsample_output", "extra_proj", "w"], linear_w(v))
        return True

    return _run_rules(params, initial, weights, rules)
