"""The bias + Swoosh op (k2transducerasr_tpu_torch/ops/activations_cuda.py)
on the CPU: its plain version against a float64 evaluation of both
Swooshes, the wrapper's refusals, the layouts its kernel walks, the
product-only forms of the linear and the convolutions that feed it, and a
spy showing that every Swoosh of the zipformer2 encoder goes through it.

Tolerance against float64: the plain version computes z = y + b, t = z -
shift, softplus(t), 0.08 z and two subtractions in float32, each within
half a float32 ulp of its operands' scale, exp and log1p within one
(Sleef's, on the CPU); so it lies within 8 * 2**-24 * (|z| + |t| +
softplus(t) + 0.08 |z| + offset) of the exact value, and then rounds once
to the output dtype: one more ulp of the output at most.  The kernel itself
(the same steps, CUDA's expf and log1pf) is held against the plain version
on the card (tests/test_torch_cuda.py).
"""

import collections
import sys

import numpy as np
import pytest
import torch

from k2transducerasr_tpu_torch.models import zipformer2 as TZ
from k2transducerasr_tpu_torch.ops import activations_cuda as ACT
from k2transducerasr_tpu_torch.ops import layers as L

SHIFT_OFFSET = {"l": (4.0, 0.035), "r": (1.0, 0.313261687)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
MANTISSA = {torch.float32: 23, torch.bfloat16: 7}


def _operands(rows, c, dtype, bias, seed=0):
    rng = np.random.default_rng(seed)
    # spread over the Swooshes' bend (-10..10) and past it
    y = torch.from_numpy((rng.standard_normal((rows, c)) * 5).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)) if bias else None
    return y, b


def _exact(y, b, kind):
    """Swoosh of y + b in float64, and the scale of its float32 steps."""
    shift, offset = SHIFT_OFFSET[kind]
    z = y.double() + (0 if b is None else b.double())
    t = z - shift
    sp = torch.clamp(t, min=0) + torch.log1p(torch.exp(-torch.abs(t)))
    return sp - 0.08 * z - offset, z.abs() + t.abs() + sp + 0.08 * z.abs() + offset


def _ulp(x, dtype):
    mag = x.abs().clamp_min(torch.finfo(dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])


@pytest.mark.parametrize("c", [8, 13, 128, 192, 1536])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("inp,out", [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")],
                         ids=["f32-to-f32", "f32-to-bf16", "bf16-to-bf16"])
@pytest.mark.parametrize("kind", ["l", "r"])
def test_reference_is_one_rounding_of_the_exact_swoosh(kind, inp, out, bias, c):
    y, b = _operands(48, c, DTYPES[inp], bias, seed=c)
    got = ACT.bias_swoosh_reference(y, b, kind, DTYPES[out])
    assert got.dtype == DTYPES[out] and got.shape == y.shape
    exact, scale = _exact(y, b, kind)
    tol = 8 * 2.0**-24 * scale + _ulp(exact, DTYPES[out]).double()
    assert bool(((got.double() - exact).abs() <= tol).all())


@pytest.mark.parametrize("kind,swoosh", [("l", L.swoosh_l), ("r", L.swoosh_r)])
def test_float32_reference_is_the_layers_swoosh_bit_for_bit(kind, swoosh):
    """In float32 the plain version is the encoder's former ops exactly: the
    bias added, then ``ops/layers.py``'s Swoosh."""
    y, b = _operands(64, 192, torch.float32, True)
    assert torch.equal(ACT.bias_swoosh_reference(y, b, kind, torch.float32), swoosh(y + b))
    assert torch.equal(ACT.bias_swoosh(y, None, kind, torch.float32), swoosh(y))


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    y, b = _operands(16, 24, torch.bfloat16, True)
    before = ACT.bias_swoosh.launches
    got = ACT.bias_swoosh(y, b, "r", torch.bfloat16)
    assert torch.equal(got, ACT.bias_swoosh_reference(y, b, "r", torch.bfloat16))
    assert ACT.bias_swoosh.launches == before  # the CPU path does not count


def _bad_calls():
    y, b = _operands(4, 8, torch.float32, True)
    meta = torch.device("meta")
    return {
        "y-float16": (y.half(), b, "l", torch.float32),
        "y-int": (y.int(), b, "l", torch.float32),
        "out-float16": (y, b, "l", torch.float16),
        "bf16-to-f32": (y.bfloat16(), b, "l", torch.float32),
        "b-bf16": (y, b.bfloat16(), "l", torch.float32),
        "b-shape": (y, torch.zeros(9), "l", torch.float32),
        "b-device": (y, b.to(meta), "l", torch.float32),
        "y-device": (y.to(meta), b.to(meta), "l", torch.float32),
        "y-0d": (y[0, 0], None, "l", torch.float32),
        "kind": (y, b, "x", torch.float32),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_the_wrapper_refuses(case):
    with pytest.raises(ValueError):
        ACT.bias_swoosh(*_bad_calls()[case])


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(2, 3, 8), 1),  # channels last
    (lambda: torch.zeros(2, 8, 5).transpose(1, 2), 5),  # a depthwise conv's [B, C, T]
    (lambda: torch.zeros(2, 4, 6, 7).permute(0, 2, 3, 1), 42),  # NCHW seen as NHWC
    (lambda: torch.zeros(3, 4, 1), 1),  # one channel
], ids=["channels-last", "depthwise", "nchw", "one-channel"])
def test_channel_stride_of_dense_layouts(make, want):
    assert ACT._channel_stride(make()) == want


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 3, 8)[..., :4],  # rows with a gap
    lambda: torch.zeros(8)[None].expand(3, 8),  # overlapping rows
], ids=["gap", "overlap"])
def test_channel_stride_refuses_other_layouts(make):
    with pytest.raises(ValueError, match="dense"):
        ACT._channel_stride(make())


def _linear(seed, k=24, n=40):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) / 5),
            "b": torch.from_numpy(rng.standard_normal(n).astype(np.float32))}


@pytest.mark.parametrize("route", ["bf16", "f32", "int8-bf16", "int8-f32"])
def test_linear_product_plus_bias_is_apply_linear(route):
    """``linear_product`` is ``apply_linear`` less the bias and the cast:
    adding them back gives ``apply_linear`` bit for bit."""
    p = _linear(1)
    if route.startswith("int8"):
        p = L.quantize_linear_int8(p)
    cd = torch.bfloat16 if route.endswith("bf16") else None
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 5, 24)).astype(np.float32))
    y = L.linear_product(p, x, cd)
    assert y.dtype == (torch.bfloat16 if route == "bf16" else torch.float32)
    back = y.float() + p["b"]
    assert torch.equal(back if cd is None else back.to(cd), L.apply_linear(p, x, cd))


@pytest.mark.parametrize("cd", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_conv_products_plus_bias_are_the_convs(cd):
    rng = np.random.default_rng(3)
    p1 = L.init_conv1d(rng, 12, 12, 5, groups=12)
    p1 = {k: torch.from_numpy(v) for k, v in p1.items()}
    x1 = torch.from_numpy(rng.standard_normal((2, 30, 12)).astype(np.float32))
    y1 = L.conv1d_product(p1["w"], x1, groups=12, padding="SAME", compute_dtype=cd)
    want1 = L.apply_conv1d(p1, x1, groups=12, padding="SAME", compute_dtype=cd)
    assert y1.dtype == torch.float32 and torch.equal(L._cast(y1 + p1["b"], cd), want1)
    p2 = {k: torch.from_numpy(v) for k, v in L.init_conv2d(rng, 3, 8, (3, 3)).items()}
    x2 = torch.from_numpy(rng.standard_normal((2, 11, 9, 3)).astype(np.float32))
    y2 = L.conv2d_product(p2["w"], x2, strides=(2, 2), compute_dtype=cd)
    want2 = L.apply_conv2d(p2, x2, strides=(2, 2), compute_dtype=cd)
    assert y2.dtype == torch.float32 and torch.equal(L._cast(y2 + p2["b"], cd), want2)


# the flagship's layers per stack (16: 84 Swooshes a forward) at tiny widths
SPY_CFG = dict(num_encoder_layers=(2, 2, 3, 4, 3, 2), encoder_dims=(16, 16, 24, 32, 24, 16),
               num_heads=(2,) * 6, feedforward_dims=(24, 24, 32, 40, 32, 24),
               cnn_module_kernels=(5, 5, 3, 3, 3, 5), query_head_dim=4, value_head_dim=4,
               pos_head_dim=2, pos_dim=8, embed_channels=(2, 4, 8))
# the caller of each Swoosh site, its kind and its count a forward or a step
SITES = {"_apply_ff": ("l", 48), "_embed_tail": ("l", 1), "_conv_module": ("r", 32),
         "_embed_conv_stack": ("r", 3)}


@pytest.mark.parametrize("route", ["offline", "offline-causal", "streaming"])
def test_every_swoosh_site_goes_through_the_wrapper(monkeypatch, route):
    """84 ``bias_swoosh`` calls per forward and per streaming step at the
    flagship's layer counts: 48 feed-forwards, the ConvNeXt, 32 conv
    modules, 3 embed convs; each with its bias (the causal conv modules'
    biases are in the sum they hand over), out in the compute dtype."""
    cfg = TZ.Zipformer2Config(causal=route != "offline", chunk_size=16, left_context_frames=32,
                              **SPY_CFG)
    enc = TZ.Zipformer2(cfg, TZ.init_params(np.random.default_rng(0), cfg))
    calls = []
    real = TZ.bias_swoosh

    def spy(y, b, kind, out_dtype):
        f = sys._getframe(1)
        while f.f_code.co_name not in SITES:
            f = f.f_back
        calls.append((f.f_code.co_name, kind, b is not None, out_dtype))
        return real(y, b, kind, out_dtype)

    monkeypatch.setattr(TZ, "bias_swoosh", spy)
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        if route == "streaming":
            x = torch.from_numpy(rng.standard_normal((2, cfg.chunk_input_len, 80))
                                 .astype(np.float32))
            enc.streaming_step(enc.init_state(2), x, torch.bfloat16)
        else:
            x = torch.from_numpy(rng.standard_normal((2, 100, 80)).astype(np.float32))
            enc(x, torch.tensor([100, 77]), torch.bfloat16)
    assert len(calls) == 84
    assert collections.Counter(site for site, *_ in calls) == {
        site: n for site, (_, n) in SITES.items()}
    for site, kind, has_bias, out_dtype in calls:
        assert kind == SITES[site][0] and out_dtype == torch.bfloat16
        assert has_bias == (site != "_conv_module" or route == "offline")
