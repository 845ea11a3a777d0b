"""The LayerNorm op (k2transducerasr_tpu_torch/ops/norm_cuda.py) on the CPU:
its plain version against the body ``ops/layers.py::apply_layernorm`` had
before the kernel, bit for bit; ``apply_layernorm`` on CPU tensors
unchanged; the wrapper's refusals and the row layouts it takes; and a spy
showing that every LayerNorm of the conformer (60 a flagship forward, 72 a
streaming step) and the LSTM goes through it, and none of zipformer2's.
The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""

import collections
import sys

import numpy as np
import pytest
import torch

from k2transducerasr_tpu_torch.models import conformer as TC
from k2transducerasr_tpu_torch.models import lstm as TL
from k2transducerasr_tpu_torch.models import zipformer2 as TZ
from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.ops import norm_cuda as N

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _global_rng_untouched():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


def _operands(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    return x, scale, bias


def _before_the_kernel(p, x, eps=1e-5):
    """``ops/layers.py::apply_layernorm`` as it was before the kernel."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


@pytest.mark.parametrize("d", [512, 24, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_reference_is_the_former_layernorm_bit_for_bit(eps, dtype, d):
    x, scale, bias = _operands((3, 17, d), DTYPES[dtype], seed=d)
    got = N.layernorm_reference(x, scale, bias, eps)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, _before_the_kernel({"scale": scale, "bias": bias}, x, eps))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps", [None, 1e-3])
def test_apply_layernorm_on_the_cpu_is_what_it_was(dtype, eps):
    x, scale, bias = _operands((2, 9, 64), DTYPES[dtype], seed=4)
    p = {"scale": scale, "bias": bias}
    kw = {} if eps is None else {"eps": eps}
    before = N.layernorm.launches
    assert torch.equal(L.apply_layernorm(p, x, **kw), _before_the_kernel(p, x, **kw))
    assert N.layernorm.launches == before  # the CPU path does not count


def _bad_calls():
    x, scale, bias = _operands((4, 8), torch.float32)
    meta = torch.device("meta")
    return {
        "x-int": (x.int(), scale, bias),
        "x-float16": (x.half(), scale, bias),
        "x-float64": (x.double(), scale, bias),
        "x-0d": (x[0, 0], scale[:1][0], bias[:1][0]),
        "scale-bf16": (x, scale.bfloat16(), bias),
        "bias-float64": (x, scale, bias.double()),
        "scale-shape": (x, torch.ones(9), bias),
        "bias-shape": (x, scale, torch.zeros(1, 8)),
        "scale-device": (x, scale.to(meta), bias),
        "bias-device": (x, scale, bias.to(meta)),
        "x-device": (x.to(meta), scale.to(meta), bias.to(meta)),
        "last-axis-strided": (torch.zeros(8, 4).t(), scale, bias),
        "rows-at-two-strides": (torch.zeros(3, 4, 8)[:, :2], scale, bias),
        "rows-overlap": (torch.zeros(8)[None].expand(3, 8), scale, bias),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_the_wrapper_refuses(case):
    with pytest.raises(ValueError):
        N.layernorm(*_bad_calls()[case])


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(2, 3, 8), 8),  # dense
    (lambda: torch.zeros(2, 3, 16)[..., :8], 16),  # each row a prefix of a wider one
    (lambda: torch.zeros(6, 8)[::2], 16),  # every other row
    (lambda: torch.zeros(1, 5, 1, 8), 8),  # axes of one
    (lambda: torch.zeros(8), 8),  # one row
    (lambda: torch.zeros(1, 4).t(), 1),  # D = 1
], ids=["dense", "prefix", "every-other", "unit-axes", "one-row", "d1"])
def test_row_stride_of_the_layouts_taken(make, want):
    x = make()
    assert N._row_stride(x) == want
    scale, bias = torch.ones(x.shape[-1]), torch.zeros(x.shape[-1])
    assert torch.equal(N.layernorm(x, scale, bias), N.layernorm_reference(x.contiguous(), scale,
                                                                          bias))


def test_empty_inputs_give_empty_outputs():
    _, scale, bias = _operands((1, 8), torch.float32)
    got = N.layernorm(torch.zeros(0, 3, 8, dtype=torch.bfloat16), scale, bias)
    assert got.shape == (0, 3, 8) and got.dtype == torch.bfloat16


# the flagship conformer's 12 layers and the LSTM's at tiny widths
CONFORMER = dict(d_model=16, num_heads=2, ff_dim=24, cnn_kernel=5, chunk_size=4,
                 left_context=8)
# the caller of each LayerNorm site and its count a layer: offline, a streaming step
CONFORMER_SITES = {"_ff": (2, 2), "_conv_module": (1, 1), "_block": (2, 3)}


def _spy(monkeypatch, sites):
    calls = []
    real = N.layernorm

    def spy(x, scale, bias, eps=1e-5):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_name not in sites:
            f = f.f_back
        calls.append((f and f.f_code.co_name, x.dtype, eps))
        return real(x, scale, bias, eps)

    monkeypatch.setattr(N, "layernorm", spy)
    return calls


@pytest.mark.parametrize("route", ["offline", "streaming"])
def test_every_conformer_layernorm_goes_through_the_wrapper(monkeypatch, route):
    """60 ``layernorm`` calls per flagship forward (five a layer: the two
    feed-forwards', the conv module's, the attention's, the final one) and
    72 per streaming step (the attention normalises its kv too), each on
    the block's bf16 stream with the default eps."""
    cfg = TC.ConformerConfig(causal=route == "streaming", **CONFORMER)
    assert cfg.num_layers == 12
    enc = TC.Conformer(cfg, TC.init_params(np.random.default_rng(0), cfg))
    calls = _spy(monkeypatch, CONFORMER_SITES)
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        if route == "streaming":
            x = torch.from_numpy(rng.standard_normal((2, cfg.chunk_input_len, 80))
                                 .astype(np.float32))
            enc.streaming_step(enc.init_state(2), x, torch.bfloat16)
        else:
            x = torch.from_numpy(rng.standard_normal((2, 60, 80)).astype(np.float32))
            enc(x, torch.tensor([60, 41]), torch.bfloat16)
    k = int(route == "streaming")
    assert len(calls) == {"offline": 60, "streaming": 72}[route]
    assert collections.Counter(site for site, *_ in calls) == {
        site: 12 * n[k] for site, n in CONFORMER_SITES.items()}
    assert {(dtype, eps) for _, dtype, eps in calls} == {(torch.bfloat16, 1e-5)}


@pytest.mark.parametrize("route", ["offline", "streaming"])
def test_every_lstm_layernorm_goes_through_the_wrapper(monkeypatch, route):
    """One ``layernorm`` a layer (``norm_final``), offline and streaming."""
    cfg = TL.LstmConfig(d_model=16, rnn_hidden_size=24, num_layers=3, ff_dim=32, chunk_size=4)
    enc = TL.Lstm(cfg, TL.init_params(np.random.default_rng(0), cfg))
    calls = _spy(monkeypatch, {"_encode"})
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        if route == "streaming":
            x = torch.from_numpy(rng.standard_normal((2, cfg.chunk_input_len, 80))
                                 .astype(np.float32))
            enc.streaming_step(enc.init_state(2), x)
        else:
            x = torch.from_numpy(rng.standard_normal((2, 40, 80)).astype(np.float32))
            enc(x, torch.tensor([40, 31]))
    assert len(calls) == 3


def test_zipformer2_calls_no_layernorm(monkeypatch):
    cfg = TZ.Zipformer2Config(num_encoder_layers=(1, 1), encoder_dims=(16, 16),
                              num_heads=(2, 2), feedforward_dims=(24, 24),
                              cnn_module_kernels=(5, 5), downsampling_factors=(1, 2),
                              query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
                              embed_channels=(2, 4, 8))
    enc = TZ.Zipformer2(cfg, TZ.init_params(np.random.default_rng(0), cfg))
    calls = _spy(monkeypatch, set())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 60, 80))
                         .astype(np.float32))
    with torch.inference_mode():
        enc(x, torch.tensor([60, 41]), torch.bfloat16)
    assert calls == []
