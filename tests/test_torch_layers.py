"""The port's fbank and layer ops (k2transducerasr_tpu_torch/frontend,
ops/layers.py) against the JAX package on the CPU, inputs from numpy seeds.

Tolerances: float32 ops agree to rtol/atol 1e-5 (summation order only);
the fbank agrees with the JAX fbank to rtol 1e-4 / atol 1e-3 and with the
kaldi oracle (tests/kaldi_fbank_reference.py) to the repo's own fbank
tolerance, rtol 2e-4 / atol 2e-3; bf16 ``apply_linear`` agrees to one bf16
ulp of the output (rtol 2**-7) — PyTorch's bf16 matmul rounds before the
float32 bias add, the reference after it.
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.frontend import fbank as JF
from k2transducerasr_tpu.ops import layers as JL
from k2transducerasr_tpu_torch.frontend import fbank as TF
from k2transducerasr_tpu_torch.ops import layers as TL
from k2transducerasr_tpu_torch.runtime.device import exact_f32
from tests.kaldi_fbank_reference import fbank_reference


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(tree):
    """numpy param dict -> torch param dict (the port's ops take either)."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _speech_like(n, seed=0):
    rng = _rng(seed)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 730 * t + 0.5)
         + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


@pytest.mark.parametrize("snip_edges", [True, False], ids=["snip", "centred"])
def test_fbank_matches_jax_and_kaldi(snip_edges):
    cfg_kw = dict(snip_edges=snip_edges)
    jcfg, tcfg = JF.FbankConfig(**cfg_kw), TF.FbankConfig(**cfg_kw)
    lens = [9000, 15843]  # ragged; odd length exercises the reflection
    n = max(lens)
    batch = np.zeros((2, n), np.float32)
    for i, m in enumerate(lens):
        batch[i, :m] = _speech_like(m, seed=i)
    frames = TF.num_frames_for(n, tcfg)
    assert frames == JF.num_frames_for(n, jcfg)
    want = np.asarray(JF.fbank_compute(jnp.asarray(batch), jcfg, frames,
                                       n_valid=jnp.asarray(lens, jnp.int32)))
    got = TF.fbank_compute(torch.from_numpy(batch), tcfg, frames,
                           n_valid=torch.tensor(lens)).numpy()
    assert got.shape == want.shape
    for i, m in enumerate(lens):
        t = TF.num_frames_for(m, tcfg)
        np.testing.assert_allclose(got[i, :t], want[i, :t], rtol=1e-4, atol=1e-3)
        ref = fbank_reference(batch[i, :m], JF.FbankConfig(**cfg_kw))
        np.testing.assert_allclose(got[i, :t], ref, rtol=2e-4, atol=2e-3)


def test_fbank_tables_and_frame_counts_match_jax():
    for kw in ({}, {"window_type": "povey"}, {"snip_edges": False}):
        jd, jm = JF._build_matrices(JF.FbankConfig(**kw))
        td, tm = TF.fbank_matrices(TF.FbankConfig(**kw))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tm, jm)
        for n in (0, 399, 400, 560, 16000, 16001):
            assert TF.num_frames_for(n, TF.FbankConfig(**kw)) == JF.num_frames_for(
                n, JF.FbankConfig(**kw))


def test_fbank_dither_raises():
    """dither > 0 is ported (tests/test_torch_frontend.py): it no longer
    raises NotImplementedError; a generator that is no torch.Generator
    raises."""
    feats = TF.fbank_compute(torch.zeros(1, 800), TF.FbankConfig(dither=1.0), 2)
    assert feats.shape == (1, 2, 80) and bool(torch.isfinite(feats).all())
    with pytest.raises(TypeError):
        TF.fbank_compute(torch.zeros(1, 800), TF.FbankConfig(dither=1.0), 2, generator=0)


@pytest.mark.parametrize("bias", [True, False])
def test_apply_linear_f32_and_bf16(bias):
    rng = _rng(1)
    p = {"w": rng.standard_normal((24, 40)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    want = np.asarray(JL.apply_linear(p, x))
    got = TL.apply_linear(_t(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want16 = np.asarray(JL.apply_linear(p, x, jnp.bfloat16).astype(jnp.float32))
    got16 = TL.apply_linear(_t(p), torch.from_numpy(x), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2.0**-7, atol=2.0**-7)


def test_biasnorm_and_swoosh_match_jax():
    rng = _rng(2)
    x = (3 * rng.standard_normal((2, 7, 16))).astype(np.float32)
    p = {"bias": rng.standard_normal(16).astype(np.float32),
         "log_scale": np.float32(0.3)}
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(TL.apply_biasnorm(_t(p), tx).numpy(),
                               np.asarray(JL.apply_biasnorm(p, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TL.swoosh_l(tx).numpy(), np.asarray(JL.swoosh_l(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TL.swoosh_r(tx).numpy(), np.asarray(JL.swoosh_r(x)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "cin,cout,k,groups,padding,cd",
    [
        (12, 12, 7, 12, "SAME", None),  # depthwise, offline conv module
        (12, 12, 4, 12, "VALID", None),  # depthwise, causal half kernel
        (12, 12, 7, 12, "SAME", jnp.bfloat16),
        (16, 16, 2, 4, "VALID", None),  # grouped, the decoder's context conv
    ],
)
def test_apply_conv1d_matches_jax(cin, cout, k, groups, padding, cd):
    rng = _rng(3)
    p = {"w": rng.standard_normal((k, cin // groups, cout)).astype(np.float32),
         "b": rng.standard_normal(cout).astype(np.float32)}
    x = rng.standard_normal((2, 11, cin)).astype(np.float32)
    want = np.asarray(JL.apply_conv1d(p, x, groups=groups, padding=padding,
                                      compute_dtype=cd)).astype(np.float32)
    got = TL.apply_conv1d(_t(p), torch.from_numpy(x), groups=groups, padding=padding,
                          compute_dtype=None if cd is None else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5 if cd is None else 2.0**-7,
                               atol=1e-5 if cd is None else 2.0**-7)


def test_embed_convs_match_the_banded_forms():
    """conv1 (C_in=1, freq pad 1) and conv2 (stride 2) as plain conv2d equal
    the reference's banded-matmul forms; conv3 (stride (1, 2)) equals its
    apply_conv2d."""
    rng = _rng(4)
    x = rng.standard_normal((2, 15, 20)).astype(np.float32)
    p1 = {"w": rng.standard_normal((3, 3, 1, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    p2 = {"w": rng.standard_normal((3, 3, 3, 5)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    p3 = {"w": rng.standard_normal((3, 3, 5, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    h1 = np.array(JL.apply_conv2d_c1_banded(p1, x))
    t1 = TL.apply_conv2d(_t(p1), torch.from_numpy(x)[..., None], padding=(0, 1))
    np.testing.assert_allclose(t1.numpy(), h1, rtol=1e-5, atol=1e-5)
    h2 = np.array(JL.apply_conv2d_banded_s2(p2, h1))
    t2 = TL.apply_conv2d(_t(p2), torch.from_numpy(h1), strides=(2, 2))
    np.testing.assert_allclose(t2.numpy(), h2, rtol=1e-5, atol=1e-5)
    h3 = np.asarray(JL.apply_conv2d(p3, h2, strides=(1, 2)))
    t3 = TL.apply_conv2d(_t(p3), torch.from_numpy(h2), strides=(1, 2))
    np.testing.assert_allclose(t3.numpy(), h3, rtol=1e-5, atol=1e-5)


# -- the convolutions' TF32 (ops/layers.py::conv_tf32) ------------------------


@pytest.mark.parametrize("before", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_conv_tf32_leaves_the_flag_as_the_caller_set_it(monkeypatch, before, raises):
    """``conv_tf32`` sets no flag: on CPU tensors the convolution sees
    cuDNN's TF32 flag as the caller set it, and the flag reads so after the
    call, whether the convolution returned or raised (the error passes
    through)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before)
    seen = []

    def conv(x, w, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        if raises:
            raise RuntimeError("conv failed")
        return x * w

    x = torch.ones(3)
    if raises:
        with pytest.raises(RuntimeError, match="conv failed"):
            TL.conv_tf32(conv, x, x)
    else:
        assert torch.equal(TL.conv_tf32(conv, x, x), x)
    assert seen == [before] and torch.backends.cudnn.allow_tf32 is before


# (name, product, compute dtype, groups, C_in, C_out, whether it runs
# through conv_tf32)
SCOPE_CASES = [
    ("conv1d-pointwise-bf16", "conv1d", torch.bfloat16, 1, 8, 32, True),
    ("conv1d-pointwise-fp16", "conv1d", torch.float16, 1, 8, 32, True),
    ("conv1d-pointwise-f32", "conv1d", None, 1, 8, 32, False),
    ("conv1d-depthwise-bf16", "conv1d", torch.bfloat16, 32, 32, 32, False),
    ("conv1d-grouped-bf16", "conv1d", torch.bfloat16, 2, 8, 64, True),
    ("conv1d-grouped-narrow-bf16", "conv1d", torch.bfloat16, 2, 8, 32, False),
    ("conv2d-c1-bf16", "conv2d", torch.bfloat16, 1, 1, 32, True),
    ("conv2d-c1-narrow-bf16", "conv2d", torch.bfloat16, 1, 1, 8, False),
    ("conv2d-bf16", "conv2d", torch.bfloat16, 1, 6, 32, True),
    ("conv2d-f32", "conv2d", None, 1, 6, 32, False),
    ("conv2d-depthwise-bf16", "conv2d", torch.bfloat16, 6, 6, 6, False),
]


@pytest.mark.parametrize("name,product,cd,groups,cin,cout,scoped", SCOPE_CASES,
                         ids=[c[0] for c in SCOPE_CASES])
def test_conv_products_allow_tf32_only_over_exact_operands(monkeypatch, name, product, cd,
                                                           groups, cin, cout, scoped):
    """A product over operands rounded to bf16 or fp16 with at least
    ``TF32_MIN_OUT_CHANNELS`` outputs a group goes through ``conv_tf32``
    (which asks for TF32 in its own call on the card); the float32 route, a
    depthwise product and a narrower one do not.  No flag changes: the
    convolution sees both TF32 flags as the caller set them (here False,
    which a scope that turned TF32 on would show), and they read so after;
    on CPU tensors ``conv_tf32.launches`` does not rise."""
    assert TL.TF32_MIN_OUT_CHANNELS == 32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    fn, real = getattr(torch.nn.functional, product), TL.conv_tf32
    seen, routed = [], []

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return fn(*a, **kw)

    def spy_tf32(*a, **kw):
        routed.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, product, spy)
    monkeypatch.setattr(TL, "conv_tf32", spy_tf32)
    g = torch.Generator().manual_seed(len(name))
    before = real.launches
    if product == "conv1d":
        w = torch.randn(3, cin // groups, cout, generator=g)
        TL.conv1d_product(w, torch.randn(2, 9, cin, generator=g), groups=groups,
                          compute_dtype=cd)
    else:
        w = torch.randn(3, 3, cin // groups, cout, generator=g)
        TL.conv2d_product(w, torch.randn(2, 9, 7, cin, generator=g), strides=(2, 2),
                          groups=groups, compute_dtype=cd)
    assert len(routed) == int(scoped)
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert real.launches == before


# (name, product, x shape, weight shape, keyword arguments): the embed convs
# (C_in 1 with the freq padding, stride 2, stride (1, 2)) and the conformer's
# pointwise and depthwise convs, at small widths
BITWISE_CASES = [
    ("conv2d-c1", "conv2d", (2, 13, 20, 1), (3, 3, 1, 8), dict(padding=(0, 1))),
    ("conv2d-s2", "conv2d", (2, 11, 18, 8), (3, 3, 8, 12), dict(strides=(2, 2))),
    ("conv2d-s12", "conv2d", (2, 5, 9, 12), (3, 3, 12, 16), dict(strides=(1, 2))),
    ("conv1d-pointwise", "conv1d", (2, 17, 16), (1, 16, 32), dict(padding="SAME")),
    ("conv1d-depthwise", "conv1d", (2, 17, 16), (7, 1, 16), dict(groups=16, padding="SAME")),
]


@pytest.mark.parametrize("name,product,xs,ws,kw", BITWISE_CASES,
                         ids=[c[0] for c in BITWISE_CASES])
def test_bf16_conv_products_on_the_cpu_are_the_float32_conv_of_the_upcasts(
        name, product, xs, ws, kw):
    """On the CPU a bf16-operand product, through ``conv_tf32`` or not, is
    bit for bit ``F.conv1d``/``F.conv2d`` over the operands rounded to bf16
    and upcast to float32."""
    g = torch.Generator().manual_seed(len(name))
    x, w = torch.randn(xs, generator=g), torch.randn(ws, generator=g)
    xr, wr = x.bfloat16().float(), w.bfloat16().float()
    if product == "conv1d":
        got = TL.conv1d_product(w, x, compute_dtype=torch.bfloat16, **kw)
        k, lo = ws[0], (ws[0] - 1) // 2
        xp = torch.nn.functional.pad(xr, (0, 0, lo, k - 1 - lo)).transpose(1, 2)
        want = torch.nn.functional.conv1d(xp, wr.permute(2, 1, 0),
                                          groups=kw.get("groups", 1)).transpose(1, 2)
    else:
        got = TL.conv2d_product(w, x, compute_dtype=torch.bfloat16, **kw)
        want = torch.nn.functional.conv2d(
            xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), stride=kw.get("strides", (1, 1)),
            padding=kw.get("padding", (0, 0))).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# -- the port's one precision rule (runtime/device.py::exact_f32) -------------


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_overlapping_exact_f32_scopes_on_two_threads_restore_at_the_last_exit(monkeypatch):
    """Thread A opens a scope, thread B opens one, A closes first: both TF32
    flags stay False until B, the last, closes, and then read as the caller
    set them (True)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a_in, b_in, a_out, b_may_exit = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with exact_f32():
            seen["a"] = _flags()
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with exact_f32():
            b_in.set()
            a_out.wait(10)
            seen["b after a's exit"] = _flags()
            b_may_exit.wait(10)

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    assert a_out.wait(10)
    assert _flags() == (False, False)  # B's scope is still open
    b_may_exit.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert seen == {"a": (False, False), "b after a's exit": (False, False)}
    assert _flags() == (True, True)


def test_exact_f32_under_thread_churn_never_lets_tf32_in(monkeypatch):
    """More threads than cores, each opening and closing nested scopes with
    a short switch interval: every read inside a scope sees both flags
    False, and the caller's values (True, False) come back after the last."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    bad = []

    def churn():
        for _ in range(200):
            with exact_f32():
                with exact_f32():
                    if _flags() != (False, False):
                        bad.append(_flags())
                if _flags() != (False, False):
                    bad.append(_flags())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert bad == []
    assert _flags() == (True, False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conformer_norms_and_activations_match_jax(dtype):
    """LayerNorm, folded BatchNorm, swish and GLU.  bf16: LayerNorm to one
    bf16 ulp (rtol 2**-7; both round one float32 value); swish and GLU to
    two (rtol 2**-6: PyTorch rounds the sigmoid to bf16 before the product,
    XLA may round once after it); BatchNorm promotes to float32 in both."""
    rng = _rng(6)
    x = (2 * rng.standard_normal((2, 7, 16)) + 0.5).astype(np.float32)
    ln = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    bn = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    one, two = (1e-5, 1e-5) if dtype == "f32" else (2.0**-7, 2.0**-6)

    def check(got, want, rtol, out_dtype=tx.dtype):
        assert got.dtype == out_dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=1e-6)

    check(TL.apply_layernorm(_t(ln), tx), JL.apply_layernorm(ln, jx), one)
    check(TL.apply_batchnorm(_t(bn), tx), JL.apply_batchnorm(bn, jx), 1e-6,
          out_dtype=torch.float32)
    check(TL.swish(tx), JL.swish(jx), two)
    check(TL.glu(tx), JL.glu(jx), two)
    for init in ("init_layernorm", "init_batchnorm"):
        got, want = getattr(TL, init)(16), getattr(JL, init)(16)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_embedding_and_length_mask_match_jax():
    table = _rng(5).standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[0, 3], [9, 9]])
    np.testing.assert_array_equal(
        TL.apply_embedding({"table": torch.from_numpy(table)}, torch.from_numpy(ids)).numpy(),
        np.asarray(JL.apply_embedding({"table": table}, ids)))
    lens = np.array([0, 3, 6])
    np.testing.assert_array_equal(TL.length_mask(torch.from_numpy(lens), 6).numpy(),
                                  np.asarray(JL.length_mask(jnp.asarray(lens), 6)))
    assert TL.NEG_INF == JL.NEG_INF
