"""The port's fbank and layer ops (k2transducerasr_tpu_torch/frontend,
ops/layers.py) against the JAX package on the CPU, inputs from numpy seeds.

Tolerances: float32 ops agree to rtol/atol 1e-5 (summation order only);
the fbank agrees with the JAX fbank to rtol 1e-4 / atol 1e-3 and with the
kaldi oracle (tests/kaldi_fbank_reference.py) to the repo's own fbank
tolerance, rtol 2e-4 / atol 2e-3; bf16 ``apply_linear`` agrees to one bf16
ulp of the output (rtol 2**-7) — PyTorch's bf16 matmul rounds before the
float32 bias add, the reference after it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.frontend import fbank as JF
from k2transducerasr_tpu.ops import layers as JL
from k2transducerasr_tpu_torch.frontend import fbank as TF
from k2transducerasr_tpu_torch.ops import layers as TL
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
