"""The rest of the port's frontend (``frontend/fbank.py``: dither,
``FbankConfig.whisper``, ``FbankExtractor``; ``frontend/__init__.py``'s
exports) against the JAX package on the CPU, inputs from numpy seeds.

Tolerances: features on valid frames within the fbank tolerance of
tests/test_torch_layers.py (rtol 1e-4, atol 1e-3).  Dither draws from
``torch.Generator`` where the reference draws from ``jax.random``: the
same distribution, other values, so dithered features are compared by the
mean and standard deviation of their difference from the clean ones
(within a tenth of that deviation; ~24,000 values, so the sampling error
of either is ~1%), and the port's noise for one generator seed is the same
every time.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k2transducerasr_tpu.frontend as JFE
from k2transducerasr_tpu.frontend import fbank as JF
import k2transducerasr_tpu_torch.frontend as TFE
from k2transducerasr_tpu_torch.frontend import fbank as TF


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


def _speech_like(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 730 * t + 0.5)
         + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


def test_exports_match_jax():
    assert TFE.__all__ == JFE.__all__
    for name in TFE.__all__:
        assert getattr(TFE, name) is getattr(TF, name)


@pytest.mark.parametrize("rate", [16000, 8000])
def test_whisper_config_matches_jax(rate):
    got, want = TF.FbankConfig.whisper(rate), JF.FbankConfig.whisper(rate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    td, tm = TF.fbank_matrices(got)
    jd, jm = JF._build_matrices(want)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("whisper", [False, True], ids=["fbank", "whisper"])
def test_fbank_extractor_matches_jax(whisper):
    """A ragged batch (true lengths below the buffer's) and one 1-D buffer:
    the same frame counts and, on each lane's valid frames, the same
    features.  The port returns only as many frames as the longest lane
    has; the reference pads to 64-frame buckets."""
    jcfg = JF.FbankConfig.whisper() if whisper else JF.FbankConfig()
    tcfg = TF.FbankConfig.whisper() if whisper else TF.FbankConfig()
    lens = np.array([9000, 15843, 4001], np.int32)
    batch = np.zeros((3, 16000), np.float32)
    for i, m in enumerate(lens):
        batch[i, :m] = _speech_like(int(m), seed=i)
    want, want_n = JF.FbankExtractor(jcfg)(batch, lens)
    got, got_n = TF.FbankExtractor(tcfg, device="cpu")(batch, lens)
    np.testing.assert_array_equal(got_n, want_n)
    assert got.shape == (3, int(want_n.max()), 80) and want.shape[1] % 64 == 0
    for i, t in enumerate(want_n):
        np.testing.assert_allclose(got[i, :t].numpy(), np.asarray(want[i, :t]),
                                   rtol=1e-4, atol=1e-3)
    one, n_one = TF.FbankExtractor(tcfg, device="cpu")(batch[1, :lens[1]])
    j_one, j_n = JF.FbankExtractor(jcfg)(batch[1, :lens[1]])
    assert n_one == j_n and one.shape == (n_one, 80)
    np.testing.assert_allclose(one.numpy(), np.asarray(j_one[:j_n]), rtol=1e-4, atol=1e-3)


def test_fbank_extractor_needs_a_device_it_can_use(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.FbankExtractor(TF.FbankConfig())


def _dithered(n=16000):
    cfg_kw = dict(dither=1.0, input_scale=32768.0)  # kaldi: int16-range samples
    return _speech_like(n, seed=3)[None], cfg_kw


def test_dither_is_deterministic_for_one_generator_seed():
    x, kw = _dithered()
    cfg = TF.FbankConfig(**kw)
    frames = TF.num_frames_for(x.shape[1], cfg)
    xt = torch.from_numpy(x)

    def feats(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return TF.fbank_compute(xt, cfg, frames, generator=gen)

    assert torch.equal(feats(5), feats(5))
    assert not torch.equal(feats(5), feats(6))
    assert torch.equal(feats(None), feats(0))  # the default: seed 0
    clean = TF.fbank_compute(xt, dataclasses.replace(cfg, dither=0.0), frames)
    assert not torch.equal(feats(0), clean)
    noise = TF.dither_noise((200, 400), TF.FbankConfig(dither=0.5), "cpu")
    assert torch.equal(noise, TF.dither_noise((200, 400), TF.FbankConfig(dither=0.5), "cpu"))
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 0.5) < 0.01


def test_dither_statistics_match_jax():
    """dithered - clean features: the port's mean and standard deviation
    against the JAX package's (its default key, PRNGKey(0))."""
    x, kw = _dithered()
    jcfg, tcfg = JF.FbankConfig(**kw), TF.FbankConfig(**kw)
    frames = TF.num_frames_for(x.shape[1], tcfg)
    jd = np.asarray(JF.fbank_compute(jnp.asarray(x), jcfg, frames)
                    - JF.fbank_compute(jnp.asarray(x), dataclasses.replace(jcfg, dither=0.0),
                                       frames))
    xt = torch.from_numpy(x)
    td = (TF.fbank_compute(xt, tcfg, frames)
          - TF.fbank_compute(xt, dataclasses.replace(tcfg, dither=0.0), frames)).numpy()
    assert td.shape == jd.shape
    assert not np.array_equal(td, jd)  # other draws
    assert jd.std() > 1e-4  # visible in the features (float32 noise is ~1e-6)
    assert abs(td.mean() - jd.mean()) < 0.1 * jd.std()
    assert abs(td.std() / jd.std() - 1.0) < 0.1
