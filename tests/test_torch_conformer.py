"""The port's conformer (k2transducerasr_tpu_torch/models/conformer.py) and
its offline recognizer against the JAX package on the CPU, inputs from numpy
seeds, plus the conformer pin's model dir.

JAX runs its default CPU route (``K2T_FLASH_ATTN`` unset: the XLA attention,
which scales the f32 scores after the product), the port its one route (the
scale folded into the query operands before K2's plain version).
Tolerances: float32 encoder output agrees to atol 1e-4 (summation order and
where the scale is applied, through every layer) and f32 tokens and
timestamps are identical; bf16 encoder output agrees to atol 0.05, a few
bf16 ulps over LayerNorm outputs below 4 — two bf16 pipelines whose
roundings differ at the ulp level (PyTorch's bf16 matmul rounds before the
bias add, the port rounds the scaled query once where the reference rounds
the unscaled one).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.frontend.fbank import fbank_compute as j_fbank_compute
from k2transducerasr_tpu.frontend.fbank import fbank_matrices as j_fbank_matrices
from k2transducerasr_tpu.frontend.fbank import num_frames_jnp
from k2transducerasr_tpu.models import conformer as JC
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.checkpoint import flatten_params as j_flatten
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JRecognizer
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.models import conformer as TC
from k2transducerasr_tpu_torch.ops import attention_cuda as AC
from k2transducerasr_tpu_torch.runtime.checkpoint import flatten_params, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "conformer_pin")
# tests/test_pinned_transcripts.py's conformer bundle and offline pin
PIN_CFG = dict(d_model=64, num_layers=2, num_heads=4, ff_dim=96, cnn_kernel=7, causal=True,
               chunk_size=4, left_context=8)
PIN_TEXT = "tok28tok28tok28tok28"
PIN_TIMESTAMPS = [0, 1, 4, 7]
TINY = dict(d_model=32, num_layers=2, num_heads=4, ff_dim=48, cnn_kernel=7)
CAUSAL = dict(causal=True, chunk_size=4, left_context=8)


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _streams(rec, pcms):
    out = []
    for x in pcms:
        s = rec.create_offline_stream()
        s.add_samples(x)
        out.append(s)
    return out


@pytest.fixture
def jax_default_route(monkeypatch):
    """The JAX conformer's own CPU route (no Pallas interpret switch)."""
    monkeypatch.delenv("K2T_FLASH_ATTN", raising=False)


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "causal"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(jax_default_route, causal, dtype):
    cfg_kw = dict(TINY, **(CAUSAL if causal else {}))
    jcfg, tcfg = JC.ConformerConfig(**cfg_kw), TC.ConformerConfig(**cfg_kw)
    params = jax.device_get(JC.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((3, 71, 80))).astype(np.float32)
    lens = np.array([71, 43, 20], np.int32)  # ragged; lane 2 has 3 frames after subsampling
    jcd, tcd, atol = ((None, None, 1e-4) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, 0.05))

    fwd = jax.jit(JC.forward, static_argnums=(1, 4))
    want, want_lens = fwd(params, jcfg, jnp.asarray(x), jnp.asarray(lens), jcd)
    enc = TC.Conformer(tcfg, params)
    with torch.inference_mode():
        got, got_lens = enc(torch.from_numpy(x), torch.from_numpy(lens), tcd)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == (torch.float32 if tcd is None else tcd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)


def test_attention_calls_k2_once_per_layer(monkeypatch):
    """On CPU tensors K2's wrapper runs its plain version and counts nothing;
    the forward calls it once per layer."""
    cfg = TC.ConformerConfig(**TINY)
    enc = TC.Conformer(cfg, TC.init_params(np.random.default_rng(0), cfg))
    calls = []

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return AC.relpos_attn_ctx(*a, **kw)

    before = AC.relpos_attn_ctx.launches
    monkeypatch.setattr(TC, "relpos_attn_ctx", spy)
    out, _ = enc(torch.zeros(2, 40, 80), torch.tensor([40, 30]))
    assert len(calls) == cfg.num_layers and calls[0] == (2, 9, 4, 8)
    assert AC.relpos_attn_ctx.launches == before
    assert out.shape == (2, 9, 32)


def test_init_params_tree_matches_jax():
    cfg_kw = dict(TINY, ff_dim=40)
    want = j_flatten(jax.device_get(JC.init_params(jax.random.PRNGKey(0),
                                                   JC.ConformerConfig(**cfg_kw))))
    got = flatten_params(TC.init_params(np.random.default_rng(0), TC.ConformerConfig(**cfg_kw)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    enc = TC.Conformer(TC.ConformerConfig(**cfg_kw), TC.init_params(np.random.default_rng(1),
                                                                    TC.ConformerConfig(**cfg_kw)))
    assert set(enc.state_dict()) == set(want)


def test_config_matches_jax():
    jcfg, tcfg = JC.ConformerConfig(), TC.ConformerConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.head_dim, tcfg.decode_chunk_len, tcfg.chunk_input_len) == (
        jcfg.head_dim, jcfg.decode_chunk_len, jcfg.chunk_input_len)
    for t in (0, 7, 71, 3072):
        assert tcfg.subsampled_len(t) == jcfg.subsampled_len(t)
    assert TC.output_dim(tcfg) == JC.output_dim(jcfg) == 512
    with open(os.path.join(PIN_DIR, "config.json")) as f:
        raw = json.load(f)
    assert TC.Config(**raw["encoder"]) == TC.ConformerConfig(**PIN_CFG)


def test_rel_pos_emb_matches_jax():
    np.testing.assert_allclose(TC._rel_pos_emb(5, 9, 16).numpy(),
                               np.asarray(JC._rel_pos_emb(5, 9, 16)), rtol=0, atol=1e-6)


def _jax_encode(bundle, samples, counts):
    """The JAX recognizer's front + encoder at f32, jitted."""
    fcfg = bundle.frontend_cfg
    tables = tuple(jnp.asarray(m) for m in j_fbank_matrices(fcfg))

    @jax.jit
    def enc(params, samples, counts):
        x = samples.astype(jnp.float32) * (1.0 / 32768.0)
        t_pad = (x.shape[1] - fcfg.frame_length) // fcfg.frame_shift + 1
        feats = j_fbank_compute(x, fcfg, t_pad, n_valid=counts, tables=tables)
        return JC.forward(params, bundle.encoder_cfg, feats, num_frames_jnp(counts, fcfg))

    out, lens = enc(bundle.params["encoder"], jnp.asarray(samples), jnp.asarray(counts))
    return np.asarray(out), np.asarray(lens)


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "causal"])
def test_recognizer_matches_jax(tmp_path, jax_default_route, causal):
    cfg = JC.ConformerConfig(**TINY, **(CAUSAL if causal else {}))
    jb = JBundle.random("conformer", cfg, vocab_size=32, seed=7, decoder_dim=24, joiner_dim=20)
    jb.save(str(tmp_path))
    pcms = [_pcm(6400, 1), _pcm(3900, 2), _pcm(9100, 3)]  # ragged batch

    jrec = JRecognizer(jb, compute_dtype=None)
    want = jrec.get_results(_streams(jrec, pcms))
    tb = ModelBundle.from_dir(str(tmp_path), device="cpu")
    assert isinstance(tb.encoder, TC.Conformer)
    trec = OfflineRecognizer(tb, compute_dtype=None, device="cpu")
    got = trec.get_results(_streams(trec, pcms))
    assert sum(len(r.tokens) for r in want) > 0
    for g, w in zip(got, want):
        assert (g.text, g.tokens, g.timestamps) == (w.text, w.tokens, w.timestamps)

    samples, counts = trec.pcm_batch(_streams(trec, pcms))
    enc, lens = trec.encode(samples, counts)
    want_enc, want_lens = _jax_encode(jb, samples.numpy(), counts.numpy())
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_allclose(enc.numpy(), want_enc, rtol=0, atol=1e-4)


def test_reproduces_the_conformer_pin():
    """tests/test_pinned_transcripts.py's conformer offline pin (chunk-causal
    attention masks on the offline path), through the committed model dir."""
    bundle = ModelBundle.from_dir(PIN_DIR, device="cpu")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    res = rec.get_result(_streams(rec, [_pcm(6400)])[0])
    assert (res.text, res.timestamps) == (PIN_TEXT, PIN_TIMESTAMPS)


def test_pin_fixture_equals_a_fresh_jax_bundle(tmp_path):
    """The committed dir was written by

        ModelBundle.random("conformer", ConformerConfig(**PIN_CFG), vocab_size=32,
                           seed=2, decoder_dim=40, joiner_dim=36).save(PIN_DIR)

    with the JAX package's ModelBundle — the pin's bundle
    (tests/test_pinned_transcripts.py:41-47).  It must not drift from it."""
    fresh = JBundle.random("conformer", JC.ConformerConfig(**PIN_CFG), vocab_size=32, seed=2,
                           decoder_dim=40, joiner_dim=36)
    fresh.save(str(tmp_path))
    with np.load(os.path.join(PIN_DIR, "params.npz")) as a, \
            np.load(tmp_path / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("config.json", "tokens.txt"):
        with open(os.path.join(PIN_DIR, name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name


def test_random_bundle_builds_the_full_width_config():
    """ModelBundle.random for conformer without JAX: ConformerConfig()'s
    tree (12 layers, d_model 512) from a numpy seed, on the CPU."""
    cfg = TC.ConformerConfig()
    bundle = ModelBundle.random("conformer", cfg, vocab_size=500, seed=0, device="cpu")
    sd = bundle.encoder.state_dict()
    assert sd["layers.11.attn.u"].shape == (8, 64)
    assert sd["subsample.out.w"].shape == (512 * 19, 512)
    assert sd["layers.0.conv.dw.w"].shape == (31, 1, 512)
    assert bundle.joiner.cfg.encoder_dim == 512


def test_params_from_numpy_round_trips_the_conformer_tree():
    tree = jax.device_get(JC.init_params(jax.random.PRNGKey(3), JC.ConformerConfig(**TINY)))
    flat = j_flatten(tree)
    sd = params_from_numpy(tree).state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
