"""The port's LSTM transducer (k2transducerasr_tpu_torch/models/lstm.py),
offline and streaming, and its recognizers against the JAX package on the
CPU, inputs from numpy seeds, plus the LSTM pin's model dir.

The JAX recurrence is a ``lax.scan``; the port's is PyTorch's LSTM with
projections (``torch._VF.lstm``; ATen's loop on the CPU).  Tolerances:
float32 encoder output and streaming steps (the h and c leaves included)
agree to atol 1e-5 (summation order of the gate products), tokens and
timestamps exactly; bf16 encoder output to atol 0.05 (the port runs the
recurrence in float32 on bf16-rounded weights and input, the reference
also rounds the input gates and ``h`` to bf16 at each step: a few bf16 ulps
over LayerNorm outputs of order 1).  No test here draws from the global
torch RNG, and one checks that the port does not either.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode.rnnt_greedy import GreedyState as JGreedyState
from k2transducerasr_tpu.models import lstm as JL
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.checkpoint import flatten_params as j_flatten
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.models import lstm as TL
from k2transducerasr_tpu_torch.runtime.checkpoint import (
    flatten_params,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "lstm_pin")
# tests/test_pinned_transcripts.py's LSTM bundle and pins
PIN_CFG = dict(d_model=32, rnn_hidden_size=48, num_layers=1, ff_dim=64, chunk_size=4)
PIN_BUNDLE = dict(vocab_size=16, seed=0, decoder_dim=24, joiner_dim=24)
PIN_TEXT = "tok6tok15tok15tok15tok15tok15tok15"
PIN_TIMESTAMPS = list(range(8))
ONLINE_PIN_TEXT = "tok6tok15tok15tok15tok15tok15tok15tok9tok9tok9tok9tok9tok9"
TINY = dict(d_model=32, rnn_hidden_size=48, num_layers=3, ff_dim=64, chunk_size=4)


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


def _setup(seed=0, **kw):
    jcfg, tcfg = JL.LstmConfig(**{**TINY, **kw}), TL.LstmConfig(**{**TINY, **kw})
    params = jax.device_get(JL.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, params, TL.Lstm(tcfg, params)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(dtype):
    jcfg, tcfg, params, enc = _setup()
    x = (0.5 * np.random.default_rng(5).standard_normal((3, 93, 80))).astype(np.float32)
    lens = np.array([93, 50, 20], np.int32)  # ragged; lane 2 has 3 frames after subsampling
    jcd, tcd, atol = ((None, None, 1e-5) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, 0.05))
    want, want_lens = jax.jit(JL.forward, static_argnums=(1, 4))(
        params, jcfg, jnp.asarray(x), jnp.asarray(lens), jcd)
    with torch.inference_mode():
        got, got_lens = enc(torch.from_numpy(x), torch.from_numpy(lens), tcd)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # from layer 0 on
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def _windows(cfg, b, n, seed=5):
    extra = cfg.chunk_input_len - cfg.decode_chunk_len
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (b, cfg.decode_chunk_len * n + extra, 80))).astype(np.float32)
    step = cfg.decode_chunk_len
    return x, [x[:, i * step: i * step + cfg.chunk_input_len] for i in range(n)]


def test_streaming_step_matches_jax():
    """Three f32 steps from a state whose lanes differ (lane 0 fresh),
    carried in by state_from_numpy: outputs, h and c at atol 1e-5."""
    jcfg, tcfg, params, enc = _setup(seed=4)
    _, windows = _windows(jcfg, 2, 4)
    step = jax.jit(JL.streaming_step, static_argnums=(1, 4))
    _, jstate = step(params, jcfg, JL.init_state(jcfg, 2), jnp.asarray(windows[0]))
    jstate = jax.tree.map(lambda a: np.concatenate([np.zeros_like(a[:1]), a[1:]]),
                          jax.device_get(jstate))
    tstate = state_from_numpy(jstate)
    for w in windows[1:]:
        want, jstate = step(params, jcfg, jstate, jnp.asarray(w))
        with torch.inference_mode():
            got, tstate = TL.streaming_step(enc, tcfg, tstate, torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        g, wnt = state_to_numpy(tstate), jax.device_get(jstate)
        assert sorted(g) == sorted(wnt) == ["c", "h"]
        for k in g:
            assert g[k].dtype == wnt[k].dtype == np.float32
            np.testing.assert_allclose(g[k], wnt[k], rtol=0, atol=1e-5, err_msg=k)


def test_streaming_matches_offline():
    """LSTMs are causal: the port's steps equal its own offline forward over
    the windows' whole sequence."""
    _, tcfg, _, enc = _setup(seed=8)
    x, windows = _windows(tcfg, 2, 3, seed=9)
    state = enc.init_state(2)
    outs = []
    with torch.inference_mode():
        full, _ = enc(torch.from_numpy(x), torch.full((2,), x.shape[1]))
        for w in windows:
            out, state = enc.streaming_step(state, torch.from_numpy(w))
            outs.append(out)
    stream = torch.cat(outs, dim=1)
    assert stream.shape[1] == 3 * TL.output_chunk_len(tcfg)
    np.testing.assert_allclose(full[:, : stream.shape[1]].numpy(), stream.numpy(), rtol=0,
                               atol=1e-5)


def test_recognizers_match_jax(tmp_path):
    """A JAX bundle's dir, loaded by the port: offline transcripts of a
    ragged batch and the online partials after every 800-sample feed are
    token-identical to the JAX recognizers', f32."""
    jb = JBundle.random("lstm", JL.LstmConfig(**TINY), vocab_size=32, seed=7, decoder_dim=24,
                        joiner_dim=20)
    jb.save(str(tmp_path))
    tb = ModelBundle.from_dir(str(tmp_path), device="cpu")
    assert isinstance(tb.encoder, TL.Lstm)
    pcms = [_pcm(6400, 1), _pcm(3900, 2), _pcm(9100, 3)]
    jrec = JOffline(jb, compute_dtype=None)
    want = jrec.get_results(_streams(jrec, pcms))
    trec = OfflineRecognizer(tb, compute_dtype=None, device="cpu")
    got = trec.get_results(_streams(trec, pcms))
    assert sum(len(r.tokens) for r in want) > 0
    for g, w in zip(got, want):
        assert (g.text, g.tokens, g.timestamps) == (w.text, w.tokens, w.timestamps)
    partials = []
    for rec in (JOnline(jb, compute_dtype=None, max_lanes=2),
                OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, device="cpu")):
        s = rec.create_online_stream()
        out = []
        for i in range(0, 9100, 800):
            s.add_samples(pcms[2][i:i + 800])
            out.extend((r.text, r.tokens, r.timestamps) for r in rec.get_results([s]))
        r = rec.decode_to_end(s)
        partials.append(out + [(r.text, r.tokens, r.timestamps)])
    assert partials[1] == partials[0] and partials[0][-1][1]


def test_snapshot_carries_a_stream_across_packages():
    """The pin's bundle: a JAX snapshot (h and c) restored into the port
    continues to the JAX stream's final result, and back."""
    jb = JBundle.random("lstm", JL.LstmConfig(**PIN_CFG), **PIN_BUNDLE)
    tb = ModelBundle.from_dir(PIN_DIR, device="cpu")
    pcm = _pcm(6400)
    jrec = JOnline(jb, compute_dtype=None, max_lanes=2)
    js = jrec.create_online_stream()
    js.add_samples(pcm[:4000])
    while js._ready():
        jrec.get_results([js])
    snap = jrec.snapshot_stream(js)
    js.add_samples(pcm[4000:])
    want = jrec.decode_to_end(js)
    assert want.text == ONLINE_PIN_TEXT

    trec = OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, device="cpu")
    ts = trec.restore_stream(snap)
    ts.add_samples(pcm[4000:])
    got = trec.decode_to_end(ts)
    assert (got.text, got.tokens, got.timestamps) == (want.text, want.tokens, want.timestamps)

    ts = trec.create_online_stream()
    ts.add_samples(pcm[:4000])
    while ts._ready():
        trec.get_results([ts])
    psnap = trec.snapshot_stream(ts)
    assert sorted(flatten_params(psnap["enc"])) == ["c", "h"]
    psnap["dec"] = JGreedyState(**dataclasses.asdict(psnap["dec"]))
    js = jrec.restore_stream(psnap)
    js.add_samples(pcm[4000:])
    back = jrec.decode_to_end(js)
    assert (back.text, back.timestamps) == (want.text, want.timestamps)


def test_reproduces_the_lstm_pins():
    bundle = ModelBundle.from_dir(PIN_DIR, device="cpu")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    res = rec.get_result(_streams(rec, [_pcm(6400)])[0])
    assert (res.text, res.timestamps) == (PIN_TEXT, PIN_TIMESTAMPS)
    online = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device="cpu")
    s = online.create_online_stream()
    s.add_samples(_pcm(6400))
    assert online.decode_to_end(s).text == ONLINE_PIN_TEXT


def test_pin_fixture_equals_a_fresh_jax_bundle(tmp_path):
    """The committed dir was written by

        ModelBundle.random("lstm", LstmConfig(**PIN_CFG), vocab_size=16, seed=0,
                           decoder_dim=24, joiner_dim=24).save(PIN_DIR)

    with the JAX package's ModelBundle — the pin's bundle
    (tests/test_pinned_transcripts.py:34-40).  It must not drift from it."""
    JBundle.random("lstm", JL.LstmConfig(**PIN_CFG), **PIN_BUNDLE).save(str(tmp_path))
    with np.load(os.path.join(PIN_DIR, "params.npz")) as a, \
            np.load(tmp_path / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("config.json", "tokens.txt"):
        with open(os.path.join(PIN_DIR, name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name


def test_building_and_running_draws_nothing_from_the_global_rng():
    """ModelBundle.random and from_dir, an offline decode and an online
    decode leave torch's global RNG state as it was."""
    before = torch.random.get_rng_state()
    for bundle in (ModelBundle.random("lstm", TL.LstmConfig(**PIN_CFG), vocab_size=16, seed=1,
                                      decoder_dim=24, joiner_dim=24, device="cpu"),
                   ModelBundle.from_dir(PIN_DIR, device="cpu")):
        rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
        rec.get_result(_streams(rec, [_pcm(4000)])[0])
        online = OnlineRecognizer(bundle, max_lanes=1, device="cpu")  # bf16 compute
        s = online.create_online_stream()
        s.add_samples(_pcm(4000))
        online.decode_to_end(s)
    assert torch.equal(torch.random.get_rng_state(), before)


def test_recurrent_weights_are_built_once_in_torch_layout():
    _, tcfg, params, enc = _setup()
    w = enc.rnn_weights(None)
    assert len(w) == tcfg.num_layers and enc.rnn_weights(None) is w
    p = params["layers"][1]["lstm"]
    for got, want in zip(w[1], (p["wx"].T, p["wh"].T, p["b"], np.zeros_like(p["b"]), p["wp"].T)):
        np.testing.assert_array_equal(got.numpy(), want)
    rounded = enc.rnn_weights(torch.bfloat16)[1][0]
    assert rounded.dtype == torch.float32
    assert torch.equal(rounded, torch.from_numpy(p["wx"].T.copy()).bfloat16().float())
    with pytest.raises(ValueError, match="compute_dtype"):
        enc.rnn_weights(torch.float16)


def test_projection_must_be_narrower_than_the_cell():
    cfg = TL.LstmConfig(**{**TINY, "rnn_hidden_size": 32})
    with pytest.raises(ValueError, match="d_model < rnn_hidden_size"):
        TL.Lstm(cfg, TL.init_params(np.random.default_rng(0), cfg))


def test_init_params_and_config_match_jax():
    jcfg, tcfg = JL.LstmConfig(**TINY), TL.LstmConfig(**TINY)
    want = j_flatten(jax.device_get(JL.init_params(jax.random.PRNGKey(0), jcfg)))
    got = flatten_params(TL.init_params(np.random.default_rng(0), tcfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert dataclasses.asdict(TL.LstmConfig()) == dataclasses.asdict(JL.LstmConfig())
    assert (tcfg.decode_chunk_len, tcfg.chunk_input_len, TL.output_dim(tcfg),
            TL.output_chunk_len(tcfg)) == (jcfg.decode_chunk_len, jcfg.chunk_input_len,
                                          JL.output_dim(jcfg), JL.output_chunk_len(jcfg))
    for t in (7, 71, 3072):
        assert tcfg.subsampled_len(t) == jcfg.subsampled_len(t)
    tree = jax.device_get(JL.init_params(jax.random.PRNGKey(3), jcfg))
    sd = params_from_numpy(tree).state_dict()
    assert set(sd) == set(j_flatten(tree))
    want_state = jax.device_get(JL.init_state(jcfg, 2))
    got_state = state_to_numpy(TL.init_state(tcfg, 2))
    for k in ("h", "c"):
        assert got_state[k].shape == want_state[k].shape and got_state[k].dtype == np.float32
