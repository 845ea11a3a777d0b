"""The port's zipformer v1 (k2transducerasr_tpu_torch/models/zipformer.py),
offline and streaming, and its recognizers against the JAX package on the
CPU, inputs from numpy seeds, plus the zipformer pin's model dir.

JAX runs its default CPU route (``K2T_FLASH_ATTN`` unset: the XLA masked
softmax, which masks queries as well as keys), the port K1's plain version
(keys only); the stacks zero invalid rows, so whole outputs compare.
Tolerances: float32 encoder output and streaming steps (state leaves
included) agree to atol 1e-4 (summation order through every layer), tokens
and timestamps exactly; bf16 encoder output to atol 0.05, a few bf16 ulps
over BasicNorm outputs of order 1 (two bf16 pipelines whose roundings differ
at the ulp level: PyTorch's bf16 matmul rounds before the bias add, and
elementwise ops round at other points).
"""

import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.models import registry as JR
from k2transducerasr_tpu.models import zipformer as JZ
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.checkpoint import flatten_params as j_flatten
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.models import registry as TR
from k2transducerasr_tpu_torch.models import zipformer as TZ
from k2transducerasr_tpu_torch.ops import attention_cuda as AC
from k2transducerasr_tpu_torch.runtime.checkpoint import (
    flatten_params,
    load_params,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "zipformer_pin")
# tests/test_pinned_transcripts.py's zipformer bundle and pins
PIN_CFG = dict(num_encoder_layers=(1, 1), encoder_dims=(32, 32), attention_dims=(32, 32),
               num_heads=(4, 4), feedforward_dims=(48, 48), cnn_module_kernels=(7, 7),
               downsampling_factors=(1, 2), causal=True, chunk_size=4, left_context_frames=8)
PIN_BUNDLE = dict(vocab_size=32, seed=3, decoder_dim=40, joiner_dim=36)
PIN_TEXT = "tok5tok17tok5tok17tok5tok17tok5tok17"
PIN_TIMESTAMPS = list(range(8))
ONLINE_PIN_TEXT = "tok5tok17tok5tok17tok5tok17tok5tok17tok5tok23"
# four stacks: a dim change at stack 1 (extra_proj, the combiner's pad) and
# U-Net skips into stacks 2 and 3
TINY = dict(num_encoder_layers=(1, 1, 1, 1), encoder_dims=(16, 24, 24, 24),
            attention_dims=(16, 16, 16, 16), num_heads=(2, 2, 2, 2),
            feedforward_dims=(32, 32, 32, 32), cnn_module_kernels=(7, 7, 7, 7),
            downsampling_factors=(1, 2, 4, 2), embed_channels=(2, 4, 8))
CAUSAL = dict(causal=True, chunk_size=4, left_context_frames=8)


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
    """The JAX zipformer's own CPU route (no Pallas interpret switch)."""
    monkeypatch.delenv("K2T_FLASH_ATTN", raising=False)


def _cfgs(**kw):
    return JZ.ZipformerConfig(**kw), TZ.ZipformerConfig(**kw)


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "causal"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(jax_default_route, causal, dtype):
    jcfg, tcfg = _cfgs(**TINY, **(CAUSAL if causal else {}))
    params = jax.device_get(JZ.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((3, 83, 80))).astype(np.float32)
    lens = np.array([83, 50, 21], np.int32)  # ragged; lane 2 has 7 embed frames
    jcd, tcd, atol = ((None, None, 1e-4) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, 0.05))
    want, want_lens = jax.jit(JZ.forward, static_argnums=(1, 4))(
        params, jcfg, jnp.asarray(x), jnp.asarray(lens), jcd)
    enc = TZ.Zipformer(tcfg, params)
    with torch.inference_mode():
        got, got_lens = enc(torch.from_numpy(x), torch.from_numpy(lens), tcd)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == (torch.float32 if tcd is None else tcd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "chunk-causal"])
def test_full_width_layer_matches_jax(jax_default_route, causal):
    """One stack-0 layer of ZipformerConfig() (dim 384, attention 192, 8
    heads of 24, pos_dim 4, kernel 31), T = 48, float32, on valid rows."""
    jcfg, tcfg = _cfgs(causal=causal)
    params = jax.device_get(JZ._init_layer(jax.random.PRNGKey(3), jcfg, 0))
    b, t = 2, 48
    x = np.random.default_rng(0).standard_normal((b, t, 384)).astype(np.float32)
    rows = [t, t] if causal else [t, 29]
    valid = np.arange(t)[None, :] < np.array(rows)[:, None]
    kw = ({"chunk_left": (16, 64)} if causal else {"pad_lens": np.array(rows, np.int32)})
    vj = None if causal else jnp.asarray(valid)
    want, _ = JZ._layer_forward(params, jcfg, 0, jnp.asarray(x), None, None, vj, None, **kw)
    tkw = dict(kw) if causal else {"pad_lens": torch.tensor(rows, dtype=torch.int32)}
    got, _ = TZ._layer_forward(params_from_numpy(params), tcfg, 0, torch.from_numpy(x), None,
                               None if causal else torch.from_numpy(valid), None, **tkw)
    want = np.asarray(want)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(got[i, :r].numpy(), want[i, :r], rtol=1e-4, atol=1e-4)


def test_attention_calls_k1_once_per_layer(monkeypatch):
    """On CPU tensors K1's wrapper runs its plain version and counts nothing;
    the forward calls it once per layer, at qd 8, pd 4."""
    cfg = TZ.ZipformerConfig(**TINY)
    enc = TZ.Zipformer(cfg, TZ.init_params(np.random.default_rng(0), cfg))
    calls = []

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape) + (a[2].shape[-1],))
        return AC.relpos_attn_probs(*a, **kw)

    before = AC.relpos_attn_probs.launches
    monkeypatch.setattr(TZ, "relpos_attn_probs", spy)
    with torch.inference_mode():
        out, lens = enc(torch.zeros(2, 60, 80), torch.tensor([60, 40]))
    assert calls == [(2, 26, 2, 8, 4), (2, 13, 2, 8, 4), (2, 7, 2, 8, 4), (2, 13, 2, 8, 4)]
    assert AC.relpos_attn_probs.launches == before
    assert out.shape == (2, 13, 24) and lens.tolist() == [13, 8]


def test_init_params_tree_matches_jax():
    """Same paths, shapes, dtypes and None entries as the JAX init, for a
    config with skips (None for stacks 0-1, combiners for 2-3)."""
    jcfg, tcfg = _cfgs(**TINY)
    want = jax.device_get(JZ.init_params(jax.random.PRNGKey(0), jcfg))
    got = TZ.init_params(np.random.default_rng(0), tcfg)
    assert [x is None for x in got["skip_combiners"]] == [True, True, False, False]
    assert [x is None for x in want["skip_combiners"]] == [True, True, False, False]
    jw, tg = j_flatten(want), flatten_params(got)
    assert set(tg) == set(jw)
    for k, v in jw.items():
        assert tg[k].shape == v.shape and tg[k].dtype == v.dtype, k
    enc = TZ.Zipformer(tcfg, got)
    assert enc["skip_combiners"][0] is None and "weight1" in enc["skip_combiners"][2]
    assert set(enc.state_dict()) == {k for k, v in jw.items() if v.dtype != object}


def test_params_from_numpy_round_trips_the_v1_tree():
    tree = jax.device_get(JZ.init_params(jax.random.PRNGKey(3), JZ.ZipformerConfig(**TINY)))
    flat = {k: v for k, v in j_flatten(tree).items() if v.dtype != object}
    enc = params_from_numpy(tree)
    assert [x is None for x in enc["skip_combiners"]] == [x is None for x in tree["skip_combiners"]]
    sd = enc.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_config_matches_jax():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for i in range(jcfg.num_stacks):
        assert (tcfg.stack_chunk(i), tcfg.stack_left(i)) == (jcfg.stack_chunk(i),
                                                             jcfg.stack_left(i))
    assert tcfg.skip_sources() == jcfg.skip_sources()
    assert (tcfg.decode_chunk_len, tcfg.chunk_input_len, TZ.output_dim(tcfg),
            TZ.output_chunk_len(tcfg)) == (jcfg.decode_chunk_len, jcfg.chunk_input_len,
                                          JZ.output_dim(jcfg), JZ.output_chunk_len(jcfg))
    for t in (7, 71, 3072):
        assert (tcfg.embed_len(t), tcfg.subsampled_len(t)) == (jcfg.embed_len(t),
                                                               jcfg.subsampled_len(t))
    with open(os.path.join(PIN_DIR, "config.json")) as f:
        raw = json.load(f)
    assert TZ.Config(**raw["encoder"]) == TZ.ZipformerConfig(**PIN_CFG)
    # every family of the JAX registry loads in the port
    for name in JR._FAMILIES:
        assert TR.get_encoder(name).__name__.replace("_torch", "") == JR.get_encoder(name).__name__


def test_sinusoidal_rel_pos_matches_jax():
    from k2transducerasr_tpu_torch.ops.attention import sinusoidal_rel_pos

    np.testing.assert_allclose(sinusoidal_rel_pos(5, 9, 32).numpy(),
                               np.asarray(JZ._sinusoidal_rel_pos(5, 9, 32)), rtol=0, atol=1e-6)


def _windows(cfg, b, n, seed=5):
    extra = cfg.chunk_input_len - cfg.decode_chunk_len
    t_raw = cfg.decode_chunk_len * n + extra
    x = (0.5 * np.random.default_rng(seed).standard_normal((b, t_raw, 80))).astype(np.float32)
    step = cfg.decode_chunk_len
    return x, [x[:, i * step: i * step + cfg.chunk_input_len] for i in range(n)]


def _assert_trees_close(got, want, atol):
    g, w = flatten_params(got), flatten_params(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


def test_streaming_step_matches_jax(jax_default_route):
    """Four f32 steps from a state whose lanes differ (lane 0 fresh, lane 1
    one step in, so kv_start differs per lane), carried into the port by
    state_from_numpy: outputs and every state leaf at atol 1e-4."""
    jcfg, tcfg = _cfgs(**TINY, **CAUSAL)
    params = jax.device_get(JZ.init_params(jax.random.PRNGKey(4), jcfg))
    _, windows = _windows(jcfg, 2, 5)
    step = jax.jit(JZ.streaming_step, static_argnums=(1, 4))
    _, jstate = step(params, jcfg, JZ.init_state(jcfg, 2), jnp.asarray(windows[0]))
    jstate = jax.tree.map(lambda a: np.concatenate([np.zeros_like(a[:1]), a[1:]]),
                          jax.device_get(jstate))
    tstate = state_from_numpy(jstate)
    enc = TZ.Zipformer(tcfg, params)
    for w in windows[1:]:
        want, jstate = step(params, jcfg, jstate, jnp.asarray(w))
        with torch.inference_mode():
            got, tstate = TZ.streaming_step(enc, tcfg, tstate, torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        _assert_trees_close(state_to_numpy(tstate), jax.device_get(jstate), atol=1e-4)
    assert tstate["processed"].tolist() == [4 * tcfg.chunk_size, 5 * tcfg.chunk_size]


def test_bf16_step_matches_jax(jax_default_route):
    jcfg, tcfg = _cfgs(**TINY, **CAUSAL)
    params = jax.device_get(JZ.init_params(jax.random.PRNGKey(6), jcfg))
    _, windows = _windows(jcfg, 2, 3, seed=7)
    jstate, tstate = JZ.init_state(jcfg, 2), TZ.init_state(tcfg, 2)
    enc = TZ.Zipformer(tcfg, params)
    step = jax.jit(JZ.streaming_step, static_argnums=(1, 4))
    for w in windows:
        want, jstate = step(params, jcfg, jstate, jnp.asarray(w), jnp.bfloat16)
        with torch.inference_mode():
            got, tstate = enc.streaming_step(tstate, torch.from_numpy(w), torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=0.05)


def test_streaming_matches_offline_causal():
    """The port's streaming against its own offline chunk-causal forward
    over the windows' whole sequence (the reference's oracle, rtol/atol
    3e-3)."""
    cfg = TZ.ZipformerConfig(**TINY, **CAUSAL)
    enc = TZ.Zipformer(cfg, TZ.init_params(np.random.default_rng(8), cfg))
    x, windows = _windows(cfg, 2, 4, seed=9)
    state = enc.init_state(2)
    outs = []
    with torch.inference_mode():
        full, _ = enc(torch.from_numpy(x), torch.full((2,), x.shape[1]))
        for w in windows:
            out, state = enc.streaming_step(state, torch.from_numpy(w))
            outs.append(out)
    stream = torch.cat(outs, dim=1)
    assert stream.shape[1] == 4 * TZ.output_chunk_len(cfg)
    np.testing.assert_allclose(full[:, : stream.shape[1]].numpy(), stream.numpy(), rtol=3e-3,
                               atol=3e-3)


def test_init_state_matches_jax_and_crosses_packages():
    """The default config's state: 7 leaves per layer plus ``processed``, 106
    in all, the JAX tree, shapes and dtypes; it crosses the package boundary
    and back exactly."""
    jcfg, tcfg = _cfgs(causal=True)
    want = jax.device_get(JZ.init_state(jcfg, 2))
    got = state_to_numpy(TZ.init_state(tcfg, 2))
    assert len(flatten_params(got)) == 106
    _assert_trees_close(got, want, atol=0)
    want["processed"] = np.array([16, 48], np.int32)
    want["layers"][7]["avg"] = np.random.default_rng(0).standard_normal((2, 384)).astype(
        np.float32)
    port = state_from_numpy(want)
    assert port["processed"].dtype == torch.int64 and port["layers"][0]["len"].dtype == torch.float32
    _assert_trees_close(state_to_numpy(port), want, atol=0)


def test_recognizers_match_jax(tmp_path, jax_default_route):
    """A JAX bundle's dir, loaded by the port: offline transcripts of a
    ragged batch (non-causal and causal configs) and online partials after
    every 800-sample feed (causal) are token-identical to the JAX
    recognizers', f32; the offline encoder output to atol 1e-4."""
    pcms = [_pcm(6400, 1), _pcm(3900, 2), _pcm(9100, 3)]
    for causal in (False, True):
        cfg = JZ.ZipformerConfig(**TINY, **(CAUSAL if causal else {}))
        jb = JBundle.random("zipformer", cfg, vocab_size=32, seed=7, decoder_dim=24,
                            joiner_dim=20)
        path = tmp_path / str(causal)
        jb.save(str(path))
        jrec = JOffline(jb, compute_dtype=None)
        want = jrec.get_results(_streams(jrec, pcms))
        tb = ModelBundle.from_dir(str(path), device="cpu")
        assert isinstance(tb.encoder, TZ.Zipformer)
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
    """The pin's bundle: a JAX snapshot_stream() restored into the port
    continues to the JAX stream's final result, and a port snapshot
    restored into JAX does too (the 7 caches per layer and ``processed``)."""
    from k2transducerasr_tpu.decode.rnnt_greedy import GreedyState as JGreedyState

    jb = JBundle.random("zipformer", JZ.ZipformerConfig(**PIN_CFG), **PIN_BUNDLE)
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
    assert len(flatten_params(psnap["enc"])) == 2 * 7 + 1
    psnap["dec"] = JGreedyState(**dataclasses.asdict(psnap["dec"]))
    js = jrec.restore_stream(psnap)
    js.add_samples(pcm[4000:])
    back = jrec.decode_to_end(js)
    assert (back.text, back.timestamps) == (want.text, want.timestamps)


def test_reproduces_the_zipformer_pins():
    """tests/test_pinned_transcripts.py's zipformer pins through the
    committed model dir: offline text and timestamps, and the online text
    through decode_to_end."""
    bundle = ModelBundle.from_dir(PIN_DIR, device="cpu")
    assert bundle.encoder["skip_combiners"][0] is None
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    res = rec.get_result(_streams(rec, [_pcm(6400)])[0])
    assert (res.text, res.timestamps) == (PIN_TEXT, PIN_TIMESTAMPS)
    online = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device="cpu")
    s = online.create_online_stream()
    s.add_samples(_pcm(6400))
    assert online.decode_to_end(s).text == ONLINE_PIN_TEXT


def _members(path):
    """{name: raw bytes} of an .npz, and the names whose .npy header says
    dtype object (read from the header; nothing is unpickled)."""
    objects = set()
    with zipfile.ZipFile(path) as zf:
        raw = {n: zf.read(n) for n in zf.namelist()}
        for n in raw:
            with zf.open(n) as f:
                assert np.lib.format.read_magic(f) == (1, 0)
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            if dtype.hasobject:
                assert shape == (), n
                objects.add(n)
    return raw, objects


def test_pin_fixture_equals_a_fresh_jax_bundle(tmp_path):
    """The committed dir was written by

        ModelBundle.random("zipformer", ZipformerConfig(**PIN_CFG), vocab_size=32,
                           seed=3, decoder_dim=40, joiner_dim=36).save(PIN_DIR)

    with the JAX package's ModelBundle — the pin's bundle
    (tests/test_pinned_transcripts.py:48-58).  It must not drift from it:
    every member equal, the two ``None`` skip combiners (0-d object arrays)
    compared by header and bytes, never unpickled."""
    JBundle.random("zipformer", JZ.ZipformerConfig(**PIN_CFG), **PIN_BUNDLE).save(str(tmp_path))
    (a, a_obj), (b, b_obj) = _members(os.path.join(PIN_DIR, "params.npz")), _members(
        tmp_path / "params.npz")
    assert sorted(a) == sorted(b)
    assert a_obj == b_obj == {"encoder.skip_combiners.0.npy", "encoder.skip_combiners.1.npy"}
    for n in a_obj:
        assert a[n] == b[n], n
    with np.load(os.path.join(PIN_DIR, "params.npz")) as x, np.load(tmp_path / "params.npz") as y:
        for k in x.files:
            if k + ".npy" not in a_obj:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    for name in ("config.json", "tokens.txt"):
        with open(os.path.join(PIN_DIR, name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name
    assert load_params(os.path.join(PIN_DIR, "params.npz"))["encoder"]["skip_combiners"] == [
        None, None]


def test_object_members_are_read_by_header_only(tmp_path):
    """Only the 0-d object members (None nodes) are read, from the header;
    any other object member raises, naming the key, and nothing is
    unpickled."""
    path = tmp_path / "params.npz"
    np.savez(path, **{"encoder.a": np.zeros(2, np.float32),
                      "encoder.bad": np.array([None, None], dtype=object)})
    with pytest.raises(ValueError, match="encoder.bad"):
        load_params(str(path))
    np.savez(path, **{"encoder.a": np.zeros(2, np.float32),
                      "encoder.b": np.array({"x": 1}, dtype=object)})  # 0-d, pickles a dict
    assert load_params(str(path))["encoder"]["b"] is None


def test_random_bundle_builds_the_full_width_config():
    """ModelBundle.random for zipformer without JAX: ZipformerConfig()'s
    tree (15 layers in 5 stacks, dims 384, attention 192, 8 heads) from a
    numpy seed, on the CPU."""
    cfg = TZ.ZipformerConfig()
    bundle = ModelBundle.random("zipformer", cfg, vocab_size=500, seed=0, device="cpu")
    sd = bundle.encoder.state_dict()
    assert sd["stacks.4.layers.3.attn.in_proj.w"].shape == (384, 192 + 192 + 96 + 32)
    assert sd["stacks.3.upsample_bias"].shape == (8, 384)
    assert sd["skip_combiners.2.weight1"].shape == ()
    assert [x is None for x in bundle.encoder["skip_combiners"]] == [True, True, False, False,
                                                                     False]
    assert sum(len(s["layers"]) for s in bundle.encoder["stacks"]) == 15
    assert bundle.joiner.cfg.encoder_dim == 384
