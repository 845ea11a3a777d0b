"""The port's streaming encoders (``init_state``/``streaming_step`` of
zipformer2 and conformer), its ``OnlineFbank`` and the state bridge
(``runtime/checkpoint.state_from_numpy``/``state_to_numpy``) against the JAX
package on the CPU, inputs from numpy seeds.

Tolerances: float32 steps agree with the JAX steps to atol 1e-4 on the
output and on every state leaf (summation order through every layer); the
port's streaming agrees with its own offline-causal forward to rtol/atol
3e-3, the reference's own bound for that identity (the two paths schedule
reductions differently); a bf16 step agrees to atol 0.05 (two bf16
pipelines, one bf16 ulp apart per linear, over outputs of order 1);
``OnlineFbank`` frames to rtol 1e-4 / atol 1e-3, the offline fbank's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.frontend import fbank as JF
from k2transducerasr_tpu.models import conformer as JC
from k2transducerasr_tpu.models import zipformer2 as JZ
from k2transducerasr_tpu_torch.frontend import fbank as TF
from k2transducerasr_tpu_torch.models import conformer as TC
from k2transducerasr_tpu_torch.models import zipformer2 as TZ
from k2transducerasr_tpu_torch.runtime.checkpoint import (
    flatten_params,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

ZIP = dict(num_encoder_layers=(1, 1), encoder_dims=(16, 32), downsampling_factors=(1, 2),
           num_heads=(2, 2), feedforward_dims=(32, 48), cnn_module_kernels=(7, 7),
           query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
           embed_channels=(2, 4, 8), causal=True, chunk_size=8, left_context_frames=16)
CONF = dict(d_model=64, num_layers=2, num_heads=4, ff_dim=96, cnn_kernel=7, causal=True,
            chunk_size=4, left_context=8)
# family -> (JAX module, port module, config kwargs); "short-chunk": stack 1's
# chunk of 4 frames is shorter than its conv half-kernel of 7
FAMILIES = {
    "zipformer2": (JZ, TZ, ZIP),
    "zipformer2-short-chunk": (JZ, TZ, dict(ZIP, cnn_module_kernels=(7, 15))),
    "conformer": (JC, TC, CONF),
}


def _jit_step(jmod):
    return jax.jit(jmod.streaming_step, static_argnums=(1, 4))


def _setup(family, seed=4):
    jmod, tmod, kw = FAMILIES[family]
    jcfg, tcfg = jmod.Config(**kw), tmod.Config(**kw)
    params = jax.device_get(jmod.init_params(jax.random.PRNGKey(seed), jcfg))
    return jmod, tmod, jcfg, tcfg, params


def _windows(cfg, b, n, seed=5):
    """n streaming windows of raw features, advancing by decode_chunk_len;
    also returns the whole [b, t_raw, 80] sequence they cover."""
    extra = cfg.chunk_input_len - cfg.decode_chunk_len
    t_raw = cfg.decode_chunk_len * n + extra
    x = (0.5 * np.random.default_rng(seed).standard_normal((b, t_raw, 80))).astype(np.float32)
    step = cfg.decode_chunk_len
    return x, [x[:, i * step: i * step + cfg.chunk_input_len] for i in range(n)]


def _assert_trees_close(got, want, atol, rtol=0.0):
    """Every leaf of two state trees in the JAX layout (numpy)."""
    g, w = flatten_params(got), flatten_params(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("family", ["zipformer2", "conformer"])
def test_streaming_step_matches_jax(family):
    """Three f32 steps from a state whose lanes differ (lane 0 fresh, lane 1
    one step in, so kv_start differs per lane), carried into the port by
    state_from_numpy: outputs and every state leaf at atol 1e-4."""
    jmod, tmod, jcfg, tcfg, params = _setup(family)
    _, windows = _windows(jcfg, 2, 4)
    step = _jit_step(jmod)
    _, jstate = step(params, jcfg, jmod.init_state(jcfg, 2), jnp.asarray(windows[0]))
    jstate = jax.tree.map(lambda a: np.concatenate([np.zeros_like(a[:1]), a[1:]]),
                          jax.device_get(jstate))  # lane 0 starts afresh
    tstate = state_from_numpy(jstate)
    enc = tmod.Encoder(tcfg, params)
    for w in windows[1:]:
        want, jstate = step(params, jcfg, jstate, jnp.asarray(w))
        with torch.inference_mode():
            got, tstate = tmod.streaming_step(enc, tcfg, tstate, torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        _assert_trees_close(state_to_numpy(tstate), jax.device_get(jstate), atol=1e-4)
    assert tstate["processed"].dtype == torch.int64
    assert tstate["processed"].tolist() == [3 * tcfg.chunk_size, 4 * tcfg.chunk_size]


@pytest.mark.parametrize("family", ["zipformer2", "conformer"])
def test_bf16_step_matches_jax(family):
    jmod, tmod, jcfg, tcfg, params = _setup(family, seed=6)
    _, windows = _windows(jcfg, 2, 2, seed=7)
    jstate, tstate = jmod.init_state(jcfg, 2), tmod.init_state(tcfg, 2)
    enc = tmod.Encoder(tcfg, params)
    step = _jit_step(jmod)
    for w in windows:
        want, jstate = step(params, jcfg, jstate, jnp.asarray(w), jnp.bfloat16)
        with torch.inference_mode():
            got, tstate = enc.streaming_step(tstate, torch.from_numpy(w), torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=0.05)


def test_flagship_width_layer_with_caches_matches_jax():
    """One stack-0 layer of Zipformer2Config(causal=True) (dim 192, 4 heads,
    qd 32, pd 4, left 128, chunk 32, kernel 31) streaming with random
    caches and kv_start 0, mid and left: output and new caches at 1e-4."""
    jcfg, tcfg = JZ.Zipformer2Config(causal=True), TZ.Zipformer2Config(causal=True)
    params = jax.device_get(JZ._init_layer(jax.random.PRNGKey(3), jcfg, 0))
    rng = np.random.default_rng(1)
    b, t, left = 3, 32, 128

    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    caches = {"key": mk(b, left, 128), "val1": mk(b, left, 48), "val2": mk(b, left, 48),
              "nonlin": mk(b, left, 144), "conv1": mk(b, 15, 192), "conv2": mk(b, 15, 192)}
    x = mk(b, t, 192)
    kv_start = np.array([0, 50, left], np.int32)
    layer = jax.jit(lambda p, x, c, kv: JZ._layer_forward(p, jcfg, 0, x, None, 32, c, None,
                                                          kv_start=kv))
    want, want_caches = layer(params, jnp.asarray(x), caches, jnp.asarray(kv_start))
    got, got_caches = TZ._layer_forward(
        params_from_numpy(params), tcfg, 0, torch.from_numpy(x), 32, None,
        caches=state_from_numpy(caches), kv_start=torch.from_numpy(kv_start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _assert_trees_close(state_to_numpy(got_caches), jax.device_get(want_caches), atol=1e-4,
                        rtol=1e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streaming_matches_offline_causal(family):
    """The port's streaming against its own offline chunk-causal forward
    over the windows' whole sequence (the reference's oracle).  The
    short-chunk case needs the conv cache to be the tail of [cache | h]."""
    _, tmod, _, tcfg, params = _setup(family, seed=8)
    n = 3
    x, windows = _windows(tcfg, 2, n, seed=9)
    enc = tmod.Encoder(tcfg, params)
    state = enc.init_state(2)
    outs = []
    with torch.inference_mode():
        full, _ = enc(torch.from_numpy(x), torch.full((2,), x.shape[1]))
        for w in windows:
            out, state = enc.streaming_step(state, torch.from_numpy(w))
            outs.append(out)
    stream = torch.cat(outs, dim=1)
    assert stream.shape[1] == n * tmod.output_chunk_len(tcfg)
    np.testing.assert_allclose(full[:, : stream.shape[1]].numpy(), stream.numpy(),
                               rtol=3e-3, atol=3e-3)
    if family == "zipformer2-short-chunk":
        assert state["layers"][1]["conv1"].shape == (2, 7, 32)


@pytest.mark.parametrize("family", ["zipformer2", "conformer"])
def test_init_state_matches_jax(family):
    jmod, tmod, jcfg, tcfg, _ = _setup(family)
    want = jax.device_get(jmod.init_state(jcfg, 3))
    got = state_to_numpy(tmod.init_state(tcfg, 3))
    _assert_trees_close(got, want, atol=0)
    assert (tmod.output_chunk_len(tcfg), tcfg.chunk_input_len, tcfg.decode_chunk_len) == (
        jmod.output_chunk_len(jcfg), jcfg.chunk_input_len, jcfg.decode_chunk_len)
    if family == "zipformer2":
        assert (tcfg.embed_cache_len, tcfg.embed_len(77)) == (jcfg.embed_cache_len,
                                                               jcfg.embed_len(77))


def test_online_fbank_matches_jax():
    """800-sample feeds, then input_finished: the same frames per call."""
    cfg_kw = dict(window_type="povey")
    j = JF.OnlineFbank(JF.FbankConfig(**cfg_kw))
    t = TF.OnlineFbank(TF.FbankConfig(**cfg_kw), device="cpu")
    pcm = (0.3 * np.random.default_rng(3).standard_normal(7000)).astype(np.float32)
    n_frames = 0
    for i in range(0, len(pcm), 800):
        want, got = j.accept_waveform(pcm[i:i + 800]), t.accept_waveform(pcm[i:i + 800])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        n_frames += len(got)
    want, got = j.input_finished(), t.input_finished()
    assert got.shape == want.shape
    assert n_frames + len(got) == TF.num_frames_for(len(pcm), t.cfg)
    with pytest.raises(RuntimeError):
        t.accept_waveform(pcm[:10])
    with pytest.raises(ValueError, match="snip_edges"):
        TF.OnlineFbank(TF.FbankConfig(snip_edges=False), device="cpu")


def test_state_bridge_round_trips():
    """JAX layout -> port -> JAX layout is exact, int32 counters become
    int64 in the port, and a dataclass becomes the port's GreedyState."""
    from k2transducerasr_tpu.decode import rnnt_greedy as JG
    from k2transducerasr_tpu_torch.decode.rnnt_greedy import GreedyState

    tree = jax.device_get(JZ.init_state(JZ.Zipformer2Config(**ZIP), 2))
    tree["processed"] = np.array([8, 40], np.int32)
    tree["layers"][1]["key"] = np.random.default_rng(0).standard_normal((2, 8, 8)).astype(
        np.float32)
    port = state_from_numpy(tree)
    assert port["processed"].dtype == torch.int64
    _assert_trees_close(state_to_numpy(port), tree, atol=0)
    dec = JG.GreedyState(*(np.arange(4, dtype=np.int32).reshape(2, 2) for _ in range(6)))
    got = state_from_numpy(dec)
    assert isinstance(got, GreedyState) and got.tokens.dtype == torch.int64
    back = state_to_numpy(got)
    for f in ("hyp", "dec_proj", "tokens", "timestamps", "count", "trailing_blanks"):
        np.testing.assert_array_equal(getattr(back, f), getattr(dec, f))
