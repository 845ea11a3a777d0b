"""The port's zipformer2 layer, decoder, joiner, greedy search and text
assembly against the JAX package on the CPU, inputs from numpy seeds.

Tolerances: one flagship-width layer in float32 agrees to rtol/atol 1e-4 on
valid rows (summation order through ~20 matmuls; rows past a lane's length
differ by design — the port masks keys only, as the kernel does, and the
stack zeroes those rows); decoder/joiner outputs to 1e-5; greedy tokens,
timestamps, counts and trailing blanks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode import rnnt_greedy as JG
from k2transducerasr_tpu.models import decoder as JD
from k2transducerasr_tpu.models import joiner as JJ
from k2transducerasr_tpu.models import zipformer2 as JZ
from k2transducerasr_tpu.text.postprocess import tokens_to_text as j_tokens_to_text
from k2transducerasr_tpu.text.symbol_table import SymbolTable as JSymbolTable
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TG
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.models import zipformer2 as TZ
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text as t_tokens_to_text
from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable as TSymbolTable


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "chunk-causal"])
def test_flagship_width_layer_matches_jax(causal):
    """One stack-0 layer of the default config (dim 192, 4 heads, qd 32,
    pd 4, vd 12, pos_dim 48, kernel 31), T = 64, float32."""
    jcfg = JZ.Zipformer2Config(causal=causal)
    tcfg = TZ.Zipformer2Config(causal=causal)
    params = jax.device_get(JZ._init_layer(jax.random.PRNGKey(3), jcfg, 0))
    b, t = 2, 64
    x = np.random.default_rng(0).standard_normal((b, t, 192)).astype(np.float32)
    if causal:
        chunk, kw, rows = 32, {"chunk_left": (32, 128)}, [t, t]
        valid_j = valid_t = None
    else:
        chunk, rows = 0, [64, 41]
        valid = np.arange(t)[None, :] < np.array(rows)[:, None]
        valid_j, valid_t = jnp.asarray(valid), torch.from_numpy(valid)
        kw = {"pad_lens": np.array(rows, np.int32)}
    want, _ = JZ._layer_forward(params, jcfg, 0, jnp.asarray(x), None, chunk, None, None,
                                valid_j, kw.get("pad_lens"), chunk_left=kw.get("chunk_left"))
    tkw = {"pad_lens": torch.tensor(rows, dtype=torch.int32)} if not causal else kw
    got, _ = TZ._layer_forward(params_from_numpy(params), tcfg, 0, torch.from_numpy(x), chunk,
                               None, valid_t, **tkw)
    want = np.asarray(want)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(got[i, :r].numpy(), want[i, :r], rtol=1e-4, atol=1e-4)


def test_compact_rel_pos_matches_jax():
    # cos/sin of angles up to ~38 rad in float32: the two libraries' argument
    # reductions differ by a few ulps of the angle
    np.testing.assert_allclose(TZ._compact_rel_pos(37, 37, 48).numpy(),
                               np.asarray(JZ._compact_rel_pos(37, 37, 48)), rtol=1e-5, atol=1e-5)


def test_init_params_has_the_jax_structure():
    from k2transducerasr_tpu.runtime.checkpoint import flatten_params as jflat

    cfg = dict(num_encoder_layers=(1, 2), encoder_dims=(16, 32), downsampling_factors=(1, 2),
               num_heads=(2, 2), feedforward_dims=(32, 48), cnn_module_kernels=(7, 7),
               query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
               embed_channels=(2, 4, 8))
    for causal in (False, True):
        jcfg = JZ.Zipformer2Config(causal=causal, **cfg)
        want = jax.eval_shape(lambda key: JZ.init_params(key, jcfg), jax.random.PRNGKey(0))
        want = jflat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
        want = {k: v.shape for k, v in want.items()}
        got = jflat(TZ.init_params(np.random.default_rng(0),
                                   TZ.Zipformer2Config(causal=causal, **cfg)))
        assert {k: v.shape for k, v in got.items()} == want


def _dec_join(vocab=12, ctx=2, d=16, j=20, enc=24):
    dcfg_j = JD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    jcfg_j = JJ.JoinerConfig(encoder_dim=enc, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    dp = jax.device_get(JD.init_params(jax.random.PRNGKey(1), dcfg_j))
    jp = jax.device_get(JJ.init_params(jax.random.PRNGKey(2), jcfg_j))
    dcfg_t = TD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    jcfg_t = TJ.JoinerConfig(encoder_dim=enc, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    return (dcfg_j, jcfg_j, dp, jp), (dcfg_t, TD.Decoder(dcfg_t, dp), TJ.Joiner(jcfg_t, jp))


def test_decoder_and_joiner_match_jax():
    (dcfg_j, _, dp, jp), (dcfg_t, dec, join) = _dec_join()
    y = np.array([[-1, 0], [3, 7], [11, 2]])
    want = np.asarray(JD.forward(dp, dcfg_j, jnp.asarray(y)))
    got = dec(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tables_j = JD.context_tables(dp, dcfg_j)
    tables_t = TD.context_tables(dec, dcfg_t)
    for a, b in zip(tables_t, tables_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TD.forward_from_tables(tables_t, dcfg_t, torch.from_numpy(y)).numpy(),
        np.asarray(JD.forward_from_tables(tables_j, dcfg_j, jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    enc = np.random.default_rng(4).standard_normal((3, 5, 24)).astype(np.float32)
    ep_j = JJ.project_encoder(jp, enc)
    ep_t = TJ.project_encoder(join, torch.from_numpy(enc))
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5, atol=1e-5)
    dp_j = JJ.project_decoder(jp, JD.forward(dp, dcfg_j, jnp.asarray(y)))
    dp_t = TJ.project_decoder(join, got)
    np.testing.assert_allclose(
        TJ.joint_logits(join, ep_t, dp_t[:, None]).numpy(),
        np.asarray(JJ.joint_logits(jp, ep_j, dp_j[:, None])), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_tokens,window", [(64, 64), (5, 4)], ids=["plain", "full-buffer"])
def test_greedy_skip_matches_jax_and_the_oracle(max_tokens, window):
    (dcfg_j, _, dp, jp), (dcfg_t, dec, join) = _dec_join(vocab=6)
    b, t = 3, 23
    enc_proj = (2 * np.random.default_rng(5).standard_normal((b, t, 20))).astype(np.float32)
    lens = np.array([23, 9, 1], np.int32)
    zero = np.zeros((b,), np.int32)
    st_j = JG.init_state(dp, dcfg_j, jp, b, max_tokens)
    want = JG.greedy_frames_skip(dp, dcfg_j, jp, st_j, jnp.asarray(enc_proj), jnp.asarray(lens),
                                 jnp.asarray(zero), window=window)
    st_t = TG.init_state(dec, dcfg_t, join, b, max_tokens)
    args = (torch.from_numpy(enc_proj), torch.from_numpy(lens).long(), torch.zeros(b).long())
    got = TG.greedy_frames_skip(dec, dcfg_t, join, st_t, *args, window=window)
    oracle = TG.greedy_frames(dec, dcfg_t, join, st_t, *args)
    for name in ("tokens", "timestamps", "count", "trailing_blanks"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(oracle, name).numpy())
    assert int(got.count.sum()) > 0
    assert TG.extract_results(got.tokens, got.timestamps, got.count) == JG.extract_results(
        want.tokens, want.timestamps, want.count)


@pytest.mark.parametrize(
    "symbols,ids",
    [
        (["<blk>", "<sos/eos>", "<unk>", "▁HE", "LLO", "▁WORLD"], [3, 4, 0, 5, -1, 1]),
        (["<blk>", "<sos/eos>", "<unk>", "好", "世", "界"], [3, 4, 5, 2, 3]),
        (["<blk>", "<sos/eos>", "<unk>", "<0xE4>", "<0xBD>", "<0xA0>", "Q"], [3, 4, 5, 6, 3]),
    ],
    ids=["bpe", "cjk", "hex-bytes"],
)
def test_tokens_to_text_matches_jax(symbols, ids):
    assert t_tokens_to_text(ids, TSymbolTable(symbols)) == j_tokens_to_text(
        ids, JSymbolTable(symbols))
