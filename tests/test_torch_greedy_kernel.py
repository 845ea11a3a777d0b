"""The greedy search's kernel module (``decode/rnnt_greedy.py``) on the CPU:
the wrapper's plain version against the JAX package's
``greedy_frames_skip``, its window invariance, chained streaming calls, the
kernel's operands (``greedy_operands``) against the plain ops, each cluster
rank's share of the packed weights (``rank_ranges``), and the
tie-aware replay (``k2transducerasr_tpu_torch/testing.py``).  Inputs come from numpy seeds; nothing draws from torch's
global RNG.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: tokens, timestamps, counts, contexts and trailing blanks
exactly; the decoder output of two chained calls against one call exactly
(the same ops on the same rows); operands against the JAX package's
float32 ops to atol 1e-5 (summation order of the folded tables), against
the port's own ops exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode import rnnt_greedy as JG
from k2transducerasr_tpu.models import decoder as JD
from k2transducerasr_tpu.models import joiner as JJ
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TG
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.testing import _linear, _round_once, tie_aware_replay

FIELDS = ("hyp", "tokens", "timestamps", "count", "trailing_blanks")


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


def _models(vocab=7, ctx=2, d=16, j=20, seed=1):
    """JAX-initialised decoder and joiner (numpy trees), the port's copies,
    with the blank and sos biases raised so that blank runs, skipped sos
    and emissions all occur."""
    dcfg_j = JD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    jcfg_j = JJ.JoinerConfig(encoder_dim=24, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    dp = jax.device_get(JD.init_params(jax.random.PRNGKey(seed), dcfg_j))
    jp = jax.device_get(JJ.init_params(jax.random.PRNGKey(seed + 1), jcfg_j))
    jp["output"]["b"] = np.array(jp["output"]["b"])
    jp["output"]["b"][0] += 0.6
    jp["output"]["b"][1] += 0.4
    dcfg_t = TD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    jcfg_t = TJ.JoinerConfig(encoder_dim=24, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    jax_trees = jax.tree.map(jnp.asarray, (dp, jp))  # context 1: the table itself is traced
    return (dcfg_j, *jax_trees), (dcfg_t, TD.Decoder(dcfg_t, dp), TJ.Joiner(jcfg_t, jp))


def _enc_proj(b, t, j, seed, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal((b, t, j))).astype(np.float32)


def _assert_state_equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("max_tokens", [64, 5], ids=["room", "overflow"])
@pytest.mark.parametrize("extra_skip_sos", [False, True], ids=["offline", "skip-sos"])
@pytest.mark.parametrize("ctx", [1, 2], ids=["ctx1", "ctx2"])
def test_wrapper_on_cpu_matches_jax(ctx, extra_skip_sos, max_tokens):
    """CPU tensors take the plain version: the JAX package's state exactly,
    over a ragged batch with a lane of 0 frames, T below the window, a
    nonzero frame_offset per lane and (``overflow``) a token buffer that
    fills; the launch count does not move."""
    (dcfg_j, dp, jp), (dcfg_t, dec, join) = _models(ctx=ctx)
    b, t = 4, 23
    enc = _enc_proj(b, t, 20, seed=5)
    lens = np.array([23, 9, 0, 17], np.int32)
    offset = np.array([0, 40, 7, 1000], np.int32)
    st_j = JG.init_state(dp, dcfg_j, jp, b, max_tokens)
    want = JG.greedy_frames_skip(dp, dcfg_j, jp, st_j, jnp.asarray(enc), jnp.asarray(lens),
                                 jnp.asarray(offset), extra_skip_sos)
    st_t = TG.init_state(dec, dcfg_t, join, b, max_tokens)
    before = TG.greedy_frames_skip.launches
    got = TG.greedy_frames_skip(dec, dcfg_t, join, st_t, torch.from_numpy(enc),
                                torch.from_numpy(lens).long(), torch.from_numpy(offset).long(),
                                extra_skip_sos)
    assert TG.greedy_frames_skip.launches == before
    _assert_state_equal(got, want)
    np.testing.assert_allclose(got.dec_proj.numpy(), np.asarray(want.dec_proj), atol=1e-5)
    counts = got.count.tolist()
    assert counts[2] == 0 and int(got.trailing_blanks[2]) == 0  # the empty lane
    if max_tokens == 5:
        assert max(counts) == 5
    emitted = torch.cat([got.tokens[i, :n] for i, n in enumerate(counts)])
    assert (1 in emitted.tolist()) != extra_skip_sos  # sos emitted only offline
    assert bool((got.timestamps[1, :counts[1]] >= 40).all())


@pytest.mark.parametrize("window", [1, 3, 64])
def test_plain_version_is_window_invariant(window):
    """The plain version equals the per-frame oracle ``greedy_frames`` for
    every window, so the kernel may group frames as it likes."""
    _, (dcfg, dec, join) = _models(vocab=9)
    b, t = 3, 37
    args = (torch.from_numpy(_enc_proj(b, t, 20, seed=8)), torch.tensor([37, 20, 1]),
            torch.tensor([3, 0, 11]))
    st = TG.init_state(dec, dcfg, join, b, 12)
    got = TG.greedy_frames_skip_reference(dec, dcfg, join, st, *args, True, window=window)
    oracle = TG.greedy_frames(dec, dcfg, join, st, *args, True)
    _assert_state_equal(got, oracle)
    torch.testing.assert_close(got.dec_proj, oracle.dec_proj, rtol=0, atol=0)
    assert int(got.count.sum()) > 3


@pytest.mark.parametrize("split", [1, 16, 30])
def test_two_chained_calls_equal_one_call(split):
    """Streaming: the search over frames [0, split) and then, from its
    state, [split, T) with frame_offset += split equals one call over all T
    frames (lanes shorter than the split finish in the first call)."""
    _, (dcfg, dec, join) = _models()
    b, t = 3, 31
    enc = torch.from_numpy(_enc_proj(b, t, 20, seed=11))
    lens = torch.tensor([31, 22, 9])
    offset = torch.tensor([5, 0, 200])
    st = TG.init_state(dec, dcfg, join, b, 40)
    whole = TG.greedy_frames_skip(dec, dcfg, join, st, enc, lens, offset, True)
    first = TG.greedy_frames_skip(dec, dcfg, join, st, enc[:, :split], lens.clamp(max=split),
                                  offset, True)
    second = TG.greedy_frames_skip(dec, dcfg, join, first, enc[:, split:],
                                   (lens - split).clamp(min=0), offset + split, True)
    _assert_state_equal(second, whole)
    torch.testing.assert_close(second.dec_proj, whole.dec_proj, rtol=0, atol=0)


def _unpack_mma_b(packed):
    """The inverse of ``pack_mma_b``: [Np/8, Kp/16, 32, 4] -> [Kp, Np]."""
    np_, kp = packed.shape[0] * 8, packed.shape[1] * 16
    x = packed.reshape(np_ // 8, kp // 16, 8, 4, 2, 2)  # nt, ks, g, q, h, e
    return x.permute(1, 4, 3, 5, 0, 2).reshape(kp, np_)


def _unpack_chunks(packed):
    """The inverse of ``pack_chunks``: [Np/8, K, 8] -> [K, Np]."""
    n8, k, _ = packed.shape
    return packed.permute(1, 0, 2).reshape(k, n8 * 8)


def _unpack_out_w(w, compute_dtype):
    """W_out's packed n-tiles [n, ...] back to [Jp, 8 n] (either dtype)."""
    return _unpack_chunks(w) if compute_dtype is None else _unpack_mma_b(w)


def test_pack_mma_b_places_each_lanes_fragment():
    """Lane 4g + q of (n-tile, k-step) holds w[k0 + 2q + {0, 1, 8, 9}, n0 + g],
    the register order of mma.m16n8k16's B operand; unpacking inverts it."""
    w = torch.arange(48 * 24, dtype=torch.float32).reshape(48, 24)
    p = TG.pack_mma_b(w)
    assert p.shape == (3, 3, 32, 4)
    for nt, ks, lane in [(0, 0, 0), (2, 1, 13), (1, 2, 31)]:
        g, q = lane // 4, lane % 4
        want = [w[16 * ks + 2 * q + e, 8 * nt + g] for e in (0, 1, 8, 9)]
        assert p[nt, ks, lane].tolist() == [float(x) for x in want]
    assert torch.equal(_unpack_mma_b(p), w)
    assert torch.equal(_unpack_chunks(TG.pack_chunks(w)), w)


def _kernel_math(ops, dcfg, hyp, enc_proj, compute_dtype):
    """What the kernel computes from its operands, written with plain ops:
    the decoder refresh of ``hyp`` [B, C] and the logits of enc_proj [B, J]."""
    v, j = ops.vocab, ops.joiner_dim
    c = ops.tables.shape[0]
    y = torch.where(hyp < 0, dcfg.blank_id, hyp)
    dout = ops.tables[0][y[:, 0]]
    for i in range(1, c):
        dout = dout + ops.tables[i][y[:, i]]
    dout = torch.relu(dout)
    dec_w = _unpack_chunks(ops.dec_w)[:, :j]
    w = _unpack_out_w(ops.out_w, ops.compute_dtype)[:j, :v]
    if compute_dtype is None:
        dec_proj = dout @ dec_w + ops.dec_b[:j]
        logits = torch.tanh(enc_proj + dec_proj) @ w + ops.out_b[:v]
        return dec_proj, logits
    cd = compute_dtype
    dec_proj = ((dout.to(cd) @ dec_w).float() + ops.dec_b[:j]).to(cd)
    x = torch.tanh(enc_proj.to(cd) + dec_proj)
    logits = ((x @ w).float() + ops.out_b[:v]).to(cd)
    return dec_proj, logits


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ctx", [1, 2], ids=["ctx1", "ctx2"])
def test_operands_reproduce_the_plain_ops(ctx, compute_dtype):
    """The folded tables, the weight copies and the packed output weight give
    ``forward_from_tables``, ``project_decoder`` and ``joint_logits``: the
    port's own ops exactly, the JAX package's in float32 to atol 1e-5."""
    (dcfg_j, dp, jp), (dcfg, dec, join) = _models(vocab=21, ctx=ctx, d=24, j=19)
    ops = TG.greedy_operands(dec, dcfg, join, compute_dtype)
    assert ops.tables.shape == (ctx, 21, 24) and ops.dec_w.shape == (4, 24, 8)
    assert ops.out_b.shape == (24,) and ops.vocab == 21 and ops.joiner_dim == 19
    tables = TD.context_tables(dec, dcfg)
    for i, t in enumerate(tables):
        assert torch.equal(ops.tables[i], t)
    hyp = torch.from_numpy(np.random.default_rng(2).integers(-1, 21, (5, ctx)))
    enc = torch.from_numpy(_enc_proj(5, 1, 19, seed=3)[:, 0])
    dec_proj, logits = _kernel_math(ops, dcfg, hyp, enc, compute_dtype)
    want_dp = TJ.project_decoder(join, TD.forward_from_tables(tables, dcfg, hyp), compute_dtype)
    enc_c = enc if compute_dtype is None else enc.to(compute_dtype)
    want_logits = TJ.joint_logits(join, enc_c, want_dp, compute_dtype)
    assert torch.equal(dec_proj, want_dp)
    assert torch.equal(logits, want_logits)
    if compute_dtype is None:
        jt = JD.context_tables(dp, dcfg_j)
        j_dp = JJ.project_decoder(jp, JD.forward_from_tables(jt, dcfg_j, jnp.asarray(hyp.numpy())))
        np.testing.assert_allclose(dec_proj.numpy(), np.asarray(j_dp), atol=1e-5)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(JJ.joint_logits(jp, jnp.asarray(enc.numpy()), j_dp)),
                                   atol=1e-5)


@pytest.mark.parametrize("units", [1, 6, 7, 8, 9, 63, 64, 65, 688])
def test_rank_ranges_own_every_unit_once(units):
    """The CLUSTER ranks' shares tile [0, units) in rank order: contiguous,
    each unit owned by exactly one rank."""
    ranges = TG.rank_ranges(units)
    assert len(ranges) == TG.CLUSTER
    owner = [r for r, (lo, hi) in enumerate(ranges) for _ in range(lo, hi)]
    assert owner == sorted(owner) and len(owner) == units
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("units", [1, 6, 7, 8, 9, 63, 64, 65, 688])
def test_rank_ranges_are_as_even_as_stated(units):
    """Every share holds units // CLUSTER or one more, the larger first
    (V = 500: 63 n-tiles, 8 on ranks 0-6 and 7 on rank 7)."""
    sizes = [hi - lo for lo, hi in TG.rank_ranges(units)]
    base, extra = divmod(units, TG.CLUSTER)
    assert sizes == [base + 1] * extra + [base] * (TG.CLUSTER - extra)
    if units == 63:
        assert sizes == [8] * 7 + [7]


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("vocab,d,j", [(21, 24, 19), (500, 16, 40), (7, 12, 150)],
                         ids=["v21", "v500", "v7-j150"])
def test_rank_shares_reassemble_the_padded_weights(compute_dtype, vocab, d, j):
    """Each rank's W_out n-tiles and decoder_proj chunks (rows lo .. hi of
    rank_ranges of the packed operands, as the kernel's blocks copy them),
    unpacked and put side by side in rank order, are the zero-padded
    weights in the compute dtype; rank r's share covers columns 8 lo ..
    8 hi, each a contiguous block."""
    _, (dcfg, dec, join) = _models(vocab=vocab, d=d, j=j)
    ops = TG.greedy_operands(dec, dcfg, join, compute_dtype)
    jp, vp = -(-j // 16) * 16, -(-vocab // 8) * 8
    wdt = torch.float32 if compute_dtype is None else compute_dtype
    want_w = torch.zeros((jp, vp), dtype=wdt)
    want_w[:j, :vocab] = join["output"]["w"].to(wdt)
    want_d = torch.zeros((d, jp), dtype=wdt)
    want_d[:, :j] = join["decoder_proj"]["w"].to(wdt)
    assert ops.out_w.shape[0] == vp // 8 and ops.dec_w.shape[0] == jp // 8
    shares = [(ops.out_w[wl:wh], ops.dec_w[dl:dh])
              for (wl, wh), (dl, dh) in zip(TG.rank_ranges(vp // 8), TG.rank_ranges(jp // 8))]
    got_w = torch.cat([_unpack_out_w(w, compute_dtype) for w, _ in shares if w.shape[0]], dim=1)
    got_d = torch.cat([_unpack_chunks(c) for _, c in shares if c.shape[0]], dim=1)
    assert torch.equal(got_w, want_w) and torch.equal(got_d, want_d)
    for (w, c), (wl, wh) in zip(shares, TG.rank_ranges(vp // 8)):
        if wh > wl:
            assert torch.equal(_unpack_out_w(w, compute_dtype), want_w[:, 8 * wl:8 * wh])
        assert w.is_contiguous() and c.is_contiguous()


def test_operands_refuse_what_the_kernel_does_not_take():
    _, (dcfg, dec, join) = _models()
    with pytest.raises(ValueError, match="compute_dtype"):
        TG.greedy_operands(dec, dcfg, join, torch.float16)
    small = TD.DecoderConfig(vocab_size=5, decoder_dim=16, context_size=2)
    with pytest.raises(ValueError, match="chain"):
        TG.greedy_operands(TD.Decoder(small, TD.init_params(np.random.default_rng(0), small)),
                           small, join)


def _bf16_search(extra_skip_sos, seed=4):
    """A bf16 plain search over a ragged batch, for the replay: (models,
    initial state, inputs, final state)."""
    _, (dcfg, dec, join) = _models(vocab=11, seed=seed)
    b, t = 3, 29
    enc = torch.from_numpy(_enc_proj(b, t, 20, seed=seed)).to(torch.bfloat16)
    lens, offset = torch.tensor([29, 13, 0]), torch.tensor([0, 64, 3])
    st = TG.init_state(dec, dcfg, join, b, 40, torch.bfloat16)
    final = TG.greedy_frames_skip(dec, dcfg, join, st, enc, lens, offset, extra_skip_sos,
                                  torch.bfloat16)
    return (dec, dcfg, join), st, (enc, lens, offset), final


@pytest.mark.parametrize("change", ["none", "token", "timestamp", "count"])
@pytest.mark.parametrize("extra_skip_sos", [False, True], ids=["offline", "skip-sos"])
def test_tie_aware_replay(extra_skip_sos, change):
    """The replay accepts the plain loop's own bf16 output and rejects it
    after one token is changed (to the frame's lowest logit), one emission
    is moved a frame later, or one count is cut."""
    (dec, dcfg, join), st, (enc, lens, offset), final = _bf16_search(extra_skip_sos)
    n = final.count.tolist()
    assert n[0] > 4 and n[2] == 0
    final = dataclasses.replace(final, tokens=final.tokens.clone(),
                                timestamps=final.timestamps.clone(), count=final.count.clone())
    if change == "token":
        frame = int(final.timestamps[0, 2])
        logits = TJ.joint_logits(join, enc[0, frame], final.dec_proj[0], torch.bfloat16)
        final.tokens[0, 2] = int(logits.float()[3:].argmin()) + 3
    elif change == "timestamp":
        final.timestamps[0, 0] += 1
    elif change == "count":
        final.count[0] -= 1
    got = tie_aware_replay(dec, dcfg, join, st, enc, lens, offset, final, extra_skip_sos,
                           torch.bfloat16)
    if change == "none":
        assert got.ok, got.reason
        assert got.frames == 29 + 13 and got.differing == 0 and got.worst_ulps == 0.0
    else:
        assert not got.ok


def test_tie_aware_replay_allows_a_near_tie():
    """A decision one bf16 ulp below the plain maximum (a near-tie that the
    kernel's summation order may flip) passes at 2 ulps and fails at 0: the
    joiner's output column of another token is made the winner's, its bias
    one ulp lower; the flipped run is the plain search under the bias one
    ulp higher."""
    _, (dcfg, dec, join) = _models(vocab=11, seed=6)
    bf16 = torch.bfloat16
    st = TG.init_state(dec, dcfg, join, 1, 8, bf16)
    frames = torch.from_numpy(_enc_proj(1, 29, 20, seed=6)).to(bf16)
    ys = TJ.joint_logits(join, frames[0], st.dec_proj[0], bf16).float().argmax(-1)
    first = int(((ys != 0) & (ys != 2)).nonzero()[0, 0])  # the first frame that emits
    enc, lens, offset = frames[:, first:first + 1], torch.tensor([1]), torch.tensor([0])
    win = int(ys[first])
    other = 3 if win != 3 else 4

    def joiner(ulps):
        jp = {k: {n: join[k][n].clone() for n in ("w", "b")}
              for k in ("encoder_proj", "decoder_proj", "output")}
        top = TJ.joint_logits(jp, enc[0, 0], st.dec_proj[0], bf16).float()[win]
        jp["output"]["w"][:, other] = jp["output"]["w"][:, win]
        jp["output"]["b"][other] = jp["output"]["b"][win] + ulps * 2.0 ** (
            float(torch.floor(torch.log2(top.abs()))) - 7)
        return jp

    near, swapped = joiner(-1.0), joiner(1.0)
    logits = TJ.joint_logits(near, enc[0, 0], st.dec_proj[0], bf16).float()
    assert int(logits.argmax()) == win and logits[other] < logits[win]
    flipped = TG.greedy_frames_skip(dec, dcfg, swapped, st, enc, lens, offset, False, bf16)
    assert flipped.tokens[0, 0].item() == other and flipped.count.item() == 1
    args = (dec, dcfg, near, st, enc, lens, offset, flipped, False, bf16)
    loose, strict = tie_aware_replay(*args), tie_aware_replay(*args, ulps=0.0)
    assert loose.ok, loose.reason
    assert loose.frames == 1 and loose.differing == 1 and 0 < loose.worst_ulps <= 2.0
    assert not strict.ok


@pytest.mark.parametrize("steps,ok", [(0, True), (1, False), (2, False)],
                         ids=["exact", "neighbour", "two-away"])
def test_tie_aware_replay_rounds_the_product_then_the_bias(steps, ok):
    """bf16 rounds decoder_proj's product before it adds the bias.  Where
    the bias all but cancels the product, one step of the rounded product
    is many ulps of the output: the replay accepts the final decoder output
    built from the plain product, and refuses one built from the product's
    neighbour, or from two neighbours out, beyond its ulps band.  Lane 2
    has no frames, so its final output is the initial one's."""
    _, (dcfg, dec, join) = _models(vocab=11, seed=4)
    bf16 = torch.bfloat16
    jp = {k: {n: join[k][n].clone() for n in ("w", "b")}
          for k in ("encoder_proj", "decoder_proj", "output")}
    hyp0 = torch.full((1, dcfg.context_size), dcfg.blank_id, dtype=torch.int64)
    w_only = {"decoder_proj": {"w": jp["decoder_proj"]["w"]}}
    prod = TJ.project_decoder(w_only, TD.forward_from_tables(TD.context_tables(dec, dcfg), dcfg,
                                                             hyp0), bf16)[0]
    by_conv = TJ.project_decoder(w_only, TD.forward(dec, dcfg, hyp0), bf16)[0]
    col = next(i for i in prod.float().abs().argsort(descending=True).tolist()
               if prod[i] == by_conv[i])  # both decoder paths round it alike
    p0 = float(prod[col])
    jp["decoder_proj"]["b"][col] = -p0 + 2.0 ** (math.floor(math.log2(abs(p0))) - 11)
    enc = torch.from_numpy(_enc_proj(3, 29, 20, seed=4)).to(bf16)
    lens, offset = torch.tensor([29, 13, 0]), torch.tensor([0, 64, 3])
    st = TG.init_state(dec, dcfg, jp, 3, 40, bf16)
    final = TG.greedy_frames_skip(dec, dcfg, jp, st, enc, lens, offset, False, bf16)
    assert int(final.count[0]) > 0 and int(final.count[2]) == 0
    moved = (prod[col:col + 1].view(torch.int16) + steps).view(bf16)
    final.dec_proj[2, col] = (moved.float() + jp["decoder_proj"]["b"][col]).to(bf16)[0]
    want = float(st.dec_proj[2, col])
    off = abs(float(final.dec_proj[2, col]) - want)
    assert off == 0.0 if ok else off > 2 * 2.0 ** -7 * abs(want) + 1e-5
    got = tie_aware_replay(dec, dcfg, jp, st, enc, lens, offset, final, False, bf16)
    assert got.ok == ok, got.reason
    if not ok:
        assert got.reason == "final dec_proj differs"


def test_tie_aware_replay_rounds_each_product_once():
    """The replay's plain bf16 product is the exact sum rounded once to the
    nearest bf16 (ties to even), also just off a midpoint, where rounding
    through float32 first would land on the tie; e.g. 1 + 2^-8 + 2^-30,
    which float32 sums to 1 + 2^-8 and bf16 then rounds down to 1."""
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000))
    lo = x.to(bf16).double()
    hi = (x.to(bf16).view(torch.int16) + 1).view(bf16).double()
    mid = (lo + hi) / 2
    x = torch.cat([x, mid, mid * (1 + 2.0 ** -40), mid * (1 - 2.0 ** -40)])
    got = _round_once(x, bf16)
    for step in (-1, 1):
        other = (got.view(torch.int16) + step).view(bf16).double()
        nearer = (x - got.double()).abs() < (x - other).abs()
        tie = (x - got.double()).abs() == (x - other).abs()
        assert bool((nearer | (tie & (got.view(torch.int16) % 2 == 0))).all())
    assert bool((_round_once(mid * (1 + 2.0 ** -40), bf16).double().abs() > mid.abs()).all())
    xs = torch.tensor([[1.0, 2.0 ** -8, 2.0 ** -15]])
    w = {"w": torch.tensor([[1.0], [1.0], [2.0 ** -15]])}
    assert float(_linear(w, xs, bf16)[0, 0]) == 1 + 2.0 ** -7
