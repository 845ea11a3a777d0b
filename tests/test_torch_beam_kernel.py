"""The beam search's kernel module (``decode/rnnt_beam.py``) on the CPU: the
plain version (``beam_frames_skip_reference``) against the JAX package's
``beam_frames_skip``, the wrapper taking it for CPU tensors, the wrapper's
operand checks for the kernel (on ``meta`` tensors: they raise before any
launch, so no card is needed), the frames' choices it records
(``BeamTrace``), the beam replay (``k2transducerasr_tpu_torch/testing.py``)
and the host mirror of the kernel's shared-memory plan.  Inputs come from
numpy seeds; nothing draws from torch's global RNG.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: tokens, timestamps, counts and contexts exactly; scores to atol
1e-4 (float32 log-probs summed by a cumsum in another order), decoder
outputs to atol 1e-5 (the folded tables' summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode import rnnt_beam as JBeam
from k2transducerasr_tpu.models import decoder as JD
from k2transducerasr_tpu.models import joiner as JJ
from k2transducerasr_tpu_torch.decode import rnnt_beam as TBeam
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TGreedy
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.testing import beam_replay


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


def _models(vocab=9, ctx=2, d=16, j=20, seed=3, blank_bias=0.5):
    """JAX-initialised decoder and joiner (numpy trees) and the port's
    copies; the blank bias raised so that blank runs and emissions both
    occur."""
    dcfg_j = JD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    jcfg = JJ.JoinerConfig(encoder_dim=24, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    dp = jax.device_get(JD.init_params(jax.random.PRNGKey(seed), dcfg_j))
    jp = jax.device_get(JJ.init_params(jax.random.PRNGKey(seed + 1), jcfg))
    jp["output"]["b"] = np.array(jp["output"]["b"])
    jp["output"]["b"][0] += blank_bias
    dcfg_t = TD.DecoderConfig(vocab_size=vocab, decoder_dim=d, context_size=ctx)
    tcfg = TJ.JoinerConfig(encoder_dim=24, decoder_dim=d, joiner_dim=j, vocab_size=vocab)
    jax_trees = jax.tree.map(jnp.asarray, (dp, jp))
    return (dcfg_j, *jax_trees), (dcfg_t, TD.Decoder(dcfg_t, dp), TJ.Joiner(tcfg, jp))


def _enc_proj(b, t, j, seed, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((b, t, j))).astype(np.float32)


def _assert_states_equal(got, want):
    for f in ("hyp", "tokens", "timestamps", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.dec_proj), np.asarray(want.dec_proj), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("max_tokens", [64, 4], ids=["room", "overflow"])
@pytest.mark.parametrize("extra_skip_sos", [False, True], ids=["offline", "skip-sos"])
@pytest.mark.parametrize("k,window", [(4, 64), (3, 5)], ids=["K4-W64", "K3-W5"])
def test_reference_matches_jax(k, window, extra_skip_sos, max_tokens):
    """The plain version against the JAX package's beam_frames_skip: a
    ragged batch with a lane of 0 frames, per-lane frame_offset, windows
    that fold (W5) and (``overflow``) token buffers that fill."""
    (dcfg_j, dp, jp), (dcfg_t, dec, join) = _models()
    b, t = 4, 27
    enc = _enc_proj(b, t, 20, seed=5)
    lens = np.array([27, 11, 0, 19], np.int32)
    offset = np.array([0, 40, 7, 1000], np.int32)
    st_j = JBeam.init_state(dp, dcfg_j, jp, b, k, max_tokens)
    want = JBeam.beam_frames_skip(dp, dcfg_j, jp, st_j, jnp.asarray(enc), jnp.asarray(lens),
                                  jnp.asarray(offset), extra_skip_sos, window=window)
    st_t = TBeam.init_state(dec, dcfg_t, join, b, k, max_tokens)
    got = TBeam.beam_frames_skip_reference(dec, dcfg_t, join, st_t, torch.from_numpy(enc),
                                           torch.from_numpy(lens).long(),
                                           torch.from_numpy(offset).long(), extra_skip_sos,
                                           window=window)
    _assert_states_equal(got, want)
    counts = got.count
    assert int(counts[2].max()) == 0  # the empty lane
    if max_tokens == 4:
        assert int(counts.max()) == 4
    else:
        assert int(counts.max()) > 4
    assert bool((got.timestamps[1][got.tokens[1] != 0] >= 40).all())


def test_wrapper_runs_the_plain_version_on_cpu():
    """CPU tensors: the wrapper is the plain version (the same state and
    trips), and launches nothing."""
    _, (dcfg, dec, join) = _models()
    enc = torch.from_numpy(_enc_proj(3, 21, 20, seed=8))
    args = (enc, torch.tensor([21, 4, 13]), torch.tensor([0, 2, 9]), True)
    st = TBeam.init_state(dec, dcfg, join, 3, 4, 32)
    launches, trips = TBeam.beam_frames_skip.launches, TBeam.beam_frames_skip.trips
    got = TBeam.beam_frames_skip(dec, dcfg, join, st, *args, window=6)
    mid = TBeam.beam_frames_skip.trips
    want = TBeam.beam_frames_skip_reference(dec, dcfg, join, st, *args, window=6)
    assert TBeam.beam_frames_skip.launches == launches
    assert mid - trips == TBeam.beam_frames_skip.trips - mid > 0
    for f in dataclasses.fields(TBeam.BeamState):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def _meta_call(mutate):
    """The kernel's launch path on ``meta`` tensors (no card), with one
    operand or state leaf changed by ``mutate``; every check runs before
    the launch."""
    _, (dcfg, dec, join) = _models()
    ops = TGreedy.greedy_operands(dec, dcfg, join)
    ops = dataclasses.replace(ops, **{f: getattr(ops, f).to("meta") for f in
                                      ("tables", "dec_w", "dec_b", "out_w", "out_b")})
    st = TBeam.init_state(dec, dcfg, join, 2, 4, 8)
    st = TBeam.BeamState(*(x.to("meta") for x in dataclasses.astuple(st)))
    args = dict(ops=ops, dec_cfg=dcfg, state=st, enc_proj=torch.zeros((2, 5, 20), device="meta"),
                enc_lens=torch.tensor([5, 5]).to("meta"), frame_offset=torch.zeros(2).long().to(
                    "meta"), extra_skip_sos=False, compute_dtype=None, window=64, trace=None)
    mutate(args)
    return TBeam._launch_kernel(**args)


@pytest.mark.parametrize("mutate,match", [
    (lambda a: a.update(enc_proj=a["enc_proj"].to(torch.bfloat16)), "must be"),
    (lambda a: a.update(compute_dtype=torch.bfloat16), "operands built for"),
    (lambda a: a.update(state=dataclasses.replace(a["state"], score=a["state"].score.repeat(
        1, 5)[:, :17])), "1..16 beams"),
    (lambda a: a.update(state=dataclasses.replace(a["state"], hyp=a["state"].hyp[:, :, :1])),
     "context"),
    (lambda a: a.update(state=dataclasses.replace(a["state"],
                                                  score=a["state"].score.double())), "float32"),
    (lambda a: a.update(ops=dataclasses.replace(a["ops"], out_b=torch.zeros(16))),
     "enc_proj's device"),
    (lambda a: a.update(trace=TBeam.BeamTrace.empty(2, 4, 4, "meta")), "trace"),
    (lambda a: a.update(ops=dataclasses.replace(a["ops"], out_w=a["ops"].out_w.transpose(
        0, 1))), "contiguous"),
], ids=["frames-dtype", "operands-dtype", "17-beams", "context", "score-dtype", "device",
        "trace-shape", "layout"])
def test_wrapper_checks_the_kernels_operands(mutate, match):
    with pytest.raises(ValueError, match=match):
        _meta_call(mutate)


def _search(compute_dtype, extra_skip_sos, k=4, window=6, seed=4):
    """A plain search over a ragged batch with its trace: (models, initial
    state, inputs, final state, trace)."""
    _, (dcfg, dec, join) = _models(vocab=11, seed=seed, blank_bias=1.0)
    b, t = 3, 29
    enc = torch.from_numpy(_enc_proj(b, t, 20, seed=seed))
    if compute_dtype is not None:
        enc = enc.to(compute_dtype)
    lens, offset = torch.tensor([29, 13, 0]), torch.tensor([0, 64, 3])
    st = TBeam.init_state(dec, dcfg, join, b, k, 40, compute_dtype)
    trace = TBeam.BeamTrace.empty(b, t, k, "cpu")
    final = TBeam.beam_frames_skip(dec, dcfg, join, st, enc, lens, offset, extra_skip_sos,
                                   compute_dtype, window, trace=trace)
    return (dec, dcfg, join), st, (enc, lens, offset), final, trace


@pytest.mark.parametrize("change", ["none", "token", "timestamp", "count", "score", "hyp"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_beam_replay(compute_dtype, change):
    """The replay accepts the plain version's own search (its trace covering
    emission steps, frames without a step and folded windows) and refuses
    it with one field of one beam changed."""
    (dec, dcfg, join), st, (enc, lens, offset), final, trace = _search(compute_dtype, True)
    kinds = trace.fields()[2][torch.arange(29)[None, :] < lens[:, None]][:, 0]
    assert {int(x) for x in kinds.unique()} == {TBeam.STEP_NONE, TBeam.STEP_EMIT, TBeam.STEP_FOLD}
    bad = TBeam.BeamState(*(x.clone() for x in dataclasses.astuple(final)))
    n = int(final.count[0, 1])
    assert n > 1
    if change == "token":
        bad.tokens[0, 1, n - 1] += 1
    elif change == "timestamp":
        bad.timestamps[0, 1, 0] += 1
    elif change == "count":
        bad.count[0, 1] -= 1
    elif change == "score":
        bad.score[0, 1] += 1e-3
    elif change == "hyp":
        bad.hyp[0, 1, 0] += 1
    res = beam_replay(dec, dcfg, join, st, enc, lens, offset, bad, trace, True, compute_dtype,
                      window=6)
    assert res.ok == (change == "none"), res.reason
    if change == "none":
        assert res.frames == 29 + 13 and res.differing == 0


def test_beam_replay_refuses_a_choice_outside_the_band():
    """A trace whose emission step takes a candidate far below the plain top
    K (its recorded token changed) is refused at that frame."""
    (dec, dcfg, join), st, (enc, lens, offset), final, trace = _search(None, False)
    parent, stored, kind, token = trace.fields()
    at = (kind[0, :, 0] == TBeam.STEP_EMIT).nonzero()[0, 0]
    e = trace.steps[0, at, 0]
    trace.steps[0, at, 0] = e + ((1 if int(token[0, at, 0]) != 1 else 2) << 7)
    res = beam_replay(dec, dcfg, join, st, enc, lens, offset, final, trace, False, None, window=6)
    assert not res.ok and f"frame {int(at)}" in res.reason


def test_trace_fields_round_trip():
    steps = torch.tensor([[[(37 << 7) | (TBeam.STEP_EMIT << 5) | (1 << 4) | 3,
                            (0 << 7) | (TBeam.STEP_FOLD << 5) | 15]]], dtype=torch.int32)
    tr = TBeam.BeamTrace(steps, torch.zeros(steps.shape))
    parent, stored, kind, token = tr.fields()
    assert parent.tolist() == [[[3, 15]]] and stored.tolist() == [[[1, 0]]]
    assert kind.tolist() == [[[TBeam.STEP_EMIT, TBeam.STEP_FOLD]]] and token.tolist() == [[[37, 0]]]


def _place(sizes):
    """csrc/rnnt_cluster.cuh's Layout: each part 128-byte aligned after the
    48 bytes of mbarriers; returns the end."""
    at = 48
    for n in sizes:
        at = -(-(at + n) // 128) * 128
    return at


@pytest.mark.parametrize("compute_dtype,beams,vocab", [(torch.bfloat16, 4, 500), (None, 4, 500),
                                                       (torch.bfloat16, 8, 500),
                                                       (torch.bfloat16, 4, 5500)],
                         ids=["bf16-K4", "f32-K4", "bf16-K8", "bf16-V5500"])
def test_plan_bytes_at_the_flagship_shapes(compute_dtype, beams, vocab):
    """The host mirror of the kernel's plan at J = D = 512, context 2, on an
    H100's 227 KB (232,448 bytes) per block: its fixed parts, part by part,
    and where the weights go.  bf16 at K = 4 and 8 holds every weight share
    resident (8 n-tiles and 8 chunks of 8 KB a rank); float32 (16 KB units)
    and V = 5,500 (86 n-tiles a rank) stream."""
    bf = compute_dtype is not None
    p = TBeam.plan_bytes(512, 512, vocab, 2, beams, compute_dtype)
    ntw = -(-(-(-vocab // 8)) // 8)
    fixed = _place([2 * beams * 512 * 4, beams * 512 * 4, 2 * beams * 2 * 4, 1360,
                    2 * 8 * 16 * 16, 2 * 8 * 17 * 8, 16 * 16 * 8, beams * ntw * 8 * 4,
                    16 * 2 * 32 * 16 if bf else 0, ntw * 8 * 4, 8 * 8 * 4,
                    16 * 520 * 2 if bf else beams * 512 * 4])
    assert p["fixed_bytes"] == fixed
    assert p["ntiles_per_rank"] == ntw and p["chunks_per_rank"] == 8
    unit = 8192 if bf else 16384
    if bf and vocab == 500:
        assert (p["res_w"], p["res_d"], p["sw"], p["sd"]) == (8, 8, 0, 0)
        assert p["smem_bytes"] == fixed + 16 * unit
        assert beams != 4 or p["smem_bytes"] == 200192
    else:
        assert p["sw"] or p["sd"]
        assert p["smem_bytes"] <= 232448
        streamed = p["depth"] * (p["sw"] + p["sd"]) * unit
        assert p["smem_bytes"] == fixed + (p["res_w"] + p["res_d"]) * unit + streamed
    # J = 4096 in float32: the decoder outputs' two buffers (128 KB) and the
    # tile (64 KB) leave no room for a stage of each weight
    assert TBeam.plan_bytes(4096, 512, 500, 2, 4, None) is None
