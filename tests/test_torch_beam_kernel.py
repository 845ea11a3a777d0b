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

import hypothesis
import hypothesis.strategies as st
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
    (lambda a: a.update(trace=dataclasses.replace(TBeam.BeamTrace.empty(2, 5, 4, "meta"),
                                                  second=torch.zeros(3, dtype=torch.int32,
                                                                     device="meta"))), "trace"),
], ids=["frames-dtype", "operands-dtype", "17-beams", "context", "score-dtype", "device",
        "trace-shape", "layout", "trace-second"])
def test_wrapper_checks_the_kernels_operands(mutate, match):
    with pytest.raises(ValueError, match=match):
        _meta_call(mutate)


def test_wrapper_refuses_more_lanes_than_the_tile_holds(monkeypatch):
    """The P that the launch shape gives is checked: 5 lanes of 4 beams
    are more rows than the tile's 16."""
    monkeypatch.setattr(TBeam, "kernel_lanes", lambda *a, **kw: dict(lanes=5))
    with pytest.raises(ValueError, match="lanes_per_cluster must be 1..4"):
        _meta_call(lambda a: None)


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


@pytest.mark.parametrize("lanes", [1, 2], ids=["P1", "P2"])
@pytest.mark.parametrize("compute_dtype,beams,vocab", [(torch.bfloat16, 4, 500), (None, 4, 500),
                                                       (torch.bfloat16, 8, 500),
                                                       (torch.bfloat16, 4, 5500)],
                         ids=["bf16-K4", "f32-K4", "bf16-K8", "bf16-V5500"])
def test_plan_bytes_at_the_flagship_shapes(compute_dtype, beams, vocab, lanes):
    """The host mirror of the kernel's plan at J = D = 512, context 2, on an
    H100's 227 KB (232,448 bytes) per block, with ``lanes`` lanes a cluster
    (P; the tile's rows R = P K): its fixed parts, part by part (the beam's
    mbarriers, each lane's two buffers of decoder outputs in the compute
    dtype, the contexts, the beam state, the exchange's partials and lists,
    the second exchange's lists, the rows' best candidates, the warps' top-K
    slots, the logits, the biases, and one region for the tile with the bf16 scratch or the
    emitters' decoder outputs), and where the weights go.  bf16 at K = 4 and
    8 holds every weight share resident (8 n-tiles and 8 chunks of 8 KB a
    rank), at P = 2 too; float32 (16 KB units) and V = 5,500 (86 n-tiles a
    rank) stream."""
    bf = compute_dtype is not None
    p = TBeam.plan_bytes(512, 512, vocab, 2, beams, compute_dtype, lanes=lanes)
    ntw = -(-(-(-vocab // 8)) // 8)
    rows = lanes * beams
    tile = 16 * 520 * 2 if bf else (4 if rows <= 4 else 8 if rows <= 8 else 16) * 512 * 4
    fixed = _place([6 * 8, lanes * 2 * beams * 512 * (2 if bf else 4), lanes * 2 * beams * 2 * 4,
                    1984, 2 * 8 * rows * 16, 2 * 8 * rows * beams * 8, 2 * 8 * lanes * beams * 8,
                    rows * beams * 8, 16 * 16 * 8, rows * ntw * 8 * 4, ntw * 8 * 4, 8 * 8 * 4,
                    max(-(-tile // 128) * 128 + (16 * 2 * 32 * 16 if bf else 0), rows * 512 * 4,
                        16 * 520 * 2 if bf else 0)])
    assert p["fixed_bytes"] == fixed
    assert p["ntiles_per_rank"] == ntw and p["chunks_per_rank"] == 8
    unit = 8192 if bf else 16384
    if bf and vocab == 500:
        assert (p["res_w"], p["res_d"], p["sw"], p["sd"]) == (8, 8, 0, 0)
        assert p["smem_bytes"] == fixed + 16 * unit
        assert beams != 4 or p["smem_bytes"] == {1: 181888, 2: 194816}[lanes]
    else:
        assert p["sw"] or p["sd"]
        assert p["smem_bytes"] <= 232448
        streamed = p["depth"] * (p["sw"] + p["sd"]) * unit
        assert p["smem_bytes"] == fixed + (p["res_w"] + p["res_d"]) * unit + streamed
    # J = 4096 in float32: the decoder outputs' two buffers (128 KB) and the
    # tile (64 KB) leave no room for a stage of each weight
    assert TBeam.plan_bytes(4096, 512, 500, 2, 4, None) is None


@pytest.mark.parametrize("batch,beams,at_once,want", [
    (16, 4, {1: 15, 2: 15, 3: 14, 4: 14}, 2),   # the flagship: 8 clusters, one wave
    (15, 4, {1: 15, 2: 15, 3: 14, 4: 14}, 1),   # one lane a cluster already fits
    (1, 4, {1: 15, 2: 15, 3: 14, 4: 14}, 1),
    (16, 16, {1: 15}, 1),                       # 16 beams fill the tile
    (16, 8, {1: 15, 2: 15}, 2),
    (64, 4, {1: 15, 2: 15, 3: 14, 4: 14}, 3),   # no P gives one wave: the fewest waves
    (200, 1, {p: 15 for p in range(1, 17)}, 14),
    (40, 4, {1: 15, 2: 0}, 1),                  # P = 2's plan does not fit
], ids=["B16-K4", "B15-K4", "B1", "K16", "K8", "B64-K4", "B200-K1", "no-fit"])
def test_lanes_per_cluster(batch, beams, at_once, want):
    """P, the lanes a cluster carries: the fewest that run the batch in one
    wave of clusters, at most 16 // K; else the fewest waves."""
    assert TBeam.lanes_per_cluster(batch, beams, lambda p: at_once.get(p, 0)) == want


# -- the kernel's one-exchange selection rule, mirrored on the host

def _one_exchange(values, logits, forbid, k):
    """The kernel's K best of the candidates ``values`` [rows, V] (rows in
    the beams' sorted order, flat index i V + v; ``forbid`` [V] the columns
    at NEG_INF), its way: each of the 8 ranks' column shares
    (rnnt_greedy.rank_ranges) pushes, per row, its K best columns by
    (logit descending, column ascending, the forbidden ones after every
    allowed one); every rank takes each row's K best of the pushed by
    (value, column), then the K best of the rows' by (value, flat index);
    the frame is ambiguous where a rank's list for a row is full (the rank
    has more than K columns) and its last value is not below the K-th
    chosen, and then the second exchange (each rank's K best by (value,
    flat index) over all its columns, merged) decides.  Returns (values,
    flat indices, ambiguous, the first exchange's answer was right)."""
    rows, v = values.shape
    val = values.tolist()
    cols = [range(lo * 8, min(hi * 8, v)) for lo, hi in TGreedy.rank_ranges(-(-v // 8))]

    def by_logit(i, c):
        return (bool(forbid[c]), 0.0 if forbid[c] else -float(logits[i, c]), c)

    def by_value(i, c):
        return (-val[i][c], i * v + c)

    lists = {(q, i): sorted(cols[q], key=lambda c: by_logit(i, c))[:k]
             for q in range(8) for i in range(rows)}
    rows_best = [sorted((c for q in range(8) for c in lists[q, i]), key=lambda c: by_value(i, c))
                 [:k] for i in range(rows)]
    chosen = sorted(((i, c) for i in range(rows) for c in rows_best[i]),
                    key=lambda ic: by_value(*ic))[:k]
    v_k = val[chosen[-1][0]][chosen[-1][1]]
    ambiguous = any(len(cols[q]) > k and not val[i][lists[q, i][-1]] < v_k
                    for q in range(8) for i in range(rows))
    fast = [i * v + c for i, c in chosen]
    if ambiguous:
        per_rank = [sorted(((i, c) for i in range(rows) for c in cols[q]),
                           key=lambda ic: by_value(*ic))[:k] for q in range(8)]
        chosen = sorted((ic for q in per_rank for ic in q), key=lambda ic: by_value(*ic))[:k]
    flat = [i * v + c for i, c in chosen]
    return [val[i][c] for i, c in chosen], flat, ambiguous, fast == flat


def _candidates(base, logits, forbid):
    """float32 values as the kernel computes them: base + ((logit - M) -
    lse), base + NEG_INF at a forbidden column."""
    lg = torch.from_numpy(np.asarray(logits, np.float32))
    m = lg.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(lg - m).sum(dim=1, keepdim=True))
    b = torch.from_numpy(np.asarray(base, np.float32))[:, None]
    return torch.where(torch.from_numpy(forbid)[None, :], b + torch.tensor(TBeam.NEG_INF),
                       b + ((lg - m) - lse))


def _forbidden(v, skip_sos):
    ids = np.arange(v)
    return (ids == 2) | ((ids == 1) & skip_sos)


def _check_rule(base, logits, k, skip_sos):
    forbid = _forbidden(logits.shape[1], skip_sos)
    values = _candidates(base, logits, forbid)
    got_v, got_i, ambiguous, fast_ok = _one_exchange(values, logits, forbid, k)
    want_v, want_i = TBeam._top_k(values.reshape(-1), k)
    assert got_i == want_i.tolist()
    assert got_v == want_v.tolist()
    return ambiguous, fast_ok


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
@hypothesis.given(seed=st.integers(0, 2**32 - 1), k=st.integers(1, 16), v=st.integers(3, 160),
                  scale=st.sampled_from([1e-6, 1.0, 30.0]), offset=st.sampled_from([0.0, 4096.0]),
                  dead=st.integers(0, 3), skip_sos=st.booleans())
def test_one_exchange_rule_equals_the_full_top_k(seed, k, v, scale, offset, dead, skip_sos):
    """Drawn beams and vocabularies (V from 3, so that fewer than 8 K and
    fewer than K allowed columns occur), logits from near-equal to spread,
    scores near 0 or near 4,096, dead beams at NEG_INF: the rule gives
    _top_k's K best of the whole [K, V] exactly, fallback included."""
    rng = np.random.default_rng(seed)
    base = -offset - rng.uniform(0, 20, k)
    base[k - min(dead, k - 1):] = TBeam.NEG_INF
    _check_rule(base.astype(np.float32), (scale * rng.standard_normal((k, v))).astype(np.float32),
                k, skip_sos)


def _collapsed(k, v=500, cols=range(200, 206)):
    """Scores near 4,096, and row 0's best logits in one rank's share
    (columns 200-205, rank 3), each one float32 ulp above the last: their
    values collapse into one (a score's ulp there is ~4.9e-4), so the list
    by logit (the highest columns) is not the K best by (value, column)."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((k, v)).astype(np.float32)
    top = np.float32(8.0)
    for c in cols:
        logits[0, c] = top
        top = np.nextafter(top, np.float32(9.0))
    forbid = _forbidden(v, False)
    for shift in np.arange(0, 4, 0.25):
        base = np.full(k, -4095.0 - shift, np.float32)
        base[1:] -= 30.0
        vals = _candidates(base, logits, forbid)[0, list(cols)]
        if bool((vals == vals[0]).all()):
            return base, logits
    raise AssertionError("no score collapses the six values")


@pytest.mark.parametrize("k", [1, 4, 5])
def test_one_exchange_rule_at_a_collapsed_cut(k):
    """Where two logits give one value, a candidate a rank did not push can
    belong in the K best: the check fires, the first exchange's answer is
    wrong, and the second exchange gives the exact one."""
    base, logits = _collapsed(k)
    ambiguous, fast_ok = _check_rule(base, logits, k, False)
    assert ambiguous and not fast_ok


@pytest.mark.parametrize("k", [4, 16])
def test_one_exchange_rule_with_equal_logits_across_ranks(k):
    """The same best logit in columns of four ranks, in every row: ties by
    flat index across the ranks' lists."""
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((k, 500)).astype(np.float32)
    logits[:, [10, 100, 300, 450]] = 6.0
    base = (-4096.0 - rng.uniform(0, 1, k)).astype(np.float32)
    _check_rule(base, logits, k, False)


@pytest.mark.parametrize("v,k,fires", [(5, 4, True), (8, 7, True), (5, 16, False),
                                       (12, 16, False)])
def test_one_exchange_rule_where_forbidden_columns_enter(v, k, fires):
    """V < 8 K: ranks own few columns or none.  One live beam and the rest
    at NEG_INF under extra_skip_sos, fewer allowed columns than K: the live
    beam's forbidden columns (at base + NEG_INF) tie the dead beams' allowed
    ones and enter the K best by flat index, exactly.  The check fires
    where rank 0 holds more than K columns (its list of the live row ends
    on a forbidden column at the cut); where every rank holds K or fewer,
    every candidate was pushed and it stays quiet."""
    rng = np.random.default_rng(v + k)
    base = np.full(k, TBeam.NEG_INF, np.float32)
    base[0] = -3.0
    logits = rng.standard_normal((k, v)).astype(np.float32)
    forbid = _forbidden(v, True)
    values = _candidates(base, logits, forbid)
    flat = TBeam._top_k(values.reshape(-1), k)[1]
    assert bool(torch.isin(flat, torch.tensor([1, 2])).any())
    ambiguous, _ = _check_rule(base, logits, k, True)
    assert ambiguous == fires


@pytest.mark.parametrize("seed", range(4))
def test_one_exchange_rule_is_quiet_on_generic_frames(seed):
    """Spread logits and distinct scores: one exchange decides."""
    rng = np.random.default_rng(100 + seed)
    base = (-rng.uniform(0, 200, 4)).astype(np.float32)
    ambiguous, fast_ok = _check_rule(base, (2 * rng.standard_normal((4, 500))).astype(np.float32),
                                     4, False)
    assert not ambiguous and fast_ok
