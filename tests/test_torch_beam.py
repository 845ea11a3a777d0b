"""The port's modified beam search (``decode/rnnt_beam.py``), its n-best and
hotwords, and both recognizers under ``modified_beam_search``, against the
JAX package on the CPU, inputs from numpy seeds and the committed pin dirs.

Tolerances: beam tokens, timestamps, counts and contexts are compared
exactly; scores to float32 atol 1e-4 and projected decoder outputs to atol
1e-5 (the skip sums blank log-probs with a cumsum whose order differs
between XLA and PyTorch); recognizer results (text, tokens, timestamps of
every n-best hypothesis) exactly, at float32.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode import rnnt_beam as JBeam
from k2transducerasr_tpu.models import decoder as JD
from k2transducerasr_tpu.models import joiner as JJ
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.decode import rnnt_beam as TBeam
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TGreedy
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy
from k2transducerasr_tpu_torch.text import apply_hotwords, boost_tokens
from test_beam_oracle import ENC as ORACLE_ENC
from test_beam_oracle import _params as oracle_params
from test_beam_oracle import oracle_modified_beam_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
FAMILIES = ("zipformer2", "conformer")
BEAM = dict(decoding_method="modified_beam_search", compute_dtype=None, max_active_paths=4)


def _chip_smoke():
    """chip_smoke.py's module (it holds the beam pins the card checks)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


# -- the search functions ----------------------------------------------------


def _models(seed, vocab=8, enc_dim=16, dec_dim=12, join_dim=10, blank_bias=0.0,
            suppress_unk=True):
    """tests/test_beam.py's toy decoder and joiner: (JAX trees, port trees,
    decoder config of each)."""
    kd, kj = jax.random.split(jax.random.PRNGKey(seed))
    jcfg = JD.DecoderConfig(vocab_size=vocab, decoder_dim=dec_dim, context_size=2)
    dp = jax.device_get(JD.init_params(kd, jcfg))
    jp = jax.device_get(JJ.init_params(kj, JJ.JoinerConfig(enc_dim, dec_dim, join_dim, vocab)))
    b = np.array(jp["output"]["b"])
    b[0] += blank_bias
    if suppress_unk:
        b[2] -= 100.0  # <unk> never the argmax, so greedy and beam 1 agree
    jp["output"]["b"] = b
    tcfg = TD.DecoderConfig(vocab_size=vocab, decoder_dim=dec_dim, context_size=2)
    return (dp, jp, jcfg), (params_from_numpy(dp), params_from_numpy(jp), tcfg)


def _enc(seed, b, t, d=16):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _assert_states_equal(got, want):
    """A port BeamState against a JAX (or port) one: the int fields and the
    contexts exactly, scores to 1e-4, decoder projections to 1e-5."""
    for f in ("hyp", "tokens", "timestamps", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.dec_proj), np.asarray(want.dec_proj), rtol=0,
                               atol=1e-5)


def _run_all(seed, blank_bias, k, window, extra_skip_sos, lens, offs, max_tokens=64, t=50):
    (dp, jp, jcfg), (tdp, tjp, tcfg) = _models(seed, blank_bias=blank_bias,
                                                suppress_unk=not extra_skip_sos)
    enc = _enc(seed + 100, len(lens), t)
    lens_np, offs_np = np.array(lens, np.int32), np.array(offs, np.int32)
    j_proj = JJ.project_encoder(jp, jnp.asarray(enc))
    j0 = JBeam.init_state(dp, jcfg, jp, len(lens), k, max_tokens)
    want = JBeam.beam_frames_skip(dp, jcfg, jp, j0, j_proj, jnp.asarray(lens_np),
                                  jnp.asarray(offs_np), extra_skip_sos, window=window)
    t_proj = TJ.project_encoder(tjp, torch.from_numpy(enc))
    t0 = TBeam.init_state(tdp, tcfg, tjp, len(lens), k, max_tokens)
    lens_t, offs_t = torch.from_numpy(lens_np), torch.from_numpy(offs_np)
    scan = TBeam.beam_frames(tdp, tcfg, tjp, t0, t_proj, lens_t, offs_t, extra_skip_sos)
    skip = TBeam.beam_frames_skip(tdp, tcfg, tjp, t0, t_proj, lens_t, offs_t, extra_skip_sos,
                                  window=window)
    return want, scan, skip, t0


BEAM_CASES = [
    # seed, blank bias, K, window, extra_skip_sos, lens, frame offsets, max_tokens
    pytest.param(11, 0.0, 4, 64, False, [50, 23, 41], [0, 5, 0], 64, id="dense-K4-W64"),
    pytest.param(12, 3.0, 4, 4, False, [50, 23, 41], [0, 5, 0], 64, id="mixed-K4-W4"),
    pytest.param(13, 8.0, 4, 64, True, [50, 0, 41], [0, 0, 7], 64, id="sparse-sos-zero-lane"),
    pytest.param(14, 3.0, 2, 4, True, [50, 31], [3, 0], 64, id="K2-W4-sos"),
    pytest.param(15, 0.0, 1, 64, False, [50, 17], [0, 0], 64, id="K1"),
    pytest.param(16, 0.0, 4, 4, False, [50, 30], [0, 0], 5, id="full-token-buffer"),
]


@pytest.mark.parametrize("seed,bias,k,window,sos,lens,offs,max_tokens", BEAM_CASES)
def test_skip_equals_scan_and_jax(seed, bias, k, window, sos, lens, offs, max_tokens):
    want, scan, skip, t0 = _run_all(seed, bias, k, window, sos, lens, offs, max_tokens)
    _assert_states_equal(scan, want)
    _assert_states_equal(skip, want)
    if 0 in lens:  # a zero-length lane keeps its initial beams
        i = lens.index(0)
        for f in dataclasses.fields(t0):
            torch.testing.assert_close(getattr(skip, f.name)[i], getattr(t0, f.name)[i])
    if max_tokens < 50:
        assert int(skip.count.max()) == max_tokens  # a buffer filled, and stayed in range


def test_beam1_equals_greedy():
    _, (tdp, tjp, tcfg) = _models(1)
    enc = torch.from_numpy(_enc(2, 3, 25))
    lens = torch.tensor([25, 13, 25])
    proj = TJ.project_encoder(tjp, enc)
    g0 = TGreedy.init_state(tdp, tcfg, tjp, 3)
    g = TGreedy.greedy_frames_skip(tdp, tcfg, tjp, g0, proj, lens, torch.zeros(3, dtype=torch.long))
    b = TBeam.rnnt_beam_search(tdp, tcfg, tjp, enc, lens, num_active_paths=1)
    want = TGreedy.extract_results(g.tokens, g.timestamps, g.count)
    assert TGreedy.extract_results(*b) == want and sum(len(t) for t, _ in want) > 0


def test_chunked_equals_whole():
    """The streaming shape: beam_frames_skip over chunks with frame offsets
    == beam_frames over the whole utterance."""
    _, (tdp, tjp, tcfg) = _models(31, blank_bias=4.0)
    proj = TJ.project_encoder(tjp, torch.from_numpy(_enc(32, 2, 24)))
    st = TBeam.init_state(tdp, tcfg, tjp, 2, 4)
    want = TBeam.beam_frames(tdp, tcfg, tjp, st, proj, torch.tensor([24, 24]),
                             torch.zeros(2, dtype=torch.long))
    for c in range(0, 24, 8):
        st = TBeam.beam_frames_skip(tdp, tcfg, tjp, st, proj[:, c:c + 8], torch.tensor([8, 8]),
                                    torch.tensor([c, c]))
    _assert_states_equal(st, want)


@pytest.mark.parametrize("k,sos", [(4, False), (2, True)], ids=["K4", "K2-sos"])
def test_matches_the_numpy_oracle(k, sos):
    """tests/test_beam_oracle.py's host-side modified beam search."""
    dec, join = oracle_params(0 if k == 4 else 7)
    rng = np.random.default_rng(1 if k == 4 else 2)
    enc = (rng.standard_normal((3, 17, ORACLE_ENC)) * 2.0).astype(np.float32)
    lens = np.array([17, 9, 13], np.int32)
    tdec, tjoin = params_from_numpy(jax.device_get(dec)), params_from_numpy(jax.device_get(join))
    tcfg = TD.DecoderConfig(vocab_size=23, decoder_dim=16, context_size=2)
    got = TGreedy.extract_results(*TBeam.rnnt_beam_search(
        tdec, tcfg, tjoin, torch.from_numpy(enc), torch.from_numpy(lens), num_active_paths=k,
        max_tokens=64, extra_skip_sos=sos))
    for i in range(3):
        toks, ts, _ = oracle_modified_beam_search(dec, join, enc[i], int(lens[i]), k=k,
                                                  extra_skip_sos=sos)
        assert got[i] == (toks, ts), i


def test_top_k_breaks_ties_as_jax():
    row = np.array([[0, 1, 1, 1, -1e30, -1e30, 1, 0.5]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 4)
    got_v, got_i = TBeam._top_k(torch.from_numpy(row), 4)
    assert got_i.tolist() == np.asarray(want_i).tolist() == [[1, 2, 3, 6]]
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("sos", [False, True], ids=["offline-rule", "online-rule"])
def test_tied_candidates_follow_jax(sos):
    """Equal logits everywhere (zero output weights, equal biases past the
    blank): every frame's K*V candidates tie across the K-th slot, and the
    dead beams tie at NEG_INF.  Parents, tokens and the n-best order must
    be JAX's."""
    (dp, jp, jcfg), _ = _models(41, vocab=9, suppress_unk=False)
    jp["output"]["w"] = np.zeros_like(jp["output"]["w"])
    jp["output"]["b"] = np.array([0.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    tdp, tjp = params_from_numpy(dp), params_from_numpy(jp)
    tcfg = TD.DecoderConfig(vocab_size=9, decoder_dim=12, context_size=2)
    enc = _enc(42, 2, 12)
    lens = np.array([12, 7], np.int32)
    offs = np.zeros(2, np.int32)
    j0 = JBeam.init_state(dp, jcfg, jp, 2, 4, 32)
    want = JBeam.beam_frames_skip(dp, jcfg, jp, j0, JJ.project_encoder(jp, jnp.asarray(enc)),
                                  jnp.asarray(lens), jnp.asarray(offs), sos, window=4)
    t0 = TBeam.init_state(tdp, tcfg, tjp, 2, 4, 32)
    args = (TJ.project_encoder(tjp, torch.from_numpy(enc)), torch.from_numpy(lens),
            torch.from_numpy(offs), sos)
    skip = TBeam.beam_frames_skip(tdp, tcfg, tjp, t0, *args, window=4)
    _assert_states_equal(skip, want)
    _assert_states_equal(TBeam.beam_frames(tdp, tcfg, tjp, t0, *args), want)
    assert len({tuple(r) for r in np.asarray(want.tokens)[0].tolist()}) == 4  # the ties mattered
    for g, w in zip(TBeam.nbest_beams(skip), JBeam.nbest_beams(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_best_and_nbest_order_follow_jax():
    """Tied scores: the best beam is the first maximum, the n-best a stable
    descending order."""
    score = np.array([[-1.0, 0.0, 0.0, -1e30], [-1e30, -1e30, -2.0, -2.0],
                      [0.5, 0.5, 0.5, 0.5]], np.float32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 9, (3, 4, 6))
    ts = rng.integers(0, 20, (3, 4, 6))
    count = rng.integers(0, 7, (3, 4))
    t = TBeam.BeamState(None, None, torch.from_numpy(score), torch.from_numpy(tokens),
                        torch.from_numpy(ts), torch.from_numpy(count))
    j = JBeam.BeamState(None, None, jnp.asarray(score), jnp.asarray(tokens, jnp.int32),
                        jnp.asarray(ts, jnp.int32), jnp.asarray(count, jnp.int32))
    for g, w in zip(TBeam.best_beam(t) + TBeam.nbest_beams(t),
                    JBeam.best_beam(j) + JBeam.nbest_beams(j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hotword_helpers_match_jax():
    from k2transducerasr_tpu.text import hotwords as JH

    nbest = ["the cat sat", "the Kat sat", "a kat kat", ""]
    for hw in ([], ["kat"], ["KAT", "sat"], ["dog"]):
        assert apply_hotwords(nbest, hw) == JH.apply_hotwords(nbest, hw)
    assert apply_hotwords([], ["x"]) == JH.apply_hotwords([], ["x"]) == ""
    toks = [["a", "b"], ["a", "c", "d"], ["c", "d", "e"]]
    for hw in ([["c", "d"]], [["a", "b"]], [["z"]], [[]]):
        assert boost_tokens(toks[0], hw, toks[1:]) == JH.boost_tokens(toks[0], hw, toks[1:])


# -- the recognizers on the pin dirs -------------------------------------------


@pytest.fixture(scope="module")
def bundles():
    """family -> (JAX bundle, port bundle) of the pin dirs."""
    return {f: (JBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin")),
                ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin"), device="cpu"))
            for f in FAMILIES}


@pytest.fixture(scope="module")
def beam_pins():
    return _chip_smoke().BEAM_PINS


def _nbest(results):
    return [(r.text, r.tokens, r.timestamps) for r in results]


@pytest.mark.parametrize("family", FAMILIES)
def test_offline_nbest_matches_jax_and_the_beam_pin(bundles, beam_pins, family):
    jb, tb = bundles[family]
    pcms = [_pcm(6400), _pcm(4100, 3)]  # a ragged batch
    jrec = JOffline(jb, **BEAM)
    trec = OfflineRecognizer(tb, device="cpu", **BEAM)
    want, got = [], []
    for rec, out in ((jrec, want), (trec, got)):
        streams = []
        for x in pcms:
            s = rec.create_offline_stream()
            s.add_samples(x)
            streams.append(s)
        out.extend(_nbest(n) for n in rec.get_nbest_results(streams))
        out.append(_nbest(rec.get_results(streams)))
    assert got == want
    assert [g[0] for g in got[:2]] == got[2]  # the best result is n-best entry 0
    assert _pinned_from(got[0]) == beam_pins[family]["offline"]


def _pinned_from(nbest):
    return [(text, stamps) for text, _, stamps in nbest]


def _feed_nbest(rec, stream, pcm, feed=800):
    """800-sample feeds, get_nbest_results after each, then the tail flush;
    every n-best list."""
    out = []
    for i in range(0, len(pcm), feed):
        stream.add_samples(pcm[i:i + feed])
        out.append(_nbest(rec.get_nbest_results([stream])[0]))
    stream.input_finished()
    while not stream.is_finished:
        out.append(_nbest(rec.get_nbest_results([stream])[0]))
    out.append(_nbest(rec.get_nbest_results([stream])[0]))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_online_nbest_matches_jax_after_every_step(bundles, beam_pins, family):
    jb, tb = bundles[family]
    jrec = JOnline(jb, max_lanes=2, **BEAM)
    trec = OnlineRecognizer(tb, max_lanes=2, device="cpu", **BEAM)
    want = _feed_nbest(jrec, jrec.create_online_stream(), _pcm(6400))
    got = _feed_nbest(trec, trec.create_online_stream(), _pcm(6400))
    assert got == want and len(got) > 8
    assert _pinned_from(got[-1]) == beam_pins[family]["online"]
    s = trec.create_online_stream()
    s.add_samples(_pcm(6400))
    assert trec.decode_to_end(s).text == got[-1][0][0]


def test_offline_hotwords_flip_the_result(bundles):
    _, tb = bundles["zipformer2"]
    rec = OfflineRecognizer(tb, device="cpu", **BEAM)
    s = rec.create_offline_stream()
    s.add_samples(_pcm(6400))
    nbest = rec.get_nbest_results([s])[0]
    target = next(c for c in nbest[1:] if c.text and c.text != nbest[0].text)
    hw = OfflineRecognizer(tb, device="cpu", hotwords=[target.text], **BEAM)
    s2 = hw.create_offline_stream()
    s2.add_samples(_pcm(6400))
    res = hw.get_result(s2)
    assert (res.text, res.timestamps) == (target.text, target.timestamps)
    assert s2.result is res


def test_online_hotwords_flip_the_result(bundles):
    _, tb = bundles["conformer"]
    rec = OnlineRecognizer(tb, max_lanes=2, device="cpu", **BEAM)
    pcm = _pcm(6400)
    s = rec.create_online_stream()
    s.add_samples(pcm)
    while s._ready():
        nbest = rec.get_nbest_results([s])[0]
    target = next(c for c in nbest[1:] if c.text and c.text != nbest[0].text)
    hw = OnlineRecognizer(tb, max_lanes=2, device="cpu", hotwords=[target.text], **BEAM)
    s2 = hw.create_online_stream()
    s2.add_samples(pcm)
    while s2._ready():
        res = hw.get_results([s2])[0]
    assert res.text == target.text and res.text != nbest[0].text


def test_hotwords_without_beam_search_raise(bundles):
    _, tb = bundles["zipformer2"]
    with pytest.raises(ValueError, match="hotwords"):
        OfflineRecognizer(tb, device="cpu", hotwords=["x"])
    with pytest.raises(ValueError, match="hotwords"):
        OnlineRecognizer(tb, device="cpu", hotwords=["x"])
    with pytest.raises(ValueError, match="modified_beam_search"):
        OfflineRecognizer(tb, device="cpu").get_nbest_results([])
    with pytest.raises(ValueError, match="modified_beam_search"):
        OnlineRecognizer(tb, device="cpu").get_nbest_results([])


def test_windows_per_step_3_equals_1(bundles):
    _, tb = bundles["zipformer2"]

    def run(wps):
        rec = OnlineRecognizer(tb, max_lanes=2, windows_per_step=wps, device="cpu", **BEAM)
        sa, sb = rec.create_online_stream(), rec.create_online_stream()
        sa.add_samples(_pcm(rec.window_samples + 5 * rec.hop_samples, 21))
        sb.add_samples(_pcm(rec.window_samples + 2 * rec.hop_samples, 22))
        while sa._ready() or sb._ready():
            rec.get_results([sa, sb])
        return [_nbest(n) for n in rec.get_nbest_results([sa, sb])]

    assert run(3) == run(1)


def test_snapshot_carries_a_beam_stream_across_packages(bundles):
    jb, tb = bundles["zipformer2"]
    pcm = _pcm(6400)
    jrec = JOnline(jb, max_lanes=2, **BEAM)
    js = jrec.create_online_stream()
    js.add_samples(pcm[:4000])
    while js._ready():
        jrec.get_results([js])
    snap = jrec.snapshot_stream(js)
    js.add_samples(pcm[4000:])
    jrec.decode_to_end(js)
    want = _nbest(jrec.get_nbest_results([js])[0])

    trec = OnlineRecognizer(tb, max_lanes=3, device="cpu", **BEAM)
    trec.create_online_stream()  # occupy a lane: the restore lands in another
    ts = trec.restore_stream(snap)
    assert isinstance(trec._dec_state, TBeam.BeamState)
    ts.add_samples(pcm[4000:])
    trec.decode_to_end(ts)
    assert _nbest(trec.get_nbest_results([ts])[0]) == want

    ts = trec.create_online_stream()
    ts.add_samples(pcm[:4000])
    while ts._ready():
        trec.get_results([ts])
    psnap = trec.snapshot_stream(ts)
    psnap["dec"] = JBeam.BeamState(**dataclasses.asdict(psnap["dec"]))
    js = jrec.restore_stream(psnap)
    js.add_samples(pcm[4000:])
    jrec.decode_to_end(js)
    assert _nbest(jrec.get_nbest_results([js])[0]) == want


def test_beam_is_endpoint_is_false(bundles):
    _, tb = bundles["conformer"]
    rec = OnlineRecognizer(tb, max_lanes=2, enable_endpoint=True, device="cpu", **BEAM)
    s = rec.create_online_stream()
    s.add_samples(np.concatenate([_pcm(6400), np.zeros(16000, np.float32)]))
    decisions = []
    while s._ready():
        rec.get_results([s])
        decisions.append(rec.is_endpoint(s))
    assert decisions and not any(decisions)


def test_pipelined_hotword_readback_matches_serial(bundles):
    """begin_step for window k+1 before end_step for window k, with the
    every-beam readback that hotwords need: each handle still reads its own
    step's beams."""
    _, tb = bundles["zipformer2"]
    pcm = _pcm(12000, 11)

    def recognizer():
        rec = OnlineRecognizer(tb, max_lanes=2, device="cpu", hotwords=["tok6tok26"], **BEAM)
        s = rec.create_online_stream()
        s.add_samples(pcm)
        return rec, s

    rec, s = recognizer()
    serial = []
    while s._ready():
        serial.extend(_nbest(rec.get_results([s])))
    rec, s = recognizer()
    piped, pending = [], None
    while s._ready():
        nxt = rec.begin_step([s])
        if pending is not None:
            piped.extend(_nbest(rec.end_step(pending)))
        pending = nxt
    piped.extend(_nbest(rec.end_step(pending)))
    assert piped == serial and len({p[0] for p in serial}) > 1


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_beam_invariants(bundles, family):
    """bf16 cannot equal JAX token for token (PyTorch's bf16 linear rounds
    before the bias add): the n-best is sorted with finite scores, and the
    best result is n-best entry 0, offline and online."""
    _, tb = bundles[family]
    kw = dict(BEAM, compute_dtype=torch.bfloat16)
    off = OfflineRecognizer(tb, device="cpu", **kw)
    s = off.create_offline_stream()
    s.add_samples(_pcm(6400))
    pending = off.begin_decode([s])
    best = off.end_decode(pending)[0]
    score = pending.host[3]
    assert bool(torch.isfinite(score).all()) and bool((score[:, 1:] <= score[:, :-1]).all())
    first = off._nbest_results([s], pending.host)[0][0]
    assert (best.text, best.timestamps) == (first.text, first.timestamps) and best.text
    on = OnlineRecognizer(tb, max_lanes=2, device="cpu", **kw)
    st = on.create_online_stream()
    st.add_samples(_pcm(6400))
    res = on.decode_to_end(st)
    assert _nbest([res])[0] == _nbest(on.get_nbest_results([st])[0])[0] and res.text
