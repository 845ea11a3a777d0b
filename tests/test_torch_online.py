"""The port's OnlineRecognizer(device="cpu") against the JAX package's on
the committed pin model dirs (tests/torch_port_data), f32 compute.

Partial tokens and timestamps, the online pins, endpoint decisions and a
stream carried across by snapshot/restore are compared exactly; the
recognizers' own behaviours (lanes, ``windows_per_step``, pipelined
readback, the options not ported yet) are checked on the port alone.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode.rnnt_greedy import GreedyState as JGreedyState
from k2transducerasr_tpu.runtime import endpoint as JE
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OnlineRecognizer
from k2transducerasr_tpu_torch.runtime import endpoint as TE
from torch_parallel_worker import fake_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
# tests/test_pinned_transcripts.py's online pins
ONLINE_PINS = {
    "zipformer2": "tok25tok25tok18tok8tok12tok6tok25tok6tok12tok6tok25tok6",
    "conformer": "tok28tok28tok28tok28",
}


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles():
    """family -> (JAX bundle, port bundle) of the pin dirs."""
    return {f: (JBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin")),
                ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin"), device="cpu"))
            for f in ONLINE_PINS}


def _port(bundles, family="zipformer2", **kw):
    kw = {"compute_dtype": None, "max_lanes": 2, "device": "cpu", **kw}
    return OnlineRecognizer(bundles[family][1], **kw)


def _parts(results):
    return [(r.text, r.tokens, r.timestamps) for r in results]


def _feed(rec, stream, pcm, feed=800):
    """800-sample feeds, a get_results after each; then the tail flush.
    Returns every partial result."""
    out = []
    for i in range(0, len(pcm), feed):
        stream.add_samples(pcm[i:i + feed])
        out.extend(_parts(rec.get_results([stream])))
    stream.input_finished()
    while not stream.is_finished:
        out.extend(_parts(rec.get_results([stream])))
    out.extend(_parts(rec.get_results([stream])))
    return out


@pytest.mark.parametrize("family", list(ONLINE_PINS))
def test_partials_match_jax_and_give_the_online_pin(bundles, family):
    jb, _ = bundles[family]
    jrec = JOnline(jb, compute_dtype=None, max_lanes=2)
    trec = _port(bundles, family)
    pcm = _pcm(6400)
    want = _feed(jrec, jrec.create_online_stream(), pcm)
    got = _feed(trec, trec.create_online_stream(), pcm)
    assert got == want
    assert got[-1][0] == ONLINE_PINS[family]


@pytest.mark.parametrize("family", list(ONLINE_PINS))
def test_decode_to_end_gives_the_online_pin(bundles, family):
    rec = _port(bundles, family)
    s = rec.create_online_stream()
    s.add_samples(_pcm(6400))
    assert rec.decode_to_end(s).text == ONLINE_PINS[family]
    assert s.is_finished


def _drain(rec, stream, pcm):
    stream.add_samples(pcm)
    while stream._ready():
        rec.get_results([stream])
    return _parts(rec.get_results([stream]))[0]


def test_two_interleaved_streams_match_solo_runs(bundles):
    """Lanes are independent: B starts two windows after A (so their
    kv_start differs within a step), and a lane with no window ready keeps
    its caches and counters while the other steps."""
    pcm_a, pcm_b = _pcm(9000, 7), _pcm(7000, 8)
    solo = []
    for x in (pcm_a, pcm_b):
        rec = _port(bundles)
        solo.append(_drain(rec, rec.create_online_stream(), x))
    rec = _port(bundles)
    sa, sb = rec.create_online_stream(), rec.create_online_stream()
    sa.add_samples(pcm_a)
    sb.add_samples(pcm_b[:800])  # not a whole window: B idles
    idle = rec.snapshot_stream(sb)
    rec.get_results([sa, sb])
    rec.get_results([sa, sb])
    after = rec.snapshot_stream(sb)
    assert after["frames"] == idle["frames"] == 0
    assert int(after["enc"]["processed"]) == 0
    assert int(rec.snapshot_stream(sa)["enc"]["processed"]) == 2 * 8
    for k in ("key", "nonlin", "conv1"):
        np.testing.assert_array_equal(after["enc"]["layers"][0][k], idle["enc"]["layers"][0][k])
    np.testing.assert_array_equal(after["dec"].dec_proj, idle["dec"].dec_proj)
    sb.add_samples(pcm_b[800:])
    while sa._ready() or sb._ready():
        rec.get_results([sa, sb])
    assert _parts(rec.get_results([sa, sb])) == solo


def test_lane_reuse_resets_state_and_exhaustion_raises(bundles):
    rec = _port(bundles, max_lanes=1)
    pcm = _pcm(6000, 9)

    def run():
        s = rec.create_online_stream()
        out = _drain(rec, s, pcm)
        rec.dispose_stream(s)
        assert s.lane == -1 and rec.get_result(s).text == out[0]
        return out

    first = run()
    assert first[0] and run() == first  # the same lane, from a fresh state
    rec.create_online_stream()
    with pytest.raises(RuntimeError, match="lanes busy"):
        rec.create_online_stream()


def test_windows_per_step_2_equals_1(bundles):
    """Two windows per step, with a lane that has fewer buffered windows
    than the slots: the drained results equal one window per step."""
    def run(wps):
        rec = _port(bundles, windows_per_step=wps)
        sa, sb = rec.create_online_stream(), rec.create_online_stream()
        sa.add_samples(_pcm(rec.window_samples + 5 * rec.hop_samples, 21))
        sb.add_samples(_pcm(rec.window_samples + 2 * rec.hop_samples, 22))
        steps = 0
        while sa._ready() or sb._ready():
            rec.get_results([sa, sb])
            steps += 1
        return _parts(rec.get_results([sa, sb])), steps

    (two, steps2), (one, steps1) = run(2), run(1)
    assert two == one and (steps2, steps1) == (3, 6)


def test_pipelined_begin_end_matches_serial(bundles):
    """begin_step for window k+1 before end_step for window k: the handle of
    step k still reads step k's results."""
    pcm = _pcm(12000, 11)

    def serial():
        rec = _port(bundles)
        s = rec.create_online_stream()
        s.add_samples(pcm)
        out = []
        while s._ready():
            out.extend(_parts(rec.get_results([s])))
        return out

    rec = _port(bundles)
    s = rec.create_online_stream()
    s.add_samples(pcm)
    out, pending = [], None
    while s._ready():
        nxt = rec.begin_step([s])
        if pending is not None:
            out.extend(_parts(rec.end_step(pending)))
        pending = nxt
    out.extend(_parts(rec.end_step(pending)))
    want = serial()
    assert out == want and len({p[0] for p in want}) > 1


def test_endpoint_decisions_match_jax(bundles):
    """Speech then silence, 800-sample feeds: is_endpoint after every step
    as the JAX recognizer decides it (short limits so rules 1-3 all fire)."""
    cfg_kw = dict(min_trailing_silence_no_text=0.3, min_trailing_silence_after_text=0.2,
                  max_utterance_length=1.2, frame_seconds=0.04)
    jrec = JOnline(bundles["conformer"][0], compute_dtype=None, max_lanes=2,
                   enable_endpoint=True, endpoint_config=JE.EndpointConfig(**cfg_kw))
    trec = _port(bundles, "conformer", enable_endpoint=True,
                 endpoint_config=TE.EndpointConfig(**cfg_kw))
    pcm = np.concatenate([_pcm(6400), np.zeros(16000, np.float32)])
    decisions = []
    for rec in (jrec, trec):
        s = rec.create_online_stream()
        got = []
        for i in range(0, len(pcm), 800):
            s.add_samples(pcm[i:i + 800])
            rec.get_results([s])
            got.append(rec.is_endpoint(s))
        decisions.append(got)
    assert decisions[1] == decisions[0] and True in decisions[0] and False in decisions[0]
    for args in [(0, 0, 0), (200, 0, 10), (60, 3, 100), (10, 2, 600), (124, 0, 124)]:
        assert TE.is_endpoint(TE.EndpointConfig(), *args) == JE.is_endpoint(
            JE.EndpointConfig(), *args)


def test_snapshot_carries_a_stream_across_packages(bundles):
    """A JAX snapshot_stream() restored into the port continues to the JAX
    stream's final result; a port snapshot restored into JAX does too."""
    jb, _ = bundles["zipformer2"]
    pcm = _pcm(6400)
    jrec = JOnline(jb, compute_dtype=None, max_lanes=2)
    js = jrec.create_online_stream()
    js.add_samples(pcm[:4000])
    while js._ready():
        jrec.get_results([js])
    snap = jrec.snapshot_stream(js)
    js.add_samples(pcm[4000:])
    want = jrec.decode_to_end(js)

    trec = _port(bundles, max_lanes=3)
    trec.create_online_stream()  # occupy a lane: the restore lands in another
    ts = trec.restore_stream(snap)
    ts.add_samples(pcm[4000:])
    got = trec.decode_to_end(ts)
    assert (got.text, got.tokens, got.timestamps) == (want.text, want.tokens, want.timestamps)

    ts = trec.create_online_stream()
    ts.add_samples(pcm[:4000])
    while ts._ready():
        trec.get_results([ts])
    psnap = trec.snapshot_stream(ts)
    psnap["dec"] = JGreedyState(**dataclasses.asdict(psnap["dec"]))
    js = jrec.restore_stream(psnap)
    js.add_samples(pcm[4000:])
    back = jrec.decode_to_end(js)
    assert (back.text, back.timestamps) == (want.text, want.timestamps)


def test_unported_options_raise_and_default_device_is_the_card(bundles, monkeypatch):
    tb = bundles["zipformer2"][1]
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is make_mesh's
        _port(bundles, mesh=object())
    with fake_world(4) as mesh:  # the JAX package's message
        with pytest.raises(ValueError, match=r"max_lanes=6 must be a multiple of the mesh "
                                             r"data axis \(4\)"):
            _port(bundles, max_lanes=6, mesh=mesh("cpu", 4, 1))
    assert _port(bundles, accuracy="int8").accuracy == "int8"  # ported: tests/test_torch_int8.py
    for kw in (dict(decoding_method="beam"), dict(accuracy="fp16")):
        with pytest.raises(ValueError, match="unsupported"):
            _port(bundles, **kw)
    with pytest.raises(ValueError):
        _port(bundles, windows_per_step=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OnlineRecognizer(tb)
