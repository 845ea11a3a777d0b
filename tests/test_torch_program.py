"""The offline recognizer's decode program (``runtime/program.py``): one
entry per (rows, bucketed samples), run through ``begin_decode``, against
the JAX package's ``OfflineRecognizer`` (one jitted program per batch and
frame bucket) on the CPU, on the committed pin dirs of all five families.

On the CPU the program runs ``_decode`` eagerly on its static inputs and
clones the outputs, the route these tests drive; the CUDA graphs it
captures on the card are held against eager ``_decode`` in
``tests/test_torch_cuda.py``.  The launch-counter arithmetic of a replay is
checked here with a fake graph.

Tolerances: none.  At float32 (``compute_dtype=None``) text, tokens and
timestamps, and every n-best hypothesis under beam search, are compared
exactly, as ``tests/test_torch_beam.py`` and the family files compare them.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.frontend.fbank import dither_noise, fbank_compute
from k2transducerasr_tpu_torch.runtime.program import DecodeProgram, kernel_wrappers
from test_pinned_transcripts import _bundle as jax_pin_bundle
from torch_parallel_worker import fake_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
GREEDY, BEAM, CTC = "greedy_search", "modified_beam_search", "greedy_search_ctc"
HOTWORDS = ["tok25tok25"]  # the third of the zipformer2 pin's n-best starts with it
# (family, method, hotwords): every family and search method
CASES = [("zipformer2", GREEDY, None), ("conformer", GREEDY, None), ("zipformer", GREEDY, None),
         ("lstm", GREEDY, None), ("zipformer2ctc", CTC, None), ("zipformer2", BEAM, None),
         ("conformer", BEAM, None), ("zipformer", BEAM, None), ("lstm", BEAM, None),
         ("zipformer2", BEAM, HOTWORDS)]


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


def _results(results):
    return [(r.text, r.tokens, r.timestamps) for r in results]


@pytest.fixture(autouse=True)
def _global_rng_untouched():
    state = torch.get_rng_state()
    yield
    assert torch.equal(torch.get_rng_state(), state), "the test drew from the global torch RNG"


@pytest.fixture(scope="module")
def bundles():
    """family -> (the JAX pin bundle, the port's bundle of its pin dir, which
    the JAX bundle wrote)."""
    return {f: (jax_pin_bundle(f),
                ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin"), device="cpu"))
            for f in sorted({c[0] for c in CASES})}


def _pair(bundles, family, method, hotwords=None, **kw):
    jb, tb = bundles[family]
    kw = dict(kw, decoding_method=method, compute_dtype=None, max_active_paths=4,
              hotwords=hotwords)
    return JOffline(jb, **kw), OfflineRecognizer(tb, device="cpu", **kw)


@pytest.mark.parametrize("family,method,hotwords", CASES,
                         ids=[f"{f}-{m}" + ("-hotwords" if h else "") for f, m, h in CASES])
def test_program_route_matches_jax(bundles, family, method, hotwords):
    """A ragged batch through begin_decode/end_decode (the program) gives the
    JAX recognizer's text, tokens and timestamps; under beam search also
    every n-best hypothesis; the program holds the batch's one key."""
    jrec, trec = _pair(bundles, family, method, hotwords)
    pcms = [_pcm(6400), _pcm(4100, 3), _pcm(5300, 4)]
    want = _results(jrec.get_results(_streams(jrec, pcms)))
    got = _results(trec.end_decode(trec.begin_decode(_streams(trec, pcms))))
    assert got == want
    assert any(tokens for _, tokens, _ in got)
    if method == BEAM:
        want = [_results(n) for n in jrec.get_nbest_results(_streams(jrec, pcms))]
        got = [_results(n) for n in trec.get_nbest_results(_streams(trec, pcms))]
        assert got == want
    assert len(trec.program) == 1


# frame_bucket=16: 6400 and 6300 samples (38 and 37 frames) share the
# 48-frame bucket, 9000 and 8200 (55, 50) fill the 64-frame one
BATCHES = {"one-bucket": ([6400, 5000], [6300, 5500]),
           "two-buckets": ([6400, 5000], [9000, 8200])}


@pytest.mark.parametrize("method", [GREEDY, BEAM])
@pytest.mark.parametrize("buckets", list(BATCHES))
def test_pipelined_batches_equal_sequential(bundles, buckets, method):
    """begin_decode(A), begin_decode(B), end_decode(A), end_decode(B) gives
    what A and B decoded one by one give, and the JAX recognizer's."""
    jrec, trec = _pair(bundles, "zipformer2", method, frame_bucket=16)
    pcm = [[_pcm(n, 20 + 2 * k + i) for i, n in enumerate(lens)]
           for k, lens in enumerate(BATCHES[buckets])]
    want = [_results(jrec.get_results(_streams(jrec, p))) for p in pcm]
    sequential = [_results(trec.get_results(_streams(trec, p))) for p in pcm]
    a = trec.begin_decode(_streams(trec, pcm[0]))
    b = trec.begin_decode(_streams(trec, pcm[1]))
    assert [_results(trec.end_decode(a)), _results(trec.end_decode(b))] == sequential == want
    assert len(trec.program) == (1 if buckets == "one-bucket" else 2)


def test_program_key_is_rows_and_bucketed_samples(bundles):
    """A batch of a seen (rows, bucket) reuses its entry (the same static
    inputs); another bucket or another row count adds one."""
    _, trec = _pair(bundles, "zipformer2", GREEDY, frame_bucket=16)
    frame = trec.bundle.frontend_cfg

    def samples(frames):  # the bucketed buffer of a batch of `frames` frames
        return (frames - 1) * frame.frame_shift + frame.frame_length

    trec.get_results(_streams(trec, [_pcm(6400), _pcm(5000, 2)]))
    assert list(trec.program.entries) == [(2, samples(48))]
    inputs = trec.program.entries[(2, samples(48))].inputs
    trec.get_results(_streams(trec, [_pcm(5500, 3), _pcm(6300, 4)]))
    assert list(trec.program.entries) == [(2, samples(48))]
    assert trec.program.entries[(2, samples(48))].inputs is inputs
    trec.get_results(_streams(trec, [_pcm(9000, 5), _pcm(8200, 6)]))
    trec.get_results(_streams(trec, [_pcm(6400)]))
    assert list(trec.program.entries) == [(2, samples(48)), (2, samples(64)), (1, samples(48))]
    assert len(trec.program) == 3 and trec.program.graphs is None


class _FakeGraph:
    """Stands in for a captured graph: a replay recomputes the outputs in
    place from the static inputs and runs no Python wrapper."""

    def __init__(self, inputs, outputs):
        self.inputs, self.outputs, self.replays = inputs, outputs, 0

    def replay(self):
        samples, counts = self.inputs
        self.outputs[0].copy_(samples.sum(1))
        self.outputs[1].copy_(counts * 2)
        self.replays += 1


class _FakeGraphs:
    """warm_up runs fn; capture runs it too (its wrapper counts, as the real
    wrappers count while a capture records their launches).  ``stream``
    stands for the caller's current stream."""

    def __init__(self, fail=False, graph=_FakeGraph):
        self.fail, self.graph, self.graphs, self.stream = fail, graph, [], "s1"

    def current_stream(self):
        return self.stream

    def warm_up(self, fn, inputs):
        fn(*inputs)

    def capture(self, fn, inputs):
        outputs = fn(*inputs)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.graphs.append(self.graph(inputs, outputs))
        return self.graphs[-1], outputs


def test_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    """Warm-up launches count, captured ones are taken back, each replay
    adds the capture's; the outputs are clones of the graph's; a failed
    capture raises, restores the counts and stores no entry."""
    probs, _, search, beam, swoosh, convs, norm = kernel_wrappers()
    monkeypatch.setattr(probs, "launches", 10)
    monkeypatch.setattr(search, "launches", 0)
    monkeypatch.setattr(beam, "launches", 0)
    monkeypatch.setattr(swoosh, "launches", 0)
    monkeypatch.setattr(convs, "launches", 0)
    monkeypatch.setattr(norm, "launches", 0)

    def fn(samples, counts):  # what the kernels' wrappers count on the card
        probs.launches += 3
        search.launches += 1
        swoosh.launches += 5
        convs.launches += 2
        norm.launches += 4
        return samples.sum(1), counts * 2

    graphs = _FakeGraphs()
    program = DecodeProgram(fn, torch.device("cpu"), graphs=graphs)
    x = torch.arange(6, dtype=torch.int16).reshape(2, 3)
    n = torch.tensor([3, 2])
    first = program(x, n)
    assert (probs.launches, search.launches) == (10 + 3 + 3, 1 + 1)  # warm-up + one replay
    assert program.entries[(2, 3)].launches == (3, 0, 1, 0, 5, 2, 4)
    assert graphs.graphs[0].replays == 1
    assert beam.launches == 0 and swoosh.launches == 5 + 5 and convs.launches == 2 + 2
    assert norm.launches == 4 + 4
    assert first[0].tolist() == [3, 12] and first[1].tolist() == [6, 4] and len(first) == 2
    second = program(x + 1, n - 1)
    assert (probs.launches, search.launches) == (19, 3) and len(graphs.graphs) == 1
    assert swoosh.launches == 15 and convs.launches == 6 and norm.launches == 12
    assert second[0].tolist() == [6, 15] and second[1].tolist() == [4, 2]
    assert first[0].tolist() == [3, 12]  # a clone: the replay did not overwrite it
    assert second[0].data_ptr() != graphs.graphs[0].outputs[0].data_ptr()

    graphs.fail = True
    with pytest.raises(RuntimeError, match="capturing"):
        program(torch.zeros((1, 3), dtype=torch.int16), torch.tensor([3]))
    assert (probs.launches, search.launches) == (19 + 3, 3 + 1)  # the warm-up's only
    assert swoosh.launches == 15 + 5 and convs.launches == 6 + 2 and norm.launches == 12 + 4
    assert list(program.entries) == [(2, 3)]


def test_a_call_on_another_stream_raises():
    """The graphs serve the stream of the program's first call: a call on
    another raises before it touches the static inputs."""
    graphs = _FakeGraphs()
    program = DecodeProgram(lambda s, c: (s.sum(1), c * 2), torch.device("cpu"), graphs=graphs)
    x, n = torch.ones((2, 3), dtype=torch.int16), torch.tensor([3, 2])
    program(x, n)
    assert program.stream == "s1"
    graphs.stream = "s2"
    with pytest.raises(RuntimeError, match="one caller stream"):
        program(x + 1, n)
    assert torch.equal(program.entries[(2, 3)].inputs[0], x)
    graphs.stream = "s1"
    assert program(x + 1, n)[0].tolist() == [6, 6]


class _SlowGraph(_FakeGraph):
    """A replay that reads its static inputs only after a pause: a call
    whose copy lands in that pause would change what the replay reads."""

    def replay(self):
        time.sleep(0.002)
        super().replay()


def test_calls_from_two_threads_do_not_interleave():
    """Two threads calling one program: each call's copy, replay and clones
    run together, so every result is its own input's."""
    program = DecodeProgram(lambda s, c: (s.sum(1), c * 2), torch.device("cpu"),
                            graphs=_FakeGraphs(graph=_SlowGraph))
    n = torch.tensor([3, 2])
    program(torch.zeros((2, 3), dtype=torch.int16), n)
    wrong = []

    def caller(base):
        for k in range(25):
            v = base + k
            out = program(torch.full((2, 3), v, dtype=torch.int16), n)
            if out[0].tolist() != [3 * v, 3 * v]:
                wrong.append((v, out[0].tolist()))

    threads = [threading.Thread(target=caller, args=(base,)) for base in (0, 100)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == []


def test_dropping_a_recognizer_frees_its_program(bundles):
    """The program holds its recognizer's ``_decode`` weakly: with the cycle
    collector off, dropping the recognizer frees it, its program and the
    program's entries (on the card: the graphs and their pool)."""
    import gc
    import weakref

    rec = OfflineRecognizer(bundles["zipformer2"][1], compute_dtype=None, device="cpu")
    rec.get_results(_streams(rec, [_pcm(6400)]))
    assert rec.program.fn == rec._decode and len(rec.program) == 1
    refs = (weakref.ref(rec), weakref.ref(rec.program))
    gc.disable()
    try:
        del rec
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_default_counters_are_the_four_kernel_wrappers():
    from k2transducerasr_tpu_torch.decode import rnnt_beam, rnnt_greedy
    from k2transducerasr_tpu_torch.ops import activations_cuda, attention_cuda, layers, norm_cuda

    program = DecodeProgram(lambda s, c: (s,), torch.device("cpu"))
    assert program.counters == kernel_wrappers() == (
        attention_cuda.relpos_attn_probs, attention_cuda.relpos_attn_ctx,
        rnnt_greedy.greedy_frames_skip, rnnt_beam.beam_frames_skip,
        activations_cuda.bias_swoosh, layers.conv_tf32, norm_cuda.layernorm)
    assert program.graphs is None and program.pool_bytes() == 0


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["offline", "online"])
def test_recognizers_run_their_device_work_with_tf32_off(bundles, monkeypatch, kind,
                                                         compute_dtype):
    """The port's one precision rule: with both TF32 flags set True by the
    caller, every linear and convolution a recognizer runs (built, then
    decoding a batch or taking a step; bf16 or float32) sees both False, and
    both read True again afterwards."""
    from k2transducerasr_tpu_torch import OnlineRecognizer
    from k2transducerasr_tpu_torch.ops import layers

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    def spy(fn):
        def call(*a, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return fn(*a, **kw)
        return call

    for name in ("apply_linear", "_conv"):
        monkeypatch.setattr(layers, name, spy(getattr(layers, name)))
    tb = bundles["zipformer2"][1]
    if kind == "offline":
        rec = OfflineRecognizer(tb, compute_dtype=compute_dtype, device="cpu")
        rec.get_results(_streams(rec, [_pcm(6400)]))
    else:
        rec = OnlineRecognizer(tb, compute_dtype=compute_dtype, max_lanes=2, device="cpu")
        s = rec.create_online_stream()
        s.add_samples(_pcm(rec.window_samples))
        rec.get_results([s])
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


def test_mesh_recognizer_stays_eager(bundles):
    """The rule: under a mesh the recognizer has no program (its collectives
    cannot be captured); without one it always has one."""
    tb = bundles["zipformer2"][1]
    assert OfflineRecognizer(tb, compute_dtype=None, device="cpu").program is not None
    with fake_world(2) as mesh:
        rec = OfflineRecognizer(tb, compute_dtype=None, device="cpu", mesh=mesh())
        assert rec.program is None


def test_dither_through_the_program_equals_fbank_draw():
    """With dither the program's features are fbank_compute's own draw (a
    fresh generator seeded 0), batch after batch: the recognizer keeps the
    noise of each shape, drawn once."""
    import dataclasses

    tb = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cpu")
    tb = dataclasses.replace(tb, frontend_cfg=dataclasses.replace(tb.frontend_cfg, dither=1.0))
    rec = OfflineRecognizer(tb, compute_dtype=None, device="cpu")
    cfg = tb.frontend_cfg
    for seed in (1, 2):
        samples, counts = rec.pcm_batch(_streams(rec, [_pcm(6400, seed), _pcm(3000, seed)]))
        t_pad = (samples.shape[1] - cfg.frame_length) // cfg.frame_shift + 1
        feats, _ = rec.features(samples, counts)
        want = fbank_compute(samples.float() * (1.0 / 32768.0), cfg, t_pad, n_valid=counts,
                             tables=rec._fbank_tables)
        assert torch.equal(feats, want)
    assert list(rec._dither) == [(2, t_pad)]
    assert torch.equal(rec._dither[(2, t_pad)],
                       dither_noise((2, t_pad, cfg.frame_length), cfg, "cpu"))
