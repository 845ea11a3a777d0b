"""The port's tracing (``k2transducerasr_tpu_torch/utils/profiling.py``): the
ring of host spans, the counters, the stage markers and the spans and
counters the recognizers and the decode program record, on the CPU, with
``chip_smoke.py``'s split of a trace by its markers; the card tests
(marker ``cuda``) hold the markers in a replay's trace and in a capture's
nodes, and a replay with markers to one without, bit for bit.

Here a marker launches nothing (``stage`` on a CPU device); the CPU tests
hold where ``_decode`` and ``_step`` place their marks among the work they
split.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import importlib.util
import inspect
import os
import re
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.decode import rnnt_greedy
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.ops import cuda_build
from k2transducerasr_tpu_torch.runtime import offline as offline_mod
from k2transducerasr_tpu_torch.runtime import online as online_mod
from k2transducerasr_tpu_torch.runtime.checkpoint import tree_map
from k2transducerasr_tpu_torch.runtime.program import CudaGraphs, DecodeProgram
from k2transducerasr_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
PORT = os.path.join(REPO, "k2transducerasr_tpu_torch")
OFFLINE_SPANS = ("begin_decode.pcm", "begin_decode.queue", "end_decode.wait", "end_decode.text")
ONLINE_SPANS = ("begin_step.prep", "begin_step.queue", "end_step.wait", "end_step.text")


def _pcm(n, seed=9):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cpu")


def _offline_streams(rec, lens=(6400, 4100)):
    out = []
    for i, n in enumerate(lens):
        s = rec.create_offline_stream()
        s.add_samples(_pcm(n, 3 + i))
        out.append(s)
    return out


def _names(spans):
    return [n for n, _, _ in spans]


def test_ring_is_bounded_and_ordered():
    n = profiling.RING_SIZE + 10
    for i in range(n):
        with profiling.span(f"s{i}"):
            pass
    ring = profiling.spans()
    assert len(ring) == profiling.RING_SIZE
    assert ring[0][0] == "s10" and ring[-1][0] == f"s{n - 1}"  # the oldest dropped out
    starts = [s for _, s, _ in ring]
    assert starts == sorted(starts)
    assert all(s <= e for _, s, e in ring)
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_span_times_its_block_on_the_perf_counter():
    t0 = time.perf_counter_ns()
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    t1 = time.perf_counter_ns()
    (inner, s_in, e_in), (outer, s_out, e_out) = profiling.spans()
    assert (inner, outer) == ("inner", "outer")
    assert t0 <= s_out <= s_in <= e_in <= e_out <= t1
    with pytest.raises(ZeroDivisionError), profiling.span("raised"):
        1 / 0
    assert profiling.spans()[-1][0] == "raised"  # recorded on the way out


def test_counters_add_and_read_back_a_copy():
    profiling.count("a")
    profiling.count("a", 2)
    profiling.count("t", 0.25)
    got = profiling.counters()
    assert got == {"a": 3, "t": 0.25}
    got["a"] = 99
    assert profiling.counters()["a"] == 3


def test_counters_lose_no_update_across_threads():
    import sys
    import threading

    n_threads, n = 2 * (os.cpu_count() or 1), 5000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("c") for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["c"] == n_threads * n


def test_offline_records_one_span_of_each_name_per_call(bundle):
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    pending = [rec.begin_decode(_offline_streams(rec)) for _ in range(3)]
    assert _names(profiling.spans()) == [n for _ in range(3) for n in OFFLINE_SPANS[:2]]
    profiling.reset()
    for p in pending:
        rec.end_decode(p)
    assert _names(profiling.spans()) == [n for _ in range(3) for n in OFFLINE_SPANS[2:]]


def test_online_records_one_span_of_each_name_per_call(bundle):
    rec = OnlineRecognizer(bundle, max_lanes=3, compute_dtype=None, device="cpu")
    streams = [rec.create_online_stream() for _ in range(2)]
    for i, s in enumerate(streams):
        s.add_samples(_pcm(3 * rec.window_samples, 20 + i))
    for _ in range(4):  # the last steps find no stream ready: spans all the same
        rec.end_step(rec.begin_step(streams))
    assert _names(profiling.spans()) == list(ONLINE_SPANS) * 4


def test_spans_are_profiler_events_on_the_same_offsets(bundle):
    """Under torch.profiler each span is also an event of its name, and the
    offsets between spans in the ring agree with kineto's within 1 ms.  The
    profiler's first scope costs a one-off ~1.5 ms of host time here (its
    lazy set-up), so the first call is left out of the comparison."""
    from torch.profiler import ProfilerActivity, profile

    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    streams = _offline_streams(rec)
    rec.get_results(streams)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            rec.end_decode(rec.begin_decode(streams))
    ring = profiling.spans()
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in OFFLINE_SPANS),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == _names(ring)[-12:] == list(OFFLINE_SPANS) * 3
    ring, events = ring[-8:], events[-8:]
    for (_, s, _), ev in zip(ring, events):
        assert abs((s - ring[0][1]) - (ev.start_ns() - events[0].start_ns())) < 1e6


class _FakeGraph:
    def __init__(self, inputs, outputs):
        self.inputs, self.outputs = inputs, outputs

    def replay(self):
        self.outputs[0].copy_(self.inputs[0].sum(1))


class _FakeGraphs:
    """warm_up and capture run fn; the capture holds a graph that replays
    it from the static inputs."""

    def current_stream(self):
        return "s1"

    def warm_up(self, fn, inputs):
        fn(*inputs)

    def capture(self, fn, inputs):
        outputs = fn(*inputs)
        return _FakeGraph(inputs, outputs), outputs


def test_program_counts_captures_replays_and_capture_seconds():
    slept = []

    def fn(samples, counts):
        time.sleep(0.01)
        slept.append(1)
        return (samples.sum(1),)

    program = DecodeProgram(fn, torch.device("cpu"), graphs=_FakeGraphs())
    x = torch.ones((2, 3), dtype=torch.int16)
    n = torch.tensor([3, 2])
    for _ in range(3):
        program(x, n)
    program(torch.ones((1, 5), dtype=torch.int16), n[:1])  # a second key
    got = profiling.counters()
    assert got["program.captures"] == 2 and got["program.replays"] == 4
    assert len(slept) == 4  # warm-up and capture, two keys; a replay runs no fn
    assert 0.04 <= got["program.capture_s"] < 5.0
    # no graphs (the CPU route): eager calls, nothing captured or replayed
    profiling.reset()
    DecodeProgram(fn, torch.device("cpu"))(x, n)
    assert profiling.counters() == {}


def test_stage_is_a_noop_on_the_cpu(monkeypatch):
    """On a CPU device a marker launches nothing and opens no profiler scope;
    an unknown stage raises."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(cuda_build, "launch", refuse)
    monkeypatch.setattr(cuda_build, "function", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in profiling.STAGES:
            profiling.stage(name, torch.device("cpu"))
    assert not [e for e in prof.events() if e.name.startswith(profiling.MARKER_PREFIX)]
    with pytest.raises(ValueError):
        profiling.stage("decoder", torch.device("cpu"))


def _logged(log, label, fn):
    """``fn``, appending ``label`` to ``log`` at each call."""
    def call(*args, **kwargs):
        log.append(label)
        return fn(*args, **kwargs)
    return call


def test_decode_marks_each_stage_before_its_work(bundle, monkeypatch):
    """``_decode``'s marks, recorded in place of the launches, lie between
    the work they split: fbank, the features, encoder, the encoder, search,
    the search, end; and they leave the outputs as an unrecorded call's."""
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    samples, counts = rec.pcm_batch(_offline_streams(rec))
    with torch.inference_mode():
        plain = rec._decode(samples, counts)
    log = []
    monkeypatch.setattr(profiling, "stage", lambda name, device: log.append(name))
    monkeypatch.setattr(rec, "features", _logged(log, "features()", rec.features))
    monkeypatch.setattr(rec, "encoder", _logged(log, "encoder()", rec.encoder))
    monkeypatch.setattr(rec, "_search", _logged(log, "_search()", rec._search))
    with torch.inference_mode():
        marked = rec._decode(samples, counts)
    assert log == ["fbank", "features()", "encoder", "encoder()", "search", "_search()", "end"]
    assert len(plain) == len(marked) == 3
    for a, b in zip(plain, marked):
        assert torch.equal(a, b)
    log.clear()
    rec.encode(samples, counts)  # the path the encoder checks call: the same marks
    assert log == ["fbank", "features()", "encoder", "encoder()"]


def test_step_marks_each_window_slot_then_the_search(bundle, monkeypatch):
    """``_step``'s marks at two window slots: fbank, encoder and freeze
    before each slot's work, then search before the projection and the
    search and end after the state's write-back (the frame counters
    already advanced)."""
    rec = OnlineRecognizer(bundle, max_lanes=3, compute_dtype=None, windows_per_step=2,
                           device="cpu")
    log = []

    def stage(name, device):
        log.append(name if name != "end" else ("end", rec._frame_count.tolist()))

    monkeypatch.setattr(profiling, "stage", stage)
    monkeypatch.setattr(online_mod, "fbank_compute",
                        _logged(log, "fbank()", online_mod.fbank_compute))
    monkeypatch.setattr(rec._enc, "streaming_step",
                        _logged(log, "encoder()", rec._enc.streaming_step))
    monkeypatch.setattr(online_mod, "_freeze", _logged(log, "freeze()", online_mod._freeze))
    monkeypatch.setattr(joiner_mod, "project_encoder",
                        _logged(log, "project()", joiner_mod.project_encoder))
    monkeypatch.setattr(rnnt_greedy, "greedy_frames_skip",
                        _logged(log, "search()", rnnt_greedy.greedy_frames_skip))
    pcm = _pcm(3 * 2 * rec.window_samples).reshape(3, 2, -1)
    windows = torch.from_numpy((pcm * 32768.0).astype(np.int16))
    with torch.inference_mode():
        rec._step(windows, torch.tensor([2, 0, 1]))
    slot = ["fbank", "fbank()", "encoder", "encoder()", "freeze", "freeze()"]
    chunk = rec.chunk_frames
    assert log == slot * 2 + ["search", "project()", "search()",
                              ("end", [2 * chunk, 0, chunk])]


def _chip_smoke():
    """chip_smoke.py's module (it holds the split of a trace by its markers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lanes_stepped_counts_the_nonzero_wcount_entries(bundle):
    rec = OnlineRecognizer(bundle, max_lanes=4, compute_dtype=None, windows_per_step=2,
                           device="cpu")
    seen = []
    program = rec.program
    rec.program = lambda windows, wcount: (seen.append(wcount.clone()),
                                           program(windows, wcount))[1]
    streams = [rec.create_online_stream() for _ in range(3)]
    for i, (s, n) in enumerate(zip(streams, (1, 2, 4))):
        s.add_samples(_pcm(rec.window_samples + (n - 1) * rec.hop_samples, 40 + i))
    for _ in range(3):
        rec.end_step(rec.begin_step(streams))
    got = profiling.counters()
    assert [c.tolist().count(0) for c in seen] == [1, 3]  # 3 lanes stepped, then 1
    assert got["online.lanes_stepped"] == sum(int(torch.count_nonzero(c)) for c in seen) == 4
    assert got["online.windows"] == sum(int(c.sum()) for c in seen) == 1 + 2 + 4


def test_decode_and_step_hold_no_profiler_scope_and_profiling_is_the_one_tracing_module():
    for fn in (offline_mod.OfflineRecognizer._decode, online_mod.OnlineRecognizer._step):
        src = inspect.getsource(fn)
        assert "record_function" not in src and "profiling.stage(" in src
    users = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if re.search(r"record_function|torch\.profiler|from torch import profiler",
                                 fh.read()):
                        users.append(os.path.relpath(os.path.join(root, f), PORT))
    assert users == [os.path.join("utils", "profiling.py")]


@pytest.mark.parametrize("events,want", [
    # two replays, the span cut inside the first one's encoder and the second's search
    ([("copy", 0, 1), ("k2t_stage_encoder", 1, 2), ("a", 2, 5), ("k2t_stage_search", 5, 6),
      ("g", 6, 8), ("k2t_stage_end", 8, 9), ("clone", 9, 10), ("k2t_stage_fbank", 10, 11),
      ("f", 11, 12), ("k2t_stage_encoder", 12, 13), ("b", 13, 15), ("k2t_stage_search", 15, 16),
      ("g", 16, 17)],
     {"fbank": 3, "encoder": 7, "search": 5, "copies": 2}),
    # streaming, overlapping intervals counted once, two window slots
    ([("k2t_stage_fbank", 0, 1), ("f", 1, 3), ("f2", 2, 4), ("k2t_stage_encoder", 4, 5),
      ("e", 5, 6), ("k2t_stage_freeze", 6, 7), ("z", 7, 8), ("k2t_stage_fbank", 8, 9),
      ("k2t_stage_encoder", 9, 10), ("k2t_stage_freeze", 10, 11), ("k2t_stage_search", 11, 12),
      ("k2t_stage_end", 12, 13)],
     {"fbank": 5, "encoder": 3, "freeze": 3, "search": 1, "copies": 1}),
    ([("x", 0, 1)], {"copies": 1}),
])
def test_stage_split_sums_each_stage_by_its_markers(events, want):
    assert _chip_smoke().stage_split(events) == pytest.approx(want)


END = "k2t_stage_end"


@pytest.mark.parametrize("names,reps,want", [
    # one uncounted call, two counted, one uncounted
    (["f", "s", END, "f", "a", END, "f", "b", END, "f", "s", END], 2,
     ["f", "a", END, "f", "b", END]),
    # the first call's head and the last call's tail, its marker too, lost
    (["s", END, "f", "a", END, "f"], 1, ["f", "a", END]),
])
def test_counted_window_takes_the_counted_calls_between_the_uncounted_ones(names, reps, want):
    """``chip_smoke.device_trace`` counts the events of the calls bracketed
    by an uncounted call before and after, by their end markers."""
    assert names[_chip_smoke().counted_window(names, reps)] == want


@pytest.mark.parametrize("names", [
    ["f", END, "f", END, "f"],  # two counted calls' end markers lost
    ["f", END, "f", END, "f", END, "f", END, "f", END],  # a call more than the count
])
def test_counted_window_refuses_another_number_of_calls(names):
    with pytest.raises(AssertionError, match="markers"):
        _chip_smoke().counted_window(names, 2)


# -- on the card --------------------------------------------------------------


def _node_records(graph) -> list[str]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as f:
            return re.split(r'\n(?="graph_\d+_node_\d+"\[)', f.read())[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["offline", "online"])
def test_replays_carry_each_marker_once_in_stage_order(kind, monkeypatch):
    """A replay's profiler trace holds each marker once per replay, in stage
    order; a capture holds exactly one kernel node more per marker than the
    same capture without markers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    if kind == "offline":
        rec = OfflineRecognizer(cuda, device="cuda")
        streams = _offline_streams(rec)
        run = lambda: rec.end_decode(rec.begin_decode(streams))  # noqa: E731
        order = ["fbank", "encoder", "search", "end"]
    else:
        rec = OnlineRecognizer(cuda, max_lanes=2, device="cuda")
        streams = [rec.create_online_stream()]
        streams[0].add_samples(_pcm(rec.window_samples + 8 * rec.hop_samples))
        run = lambda: rec.end_step(rec.begin_step(streams))  # noqa: E731
        order = ["fbank", "encoder", "freeze", "search", "end"]
    run()  # the warm-up (it builds and loads the markers) and the capture
    (entry,) = rec.program.entries.values()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    marks = [e.name[len(profiling.MARKER_PREFIX):] for e in
             sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA and e.name.startswith(profiling.MARKER_PREFIX)]
    assert marks == order * 3

    fn = rec._decode if kind == "offline" else rec._step
    nodes = {}
    for marked in (True, False):
        if not marked:
            monkeypatch.setattr(profiling, "stage", lambda name, device: None)
        graphs = CudaGraphs(rec.device)  # a pool of its own
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        with torch.inference_mode(), torch.cuda.graph(graph, pool=graphs.pool,
                                                      stream=graphs.stream):
            fn(*entry.inputs)  # runs nothing: a capture
        nodes[marked] = _node_records(graph)
        del graph
    assert len(nodes[True]) - len(nodes[False]) == len(order)
    assert sum(profiling.MARKER_PREFIX in n for n in nodes[True]) == len(order)
    assert not any(profiling.MARKER_PREFIX in n for n in nodes[False])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["offline", "online"])
def test_replays_with_and_without_markers_agree_bit_for_bit(kind, monkeypatch):
    """``_decode`` (``_step``) captured with its markers and captured with
    ``stage`` a no-op, each replayed from the same static inputs (and the
    same lane pool): the outputs (every pool leaf) equal bit for bit, and
    equal the recognizer's own replay's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    cuda = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    if kind == "offline":
        rec = OfflineRecognizer(cuda, device="cuda")
        streams = _offline_streams(rec)
        rec.get_results(streams)  # the warm-up (it loads the markers) and the capture
        fn, pool = rec._decode, ()
    else:
        rec = OnlineRecognizer(cuda, max_lanes=2, device="cuda")
        streams = [rec.create_online_stream()]
        streams[0].add_samples(_pcm(rec.window_samples + 8 * rec.hop_samples))
        rec.end_step(rec.begin_step(streams))  # the warm-up and the capture
        fn, pool = rec._step, []
        tree_map(lambda t: pool.append(t), rec._pool())
    (entry,) = rec.program.entries.values()
    start = [t.clone() for t in pool]

    def replayed(graph, outputs):
        for t, t0 in zip(pool, start):
            t.copy_(t0)
        graph.replay()
        torch.cuda.synchronize()
        return [t.clone() for t in tuple(outputs) + tuple(pool)]

    got = {"program": replayed(entry.graph, entry.outputs)}
    for marked in (True, False):
        if not marked:
            monkeypatch.setattr(profiling, "stage", lambda name, device: None)
        with torch.inference_mode(), rec._precision():
            graph, outputs = CudaGraphs(rec.device).capture(fn, entry.inputs)  # runs nothing
        got[marked] = replayed(graph, outputs)
        del graph
    assert len(got[True]) == len(got[False]) == len(got["program"]) > 2
    for a, b, c in zip(got[True], got[False], got["program"]):
        assert torch.equal(a, b) and torch.equal(a, c)
