"""The readers of the system's stage markers, host spans and counters
(``asrbench/metrics/_program.py`` and the metrics on it) on a made-up traced
span, whose first and last replays are cut by its edges, and a filled ring;
and the parent's case, a system that records none of them: nothing to read.
"""

import sys
import types

import pytest

from asrbench.core import spec
from asrbench.core.harness import Context, Trace

TRACING = "k2transducerasr_tpu_torch.utils.profiling"


def _rec(t0, t1, host_s=0.0):
    return dict(t0=t0, t1=t1, host_s=host_s, bounds={}, flops=0.0)


def _mark(stage, at):
    return (f"k2t_stage_{stage}", at, at + 0.001)


# Offline, the span from 100.0 s to 101.0 s on the host clock; device times
# from the span's start.  Replay A began before the span (cut inside its
# encoder), B inside, C inside (cut inside its encoder at the right edge).
OFFLINE_DEVICE = [
    ("elementwise", 0.000, 0.040),  # A's encoder, before the span's first marker
    _mark("search", 0.040), ("rnnt_greedy", 0.041, 0.050),
    _mark("end", 0.050), ("Memcpy DtoH", 0.051, 0.055),  # no stage
    ("Memcpy DtoD", 0.200, 0.202),  # B's static inputs: before fbank, no stage
    _mark("fbank", 0.210), ("gemm", 0.211, 0.220),
    _mark("encoder", 0.220), ("elementwise", 0.221, 0.500), ("conv", 0.400, 0.600),
    _mark("search", 0.600), ("rnnt_greedy", 0.601, 0.620),
    _mark("end", 0.620), ("Memcpy DtoH", 0.621, 0.625),
    _mark("fbank", 0.700), ("gemm", 0.701, 0.710),
    _mark("encoder", 0.710), ("elementwise", 0.711, 1.000),
]
OFFLINE_RECORDS = [_rec(99.70, 100.10), _rec(100.15, 100.65), _rec(100.65, 101.20)]


def _ctx(device, records, t0=100.0, t1=101.0):
    run = types.SimpleNamespace(records=records)
    return Context(run, Trace(t1 - t0, device, [], t0, t1))


def _read(metric, ctx):
    return spec.reader(metric)(ctx, metric)


def test_offline_stages_per_replay_with_both_edges_cut():
    ctx = _ctx(OFFLINE_DEVICE, OFFLINE_RECORDS)
    assert len(ctx.traced) == 2  # B and C: A began before the span
    fbank = 0.010 + 0.010
    encoder = 0.040 + (0.600 - 0.220) + (1.000 - 0.710)  # A's cut part counts for encoder
    search = 0.010 + 0.020
    assert _read("fbank_ms.tput", ctx) == pytest.approx(fbank / 2 * 1e3)
    assert _read("encoder_ms.tput", ctx) == pytest.approx(encoder / 2 * 1e3)
    assert _read("search_ms.tput", ctx) == pytest.approx(search / 2 * 1e3)
    copies = 0.005 + 0.002 + 0.005
    replay = _read("replay_ms.tput", ctx)
    assert replay == pytest.approx((fbank + encoder + search + copies) / 2 * 1e3)
    assert _read("freeze_ms.tput", ctx) is None  # no freeze marker offline


# Streaming, one replay whose span opens on its fbank marker and closes
# inside the next replay's freeze stage.
STREAM_DEVICE = [
    ("Memcpy HtoD", 0.000, 0.002),  # the windows' copy: before fbank, no stage
    _mark("fbank", 0.010), ("gemm", 0.011, 0.015),
    _mark("encoder", 0.015), ("elementwise", 0.016, 0.055),
    _mark("freeze", 0.055), ("where", 0.056, 0.060), ("copy", 0.060, 0.062),
    _mark("search", 0.062), ("rnnt_greedy", 0.063, 0.064),
    _mark("end", 0.064), ("Memcpy DtoH", 0.065, 0.066),
    _mark("fbank", 0.100), ("gemm", 0.101, 0.105),
    _mark("encoder", 0.105), ("elementwise", 0.106, 0.145),
    _mark("freeze", 0.145), ("where", 0.146, 0.150),
]


def test_stream_stages_with_the_span_opening_on_a_marker():
    ctx = _ctx(STREAM_DEVICE, [_rec(100.0, 100.09), _rec(100.09, 100.2)], t1=100.15)
    assert len(ctx.traced) == 2
    assert _read("fbank_ms.stream", ctx) == pytest.approx(0.010 / 2 * 1e3)
    assert _read("encoder_ms.stream", ctx) == pytest.approx(0.080 / 2 * 1e3)
    assert _read("freeze_ms.stream", ctx) == pytest.approx(0.012 / 2 * 1e3)
    assert _read("search_ms.stream", ctx) == pytest.approx(0.002 / 2 * 1e3)


@pytest.fixture
def ring(monkeypatch):
    """Installs a made-up tracing module of the system: fill(spans, counters)."""
    def fill(spans=(), counters=None):
        mod = types.SimpleNamespace(spans=lambda: list(spans),
                                    counters=lambda: dict(counters or {}))
        monkeypatch.setitem(sys.modules, TRACING, mod)
    return fill


def _ns(s):
    return int(round(s * 1e9))


def test_host_parts_are_medians_of_spans_begun_in_the_untraced_replays(ring):
    """Twelve pipelined batches before the span (each record covers its own
    begin_decode, the next one's and its end_decode), then the span; spans
    of set-up and of the span are left out."""
    records, spans = [], [("begin_decode.pcm", _ns(1.0), _ns(1.5))]  # set-up's warm-up
    for k in range(12):
        t = 10.0 + k
        records.append(_rec(t, t + 1.5))
        spans += [("begin_decode.pcm", _ns(t), _ns(t + 0.010 + 0.001 * k)),
                  ("begin_decode.queue", _ns(t + 0.02), _ns(t + 0.021)),
                  ("end_decode.wait", _ns(t + 1.2), _ns(t + 1.4)),
                  ("end_decode.text", _ns(t + 1.4), _ns(t + 1.402))]
    records.append(_rec(30.0, 30.5))  # inside the span
    spans += [("begin_decode.pcm", _ns(30.0), _ns(30.9)), ("end_decode.text", _ns(30.4),
                                                             _ns(30.45))]
    ring(spans, {"program.capture_s": 0.75, "program.captures": 1})
    ctx = _ctx([], records, t0=29.0, t1=31.0)
    assert len(ctx.untraced) == 12
    assert _read("prep_ms.tput", ctx) == pytest.approx(15.5)  # the median of 10-21 ms
    assert _read("queue_ms.tput", ctx) == pytest.approx(1.0)
    assert _read("text_ms.tput", ctx) == pytest.approx(2.0)
    assert _read("capture_s.setup", ctx) == pytest.approx(0.75)


def test_streaming_host_parts_read_the_step_spans(ring):
    records = [_rec(10.0 + k, 10.5 + k) for k in range(3)]
    spans = []
    for k in range(3):
        t = 10.0 + k
        spans += [("begin_step.prep", _ns(t), _ns(t + 0.005)),
                  ("begin_step.queue", _ns(t + 0.005), _ns(t + 0.006)),
                  ("end_step.wait", _ns(t + 0.1), _ns(t + 0.2)),
                  ("end_step.text", _ns(t + 0.2), _ns(t + 0.203))]
    spans.append(("begin_step.prep", _ns(9.0), _ns(9.5)))  # before the first replay
    ring(spans)
    ctx = _ctx([], records, t0=20.0, t1=21.0)  # fewer than ten before: all of them
    assert _read("prep_ms.stream", ctx) == pytest.approx(5.0)
    assert _read("queue_ms.stream", ctx) == pytest.approx(1.0)
    assert _read("text_ms.stream", ctx) == pytest.approx(3.0)
    assert _read("capture_s.setup", ctx) is None  # no capture counted


NEW = ("fbank_ms.tput", "encoder_ms.stream", "freeze_ms.stream", "search_ms.tput",
       "prep_ms.tput", "queue_ms.stream", "text_ms.tput", "capture_s.setup")


@pytest.mark.parametrize("tracing", ["absent", "without_spans"])
def test_a_system_that_records_nothing_gives_nothing_to_read(monkeypatch, tracing):
    """The parent's case: no stage marker in the trace, and a tracing module
    that is not loaded or holds no ring and no counters."""
    if tracing == "absent":
        monkeypatch.delitem(sys.modules, TRACING, raising=False)
    else:
        monkeypatch.setitem(sys.modules, TRACING,
                            types.SimpleNamespace(trace=None, Stopwatch=None))
    device = [(n, s, e) for n, s, e in OFFLINE_DEVICE if not n.startswith("k2t_stage_")]
    ctx = _ctx(device, OFFLINE_RECORDS)
    for m in NEW:
        assert _read(m, ctx) is None, m
    empty = Context(types.SimpleNamespace(records=[]), None)
    for m in NEW:
        assert _read(m, empty) is None, m
