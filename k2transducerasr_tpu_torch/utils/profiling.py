"""The port's tracing: host spans and counters, device stage markers that
survive a CUDA-graph replay, the operator's profiler export and the demos'
stopwatch.  PyTorch port of ``k2transducerasr_tpu/utils/profiling.py``
(``trace``, ``Stopwatch``), extended.

Spans (host).  ``with span(name):`` appends ``(name, start_ns, end_ns)``,
timed by ``time.perf_counter_ns``, to a process-wide ring of ``RING_SIZE``
entries (the oldest drop out).  ``perf_counter`` is the clock of a caller
that times the API calls itself, so a span lands on its timeline with no
conversion.  While a torch profiler runs, the span is also a
``record_function`` scope of the same name, which a profiler trace shows
beside the device's events.  No switch: a span costs two clock reads and one
append.  The recognizers open one span of each name per API call:

    begin_decode.pcm    the host batch and its upload (``pcm_batch``)
    begin_decode.queue  the program call, the readback and the event
    end_decode.wait     the wait on the event
    end_decode.text     the results
    begin_step.prep     the ready streams, the pinned buffers, the windows
    begin_step.queue    the program call (or eager step), readback, event
    end_step.wait       the wait on the event
    end_step.text       the results

Counters (host).  ``count(name, n)`` adds to a process-wide dict:
``program.replays``, ``program.captures`` and ``program.capture_s`` (each
key's eager warm-up plus its capture, host clock) from
``runtime/program.DecodeProgram``; ``online.windows`` and
``online.lanes_stepped`` (the windows a step takes and the lanes with one)
from ``OnlineRecognizer.begin_step``.  The kernels' own ``.launches``
counters (``runtime/program.kernel_wrappers``) are apart and unchanged.
What an operator reads from them (a capture while serving, the lanes a
streaming replay steps) is in README's port section.

Stage markers (device).  ``stage(name, device)`` launches one empty kernel,
``k2t_stage_<name>`` (``csrc/stage_marks.cu``), on the current stream: a
point in stream order where the stage ``name`` begins and the one before it
ends.  Under capture the launch is a graph node, so every replay carries the
marker into a device trace by name; a replay runs no Python, and a
``record_function`` scope would be recorded once, at capture.  An eager
call launches the same kernel, so one mechanism marks both paths.  On the
CPU it does nothing.  The marks, in order (``STAGES``): ``_decode`` (its
``encode``) fbank, encoder, then search, end; ``_step`` fbank, encoder and
freeze for each window slot, then search, end.  What lies between ``end``
and the next ``fbank`` is the copies into the static inputs and of the
outputs, outside any stage.

``spans()``, ``counters()`` read the ring and the counters; ``reset()``
clears both.  ``trace(log_dir)`` writes a Chrome trace of a block: around a
serving loop it shows the spans, the stage markers and the kernels on one
timeline.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time

import torch

from k2transducerasr_tpu_torch.ops import cuda_build

RING_SIZE = 65536
STAGES = ("fbank", "encoder", "freeze", "search", "end")
STEP_STAGES = STAGES[:4]  # a streaming step's stages, in order
MARKER_PREFIX = "k2t_stage_"

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)  # appends are atomic
_counters: dict[str, float] = {}
_counters_lock = threading.Lock()
_clock = time.perf_counter_ns


class _Span:
    __slots__ = ("name", "start", "scope")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.scope = None
        if torch.autograd._profiler_enabled():
            self.scope = torch.profiler.record_function(self.name)
            self.scope.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        _ring.append((self.name, self.start, end))


def span(name: str) -> _Span:
    """A context manager that records the block as ``(name, start_ns,
    end_ns)`` in the ring (and a profiler scope while a profiler runs).
    Not for a per-stream, per-window or per-token loop."""
    return _Span(name)


def count(name: str, n: float = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> list[tuple[str, int, int]]:
    """The ring, oldest first: ``(name, start_ns, end_ns)`` on
    ``time.perf_counter_ns``."""
    return list(_ring)


def counters() -> dict[str, float]:
    with _counters_lock:
        return dict(_counters)


def reset() -> None:
    _ring.clear()
    with _counters_lock:
        _counters.clear()


# ---------------------------------------------------------------------------
# stage markers
# ---------------------------------------------------------------------------

_mark_fn = None


def _marker():
    """The C entry point ``k2t_stage_mark(which, stream)``, built and loaded
    at the first marker: that must be an eager call (a program's warm-up),
    since neither may happen under capture."""
    global _mark_fn
    if _mark_fn is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stage markers' library loads at the first eager marker, "
                               "never under capture: run the function once eagerly first")
        _mark_fn = cuda_build.function("stage_marks", "k2t_stage_mark",
                                       [ctypes.c_int, ctypes.c_void_p])
    return _mark_fn


def stage(name: str, device: torch.device) -> None:
    """Mark the start of stage ``name`` (one of ``STAGES``) on ``device``'s
    current stream; see the module docstring."""
    which = STAGES.index(name)
    if device.type != "cuda":
        return
    if device.index is None:  # "cuda": the current device
        device = torch.device("cuda", torch.cuda.current_device())
    cuda_build.launch("stage_marks", _marker(), device, which)


# ---------------------------------------------------------------------------
# the operator's export and the demos' stopwatch
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``<log_dir>/trace_<pid>.json``
    (Chrome trace format, which TensorBoard's profiler plugin and
    chrome://tracing read).  CPU activity, and CUDA activity where a card
    is present: around a serving loop the trace holds the recognizers'
    spans, the stage markers of every replay and the kernels on one
    timeline.  Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class Stopwatch:
    """Accumulates wall time (``time.perf_counter``) + processed audio
    seconds; reports RTF and audio-s/s (the framework's first-class
    throughput meter)."""

    def __init__(self):
        self.wall = 0.0
        self.audio = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, audio_seconds: float = 0.0):
        if self._t0 is not None:
            self.wall += time.perf_counter() - self._t0
            self._t0 = None
        self.audio += audio_seconds

    @property
    def rtf(self) -> float:
        return self.wall / max(self.audio, 1e-9)

    @property
    def audio_s_per_s(self) -> float:
        return self.audio / max(self.wall, 1e-9)

    def report(self) -> str:
        return (
            f"elapsed_milliseconds:{self.wall * 1000:.4f}\n"
            f"total_duration:{self.audio * 1000:.0f}\n"
            f"rtf:{self.rtf}"
        )
