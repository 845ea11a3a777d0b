"""One program per input shape: the port's counterpart of the JAX
runtimes' shape-keyed ``jax.jit`` caches.  The offline recognizer's
``_build_decode_fn`` (``k2transducerasr_tpu/runtime/offline.py``) runs
fbank, the encoder, the joiner projection and the search as ONE compiled
program per (batch, frame bucket); the online recognizer's
``_build_step_fn`` (``runtime/online.py``) runs a streaming step over the
whole lane pool as ONE compiled program of one shape.

``DecodeProgram(fn, device)`` wraps a function of (int16 samples, int64
counts) that returns a tuple of output tensors: offline ``_decode``
(samples [rows, N], counts [rows]), keyed (rows, N); online ``_step``
(windows [L, W, n], counts [L]), keyed (L, W, n), which writes the lane
pool in place and returns nothing.  The inputs may lie on the device or on
the host: online ``begin_step`` passes its pinned host buffers, which go
straight into the static inputs, non-blocking.  Each key holds:

* the static inputs on ``device``, which every call fills with ``copy_``;
* on the card, a ``torch.cuda.CUDAGraph`` of ``fn``, captured at the first
  call of that shape after one eager warm-up run on the program's side
  stream, as PyTorch's documentation prescribes.  The warm-up builds the
  kernels, sets their shared-memory attributes and creates the cuBLAS and
  cuDNN handles, none of which may happen under capture.  The warm-up
  rule: an ``fn`` that writes state in place (the online step) passes
  ``idle``, a function of the static inputs that returns inputs on which
  ``fn`` changes nothing (every count 0), and the warm-up runs on those;
  otherwise the first call would apply its inputs twice, once in the
  warm-up and once in the replay.  The capture itself runs nothing;
* the static outputs the graph writes.

A call on the card is one replay on the caller's current stream (the
stream ``ops/cuda_build.launch`` launches on), and the outputs are cloned on
the device right after it, in stream order, so what a caller holds never
points into a buffer that a later replay of any graph overwrites.  Nothing
waits for the card but the first call of a shape (capture synchronises).
An op that capture refuses raises from that first call: there is no eager
fallback.

One caller stream.  The static inputs and the pool below are shared by
every call, so a program serves one stream: the stream of its first call
on the card.  A call on another stream raises (its replay could overlap
one still running on the first), and a lock holds each call's copy, replay
and clones together, so two threads on that stream do not interleave them.

Memory.  A program holds one graph per key it has seen and all of them
allocate from ONE memory pool (``torch.cuda.graph_pool_handle()``): each
capture may reuse what earlier captures freed, so the pool holds about the
largest key's working memory plus every key's static outputs
(``pool_bytes``).  Sharing is safe because the replays are serialised on
one stream and every replay's outputs are cloned before the next replay is
queued; the static inputs lie outside the pool.  A bound method ``fn`` is
held weakly: its owner keeps the program, not the other way round, so
dropping the owner frees the graphs and their pool without waiting for the
cycle collector.

Launch counts.  A replay runs no Python, so the kernels' wrappers
(``kernel_wrappers()``) do not count its launches.  Capture records how many
times each wrapper launched (its ``launches`` rose while ``fn`` was
captured, and is set back: nothing ran); every replay then adds those
numbers, so each count stays the number of launches the card ran.

Counters.  The program counts into ``utils/profiling``'s counters:
``program.replays``, ``program.captures`` and ``program.capture_s``, the
host seconds of each key's eager warm-up and capture together (capture
synchronises).

Precision.  The cuBLAS and cuDNN math modes (TF32 on or off) are fixed
into a graph when it is captured.  The recognizers' ``fn`` enters
``runtime/device.exact_f32`` itself, so its warm-up and capture run with
TF32 off whatever the caller's flags, and every replay keeps that; a
convolution over bf16-rounded operands asks for TF32 in its own call
(``ops/layers.conv_tf32``).

On the CPU each call runs ``fn`` eagerly on the static inputs and clones
its outputs: the plain route the tests drive.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
import weakref

import torch

from k2transducerasr_tpu_torch.decode import rnnt_beam, rnnt_greedy
from k2transducerasr_tpu_torch.ops import activations_cuda, attention_cuda, layers, norm_cuda
from k2transducerasr_tpu_torch.utils import profiling


def kernel_wrappers() -> tuple:
    """The wrappers that count their kernels' launches (``.launches``):
    K1, K2, G, B, S, the convolutions run with cuDNN's TF32 allowed
    (``ops/layers.conv_tf32``) and LN (``ops/norm_cuda.layernorm``)."""
    return (attention_cuda.relpos_attn_probs, attention_cuda.relpos_attn_ctx,
            rnnt_greedy.greedy_frames_skip, rnnt_beam.beam_frames_skip,
            activations_cuda.bias_swoosh, layers.conv_tf32, norm_cuda.layernorm)


@dataclasses.dataclass
class Entry:
    """One key's state: the static inputs and, on the card, its graph, the
    outputs the graph writes and each counter's launches per replay."""

    inputs: tuple[torch.Tensor, torch.Tensor]
    graph: object = None
    outputs: tuple = ()
    launches: tuple[int, ...] = ()


class CudaGraphs:
    """Warm-up and capture on ``device``: one side stream and one memory
    pool for every graph of a program."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def current_stream(self):
        return torch.cuda.current_stream(self.device)

    def warm_up(self, fn, inputs) -> None:
        caller = self.current_stream()
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            fn(*inputs)
        caller.wait_stream(self.stream)

    def capture(self, fn, inputs):
        """-> (graph, the outputs it writes)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            outputs = fn(*inputs)
        return graph, outputs

    def pool_bytes(self) -> int:
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class DecodeProgram:
    """``fn`` run once per call, keyed by the input shape; see the module
    docstring.  ``graphs``: the capture (default ``CudaGraphs(device)`` on
    the card, none on the CPU; a test passes a fake).  ``idle``: the
    warm-up's inputs from the static inputs, for an ``fn`` that writes
    state in place (default: the static inputs themselves)."""

    def __init__(self, fn, device: torch.device, graphs=None, idle=None):
        self._fn = weakref.WeakMethod(fn) if inspect.ismethod(fn) else lambda: fn
        self._idle = idle
        self.device = device
        self.counters = kernel_wrappers()
        if graphs is None and device.type == "cuda":
            graphs = CudaGraphs(device)
        self.graphs = graphs
        self.entries: dict[tuple[int, int], Entry] = {}
        self.stream = None  # the caller's stream, set at the first call with graphs
        self._lock = threading.Lock()

    @property
    def fn(self):
        return self._fn()

    def __len__(self) -> int:
        return len(self.entries)

    def __call__(self, samples: torch.Tensor, counts: torch.Tensor) -> tuple:
        with self._lock:
            if self.graphs is not None:
                self._check_stream()
            key = tuple(samples.shape)
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = self._new_entry(samples, counts)
            else:
                entry.inputs[0].copy_(samples, non_blocking=True)
                entry.inputs[1].copy_(counts, non_blocking=True)
            if entry.graph is None:
                return tuple(t.clone() for t in self.fn(*entry.inputs))
            entry.graph.replay()
            profiling.count("program.replays")
            for counter, n in zip(self.counters, entry.launches):
                counter.launches += n
            return tuple(t.clone() for t in entry.outputs)

    def _check_stream(self) -> None:
        stream = self.graphs.current_stream()
        if self.stream is None:
            self.stream = stream
        elif stream != self.stream:
            raise RuntimeError(f"program called on {stream}; its graphs serve one "
                               f"caller stream, {self.stream}")

    def _new_entry(self, samples, counts) -> Entry:
        inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                       .copy_(x, non_blocking=True) for x in (samples, counts))
        if self.graphs is None:
            return Entry(inputs)
        t0 = time.perf_counter()
        self.graphs.warm_up(self.fn, inputs if self._idle is None else self._idle(*inputs))
        before = [c.launches for c in self.counters]
        try:
            graph, outputs = self.graphs.capture(self.fn, inputs)
            launches = tuple(c.launches - n for c, n in zip(self.counters, before))
        finally:  # the captured launches did not run
            for c, n in zip(self.counters, before):
                c.launches = n
        profiling.count("program.captures")
        profiling.count("program.capture_s", time.perf_counter() - t0)
        return Entry(inputs, graph, tuple(outputs), launches)

    def pool_bytes(self) -> int:
        """The card's memory held in the graphs' pool (0 without graphs)."""
        return 0 if self.graphs is None else self.graphs.pool_bytes()
