"""Profiling helpers — PyTorch port of ``k2transducerasr_tpu/utils/profiling.py``.

``trace(log_dir)``: context manager around ``torch.profiler`` that records
CPU activity, and CUDA activity where a card is present, and writes a
Chrome/TensorBoard trace into ``log_dir``.
``Stopwatch``: wall-clock section timing with an audio-seconds meter.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``<log_dir>/trace_<pid>.json``
    (Chrome trace format, which TensorBoard's profiler plugin and
    chrome://tracing read).  Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class Stopwatch:
    """Accumulates wall time + processed audio seconds; reports RTF and
    audio-s/s (the framework's first-class throughput meter)."""

    def __init__(self):
        self.wall = 0.0
        self.audio = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self, audio_seconds: float = 0.0):
        if self._t0 is not None:
            self.wall += time.time() - self._t0
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
