"""What the system records of itself, for the readers of its stages, host
parts and set-up (``<quantity>_ms.<moves>``, ``capture_s.setup``).

* Stage markers (device): the system launches one empty kernel,
  ``k2t_stage_<stage>``, where each stage of a replay begins: fbank,
  encoder, [freeze,] search, and ``end`` after the search.  A stage's time
  is the union of the device intervals from its marker to the next one,
  each interval going to the last marker that began at or before it;
  intervals before the span's first marker go to the stage that marker
  ends (the stage whose marker came before it in the span); those from
  ``end`` to the next ``fbank`` (the copies into the graph's inputs and of
  its outputs) go to no stage.  Per replay: over the traced span's
  replays, as ``replay_ms``.
* Host spans: ``(name, start_ns, end_ns)`` on ``time.perf_counter_ns``, the
  harness's clock, read from the system's ring.  A quantity is the median
  duration of the spans of its names that began inside the replays before
  the traced span, as ``host_ms``.
* Counters: the system's, at the run's end.

Nothing of the system is imported: its tracing module is read where the run
has loaded it, and a system without spans, counters or markers gives
nothing to read (None).
"""

from __future__ import annotations

import bisect
import sys

from asrbench.core import yardstick

MARKER = "k2t_stage_"
TRACING = "k2transducerasr_tpu_torch.utils.profiling"


def stage_split(device) -> dict:
    """{stage: seconds} over ``device``'s (name, start s, end s) events."""
    events = sorted(device, key=lambda e: e[1])
    marks = [n[len(MARKER):] for n, _, _ in events if n.startswith(MARKER)]
    if not marks:
        return {}
    before = {}
    for prev, cur in zip(marks, marks[1:]):
        before.setdefault(cur, prev)
    current = before.get(marks[0], "end")
    parts: dict = {}
    for n, s, e in events:
        if n.startswith(MARKER):
            current = n[len(MARKER):]
        if current != "end":
            parts.setdefault(current, []).append((s, e))
    return {k: yardstick.union_length(v) for k, v in parts.items()}


def stage_ms(ctx, stage: str):
    """The stage's device ms per replay in the traced span."""
    n = len(ctx.traced)
    if ctx.trace is None or not n:
        return None
    got = stage_split(ctx.trace.device).get(stage)
    return None if got is None else got / n * 1e3


def _tracing(attr: str):
    return getattr(sys.modules.get(TRACING), attr, None)


def span_ms(ctx, names: tuple):
    """The median ms of the spans named in ``names`` that began inside a
    replay before the traced span."""
    ring = _tracing("spans")
    recs = ctx.untraced
    if ring is None or not recs:
        return None
    windows = sorted((r["t0"], r["t1"]) for r in recs)
    starts = [s for s, _ in windows]
    reach, hi = [], float("-inf")  # the latest end among the replays begun so far
    for _, e in windows:
        hi = max(hi, e)
        reach.append(hi)
    durations = []
    for name, s, e in ring():
        if name not in names:
            continue
        t = s / 1e9
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and reach[i] >= t:
            durations.append((e - s) / 1e6)
    return ctx.median(durations)


def counter(name: str):
    counters = _tracing("counters")
    return None if counters is None else counters().get(name)
