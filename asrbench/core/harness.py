"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the weights from the seed on the device, fits the joiner with
the plain reference (which is then freed; its seconds are logged apart and
left out of ``setup_s``), builds the system, makes the traffic's audio and
warms exactly the shapes the traffic uses.  The window drives the system for
``seconds`` with one of two loops, named by the traffic mix:

* ``offline_batches``: a backlog of equal segments in batches of ``rows``,
  a closed loop through the 2-deep ``begin_decode``/``end_decode``
  pipeline; the rate is every batch's audio over the time from the first
  ``begin_decode`` to the last ``end_decode``.
* ``stream_open``: ``streams`` users, each running sessions back to back,
  whose audio is pushed in hop-sized pieces when it is due (an open loop);
  whenever a stream holds a window the loop calls ``begin_step`` on every
  live stream, 2-deep with ``end_step``.  A chunk is timed from when its
  last piece was due to the ``end_step`` that returns its result.

With ``trace`` a profiler covers a span of the window (``trace_s`` of the
mix, starting a third of the way in, on synchronised edges) and the
per-layer readers (``asrbench/metrics``) take their numbers from it.  The
work each replay did (FLOPs, each kernel's least time) is counted by the
model type's file (``asrbench/models``) and the decoding method's
(``asrbench/decoding``), found by the configuration's names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import math
import statistics
import sys
import time

import numpy as np
import torch

from asrbench.core import audio as audio_mod
from asrbench.core import check as check_mod
from asrbench.core import spec, system, traffic, weights
from asrbench.core import yardstick as Y
from asrbench.core.spec import Cell, reader
from asrbench.reference import fbank as fbank_ref
from asrbench.reference.transducer import Reference

perf = time.perf_counter


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# spans and the traced span
# ---------------------------------------------------------------------------


class Spans:
    """The benchmark's spans around its calls into the system: while the
    profiler runs each is a ``record_function`` scope (``asrbench.<name>``),
    so that the trace names what the host was doing."""

    def __init__(self):
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.tracing:
            with torch.profiler.record_function("asrbench." + name):
                yield
        else:
            yield


@dataclasses.dataclass
class Trace:
    window_s: float
    device: list  # (name, start s, end s) from the traced window's start
    host: list  # (span name, start s, end s)
    t0: float  # perf_counter at the traced window's start
    t1: float


class Tracer:
    """Starts the profiler ``lead`` seconds into the window and stops it
    ``length`` seconds later, the card synchronised at both edges."""

    def __init__(self, enabled: bool, lead: float, length: float, spans: Spans, cuda: bool):
        self.enabled, self.lead, self.length = enabled, lead, length
        self.spans, self.cuda = spans, cuda
        self.state = "idle"
        self.prof = self.marker = None
        self.t0 = self.t1 = None
        self.result: Trace | None = None

    def tick(self, start: float, now: float) -> None:
        if not self.enabled or self.state == "done":
            return
        if self.state == "idle" and now >= start + self.lead:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.marker = torch.profiler.record_function("asrbench.trace_window")
            self.marker.__enter__()
            self.spans.tracing = True
            self.t0 = perf()
            self.state = "on"
        elif self.state == "on" and now >= self.t0 + self.length:
            self.stop()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> None:
        if self.state != "on":
            return
        self._sync()
        self.t1 = perf()
        self.marker.__exit__(None, None, None)
        self.spans.tracing = False
        self.prof.__exit__(None, None, None)
        self.state = "done"

    def read(self) -> Trace | None:
        """The traced span's events, read once the window has closed (the
        reading takes seconds at these event counts)."""
        if self.state == "done" and self.result is None:
            self.result = self._read()
            self.prof = None
        return self.result

    def _read(self) -> Trace:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == "asrbench.trace_window")
        lo, hi = mark.start_ns(), mark.end_ns()
        dev, host = [], []
        for e in events:
            s, t = e.start_ns(), e.end_ns()
            if t <= lo or s >= hi:
                continue
            s, t = (max(s, lo) - lo) / 1e9, (min(t, hi) - lo) / 1e9
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                dev.append((e.name(), s, t))
            elif e.name().startswith("asrbench.") and e.name() != "asrbench.trace_window":
                host.append((e.name()[len("asrbench."):], s, t))
        return Trace((hi - lo) / 1e9, dev, host, self.t0, self.t1)


# ---------------------------------------------------------------------------
# the run's shared state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    cell: Cell
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: torch.device
    spans: Spans
    tracer: Tracer
    model: object  # the model type's file (asrbench/models)
    decoding: object  # the decoding method's file (asrbench/decoding)
    rec: object = None
    records: list = dataclasses.field(default_factory=list)  # one per replay
    served: list = dataclasses.field(default_factory=list)  # finished requests
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)
    window_start: float | None = None  # when the window opened, if traffic ran before

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def dtype(self):
        return system.DTYPES[self.cfg["compute_dtype"]] or torch.float32

    def bandwidth(self) -> float:
        return Y.card_bandwidth(torch.cuda.get_device_name(0) if self.cuda else "")

    def search(self, rows: int, frames: int, emissions: int) -> dict:
        """The decoding method's work over ``rows`` lanes: FLOPs, bounds."""
        return self.decoding.work(self.cfg, self.model.output_dim(self.cfg), rows, frames,
                                  emissions, self.dtype(), self.bandwidth())


def token_ids(rec) -> dict:
    table = rec.bundle.tokens
    return {table[i]: i for i in range(len(table))}


# ---------------------------------------------------------------------------
# the joiner fit (on the reference, with its own greedy search)
# ---------------------------------------------------------------------------


def calibrate(cfg: dict, tree: dict, seed: int, device, streaming: bool) -> dict:
    """Fit the joiner to random weights, in the tree, with the reference on
    the seed's calibration audio; -> what was set.

    Random weights make an encoder whose output barely moves from frame to
    frame next to its mean, so every frame would give the same argmax.
    First the joiner's encoder projection is centred on the calibration
    frames' mean and scaled by ``encoder_proj_scale``; then the offset of
    the blank logit is chosen so that the reference's greedy search emits
    ``target_tokens_per_s`` (a trained model emits on 10-15% of frames): the
    largest of a grid of offsets that still emits that many, then of a finer
    grid inside the step it found, each grid one batched search.  The
    encoder runs once.  Raises if the density lands outside ``band``."""
    em = cfg["emission"]
    check_mod.tf32_off()
    ref = Reference(cfg, tree, device)
    n = traffic.seconds_to_samples(em["calibration_s"], cfg["frontend"]["sample_rate"])
    pcm = audio_mod.clips(em["calibration_clips"], n, int(seed) + 1, device)
    encs = [check_mod.encode(ref, p, streaming) for p in pcm]
    mu = torch.cat(encs).mean(dim=0)
    scale = float(em["encoder_proj_scale"])
    proj = tree["joiner"]["encoder_proj"]
    proj["w"].mul_(scale)
    proj["b"].copy_(-(mu @ proj["w"].to(mu.dtype)).to(proj["b"].dtype))
    ref.enc_w = proj["w"].to(torch.float32).clone()
    ref.enc_b = proj["b"].to(torch.float32).clone()
    secs = em["calibration_clips"] * em["calibration_s"]
    target, (lo_band, hi_band) = em["target_tokens_per_s"], em["band"]
    lo, hi = em["blank_offset_range"]
    for _ in range(2):
        grid = torch.linspace(lo, hi, 33, dtype=torch.float64)
        dens = ref.greedy_counts(encs, grid.float(), streaming).double() / secs
        ok = (dens >= target).nonzero().flatten()
        if not len(ok):
            raise RuntimeError(f"no blank offset in [{lo}, {hi}] emits {target} tokens/s")
        i = int(ok.max())
        if i == len(grid) - 1:
            raise RuntimeError(f"every blank offset in [{lo}, {hi}] emits over {target} tokens/s")
        lo, hi = float(grid[i]), float(grid[i + 1])
        got = float(dens[i])
    delta = lo
    del ref, encs
    if not lo_band <= got <= hi_band:
        raise RuntimeError(f"blank-offset calibration gives {got:.3f} tokens/s, outside "
                           f"{lo_band}-{hi_band}")
    tree["joiner"]["output"]["b"][0] += delta
    return {"blank_offset": delta, "reference_tokens_per_s": got}


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


class OfflineBatches:
    """A backlog of ``segment_s`` segments in batches of ``rows``, through the
    ``pipeline_depth``-deep pipeline (closed loop)."""

    def __init__(self, run: Run):
        self.run = run
        mix, sr = run.mix, run.cfg["frontend"]["sample_rate"]
        self.rows = int(mix["rows"])
        self.n = traffic.seconds_to_samples(mix["segment_s"], sr)
        nb = int(mix["distinct_batches"])
        self.pcm = audio_mod.clips(nb * self.rows, self.n, run.seed, run.device)
        self.fl = audio_mod.as_float(self.pcm)
        self.order = traffic.order(nb * self.rows, run.seed, 3)
        self.nb = nb
        self.audio_s = self.rows * self.n / sr
        self.ids = token_ids(run.rec)
        raw = fbank_ref.num_frames(self.n, run.cfg["frontend"])
        bucket = run.cfg["recognizer"]["frame_bucket"]
        t_pad = max(bucket, -(-raw // bucket) * bucket)
        self.work = run.model.offline_work(run.cfg, self.rows, raw, t_pad, run.dtype(),
                                           run.bandwidth(), run.tracer.enabled)

    def batch(self, k: int) -> list:
        idx = self.order[(k % self.nb) * self.rows:(k % self.nb + 1) * self.rows]
        out = []
        for i in idx:
            s = self.run.rec.create_offline_stream()
            s.add_samples(self.fl[i])
            out.append(s)
        return out, idx

    def warm(self):
        rec = self.run.rec
        for k in range(2):
            streams, _ = self.batch(k)
            rec.end_decode(rec.begin_decode(streams))
        self.run.sync()

    def window(self):
        run, rec, spans = self.run, self.run.rec, self.run.spans
        t0 = perf()
        run.tracer.tick(t0, t0)
        k = 0

        def begin(k):
            streams, idx = self.batch(k)
            tb = perf()
            with spans("begin_decode"):
                h = rec.begin_decode(streams)
            return h, idx, tb, perf() - tb

        pending = begin(k)
        done_audio, t_last = 0.0, t0
        while pending is not None:
            now = perf()
            run.tracer.tick(t0, now)
            nxt = None
            if now - t0 < run.seconds:
                k += 1
                nxt = begin(k)
            h, idx, tb, host_b = pending
            with spans("wait"):
                if h.event is not None:
                    h.event.synchronize()
            te = perf()
            with spans("end_decode"):
                res = rec.end_decode(h)
            t_last = perf()
            done_audio += self.audio_s
            run.attempted += len(idx)
            toks = [[self.ids[t] for t in r.tokens] for r in res]
            em = sum(len(t) for t in toks)
            fr = self.work["out_frames"] * self.rows
            search = run.search(self.rows, fr, em)
            run.records.append(dict(
                t0=tb, t1=t_last, host_s=host_b + (t_last - te),
                bounds={**self.work["bounds"], **search["bounds"]}, frames=fr, emissions=em,
                flops=self.work["flops"] * self.rows + search["flops"]))
            for i, t, r in zip(idx, toks, res):
                run.served.append((int(i), t, list(r.timestamps)))
            pending = nxt
        run.tracer.stop()
        run.e2e["offline_audio_s_per_s"] = done_audio / (t_last - t0)
        run.notes["batches"] = len(run.records)
        run.notes["window_s"] = t_last - t0

    def sample(self) -> list:
        """``check_requests`` finished requests drawn from the seed."""
        run = self.run
        n = len(run.served)
        pick = traffic.rng(run.seed, 4).choice(n, size=min(int(run.mix["check_requests"]), n),
                                               replace=False)
        return [check_mod.Served(self.pcm[run.served[j][0]], run.served[j][1], run.served[j][2])
                for j in pick]


@dataclasses.dataclass
class Session:
    slot: int
    clip: int
    start: float  # when its audio began (its first piece is due a window later)
    windows: int
    stream: object = None
    pushed: int = 0
    stepped: int = 0
    answered: int = 0  # windows whose result has come back
    tokens: list = dataclasses.field(default_factory=list)
    stamps: list = dataclasses.field(default_factory=list)


class StreamOpen:
    """``streams`` users on a pool of ``max_lanes`` lanes, each running
    sessions back to back; audio pushed in hop-sized pieces as it is due."""

    def __init__(self, run: Run):
        self.run = run
        rec, mix = run.rec, run.mix
        self.sr = run.cfg["frontend"]["sample_rate"]
        self.win, self.hop = rec.window_samples, rec.hop_samples
        self.sessions = traffic.Sessions(mix, run.seed, self.hop / self.sr)
        longest = traffic.seconds_to_samples(mix["session_s"]["max"], self.sr)
        self.n_clips = int(mix["distinct_sessions"])
        self.pcm = audio_mod.clips(self.n_clips, longest, run.seed, run.device)
        self.fl = audio_mod.as_float(self.pcm)
        self.ids = token_ids(rec)
        n = self.sessions.streams
        # the first sessions are already under way when traffic starts: each
        # has the mix's residual share of its duration left
        self.residual = ((np.arange(n) + 0.5) / n)[traffic.order(n, run.seed, 5)]
        self.lanes = run.cfg["recognizer"]["max_lanes"]
        self.work = run.model.stream_work(run.cfg, self.lanes, run.dtype(), run.bandwidth(),
                                          run.tracer.enabled)
        self.next_clip = 0
        self.finished: list[Session] = []

    def piece(self, s: Session, j: int) -> tuple[int, int]:
        a = 0 if j == 0 else self.win + (j - 1) * self.hop
        return a, self.win + j * self.hop

    def due(self, s: Session, j: int) -> float:
        return s.start + self.piece(s, j)[1] / self.sr

    def new_session(self, slot: int, start: float, duration: float) -> Session:
        n = traffic.seconds_to_samples(duration, self.sr)
        w = max(1, traffic.windows_in(n, self.win, self.hop))
        s = Session(slot, self.next_clip % self.n_clips, start, w)
        self.next_clip += 1
        return s

    def warm(self):
        """One stream through the step's one graph (capture, then a
        replay), then given back: a later stream resets its lane."""
        rec = self.run.rec
        st = rec.create_online_stream()
        st.add_samples(self.fl[0, : self.win + self.hop])
        for _ in range(2):
            rec.end_step(rec.begin_step([st]))
        rec.dispose_stream(st)
        self.run.sync()

    def window(self):
        """Traffic starts ``lead_s`` before the window (counted as set-up),
        so that the window opens on a pool in its steady state; chunks due
        before it opens are served and not counted."""
        run, rec, spans = self.run, self.run.rec, self.run.spans
        t_gen = perf()
        t0 = t_gen + float(run.mix["lead_s"])
        run.window_start = t0
        t_end = t0 + run.seconds
        slots: list[Session] = []
        heap = []  # (due, slot)
        for i in range(self.sessions.streams):
            d = self.sessions.next_duration() * float(self.residual[i])
            phase = float(self.sessions.phases[i])
            s = self.new_session(i, t_gen + phase - self.win / self.sr, d)
            slots.append(s)
            heapq.heappush(heap, (self.due(s, 0), i))
        lateness, lat = [], []
        pending = None  # (handle, streams, sessions, chunks (session, j, due), t begin, host s)
        pending_windows = 0

        def finish(p):
            nonlocal pending_windows
            h, live, sess, chunks, tb, host_b = p
            with spans("wait"):
                if h[2] is not None:
                    h[2].synchronize()
            te = perf()
            with spans("end_step"):
                res = rec.end_step(h)
            t1 = perf()
            emitted = 0
            for r, s in zip(res, sess):
                toks = [self.ids[t] for t in r.tokens]
                emitted += max(0, len(toks) - len(s.tokens))
                s.tokens, s.stamps = toks, list(r.timestamps)
            for s, j, due in chunks:
                if due >= t0:
                    lat.append((due, t1 - due))
                s.answered = max(s.answered, j + 1)
            ready = len(chunks)
            fr = ready * self.work["out_frames"]
            if tb >= t0:  # steps before the window opened are not counted
                search = run.search(self.lanes, fr, emitted)
                run.records.append(dict(
                    t0=tb, t1=t1, host_s=host_b + (t1 - te),
                    bounds={**self.work["bounds"], **search["bounds"]}, frames=fr,
                    emissions=emitted, ready=ready,
                    flops=ready * self.work["flops"] + search["flops"]))
            for s, _, _ in chunks:
                if s.answered == s.windows and s.stream is not None:
                    rec.dispose_stream(s.stream)
                    s.stream = None
                    self.finished.append(s)
                    nxt = self.new_session(s.slot, self.due(s, s.windows - 1) - self.win / self.sr,
                                           self.sessions.next_duration())
                    slots[s.slot] = nxt
                    heapq.heappush(heap, (self.due(nxt, 0), s.slot))
            pending_windows -= ready

        while True:
            now = perf()
            if now >= t0:
                run.tracer.tick(t0, now)
            with spans("generator"):
                while heap and heap[0][0] <= now and heap[0][0] < t_end:
                    due, i = heapq.heappop(heap)
                    s = slots[i]
                    if s.stream is None:  # a session's first piece: its lane
                        s.stream = rec.create_online_stream()
                    a, b = self.piece(s, s.pushed)
                    s.stream.add_samples(self.fl[s.clip, a:b])
                    s.pushed += 1
                    pending_windows += 1
                    if due >= t0:
                        lateness.append(now - due)
                        run.attempted += 1
                    if s.pushed < s.windows:
                        heapq.heappush(heap, (self.due(s, s.pushed), i))
            live_sess = [s for s in slots if s.stream is not None]
            ready = [s for s in live_sess if s.pushed > s.stepped]
            if ready:
                live = [s.stream for s in live_sess]
                tb = perf()
                with spans("begin_step"):
                    h = rec.begin_step(live)
                host_b = perf() - tb
                chunks = []
                for s in ready:
                    chunks.append((s, s.stepped, self.due(s, s.stepped)))
                    s.stepped += 1
                nxt = (h, live, live_sess, chunks, tb, host_b)
                if pending is not None:
                    finish(pending)
                pending = nxt
                continue
            if pending is not None:
                finish(pending)
                pending = None
                continue
            if now >= t_end or not heap or heap[0][0] >= t_end:
                if pending_windows == 0:
                    break
            wait = (heap[0][0] - perf()) if heap else 0.0
            if wait > 0:
                with spans("idle"):
                    time.sleep(min(wait, 0.005))
        run.tracer.stop()
        ms = [x for _, x in lat]
        run.e2e["stream_chunk_p95_ms"] = Y.percentile(ms, 95) * 1e3
        steps = len(run.records)
        third = [[x for d, x in lat if t0 + k * run.seconds / 3 <= d < t0 + (k + 1) * run.seconds / 3]
                 for k in (0, 2)]
        run.notes.update(
            chunks=len(lat), steps=steps, p50_ms=Y.percentile(ms, 50) * 1e3,
            p95_first_third_ms=Y.percentile(third[0], 95) * 1e3 if third[0] else None,
            p95_last_third_ms=Y.percentile(third[1], 95) * 1e3 if third[1] else None,
            mean_ready=(sum(r["ready"] for r in run.records) / steps) if steps else 0.0,
            late_p95_ms=Y.percentile(lateness, 95) * 1e3 if lateness else 0.0,
            late_max_ms=max(lateness) * 1e3 if lateness else 0.0,
            sessions_ended=len(self.finished), window_s=perf() - t0)
        self.live_end = [s for s in slots if s.stream is not None]

    def sample(self) -> list:
        """``check_sessions`` sessions that were served, the longest among
        them, each with the samples its answered windows covered."""
        cand = [s for s in self.finished + self.live_end if s.answered > 0]
        k = min(int(self.run.mix["check_sessions"]), len(cand))
        pick = list(traffic.rng(self.run.seed, 4).choice(len(cand), size=k, replace=False))
        top = max(range(len(cand)), key=lambda j: cand[j].answered)
        if top not in pick:
            pick[0] = top
        out = []
        for j in pick:
            s = cand[j]
            n = self.win + (s.answered - 1) * self.hop
            out.append(check_mod.Served(self.pcm[s.clip, :n], s.tokens, s.stamps))
        return out


LOOPS = {"offline_batches": OfflineBatches, "stream_open": StreamOpen}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, control: str | None = None) -> dict:
    """Set-up, window, check -> the result object (without the device
    fields the entry point adds).  ``control``: judge the control
    (``check.CONTROLS``) in the system's place on the same requests; the
    system's own reading is logged beside it."""
    t_start = perf() if t_start is None else t_start
    device = torch.device(device)
    cfg = dict(cell.config)
    mix = cell.traffic
    if cfg["recognizer"]["kind"] == "online":
        cfg["recognizer"] = dict(cfg["recognizer"], max_lanes=int(mix["max_lanes"]))
    streaming = cfg["recognizer"]["kind"] == "online"
    spans = Spans()
    lead = seconds / 3.0
    tracer = Tracer(trace, lead, min(float(mix["trace_s"]), seconds - lead), spans,
                    device.type == "cuda")
    run = Run(cell, cfg, mix, int(seed), float(seconds), device, spans, tracer,
              spec.model(cfg), spec.decoding(cfg))

    phases = {"imports": perf() - t_start}

    def mark(name):
        run.sync()
        phases[name] = perf() - t_start - sum(phases.values())

    tree = weights.make_tree(system.init_fns(cfg), seed, device, run.model.CONSTANT_RANGES)
    mark("weights")
    fit = calibrate(cfg, tree, seed, device, streaming)
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mark("calibration")
    run.rec = system.build(cfg, tree, device)
    mark("system")
    loop = LOOPS[mix["loop"]](run)
    mark("traffic")
    loop.warm()
    mark("warm")
    t_ready = perf()
    # the joiner fit is the reference's work on the benchmark's inputs: not set-up
    setup_s = t_ready - t_start - phases["calibration"]
    log("set-up phases, s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    log(f"the joiner fit (the reference's calibration) {phases['calibration']:.3f} s, "
        "not in setup_s")

    loop.window()
    tracer.read()
    if run.window_start is not None:  # traffic ran before the window: set-up
        setup_s += run.window_start - t_ready
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    sample = loop.sample()
    run.rec = None
    del loop.run
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    t_check = perf()
    verdict = check_mod.judge(cfg, tree, sample, device, streaming)
    if control is not None:
        sound = verdict
        verdict = check_mod.judge(cfg, tree, sample, device, streaming, control)
        log(f"the system's own reading {sound}; the {control} control's below")
    check_s = perf() - t_check

    limit = cell.limits.get("max_logit_gap")
    gap = verdict["max_logit_gap"]
    correct = limit is not None and math.isfinite(gap) and gap <= limit
    emitted = sum(r["emissions"] for r in run.records)
    frames = sum(r["frames"] for r in run.records)
    log(f"set-up {setup_s:.3f} s (joiner fit {fit}); window {run.notes}; served emission share {emitted / max(frames, 1):.4f} "
        f"of frames; check {check_s:.3f} s over {len(sample)} requests, {verdict}")
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed}
    if trace:
        metrics = {}
        ctx = Context(run, tracer.result)
        for m in cell.per_layer:
            v = reader(m["name"])(ctx, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        out["trace"] = tracer.result
        if tracer.result is not None:
            out["breakdown"] = breakdown(tracer.result)
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
        out["metrics"] = metrics
    out["memory_peak_bytes"] = int(peak)
    out["compared"] = {"max_logit_gap": {"value": gap, "limit": limit}}
    return out


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the window's per-replay records (host
    spans, the work each replay did, computed from the cell's shapes) and
    the traced span (device events, host scopes)."""

    run: Run
    trace: Trace | None

    @property
    def traced(self) -> list:
        if self.trace is None:
            return []
        return [r for r in self.run.records if self.trace.t0 <= r["t0"] < self.trace.t1]

    @property
    def untraced(self) -> list:
        """The replays before the traced span (the profiler slows the host,
        and an open loop takes a while to recover), or all of them when
        fewer than ten came before it."""
        t = self.trace
        out = [r for r in self.run.records if t is None or r["t1"] < t.t0]
        return out if len(out) >= 10 else self.run.records

    def device_intervals(self, name_part: str | None = None) -> list:
        if self.trace is None:
            return []
        return [(s, e) for n, s, e in self.trace.device if name_part is None or name_part in n]

    def median(self, values):
        return statistics.median(values) if values else None


def breakdown(t: Trace) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the benchmark span the host was in (its innermost)."""
    by_name: dict[str, float] = {}
    for n, s, e in t.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = Y.gaps([(s, e) for _, s, e in t.device], 0.0, t.window_s)
    named = []
    for s, e in sorted(gaps, key=lambda g: -(g[1] - g[0]))[:10]:
        mid = 0.5 * (s + e)
        inside = [h for h in t.host if h[1] <= mid <= h[2]]
        label = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "outside_spans"
        named.append([label, e - s])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": named}
