"""Online (streaming) recognizer — PyTorch port of
``k2transducerasr_tpu/runtime/online.py``.

The recognizer owns a lane pool on its device: the encoder's streaming state
and the decode state of its method (``GreedyState``, ``BeamState`` or
``CtcState``), each leaf ``[max_lanes, ...]``, plus each lane's count of
encoder frames decoded.  A stream is a host sample buffer and a lane.  Each
step takes one window (``windows_per_step`` of them at most) from every
ready stream and runs, as the reference's one compiled step does, on EVERY
lane of the pool: int16 windows ``[L, W, n]`` and counts ``wcount [L]`` ->
fbank -> encoder ``streaming_step`` -> one of blank-skipping greedy search,
blank-skipping modified beam search (joiner projection first) or CTC greedy
(CTC head first).  Window slot k steps the lanes with ``wcount > k``: every
lane runs, and each state leaf keeps its old value on the others
(``_freeze``, the reference's ``_where_lane``); a lane with no window
decodes zero frames, which leaves its decode state as it was.  Every write
goes into the pool's leaves in place, so they never move.

Without a mesh ``begin_step`` runs the step through a
``runtime/program.DecodeProgram`` keyed by ``(L, W, n)``: on the card one
CUDA graph per recognizer, captured at the first step and replayed with one
launch per step, from one caller stream.  Its warm-up run (before the
capture) steps an idle pool, every ``wcount`` 0, which changes nothing, so
the first step is not applied twice.  Under a mesh the same step runs
eagerly on the rank's own lanes: its collectives (gloo) cannot be captured.
With dither, the step's noise is drawn once, here (``fbank.dither_noise``,
seeded 0, the eager draw of every call), and read by each window slot: a
graph cannot draw from an unregistered generator.  ``_step`` marks its
stages on the device (``utils/profiling.stage``: fbank, encoder and freeze
for each window slot, then search and end), marks that a replay carries;
``begin_step`` and ``end_step`` record their parts as host spans and count
the windows and lanes each step takes, and the bytes of encoder state its
freezes pass (``online.freeze_bytes``: the whole pool per window slot).

A recognizer serves one thread: its streams' buffers, its lane list and its
pool are shared, and a step's readback is queued after the replay outside
the program's lock.

A stream is ready when a whole window is buffered; ``input_finished``
zero-pads the tail so the last partial window flushes.  Online greedy and
beam search skip ``<sos/eos>`` as well as blank and unk
(``extra_skip_sos``), as the reference's online path does.

``begin_step`` runs a step and starts the readback of every lane's tokens,
timestamps and counts (the best beam's, or every beam's when ``hotwords``
are set; and the endpoint counters) into fresh host buffers (pinned,
non-blocking on the card), recording an event; ``end_step`` waits on it.  A
later step never writes what a pending handle reads, so a serving loop may
call ``begin_step`` for chunk k+1 before ``end_step`` for chunk k.

``accuracy="int8"`` runs the encoder's linears in int8
(``ModelBundle.int8_encoder``).

``mesh`` (``parallel/sharding.make_mesh``) runs the pool over every rank of
the process group, SPMD: each rank makes the same calls with the same
streams, so lanes are handed out in the same order everywhere.  Data group
``r`` owns the ``r``-th contiguous block of ``max_lanes / n_data`` lanes and
holds the state of those lanes only; a step runs on all of its own lanes
(its ranks together, with the encoder's weights split over them),
and the readback gathers every lane's buffers over ``data`` in one
collective.  ``snapshot_stream`` broadcasts the owner's state to every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from k2transducerasr_tpu_torch import native
from k2transducerasr_tpu_torch.decode import ctc_greedy, rnnt_beam, rnnt_greedy
from k2transducerasr_tpu_torch.frontend.fbank import dither_noise, fbank_compute, fbank_matrices
from k2transducerasr_tpu_torch.models import ctc as ctc_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.models.registry import get_encoder
from k2transducerasr_tpu_torch.parallel.sharding import all_gather_dim, mesh_coords
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.checkpoint import state_from_numpy, state_to_numpy, tree_map
from k2transducerasr_tpu_torch.runtime.device import (
    exact_f32,
    host_zeros,
    readback,
    resolve_device,
    upload,
)
from k2transducerasr_tpu_torch.runtime.endpoint import EndpointConfig, is_endpoint
from k2transducerasr_tpu_torch.runtime.offline import DECODING_METHODS
from k2transducerasr_tpu_torch.runtime.program import DecodeProgram
from k2transducerasr_tpu_torch.text.hotwords import apply_hotwords
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text
from k2transducerasr_tpu_torch.utils import profiling


@dataclasses.dataclass
class OnlineRecognizerResult:
    text: str
    tokens: list[str]
    timestamps: list[int]

    @property
    def text_len(self) -> int:
        return len(self.text)


class OnlineStream:
    """Host half of a stream: a raw-sample buffer and a lane of the
    recognizer's pool, where its decode state lives.  The buffer is the
    native ring buffer when the native library is built
    (``native.available()``), else numpy; both give the same windows."""

    def __init__(self, recognizer: "OnlineRecognizer", lane: int):
        self._rec = recognizer
        self.lane = lane
        self._rb = native.RingBuffer() if native.available() else None
        self._buf = np.zeros(0, np.float32)  # the numpy fallback
        self._consumed = 0  # samples already consumed (hops)
        self.finished_input = False
        self.is_finished = False  # fully drained after input_finished
        self.result: OnlineRecognizerResult | None = None

    def add_samples(self, samples: np.ndarray) -> None:
        if self.finished_input:
            raise RuntimeError("add_samples after input_finished")
        self._push(np.asarray(samples, np.float32))

    def input_finished(self) -> None:
        """Declare the end of audio; pads zeros so every remaining frame
        flushes through the chunked encoder (the reference's tail flush)."""
        if self.finished_input:
            return
        self.finished_input = True
        win, hop = self._rec.window_samples, self._rec.hop_samples
        # pad so that at least one more full window exists past current data
        n = self._size()
        k = max(0, -(-max(n - win, 0) // hop)) + 1
        need = win + k * hop
        if need > n:
            self._push(np.zeros(need - n, np.float32))

    AddSamples = add_samples
    InputFinished = input_finished

    def _push(self, x: np.ndarray) -> None:
        if self._rb is not None:
            self._rb.push(x)
        else:
            self._buf = np.concatenate([self._buf, x])

    def _size(self) -> int:
        return len(self._rb) if self._rb is not None else len(self._buf)

    def _samples(self) -> np.ndarray:
        """Every buffered sample (a copy)."""
        return self._rb.window(self._size()) if self._rb is not None else self._buf.copy()

    def _ready(self) -> bool:
        return not self.is_finished and self._size() >= self._rec.window_samples

    def _take_window(self) -> np.ndarray:
        win, hop = self._rec.window_samples, self._rec.hop_samples
        if self._rb is not None:
            out = self._rb.window(win)
            self._rb.advance(hop)
        else:
            out = self._buf[:win]
            self._buf = self._buf[hop:]
        self._consumed += hop
        if self.finished_input and self._size() < win:
            self.is_finished = True
        return out


class OnlineRecognizer:
    def __init__(
        self,
        bundle: ModelBundle,
        decoding_method: str = "greedy_search",
        compute_dtype=torch.bfloat16,
        max_lanes: int = 8,
        max_tokens: int = 512,
        max_active_paths: int = 4,
        enable_endpoint: bool = False,
        endpoint_config: EndpointConfig | None = None,
        mesh=None,
        hotwords: list[str] | None = None,
        accuracy: str | None = None,
        windows_per_step: int = 1,
        device: str | torch.device = "cuda",
    ):
        """``compute_dtype``: bf16 (default) or None for float32, which is
        true float32 on the card: the recognizer's device work runs with
        TF32 off whatever the dtype (``runtime/device.exact_f32``).  A CTC
        bundle always decodes with ``greedy_search_ctc``; ``hotwords`` need
        ``modified_beam_search``.  ``device`` must be the bundle's; the
        default asks for the card.  ``mesh``: a ``DeviceMesh`` of
        ``parallel/sharding.make_mesh`` whose data groups divide
        ``max_lanes``."""
        if bundle.is_ctc:
            decoding_method = "greedy_search_ctc"
        if decoding_method not in DECODING_METHODS:
            raise ValueError(f"unsupported decoding method {decoding_method!r}")
        if hotwords and decoding_method != "modified_beam_search":
            raise ValueError("hotwords require decoding_method='modified_beam_search'")
        n_data, _, data_rank, _ = mesh_coords(mesh)
        if max_lanes % n_data:
            raise ValueError(
                f"max_lanes={max_lanes} must be a multiple of the mesh "
                f"data axis ({n_data})"
            )
        if accuracy not in (None, "auto", "float32", "int8"):
            raise ValueError(f"unsupported accuracy {accuracy!r}")
        if windows_per_step < 1:
            raise ValueError("windows_per_step must be >= 1")
        dev = resolve_device(device)
        if dev != bundle.device:
            raise ValueError(
                f"bundle is on {bundle.device}, recognizer asked for {dev}; "
                "load the bundle with the same device"
            )
        self.bundle = bundle
        self.device = dev
        self.accuracy = accuracy
        self.mesh = mesh
        self._n_data = n_data
        self._data_group = None if mesh is None else mesh.get_group("data")
        # this rank's data group holds lanes [_lane0, _lane0 + _pool_lanes)
        self._pool_lanes = max_lanes // n_data
        self._lane0 = data_rank * self._pool_lanes
        # accuracy="int8": the encoder's linears quantized once, here; under
        # a mesh, this rank's shards
        self.encoder, self.ctc = bundle.compute_modules(accuracy, mesh)
        self.decoding_method = decoding_method
        self.compute_dtype = compute_dtype
        self.max_lanes = max_lanes
        self.max_tokens = max_tokens
        self.max_active_paths = max_active_paths
        self.hotwords = hotwords
        self.enable_endpoint = enable_endpoint
        self._endpoint_cfg = endpoint_config
        self.windows_per_step = windows_per_step

        self._enc = get_encoder(bundle.model_type)
        enc_cfg, fcfg = bundle.encoder_cfg, bundle.frontend_cfg
        self.chunk_frames = self._enc.output_chunk_len(enc_cfg)  # encoder frames per window
        self._feat_window = enc_cfg.chunk_input_len
        self.window_samples = (self._feat_window - 1) * fcfg.frame_shift + fcfg.frame_length
        self.hop_samples = enc_cfg.decode_chunk_len * fcfg.frame_shift
        self._fbank_tables = tuple(torch.from_numpy(m).to(dev) for m in fbank_matrices(fcfg))
        # fbank's own dither draw for a window slot of the pool, drawn once
        self._dither = None if fcfg.dither <= 0.0 else dither_noise(
            (self._pool_lanes, self._feat_window, fcfg.frame_length), fcfg, dev)
        # the search kernels' operands (greedy and beam share them), built once
        # (decode/rnnt_greedy.py::greedy_operands)
        self._search_ops = None
        if dev.type == "cuda" and decoding_method in ("greedy_search", "modified_beam_search"):
            with exact_f32():
                self._search_ops = rnnt_greedy.greedy_operands(bundle.decoder, bundle.decoder_cfg,
                                                               bundle.joiner, compute_dtype)

        self._free_lanes = list(range(max_lanes))
        self._streams: dict[int, OnlineStream] = {}
        # the lane pool (this data group's lanes): bound here once and only
        # ever written in place, since a captured step holds its addresses
        self._enc_state = self._enc.init_state(enc_cfg, self._pool_lanes, dev)
        # the bytes of encoder state a window slot's freeze passes: every
        # leaf of the pool (``online.freeze_bytes``)
        leaf_bytes = []
        tree_map(lambda t: leaf_bytes.append(t.numel() * t.element_size()), self._enc_state)
        self._freeze_bytes = sum(leaf_bytes)
        self._dec_state = self._init_dec_state(self._pool_lanes)
        self._frame_count = torch.zeros((self._pool_lanes,), dtype=torch.int64, device=dev)
        self._reset_template = None
        self._endpoint_host = None  # (trailing, count, frames) from the last readback
        # the step program: one key (L, W, n), on the card one CUDA graph;
        # its warm-up steps an idle pool, a no-op
        self.program = None if mesh is not None else DecodeProgram(
            self._step, dev, idle=lambda windows, wcount: (windows, torch.zeros_like(wcount)))

    # -- public API ---------------------------------------------------------

    def create_online_stream(self) -> OnlineStream:
        if not self._free_lanes:
            raise RuntimeError(
                f"all {self.max_lanes} lanes busy; raise max_lanes or dispose streams"
            )
        lane = self._free_lanes.pop()
        if self._owns(lane):
            self._reset_lane(lane - self._lane0)
        stream = OnlineStream(self, lane)
        self._streams[lane] = stream
        return stream

    CreateOnlineStream = create_online_stream
    create_stream = create_online_stream

    def dispose_stream(self, stream: OnlineStream) -> None:
        if stream.lane in self._streams:
            del self._streams[stream.lane]
            self._free_lanes.append(stream.lane)
            stream.lane = -1

    def get_result(self, stream: OnlineStream) -> OnlineRecognizerResult:
        return self.get_results([stream])[0]

    def get_results(self, streams: list[OnlineStream]) -> list[OnlineRecognizerResult]:
        """Advance every ready stream by one window (streams without a whole
        window are skipped this round), then return current partial
        results."""
        return self.end_step(self.begin_step(streams))

    GetResult = get_result
    GetResults = get_results

    def get_nbest_results(self, streams: list[OnlineStream]
                          ) -> list[list[OnlineRecognizerResult]]:
        """Advance every ready stream one window (as ``get_results``) and
        return all ``max_active_paths`` partial hypotheses per stream,
        best-scoring first (``modified_beam_search`` only)."""
        if self.decoding_method != "modified_beam_search":
            raise ValueError("get_nbest_results requires modified_beam_search")
        self.end_step(self.begin_step(streams))
        bufs = self._all_lanes(rnnt_beam.nbest_beams(self._dec_state)[:3])
        toks, stamps, counts = (t.cpu() for t in bufs)
        return [self._lane_nbest(s.lane, toks, stamps, counts) if s.lane >= 0 else []
                for s in streams]

    def begin_step(self, streams: list[OnlineStream]):
        """Run one step for every ready stream and start the readback of the
        results without waiting for it; ``end_step`` takes the handle.  Under
        every search method on the card nothing here waits for the device:
        the whole pool's windows and counts go up pinned and non-blocking,
        and the step is one replay of the recognizer's CUDA graph (the first
        step captures it, which waits).

        One thread and one stream per recognizer: the graph's static inputs
        and the pool are shared, so every ``begin_step`` on the card must
        run on the stream of the first (another raises)."""
        stepped = False
        with profiling.span("begin_step.prep"):
            active = [s for s in streams if s.lane >= 0 and s._ready()]
            if active:
                # the pool's windows as int16 (made by truncation toward zero);
                # a lane without a window gets zeros and a count of 0
                shape = (self._pool_lanes, self.windows_per_step, self.window_samples)
                windows_t = host_zeros(shape, torch.int16, self.device)
                wcount_t = host_zeros((self._pool_lanes,), torch.int64, self.device)
                windows, wcount = windows_t.numpy(), wcount_t.numpy()
                # every rank takes every stream's windows; it keeps its own lanes'
                for s in active:
                    lane = s.lane - self._lane0
                    k = 0
                    while k < shape[1] and s._ready():
                        w = s._take_window()
                        if self._owns(s.lane):
                            windows[lane, k] = np.clip(w * 32768.0, -32768,
                                                       32767).astype(np.int16)
                        k += 1
                    if self._owns(s.lane):
                        wcount[lane] = k
                lanes = int(np.count_nonzero(wcount))
                profiling.count("online.windows", int(wcount.sum()))
                profiling.count("online.lanes_stepped", lanes)
                stepped = lanes > 0
                if stepped:  # each window slot's freeze passes the whole pool
                    profiling.count("online.freeze_bytes", shape[1] * self._freeze_bytes)
        with profiling.span("begin_step.queue"):
            if stepped:
                with torch.inference_mode():
                    if self.program is not None:  # copies into its static inputs
                        self.program(windows_t, wcount_t)
                    else:  # under a mesh: eager
                        self._step(upload(windows_t, self.device), upload(wcount_t, self.device))
            st = self._dec_state
            if self.hotwords:  # every beam's partial text, for the selection
                bufs = rnnt_beam.nbest_beams(st)[:3]
            elif self.decoding_method == "modified_beam_search":
                bufs = rnnt_beam.best_beam(st)
            else:
                bufs = (st.tokens, st.timestamps, st.count)
            if self.enable_endpoint and self.decoding_method != "modified_beam_search":
                bufs = bufs + (st.trailing_blanks, self._frame_count)
            host = tuple(readback(t) for t in self._all_lanes(bufs))
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return streams, host, event

    def end_step(self, pending) -> list[OnlineRecognizerResult]:
        """Wait for a ``begin_step`` handle and return current partial
        results for its streams.  With ``hotwords`` each stream's result is
        the n-best hypothesis that ``apply_hotwords`` prefers."""
        streams, host, event = pending
        with profiling.span("end_step.wait"):
            if event is not None:
                event.synchronize()
        with profiling.span("end_step.text"):
            tokens, stamps, counts = host[:3]
            if len(host) > 3:
                self._endpoint_host = (host[3], counts, host[4])
            results = []
            for s in streams:
                if s.lane < 0:
                    results.append(s.result or OnlineRecognizerResult("", [], []))
                    continue
                if self.hotwords:
                    cands = self._lane_nbest(s.lane, tokens, stamps, counts)
                    texts = [c.text for c in cands]
                    s.result = cands[texts.index(apply_hotwords(texts, self.hotwords))]
                else:
                    n = int(counts[s.lane])
                    s.result = self._result(tokens[s.lane, :n].tolist(),
                                            stamps[s.lane, :n].tolist())
                results.append(s.result)
        return results

    def snapshot_stream(self, stream: OnlineStream) -> dict:
        """A stream's whole decode state (encoder caches, decode state, frame
        counter, buffered samples) as host arrays in the JAX package's
        layout (``runtime/checkpoint.state_to_numpy``): restorable into any
        lane of a recognizer with the same bundle, of either package, on any
        mesh.  Under a mesh every rank returns it, broadcast from the lane's
        data group."""
        lane = stream.lane
        if lane < 0:
            raise ValueError("stream has no lane (disposed?)")
        local = lane - self._lane0
        if self._n_data == 1:
            pick = lambda a: a[local]  # noqa: E731
        else:
            src = dist.get_global_rank(self._data_group, lane // self._pool_lanes)

            def pick(a):
                t = a[local].clone() if self._owns(lane) else torch.empty_like(a[0])
                dist.broadcast(t, src=src, group=self._data_group)
                return t

        return {
            "enc": state_to_numpy(tree_map(pick, self._enc_state)),
            "dec": state_to_numpy(tree_map(pick, self._dec_state)),
            "frames": int(pick(self._frame_count)),
            "buffer": stream._samples(),
            "consumed": stream._consumed,
            "finished_input": stream.finished_input,
        }

    def restore_stream(self, snapshot: dict) -> OnlineStream:
        """A new stream whose device and host state continue exactly from a
        snapshot (``state_from_numpy`` takes either package's)."""
        stream = self.create_online_stream()
        if self._owns(stream.lane):
            lane = stream.lane - self._lane0
            state = (state_from_numpy(snapshot["enc"], self.device),
                     state_from_numpy(snapshot["dec"], self.device),
                     torch.tensor(int(snapshot["frames"])))
            tree_map(lambda pool, v: pool[lane].copy_(v), self._pool(), state)
        stream._push(np.asarray(snapshot["buffer"], np.float32))
        stream._consumed = snapshot["consumed"]
        stream.finished_input = snapshot["finished_input"]
        return stream

    def is_endpoint(self, stream: OnlineStream) -> bool:
        """The endpoint rules of ``runtime/endpoint.py`` on the lane's
        trailing-blank, token and frame counters.  They ride the batched
        readback of ``end_step``; before any step has completed, one direct
        read.  Beam search keeps no blank counter: never an endpoint."""
        if (not self.enable_endpoint or stream.lane < 0
                or self.decoding_method == "modified_beam_search"):
            return False
        cfg = self._endpoint_cfg or EndpointConfig(
            frame_seconds=(self.hop_samples / self.bundle.frontend_cfg.sample_rate)
            / self.chunk_frames
        )
        if self._endpoint_host is None:
            st = self._dec_state
            self._endpoint_host = tuple(t.cpu() for t in self._all_lanes(
                (st.trailing_blanks, st.count, self._frame_count)))
        trailing, count, frames = (int(a[stream.lane]) for a in self._endpoint_host)
        return is_endpoint(cfg, trailing, count, frames)

    def decode_to_end(self, stream: OnlineStream) -> OnlineRecognizerResult:
        """Drain a stream completely (declares the end of its input)."""
        stream.input_finished()
        while not stream.is_finished:
            self.get_results([stream])
        return self.get_results([stream])[0]

    # -- internals ----------------------------------------------------------

    def _result(self, toks: list[int], stamps: list[int]) -> OnlineRecognizerResult:
        table = self.bundle.tokens
        return OnlineRecognizerResult(text=tokens_to_text(toks, table),
                                      tokens=[table.get(t) for t in toks], timestamps=stamps)

    def _lane_nbest(self, lane, toks, stamps, counts) -> list[OnlineRecognizerResult]:
        """One lane's K beams from [L, K, U] host buffers."""
        return [self._result(toks[lane, j, :n].tolist(), stamps[lane, j, :n].tolist())
                for j, n in enumerate(counts[lane].tolist())]

    @exact_f32()
    def _init_dec_state(self, batch: int):
        b, cd = self.bundle, self.compute_dtype
        if self.decoding_method == "greedy_search_ctc":
            return ctc_greedy.init_state(batch, self.max_tokens, device=self.device)
        if self.decoding_method == "modified_beam_search":
            return rnnt_beam.init_state(b.decoder, b.decoder_cfg, b.joiner, batch,
                                        self.max_active_paths, self.max_tokens, cd)
        return rnnt_greedy.init_state(b.decoder, b.decoder_cfg, b.joiner, batch,
                                      self.max_tokens, cd)

    def _pool(self) -> tuple:
        """The lane pool: (encoder state, decode state, frame counters), each
        leaf ``[pool lanes, ...]``.  Bound in ``__init__`` and only written
        in place: the captured step holds these addresses."""
        return self._enc_state, self._dec_state, self._frame_count

    def _owns(self, lane: int) -> bool:
        """Whether this rank's data group holds ``lane``."""
        return 0 <= lane - self._lane0 < self._pool_lanes

    def _all_lanes(self, bufs: tuple) -> tuple:
        """Per-lane int64 buffers of this data group's lanes -> the same of
        every lane: one gather over ``data`` of the buffers side by side."""
        if self._n_data == 1:
            return tuple(bufs)
        flat = all_gather_dim(torch.cat([t.reshape(t.shape[0], -1) for t in bufs], dim=1), 0,
                              self._data_group)
        out, at = [], 0
        for t in bufs:
            n = t[0].numel()
            out.append(flat[:, at:at + n].reshape(flat.shape[0], *t.shape[1:]))
            at += n
        return tuple(out)

    def _reset_lane(self, lane: int) -> None:
        """Zero one lane's state (a fresh stream); ``lane`` indexes the
        pool."""
        if self._reset_template is None:  # a pool of one lane
            self._reset_template = (
                self._enc.init_state(self.bundle.encoder_cfg, 1, self.device),
                self._init_dec_state(1),
                torch.zeros((1,), dtype=torch.int64, device=self.device),
            )
        tree_map(lambda pool, tpl: pool[lane].copy_(tpl[0]), self._pool(), self._reset_template)
        self._endpoint_host = None  # the lane's counters changed

    @exact_f32()
    def _step(self, windows: torch.Tensor, wcount: torch.Tensor) -> tuple:
        """One step of the whole pool (the reference's ``_build_step_fn``):
        windows [L, W, n] int16, wcount [L] int64 windows per lane.  Window
        slot k steps the encoder of every lane and keeps the new state of
        the lanes with more than k windows; one decode pass then runs over
        each lane's ``wcount * chunk`` encoder frames.  Writes the pool in
        place, reads nothing on the host and returns nothing: the function
        ``program`` captures.  Its stages are marked on the device
        (``profiling.stage``)."""
        b, dev = self.bundle, self.device
        cd, chunk = self.compute_dtype, self.chunk_frames
        outs = []
        for k in range(windows.shape[1]):
            profiling.stage("fbank", dev)
            feats = fbank_compute(windows[:, k].float() * (1.0 / 32768.0), b.frontend_cfg,
                                  self._feat_window, tables=self._fbank_tables,
                                  noise=self._dither)
            profiling.stage("encoder", dev)
            out, new_state = self._enc.streaming_step(self.encoder, b.encoder_cfg,
                                                      self._enc_state, feats, cd)
            profiling.stage("freeze", dev)
            _freeze(self._enc_state, new_state, wcount > k)
            outs.append(out)
        profiling.stage("search", dev)
        enc_out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        lens, dec, offset = wcount * chunk, self._dec_state, self._frame_count
        if self.decoding_method == "greedy_search_ctc":
            lp = ctc_mod.log_probs(self.ctc, enc_out, cd)
            new_dec = ctc_greedy.ctc_frames(dec, lp, lens, offset)
        else:
            # online search also skips <sos/eos> = 1 (extra_skip_sos)
            enc_proj = joiner_mod.project_encoder(b.joiner, enc_out, cd)
            args = (b.decoder, b.decoder_cfg, b.joiner, dec, enc_proj, lens, offset, True, cd)
            search = (rnnt_beam.beam_frames_skip
                      if self.decoding_method == "modified_beam_search"
                      else rnnt_greedy.greedy_frames_skip)
            new_dec = search(*args, operands=self._search_ops)
        tree_map(lambda pool, v: pool.copy_(v), self._dec_state, new_dec)
        self._frame_count.add_(lens)
        profiling.stage("end", dev)
        return ()


def _freeze(pool, new, active: torch.Tensor) -> None:
    """Write ``new`` into the ``pool`` leaves in place on the ``active``
    lanes; the others keep theirs (the reference's ``_where_lane``: every
    leaf is lane-leading).  Every select is made before the first write, so
    a new leaf that is a view of a pool leaf reads it unchanged."""
    def select(old, v):
        mask = active.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(mask, v.to(old.dtype), old)

    tree_map(lambda old, v: old.copy_(v), pool, tree_map(select, pool, new))
