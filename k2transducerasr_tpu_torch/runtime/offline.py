"""Offline (whole-utterance) recognizer — PyTorch port of
``k2transducerasr_tpu/runtime/offline.py``.

Per batch: int16 PCM -> fbank -> encoder -> one of
  * ``greedy_search``: joiner encoder projection -> blank-skipping greedy
    search;
  * ``modified_beam_search``: the same projection -> blank-skipping beam
    search over ``max_active_paths`` beams, with ``get_nbest_results`` and
    ``hotwords`` (the n-best hypothesis with the most hotwords wins);
  * ``greedy_search_ctc`` (forced for a CTC model type): CTC head ->
    vectorised CTC greedy,
all on the bundle's device; the host reads back only the token buffers.
``accuracy="int8"`` runs the encoder's linears in int8
(``ModelBundle.int8_encoder``).

``mesh`` (``parallel/sharding.make_mesh``) runs the batch over every rank of
the process group, SPMD: each rank makes the same calls with the same
streams and returns every stream's result.  The batch is padded to a
multiple of the mesh's data groups and data group ``r`` decodes its ``r``-th
block of rows; the ranks of one group compute those rows together with the
encoder's weights split over them (tensor parallelism, ``ops/layers.py``).
The token buffers are then gathered over ``data``.

Without a mesh ``begin_decode`` runs ``_decode`` through a
``runtime/program.DecodeProgram``: on the card one CUDA graph per (rows,
bucketed samples), captured at the first batch of that shape and replayed
with one launch per batch, as the JAX runtime compiles one program per
(batch, frame bucket).  Under a mesh ``_decode`` runs eagerly: its
collectives (gloo) cannot be captured.

``begin_decode`` and ``end_decode`` record their parts as host spans and
``_decode`` marks its stages on the device (fbank, encoder, search, end),
through ``utils/profiling``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from k2transducerasr_tpu_torch.decode import ctc_greedy, rnnt_beam, rnnt_greedy
from k2transducerasr_tpu_torch.frontend.fbank import (
    dither_noise,
    fbank_compute,
    fbank_matrices,
    num_frames_for,
    num_frames_tensor,
)
from k2transducerasr_tpu_torch.models import ctc as ctc_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.parallel.sharding import all_gather_dim, all_reduce_max, mesh_coords
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.device import (
    exact_f32,
    host_zeros,
    readback,
    resolve_device,
    upload,
)
from k2transducerasr_tpu_torch.runtime.program import DecodeProgram
from k2transducerasr_tpu_torch.text.hotwords import apply_hotwords
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text
from k2transducerasr_tpu_torch.utils import profiling

DECODING_METHODS = ("greedy_search", "greedy_search_ctc", "modified_beam_search")


@dataclasses.dataclass
class OfflineRecognizerResult:
    text: str
    tokens: list[str]
    timestamps: list[int]

    @property
    def text_len(self) -> int:
        return len(self.text)


class PendingDecode(NamedTuple):
    """A batch ``begin_decode`` queued: its streams, the host copies of
    ``_decode``'s outputs (filled once ``event`` has passed) and the event
    (None on the CPU, where the copies are done)."""

    streams: list
    host: tuple
    event: object


class OfflineStream:
    """Per-utterance sample accumulator; features are computed batched at
    decode time."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._chunks: list[np.ndarray] = []
        self.result: OfflineRecognizerResult | None = None

    def add_samples(self, samples: np.ndarray) -> None:
        self._chunks.append(np.asarray(samples, dtype=np.float32))

    @property
    def samples(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.float32)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]

    AddSamples = add_samples


def _bucket(n: int, step: int, minimum: int) -> int:
    return max(minimum, -(-n // step) * step)


# ln(1e-10): the reference's pad fill
REFERENCE_PAD_FILL = -23.025850929940457


def apply_reference_pad(feats, feat_lens, tail_len: int = 19, longest=None):
    """The reference's offline feature-pad contract: every lane claims
    max(feat_lens)+tail_len frames (capped at the buffer), frames past a
    lane's true length are filled with ln(1e-10), and exact-zero feature
    values become ln(1e-10) too.  feats: [B, T_pad, F]; feat_lens: [B];
    ``longest``: the max over the whole batch where ``feat_lens`` holds
    only some of its rows."""
    t_pad = feats.shape[1]
    longest = feat_lens.max() if longest is None else longest
    claim = torch.clamp(torch.as_tensor(longest, device=feat_lens.device) + tail_len, max=t_pad)
    feats = torch.where(feats == 0.0, REFERENCE_PAD_FILL, feats)
    valid = torch.arange(t_pad, device=feats.device)[None, :] < feat_lens[:, None]
    feats = torch.where(valid[:, :, None], feats, REFERENCE_PAD_FILL)
    # the claim stays on the device: no host sync
    return feats, torch.zeros_like(feat_lens) + claim


class OfflineRecognizer:
    def __init__(
        self,
        bundle: ModelBundle,
        decoding_method: str = "greedy_search",
        compute_dtype=torch.bfloat16,
        max_tokens: int = 1024,
        frame_bucket: int = 256,
        max_active_paths: int = 4,
        mesh=None,
        reference_pad_compat: bool = False,
        hotwords: list[str] | None = None,
        accuracy: str | None = None,
        device: str | torch.device = "cuda",
    ):
        """``compute_dtype``: bf16 (default) or None for float32, which is
        true float32 on the card (TF32 off while a batch decodes).  A CTC
        bundle always decodes with ``greedy_search_ctc``; ``hotwords`` need
        ``modified_beam_search``.  ``device`` must be the bundle's; the
        default asks for the card.  ``mesh``: a ``DeviceMesh`` of
        ``parallel/sharding.make_mesh`` on the bundle's device type."""
        if bundle.is_ctc:
            decoding_method = "greedy_search_ctc"
        if decoding_method not in DECODING_METHODS:
            raise ValueError(f"unsupported decoding method {decoding_method!r}")
        if hotwords and decoding_method != "modified_beam_search":
            raise ValueError("hotwords require decoding_method='modified_beam_search'")
        n_data, _, data_rank, _ = mesh_coords(mesh)
        if accuracy not in (None, "auto", "float32", "int8"):
            raise ValueError(f"unsupported accuracy {accuracy!r}")
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
        self._n_data, self._data_rank = n_data, data_rank
        self._data_group = None if mesh is None else mesh.get_group("data")
        # accuracy="int8": the encoder's linears quantized once, here; under
        # a mesh, this rank's shards
        self.encoder, self.ctc = bundle.compute_modules(accuracy, mesh)
        self.decoding_method = decoding_method
        self.compute_dtype = compute_dtype
        self.max_tokens = max_tokens
        self.frame_bucket = frame_bucket
        self.max_active_paths = max_active_paths
        self.reference_pad_compat = reference_pad_compat
        self.hotwords = hotwords
        self._fbank_tables = tuple(
            torch.from_numpy(m).to(dev) for m in fbank_matrices(bundle.frontend_cfg)
        )
        # the search kernels' operands (greedy and beam share them), built once
        # (decode/rnnt_greedy.py::greedy_operands)
        self._search_ops = None
        if dev.type == "cuda" and decoding_method in ("greedy_search", "modified_beam_search"):
            self._search_ops = rnnt_greedy.greedy_operands(bundle.decoder, bundle.decoder_cfg,
                                                           bundle.joiner, compute_dtype)
        # the dither noise per (rows, frames), drawn once (features)
        self._dither: dict[tuple[int, int], torch.Tensor] = {}
        # one CUDA graph per (rows, samples) on the card; None under a mesh
        self.program = None if mesh is not None else DecodeProgram(self._decode, dev)

    # -- public API ---------------------------------------------------------

    def create_offline_stream(self) -> OfflineStream:
        return OfflineStream(self.bundle.frontend_cfg.sample_rate)

    create_stream = create_offline_stream
    CreateOfflineStream = create_offline_stream

    def get_result(self, stream: OfflineStream) -> OfflineRecognizerResult:
        return self.get_results([stream])[0]

    def get_results(self, streams: list[OfflineStream]) -> list[OfflineRecognizerResult]:
        return self.end_decode(self.begin_decode(streams))

    GetResult = get_result
    GetResults = get_results

    def pcm_batch(self, streams: list[OfflineStream]):
        """Streams -> (samples [B, N] int16, true sample counts [B]) on the
        device, N covering the frame bucket.  PCM becomes int16 by truncation
        toward zero, exactly as the reference ships it.  Under a mesh the
        batch is padded with empty rows to a multiple of the data groups and
        only this rank's group's rows are uploaded.  The rows are written
        into pinned host memory and uploaded without blocking (``upload``),
        so the host does not wait for the card."""
        cfg = self.bundle.frontend_cfg
        n_samples = [len(s.samples) for s in streams]
        n_frames = np.array([num_frames_for(n, cfg) for n in n_samples], np.int32)
        # compat mode claims +19 frames past the longest lane — keep them
        # inside the bucketed buffer
        tail = 19 if self.reference_pad_compat else 0
        t_pad = _bucket(int(n_frames.max(initial=1)) + tail, self.frame_bucket,
                        self.frame_bucket)
        need = (t_pad - 1) * cfg.frame_shift + cfg.frame_length
        rows = -(-len(streams) // self._n_data)  # per data group
        mine = range(self._data_rank * rows, (self._data_rank + 1) * rows)
        batch_t = host_zeros((rows, need), torch.int16, self.device)
        counts_t = host_zeros((rows,), torch.int64, self.device)
        batch, counts = batch_t.numpy(), counts_t.numpy()
        for i, lane in enumerate(mine):
            if lane < len(streams):
                x = streams[lane].samples[:need]
                batch[i, : len(x)] = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
                counts[i] = min(n_samples[lane], need)
        return upload(batch_t, self.device), upload(counts_t, self.device)

    def begin_decode(self, streams: list[OfflineStream]) -> PendingDecode:
        """Queue the device work for a batch and return a pending handle
        (``PendingDecode``) without waiting for the device.  On the card the
        whole program is one replay of the batch shape's CUDA graph
        (``program``; the first batch of a shape captures it, which waits
        for the card), and the readback of what ``end_decode`` reads (the
        best hypothesis, or under beam search the ordered n-best) starts
        right after it into pinned memory.  The upload is pinned and
        non-blocking too, so a serving loop can prepare batch k+1 while
        batch k runs, and ``end_decode`` of batch k waits for batch k alone.

        One stream per recognizer: the graphs share their static inputs and
        memory, so every ``begin_decode`` of a recognizer on the card must
        run on the stream of its first (another raises); calls from several
        threads on that stream are serialised."""
        with profiling.span("begin_decode.pcm"):
            samples, sample_counts = self.pcm_batch(streams)
        with profiling.span("begin_decode.queue"), torch.inference_mode(), self._precision():
            if self.program is not None:
                out = self.program(samples, sample_counts)
            else:  # under a mesh: eager
                out = self._decode(samples, sample_counts)
                if self._n_data > 1:  # every data group's rows, in order
                    out = tuple(self._all_rows(t) for t in out)
            host = tuple(readback(t) for t in out)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return PendingDecode(streams, host, event)

    def end_decode(self, pending: PendingDecode) -> list[OfflineRecognizerResult]:
        """Wait for a ``begin_decode`` handle's readback and build results.
        Under beam search each stream's result is its best hypothesis, or
        with ``hotwords`` the n-best hypothesis that ``apply_hotwords``
        prefers."""
        streams = pending.streams
        with profiling.span("end_decode.wait"):
            if pending.event is not None:
                pending.event.synchronize()
        with profiling.span("end_decode.text"):
            if self.hotwords:
                results = []
                for cands in self._nbest_results(streams, pending.host):
                    texts = [c.text for c in cands]
                    results.append(cands[texts.index(apply_hotwords(texts, self.hotwords))])
            else:
                host = pending.host
                if self.decoding_method == "modified_beam_search":  # the n-best's first
                    host = tuple(t[:, 0] for t in host[:3])
                rows = rnnt_greedy.extract_results(*host)[:len(streams)]
                results = [self._result(toks, stamps) for toks, stamps in rows]
            for stream, res in zip(streams, results):
                stream.result = res
        return results

    def get_nbest_results(self, streams: list[OfflineStream]
                          ) -> list[list[OfflineRecognizerResult]]:
        """Decode and return all ``max_active_paths`` hypotheses per stream,
        best-scoring first (``modified_beam_search`` only).  Beams are not
        recombined, so two may carry the same tokens."""
        if self.decoding_method != "modified_beam_search":
            raise ValueError("get_nbest_results requires modified_beam_search")
        pending = self.begin_decode(streams)
        if pending.event is not None:
            pending.event.synchronize()
        return self._nbest_results(streams, pending.host)

    def _result(self, toks: list[int], stamps: list[int]) -> OfflineRecognizerResult:
        table = self.bundle.tokens
        return OfflineRecognizerResult(text=tokens_to_text(toks, table),
                                       tokens=[table.get(t) for t in toks], timestamps=stamps)

    def _nbest_results(self, streams, host) -> list[list[OfflineRecognizerResult]]:
        """The n-best hypotheses of each stream from the host copies of
        ``rnnt_beam.nbest_beams``' buffers."""
        toks, stamps, counts = host[:3]
        return [[self._result(toks[i, j, :n].tolist(), stamps[i, j, :n].tolist())
                 for j, n in enumerate(counts[i].tolist())]
                for i in range(len(streams))]

    # -- the decode program -------------------------------------------------

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather_dim(t, 0, self._data_group)

    def _precision(self):
        """float32 compute means true float32: TF32 off while it runs."""
        return exact_f32() if self.compute_dtype is None else contextlib.nullcontext()

    def features(self, samples: torch.Tensor, sample_counts: torch.Tensor):
        """int16 samples [B, N] + true counts -> (feats [B, T_pad, F],
        feat_lens [B])."""
        fcfg = self.bundle.frontend_cfg
        x = samples.float() * (1.0 / 32768.0)
        t_pad = (x.shape[1] - fcfg.frame_length) // fcfg.frame_shift + 1
        feats = fbank_compute(x, fcfg, t_pad, n_valid=sample_counts, tables=self._fbank_tables,
                              noise=self._dither_noise(x.shape[0], t_pad))
        feat_lens = num_frames_tensor(sample_counts, fcfg)
        if self.reference_pad_compat:
            longest = feat_lens.max()
            if self._n_data > 1:  # over every data group's rows
                longest = all_reduce_max(longest, self._data_group)
            feats, feat_lens = apply_reference_pad(feats, feat_lens, longest=longest)
        return feats, feat_lens

    def _dither_noise(self, rows: int, frames: int) -> torch.Tensor | None:
        """fbank's own dither draw for a batch of this shape (``dither_noise``:
        a fresh generator seeded 0 each time), drawn at the shape's first
        batch and kept: a graph cannot draw from an unregistered generator,
        and reading the kept noise gives every batch the eager route's
        features.  None without dither."""
        fcfg = self.bundle.frontend_cfg
        if fcfg.dither <= 0.0:
            return None
        key = (rows, frames)
        if key not in self._dither:
            self._dither[key] = dither_noise((rows, frames, fcfg.frame_length), fcfg, self.device)
        return self._dither[key]

    def encode(self, samples: torch.Tensor, sample_counts: torch.Tensor):
        """fbank and encoder: -> (enc_out [B, T', D], enc_lens [B]).  Each
        is marked on the device (``profiling.stage``)."""
        with torch.inference_mode(), self._precision():
            profiling.stage("fbank", self.device)
            feats, feat_lens = self.features(samples, sample_counts)
            profiling.stage("encoder", self.device)
            return self.encoder(feats, feat_lens, self.compute_dtype)

    def _decode(self, samples, sample_counts) -> tuple:
        """-> what ``end_decode`` reads: each lane's (tokens, timestamps,
        count), or under beam search the ordered n-best buffers (tokens,
        timestamps, count, score; ``rnnt_beam.nbest_beams``).  The function
        ``program`` captures; called directly it runs eagerly (the reference
        a graph is held to).  Its stages are marked on the device
        (``profiling.stage``): fbank, encoder, search, end."""
        enc_out, enc_lens = self.encode(samples, sample_counts)
        profiling.stage("search", self.device)
        out = self._search(enc_out, enc_lens)
        profiling.stage("end", self.device)
        return out

    def _search(self, enc_out, enc_lens) -> tuple:
        """The joiner projection or the CTC head, the search and, under beam
        search, the n-best: ``_decode``'s outputs from the encoder's."""
        b = self.bundle
        cd = self.compute_dtype
        batch = enc_out.shape[0]
        zero = torch.zeros((batch,), dtype=torch.int64, device=self.device)
        if self.decoding_method == "greedy_search_ctc":
            lp = ctc_mod.log_probs(self.ctc, enc_out, cd)
            state = ctc_greedy.init_state(batch, self.max_tokens, device=self.device)
            final = ctc_greedy.ctc_frames(state, lp, enc_lens, zero)
            return final.tokens, final.timestamps, final.count
        enc_proj = joiner_mod.project_encoder(b.joiner, enc_out, cd)
        if self.decoding_method == "modified_beam_search":
            state = rnnt_beam.init_state(b.decoder, b.decoder_cfg, b.joiner, batch,
                                         self.max_active_paths, self.max_tokens, cd)
            final = rnnt_beam.beam_frames_skip(b.decoder, b.decoder_cfg, b.joiner, state,
                                               enc_proj, enc_lens, zero, False, cd,
                                               operands=self._search_ops)
            return rnnt_beam.nbest_beams(final)
        state = rnnt_greedy.init_state(b.decoder, b.decoder_cfg, b.joiner, batch,
                                       self.max_tokens, cd)
        final = rnnt_greedy.greedy_frames_skip(b.decoder, b.decoder_cfg, b.joiner, state,
                                               enc_proj, enc_lens, zero, False, cd,
                                               operands=self._search_ops)
        return final.tokens, final.timestamps, final.count
