"""Offline (whole-utterance) recognizer — PyTorch port of
``k2transducerasr_tpu/runtime/offline.py`` for ``greedy_search``.

Per batch: int16 PCM -> fbank -> zipformer2 -> joiner encoder projection ->
blank-skipping greedy search -> text, all on the bundle's device; the host
reads back only the token buffers.  Beam search, CTC, ``mesh``, ``hotwords``
and ``accuracy="int8"`` are not ported yet and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from k2transducerasr_tpu_torch.decode import rnnt_greedy
from k2transducerasr_tpu_torch.frontend.fbank import (
    fbank_compute,
    fbank_matrices,
    num_frames_for,
    num_frames_tensor,
)
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.device import exact_f32, resolve_device
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text


@dataclasses.dataclass
class OfflineRecognizerResult:
    text: str
    tokens: list[str]
    timestamps: list[int]


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



def _bucket(n: int, step: int, minimum: int) -> int:
    return max(minimum, -(-n // step) * step)


# ln(1e-10): the reference's pad fill
REFERENCE_PAD_FILL = -23.025850929940457


def apply_reference_pad(feats, feat_lens, tail_len: int = 19):
    """The reference's offline feature-pad contract: every lane claims
    max(feat_lens)+tail_len frames (capped at the buffer), frames past a
    lane's true length are filled with ln(1e-10), and exact-zero feature
    values become ln(1e-10) too.  feats: [B, T_pad, F]; feat_lens: [B]."""
    t_pad = feats.shape[1]
    claim = torch.clamp(feat_lens.max() + tail_len, max=t_pad)
    feats = torch.where(feats == 0.0, REFERENCE_PAD_FILL, feats)
    valid = torch.arange(t_pad, device=feats.device)[None, :] < feat_lens[:, None]
    feats = torch.where(valid[:, :, None], feats, REFERENCE_PAD_FILL)
    return feats, torch.full_like(feat_lens, int(claim))


_NOT_PORTED = "not ported to PyTorch yet (see ROADMAP.md)"


class OfflineRecognizer:
    def __init__(
        self,
        bundle: ModelBundle,
        decoding_method: str = "greedy_search",
        compute_dtype=torch.bfloat16,
        max_tokens: int = 1024,
        frame_bucket: int = 256,
        reference_pad_compat: bool = False,
        mesh=None,
        hotwords: list[str] | None = None,
        accuracy: str | None = None,
        device: str | torch.device = "cuda",
    ):
        """``compute_dtype``: bf16 (default) or None for float32, which is
        true float32 on the card (TF32 off while a batch decodes).
        ``device`` must be the bundle's; the default asks for the card."""
        for name, value in (("mesh", mesh), ("hotwords", hotwords)):
            if value:
                raise NotImplementedError(f"{name} is {_NOT_PORTED}")
        if accuracy not in (None, "auto", "float32"):
            raise NotImplementedError(f"accuracy={accuracy!r} is {_NOT_PORTED}")
        dev = resolve_device(device)
        if dev != bundle.device:
            raise ValueError(
                f"bundle is on {bundle.device}, recognizer asked for {dev}; "
                "load the bundle with the same device"
            )
        if decoding_method != "greedy_search":
            raise NotImplementedError(f"decoding_method {decoding_method!r} is {_NOT_PORTED}")
        self.bundle = bundle
        self.device = dev
        self.decoding_method = decoding_method
        self.compute_dtype = compute_dtype
        self.max_tokens = max_tokens
        self.frame_bucket = frame_bucket
        self.reference_pad_compat = reference_pad_compat
        self._fbank_tables = tuple(
            torch.from_numpy(m).to(dev) for m in fbank_matrices(bundle.frontend_cfg)
        )

    # -- public API ---------------------------------------------------------

    def create_offline_stream(self) -> OfflineStream:
        return OfflineStream(self.bundle.frontend_cfg.sample_rate)

    def get_result(self, stream: OfflineStream) -> OfflineRecognizerResult:
        return self.get_results([stream])[0]

    def get_results(self, streams: list[OfflineStream]) -> list[OfflineRecognizerResult]:
        return self.end_decode(self.begin_decode(streams))

    def pcm_batch(self, streams: list[OfflineStream]):
        """Streams -> (samples [B, N] int16, true sample counts [B]) on the
        device, N covering the frame bucket.  PCM becomes int16 by truncation
        toward zero, exactly as the reference ships it."""
        cfg = self.bundle.frontend_cfg
        n_samples = [len(s.samples) for s in streams]
        n_frames = np.array([num_frames_for(n, cfg) for n in n_samples], np.int32)
        # compat mode claims +19 frames past the longest lane — keep them
        # inside the bucketed buffer
        tail = 19 if self.reference_pad_compat else 0
        t_pad = _bucket(int(n_frames.max(initial=1)) + tail, self.frame_bucket,
                        self.frame_bucket)
        need = (t_pad - 1) * cfg.frame_shift + cfg.frame_length
        batch = np.zeros((len(streams), need), np.int16)
        for i, s in enumerate(streams):
            x = s.samples[:need]
            batch[i, : len(x)] = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
        counts = np.minimum(np.array(n_samples, np.int64), need)
        return torch.from_numpy(batch).to(self.device), torch.from_numpy(counts).to(self.device)

    def begin_decode(self, streams: list[OfflineStream]):
        """Run the device work for a batch and return a pending handle; the
        token buffers stay on the device until ``end_decode``."""
        samples, sample_counts = self.pcm_batch(streams)
        with torch.inference_mode(), self._precision():
            st = self._decode(samples, sample_counts)
        return (streams, st.tokens, st.timestamps, st.count)

    def end_decode(self, pending) -> list[OfflineRecognizerResult]:
        """Read back a ``begin_decode`` handle's tokens and build results."""
        streams, tokens, timestamps, count = pending
        table = self.bundle.tokens
        results = []
        for i, (toks, stamps) in enumerate(rnnt_greedy.extract_results(tokens, timestamps,
                                                                       count)):
            res = OfflineRecognizerResult(
                text=tokens_to_text(toks, table),
                tokens=[table.get(t) for t in toks],
                timestamps=stamps,
            )
            streams[i].result = res
            results.append(res)
        return results

    # -- the decode program -------------------------------------------------

    def _precision(self):
        """float32 compute means true float32: TF32 off while it runs."""
        return exact_f32() if self.compute_dtype is None else contextlib.nullcontext()

    def features(self, samples: torch.Tensor, sample_counts: torch.Tensor):
        """int16 samples [B, N] + true counts -> (feats [B, T_pad, F],
        feat_lens [B])."""
        fcfg = self.bundle.frontend_cfg
        x = samples.float() * (1.0 / 32768.0)
        t_pad = (x.shape[1] - fcfg.frame_length) // fcfg.frame_shift + 1
        feats = fbank_compute(x, fcfg, t_pad, n_valid=sample_counts, tables=self._fbank_tables)
        feat_lens = num_frames_tensor(sample_counts, fcfg)
        if self.reference_pad_compat:
            feats, feat_lens = apply_reference_pad(feats, feat_lens)
        return feats, feat_lens

    def encode(self, samples: torch.Tensor, sample_counts: torch.Tensor):
        """fbank and encoder: -> (enc_out [B, T', D], enc_lens [B])."""
        with torch.inference_mode(), self._precision():
            feats, feat_lens = self.features(samples, sample_counts)
            return self.bundle.encoder(feats, feat_lens, self.compute_dtype)

    def _decode(self, samples, sample_counts) -> rnnt_greedy.GreedyState:
        b = self.bundle
        enc_out, enc_lens = self.encode(samples, sample_counts)
        enc_proj = joiner_mod.project_encoder(b.joiner, enc_out, self.compute_dtype)
        state = rnnt_greedy.init_state(b.decoder, b.decoder_cfg, b.joiner, samples.shape[0],
                                       self.max_tokens, self.compute_dtype)
        zero = torch.zeros((samples.shape[0],), dtype=torch.int64, device=self.device)
        return rnnt_greedy.greedy_frames_skip(
            b.decoder, b.decoder_cfg, b.joiner, state, enc_proj, enc_lens, zero, False,
            self.compute_dtype,
        )
