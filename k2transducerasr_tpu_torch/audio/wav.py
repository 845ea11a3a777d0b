"""Host-side audio ingest: RIFF/WAVE + mp3 decoding to float32 mono — the
port's copy of ``k2transducerasr_tpu/audio/wav.py``.

Equivalent capability to the reference's ``Examples/Utils/AudioHelper.cs``
(NAudio + MediaFoundation): wav decode, channel downmix, normalization to
[-1, 1], and format sniffing by magic bytes (AudioHelper.cs:285-405).  We
support PCM16/PCM24/PCM32/IEEE-float wav natively via the stdlib, mp3 via
the host codec library (audio/codecs.py), and ogg/flac/mp4 (plus anything
else the host media stack knows) via the ffmpeg-backed native decoder
(native/media_native.cpp) — the OS-codec route the reference takes through
MediaFoundation.
"""

from __future__ import annotations

import io
import struct
import wave
from dataclasses import dataclass

import numpy as np


@dataclass
class AudioData:
    """Decoded mono audio. ``samples`` is float32 in [-1, 1]."""

    samples: np.ndarray
    sample_rate: int

    @property
    def duration(self) -> float:
        return float(len(self.samples)) / float(self.sample_rate)


# Magic-byte sniffing (same container set the reference recognizes,
# AudioHelper.cs:285-405).
_MAGIC = [
    (b"RIFF", "wav"),
    (b"ID3", "mp3"),
    (b"\xff\xfb", "mp3"),
    (b"\xff\xf3", "mp3"),
    (b"\xff\xf2", "mp3"),
    (b"OggS", "ogg"),
    (b"fLaC", "flac"),
]


def sniff_format(data: bytes) -> str:
    for magic, name in _MAGIC:
        if data[: len(magic)] == magic:
            return name
    if len(data) >= 12 and data[4:8] == b"ftyp":
        return "mp4"
    return "unknown"


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        # wav 8-bit is unsigned
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        # sign-extend 24-bit little-endian
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
        ).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav sample width: {sampwidth}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x


def _read_wav_float(data: bytes) -> AudioData | None:
    """Parse an IEEE-float (format tag 3) wav, which ``wave`` cannot read."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data" and fmt is not None:
            tag, n_ch, rate, _, _, bits = fmt
            if tag == 3 or (tag == 0xFFFE and bits == 32):
                x = np.frombuffer(body, dtype="<f4").astype(np.float32)
                if n_ch > 1:
                    x = x.reshape(-1, n_ch).mean(axis=1)
                return AudioData(np.ascontiguousarray(x), rate)
            return None
        pos += 8 + size + (size & 1)
    return None


def read_wav(path_or_bytes: str | bytes) -> AudioData:
    """Decode a wav file to mono float32 in [-1, 1].

    Parity: the reference converts to "16-bit PCM -> float / 32768, downmix"
    (AudioHelper.cs:12-32); we keep full source precision instead.
    """
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    kind = sniff_format(data)
    if kind == "mp3":
        import tempfile

        from k2transducerasr_tpu_torch.audio import codecs

        if isinstance(path_or_bytes, bytes):
            with tempfile.NamedTemporaryFile(suffix=".mp3") as tmp:
                tmp.write(data)
                tmp.flush()
                samples, rate = codecs.decode_mp3(tmp.name)
        else:
            samples, rate = codecs.decode_mp3(path_or_bytes)
        return AudioData(samples, rate)
    if kind not in ("wav", "unknown"):
        # ogg/flac/mp4 (and anything else the host media stack knows) route
        # through the ffmpeg-backed native decoder — the analog of the
        # reference handing non-wav media to MediaFoundation
        # (AudioHelper.cs:41-78)
        import tempfile

        from k2transducerasr_tpu_torch import native

        if native.media_available():
            if isinstance(path_or_bytes, bytes):
                with tempfile.NamedTemporaryFile(suffix=f".{kind}") as tmp:
                    tmp.write(data)
                    tmp.flush()
                    decoded = native.media_decode(tmp.name)
            else:
                decoded = native.media_decode(path_or_bytes)
            if decoded is None:
                raise ValueError(f"host media stack failed to decode '{kind}' input")
            samples, rate = decoded
            return AudioData(samples, rate)
        raise ValueError(
            f"compressed audio format '{kind}' needs the host ffmpeg "
            "libraries (libavformat/avcodec/swresample), which are "
            "unavailable; decode to wav/pcm first"
        )

    # the native C++ decoder (k2transducerasr_tpu_torch/native) when built:
    # the same output as the numpy path below (tests/test_torch_audio.py)
    from k2transducerasr_tpu_torch import native

    decoded = native.wav_decode(data)
    if decoded is not None:
        samples, rate = decoded
        return AudioData(samples, rate)

    try:
        with wave.open(io.BytesIO(data)) as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
        return AudioData(_decode_pcm(raw, sampwidth, n_channels), rate)
    except wave.Error:
        out = _read_wav_float(data)
        if out is not None:
            return out
        raise


# Public name reflecting the widened surface (wav + mp3); read_wav kept for
# backward compatibility.
read_audio = read_wav


def read_wav_chunks(path: str, chunk_samples: int):
    """Yield successive mono float32 chunks — streaming-ingest parity with
    ``AudioHelper.GetFileChunkSamples`` (AudioHelper.cs:80-127), which feeds
    800-sample chunks to the online recognizer."""
    audio = read_wav(path)
    x = audio.samples
    for i in range(0, len(x), chunk_samples):
        yield x[i : i + chunk_samples]
