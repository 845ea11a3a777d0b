"""The port's audio ingest (``audio/``) and native libraries (``native/``,
built into ``_build/``) against the JAX package's on the CPU: the port of
tests/test_audio.py and tests/test_native.py.  Every decoded or resampled
signal equals the JAX package's bit for bit; the tests that need g++, the
host's mp3 codecs or its ffmpeg stack skip where the host lacks them (each
decides inside the test).  The online recognizer's native ring buffer and
its numpy fallback give the same transcripts.
"""

import ctypes
import ctypes.util
import io
import struct
import wave

import numpy as np
import pytest
import torch

from k2transducerasr_tpu import native as jnative
from k2transducerasr_tpu.audio import resample as JR
from k2transducerasr_tpu.audio import wav as JW
from k2transducerasr_tpu_torch import ModelBundle, OnlineRecognizer
from k2transducerasr_tpu_torch import audio as TA
from k2transducerasr_tpu_torch import native
from k2transducerasr_tpu_torch.audio import codecs as TC
from k2transducerasr_tpu_torch.audio import resample as TR
from k2transducerasr_tpu_torch.audio import wav as TW
from k2transducerasr_tpu_torch.models.lstm import LstmConfig


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("native toolchain (g++) unavailable")
    return native


def _wav_bytes(samples, rate=16000, channels=1):
    """16-bit wav bytes; ``samples`` [N] is copied to every channel, [N, C]
    gives each channel its own."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = np.stack([samples] * channels, 1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples.reshape(-1), -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _float_wav(x):
    hdr = b"RIFF" + struct.pack("<I", 36 + x.nbytes) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32)
    return hdr + fmt + b"data" + struct.pack("<I", x.nbytes) + x.tobytes()


def _equal(got, want):
    assert got.sample_rate == want.sample_rate
    assert got.samples.dtype == want.samples.dtype == np.float32
    np.testing.assert_array_equal(got.samples, want.samples)


SIGNALS = {
    "pcm16-mono": lambda: _wav_bytes(np.sin(np.linspace(0, 10, 1600)).astype(np.float32) * 0.5),
    "pcm16-stereo": lambda: _wav_bytes(np.sin(np.linspace(0, 10, 1600)) * 0.5, channels=2),
    "pcm16-8k": lambda: _wav_bytes(np.sin(np.linspace(0, 30, 800)) * 0.3, rate=8000),
    "float32": lambda: _float_wav((np.sin(np.linspace(0, 20, 800)) * 0.25).astype("<f4")),
}


@pytest.mark.parametrize("kind", list(SIGNALS))
def test_read_wav_matches_jax(kind):
    data = SIGNALS[kind]()
    _equal(TW.read_wav(data), JW.read_wav(data))


def test_read_wav_values_and_sniffing():
    x = np.sin(np.linspace(0, 10, 1600)).astype(np.float32) * 0.5
    audio = TA.read_wav(_wav_bytes(x))
    assert audio.sample_rate == 16000 and abs(audio.duration - 0.1) < 1e-6
    np.testing.assert_allclose(audio.samples, np.round(x * 32767) / 32767, atol=1e-4)
    np.testing.assert_allclose(TA.read_wav(_wav_bytes(np.stack([x, -x], 1))).samples,
                               np.zeros(1600), atol=1e-4)
    for data in (b"RIFFxxxxWAVE", b"ID3\x04rest", b"OggS....", b"fLaC....",
                 b"\x00\x00\x00\x20ftypisom", b"\xff\xfb..", b"nothing"):
        assert TW.sniff_format(data) == JW.sniff_format(data)
    assert TA.read_audio is TA.read_wav


def test_read_wav_from_a_path_and_in_chunks(tmp_path):
    x = np.random.default_rng(7).standard_normal(4000).astype(np.float32) * 0.1
    path = tmp_path / "noise.wav"
    path.write_bytes(_wav_bytes(x))
    _equal(TW.read_wav(str(path)), JW.read_wav(str(path)))
    got = list(TW.read_wav_chunks(str(path), 800))
    want = list(JW.read_wav_chunks(str(path), 800))
    assert [len(c) for c in got] == [len(c) for c in want] == [800] * 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rates", [(32000, 16000), (44100, 16000), (8000, 16000),
                                   (16000, 16000)])
def test_resample_matches_jax(rates):
    x = np.random.default_rng(0).standard_normal(7001).astype(np.float32)
    np.testing.assert_array_equal(TR.resample_linear(x, *rates), JR.resample_linear(x, *rates))
    np.testing.assert_array_equal(TR.resample_sinc(x[:3000], *rates),
                                  JR.resample_sinc(x[:3000], *rates))
    assert TA.resample_linear is TR.resample_linear


def test_native_builds_into_the_ports_build_dir(native_lib):
    import os

    lib = native_lib.get_lib()
    assert os.path.dirname(lib._name) == native_lib.BUILD_DIR
    assert native_lib.BUILD_DIR.endswith(os.path.join("k2transducerasr_tpu_torch", "_build"))
    assert native_lib.get_lib() is lib  # built and loaded once


def test_native_wav_decode_matches_jax(native_lib):
    x = (np.sin(np.linspace(0, 30, 3200)) * 0.6).astype(np.float32)
    for data in (_wav_bytes(x), _wav_bytes(x, channels=2), _float_wav(x.astype("<f4"))):
        got, rate = native_lib.wav_decode(data)
        with wave.open(io.BytesIO(_wav_bytes(x))) as w:
            py = JW._decode_pcm(w.readframes(w.getnframes()), 2, 1)
        if jnative.available():
            want, jrate = jnative.wav_decode(data)
            assert rate == jrate
            np.testing.assert_array_equal(got, want)
        if data[20:22] != b"\x03\x00":  # the PCM ones: the numpy route's values
            assert rate == 16000
            np.testing.assert_allclose(got, py, atol=1e-6)
    assert native_lib.wav_decode(b"not a wav file at all........") is None


def test_native_resample_matches_jax(native_lib):
    x = np.random.default_rng(0).standard_normal(32000).astype(np.float32)
    got = native_lib.resample_linear(x, 32000, 16000)
    want = JR.resample_linear(x, 32000, 16000)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.resample_linear(x, 32000, 16000))


def test_ring_buffer_semantics(native_lib):
    rb = native_lib.RingBuffer()
    rb.push(np.arange(10, dtype=np.float32))
    assert len(rb) == 10
    assert rb.window(12) is None  # underfull
    np.testing.assert_array_equal(rb.window(6), np.arange(6, dtype=np.float32))
    rb.advance(4)
    assert len(rb) == 6
    np.testing.assert_array_equal(rb.window(6), np.arange(4, 10, dtype=np.float32))
    for i in range(100):  # many pushes exercise compaction
        rb.push(np.full(1000, i, np.float32))
        rb.advance(1000)
    assert len(rb) == 6
    assert rb.window(0).shape == (0,)


def test_online_stream_uses_the_native_ring_buffer(native_lib):
    """OnlineStream on the native ring buffer decodes as on the numpy
    fallback, partial results and snapshot included."""
    cfg = LstmConfig(d_model=32, rnn_hidden_size=48, num_layers=1, ff_dim=64, chunk_size=4)
    bundle = ModelBundle.random("lstm", cfg, vocab_size=16, seed=0, decoder_dim=24,
                                joiner_dim=24, device="cpu")
    rec = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device="cpu")
    pcm = np.random.default_rng(1).standard_normal(
        3 * rec.window_samples + rec.hop_samples).astype(np.float32) * 0.1
    out = []
    for use_native in (True, False):
        s = rec.create_online_stream()
        assert s._rb is not None  # the native path is active where it was built
        if not use_native:
            s._rb = None
        texts = []
        for i in range(0, len(pcm), 700):
            s.add_samples(pcm[i:i + 700])
            while s._ready():
                texts.append(rec.get_results([s])[0].text)
        snap = rec.snapshot_stream(s)
        assert snap["buffer"].shape == (s._size(),)
        texts.append(rec.decode_to_end(s).text)
        out.append((texts, snap["buffer"]))
        rec.dispose_stream(s)
    assert out[0][0] == out[1][0] and out[0][0][-1]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def _codec_libs_present():
    def so(name):
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            return False

    return bool((ctypes.util.find_library("mpg123") or so("libmpg123.so.0"))
                and (ctypes.util.find_library("mp3lame") or so("libmp3lame.so.0")))


def test_mp3_decode_matches_jax(tmp_path):
    if not _codec_libs_present():
        pytest.skip("host codec libraries not present")
    rate = 16000
    t = np.arange(rate) / rate
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = tmp_path / "tone.mp3"
    TC.encode_mp3(x, rate, path)
    got = TA.read_audio(str(path))
    _equal(got, JW.read_audio(str(path)))
    assert abs(len(got.samples) - len(x)) < 3000
    best = max(float(np.corrcoef(got.samples[lag:lag + 8000], x[:8000])[0, 1])
               for lag in range(0, 2400, 24))
    assert best > 0.95, f"decoded waveform poorly correlated: {best}"
    _equal(TA.read_audio(path.read_bytes()), got)  # bytes, no file name
    chunks = list(TW.read_wav_chunks(str(path), 800))
    assert all(len(c) == 800 for c in chunks[:-1]) and sum(map(len, chunks)) == len(got.samples)


def test_media_decode_matches_jax(tmp_path):
    """ogg, flac and mp4 through the ffmpeg-backed native media library."""
    if not native.media_available():
        pytest.skip("host ffmpeg media stack not present")
    rate = 16000
    t = np.arange(2 * rate) / rate
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    for ext, kind in (("ogg", "ogg"), ("flac", "flac"), ("m4a", "mp4")):
        path = tmp_path / f"tone.{ext}"
        assert native.media_encode(str(path), x, rate), f"{ext} encode failed"
        assert TW.sniff_format(path.read_bytes()) == kind
        got = TA.read_audio(str(path))
        assert got.sample_rate == rate and abs(len(got.samples) - len(x)) < 4000
        if jnative.media_available():
            _equal(got, JW.read_audio(str(path)))
        if kind == "flac":  # lossless up to one 16-bit step
            n = min(len(got.samples), len(x))
            assert np.max(np.abs(got.samples[:n] - x[:n])) < 2.0 / 32768
        _equal(TA.read_audio(path.read_bytes()), got)
