"""Compressed-audio decode via the host OS codec libraries (ctypes) — the
port's copy of ``k2transducerasr_tpu/audio/codecs.py``.

The reference decodes mp3/media through the OS codec stack (NAudio /
MediaFoundation, ``Examples/Utils/AudioHelper.cs:41-78``).  The host analog
is binding the distro codec libraries directly: libmpg123 for
MPEG audio (mp3).  No Python codec packages are assumed; if the shared
library is absent we raise with a clear message and wav decode still works.

Decode contract (same as wav): mono float32 in [-1, 1] + sample rate.
Multi-channel sources are downmixed by averaging, matching
``AudioHelper.GetFileSample``'s mono conversion.

ogg/flac/mp4 (and any other host-supported container) decode through the
ffmpeg-backed native library (native/media_native.cpp, routed from
wav.read_wav); the magic sniffing surface (AudioHelper.cs:285-405) is
matched in wav.py.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

# mpg123 API constants (mpg123.h enum mpg123_errors / mpg123_enc_enum)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_ENC_SIGNED_16 = 0xD0

_mpg123 = None


def _load_mpg123():
    global _mpg123
    if _mpg123 is not None:
        return _mpg123
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:  # pragma: no cover - env without codecs
        raise RuntimeError(
            "mp3 decode needs libmpg123 on the host (not found); "
            "decode to wav/pcm first"
        ) from e
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.restype = ctypes.c_int
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.restype = ctypes.c_int
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    lib.mpg123_init()
    _mpg123 = lib
    return lib


def decode_mp3(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Decode an mp3 file to (mono float32 samples in [-1,1], sample_rate).

    mpg123 applies LAME gapless info when present, so round-trips through
    an mp3 encoder are sample-count faithful up to codec delay.
    """
    lib = _load_mpg123()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(
            f"mpg123_new failed: {lib.mpg123_plain_strerror(err.value).decode()}"
        )
    try:
        rc = lib.mpg123_open(h, os.fspath(path).encode())
        if rc != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed (rc={rc}) for {path!r}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        rc = lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        if rc != _MPG123_OK:
            raise RuntimeError(f"mpg123_getformat failed (rc={rc})")
        # Pin the output format to signed 16-bit at the stream's native rate
        # so later frames can't renegotiate mid-read.
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)

        bufsize = 1 << 17
        buf = ctypes.create_string_buffer(bufsize)
        done = ctypes.c_size_t(0)
        chunks: list[bytes] = []
        while True:
            rc = lib.mpg123_read(h, buf, bufsize, ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc in (_MPG123_OK, _MPG123_NEW_FORMAT, _MPG123_NEED_MORE):
                continue
            raise RuntimeError(
                f"mpg123_read failed: {lib.mpg123_plain_strerror(rc).decode()}"
            )
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2").astype(np.float32)
        pcm /= 32768.0
        if channels.value > 1:
            pcm = pcm.reshape(-1, channels.value).mean(axis=1)
        return np.ascontiguousarray(pcm), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def encode_mp3(
    samples: np.ndarray, sample_rate: int, path: str | os.PathLike, bitrate: int = 128
) -> None:
    """Encode mono float32 samples to an mp3 file via libmp3lame.

    Exists to build test fixtures and synthetic workloads without shipping
    binary blobs in the repo; not part of the recognition path.
    """
    name = ctypes.util.find_library("mp3lame") or "libmp3lame.so.0"
    lib = ctypes.CDLL(name)
    lib.lame_init.restype = ctypes.c_void_p
    for fn in (
        "lame_set_in_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_mode",
        "lame_init_params",
    ):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int][
            : 1 if fn == "lame_init_params" else 2
        ]
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.lame_close.restype = ctypes.c_int
    lib.lame_close.argtypes = [ctypes.c_void_p]

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_brate(gfp, int(bitrate))
        lib.lame_set_mode(gfp, 3)  # MONO
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        pcm = np.clip(np.asarray(samples, np.float32) * 32768.0, -32768, 32767).astype(
            "<i2"
        )
        pcm = np.ascontiguousarray(pcm)
        outsize = int(1.25 * len(pcm)) + 7200
        out = ctypes.create_string_buffer(outsize)
        n = lib.lame_encode_buffer(
            gfp,
            pcm.ctypes.data_as(ctypes.c_void_p),
            pcm.ctypes.data_as(ctypes.c_void_p),  # right == left for mono
            len(pcm),
            out,
            outsize,
        )
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {n}")
        tail = ctypes.create_string_buffer(7200)
        m = lib.lame_encode_flush(gfp, tail, 7200)
        with open(os.fspath(path), "wb") as f:
            f.write(out.raw[:n])
            f.write(tail.raw[:m])
    finally:
        lib.lame_close(gfp)
