"""ctypes loader for the port's native audio libraries (C++, C ABI): its own
copies of the JAX package's ``audio_native.cpp`` (wav decode, linear
resampling, the streams' ring buffer) and ``media_native.cpp`` (any format
the host's ffmpeg libraries decode).

Each library is built with g++ at first use into ``_build/`` beside the
package (the file name carries a hash of the source and the flags, and a
finished build is moved into place atomically) and loaded with ctypes.
Where g++ or the ffmpeg development files are missing, the callers fall back
to the numpy implementations (``audio/wav.py``, ``audio/resample.py``), as
the JAX package does; the native path gives the same outputs.
``available()`` and ``media_available()`` say which route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_AUDIO = ("audio_native.cpp", "k2taudio", ["-O3", "-shared", "-fPIC", "-std=c++17"], [])
_MEDIA = ("media_native.cpp", "k2tmedia", ["-O2", "-shared", "-fPIC", "-std=c++17"],
          ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"])

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _library(spec) -> ctypes.CDLL | None:
    """Build (once per source and flags) and load a library; None when the
    toolchain or a library it links is missing."""
    src, name, flags, links = spec
    path = os.path.join(_HERE, src)
    with open(path, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(flags + links).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, path, "-o", tmp, *links], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp)
            return None
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    try:
        return ctypes.CDLL(out)
    except OSError:
        return None


def get_lib() -> ctypes.CDLL | None:
    """The audio library (built if needed), or None if unavailable."""
    with _lock:
        if "audio" in _libs:
            return _libs["audio"]
        lib = _library(_AUDIO)
        if lib is not None:
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.k2t_wav_decode.restype = ctypes.c_longlong
            lib.k2t_wav_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, f32p,
                                           ctypes.POINTER(ctypes.c_int)]
            lib.k2t_resample_linear.restype = ctypes.c_longlong
            lib.k2t_resample_linear.argtypes = [f32p, ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, f32p]
            lib.k2t_rb_create.restype = ctypes.c_void_p
            lib.k2t_rb_create.argtypes = [ctypes.c_longlong]
            lib.k2t_rb_free.restype = None
            lib.k2t_rb_free.argtypes = [ctypes.c_void_p]
            lib.k2t_rb_push.restype = None
            lib.k2t_rb_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_longlong]
            lib.k2t_rb_size.restype = ctypes.c_longlong
            lib.k2t_rb_size.argtypes = [ctypes.c_void_p]
            lib.k2t_rb_window.restype = ctypes.c_int
            lib.k2t_rb_window.argtypes = [ctypes.c_void_p, f32p, ctypes.c_longlong]
            lib.k2t_rb_advance.restype = None
            lib.k2t_rb_advance.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        _libs["audio"] = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def get_media_lib() -> ctypes.CDLL | None:
    """The ffmpeg-backed media library (built if needed), or None if the
    host has no ffmpeg development stack."""
    with _lock:
        if "media" in _libs:
            return _libs["media"]
        lib = _library(_MEDIA)
        if lib is not None:
            lib.k2t_media_decode.restype = ctypes.c_void_p
            lib.k2t_media_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                                             ctypes.POINTER(ctypes.c_int)]
            lib.k2t_media_copy.restype = None
            lib.k2t_media_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.k2t_media_free.restype = None
            lib.k2t_media_free.argtypes = [ctypes.c_void_p]
            lib.k2t_media_encode.restype = ctypes.c_int
            lib.k2t_media_encode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                             ctypes.c_longlong, ctypes.c_int]
        _libs["media"] = lib
        return lib


def media_available() -> bool:
    return get_media_lib() is not None


def _f32p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def media_decode(path: str):
    """Decode any file the host media stack knows -> (float32 mono, rate),
    or None if the stack is unavailable or the file cannot be decoded."""
    lib = get_media_lib()
    if lib is None:
        return None
    n = ctypes.c_longlong(0)
    rate = ctypes.c_int(0)
    h = lib.k2t_media_decode(os.fsencode(path), ctypes.byref(n), ctypes.byref(rate))
    if not h:
        return None
    try:
        out = np.empty(n.value, np.float32)
        lib.k2t_media_copy(h, _f32p(out))
    finally:
        lib.k2t_media_free(h)
    return out, int(rate.value)


def media_encode(path: str, pcm: np.ndarray, rate: int) -> bool:
    """Encode mono float32 PCM to ``path`` (codec from the extension), for
    test fixtures.  False if unavailable or the encode failed."""
    lib = get_media_lib()
    if lib is None:
        return False
    x = np.ascontiguousarray(pcm, np.float32)
    return lib.k2t_media_encode(os.fsencode(path), _f32p(x), len(x), rate) == 0


def wav_decode(data: bytes):
    """Native wav decode -> (float32 mono, rate), or None when the library
    is unavailable or the format unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    rate = ctypes.c_int(0)
    n = lib.k2t_wav_decode(data, len(data), None, ctypes.byref(rate))
    if n < 0:
        return None
    out = np.empty(n, np.float32)
    lib.k2t_wav_decode(data, len(data), _f32p(out), ctypes.byref(rate))
    return out, int(rate.value)


def resample_linear(x: np.ndarray, src: int, dst: int):
    """Native linear resampling (``audio.resample.resample_linear``'s
    semantics), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = lib.k2t_resample_linear(_f32p(x), len(x), src, dst, None)
    out = np.empty(n_out, np.float32)
    lib.k2t_resample_linear(_f32p(x), len(x), src, dst, _f32p(out))
    return out


class RingBuffer:
    """Native per-stream sample buffer: push samples, peek fixed windows,
    advance by a hop — amortised O(1), no per-chunk numpy reallocation."""

    def __init__(self, capacity: int = 1 << 16):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native audio library unavailable")
        self._lib = lib
        self._h = lib.k2t_rb_create(capacity)

    def push(self, samples: np.ndarray) -> None:
        x = np.ascontiguousarray(samples, np.float32)
        self._lib.k2t_rb_push(self._h, _f32p(x), len(x))

    def __len__(self) -> int:
        return int(self._lib.k2t_rb_size(self._h))

    def window(self, win: int):
        """The first ``win`` samples (a copy), or None if fewer are held."""
        out = np.empty(win, np.float32)
        return out if self._lib.k2t_rb_window(self._h, _f32p(out), win) == 0 else None

    def advance(self, hop: int) -> None:
        self._lib.k2t_rb_advance(self._h, hop)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.k2t_rb_free(h)
            self._h = None
