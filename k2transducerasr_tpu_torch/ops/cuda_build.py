"""Build and load the port's CUDA sources (``csrc/<name>.cu``).

Each source is compiled by ``nvcc`` for sm_90a into a shared library with a
plain C interface, at first use, into ``_build/`` beside this package, and
loaded with ctypes.  The library's file name carries a hash of the source
bytes, of every header ``csrc/*.cuh`` and of the flags, so an edited source
or header never loads a stale build.
Importing this module needs neither ``nvcc`` nor a card.

    fn = cuda_build.function("relpos_attn_ctx", "k2t_relpos_attn_ctx", argtypes)
    cuda_build.launch("relpos_attn_ctx", fn, device, *args)

``build(*names)`` starts one ``nvcc`` per source that is not built yet, all
at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str, source: bytes | None = None) -> str:
    """Where ``name``'s library lives: ``_build/lib<name>_<hash>.so``, the
    hash over ``source`` (default: the file's bytes), every ``csrc/*.cuh``
    in sorted order (name and bytes) and ``NVCC_FLAGS``."""
    if source is None:
        with open(source_path(name), "rb") as f:
            source = f.read()
    h = hashlib.sha256(source)
    for header in sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")):
        with open(os.path.join(CSRC, header), "rb") as f:
            body = f.read()
        h.update(f"\0{header}\0{len(body)}\0".encode() + body)
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def build(*names: str, verbose: bool = False) -> dict[str, str]:
    """Compile each named source whose library does not exist yet (one
    ``nvcc`` each, started together); returns {name: library path}."""
    paths = {name: library_path(name) for name in names}
    todo = {name: out for name, out in paths.items() if not os.path.exists(out)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{stdout}\n{stderr}")
            continue
        if verbose:
            print(stderr, end="", flush=True)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built if needed),
    with its ``argtypes`` and an ``int`` (cudaError_t) result."""
    with _lock:
        fn = _functions.get((name, symbol))
        if fn is None:
            lib = ctypes.CDLL(build(name)[name])
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[(name, symbol)] = fn
    return fn


# cudaErrorInvalidValue: what the entry points return, before any launch,
# for shapes their kernels do not take (a shared-memory plan that does not
# fit a block)
_INVALID_VALUE = 1


def launch(name: str, fn, device: torch.device, *args, tail: tuple = ()) -> None:
    """Call the C entry point ``fn(*args, stream, *tail)`` on ``device``'s
    current stream (``tail``: arguments an entry point added after the
    stream), with ``device`` as the current device, and raise if it returns
    a cudaError: ``ValueError`` for cudaErrorInvalidValue (shapes the kernel
    does not take), else ``RuntimeError``.  The raw stream handle and the
    device check are the cheap forms of ``current_stream()`` and
    ``torch.cuda.device``: the host's time here is time the card idles when
    the queue is empty."""
    idx = device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx), *tail)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx), *tail)
    if err == _INVALID_VALUE:
        raise ValueError(f"{name} kernel does not take these shapes (cudaErrorInvalidValue: "
                         f"its shared-memory plan does not fit a block)")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
