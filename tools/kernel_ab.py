"""What the A/B tools share: build versions of one kernel's source, swap a
build in under the port's wrapper, and time calls on the card.

A kernel ``name`` is a source ``k2transducerasr_tpu_torch/csrc/<name>.cu``
whose C entry is ``k2t_<name>``.  Each version is compiled with ``nvcc`` and
the flags of ``ops/cuda_build.py``, its includes resolved against ``csrc/``,
into the git-ignored ``_build/`` (once per content: the file name carries the
text's hash), all versions' ``nvcc`` started together.  ``use`` puts a build
in ``cuda_build``'s table of loaded functions, where the wrapper looks it up
at its next launch; ``restore`` drops it, so the next launch loads the
checkout's own build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k2transducerasr_tpu_torch.ops import cuda_build  # noqa: E402


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def build(name: str, sources: dict[str, str], argtypes) -> dict:
    """Compile each source text of kernel ``name`` and return its
    ``k2t_<name>`` by label."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    running, libs = [], {}
    for label, text in sources.items():
        tag = hashlib.sha256(text.encode()).hexdigest()[:16]
        lib = os.path.join(cuda_build.BUILD_DIR, f"lib{name}_ab_{tag}.so")
        if not os.path.exists(lib):
            cu = os.path.join(cuda_build.BUILD_DIR, f"{name}_ab_{tag}.cu")
            with open(cu, "w") as f:
                f.write(text)
            running.append((label, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", lib,
                 cu])))
        libs[label] = lib
    failed = [label for label, proc in running if proc.wait() != 0]
    if failed:
        raise SystemExit(f"{name}: nvcc failed for {failed}")
    fns = {}
    for label, lib in libs.items():
        fn = getattr(ctypes.CDLL(lib), f"k2t_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def use(name: str, fn) -> None:
    """The wrapper of kernel ``name`` launches ``fn`` from now on."""
    cuda_build._functions[(name, f"k2t_{name}")] = fn


def restore(name: str) -> None:
    cuda_build._functions.pop((name, f"k2t_{name}"), None)


def median_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """The median of ``reps`` calls of ``fn`` timed by CUDA events, after
    ``warm`` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
