"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking for
CUDA where there is none raises: nothing carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')")
    return dev


# exact_f32's scopes over the whole process, since the flags it clears are
# the process's: how many are open, and the flags the first one found
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = (False, False)


@contextlib.contextmanager
def exact_f32():
    """Turn TF32 off for float32 matmuls and cuDNN (convolutions and RNNs)
    while the block runs: the one precision rule of the port's device work,
    which the recognizers enter for every compute dtype and the fbank for
    its matmuls.  A product that may run on TF32 asks for it in its own call
    (``ops/layers.conv_tf32``) and sets no flag.

    Scopes nest and overlap across threads: under a lock, the first to open
    saves both flags and clears them, and the last to close restores them,
    so no thread's float32 work meets TF32 while another's scope is open.
    A flag the caller sets meanwhile is overwritten at the last close."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _f32_saved[0]
                torch.backends.cudnn.allow_tf32 = _f32_saved[1]


def host_zeros(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zeroed host buffer to fill and then ``upload`` to ``device``:
    pinned when ``device`` is the card, so the upload does not wait."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def upload(x: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``.  To the card the copy goes from
    pinned memory (``x`` itself when it is pinned, else a pinned copy) and
    does not block the host: PyTorch's caching host allocator keeps the
    pinned block until the copy is done."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if device.type != "cuda":
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def readback(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that no later work writes: from the card pinned
    and non-blocking, in stream order (the caller records an event after it
    and waits on that event before reading); on the CPU a clone."""
    if t.device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    return t.clone()
