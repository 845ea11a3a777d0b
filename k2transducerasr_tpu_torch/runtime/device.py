"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking for
CUDA where there is none raises: nothing carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def exact_f32():
    """Turn TF32 off for float32 matmuls and cuDNN convolutions while the
    block runs, then restore both flags.  A float32 conv goes through cuDNN
    in TF32 by default (about three decimal digits); the fbank matmuls and
    the ``compute_dtype=None`` path are specified as true float32."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


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
