"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking for
CUDA where there is none raises: nothing carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib

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
