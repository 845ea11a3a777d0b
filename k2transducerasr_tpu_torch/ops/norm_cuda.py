"""LayerNorm — the conformer's and the LSTM's norms as one kernel:

    layernorm(x, scale, bias, eps) = (x - mean) * rsqrt(var + eps) * scale + bias

over the last axis of ``x``, with the mean and the population variance
(``torch.var(correction=0)``) in float32, every step in float32 and the
result rounded once to ``x``'s dtype (``csrc/layernorm.cu``).  It replaces
no TPU kernel: XLA fused this chain on the TPU; eager PyTorch ran it as ten
kernels, eight of them over the whole tensor in float32.

``x`` [..., D] is float32 or bf16, its last axis dense and its rows (the
leading axes taken as one) at one stride; ``scale`` and ``bias`` are
float32 [D].  The output is dense, in ``x``'s dtype.

The wrapper launches the kernel for CUDA tensors and runs its plain PyTorch
version, ``layernorm_reference``, for CPU tensors.  On a CUDA tensor it
launches the kernel or raises; there is no fallback.  The kernel is
compiled with ``nvcc`` at first use (``ops/cuda_build.py``), so importing
this module needs neither ``nvcc`` nor a card.  ``layernorm.launches``
counts kernel launches (the CPU path does not count); a CUDA graph's
program adds its captured launches at each replay (``runtime/program.py``).
"""

from __future__ import annotations

import ctypes

import torch

from k2transducerasr_tpu_torch.ops import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024  # a row lives in one warp's registers
MAX_ROWS = 2**31 - 1

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(x, scale, bias) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0:
        raise ValueError("x must have a feature axis")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (x.shape[-1],):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({x.shape[-1]},)")


def _row_stride(x: torch.Tensor) -> int:
    """The stride between the rows of ``x`` seen as [rows, D]: its last axis
    dense and its leading axes one axis of rows at one stride, no less than
    D (rows that do not overlap).  ValueError for any other layout."""
    d = x.shape[-1]
    if d > 1 and x.stride(-1) != 1:
        raise ValueError(f"x's last axis must be dense, got strides {x.stride()}")
    step = expected = None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if step is None:
            step = expected = stride
        if stride != expected:
            raise ValueError(f"x's rows must lie at one stride, got shape {tuple(x.shape)} "
                             f"strides {x.stride()}")
        expected = stride * size
    if step is not None and step < d:
        raise ValueError(f"x's rows overlap: stride {step} < {d}")
    return d if step is None else step


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis in float32, rounded once to
    ``x``'s dtype; see the module docstring."""
    _check(x, scale, bias)
    stride = _row_stride(x)
    if x.device.type == "cpu":
        return layernorm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    d = x.shape[-1]
    if d > MAX_WIDTH:
        raise ValueError(f"kernel takes rows of at most {MAX_WIDTH} elements, got {d}")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale and bias must be contiguous")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows = x.numel() // d
    if rows > MAX_ROWS:
        raise ValueError(f"kernel takes at most {MAX_ROWS} rows, got {rows}")
    fn = cuda_build.function("layernorm", "k2t_layernorm", _ARGTYPES)
    cuda_build.launch("layernorm", fn, x.device, x.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), rows, d, stride, eps,
                      _DTYPE_CODE[x.dtype])
    layernorm.launches += 1
    return out


layernorm.launches = 0


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``layernorm``: float32 mean and (population)
    variance over the last axis, cast back to the input dtype."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)
