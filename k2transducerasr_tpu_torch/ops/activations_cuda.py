"""Bias + Swoosh — the zipformer2 encoder's activations as one kernel:

    bias_swoosh(y, b, kind, out_dtype) = swoosh_kind(y + b), rounded once to out_dtype

    kind "l": SwooshL(z) = softplus(z - 4) - 0.08 z - 0.035
    kind "r": SwooshR(z) = softplus(z - 1) - 0.08 z - 0.313261687
    softplus(t) = max(t, 0) + log1p(exp(-|t|))   (the reference's form)

(``csrc/bias_swoosh.cu``).  It replaces no TPU kernel: XLA fused this chain
on the TPU; eager PyTorch ran it as a bias add, a cast and ten kernels.

``y`` [..., C] is a product (bf16 from cuBLAS, float32 under int8, a
model-sharded weight or ``compute_dtype=None``) or a convolution's float32
output before its bias; ``b`` an optional float32 [C].  All arithmetic is
float32, the result rounded once to ``out_dtype``: float32 or bf16 from a
float32 ``y``, bf16 from a bf16 ``y`` (its only source, a product under a
bf16 compute dtype, feeds a bf16 activation).  The output has ``y``'s
strides: ``y`` may lie in memory in any order of its axes, as long as its
elements fill one dense block (a depthwise convolution's [B, C, T] seen
as [B, T, C], an NCHW convolution seen as NHWC), and the kernel walks the
channel by its stride, so no caller copies its tensor into another layout
first.

The wrapper launches the kernel for CUDA tensors and runs its plain PyTorch
version, ``bias_swoosh_reference`` (the same float32 steps, one rounding),
for CPU tensors.  On a CUDA tensor it launches the kernel or raises; there
is no fallback.  The kernel is compiled with ``nvcc`` at first use
(``ops/cuda_build.py``), so importing this module needs neither ``nvcc``
nor a card.  ``bias_swoosh.launches`` counts kernel launches (the CPU path
does not count); a CUDA graph's program adds its captured launches at each
replay (``runtime/program.py``).
"""

from __future__ import annotations

import ctypes

import torch

from k2transducerasr_tpu_torch.ops import cuda_build
from k2transducerasr_tpu_torch.ops.layers import swoosh_l, swoosh_r

KINDS = {"l": swoosh_l, "r": swoosh_r}
_KIND_CODE = {"l": 0, "r": 1}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ELEMENTS = 2**31 - 1  # the kernel's indices are 32-bit

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(y, b, kind, out_dtype) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be 'l' or 'r', got {kind!r}")
    if y.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes must be float32/bfloat16, got {y.dtype} -> {out_dtype}")
    if y.dtype == torch.bfloat16 and out_dtype == torch.float32:
        raise ValueError("a bf16 y rounds to bf16 only, not to float32")
    if y.dim() == 0:
        raise ValueError("y must have a channel axis")
    if b is not None:
        if b.device != y.device:
            raise ValueError(f"b on {b.device}, y on {y.device}")
        if b.dtype != torch.float32:
            raise ValueError(f"b must be float32, got {b.dtype}")
        if tuple(b.shape) != (y.shape[-1],):
            raise ValueError(f"b shape {tuple(b.shape)} != ({y.shape[-1]},)")


def _channel_stride(y: torch.Tensor) -> int:
    """The stride of ``y``'s channel (last) axis in the one dense block its
    elements fill, in some order of its axes (no gap, no overlap): what the
    kernel walks.  ValueError for any other layout."""
    expected = 1
    for stride, size in sorted((st, s) for s, st in zip(y.shape, y.stride()) if s > 1):
        if stride != expected:
            raise ValueError(f"y's elements must fill one dense block of memory, got shape "
                             f"{tuple(y.shape)} strides {y.stride()}")
        expected *= size
    return y.stride(-1) if y.shape[-1] > 1 else 1


def bias_swoosh(y: torch.Tensor, b: torch.Tensor | None, kind: str,
                out_dtype: torch.dtype) -> torch.Tensor:
    """swoosh_kind(y + b) in float32, rounded once to ``out_dtype``; see the
    module docstring."""
    _check(y, b, kind, out_dtype)
    if y.device.type == "cpu":
        return bias_swoosh_reference(y, b, kind, out_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"bias_swoosh: unsupported device {y.device}")
    if y.numel() > MAX_ELEMENTS:
        raise ValueError(f"kernel takes at most {MAX_ELEMENTS} elements, got {y.numel()}")
    if b is not None and not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if y.numel() == 0:
        return torch.empty_like(y, dtype=out_dtype)
    sc = _channel_stride(y)
    out = torch.empty_like(y, dtype=out_dtype)  # y's strides (y is dense)
    fn = cuda_build.function("bias_swoosh", "k2t_bias_swoosh", _ARGTYPES)
    cuda_build.launch("bias_swoosh", fn, y.device,
                      y.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
                      y.numel(), y.shape[-1], sc, _KIND_CODE[kind], _DTYPE_CODE[y.dtype],
                      _DTYPE_CODE[out_dtype])
    bias_swoosh.launches += 1
    return out


bias_swoosh.launches = 0


def bias_swoosh_reference(y: torch.Tensor, b: torch.Tensor | None, kind: str,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``bias_swoosh`` (same contract): ``y`` and
    the bias added in float32, the Swoosh of ``ops/layers.py`` in float32,
    cast to ``out_dtype`` at the end."""
    _check(y, b, kind, out_dtype)
    z = y.float()
    if b is not None:
        z = z + b
    return KINDS[kind](z).to(out_dtype)
