"""The neural-net ops the encoder families use, as plain functions on
tensors — PyTorch port of the matching subset of
``k2transducerasr_tpu/ops/layers.py``.

Conventions (as in the reference):
  * params are ``ParamTree`` nodes (or dicts) of float32 tensors in the JAX
    package's layouts (see ``runtime/checkpoint.py``);
  * ``compute_dtype`` (bf16, or None for float32) is the dtype operands are
    cast to; products accumulate in float32, the bias is added in float32,
    and the result is cast back to ``compute_dtype``.

A linear whose tree holds ``w_q8``/``w_scale`` (``quantize_tree_int8``)
runs in int8: per-token symmetric activation scales, an int8 x int8 ->
int32 product (``torch._int_mm``: cuBLASLt on the card), then the scales and
the bias in float32 — the reference's ``accuracy="int8"`` mode, whose
product XLA computes (no Pallas kernel).

A weight that ``parallel/sharding.shard_params`` split over a mesh's
``model`` dimension is a ``ModelShard``, and ``apply_linear`` writes out the
collectives of tensor parallelism (``_product``): split on its output axis,
the local product's columns are gathered; split on its input axis, the
product of the input's slice is summed over the group and the bias added
after the sum.  Under int8 the activation scale is taken over the whole row
before the slice, and the int32 partial products sum exactly.

One rounding differs from the reference under bf16: ``apply_linear`` takes
PyTorch's bf16 matmul, whose float32 accumulator is rounded to bf16 before
the float32 bias add (the reference rounds once, after the add).  That is a
one-bf16-ulp-level difference, stated in the bf16 tolerances of the tests.

Convolutions take float32 operands rounded to ``compute_dtype`` and give a
float32 output, as the reference computes them.  The port's device work runs
with TF32 off (``runtime/device.exact_f32``, which the recognizers enter for
every compute dtype); the one product that uses TF32 asks for it in its own
call (``conv_tf32``) and sets no flag.  That is a product over a dtype TF32
holds exactly (bf16, fp16: at most 10 explicit mantissa bits, and float32's
exponent) with enough outputs a group for the tensor cores to pay
(``TF32_MIN_OUT_CHANNELS``): the operands pass into TF32 unchanged, each
product of two is exact in float32 and the sums stay float32, so only their
order differs, as it does between any two cuDNN algorithms.  The float32
route (``compute_dtype=None``), depthwise products (one output a group:
PyTorch's own kernel, where TF32 means nothing) and other narrow ones are
plain ``F.conv1d``/``F.conv2d`` calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from k2transducerasr_tpu_torch.parallel.sharding import ModelShard, all_gather_dim, all_reduce_sum

NEG_INF = -1e9  # attention mask fill (f32-safe, bf16-safe)


# Initializers: numpy-seeded, the reference initializers' shapes and
# uniform(+-1/sqrt(fan_in)) scales (the values differ from jax.random's).


def _uniform(rng: np.random.Generator, shape, scale: float) -> np.ndarray:
    return rng.uniform(-scale, scale, size=shape).astype(np.float32)


def init_linear(rng, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    scale = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(rng, (in_dim, out_dim), scale)}
    if bias:
        p["b"] = _uniform(rng, (out_dim,), scale)
    return p


def init_conv1d(rng, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                bias: bool = True) -> dict:
    scale = 1.0 / math.sqrt(in_ch // groups * kernel)
    p = {"w": _uniform(rng, (kernel, in_ch // groups, out_ch), scale)}
    if bias:
        p["b"] = _uniform(rng, (out_ch,), scale)
    return p


def init_conv2d(rng, in_ch: int, out_ch: int, kernel: tuple) -> dict:
    scale = 1.0 / math.sqrt(in_ch * kernel[0] * kernel[1])
    return {"w": _uniform(rng, (*kernel, in_ch, out_ch), scale),
            "b": _uniform(rng, (out_ch,), scale)}


def init_embedding(rng, vocab: int, dim: int) -> dict:
    return {"table": rng.standard_normal((vocab, dim)).astype(np.float32)}


def init_biasnorm(dim: int) -> dict:
    return {"bias": np.zeros((dim,), np.float32), "log_scale": np.zeros((), np.float32)}


def init_layernorm(dim: int) -> dict:
    return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}


def init_batchnorm(dim: int) -> dict:
    """Inference-mode batchnorm: running statistics folded into scale/bias."""
    return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}


def _cast(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype is None else x.to(compute_dtype)


def apply_linear(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b) — see the module docstring for the
    bf16 rounding and the int8 form."""
    y = linear_product(p, x, compute_dtype).float()
    if "b" in p:
        y = y + p["b"]
    return _cast(y, compute_dtype)


def linear_product(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``apply_linear`` without its bias and its cast, for a caller whose
    next op adds the bias (``ops/activations_cuda.bias_swoosh``): with a
    whole weight under a ``compute_dtype``, the product as cuBLAS rounds it
    to that dtype (the values ``apply_linear`` adds its bias to); float32
    under None, under int8 (the scales applied) and for a model-sharded
    weight (its partial products gathered or summed in float32)."""
    if "w_q8" in p:
        return _int8_product(p, x)
    w = p["w"]
    if compute_dtype is None:
        return _product(x, w, lambda a, m: torch.matmul(a.to(m.dtype), m))
    if isinstance(w, ModelShard):
        return _product(x, w, lambda a, m: torch.matmul(a.to(compute_dtype),
                                                        m.to(compute_dtype)).float())
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))


def _product(x: torch.Tensor, w, mm) -> torch.Tensor:
    """``mm(x, w)`` for a whole ``w``; for a ``ModelShard``, the same product
    from this rank's shard and the ``model`` group's collectives: split on
    the output axis, the local columns gathered; split on the input axis,
    the product of ``x``'s matching slice summed over the group."""
    if not isinstance(w, ModelShard):
        return mm(x, w)
    if w.axis == 1:
        return all_gather_dim(mm(x, w.local), -1, w.group)
    k = w.local.shape[0]
    return all_reduce_sum(mm(x[..., w.rank * k:(w.rank + 1) * k], w.local), w.group)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded on every device, as the reference
    quantizes its weights (eagerly).  (On CUDA, dividing by a Python number
    multiplies by its rounded reciprocal, one float32 ulp off for some x; a
    tensor divisor divides.)"""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def _mul_inv127(x: torch.Tensor) -> torch.Tensor:
    """x * float32(1/127): the reference's activation scale, which XLA
    compiles from ``amax / 127.0`` into this product; exactly rounded on
    every device."""
    return x * torch.full((), 1.0 / 127.0, dtype=x.dtype, device=x.device)


def quantize_linear_int8(p) -> dict:
    """{"w": [in, out], ...} -> {"w_q8": int8 [in, out], "w_scale": [out]
    float32, ...}: symmetric per-output-channel weights, a zero scale taken
    as 1, round half to even, clipped to +-127.  On the tree's own device;
    ``w_q8`` is stored column-major, the layout ``int8_matmul`` wants."""
    w = p["w"]
    scale = _div127(torch.amax(torch.abs(w), dim=0))
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w_q8": _col_major(q), "w_scale": scale.float()}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_tree_int8(tree, min_size: int = 4096):
    """Every linear-shaped node ({"w": 2-D, at least ``min_size``
    elements}) of a tree of dicts and lists of tensors, quantized by
    ``quantize_linear_int8``; conv weights (more than 2-D), small
    projections and other leaves stay as they are."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.ndim == 2 and w.numel() >= min_size:
            return quantize_linear_int8(tree)
        return {k: quantize_tree_int8(v, min_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [quantize_tree_int8(v, min_size) for v in tree]
    return tree


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _col_major(b: torch.Tensor) -> torch.Tensor:
    """The same matrix stored column-major (a no-op if it is already)."""
    return b.t().contiguous().t()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N] by ``torch._int_mm``.
    On the card (cuBLASLt) it takes more than 16 rows and K, N multiples of
    8, and with a row-major ``b`` it refuses many shapes whose M is not a
    multiple of 32 (measured on an H100, torch 2.11); with a column-major
    ``b`` it took every shape tried.  So ``a`` goes row-major and ``b``
    column-major, both zero-padded to M >= 24 and M, K, N multiples of 8 —
    exact, since the padded rows and columns add zeros — and the result is
    cut back.  The same padding runs on every device."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), _col_major(b))[:m, :n]


def _int8_product(p, x: torch.Tensor) -> torch.Tensor:
    """(q(x) @ w_q8) * x_scale * w_scale with dynamic per-token activation
    scales ``amax/127`` (a zero amax taken as 1; as the compiled reference
    rounds it, ``_mul_inv127``), all in float32 as the reference computes
    it."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    xs = _mul_inv127(torch.where(amax == 0, 1.0, amax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)

    def mm(a, w):
        return int8_matmul(a.reshape(-1, a.shape[-1]), w).reshape(*a.shape[:-1], w.shape[1])

    return _product(xq, p["w_q8"], mm).float() * xs * p["w_scale"]


def apply_biasnorm(p, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """icefall Zipformer BiasNorm: x / rms(x - bias) * exp(log_scale)."""
    x32 = x.float()
    centered = x32 - p["bias"]
    rms = torch.sqrt(torch.mean(centered * centered, dim=-1, keepdim=True) + eps)
    return (x32 / rms * torch.exp(p["log_scale"])).to(x.dtype)


def apply_layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Float32 mean and (population) variance over the last axis, cast back
    to the input dtype."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def apply_batchnorm(p, x: torch.Tensor) -> torch.Tensor:
    """x * scale + bias with float32 scale/bias: a bf16 ``x`` promotes to
    float32, as in the reference."""
    return x * p["scale"] + p["bias"]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """icefall DoubleSwish: x * sigmoid(x - 1) (zipformer v1, LSTM)."""
    return x * torch.sigmoid(x - 1.0)


def glu(x: torch.Tensor) -> torch.Tensor:
    """First half of the last axis times the sigmoid of the second half."""
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


def _softplus(z: torch.Tensor) -> torch.Tensor:
    """logaddexp(0, z) in the reference's form: max(z, 0) + log1p(exp(-|z|))."""
    return torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL(x) = log(1 + exp(x-4)) - 0.08x - 0.035 (icefall zipformer2)."""
    return _softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR(x) = log(1 + exp(x-1)) - 0.08x - 0.313261687."""
    return _softplus(x - 1.0) - 0.08 * x - 0.313261687


def apply_conv1d(p, x: torch.Tensor, groups: int = 1, padding: str = "SAME",
                 compute_dtype=None) -> torch.Tensor:
    """x: [B, T, C_in] -> [B, T', C_out].  Weight layout [K, C_in/g, C_out].
    Depthwise (groups == C) and grouped convs alike; float32 accumulation
    over operands rounded to ``compute_dtype``."""
    y = conv1d_product(p["w"], x, groups, padding, compute_dtype)
    if "b" in p:
        y = y + p["b"]
    return _cast(y, compute_dtype)


def conv1d_product(w, x: torch.Tensor, groups: int = 1, padding: str = "SAME",
                   compute_dtype=None) -> torch.Tensor:
    """``apply_conv1d`` without its bias and its cast: the float32 output,
    [B, T', C_out] as PyTorch's convolution lays it out (a depthwise one's
    [B, C_out, T'] on the card, seen through a transpose)."""
    k = w.shape[0]
    xc = _cast(x, compute_dtype).float()
    wc = _cast(w, compute_dtype).float().permute(2, 1, 0)  # [C_out, C_in/g, K]
    if padding == "SAME":
        lo = (k - 1) // 2
        xc = F.pad(xc, (0, 0, lo, k - 1 - lo))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return _conv(F.conv1d, xc.transpose(1, 2), wc, compute_dtype,
                 groups=groups).transpose(1, 2)


def apply_conv2d(p, x: torch.Tensor, strides=(1, 1), padding=(0, 0), groups: int = 1,
                 compute_dtype=None, weight=None) -> torch.Tensor:
    """x: [B, H, W, C_in] (NHWC, as the reference) -> [B, H', W', C_out].
    Weight HWIO ``[kh, kw, C_in/g, C_out]`` (``weight`` overrides ``p["w"]``);
    ``padding`` is the symmetric (H, W) zero padding.  Covers the reference's
    ``apply_conv2d`` and its banded-matmul forms of the embed convs
    (``apply_conv2d_c1_banded``, ``apply_conv2d_banded_s2``), which compute
    this same 3x3 conv."""
    y = conv2d_product(p["w"] if weight is None else weight, x, strides, padding, groups,
                       compute_dtype)
    if "b" in p:
        y = y + p["b"]
    return _cast(y, compute_dtype)


def conv2d_product(w, x: torch.Tensor, strides=(1, 1), padding=(0, 0), groups: int = 1,
                   compute_dtype=None) -> torch.Tensor:
    """``apply_conv2d`` without its bias and its cast: the float32 output,
    [B, H', W', C_out] as a view of the convolution's NCHW tensor (channels
    last in memory where the convolution keeps its NHWC input's layout, as
    cuDNN does)."""
    xc = _cast(x, compute_dtype).float().permute(0, 3, 1, 2)  # NCHW view
    wc = _cast(w, compute_dtype).float().permute(3, 2, 0, 1)  # OIHW
    y = _conv(F.conv2d, xc, wc, compute_dtype, stride=tuple(strides), padding=tuple(padding),
              groups=groups)
    return y.permute(0, 2, 3, 1)


# The compute dtypes TF32 holds exactly: every value keeps its mantissa (10
# bits at most) and its exponent (float32's range) in TF32.
TF32_EXACT = (torch.bfloat16, torch.float16)
# The fewest output channels a group for which cuDNN's TF32 conv beats its
# FFMA one.  On an H100 80GB HBM3 (700 W, cuDNN through torch 2.11), device
# time: zipformer2's embed conv1 (1 -> 8 channels, 3x3, x [20, 1, 3072, 80])
# took 1.547 ms under TF32 against 0.381 on FFMA; every conv of 32 outputs
# or more at the benchmark's shapes ran faster under TF32, 1.97x (8 -> 32,
# 0.314 against 0.626 ms) to 11.2x (the conformer's conv2, 512 -> 512), and
# the conformer's conv1, 1 -> 512 over the same 9-long reduction as
# zipformer2's, 2.58x (1.187 against 3.062 ms): the output width decides,
# not the reduction's length.
TF32_MIN_OUT_CHANNELS = 32


def _conv(conv, xc: torch.Tensor, wc: torch.Tensor, compute_dtype, groups: int, **kw):
    """``conv(xc, wc, groups=groups, **kw)`` on operands rounded to
    ``compute_dtype``: through ``conv_tf32`` where that dtype is one TF32
    holds exactly and the product has ``TF32_MIN_OUT_CHANNELS`` outputs a
    group or more (``wc``'s dim 0 over ``groups``; a depthwise product has
    one); ``conv`` itself otherwise."""
    if compute_dtype in TF32_EXACT and wc.shape[0] // groups >= TF32_MIN_OUT_CHANNELS:
        return conv_tf32(conv, xc, wc, groups=groups, **kw)
    return conv(xc, wc, groups=groups, **kw)


def conv_tf32(conv, xc: torch.Tensor, wc: torch.Tensor, stride=1, padding=0,
              groups: int = 1) -> torch.Tensor:
    """``conv(xc, wc, stride=stride, padding=padding, groups=groups)`` with
    cuDNN's TF32 allowed in this one call, for float32 operands that TF32
    holds exactly (see the module docstring): float32 sums of exact products.

    On CUDA tensors it makes the call that ATen's convolution makes for such
    a product, ``aten::cudnn_convolution``, with ``allow_tf32`` passed in
    place of read from the process's flag: a conv1d as a 2-d conv of height 1
    over its input made contiguous, cuDNN's ``benchmark`` and
    ``deterministic`` as the process set them, and both operands laid out by
    cuDNN's call in the memory format ATen would choose.  No TF32 flag is
    read or written, so float32 work on another thread keeps its own
    precision.  A CUDA graph captured around the call keeps the TF32
    algorithm that its eager warm-up and the capture chose, and every replay
    runs it.  On CPU tensors ``conv`` itself: TF32 means nothing there.
    ``conv_tf32.launches`` counts the calls on CUDA tensors (a program adds
    its captured calls at each replay, ``runtime/program.py``)."""
    if not xc.is_cuda:
        return conv(xc, wc, stride=stride, padding=padding, groups=groups)
    n = xc.dim() - 2
    stride = (stride,) * n if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * n if isinstance(padding, int) else tuple(padding)
    dilation = (1,) * n
    if n == 1:  # ATen's view1d_as_2d
        xc, wc = xc.contiguous().unsqueeze(2), wc.unsqueeze(2)
        stride, padding, dilation = (1,) + stride, (0,) + padding, (1,) + dilation
    deterministic = (torch.backends.cudnn.deterministic
                     or torch.are_deterministic_algorithms_enabled())
    y = torch.ops.aten.cudnn_convolution(xc, wc, padding, stride, dilation, groups,
                                         torch.backends.cudnn.benchmark, deterministic, True)
    conv_tf32.launches += 1
    return y.squeeze(2) if n == 1 else y


conv_tf32.launches = 0


def apply_embedding(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def with_cache(cache: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """[cache | chunk] along time (dim 1), the cache cast to the chunk's
    dtype (a streaming layer's keys, values or conv context)."""
    return torch.cat([cache.to(chunk.dtype), chunk], dim=1)


def downsample_windows(x: torch.Tensor, ds: int, lens=None) -> torch.Tensor:
    """[B, T, D] -> [B, ceil(T/ds), ds, D] windows of ``ds`` frames, the
    tail window padded by repeating the last frame.  With ``lens``, frames
    at index >= lens are first replaced by each lane's LAST VALID frame, so
    a padded lane downsamples as it would unpadded (the reference's
    padding-invariant form of the zipformers' downsampling)."""
    b, t, d = x.shape
    t_out = -(-t // ds)
    if lens is not None:
        last = x[torch.arange(b, device=x.device), torch.clamp(lens - 1, min=0)][:, None, :]
        keep = torch.arange(t, device=x.device)[None, :, None] < lens[:, None, None]
        x = torch.where(keep, x, last)
    if t_out * ds > t:
        x = torch.cat([x, x[:, -1:].expand(b, t_out * ds - t, d)], dim=1)
    return x.reshape(b, t_out, ds, d)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True = valid)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]
