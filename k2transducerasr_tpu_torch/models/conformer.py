"""Conformer encoder, offline and streaming — PyTorch port of
``k2transducerasr_tpu/models/conformer.py`` (icefall
pruned_transducer_stateless conformer).

Conv2dSubsampling (two stride-2 VALID 3x3 convs -> T/4), the sqrt(d_model)
xscale, then N blocks of [0.5*FF, rel-pos MHSA, conv module (GLU +
depthwise), 0.5*FF, LayerNorm].  The structure and names follow the
reference function for function.  Differences of form, not of value:
  * attention takes one route: ``rel_pos_attention`` folds pos_bias_u/v and
    1/sqrt(dh) into the query operands in float32 before the one cast to the
    compute dtype, then calls ``ops.attention_cuda.relpos_attn_ctx`` (K2: the
    CUDA kernel on the card, its plain version on the CPU).  The reference's
    XLA branch exists only as a TPU switch and is not ported;
  * the parameters live in an ``nn.Module`` (``Conformer``) whose
    ``state_dict`` keys are the reference's dotted paths.

Streaming (``init_state``/``streaming_step``, causal configs) carries the
reference's state, batch-leading: each layer's post-ff1 input for the last
``left_context`` frames (``attn [B, L, lc, D]``), each conv module's last
``kernel-1`` frames (``conv [B, L, k-1, D]``), both float32, and an int64
``processed`` counter.  K2 then runs with T = chunk, S = lc + chunk and
per-lane ``kv_start`` gating.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.ops.attention import sinusoidal_rel_pos as _rel_pos_emb
from k2transducerasr_tpu_torch.ops.attention_cuda import relpos_attn_ctx
from k2transducerasr_tpu_torch.parallel.sharding import whole
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    feature_dim: int = 80
    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 8
    ff_dim: int = 2048
    cnn_kernel: int = 31
    # streaming-trained models: causal conv + bounded-left-context attention
    causal: bool = False
    chunk_size: int = 16  # frames after 4x subsampling
    left_context: int = 64  # attention left context, subsampled frames
    subsample_out: int | None = None  # frequency-linear in-dim override

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def subsampled_len(self, t: int) -> int:
        return ((t - 1) // 2 - 1) // 2

    @property
    def decode_chunk_len(self) -> int:
        """Raw feature frames consumed per streaming step."""
        return 4 * self.chunk_size

    @property
    def chunk_input_len(self) -> int:
        """Raw feature frames a streaming step reads: the subsampling stack's
        7-frame receptive field plus stride 4 over ``chunk_size`` outputs."""
        return 4 * self.chunk_size + 3


Config = ConformerConfig


def output_dim(cfg: ConformerConfig) -> int:
    return cfg.d_model


def output_chunk_len(cfg: ConformerConfig) -> int:
    """Encoder output frames per streaming step."""
    return cfg.chunk_size


# ---------------------------------------------------------------------------
# Random init (numpy-seeded; the JAX init's tree, shapes and scales)
# ---------------------------------------------------------------------------


def _init_ff(rng, d: int, ff: int) -> dict:
    return {"ln": L.init_layernorm(d), "w1": L.init_linear(rng, d, ff),
            "w2": L.init_linear(rng, ff, d)}


def _init_layer(rng, cfg: ConformerConfig) -> dict:
    d, ff = cfg.d_model, cfg.ff_dim
    return {
        "ff1": _init_ff(rng, d, ff),
        "attn": {
            "ln": L.init_layernorm(d),
            "q": L.init_linear(rng, d, d),
            "k": L.init_linear(rng, d, d),
            "v": L.init_linear(rng, d, d),
            "pos": L.init_linear(rng, d, d, bias=False),
            "out": L.init_linear(rng, d, d),
            "u": np.zeros((cfg.num_heads, cfg.head_dim), np.float32),
            "v_bias": np.zeros((cfg.num_heads, cfg.head_dim), np.float32),
        },
        "conv": {
            "ln": L.init_layernorm(d),
            "pw1": L.init_conv1d(rng, d, 2 * d, kernel=1),
            "dw": L.init_conv1d(rng, d, d, kernel=cfg.cnn_kernel, groups=d),
            "bn": L.init_batchnorm(d),
            "pw2": L.init_conv1d(rng, d, d, kernel=1),
        },
        "ff2": _init_ff(rng, d, ff),
        "norm_final": L.init_layernorm(d),
    }


def init_params(rng: np.random.Generator, cfg: ConformerConfig) -> dict:
    """numpy tree with the reference ``init_params``' structure, shapes and
    uniform(+-1/sqrt(fan_in)) scales (other values: another generator)."""
    freq_out = ((cfg.feature_dim - 1) // 2 - 1) // 2
    sub = {
        "conv1": L.init_conv2d(rng, 1, cfg.d_model, (3, 3)),
        "conv2": L.init_conv2d(rng, cfg.d_model, cfg.d_model, (3, 3)),
        "out": L.init_linear(rng, cfg.d_model * freq_out, cfg.d_model),
    }
    return {"subsample": sub, "layers": [_init_layer(rng, cfg) for _ in range(cfg.num_layers)]}


# ---------------------------------------------------------------------------
# Subsampling and positions
# ---------------------------------------------------------------------------


def subsample(p, cfg: ConformerConfig, x, compute_dtype=None):
    """x: [B, T, F] -> [B, T', d_model], T' = ((T-1)//2 - 1)//2."""
    h = torch.relu(L.apply_conv2d(p["conv1"], x[..., None], strides=(2, 2),
                                  compute_dtype=compute_dtype))
    h = torch.relu(L.apply_conv2d(p["conv2"], h, strides=(2, 2), compute_dtype=compute_dtype))
    b, t, f, c = h.shape
    # icefall Conv2dSubsampling flattens (C, F') with F' fastest
    h = h.transpose(2, 3).reshape(b, t, c * f)
    return L.apply_linear(p["out"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Conformer block
# ---------------------------------------------------------------------------


def rel_pos_attention(p, cfg: ConformerConfig, x_q, x_kv, compute_dtype=None, pad_lens=None,
                      chunk_left=None, kv_start=None):
    """Transformer-XL attention with the queries as the LAST t_q positions of
    the kv sequence.  x_q: [B, T, D]; x_kv: [B, S, D] -> [B, T, D].

    (q+u)·k + skew((q+v)·p), scaled by 1/sqrt(dh), maps onto K2's
    q·k + skew(pos_q·pos_k) by folding u/v_bias and the scale into the query
    operands in float32 before the one cast to the compute dtype.  Masks are
    the specs ``pad_lens`` (valid keys), ``chunk_left`` (static (chunk,
    left) pattern) and ``kv_start`` (streaming gating); K2 masks keys only,
    and the caller zeroes invalid query rows."""
    h, dh = cfg.num_heads, cfg.head_dim
    b, t, d = x_q.shape
    s = x_kv.shape[1]
    q = L.apply_linear(p["q"], x_q, compute_dtype).reshape(b, t, h, dh)
    k = L.apply_linear(p["k"], x_kv, compute_dtype).reshape(b, s, h, dh)
    v = L.apply_linear(p["v"], x_kv, compute_dtype).reshape(b, s, h, dh)
    pe = _rel_pos_emb(t, s, d, x_q.device)
    pos = L.apply_linear(p["pos"], pe, compute_dtype).reshape(-1, h, dh)  # [R, H, dh]
    scale = 1.0 / math.sqrt(dh)
    qs = ((q + whole(p["u"])).float() * scale).to(k.dtype)
    ps = ((q + whole(p["v_bias"])).float() * scale).to(pos.dtype)
    ch, lf = chunk_left if chunk_left is not None else (0, 0)
    ctx = relpos_attn_ctx(qs, k, ps, pos, v, pad_lens, chunk=ch, left=lf, kv_start=kv_start)
    return L.apply_linear(p["out"], ctx.reshape(b, t, h * dh), compute_dtype)


def _ff(p, x, compute_dtype):
    h = L.apply_layernorm(p["ln"], x)
    h = L.swish(L.apply_linear(p["w1"], h, compute_dtype))
    return L.apply_linear(p["w2"], h, compute_dtype)


def _conv_module(p, cfg: ConformerConfig, x, compute_dtype, conv_cache=None, valid=None):
    """x: [B, T, D].  conv_cache: [B, kernel-1, D] left context (causal) or
    None (SAME padding when non-causal, a zero left cache when causal).
    ``valid``: [B, T] bool — padded positions are zeroed before the
    depthwise conv so they cannot bleed into valid frames.
    Returns (out, new_cache)."""
    h = L.apply_layernorm(p["ln"], x)
    h = L.glu(L.apply_conv1d(p["pw1"], h, padding="SAME", compute_dtype=compute_dtype))
    if valid is not None:
        h = torch.where(valid[:, :, None], h, 0.0)
    k = cfg.cnn_kernel
    if cfg.causal:
        if conv_cache is None:
            cache = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=h.dtype, device=h.device)
        else:
            cache = conv_cache.to(h.dtype)
        hc = torch.cat([cache, h], dim=1)
        new_cache = hc[:, -(k - 1):, :]
        h = L.apply_conv1d(p["dw"], hc, groups=cfg.d_model, padding="VALID",
                           compute_dtype=compute_dtype)
    else:
        new_cache = None
        h = L.apply_conv1d(p["dw"], h, groups=cfg.d_model, padding="SAME",
                           compute_dtype=compute_dtype)
    h = L.swish(L.apply_batchnorm(p["bn"], h))  # float32: the bn params promote
    h = L.apply_conv1d(p["pw2"], h, padding="SAME", compute_dtype=compute_dtype)
    return h, new_cache


def _block(p, cfg: ConformerConfig, x, compute_dtype, valid=None, pad_lens=None,
           chunk_left=None, conv_cache=None, attn_cache=None, kv_start=None):
    """One conformer layer.  Offline the attention's kv is the query
    sequence; streaming, ``attn_cache`` [B, lc, D] holds the previous
    frames' post-ff1 inputs and kv is the layernorm of ``[attn_cache |
    x_ff]``, gated per lane by ``kv_start``.
    Returns (out, new_conv_cache, new_attn_cache); the caches are None
    where none was given."""
    x = x + 0.5 * _ff(p["ff1"], x, compute_dtype)
    attn_in = L.apply_layernorm(p["attn"]["ln"], x)
    kv_in, new_attn = attn_in, None
    if attn_cache is not None:
        kv = torch.cat([attn_cache.to(x.dtype), x], dim=1)
        kv_in, new_attn = L.apply_layernorm(p["attn"]["ln"], kv), kv[:, -attn_cache.shape[1]:]
    x = x + rel_pos_attention(p["attn"], cfg, attn_in, kv_in, compute_dtype,
                              pad_lens=pad_lens, chunk_left=chunk_left, kv_start=kv_start)
    h, new_conv = _conv_module(p["conv"], cfg, x, compute_dtype, conv_cache, valid)
    x = x + h
    x = x + 0.5 * _ff(p["ff2"], x, compute_dtype)
    return L.apply_layernorm(p["norm_final"], x), new_conv, new_attn


def forward(params, cfg: ConformerConfig, x, x_lens, compute_dtype=None):
    """x: [B, T, F]; x_lens: [B] -> (enc_out [B, T', D], out_lens [B])."""
    h = subsample(params["subsample"], cfg, x, compute_dtype)
    # espnet RelPositionalEncoding scales the embedding by sqrt(d_model)
    h = h * math.sqrt(cfg.d_model)
    out_lens = ((x_lens - 1) // 2 - 1) // 2
    valid = L.length_mask(out_lens, h.shape[1])  # [B, T']
    pad_lens = torch.clamp(out_lens, min=0).to(torch.int32)
    chunk_left = (cfg.chunk_size, cfg.left_context) if cfg.causal else None
    for layer in params["layers"]:
        h, _, _ = _block(layer, cfg, h, compute_dtype, valid=valid, pad_lens=pad_lens,
                         chunk_left=chunk_left)
        h = torch.where(valid[:, :, None], h, 0.0)
    return h, out_lens


def init_state(cfg: ConformerConfig, batch: int, device="cpu") -> dict:
    """Zero streaming state, batch-leading (the reference's tree and
    shapes): ``attn [B, L, lc, D]`` and ``conv [B, L, k-1, D]`` float32,
    ``processed`` int64 subsampled frames."""
    lc, k, d, n = cfg.left_context, cfg.cnn_kernel, cfg.d_model, cfg.num_layers
    return {
        "attn": torch.zeros((batch, n, lc, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, n, k - 1, d), dtype=torch.float32, device=device),
        "processed": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def streaming_step(params, cfg: ConformerConfig, state: dict, x_chunk, compute_dtype=None):
    """One chunk step.  x_chunk: [B, chunk_input_len, F] raw features ->
    (enc_out [B, chunk_size, D], new_state).  Cache slot j of a lane is
    valid once it holds a real frame: ``kv_start = lc - min(processed, lc)``."""
    lc = cfg.left_context
    h = subsample(params["subsample"], cfg, x_chunk, compute_dtype) * math.sqrt(cfg.d_model)
    processed = state["processed"]
    kv_start = (lc - torch.clamp(processed, max=lc)).to(torch.int32)
    new_attn, new_conv = [], []
    for i, layer in enumerate(params["layers"]):
        h, conv_cache, attn_cache = _block(layer, cfg, h, compute_dtype,
                                           conv_cache=state["conv"][:, i],
                                           attn_cache=state["attn"][:, i], kv_start=kv_start)
        new_attn.append(attn_cache.float())
        new_conv.append(conv_cache.float())
    new_state = {
        "attn": torch.stack(new_attn, dim=1),
        "conv": torch.stack(new_conv, dim=1),
        "processed": processed + cfg.chunk_size,
    }
    return h, new_state


class Conformer(ParamTree):
    """The encoder's parameters as an ``nn.Module`` (``state_dict`` keys are
    the reference's dotted paths) with the offline forward and the
    streaming step."""

    def __init__(self, cfg: ConformerConfig, tree: dict, device="cpu"):
        super().__init__(tree, device)
        self.cfg = cfg

    def forward(self, x, x_lens, compute_dtype=None):
        return forward(self, self.cfg, x, x_lens, compute_dtype)

    def init_state(self, batch: int) -> dict:
        return init_state(self.cfg, batch, self.subsample["conv1"]["w"].device)

    def streaming_step(self, state: dict, x_chunk, compute_dtype=None):
        return streaming_step(self, self.cfg, state, x_chunk, compute_dtype)


Encoder = Conformer
