"""Zipformer2 encoder, offline and streaming — PyTorch port of
``k2transducerasr_tpu/models/zipformer2.py`` (icefall "zipformer" 2023).

The structure and names follow the reference function for function; see its
module docstring for the architecture.  Differences of form, not of value:
  * attention always takes the shared-probs route: ``_attn_shared`` calls
    ``ops.attention_cuda.relpos_attn_probs`` once per layer (the CUDA kernel
    on the card, its plain version on the CPU) and the three consumers
    (self_attn1, self_attn2, the nonlin-attention gate) read those probs;
  * the embed convs are plain 3x3 conv2d (the reference's banded-matmul
    forms compute the same conv), and the ConvNeXt depthwise conv uses the
    diagonal of its dense ``[7, 7, C, C]`` weight at call time;
  * the parameters live in an ``nn.Module`` (``Zipformer2``) whose
    ``state_dict`` keys are the reference's dotted paths;
  * every Swoosh (the feed-forwards' and the ConvNeXt's SwooshL, the embed
    convs' and the conv modules' SwooshR) is one ``bias_swoosh`` call
    (``ops/activations_cuda.py``: a kernel on the card) that adds the bias of
    the product or convolution before it, in float32, and rounds once to the
    compute dtype (float32 under ``compute_dtype=None``).  So those products
    and convolutions run without their bias (``L.linear_product``,
    ``L.conv1d_product``, ``L.conv2d_product``), and under bf16 the sum of
    product and bias is rounded once, after the Swoosh.  int8
    and model-sharded weights hand the kernel their float32 product; the
    causal conv modules their float32 sum of the two convolutions, whose
    biases it holds.

Streaming (``init_state``/``streaming_step``, causal configs) carries the
reference's cache inventory in its batch-leading layout: per layer
key/val1/val2/nonlin ``[B, left_i, ...]`` and conv1/conv2 ``[B, k//2, D]``,
the embed stage cache ``[B, 3, F', c3]`` and an int64 ``processed`` counter.
Each layer's K1 call then has T != S (the chunk's queries against
``[cache | chunk]`` keys) and per-lane ``kv_start`` gating.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.ops.activations_cuda import bias_swoosh
from k2transducerasr_tpu_torch.ops.attention import descending_rel_positions
from k2transducerasr_tpu_torch.ops.attention_cuda import relpos_attn_probs
from k2transducerasr_tpu_torch.parallel.sharding import whole
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class Zipformer2Config:
    feature_dim: int = 80
    num_encoder_layers: tuple = (2, 2, 3, 4, 3, 2)
    encoder_dims: tuple = (192, 256, 384, 512, 384, 256)
    downsampling_factors: tuple = (1, 2, 4, 8, 4, 2)
    num_heads: tuple = (4, 4, 4, 8, 4, 4)
    feedforward_dims: tuple = (512, 768, 1024, 1536, 1024, 768)
    cnn_module_kernels: tuple = (31, 31, 15, 15, 15, 31)
    query_head_dim: int = 32
    value_head_dim: int = 12
    pos_head_dim: int = 4
    pos_dim: int = 48
    # embed conv channels
    embed_channels: tuple = (8, 32, 128)
    causal: bool = False
    chunk_size: int = 32  # encoder-rate (post-embed) frames per step
    left_context_frames: int = 128  # encoder-rate frames of attention memory

    def __post_init__(self):
        # config.json stores tuples as JSON lists
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                object.__setattr__(self, f.name, tuple(v))

    @property
    def num_stacks(self) -> int:
        return len(self.encoder_dims)

    @property
    def output_downsampling_factor(self) -> int:
        return 2

    @property
    def encoder_out_dim(self) -> int:
        return max(self.encoder_dims)

    def embed_len(self, t_raw: int) -> int:
        """Raw frames -> encoder-rate frames through the embed conv stack
        (receptive field 9, stride 2)."""
        return (t_raw - 7) // 2

    @property
    def decode_chunk_len(self) -> int:
        """Raw feature frames a streaming window advances by."""
        return 2 * self.chunk_size

    @property
    def embed_cache_len(self) -> int:
        """Stage frames cached across streaming windows: the ConvNeXt
        half-kernel (icefall's ``embed_states``)."""
        return 3

    @property
    def embed_freq_out(self) -> int:
        """Frequency width after the conv stack (80 -> 39 -> 19)."""
        f2 = (self.feature_dim - 3) // 2 + 1
        return (f2 - 3) // 2 + 1

    @property
    def chunk_input_len(self) -> int:
        """Raw feature frames per streaming window: 2*chunk + 13, the conv
        stack's receptive field plus the ConvNeXt's 3-stage-frame lookahead."""
        return 2 * self.chunk_size + 13

    def stack_chunk(self, i: int) -> int:
        return self.chunk_size // self.downsampling_factors[i]

    def stack_left(self, i: int) -> int:
        return max(1, self.left_context_frames // self.downsampling_factors[i])


Config = Zipformer2Config


def output_dim(cfg: Zipformer2Config) -> int:
    return cfg.encoder_out_dim


def output_chunk_len(cfg: Zipformer2Config) -> int:
    """Output frames per streaming step (after the final /2 downsample)."""
    return cfg.chunk_size // cfg.output_downsampling_factor


# ---------------------------------------------------------------------------
# Random init (numpy-seeded; the JAX init's shapes and scales)
# ---------------------------------------------------------------------------


def _init_embed(rng, cfg: Zipformer2Config) -> dict:
    c1, c2, c3 = cfg.embed_channels
    return {
        "conv1": L.init_conv2d(rng, 1, c1, (3, 3)),
        "conv2": L.init_conv2d(rng, c1, c2, (3, 3)),
        "conv3": L.init_conv2d(rng, c2, c3, (3, 3)),
        "convnext_dw": L.init_conv2d(rng, c3, c3, (7, 7)),  # dense; diagonal used
        "convnext_pw1": L.init_linear(rng, c3, 3 * c3),
        "convnext_pw2": L.init_linear(rng, 3 * c3, c3),
        "out": L.init_linear(rng, c3 * cfg.embed_freq_out, cfg.encoder_dims[0]),
        "out_norm": L.init_biasnorm(cfg.encoder_dims[0]),
    }


def _init_conv_mod(rng, dim: int, kernel: int, causal: bool) -> dict:
    p = {"in_proj": L.init_linear(rng, dim, 2 * dim), "out": L.init_linear(rng, dim, dim)}
    if causal:
        p["causal_dw"] = L.init_conv1d(rng, dim, dim, kernel // 2 + 1, groups=dim)
        p["chunk_dw"] = L.init_conv1d(rng, dim, dim, kernel, groups=dim)
        p["chunk_scale"] = np.zeros((2, kernel, dim), np.float32)
    else:
        p["dw"] = L.init_conv1d(rng, dim, dim, kernel, groups=dim)
    return p


def _init_layer(rng, cfg: Zipformer2Config, si: int) -> dict:
    dim, heads = cfg.encoder_dims[si], cfg.num_heads[si]
    ff, kernel = cfg.feedforward_dims[si], cfg.cnn_module_kernels[si]
    qd, pd, vd = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim
    hidden = 3 * dim // 4
    return {
        "attn_weights": {
            "in_proj": L.init_linear(rng, dim, heads * (2 * qd + pd)),
            "pos_proj": L.init_linear(rng, cfg.pos_dim, heads * pd, bias=False),
        },
        "self_attn1": {"v": L.init_linear(rng, dim, heads * vd),
                       "out": L.init_linear(rng, heads * vd, dim)},
        "self_attn2": {"v": L.init_linear(rng, dim, heads * vd),
                       "out": L.init_linear(rng, heads * vd, dim)},
        "nonlin_attn": {"in_proj": L.init_linear(rng, dim, 3 * hidden),
                        "out": L.init_linear(rng, hidden, dim)},
        "conv1": _init_conv_mod(rng, dim, kernel, cfg.causal),
        "conv2": _init_conv_mod(rng, dim, kernel, cfg.causal),
        "ff1": {"w1": L.init_linear(rng, dim, ff), "w2": L.init_linear(rng, ff, dim)},
        "ff2": {"w1": L.init_linear(rng, dim, ff), "w2": L.init_linear(rng, ff, dim)},
        "ff3": {"w1": L.init_linear(rng, dim, ff), "w2": L.init_linear(rng, ff, dim)},
        "norm": L.init_biasnorm(dim),
        "bypass": np.full((dim,), 0.5, np.float32),
        "bypass_mid": np.full((dim,), 0.5, np.float32),
    }


def init_params(rng: np.random.Generator, cfg: Zipformer2Config) -> dict:
    """numpy tree with the reference ``init_params``' structure, shapes and
    uniform(+-1/sqrt(fan_in)) scales.  The values differ from the JAX
    init's (another generator); it lets the card build any config without
    JAX."""
    stacks = []
    for si in range(cfg.num_stacks):
        p = {"layers": [_init_layer(rng, cfg, si) for _ in range(cfg.num_encoder_layers[si])]}
        ds = cfg.downsampling_factors[si]
        if ds > 1:
            p["downsample_weights"] = np.zeros((ds,), np.float32)
            p["bypass_out"] = np.full((cfg.encoder_dims[si],), 0.5, np.float32)
        stacks.append(p)
    return {
        "embed": _init_embed(rng, cfg),
        "stacks": stacks,
        "downsample_output_weights": np.zeros((cfg.output_downsampling_factor,), np.float32),
    }


# ---------------------------------------------------------------------------
# Embed (Conv2dSubsampling + ConvNeXt)
# ---------------------------------------------------------------------------


def _bias(p):
    return p["b"] if "b" in p else None


def _swoosh_dtype(compute_dtype):
    return compute_dtype or torch.float32


def _linear_swoosh(p, x, kind: str, compute_dtype):
    """Swoosh ``kind`` of the linear ``p`` (its bias added by the kernel)."""
    return bias_swoosh(L.linear_product(p, x, compute_dtype), _bias(p), kind,
                       _swoosh_dtype(compute_dtype))


def _conv2d_swoosh_r(p, x, compute_dtype, **conv):
    """SwooshR of the 3x3 conv ``p`` (its bias added by the kernel)."""
    y = L.conv2d_product(p["w"], x, compute_dtype=compute_dtype, **conv)
    return bias_swoosh(y, _bias(p), "r", _swoosh_dtype(compute_dtype))


def _embed_conv_stack(p, x, compute_dtype=None):
    """Conv 3-stack: x [B, T, F] -> stage tensor [B, (T-7)//2, F', c3]
    (conv1: freq pad 1, time VALID; conv2: stride 2 VALID; conv3: stride
    (1, 2) VALID; SwooshR after each)."""
    h = _conv2d_swoosh_r(p["conv1"], x[..., None], compute_dtype, padding=(0, 1))
    h = _conv2d_swoosh_r(p["conv2"], h, compute_dtype, strides=(2, 2))
    return _conv2d_swoosh_r(p["conv3"], h, compute_dtype, strides=(1, 2))


def _embed_tail(p, h, compute_dtype=None):
    """ConvNeXt (time-VALID over a pre-extended stage tensor) + out linear +
    BiasNorm.  h: [B, T0+6, F', c3] -> [B, T0, dims[0]].  The flatten
    before ``out`` is channel-major [C, F]."""
    residual = h[:, 3:-3]
    hh = F.pad(h, (0, 0, 3, 3))  # freq SAME
    w = p["convnext_dw"]["w"]  # [7, 7, c3, c3] — applied depthwise (diagonal)
    dw_w = torch.diagonal(w, dim1=2, dim2=3)[:, :, None, :]  # HWIO [7, 7, 1, C]
    dw = L.apply_conv2d(p["convnext_dw"], hh, groups=hh.shape[-1], compute_dtype=compute_dtype,
                        weight=dw_w)
    hh = _linear_swoosh(p["convnext_pw1"], dw, "l", compute_dtype)
    hh = L.apply_linear(p["convnext_pw2"], hh, compute_dtype)
    h = residual + hh
    b, t0, f, c = h.shape
    h = h.transpose(2, 3).reshape(b, t0, c * f)
    h = L.apply_linear(p["out"], h, compute_dtype)
    return L.apply_biasnorm(p["out_norm"], h)


def _embed_forward(p, x, compute_dtype=None, x_lens=None):
    """Offline embed: x [B, T, F] -> [B, (T-7)//2, dims[0]] (ConvNeXt SAME
    in time via 3 zero stage frames each side)."""
    h = _embed_conv_stack(p, x, compute_dtype)
    if x_lens is not None:
        # zero stage frames derived from padding so they cannot bleed into
        # valid frames through the ConvNeXt receptive field
        stage_valid = torch.clamp((x_lens - 7) // 2, min=0)
        mask = L.length_mask(stage_valid, h.shape[1])
        h = torch.where(mask[:, :, None, None], h, 0.0)
    h = F.pad(h, (0, 0, 0, 0, 3, 3))
    return _embed_tail(p, h, compute_dtype)


# ---------------------------------------------------------------------------
# Compact relative positional encoding
# ---------------------------------------------------------------------------


def _compact_rel_pos(t_q: int, s_kv: int, pos_dim: int, device=None,
                     length_factor: float = 1.0) -> torch.Tensor:
    """[R, pos_dim] compact relative positional embedding (icefall's
    CompactRelPositionalEncoding), rows in DESCENDING relative position —
    row for row the reference's ``_compact_rel_pos``."""
    p = -descending_rel_positions(t_q, s_kv, device)  # ascending -(s_kv-1)..(t_q-1)
    comp = math.sqrt(pos_dim)
    x_compressed = comp * torch.sign(p) * (torch.log(torch.abs(p) + comp) - math.log(comp))
    length_scale = length_factor * pos_dim / (2.0 * math.pi)
    x_atan = torch.atan(x_compressed / length_scale)
    freqs = 1.0 + torch.arange(pos_dim // 2, dtype=torch.float32, device=device)
    ang = x_atan[:, None] * freqs[None, :]
    pe = torch.stack([torch.cos(ang), torch.sin(ang)], dim=2).reshape(-1, pos_dim)
    pe[:, -1] = 1.0
    return pe


# ---------------------------------------------------------------------------
# Layer sub-modules
# ---------------------------------------------------------------------------


def _apply_ff(p, x, compute_dtype):
    return L.apply_linear(p["w2"], _linear_swoosh(p["w1"], x, "l", compute_dtype), compute_dtype)


def _attn_shared(p, cfg: Zipformer2Config, si: int, x_q, compute_dtype,
                 pad_lens=None, chunk_left=None, k_src=None, kv_start=None):
    """Project q/pos (and, offline, k) from the layer input and compute the
    attention probs [B, H, T, S] once; self_attn1, self_attn2 and the
    nonlin-attention gate share them.  ``k_src``: [B, S, H*qd] keys already
    projected (streaming: ``[cache | chunk]``), or None to take them from
    this in_proj.  Masks: ``pad_lens`` valid key counts per lane
    (non-causal), ``chunk_left`` the static (chunk, left) pattern (offline
    causal), ``kv_start`` the first valid key per lane (streaming)."""
    heads, qd, pd = cfg.num_heads[si], cfg.query_head_dim, cfg.pos_head_dim
    b, t, _ = x_q.shape
    # in_proj column layout is flat [q (H*qd) | k (H*qd) | pos (H*pd)]
    proj = L.apply_linear(p["in_proj"], x_q, compute_dtype)
    q = proj[..., : heads * qd].reshape(b, t, heads, qd)
    if k_src is None:
        k_src = proj[..., heads * qd : 2 * heads * qd]
    s = k_src.shape[1]
    k = k_src.reshape(b, s, heads, qd)
    pos_q = proj[..., 2 * heads * qd :].reshape(b, t, heads, pd)
    pe = _compact_rel_pos(t, s, cfg.pos_dim, x_q.device)
    pos_k = L.apply_linear(p["pos_proj"], pe, compute_dtype).reshape(-1, heads, pd)
    ch, lf = chunk_left if chunk_left is not None else (0, 0)
    # all four are in the compute dtype; the kernel takes contiguous inputs
    return relpos_attn_probs(q.contiguous(), k.contiguous(), pos_q.contiguous(),
                             pos_k.contiguous(), pad_lens, chunk=ch, left=lf, kv_start=kv_start)


def _project_keys(p, cfg: Zipformer2Config, si: int, x, compute_dtype):
    """The key third of ``in_proj`` alone (streaming: the chunk's keys,
    which join the key cache); a model-sharded ``in_proj`` is gathered
    whole first."""
    heads, qd = cfg.num_heads[si], cfg.query_head_dim
    sl = slice(heads * qd, 2 * heads * qd)
    if "w_q8" in p["in_proj"]:  # int8: the key columns and their scales
        sub = {"w_q8": whole(p["in_proj"]["w_q8"])[:, sl], "w_scale": p["in_proj"]["w_scale"][sl]}
    else:
        sub = {"w": whole(p["in_proj"]["w"])[:, sl]}
    if "b" in p["in_proj"]:
        sub["b"] = p["in_proj"]["b"][sl]
    return L.apply_linear(sub, x, compute_dtype)


def _attn_apply(probs, v):
    """probs @ v for all heads.  v: [B, S, H, vd] -> ctx [B, T, H, vd]
    (float32; the product runs in v's dtype)."""
    ctx = torch.matmul(probs.to(v.dtype), v.permute(0, 2, 1, 3))  # [B, H, T, vd]
    return ctx.permute(0, 2, 1, 3).float()


def _attn_apply_head0(probs, v):
    """Head-0 probs @ v (the nonlin-attention gate).  v: [B, S, hidden] ->
    [B, T, hidden] (float32)."""
    return torch.matmul(probs[:, 0].to(v.dtype), v).float()


def _self_attn(p, cfg, si, v_src, probs, compute_dtype):
    """v_src: [B, S, H*vd] pre-projected values."""
    heads, vd = cfg.num_heads[si], cfg.value_head_dim
    b, s, _ = v_src.shape
    ctx = _attn_apply(probs, v_src.reshape(b, s, heads, vd))
    t = ctx.shape[1]
    return L.apply_linear(p["out"], ctx.reshape(b, t, heads * vd), compute_dtype)


def _nonlin_attention(p, dim, x, probs, compute_dtype, v_cached=None):
    """Attention-gated nonlinearity.  x: [B, T, D] (the target side);
    v_cached: [B, S-T, hidden] cached source values (streaming) or None.
    Returns (out [B, T, D], v_chunk [B, T, hidden], the chunk's gated
    source values)."""
    hidden = 3 * dim // 4
    proj = L.apply_linear(p["in_proj"], x, compute_dtype)
    s_gate, xv, y = torch.split(proj, [hidden, hidden, proj.shape[-1] - 2 * hidden], dim=-1)
    v_chunk = xv * torch.tanh(s_gate)
    v_src = v_chunk if v_cached is None else L.with_cache(v_cached, v_chunk)
    attended = _attn_apply_head0(probs, v_src)
    return L.apply_linear(p["out"], attended * y, compute_dtype), v_chunk


def _chunkwise_scale(scale, chunk: int):
    """scale [2, k, D] -> [chunk, D]: 1 + left-edge + right-edge corrections
    (icefall ChunkCausalDepthwiseConv1d._get_chunk_scale)."""
    left, right = scale[0], scale[1]
    k, d = left.shape
    if chunk < k:
        l_e, r_e = left[:chunk], right[k - chunk :]
    else:
        pad = torch.zeros((chunk - k, d), dtype=left.dtype, device=left.device)
        l_e = torch.cat([left, pad], dim=0)
        r_e = torch.cat([pad, right], dim=0)
    return 1.0 + l_e + r_e


def _conv_module(p, dim, kernel, x, chunk, compute_dtype, valid=None, cache=None):
    """zipformer2 ConvolutionModule (in_proj -> value*sigmoid(gate) ->
    depthwise -> SwooshR -> out_proj).  chunk == 0: SAME depthwise conv with
    padded positions zeroed first (``valid``).  chunk > 0: icefall's
    ChunkCausalDepthwiseConv1d over a left context — zeros offline (cache
    None), the ``cache`` [B, k//2, D] streaming — with T split into chunks.
    Returns (out [B, T, D], the next cache or None): the tail of
    ``[cache | h]``, not of ``h`` alone, since a deep stack's chunk (4
    frames at stride 8) can be shorter than the half-kernel."""
    half = kernel // 2
    h = L.apply_linear(p["in_proj"], x, compute_dtype)
    a, g = torch.chunk(h, 2, dim=-1)
    h = a * torch.sigmoid(g)
    if valid is not None:
        h = torch.where(valid[:, :, None], h, 0.0)
    new_cache = None
    if chunk == 0:
        y = L.conv1d_product(p["dw"]["w"], h, groups=dim, padding="SAME",
                             compute_dtype=compute_dtype)
        bias = _bias(p["dw"])
    else:
        b, t, d = h.shape
        if cache is None:
            hc = torch.cat([torch.zeros((b, half, d), dtype=h.dtype, device=h.device), h], dim=1)
        else:
            hc = L.with_cache(cache, h)
            new_cache = hc[:, -half:]
        y_causal = L.apply_conv1d(
            p["causal_dw"], hc, groups=dim, padding="VALID", compute_dtype=compute_dtype,
        )  # [B, T, D]
        n = t // chunk
        win = F.pad(h.reshape(b * n, chunk, d), (0, 0, half, half))
        y_chunk = L.apply_conv1d(
            p["chunk_dw"], win, groups=dim, padding="VALID", compute_dtype=compute_dtype
        ).reshape(b, n, chunk, d)
        y_chunk = y_chunk * _chunkwise_scale(p["chunk_scale"], chunk)[None, None]
        y = y_causal + y_chunk.reshape(b, t, d)
        bias = None  # each convolution's bias is in the sum
    y = bias_swoosh(y, bias, "r", _swoosh_dtype(compute_dtype))
    return L.apply_linear(p["out"], y, compute_dtype), new_cache


# ---------------------------------------------------------------------------
# Bypass / downsample / channel stitch
# ---------------------------------------------------------------------------


def _bypass(scale, x_orig, x):
    return x_orig + scale * (x - x_orig)


def _simple_downsample(weights, x, ds: int, lens=None):
    """[B, T, D] -> [B, ceil(T/ds), D]: learned softmax weights over each
    window of ``L.downsample_windows`` (the tail repeats the last frame;
    with ``lens``, each lane's LAST VALID frame fills its padding: the
    reference's padding-invariant form, not icefall's)."""
    xw = L.downsample_windows(x, ds, lens)
    w = torch.softmax(weights, dim=0).to(x.dtype).float()
    return (xw.float() * w[None, None, :, None]).sum(dim=2).to(x.dtype)


def _simple_upsample(x, ds: int, t_target: int):
    return torch.repeat_interleave(x, ds, dim=1)[:, :t_target]


def _convert_channels(x, dim: int):
    cur = x.shape[-1]
    if cur == dim:
        return x
    if cur > dim:
        return x[..., :dim]
    return F.pad(x, (0, dim - cur))


# ---------------------------------------------------------------------------
# Layer / stack / forward
# ---------------------------------------------------------------------------


def _layer_forward(p, cfg: Zipformer2Config, si: int, x, chunk: int, compute_dtype,
                   valid=None, pad_lens=None, chunk_left=None, caches=None, kv_start=None):
    """One Zipformer2 layer.  ``chunk``: conv chunk size (0 = non-causal);
    op order ff1, nonlin_attn, attn1, conv1, ff2, bypass_mid, attn2, conv2,
    ff3, BiasNorm, bypass.

    ``caches``: None offline, or (streaming) the layer's dict key/val1/val2/
    nonlin ``[B, left, ...]`` and conv1/conv2 ``[B, k//2, D]``; keys and
    values then run over ``[cache | chunk]`` with ``kv_start`` gating the
    cache slots that hold no history yet.  Returns (out, new caches or
    None); each new cache holds the same stage tensor the offline pass
    computes at that position."""
    dim = cfg.encoder_dims[si]
    kernel = cfg.cnn_module_kernels[si]
    x_orig = x
    streaming = caches is not None
    caches = caches or {}
    k_src = None
    if streaming:
        k_src = L.with_cache(caches["key"], _project_keys(p["attn_weights"], cfg, si, x,
                                                          compute_dtype))
    probs = _attn_shared(p["attn_weights"], cfg, si, x, compute_dtype, pad_lens=pad_lens,
                         chunk_left=chunk_left, k_src=k_src, kv_start=kv_start)
    x = x + _apply_ff(p["ff1"], x, compute_dtype)
    na, nonlin_chunk = _nonlin_attention(p["nonlin_attn"], dim, x, probs, compute_dtype,
                                         caches.get("nonlin"))
    x = x + na
    v1 = L.apply_linear(p["self_attn1"]["v"], x, compute_dtype)
    v1_src = L.with_cache(caches["val1"], v1) if streaming else v1
    x = x + _self_attn(p["self_attn1"], cfg, si, v1_src, probs, compute_dtype)
    c1, new_conv1 = _conv_module(p["conv1"], dim, kernel, x, chunk, compute_dtype, valid,
                                 caches.get("conv1"))
    x = x + c1
    x = x + _apply_ff(p["ff2"], x, compute_dtype)
    x = _bypass(p["bypass_mid"], x_orig, x)
    v2 = L.apply_linear(p["self_attn2"]["v"], x, compute_dtype)
    v2_src = L.with_cache(caches["val2"], v2) if streaming else v2
    x = x + _self_attn(p["self_attn2"], cfg, si, v2_src, probs, compute_dtype)
    c2, new_conv2 = _conv_module(p["conv2"], dim, kernel, x, chunk, compute_dtype, valid,
                                 caches.get("conv2"))
    x = x + c2
    x = x + _apply_ff(p["ff3"], x, compute_dtype)
    x = L.apply_biasnorm(p["norm"], x)
    x = _bypass(p["bypass"], x_orig, x)
    if not streaming:
        return x, None
    left = caches["key"].shape[1]
    return x, {
        "key": k_src[:, -left:],
        "nonlin": L.with_cache(caches["nonlin"], nonlin_chunk)[:, -left:],
        "val1": v1_src[:, -left:],
        "val2": v2_src[:, -left:],
        "conv1": new_conv1,
        "conv2": new_conv2,
    }


def _stack_forward(p, cfg: Zipformer2Config, si: int, x, valid, compute_dtype):
    """One (possibly downsampled) stack, offline."""
    ds = cfg.downsampling_factors[si]
    t_full = x.shape[1]
    x = _convert_channels(x, cfg.encoder_dims[si])
    src = x
    if ds > 1:
        lens = valid.sum(dim=1) if valid is not None else None
        src = _simple_downsample(p["downsample_weights"], src, ds, lens)
        # a downsampled frame is valid if its first source frame is valid
        v = valid[:, ::ds][:, : src.shape[1]] if valid is not None else None
    else:
        v = valid
    pad_lens = v.sum(dim=1, dtype=torch.int32) if v is not None else None
    chunk_left = (max(1, cfg.stack_chunk(si)), cfg.stack_left(si)) if cfg.causal else None
    chunk = cfg.stack_chunk(si) if cfg.causal else 0
    for layer in p["layers"]:
        src, _ = _layer_forward(layer, cfg, si, src, chunk, compute_dtype, v, pad_lens,
                                chunk_left=chunk_left)
        if v is not None:
            src = torch.where(v[:, :, None], src, 0.0)
    if ds > 1:
        src = _simple_upsample(src, ds, t_full)
        src = _bypass(p["bypass_out"], x, src)  # out_combiner (ds>1 only)
    return src


def forward(params, cfg: Zipformer2Config, x, x_lens, compute_dtype=None):
    """x: [B, T, F] raw fbank -> (enc_out [B, T', max_dim], out_lens [B]).

    Causal mode computes what chunked streaming over the zero-extended input
    would (whole windows of 2*chunk+13 raw frames, no lane masking inside
    the stacks); non-causal mode masks padded keys and zeroes padded
    positions, as icefall's offline forward does."""
    lens0 = torch.clamp((x_lens - 7) // 2, min=0)
    if cfg.causal:
        t_raw = x.shape[1]
        c = cfg.chunk_size
        t0 = max(1, (t_raw - 7) // 2)
        kwin = -(-t0 // c)
        t_need = 2 * c * kwin + 13
        if t_need > t_raw:
            x = F.pad(x, (0, 0, 0, t_need - t_raw))
        stage = _embed_conv_stack(params["embed"], x, compute_dtype)
        stage = F.pad(stage, (0, 0, 0, 0, 3, 0))
        h = _embed_tail(params["embed"], stage, compute_dtype)  # [B, c*kwin, D]
        valid = None
    else:
        h = _embed_forward(params["embed"], x, compute_dtype, x_lens=x_lens)
        valid = L.length_mask(lens0, h.shape[1])
        h = torch.where(valid[:, :, None], h, 0.0)

    outputs = []
    for si in range(cfg.num_stacks):
        h = _stack_forward(params["stacks"][si], cfg, si, h, valid, compute_dtype)
        if valid is not None:
            h = torch.where(valid[:, :, None], h, 0.0)
        outputs.append(h)

    out = _simple_downsample(
        params["downsample_output_weights"], _full_dim_output(cfg, outputs),
        cfg.output_downsampling_factor, lens0 if valid is not None else None,
    )
    out_lens = -((-lens0) // cfg.output_downsampling_factor)
    ovalid = L.length_mask(out_lens, out.shape[1])
    return torch.where(ovalid[:, :, None], out, 0.0), out_lens


def _full_dim_output(cfg: Zipformer2Config, outputs):
    """Channel-stitch the stacks' outputs to max(dims) (icefall
    _get_full_dim_output)."""
    dims = cfg.encoder_dims
    pieces = [outputs[-1]]
    cur = dims[-1]
    for i in range(cfg.num_stacks - 2, -1, -1):
        if dims[i] > cur:
            pieces.append(outputs[i][..., cur : dims[i]])
            cur = dims[i]
    return torch.cat(pieces, dim=-1)


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


def init_state(cfg: Zipformer2Config, batch: int, device="cpu") -> dict:
    """Zero streaming state, batch-leading (the reference's tree and
    shapes): per layer key/val1/val2/nonlin ``[B, left_i, ...]`` and
    conv1/conv2 ``[B, k//2, D]`` in float32, the embed stage cache
    ``[B, 3, F', c3]`` and ``processed`` (int64 encoder-rate frames)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    layers = []
    for si in range(cfg.num_stacks):
        dim, heads, left = cfg.encoder_dims[si], cfg.num_heads[si], cfg.stack_left(si)
        half = cfg.cnn_module_kernels[si] // 2
        for _ in range(cfg.num_encoder_layers[si]):
            layers.append({
                "key": zeros(batch, left, heads * cfg.query_head_dim),
                "val1": zeros(batch, left, heads * cfg.value_head_dim),
                "val2": zeros(batch, left, heads * cfg.value_head_dim),
                "nonlin": zeros(batch, left, 3 * dim // 4),
                "conv1": zeros(batch, half, dim),
                "conv2": zeros(batch, half, dim),
            })
    return {
        "layers": layers,
        "embed_stage": zeros(batch, cfg.embed_cache_len, cfg.embed_freq_out,
                             cfg.embed_channels[-1]),
        "processed": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def streaming_step(params, cfg: Zipformer2Config, state: dict, x_chunk, compute_dtype=None):
    """x_chunk: [B, 2*chunk+13, F] raw feature window -> (enc_out
    [B, chunk/2, D], new_state).  Needs cfg.causal.

    Windows advance by 2*chunk raw frames.  The conv stack yields chunk+3
    stage frames; the 3-frame stage cache is the ConvNeXt's left context
    and the window's last 3 its lookahead and the next cache, so streaming
    == offline-causal.  Each stack gates its cache slots per lane with
    ``kv_start = left - min(processed // ds, left)``."""
    c = cfg.chunk_size
    stage = _embed_conv_stack(params["embed"], x_chunk, compute_dtype)  # [B, c+3, F', c3]
    stage = L.with_cache(state["embed_stage"], stage)
    h = _embed_tail(params["embed"], stage, compute_dtype)  # [B, c, D]
    processed = state["processed"]

    new_layers = []
    outputs = []
    li = 0
    for si in range(cfg.num_stacks):
        ds, left = cfg.downsampling_factors[si], cfg.stack_left(si)
        stack = params["stacks"][si]
        h = _convert_channels(h, cfg.encoder_dims[si])
        src = _simple_downsample(stack["downsample_weights"], h, ds) if ds > 1 else h
        kv_start = (left - torch.clamp(processed // ds, max=left)).to(torch.int32)
        for layer in stack["layers"]:
            src, new_cache = _layer_forward(layer, cfg, si, src, cfg.stack_chunk(si),
                                            compute_dtype, caches=state["layers"][li],
                                            kv_start=kv_start)
            new_layers.append(new_cache)
            li += 1
        if ds > 1:
            src = _bypass(stack["bypass_out"], h, _simple_upsample(src, ds, c))
        h = src
        outputs.append(h)

    out = _simple_downsample(params["downsample_output_weights"], _full_dim_output(cfg, outputs),
                             cfg.output_downsampling_factor)
    new_state = {
        "layers": new_layers,
        "embed_stage": stage[:, -cfg.embed_cache_len:],
        "processed": processed + c,
    }
    return out, new_state


class Zipformer2(ParamTree):
    """The encoder's parameters as an ``nn.Module`` (``state_dict`` keys are
    the reference's dotted paths) with the offline forward and the
    streaming step."""

    def __init__(self, cfg: Zipformer2Config, tree: dict, device="cpu"):
        super().__init__(tree, device)
        self.cfg = cfg

    def forward(self, x, x_lens, compute_dtype=None):
        return forward(self, self.cfg, x, x_lens, compute_dtype)

    def init_state(self, batch: int) -> dict:
        return init_state(self.cfg, batch, self.downsample_output_weights.device)

    def streaming_step(self, state: dict, x_chunk, compute_dtype=None):
        return streaming_step(self, self.cfg, state, x_chunk, compute_dtype)


Encoder = Zipformer2
