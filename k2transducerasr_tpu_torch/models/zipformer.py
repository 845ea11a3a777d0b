"""Zipformer v1 encoder (icefall pruned_transducer_stateless7, 2022), offline
and streaming — PyTorch port of ``k2transducerasr_tpu/models/zipformer.py``.

The structure and names follow the reference function for function; see its
module docstring for the architecture (Conv2dSubsampling with DoubleSwish
and BasicNorm, layers of ff1 -> pooling -> self_attn -> conv1 -> ff2 ->
forward2 -> conv2 -> ff3 -> BasicNorm -> scalar bypass, AttentionDownsample
/ SimpleUpsample stacks with U-Net skips, an AttentionDownsample x2
output).  Differences of form, not of value:
  * attention takes one route: ``_attention`` calls
    ``ops.attention_cuda.relpos_attn_probs`` (K1: the CUDA kernel on the
    card, its plain version on the CPU) once per layer, with no
    1/sqrt(head_dim), and both value paths (``out1`` now, ``out2`` after
    ff2) read those probs.  The reference's A/B switch to a per-consumer
    fused kernel is not ported;
  * the embed convs are plain 3x3 conv2d (the reference's banded-matmul
    forms compute the same conv);
  * the parameters live in an ``nn.Module`` (``Zipformer``) whose
    ``state_dict`` keys are the reference's dotted paths; the reference's
    ``None`` entries of ``skip_combiners`` stay ``None``.

Streaming (``init_state``/``streaming_step``, causal configs) carries the
reference's seven caches per layer, batch-leading: ``len [B]`` and ``avg
[B, D]`` (the cumulative pooling), ``key [B, left_i, adim]``, ``val1``/
``val2 [B, left_i, adim/2]`` and ``conv1``/``conv2 [B, kernel-1, D]``, all
float32, plus an int64 ``processed`` counter.  Each layer's K1 call then
has T = the stack's chunk against S = left_i + T keys, gated per lane by
``kv_start``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.ops.attention import sinusoidal_rel_pos
from k2transducerasr_tpu_torch.ops.attention_cuda import relpos_attn_probs
from k2transducerasr_tpu_torch.parallel.sharding import whole
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    feature_dim: int = 80
    num_encoder_layers: tuple = (2, 4, 3, 2, 4)
    encoder_dims: tuple = (384, 384, 384, 384, 384)
    attention_dims: tuple = (192, 192, 192, 192, 192)
    downsampling_factors: tuple = (1, 2, 4, 8, 2)
    num_heads: tuple = (8, 8, 8, 8, 8)
    feedforward_dims: tuple = (1024, 1024, 1024, 1024, 1024)
    cnn_module_kernels: tuple = (31, 31, 31, 31, 31)
    pos_dim: int = 4  # positional-query head dim (icefall pos_dim)
    embed_channels: tuple = (8, 32, 128)
    output_downsampling_factor: int = 2
    causal: bool = False
    chunk_size: int = 16  # embed-rate frames per streaming step
    left_context_frames: int = 64

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
    def encoder_out_dim(self) -> int:
        return self.encoder_dims[-1]

    def embed_len(self, t_raw: int) -> int:
        """Raw frames -> embed-rate frames (receptive field 7, stride 2)."""
        return (t_raw - 7) // 2

    def subsampled_len(self, t_raw: int) -> int:
        return (self.embed_len(t_raw) + 1) // 2

    @property
    def decode_chunk_len(self) -> int:
        """Raw feature frames a streaming window advances by."""
        return 2 * self.chunk_size

    @property
    def chunk_input_len(self) -> int:
        """Raw feature frames per streaming window: the embed's 7-frame
        receptive field over 2*chunk frames."""
        return 2 * self.chunk_size + 7

    def stack_chunk(self, i: int) -> int:
        return self.chunk_size // self.downsampling_factors[i]

    def stack_left(self, i: int) -> int:
        return max(1, self.left_context_frames // self.downsampling_factors[i])

    def skip_sources(self) -> tuple:
        """Per-stack U-Net skip source (stack index or None): icefall
        Zipformer.__init__'s skip_layers rule."""
        z = self.downsampling_factors
        out = [None, None]
        for i in range(2, self.num_stacks):
            out.append(next((j for j in range(i - 2, -1, -1) if z[j] <= z[i]), 0))
        return tuple(out[: self.num_stacks])


Config = ZipformerConfig


def output_dim(cfg: ZipformerConfig) -> int:
    return cfg.encoder_out_dim


def output_chunk_len(cfg: ZipformerConfig) -> int:
    """Output frames per streaming step (after the final downsample)."""
    return cfg.chunk_size // cfg.output_downsampling_factor


# ---------------------------------------------------------------------------
# Random init (numpy-seeded; the JAX init's tree, shapes and scales)
# ---------------------------------------------------------------------------


def _uniform_std(rng, shape, std: float) -> np.ndarray:
    """A symmetric uniform draw of standard deviation ``std`` (icefall draws
    the downsample query and the upsample bias from a normal of that std):
    only symmetric uniform and standard normal draws are scaled at the
    draw, as ``asrbench``'s recorder of an init takes them."""
    a = math.sqrt(3.0) * std
    return rng.uniform(-a, a, size=shape).astype(np.float32)


def init_basicnorm(dim: int) -> dict:
    return {"eps_log": np.asarray(math.log(0.25), np.float32)}


def _init_embed(rng, cfg: ZipformerConfig) -> dict:
    c1, c2, c3 = cfg.embed_channels
    f2 = (cfg.feature_dim - 3) // 2 + 1
    freq_out = (f2 - 3) // 2 + 1
    return {
        "conv1": L.init_conv2d(rng, 1, c1, (3, 3)),
        "conv2": L.init_conv2d(rng, c1, c2, (3, 3)),
        "conv3": L.init_conv2d(rng, c2, c3, (3, 3)),
        "out": L.init_linear(rng, c3 * freq_out, cfg.encoder_dims[0]),
        "out_norm": init_basicnorm(cfg.encoder_dims[0]),
    }


def _init_layer(rng, cfg: ZipformerConfig, si: int) -> dict:
    dim, adim, heads = cfg.encoder_dims[si], cfg.attention_dims[si], cfg.num_heads[si]
    ff, kernel = cfg.feedforward_dims[si], cfg.cnn_module_kernels[si]

    def ffm():
        return {"w1": L.init_linear(rng, dim, ff), "w2": L.init_linear(rng, ff, dim)}

    def convm():
        return {"pw1": L.init_linear(rng, dim, 2 * dim),
                "dw": L.init_conv1d(rng, dim, dim, kernel, groups=dim),
                "pw2": L.init_linear(rng, dim, dim)}

    return {
        "attn": {
            # in_proj packing: [q | k | v | pos_q]
            "in_proj": L.init_linear(rng, dim, 2 * adim + adim // 2 + heads * cfg.pos_dim),
            "pos_proj": L.init_linear(rng, dim, heads * cfg.pos_dim, bias=False),
            "out1": L.init_linear(rng, adim // 2, dim),
            "v2": L.init_linear(rng, dim, adim // 2, bias=False),
            "out2": L.init_linear(rng, adim // 2, dim),
        },
        "pooling": {"proj": L.init_linear(rng, dim, dim, bias=False)},
        "conv1": convm(),
        "conv2": convm(),
        "ff1": ffm(),
        "ff2": ffm(),
        "ff3": ffm(),
        "norm": init_basicnorm(dim),
        "bypass_scale": np.asarray(0.5, np.float32),
    }


def _init_attention_downsample(rng, in_dim: int, out_dim: int, ds: int) -> dict:
    p = {"query": _uniform_std(rng, in_dim, in_dim**-0.5)}
    if in_dim != out_dim:
        p["extra_proj"] = L.init_linear(rng, in_dim * ds, out_dim - in_dim, bias=False)
    return p


def _init_stack(rng, cfg: ZipformerConfig, si: int) -> dict:
    p = {"layers": [_init_layer(rng, cfg, si) for _ in range(cfg.num_encoder_layers[si])]}
    ds, dim = cfg.downsampling_factors[si], cfg.encoder_dims[si]
    in_dim = cfg.encoder_dims[si - 1] if si > 0 else cfg.encoder_dims[0]
    if ds > 1:
        p["downsample"] = _init_attention_downsample(rng, in_dim, dim, ds)
        p["upsample_bias"] = _uniform_std(rng, (ds, dim), 0.01)
        p["out_combiner"] = {"weight1": np.zeros((), np.float32)}
    elif in_dim != dim:
        raise ValueError(f"stack {si}: ds=1 with dim change {in_dim}->{dim} is not an "
                         "icefall v1 configuration")
    return p


def init_params(rng: np.random.Generator, cfg: ZipformerConfig) -> dict:
    """numpy tree with the reference ``init_params``' structure, shapes,
    scales and ``None`` entries (other values: another generator; the
    downsample queries and upsample biases uniform, of the reference's
    normal draws' std)."""
    return {
        "embed": _init_embed(rng, cfg),
        "stacks": [_init_stack(rng, cfg, i) for i in range(cfg.num_stacks)],
        "downsample_output": _init_attention_downsample(
            rng, cfg.encoder_dims[-1], cfg.encoder_dims[-1], cfg.output_downsampling_factor),
        "skip_combiners": [None if j is None else {"weight1": np.zeros((), np.float32)}
                           for j in cfg.skip_sources()],
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def apply_basicnorm(p, x):
    """icefall BasicNorm: x * rsqrt(mean(x^2) + exp(eps_log)), float32."""
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + torch.exp(p["eps_log"]))
    return (x32 * scale).to(x.dtype)


def _embed_forward(p, x, compute_dtype=None):
    """x [B, T, F] -> [B, (T-7)//2, dims[0]]: conv1 (freq pad 1, time
    VALID), conv2 (stride 2, VALID), conv3 (stride (1, 2), VALID) with
    DoubleSwish after each, the channel-major [C, F] flatten, the out
    linear, BasicNorm."""
    h = L.double_swish(L.apply_conv2d(p["conv1"], x[..., None], padding=(0, 1),
                                      compute_dtype=compute_dtype))
    h = L.double_swish(L.apply_conv2d(p["conv2"], h, strides=(2, 2), compute_dtype=compute_dtype))
    h = L.double_swish(L.apply_conv2d(p["conv3"], h, strides=(1, 2), compute_dtype=compute_dtype))
    b, t0, f, c = h.shape
    h = L.apply_linear(p["out"], h.transpose(2, 3).reshape(b, t0, c * f), compute_dtype)
    return apply_basicnorm(p["out_norm"], h)


def _attention_downsample(p, x, ds: int, lens=None):
    """icefall AttentionDownsample: softmax(query . frame) weights over each
    window of ``L.downsample_windows`` (the tail repeats the last frame;
    with ``lens``, each lane's LAST VALID frame fills its padding: the
    reference's padding-invariant form); when dims change, the extra
    channels come from a linear over the window flatten.
    x: [B, T, Din] -> [B, ceil(T/ds), Dout]."""
    xw = L.downsample_windows(x, ds, lens)
    b, t_out, _, d = xw.shape
    w = torch.softmax(torch.einsum("bkwd,d->bkw", xw.float(), p["query"].float()), dim=-1)
    ans = torch.einsum("bkwd,bkw->bkd", xw.float(), w.to(xw.dtype).float()).to(xw.dtype)
    if "extra_proj" in p:
        ans2 = L.apply_linear(p["extra_proj"], xw.reshape(b, t_out, ds * d))
        ans = torch.cat([ans, ans2.to(ans.dtype)], dim=-1)
    return ans


def _simple_upsample_v1(bias, x, t_target: int):
    """icefall v1 SimpleUpsample: repeat each frame ``ds`` times adding a
    learned per-phase bias, truncated to the pre-downsample length (a
    model-sharded ``bias`` is gathered whole)."""
    b, t, d = x.shape
    bias = whole(bias)
    ds = bias.shape[0]
    y = x[:, :, None, :] + bias[None, None].to(x.dtype)
    return y.reshape(b, t * ds, d)[:, :t_target]


def _simple_combine(weight1, src1, src2):
    """icefall SimpleCombiner: src1*w1 + src2*(1-w1), src1 zero-padded or
    truncated on the last dim to src2's width."""
    a = src1 * weight1.to(src1.dtype)
    b_ = src2 * (1.0 - weight1).to(src2.dtype)
    d1, d2 = a.shape[-1], b_.shape[-1]
    if d1 < d2:
        a = F.pad(a, (0, d2 - d1))
    elif d1 > d2:
        a = a[..., :d2]
    return a + b_


def _attention(p, cfg: ZipformerConfig, si: int, x, k_cache, v1_cache, compute_dtype,
               pad_lens=None, chunk_left=None, kv_start=None):
    """The shared attention weights of a layer.  Projects q, k, v1 and pos_q
    from the packed ``in_proj`` and pos_k from ``pos_proj`` over the
    sinusoid, and computes the probs [B, H, T, S] once through K1 (no
    1/sqrt(head_dim): icefall folds it into in_proj's init).  Streaming,
    keys and values run over ``[cache | chunk]``.  Masks: ``pad_lens`` valid
    keys per lane (non-causal offline), ``chunk_left`` the static (chunk,
    left) pattern (causal offline), ``kv_start`` the first valid key per
    lane (streaming).  Returns (probs, v1 source, k chunk, v1 chunk)."""
    adim, heads, pd = cfg.attention_dims[si], cfg.num_heads[si], cfg.pos_dim
    b, t, _ = x.shape
    proj = L.apply_linear(p["in_proj"], x, compute_dtype)
    q = proj[..., :adim].reshape(b, t, heads, adim // heads)
    k_chunk = proj[..., adim: 2 * adim]
    v1_chunk = proj[..., 2 * adim: 2 * adim + adim // 2]
    pos_q = proj[..., 2 * adim + adim // 2:].reshape(b, t, heads, pd)
    k_src = k_chunk if k_cache is None else L.with_cache(k_cache, k_chunk)
    v1_src = v1_chunk if v1_cache is None else L.with_cache(v1_cache, v1_chunk)
    s = k_src.shape[1]
    pe = sinusoidal_rel_pos(t, s, cfg.encoder_dims[si], x.device)
    pos_k = L.apply_linear(p["pos_proj"], pe, compute_dtype).reshape(-1, heads, pd)
    ch, lf = chunk_left if chunk_left is not None else (0, 0)
    # all four are in the compute dtype; the kernel takes contiguous inputs
    probs = relpos_attn_probs(q.contiguous(), k_src.reshape(b, s, heads, -1).contiguous(),
                              pos_q.contiguous(), pos_k.contiguous(), pad_lens, chunk=ch,
                              left=lf, kv_start=kv_start)
    return probs, v1_src, k_chunk, v1_chunk


def _weighted(p_out, probs, v_src, compute_dtype):
    """out(probs @ v) for all heads.  v_src: [B, S, adim/2] -> [B, T, D];
    the product runs in v's dtype with float32 accumulation."""
    b, h, t, _ = probs.shape
    s, dv = v_src.shape[1:]
    v = v_src.reshape(b, s, h, dv // h).permute(0, 2, 1, 3)
    ctx = torch.matmul(probs.to(v.dtype), v).permute(0, 2, 1, 3).reshape(b, t, dv)
    return L.apply_linear(p_out, ctx, compute_dtype)


def _pooling_global(p, x, valid, compute_dtype):
    """Offline PoolingModule: the masked global mean over time, projected
    and broadcast to every frame."""
    x32 = x.float()
    if valid is None:
        mean = torch.mean(x32, dim=1, keepdim=True)
    else:
        w = valid.float()
        w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
        mean = torch.einsum("btd,bt->bd", x32, w)[:, None, :]
    return L.apply_linear(p["proj"], mean.to(x.dtype), compute_dtype)


def _pooling_causal(p, x, cached_len, cached_avg, compute_dtype):
    """Causal PoolingModule: the cumulative mean, with ``cached_len``/
    ``cached_avg`` carrying the history across chunks (None offline).
    Returns (out, new_len, new_avg), the last two float32."""
    b, t, d = x.shape
    csum = torch.cumsum(x.float(), dim=1)
    if cached_len is None:
        base_n = torch.zeros((b, 1), dtype=torch.float32, device=x.device)
        base_sum = torch.zeros((b, 1, d), dtype=torch.float32, device=x.device)
    else:
        base_n = cached_len[:, None].float()
        base_sum = cached_avg.float()[:, None, :] * base_n[:, :, None]
    counts = torch.arange(1, t + 1, dtype=torch.float32, device=x.device)[None, :] + base_n
    mean = (csum + base_sum) / counts[:, :, None]
    out = L.apply_linear(p["proj"], mean.to(x.dtype), compute_dtype)
    return out, counts[:, -1], mean[:, -1]


def _causal_conv(p, dim: int, kernel: int, x, cache, compute_dtype):
    """Causal ConvolutionModule: pw1 + GLU -> depthwise over ``[cache | h]``
    (cache: [B, kernel-1, D], zeros when None) -> DoubleSwish -> pw2.
    Returns (out, the tail of ``[cache | h]``)."""
    h = L.glu(L.apply_linear(p["pw1"], x, compute_dtype))
    b, _, d = h.shape
    if cache is None:
        cache = torch.zeros((b, kernel - 1, d), dtype=h.dtype, device=h.device)
    win = L.with_cache(cache, h)
    y = L.apply_conv1d(p["dw"], win, groups=dim, padding="VALID", compute_dtype=compute_dtype)
    return L.apply_linear(p["pw2"], L.double_swish(y), compute_dtype), win[:, -(kernel - 1):]


def _centered_conv(p, dim: int, x, valid, compute_dtype):
    """Non-causal ConvolutionModule: SAME depthwise conv, padded positions
    zeroed before it."""
    h = L.glu(L.apply_linear(p["pw1"], x, compute_dtype))
    if valid is not None:
        h = torch.where(valid[:, :, None], h, 0.0)
    y = L.apply_conv1d(p["dw"], h, groups=dim, padding="SAME", compute_dtype=compute_dtype)
    return L.apply_linear(p["pw2"], L.double_swish(y), compute_dtype)


def _ff(p, x, compute_dtype):
    return L.apply_linear(p["w2"], L.double_swish(L.apply_linear(p["w1"], x, compute_dtype)),
                          compute_dtype)


def _layer_forward(p, cfg: ZipformerConfig, si: int, x, caches, valid, compute_dtype,
                   pad_lens=None, chunk_left=None, kv_start=None):
    """One ZipformerEncoderLayer in icefall's op order: ff1 -> pooling ->
    self_attn -> conv1 -> ff2 -> forward2 (the same probs, the v2/out2
    value path) -> conv2 -> ff3 -> BasicNorm -> scalar bypass.

    ``caches``: None offline, or (streaming) the layer's dict len, avg, key,
    val1, val2, conv1, conv2.  Returns (out, new caches or None)."""
    dim, kernel = cfg.encoder_dims[si], cfg.cnn_module_kernels[si]
    streaming = caches is not None
    caches = caches or {}
    x_orig = x
    new = {}

    x = x + _ff(p["ff1"], x, compute_dtype)
    if cfg.causal:
        pool, new["len"], new["avg"] = _pooling_causal(p["pooling"], x, caches.get("len"),
                                                       caches.get("avg"), compute_dtype)
    else:
        pool = _pooling_global(p["pooling"], x, valid, compute_dtype)
    x = x + pool

    probs, v1_src, k_chunk, v1_chunk = _attention(
        p["attn"], cfg, si, x, caches.get("key"), caches.get("val1"), compute_dtype,
        pad_lens=pad_lens, chunk_left=chunk_left, kv_start=kv_start)
    x = x + _weighted(p["attn"]["out1"], probs, v1_src, compute_dtype)

    if cfg.causal:
        c1, new["conv1"] = _causal_conv(p["conv1"], dim, kernel, x, caches.get("conv1"),
                                        compute_dtype)
    else:
        c1 = _centered_conv(p["conv1"], dim, x, valid, compute_dtype)
    x = x + c1
    x = x + _ff(p["ff2"], x, compute_dtype)

    v2_chunk = L.apply_linear(p["attn"]["v2"], x, compute_dtype)
    v2_src = L.with_cache(caches["val2"], v2_chunk) if streaming else v2_chunk
    x = x + _weighted(p["attn"]["out2"], probs, v2_src, compute_dtype)

    if cfg.causal:
        c2, new["conv2"] = _causal_conv(p["conv2"], dim, kernel, x, caches.get("conv2"),
                                        compute_dtype)
    else:
        c2 = _centered_conv(p["conv2"], dim, x, valid, compute_dtype)
    x = x + c2
    x = x + _ff(p["ff3"], x, compute_dtype)
    x = apply_basicnorm(p["norm"], x)
    x = x_orig + (x - x_orig) * p["bypass_scale"].to(x.dtype)
    if not streaming:
        return x, None
    left = caches["key"].shape[1]
    new["key"] = L.with_cache(caches["key"], k_chunk)[:, -left:]
    new["val1"] = v1_src[:, -left:]
    new["val2"] = v2_src[:, -left:]
    return x, new


# ---------------------------------------------------------------------------
# Offline / streaming
# ---------------------------------------------------------------------------


def forward(params, cfg: ZipformerConfig, x, x_lens, compute_dtype=None):
    """x: [B, T, F] raw fbank -> (enc_out [B, T', D_last], out_lens [B]),
    ``out_lens = ((x_lens-7)//2 + 1) // 2``.

    Non-causal: icefall's offline forward (global pooling, full attention
    over the valid keys, SAME convs, padded frames zeroed).  Causal: what
    chunked streaming over the zero-extended input computes (whole windows
    of 2*chunk+7 raw frames, no lane masking inside the stacks)."""
    lens0 = torch.clamp((x_lens - 7) // 2, min=0)
    if cfg.causal:
        t_raw = x.shape[1]
        c = cfg.chunk_size
        kwin = -(-max(1, (t_raw - 7) // 2) // c)
        t_need = 2 * c * kwin + 7
        if t_need > t_raw:
            x = F.pad(x, (0, 0, 0, t_need - t_raw))
    h = _embed_forward(params["embed"], x, compute_dtype)
    t_full = h.shape[1]
    valid = None
    if not cfg.causal:
        valid = L.length_mask(lens0, t_full)
        h = torch.where(valid[:, :, None], h, 0.0)
    lens = lens0 if valid is not None else None

    skips = cfg.skip_sources()
    outputs = []
    for si in range(cfg.num_stacks):
        p = params["stacks"][si]
        ds = cfg.downsampling_factors[si]
        if skips[si] is not None:
            h = _simple_combine(params["skip_combiners"][si]["weight1"], outputs[skips[si]], h)
        src, v = h, valid
        if ds > 1:
            src = _attention_downsample(p["downsample"], h, ds, lens)
            v = valid[:, ::ds][:, : src.shape[1]] if valid is not None else None
        pad_lens = v.sum(dim=1, dtype=torch.int32) if v is not None else None
        chunk_left = (max(1, cfg.stack_chunk(si)), cfg.stack_left(si)) if cfg.causal else None
        for layer in p["layers"]:
            src, _ = _layer_forward(layer, cfg, si, src, None, v, compute_dtype,
                                    pad_lens=pad_lens, chunk_left=chunk_left)
            if v is not None:
                src = torch.where(v[:, :, None], src, 0.0)
        if ds > 1:
            src = _simple_upsample_v1(p["upsample_bias"], src, t_full)
            src = _simple_combine(p["out_combiner"]["weight1"], h, src)
            if valid is not None:
                src = torch.where(valid[:, :, None], src, 0.0)
        h = src
        outputs.append(h)

    out = _attention_downsample(params["downsample_output"], h, cfg.output_downsampling_factor,
                                lens)
    out_lens = (lens0 + 1) // cfg.output_downsampling_factor
    ovalid = L.length_mask(out_lens, out.shape[1])
    return torch.where(ovalid[:, :, None], out, 0.0), out_lens


def init_state(cfg: ZipformerConfig, batch: int, device="cpu") -> dict:
    """Zero streaming state, batch-leading (the reference's tree and
    shapes): per layer ``len [B]``, ``avg [B, D]``, ``key [B, left_i,
    adim]``, ``val1``/``val2 [B, left_i, adim/2]``, ``conv1``/``conv2
    [B, kernel-1, D]`` in float32, and ``processed`` (int64 embed-rate
    frames; int32 in the JAX layout, see ``checkpoint.state_to_numpy``)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    layers = []
    for si in range(cfg.num_stacks):
        dim, adim, left = cfg.encoder_dims[si], cfg.attention_dims[si], cfg.stack_left(si)
        k = cfg.cnn_module_kernels[si]
        for _ in range(cfg.num_encoder_layers[si]):
            layers.append({
                "len": zeros(batch),
                "avg": zeros(batch, dim),
                "key": zeros(batch, left, adim),
                "val1": zeros(batch, left, adim // 2),
                "val2": zeros(batch, left, adim // 2),
                "conv1": zeros(batch, k - 1, dim),
                "conv2": zeros(batch, k - 1, dim),
            })
    return {"layers": layers,
            "processed": torch.zeros((batch,), dtype=torch.int64, device=device)}


def streaming_step(params, cfg: ZipformerConfig, state: dict, x_chunk, compute_dtype=None):
    """x_chunk: [B, 2*chunk+7, F] raw feature window -> (enc_out
    [B, chunk/2, D], new_state).  Needs cfg.causal and an even chunk.

    Windows advance by 2*chunk raw frames and overlap by 7: the embed is
    recomputed over the overlap (its receptive field is local, so its frames
    equal a whole-utterance embed's).  Each stack gates its cache slots per
    lane with ``kv_start = left - min(processed // ds, left)``."""
    if cfg.chunk_size % 2:
        raise ValueError(f"zipformer v1 streaming needs an even chunk_size, got {cfg.chunk_size}")
    c = cfg.chunk_size
    h = _embed_forward(params["embed"], x_chunk, compute_dtype)[:, -c:]
    processed = state["processed"]

    skips = cfg.skip_sources()
    new_layers = []
    outputs = []
    li = 0
    for si in range(cfg.num_stacks):
        p = params["stacks"][si]
        ds, left = cfg.downsampling_factors[si], cfg.stack_left(si)
        if skips[si] is not None:
            h = _simple_combine(params["skip_combiners"][si]["weight1"], outputs[skips[si]], h)
        src = _attention_downsample(p["downsample"], h, ds) if ds > 1 else h
        kv_start = (left - torch.clamp(processed // ds, max=left)).to(torch.int32)
        for layer in p["layers"]:
            src, caches = _layer_forward(layer, cfg, si, src, state["layers"][li], None,
                                         compute_dtype, kv_start=kv_start)
            new_layers.append(caches)
            li += 1
        if ds > 1:
            src = _simple_combine(p["out_combiner"]["weight1"], h,
                                  _simple_upsample_v1(p["upsample_bias"], src, c))
        h = src
        outputs.append(h)

    out = _attention_downsample(params["downsample_output"], h, cfg.output_downsampling_factor)
    return out, {"layers": new_layers, "processed": processed + c}


class Zipformer(ParamTree):
    """The encoder's parameters as an ``nn.Module`` (``state_dict`` keys are
    the reference's dotted paths) with the offline forward and the
    streaming step."""

    def __init__(self, cfg: ZipformerConfig, tree: dict, device="cpu"):
        # a stack without a U-Net skip has no combiner: its slot is None,
        # whatever a tree made elsewhere holds there (``asrbench``'s weights
        # fill every leaf of the init's tree, None slots included)
        skips = [None if j is None else c
                 for j, c in zip(cfg.skip_sources(), tree["skip_combiners"])]
        super().__init__(dict(tree, skip_combiners=skips), device)
        self.cfg = cfg

    def forward(self, x, x_lens, compute_dtype=None):
        return forward(self, self.cfg, x, x_lens, compute_dtype)

    def init_state(self, batch: int) -> dict:
        return init_state(self.cfg, batch, self.downsample_output["query"].device)

    def streaming_step(self, state: dict, x_chunk, compute_dtype=None):
        return streaming_step(self, self.cfg, state, x_chunk, compute_dtype)


Encoder = Zipformer
