"""The benchmark's plain reference of the zipformer2 encoder: icefall's
Zipformer2 at inference, in float32 PyTorch, with no kernel, cache or
batching of the program under test.

A frozen copy of the repository's test oracle
(``tests/icefall_zipformer2_oracle.py``), changed only so that every tensor it
makes is made on its input's device.  It reproduces, from the public icefall
``zipformer/zipformer.py`` (2023) recipe, the inference-time
computation of every exported component:

  * Conv2dSubsampling: 3 convs (time VALID stride 2, freq 80->19, SwooshR) ->
    ConvNeXt (depthwise 7x7 SAME, hidden ratio 3, SwooshL, residual) ->
    channel-major [C, F] flatten -> Linear -> BiasNorm;
  * CompactRelPositionalEncoding: log compression (compression_length
    sqrt(dim)), atan with length_scale dim/(2*pi), integer freqs 1..dim/2,
    interleaved cos/sin, last column 1.0;
  * RelPositionMultiheadAttentionWeights: one in_proj packing [q | k | p],
    pos scores via linear_pos + gather rel-shift, masked_fill(-1000), softmax;
  * SelfAttention / NonlinAttention (tanh gate, head 0 only) /
    ConvolutionModule (value*sigmoid(gate), depthwise SAME or
    ChunkCausalDepthwiseConv1d, SwooshR before out_proj) /
    FeedforwardModule (SwooshL before out_proj);
  * Zipformer2EncoderLayer op order: attn_weights; +ff1; +nonlin_attn; +attn1;
    +conv1; +ff2; bypass_mid; +attn2; +conv2; +ff3; BiasNorm; bypass;
  * SimpleDownsample (softmax window weights, repeat-last-frame tail pad),
    SimpleUpsample, BypassModule (per-channel scale), stack nesting
    (DownsampledZipformer2Encoder), convert_num_channels channel stitching,
    _get_full_dim_output, final SimpleDownsample x2.

Training-only modules (Balancer, Whiten, ScaleGrad, Dropout, ScheduledFloat)
are identity at inference and hold no parameters, so `state_dict()` here
yields exactly the initializer names a real export carries
(``oracle_state`` of ``asrbench/models/zipformer2.py`` fills it from the
benchmark's weights).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn


class SwooshL(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        return torch.logaddexp(torch.zeros_like(x), x - 4.0) - 0.08 * x - 0.035


class SwooshR(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        return torch.logaddexp(torch.zeros_like(x), x - 1.0) - 0.08 * x - 0.313261687


class BiasNorm(nn.Module):
    """x * (mean((x - bias)^2) ** -0.5) * exp(log_scale)."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.tensor(1.0))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: Tensor) -> Tensor:
        scales = ((x - self.bias) ** 2).mean(dim=-1, keepdim=True) ** -0.5
        return x * scales * self.log_scale.exp()


class ActivationAndLinear(nn.Linear):
    """icefall ActivationDropoutAndLinear at inference: activation then
    linear; parameters live directly on the module (weight/bias)."""

    def __init__(self, in_ch, out_ch, activation="SwooshL", bias=True):
        super().__init__(in_ch, out_ch, bias=bias)
        self.act = SwooshL() if activation == "SwooshL" else SwooshR()

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(self.act(x), self.weight, self.bias)


class ConvNeXt(nn.Module):
    def __init__(self, channels: int, hidden_ratio: int = 3, kernel_size=(7, 7)):
        super().__init__()
        padding = (kernel_size[0] // 2, kernel_size[1] // 2)
        hidden = channels * hidden_ratio
        self.depthwise_conv = nn.Conv2d(
            channels, channels, groups=channels, kernel_size=kernel_size, padding=padding
        )
        self.pointwise_conv1 = nn.Conv2d(channels, hidden, kernel_size=1)
        self.activation = SwooshL()
        self.pointwise_conv2 = nn.Conv2d(hidden, channels, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:  # (N, C, T, F)
        bypass = x
        x = self.depthwise_conv(x)
        x = self.pointwise_conv1(x)
        x = self.activation(x)
        x = self.pointwise_conv2(x)
        return bypass + x


class Conv2dSubsampling(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layer1_channels=8,
                 layer2_channels=32, layer3_channels=128):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, layer1_channels, kernel_size=3, padding=(0, 1)),
            SwooshR(),
            nn.Conv2d(layer1_channels, layer2_channels, kernel_size=3, stride=2),
            SwooshR(),
            nn.Conv2d(layer2_channels, layer3_channels, kernel_size=3, stride=(1, 2)),
            SwooshR(),
        )
        self.convnext = ConvNeXt(layer3_channels)
        out_width = (((in_channels - 1) // 2) - 1) // 2
        self.out = nn.Linear(out_width * layer3_channels, out_channels)
        self.out_norm = BiasNorm(out_channels)

    def forward(self, x: Tensor) -> Tensor:  # (N, T, idim) -> (N, (T-7)//2, D)
        x = x.unsqueeze(1)
        x = self.conv(x)
        x = self.convnext(x)
        b, c, t, f = x.size()
        x = x.transpose(1, 2).reshape(b, t, c * f)
        x = self.out(x)
        return self.out_norm(x)


class CompactRelPositionalEncoding(nn.Module):
    """No parameters; recomputed per call (max_len caching omitted)."""

    def __init__(self, embed_dim: int, length_factor: float = 1.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.length_factor = length_factor

    def forward(self, x: Tensor, left_context_len: int = 0) -> Tensor:
        # x: (time, batch, _). Returns (1, left + 2*time - 1, embed_dim),
        # positions ascending from -(time + left - 1) to (time - 1).
        T = x.size(0) + left_context_len
        pos = torch.arange(-(T - 1), T, dtype=torch.float32, device=x.device).unsqueeze(1)
        freqs = 1 + torch.arange(self.embed_dim // 2, device=x.device)
        compression_length = self.embed_dim ** 0.5
        x_compressed = (
            compression_length
            * pos.sign()
            * ((pos.abs() + compression_length).log() - math.log(compression_length))
        )
        length_scale = self.length_factor * self.embed_dim / (2.0 * math.pi)
        x_atan = (x_compressed / length_scale).atan()
        cosines = (x_atan * freqs).cos()
        sines = (x_atan * freqs).sin()
        pe = torch.zeros(pos.shape[0], self.embed_dim, device=x.device)
        pe[:, 0::2] = cosines
        pe[:, 1::2] = sines
        pe[:, -1] = 1.0
        # slice: negative side length (time + left), positive side time
        x_size_left = x.size(0) + left_context_len
        pos_emb = pe[pe.size(0) // 2 - x_size_left + 1 : pe.size(0) // 2 + x.size(0)]
        return pos_emb.unsqueeze(0)


class RelPositionMultiheadAttentionWeights(nn.Module):
    def __init__(self, embed_dim, pos_dim, num_heads, query_head_dim, pos_head_dim):
        super().__init__()
        self.num_heads = num_heads
        self.query_head_dim = query_head_dim
        self.pos_head_dim = pos_head_dim
        in_proj_dim = (query_head_dim * 2 + pos_head_dim) * num_heads
        self.in_proj = nn.Linear(embed_dim, in_proj_dim, bias=True)
        self.linear_pos = nn.Linear(pos_dim, num_heads * pos_head_dim, bias=False)

    def forward(self, x: Tensor, pos_emb: Tensor, key_padding_mask=None,
                attn_mask=None) -> Tensor:
        # x: (time, batch, embed_dim); returns (heads, batch, time, time)
        x = self.in_proj(x)
        H, qd, pd = self.num_heads, self.query_head_dim, self.pos_head_dim
        query_dim = qd * H
        q = x[..., 0:query_dim]
        k = x[..., query_dim : 2 * query_dim]
        p = x[..., 2 * query_dim :]
        seq_len, batch_size, _ = q.shape
        q = q.reshape(seq_len, batch_size, H, qd).permute(2, 1, 0, 3)
        p = p.reshape(seq_len, batch_size, H, pd).permute(2, 1, 0, 3)
        k = k.reshape(seq_len, batch_size, H, qd).permute(2, 1, 3, 0)
        attn_scores = torch.matmul(q, k)  # (H, B, T, T)

        pos_emb = self.linear_pos(pos_emb)
        seq_len2 = 2 * seq_len - 1
        pos_emb = pos_emb.reshape(-1, seq_len2, H, pd).permute(2, 0, 3, 1)
        pos_scores = torch.matmul(p, pos_emb)  # (H, B, T, 2T-1)
        # rel shift (icefall's gather/tracing branch)
        (h_, b_, time1, n) = pos_scores.shape
        rows = torch.arange(start=time1 - 1, end=-1, step=-1, device=x.device)
        cols = torch.arange(seq_len, device=x.device)
        rows = rows.repeat(b_ * h_).unsqueeze(-1)
        indexes = rows + cols
        pos_scores = pos_scores.reshape(-1, n)
        pos_scores = torch.gather(pos_scores, dim=1, index=indexes)
        pos_scores = pos_scores.reshape(h_, b_, time1, seq_len)
        attn_scores = attn_scores + pos_scores

        if attn_mask is not None:
            attn_scores = attn_scores.masked_fill(attn_mask, -1000)
        if key_padding_mask is not None:
            # key_padding_mask: (batch, time), True at PADDED positions
            attn_scores = attn_scores.masked_fill(
                key_padding_mask.unsqueeze(1), -1000
            )
        return attn_scores.softmax(dim=-1)


class SelfAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, value_head_dim):
        super().__init__()
        self.in_proj = nn.Linear(embed_dim, num_heads * value_head_dim, bias=True)
        self.out_proj = nn.Linear(num_heads * value_head_dim, embed_dim, bias=True)

    def forward(self, x: Tensor, attn_weights: Tensor) -> Tensor:
        (seq_len, batch, _) = x.shape
        num_heads = attn_weights.shape[0]
        x = self.in_proj(x)
        x = x.reshape(seq_len, batch, num_heads, -1).permute(2, 1, 0, 3)
        x = torch.matmul(attn_weights, x)
        x = x.permute(2, 1, 0, 3).reshape(seq_len, batch, -1)
        return self.out_proj(x)


class NonlinAttention(nn.Module):
    def __init__(self, channels: int, hidden_channels: int):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.in_proj = nn.Linear(channels, hidden_channels * 3, bias=True)
        self.out_proj = nn.Linear(hidden_channels, channels, bias=True)

    def forward(self, x: Tensor, attn_weights: Tensor) -> Tensor:
        # attn_weights: (1, batch, time, time) — head 0 only
        x = self.in_proj(x)
        (seq_len, batch, _) = x.shape
        s, x, y = x.chunk(3, dim=2)
        x = x * s.tanh()
        num_heads = attn_weights.shape[0]
        x = x.reshape(seq_len, batch, num_heads, -1).permute(2, 1, 0, 3)
        x = torch.matmul(attn_weights, x)
        x = x.permute(2, 1, 0, 3).reshape(seq_len, batch, -1)
        x = x * y
        return self.out_proj(x)


class ChunkCausalDepthwiseConv1d(nn.Module):
    """Causal half-kernel depthwise conv + within-chunk SAME depthwise conv
    scaled by learned per-position edge corrections."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal_conv = nn.Conv1d(
            channels, channels, groups=channels, kernel_size=kernel_size // 2 + 1
        )
        self.chunkwise_conv = nn.Conv1d(
            channels, channels, groups=channels, kernel_size=kernel_size,
            padding=kernel_size // 2,
        )
        self.chunkwise_conv_scale = nn.Parameter(torch.zeros(2, channels, kernel_size))

    def _get_chunk_scale(self, chunk_size: int) -> Tensor:
        left_edge = self.chunkwise_conv_scale[0]
        right_edge = self.chunkwise_conv_scale[1]
        if chunk_size < self.kernel_size:
            left_edge = left_edge[:, :chunk_size]
            right_edge = right_edge[:, -chunk_size:]
        else:
            t = chunk_size - self.kernel_size
            channels = left_edge.shape[0]
            pad = torch.zeros(channels, t, device=left_edge.device)
            left_edge = torch.cat((left_edge, pad), dim=-1)
            right_edge = torch.cat((pad, right_edge), dim=-1)
        return 1.0 + (left_edge + right_edge)

    def forward(self, x: Tensor, chunk_size: int = -1) -> Tensor:
        # x: (batch, channels, time)
        (batch_size, num_channels, seq_len) = x.shape
        left_pad = self.kernel_size // 2
        if chunk_size < 0 or chunk_size > seq_len:
            chunk_size = seq_len
        right_pad = -seq_len % chunk_size
        x = F.pad(x, (left_pad, right_pad))
        x_causal = self.causal_conv(x[..., : left_pad + seq_len])
        x_chunk = x[..., left_pad:]
        num_chunks = x_chunk.shape[2] // chunk_size
        x_chunk = x_chunk.reshape(batch_size, num_channels, num_chunks, chunk_size)
        x_chunk = x_chunk.permute(0, 2, 1, 3).reshape(
            batch_size * num_chunks, num_channels, chunk_size
        )
        x_chunk = self.chunkwise_conv(x_chunk)
        x_chunk = x_chunk * self._get_chunk_scale(chunk_size)
        x_chunk = x_chunk.reshape(
            batch_size, num_chunks, num_channels, chunk_size
        ).permute(0, 2, 1, 3)
        x_chunk = x_chunk.reshape(batch_size, num_channels, num_chunks * chunk_size)
        x_chunk = x_chunk[..., :seq_len]
        return x_chunk + x_causal


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int, causal: bool):
        super().__init__()
        bottleneck_dim = channels
        self.in_proj = nn.Linear(channels, 2 * bottleneck_dim)
        self.depthwise_conv = (
            ChunkCausalDepthwiseConv1d(bottleneck_dim, kernel_size)
            if causal
            else nn.Conv1d(
                bottleneck_dim, bottleneck_dim, groups=bottleneck_dim,
                kernel_size=kernel_size, padding=kernel_size // 2,
            )
        )
        self.causal = causal
        self.out_proj = ActivationAndLinear(bottleneck_dim, channels, "SwooshR")

    def forward(self, x: Tensor, src_key_padding_mask=None, chunk_size: int = -1):
        # x: (time, batch, channels)
        x = self.in_proj(x)
        x, s = x.chunk(2, dim=2)
        x = x * s.sigmoid()
        x = x.permute(1, 2, 0)  # (batch, channels, time)
        if src_key_padding_mask is not None:
            x = x.masked_fill(src_key_padding_mask.unsqueeze(1).expand_as(x), 0.0)
        if self.causal:
            x = self.depthwise_conv(x, chunk_size=chunk_size)
        else:
            x = self.depthwise_conv(x)
        x = x.permute(2, 0, 1)
        return self.out_proj(x)


class FeedforwardModule(nn.Module):
    def __init__(self, embed_dim: int, feedforward_dim: int):
        super().__init__()
        self.in_proj = nn.Linear(embed_dim, feedforward_dim)
        self.out_proj = ActivationAndLinear(feedforward_dim, embed_dim, "SwooshL")

    def forward(self, x: Tensor) -> Tensor:
        return self.out_proj(self.in_proj(x))


class BypassModule(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.bypass_scale = nn.Parameter(torch.full((embed_dim,), 0.5))

    def forward(self, src_orig: Tensor, src: Tensor) -> Tensor:
        return src_orig + (src - src_orig) * self.bypass_scale


class Zipformer2EncoderLayer(nn.Module):
    def __init__(self, embed_dim, pos_dim, num_heads, query_head_dim, pos_head_dim,
                 value_head_dim, feedforward_dim, cnn_module_kernel, causal):
        super().__init__()
        self.self_attn_weights = RelPositionMultiheadAttentionWeights(
            embed_dim, pos_dim, num_heads, query_head_dim, pos_head_dim
        )
        self.self_attn1 = SelfAttention(embed_dim, num_heads, value_head_dim)
        self.self_attn2 = SelfAttention(embed_dim, num_heads, value_head_dim)
        self.feed_forward1 = FeedforwardModule(embed_dim, feedforward_dim)
        self.feed_forward2 = FeedforwardModule(embed_dim, feedforward_dim)
        self.feed_forward3 = FeedforwardModule(embed_dim, feedforward_dim)
        self.nonlin_attention = NonlinAttention(embed_dim, 3 * embed_dim // 4)
        self.conv_module1 = ConvolutionModule(embed_dim, cnn_module_kernel, causal)
        self.conv_module2 = ConvolutionModule(embed_dim, cnn_module_kernel, causal)
        self.norm = BiasNorm(embed_dim)
        self.bypass = BypassModule(embed_dim)
        self.bypass_mid = BypassModule(embed_dim)

    def forward(self, src, pos_emb, chunk_size=-1, attn_mask=None,
                src_key_padding_mask=None):
        src_orig = src
        attn_weights = self.self_attn_weights(
            src, pos_emb, key_padding_mask=src_key_padding_mask, attn_mask=attn_mask
        )
        src = src + self.feed_forward1(src)
        selected_attn_weights = attn_weights[0:1]
        src = src + self.nonlin_attention(src, selected_attn_weights)
        src = src + self.self_attn1(src, attn_weights)
        src = src + self.conv_module1(
            src, src_key_padding_mask=src_key_padding_mask, chunk_size=chunk_size
        )
        src = src + self.feed_forward2(src)
        src = self.bypass_mid(src_orig, src)
        src = src + self.self_attn2(src, attn_weights)
        src = src + self.conv_module2(
            src, src_key_padding_mask=src_key_padding_mask, chunk_size=chunk_size
        )
        src = src + self.feed_forward3(src)
        src = self.norm(src)
        src = self.bypass(src_orig, src)
        return src


class Zipformer2Encoder(nn.Module):
    def __init__(self, layer_fn, num_layers: int, embed_dim: int, pos_dim: int):
        super().__init__()
        self.encoder_pos = CompactRelPositionalEncoding(pos_dim)
        self.layers = nn.ModuleList([layer_fn() for _ in range(num_layers)])

    def forward(self, src, chunk_size=-1, attn_mask=None, src_key_padding_mask=None):
        pos_emb = self.encoder_pos(src)
        for mod in self.layers:
            src = mod(src, pos_emb, chunk_size=chunk_size, attn_mask=attn_mask,
                      src_key_padding_mask=src_key_padding_mask)
        return src


class SimpleDownsample(nn.Module):
    def __init__(self, downsample: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(downsample))
        self.downsample = downsample

    def forward(self, src: Tensor) -> Tensor:
        # src: (time, batch, channels)
        (seq_len, batch_size, in_channels) = src.shape
        ds = self.downsample
        d_seq_len = (seq_len + ds - 1) // ds
        pad = d_seq_len * ds - seq_len
        if pad > 0:
            src_extra = src[src.shape[0] - 1 :].expand(pad, src.shape[1], src.shape[2])
            src = torch.cat((src, src_extra), dim=0)
        src = src.reshape(d_seq_len, ds, batch_size, in_channels)
        weights = self.bias.softmax(dim=0).unsqueeze(-1).unsqueeze(-1)
        return (src * weights).sum(dim=1)


class SimpleUpsample(nn.Module):
    def __init__(self, upsample: int):
        super().__init__()
        self.upsample = upsample

    def forward(self, src: Tensor) -> Tensor:
        (seq_len, batch_size, num_channels) = src.shape
        src = src.unsqueeze(1).expand(seq_len, self.upsample, batch_size, num_channels)
        return src.reshape(seq_len * self.upsample, batch_size, num_channels)


class DownsampledZipformer2Encoder(nn.Module):
    def __init__(self, encoder: Zipformer2Encoder, dim: int, downsample: int):
        super().__init__()
        self.downsample_factor = downsample
        self.downsample = SimpleDownsample(downsample)
        self.encoder = encoder
        self.upsample = SimpleUpsample(downsample)
        self.out_combiner = BypassModule(dim)

    def forward(self, src, chunk_size=-1, attn_mask=None, src_key_padding_mask=None):
        src_orig = src
        src = self.downsample(src)
        ds = self.downsample_factor
        if attn_mask is not None:
            attn_mask = attn_mask[::ds, ::ds]
        if src_key_padding_mask is not None:
            src_key_padding_mask = src_key_padding_mask[..., ::ds]
        src = self.encoder(
            src, chunk_size=chunk_size if chunk_size < 0 else chunk_size // ds,
            attn_mask=attn_mask, src_key_padding_mask=src_key_padding_mask,
        )
        src = self.upsample(src)
        src = src[: src_orig.shape[0]]
        return self.out_combiner(src_orig, src)


def convert_num_channels(x: Tensor, num_channels: int) -> Tensor:
    if num_channels <= x.shape[-1]:
        return x[..., :num_channels]
    shape = list(x.shape)
    shape[-1] = num_channels - shape[-1]
    zeros = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat((x, zeros), dim=-1)


class Zipformer2(nn.Module):
    """The `encoder` half of the export (encoder_embed lives beside it)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        encoders = []
        for si in range(len(cfg.num_encoder_layers)):
            def layer_fn(si=si):
                return Zipformer2EncoderLayer(
                    cfg.encoder_dims[si], cfg.pos_dim, cfg.num_heads[si],
                    cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim,
                    cfg.feedforward_dims[si], cfg.cnn_module_kernels[si], cfg.causal,
                )
            enc = Zipformer2Encoder(
                layer_fn, cfg.num_encoder_layers[si], cfg.encoder_dims[si], cfg.pos_dim
            )
            ds = cfg.downsampling_factors[si]
            if ds != 1:
                enc = DownsampledZipformer2Encoder(enc, cfg.encoder_dims[si], ds)
            encoders.append(enc)
        self.encoders = nn.ModuleList(encoders)
        self.downsample_output = SimpleDownsample(2)

    def forward(self, x: Tensor, x_lens: Tensor, chunk_size: int = -1,
                left_context_len: int = -1):
        # x: (time, batch, dims[0]) post-embed; x_lens: valid embed frames
        cfg = self.cfg
        t = x.shape[0]
        src_key_padding_mask = (
            torch.arange(t, device=x.device).unsqueeze(0) >= x_lens.unsqueeze(1)
        )  # (batch, time) True at pads
        attn_mask = None
        if chunk_size > 0:
            # block-causal mask with bounded left context (training-style
            # offline equivalent of the streamed graph)
            q = torch.arange(t, device=x.device).unsqueeze(1)
            s = torch.arange(t, device=x.device).unsqueeze(0)
            cs = (q // chunk_size) * chunk_size
            allowed = (s <= cs + chunk_size - 1) & (s >= cs - left_context_len)
            attn_mask = ~allowed
        outputs = []
        for si, module in enumerate(self.encoders):
            x = convert_num_channels(x, self.cfg.encoder_dims[si])
            x = module(x, chunk_size=chunk_size, attn_mask=attn_mask,
                       src_key_padding_mask=src_key_padding_mask)
            outputs.append(x)
        # _get_full_dim_output
        dims = cfg.encoder_dims
        num_encoders = len(dims)
        pieces = [outputs[-1]]
        cur_dim = dims[-1]
        for i in range(num_encoders - 2, -1, -1):
            d = dims[i]
            if d > cur_dim:
                pieces.append(outputs[i][..., cur_dim:d])
                cur_dim = d
        x = torch.cat(pieces, dim=-1)
        x = self.downsample_output(x)
        lens = (x_lens + 1) // 2
        return x, lens


class OracleModel(nn.Module):
    """encoder_embed + encoder, named as icefall's export serializes them."""

    def __init__(self, cfg):
        super().__init__()
        self.encoder_embed = Conv2dSubsampling(
            cfg.feature_dim, cfg.encoder_dims[0], *cfg.embed_channels
        )
        self.encoder = Zipformer2(cfg)

    @torch.no_grad()
    def forward(self, feats: Tensor, feat_lens: Tensor, chunk_size: int = -1,
                left_context_len: int = -1):
        # feats: (batch, T, 80) -> (batch, T', max_dim), out_lens
        x = self.encoder_embed(feats)
        x = x.permute(1, 0, 2)  # (time, batch, dim)
        x_lens = torch.clamp((feat_lens - 7) // 2, min=0)
        x, lens = self.encoder(x, x_lens, chunk_size, left_context_len)
        return x.permute(1, 0, 2), lens
