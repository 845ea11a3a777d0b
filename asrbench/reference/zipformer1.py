"""The benchmark's plain reference of the zipformer v1 encoder: icefall's
``pruned_transducer_stateless7`` Zipformer at inference, and the
chunk-causal forward of its ``_streaming`` variant, in float32 PyTorch, with
no kernel, cache or batching of the program under test.

A frozen copy of the repository's test oracle
(``tests/icefall_zipformer1_oracle.py``), reconstructed from the public
icefall source with the module tree named as the export serializes it.
Its departures from that oracle:

  * every tensor it makes at run time is made on its input's device;
  * the U-Net skip topology comes from ``skip_sources`` here (the oracle
    asks the program's config for it), the same rule.

Its departures from icefall, both the oracle's: the training-only modules
(ActivationBalancer, Whiten, dropout, feature masking) are left out, being
identity at inference and holding no parameters; ScaledLinear and
ScaledConv are plain Linear and Conv (they differ only in their init).

Covered, keyed to icefall's classes:

  * Conv2dSubsampling (three 3x3 convs with DoubleSwish, time VALID,
    receptive field 7, stride 2; channel-major flatten; Linear; BasicNorm
    with a fixed eps);
  * ZipformerEncoderLayer: ff1 -> pooling -> self_attn -> conv1 -> ff2 ->
    self_attn.forward2 (the same attention weights, a second value path) ->
    conv2 -> ff3 -> norm_final (BasicNorm) -> scalar bypass;
  * RelPositionMultiheadAttention: ``in_proj`` packs [q | k | v | pos_q],
    no run-time 1/sqrt(d), Transformer-XL sinusoidal positions of d_model
    through ``linear_pos``, the rel-shift as a gather;
  * PoolingModule: the masked global mean offline, the cumulative mean
    when causal;
  * ConvolutionModule: pointwise, GLU, depthwise (centred, or causal with a
    left pad), DoubleSwish, pointwise;
  * AttentionDownsample (softmax-weighted windows, the tail repeating the
    last frame), SimpleUpsample (a learned bias per phase), SimpleCombiner,
    DownsampledZipformerEncoder, the U-Net skips and the final x2
    downsample with lengths (x + 1) // 2;
  * the chunk-causal mask of the ``_streaming`` variant (``chunk_size``,
    ``left_context_len`` at the embed's rate, taken ``[::ds, ::ds]`` in each
    downsampled stack), under which the whole-utterance forward equals
    chunked streaming with caches (icefall's simulated streaming).

``oracle_state`` of ``asrbench/models/zipformer.py`` fills ``state_dict()``
from the benchmark's weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch import Tensor


def skip_sources(downsampling_factors) -> tuple:
    """Per stack, the stack whose output its U-Net skip combines in (None
    for the first two): icefall ``Zipformer.__init__``'s ``skip_layers``
    rule, the nearest earlier stack but one whose factor is no larger."""
    z = tuple(downsampling_factors)
    out = [None, None]
    for i in range(2, len(z)):
        out.append(next((j for j in range(i - 2, -1, -1) if z[j] <= z[i]), 0))
    return tuple(out[: len(z)])


class DoubleSwish(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        return x * torch.sigmoid(x - 1.0)


class BasicNorm(nn.Module):
    def __init__(self, num_channels: int, eps: float = 0.25, learn_eps: bool = True):
        super().__init__()
        if learn_eps:
            self.eps = nn.Parameter(torch.tensor(eps).log().detach())
        else:
            self.register_buffer("eps", torch.tensor(eps).log().detach())

    def forward(self, x: Tensor) -> Tensor:
        scales = (torch.mean(x**2, dim=-1, keepdim=True) + self.eps.exp()) ** -0.5
        return x * scales


class Conv2dSubsampling(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layer1_channels=8,
                 layer2_channels=32, layer3_channels=128):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, layer1_channels, kernel_size=3, padding=(0, 1)),
            DoubleSwish(),
            nn.Conv2d(layer1_channels, layer2_channels, kernel_size=3, stride=2),
            DoubleSwish(),
            nn.Conv2d(layer2_channels, layer3_channels, kernel_size=3, stride=(1, 2)),
            DoubleSwish(),
        )
        out_width = (((in_channels - 1) // 2) - 1) // 2
        self.out = nn.Linear(out_width * layer3_channels, out_channels)
        self.out_norm = BasicNorm(out_channels, learn_eps=False)

    def forward(self, x: Tensor) -> Tensor:  # (N, T, idim) -> (N, (T-7)//2, D)
        x = x.unsqueeze(1)
        x = self.conv(x)
        b, c, t, f = x.size()
        x = x.transpose(1, 2).reshape(b, t, c * f)
        x = self.out(x)
        return self.out_norm(x)


class RelPositionalEncoding(nn.Module):
    """Transformer-XL / espnet sinusoidal pe over relative positions
    T-1 .. -(T-1) (positive part flipped, then negatives), dim d_model."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, seq_len: int, device=None) -> Tensor:  # (1, 2T-1, d_model)
        pos = torch.arange(0, seq_len, dtype=torch.float32, device=device).unsqueeze(1)
        div = torch.exp(
            torch.arange(0, self.d_model, 2, dtype=torch.float32, device=device)
            * -(math.log(10000.0) / self.d_model)
        )
        pe_pos = torch.zeros(seq_len, self.d_model, device=device)
        pe_neg = torch.zeros(seq_len, self.d_model, device=device)
        pe_pos[:, 0::2] = torch.sin(pos * div)
        pe_pos[:, 1::2] = torch.cos(pos * div)
        pe_neg[:, 0::2] = torch.sin(-1 * pos * div)
        pe_neg[:, 1::2] = torch.cos(-1 * pos * div)
        pe_pos = torch.flip(pe_pos, [0]).unsqueeze(0)
        pe_neg = pe_neg[1:].unsqueeze(0)
        return torch.cat([pe_pos, pe_neg], dim=1)


class RelPositionMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, attention_dim: int, num_heads: int,
                 pos_dim: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.attention_dim = attention_dim
        self.num_heads = num_heads
        self.pos_dim = pos_dim
        self.head_dim = attention_dim // num_heads
        in_proj_dim = 2 * attention_dim + attention_dim // 2 + pos_dim * num_heads
        self.in_proj = nn.Linear(embed_dim, in_proj_dim, bias=True)
        self.in_proj2 = nn.Linear(embed_dim, attention_dim // 2, bias=False)
        self.out_proj = nn.Linear(attention_dim // 2, embed_dim, bias=True)
        self.out_proj2 = nn.Linear(attention_dim // 2, embed_dim, bias=True)
        self.linear_pos = nn.Linear(embed_dim, num_heads * pos_dim, bias=False)

    @staticmethod
    def _rel_shift(pos_scores: Tensor, seq_len: int) -> Tensor:
        """(B, H, T, 2T-1) -> (B, H, T, T): out[t, s] takes relative index
        (T-1) - t + s — icefall's as_strided skew."""
        (b, h, t, n) = pos_scores.shape
        rows = torch.arange(t - 1, -1, -1, device=pos_scores.device).unsqueeze(-1)
        cols = torch.arange(seq_len, device=pos_scores.device).unsqueeze(0)
        idx = (rows + cols).unsqueeze(0).unsqueeze(0).expand(b, h, t, seq_len)
        return torch.gather(pos_scores, 3, idx)

    def forward(self, x: Tensor, pos_emb: Tensor, attn_mask=None,
                key_padding_mask=None):
        # x: (T, B, C).  Returns (out (T,B,C), attn_weights (B*H, T, T)).
        seq_len, bsz, _ = x.shape
        adim, heads, hd, pd = (self.attention_dim, self.num_heads,
                               self.head_dim, self.pos_dim)
        x_proj = self.in_proj(x)
        q = x_proj[..., 0:adim]
        k = x_proj[..., adim : 2 * adim]
        value_dim = adim // 2
        v = x_proj[..., 2 * adim : 2 * adim + value_dim]
        p = x_proj[..., 2 * adim + value_dim :]

        q = q.reshape(seq_len, bsz, heads, hd).permute(1, 2, 0, 3)
        p = p.reshape(seq_len, bsz, heads, pd).permute(1, 2, 0, 3)
        k = k.reshape(seq_len, bsz, heads, hd).permute(1, 2, 3, 0)
        # NO scaling here: folded into ScaledLinear's initial_scale at init.
        attn_scores = torch.matmul(q, k)  # (B, H, T, T)

        pos = self.linear_pos(pos_emb).reshape(1, -1, heads, pd).permute(0, 2, 3, 1)
        pos_scores = torch.matmul(p, pos)  # (B, H, T, 2T-1)
        attn_scores = attn_scores + self._rel_shift(pos_scores, seq_len)

        if attn_mask is not None:  # (T, T) bool, True = masked
            attn_scores = attn_scores.masked_fill(attn_mask, float("-inf"))
        if key_padding_mask is not None:  # (B, T) bool, True = pad
            attn_scores = attn_scores.masked_fill(
                key_padding_mask.unsqueeze(1).unsqueeze(2), float("-inf")
            )
        attn_weights = attn_scores.softmax(dim=-1)
        attn_weights = attn_weights.reshape(bsz * heads, seq_len, seq_len)

        v = v.reshape(seq_len, bsz * heads, value_dim // heads).transpose(0, 1)
        out = torch.bmm(attn_weights, v)  # (B*H, T, vd/head)
        out = out.transpose(0, 1).contiguous().reshape(seq_len, bsz, value_dim)
        return self.out_proj(out), attn_weights

    def forward2(self, x: Tensor, attn_weights: Tensor) -> Tensor:
        seq_len, bsz, _ = x.shape
        heads = self.num_heads
        value_dim = self.attention_dim // 2
        v = self.in_proj2(x)
        v = v.reshape(seq_len, bsz * heads, value_dim // heads).transpose(0, 1)
        out = torch.bmm(attn_weights, v)
        out = out.transpose(0, 1).contiguous().reshape(seq_len, bsz, value_dim)
        return self.out_proj2(out)


class PoolingModule(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.proj = nn.Linear(d_model, d_model, bias=False)

    def forward(self, x: Tensor, key_padding_mask=None, causal: bool = False):
        # x: (T, B, C)
        if causal:
            # _streaming variant: cumulative mean over frames <= t
            counts = torch.arange(1, x.shape[0] + 1, dtype=x.dtype,
                                  device=x.device).reshape(-1, 1, 1)
            mean = x.cumsum(dim=0) / counts
            return self.proj(mean)
        if key_padding_mask is not None:
            w = (~key_padding_mask).to(x.dtype)  # (B, T)
            w = w / w.sum(dim=1, keepdim=True)
            mean = (x * w.t().unsqueeze(-1)).sum(dim=0, keepdim=True)
        else:
            mean = x.mean(dim=0, keepdim=True)
        return self.proj(mean)  # (1, B, C), broadcast-added by caller


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int, causal: bool):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        pad = 0 if causal else (kernel_size - 1) // 2
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, padding=pad, groups=channels
        )
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)
        self.activation = DoubleSwish()
        self.causal = causal
        self.kernel_size = kernel_size

    def forward(self, x: Tensor, src_key_padding_mask=None) -> Tensor:
        # x: (T, B, C)
        x = x.permute(1, 2, 0)  # (B, C, T)
        x = self.pointwise_conv1(x)
        x = nn.functional.glu(x, dim=1)
        if src_key_padding_mask is not None:
            x = x.masked_fill(src_key_padding_mask.unsqueeze(1), 0.0)
        if self.causal:
            x = nn.functional.pad(x, (self.kernel_size - 1, 0))
        x = self.depthwise_conv(x)
        x = self.activation(x)
        x = self.pointwise_conv2(x)
        return x.permute(2, 0, 1)


class FeedforwardModule(nn.Module):
    def __init__(self, d_model: int, feedforward_dim: int):
        super().__init__()
        self.in_proj = nn.Linear(d_model, feedforward_dim)
        self.activation = DoubleSwish()
        self.out_proj = nn.Linear(feedforward_dim, d_model)

    def forward(self, x: Tensor) -> Tensor:
        return self.out_proj(self.activation(self.in_proj(x)))


class ZipformerEncoderLayer(nn.Module):
    def __init__(self, d_model, attention_dim, nhead, feedforward_dim,
                 cnn_module_kernel, pos_dim, causal):
        super().__init__()
        self.self_attn = RelPositionMultiheadAttention(
            d_model, attention_dim, nhead, pos_dim
        )
        self.pooling = PoolingModule(d_model)
        self.feed_forward1 = FeedforwardModule(d_model, feedforward_dim)
        self.feed_forward2 = FeedforwardModule(d_model, feedforward_dim)
        self.feed_forward3 = FeedforwardModule(d_model, feedforward_dim)
        self.conv_module1 = ConvolutionModule(d_model, cnn_module_kernel, causal)
        self.conv_module2 = ConvolutionModule(d_model, cnn_module_kernel, causal)
        self.norm_final = BasicNorm(d_model)
        self.bypass_scale = nn.Parameter(torch.tensor(0.5))
        self.causal = causal

    def forward(self, src, pos_emb, attn_mask=None, src_key_padding_mask=None):
        src_orig = src
        src = src + self.feed_forward1(src)
        src = src + self.pooling(
            src, key_padding_mask=src_key_padding_mask, causal=self.causal
        )
        src_att, attn_weights = self.self_attn(
            src, pos_emb, attn_mask=attn_mask, key_padding_mask=src_key_padding_mask
        )
        src = src + src_att
        src = src + self.conv_module1(src, src_key_padding_mask=src_key_padding_mask)
        src = src + self.feed_forward2(src)
        src = src + self.self_attn.forward2(src, attn_weights)
        src = src + self.conv_module2(src, src_key_padding_mask=src_key_padding_mask)
        src = src + self.feed_forward3(src)
        src = self.norm_final(src)
        return src_orig + (src - src_orig) * self.bypass_scale


class ZipformerEncoder(nn.Module):
    def __init__(self, layer_fn, num_layers: int, d_model: int):
        super().__init__()
        self.encoder_pos = RelPositionalEncoding(d_model)
        self.layers = nn.ModuleList([layer_fn() for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, src_key_padding_mask=None):
        pos_emb = self.encoder_pos(src.shape[0], src.device)
        for mod in self.layers:
            src = mod(src, pos_emb, attn_mask=attn_mask,
                      src_key_padding_mask=src_key_padding_mask)
        return src


class AttentionDownsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, downsample: int):
        super().__init__()
        self.query = nn.Parameter(torch.randn(in_channels) * (in_channels**-0.5))
        if in_channels != out_channels:
            self.extra_proj = nn.Linear(
                in_channels * downsample, out_channels - in_channels, bias=False
            )
        else:
            self.extra_proj = None
        self.downsample = downsample

    def forward(self, src: Tensor) -> Tensor:
        # src: (T, B, C) -> (ceil(T/ds), B, C_out)
        (seq_len, batch_size, in_channels) = src.shape
        ds = self.downsample
        d_seq_len = (seq_len + ds - 1) // ds
        pad = d_seq_len * ds - seq_len
        if pad > 0:
            src_extra = src[-1:].expand(pad, batch_size, in_channels)
            src = torch.cat((src, src_extra), dim=0)
        src = src.reshape(d_seq_len, ds, batch_size, in_channels)
        scores = (src * self.query).sum(dim=-1, keepdim=True)
        weights = scores.softmax(dim=1)
        ans = (src * weights).sum(dim=1)
        src = src.permute(0, 2, 1, 3).reshape(d_seq_len, batch_size, ds * in_channels)
        if self.extra_proj is not None:
            ans = torch.cat((ans, self.extra_proj(src)), dim=2)
        return ans


class SimpleUpsample(nn.Module):
    def __init__(self, num_channels: int, upsample: int):
        super().__init__()
        self.bias = nn.Parameter(torch.randn(upsample, num_channels) * 0.01)

    def forward(self, src: Tensor) -> Tensor:
        (seq_len, batch_size, num_channels) = src.shape
        upsample = self.bias.shape[0]
        src = src.unsqueeze(1).expand(seq_len, upsample, batch_size, num_channels)
        src = src + self.bias.unsqueeze(1)
        return src.reshape(seq_len * upsample, batch_size, num_channels)


class SimpleCombiner(nn.Module):
    def __init__(self, dim1: int, dim2: int):
        super().__init__()
        self.weight1 = nn.Parameter(torch.zeros(()))

    def forward(self, src1: Tensor, src2: Tensor) -> Tensor:
        src1 = src1 * self.weight1
        src2 = src2 * (1.0 - self.weight1)
        d1, d2 = src1.shape[-1], src2.shape[-1]
        if d1 < d2:
            src1 = nn.functional.pad(src1, (0, d2 - d1))
        elif d1 > d2:
            src1 = src1[..., :d2]
        return src1 + src2


class SimpleCombinerIdentity(nn.Module):
    def forward(self, src1: Tensor, src2: Tensor) -> Tensor:
        return src2


class DownsampledZipformerEncoder(nn.Module):
    def __init__(self, encoder, input_dim: int, output_dim: int, downsample: int):
        super().__init__()
        self.downsample_factor = downsample
        self.downsample = AttentionDownsample(input_dim, output_dim, downsample)
        self.encoder = encoder
        self.upsample = SimpleUpsample(output_dim, downsample)
        self.out_combiner = SimpleCombiner(input_dim, output_dim)

    def forward(self, src, attn_mask=None, src_key_padding_mask=None):
        src_orig = src
        src = self.downsample(src)
        ds = self.downsample_factor
        if attn_mask is not None:
            attn_mask = attn_mask[::ds, ::ds]
        src = self.encoder(
            src, attn_mask=attn_mask, src_key_padding_mask=src_key_padding_mask
        )
        src = self.upsample(src)
        src = src[: src_orig.shape[0]]
        return self.out_combiner(src_orig, src)


class Zipformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        z = cfg.downsampling_factors
        encoders = []
        for si in range(len(cfg.num_encoder_layers)):
            def layer_fn(si=si):
                return ZipformerEncoderLayer(
                    cfg.encoder_dims[si], cfg.attention_dims[si], cfg.num_heads[si],
                    cfg.feedforward_dims[si], cfg.cnn_module_kernels[si],
                    cfg.pos_dim, cfg.causal,
                )
            enc = ZipformerEncoder(
                layer_fn, cfg.num_encoder_layers[si], cfg.encoder_dims[si]
            )
            if z[si] != 1:
                enc = DownsampledZipformerEncoder(
                    enc,
                    input_dim=cfg.encoder_dims[si - 1] if si > 0 else cfg.encoder_dims[0],
                    output_dim=cfg.encoder_dims[si],
                    downsample=z[si],
                )
            encoders.append(enc)
        self.encoders = nn.ModuleList(encoders)
        # U-Net skips (Zipformer.__init__'s skip_layers rule)
        self.skip_layers = list(skip_sources(cfg.downsampling_factors))
        self.skip_modules = nn.ModuleList(
            [
                SimpleCombinerIdentity() if j is None
                else SimpleCombiner(cfg.encoder_dims[j], cfg.encoder_dims[i - 1])
                for i, j in enumerate(self.skip_layers)
            ]
        )
        self.downsample_output = AttentionDownsample(
            cfg.encoder_dims[-1], cfg.encoder_dims[-1],
            cfg.output_downsampling_factor,
        )

    def forward(self, x: Tensor, x_lens: Tensor, chunk_size: int = -1,
                left_context_len: int = -1):
        # x: (T, B, C) post-embed; x_lens: valid embed frames
        cfg = self.cfg
        t = x.shape[0]
        key_padding_mask = (torch.arange(t, device=x.device).unsqueeze(0)
                            >= x_lens.unsqueeze(1))
        attn_mask = None
        if chunk_size > 0:
            q = torch.arange(t, device=x.device).unsqueeze(1)
            s = torch.arange(t, device=x.device).unsqueeze(0)
            cs = (q // chunk_size) * chunk_size
            allowed = (s <= cs + chunk_size - 1) & (s >= cs - left_context_len)
            attn_mask = ~allowed
        if cfg.causal:
            key_padding_mask = None  # streamed graph sees its whole window
        outputs = []
        for i, (module, skip_module) in enumerate(zip(self.encoders, self.skip_modules)):
            ds = cfg.downsampling_factors[i]
            k = self.skip_layers[i]
            if k is not None:
                x = skip_module(outputs[k], x)
            x = module(
                x,
                attn_mask=attn_mask,
                src_key_padding_mask=None if key_padding_mask is None
                else key_padding_mask[..., ::ds],
            )
            outputs.append(x)
        x = self.downsample_output(x)
        lens = (x_lens + 1) // cfg.output_downsampling_factor
        return x, lens


class OracleModel(nn.Module):
    """encoder_embed + encoder, named as icefall's export serializes them."""

    def __init__(self, cfg):
        super().__init__()
        self.encoder_embed = Conv2dSubsampling(
            cfg.feature_dim, cfg.encoder_dims[0], *cfg.embed_channels
        )
        self.encoder = Zipformer(cfg)

    @torch.no_grad()
    def forward(self, feats: Tensor, feat_lens: Tensor, chunk_size: int = -1,
                left_context_len: int = -1):
        # feats: (B, T, 80) -> (B, T', D_last), out_lens
        x = self.encoder_embed(feats)
        x = x.permute(1, 0, 2)
        x_lens = torch.clamp((feat_lens - 7) // 2, min=0)
        x, lens = self.encoder(x, x_lens, chunk_size, left_context_len)
        return x.permute(1, 0, 2), lens
