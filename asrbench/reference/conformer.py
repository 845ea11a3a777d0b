"""The benchmark's plain reference of the conformer encoder: icefall's
``pruned_transducer_stateless`` conformer (the classic espnet-derived
block of ``transducer_stateless/conformer.py``) at inference, in float32
PyTorch, with no kernel, cache or batching of the program under test.

A frozen copy of the repository's test oracle
(``tests/icefall_conformer_oracle.py``), changed only so that every tensor it
makes is made on its input's device.  It computes, keyed to the
icefall/espnet classes:

  * Conv2dSubsampling: two stride-2 VALID 3x3 convs + ReLU, the (C, F')
    flatten, Linear -> [B, ((T-1)//2-1)//2, D];
  * RelPositionalEncoding: ``x * sqrt(d_model)`` input scaling and the
    INTERLEAVED sin/cos table over DESCENDING relative positions
    S-1 .. -(T-1);
  * RelPositionMultiheadAttention: packed qkv ``in_proj``, ``linear_pos``
    (no bias), ``pos_bias_u``/``pos_bias_v``, scores
    ((q+u)·k + rel_shift((q+v)·p)) / sqrt(head_dim), key and query padding
    masked;
  * ConformerEncoderLayer (normalize_before=True): 0.5*macaron-FF (Swish),
    MHSA, conv module (pointwise to 2d + GLU -> depthwise -> BatchNorm ->
    Swish -> pointwise), 0.5*FF, norm_final.

Departures from icefall's module, each a matter of inference, not of value:
dropout is left out (identity at inference); BatchNorm runs in eval mode on
its running statistics (``asrbench/models/conformer.py`` sets them to
reproduce the system's folded scale and bias); padded frames are zeroed
after the GLU and after every layer (icefall's masked inference); the
encoder ends at the last layer's ``norm_final``, with the joiner's encoder
projection the model's only output projection (the system's stateless
transducer layout).  The causal mode (a left-padded depthwise conv and a
chunk-causal mask) is kept as the oracle has it; no cell runs it.
"""

import math

import torch
import torch.nn as nn
from torch import Tensor


class Swish(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        return x * torch.sigmoid(x)


class Conv2dSubsampling(nn.Module):
    """espnet Conv2dSubsampling: [B, T, F] -> [B, ((T-1)//2-1)//2, D]."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, odim, 3, 2),
            nn.ReLU(),
            nn.Conv2d(odim, odim, 3, 2),
            nn.ReLU(),
        )
        self.out = nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim)

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv(x.unsqueeze(1))  # [B, C, T', F']
        b, c, t, f = x.shape
        return self.out(x.transpose(1, 2).contiguous().view(b, t, c * f))


def rel_positional_encoding(t_q: int, s_kv: int, d_model: int, device=None) -> Tensor:
    """espnet RelPositionalEncoding table for relative positions
    r = s_kv-1 .. -(t_q-1) (descending), INTERLEAVED sin/cos:
    pe[:, 0::2] = sin(r * div), pe[:, 1::2] = cos(r * div)."""
    r = torch.arange(s_kv - 1, -t_q, -1, dtype=torch.float32, device=device)
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / d_model)
    )
    pe = torch.zeros(len(r), d_model, device=device)
    pe[:, 0::2] = torch.sin(r[:, None] * div[None, :])
    pe[:, 1::2] = torch.cos(r[:, None] * div[None, :])
    return pe


class RelPositionMultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, self.head_dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.uniform_(self.in_proj_bias, -0.1, 0.1)
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    @staticmethod
    def rel_shift(x: Tensor) -> Tensor:
        """[B, H, T, S+T-1] scores over descending rel positions -> aligned
        [B, H, T, S]: out[t, s] = x[t, (T-1) - t + s], i.e. icefall's
        as_strided rel_shift with storage_offset = n_stride * (time1 - 1)
        (pruned_transducer_stateless conformer.py)."""
        b, h, t, r = x.shape
        s = r - t + 1
        x = torch.nn.functional.pad(x, (0, 1))  # [B, H, T, R+1]
        flat = x.view(b, h, t * (r + 1))
        v = flat[:, :, t - 1 : t - 1 + t * r].view(b, h, t, r)
        return v[..., :s]

    def forward(self, x: Tensor, pos_emb: Tensor, mask: Tensor | None) -> Tensor:
        """Self-attention with q == full sequence.  mask: [T, S] or
        [B, T, S] bool, True = attend."""
        b, t, d = x.shape
        h, dh = self.num_heads, self.head_dim
        qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)
        q = q.view(b, t, h, dh)
        k = k.view(b, t, h, dh)
        v = v.view(b, t, h, dh)

        p = self.linear_pos(pos_emb).view(-1, h, dh)  # [R, H, dh]
        q_u = (q + self.pos_bias_u).permute(0, 2, 1, 3)  # [B, H, T, dh]
        q_v = (q + self.pos_bias_v).permute(0, 2, 1, 3)
        kt = k.permute(0, 2, 3, 1)  # [B, H, dh, S]
        matrix_ac = torch.matmul(q_u, kt)  # [B, H, T, S]
        matrix_bd = torch.matmul(q_v, p.permute(1, 2, 0).unsqueeze(0))  # [B,H,T,R]
        matrix_bd = self.rel_shift(matrix_bd)
        scores = (matrix_ac + matrix_bd) / math.sqrt(dh)
        if mask is not None:
            if mask.dim() == 2:
                mask = mask.unsqueeze(0)
            scores = scores.masked_fill(~mask.unsqueeze(1), float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, v.permute(0, 2, 1, 3))  # [B, H, T, dh]
        ctx = ctx.permute(0, 2, 1, 3).contiguous().view(b, t, d)
        return self.out_proj(ctx)


class ConvolutionModule(nn.Module):
    def __init__(self, d_model: int, kernel: int, causal: bool):
        super().__init__()
        self.kernel = kernel
        self.causal = causal
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(
            d_model, d_model, kernel,
            padding=0 if causal else (kernel - 1) // 2, groups=d_model,
        )
        self.norm = nn.BatchNorm1d(d_model)
        self.activation = Swish()
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)

    def forward(self, x: Tensor, pad_mask: Tensor | None = None) -> Tensor:
        """pad_mask: [B, T] bool, True = valid — padded positions are zeroed
        after the GLU (icefall's masked_fill) so they can't bleed into valid
        frames through the depthwise receptive field."""
        x = x.transpose(1, 2)  # [B, D, T]
        x = nn.functional.glu(self.pointwise_conv1(x), dim=1)
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[:, None, :], 0.0)
        if self.causal:
            x = nn.functional.pad(x, (self.kernel - 1, 0))
        x = self.depthwise_conv(x)
        x = self.activation(self.norm(x))
        return self.pointwise_conv2(x).transpose(1, 2)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_dim: int, kernel: int,
                 causal: bool):
        super().__init__()
        self.self_attn = RelPositionMultiheadAttention(d_model, num_heads)
        self.feed_forward = nn.Sequential(
            nn.Linear(d_model, ff_dim), Swish(), nn.Identity(),
            nn.Linear(ff_dim, d_model),
        )
        self.feed_forward_macaron = nn.Sequential(
            nn.Linear(d_model, ff_dim), Swish(), nn.Identity(),
            nn.Linear(ff_dim, d_model),
        )
        self.conv_module = ConvolutionModule(d_model, kernel, causal)
        self.norm_ff = nn.LayerNorm(d_model)
        self.norm_mha = nn.LayerNorm(d_model)
        self.norm_ff_macaron = nn.LayerNorm(d_model)
        self.norm_conv = nn.LayerNorm(d_model)
        self.norm_final = nn.LayerNorm(d_model)
        self.ff_scale = 0.5

    def forward(self, x: Tensor, pos_emb: Tensor, mask: Tensor | None,
                pad_mask: Tensor | None = None) -> Tensor:
        x = x + self.ff_scale * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = x + self.ff_scale * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class OracleConformer(nn.Module):
    """Module tree named as the export serializes it: ``encoder_embed.*``,
    ``encoder.layers.N.*``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.d_model = cfg.d_model
        self.encoder_embed = Conv2dSubsampling(cfg.feature_dim, cfg.d_model)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            ConformerEncoderLayer(
                cfg.d_model, cfg.num_heads, cfg.ff_dim, cfg.cnn_kernel, cfg.causal
            )
            for _ in range(cfg.num_layers)
        )

    def chunk_causal_mask(self, t: int, device=None) -> Tensor:
        q = torch.arange(t, device=device)[:, None]
        s = torch.arange(t, device=device)[None, :]
        chunk_start = (q // self.cfg.chunk_size) * self.cfg.chunk_size
        chunk_end = chunk_start + self.cfg.chunk_size - 1
        return (s <= chunk_end) & (s >= chunk_start - self.cfg.left_context)

    @torch.no_grad()
    def forward(self, x: Tensor, x_lens: Tensor):
        """[B, T, F] -> ([B, T', D], out_lens).  Padded positions are zeroed
        per block (matching masked inference)."""
        dev = x.device
        h = self.encoder_embed(x)
        t = h.shape[1]
        # espnet RelPositionalEncoding: scale the embedding, build the table
        h = h * math.sqrt(self.d_model)
        pos_emb = rel_positional_encoding(t, t, self.d_model, dev)
        out_lens = torch.div(
            torch.div(x_lens - 1, 2, rounding_mode="floor") - 1, 2,
            rounding_mode="floor",
        )
        valid = torch.arange(t, device=dev)[None, :] < out_lens[:, None]  # [B, T']
        mask = valid[:, None, :] & valid[:, :, None]
        if self.cfg.causal:
            mask = mask & self.chunk_causal_mask(t, dev)[None]
        for layer in self.encoder.layers:
            h = layer(h, pos_emb, mask, pad_mask=valid)
            # zero padded block outputs (masked inference convention)
            h = torch.where(valid[:, :, None], h, torch.zeros((), device=dev))
        return h, out_lens
