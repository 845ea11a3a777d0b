"""LSTM transducer encoder (icefall lstm_transducer family), offline and
streaming — PyTorch port of ``k2transducerasr_tpu/models/lstm.py``.

Conformer's Conv2dSubsampling, then N layers of [LSTM with projection ->
residual -> feedforward (DoubleSwish) -> residual -> LayerNorm].  LSTMs are
causal, so offline and streaming are the same program over different
windows; padding frames run through the recurrence as in the reference (no
packed sequences) and only follow the valid ones.

The reference's recurrence is a ``lax.scan`` (an XLA loop, no TPU kernel).
Here it is PyTorch's own LSTM with projections, called in its functional
form (``torch._VF.lstm``) on weights built once when the encoder is made —
cuDNN on the card, ATen's loop on the CPU.  PyTorch's gate order is the
reference's (i, f, g, o), and the weights map as ``weight_ih = wx.T``,
``weight_hh = wh.T``, ``weight_hr = wp.T``, ``bias_ih = b``, ``bias_hh =
0``.  On the card each layer's five weights are views into one flat cuDNN
buffer (``torch._cudnn_rnn_flatten_weight``), so no call compacts them.
Nothing here draws from the global torch RNG.

Precision.  ``h`` and ``c`` are float32, as in the reference, and the LSTM's
output is float32: the residual stream becomes float32 after the first
layer (bf16 + float32 promotes), as there.  Under ``compute_dtype`` bf16 the
recurrence runs in float32 on bf16-rounded weights and a bf16-rounded
input, where the reference also rounds the input gates after the bias add
and ``h`` before each recurrent product (the port keeps them float32, or
TF32 on the card's tensor cores): a bf16 encoder differs from the
reference's by a few bf16 ulps, as the tests state.  ``compute_dtype=None``
on the card runs cuDNN in true float32 inside ``exact_f32()``
(``torch.backends.cudnn.allow_tf32`` off also covers its RNNs).

Streaming state, batch-leading: ``h [B, L, d_model]`` (projected hidden)
and ``c [B, L, rnn_hidden_size]`` (cell), float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from k2transducerasr_tpu_torch.models.conformer import subsample
from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.parallel.sharding import whole
from k2transducerasr_tpu_torch.runtime.checkpoint import ParamTree


@dataclasses.dataclass(frozen=True)
class LstmConfig:
    feature_dim: int = 80
    d_model: int = 512
    rnn_hidden_size: int = 1024
    num_layers: int = 12
    ff_dim: int = 2048
    chunk_size: int = 16  # subsampled frames per streaming step

    def subsampled_len(self, t: int) -> int:
        return ((t - 1) // 2 - 1) // 2

    @property
    def decode_chunk_len(self) -> int:
        """Raw feature frames a streaming window advances by."""
        return 4 * self.chunk_size

    @property
    def chunk_input_len(self) -> int:
        """Raw feature frames per streaming window (the subsampling's
        receptive field over ``chunk_size`` outputs)."""
        return 4 * self.chunk_size + 3


Config = LstmConfig


def output_dim(cfg: LstmConfig) -> int:
    return cfg.d_model


def output_chunk_len(cfg: LstmConfig) -> int:
    return cfg.chunk_size


def init_params(rng: np.random.Generator, cfg: LstmConfig) -> dict:
    """numpy tree with the reference ``init_params``' structure, shapes and
    scales (other values: another generator)."""
    d, hid, freq_out = cfg.d_model, cfg.rnn_hidden_size, ((cfg.feature_dim - 1) // 2 - 1) // 2
    scale = 1.0 / math.sqrt(hid)

    def u(*shape):
        return rng.uniform(-scale, scale, size=shape).astype(np.float32)

    sub = {"conv1": L.init_conv2d(rng, 1, d, (3, 3)), "conv2": L.init_conv2d(rng, d, d, (3, 3)),
           "out": L.init_linear(rng, d * freq_out, d)}
    layers = [{"lstm": {"wx": u(d, 4 * hid), "wh": u(d, 4 * hid),
                        "b": np.zeros((4 * hid,), np.float32), "wp": u(hid, d)},
               "ff": {"w1": L.init_linear(rng, d, cfg.ff_dim),
                      "w2": L.init_linear(rng, cfg.ff_dim, d)},
               "norm_final": L.init_layernorm(d)}
              for _ in range(cfg.num_layers)]
    return {"subsample": sub, "layers": layers}


def _rnn_weights(p, round_to=None) -> list:
    """One layer's [weight_ih, weight_hh, bias_ih, bias_hh, weight_hr] in
    PyTorch's layout, float32 (``round_to``: the matrices rounded to that
    dtype first), as views into one flat cuDNN buffer on the card.  A
    model-sharded matrix is gathered whole: each rank holds the whole
    recurrence."""
    mats = [whole(p[k]) for k in ("wx", "wh", "wp")]
    mats = [m if round_to is None else m.to(round_to).float() for m in mats]
    wx, wh, wp = (m.t().contiguous() for m in mats)
    weights = [wx, wh, p["b"].clone(), torch.zeros_like(p["b"]), wp]
    if wx.is_cuda:
        from torch.backends.cudnn import rnn

        # copies the five into one buffer and makes each a view of it
        torch._cudnn_rnn_flatten_weight(weights, 5, wx.shape[1], rnn.get_cudnn_mode("LSTM"),
                                        wp.shape[1], wp.shape[0], 1, True, False)
    return weights


def _lstm_layer(weights, x, h0, c0):
    """x: [B, T, D] float32 -> (out [B, T, proj], h_T [B, proj], c_T [B, H])."""
    out, h_t, c_t = torch._VF.lstm(x, (h0[None].contiguous(), c0[None].contiguous()), weights,
                                   True, 1, 0.0, False, False, True)
    return out, h_t[0], c_t[0]


def _encode(params, cfg: LstmConfig, h, state, compute_dtype=None):
    """All layers over the subsampled input h [B, T', D], with each layer's
    (h0, c0) carried in and out.  ``params``: the ``Lstm`` encoder (its
    recurrent weights are built when it is made)."""
    weights = params.rnn_weights(compute_dtype)
    new_h, new_c = [], []
    for i, layer in enumerate(params["layers"]):
        x = h.float() if compute_dtype is None else h.to(compute_dtype).float()
        out, h_t, c_t = _lstm_layer(weights[i], x, state["h"][:, i], state["c"][:, i])
        new_h.append(h_t)
        new_c.append(c_t)
        h = h + out
        ff = layer["ff"]
        ffh = L.double_swish(L.apply_linear(ff["w1"], h, compute_dtype))
        h = h + L.apply_linear(ff["w2"], ffh, compute_dtype)
        h = L.apply_layernorm(layer["norm_final"], h)
    return h, {"h": torch.stack(new_h, dim=1), "c": torch.stack(new_c, dim=1)}


def init_state(cfg: LstmConfig, batch: int, device="cpu") -> dict:
    """Zero streaming state: ``h [B, L, d_model]``, ``c [B, L, H]``, float32."""
    return {
        "h": torch.zeros((batch, cfg.num_layers, cfg.d_model), dtype=torch.float32,
                         device=device),
        "c": torch.zeros((batch, cfg.num_layers, cfg.rnn_hidden_size), dtype=torch.float32,
                         device=device),
    }


def forward(params, cfg: LstmConfig, x, x_lens, compute_dtype=None):
    """x: [B, T, F]; x_lens: [B] -> (enc_out [B, T', D] float32, out_lens)."""
    h = subsample(params["subsample"], cfg, x, compute_dtype)
    out_lens = ((x_lens - 1) // 2 - 1) // 2
    h, _ = _encode(params, cfg, h, init_state(cfg, x.shape[0], x.device), compute_dtype)
    valid = L.length_mask(out_lens, h.shape[1])
    return torch.where(valid[:, :, None], h, 0.0), out_lens


def streaming_step(params, cfg: LstmConfig, state: dict, x_chunk, compute_dtype=None):
    """x_chunk: [B, chunk_input_len, F] -> (enc_out [B, chunk, D], new_state)."""
    h = subsample(params["subsample"], cfg, x_chunk, compute_dtype)
    return _encode(params, cfg, h, state, compute_dtype)


class Lstm(ParamTree):
    """The encoder's parameters as an ``nn.Module`` (``state_dict`` keys are
    the reference's dotted paths), with the recurrent weights in PyTorch's
    layout built once: float32, and bf16-rounded for a bf16 compute dtype.
    cuDNN's projection needs ``d_model < rnn_hidden_size``; any other
    config raises ``ValueError``."""

    def __init__(self, cfg: LstmConfig, tree: dict, device="cpu"):
        if not cfg.d_model < cfg.rnn_hidden_size:
            raise ValueError(f"LSTM projection needs d_model < rnn_hidden_size, got "
                             f"{cfg.d_model} >= {cfg.rnn_hidden_size}")
        super().__init__(tree, device)
        self.cfg = cfg
        with torch.no_grad():
            self._rnn = {dt: [_rnn_weights(layer["lstm"], dt) for layer in self.layers]
                         for dt in (None, torch.bfloat16)}

    def rnn_weights(self, compute_dtype=None) -> list:
        """Per layer, the five weights of ``torch._VF.lstm`` for
        ``compute_dtype`` (None or bf16)."""
        if compute_dtype not in self._rnn:
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        return self._rnn[compute_dtype]

    def forward(self, x, x_lens, compute_dtype=None):
        return forward(self, self.cfg, x, x_lens, compute_dtype)

    def init_state(self, batch: int) -> dict:
        return init_state(self.cfg, batch, self.subsample["conv1"]["w"].device)

    def streaming_step(self, state: dict, x_chunk, compute_dtype=None):
        return streaming_step(self, self.cfg, state, x_chunk, compute_dtype)


Encoder = Lstm
