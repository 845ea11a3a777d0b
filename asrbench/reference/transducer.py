"""The plain reference of a transducer: the encoder of the configuration's
model type (``asrbench/models/<model_type>.py``, found by name) and a
stateless RNN-T decoder and joiner in float32 PyTorch, loaded from the
benchmark's weights, with the greedy search that calibrates the emission
density.  How served tokens are judged against it is the decoding method's
(``asrbench/decoding/<decoding_method>.py``).

Semantics (icefall's, as the system under test states them): blank = 0,
sos/eos = 1, unk = 2; the decoder's context starts as ``context_size``
blanks (icefall starts with -1s, which embed as zeros: the system embeds
blanks, and so does this).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from asrbench.core import spec

BLANK, SOS, UNK = 0, 1, 2


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the tensor (its largest
    magnitude at the type's largest finite value), back in float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return ((x / scale).to(dtype).float() * scale).to(x.dtype)


class LowerPrecision(torch.overrides.TorchFunctionMode):
    """While active, every product (matmul, linear, convolution) takes its
    two operands rounded to ``dtype`` (per-tensor scales) and accumulates in
    float32: the reference computed in a lower precision (the control)."""

    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm,
                F.linear, F.conv1d, F.conv2d}

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            args = tuple(round_to(a, self.dtype) if i < 2 and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for i, a in enumerate(args))
            if "weight" in kwargs:
                kwargs["weight"] = round_to(kwargs["weight"], self.dtype)
        return func(*args, **kwargs)


class Reference:
    """The reference transducer on ``device``: the model type's encoder
    (``build``) and the decoder and joiner, their weights copied from the
    benchmark's tree (the system's layout).  ``operands``: a lower precision
    for every product of the encoder and the joiner (the control,
    ``LowerPrecision``), or None for float32."""

    def __init__(self, cfg: dict, tree: dict, device, operands=None):
        self.cfg = cfg
        self.model = spec.model(cfg)
        self.device = torch.device(device)
        self.encoder = self.model.build(cfg, tree["encoder"], self.device)
        self.operands = operands
        dec, join = tree["decoder"], tree["joiner"]
        f32 = dict(dtype=torch.float32, device=self.device)
        self.embedding = dec["embedding"]["table"].to(**f32).clone()
        w = dec["conv"]["w"].to(**f32)  # [k, in/g, out] -> torch [out, in/g, k]
        self.conv_w = w.permute(2, 1, 0).contiguous()
        self.groups = self.embedding.shape[1] // w.shape[1]
        self.context = w.shape[0]
        self.enc_w = join["encoder_proj"]["w"].to(**f32).clone()  # [in, out]
        self.enc_b = join["encoder_proj"]["b"].to(**f32).clone()
        self.dec_w = join["decoder_proj"]["w"].to(**f32).clone()
        self.dec_b = join["decoder_proj"]["b"].to(**f32).clone()
        self.out_w = join["output"]["w"].to(**f32).clone()
        self.out_b = join["output"]["b"].to(**f32).clone()

    # -- encoder ------------------------------------------------------------

    def _precision(self):
        return contextlib.nullcontext() if self.operands is None else LowerPrecision(self.operands)

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, streaming: bool) -> torch.Tensor:
        with self._precision():
            return self.model.encode(self.encoder, self.cfg, feats, streaming)

    # -- decoder and joiner -------------------------------------------------

    def decoder(self, ctx: torch.Tensor) -> torch.Tensor:
        """ctx [N, context] token ids -> decoder outputs [N, D]."""
        emb = self.embedding[ctx].permute(0, 2, 1)  # [N, D, context]
        return torch.relu(F.conv1d(emb, self.conv_w, groups=self.groups)[:, :, 0])

    def logits(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """enc [T, D_enc] and decoder outputs [T, D_dec] -> [T, V]."""
        with self._precision():
            hid = torch.tanh(enc @ self.enc_w + self.enc_b + dec @ self.dec_w + self.dec_b)
            return hid @ self.out_w + self.out_b

    def contexts(self, tokens: list[int]) -> torch.Tensor:
        """[U + 1, context]: the context before each served token and after
        the last."""
        hist = [BLANK] * self.context + list(tokens)
        idx = torch.arange(len(tokens) + 1)[:, None] + torch.arange(self.context)[None]
        return torch.tensor(hist, device=self.device)[idx.to(self.device)]

    @torch.no_grad()
    def greedy_counts(self, encs: list[torch.Tensor], blank_deltas: torch.Tensor,
                      skip_sos: bool) -> torch.Tensor:
        """Tokens the reference's own greedy search emits over all of
        ``encs`` with each of ``blank_deltas`` added to the blank logit (the
        calibration): one search of every (delta, utterance) pair at once.
        -> [len(blank_deltas)] counts."""
        nd, nu = len(blank_deltas), len(encs)
        t_max = max(e.shape[0] for e in encs)
        enc = torch.zeros((nu, t_max, encs[0].shape[1]), device=self.device)
        for i, e in enumerate(encs):
            enc[i, : e.shape[0]] = e
        enc_p = (enc @ self.enc_w + self.enc_b).repeat(nd, 1, 1)  # [nd * nu, T, J]
        lens = torch.tensor([e.shape[0] for e in encs], device=self.device).repeat(nd)
        out_b = self.out_b.repeat(nd * nu, 1)
        out_b[:, BLANK] += blank_deltas.to(self.device).repeat_interleave(nu)
        n = nd * nu
        ctx = torch.full((n, self.context), BLANK, device=self.device, dtype=torch.long)
        dec_p = self.decoder(ctx) @ self.dec_w + self.dec_b
        count = torch.zeros(n, dtype=torch.long, device=self.device)
        skip = torch.tensor([BLANK, UNK] + ([SOS] if skip_sos else []), device=self.device)
        for t in range(t_max):
            y = (torch.tanh(enc_p[:, t] + dec_p) @ self.out_w + out_b).argmax(dim=1)
            emit = (t < lens) & ~torch.isin(y, skip)
            new_ctx = torch.cat([ctx[:, 1:], y[:, None]], dim=1)
            ctx = torch.where(emit[:, None], new_ctx, ctx)
            dec_p = torch.where(emit[:, None], self.decoder(ctx) @ self.dec_w + self.dec_b, dec_p)
            count += emit.long()
        return count.reshape(nd, nu).sum(dim=1).cpu()
