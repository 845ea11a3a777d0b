"""Checks of results that the port's kernels may compute in another order
than their plain versions; ``chip_smoke.py`` and the tests use them, the
recognizers do not.

``tie_aware_replay`` holds a greedy search (``decode/rnnt_greedy.py``) to the
plain ops frame by frame: in bf16 the kernel's summation order may
legitimately flip a near-tie, and one flip changes every later frame, so the
tokens alone cannot be compared.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from k2transducerasr_tpu_torch.decode.rnnt_greedy import GreedyState, _blankish, _UNK
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.ops.layers import apply_linear


@dataclasses.dataclass
class ReplayResult:
    ok: bool
    frames: int  # frames checked (valid, before a lane's buffer filled)
    differing: int  # of those, frames decided otherwise than the plain argmax
    worst_ulps: float  # largest (plain max - decided logit) in ulps of the max
    reason: str  # the first check that failed ("" when ok)


def tie_aware_replay(dec_params, dec_cfg, join_params, state: GreedyState, enc_proj, enc_lens,
                     frame_offset, final: GreedyState, extra_skip_sos: bool = False,
                     compute_dtype=None, ulps: float = 2.0) -> ReplayResult:
    """Hold ``final``, a search's result from ``state`` over ``enc_proj``,
    to the plain ops frame by frame, allowing near-ties to go either way.

    From the new tokens and timestamps it rebuilds, with
    ``forward_from_tables`` and ``project_decoder``, the decoder state that
    was active at every frame, evaluates ``joint_logits`` at every valid
    frame in one batched call, and requires at each frame, until the lane's
    token buffer is full, that the decision lies within ``ulps`` ulps (of
    the compute dtype, at the frame's plain maximum) of that maximum: an
    emitted token's own logit, or at a blank frame the largest blankish
    logit.  It also requires emissions at increasing frames inside the
    lane's length, no blankish token emitted, the buffers outside the new
    slots unchanged, and the final count, context, trailing blanks and
    (within ``ulps``) decoder output that those emissions give.  The plain
    ops round where ``apply_linear`` rounds, each product in the compute
    dtype summed exactly and rounded once (``_linear``): the value that every
    float32 summation order, the kernel's or a library's, approximates."""
    b, t_max, j = enc_proj.shape
    dev = enc_proj.device
    k_max = state.tokens.shape[1]
    c = state.hyp.shape[1]
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    lens = enc_lens.to(dev, torch.int64).clamp(0, t_max)
    offset = torch.as_tensor(frame_offset, device=dev).to(torch.int64).expand(b)
    c0, c1 = state.count, final.count
    n_new = c1 - c0
    e = max(int(n_new.max()) if b else 0, 0)
    ar_e = torch.arange(e, device=dev)
    has = ar_e[None, :] < n_new[:, None]  # [B, E]
    slot = (c0[:, None] + ar_e[None, :]).clamp(max=k_max - 1)
    tok = torch.where(has, final.tokens.gather(1, slot), dec_cfg.blank_id)
    frame = torch.where(has, final.timestamps.gather(1, slot) - offset[:, None], t_max)

    def fail(reason):
        return ReplayResult(False, 0, 0, math.inf, reason)

    blank_ids = [dec_cfg.blank_id, _UNK] + ([1] if extra_skip_sos else [])
    if bool((n_new < 0).any()) or bool((c1 > k_max).any()):
        return fail("counts went down or past the buffer")
    if bool((has & ((frame < 0) | (frame >= lens[:, None]))).any()):
        return fail("an emission outside its lane's frames")
    if e > 1 and bool((has[:, 1:] & (frame[:, 1:] <= frame[:, :-1])).any()):
        return fail("emissions not at increasing frames")
    if bool((has & _blankish(tok, extra_skip_sos, dec_cfg.blank_id)).any()):
        return fail("a blankish token emitted")
    slots = torch.arange(k_max, device=dev)[None, :]
    new_slot = (slots >= c0[:, None]) & (slots < c1[:, None])
    for name, before, after in (("tokens", state.tokens, final.tokens),
                                ("timestamps", state.timestamps, final.timestamps)):
        if not torch.equal(torch.where(new_slot, 0, before), torch.where(new_slot, 0, after)):
            return fail(f"{name} changed outside the new slots")

    # the decoder state after k emissions, k = 0 .. E
    seq = torch.cat([state.hyp, tok], dim=1)  # [B, C + E]
    hyps = seq.unfold(1, c, 1)  # [B, E + 1, C]
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    dec_out = decoder_mod.forward_from_tables(tables, dec_cfg, hyps.reshape(-1, c))
    dps = _linear(join_params["decoder_proj"], dec_out, compute_dtype).reshape(b, e + 1, j)
    dps = torch.cat([state.dec_proj[:, None].to(dps.dtype), dps[:, 1:]], dim=1)
    # frame t decides with the state after the emissions at frames < t
    ts = torch.arange(t_max, device=dev)
    k_at = torch.searchsorted(frame.contiguous(), ts.expand(b, t_max).contiguous())  # [B, T]
    dec_t = dps.gather(1, k_at[..., None].expand(b, t_max, j))
    logits = _linear(join_params["output"], torch.tanh(enc_proj + dec_t), compute_dtype).float()

    top = logits.max(dim=-1).values
    mag = top.abs().clamp_min(torch.finfo(dtype).tiny)
    ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(mag)))
    emit = torch.zeros((b, t_max), dtype=torch.bool, device=dev)
    y = torch.zeros((b, t_max), dtype=torch.int64, device=dev)
    lane = torch.arange(b, device=dev)[:, None].expand(b, e)
    emit[lane[has], frame[has]] = True
    y[lane[has], frame[has]] = tok[has]
    decided = torch.where(emit, logits.gather(-1, y[..., None])[..., 0],
                          logits[..., blank_ids].max(dim=-1).values)
    # checked: valid frames up to the emission that filled the buffer
    full = c1 >= k_max
    last = frame.gather(1, (n_new - 1).clamp(min=0)[:, None])[:, 0]
    stop = torch.where(full & (n_new > 0), last + 1, torch.where(full & (c0 >= k_max), 0, lens))
    checked = ts[None, :] < stop[:, None]
    gap = torch.where(checked, (top - decided) / ulp, 0.0)  # in ulps of the maximum
    argmax = logits.argmax(dim=-1)
    differ = checked & torch.where(emit, argmax != y,
                                   ~_blankish(argmax, extra_skip_sos, dec_cfg.blank_id))
    frames, n_differ = int(checked.sum()), int(differ.sum())
    worst = float(gap.max()) if b * t_max else 0.0
    if worst > ulps:
        bad = (gap > ulps).nonzero()[0].tolist()
        return ReplayResult(False, frames, n_differ, worst,
                            f"lane {bad[0]} frame {bad[1]}: decision {worst:.2f} ulps below "
                            f"the plain maximum")

    # the final state those emissions give
    last_emit = torch.where(n_new > 0, last, -1)
    want_trailing = torch.where(n_new > 0, lens - 1 - last_emit, state.trailing_blanks + lens)
    want_hyp = hyps[torch.arange(b, device=dev), n_new]
    want_dp = dps[torch.arange(b, device=dev), n_new].float()
    dp_tol = ulps * torch.finfo(dtype).eps * want_dp.abs().clamp_min(1e-30)
    checks = (("trailing_blanks", torch.equal(final.trailing_blanks, want_trailing)),
              ("hyp", torch.equal(final.hyp, want_hyp)),
              ("dec_proj", bool(((final.dec_proj.float() - want_dp).abs()
                                 <= torch.maximum(dp_tol, torch.full_like(dp_tol, 1e-5))).all())))
    for name, ok in checks:
        if not ok:
            return ReplayResult(False, frames, n_differ, worst, f"final {name} differs")
    return ReplayResult(True, frames, n_differ, worst, "")


def _linear(p, x, compute_dtype):
    """``apply_linear(p, x, compute_dtype)`` with its rounding points, but in
    a reduced compute dtype the product summed exactly (float64) and
    rounded once (``_round_once``) before the bias is added."""
    if compute_dtype is None:
        return apply_linear(p, x)
    prod = x.to(compute_dtype).double() @ p["w"].to(compute_dtype).double()
    y = _round_once(prod, compute_dtype).float()
    if "b" in p:
        y = y + p["b"]
    return y.to(compute_dtype)


def _round_once(x: torch.Tensor, dtype) -> torch.Tensor:
    """float64 ``x`` rounded to nearest (even) in ``dtype``, once: x is first
    rounded to odd in float32 (truncated, its last bit set where that was
    inexact), which keeps the second rounding from compounding the first."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    f = torch.where(f.double() != x, (f.view(torch.int32) | 1).view(torch.float32), f)
    return f.to(dtype)
