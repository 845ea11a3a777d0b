"""Checks of results that the port's kernels may compute in another order
than their plain versions; ``chip_smoke.py`` and the tests use them, the
recognizers do not.

``tie_aware_replay`` holds a greedy search (``decode/rnnt_greedy.py``) to the
plain ops frame by frame: in bf16 the kernel's summation order may
legitimately flip a near-tie, and one flip changes every later frame, so the
tokens alone cannot be compared.  ``beam_replay`` does the same for a
modified beam search (``decode/rnnt_beam.py``) through the choices it
recorded (``BeamTrace``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from k2transducerasr_tpu_torch.decode import rnnt_beam
from k2transducerasr_tpu_torch.decode.rnnt_beam import BeamState, BeamTrace
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


def beam_replay(dec_params, dec_cfg, join_params, state: BeamState, enc_proj, enc_lens,
                frame_offset, final: BeamState, trace: BeamTrace, extra_skip_sos: bool = False,
                compute_dtype=None, ulps: float = 2.0, window: int = 64) -> ReplayResult:
    """Hold ``final``, a modified beam search's result from ``state`` over
    ``enc_proj`` (``rnnt_beam.beam_frames_skip``'s trips), to the plain ops
    along the choices it recorded in ``trace``, allowing near-ties to go
    either way.

    Frame by frame it keeps the search's beams as the trace gives them
    (contexts, token buffers, the recorded scores) with decoder outputs
    from the plain ops, evaluates ``joint_logits`` and the float32
    log-softmax for every beam (products exact and rounded once,
    ``_linear``), and sums the trip's blank log-probs as the plain version
    does.  The band ``tol`` is 2 ``ulps`` (of the compute dtype, at each
    row's largest logit: one for the logit, one for the log-sum-exp),
    counted once per frame of the trip so far and once more for the frame,
    doubled for a comparison of two candidates, plus 4 float32 ulps of the
    live scores' magnitude (two roundings of score + log-prob on each side:
    where the log-probs differ in their last bits, the sums at a score of
    thousands may round one ulp apart).  It requires:
      * a frame without a step: no non-blank candidate beats the worst
        blank one by more than the band, and the trip's window has not
        ended there;
      * an emission step: the recorded scores within the band of the plain
        values of the chosen (parent, token) pairs, which are distinct,
        ordered best first within the band, and beaten by no other
        candidate by more than the band; the stored flags as the buffers
        allow;
      * a window's end: the frame is the trip's last and may not emit beyond
        the band; the recorded scores within the band of score + the trip's
        blank sum, a permutation of the beams, ordered within the band;
      * at the end: the tokens, timestamps, counts, contexts and scores the
        choices give, exactly; each decoder output within ``ulps`` of the
        plain one.
    ``differing`` counts the steps whose choice is not the plain ops' own
    (a flip inside the band); ``worst_ulps`` the largest overshoot of a
    choice's plain value past another's, in bands."""
    b, t_max, j = enc_proj.shape
    dev = enc_proj.device
    k = state.score.shape[1]
    c = state.hyp.shape[2]
    u = state.tokens.shape[2]
    blank = dec_cfg.blank_id
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    lens = enc_lens.to(dev, torch.int64).clamp(0, t_max)
    offset = torch.as_tensor(frame_offset, device=dev).to(torch.int64).expand(b)
    w = min(t_max, window)
    parent_t, stored_t, kind_t, token_t = trace.fields()
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    lane = torch.arange(b, device=dev)[:, None]
    beam = torch.arange(k, device=dev)[None, :]
    hyp, dp = state.hyp.clone(), state.dec_proj.to(dtype).clone()
    score, count = state.score.clone(), state.count.clone()
    tokens, timestamps = state.tokens.clone(), state.timestamps.clone()
    cumi = torch.zeros((b, k), device=dev)
    trip_end = torch.zeros((b,), dtype=torch.int64, device=dev)
    n_trip = torch.zeros((b,), dtype=torch.int64, device=dev)
    frames = differing = 0
    worst = 0.0

    def fail(t, lanes, reason):
        return ReplayResult(False, frames, differing, math.inf,
                            f"lane {int(lanes.nonzero()[0, 0])} frame {t}: {reason}")

    for t in range(t_max):
        valid = t < lens
        if not bool(valid.any()):
            break
        fresh = valid & (t >= trip_end)
        trip_end = torch.where(fresh, torch.clamp(torch.full_like(trip_end, t), max=t_max - w)
                               + w, trip_end).clamp(max=lens)
        n_trip = torch.where(fresh, 0, n_trip) + 1
        logits = _linear(join_params["output"], torch.tanh(enc_proj[:, t, None, :] + dp),
                         compute_dtype).float()  # [B, K, V]
        logp = rnnt_beam._log_probs(logits, extra_skip_sos)
        v = logp.shape[-1]
        blp = logp[..., blank]
        cumi = torch.where(fresh[:, None], 0.0, cumi) + blp
        cume = cumi - blp
        skip = score + cume
        foldv = score + cumi
        min_blank = foldv.amin(dim=1)
        cand = skip[..., None] + logp  # [B, K, V]
        nb = cand.clone()
        nb[..., blank] = -math.inf
        max_nb = nb.amax(dim=(1, 2))
        mag = logits.abs().amax(dim=-1).clamp_min(torch.finfo(dtype).tiny)
        delta = (2 * ulps * torch.finfo(dtype).eps
                 * torch.exp2(torch.floor(torch.log2(mag)))).amax(dim=1)  # [B]
        live = torch.where(score > rnnt_beam.NEG_INF / 2, score.abs(), 0.0).amax(dim=1)
        score_ulp = torch.finfo(torch.float32).eps * torch.exp2(torch.floor(torch.log2(
            live.clamp_min(torch.finfo(torch.float32).tiny))))
        tol = 2 * (n_trip + 1) * delta + 4 * score_ulp
        kind, par, tok = kind_t[:, t], parent_t[:, t], token_t[:, t]
        kind0 = kind[:, 0]
        end = t == trip_end - 1
        may = max_nb >= min_blank - tol
        must = max_nb >= min_blank + tol
        if bool((valid & (kind != kind0[:, None]).any(1)).any()):
            return fail(t, valid & (kind != kind0[:, None]).any(1), "mixed step kinds")
        idle, emit_step, fold = (valid & (kind0 == kk) for kk in (0, 1, 2))
        bad = (idle & (must | end)) | (fold & (must | ~end)) | (emit_step & ~may)
        if bool(bad.any()):
            return fail(t, bad, f"step kind {int(kind0[bad][0])} where the plain ops "
                                f"{'emit' if bool(must[bad][0]) else 'do not'} (window end: "
                                f"{bool(end[bad][0])})")
        values = trace.values[:, t]
        if bool((idle & (values != score).any(1)).any()):
            return fail(t, idle & (values != score).any(1), "scores changed without a step")
        step = emit_step | fold
        frames += int(valid.sum())
        if not bool(step.any()):
            continue
        # the plain values of the recorded choices
        chosen = torch.where(emit_step[:, None], cand[lane, par, tok.clamp(0, v - 1)],
                             foldv.gather(1, par))
        off = (values - chosen).abs() > tol[:, None]
        order = (chosen[:, 1:] > chosen[:, :-1] + tol[:, None]).any(1)
        pick = par * v + tok
        dup = (pick[:, :, None] == pick[:, None, :]) & ~torch.eye(k, dtype=torch.bool,
                                                                   device=dev)[None]
        taken = torch.zeros((b, k * v), dtype=torch.bool, device=dev)
        taken[lane.expand(b, k), pick.clamp(0, k * v - 1)] = True
        others = cand.reshape(b, k * v).masked_fill(taken, -math.inf).amax(dim=1)
        beaten = emit_step & (others > chosen.amin(dim=1) + tol)
        perm_bad = fold & ((tok != blank).any(1) | dup.any((1, 2)))
        bad = step & (off.any(1) | order | beaten | perm_bad | (emit_step & dup.any((1, 2))))
        if bool(bad.any()):
            return fail(t, bad, "a recorded choice outside the band of the plain top K")
        gap = torch.where(emit_step, (others - chosen.amin(dim=1)) / delta.clamp_min(1e-30),
                          -math.inf)
        worst = max(worst, float(gap.max()))
        differing += int((emit_step & ((others > chosen.amin(dim=1))
                                       | (chosen[:, 1:] > chosen[:, :-1]).any(1))).sum())
        # the step, on the lanes that took one
        emit = emit_step[:, None] & (tok != blank)
        count_p = count.gather(1, par)
        want_stored = emit & (count_p < u)
        if bool((step[:, None] & (stored_t[:, t] != want_stored.long())).any()):
            return fail(t, (step[:, None] & (stored_t[:, t] != want_stored.long())).any(1),
                        "a stored flag the buffers do not allow")
        hyp_p, dp_p = hyp[lane, par], dp[lane, par]
        new_hyp = torch.where(emit[..., None], torch.cat([hyp_p[..., 1:], tok[..., None]], 2), hyp_p)
        dec_out = decoder_mod.forward_from_tables(tables, dec_cfg, new_hyp.reshape(b * k, c))
        fresh_dp = _linear(join_params["decoder_proj"], dec_out, compute_dtype).reshape(b, k, j)
        new_dp = torch.where(emit[..., None], fresh_dp.to(dp.dtype), dp_p)
        tok_p, ts_p = tokens[lane, par], timestamps[lane, par]
        pos = count_p.clamp(max=u - 1)
        tok_p[lane, beam, pos] = torch.where(want_stored, tok, tok_p[lane, beam, pos])
        ts_p[lane, beam, pos] = torch.where(want_stored, offset[:, None] + t,
                                            ts_p[lane, beam, pos])
        sel = step[:, None]
        hyp = torch.where(sel[..., None], new_hyp, hyp)
        dp = torch.where(sel[..., None], new_dp, dp)
        score = torch.where(sel, values, score)
        count = torch.where(sel, count_p + want_stored.long(), count)
        tokens = torch.where(sel[..., None], tok_p, tokens)
        timestamps = torch.where(sel[..., None], ts_p, timestamps)
        trip_end = torch.where(step, t + 1, trip_end)

    for name, got, want in (("tokens", final.tokens, tokens),
                            ("timestamps", final.timestamps, timestamps),
                            ("count", final.count, count), ("hyp", final.hyp, hyp),
                            ("score", final.score, score)):
        if not torch.equal(got, want):
            lanes = (got != want).reshape(b, -1).any(1).nonzero()[:, 0].tolist()
            return ReplayResult(False, frames, differing, worst,
                                f"final {name} differs from the recorded choices' in lanes "
                                f"{lanes}")
    want_dp = dp.float()
    dp_tol = torch.maximum(ulps * torch.finfo(dtype).eps * want_dp.abs(),
                           torch.full_like(want_dp, 1e-5))
    if not bool(((final.dec_proj.float() - want_dp).abs() <= dp_tol).all()):
        return ReplayResult(False, frames, differing, worst, "final dec_proj differs")
    return ReplayResult(True, frames, differing, worst, "")
