"""The benchmark's arithmetic of peaks, bytes and operations.

The first five functions are frozen copies of ``chip_smoke.py``'s
(``card_bandwidth``, ``peak_flops``, ``bound``, ``_k1_bytes_ops``,
``_greedy_bytes_ops``); the greedy count takes the search's sizes as
numbers instead of the system's operand object.  A model type's FLOPs are
counted with ``flop_count`` over its plain reference on the meta device
(``asrbench/models/<model_type>.py``): the same count whatever implements
the step.
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_BF16 = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)


def card_bandwidth(name: str) -> float:
    """Device-memory bandwidth (bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12  # H100 SXM


def peak_flops(dtype) -> float:
    """Dense peak of the unit the work's type runs on (H100 SXM data sheet)."""
    return 989e12 if dtype == torch.bfloat16 else 67e12


def bound(nbytes, ops, dtype, bw):
    """The least time, ms, and what bounds it."""
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bytes_ops(b, t, s, h, in_dtype, out_dtype, qd=32, pd=4):
    """K1 (``relpos_attn_probs``) at one call's shapes: q, k, pos_q, pos_k
    read once, two int32 per lane, the probs written once; 2 b h t s (qd +
    pd) operations."""
    ie = torch.finfo(in_dtype).bits // 8
    oe = torch.finfo(out_dtype).bits // 8
    nbytes = (b * t * h * qd + b * s * h * qd + b * t * h * pd + (t + s - 1) * h * pd) * ie \
        + 2 * 4 * b + b * h * t * s * oe
    ops = 2 * b * h * t * s * (qd + pd)
    return nbytes, ops


def greedy_bytes_ops(b, frames, emissions, *, context, vocab, decoder_dim, joiner_dim,
                     elem_bytes):
    """The least bytes and operations of one greedy search (G), counted from
    what the data needs: the valid frames of enc_proj read once, the two
    weights and biases once, the context-table rows the emissions gather (at
    most the whole tables), the small state read and written once, the
    lanes' lengths and offsets read, and 16 bytes written per emission; a
    joiner row per valid frame (2 J V) and a decoder refresh per emission
    (2 D J)."""
    c, v, d, j, e = context, vocab, decoder_dim, joiner_dim, elem_bytes
    weights = (j * v + d * j) * e + (j + v) * 4
    tables = min(c * v * d, emissions * c * d) * 4
    state = b * c * 8 + b * j * e + 2 * b * 8
    nbytes = frames * j * e + weights + tables + 2 * state + 2 * b * 8 + 16 * emissions
    return nbytes, 2 * frames * j * v + 2 * emissions * d * j


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle gaps [(start, end)] inside [lo, hi] between the union of
    ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def percentile(values, q: float) -> float:
    """The q-th percentile over every value (numpy's linear rule)."""
    if not len(values):
        raise ValueError("no values")
    return float(np.percentile(values, q))


def flop_count(fn) -> int:
    """The FLOPs ``FlopCounterMode`` counts while ``fn()`` runs (on the meta
    device it runs no arithmetic)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return int(fc.get_total_flops())


def search_flops(frames: int, emissions: int, *, encoder_dim, joiner_dim, vocab,
                 decoder_dim, context, groups) -> int:
    """The joiner over every valid frame (its encoder projection and output
    layer, 2 E J + 2 J V) and a decoder refresh per emission (the grouped
    context conv and the decoder projection)."""
    per_frame = 2 * encoder_dim * joiner_dim + 2 * joiner_dim * vocab
    per_emit = 2 * context * decoder_dim * (decoder_dim // groups) + 2 * decoder_dim * joiner_dim
    return frames * per_frame + emissions * per_emit
