"""Sample-rate conversion (host side, numpy) — the port's copy of
``k2transducerasr_tpu/audio/resample.py``.

The reference resamples with plain linear interpolation
(``AudioHelper.cs:187-284``); we match that semantics exactly so transcripts
computed from non-16 kHz sources agree, and additionally provide a windowed
sinc (kaldi ``LinearResample``-style) polyphase resampler for quality.
"""

from __future__ import annotations

import numpy as np


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resampling, matching AudioHelper.cs:187-284:
    output length = floor(n * dst/src); sample i interpolates source position
    ``i * src/dst`` between its two neighbours."""
    if src_rate == dst_rate:
        return np.asarray(x, dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    n_out = int(len(x) * dst_rate / src_rate)
    pos = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    i0 = np.minimum(pos.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (pos - i0).astype(np.float32)
    return (x[i0] * (1.0 - frac) + x[i1] * frac).astype(np.float32)


def resample_sinc(
    x: np.ndarray,
    src_rate: int,
    dst_rate: int,
    num_zeros: int = 10,
    cutoff_ratio: float = 0.95,
) -> np.ndarray:
    """Windowed-sinc polyphase resampler (higher quality than linear).

    Kaldi-style: low-pass at ``cutoff_ratio * min(src,dst)/2`` with a Hann
    windowed sinc of ``num_zeros`` zero crossings per side.
    """
    if src_rate == dst_rate:
        return np.asarray(x, dtype=np.float32)
    x = np.asarray(x, dtype=np.float64)
    g = np.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    cutoff = cutoff_ratio * 0.5 * min(src_rate, dst_rate)
    # filter length per output tap
    half_width = num_zeros / (2.0 * cutoff / src_rate)
    n_out = int(len(x) * dst_rate / src_rate)
    out = np.zeros(n_out, dtype=np.float64)
    t_out = np.arange(n_out) * (down / up)  # in input-sample units
    left = np.ceil(t_out - half_width).astype(np.int64)
    width = int(np.floor(2 * half_width)) + 2
    idx = left[:, None] + np.arange(width)[None, :]
    delta = (idx - t_out[:, None]) * (2.0 * np.pi * cutoff / src_rate)
    sinc = np.where(np.abs(delta) < 1e-9, 1.0, np.sin(delta) / np.where(delta == 0, 1.0, delta))
    # Hann window over [-half_width, half_width]
    frac = (idx - t_out[:, None]) / half_width
    win = np.where(np.abs(frac) < 1.0, 0.5 * (1.0 + np.cos(np.pi * frac)), 0.0)
    taps = sinc * win * (2.0 * cutoff / src_rate)
    valid = (idx >= 0) & (idx < len(x))
    gathered = np.where(valid, x[np.clip(idx, 0, len(x) - 1)], 0.0)
    out = (gathered * taps).sum(axis=1)
    scale = min(1.0, up / down)  # preserve amplitude when downsampling
    del scale  # gain already folded into taps
    return out.astype(np.float32)
