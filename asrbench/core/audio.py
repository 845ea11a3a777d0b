"""Synthetic speech-like audio from the seed, made on the device in bulk and
brought to the host once as int16.

A clip is a run of phone-like segments of 50-150 ms: voiced ones (a
fundamental of 90-250 Hz and two formant-like partials), fricatives
(differenced noise) and near-silences, each at its own level over a 20 dB
range, under a raised-cosine envelope.  The segments make consecutive
encoder frames differ as speech makes them differ; a steady tone (the
pattern of ``bench.py``'s ``synth_pcm``) leaves a random-weight encoder's
output nearly constant, clip to clip as much as frame to frame.

The system gets ``int16 / 32768`` as float32, which its own int16
conversion maps back to the same samples; the reference reads the int16
samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
SEG_S = (0.05, 0.15)  # segment durations, s
KINDS = (0.5, 0.25)  # shares of voiced and fricative segments; the rest near-silent


def clips(n_clips: int, n_samples: int, seed: int, device) -> np.ndarray:
    """[n_clips, n_samples] int16 (host), drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 7919)
    f32 = dict(dtype=torch.float32, device=device)
    segs = n_samples // int(SEG_S[0] * SAMPLE_RATE) + 2
    p = torch.rand((6, n_clips, segs), generator=g, **f32)
    dur = torch.round((SEG_S[0] + (SEG_S[1] - SEG_S[0]) * p[0]) * SAMPLE_RATE)
    ends = torch.cumsum(dur, dim=1)
    kind = (p[1] >= KINDS[0]).long() + (p[1] >= KINDS[0] + KINDS[1]).long()
    amp = 10.0 ** (-2.0 + 1.0 * p[2])
    freqs = torch.stack([90.0 + 160.0 * p[3], 300.0 + 600.0 * p[4], 900.0 + 1600.0 * p[5]])
    out = np.empty((n_clips, n_samples), np.int16)
    step = 1 << 18  # samples per block: bounds the device memory
    for a in range(0, n_samples, step):
        b = min(a + step, n_samples)
        t = torch.arange(a, b, device=device, dtype=torch.float64)
        seg = torch.searchsorted(ends, t.to(torch.float32).expand(n_clips, -1).contiguous(),
                                 right=True).clamp(max=segs - 1)
        length = torch.gather(dur, 1, seg)
        start = torch.gather(ends, 1, seg) - length
        pos = (t[None].float() - start) / length
        env = 0.3 + 0.7 * (0.5 - 0.5 * torch.cos(2 * math.pi * pos))
        ph = (2 * math.pi / SAMPLE_RATE) * t  # float64: exact phase over a minute
        f = torch.gather(freqs, 2, seg.expand(3, -1, -1))
        voiced = (torch.sin(torch.remainder(f[0] * ph, 2 * math.pi).float())
                  + 0.6 * torch.sin(torch.remainder(f[1] * ph, 2 * math.pi).float())
                  + 0.4 * torch.sin(torch.remainder(f[2] * ph, 2 * math.pi).float()))
        noise = torch.randn((n_clips, b - a + 1), generator=g, **f32)
        fric = noise[:, 1:] - noise[:, :-1]
        k = torch.gather(kind, 1, seg)
        y = torch.where(k == 0, voiced, torch.where(k == 1, fric, 0.01 * noise[:, 1:]))
        x = y * env * torch.gather(amp, 1, seg)
        out[:, a:b] = torch.clamp(torch.round(x * 32768.0), -32768, 32767
                                  ).to(torch.int16).cpu().numpy()
    return out


def as_float(pcm: np.ndarray) -> np.ndarray:
    """int16 -> the float32 samples the system takes (exact)."""
    return pcm.astype(np.float32) * np.float32(1.0 / 32768.0)
