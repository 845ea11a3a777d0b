"""Kaldi log-mel filterbank, the benchmark's plain reference: frame by frame
in float64 (DC removal, preemphasis, window, zero-padded real FFT, power,
triangular mel banks, log), rounded to float32 at the end.  Both of
kaldi's framings: ``snip_edges`` (frame t covers [t shift, t shift +
length)) and centred (frame t centred at t shift + shift / 2, samples
outside the signal reflected at its edges); no dither: what the
benchmark's configurations state."""

from __future__ import annotations

import math

import torch


def _mel(f):
    return 1127.0 * torch.log(1.0 + f / 700.0)


def window(name: str, n: int, device=None) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64, device=device)
    a = 2.0 * math.pi / (n - 1)
    if name == "povey":
        return (0.5 - 0.5 * torch.cos(a * i)) ** 0.85
    if name == "hamming":
        return 0.54 - 0.46 * torch.cos(a * i)
    if name == "hanning":
        return 0.5 - 0.5 * torch.cos(a * i)
    raise ValueError(f"window {name!r} is not in the reference")


def mel_banks(fcfg: dict, nfft: int, device=None) -> torch.Tensor:
    """[nfft // 2, num_mel_bins]: kaldi's MelBanks over the fft bins below
    Nyquist."""
    sr, bins = fcfg["sample_rate"], fcfg["num_mel_bins"]
    high = fcfg["high_freq"] if fcfg["high_freq"] > 0 else sr / 2.0 + fcfg["high_freq"]
    lo, hi = _mel(torch.tensor(float(fcfg["low_freq"]), dtype=torch.float64)), \
        _mel(torch.tensor(float(high), dtype=torch.float64))
    delta = (hi - lo) / (bins + 1)
    mel_f = _mel(torch.arange(nfft // 2, dtype=torch.float64) * (sr / nfft))
    left = lo + delta * torch.arange(bins, dtype=torch.float64)
    up = (mel_f[:, None] - left[None]) / delta
    down = (left[None] + 2 * delta - mel_f[:, None]) / delta
    return torch.clamp(torch.minimum(up, down), min=0.0).to(device)


def _lengths(fcfg: dict) -> tuple[int, int]:
    sr = fcfg["sample_rate"]
    return int(sr * fcfg["frame_length_ms"] / 1000.0), int(sr * fcfg["frame_shift_ms"] / 1000.0)


def num_frames(n_samples: int, fcfg: dict) -> int:
    """Kaldi's frame count of ``n_samples`` under the configuration's
    framing."""
    n, shift = _lengths(fcfg)
    if not fcfg["snip_edges"]:
        return (n_samples + shift // 2) // shift
    return 0 if n_samples < n else 1 + (n_samples - n) // shift


def frames_of(x: torch.Tensor, fcfg: dict) -> torch.Tensor:
    """[N] samples -> [T, frame length] under the configuration's framing."""
    n, shift = _lengths(fcfg)
    t = num_frames(x.numel(), fcfg)
    if fcfg["snip_edges"]:
        return x.unfold(0, n, shift)[:t].clone()
    idx = (torch.arange(t, device=x.device)[:, None] * shift + shift // 2 - n // 2
           + torch.arange(n, device=x.device)[None])
    size = x.numel()
    while bool(((idx < 0) | (idx >= size)).any()):  # kaldi reflects until inside
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= size, 2 * size - 1 - idx, idx)
    return x[idx]


def fbank(pcm: torch.Tensor, fcfg: dict) -> torch.Tensor:
    """pcm: [N] int16 samples -> [frames, num_mel_bins] float32."""
    if fcfg.get("dither", 0.0):
        raise ValueError("the reference fbank takes no dither")
    n, _ = _lengths(fcfg)
    nfft = 1 << (n - 1).bit_length()
    x = pcm.to(torch.float64) / 32768.0
    if num_frames(x.numel(), fcfg) == 0:
        return torch.zeros((0, fcfg["num_mel_bins"]), dtype=torch.float32, device=pcm.device)
    frames = frames_of(x, fcfg)  # [T, n]
    frames -= frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - fcfg["preemph_coeff"] * prev
    frames = frames * window(fcfg["window_type"], n, pcm.device)
    power = torch.fft.rfft(frames, n=nfft).abs() ** 2  # [T, nfft/2 + 1]
    energies = power[:, : nfft // 2] @ mel_banks(fcfg, nfft, pcm.device)
    eps = torch.finfo(torch.float32).eps
    return torch.log(torch.clamp(energies, min=eps)).to(torch.float32)
