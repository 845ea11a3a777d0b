"""Kaldi-compatible log-mel filterbank, PyTorch port of
``k2transducerasr_tpu/frontend/fbank.py``.

Same design: with dither == 0 every per-frame op before the power spectrum
(DC removal, preemphasis, window, zero-padded rDFT) is linear in the frame,
so the chain is pre-composed (numpy, float64, then float32) into one
``[frame_len, 2*(nfft//2+1)]`` matrix ``A``:

    power[k] = (x @ A)[k]^2 + (x @ A)[k + n_bins]^2
    fbank    = log(max(power @ Mel, eps))

Both matmuls are true float32: TF32 is turned off around them on the card
(``runtime.device.exact_f32``), as the reference keeps them at
``precision=HIGHEST``.  With dither > 0, ``dither * N(0, 1)`` noise from an
explicit ``torch.Generator`` is added to the frames before the first
matmul (the reference draws it from ``jax.random``: the same distribution,
other values).

``FbankExtractor`` is the batched whole-buffer front; ``OnlineFbank`` the
streaming one: a host sample buffer whose completed frames go through the
same ``fbank_compute``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from k2transducerasr_tpu_torch.runtime.device import exact_f32, resolve_device

_EPS = float(np.finfo(np.float32).eps)  # kaldi's energy floor for log


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Kaldi frame options; the same fields as the JAX package's config, so
    a model dir's ``config.json`` loads into either."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    window_type: str = "hamming"  # povey | hamming | hanning | rectangular | blackman
    dither: float = 0.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means Nyquist + high_freq
    use_power: bool = True
    use_log_fbank: bool = True
    blackman_coeff: float = 0.42
    input_scale: float = 1.0

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n

    @classmethod
    def whisper(cls, sample_rate: int = 16000) -> "FbankConfig":
        """The reference's whisper front: hanning window, 80 mels,
        snip_edges=False."""
        return cls(sample_rate=sample_rate, window_type="hanning", num_mel_bins=80,
                   snip_edges=False)


def num_frames_for(num_samples: int, cfg: FbankConfig) -> int:
    """Frame count under snip_edges semantics (kaldi NumFrames)."""
    fl, fs = cfg.frame_length, cfg.frame_shift
    if cfg.snip_edges:
        if num_samples < fl:
            return 0
        return 1 + (num_samples - fl) // fs
    return (num_samples + fs // 2) // fs


def num_frames_tensor(num_samples: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Tensor version of ``num_frames_for``."""
    fl, fs = cfg.frame_length, cfg.frame_shift
    if cfg.snip_edges:
        return torch.where(num_samples < fl, 0, 1 + (num_samples - fl) // fs)
    return (num_samples + fs // 2) // fs


def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if cfg.window_type == "rectangular":
        return np.ones(n)
    if cfg.window_type == "blackman":
        c = cfg.blackman_coeff
        return c - 0.5 * np.cos(a * i) + (0.5 - c) * np.cos(2 * a * i)
    raise ValueError(f"unknown window type {cfg.window_type!r}")


def mel_scale(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Kaldi MelBanks: triangular filters in mel space over fft bins
    ``0 .. nfft/2 - 1`` (the Nyquist bin is never covered).  Returns
    ``[nfft//2 + 1, num_mel_bins]`` with a zero Nyquist row."""
    nfft = cfg.padded_window_size
    n_bins = nfft // 2 + 1
    high_freq = cfg.high_freq if cfg.high_freq > 0 else cfg.sample_rate / 2.0 + cfg.high_freq
    mel_low, mel_high = mel_scale(cfg.low_freq), mel_scale(high_freq)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_freqs = np.arange(n_bins, dtype=np.float64) * (cfg.sample_rate / nfft)
    mel_f = mel_scale(fft_freqs)

    out = np.zeros((n_bins, cfg.num_mel_bins), dtype=np.float64)
    for m in range(cfg.num_mel_bins):
        left = mel_low + m * delta
        center, right = left + delta, left + 2 * delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        out[:, m] = np.maximum(0.0, np.minimum(up, down))
    out[nfft // 2, :] = 0.0  # kaldi never reads the Nyquist bin
    return out


def _build_matrices(cfg: FbankConfig):
    """Pre-compose DC-removal, preemphasis, window, and padded rDFT into a
    single real matrix ``A [frame_len, 2*n_bins]`` (cos block | sin block);
    returns (A, Mel) as float32 numpy arrays."""
    n = cfg.frame_length
    nfft = cfg.padded_window_size
    n_bins = nfft // 2 + 1

    m = np.eye(n, dtype=np.float64)
    if cfg.remove_dc_offset:
        m = m - np.full((n, n), 1.0 / n)
    if cfg.preemph_coeff != 0.0:
        p = np.eye(n, dtype=np.float64)
        idx = np.arange(1, n)
        p[idx, idx - 1] = -cfg.preemph_coeff
        p[0, 0] = 1.0 - cfg.preemph_coeff  # kaldi: x[0] -= coeff * x[0]
        m = p @ m
    m = _window(cfg)[:, None] * m  # diag(window) @ preemph @ dc

    k = np.arange(n_bins, dtype=np.float64)
    t = np.arange(n, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(t, k) / nfft
    a_cos = m.T @ np.cos(ang)
    a_sin = m.T @ -np.sin(ang)
    dft = np.concatenate([a_cos, a_sin], axis=1)  # [frame_len, 2*n_bins]
    return dft.astype(np.float32), mel_banks(cfg).astype(np.float32)


@functools.lru_cache(maxsize=8)
def fbank_matrices(cfg: FbankConfig):
    """The composed (dft, mel) matrices as host numpy arrays (cached per
    config; callers move them to their device once)."""
    return _build_matrices(cfg)


def frame_signal(samples: torch.Tensor, cfg: FbankConfig, num_frames: int) -> torch.Tensor:
    """snip_edges framing: frame t covers [t*shift, t*shift + frame_len).
    A buffer shorter than the last frame is zero-padded, as the reference's
    reshape-based framing does.  Returns [B, num_frames, frame_len]."""
    fs, fl = cfg.frame_shift, cfg.frame_length
    need = (num_frames - 1) * fs + fl
    if samples.shape[1] < need:
        samples = torch.nn.functional.pad(samples, (0, need - samples.shape[1]))
    return samples[:, :need].unfold(1, fl, fs)


def frame_indices(num_frames: int, cfg: FbankConfig, device="cpu") -> torch.Tensor:
    """Sample index matrix [num_frames, frame_len]: frame t covers
    [t*shift, t*shift + frame_len) with snip_edges, else it is centred at
    t*shift + shift/2 (kaldi), its out-of-range indices left raw."""
    starts = torch.arange(num_frames, device=device) * cfg.frame_shift
    if not cfg.snip_edges:
        starts = starts + (cfg.frame_shift // 2 - cfg.frame_length // 2)
    return starts[:, None] + torch.arange(cfg.frame_length, device=device)[None, :]


def _reflected_frames(x: torch.Tensor, cfg: FbankConfig, num_frames: int,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """snip_edges=False framing: frame t is centred at t*shift + shift/2 and
    indices reflect at the lane's true sample count (kaldi: s<0 -> -s-1,
    s>=n -> 2n-1-s)."""
    dev = x.device
    idx = frame_indices(num_frames, cfg, dev)
    idx = torch.where(idx < 0, -idx - 1, idx)
    n = n_valid.to(dev, torch.int64)[:, None, None]
    idx = idx[None].expand(x.shape[0], -1, -1)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    idx = idx.clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx.reshape(x.shape[0], -1)).reshape(idx.shape)


def dither_noise(shape, cfg: FbankConfig, device,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``cfg.dither * N(0, 1)`` float32 noise of ``shape`` on ``device``,
    drawn from ``generator`` (a generator on ``device``); by default a fresh
    one seeded with 0, as the reference's default key is ``PRNGKey(0)``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return cfg.dither * torch.randn(shape, generator=generator, dtype=torch.float32,
                                    device=device)


def fbank_compute(samples: torch.Tensor, cfg: FbankConfig, num_frames: int,
                  n_valid: torch.Tensor | None = None, tables=None,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """samples: [B, N] float32 -> feats [B, num_frames, num_mel_bins].

    n_valid: [B] true sample counts — used when snip_edges=False (frame
    centring reflects at the true signal boundaries).  tables: (dft, mel)
    tensors on the samples' device, as ``fbank_matrices`` gives them.
    generator: the source of the dither noise (cfg.dither > 0,
    ``dither_noise``); noise: the dither noise itself, [B, num_frames,
    frame_length], drawn in place of one from ``generator``."""
    if tables is None:
        tables = tuple(torch.from_numpy(m).to(samples.device) for m in fbank_matrices(cfg))
    dft, mel = tables
    x = samples.float() * cfg.input_scale
    if cfg.snip_edges:
        frames = frame_signal(x, cfg, num_frames)
    else:
        if n_valid is None:
            n_valid = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64)
        frames = _reflected_frames(x, cfg, num_frames, n_valid)
    if cfg.dither > 0.0:
        if noise is None:
            noise = dither_noise(frames.shape, cfg, frames.device, generator)
        frames = frames + noise
    with exact_f32():
        spec = torch.matmul(frames, dft)
        n_bins = dft.shape[1] // 2
        power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
        if not cfg.use_power:
            power = torch.sqrt(torch.clamp(power, min=0.0))
        feats = torch.matmul(power, mel)
    if cfg.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=_EPS))
    return feats


class FbankExtractor:
    """Batched whole-buffer fbank on ``device``.  (The reference pads the
    frame axis to 64-frame buckets to bound XLA recompiles; the port
    computes exactly the frames the longest buffer has.)"""

    def __init__(self, cfg: FbankConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tables = tuple(torch.from_numpy(m).to(self.device) for m in fbank_matrices(cfg))

    def __call__(self, samples: np.ndarray, n_valid=None,
                 generator: torch.Generator | None = None):
        """samples: [B, N] or [N] float32 -> (feats [B, T, M] on the device,
        n_frames [B] int32 numpy), T the most frames of any buffer; a
        lane's frames past its ``n_frames`` are not part of the result.
        For [N], (feats [T, M], n_frames int)."""
        cfg = self.cfg
        samples = np.asarray(samples, np.float32)
        squeeze = samples.ndim == 1
        if squeeze:
            samples = samples[None, :]
        b, n = samples.shape
        if n_valid is None:
            n_valid = np.full((b,), n, dtype=np.int32)
        n_frames = np.array([num_frames_for(int(v), cfg) for v in n_valid], dtype=np.int32)
        t = int(n_frames.max(initial=0))
        x = torch.from_numpy(samples).to(self.device)
        lens = torch.from_numpy(np.asarray(n_valid, np.int64)).to(self.device)
        feats = fbank_compute(x, cfg, t, n_valid=lens, tables=self._tables, generator=generator)
        if squeeze:
            return feats[0], int(n_frames[0])
        return feats, n_frames


class OnlineFbank:
    """Streaming fbank with kaldi online semantics (port of the reference's
    ``OnlineFbank``).  The host keeps a sample buffer; each call computes
    every newly completed frame with ``fbank_compute`` on ``device``.
    ``input_finished()`` drops a partial tail frame (snip_edges=True)."""

    def __init__(self, cfg: FbankConfig, device: str | torch.device = "cuda"):
        if not cfg.snip_edges:
            raise ValueError(
                "streaming fbank requires snip_edges=True (centred framing reflects at "
                "the utterance's end, which is unknown while streaming)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tables = tuple(torch.from_numpy(m).to(self.device) for m in fbank_matrices(cfg))
        self._buf = np.zeros(0, dtype=np.float32)
        self._finished = False

    def accept_waveform(self, samples: np.ndarray) -> np.ndarray:
        """Append samples; return all newly completed frames [T_new, M]."""
        if self._finished:
            raise RuntimeError("accept_waveform after input_finished")
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        return self._drain()

    def input_finished(self) -> np.ndarray:
        self._finished = True
        return self._drain()

    def _drain(self) -> np.ndarray:
        cfg = self.cfg
        t = num_frames_for(len(self._buf), cfg)
        if t == 0:
            return np.zeros((0, cfg.num_mel_bins), dtype=np.float32)
        x = torch.from_numpy(self._buf).to(self.device)[None]
        feats = fbank_compute(x, cfg, t, tables=self._tables)[0].cpu().numpy()
        self._buf = self._buf[t * cfg.frame_shift:]
        return feats
