"""What decides ``correct``: the served tokens of a sample of finished
requests, judged by the plain reference (``asrbench/reference``), run once
the window has closed and the system is freed.

For each sampled request the reference computes fbank and the encoder from
the request's own int16 samples; the configuration's decoding method
(``asrbench/decoding/<decoding_method>.py``, found by name) gives the gap at
every encoder frame by which the served output lies below the reference's
best, and the number compared is the widest over every frame of every
sampled request.  The reference runs in float32 with TF32 off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asrbench.core import spec
from asrbench.reference.fbank import fbank
from asrbench.reference.transducer import Reference


@dataclasses.dataclass
class Served:
    """One request as the system served it: its int16 samples (for a stream,
    the samples its stepped windows covered), the token ids and their
    encoder frames."""

    pcm: np.ndarray
    tokens: list
    stamps: list


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def encode(ref: Reference, pcm: np.ndarray, streaming: bool) -> torch.Tensor:
    feats = fbank(torch.from_numpy(pcm).to(ref.device), ref.cfg["frontend"])
    return ref.encode(feats, streaming)


CONTROLS = {"fp8": torch.float8_e4m3fn}


def judge(cfg: dict, tree: dict, served: list, device, streaming: bool,
          control: str | None = None) -> dict:
    """-> {"max_logit_gap", "frames", "tokens", "differing_frames"} over the
    ``served`` sample.  With ``control`` the number is the control's: the
    reference with its encoder's linears and convolutions in that precision
    put in the system's place, read at every frame of the same requests
    under the same served tokens, by the gap of the choice it puts first."""
    tf32_off()
    method = spec.decoding(cfg)
    ref = Reference(cfg, tree, device)
    low = None if control is None else Reference(cfg, tree, device, CONTROLS[control])
    worst, frames, tokens, differ = 0.0, 0, 0, 0
    for s in served:
        enc = encode(ref, s.pcm, streaming)
        if low is None:
            gaps = method.served_gaps(ref, enc, s.tokens, s.stamps, streaming)
        else:
            gaps = method.control_gaps(ref, enc, low, encode(low, s.pcm, streaming), s.tokens,
                                       s.stamps, streaming)
        worst = max(worst, float(gaps.max()) if gaps.numel() else 0.0)
        frames += int(enc.shape[0])
        tokens += len(s.tokens)
        differ += int((gaps > 0).sum())
    del ref, low
    return {"max_logit_gap": worst, "frames": frames, "tokens": tokens,
            "differing_frames": differ}
