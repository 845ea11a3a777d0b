"""Endpoint detection for streaming recognition — the port's copy of
``k2transducerasr_tpu/runtime/endpoint.py`` (pure Python).

Rules in the sherpa/k2 style, driven by the ``trailing_blanks`` counter the
greedy decode state tracks on the device:

  rule1: trailing silence >= min_trailing_silence_no_text  (nothing decoded)
  rule2: trailing silence >= min_trailing_silence_after_text (something decoded)
  rule3: utterance length >= max_utterance_length
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EndpointConfig:
    min_trailing_silence_no_text: float = 5.0  # seconds
    min_trailing_silence_after_text: float = 2.4
    max_utterance_length: float = 20.0
    frame_seconds: float = 0.04  # one encoder output frame (25 Hz default)


def is_endpoint(
    cfg: EndpointConfig,
    trailing_blank_frames: int,
    emitted_tokens: int,
    utterance_frames: int,
) -> bool:
    silence = trailing_blank_frames * cfg.frame_seconds
    length = utterance_frames * cfg.frame_seconds
    if emitted_tokens == 0 and silence >= cfg.min_trailing_silence_no_text:
        return True
    if emitted_tokens > 0 and silence >= cfg.min_trailing_silence_after_text:
        return True
    return length >= cfg.max_utterance_length
