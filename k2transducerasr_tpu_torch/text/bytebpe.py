"""Byte-level BPE text recovery (fairseq/icefall ``byte_utils`` semantics).

The reference ports fairseq's byte_utils to C# (``Utils/ByteDataHelper.cs``,
itself copied from icefall/fairseq).  We implement the same published
algorithm: a 256-entry byte -> printable-char table and a dynamic-programming
"smart decode" that recovers the longest valid UTF-8 subsequence from a
possibly-corrupt byte stream.

The printable-char table is generated from its defining rule rather than
enumerated: codepoints 256..287 stand in for control bytes 0..31, printable
ASCII 32..126 maps to itself, and bytes 127..255 map to ascending codepoints
from 288 skipping the six non-keyboard letters {306, 307, 319, 320, 329, 383}
(Ĳ ĳ Ŀ ŀ ŉ ſ).
"""

from __future__ import annotations

import re

SPACE = chr(32)
SPACE_ESCAPE = chr(9601)  # "▁"
BPE_UNK = chr(8263)  # "⁇"

_WHITESPACE = re.compile(r"\s+")


def _printable_base_chars() -> list[int]:
    out = list(range(256, 288)) + list(range(32, 127))
    c = 288
    skips = {306, 307, 319, 320, 329, 383}
    while len(out) < 256:
        if c not in skips:
            out.append(c)
        c += 1
    return out


_PRINTABLE = _printable_base_chars()
BYTE_TO_BCHAR = {b: chr(_PRINTABLE[b]) for b in range(256)}
BCHAR_TO_BYTE = {c: b for b, c in BYTE_TO_BCHAR.items()}
BCHAR_TO_BYTE[BPE_UNK] = 32  # unknown char decodes to space


def byte_encode(x: str) -> str:
    """Whitespace-normalize then map each UTF-8 byte to its printable char."""
    normalized = _WHITESPACE.sub(SPACE, x)
    return "".join(BYTE_TO_BCHAR[b] for b in normalized.encode("utf-8"))


def byte_decode(x: str) -> str:
    """Inverse of byte_encode; returns "" if the bytes are not valid UTF-8
    (mirroring the reference's try/catch contract, ByteDataHelper.cs:331-346)."""
    try:
        return bytes(BCHAR_TO_BYTE[c] for c in x).decode("utf-8")
    except (KeyError, UnicodeDecodeError):
        return ""


def smart_byte_decode(x: str) -> str:
    """Best-effort decode: if plain decode fails, run the fairseq DP that
    keeps the maximum number of decodable 1..4-byte groups."""
    out = byte_decode(x)
    if out != "" or not x:
        return out
    n = len(x)
    f = [0] * (n + 1)  # best #chars recovered using first i symbols
    pt = [0] * (n + 1)
    for i in range(1, n + 1):
        f[i], pt[i] = f[i - 1], i - 1
        for j in range(1, min(4, i) + 1):
            if f[i - j] + 1 > f[i] and byte_decode(x[i - j : i]):
                f[i], pt[i] = f[i - j] + 1, i - j
    pieces: list[str] = []
    cur = n
    while cur > 0:
        if f[cur] == f[pt[cur]] + 1:
            pieces.append(byte_decode(x[pt[cur] : cur]))
        cur = pt[cur]
    return "".join(reversed(pieces))
