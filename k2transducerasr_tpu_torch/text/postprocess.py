"""Token-id sequence -> final text.

Behavioral contract from the reference (``OfflineRecognizer.cs:432-545``,
``OnlineRecognizer.cs:321-447``):

  * stop at token id 2 (<unk> doubling as an end marker), skip -1 fillers;
  * drop ``<blk>`` / ``<sos/eos>`` / ``<unk>`` symbols;
  * CJK symbols concatenate without separators; other symbols concatenate
    as-is (BPE pieces carry their own "▁" word boundary);
  * "▁" (U+2581) -> space;
  * runs of byte tokens ``<0xAB><0xCD>...`` -> raw bytes -> best-effort UTF-8
    (fairseq smart decode — the reference's C# uses lossy
    ``Encoding.UTF8.GetString``; we use the DP recovery the algorithm
    intends);
  * otherwise a smart-byte-decode pass (identity for ordinary text);
  * final lowercase.

Note: the reference's *offline* CheckText strips all spaces before smart
decode (``OfflineRecognizer.cs:498``), which contradicts the README's
documented transcripts (README.EN.md:97-101 shows spaced text); we treat that
as a regression and keep spaces, matching the published expected output.
"""

from __future__ import annotations

import re

from k2transducerasr_tpu_torch.text.bytebpe import smart_byte_decode
from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable

_HEX_RUN = re.compile(r"(?:<0x[0-9A-Fa-f]{2}>)+")
_SKIP_SYMBOLS = frozenset(("<blk>", "<sos/eos>", "<unk>"))

EOS_BREAK_ID = 2  # reference breaks assembly at token id 2


def is_cjk(s: str) -> bool:
    """Exact-match CJK check (reference: regex ^[\\u4e00-\\u9fa5]+$)."""
    return bool(s) and all("一" <= ch <= "龥" for ch in s)


def _decode_hex_run(match: re.Match) -> str:
    hex_digits = re.sub(r"<0x|>", "", match.group(0))
    if len(hex_digits) % 2:
        hex_digits += "20"  # reference pads odd hex with a space byte
    raw = bytes.fromhex(hex_digits)
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        # fairseq DP recovery over the byte stream
        from k2transducerasr_tpu_torch.text.bytebpe import BYTE_TO_BCHAR

        return smart_byte_decode("".join(BYTE_TO_BCHAR[b] for b in raw))


def assemble_symbols(token_ids, table: SymbolTable) -> str:
    parts: list[str] = []
    for tok in token_ids:
        tok = int(tok)
        if tok == EOS_BREAK_ID:
            break
        if tok == -1:
            continue
        sym = table.get(tok)
        if sym in _SKIP_SYMBOLS:
            continue
        parts.append(sym)
    return "".join(parts)


def finalize_text(raw: str) -> str:
    text = raw.replace("▁", " ")
    if _HEX_RUN.search(text):
        text = _HEX_RUN.sub(_decode_hex_run, text)
    else:
        decoded = smart_byte_decode(text)
        if decoded:
            text = decoded
    return text.lower()


def tokens_to_text(token_ids, table: SymbolTable) -> str:
    """Full pipeline: ids -> symbols -> text (the reference's DecodeMulti)."""
    return finalize_text(assemble_symbols(token_ids, table))
