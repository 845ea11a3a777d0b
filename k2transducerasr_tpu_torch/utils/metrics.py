"""WER/CER metrics — a copy of ``k2transducerasr_tpu/utils/metrics.py`` (pure
Python): Levenshtein counts, corpus-level WER and CER."""

from __future__ import annotations

import dataclasses


def edit_distance(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """Levenshtein alignment counts: (substitutions, insertions, deletions,
    correct)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels)
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], *prev[j - 1][1:])]
            else:
                cand = [(prev[j - 1][0] + 1, prev[j - 1][1] + 1, prev[j - 1][2], prev[j - 1][3])]
            cand.append((cur[j - 1][0] + 1, cur[j - 1][1], cur[j - 1][2] + 1, cur[j - 1][3]))
            cand.append((prev[j][0] + 1, prev[j][1], prev[j][2], prev[j][3] + 1))
            cur.append(min(cand))
        prev = cur
    cost, subs, ins, dels = prev[m]
    correct = n - subs - dels
    return subs, ins, dels, correct


@dataclasses.dataclass
class ErrorRate:
    errors: int
    total: int
    substitutions: int
    insertions: int
    deletions: int

    @property
    def rate(self) -> float:
        return self.errors / max(self.total, 1)


def _tokenize(text: str, unit: str) -> list[str]:
    if unit == "char":
        return [c for c in text if not c.isspace()]
    return text.split()


def measure(refs: list[str], hyps: list[str], unit: str = "word") -> ErrorRate:
    """Corpus-level WER (unit='word') or CER (unit='char' — use for zh)."""
    if len(refs) != len(hyps):
        raise ValueError("refs/hyps length mismatch")
    s = i = d = t = 0
    for r, h in zip(refs, hyps):
        rt, ht = _tokenize(r, unit), _tokenize(h, unit)
        subs, ins, dels, _ = edit_distance(rt, ht)
        s += subs
        i += ins
        d += dels
        t += len(rt)
    return ErrorRate(errors=s + i + d, total=t, substitutions=s, insertions=i, deletions=d)
