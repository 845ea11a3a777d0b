"""Hotword n-best substitution — the port's copy of
``k2transducerasr_tpu/text/hotwords.py`` (pure Python): given the n-best
hypotheses of a beam search, prefer the one that carries a hotword.
"""

from __future__ import annotations


def apply_hotwords(nbest_texts: list[str], hotwords: list[str]) -> str:
    """Pick the n-best hypothesis containing the most hotword occurrences
    (case-insensitive); ties break toward the higher-ranked (earlier)
    hypothesis.  Empty hotwords -> the 1-best; empty n-best -> ""."""
    if not nbest_texts:
        return ""
    if not hotwords:
        return nbest_texts[0]
    lowered = [h.lower() for h in hotwords]

    def score(text: str) -> int:
        t = text.lower()
        return sum(t.count(h) for h in lowered)

    best = nbest_texts[0]
    best_score = score(best)
    for cand in nbest_texts[1:]:
        sc = score(cand)
        if sc > best_score:
            best, best_score = cand, sc
    return best


def boost_tokens(
    tokens: list[str], hotword_token_seqs: list[list[str]], nbest_tokens: list[list[str]]
) -> list[str]:
    """Token-level variant: if an n-best hypothesis contains a whole hotword
    token sequence that the 1-best lacks, substitute that hypothesis."""
    def contains(seq: list[str], sub: list[str]) -> bool:
        if not sub or len(sub) > len(seq):
            return False
        return any(seq[i : i + len(sub)] == sub for i in range(len(seq) - len(sub) + 1))

    for hw in hotword_token_seqs:
        if contains(tokens, hw):
            continue
        for cand in nbest_tokens:
            if contains(cand, hw):
                return cand
    return tokens
