"""What the benchmark knows of the ``greedy_search`` decoding method: how the
tokens it served are judged against the plain reference, and the work of
one search (the greedy kernel G's least time, the joiner's and decoder's
FLOPs).

Semantics (icefall's greedy search, as the system under test states them):
at most one symbol per encoder frame; a frame emits its argmax unless it is
blank or unk (or, in streaming, sos/eos).

A decoding method's file exports ``served_gaps``, ``control_gaps`` and
``work``; the check and the harness call nothing else of it, so another
method is another file of this folder, named as its configuration's
``decoding_method``.
"""

from __future__ import annotations

import torch

from asrbench.core import yardstick as Y
from asrbench.reference.transducer import BLANK, SOS, UNK


def _skip(streaming: bool) -> list:
    return [BLANK, UNK] + ([SOS] if streaming else [])


@torch.no_grad()
def served_gaps(ref, enc: torch.Tensor, tokens: list, stamps: list,
                streaming: bool) -> torch.Tensor:
    """The gap at every frame of ``enc`` by which the served choice (its
    token at that frame, or no emission) lies below the reference's best,
    under the decoder context the SERVED tokens built: [T'] float32 (0 where
    they agree).  A served token must sit on a frame of its own, in order,
    inside the utterance; one that does not gets an infinite gap."""
    t = enc.shape[0]
    stamps_t = torch.tensor(stamps, dtype=torch.long)
    bad = (len(tokens) != len(stamps) or len(tokens) > t
           or (len(stamps) and (stamps_t.min() < 0 or stamps_t.max() >= t))
           or bool((stamps_t[1:] <= stamps_t[:-1]).any()))
    if bad:
        return torch.full((max(t, 1),), float("inf"))
    emitted = torch.zeros(t, dtype=torch.long)
    emitted[stamps_t] = 1
    # the served context index at each frame: tokens emitted before it
    before = torch.cumsum(emitted, 0) - emitted
    dec = ref.decoder(ref.contexts(tokens))[before.to(ref.device)]
    logits = ref.logits(enc, dec)  # [T', V]
    best = logits.max(dim=1).values
    skip = _skip(streaming)
    no_emit = logits[:, skip].max(dim=1).values
    chosen = no_emit.clone()
    if tokens:
        tok = torch.tensor(tokens, device=ref.device)
        chosen[stamps_t.to(ref.device)] = logits[stamps_t.to(ref.device), tok]
        # a served token that is one the search never emits is wrong
        never = torch.isin(tok, torch.tensor(skip, device=ref.device))
        chosen[stamps_t.to(ref.device)[never]] = -float("inf")
    return (best - chosen).float().cpu()


@torch.no_grad()
def control_gaps(ref, enc: torch.Tensor, low, low_enc: torch.Tensor, tokens: list,
                 stamps: list, streaming: bool) -> torch.Tensor:
    """At every frame, under the served tokens' context: the gap by which
    the choice that ``low`` (the control) puts first, from its encoder
    frames ``low_enc`` and its joiner, lies below the reference's best: [T']
    float32."""
    t = min(enc.shape[0], low_enc.shape[0])
    emitted = torch.zeros(t, dtype=torch.long)
    emitted[torch.tensor([s for s in stamps if s < t], dtype=torch.long)] = 1
    before = (torch.cumsum(emitted, 0) - emitted).to(ref.device)
    dec = ref.decoder(ref.contexts(tokens))[before]
    mine, theirs = ref.logits(enc[:t], dec), low.logits(low_enc[:t], dec)
    skip = _skip(streaming)
    # the control's first choice: no emission if one of ``skip`` tops it
    pick = theirs.argmax(dim=1)
    no_emit = torch.isin(pick, torch.tensor(skip, device=ref.device))
    chosen = torch.where(no_emit, mine[:, skip].max(dim=1).values,
                         mine.gather(1, pick[:, None])[:, 0])
    return (mine.max(dim=1).values - chosen).float().cpu()


def work(cfg: dict, encoder_dim: int, rows: int, frames: int, emissions: int, dtype,
         bandwidth) -> dict:
    """One search over ``rows`` lanes, ``frames`` valid encoder frames in
    all and ``emissions`` tokens: the joiner's and decoder's FLOPs, and G's
    least time (``bounds``, ms)."""
    d = cfg["decoder"]
    nb, ops = Y.greedy_bytes_ops(rows, frames, emissions, context=d["context_size"],
                                 vocab=cfg["vocab_size"], decoder_dim=d["decoder_dim"],
                                 joiner_dim=cfg["joiner"]["joiner_dim"],
                                 elem_bytes=torch.finfo(dtype).bits // 8)
    flops = Y.search_flops(frames, emissions, encoder_dim=encoder_dim,
                           joiner_dim=cfg["joiner"]["joiner_dim"], vocab=cfg["vocab_size"],
                           decoder_dim=d["decoder_dim"], context=d["context_size"],
                           groups=d["decoder_dim"] // 4)
    return {"flops": flops, "bounds": {"g": Y.bound(nb, ops, dtype, bandwidth)[0]}}
