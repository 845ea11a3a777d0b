"""A/B timing of two builds of the greedy search kernel on the card.

    python3 tools/greedy_ab.py A.cu B.cu [--pairs N]

A.cu and B.cu are versions of ``k2transducerasr_tpu_torch/csrc/rnnt_greedy.cu``
(its C interface unchanged), built and swapped in under the wrapper
(``decode/rnnt_greedy.greedy_frames_skip``) by ``tools/kernel_ab.py``.  The
cases are ``chip_smoke.py`` [3c]'s bf16 shapes: the decoder and joiner of
``Zipformer2Config(causal=True)`` from seed 0 (vocab 500), random encoder
frames from a ``torch.Generator`` seeded 11; 16 full lanes x 766 frames (two waves of clusters on an H100 SXM), 15 lanes (one
wave), and a streaming step of 16 lanes x 16 frames.  Per case the builds run
in the order A B B A, N times (default 4); each run is the median of 10 calls
timed by CUDA events after 2 warm calls.  Both builds must give the same
state bit for bit.  Prints the card's name and power limit, then one line per
case with every time and the medians.  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k2transducerasr_tpu_torch import ModelBundle  # noqa: E402
from k2transducerasr_tpu_torch.decode import rnnt_greedy  # noqa: E402
from k2transducerasr_tpu_torch.models import joiner as joiner_mod  # noqa: E402
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config  # noqa: E402
from kernel_ab import build, card, median_ms, restore, use  # noqa: E402

CASES = (("offline, 16 full lanes", 16, 766), ("offline, 15 lanes (one wave)", 15, 766),
         ("streaming step, 16 x 16", 16, 16))
FIELDS = ("hyp", "dec_proj", "tokens", "timestamps", "count", "trailing_blanks")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("greedy_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"card: {card()}", flush=True)
    texts = {}
    for label, path in (("A", args.a), ("B", args.b)):
        with open(path) as f:
            texts[label] = f.read()
    fns = build("rnnt_greedy", texts, rnnt_greedy._ARGTYPES)
    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=True), vocab_size=500,
                                seed=0, device="cuda")
    dec, join, cfg = bundle.decoder, bundle.joiner, bundle.decoder_cfg
    bf16 = torch.bfloat16
    ops = rnnt_greedy.greedy_operands(dec, cfg, join, bf16)
    g = torch.Generator(device="cuda").manual_seed(11)
    enc_dim = join["encoder_proj"]["w"].shape[0]
    with torch.inference_mode():
        for name, b, t in CASES:
            enc = joiner_mod.project_encoder(
                join, torch.randn((b, t, enc_dim), generator=g, device="cuda"), bf16)
            st = rnnt_greedy.init_state(dec, cfg, join, b, 1024, bf16)
            lens = torch.full((b,), t, device="cuda")
            zero = torch.zeros(b, dtype=torch.int64, device="cuda")

            def call():
                return rnnt_greedy.greedy_frames_skip(dec, cfg, join, st, enc, lens, zero, False,
                                                      bf16, operands=ops)

            outs, times = {}, {"A": [], "B": []}
            for which in "ABBA" * args.pairs:
                use("rnnt_greedy", fns[which])
                outs[which] = call()
                times[which].append(median_ms(call))
            same = all(torch.equal(getattr(outs["A"], f), getattr(outs["B"], f)) for f in FIELDS)
            print(f"{name}: A {[round(x, 4) for x in times['A']]} median "
                  f"{statistics.median(times['A']):.4f} ms | B {[round(x, 4) for x in times['B']]} "
                  f"median {statistics.median(times['B']):.4f} ms | identical {same}", flush=True)
            if not same:
                return 1
    restore("rnnt_greedy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
