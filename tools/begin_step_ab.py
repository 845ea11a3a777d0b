"""``OnlineRecognizer.begin_step``'s host time on the card, for two checkouts
of the port, in turns.

    python3 tools/begin_step_ab.py ROOT_A ROOT_B [--rounds 2] [--family zipformer2]
                                   [--method greedy_search]

runs one process per checkout and round, in the order A, B, B, A (each
further round the same), on one card.  Each process imports the port from
its ROOT (its kernels built there, from its own sources) and drives a
full-width streaming recognizer: the family's causal flagship config
(``Zipformer2Config(causal=True)``, ``ConformerConfig(causal=True)``,
``ZipformerConfig(causal=True)`` or ``LstmConfig()``), random weights from
seed 0, vocabulary 500, bf16, 16 lanes of 10 s of synthetic speech-band
audio each.  A first ``get_results`` captures the step's graph; then every
step with all 16 lanes ready is ``begin_step`` timed on the host clock, the
card idle before it, and ``end_step``.  Prints one JSON line per process
and, last, the card (``nvidia-smi --query-gpu=name,power.limit``) with each
checkout's median over all of its steps.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LANES, SECONDS = 16, 10.0


def synth_pcm(n: int, seed: int):
    """chip_smoke.py's speech-band test signal."""
    import numpy as np

    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 180.0 + 40.0 * (seed % 7)
    return (
        0.22 * np.sin(2 * np.pi * (f0 + 15.0 * np.sin(2 * np.pi * 0.31 * t)) * t)
        + 0.18 * np.sin(2 * np.pi * (2.37 * f0) * t + 1.0 + 0.8 * np.sin(2 * np.pi * 0.47 * t))
        + 0.12 * rng.standard_normal(n)
    ).astype(np.float32)


def measure(root: str, family: str, method: str) -> dict:
    """One checkout's begin_step host ms per step (see the module
    docstring)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from k2transducerasr_tpu_torch import ModelBundle, OnlineRecognizer
    from k2transducerasr_tpu_torch.models.conformer import ConformerConfig
    from k2transducerasr_tpu_torch.models.lstm import LstmConfig
    from k2transducerasr_tpu_torch.models.zipformer import ZipformerConfig
    from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

    cfg = {"zipformer2": lambda: Zipformer2Config(causal=True),
           "zipformer2ctc": lambda: Zipformer2Config(causal=True),
           "conformer": lambda: ConformerConfig(causal=True),
           "zipformer": lambda: ZipformerConfig(causal=True), "lstm": LstmConfig}[family]()
    bundle = ModelBundle.random(family, cfg, vocab_size=500, seed=0, device="cuda")
    rec = OnlineRecognizer(bundle, decoding_method=method, max_lanes=LANES, device="cuda")
    streams = []
    for i in range(LANES):
        s = rec.create_online_stream()
        s.add_samples(synth_pcm(int(16000 * SECONDS), 700 + i))
        streams.append(s)
    rec.get_results(streams)  # the capture
    host = []
    while all(s._ready() for s in streams):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = rec.begin_step(streams)
        host.append((time.perf_counter() - t0) * 1e3)
        rec.end_step(pending)
    return {"root": root, "family": family, "method": rec.decoding_method, "steps": len(host),
            "graphs": len(rec.program), "begin_step_host_ms": statistics.median(host),
            "all_ms": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="two checkouts of the repo: A and B")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--family", default="zipformer2")
    ap.add_argument("--method", default="greedy_search")
    ap.add_argument("--measure", help="(internal) measure the checkout at this root")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.family, args.method)), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two roots")
    runs = {root: [] for root in args.roots}
    order = [args.roots[0], args.roots[1], args.roots[1], args.roots[0]] * args.rounds
    for root in order[:2 * args.rounds]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                              "--family", args.family, "--method", args.method],
                             capture_output=True, text=True, check=False)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        runs[root].extend(row["all_ms"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({"card": card, "family": args.family, "method": args.method,
                      "median_begin_step_host_ms": {r: statistics.median(ms)
                                                    for r, ms in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
