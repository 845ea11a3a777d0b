"""Where the conformer cell's device time goes, by module and op, on the card.

    python3 tools/conformer_split.py [--seed N] [--rounds 10]

Builds the benchmark's ``conf_offline_longform`` system (the
``conformer_librispeech_offline`` configuration, random weights from the
seed, bf16) and its one batch shape, 20 x 30 s.  Then:

* **the split**: one eager ``OfflineRecognizer.encode`` of the batch under
  ``torch.profiler``, each op of ``models/conformer.py`` (the embed's two
  convolutions and its linear, the linears, K2, the pointwise and depthwise
  convolutions, BatchNorm, Swish, GLU, LayerNorm) in a ``record_function``
  scope of its own named by the module that called it; the device time of
  the kernels each scope launched, and "other" (the residual adds, the
  scaling, the masks, fbank) as the rest of the kernels' time;
* **the replay**: the device time of one replay of the batch's graph
  (CUDA events over ``--rounds`` replays queued back to back, after two
  warm decodes).

Both run with TF32 off for the process, as the benchmark's harness leaves it
once its reference has run; the port's bf16-operand convolutions allow it
for themselves (``ops/layers.py::conv_tf32``).

Prints the card's name and power limit and one JSON line per part.  Needs
one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "conf_offline_longform"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def build(cfg: dict, tree: dict, pcm):
    from asrbench.core import system
    rec = system.build(cfg, tree, "cuda")
    streams = []
    for row in pcm:
        s = rec.create_offline_stream()
        s.add_samples(row)
        streams.append(s)
    return rec, streams


def scoped_ops(region: list):
    """Wrap the ops ``models/conformer.py`` calls in scopes named
    ``<module>.<op>`` (the module: the innermost of embed, ff, attn, conv
    being run); -> a function that undoes it."""
    from k2transducerasr_tpu_torch.models import conformer as M
    from k2transducerasr_tpu_torch.ops import layers as L

    saved = []

    def patch(owner, name, wrap):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrap(getattr(owner, name)))

    def module(tag):
        def wrap(fn):
            def call(*a, **k):
                region.append(tag)
                try:
                    return fn(*a, **k)
                finally:
                    region.pop()
            return call
        return wrap

    def op(tag):
        def wrap(fn):
            def call(*a, **k):
                name = tag(*a, **k) if callable(tag) else tag
                with torch.profiler.record_function(f"split:{region[-1]}.{name}"):
                    return fn(*a, **k)
            return call
        return wrap

    for name, tag in (("subsample", "embed"), ("_ff", "ff"), ("rel_pos_attention", "attn"),
                      ("_conv_module", "conv")):
        patch(M, name, module(tag))
    embed_convs = collections.Counter()

    def conv2d_tag(*a, **k):
        embed_convs["n"] += 1
        return f"conv{2 - embed_convs['n'] % 2}"

    patch(L, "apply_conv2d", op(conv2d_tag))
    patch(L, "apply_conv1d",
          op(lambda p, x, groups=1, **k: "depthwise" if groups > 1 else "pointwise"))
    for name in ("apply_linear", "apply_layernorm", "apply_batchnorm", "swish", "glu"):
        patch(L, name, op(name.replace("apply_", "")))
    patch(M, "relpos_attn_ctx", op("k2"))
    return lambda: [setattr(o, n, f) for o, n, f in reversed(saved)]


def split(rec, streams) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    region = ["block"]  # the block's own LayerNorms (attention's input, norm_final)
    samples, counts = rec.pcm_batch(streams)
    rec.encode(samples, counts)  # warm
    undo = scoped_ops(region)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rec.encode(samples, counts)
            torch.cuda.synchronize()
    finally:
        undo()
    events = prof.events()
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    parts = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("split:"):
            parts[e.name[len("split:"):]] += e.device_time_total
    # K2 is launched through ctypes, outside the profiler's op tree: by name
    parts["attn.k2"] += sum(e.time_range.elapsed_us() for e in events
                            if e.device_type == DeviceType.CUDA and "relpos_attn_ctx" in e.name)
    parts["other"] = total - sum(parts.values())
    return {"kernels_ms": total / 1e3,
            "parts_ms": {k: v / 1e3 for k, v in sorted(parts.items(), key=lambda kv: -kv[1])}}


def replay_ms(rec, streams, rounds: int) -> float:
    """The device time of one replay of the batch's graph: ``rounds``
    replays queued back to back between two events."""
    for _ in range(2):
        rec.end_decode(rec.begin_decode(streams))
    (entry,) = rec.program.entries.values()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 29)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from asrbench.core import audio, spec, system, traffic, weights

    print(json.dumps({"card": card(), "torch": torch.__version__}), flush=True)
    cell = spec.load_cell(ROOT, CELL)
    cfg, mix = cell.config, cell.traffic
    tree = weights.make_tree(system.init_fns(cfg), args.seed, "cuda",
                             spec.model(cfg).CONSTANT_RANGES)
    n = traffic.seconds_to_samples(mix["segment_s"], cfg["frontend"]["sample_rate"])
    pcm = audio.as_float(audio.clips(int(mix["rows"]), n, args.seed + 1, "cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, streams = build(cfg, tree, pcm)
    print(json.dumps({"split": split(rec, streams)}), flush=True)
    print(json.dumps({"replay_ms": replay_ms(rec, streams, args.rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
