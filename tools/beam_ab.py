"""What each part of the beam search kernel's design buys, timed on the card.

    python3 tools/beam_ab.py [--parent PARENT.cu] [--rounds N]

Builds ``k2transducerasr_tpu_torch/csrc/rnnt_beam.cu`` and, from it, each
entry of ABLATIONS (a text substitution that takes one part of the design
back: every emission step through the second exchange, a cluster barrier
after every mbarrier wait, the float32 logits a thread per (column, row),
the bf16 refresh on the CUDA cores instead of mma.sync, every top K by K
rounds of warp reductions instead of one pairwise pass, the staging and the
table gather 4 bytes a thread instead of 16); with ``--parent``, also an
earlier version of the kernel (its C entry's first 35 arguments those of
today's: it ignores the counter and P, and runs one lane a cluster).  The
builds are made and swapped in under the wrapper
(``decode/rnnt_beam.beam_frames_skip``) by ``tools/kernel_ab.py``.  Today's
kernel at the wrapper's own choice of P is timed beside P = 1 forced (one
lane a cluster: the wrapper's choice replaced).  The cases are
``chip_smoke.py`` [3d]'s offline shapes: the decoder and joiner of
``Zipformer2Config(causal=True)`` from seed 0 (vocab 500), 16 lanes x 766
random encoder frames (a ``torch.Generator`` seeded 12) at K = 4, in bf16
and in float32.  Per case the builds run in rounds (default 2), in list
order and then reversed; a run is the median of 5 calls timed by CUDA
events after 2 warm calls.  Every exact ablation must give today's state
and recorded choices bit for bit.  The CUDA-core refresh and the parent
may differ in bf16 (their decoder outputs sum in another order than the
tensor cores', so a last bit can differ); a difference is printed.  Prints
the card's name and power limit, then one line per case and build with
every time and the median.  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k2transducerasr_tpu_torch import ModelBundle  # noqa: E402
from k2transducerasr_tpu_torch.decode import rnnt_beam, rnnt_greedy  # noqa: E402
from k2transducerasr_tpu_torch.models import joiner as joiner_mod  # noqa: E402
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config  # noqa: E402
from k2transducerasr_tpu_torch.ops import cuda_build  # noqa: E402
from kernel_ab import build, card, median_ms, restore, use  # noqa: E402

FIELDS = ("hyp", "dec_proj", "score", "tokens", "timestamps", "count")
_F32_PER_ROW = '''template <int RT>
__device__ __forceinline__ void logits_f32(const Args& a, int rows, const float* W, int count,
                                           int col0, const float* sA, const float* bias,
                                           float* L, int lcol0) {
  for (int i = threadIdx.x; i < count * 8 * rows; i += kThreads) {
    const int k = i % rows, cl = i / rows, col = col0 + cl;
    if (col >= a.V) continue;
    const float* w = W + (size_t)(cl >> 3) * a.Jp * 8 + (cl & 7);
    const float* x = sA + (size_t)k * a.Jp;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + 4 <= a.J; j += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(x[j + e], w[(size_t)(j + e) * 8], acc[e]);
    }
    for (; j < a.J; ++j) acc[0] = fmaf(x[j], w[(size_t)j * 8], acc[0]);
    L[k * a.p.ls + col - lcol0] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + bias[col];
  }
}

'''
_PAIRS = """  if (n <= 32) return warp_top_k_pairs<1>(K, n, get, slot);
  if (n <= 64) return warp_top_k_pairs<2>(K, n, get, slot);
  if (n <= 128) return warp_top_k_pairs<4>(K, n, get, slot);
"""
# (label, [(text, replacement)], dtypes it changes, whether it must give
# today's results bit for bit)
ABLATIONS = [
    ("every emission step through the second exchange",
     [("amb = __any_sync(0xffffffffu, k < K && !(s.rowlast[r] < vk));",
       "amb = vk == vk || true;")], ("bf16", "float32"), True),
    ("a cluster barrier after every mbarrier wait",
     [("& 1u);\n", "& 1u);\n    cluster_sync();\n")], ("bf16", "float32"), True),
    ("float32 logits a thread per (column, row)", [("LOGITS_F32", _F32_PER_ROW)], ("float32",),
     True),
    ("the bf16 refresh on the CUDA cores (refresh_beams)",
     [("const bool mma = BF && a.D % 16 == 0;", "const bool mma = false;")], ("bf16",), False),
    ("every top K by K rounds of warp reductions", [(_PAIRS, "")], ("bf16", "float32"), True),
    ("staging and table gather 4 bytes a thread",
     [("const bool vec_enc = a.J % (BF ? 8 : 4) == 0", "const bool vec_enc = false && a.J"),
      ("const int vec = a.D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.tables) & 15) == 0 ? 4 : 1;",
       "const int vec = 1;")], ("bf16", "float32"), True),
]


def ablated(src: str, subs) -> str:
    for old, new in subs:
        if old == "LOGITS_F32":  # the whole function
            start = src.index("template <int RT>\n__device__ __forceinline__ void logits_f32(")
            end = src.index("// ---", start)
            src = src[:start] + new + src[end:]
            continue
        if old not in src:
            raise SystemExit(f"beam_ab: {old!r} not in rnnt_beam.cu")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("beam_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"card: {card()}", flush=True)
    with open(cuda_build.source_path("rnnt_beam")) as f:
        today = f.read()
    sources = {"today": today}
    for label, subs, _, _ in ABLATIONS:
        sources[label] = ablated(today, subs)
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    fns = build("rnnt_beam", sources, rnnt_beam._ARGTYPES)
    exact = {label: ex for label, _, _, ex in ABLATIONS}
    exact["today"] = True
    choose_p = rnnt_beam.lanes_per_cluster

    def force_lanes(lanes):
        """P forced to ``lanes`` (None: the wrapper's own choice), the
        wrapper's cached launch shapes dropped."""
        rnnt_beam.lanes_per_cluster = choose_p if lanes is None else (
            lambda batch, beams, at_once: lanes)
        rnnt_beam._kernel_lanes.cache_clear()

    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=True), vocab_size=500,
                                seed=0, device="cuda")
    dec, join, cfg = bundle.decoder, bundle.joiner, bundle.decoder_cfg
    g = torch.Generator(device="cuda").manual_seed(12)
    enc_dim = join["encoder_proj"]["w"].shape[0]
    b, t, k = 16, 766, 4
    x = torch.randn((b, t, enc_dim), generator=g, device="cuda")
    lens = torch.full((b,), t, device="cuda")
    zero = torch.zeros(b, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        for dtype, dname in ((torch.bfloat16, "bf16"), (None, "float32")):
            ops = rnnt_greedy.greedy_operands(dec, cfg, join, dtype)
            enc = joiner_mod.project_encoder(join, x, dtype)
            st = rnnt_beam.init_state(dec, cfg, join, b, k, 1024, dtype)
            runs = [("today", None), ("today", 1)]
            runs += [(label, None) for label, _, dts, _ in ABLATIONS if dname in dts]
            runs += [("parent", None)] if args.parent else []

            def call(trace=None):
                return rnnt_beam.beam_frames_skip(dec, cfg, join, st, enc, lens, zero, False,
                                                  dtype, operands=ops, trace=trace)

            want = None
            times = {r: [] for r in runs}
            for order in range(2 * args.rounds):
                for run in (runs if order % 2 == 0 else runs[::-1]):
                    label, lanes = run
                    use("rnnt_beam", fns[label])
                    force_lanes(lanes)
                    trace = rnnt_beam.BeamTrace.empty(b, t, k, "cuda")
                    got = call(trace)
                    torch.cuda.synchronize()
                    now = [getattr(got, f) for f in FIELDS] + [trace.steps, trace.values]
                    if want is None:
                        want = now
                    elif not all(torch.equal(p, q) for p, q in zip(want, now)):
                        differ = [f for f, p, q in zip(FIELDS + ("steps", "values"), want, now)
                                  if not torch.equal(p, q)]
                        print(f"{dname} {label} P={lanes}: {differ} differ from today's kernel",
                              flush=True)
                        if exact.get(label, False):
                            return 1
                    times[run].append(median_ms(call, reps=5))
                    force_lanes(None)
            for (label, lanes), ts in times.items():
                what = label + (" with P = 1 (one lane a cluster)" if lanes == 1 else "")
                print(f"{dname} 16 x 766, K=4 | {what}: {[round(x_, 4) for x_ in ts]} median "
                      f"{statistics.median(ts):.4f} ms", flush=True)
    restore("rnnt_beam")
    return 0


if __name__ == "__main__":
    sys.exit(main())
