#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 asrbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``'s workload) names
its configuration and traffic mix; set-up, the measured window, the check
against the plain reference and the result are ``asrbench/core/harness.py``.
The last line of standard output is one JSON object; the numbers compared
by the check, each beside its limit, are the last lines of standard error
and the result's last key.  Exits non-zero, with no result, without a card
(or with fewer than the cell asks for), and if JAX or the JAX package was
loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "k2transducerasr_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, choices=("fp8",),
                    help="judge the control in the system's place (the reference with its "
                         "linears and convolutions in this precision)")
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    from asrbench.core.spec import load_cell

    cell = load_cell(ROOT, args.workload)  # raises without BENCHMARK.json or the cell

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    t_torch = time.perf_counter() - T_START
    from asrbench.core.harness import log, run_cell

    t_harness = time.perf_counter() - T_START
    log(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card_limit()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | imports: torch and the card "
        f"{t_torch:.3f} s, the harness and the system {t_harness - t_torch:.3f} s, "
        f"the card's name and limit {time.perf_counter() - T_START - t_harness:.3f} s")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START,
                   control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    trace = res.pop("trace", None)
    if args.trace:
        if trace is None or not trace.device:
            print("the traced span holds no device activity", file=sys.stderr)
            return 4
        from asrbench.core.yardstick import union_length
        device["busy_s"] = union_length([(s, e) for _, s, e in trace.device])
        device["window_s"] = trace.window_s
    compared = res.pop("compared")
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["compared"] = compared
    for k, v in compared.items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
