"""Nothing the harness runs imports JAX or the JAX package, and the plain
reference imports nothing of the system under test: each checked in a
fresh interpreter by the top-level name of every loaded module, whole (the
system's package name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from asrbench.core.spec import BENCH_DIR

ROOT = os.path.dirname(BENCH_DIR)


# every model type's and decoding method's file (the reference side of a run)
_PLUGINS = ("import os\n"
            "for kind in ('models', 'decoding'):\n"
            "    for f in sorted(os.listdir(os.path.join(spec.BENCH_DIR, kind))):\n"
            "        if f.endswith('.py'):\n"
            "            spec.plugin(kind, f[:-3])\n")


def _loaded_tops(code: str) -> set:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=240, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _loaded_tops("import asrbench.run, asrbench.core.harness, asrbench.core.system\n"
                        "from asrbench.core import spec\n"
                        "[spec.reader(m) for m in ('host_ms', 'replay_ms', 'idle_share', "
                        "'k1_roofline', 'g_roofline', 'mfu')]\n" + _PLUGINS)
    assert "k2transducerasr_tpu_torch" in tops  # the system under test
    assert not tops & {"jax", "jaxlib", "flax", "k2transducerasr_tpu"}


def test_the_reference_loads_nothing_of_the_system():
    tops = _loaded_tops("import asrbench.reference.zipformer2, asrbench.reference.fbank, "
                        "asrbench.reference.transducer, asrbench.core.check\n"
                        "from asrbench.core import spec\n" + _PLUGINS)
    assert not tops & {"jax", "jaxlib", "flax", "k2transducerasr_tpu",
                       "k2transducerasr_tpu_torch"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "asrbench/run.py", "--workload", "z2_offline_longform",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=240)
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if not has_card:
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_nothing_reads_the_old_benchmarks_folder():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py") and f != os.path.basename(__file__):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    text = fh.read()
                assert "benchmarks/" not in text and "import benchmarks" not in text, f
