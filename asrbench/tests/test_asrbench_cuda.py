"""On the card (marker ``cuda``; each test skips without one): each cell runs
at its own size through ``asrbench/run.py`` and comes out correct, and its
control, the reference with its linears and convolutions in fp8 (the
nearest precision below the configuration's bf16) put in the system's
place, comes out not correct on three seeds.

    python -m pytest --noconftest -m cuda -s asrbench/tests/test_asrbench_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest

from asrbench.core.spec import BENCH_DIR

ROOT = os.path.dirname(BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(cell, seed, *extra):
    out = subprocess.run([sys.executable, "asrbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "6", "--trace", "0", *extra], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    _card()
    res = _run(cell, 2**31 + 17)
    print(cell, "sound", res["compared"])
    assert res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cell):
    _card()
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        res = _run(cell, seed, "--control", "fp8")
        print(cell, seed, "fp8 control", res["compared"])
        assert not res["correct"], (seed, res["compared"])
