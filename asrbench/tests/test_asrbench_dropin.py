"""A model type and a decoding method that the benchmark has not met are
files dropped into ``asrbench/models`` and ``asrbench/decoding``: with a
configuration, a mix, a limits file and the ``BENCHMARK.json`` entries, a
whole run (weights, the joiner fit, the window, the check) finds them by
name, and no file that is already there is edited.  The system's side of a
new family is the system's (its registry); the test registers the twin
there."""

import json
import os
import shutil

import pytest
import torch

from asrbench.core import spec
from asrbench.core.harness import run_cell
from asrbench.tests import tiny

TWIN_MODEL = '''"""zipformer2's file under another name, counting its calls."""
from asrbench.core import spec

_base = spec.plugin("models", "zipformer2")
CALLS = []
CONSTANT_RANGES = _base.CONSTANT_RANGES
output_dim = _base.output_dim


def _counted(name):
    def call(*a, **k):
        CALLS.append(name)
        return getattr(_base, name)(*a, **k)
    return call


build, encode = _counted("build"), _counted("encode")
offline_work, stream_work = _counted("offline_work"), _counted("stream_work")
'''

BEAM_STUB = '''"""A stand-in judge for modified_beam_search: no gap, and its kernel's
least time under its own key."""
import torch

CALLS = []


def served_gaps(ref, enc, tokens, stamps, streaming):
    CALLS.append(("served", len(tokens)))
    return torch.zeros(enc.shape[0])


def control_gaps(ref, enc, low, low_enc, tokens, stamps, streaming):
    return torch.zeros(enc.shape[0])


def work(cfg, encoder_dim, rows, frames, emissions, dtype, bandwidth):
    CALLS.append(("work", rows, frames))
    return {"flops": float(frames), "bounds": {"b": 1.0}}
'''


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_dropped_in_model_type_and_decoding_method_run_by_name(tmp_path, monkeypatch):
    bench_dir = tmp_path / "asrbench"
    for sub in ("configs", "traffic", "metrics", "limits", "models", "decoding"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), bench_dir / sub)
    before = {p: (bench_dir / p).read_bytes() for p in
              ("models/zipformer2.py", "decoding/greedy_search.py")}
    (bench_dir / "models" / "zipformer2_twin.py").write_text(TWIN_MODEL)
    (bench_dir / "decoding" / "modified_beam_search.py").write_text(BEAM_STUB)
    cfg = tiny.config(streaming=False)
    cfg.update(name="twin", model_type="zipformer2_twin", decoding_method="modified_beam_search")
    cfg["recognizer"]["max_active_paths"] = 2  # a recognizer option, passed by its name
    (bench_dir / "configs" / "twin.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "tiny_longform.json").write_text(json.dumps(tiny.mix("longform")))
    (bench_dir / "limits" / "twin_cell.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 1e-3, "lower": 0.0, "upper": 1.0, "readings": "test"}}))
    with open(os.path.join(os.path.dirname(spec.BENCH_DIR), "BENCHMARK.json"),
              encoding="utf-8") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "twin", "source": "https://example.org/twin",
                             "file": "asrbench/configs/twin.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "twin_cell", "config": "twin",
                               "traffic": "tiny_longform", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "offline_audio_s_per_s")["workloads"].append("twin_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    monkeypatch.setattr(spec, "_LOADED", {})
    from k2transducerasr_tpu_torch.models import registry
    monkeypatch.setitem(registry._PORTED, "zipformer2_twin", registry._PORTED["zipformer2"])

    cell = spec.load_cell(str(tmp_path), "twin_cell")
    res = run_cell(cell, 2**31 + 77, 2.0, False, "cpu")
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "offline_audio_s_per_s"}
    twin = spec.plugin("models", "zipformer2_twin")
    beam = spec.plugin("decoding", "modified_beam_search")
    assert {"build", "encode", "offline_work"} <= set(twin.CALLS)
    assert any(c[0] == "work" for c in beam.CALLS) and any(c[0] == "served" for c in beam.CALLS)
    for p, data in before.items():
        assert (bench_dir / p).read_bytes() == data
