"""BENCHMARK.json keeps to the contract's names, units and shapes, every part
it names exists under ``asrbench/``, and a configuration, traffic mix or
metric reader dropped into its folder is found by name with no file edited."""

import json
import os
import re
import shutil

import pytest

from asrbench.core import spec
from asrbench.core.harness import LOOPS

ROOT = os.path.dirname(spec.BENCH_DIR)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["asrbench"] and b["command"] == ["python3", "asrbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(json.dumps(b)) < 64 * 1024


def test_names_units_and_lines():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in b["configs"]:
        for k in c["reduced"]:
            assert spec.NAME.match(k)


def test_entries_have_just_their_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = _bench()
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in b["end_to_end"])
    for w in b["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(spec.reader(m["name"]))
        assert cell.traffic["loop"] in LOOPS


def test_every_configuration_is_used_and_its_file_is_its_own():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("asrbench/configs/")
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_every_cell_has_its_limits():
    for w in _bench()["workloads"]:
        lim = spec.load_json(os.path.join(spec.BENCH_DIR, "limits", f"{w['name']}.json"))
        gap = lim["max_logit_gap"]
        # above the lower reading, below the upper, which is 3x the lower or more
        assert gap["lower"] < gap["limit"] < gap["upper"]
        assert gap["upper"] >= 3 * gap["lower"]


def test_paths_hold_only_the_benchmark():
    for p in _bench()["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))


def test_a_dropped_in_cell_is_found_by_name(tmp_path, monkeypatch):
    """A new configuration, mix and metric reader are files of their own and
    a BENCHMARK.json entry each: the harness finds them, no file edited."""
    bench_dir = tmp_path / "asrbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), bench_dir / sub)
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "zipformer2_librispeech_medium.json"))
    cfg["name"] = "new_model"
    (bench_dir / "configs" / "new_model.json").write_text(json.dumps(cfg))
    mix = spec.load_json(spec.traffic_path("longform"))
    mix["rows"] = 8
    (bench_dir / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(ctx, name):\n    return 42.0\n")
    b = _bench()
    b["configs"].append({"name": "new_model", "source": "https://example.org/new",
                         "file": "asrbench/configs/new_model.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new_cell", "config": "new_model", "traffic": "new_mix",
                           "chips": 1, "why": "x"})
    tput = next(m for m in b["end_to_end"] if m["name"] == "offline_audio_s_per_s")
    tput["workloads"].append("new_cell")
    b["per_layer"].append({"name": "new_metric.tput", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "x",
                           "moves": "offline_audio_s_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    cell = spec.load_cell(str(tmp_path), "new_cell")
    assert cell.config["name"] == "new_model" and cell.traffic["rows"] == 8
    assert [m["name"] for m in cell.per_layer] == ["new_metric.tput"]
    assert spec.reader("new_metric.tput")(None, "new_metric.tput") == 42.0
    # a per-layer metric split by the end-to-end metric it moves reads its base's reader
    assert spec.reader("mfu.req").__module__.endswith("mfu")
    with pytest.raises(KeyError):
        spec.load_cell(str(tmp_path), "no_such_cell")
