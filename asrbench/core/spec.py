"""Finding a cell's parts by name: the workload in ``BENCHMARK.json``, its
configuration (the file its ``configs`` entry names), its traffic mix
(``asrbench/traffic/<traffic>.json``), the limits of its check
(``asrbench/limits/<workload>.json``), what the benchmark knows of the
configuration's model type (``asrbench/models/<model_type>.py``: its plain
reference, its work counts, its constant leaves) and of its decoding method
(``asrbench/decoding/<decoding_method>.py``: how its served output is judged,
its work counts), and the reader of each per-layer metric
(``asrbench/metrics/<name>.py``, or ``<name before the first dot>.py`` for a
quantity split by the end-to-end metric it moves).  Adding a cell, a mix, a
model type, a decoding method or a metric adds files and entries; no file
here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports
    limits: dict = dataclasses.field(default_factory=dict)  # number compared -> its limit


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Cell:
    """The workload ``workload`` of ``root/BENCHMARK.json``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(traffic_path(w["traffic"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload) and m["moves"] in names]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer, limits(workload))


def limits(workload: str) -> dict:
    """The limit of each number the cell's check compares
    (``asrbench/limits/<workload>.json``: name -> {"limit", and the
    readings it was set from}); none without the file."""
    path = os.path.join(BENCH_DIR, "limits", f"{workload}.json")
    if not os.path.exists(path):
        return {}
    return {k: v["limit"] for k, v in load_json(path).items()}


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


_LOADED: dict = {}


def plugin(kind: str, name: str):
    """The module ``asrbench/<kind>/<name>.py``, loaded once per path."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no asrbench/{kind}/{name}.py")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"asrbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def model(cfg: dict):
    """What the benchmark knows of the configuration's model type."""
    return plugin("models", cfg["model_type"])


def decoding(cfg: dict):
    """What the benchmark knows of the configuration's decoding method."""
    return plugin("decoding", cfg["decoding_method"])


def reader(metric: str):
    """The ``read(ctx, metric)`` function of a per-layer metric's reader."""
    for stem in (metric, metric.split(".")[0]):
        if os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{stem}.py")):
            return plugin("metrics", stem).read
    raise FileNotFoundError(f"no reader for the metric {metric!r} under asrbench/metrics")
