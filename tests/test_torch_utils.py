"""The port's ``utils/``: the WER/CER metrics equal the JAX package's
(hypothesis), ``Stopwatch`` reports what the JAX one reports, and ``trace``
writes a Chrome trace of the block (CPU activity here)."""

import glob
import json

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from k2transducerasr_tpu.utils import metrics as jmetrics
from k2transducerasr_tpu.utils import profiling as jprofiling
from k2transducerasr_tpu_torch.utils import metrics, profiling

WORDS = st.lists(st.sampled_from(["a", "b", "c", "dd", "好", "世"]), max_size=12)


@given(WORDS, WORDS)
@settings(max_examples=200, deadline=None)
def test_edit_distance_equals_jax(ref, hyp):
    assert metrics.edit_distance(ref, hyp) == jmetrics.edit_distance(ref, hyp)


@given(st.lists(st.tuples(WORDS, WORDS), max_size=5), st.sampled_from(["word", "char"]))
@settings(max_examples=100, deadline=None)
def test_measure_equals_jax(pairs, unit):
    refs = [" ".join(r) for r, _ in pairs]
    hyps = [" ".join(h) for _, h in pairs]
    got, want = metrics.measure(refs, hyps, unit), jmetrics.measure(refs, hyps, unit)
    assert (got.errors, got.total, got.substitutions, got.insertions, got.deletions,
            got.rate) == (want.errors, want.total, want.substitutions, want.insertions,
                          want.deletions, want.rate)


def test_measure_rejects_unequal_lengths():
    with pytest.raises(ValueError, match="length mismatch"):
        metrics.measure(["a"], [])


def test_stopwatch_report_equals_jax():
    ours, theirs = profiling.Stopwatch(), jprofiling.Stopwatch()
    for sw in (ours, theirs):
        sw.wall, sw.audio = 1.2345678, 7.5
    assert ours.report() == theirs.report()
    assert (ours.rtf, ours.audio_s_per_s) == (theirs.rtf, theirs.audio_s_per_s)
    sw = profiling.Stopwatch().start()
    sw.stop(2.0)
    assert sw.audio == 2.0 and sw.wall >= 0.0 and sw.report().startswith("elapsed_milliseconds:")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
