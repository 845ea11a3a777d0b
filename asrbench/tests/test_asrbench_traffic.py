"""The traffic generator repeats for a seed and keeps to its mix's stated
parameters: lengths, session durations, start phases; the audio repeats for
a seed."""

import json
import os

import numpy as np
import pytest

from asrbench.core import audio, traffic
from asrbench.core.spec import BENCH_DIR


def _mix(name):
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def test_lognormal_lengths_keep_their_distribution_and_repeat():
    # LibriSpeech test-clean's utterance lengths: median 6 s, sigma 0.6, 1.3-35 s
    dist = {"dist": "lognormal", "median": 6.0, "sigma": 0.6, "min": 1.3, "max": 35.0}
    q = traffic.quantiles(dist, 512)
    assert q.min() >= dist["min"] and q.max() <= dist["max"]
    assert np.median(q) == pytest.approx(dist["median"], rel=0.02)
    # the log-lengths' spread is the stated sigma (none of the mid-quantiles is clipped)
    assert np.std(np.log(q)) == pytest.approx(dist["sigma"], rel=0.05)
    a, b = traffic.order(len(q), 11, 3), traffic.order(len(q), 11, 3)
    assert (a == b).all()
    c = traffic.order(len(q), 12, 3)
    assert not (a == c).all() and sorted(a) == sorted(c)


@pytest.mark.parametrize("streams", [None, 820])
def test_sessions_keep_durations_and_phases(streams):
    mix = _mix("offpeak")
    if streams:  # the whole pool busy
        mix["streams"] = streams
    hop = 10240 / 16000
    s1, s2 = traffic.Sessions(mix, 2**31 + 5, hop), traffic.Sessions(mix, 2**31 + 5, hop)
    other = traffic.Sessions(mix, 2**31 + 6, hop)
    assert (s1.durations == s2.durations).all() and (s1.phases == s2.phases).all()
    assert sorted(s1.durations) == sorted(other.durations)  # the same work, another order
    lo, hi = mix["session_s"]["min"], mix["session_s"]["max"]
    assert s1.durations.min() >= lo and s1.durations.max() <= hi
    assert s1.durations.mean() == pytest.approx((lo + hi) / 2)
    assert len(s1.phases) == mix["streams"]
    assert s1.phases.min() > 0 and s1.phases.max() < hop
    # uniform over one hop: the phases are evenly spread
    assert np.diff(np.sort(s1.phases)) == pytest.approx(hop / mix["streams"])
    assert [s1.next_duration() for _ in range(3)] == list(s1.durations[:3])


def test_longform_segments():
    mix = _mix("longform")
    assert mix["rows"] * mix["segment_s"] == 600.0  # icefall decode.py --max-duration 600


def test_windows_in():
    assert traffic.windows_in(12559, 12560, 10240) == 0
    assert traffic.windows_in(12560, 12560, 10240) == 1
    assert traffic.windows_in(12560 + 10240 * 3, 12560, 10240) == 4


def test_quantiles_uniform_and_fixed():
    assert traffic.quantiles({"dist": "uniform", "min": 0, "max": 4}, 4).tolist() == \
        [0.5, 1.5, 2.5, 3.5]
    assert traffic.quantiles({"dist": "fixed", "value": 3}, 2).tolist() == [3.0, 3.0]


def test_audio_repeats_for_a_seed():
    a = audio.clips(2, 20000, 2**33 + 1, "cpu")
    b = audio.clips(2, 20000, 2**33 + 1, "cpu")
    c = audio.clips(2, 20000, 2**33 + 2, "cpu")
    assert a.dtype == np.int16 and (a == b).all() and not (a == c).all()
    assert not (a[0] == a[1]).all()
    f = audio.as_float(a)
    assert (np.clip(f * 32768.0, -32768, 32767).astype(np.int16) == a).all()
