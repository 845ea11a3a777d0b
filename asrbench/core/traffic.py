"""The one traffic generator: it reads a mix's parameters (a JSON file under
``asrbench/traffic``) and the seed, and gives the sizes and the schedule.

Every seed gets the same multiset of sizes and phases, in another order:
lengths are the quantiles ``(i + 1/2) / n`` of the stated distribution,
``n`` the mix's ``distinct``, and the seed permutes them.  So the seed
changes which audio goes where, and in what order, not how much work a run
holds.
"""

from __future__ import annotations

import statistics

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n mid-quantiles of ``dist``: {"dist": "uniform", "min", "max"},
    {"dist": "lognormal", "median", "sigma", "min", "max"} (clipped) or
    {"dist": "fixed", "value"}."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, float(dist["value"]))
    if kind == "uniform":
        return dist["min"] + (dist["max"] - dist["min"]) * q
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
        x = dist["median"] * np.exp(dist["sigma"] * z)
        return np.clip(x, dist["min"], dist["max"])
    raise ValueError(f"unknown distribution {kind!r}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (``stream`` tells uses
    apart)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, stream])


def order(n: int, seed: int, stream: int) -> np.ndarray:
    return rng(seed, stream).permutation(n)


def seconds_to_samples(s: float, rate: int) -> int:
    return int(round(s * rate))


class Sessions:
    """Streaming sessions of one mix: ``streams`` users, each running
    sessions back to back.  Session durations are the mid-quantiles of
    ``session_s``; the first sessions' start phases are uniform over one
    hop (the mid-quantiles, permuted)."""

    def __init__(self, mix: dict, seed: int, hop_s: float):
        self.streams = int(mix["streams"])
        n = int(mix["distinct_sessions"])
        self.durations = quantiles(mix["session_s"], n)[order(n, seed, 1)]
        self.phases = ((np.arange(self.streams) + 0.5) / self.streams * hop_s
                       )[order(self.streams, seed, 2)]
        self._next = 0

    def next_duration(self) -> float:
        d = float(self.durations[self._next % len(self.durations)])
        self._next += 1
        return d


def windows_in(samples: int, window: int, hop: int) -> int:
    """Whole windows of ``window`` samples, ``hop`` apart, in ``samples``."""
    return 0 if samples < window else (samples - window) // hop + 1
