"""The rest of a run, driven at a tiny size on the CPU with the timed path
broken underneath, comes out not correct: a token altered where the search
produces it, half of a batch left out, and a streaming step that leaves its
state unchanged; the run without a fault comes out correct.  (The harness's
look for a card is in ``asrbench/run.py``; ``run_cell`` is the rest.)"""

import dataclasses

import pytest
import torch

from asrbench.core.harness import run_cell
from asrbench.tests import tiny

SEED = 2**31 + 101
CELLS = [(False, "longform"), (True, "offpeak")]


def _run(streaming, mix, seconds=2.0):
    return run_cell(tiny.cell(tiny.config(streaming), tiny.mix(mix)), SEED, seconds, False, "cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("streaming,mix", CELLS)
def test_a_sound_run_is_correct(streaming, mix):
    r = _run(streaming, mix)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("streaming,mix", CELLS)
def test_a_token_altered_where_produced_is_caught(streaming, mix, monkeypatch):
    from k2transducerasr_tpu_torch.decode import rnnt_greedy
    real = rnnt_greedy.greedy_frames_skip

    def altered(*a, **k):
        st = real(*a, **k)
        toks = st.tokens.clone()
        v = a[1].vocab_size
        toks[:, 0] = torch.where(st.count > 0, 3 + (toks[:, 0] - 2) % (v - 3), toks[:, 0])
        return dataclasses.replace(st, tokens=toks)

    monkeypatch.setattr(rnnt_greedy, "greedy_frames_skip", altered)
    assert not _run(streaming, mix)["correct"]


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer
    real = OfflineRecognizer.pcm_batch

    def half(self, streams):
        samples, counts = real(self, streams)
        counts = counts.clone()
        counts[counts.shape[0] // 2:] = 0
        return samples, counts

    monkeypatch.setattr(OfflineRecognizer, "pcm_batch", half)
    assert not _run(False, "longform")["correct"]


def test_half_of_the_streams_left_out_is_caught(monkeypatch):
    from k2transducerasr_tpu_torch.runtime.online import OnlineRecognizer
    real = OnlineRecognizer._step

    def half(self, windows, wcount):
        wcount = wcount.clone()
        wcount[wcount.shape[0] // 2:] = 0
        return real(self, windows, wcount)

    monkeypatch.setattr(OnlineRecognizer, "_step", half)
    assert not _run(True, "offpeak")["correct"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    from k2transducerasr_tpu_torch.runtime.online import OnlineRecognizer
    monkeypatch.setattr(OnlineRecognizer, "_step", lambda self, windows, wcount: ())
    assert not _run(True, "offpeak")["correct"]
