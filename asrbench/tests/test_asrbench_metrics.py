"""The metric arithmetic on known inputs: a percentile over every sample,
the union of device intervals and the idle gaps, the roofline counts, the
FLOP count, and the per-layer readers on a made-up window."""

import types

import pytest
import torch

from asrbench.core import spec, yardstick as Y
from asrbench.core.harness import Context, Trace, breakdown


def test_percentile_takes_every_sample():
    xs = list(range(1, 101))
    assert Y.percentile(xs, 95) == pytest.approx(95.05)  # numpy's linear rule
    assert Y.percentile(xs[::-1], 50) == pytest.approx(50.5)
    assert Y.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        Y.percentile([], 95)


def test_union_of_intervals_counts_overlaps_once():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert Y.union_length(iv) == pytest.approx(3.0)
    assert Y.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert Y.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_k1_bytes_and_operations():
    nb, ops = Y.k1_bytes_ops(2, 3, 5, 4, torch.bfloat16, torch.bfloat16, qd=32, pd=4)
    assert ops == 2 * 2 * 4 * 3 * 5 * 36
    assert nb == (2 * 3 * 4 * 32 + 2 * 5 * 4 * 32 + 2 * 3 * 4 * 4 + 7 * 4 * 4) * 2 + 16 \
        + 2 * 4 * 3 * 5 * 2


def test_greedy_bytes_and_operations():
    nb, ops = Y.greedy_bytes_ops(2, 10, 3, context=2, vocab=5, decoder_dim=4, joiner_dim=6,
                                 elem_bytes=2)
    assert ops == 2 * 10 * 6 * 5 + 2 * 3 * 4 * 6
    weights = (6 * 5 + 4 * 6) * 2 + (6 + 5) * 4
    state = 2 * 2 * 8 + 2 * 6 * 2 + 2 * 2 * 8
    assert nb == 10 * 6 * 2 + weights + min(40, 24) * 4 + 2 * state + 32 + 48


def test_bound_takes_the_larger_time():
    assert Y.bound(3.35e9, 0, torch.bfloat16, 3.35e12) == (pytest.approx(1.0), "bytes")
    assert Y.bound(0, 989e9, torch.bfloat16, 3.35e12) == (pytest.approx(1.0), "operations")
    assert Y.bound(0, 67e9, torch.float32, 3.35e12)[0] == pytest.approx(1.0)


def _zipformer2():
    return spec.plugin("models", "zipformer2")


def _ecfg(causal=False):
    from asrbench.tests import tiny
    return _zipformer2().encoder_cfg(tiny.config(causal))


@pytest.mark.parametrize("raw", [157, 300, 413])
def test_encoder_flops_equal_a_whole_count(raw):
    """The per-stack polynomial gives what FlopCounterMode counts over the
    whole reference forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from asrbench.reference import zipformer2 as Z
    e = _ecfg()
    with torch.device("meta"):
        model = Z.OracleModel(e)
        x = torch.zeros((1, raw, 80))
        lens = torch.full((1,), raw)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, lens)
    assert _zipformer2().encoder_flops(e, raw) == pytest.approx(fc.get_total_flops(), rel=1e-9)


def test_search_flops():
    f = Y.search_flops(10, 2, encoder_dim=8, joiner_dim=4, vocab=5, decoder_dim=8, context=2,
                       groups=2)
    assert f == 10 * (2 * 8 * 4 + 2 * 4 * 5) + 2 * (2 * 2 * 8 * 4 + 2 * 8 * 4)


def _ctx():
    b = {"k1": 1.0, "g": 0.5}
    run = types.SimpleNamespace(records=[
        dict(t0=0.5, t1=0.6, host_s=0.004, bounds=b, flops=989e9),
        dict(t0=1.2, t1=1.3, host_s=0.002, bounds=b, flops=989e9),
        dict(t0=3.0, t1=3.1, host_s=0.006, bounds=b, flops=989e9)])
    dev = [("relpos_attn_probs_tc", 0.0, 0.004), ("relpos_attn_probs_tc", 0.003, 0.004),
           ("rnnt_greedy_kernel", 0.1, 0.102), ("Memcpy DtoH", 0.5, 0.7)]
    host = [("begin_decode", 0.0, 0.2), ("wait", 0.2, 0.9), ("idle", 0.9, 1.0)]
    return Context(run, Trace(1.0, dev, host, 1.0, 2.0))


def test_readers_on_a_known_window():
    ctx = _ctx()
    read = {m: spec.reader(m) for m in ("host_ms.tput", "replay_ms.tput", "idle_share.tput",
                                        "k1_roofline.tput", "g_roofline.tput", "mfu.tput")}
    assert read["idle_share.tput"](ctx, "idle_share.tput") == pytest.approx(100 * (1 - 0.206))
    assert read["replay_ms.tput"](ctx, "replay_ms.tput") == pytest.approx(206.0)
    # K1: 1 ms of bound over 4 + 1 ms taken (the overlap of two kernels counts for each)
    assert read["k1_roofline.tput"](ctx, "k1_roofline.tput") == pytest.approx(20.0)
    assert read["g_roofline.tput"](ctx, "g_roofline.tput") == pytest.approx(25.0)
    assert read["mfu.tput"](ctx, "mfu.tput") == pytest.approx(0.1)
    # fewer than 10 replays outside the traced span: the median over all
    assert read["host_ms.tput"](ctx, "host_ms.tput") == pytest.approx(4.0)


def test_readers_find_nothing_without_a_trace():
    ctx = Context(types.SimpleNamespace(records=[]), None)
    for m in ("replay_ms.stream", "idle_share.stream", "k1_roofline.stream",
              "g_roofline.stream", "mfu.stream", "host_ms.stream"):
        assert spec.reader(m)(ctx, m) is None


def test_breakdown_names_gaps_by_the_host_span():
    b = breakdown(_ctx().trace)
    assert b["device_ops"][0] == ["Memcpy DtoH", pytest.approx(0.2)]
    assert b["idle_gaps"][:2] == [["wait", pytest.approx(0.398)], ["wait", pytest.approx(0.3)]]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_run_shapes():
    from asrbench.reference.fbank import num_frames
    f = {"sample_rate": 16000, "frame_length_ms": 25.0, "frame_shift_ms": 10.0}
    assert num_frames(480000, dict(f, snip_edges=True)) == 2998
    assert num_frames(399, dict(f, snip_edges=True)) == 0
    assert num_frames(480000, dict(f, snip_edges=False)) == 3000
    assert num_frames(79, dict(f, snip_edges=False)) == 0
    assert _zipformer2().out_frames(2998) == 748 == _zipformer2().out_frames(3000)
