"""The conformer model type (``asrbench/models/conformer.py``) on the CPU at
a tiny width of its own: the system's encoder against the plain reference
(``asrbench/reference/conformer.py``) on seeded random weights, the constant
leaves drawn, K2's bytes and operations, the encoder frames and FLOPs a
batch counts, the K2 reader on a known window, and one whole tiny cell."""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from asrbench.core import spec, system, weights
from asrbench.core.harness import Context, Trace, run_cell
from asrbench.tests import tiny

TINY = dict(d_model=32, num_layers=2, num_heads=2, ff_dim=48, cnn_kernel=7, causal=False)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    with open(os.path.join(spec.BENCH_DIR, "configs", "conformer_librispeech_offline.json"),
              encoding="utf-8") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["encoder"] = dict(TINY)
    cfg["decoder"]["decoder_dim"] = 32
    cfg["joiner"]["joiner_dim"] = 32
    cfg["vocab_size"] = 50
    cfg["compute_dtype"] = "float32"
    cfg["emission"].update(calibration_clips=2, calibration_s=4.0)
    return cfg


def _model():
    return spec.plugin("models", "conformer")


def _tree(cfg, seed=2**31 + 41):
    return weights.make_tree(system.init_fns(cfg), seed, "cpu", _model().CONSTANT_RANGES)


def test_encoder_matches_the_reference_on_a_ragged_batch():
    """A padded batch of three lengths through the system's encoder against
    the reference, one utterance at a time, on the valid frames only.  Both
    run in float32; they differ by summation order alone (the system folds
    pos_bias_u/v and 1/sqrt(dh) into the query before the products, its
    attention adds keys in another order, its BatchNorm is one multiply-add),
    about 1e-6 at |x| ~ 5 after two layers, so atol 2e-5 leaves ten times
    that and still fails any wrong weight, mask or frame."""
    cfg = _config()
    tree = _tree(cfg)
    rec = system.build(cfg, tree, "cpu")
    model = _model()
    ref = model.build(cfg, tree["encoder"], "cpu")
    x = torch.randn(3, 157, 80, generator=torch.Generator().manual_seed(3))
    lens = torch.tensor([157, 120, 61])
    got, got_lens = rec.encoder(x, lens, None)
    for i in range(3):
        want = model.encode(ref, cfg, x[i, : int(lens[i])], False)
        assert int(got_lens[i]) == want.shape[0] == model.out_frames(int(lens[i]))
        torch.testing.assert_close(got[i, : want.shape[0]], want, atol=2e-5, rtol=0)


def test_constant_leaves_are_drawn_away_from_their_init():
    """Every leaf the system's init sets to a constant (LayerNorm and folded
    BatchNorm scales and biases, pos_bias_u, pos_bias_v) is drawn inside its
    range, and no element keeps its init value."""
    cfg = _config()
    init = {k: fn(weights._Recorder()) for k, fn in system.init_fns(cfg).items()}
    tree = _tree(cfg)
    ranges = _model().CONSTANT_RANGES
    seen = set()
    for path, v in weights._leaves(init):
        if isinstance(v, weights._Draw):
            continue
        node = tree
        for p in path:
            node = node[p]
        key = next(k for k in reversed(path) if isinstance(k, str))
        lo, hi = ranges[key]
        got = node.numpy()
        assert got.shape == np.shape(v)
        assert (got >= lo).all() and (got <= hi).all(), path
        assert (got != np.asarray(v)).all(), path
        seen.add(key)
    assert seen == set(ranges)


def test_k2_bytes_and_operations():
    nb, ops = _model().k2_bytes_ops(2, 3, 5, 4, 8, torch.bfloat16)
    assert ops == 3 * 2 * 2 * 4 * 3 * 5 * 8
    # q, pos_q [2, 3, 4, 8]; k, v [2, 5, 4, 8]; pos_k [7, 4, 8]; ctx [2, 3, 4, 8]; lens
    assert nb == (2 * 192 + 2 * 320 + 224 + 192) * 2 + 8


def test_offline_work_counts_the_systems_frames_and_the_references_flops():
    """Encoder frames as the system's ``out_lens``, K2 once a layer at the
    padded frames, FLOPs as a whole ``FlopCounterMode`` count of the
    reference's forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from asrbench.reference import conformer as C
    cfg = _config()
    model = _model()
    rec = system.build(cfg, _tree(cfg), "cpu")
    raws = [7, 61, 300, 413]
    x = torch.zeros(len(raws), max(raws), 80)
    _, lens = rec.encoder(x, torch.tensor(raws), None)
    assert [model.out_frames(r) for r in raws] == lens.tolist()
    e = model.encoder_cfg(cfg)
    for raw in (301, 413):
        with torch.device("meta"):
            ref = C.OracleConformer(e).eval()
            xr = torch.zeros((1, raw, 80))
            lr = torch.full((1,), raw)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref(xr, lr)
        work = model.offline_work(cfg, 3, raw, 512, torch.bfloat16, 3.35e12, True)
        assert work["out_frames"] == model.out_frames(raw)
        assert work["flops"] == pytest.approx(fc.get_total_flops(), rel=1e-12)
    nb, ops = model.k2_bytes_ops(3, 127, 127, 2, 16, torch.bfloat16)
    bound = model.offline_work(cfg, 3, 301, 512, torch.bfloat16, 3.35e12, False)["bounds"]["k2"]
    assert bound == pytest.approx(2 * max(nb / 3.35e12, ops / 989e12) * 1e3)


def test_streaming_is_refused():
    cfg = _config()
    with pytest.raises(ValueError, match="offline only"):
        _model().stream_work(cfg, 4, torch.bfloat16, 3.35e12, False)
    with pytest.raises(ValueError, match="offline only"):
        _model().encode(None, cfg, torch.zeros(100, 80), True)


def test_k2_reader_on_a_known_window():
    """1 ms of K2's bound a replay over the K2 kernels' device time (two
    replays in the span, overlapping kernels counted for each)."""
    b = {"k2": 1.0, "g": 0.5}
    run = types.SimpleNamespace(records=[
        dict(t0=0.5, t1=0.6, host_s=0.004, bounds=b, flops=0.0),
        dict(t0=1.2, t1=1.3, host_s=0.002, bounds=b, flops=0.0),
        dict(t0=1.5, t1=1.6, host_s=0.002, bounds=b, flops=0.0),
        dict(t0=3.0, t1=3.1, host_s=0.006, bounds=b, flops=0.0)])
    dev = [("void relpos_attn_ctx_tc<64>", 0.0, 0.006), ("relpos_attn_ctx_tc", 0.005, 0.007),
           ("relpos_attn_probs_tc", 0.1, 0.2), ("rnnt_greedy_kernel", 0.3, 0.302)]
    ctx = Context(run, Trace(1.0, dev, [], 1.0, 2.0))
    assert spec.reader("k2_roofline.conf")(ctx, "k2_roofline.conf") == pytest.approx(25.0)
    none = Context(types.SimpleNamespace(records=[]), None)
    assert spec.reader("k2_roofline.conf")(none, "k2_roofline.conf") is None
    # a window with no K2 kernel (a zipformer2 replay) reads nothing
    z2 = Context(run, Trace(1.0, dev[2:], [], 1.0, 2.0))
    assert spec.reader("k2_roofline.conf")(z2, "k2_roofline.conf") is None


def test_a_tiny_conformer_cell_runs_and_reads_no_gap():
    """Weights, the joiner fit, the window, the check: the whole cell at the
    tiny width on the CPU, where float32 on both sides reads a gap of 0."""
    cell = tiny.cell(_config(), tiny.mix("longform"), name="conf_tiny")
    res = run_cell(cell, 2**31 + 97, 2.0, False, "cpu")
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["compared"]["max_logit_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"setup_s", "offline_audio_s_per_s"}
