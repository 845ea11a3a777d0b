"""The zipformer v1 model type (``asrbench/models/zipformer.py``) on the CPU
at a tiny width of its own: the system's streaming step and offline causal
forward against the plain chunk-causal reference
(``asrbench/reference/zipformer1.py``) on seeded random weights, the
constant leaves drawn, one lane's state bytes, the work a step counts, the
freeze's reader on a known window, and one whole tiny streaming cell."""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from asrbench.core import spec, system, weights
from asrbench.core import yardstick as Y
from asrbench.core.harness import Context, Trace, run_cell
from asrbench.tests import tiny

# three stacks: a dim change into the first downsampled stack (extra_proj,
# the combiner's pad) and a U-Net skip into stack 2; chunk 4, left 8
TINY_KW = dict(num_encoder_layers=[1, 2, 1], encoder_dims=[16, 24, 24], attention_dims=[8, 8, 8],
               downsampling_factors=[1, 2, 2], num_heads=[2, 2, 2], feedforward_dims=[24, 32, 24],
               cnn_module_kernels=[7, 7, 7], pos_dim=2, embed_channels=[2, 4, 8],
               output_downsampling_factor=2, causal=True, chunk_size=4, left_context_frames=8)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _config(**encoder) -> dict:
    with open(os.path.join(spec.BENCH_DIR, "configs", "zipformer1_librispeech_streaming.json"),
              encoding="utf-8") as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["encoder"] = dict(TINY_KW, **encoder)
    cfg["decoder"]["decoder_dim"] = 32
    cfg["joiner"]["joiner_dim"] = 32
    cfg["vocab_size"] = 50
    cfg["compute_dtype"] = "float32"
    cfg["emission"].update(calibration_clips=2, calibration_s=4.0)
    return cfg


def _model():
    return spec.plugin("models", "zipformer")


def _tree(cfg, seed=2**31 + 41):
    return weights.make_tree(system.init_fns(cfg), seed, "cpu", _model().CONSTANT_RANGES)


def _system_and_reference(cfg):
    tree = _tree(cfg)
    return system.build(cfg, tree, "cpu").encoder, _model().build(cfg, tree["encoder"], "cpu")


# Both sides run in float32 and differ by summation order alone (K1's plain
# version against the oracle's gathered rel-shift, the cached cumulative
# mean as avg * len + the chunk's sum): about 5e-7 at |x| ~ 1.6 after four
# layers, so atol 1e-5 leaves twenty times that and still fails any wrong
# weight, mask, cache slot or frame.
ATOL = 1e-5


def test_streaming_step_matches_the_chunk_causal_reference_over_ragged_sessions():
    """Two sessions in one pool of two lanes, the second starting a step
    later and ending sooner: every step runs both lanes, and the lane
    without a window keeps its state (``runtime/online.py::_freeze``), as
    the recognizer's step does.  Each session's frames, concatenated,
    against the reference's chunk-causal forward over its raw frames."""
    from k2transducerasr_tpu_torch.runtime.online import _freeze

    cfg = _config()
    enc, ref = _system_and_reference(cfg)
    c = cfg["encoder"]["chunk_size"]
    windows, start = [5, 3], [0, 1]  # the second session's cache starts empty mid-run
    g = torch.Generator().manual_seed(3)
    feats = [torch.randn(2 * c * n + 7, 80, generator=g) for n in windows]
    state, outs = enc.init_state(2), [[], []]
    with torch.inference_mode():
        for step in range(6):
            x = torch.zeros(2, 2 * c + 7, 80)
            active = torch.zeros(2, dtype=torch.bool)
            for i in range(2):
                j = step - start[i]
                if 0 <= j < windows[i]:
                    x[i] = feats[i][2 * c * j: 2 * c * j + 2 * c + 7]
                    active[i] = True
            out, new = enc.streaming_step(state, x, None)
            _freeze(state, new, active)
            for i in range(2):
                if active[i]:
                    outs[i].append(out[i])
    for i in range(2):
        want = _model().encode(ref, cfg, feats[i], True)
        assert want.shape == (windows[i] * c // 2, 24)
        torch.testing.assert_close(torch.cat(outs[i]), want, atol=ATOL, rtol=0)


def test_offline_causal_forward_matches_the_reference():
    """A batch of two lengths (whole windows, so that no chunk reaches past
    a lane's end) through the system's offline forward, against the
    reference's whole-utterance chunk-causal forward, one at a time."""
    cfg = _config()
    enc, ref = _system_and_reference(cfg)
    c = cfg["encoder"]["chunk_size"]
    raws = [2 * c * 6 + 7, 2 * c * 3 + 7]
    x = torch.randn(2, raws[0], 80, generator=torch.Generator().manual_seed(4))
    x[1, raws[1]:] = 0.0
    with torch.inference_mode():
        got, lens = enc(x, torch.tensor(raws), None)
    for i, raw in enumerate(raws):
        want = _model().encode(ref, cfg, x[i, :raw], False)
        assert int(lens[i]) == want.shape[0] == ((raw - 7) // 2 + 1) // 2
        torch.testing.assert_close(got[i, : want.shape[0]], want, atol=ATOL, rtol=0)


def test_constant_leaves_are_drawn_away_from_their_init():
    """Every leaf the system's init sets to a constant (BasicNorm's log eps,
    the bypass scales, the combiners' weights) and each None slot of a
    stack without a skip is drawn inside its range, no element keeping its
    init value; the system's encoder keeps None in those slots."""
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
    skips = system.build(cfg, tree, "cpu").encoder.tree()["skip_combiners"]
    assert [s is None for s in skips] == [True, True, False]


@pytest.mark.parametrize("widths", ["tiny", "full"])
def test_state_bytes_equal_the_systems_init_state(widths):
    """One lane's encoder state as the configuration's shapes count it, and
    as the system's ``init_state`` holds it: 2,093,636 bytes at the cell's
    widths (523,407 float32 values and the int64 ``processed``)."""
    from k2transducerasr_tpu_torch.models import zipformer as port

    if widths == "full":
        with open(os.path.join(spec.BENCH_DIR, "configs",
                               "zipformer1_librispeech_streaming.json"), encoding="utf-8") as f:
            cfg = json.load(f)
    else:
        cfg = _config()
    state = port.init_state(port.ZipformerConfig(**cfg["encoder"]), 1)
    held = sum(t.numel() * t.element_size() for layer in state["layers"] for t in layer.values())
    held += state["processed"].numel() * state["processed"].element_size()
    assert _model().state_bytes(cfg) == held
    if widths == "full":
        assert held == 2_093_636 == 4 * 523_407 + 8


def test_stream_work_counts_the_step():
    """Encoder frames a chunk, K1 once a layer at each stack's chunk of
    queries against its left context and chunk of keys over the pool's
    lanes, the freeze's bound a lane, and FLOPs as a whole
    ``FlopCounterMode`` count of the reference's chunk-causal forward over
    left/chunk + 1 windows, its embed counted at one window."""
    from torch.utils.flop_counter import FlopCounterMode

    from asrbench.reference import zipformer1 as Z
    cfg = _config()
    model = _model()
    work = model.stream_work(cfg, 6, torch.bfloat16, 3.35e12, True)
    assert work["out_frames"] == 2
    # stacks at ds 1, 2, 2: T 4, 2, 2 against S 12, 6, 6; 1, 2, 1 layers; H 2, qd 4, pd 2
    k1 = 0.0
    for layers, t, s in ((1, 4, 12), (2, 2, 6), (1, 2, 6)):
        nb, ops = Y.k1_bytes_ops(6, t, s, 2, torch.bfloat16, torch.bfloat16, 4, 2)
        k1 += layers * max(nb / 3.35e12, ops / 989e12) * 1e3
    assert work["bounds"]["k1"] == pytest.approx(k1, rel=1e-12)
    assert work["bounds"]["freeze_per_lane"] == pytest.approx(
        2 * model.state_bytes(cfg) / 3.35e12 * 1e3, rel=1e-12)
    e = model.encoder_cfg(cfg)
    n = 8 // 4 + 1
    with torch.device("meta"):
        ref = Z.OracleModel(e).eval()
        whole = torch.zeros((1, 8 * n + 7, 80))
        window = torch.zeros((1, 8 + 7, 80))
        lens = torch.full((1,), 8 * n + 7)

    def count(fn):
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
        return fc.get_total_flops()

    stacks = count(lambda: ref(whole, lens, 4, 8)) - count(lambda: ref.encoder_embed(whole))
    assert stacks > 0
    assert work["flops"] == pytest.approx(count(lambda: ref.encoder_embed(window)) + stacks / n,
                                          rel=1e-12)
    assert model.stream_work(cfg, 6, torch.bfloat16, 3.35e12, False)["flops"] == 0.0
    with pytest.raises(ValueError, match="streaming only"):
        model.offline_work(cfg, 2, 100, 128, torch.bfloat16, 3.35e12, False)


def _mark(stage, at):
    return (f"k2t_stage_{stage}", at, at + 0.001)


def test_freeze_roofline_reader_on_a_known_window():
    """3 and 5 lanes stepped, 0.5 ms of bound a lane: 4 ms over the freeze
    stage's 12 ms of device time (its markers included); nothing to read
    without a trace, without the bound (the zipformer2 model type counts
    none) or without a freeze stage."""
    b = {"k1": 1.0, "freeze_per_lane": 0.5}
    recs = [dict(t0=100.0, t1=100.09, host_s=0.0, bounds=b, flops=0.0, ready=3),
            dict(t0=100.09, t1=100.2, host_s=0.0, bounds=b, flops=0.0, ready=5),
            dict(t0=100.3, t1=100.4, host_s=0.0, bounds=b, flops=0.0, ready=7)]
    dev = [_mark("fbank", 0.010), ("gemm", 0.011, 0.015),
           _mark("encoder", 0.015), ("elementwise", 0.016, 0.055),
           _mark("freeze", 0.055), ("where", 0.056, 0.060), ("copy", 0.060, 0.062),
           _mark("search", 0.062), ("rnnt_greedy", 0.063, 0.064), _mark("end", 0.064),
           _mark("fbank", 0.100), _mark("encoder", 0.105), ("elementwise", 0.106, 0.145),
           _mark("freeze", 0.145), ("where", 0.146, 0.150)]
    read = spec.reader("freeze_roofline.z1s")
    ctx = Context(types.SimpleNamespace(records=recs), Trace(0.15, dev, [], 100.0, 100.15))
    assert read(ctx, "freeze_roofline.z1s") == pytest.approx(100.0 * 0.004 / 0.012)
    assert read(Context(types.SimpleNamespace(records=recs), None), "freeze_roofline.z1s") is None
    z2 = [dict(r, bounds={"k1": 1.0}) for r in recs]
    assert read(Context(types.SimpleNamespace(records=z2), ctx.trace), "x") is None
    offline = [e for e in dev if "freeze" not in e[0]]
    assert read(Context(ctx.run, Trace(0.15, offline, [], 100.0, 100.15)), "x") is None


def test_a_tiny_streaming_cell_runs_and_reads_no_gap():
    """Weights, the joiner fit, the open loop, the check: the whole cell at
    the tiny width with the cell's chunk and left context on the CPU, where
    float32 on both sides reads a gap of 0."""
    cfg = _config(chunk_size=16, left_context_frames=64)
    cell = tiny.cell(cfg, tiny.mix("offpeak"), name="z1_tiny")
    res = run_cell(cell, 2**31 + 97, 2.0, False, "cpu")
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["compared"]["max_logit_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"setup_s", "stream_chunk_p95_ms"}
