"""The online recognizer's step program: one step over the whole lane pool
(``runtime/online.py::_step``), run by ``begin_step`` through a
``runtime/program.DecodeProgram`` keyed (lanes, windows per step, window
samples), against the JAX package's ``OnlineRecognizer`` (one jitted step
over every lane) on the CPU, on the committed pin dirs of all five
families.

On the CPU the program runs the step eagerly on its static inputs; the CUDA
graph it captures on the card is held against the eager step in
``tests/test_torch_cuda.py``.  Here a fake capture stands in for the card's
to show that the warm-up before a capture does not step the pool.

Tolerances: as ``tests/test_torch_online.py``, every token, timestamp,
count, context and frame counter exactly; float32 (``compute_dtype=None``)
state leaves to atol 1e-4, the bound ``tests/test_torch_streaming.py``
holds a streaming step's state to (summation order through every layer),
which also covers the beam scores (``tests/test_torch_beam.py``: 1e-4).
Idle lanes are compared with themselves bit for bit.  With dither the
port and JAX draw from different generators, so the dithered port is held
to JAX with JAX's draw put in its place, and to its own per-call draw bit
for bit.  No test draws from the global torch RNG.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OnlineRecognizer
from k2transducerasr_tpu_torch.frontend.fbank import dither_noise
from k2transducerasr_tpu_torch.runtime.checkpoint import state_to_numpy
from k2transducerasr_tpu_torch.runtime.program import DecodeProgram
from test_pinned_transcripts import _bundle as jax_pin_bundle
from torch_parallel_worker import fake_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
GREEDY, BEAM, CTC = "greedy_search", "modified_beam_search", "greedy_search_ctc"
# (family, method): every family and search method
CASES = [("zipformer2", GREEDY), ("conformer", GREEDY), ("zipformer", GREEDY), ("lstm", GREEDY),
         ("zipformer2ctc", CTC), ("zipformer2", BEAM), ("conformer", BEAM), ("zipformer", BEAM),
         ("lstm", BEAM)]
IDS = [f"{f}-{m}" for f, m in CASES]
LANES = 3  # two streams and a lane no stream holds


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(autouse=True)
def _global_rng_untouched():
    state = torch.get_rng_state()
    yield
    assert torch.equal(torch.get_rng_state(), state), "the test drew from the global torch RNG"


@pytest.fixture(scope="module")
def bundles():
    """family -> (the JAX bundle, the port's bundle) of its pin dir.  The JAX
    package reads every pin dir but zipformer v1's (its ``None`` skip
    combiners are object arrays), which its pin bundle, the one that wrote
    the dir, stands for."""
    def jax_bundle(f):
        if f == "zipformer":
            return jax_pin_bundle(f)
        return JBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin"))

    return {f: (jax_bundle(f),
                ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{f}_pin"), device="cpu"))
            for f in sorted({c[0] for c in CASES})}


def _kw(method, **kw):
    return dict(kw, decoding_method=method, compute_dtype=None, max_lanes=LANES,
                max_active_paths=4)


def _port(bundles, family, method, **kw):
    return OnlineRecognizer(bundles[family][1], device="cpu", **_kw(method, **kw))


def _leaves(tree, leaf=np.array, path="") -> dict:
    """{path: leaf(array)} of a state tree of either package (dicts, lists,
    dataclasses).  The default leaf is a numpy copy: the port's pool is
    written in place."""
    if isinstance(tree, dict):
        items = [(f"{path}/{k}", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"{path}/{i}", v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree):
        items = [(f"{path}/{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        return {path: leaf(tree)}
    return {k: v for p, x in items for k, v in _leaves(x, leaf, p).items()}


POOL = ("enc", "dec", "frames")


def _pool(rec) -> dict:
    """The port's lane pool as ``OnlineRecognizer._pool`` names it."""
    return dict(zip(POOL, rec._pool()))


def _port_pool(rec) -> dict:
    return _leaves(state_to_numpy(_pool(rec)))


def _jax_pool(rec) -> dict:
    return _leaves(jax.device_get(dict(zip(POOL, (rec._enc_state, rec._dec_state,
                                                   rec._frame_count)))))


def _assert_pools_match(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{what}: {k}"
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{what}: {k}")


def _pool_tensors(rec) -> dict:
    """{path: tensor} of the port's pool leaves, as they lie."""
    return _leaves(_pool(rec), leaf=lambda t: t)


def _schedule(rec):
    """The feeds of the step-by-step runs: (samples for stream A, for
    stream B) before each step.  A has a window before every step; B's first
    window comes two steps later, so B's lane idles in steps 0 and 1 while
    A's steps (and the third lane idles throughout)."""
    win, hop = rec.window_samples, rec.hop_samples
    a, b = _pcm(win + 4 * hop, 5), _pcm(win + 2 * hop, 6)
    feeds = [(a[:win], None), (a[win:win + hop], None), (a[win + hop:win + 2 * hop], b[:win])]
    feeds += [(a[win + (k + 2) * hop:win + (k + 3) * hop], b[win + k * hop:win + (k + 1) * hop])
              for k in range(2)]
    return feeds


@pytest.mark.parametrize("family,method", CASES, ids=IDS)
def test_whole_pool_step_matches_jax(bundles, family, method):
    """Step by step, with lanes idle in some steps: after every step the
    port's whole pool (encoder caches, decode state, frame counters) equals
    the JAX recognizer's, leaf by leaf, and so do the partial results."""
    jrec = JOnline(bundles[family][0], **_kw(method))
    trec = _port(bundles, family, method)
    recs = (jrec, trec)
    streams = [(r.create_online_stream(), r.create_online_stream()) for r in recs]
    for step, (xa, xb) in enumerate(_schedule(trec)):
        parts = []
        for rec, (sa, sb) in zip(recs, streams):
            sa.add_samples(xa)
            if xb is not None:
                sb.add_samples(xb)
            parts.append([(r.text, r.tokens, r.timestamps) for r in rec.get_results([sa, sb])])
        assert parts[1] == parts[0], f"step {step}"
        _assert_pools_match(_port_pool(trec), _jax_pool(jrec), f"step {step}")
    assert any(tokens for _, tokens, _ in parts[1])
    assert list(trec.program.entries) == [(LANES, 1, trec.window_samples)]


@pytest.mark.parametrize("family,method", CASES, ids=IDS)
def test_idle_lanes_are_untouched_by_a_step(bundles, family, method):
    """A step in which one stream's lane and the free lane have no window:
    every leaf of those lanes is bit for bit what it was before the step,
    while the stepped lane moved."""
    rec = _port(bundles, family, method)
    sa, sb = rec.create_online_stream(), rec.create_online_stream()
    sa.add_samples(_pcm(rec.window_samples + 2 * rec.hop_samples, 7))
    sb.add_samples(_pcm(rec.window_samples, 8))
    rec.get_results([sa, sb])  # both lanes step once
    assert sa._ready() and not sb._ready()
    idle = [lane for lane in range(LANES) if lane != sa.lane]
    before = {k: t.clone() for k, t in _pool_tensors(rec).items()}
    rec.get_results([sa, sb])
    after = _pool_tensors(rec)
    for k, t in after.items():
        for lane in idle:
            assert torch.equal(t[lane], before[k][lane]), f"{k}, lane {lane}"
    assert int(after["/frames"][sa.lane]) == 2 * rec.chunk_frames
    assert any(not torch.equal(t[sa.lane], before[k][sa.lane]) for k, t in after.items()
               if k.startswith("/enc"))


class _FakeStepGraphs:
    """Stands in for the card's capture: ``warm_up`` runs the step as the
    real one does; ``capture`` runs it too but, as a real capture, leaves
    nothing of it behind (the pool is put back), and its graph's replay runs
    the step on the static inputs."""

    def __init__(self, rec):
        self.rec, self.stream, self.warm_ups, self.replays = rec, "s1", [], 0

    def current_stream(self):
        return self.stream

    def warm_up(self, fn, inputs):
        self.warm_ups.append(int(inputs[1].sum()))
        fn(*inputs)

    def capture(self, fn, inputs):
        pool = _pool_tensors(self.rec)
        saved = {k: t.clone() for k, t in pool.items()}
        outputs = fn(*inputs)
        for k, t in pool.items():
            t.copy_(saved[k])
        return _FakeReplay(self, fn, inputs), outputs


class _FakeReplay:
    def __init__(self, graphs, fn, inputs):
        self.graphs, self.fn, self.inputs = graphs, fn, inputs

    def replay(self):
        self.graphs.replays += 1
        self.fn(*self.inputs)


@pytest.mark.parametrize("method", [GREEDY, BEAM])
def test_warm_up_before_the_capture_does_not_step_the_pool(bundles, method):
    """With a fake capture (the warm-up runs the step, the capture leaves
    nothing behind, a replay runs the step), the first begin_step and the
    ones after it give the JAX recognizer's pool and results: the warm-up
    ran on an idle pool (every count 0).  The same program without the
    idle warm-up steps the first window twice, which the check sees."""
    jrec = JOnline(bundles["zipformer2"][0], **_kw(method))
    recs = {"jax": jrec, "idle": _port(bundles, "zipformer2", method),
            "plain": _port(bundles, "zipformer2", method)}
    recs["idle"].program.graphs = _FakeStepGraphs(recs["idle"])
    plain = recs["plain"]
    plain.program = DecodeProgram(plain._step, plain.device, graphs=_FakeStepGraphs(plain))
    pcm = _pcm(recs["idle"].window_samples + 3 * recs["idle"].hop_samples, 12)
    streams = {}
    for name, rec in recs.items():
        streams[name] = rec.create_online_stream()
        streams[name].add_samples(pcm)
    results = {name: [] for name in recs}
    pools = {name: [] for name in recs}
    while streams["jax"]._ready():
        for name, rec in recs.items():
            results[name].append([r.tokens for r in rec.get_results([streams[name]])])
            pools[name].append(_jax_pool(rec) if name == "jax" else _port_pool(rec))
    assert len(pools["jax"]) == 4
    for got, want in zip(pools["idle"], pools["jax"]):
        _assert_pools_match(got, want, "idle warm-up")
    assert results["idle"] == results["jax"]
    graphs = recs["idle"].program.graphs
    assert graphs.warm_ups == [0] and graphs.replays == 4
    frames = "/frames"
    assert pools["plain"][0][frames][streams["plain"].lane] == 2 * plain.chunk_frames
    assert pools["jax"][0][frames][streams["jax"].lane] == plain.chunk_frames


def test_pool_leaves_never_move(bundles):
    """Every pool leaf keeps its storage (``data_ptr``) and its object across
    steps, a lane's reset for a new stream, lane reuse after a dispose and
    ``restore_stream``: what a captured step holds stays valid."""
    rec = _port(bundles, "zipformer2", GREEDY)
    ptrs = {k: (t, t.data_ptr()) for k, t in _pool_tensors(rec).items()}

    def unmoved():
        now = _pool_tensors(rec)
        return sorted(now) == sorted(ptrs) and all(
            now[k] is t and t.data_ptr() == p for k, (t, p) in ptrs.items())

    s = rec.create_online_stream()
    s.add_samples(_pcm(rec.window_samples + 3 * rec.hop_samples, 13))
    while s._ready():
        rec.get_results([s])
    assert unmoved()
    snap, lane = rec.snapshot_stream(s), s.lane
    rec.dispose_stream(s)
    again = rec.create_online_stream()  # the same lane, reset
    assert again.lane == lane
    again.add_samples(_pcm(rec.window_samples, 14))
    rec.get_results([again])
    assert unmoved()
    restored = rec.restore_stream(snap)
    restored.add_samples(_pcm(2 * rec.hop_samples, 15))
    rec.decode_to_end(restored)
    assert unmoved()
    assert len(rec.program) == 1


def test_one_key_per_recognizer_and_two_windows_a_step_equal_one(bundles):
    """A recognizer's program holds one key, (lanes, windows per step,
    window samples), however many lanes step; two windows a step (a lane
    with fewer windows than slots included) give the tokens and the pool of
    one window a step, and the JAX recognizer's."""
    def run(rec):
        sa, sb = rec.create_online_stream(), rec.create_online_stream()
        sa.add_samples(_pcm(rec.window_samples + 5 * rec.hop_samples, 21))
        sb.add_samples(_pcm(rec.window_samples + 2 * rec.hop_samples, 22))
        steps = 0
        while sa._ready() or sb._ready():
            rec.get_results([sa, sb])
            steps += 1
        return [(r.tokens, r.timestamps) for r in rec.get_results([sa, sb])], steps

    jrec = JOnline(bundles["zipformer2"][0], **_kw(GREEDY, windows_per_step=2))
    want, _ = run(jrec)
    runs = {}
    for wps in (1, 2):
        rec = _port(bundles, "zipformer2", GREEDY, windows_per_step=wps)
        runs[wps] = run(rec) + (_port_pool(rec),)
        assert list(rec.program.entries) == [(LANES, wps, rec.window_samples)]
    assert runs[2][0] == runs[1][0] == want and (runs[2][1], runs[1][1]) == (3, 6)
    _assert_pools_match(runs[2][2], runs[1][2], "windows_per_step 2 against 1")
    _assert_pools_match(runs[2][2], _jax_pool(jrec), "windows_per_step 2 against JAX")


def test_mesh_recognizer_holds_no_program(bundles):
    """Under a mesh the step runs eagerly (its collectives cannot be
    captured): no program; without one, always one."""
    tb = bundles["zipformer2"][1]
    assert OnlineRecognizer(tb, compute_dtype=None, device="cpu").program is not None
    with fake_world(2) as mesh:
        rec = OnlineRecognizer(tb, compute_dtype=None, device="cpu", mesh=mesh())
        assert rec.program is None


def _dithered(bundle, dither=0.01):
    return dataclasses.replace(bundle, frontend_cfg=dataclasses.replace(bundle.frontend_cfg,
                                                                        dither=dither))


def _run_schedule(recs) -> tuple[list, list]:
    """``_schedule``'s steps on recognizers of either package: each step's
    partial results and pool."""
    streams = [(r.create_online_stream(), r.create_online_stream()) for r in recs]
    results, pools = [], []
    for xa, xb in _schedule(recs[-1]):
        for rec, (sa, sb) in zip(recs, streams):
            sa.add_samples(xa)
            if xb is not None:
                sb.add_samples(xb)
        results.append([[(r.tokens, r.timestamps) for r in rec.get_results(list(ss))]
                        for rec, ss in zip(recs, streams)])
        pools.append([_port_pool(rec) if isinstance(rec, OnlineRecognizer) else _jax_pool(rec)
                      for rec in recs])
    return results, pools


@pytest.mark.parametrize("method", [GREEDY, BEAM])
def test_dithered_step_equals_the_per_call_draw_and_jax(bundles, method):
    """With dither the step reads noise drawn once per recognizer, fbank's
    own draw for the pool's window (a fresh generator seeded 0), which a
    graph can replay.  Step by step, idle lanes included: the pool and the
    results through the program (its warm-up and capture faked) equal bit
    for bit those of the program-less step that draws on every call, as
    the eager route did; and with the JAX package's seed-0 draw in its
    place, they equal the dithered JAX recognizer's (which draws from
    another generator: same distribution, other values)."""
    jb, tb = (_dithered(b) for b in bundles["zipformer2"])
    kept = OnlineRecognizer(tb, device="cpu", **_kw(method))
    kept.program.graphs = _FakeStepGraphs(kept)
    per_call = OnlineRecognizer(tb, device="cpu", **_kw(method))
    per_call._dither, per_call.program = None, None  # fbank draws on each call
    cfg = tb.frontend_cfg
    shape = (LANES, kept._feat_window, cfg.frame_length)
    assert torch.equal(kept._dither, dither_noise(shape, cfg, "cpu"))
    as_jax = OnlineRecognizer(tb, device="cpu", **_kw(method))
    as_jax._dither = cfg.dither * torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(0), shape, dtype=np.float32)))
    clean = _port(bundles, "zipformer2", method)
    results, pools = _run_schedule([kept, per_call, as_jax, clean, JOnline(jb, **_kw(method))])
    for step, (res, pool) in enumerate(zip(results, pools)):
        assert res[0] == res[1] and res[2] == res[4], f"step {step}"
        for k, v in pool[0].items():
            np.testing.assert_array_equal(v, pool[1][k], err_msg=f"step {step}: {k}")
        _assert_pools_match(pool[2], pool[4], f"step {step}: with JAX's draw against JAX")
    assert kept.program.graphs.warm_ups == [0] and len(kept.program) == 1
    assert any(not np.array_equal(v, pools[-1][3][k]) for k, v in pools[-1][0].items())
