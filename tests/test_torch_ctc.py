"""The port's CTC head (``models/ctc.py``), CTC greedy search
(``decode/ctc_greedy.py``) and zipformer2-CTC in both recognizers, against
the JAX package on the CPU: inputs from numpy seeds, and the committed
zipformer2-CTC pin dir (tests/torch_port_data/zipformer2ctc_pin).

Tolerances: CTC states, tokens, timestamps and partial results are compared
exactly; float32 log-probs to atol 1e-5 (summation order of one linear);
bf16 log-probs to atol 0.05 — PyTorch's bf16 matmul rounds the logits
before the float32 bias add, the reference after it, one bf16 ulp of
logits of order 4 (2^-6) moved through the log-softmax.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.decode import ctc_greedy as JCtcG
from k2transducerasr_tpu.models import ctc as JCtc
from k2transducerasr_tpu.models import zipformer2 as JZ
from k2transducerasr_tpu.runtime import endpoint as JE
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.decode import ctc_greedy as TCtcG
from k2transducerasr_tpu_torch.models import ctc as TCtc
from k2transducerasr_tpu_torch.runtime import endpoint as TE
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy, state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "zipformer2ctc_pin")
# tests/test_pinned_transcripts.py's zipformer2ctc pins and bundle config
PIN_TEXT, PIN_TIMESTAMPS, ONLINE_PIN_TEXT = "tok29", [0], "tok29tok27"
PIN_CFG = dict(num_encoder_layers=(1, 1), encoder_dims=(16, 32), downsampling_factors=(1, 2),
               num_heads=(2, 2), feedforward_dims=(32, 48), cnn_module_kernels=(7, 7),
               query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
               embed_channels=(2, 4, 8), causal=True, chunk_size=8, left_context_frames=16)


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _lp(ids, vocab=8):
    """[1, T, V] log-probs whose argmax per frame is ``ids``."""
    lp = np.full((1, len(ids), vocab), -10.0, np.float32)
    lp[0, np.arange(len(ids)), ids] = 0.0
    return lp


def _assert_same(got: TCtcG.CtcState, want):
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def _both(chunks, lens_per_chunk, max_tokens=16, batch=1):
    """Run ``ctc_frames`` chunk by chunk in both packages from fresh states;
    frame offsets advance by each lane's lens."""
    j = JCtcG.init_state(batch, max_tokens)
    t = TCtcG.init_state(batch, max_tokens)
    off = np.zeros(batch, np.int32)
    for lp, lens in zip(chunks, lens_per_chunk):
        lens = np.asarray(lens, np.int32)
        j = JCtcG.ctc_frames(j, jnp.asarray(lp), jnp.asarray(lens), jnp.asarray(off))
        t = TCtcG.ctc_frames(t, torch.from_numpy(lp), torch.from_numpy(lens),
                             torch.from_numpy(off))
        _assert_same(t, j)
        off = off + lens
    return t


def test_collapse_matches_jax():
    t = _both([_lp([0, 3, 3, 0, 4, 4, 4, 0, 3, 5])], [[10]])
    assert t.tokens[0, :4].tolist() == [3, 4, 3, 5] and t.timestamps[0, :4].tolist() == [1, 4, 8, 9]


def test_cross_chunk_collapse_matches_jax():
    lp = _lp([3, 3, 3, 3, 3, 3])
    t = _both([lp[:, :3], lp[:, 3:]], [[3], [3]])
    assert int(t.count[0]) == 1 and int(t.timestamps[0, 0]) == 0


def test_trailing_blanks_match_jax():
    lp = _lp([3, 0, 0, 0, 0, 0, 0, 0])
    t = _both([lp[:, :4], lp[:, 4:], lp[:, 4:]], [[4], [4], [2]])
    assert int(t.trailing_blanks[0]) == 3 + 4 + 2


def test_max_tokens_overflow_drops_as_jax():
    """Emissions past the buffer are dropped (the reference's
    ``mode="drop"``), within a chunk and across chunks; count stops at the
    buffer's size."""
    lp = _lp([3, 4, 5, 6, 7, 3, 4, 5, 6, 7])
    t = _both([lp[:, :7], lp[:, 7:]], [[7], [3]], max_tokens=4)
    assert t.tokens[0].tolist() == [3, 4, 5, 6] and int(t.count[0]) == 4


def test_random_ragged_batch_matches_jax():
    rng = np.random.default_rng(5)
    # a few strong tokens, so repeats and blank runs occur
    chunks = [(rng.standard_normal((4, 9, 6)) * 3).astype(np.float32) for _ in range(3)]
    _both(chunks, [[9, 4, 0, 9], [9, 9, 1, 0], [2, 9, 9, 0]], max_tokens=12, batch=4)


@pytest.mark.parametrize("cd", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_log_probs_match_jax(cd):
    cfg = JCtc.CtcConfig(encoder_dim=48, vocab_size=40)
    params = jax.device_get(JCtc.init_params(jax.random.PRNGKey(3), cfg))
    enc = np.random.default_rng(4).standard_normal((2, 11, 48)).astype(np.float32) * 3
    want = np.asarray(JCtc.log_probs(params, jnp.asarray(enc),
                                     None if cd is None else jnp.bfloat16))
    head = TCtc.Ctc(TCtc.CtcConfig(48, 40), params)
    got = head(torch.from_numpy(enc), cd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 if cd is None else 0.05)


def test_ctc_greedy_search_matches_jax():
    lp = (np.random.default_rng(8).standard_normal((3, 20, 7)) * 3).astype(np.float32)
    lens = np.array([20, 11, 0], np.int32)
    want = JCtcG.ctc_greedy_search(jnp.asarray(lp), jnp.asarray(lens), max_tokens=8)
    got = TCtcG.ctc_greedy_search(torch.from_numpy(lp), torch.from_numpy(lens), max_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- zipformer2-CTC in the recognizers -------------------------------------------


@pytest.fixture(scope="module")
def bundles():
    return JBundle.from_dir(PIN_DIR), ModelBundle.from_dir(PIN_DIR, device="cpu")


def test_pin_fixture_equals_a_fresh_jax_bundle(tmp_path):
    """The committed dir was written by

        ModelBundle.random("zipformer2ctc", Zipformer2Config(**PIN_CFG),
                           vocab_size=32, seed=4).save(PIN_DIR)

    with the JAX package's ModelBundle — the pin's bundle
    (tests/test_pinned_transcripts.py:59-67).  It must not drift from it.
    That ``random`` splits the seed into (encoder, decoder, joiner, ctc)
    keys, so its encoder is the zipformer2 pin's (same config, same seed;
    held against a fresh bundle in tests/test_torch_offline.py) and only
    the CTC head is drawn here."""
    k_ctc = jax.random.split(jax.random.PRNGKey(4), 4)[3]
    ctc_cfg = JCtc.CtcConfig(encoder_dim=32, vocab_size=32)
    zip_pin = os.path.join(REPO, "tests", "torch_port_data", "zipformer2_pin", "params.npz")
    with np.load(os.path.join(PIN_DIR, "params.npz")) as a, np.load(zip_pin) as z:
        want = {k: z[k] for k in z.files if k.startswith("encoder.")}
        want.update({f"ctc.output.{k}": np.asarray(v) for k, v in
                     JCtc.init_params(k_ctc, ctc_cfg)["output"].items()})
        assert sorted(a.files) == sorted(want)
        for k in a.files:
            np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    loaded = JBundle.from_dir(PIN_DIR)
    JBundle("zipformer2ctc", JZ.Zipformer2Config(**PIN_CFG), loaded.params, loaded.tokens,
            loaded.frontend_cfg, ctc_cfg=ctc_cfg).save(str(tmp_path))
    for name in ("config.json", "tokens.txt"):
        with open(os.path.join(PIN_DIR, name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name


def test_bundle_loads_the_ctc_head(bundles):
    jb, tb = bundles
    assert tb.is_ctc and tb.decoder is None and tb.joiner is None
    assert tb.vocab_size == jb.vocab_size == 32 and tb.ctc_cfg.encoder_dim == 32
    for k, v in params_from_numpy(jax.device_get(jb.params["ctc"])).state_dict().items():
        np.testing.assert_array_equal(tb.ctc.state_dict()[k].numpy(), v.numpy())
    rb = ModelBundle.random("zipformer2ctc", tb.encoder_cfg, vocab_size=40, device="cpu")
    assert rb.is_ctc and rb.vocab_size == 40 and rb.decoder is None


def test_offline_reproduces_the_pin_and_matches_jax(bundles):
    jb, tb = bundles
    pcms = [_pcm(6400), _pcm(9100, 3), _pcm(3000, 4)]
    out = []
    for rec in (JOffline(jb, compute_dtype=None),
                OfflineRecognizer(tb, compute_dtype=None, device="cpu")):
        streams = []
        for x in pcms:
            s = rec.create_offline_stream()
            s.add_samples(x)
            streams.append(s)
        out.append([(r.text, r.tokens, r.timestamps) for r in rec.get_results(streams)])
    assert out[1] == out[0]
    assert out[1][0][0] == PIN_TEXT and out[1][0][2] == PIN_TIMESTAMPS


def _feed(rec, stream, pcm, feed=800):
    out = []
    for i in range(0, len(pcm), feed):
        stream.add_samples(pcm[i:i + feed])
        out.extend((r.text, r.tokens, r.timestamps) for r in rec.get_results([stream]))
    stream.input_finished()
    while not stream.is_finished:
        out.extend((r.text, r.tokens, r.timestamps) for r in rec.get_results([stream]))
    out.extend((r.text, r.tokens, r.timestamps) for r in rec.get_results([stream]))
    return out


def test_online_partials_match_jax_and_give_the_pin(bundles):
    jb, tb = bundles
    jrec = JOnline(jb, compute_dtype=None, max_lanes=2)
    trec = OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, device="cpu")
    want = _feed(jrec, jrec.create_online_stream(), _pcm(6400))
    got = _feed(trec, trec.create_online_stream(), _pcm(6400))
    assert got == want and got[-1][0] == ONLINE_PIN_TEXT
    s = trec.create_online_stream()
    s.add_samples(_pcm(6400))
    assert trec.decode_to_end(s).text == ONLINE_PIN_TEXT


def test_ctc_bundle_forces_ctc_greedy(bundles):
    _, tb = bundles
    for method in ("greedy_search", "modified_beam_search"):
        assert OfflineRecognizer(tb, decoding_method=method,
                                 device="cpu").decoding_method == "greedy_search_ctc"
        assert OnlineRecognizer(tb, decoding_method=method,
                                device="cpu").decoding_method == "greedy_search_ctc"
    with pytest.raises(ValueError, match="hotwords"):
        OfflineRecognizer(tb, device="cpu", hotwords=["tok29"])


def test_windows_per_step_3_equals_1(bundles):
    _, tb = bundles

    def run(wps):
        rec = OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, windows_per_step=wps,
                               device="cpu")
        sa, sb = rec.create_online_stream(), rec.create_online_stream()
        sa.add_samples(_pcm(rec.window_samples + 5 * rec.hop_samples, 31))
        sb.add_samples(_pcm(rec.window_samples + 1 * rec.hop_samples, 32))
        while sa._ready() or sb._ready():
            rec.get_results([sa, sb])
        return [(r.text, r.timestamps) for r in rec.get_results([sa, sb])]

    one = run(1)
    assert run(3) == one and one[0][0]


def test_endpoint_decisions_match_jax(bundles):
    jb, tb = bundles
    cfg_kw = dict(min_trailing_silence_no_text=0.3, min_trailing_silence_after_text=0.2,
                  max_utterance_length=1.0, frame_seconds=0.04)
    pcm = np.concatenate([_pcm(6400), np.zeros(16000, np.float32)])
    decisions = []
    for rec in (JOnline(jb, compute_dtype=None, max_lanes=2, enable_endpoint=True,
                        endpoint_config=JE.EndpointConfig(**cfg_kw)),
                OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, enable_endpoint=True,
                                 endpoint_config=TE.EndpointConfig(**cfg_kw), device="cpu")):
        s = rec.create_online_stream()
        got = []
        for i in range(0, len(pcm), 800):
            s.add_samples(pcm[i:i + 800])
            rec.get_results([s])
            got.append(rec.is_endpoint(s))
        decisions.append(got)
    assert decisions[1] == decisions[0] and True in decisions[0] and False in decisions[0]


def test_snapshot_carries_a_ctc_stream_across_packages(bundles):
    jb, tb = bundles
    pcm = _pcm(6400)
    jrec = JOnline(jb, compute_dtype=None, max_lanes=2)
    js = jrec.create_online_stream()
    js.add_samples(pcm[:4000])
    while js._ready():
        jrec.get_results([js])
    snap = jrec.snapshot_stream(js)
    js.add_samples(pcm[4000:])
    want = jrec.decode_to_end(js)

    trec = OnlineRecognizer(tb, compute_dtype=None, max_lanes=3, device="cpu")
    trec.create_online_stream()
    ts = trec.restore_stream(snap)
    assert isinstance(trec._dec_state, TCtcG.CtcState)
    ts.add_samples(pcm[4000:])
    got = trec.decode_to_end(ts)
    assert (got.text, got.tokens, got.timestamps) == (want.text, want.tokens, want.timestamps)

    ts = trec.create_online_stream()
    ts.add_samples(pcm[:4000])
    while ts._ready():
        trec.get_results([ts])
    psnap = trec.snapshot_stream(ts)
    psnap["dec"] = JCtcG.CtcState(**dataclasses.asdict(psnap["dec"]))
    js = jrec.restore_stream(psnap)
    js.add_samples(pcm[4000:])
    back = jrec.decode_to_end(js)
    assert (back.text, back.timestamps) == (want.text, want.timestamps)


def test_state_from_numpy_picks_the_state_by_its_fields():
    from k2transducerasr_tpu.decode import rnnt_beam as JBeam
    from k2transducerasr_tpu.decode import rnnt_greedy as JGreedy
    from k2transducerasr_tpu_torch.decode import rnnt_beam as TBeam
    from k2transducerasr_tpu_torch.decode import rnnt_greedy as TGreedy

    a = np.zeros((2, 3), np.int32)
    for jcls, tcls in ((JGreedy.GreedyState, TGreedy.GreedyState),
                       (JBeam.BeamState, TBeam.BeamState), (JCtcG.CtcState, TCtcG.CtcState)):
        st = state_from_numpy(jcls(**{f.name: a for f in dataclasses.fields(jcls)}))
        assert type(st) is tcls and st.count.dtype == torch.int64

    @dataclasses.dataclass
    class Other:
        tokens: object
        count: object

    with pytest.raises(TypeError, match="no decode state"):
        state_from_numpy(Other(a, a))
