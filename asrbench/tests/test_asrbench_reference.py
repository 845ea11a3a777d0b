"""The plain reference computes what the system computes: fbank, the
encoder offline and streamed (the system's cache-carrying steps against the
reference's chunk-causal forward), and the greedy search the served tokens
are judged by.  Tiny widths, float32, on the CPU."""

import numpy as np
import pytest
import torch

from asrbench.core import audio, check, spec, system, weights
from asrbench.reference.fbank import fbank
from asrbench.reference.transducer import Reference
from asrbench.tests import tiny


def _setup(streaming, seed=2**32 + 9):
    cfg = tiny.config(streaming)
    if streaming:
        cfg["recognizer"]["max_lanes"] = 2
    return cfg, _tree(cfg, seed)


def _tree(cfg, seed):
    return weights.make_tree(system.init_fns(cfg), seed, "cpu", spec.model(cfg).CONSTANT_RANGES)


@pytest.mark.parametrize("streaming", [False, True])
def test_fbank_matches_the_system(streaming):
    """Centred framing (the offline configuration, as icefall) and
    snip_edges (the streaming one)."""
    from k2transducerasr_tpu_torch.frontend.fbank import FbankConfig, fbank_compute
    cfg = tiny.config(streaming)
    assert cfg["frontend"]["snip_edges"] == streaming
    pcm = audio.clips(1, 16037, 3, "cpu")[0]
    ref = fbank(torch.from_numpy(pcm), cfg["frontend"])
    x = torch.from_numpy(audio.as_float(pcm))[None]
    got = fbank_compute(x, FbankConfig(**cfg["frontend"]), ref.shape[0])[0]
    assert got.shape == ref.shape
    assert torch.allclose(got, ref, atol=2e-3, rtol=0)


def test_offline_encoder_matches_the_system():
    cfg, tree = _setup(False)
    rec = system.build(cfg, tree, "cpu")
    ref = Reference(cfg, tree, "cpu")
    pcm = audio.clips(1, 40000, 4, "cpu")[0]
    feats = fbank(torch.from_numpy(pcm), cfg["frontend"])
    want = ref.encode(feats, streaming=False)
    got, lens = rec.encoder(feats[None], torch.tensor([feats.shape[0]]), None)
    assert int(lens[0]) == want.shape[0]
    assert torch.allclose(got[0, : want.shape[0]], want, atol=2e-4, rtol=2e-4)


def test_streamed_encoder_matches_the_reference():
    cfg, tree = _setup(True)
    rec = system.build(cfg, tree, "cpu")
    ref = Reference(cfg, tree, "cpu")
    pcm = audio.clips(1, rec.window_samples + 3 * rec.hop_samples, 5, "cpu")[0]
    feats = fbank(torch.from_numpy(pcm), cfg["frontend"])
    want = ref.encode(feats, streaming=True)
    enc = rec.encoder
    state = enc.init_state(1)
    e = rec.bundle.encoder_cfg
    outs = []
    for k in range(4):
        win = feats[None, k * e.decode_chunk_len: k * e.decode_chunk_len + e.chunk_input_len]
        out, state = enc.streaming_step(state, win, None)
        outs.append(out[0])
    got = torch.cat(outs)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=3e-4, rtol=3e-3)


@pytest.mark.parametrize("streaming", [False, True])
def test_gaps_are_zero_on_the_references_own_search(streaming):
    """The reference's greedy tokens, served back, read no gap; one token
    moved to another id reads one."""
    cfg, tree = _setup(streaming)
    ref = Reference(cfg, tree, "cpu")
    pcm = audio.clips(1, 12560 + 10240 * 4, 6, "cpu")[0]
    enc = check.encode(ref, pcm, streaming)
    ref.out_b[0] -= 0.5  # emit on some frames
    toks, stamps = _greedy(ref, enc, streaming)
    assert toks
    gaps = spec.decoding(cfg).served_gaps
    assert float(gaps(ref, enc, toks, stamps, streaming).max()) == 0.0
    bad = list(toks)
    bad[0] = 3 + (bad[0] - 2) % (cfg["vocab_size"] - 3)
    assert float(gaps(ref, enc, bad, stamps, streaming).max()) > 0.0
    assert float(gaps(ref, enc, toks[1:], stamps[1:], streaming).max()) > 0.0
    assert gaps(ref, enc, toks, [s + 10**6 for s in stamps], streaming).isinf().all()


def _greedy(ref, enc, streaming):
    skip = {0, 2} | ({1} if streaming else set())
    ctx, toks, stamps = [0] * ref.context, [], []
    for t in range(enc.shape[0]):
        dec = ref.decoder(torch.tensor([ctx[-ref.context:]]))
        y = int(ref.logits(enc[t:t + 1], dec).argmax())
        if y not in skip:
            toks.append(y)
            stamps.append(t)
            ctx.append(y)
    return toks, stamps


def test_weights_repeat_for_a_seed():
    cfg = tiny.config(False)
    a, b, c = _tree(cfg, 2**40 + 1), _tree(cfg, 2**40 + 1), _tree(cfg, 2**40 + 2)
    wa, wb, wc = (t["joiner"]["output"]["w"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert float(a["encoder"]["stacks"][0]["layers"][0]["bypass"].min()) >= 0.3
    assert np.isclose(float(wa.abs().max()), 1 / np.sqrt(32), rtol=0.05)
