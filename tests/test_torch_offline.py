"""The whole slice: the port's OfflineRecognizer(device="cpu") against the
JAX package's on the same model dir, plus the model-dir fixture, the
parameter bridge, the import rule, the device default and the reference's
public surface (C#-style names, ``rnnt_greedy_search``, ``joiner.forward``,
``decoder.forward_sequence``).

Tolerances: at float32 (``compute_dtype=None``) tokens and timestamps are
identical and the encoder output agrees to atol 1e-4 (summation order
through every layer); at bf16 the encoder output agrees to atol 0.05 — two
bf16 pipelines whose roundings differ at the ulp level (PyTorch's bf16
matmul rounds before the bias add), over values of order 1.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from k2transducerasr_tpu.decode import rnnt_greedy as JG
from k2transducerasr_tpu.frontend.fbank import fbank_compute as j_fbank_compute
from k2transducerasr_tpu.frontend.fbank import fbank_matrices as j_fbank_matrices
from k2transducerasr_tpu.frontend.fbank import num_frames_jnp
from k2transducerasr_tpu.models import decoder as JD
from k2transducerasr_tpu.models import joiner as JJ
from k2transducerasr_tpu.models import zipformer2 as JZ
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.checkpoint import flatten_params as j_flatten
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JRecognizer
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TG
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.models import zipformer2 as TZ
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy
from torch_parallel_worker import fake_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "zipformer2_pin")
PIN_TEXT = "tok25tok25tok18tok8tok12tok6tok25tok6"
TINY = dict(num_encoder_layers=(1, 1), encoder_dims=(16, 32), downsampling_factors=(1, 2),
            num_heads=(2, 2), feedforward_dims=(32, 48), cnn_module_kernels=(7, 7),
            query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
            embed_channels=(2, 4, 8))
PIN_CFG = dict(TINY, causal=True, chunk_size=8, left_context_frames=16)


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _streams(rec, pcms):
    out = []
    for x in pcms:
        s = rec.create_offline_stream()
        s.add_samples(x)
        out.append(s)
    return out


def _jax_encode(bundle, samples, counts, compute_dtype):
    """The JAX recognizer's front + encoder, jitted (its decode program
    returns only tokens)."""
    fcfg = bundle.frontend_cfg
    tables = tuple(jnp.asarray(m) for m in j_fbank_matrices(fcfg))

    @jax.jit
    def enc(params, samples, counts):
        x = samples.astype(jnp.float32) * (1.0 / 32768.0)
        t_pad = (x.shape[1] - fcfg.frame_length) // fcfg.frame_shift + 1
        feats = j_fbank_compute(x, fcfg, t_pad, n_valid=counts, tables=tables)
        return JZ.forward(params, bundle.encoder_cfg, feats, num_frames_jnp(counts, fcfg),
                          compute_dtype)

    out, lens = enc(bundle.params["encoder"], jnp.asarray(samples), jnp.asarray(counts))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lens)


@pytest.mark.parametrize("causal", [False, True], ids=["non-causal", "causal"])
def test_recognizer_matches_jax(tmp_path, causal):
    cfg = JZ.Zipformer2Config(causal=causal, **({"chunk_size": 8, "left_context_frames": 16}
                                                if causal else {}), **TINY)
    jb = JBundle.random("zipformer2", cfg, vocab_size=32, seed=11, decoder_dim=24,
                        joiner_dim=20)
    jb.save(str(tmp_path))
    pcms = [_pcm(6400, 1), _pcm(3900, 2), _pcm(9100, 3)]  # ragged batch

    jrec = JRecognizer(jb, compute_dtype=None)
    want = jrec.get_results(_streams(jrec, pcms))
    tb = ModelBundle.from_dir(str(tmp_path), device="cpu")
    trec = OfflineRecognizer(tb, compute_dtype=None, device="cpu")
    got = trec.get_results(_streams(trec, pcms))
    assert sum(len(r.tokens) for r in want) > 0
    for g, w in zip(got, want):
        assert (g.text, g.tokens, g.timestamps) == (w.text, w.tokens, w.timestamps)

    samples, counts = trec.pcm_batch(_streams(trec, pcms))
    for cd_t, cd_j, atol in ((None, None, 1e-4), (torch.bfloat16, jnp.bfloat16, 0.05)):
        rec = OfflineRecognizer(tb, compute_dtype=cd_t, device="cpu")
        enc, lens = rec.encode(samples, counts)
        want_enc, want_lens = _jax_encode(jb, samples.numpy(), counts.numpy(), cd_j)
        np.testing.assert_array_equal(lens.numpy(), want_lens)
        np.testing.assert_allclose(enc.float().numpy(), want_enc, rtol=0, atol=atol)


def test_reference_pad_matches_jax():
    from k2transducerasr_tpu.runtime.offline import apply_reference_pad as j_pad
    from k2transducerasr_tpu_torch.runtime.offline import apply_reference_pad as t_pad

    feats = np.random.default_rng(6).standard_normal((3, 40, 5)).astype(np.float32)
    feats[0, 3, 2] = 0.0  # exact zeros are rewritten too
    lens = np.array([40, 12, 3], np.int32)
    wf, wl = j_pad(jnp.asarray(feats), jnp.asarray(lens))
    gf, gl = t_pad(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_reproduces_the_zipformer2_pin():
    """tests/test_pinned_transcripts.py's zipformer2 offline pin, through the
    committed model dir."""
    bundle = ModelBundle.from_dir(PIN_DIR, device="cpu")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
    res = rec.get_result(_streams(rec, [_pcm(6400)])[0])
    assert res.text == PIN_TEXT
    assert res.timestamps == list(range(8))


def test_pin_fixture_equals_a_fresh_jax_bundle(tmp_path):
    """The committed dir was written by

        ModelBundle.random("zipformer2", Zipformer2Config(**PIN_CFG),
                           vocab_size=32, seed=4).save(PIN_DIR)

    with the JAX package's ModelBundle — the pin's bundle
    (tests/test_pinned_transcripts.py:59-67).  It must not drift from it."""
    fresh = JBundle.random("zipformer2", JZ.Zipformer2Config(**PIN_CFG), vocab_size=32, seed=4)
    fresh.save(str(tmp_path))
    with np.load(os.path.join(PIN_DIR, "params.npz")) as a, \
            np.load(tmp_path / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("config.json", "tokens.txt"):
        with open(os.path.join(PIN_DIR, name)) as f, open(tmp_path / name) as g:
            assert f.read() == g.read(), name


def test_params_from_numpy_round_trips_state_dict():
    jb = JBundle.random("zipformer2", JZ.Zipformer2Config(**TINY), vocab_size=16, seed=1,
                        decoder_dim=8, joiner_dim=8)
    tree = jax.device_get(jb.params)
    flat = j_flatten(tree)
    sd = params_from_numpy(tree).state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    tb = ModelBundle.from_params(
        "zipformer2", TZ.Zipformer2Config(**TINY), tree, None, None,
        TD.DecoderConfig(**dataclasses.asdict(jb.decoder_cfg)),
        TJ.JoinerConfig(**dataclasses.asdict(jb.joiner_cfg)), device="cpu",
    )
    for part in ("encoder", "decoder", "joiner"):
        sd = getattr(tb, part).state_dict()
        assert {f"{part}.{k}" for k in sd} == {k for k in flat if k.startswith(part + ".")}
        for k, v in sd.items():
            np.testing.assert_array_equal(v.numpy(), flat[f"{part}.{k}"])


def test_offline_public_surface_matches_jax():
    """The reference's C#-style names and ``text_len`` on the zipformer2
    pin dir: streams made by ``create_stream`` and ``CreateOfflineStream``,
    fed by ``AddSamples`` in two parts, decoded by ``GetResult`` and
    ``GetResults``, give the JAX recognizer's results, text lengths
    included."""
    jrec = JRecognizer(JBundle.from_dir(PIN_DIR), compute_dtype=None)
    trec = OfflineRecognizer(ModelBundle.from_dir(PIN_DIR, device="cpu"), compute_dtype=None,
                             device="cpu")
    out = []
    for rec in (jrec, trec):
        streams = []
        for make, x in ((rec.create_stream, _pcm(6400)), (rec.CreateOfflineStream, _pcm(3900, 2))):
            s = make()
            s.AddSamples(x[:2000])
            s.AddSamples(x[2000:])
            streams.append(s)
        results = [rec.GetResult(streams[0]), *rec.GetResults(streams)]
        out.append([(r.text, r.text_len, r.tokens, r.timestamps) for r in results])
    assert out[1] == out[0] and out[1][0][:2] == (PIN_TEXT, len(PIN_TEXT))


@pytest.mark.parametrize("extra_skip_sos", [False, True], ids=["offline", "skip-sos"])
def test_rnnt_greedy_search_matches_jax(extra_skip_sos):
    """The whole-utterance greedy entry on a ragged batch (a lane of 0
    frames, a token buffer that fills): tokens, timestamps and counts
    exactly."""
    jb = JBundle.random("zipformer2", JZ.Zipformer2Config(**TINY), vocab_size=16, seed=1,
                        decoder_dim=8, joiner_dim=8)
    tree = jax.device_get(jb.params)
    enc = np.random.default_rng(4).standard_normal((3, 40, 32)).astype(np.float32)
    lens = np.array([40, 17, 0], np.int32)
    want = JG.rnnt_greedy_search(jb.params["decoder"], jb.decoder_cfg, jb.params["joiner"],
                                 jb.joiner_cfg, jnp.asarray(enc), jnp.asarray(lens),
                                 max_tokens=24, extra_skip_sos=extra_skip_sos)
    got = TG.rnnt_greedy_search(params_from_numpy(tree["decoder"]),
                                TD.DecoderConfig(**dataclasses.asdict(jb.decoder_cfg)),
                                params_from_numpy(tree["joiner"]),
                                TJ.JoinerConfig(**dataclasses.asdict(jb.joiner_cfg)),
                                torch.from_numpy(enc), torch.from_numpy(lens), max_tokens=24,
                                extra_skip_sos=extra_skip_sos)
    assert int(np.asarray(want[2]).max()) == 24  # a full buffer
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("context_size", [1, 2])
def test_joiner_forward_and_decoder_forward_sequence_match_jax(context_size):
    """``joiner.forward`` from raw and from projected activations, and
    ``decoder.forward_sequence`` over label sequences with -1 entries,
    float32 to atol 1e-5."""
    rng = np.random.default_rng(3)
    jcfg, dcfg = JJ.JoinerConfig(16, 24, 20, 40), JD.DecoderConfig(40, 24, context_size)
    jp = jax.device_get(JJ.init_params(jax.random.PRNGKey(0), jcfg))
    dp = jax.device_get(JD.init_params(jax.random.PRNGKey(1), dcfg))
    for project, widths in ((True, (16, 24)), (False, (20, 20))):
        enc = rng.standard_normal((2, 5, widths[0])).astype(np.float32)
        dec = rng.standard_normal((2, 5, widths[1])).astype(np.float32)
        want = JJ.forward(jp, jnp.asarray(enc), jnp.asarray(dec), project_input=project)
        got = TJ.forward(params_from_numpy(jp), torch.from_numpy(enc), torch.from_numpy(dec),
                         project_input=project)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    ys = rng.integers(-1, 40, (3, 7))
    want = JD.forward_sequence(dp, dcfg, jnp.asarray(ys, jnp.int32))
    got = TD.forward_sequence(params_from_numpy(dp), TD.DecoderConfig(40, 24, context_size),
                              torch.from_numpy(ys))
    assert got.shape == (3, 7, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelBundle.from_dir(PIN_DIR)
    bundle = ModelBundle.from_dir(PIN_DIR, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        OfflineRecognizer(bundle)
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is make_mesh's
        OfflineRecognizer(bundle, device="cpu", mesh=object())
    with fake_world(4):  # the mesh's dimensions must be ("data", "model")
        bad = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("a", "b"))
        with pytest.raises(ValueError, match="dimensions"):
            OfflineRecognizer(bundle, device="cpu", mesh=bad)
    assert OfflineRecognizer(bundle, device="cpu", accuracy="int8").accuracy == "int8"


def test_config_json_loads_into_the_port():
    with open(os.path.join(PIN_DIR, "config.json")) as f:
        raw = json.load(f)
    assert TZ.Zipformer2Config(**raw["encoder"]) == TZ.Zipformer2Config(**PIN_CFG)


_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|k2transducerasr_tpu)(?:[.\s]|$)", re.M)


def test_port_imports_no_jax():
    code = (
        "import sys, k2transducerasr_tpu_torch, k2transducerasr_tpu_torch.runtime.offline\n"
        "import k2transducerasr_tpu_torch.runtime.online, k2transducerasr_tpu_torch.runtime.endpoint\n"
        "import k2transducerasr_tpu_torch.models.conformer, k2transducerasr_tpu_torch.frontend.fbank\n"
        "import k2transducerasr_tpu_torch.decode.rnnt_beam, k2transducerasr_tpu_torch.decode.ctc_greedy\n"
        "import k2transducerasr_tpu_torch.models.ctc, k2transducerasr_tpu_torch.text.hotwords\n"
        "import k2transducerasr_tpu_torch.models.zipformer, k2transducerasr_tpu_torch.models.lstm\n"
        "import k2transducerasr_tpu_torch.frontend, k2transducerasr_tpu_torch.native\n"
        "import k2transducerasr_tpu_torch.audio.codecs\n"
        "import k2transducerasr_tpu_torch.convert.importer\n"
        "import k2transducerasr_tpu_torch.convert.zipformer2_map\n"
        "import k2transducerasr_tpu_torch.convert.zipformer1_map\n"
        "import k2transducerasr_tpu_torch.convert.family_maps\n"
        "import k2transducerasr_tpu_torch.parallel.sharding, k2transducerasr_tpu_torch.parallel.distributed\n"
        "import k2transducerasr_tpu_torch.cli.main, k2transducerasr_tpu_torch.utils.metrics\n"
        "import k2transducerasr_tpu_torch.utils.profiling\n"
        "import k2transducerasr_tpu_torch.examples.offline_demo\n"
        "import k2transducerasr_tpu_torch.examples.online_demo\n"
        "from k2transducerasr_tpu_torch.runtime.checkpoint import state_from_numpy\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'k2transducerasr_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'k2transducerasr_tpu.'))]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120).stdout.strip()
    assert out == "[]"
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "k2transducerasr_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not _JAX_IMPORT.search(f.read()), path
    # the prefix trap: the port's own imports must not match
    assert not _JAX_IMPORT.search("from k2transducerasr_tpu_torch.ops import layers")
    assert _JAX_IMPORT.search("from k2transducerasr_tpu.ops import layers")
    assert _JAX_IMPORT.search("import k2transducerasr_tpu\n")
