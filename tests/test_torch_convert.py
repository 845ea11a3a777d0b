"""The port's model-dir writer (``runtime/checkpoint.save_params``/
``save_config``, ``ModelBundle.save``) and ONNX converter (``convert/``)
against the JAX package on the CPU.

Synthetic icefall-style exports (no ``onnx`` package): the protobuf bytes
come from tests/test_onnx_import.py's builders; the encoder initializers
are the zipformer2 export of tests/test_zipformer2_import.py (from a
numpy-seeded tree) and the state_dicts of the icefall oracles for v1,
conformer and LSTM (built under ``torch.random.fork_rng``, so the global
RNG is left as it was).  Both packages convert the same directory; the
port's must equal the JAX package's on every leaf the import sets, bit for
bit.  A leaf the export does not carry keeps its initial value, which the
two packages draw differently: the port's IMPORT_REPORT.txt names each such
leaf, and those are compared by shape and dtype only.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_onnx_import import model_bytes, node_bytes, tensor_bytes
from test_zipformer2_import import TINY as Z2_TINY
from test_zipformer2_import import _export as zipformer2_export

from k2transducerasr_tpu.convert import importer as JI
from k2transducerasr_tpu.convert import onnx_proto as JP
from k2transducerasr_tpu.models import registry as JREG
from k2transducerasr_tpu.runtime import checkpoint as JCK
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.convert import importer as TI
from k2transducerasr_tpu_torch.convert import onnx_proto as TP
from k2transducerasr_tpu_torch.models import registry as TREG
from k2transducerasr_tpu_torch.runtime import checkpoint as TCK

VOCAB = 20


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


# -- the ONNX reader, config detection, QDQ ----------------------------------


def _qdq_model():
    q = np.array([[10, -20, 3], [30, 40, -7]], dtype=np.int8)
    tensors = [tensor_bytes("a_q", q), tensor_bytes("a_s", np.asarray(0.5, np.float32)),
               tensor_bytes("a_zp", np.asarray(10, np.int8)),
               tensor_bytes("b_q", q), tensor_bytes("b_s", np.array([0.1, 0.2], np.float32)),
               tensor_bytes("c", np.arange(6, dtype=np.float32).reshape(2, 3)),
               tensor_bytes("n", np.array([3, -1, 10], np.int64))]
    nodes = [node_bytes("DequantizeLinear", ["a_q", "a_s", "a_zp"], ["a"]),
             node_bytes("DequantizeLinear", ["b_q", "b_s"], ["b"])]
    return model_bytes({"model_type": "lstm", "vocab_size": "500"}, tensors, nodes)


def test_onnx_reader_and_qdq_match_jax():
    data = _qdq_model()
    got, want = TP.parse_model(data), JP.parse_model(data)
    assert got.metadata == want.metadata == {"model_type": "lstm", "vocab_size": "500"}
    assert list(got.initializers) == list(want.initializers)
    for k, v in want.initializers.items():
        assert got.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.initializers[k], v)
    gd, wd = got.dequantized(), want.dequantized()
    assert list(gd) == list(wd) and {"a", "b", "c"} <= set(gd)
    for k in wd:
        np.testing.assert_array_equal(gd[k], wd[k], err_msg=k)


METADATA = [
    {"model_type": "zipformer2", "comment": "streaming ctc"},
    {"model_type": "zipformer2", "decode_chunk_len": "64", "num_encoder_layers": "2,2,3,4,3,2",
     "encoder_dims": "192,256,384,512,384,256", "cnn_module_kernels": "31,31,15,15,15,31",
     "num_heads": "4,4,4,8,4,4", "query_head_dims": "32", "value_head_dims": "12",
     "left_context_len": "128,64,32,16,32,64"},
    {"model_type": "zipformer", "num_encoder_layers": "2,4,3,2,4", "decode_chunk_len": "32",
     "left_context_len": "64", "attention_dims": "192,192,192,192,192"},
    {"model_type": "lstm", "d_model": "512", "rnn_hidden_size": "1024",
     "num_encoder_layers": "12", "decode_chunk_len": "32"},
    {"model_type": "conformer", "encoder_dim": "256", "num_encoder_layers": "8",
     "cnn_module_kernel": "31", "chunk_size": "16", "left_context": "64"},
    {"model_type": "conformer"},
]


@pytest.mark.parametrize("meta", METADATA, ids=lambda m: m["model_type"] + str(len(m)))
def test_config_detection_matches_jax(meta):
    assert TI.detect_model_type(meta) == JI.detect_model_type(meta)
    got, want = TI.encoder_config_from_metadata(meta), JI.encoder_config_from_metadata(meta)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    meta = dict(meta, vocab_size="500")
    assert (dataclasses.asdict(TI.decoder_config_from_metadata(meta))
            == dataclasses.asdict(JI.decoder_config_from_metadata(meta)))
    with pytest.raises(ValueError, match="model_type"):
        TI.encoder_config_from_metadata({"model_type": "transformer"})


# -- the model dir writer -----------------------------------------------------


def _npz(path):
    """{key: array}; an object member (a v1 ``None``) as None.  Only files
    these tests wrote are read, so unpickling is safe."""
    with np.load(path, allow_pickle=True) as z:
        return {k: (None if z[k].dtype == object else z[k]) for k in z.files}


def _same_dirs(got_dir, want_dir, by_shape=()):
    """config.json, tokens.txt and params.npz equal, key for key; the keys
    in ``by_shape`` by shape and dtype only."""
    with open(os.path.join(got_dir, "config.json")) as f, \
            open(os.path.join(want_dir, "config.json")) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(got_dir, "tokens.txt"), "rb") as f, \
            open(os.path.join(want_dir, "tokens.txt"), "rb") as g:
        assert f.read() == g.read()
    got, want = _npz(os.path.join(got_dir, "params.npz")), _npz(os.path.join(want_dir,
                                                                             "params.npz"))
    assert sorted(got) == sorted(want)  # (a tree taken through jax.device_get is sorted)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k not in by_shape:
            np.testing.assert_array_equal(g, w, err_msg=k)


SAVE_FAMILIES = {
    "zipformer2": dict(num_encoder_layers=(1, 1), encoder_dims=(16, 24),
                       downsampling_factors=(1, 2), num_heads=(2, 2), feedforward_dims=(24, 32),
                       cnn_module_kernels=(7, 7), query_head_dim=4, value_head_dim=4,
                       pos_head_dim=2, pos_dim=8, embed_channels=(2, 4, 8)),
    "zipformer2ctc": None,  # the zipformer2 config under a CTC head
    "zipformer": dict(num_encoder_layers=(1, 1, 1), encoder_dims=(16, 24, 24),
                      attention_dims=(8, 8, 8), num_heads=(2, 2, 2),
                      feedforward_dims=(24, 32, 24), cnn_module_kernels=(7, 7, 7),
                      downsampling_factors=(1, 2, 2), pos_dim=2, embed_channels=(2, 4, 8)),
    "conformer": dict(d_model=32, num_layers=2, num_heads=4, ff_dim=48, cnn_kernel=7),
    "lstm": dict(d_model=32, rnn_hidden_size=48, num_layers=2, ff_dim=64),
}


@pytest.mark.parametrize("family", list(SAVE_FAMILIES))
def test_bundle_save_matches_jax(tmp_path, family):
    """The port's ModelBundle.save of the JAX bundle's parameters writes the
    JAX package's dir, key for key (v1's None skip combiners as 0-d object
    members); the port reads its own dir back to the same tensors."""
    kw = SAVE_FAMILIES[family] or SAVE_FAMILIES["zipformer2"]
    jcfg = JREG.get_encoder(family).Config(**kw)
    tcfg = TREG.get_encoder(family).Config(**kw)
    jb = JBundle.random(family, jcfg, vocab_size=VOCAB, seed=4, decoder_dim=24, joiner_dim=20)
    jb.save(str(tmp_path / "jax"))
    heads = (dict(ctc_cfg=jb.ctc_cfg) if jb.is_ctc else
             dict(decoder_cfg=jb.decoder_cfg, joiner_cfg=jb.joiner_cfg))
    tb = ModelBundle.from_params(family, tcfg, jax.device_get(jb.params), jb.tokens,
                                 jb.frontend_cfg, device="cpu", **heads)
    tb.save(str(tmp_path / "port"))
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    back = ModelBundle.from_dir(str(tmp_path / "port"), device="cpu")
    for mod in ("encoder", "ctc") if jb.is_ctc else ("encoder", "decoder", "joiner"):
        a, b = getattr(back, mod).state_dict(), getattr(tb, mod).state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_save_config_and_params_match_jax(tmp_path):
    jb = JBundle.random("lstm", JREG.get_encoder("lstm").Config(**SAVE_FAMILIES["lstm"]),
                        vocab_size=VOCAB, seed=1, decoder_dim=24, joiner_dim=20)
    cfgs = {"encoder": jb.encoder_cfg, "decoder": jb.decoder_cfg, "joiner": jb.joiner_cfg,
            "ctc": None, "frontend": jb.frontend_cfg}
    JCK.save_config(str(tmp_path / "j.json"), "lstm", cfgs)
    TCK.save_config(str(tmp_path / "t.json"), "lstm", cfgs)
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    tree = jax.device_get(jb.params)
    for dtype in ("float32", "int8"):
        JCK.save_params(str(tmp_path / f"j_{dtype}.npz"), tree, dtype=dtype)
        TCK.save_params(str(tmp_path / f"t_{dtype}.npz"), tree, dtype=dtype)
        got, want = _npz(tmp_path / f"t_{dtype}.npz"), _npz(tmp_path / f"j_{dtype}.npz")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- convert_model_dir --------------------------------------------------------


def _oracle_export(module_name, cls_name, jcfg, seed):
    """The state_dict of an icefall oracle built from torch's RNG at
    ``seed`` inside ``fork_rng`` (the global state is restored)."""
    import importlib

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = getattr(importlib.import_module(module_name), cls_name)(jcfg)
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _lin(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _heads_export(rng, enc_dim, ddim=16, jdim=20, ctx=2):
    """decoder.onnx and joiner.onnx initializers in icefall's names and
    torch layouts, from numpy."""
    dec = {"embedding.weight": rng.standard_normal((VOCAB, ddim)).astype(np.float32),
           "conv.weight": (0.3 * rng.standard_normal((ddim, 4, ctx))).astype(np.float32)}
    join = {"encoder_proj.weight": (0.2 * rng.standard_normal((jdim, enc_dim))).astype(np.float32),
            "encoder_proj.bias": rng.standard_normal(jdim).astype(np.float32),
            "decoder_proj.weight": (0.2 * rng.standard_normal((jdim, ddim))).astype(np.float32),
            "decoder_proj.bias": rng.standard_normal(jdim).astype(np.float32),
            "output_linear.weight": (0.2 * rng.standard_normal((VOCAB, jdim))).astype(np.float32),
            "output_linear.bias": rng.standard_normal(VOCAB).astype(np.float32)}
    return dec, join


def _z2_meta():
    return {"num_encoder_layers": "1,1", "encoder_dims": "16,24", "cnn_module_kernels": "7,7",
            "num_heads": "2,2", "query_head_dims": "4,4", "value_head_dims": "4,4"}


def _source(family):
    """(metadata, encoder initializers, encoder output dim) of a synthetic
    export of ``family``."""
    from k2transducerasr_tpu.models import conformer as JC
    from k2transducerasr_tpu.models import lstm as JL
    from k2transducerasr_tpu.models import zipformer as JZ1
    from k2transducerasr_tpu_torch.models import zipformer2 as TZ2

    if family.startswith("zipformer2"):
        tree = TZ2.init_params(np.random.default_rng(11), Z2_TINY)
        export = zipformer2_export(tree, Z2_TINY)
        meta = dict(_z2_meta(), model_type="zipformer2")
        if family == "zipformer2ctc":
            rng = np.random.default_rng(12)
            export["ctc_output.1.weight"] = rng.standard_normal((VOCAB, 24)).astype(np.float32)
            export["ctc_output.1.bias"] = rng.standard_normal(VOCAB).astype(np.float32)
            meta.update(comment="streaming ctc zipformer2", vocab_size=str(VOCAB))
        return meta, export, 24
    if family == "zipformer":
        # metadata carries layers, dims and kernels; the rest are the defaults
        kw = dict(num_encoder_layers=(1, 1), encoder_dims=(16, 24), attention_dims=(16, 16),
                  cnn_module_kernels=(7, 7))
        meta = {"model_type": "zipformer", "num_encoder_layers": "1,1",
                "encoder_dims": "16,24", "attention_dims": "16,16", "cnn_module_kernels": "7,7"}
        return meta, _oracle_export("icefall_zipformer1_oracle", "OracleModel",
                                    JZ1.ZipformerConfig(**kw), 21), 24
    if family == "conformer":
        cfg = JC.ConformerConfig(d_model=32, num_layers=2, ff_dim=48, cnn_kernel=7)
        meta = {"model_type": "conformer", "encoder_dim": "32", "num_encoder_layers": "2",
                "cnn_module_kernel": "7"}
        return meta, _oracle_export("icefall_conformer_oracle", "OracleConformer", cfg, 22), 32
    cfg = JL.LstmConfig(d_model=32, rnn_hidden_size=48, num_layers=2, ff_dim=64)
    meta = {"model_type": "lstm", "d_model": "32", "rnn_hidden_size": "48",
            "num_encoder_layers": "2"}
    return meta, _oracle_export("icefall_lstm_oracle", "OracleLstm", cfg, 23), 32


# an export without these initializers leaves their leaves at initial value
DROPPED = {"encoder.encoders.0.layers.0.bypass_mid.bypass_scale": "stacks.0.layers.0.bypass_mid",
           "encoder.encoders.1.encoder.layers.0.feed_forward3.in_proj.weight":
           "stacks.1.layers.0.ff3.w1.w"}


def _write_source(root, family):
    meta, export, enc_dim = _source(family.replace("-partial", ""))
    if family.endswith("-partial"):
        export = {k: v for k, v in export.items() if k not in DROPPED}
    os.makedirs(root)

    def onnx(name, meta_, weights):
        tensors = [tensor_bytes(k, np.ascontiguousarray(v)) for k, v in weights.items()]
        with open(os.path.join(root, name), "wb") as f:
            f.write(model_bytes(meta_, tensors))

    onnx("encoder.onnx", meta, export)
    if not family.startswith("zipformer2ctc"):
        dec, join = _heads_export(np.random.default_rng(13), enc_dim)
        onnx("decoder.onnx", {"context_size": "2", "vocab_size": str(VOCAB)}, dec)
        onnx("joiner.onnx", {"joiner_dim": "20"}, join)
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.writelines(["<blk> 0\n", "<sos/eos> 1\n", "<unk> 2\n"]
                     + [f"tok{i} {i}\n" for i in range(3, VOCAB)])


def _left_at_init(report: str) -> list[str]:
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("encoder leaves left at their initial value"):
            return [x.strip() for x in lines[i + 1:] if x.startswith("  ")]
    return []


@pytest.mark.parametrize("family", ["zipformer2", "zipformer2ctc", "zipformer", "conformer",
                                    "lstm", "zipformer2-partial"])
def test_convert_model_dir_matches_jax(tmp_path, family):
    """Each family's synthetic export converted by both packages; under
    "zipformer2-partial" two initializers are missing, so two leaves keep
    their (different) initial values and the port's report names them."""
    src = str(tmp_path / "src")
    _write_source(src, family)
    JI.convert_model_dir(src, str(tmp_path / "jax"))
    TI.convert_model_dir(src, str(tmp_path / "port"))
    with open(tmp_path / "jax" / "IMPORT_REPORT.txt") as f:
        want_report = f.read()
    with open(tmp_path / "port" / "IMPORT_REPORT.txt") as f:
        got_report = f.read()
    assert "UNMAPPED" not in want_report, want_report
    assert got_report.startswith(want_report)  # the port adds the leaves left at init
    kept = _left_at_init(got_report)
    assert kept == ([f"encoder.{v}" for v in DROPPED.values()]
                    if family.endswith("-partial") else [])
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"), by_shape=set(kept))
    bundle = ModelBundle.from_dir(str(tmp_path / "port"), device="cpu")
    assert bundle.model_type == family.replace("-partial", "") and bundle.vocab_size == VOCAB
    # every leaf imported: the same transcript as the JAX dir gives (the JAX
    # package cannot reload its own v1 dir, whose None members are pickled)
    if not kept and family != "zipformer":
        from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline

        pcm = (0.3 * np.sin(np.arange(6400) / 16000 * 2 * np.pi * 420)).astype(np.float32)
        jb = JBundle.from_dir(str(tmp_path / "jax"))
        texts = []
        for rec in (JOffline(jb, compute_dtype=None),
                    OfflineRecognizer(bundle, compute_dtype=None, device="cpu")):
            s = rec.create_offline_stream()
            s.add_samples(pcm)
            texts.append(rec.get_result(s).tokens)
        assert texts[0] == texts[1] and texts[0]


def test_convert_reports_a_missing_ctc_head(tmp_path):
    """A zipformer2-CTC export without ctc_output raises in both packages."""
    src = str(tmp_path / "src")
    _write_source(src, "zipformer2")
    meta, export, _ = _source("zipformer2")
    meta.update(comment="ctc")
    with open(os.path.join(src, "encoder.onnx"), "wb") as f:
        f.write(model_bytes(meta, [tensor_bytes(k, np.ascontiguousarray(v))
                                   for k, v in export.items()]))
    for convert in (JI.convert_model_dir, TI.convert_model_dir):
        with pytest.raises(KeyError, match="ctc_output"):
            convert(src, str(tmp_path / "dst"))


def test_export_model_dir_round_trips_through_both_converters(tmp_path):
    """The port's synthetic export (importer.export_model_dir, which
    chip_smoke.py converts at full width): its encoder initializers are
    tests/test_zipformer2_import.py's export, its bytes test_onnx_import's;
    both packages convert it to the same dir, and the converted bundle
    decodes the source bundle's tokens."""
    from k2transducerasr_tpu_torch.convert.zipformer2_map import export_zipformer2_weights
    from k2transducerasr_tpu_torch.convert.onnx_proto import encode_model

    src = ModelBundle.random("zipformer2", TREG.get_encoder("zipformer2").Config(
        **SAVE_FAMILIES["zipformer2"]), vocab_size=VOCAB, seed=5, decoder_dim=16,
        joiner_dim=20, device="cpu")
    tree = TCK.tree_to_numpy(src.encoder.tree())
    got = export_zipformer2_weights(tree, src.encoder_cfg)
    want = zipformer2_export(tree, src.encoder_cfg)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)
    meta = {"model_type": "zipformer2", "num_heads": "2,2"}
    assert encode_model(meta, got) == model_bytes(
        meta, [tensor_bytes(k, np.ascontiguousarray(v, np.float32)) for k, v in want.items()])

    TI.export_model_dir(src, str(tmp_path / "src"))
    JI.convert_model_dir(str(tmp_path / "src"), str(tmp_path / "jax"))
    TI.convert_model_dir(str(tmp_path / "src"), str(tmp_path / "port"))
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    back = ModelBundle.from_dir(str(tmp_path / "port"), device="cpu")
    pcm = (0.3 * np.sin(np.arange(6400) / 16000 * 2 * np.pi * 420)).astype(np.float32)
    toks = []
    for bundle in (src, back):
        rec = OfflineRecognizer(bundle, compute_dtype=None, device="cpu")
        s = rec.create_offline_stream()
        s.add_samples(pcm)
        toks.append(rec.get_result(s).tokens)
    assert toks[0] == toks[1] and toks[0]
    with pytest.raises(ValueError, match="zipformer2"):
        TI.export_model_dir(ModelBundle.random(
            "conformer", TREG.get_encoder("conformer").Config(**SAVE_FAMILIES["conformer"]),
            vocab_size=VOCAB, decoder_dim=16, joiner_dim=20, device="cpu"), str(tmp_path / "x"))
