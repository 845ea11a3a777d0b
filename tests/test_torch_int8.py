"""The port's int8 mode (``accuracy="int8"``: ``ops/layers.py``'s
``quantize_tree_int8`` and int8 ``apply_linear``, the recognizers'
quantized encoders, ``save_params(dtype="int8")``) against the JAX package
on the CPU, inputs from numpy seeds.

Tolerances: ``w_q8``/``w_scale`` bit-equal (the recognizers quantize eagerly,
and float32 division is correctly rounded on both sides); one int8 linear
within float32 atol 1e-5 against the compiled JAX linear, whose activation
scale XLA computes as ``amax * float32(1/127)`` (the port does the same), bf16
within one bf16 ulp as well; a whole encoder under int8 in float32: the median
element within 1e-5 and every element within 2e-3 (outputs of order 1-3). The
float parts between the linears sum in another order (~1e-6), which can flip
an activation's int8 rounding at a .5 tie: that moves the linear's outputs for
that token by one int8 step (max|x|/127 times a weight), which re-rounds later
activations differently, and attention spreads it over the frames after it.
Measured on these configs over three seeds: zipformer2 up to 8.2e-4 (30% of
the elements beyond 1e-5 in the worst seed), v1, conformer and LSTM below 1e-6
(no flip at these depths). Tokens and timestamps identical. Every config here
has a linear of at least 4096 elements, which the recognizers' ``min_size``
quantizes (asserted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.models import registry as JR
from k2transducerasr_tpu.ops import layers as JL
from k2transducerasr_tpu.runtime import checkpoint as JCK
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.models import registry as TR
from k2transducerasr_tpu_torch.ops import layers as TL
from k2transducerasr_tpu_torch.runtime import checkpoint as TCK

# small configs, each with linears of >= 4096 elements (the embed/subsample
# output and the feed-forwards) beside smaller ones that stay float
FAMILIES = {
    "zipformer2": dict(num_encoder_layers=(1, 1), encoder_dims=(64, 96),
                       downsampling_factors=(1, 2), num_heads=(2, 2),
                       feedforward_dims=(128, 192), cnn_module_kernels=(7, 7),
                       query_head_dim=8, value_head_dim=4, pos_head_dim=2, pos_dim=8,
                       embed_channels=(2, 4, 8)),
    "zipformer": dict(num_encoder_layers=(1, 1), encoder_dims=(32, 48),
                      attention_dims=(16, 16), num_heads=(2, 2), feedforward_dims=(128, 96),
                      cnn_module_kernels=(7, 7), downsampling_factors=(1, 2),
                      embed_channels=(2, 4, 8)),
    "conformer": dict(d_model=32, num_layers=2, num_heads=4, ff_dim=128, cnn_kernel=7),
    "lstm": dict(d_model=32, rnn_hidden_size=48, num_layers=2, ff_dim=128),
}
CAUSAL = {
    "zipformer2": dict(causal=True, chunk_size=8, left_context_frames=16),
    "zipformer": dict(causal=True, chunk_size=4, left_context_frames=8),
    "conformer": dict(causal=True, chunk_size=8, left_context=16),
    "lstm": dict(chunk_size=4),
}


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


def _pcm(n, seed=9):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _cfgs(family, causal=False):
    base = "zipformer2" if family == "zipformer2ctc" else family
    kw = {**FAMILIES[base], **(CAUSAL[base] if causal else {})}
    return JR.get_encoder(family).Config(**kw), TR.get_encoder(family).Config(**kw)


def _flat_tensors(tree, prefix=""):
    """A tree of dicts, lists and tensors -> {dotted path: numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree.numpy()}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flat_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in JCK.flatten_params(tree).items() if v is not None
            and np.asarray(v).dtype != object}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantize_tree_matches_jax_bit_for_bit(family):
    jcfg, tcfg = _cfgs(family)
    tree = jax.device_get(JR.get_encoder(family).init_params(jax.random.PRNGKey(0), jcfg))
    want = _jax_flat(jax.device_get(JL.quantize_tree_int8(tree)))
    enc = TR.get_encoder(family).Encoder(tcfg, tree)
    got = _flat_tensors(TL.quantize_tree_int8(enc.tree()))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    q8 = [k for k in want if k.endswith(".w_q8")]
    assert q8, "the config has no linear that min_size=4096 quantizes"
    assert all(not k.endswith(".w") or want[k].size < 4096 or want[k].ndim != 2 for k in want)
    if family == "lstm":  # the recurrent weights are no {"w": ...} dicts: they stay float
        assert all(f"layers.{i}.lstm.wx" in got for i in range(tcfg.num_layers))


@pytest.mark.parametrize("shape,zero", [((4, 37, 96), False), ((3, 13), False),
                                        ((2, 5, 96), True), ((600, 96), False)],
                         ids=["batched", "padded-13x11", "zero-input", "many-rows"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_linear_int8_matches_jax(shape, zero, dtype):
    """int8 x int8 -> int32 with per-token scales: the padded shape (3 rows,
    K=13, N=11: none a multiple of 8, fewer rows than the card takes) and a
    zero input (amax 0 taken as 1) included."""
    rng = np.random.default_rng(3)
    k = shape[-1]
    n = 11 if k == 13 else 160
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "b": rng.standard_normal(n).astype(np.float32)}
    x = np.zeros(shape, np.float32) if zero else rng.standard_normal(shape).astype(np.float32)
    x[..., 0] *= 20.0  # one large channel per token, as activations have
    jcd, tcd = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq = jax.device_get(JL.quantize_linear_int8(p))  # eager, as the recognizers quantize
    # compiled, as the recognizers run it: XLA turns amax / 127 into amax * (1/127)
    want = np.asarray(jax.jit(JL.apply_linear, static_argnums=2)(jq, jnp.asarray(x), jcd)
                      .astype(jnp.float32))
    tq = TL.quantize_linear_int8({k_: torch.from_numpy(v) for k_, v in p.items()})
    got = TL.apply_linear(tq, torch.from_numpy(x), tcd)
    assert got.dtype == (torch.float32 if tcd is None else tcd)
    # bf16: XLA may fuse the scale product and the bias add (one float32 ulp
    # apart), so a result at a bf16 rounding tie may land one bf16 ulp away
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0 if tcd is None else 2**-7,
                               atol=1e-5)


def test_int8_matmul_pads_to_the_cards_shapes_exactly():
    """The zero padding (rows to >= 24, every dim to a multiple of 8) is
    exact: the int32 product equals numpy's."""
    rng = np.random.default_rng(4)
    for m, k, n in ((1, 3, 5), (17, 8, 8), (24, 16, 9), (40, 33, 64)):
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (k, n), dtype=np.int8)
        got = TL.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))
    # a column slice (zipformer2's key columns of in_proj) is not row-major
    b = torch.from_numpy(rng.integers(-127, 128, (16, 48), dtype=np.int8))
    a = torch.from_numpy(rng.integers(-127, 128, (5, 16), dtype=np.int8))
    np.testing.assert_array_equal(TL.int8_matmul(a, b[:, 16:32]).numpy(),
                                  (a.int() @ b[:, 16:32].int()).numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encoder_int8_matches_jax(family):
    """Each family's offline encoder on a quantized tree, float32, on a
    ragged batch."""
    jcfg, tcfg = _cfgs(family)
    jmod, tmod = JR.get_encoder(family), TR.get_encoder(family)
    tree = jax.device_get(jmod.init_params(jax.random.PRNGKey(1), jcfg))
    jq = JL.quantize_tree_int8(tree)
    x = (0.5 * np.random.default_rng(5).standard_normal((2, 83, 80))).astype(np.float32)
    lens = np.array([83, 50], np.int32)
    want, want_lens = jax.jit(jmod.forward, static_argnums=(1, 4))(
        jq, jcfg, jnp.asarray(x), jnp.asarray(lens), None)
    enc = tmod.Encoder(tcfg, tree)
    qenc = tmod.Encoder(tcfg, TL.quantize_tree_int8(enc.tree()))
    assert any(k.endswith(".w_q8") for k in qenc.state_dict())
    with torch.inference_mode():
        got, got_lens = qenc(torch.from_numpy(x), torch.from_numpy(lens), None)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert float(np.median(diff)) <= 1e-5 and float(diff.max()) <= 2e-3, (
        float(np.median(diff)), float(diff.max()))


def _streams(rec, pcms):
    out = []
    for x in pcms:
        s = rec.create_offline_stream()
        s.add_samples(x)
        out.append(s)
    return out


def _bundles(family, causal, seed=7):
    jcfg, tcfg = _cfgs(family, causal)
    jb = JBundle.random(family, jcfg, vocab_size=32, seed=seed, decoder_dim=24, joiner_dim=20)
    params = jax.device_get(jb.params)
    kw = (dict(ctc_cfg=jb.ctc_cfg) if jb.is_ctc else
          dict(decoder_cfg=jb.decoder_cfg, joiner_cfg=jb.joiner_cfg))
    tb = ModelBundle.from_params(family, tcfg, params, jb.tokens, jb.frontend_cfg,
                                 device="cpu", **kw)
    return jb, tb


@pytest.mark.parametrize("family", [*FAMILIES, "zipformer2ctc"])
def test_offline_recognizer_int8_matches_jax(family):
    """A ragged batch through both packages' offline recognizers under
    accuracy="int8", float32: identical tokens and timestamps; the port
    quantizes the encoder once, and the bundle's own encoder stays float."""
    jb, tb = _bundles(family, causal=False)
    pcms = [_pcm(6400, 1), _pcm(3900, 2)]
    jrec = JOffline(jb, compute_dtype=None, accuracy="int8")
    want = jrec.get_results(_streams(jrec, pcms))
    trec = OfflineRecognizer(tb, compute_dtype=None, accuracy="int8", device="cpu")
    got = trec.get_results(_streams(trec, pcms))
    assert sum(len(r.tokens) for r in want) > 0
    for g, w in zip(got, want):
        assert (g.text, g.tokens, g.timestamps) == (w.text, w.tokens, w.timestamps)
    q8 = [k for k in trec.encoder.state_dict() if k.endswith(".w_q8")]
    assert q8 and not any(k.endswith(".w_q8") for k in tb.encoder.state_dict())
    assert OfflineRecognizer(tb, compute_dtype=None, device="cpu").encoder is tb.encoder


@pytest.mark.parametrize("family", [*FAMILIES, "zipformer2ctc"])
def test_online_recognizer_int8_matches_jax(family):
    """One stream fed in 800-sample pieces through both packages' online
    recognizers under accuracy="int8", float32: every partial result and the
    final one identical."""
    jb, tb = _bundles(family, causal=True)
    pcm = _pcm(7200, 3)
    partials = []
    for rec in (JOnline(jb, compute_dtype=None, max_lanes=2, accuracy="int8"),
                OnlineRecognizer(tb, compute_dtype=None, max_lanes=2, accuracy="int8",
                                 device="cpu")):
        if isinstance(rec, OnlineRecognizer):
            assert any(k.endswith(".w_q8") for k in rec.encoder.state_dict())
        s = rec.create_online_stream()
        out = []
        for i in range(0, len(pcm), 800):
            s.add_samples(pcm[i:i + 800])
            out.extend((r.text, r.tokens, r.timestamps) for r in rec.get_results([s]))
        r = rec.decode_to_end(s)
        partials.append(out + [(r.text, r.tokens, r.timestamps)])
    assert partials[1] == partials[0] and partials[0][-1][1]


def test_unknown_accuracy_raises():
    _, tb = _bundles("lstm", causal=False)
    for cls in (OfflineRecognizer, OnlineRecognizer):
        with pytest.raises(ValueError, match="accuracy"):
            cls(tb, accuracy="int4", device="cpu")


def test_params_int8_npz_round_trip(tmp_path):
    """save_params(dtype="int8") writes the JAX package's members bit for
    bit; both packages load the file to the same tree, and
    ModelBundle.from_dir(accuracy="int8") prefers params.int8.npz."""
    jb, tb = _bundles("conformer", causal=False)
    tree = jax.device_get(jb.params)
    JCK.save_params(str(tmp_path / "jax.npz"), tree, dtype="int8")
    TCK.save_params(str(tmp_path / "port.npz"), tree, dtype="int8")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files
        assert any(k.endswith("::q8") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = JCK.flatten_params(JCK.load_params(str(tmp_path / "jax.npz")))
    got = TCK.flatten_params(TCK.load_params(str(tmp_path / "port.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    tb.save(str(tmp_path / "dir"))
    TCK.save_params(str(tmp_path / "dir" / "params.int8.npz"),
                    TCK.tree_to_numpy({"encoder": tb.encoder.tree(), "decoder": tb.decoder.tree(),
                                       "joiner": tb.joiner.tree()}), dtype="int8")
    b8 = ModelBundle.from_dir(str(tmp_path / "dir"), device="cpu", accuracy="int8")
    b32 = ModelBundle.from_dir(str(tmp_path / "dir"), device="cpu")
    w8 = b8.encoder.state_dict()["subsample.out.w"]
    w32 = b32.encoder.state_dict()["subsample.out.w"]
    assert not torch.equal(w8, w32)  # the int8 file's dequantized weights
    assert float((w8 - w32).abs().max()) <= float(w32.abs().max()) / 127 / 2 * (1 + 1e-6)
