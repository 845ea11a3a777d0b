"""The port's CLI (``python -m k2transducerasr_tpu_torch.cli``) against the
JAX package's on the same model dirs and wavs, on the CPU (``-device cpu``):
the same flags and ``MANYSPEECH_*`` env, the same transcript lines for
offline/online x one/multi, hotwords and int8 (every line but the timings),
the same ``convert`` subcommand and the same exit codes.  The wavs hold
16-bit samples, so the int16 PCM both recognizers decode is exact.

For the line-by-line comparison both CLIs' recognizers run in float32
(``compute_dtype=None`` patched in): the CLIs have no dtype flag and decode
in bf16, where the two packages round apart at the ulp level (ROADMAP §3,
"bf16 rounding"), which flips near-tied tokens and beam orders of these
random tiny models (measured: the LSTM dir's 1.wav, and the zipformer2 dir's
beams 2 and 3 of 1.wav).  In bf16, as shipped, the port's CLI prints the
zipformer2 pin dir's pinned transcripts (tests/test_pinned_transcripts.py).
"""

import functools
import importlib
import importlib.util
import os
import shutil
import wave

import numpy as np
import pytest
import torch

from k2transducerasr_tpu.cli import main as jcli
from k2transducerasr_tpu.models.lstm import LstmConfig
from k2transducerasr_tpu.runtime import offline as joffline
from k2transducerasr_tpu.runtime import online as jonline
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu_torch import ModelBundle
from k2transducerasr_tpu_torch.cli import main as tcli
from k2transducerasr_tpu_torch.convert.importer import export_model_dir
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config
from k2transducerasr_tpu_torch.runtime import offline as toffline
from k2transducerasr_tpu_torch.runtime import online as tonline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "zipformer2_pin")
OFFLINE_PIN = "tok25tok25tok18tok8tok12tok6tok25tok6"
ONLINE_PIN = "tok25tok25tok18tok8tok12tok6tok25tok6tok12tok6tok25tok6"
TIMINGS = ("elapsed_milliseconds:", "rtf:")
TINY_ZIP2 = dict(num_encoder_layers=(1, 1), encoder_dims=(16, 32), downsampling_factors=(1, 2),
                 num_heads=(2, 2), feedforward_dims=(32, 48), cnn_module_kernels=(7, 7),
                 query_head_dim=4, value_head_dim=4, pos_head_dim=2, pos_dim=8,
                 embed_channels=(2, 4, 8))


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def write_wavs(model_dir):
    """test_wavs/0.wav (the pin signal, 0.4 s) and 1.wav (1 s, seed 10)."""
    os.makedirs(os.path.join(model_dir, "test_wavs"), exist_ok=True)
    for i, n in enumerate((6400, 16000)):
        x = np.clip(np.round(_pcm(n, 9 + i) * 32767), -32768, 32767).astype("<i2")
        with wave.open(os.path.join(model_dir, "test_wavs", f"{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(x.tobytes())


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The zipformer2 pin dir and tests/test_cli.py's LSTM dir, with wavs."""
    zip2 = str(tmp_path_factory.mktemp("zip2") / "model")
    shutil.copytree(PIN_DIR, zip2)
    lstm = str(tmp_path_factory.mktemp("lstm") / "model")
    cfg = LstmConfig(d_model=32, rnn_hidden_size=48, num_layers=1, ff_dim=64, chunk_size=4)
    JBundle.random("lstm", cfg, vocab_size=16, seed=0, decoder_dim=24, joiner_dim=24).save(lstm)
    for d in (zip2, lstm):
        write_wavs(d)
    return {"zipformer2": zip2, "lstm": lstm}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, [line for line in out.out.splitlines() if not line.startswith(TIMINGS)], out.err


@pytest.fixture
def float32(monkeypatch):
    """Both packages' recognizers default to float32 compute."""
    for mod, name in ((joffline, "OfflineRecognizer"), (jonline, "OnlineRecognizer"),
                      (toffline, "OfflineRecognizer"), (tonline, "OnlineRecognizer")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), compute_dtype=None))


ARGS = [
    ("zipformer2", ["-type", "offline", "-batch", "multi"]),
    ("zipformer2", ["-type", "offline", "-batch", "one"]),
    ("zipformer2", ["-type", "online", "-batch", "multi"]),
    ("zipformer2", ["-type", "online", "-batch", "one"]),
    ("zipformer2", ["-type", "offline", "-hotwords", "tok6,tok26"]),
    ("zipformer2", ["-type", "online", "-batch", "multi", "-hotwords", "tok6"]),
    ("zipformer2", ["-type", "offline", "-accuracy", "int8"]),
    ("lstm", ["-type", "offline", "-batch", "multi", "-threads", "2"]),
    ("lstm", ["-type", "online", "-batch", "multi", "-accuracy", "int8"]),
]


@pytest.mark.parametrize("family,args", ARGS, ids=["-".join([f] + a[1::2]) for f, a in ARGS])
def test_cli_prints_what_the_jax_cli_prints(dirs, capsys, float32, family, args):
    argv = ["-base", dirs[family], *args]
    want = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv + ["-device", "cpu"], capsys)
    assert got == want
    assert got[0] == 0 and got[1][-1] == "end!" and got[1][-2] == "total_duration:1400"


def test_cli_prints_the_pins(dirs, capsys):
    wav = os.path.join(dirs["zipformer2"], "test_wavs", "0.wav")
    for kind, pin in (("offline", OFFLINE_PIN), ("online", ONLINE_PIN)):
        rc, lines, _ = _run(tcli.main, ["-base", dirs["zipformer2"], "-type", kind, "-batch",
                                        "multi", "-files", wav, "-device", "cpu"], capsys)
        assert rc == 0 and lines[:2] == [wav, pin]


def test_cli_model_and_env(dirs, capsys, float32, monkeypatch):
    """-model under -base, and the MANYSPEECH_* env (MANYSPEECH_DEVICE too)."""
    base, model = os.path.split(dirs["zipformer2"])
    monkeypatch.setenv("MANYSPEECH_BASE", base)
    monkeypatch.setenv("MANYSPEECH_MODEL", model)
    monkeypatch.setenv("MANYSPEECH_TYPE", "online")
    monkeypatch.setenv("MANYSPEECH_DEVICE", "cpu")
    want = _run(jcli.main, [], capsys)
    got = _run(tcli.main, [], capsys)
    assert got == want and got[1][1] == ONLINE_PIN
    assert tcli.parse_args([])["device"] == "cpu"


def test_parse_args_matches_jax(monkeypatch):
    monkeypatch.setenv("MANYSPEECH_BATCH", "multi")
    argv = ["-base", "/m", "-model", "x", "-files", "a.wav", "b.wav", "-threads", "4",
            "-method", "modified_beam_search", "-hotwords", "a,b", "-accuracy", "int8"]
    got = tcli.parse_args(argv + ["-device", "cpu"])
    assert got.pop("device") == "cpu"
    assert got == jcli.parse_args(argv)
    assert tcli.parse_args(argv)["device"] == "cuda"  # the card unless the CPU is asked for


def test_cli_exit_codes_match_jax(capsys, monkeypatch):
    for var in [k for k in os.environ if k.startswith("MANYSPEECH_")]:
        monkeypatch.delenv(var)
    missing = ["-base", "/nonexistent-dir-xyz", "-device", "cpu"]
    assert _run(tcli.main, missing, capsys)[0] == _run(jcli.main, missing[:2], capsys)[0] == 2
    for main in (jcli.main, tcli.main):  # an unknown flag
        with pytest.raises(SystemExit, match="unknown flag '-bogus'"):
            main(["-bogus"])
    want, got = _run(jcli.main, [], capsys), _run(tcli.main, [], capsys)  # no args: usage
    assert want[0] == got[0] == 0 and "Usage:" in got[1] and "-device" in "\n".join(got[1])
    for argv in (["convert"], ["convert", "a"]):
        assert _run(tcli.main, argv, capsys)[0] == _run(jcli.main, argv, capsys)[0] == 2


def test_cli_device_errors(dirs, capsys, monkeypatch):
    """No fallback: -device cuda without a card exits 2 with the error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, err = _run(tcli.main, ["-base", dirs["zipformer2"], "-device", "cuda"], capsys)
    assert rc == 2 and "torch.cuda.is_available() is False" in err and not lines
    rc, _, err = _run(tcli.main, ["-base", dirs["zipformer2"], "-device", "tpu"], capsys)
    assert rc == 2 and "tpu" in err


def test_cli_convert(capsys, float32, tmp_path):
    """``convert`` on a synthetic ONNX export (``export_model_dir``, which
    takes a non-causal zipformer2) of a random tiny bundle: both CLIs exit 0
    with the same line, and the port's converted dir prints what the source
    dir prints."""
    cfg = Zipformer2Config(**TINY_ZIP2)
    src = ModelBundle.random("zipformer2", cfg, vocab_size=32, seed=4, device="cpu")
    src.save(str(tmp_path / "src"))
    onnx = str(tmp_path / "onnx")
    export_model_dir(src, onnx)
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        dst = str(tmp_path / name)
        rc, lines, _ = _run(main, ["convert", onnx, dst], capsys)
        assert rc == 0 and lines == [f"converted {onnx} -> {dst}"]
        outs[name] = dst
    texts = []
    for d in (str(tmp_path / "src"), outs["torch"]):
        write_wavs(d)
        rc, lines, _ = _run(tcli.main, ["-base", d, "-device", "cpu"], capsys)
        assert rc == 0
        texts.append(lines[1::3][:2])
    assert texts[0] == texts[1] and texts[0][0]


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["offline_demo", "online_demo"])
def test_demo_prints_what_the_jax_demo_prints(dirs, capsys, monkeypatch, name):
    """Each demo's ``main`` on the CPU (``-device cpu``): the JAX demo's
    lines, timings aside."""
    port = importlib.import_module(f"k2transducerasr_tpu_torch.examples.{name}")
    monkeypatch.setattr("sys.argv", [name, dirs["zipformer2"]])
    _jax_demo(name).main()
    want = [line for line in capsys.readouterr().out.splitlines() if not line.startswith(TIMINGS)]
    port.main([dirs["zipformer2"], "-device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if not line.startswith(TIMINGS)]
    assert got == want and got[-1] == "end!"
    assert OFFLINE_PIN in "\n".join(got)
