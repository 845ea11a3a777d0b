"""Recognition CLI — PyTorch port of ``k2transducerasr_tpu/cli/main.py``:
flag/env parity with the reference console app.

Reference surface (``Examples/Program.cs:16-23,165-205``):
  flags:   -base <dir> -type online|offline -batch one|multi -model <name>
           -accuracy int8|fp32 -threads N -files a.wav b.wav ...
  env:     MANYSPEECH_BASE / _TYPE / _BATCH / _MODEL / _ACCURACY / _THREADS
  model-dir discovery prefers *.{accuracy}.* files; default input is the
  model's ``test_wavs`` directory; prints per-file text + elapsed/total
  duration/RTF (Examples/OfflineRecognizer.cs:184-190).

Extras beyond the reference: ``-method greedy_search|modified_beam_search``,
``-hotwords "w1,w2"`` (n-best hotword preference, beam search only),
``-accuracy int8`` additionally runs the int8 COMPUTE path (the reference's
int8 models imply int8 kernels; here file preference and kernel mode are
both keyed on the same flag), and a ``convert`` subcommand (ONNX export ->
framework model dir).  ``-device cuda|cpu`` (env MANYSPEECH_DEVICE, default
cuda) says where the port runs: on the card unless the CPU is asked for; with
no card, ``-device cuda`` exits 2 with the error.

Usage:
    python -m k2transducerasr_tpu_torch.cli -base /models -model my-model \
        -type offline -batch multi -files a.wav b.wav
    python -m k2transducerasr_tpu_torch.cli convert /path/onnx_dir /path/out_dir
"""

from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np


def _env(name: str, default: str = "") -> str:
    return os.environ.get("MANYSPEECH_" + name, default)


def parse_args(argv: list[str]) -> dict:
    opts = {
        "base": _env("BASE", "."),
        "type": _env("TYPE", "offline"),
        "batch": _env("BATCH", "one"),
        "model": _env("MODEL", ""),
        "accuracy": _env("ACCURACY", ""),
        "threads": int(_env("THREADS", "0") or 0),  # parsed; unused, as in the reference CLI
        "device": _env("DEVICE", "cuda"),
        "method": "greedy_search",
        "hotwords": "",
        "files": [],
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-files":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                opts["files"].append(argv[i])
        elif a in ("-base", "-type", "-batch", "-model", "-accuracy", "-method",
                   "-hotwords", "-device"):
            i += 1
            opts[a[1:]] = argv[i]
        elif a == "-threads":
            i += 1
            opts["threads"] = int(argv[i])
        elif a in ("-h", "--help"):
            print(__doc__)
            raise SystemExit(0)
        else:
            raise SystemExit(f"unknown flag {a!r} (see --help)")
        i += 1
    return opts


def load_audio(path: str, target_rate: int) -> np.ndarray:
    from k2transducerasr_tpu_torch.audio import read_wav, resample_linear

    audio = read_wav(path)
    return resample_linear(audio.samples, audio.sample_rate, target_rate)


def run(opts: dict) -> int:
    from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
    from k2transducerasr_tpu_torch.runtime.device import resolve_device

    try:
        device = resolve_device(opts["device"])
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    model_dir = os.path.join(opts["base"], opts["model"]) if opts["model"] else opts["base"]
    if not os.path.isdir(model_dir):
        print(f"model directory not found: {model_dir}", file=sys.stderr)
        return 2
    bundle = ModelBundle.from_dir(model_dir, device=device, accuracy=opts["accuracy"])
    # -accuracy int8 also selects the int8 COMPUTE path (reference parity:
    # its int8 model files run ORT int8 kernels)
    compute_accuracy = "int8" if opts["accuracy"] == "int8" else None
    hotwords = [h.strip() for h in opts["hotwords"].split(",") if h.strip()] or None
    if hotwords:
        opts["method"] = "modified_beam_search"

    files = opts["files"]
    if not files:
        files = sorted(glob.glob(os.path.join(model_dir, "test_wavs", "*.wav")))
    if not files:
        print("no input files (-files) and no test_wavs/ in model dir", file=sys.stderr)
        return 2

    rate = bundle.frontend_cfg.sample_rate
    pcms = [load_audio(f, rate) for f in files]
    total_duration = sum(len(p) for p in pcms) / rate

    t0 = time.time()
    if opts["type"] == "offline":
        from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer

        rec = OfflineRecognizer(bundle, decoding_method=opts["method"],
                                accuracy=compute_accuracy, hotwords=hotwords, device=device)
        streams = []
        for pcm in pcms:
            s = rec.create_offline_stream()
            s.add_samples(pcm)
            streams.append(s)
        if opts["batch"] == "multi":
            results = rec.get_results(streams)
        else:
            results = [rec.get_result(s) for s in streams]
    else:
        from k2transducerasr_tpu_torch.runtime.online import OnlineRecognizer

        rec = OnlineRecognizer(
            bundle,
            decoding_method=opts["method"],
            max_lanes=max(1, len(pcms)) if opts["batch"] == "multi" else 1,
            accuracy=compute_accuracy,
            hotwords=hotwords,
            device=device,
        )
        results = []
        if opts["batch"] == "multi":
            streams = []
            for pcm in pcms:
                s = rec.create_online_stream()
                streams.append(s)
            # feed in 800-sample chunks like the reference example
            maxlen = max(len(p) for p in pcms)
            for off in range(0, maxlen, 800):
                for s, pcm in zip(streams, pcms):
                    if off < len(pcm) and not s.finished_input:
                        s.add_samples(pcm[off : off + 800])
                rec.get_results(streams)
            for s in streams:
                results.append(rec.decode_to_end(s))
                rec.dispose_stream(s)
        else:
            for pcm in pcms:
                s = rec.create_online_stream()
                for off in range(0, len(pcm), 800):
                    s.add_samples(pcm[off : off + 800])
                    r = rec.get_results([s])[0]
                results.append(rec.decode_to_end(s))
                rec.dispose_stream(s)

    elapsed_ms = (time.time() - t0) * 1000.0
    for f, r in zip(files, results):
        print(f)
        print(r.text)
        print()
    print(f"elapsed_milliseconds:{elapsed_ms:.4f}")
    print(f"total_duration:{total_duration * 1000:.0f}")
    rtf = (elapsed_ms / 1000.0) / max(total_duration, 1e-9)
    print(f"rtf:{rtf}")
    print("end!")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv and not any(k.startswith("MANYSPEECH_") for k in os.environ):
        # reference behavior: no args and no env -> print usage
        print(__doc__)
        return 0
    if argv and argv[0] == "convert":
        if len(argv) != 3:
            print("usage: ... convert <onnx_model_dir> <out_model_dir>", file=sys.stderr)
            return 2
        from k2transducerasr_tpu_torch.convert.importer import convert_model_dir

        convert_model_dir(argv[1], argv[2])
        print(f"converted {argv[1]} -> {argv[2]}")
        return 0
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
