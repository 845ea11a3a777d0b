"""Offline recognition demo — PyTorch port of ``examples/offline_demo.py``,
the analogue of the reference's ``Examples/OfflineRecognizer.cs`` program:
load a model dir, decode wavs (default: the model's test_wavs), print text
+ RTF.

  python -m k2transducerasr_tpu_torch.examples.offline_demo /path/to/model [a.wav ...] [-device cpu]
"""

import glob
import os
import sys

from k2transducerasr_tpu_torch.audio import read_wav, resample_linear
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer
from k2transducerasr_tpu_torch.utils.profiling import Stopwatch


def split_device(argv: list[str]) -> tuple[list[str], str]:
    """``argv`` without ``-device <name>``, and the name (default cuda)."""
    if "-device" not in argv:
        return argv, "cuda"
    i = argv.index("-device")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv: list[str] | None = None):
    args, device = split_device(sys.argv[1:] if argv is None else argv)
    model_dir = args[0]
    files = args[1:] or sorted(glob.glob(os.path.join(model_dir, "test_wavs", "*.wav")))
    bundle = ModelBundle.from_dir(model_dir, device=device)
    rec = OfflineRecognizer(bundle, device=device)

    sw = Stopwatch().start()
    streams, total = [], 0.0
    for f in files:
        audio = read_wav(f)
        pcm = resample_linear(audio.samples, audio.sample_rate, bundle.frontend_cfg.sample_rate)
        total += audio.duration
        s = rec.create_offline_stream()
        s.add_samples(pcm)
        streams.append(s)
    results = rec.get_results(streams)
    sw.stop(total)

    for f, r in zip(files, results):
        print(f)
        print(r.text)
        print()
    print(sw.report())
    print("end!")


if __name__ == "__main__":
    main()
