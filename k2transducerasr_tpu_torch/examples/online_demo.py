"""Streaming recognition demo — PyTorch port of ``examples/online_demo.py``,
the analogue of ``Examples/OnlineRecognizer.cs``: feed 800-sample chunks,
print partial results as they change, flush at end of input.

  python -m k2transducerasr_tpu_torch.examples.online_demo /path/to/model [a.wav ...] [-device cpu]
"""

import glob
import os
import sys

from k2transducerasr_tpu_torch.audio import read_wav, resample_linear
from k2transducerasr_tpu_torch.examples.offline_demo import split_device
from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.online import OnlineRecognizer
from k2transducerasr_tpu_torch.utils.profiling import Stopwatch


def main(argv: list[str] | None = None):
    args, device = split_device(sys.argv[1:] if argv is None else argv)
    model_dir = args[0]
    files = args[1:] or sorted(glob.glob(os.path.join(model_dir, "test_wavs", "*.wav")))
    bundle = ModelBundle.from_dir(model_dir, device=device)
    rec = OnlineRecognizer(bundle, max_lanes=max(1, len(files)), enable_endpoint=True,
                           device=device)
    rate = bundle.frontend_cfg.sample_rate

    sw = Stopwatch().start()
    total = 0.0
    for f in files:
        audio = read_wav(f)
        pcm = resample_linear(audio.samples, audio.sample_rate, rate)
        total += audio.duration
        s = rec.create_online_stream()
        last = ""
        for off in range(0, len(pcm), 800):  # reference chunk feed size
            s.add_samples(pcm[off : off + 800])
            text = rec.get_results([s])[0].text
            if text != last:
                print(f"\r{text}", end="", flush=True)
                last = text
        res = rec.decode_to_end(s)
        print(f"\r{res.text}")
        rec.dispose_stream(s)
    sw.stop(total)
    print(sw.report())
    print("end!")


if __name__ == "__main__":
    main()
