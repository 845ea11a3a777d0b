from k2transducerasr_tpu_torch.audio.resample import resample_linear
from k2transducerasr_tpu_torch.audio.wav import AudioData, read_audio, read_wav

__all__ = ["read_wav", "read_audio", "AudioData", "resample_linear"]
