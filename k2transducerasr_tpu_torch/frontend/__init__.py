from k2transducerasr_tpu_torch.frontend.fbank import (
    FbankConfig,
    FbankExtractor,
    OnlineFbank,
    fbank_matrices,
    num_frames_for,
)

__all__ = [
    "FbankConfig",
    "FbankExtractor",
    "OnlineFbank",
    "fbank_matrices",
    "num_frames_for",
]
