"""k2transducerasr_tpu_torch — the PyTorch/CUDA port of k2transducerasr_tpu.

The JAX package beside this one is the reference; this package computes the
same functions with PyTorch on an NVIDIA H100 (Hopper, sm_90a), and each of
the reference's Pallas TPU kernels becomes a CUDA C++ kernel written for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with ctypes.
It imports neither ``jax`` nor any module of ``k2transducerasr_tpu``.

Ported so far: every encoder family of the reference — the zipformer2,
zipformer v1, conformer and LSTM transducers with greedy search and
modified beam search (n-best results and hotwords), and zipformer2-CTC with
CTC greedy search; each offline (``OfflineRecognizer``: fbank -> encoder ->
the search -> text) and streaming (``OnlineRecognizer``: a device-resident
lane pool stepping each ready stream's window through fbank, the encoder's
``streaming_step`` and the search, with endpointing and snapshot/restore).
The attention of zipformer2 and zipformer v1 runs ``relpos_attn_probs``
(K1) and conformer's ``relpos_attn_ctx`` (K2) as CUDA kernels; the LSTM's
recurrence is PyTorch's LSTM (cuDNN on the card); the searches are plain
PyTorch.  Entry points
take an explicit ``device`` (default ``"cuda"``) and raise when CUDA is
asked for but absent; on CPU tensors every kernel wrapper runs its plain
PyTorch version.

    from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
"""

__version__ = "0.1.0"

from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer, OfflineStream
from k2transducerasr_tpu_torch.runtime.online import (
    OnlineRecognizer,
    OnlineRecognizerResult,
    OnlineStream,
)

__all__ = [
    "ModelBundle",
    "OfflineRecognizer",
    "OfflineStream",
    "OnlineRecognizer",
    "OnlineRecognizerResult",
    "OnlineStream",
    "__version__",
]
