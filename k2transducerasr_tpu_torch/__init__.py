"""k2transducerasr_tpu_torch — the PyTorch/CUDA port of k2transducerasr_tpu.

The JAX package beside this one is the reference; this package computes the
same functions with PyTorch on an NVIDIA H100 (Hopper, sm_90a), and each of
the reference's Pallas TPU kernels becomes a CUDA C++ kernel written for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with ctypes.
It imports neither ``jax`` nor any module of ``k2transducerasr_tpu``.

Ported so far: the offline zipformer2 transducer with greedy search
(fbank -> encoder -> joiner projection -> blank-skipping greedy search ->
text), with ``relpos_attn_probs`` as a CUDA kernel.  Entry points take an
explicit ``device`` (default ``"cuda"``) and raise when CUDA is asked for but
absent; on CPU tensors every kernel wrapper runs its plain PyTorch version.

    from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
"""

__version__ = "0.1.0"

from k2transducerasr_tpu_torch.runtime.bundle import ModelBundle
from k2transducerasr_tpu_torch.runtime.offline import OfflineRecognizer, OfflineStream

__all__ = ["ModelBundle", "OfflineRecognizer", "OfflineStream", "__version__"]
