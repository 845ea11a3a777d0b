"""Multi-process orchestration over ``torch.distributed`` — PyTorch port of
``k2transducerasr_tpu/parallel/distributed.py``.

  * ``initialize()`` joins the process group (coordinator address, process
    count and id from the arguments or from torchrun's environment), so
    that every process shares one mesh (``parallel/sharding.make_mesh``);
  * each process ingests its own audio shard; ``host_local_batch_to_global``
    assembles the global batch from the per-process arrays as a DTensor
    split over the mesh's ``data`` dimension;
  * a stream moves between recognizers (and meshes) through
    ``OnlineRecognizer.snapshot_stream``/``restore_stream``.

A single process is a no-op.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from k2transducerasr_tpu_torch.parallel.sharding import batch_sharding


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the default process group from the arguments or from
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  Returns True
    if a multi-process group was initialized, False (doing nothing) for one
    process or no coordinator address.  ``coordinator_address`` is
    ``host:port`` or an ``init_method`` URL (``tcp://...``, ``file://...``).
    ``backend``: ``"nccl"`` or ``"gloo"``; None means ``nccl`` where CUDA is
    available and ``gloo`` on the CPU.  A failure raises: nothing switches
    backend by itself."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not addr:
        return False
    n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    pid = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if n <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=pid)
    return True


def host_local_batch_to_global(mesh, local_batch) -> DTensor:
    """Assemble per-process batches (each process's rows, in data-group
    order; the ranks of one data group pass the same rows) into one DTensor
    split over the mesh's ``data`` dimension; ``.full_tensor()`` is the
    global batch.  Over gloo with CUDA tensors it raises: DTensor's
    collectives crash the process there (a segmentation fault in
    ``wait_tensor``, measured on an H100); NCCL is the backend for cards."""
    if mesh.device_type == "cuda" and dist.get_backend(mesh.get_group("data")) == "gloo":
        raise ValueError("host_local_batch_to_global needs NCCL for CUDA tensors: DTensor's "
                         "collectives over gloo crash on them")
    local = torch.as_tensor(local_batch).to(mesh.device_type)
    return DTensor.from_local(local, mesh, batch_sharding(mesh), run_check=False)
