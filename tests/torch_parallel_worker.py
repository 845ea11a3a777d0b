"""Worker process of tests/test_torch_parallel.py, and a one-process fake
world for the port's mesh checks that need no collective.

    python tests/torch_parallel_worker.py <job.json> <rank>

Joins a gloo process group on the CPU (``parallel.distributed.initialize``
with the job's ``file://`` rendezvous, or with torchrun's environment when
the job says ``"init": "env"``), makes the job's mesh, runs each of the
job's tasks through the port's public entry points and writes what each
returned to ``<out>.rank<rank>.pkl``.  It imports only torch, numpy and the
port, never JAX: the references are computed by the test, in its own
process.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer  # noqa: E402
from k2transducerasr_tpu_torch.ops import layers as L  # noqa: E402
from k2transducerasr_tpu_torch.parallel import distributed as D  # noqa: E402
from k2transducerasr_tpu_torch.parallel import sharding as sh  # noqa: E402


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of world size ``n`` held by this one process
    (torch's ``fake`` backend, whose collectives do nothing), yielding
    ``mesh(device_type="cpu", n_data=1, n_model=n)``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield lambda device_type="cpu", n_data=1, n_model=n: sh.make_mesh(
            n_data, n_model, device_type)
    finally:
        dist.destroy_process_group()


def pcm(n: int, seed: int) -> np.ndarray:
    """tests/test_sharding.py's signal."""
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def offline_pcms(n_streams: int) -> list[np.ndarray]:
    """Utterances of unequal lengths (0.6-1.2 s)."""
    return [pcm(9600 + 2400 * (i % 4), i) for i in range(n_streams)]


def offline(rec, n_streams: int) -> list:
    streams = []
    for x in offline_pcms(n_streams):
        s = rec.create_offline_stream()
        s.add_samples(x)
        streams.append(s)
    return [(r.tokens, r.timestamps) for r in rec.get_results(streams)]


def streaming(rec, n_streams: int = 3, feed: int = 1600) -> list:
    """Streams fed side by side in ``feed``-sample chunks, one get_results
    per round, then each drained; every partial result and the finals."""
    pcms = [pcm(12000 + 2000 * i, 10 + i) for i in range(n_streams)]
    streams = [rec.create_online_stream() for _ in pcms]
    partial = []
    for off in range(0, max(len(x) for x in pcms), feed):
        for s, x in zip(streams, pcms):
            if off < len(x):
                s.add_samples(x[off:off + feed])
        partial.append([(r.tokens, r.timestamps) for r in rec.get_results(streams)])
    finals = []
    for s in streams:
        r = rec.decode_to_end(s)
        finals.append((r.tokens, r.timestamps))
        rec.dispose_stream(s)
    return partial + [finals]


SNAPSHOT_PCM = (pcm(16000, 7), 8000)  # the stream, and where it is snapshotted


def snapshot_half(rec) -> dict:
    x, half = SNAPSHOT_PCM
    s = rec.create_online_stream()
    s.add_samples(x[:half])
    rec.get_results([s])
    return rec.snapshot_stream(s)


def restore_rest(rec, snap: dict) -> tuple:
    x, half = SNAPSHOT_PCM
    rec.create_online_stream()  # the restored stream takes another lane
    s = rec.restore_stream(snap)
    s.add_samples(x[half:])
    r = rec.decode_to_end(s)
    return r.tokens, r.timestamps


def tp_linears(mesh) -> dict:
    """Each linear form under tensor parallelism against the same linear
    whole, at shapes where each axis is the one split: max |difference| over
    max |whole result| (float), or whether the result is bit-equal (int8)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    x[..., :32] *= 50.0  # the halves' int8 scales differ: the row's scale must be whole
    out = {}
    for name, shape in (("row", (64, 32)), ("col", (64, 128))):
        p = {"w": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32))}
        q = L.quantize_linear_int8(p)
        sp, sq = sh.shard_params({"lin": p}, mesh)["lin"], sh.shard_params({"lin": q}, mesh)["lin"]
        assert isinstance(sp["w"], sh.ModelShard) and sp["w"].axis == (0 if name == "row" else 1)
        assert isinstance(sq["w_q8"], sh.ModelShard) and sq["w_q8"].local.stride(0) == 1
        for cd, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
            got, want = L.apply_linear(sp, x, cd), L.apply_linear(p, x, cd)
            want = want.float()
            out[f"{name}_{tag}"] = float((got.float() - want).abs().max() / want.abs().max())
        out[f"{name}_int8_equal"] = bool(torch.equal(L.apply_linear(sq, x), L.apply_linear(q, x)))
        out[f"{name}_full_equal"] = bool(torch.equal(sp["w"].full(), p["w"]))
    return out


def run_task(task: dict, mesh, dirs: dict):
    kind = task["kind"]
    bundle = ModelBundle.from_dir(dirs[task["dir"]], device="cpu")
    kw = dict(compute_dtype=None, device="cpu", mesh=mesh, **task.get("kw", {}))
    if kind == "offline":
        return offline(OfflineRecognizer(bundle, **kw), task["streams"])
    if kind == "encoder":
        rec = OfflineRecognizer(bundle, **kw)
        streams = []
        for x in offline_pcms(task["streams"]):
            streams.append(rec.create_offline_stream())
            streams[-1].add_samples(x)
        samples, counts = rec.pcm_batch(streams)  # this data group's rows
        enc, lens = rec.encode(samples, counts)
        return enc.numpy(), lens.numpy()
    if kind == "streaming":
        return streaming(OnlineRecognizer(bundle, max_lanes=task["lanes"], **kw))
    if kind == "snapshot":
        return snapshot_half(OnlineRecognizer(bundle, max_lanes=task["lanes"], **kw))
    if kind == "restore":
        with open(task["snapshot"], "rb") as f:
            snap = pickle.load(f)
        return restore_rest(OnlineRecognizer(bundle, max_lanes=task["lanes"], **kw), snap)
    raise ValueError(f"unknown task kind {kind!r}")


def main() -> int:
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        job = json.load(f)
    rank = int(sys.argv[2])
    if job["init"] == "env":
        assert D.initialize(backend="gloo"), "initialize() returned False"
    else:
        assert D.initialize(job["init"], job["world"], rank, backend="gloo")
    results = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    try:
        for name, spec in job["meshes"].items():
            mesh = sh.make_mesh(*spec, device_type="cpu")
            for task_name, task in job["tasks"].get(name, {}).items():
                if task["kind"] == "tp_linears":
                    results[task_name] = tp_linears(mesh)
                elif task["kind"] == "global_batch":
                    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
                    rows = 8 // spec[0]
                    mine = x[sh.mesh_coords(mesh)[2] * rows:][:rows]
                    g = D.host_local_batch_to_global(mesh, mine)
                    results[task_name] = (tuple(g.shape), g.to_local().numpy(),
                                          g.full_tensor().numpy())
                else:
                    results[task_name] = run_task(task, mesh, job["dirs"])
        with open(f"{job['out']}.rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
