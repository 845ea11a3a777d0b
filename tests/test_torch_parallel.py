"""The port's ``parallel/`` (``sharding``, ``distributed``) and both
recognizers under a mesh, on the CPU: gloo process groups of 2 and 4
worker processes (``tests/torch_parallel_worker.py``, which imports no JAX),
held against the JAX package's single-device results, which this process
computes.

* ``param_spec``/``param_shardings`` equal the JAX package's on every leaf,
  for n_model 1, 2 and 4 (each family's tiny tree, and ``Zipformer2Config()``'s
  leaf shapes).
* Two processes, ``initialize`` from torchrun's environment: the global
  batch of ``host_local_batch_to_global``; each tensor-parallel linear form
  (split on its input and on its output axis; float32 within 1e-6, bf16
  within 1e-2, of the whole linear's largest output: the partial sums are
  rounded apart; int8 bit-equal, with
  the two halves of each row at scales 50x apart, so a scale taken per slice
  would show); offline greedy on mesh 1x2; a stream snapshotted half-way on
  mesh 2x1 (every rank returns the same snapshot).
* Four processes, one spawn per mesh (2x2 and 4x1): offline greedy with 5
  streams (the data groups' padding), beam, CTC, int8, conformer, zipformer
  v1 and LSTM; streaming greedy, beam and CTC (3 streams side by side, every
  partial result); the 2x1 snapshot restored and drained.  Tokens and
  timestamps identical to the JAX package's (zipformer v1: to the port's
  single process, as the JAX package cannot reload a v1 dir it wrote; the
  port's single process equals JAX in tests/test_torch_zipformer1.py); the
  float32 encoder output within 1e-5 of the port's single process (the
  partial products of the split linears sum in another order).

Nothing here draws from torch's global RNG (asserted per test).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.models import registry as JR
from k2transducerasr_tpu.models.zipformer2 import Zipformer2Config as JZ2Config
from k2transducerasr_tpu.parallel import sharding as jsh
from k2transducerasr_tpu.runtime.bundle import ModelBundle as JBundle
from k2transducerasr_tpu.runtime.checkpoint import flatten_params as j_flatten
from k2transducerasr_tpu.runtime.offline import OfflineRecognizer as JOffline
from k2transducerasr_tpu.runtime.online import OnlineRecognizer as JOnline
from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.parallel import distributed as D
from k2transducerasr_tpu_torch.parallel import sharding as sh
from torch_parallel_worker import SNAPSHOT_PCM, fake_world, offline, offline_pcms, streaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")
SPAWN_TIMEOUT = 240  # seconds for a whole spawn; a hung rank fails the test

# tests/test_torch_int8.py's zipformer2: its linears reach quantize_tree_int8's min_size
INT8_CFG = dict(num_encoder_layers=(1, 1), encoder_dims=(64, 96), downsampling_factors=(1, 2),
                num_heads=(2, 2), feedforward_dims=(128, 192), cnn_module_kernels=(7, 7),
                query_head_dim=8, value_head_dim=4, pos_head_dim=2, pos_dim=8,
                embed_channels=(2, 4, 8))
# each family's tiny config (tests/test_torch_int8.py, tests/test_sharding.py)
SPEC_CFGS = {
    "zipformer2": dict(num_encoder_layers=(1, 1), encoder_dims=(16, 32),
                       downsampling_factors=(1, 2), num_heads=(2, 2), feedforward_dims=(32, 48),
                       cnn_module_kernels=(7, 7), query_head_dim=4, value_head_dim=4,
                       pos_head_dim=2, pos_dim=8, embed_channels=(2, 4, 8)),
    "zipformer2ctc": INT8_CFG,
    "zipformer": dict(num_encoder_layers=(1, 1), encoder_dims=(32, 48), attention_dims=(16, 16),
                      num_heads=(2, 2), feedforward_dims=(128, 96), cnn_module_kernels=(7, 7),
                      downsampling_factors=(1, 2), embed_channels=(2, 4, 8)),
    "conformer": dict(d_model=32, num_layers=2, num_heads=4, ff_dim=128, cnn_kernel=7),
    "lstm": dict(d_model=32, rnn_hidden_size=48, num_layers=2, ff_dim=128),
}

BEAM = {"decoding_method": "modified_beam_search"}
# name -> the task every rank runs (tests/torch_parallel_worker.py)
MESH_TASKS = {
    "offline_greedy": dict(kind="offline", dir="zipformer2", streams=5),
    "offline_beam": dict(kind="offline", dir="zipformer2", streams=3, kw=BEAM),
    "offline_ctc": dict(kind="offline", dir="zipformer2ctc", streams=3),
    "offline_int8": dict(kind="offline", dir="int8", streams=3, kw={"accuracy": "int8"}),
    "offline_conformer": dict(kind="offline", dir="conformer", streams=3),
    "offline_zipformer": dict(kind="offline", dir="zipformer", streams=3),
    "offline_lstm": dict(kind="offline", dir="lstm", streams=3),
    "streaming_greedy": dict(kind="streaming", dir="zipformer2", lanes=4),
    "streaming_beam": dict(kind="streaming", dir="zipformer2", lanes=4, kw=BEAM),
    "streaming_ctc": dict(kind="streaming", dir="zipformer2ctc", lanes=4),
    "restore": dict(kind="restore", dir="zipformer2", lanes=8),
    "encoder": dict(kind="encoder", dir="zipformer2", streams=5),
}
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


@pytest.fixture(autouse=True)
def global_rng_unchanged():
    before = torch.random.get_rng_state()
    yield
    assert torch.equal(torch.random.get_rng_state(), before), "test drew from torch's global RNG"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {f: os.path.join(PIN_ROOT, f"{f}_pin")
           for f in ("zipformer2", "zipformer2ctc", "conformer", "zipformer", "lstm")}
    out["int8"] = str(tmp_path_factory.mktemp("int8"))
    JBundle.random("zipformer2", JZ2Config(**INT8_CFG), vocab_size=40, seed=0, decoder_dim=32,
                   joiner_dim=32).save(out["int8"])
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, job: dict, world: int, env_init: bool = False) -> list[dict]:
    """Run ``world`` workers on ``job``; every rank must exit 0 within
    SPAWN_TIMEOUT.  Returns each rank's results."""
    job = dict(job, out=str(tmp / "out"), world=world,
               init="env" if env_init else f"file://{tmp / 'rdzv'}")
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    port = _free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, OMP_NUM_THREADS="1")
            if env_init:
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                           RANK=str(rank))
            logs.append(open(tmp / f"rank{rank}.log", "w+"))
            procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp / "job.json"),
                                           str(rank)], cwd=REPO, env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{tails[rank]}"
    results = []
    for rank in range(world):
        with open(f"{tmp / 'out'}.rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return type(a) is type(b) and _same_tree(vars(a), vars(b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def two_process(dirs, tmp_path_factory):
    """initialize() from torchrun's environment; meshes 2x1 and 1x2."""
    job = {"dirs": dirs, "meshes": {"dp": [2, 1], "tp": [1, 2]}, "tasks": {
        "dp": {"global_dp": {"kind": "global_batch"},
               "snapshot": dict(kind="snapshot", dir="zipformer2", lanes=4)},
        "tp": {"global_tp": {"kind": "global_batch"}, "linears": {"kind": "tp_linears"},
               "offline_greedy_tp": MESH_TASKS["offline_greedy"]},
    }}
    return _spawn(tmp_path_factory.mktemp("two"), job, 2, env_init=True)


@pytest.fixture(scope="module")
def snapshot_file(two_process, tmp_path_factory):
    path = tmp_path_factory.mktemp("snap") / "snapshot.pkl"
    with open(path, "wb") as f:
        pickle.dump(two_process[0]["snapshot"], f)
    return str(path)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, dirs, snapshot_file, tmp_path_factory):
    name = request.param
    tasks = {k: dict(v, snapshot=snapshot_file) if k == "restore" else v
             for k, v in MESH_TASKS.items()}
    job = {"dirs": dirs, "meshes": {"m": list(MESHES[name])}, "tasks": {"m": tasks}}
    return name, _spawn(tmp_path_factory.mktemp(name), job, 4)


_REFERENCES = {}


def _reference(task_name: str, dirs) -> object:
    """The single-device result of a task: the JAX package's (zipformer v1,
    and the encoder output: the port's single process)."""
    if task_name in _REFERENCES:
        return _REFERENCES[task_name]
    task = MESH_TASKS[task_name]
    kw = dict(compute_dtype=None, **task.get("kw", {}))
    path = dirs[task["dir"]]
    if task["kind"] == "encoder" or task["dir"] == "zipformer":
        rec = OfflineRecognizer(ModelBundle.from_dir(path, device="cpu"), device="cpu", **kw)
        if task["kind"] == "offline":
            want = offline(rec, task["streams"])
        else:
            streams = []
            for x in offline_pcms(task["streams"]):
                streams.append(rec.create_offline_stream())
                streams[-1].add_samples(x)
            want = rec.encode(*rec.pcm_batch(streams))[0].numpy()
    elif task["kind"] == "offline":
        want = offline(JOffline(JBundle.from_dir(path), **kw), task["streams"])
    elif task["kind"] == "streaming":
        want = streaming(JOnline(JBundle.from_dir(path), max_lanes=task["lanes"], **kw))
    else:  # restore: the whole stream decoded straight through
        rec = JOnline(JBundle.from_dir(path), max_lanes=task["lanes"], **kw)
        s = rec.create_online_stream()
        s.add_samples(SNAPSHOT_PCM[0])
        r = rec.decode_to_end(s)
        want = (r.tokens, r.timestamps)
    _REFERENCES[task_name] = want
    return want


@pytest.mark.parametrize("task", [t for t in MESH_TASKS if t != "encoder"])
def test_mesh_decode_matches_single_device(mesh_run, dirs, task):
    name, results = mesh_run
    want = _reference(task, dirs)
    assert want and any(toks for toks, _ in (want[-1] if task.startswith("streaming") else
                                              want if task != "restore" else [want]))
    for rank, res in enumerate(results):
        assert res[task] == want, f"mesh {name} rank {rank}"


def test_mesh_encoder_output_within_1e5(mesh_run, dirs):
    name, results = mesh_run
    want = _reference("encoder", dirs)
    n_data, n_model = MESHES[name]
    rows = -(-len(want) // n_data)
    for rank, res in enumerate(results):
        enc, lens = res["encoder"]
        r0 = (rank // n_model) * rows
        mine = want[r0:r0 + rows]
        got = enc[:len(mine)]
        valid = np.arange(got.shape[1])[None, :] < lens[:len(mine), None]
        np.testing.assert_allclose(np.where(valid[..., None], got, 0.0),
                                   np.where(valid[..., None], mine, 0.0), rtol=0, atol=1e-5,
                                   err_msg=f"mesh {name} rank {rank}")


def test_initialize_and_global_batch(two_process):
    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    for rank, res in enumerate(two_process):
        assert (res["world"], res["rank"]) == (2, rank)
        shape, local, full = res["global_dp"]
        assert shape == (8, 5)
        np.testing.assert_array_equal(local, x[rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(full, x)
        shape, local, full = res["global_tp"]  # one data group: every rank holds the batch
        np.testing.assert_array_equal(full, x)


def test_tensor_parallel_linears(two_process):
    for res in two_process:
        got = res["linears"]
        for form in ("row", "col"):
            assert got[f"{form}_f32"] <= 1e-6, got
            assert got[f"{form}_bf16"] <= 1e-2, got
            assert got[f"{form}_int8_equal"] and got[f"{form}_full_equal"], got


def test_offline_tensor_parallel_two_processes(two_process, dirs):
    want = _reference("offline_greedy", dirs)
    for res in two_process:
        assert res["offline_greedy_tp"] == want


def test_snapshot_is_whole_on_every_rank(two_process):
    a, b = (res["snapshot"] for res in two_process)
    assert _same_tree(a, b)
    assert a["frames"] > 0 and len(a["buffer"]) > 0


# -- in one process ----------------------------------------------------------


def _j_specs(tree, n_model):
    mesh = jsh.make_mesh(8 // n_model, n_model)
    leaves = jax.tree_util.tree_leaves_with_path(jsh.param_shardings(tree, mesh))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v.spec)
            for path, v in leaves}


def _t_specs(tree, n_model):
    with fake_world(n_model) as mesh:
        specs = sh.param_shardings(tree, mesh())
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        elif node is not None:
            out[path] = node

    walk(specs, "")
    return out


@pytest.mark.parametrize("family", list(SPEC_CFGS))
def test_param_shardings_equal_jax(family):
    cfg = JR.get_encoder(family).Config(**SPEC_CFGS[family])
    tree = jax.device_get(JBundle.random(family, cfg, vocab_size=64, seed=0, decoder_dim=32,
                                         joiner_dim=32).params)
    for n_model in (1, 2, 4):
        want, got = _j_specs(tree, n_model), _t_specs(tree, n_model)
        assert got == want, n_model
        if n_model > 1:
            assert any("model" in s for s in got.values())
        for k, v in got.items():  # the leaf rule alone, too
            if not any(p.startswith("conv") or p in ("dw", "decoder", "joiner")
                       for p in k.split(".")):
                assert sh.param_spec(np.shape(j_flatten(tree)[k]), n_model) == want[k]


def test_param_shardings_equal_jax_full_width():
    """Zipformer2Config()'s leaf shapes (abstract: nothing is allocated)."""
    from k2transducerasr_tpu.models import zipformer2 as JZ

    shapes = jax.eval_shape(lambda: JZ.init_params(jax.random.PRNGKey(0), JZ2Config()))
    tree = {"encoder": shapes}
    for n_model in (1, 2, 4):
        got, want = _t_specs(tree, n_model), _j_specs(tree, n_model)
        assert got == want and (n_model == 1 or any("model" in s for s in got.values()))


@pytest.mark.parametrize("shape,n_model,spec", [
    ((8,), 2, ()),
    ((8, 4), 1, ()),
    ((8, 4), 2, ("model", None)),
    ((4, 8), 2, (None, "model")),
    ((8, 8), 2, ("model", None)),  # ties: the first axis
    ((10, 8), 4, (None, "model")),  # 10 is not divisible: the next axis
    ((3, 2), 2, ()),  # 2 < 2 * n_model
    ((7, 3, 12), 4, (None, None, "model")),
])
def test_param_spec_rule(shape, n_model, spec):
    assert sh.param_spec(shape, n_model) == spec == tuple(jsh.param_spec(shape, n_model))


def test_shard_params_keeps_its_chunk():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    tree = {"encoder": {"lin": L.quantize_linear_int8({"w": w, "b": w[0]}), "x": {"w": w}},
            "decoder": {"w": w}, "conv1": {"w": w}}
    with fake_world(2) as mesh:
        got = sh.shard_params(tree, mesh())
    q8 = got["encoder"]["lin"]["w_q8"]
    assert isinstance(q8, sh.ModelShard) and q8.axis == 0 and q8.shape == (64, 32)
    assert torch.equal(q8.local, tree["encoder"]["lin"]["w_q8"][:32]) and q8.local.stride(0) == 1
    assert torch.equal(got["encoder"]["x"]["w"].local, w[:32])
    assert got["encoder"]["lin"]["w_scale"] is tree["encoder"]["lin"]["w_scale"]  # 1-D: whole
    assert got["decoder"]["w"] is w and got["conv1"]["w"] is w  # replicated subtrees
    with pytest.raises(AttributeError, match="apply_linear"):
        q8.float()


def test_mesh_checks():
    with pytest.raises(ValueError, match="initialized process group"):
        sh.make_mesh(1, 1, "cpu")
    with fake_world(4) as mesh:
        with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 4"):
            sh.make_mesh(2, 1, "cpu")
        with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 4"):
            sh.make_mesh(4, 2, "cpu")
        m = sh.make_mesh(2, 2, "cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (2, 2)
        assert sh.mesh_coords(m) == (2, 2, 0, 0)
        assert tuple(sh.auto_mesh(model_parallel=2, device_type="cpu").shape) == (2, 2)
        assert tuple(sh.auto_mesh(model_parallel=3, device_type="cpu").shape) == (4, 1)
        assert tuple(sh.auto_mesh(model_parallel=8, device_type="cpu").shape) == (1, 4)
        assert [type(p).__name__ for p in sh.batch_sharding(m)] == ["Shard", "Replicate"]
        assert sh.batch_sharding(m)[0].dim == 0
        assert [type(p).__name__ for p in sh.replicated(m)] == ["Replicate", "Replicate"]
        if not torch.cuda.is_available():  # no fallback to the CPU
            with pytest.raises(RuntimeError, match="cuda"):
                sh.make_mesh(2, 2)
        from torch.distributed.device_mesh import DeviceMesh

        bad = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("a", "b"))
        with pytest.raises(ValueError, match="dimensions"):
            sh.mesh_coords(bad)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sh.mesh_coords(object())


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize() is False
    assert D.initialize("127.0.0.1:1", num_processes=1, process_id=0) is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()
