"""Device-mesh sharding for multi-device inference — PyTorch port of
``k2transducerasr_tpu/parallel/sharding.py``.

A ``DeviceMesh`` over the ranks of the default process group, of shape
``(n_data, n_model)`` with dimensions ``("data", "model")``: ``data`` splits
the utterance batch (or the lane pool), ``model`` splits weights (tensor
parallelism).  The rule that picks a weight's sharded axis, and the leaves
that stay whole, are the JAX package's (``param_spec``,
``param_shardings``), so every rank holds the same bytes a JAX chip holds.

PyTorch has no pass that inserts collectives around annotated arrays, as
GSPMD does for the JAX package, so the port writes them out.
``shard_params`` leaves each rank its ``torch.chunk`` of every sharded leaf
as a ``ModelShard``.  ``ops/layers.apply_linear`` runs a linear on one: a
weight split on its output axis multiplies locally and gathers the outputs;
a weight split on its input axis multiplies its slice of the input, sums the
partial products over the ``model`` group and then adds the bias.  Every
other consumer takes the whole leaf (``ModelShard.full``, a gather), as the
``ModelShard`` refuses to act as a tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from k2transducerasr_tpu_torch.runtime.device import resolve_device

MESH_DIMS = ("data", "model")


def make_mesh(n_data: int, n_model: int, device_type: str | None = None) -> DeviceMesh:
    """A ``(n_data, n_model)`` mesh over every rank of the initialized
    default process group, rank ``i * n_model + j`` at ``(i, j)``: the ranks
    of one data group are consecutive.  ``device_type`` is the device the
    ranks compute on (default ``"cuda"``; ``"cpu"`` asks for the CPU)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data * n_model != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {world}")
    if not dist.is_initialized():
        raise ValueError("a mesh needs an initialized process group "
                         "(parallel.distributed.initialize)")
    dev = resolve_device(device_type or "cuda")
    return DeviceMesh(dev.type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=MESH_DIMS)


def auto_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """``model_parallel`` halved until it divides the device count."""
    n = n_devices if n_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    model = model_parallel
    while n % model:
        model //= 2
    return make_mesh(n // model, model, device_type)


def mesh_coords(mesh: DeviceMesh | None) -> tuple[int, int, int, int]:
    """(n_data, n_model, this rank's data index, its model index); a single
    device without a mesh is ``(1, 1, 0, 0)``."""
    if mesh is None:
        return 1, 1, 0, 0
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.sharding.make_mesh), "
                        f"got {type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"mesh dimensions must be {MESH_DIMS}, got {mesh.mesh_dim_names}")
    return (mesh.size(0), mesh.size(1), mesh.get_local_rank("data"),
            mesh.get_local_rank("model"))


def param_spec(path_leaf_shape, n_model: int) -> tuple:
    """Largest-divisible-axis TP rule for one parameter: the largest axis
    that is at least ``2 * n_model`` long and divisible by ``n_model`` (the
    first of equals) is ``"model"``; a leaf of fewer than 2 dims, or with no
    such axis, is whole (``()``).  Equal to the JAX ``PartitionSpec``."""
    shape = tuple(path_leaf_shape)
    if len(shape) < 2 or n_model <= 1:
        return ()
    order = sorted(range(len(shape)), key=lambda a: -shape[a])
    for axis in order:
        if shape[axis] >= 2 * n_model and shape[axis] % n_model == 0:
            spec = [None] * len(shape)
            spec[axis] = "model"
            return tuple(spec)
    return ()


def _is_conv_path(path) -> bool:
    """Conv kernels (the embed convs, the conv modules' depthwise kernels,
    the decoder's grouped conv) stay whole: a key starting with ``conv`` or
    equal to ``dw`` anywhere on the path."""
    return any(isinstance(k, str) and (k.startswith("conv") or k == "dw") for k in path)


def _is_replicated_subtree(path) -> bool:
    """The transducer decoder and joiner stay whole.  (In the JAX package
    this works around GSPMD's grouped-conv fault; the port keeps the rule so
    that each rank holds what a JAX chip holds, and the decode loop runs
    without collectives.)"""
    return any(k in ("decoder", "joiner") for k in path if isinstance(k, str))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``None`` stays."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def _leaf_spec(path, shape, n_model: int) -> tuple:
    if _is_replicated_subtree(path) or _is_conv_path(path):
        return ()
    return param_spec(shape, n_model)


def param_shardings(params, mesh: DeviceMesh):
    """The tree of specs (tuples of ``None``/``"model"``, ``()`` for a whole
    leaf) of a parameter tree under the TP rule."""
    n_model = mesh_coords(mesh)[1]
    return _map_with_path(lambda path, leaf: _leaf_spec(path, np.shape(leaf), n_model), params)


def shard_params(params, mesh: DeviceMesh):
    """The parameter tree as this rank holds it: its ``torch.chunk`` of every
    sharded leaf, as a ``ModelShard``, and every other leaf as it was.  An
    int8 ``w_q8`` shard keeps the column-major layout ``int8_matmul`` takes."""
    group = mesh.get_group("model")
    n_model, rank = mesh.size(1), mesh.get_local_rank("model")

    def one(path, leaf):
        leaf = torch.as_tensor(leaf)
        spec = _leaf_spec(path, leaf.shape, n_model)
        if "model" not in spec:
            return leaf
        axis = spec.index("model")
        local = torch.chunk(leaf, n_model, dim=axis)[rank]
        local = local.t().contiguous().t() if path[-1] == "w_q8" else local.contiguous()
        return ModelShard(local, axis, tuple(leaf.shape), group)

    return _map_with_path(one, params)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Leading-axis data parallelism for activations and inputs: split over
    ``data``, whole over ``model`` (the DTensor placements)."""
    mesh_coords(mesh)
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    mesh_coords(mesh)
    return (Replicate(), Replicate())


# -- collectives ---------------------------------------------------------------


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in rank
    order (each rank's ``t`` of one shape), by ``all_gather_into_tensor``
    (gloo takes CUDA tensors for it too)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    rows = t.movedim(dim, 0).contiguous()
    out = rows.new_empty((n * rows.shape[0], *rows.shape[1:]))
    dist.all_gather_into_tensor(out, rows, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (in place)."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``t`` over ``group`` (in place)."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


class ModelShard:
    """One rank's ``torch.chunk`` of a leaf split along ``axis`` over the
    ``model`` group of a mesh; ``shape`` is the whole leaf's.  It is no
    tensor: ``ops/layers.apply_linear`` runs a linear on it, any other use
    takes ``full()``, and a use as a tensor raises ``AttributeError``."""

    __slots__ = ("local", "axis", "shape", "group", "rank")

    def __init__(self, local: torch.Tensor, axis: int, shape: tuple, group):
        self.local = local
        self.axis = axis
        self.shape = torch.Size(shape)
        self.group = group
        self.rank = dist.get_rank(group)

    def full(self) -> torch.Tensor:
        """The whole leaf, gathered over the ``model`` group."""
        return all_gather_dim(self.local, self.axis, self.group)

    def __getattr__(self, name):
        raise AttributeError(f"a model-sharded leaf has no tensor attribute {name!r}: "
                             "use it through apply_linear or take ModelShard.full()")

    def __repr__(self) -> str:
        return (f"ModelShard(shape={tuple(self.shape)}, axis={self.axis}, "
                f"local={tuple(self.local.shape)}, dtype={self.local.dtype})")


def whole(leaf):
    """A parameter leaf as one tensor: a ``ModelShard`` gathered, anything
    else as it is."""
    return leaf.full() if isinstance(leaf, ModelShard) else leaf
