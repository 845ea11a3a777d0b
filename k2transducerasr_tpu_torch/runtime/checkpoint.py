"""Param persistence (.npz with dotted-path keys) + model config JSON, read
and written as the JAX package does; the one bridge from a numpy parameter
tree to the port's modules (and back, ``ParamTree.tree``); and the bridge
for a stream's state between the JAX package's snapshot layout and
the port's tensors (``state_from_numpy``/``state_to_numpy``).

A model directory holds

    config.json    — model_type + per-family hyperparameters
    params.npz     — flat { "encoder.stacks.0.layers.0.ff1.w1.w": array, ... }
    tokens.txt     — "<symbol> <id>" per line

exactly as the JAX package's ``ModelBundle.save`` writes it.

Layout choice of ``params_from_numpy``: NONE.  Every array keeps the JAX
package's layout (linear ``w`` is ``[in, out]``, conv1d ``w`` is
``[K, C_in/groups, C_out]``, conv2d ``w`` is HWIO, the ConvNeXt weight stays
the dense ``[7, 7, C, C]`` of which only the diagonal is used), and the
``state_dict`` keys are the JAX dotted paths.  Loading is therefore one tree
walk, ``state_dict`` round-trips to the very arrays of ``params.npz``, and
the ops in ``ops/layers.py`` take each weight in that layout at call time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any

import numpy as np
import torch
from torch import nn

from k2transducerasr_tpu_torch.parallel.sharding import ModelShard


def flatten_params(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = np.asarray(node)

    visit(tree, prefix)
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> Any:
    """Rebuild nested dict/list structure from dotted paths (numeric path
    components become list indices)."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, tree: Any, dtype: str = "float32") -> None:
    """Write a numpy tree as params.npz, as the JAX package writes it.
    ``dtype="int8"``: each float leaf of >= 2 dims and >= 1024 elements is
    stored as ``key::q8`` (int8) and ``key::scale`` (one symmetric float32
    scale per tensor), which ``load_params`` dequantizes.  A ``None`` node
    is written as a 0-d object member."""
    flat = flatten_params(tree)
    if dtype == "int8":
        out: dict[str, np.ndarray] = {}
        for k, v in flat.items():
            if v.dtype.kind == "f" and v.ndim >= 2 and v.size >= 1024:
                scale = np.abs(v).max() / 127.0 or 1.0
                out[k + "::q8"] = np.round(v / scale).astype(np.int8)
                out[k + "::scale"] = np.float32(scale)
            else:
                out[k] = v
        flat = out
    np.savez(path, **flat)


def save_config(path: str, model_type: str, configs: dict[str, Any]) -> None:
    """configs: {"encoder": EncoderConfig, "decoder": ..., "joiner": ...,
    "ctc": ..., "frontend": FbankConfig} (None values skipped)."""
    payload: dict[str, Any] = {"model_type": model_type}
    for name, cfg in configs.items():
        if cfg is not None:
            payload[name] = dataclasses.asdict(cfg)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def _object_members(path: str) -> dict[str, tuple]:
    """{key: shape} of the members of an .npz whose ``.npy`` header says
    dtype object, read from the headers alone (nothing is unpickled)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, _, dtype = np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, _, dtype = np.lib.format.read_array_header_2_0(f)
                else:
                    raise ValueError(f"{path}: member {name!r} has .npy format {version}")
            if dtype.hasobject:
                out[name[: -len(".npy")] if name.endswith(".npy") else name] = shape
    return out


def load_params(path: str) -> Any:
    """params.npz -> numpy tree; ``::q8``/``::scale`` pairs (int8 storage)
    are dequantized to float32.  A 0-d object member is the ``None`` the
    JAX package's ``ModelBundle.save`` writes for a ``None`` node (zipformer
    v1's ``skip_combiners``) and loads as ``None``, from its header alone;
    any other object member raises ``ValueError``."""
    objects = _object_members(path)
    with np.load(path) as data:
        flat: dict[str, Any] = {}
        for k in data.files:
            if k in objects:
                if objects[k] != ():
                    raise ValueError(f"{path}: member {k!r} is an object array of shape "
                                     f"{objects[k]}; only 0-d ones (None) are read")
                flat[k] = None
            elif k.endswith("::q8"):
                base = k[: -len("::q8")]
                flat[base] = data[k].astype(np.float32) * data[base + "::scale"]
            elif k.endswith("::scale"):
                continue
            else:
                flat[k] = data[k]
    return unflatten_params(flat)


def load_config(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def model_dir_files(model_dir: str, accuracy: str = "") -> dict[str, str]:
    """Locate config/params/tokens in a model directory; ``accuracy`` (e.g.
    "int8") selects ``params.int8.npz`` when present."""
    params = os.path.join(model_dir, "params.npz")
    if accuracy:
        preferred = os.path.join(model_dir, f"params.{accuracy}.npz")
        if os.path.exists(preferred):
            params = preferred
    files = {
        "config": os.path.join(model_dir, "config.json"),
        "params": params,
        "tokens": os.path.join(model_dir, "tokens.txt"),
    }
    missing = [k for k, v in files.items() if not os.path.exists(v)]
    if missing:
        raise FileNotFoundError(f"model dir {model_dir} missing: {missing}")
    return files


class ParamTree(nn.Module):
    """A parameter tree as an ``nn.Module``: dict nodes become child
    modules, lists of dicts become ``nn.ModuleList``s (a ``None`` entry stays
    ``None``: an empty slot, absent from the ``state_dict``), arrays become
    frozen ``nn.Parameter``s, and a ``ModelShard`` (one rank's slice of a
    leaf, ``parallel/sharding.shard_params``) stays as it is.
    ``node["key"]`` and ``"key" in node`` work as on the JAX package's
    dicts, so the model code reads like the reference.
    Leaves may be numpy arrays (copied) or tensors (kept, moved to
    ``device`` if need be)."""

    def __init__(self, tree: dict, device: torch.device | str = "cpu"):
        super().__init__()
        self._keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value, device))
            elif isinstance(value, (list, tuple)):
                if not all(v is None or isinstance(v, dict) for v in value):
                    raise TypeError(f"list node {key!r} must hold dicts or None")
                self.add_module(key, nn.ModuleList(None if v is None else ParamTree(v, device)
                                                   for v in value))
            elif isinstance(value, ModelShard):
                setattr(self, key, value)
            else:
                t = (value.detach() if isinstance(value, torch.Tensor)
                     else torch.from_numpy(np.array(value, copy=True))).to(device)
                self.register_parameter(key, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> dict:
        """The tree this node holds, as dicts and lists of its tensors (a
        ``None`` slot stays ``None``), in the order it was built from."""
        def node(v):
            if isinstance(v, nn.ModuleList):
                return [None if m is None else m.tree() for m in v]
            if isinstance(v, ModelShard):
                return v
            return v.tree() if isinstance(v, ParamTree) else v.detach()

        return {k: node(getattr(self, k)) for k in self._keys}

    def __contains__(self, key: str) -> bool:
        return key in self._keys


def params_from_numpy(tree: dict, device: torch.device | str = "cpu") -> ParamTree:
    """Carry the JAX package's parameters (a tree of numpy arrays, as
    ``jax.device_get(bundle.params)`` or ``load_params`` gives it) into the
    port.  ``state_dict`` keys are the JAX dotted paths and the arrays keep
    their layout (see the module docstring)."""
    return ParamTree(tree, device)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure: dicts, lists and
    dataclasses (rebuilt as their own type) are nodes, all else leaves."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    if dataclasses.is_dataclass(t):
        return type(t)(**{f.name: tree_map(fn, *(getattr(x, f.name) for x in trees))
                          for f in dataclasses.fields(t)})
    return fn(*trees)


def state_from_numpy(tree, device: torch.device | str = "cpu"):
    """A stream's state in the JAX package's layout -> the port's tensors.

    Covers the encoder state trees (dicts and lists of batch-leading
    arrays; zipformer2's ``embed_stage`` is ``[B, 3, F', C]`` in both) and
    the decode states: a dataclass with the field names of the port's
    ``GreedyState``, ``BeamState`` or ``CtcState`` (as
    ``OnlineRecognizer.snapshot_stream`` of either package gives it)
    becomes that class; any other dataclass raises ``TypeError``.  int32
    counters become int64; bfloat16 arrays stay bfloat16."""
    if dataclasses.is_dataclass(tree):
        from k2transducerasr_tpu_torch.decode.ctc_greedy import CtcState
        from k2transducerasr_tpu_torch.decode.rnnt_beam import BeamState
        from k2transducerasr_tpu_torch.decode.rnnt_greedy import GreedyState

        names = {f.name for f in dataclasses.fields(tree)}
        for cls in (GreedyState, BeamState, CtcState):
            if names == {f.name for f in dataclasses.fields(cls)}:
                return cls(**{n: state_from_numpy(getattr(tree, n), device) for n in names})
        raise TypeError(f"{type(tree).__name__} with fields {sorted(names)} is no decode state")
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [state_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    t = torch.from_numpy(np.array(a, copy=True))
    return (t.long() if t.dtype == torch.int32 else t).to(device)


def tree_to_numpy(tree):
    """A tree of tensors (``ParamTree.tree()``) -> the same tree of numpy
    arrays on the host; ``None`` stays ``None``."""
    return tree_map(lambda t: None if t is None else t.cpu().numpy(), tree)


def state_to_numpy(tree):
    """The port's state tensors -> the JAX package's layout (numpy; int64
    counters as int32, bfloat16 as float32, which holds its values
    exactly).  Dataclasses keep their type."""
    def leaf(t):
        if t.dtype == torch.int64:
            return t.cpu().numpy().astype(np.int32)
        return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()

    return tree_map(leaf, tree)
