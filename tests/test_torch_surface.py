"""Surface parity: every module of the JAX package ``k2transducerasr_tpu``
(and its demos, ``examples/*.py``) has a counterpart module in the port, and
every public name it defines (a top-level ``def``, ``class`` or assignment
not starting with ``_``) has a counterpart there.  Where the port's path or
name differs, the maps below say so, each with its reason."""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "k2transducerasr_tpu")

# JAX module -> the port's module, where the path differs
MODULES = {
    # the Pallas TPU kernels -> the CUDA kernels for Hopper
    "k2transducerasr_tpu.ops.attention_pallas": "k2transducerasr_tpu_torch.ops.attention_cuda",
    # the repository's demos -> the port's, runnable with python -m
    "examples.offline_demo": "k2transducerasr_tpu_torch.examples.offline_demo",
    "examples.online_demo": "k2transducerasr_tpu_torch.examples.online_demo",
}
# (JAX module, name) -> the port's name in the counterpart module (or a
# dotted path to another module's), where it differs
NAMES = {
    # a function on traced jnp arrays -> the same on tensors
    ("k2transducerasr_tpu.frontend.fbank", "num_frames_jnp"): "num_frames_tensor",
    # shared by zipformer v1 and the LSTM: one copy, in ops/layers
    ("k2transducerasr_tpu.models.zipformer", "double_swish"):
        "k2transducerasr_tpu_torch.ops.layers.double_swish",
    # banded-matmul forms of the embed convs (a TPU workaround): the port
    # computes the 3x3 conv they stand for
    ("k2transducerasr_tpu.ops.layers", "apply_conv2d_c1_banded"): "apply_conv2d",
    ("k2transducerasr_tpu.ops.layers", "apply_conv2d_banded_s2"): "apply_conv2d",
}
# (JAX module, name) the port has no counterpart for, and why
NO_COUNTERPART = {
    # an environment switch between the Pallas kernel and XLA; the port has no
    # switch: a CUDA tensor launches the kernel, a CPU tensor runs the plain
    # version (ROADMAP, "one kernel, one plain version, no switch")
    ("k2transducerasr_tpu.ops.attention_pallas", "flash_attn_mode"),
}


def _jax_modules() -> dict[str, str]:
    """dotted name -> file of every module of the JAX package and the demos."""
    out = {}
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                out[rel.removesuffix(".__init__")] = os.path.join(root, f)
    for f in os.listdir(os.path.join(REPO, "examples")):
        if f.endswith(".py"):
            out[f"examples.{f[:-3]}"] = os.path.join(REPO, "examples", f)
    return out


def _public_names(path: str) -> set[str]:
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port_module(name: str) -> str:
    return MODULES.get(name, name.replace("k2transducerasr_tpu", "k2transducerasr_tpu_torch", 1))


JAX_MODULES = _jax_modules()


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_public_name_has_a_counterpart(module):
    port = _port_module(module)
    if module.endswith("__main__"):  # runs on import: its file must exist
        assert os.path.exists(os.path.join(REPO, *port.split(".")) + ".py"), port
        return
    mod = importlib.import_module(port)
    missing = []
    for name in sorted(_public_names(JAX_MODULES[module])):
        if (module, name) in NO_COUNTERPART:
            continue
        target = NAMES.get((module, name), name)
        if "." in target:
            where, attr = target.rsplit(".", 1)
            found = hasattr(importlib.import_module(where), attr)
        else:
            found = hasattr(mod, target)
        if not found:
            missing.append(f"{name} -> {port}.{target}")
    assert not missing, missing


def test_the_maps_name_only_what_exists():
    """No stale entry: each mapped JAX name exists, and a name without a
    counterpart really has none."""
    for module, name in list(NAMES) + list(NO_COUNTERPART):
        assert name in _public_names(JAX_MODULES[module]), (module, name)
    for module, name in NO_COUNTERPART:
        assert not hasattr(importlib.import_module(_port_module(module)), name)
    assert set(MODULES) <= set(JAX_MODULES)


@pytest.mark.parametrize("kind", ["offline", "online"])
def test_recognizer_parameters_are_the_jax_ones_then_device(kind):
    """The same names in the same order, so that a positional call means the
    same in both packages; the port adds ``device``, last."""
    cls = {"offline": "OfflineRecognizer", "online": "OnlineRecognizer"}[kind]
    jax_params = list(inspect.signature(getattr(importlib.import_module(
        f"k2transducerasr_tpu.runtime.{kind}"), cls)).parameters)
    port_params = list(inspect.signature(getattr(importlib.import_module(
        f"k2transducerasr_tpu_torch.runtime.{kind}"), cls)).parameters)
    assert port_params == jax_params + ["device"]
