"""Random weights from the seed, made on the device in a few large calls, in
the layout of the system under test (the tree its ``ModelBundle.from_params``
takes).

The tree's structure and each leaf's shape and scale come from the system's
own ``init_params`` run against a recording stand-in for its numpy
generator: every draw it asks for becomes a placeholder, and the
placeholders are then filled from one ``torch.Generator`` on the device,
uniform(+-1/sqrt(fan_in)) and normal draws each in one call.  The leaves its
init sets to constants (for zipformer2: bypass scales, chunk-edge scales,
downsample weights, norm biases and scales) are drawn too, from the ranges
the model type's file gives (``CONSTANT_RANGES`` of
``asrbench/models/<model_type>.py``), so that the comparison with the
reference exercises them."""

from __future__ import annotations

import numpy as np
import torch

class _Draw:
    """A draw the init asked for: its shape, and a scale for a uniform
    draw (None for a standard normal one)."""

    def __init__(self, shape, scale):
        self.shape = tuple(int(s) for s in np.atleast_1d(shape)) if shape != () else ()
        self.scale = scale

    def astype(self, _dtype):
        return self


class _Recorder:
    """Stands in for ``np.random.Generator`` in an init."""

    def uniform(self, low, high, size=None):
        if low != -high:
            raise ValueError("only symmetric uniform draws are recorded")
        return _Draw(size, float(high))

    def standard_normal(self, size=None):
        return _Draw(size, None)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def materialize(tree: dict, seed: int, device, constant_ranges: dict) -> dict:
    """Fill a recorded tree from ``seed`` on ``device``: float32 tensors;
    ``constant_ranges``: leaf name -> (low, high) for the constant leaves."""
    leaves = list(_leaves(tree))
    uni = [(p, v) for p, v in leaves if isinstance(v, _Draw) and v.scale is not None]
    nor = [(p, v) for p, v in leaves if isinstance(v, _Draw) and v.scale is None]
    const = [(p, v) for p, v in leaves if not isinstance(v, _Draw)]
    g = torch.Generator(device=device).manual_seed(int(seed))

    def sizes(items):
        return [int(np.prod(v.shape)) for _, v in items]

    flat_u = torch.rand(sum(sizes(uni)), generator=g, device=device) * 2.0 - 1.0
    flat_n = torch.randn(sum(sizes(nor)), generator=g, device=device)
    flat_c = torch.rand(sum(int(np.size(v)) for _, v in const), generator=g, device=device)
    for (p, v), part in zip(uni, torch.split(flat_u, sizes(uni))):
        _set(tree, p, (part * v.scale).reshape(v.shape))
    for (p, v), part in zip(nor, torch.split(flat_n, sizes(nor))):
        _set(tree, p, part.reshape(v.shape))
    at = 0
    for p, v in const:
        n = int(np.size(v))
        key = next((k for k in reversed(p) if isinstance(k, str)), "")
        if key not in constant_ranges:
            raise KeyError(f"no range for the constant leaf {'/'.join(map(str, p))}")
        lo, hi = constant_ranges[key]
        _set(tree, p, (lo + (hi - lo) * flat_c[at:at + n]).reshape(np.shape(v)))
        at += n
    return tree


def make_tree(init_fns: dict, seed: int, device, constant_ranges: dict) -> dict:
    """``init_fns``: part name -> ``init(rng)`` (the system's initializers,
    bound to their configs) -> {part: tree of float32 tensors}."""
    rec = _Recorder()
    return materialize({k: fn(rec) for k, fn in init_fns.items()}, seed, device,
                       constant_ranges)
