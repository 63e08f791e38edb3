"""Parameter trees between the JAX package and the port.

``from_jax_params`` takes a CSM or Mimi parameter tree of the JAX package
whose leaves are numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: the same nesting with torch tensors, and the CSM
trunks in the port's per-layer layout.  A JAX trunk may be stacked
(``{"layers": {name: (L, ...)}}``) or per-layer (``{"layers": (L ×
{name: ...})}``); int8 ``{"q", "scale"}`` and int4 ``{"q4", "scale"}``
leaves keep their keys.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples (None
    stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _per_layer(trunk: dict) -> dict:
    layers = trunk["layers"]
    if isinstance(layers, dict):  # stacked on a leading L axis
        leaf = next(iter(layers.values()))
        while isinstance(leaf, dict):  # a quantized leaf: any of its arrays
            leaf = next(iter(leaf.values()))
        L = leaf.shape[0]
        layers = tuple(tree_map(lambda a, l=l: a[l], layers) for l in range(L))
    return {"layers": tuple(layers), "final_norm": trunk["final_norm"]}


def _is_trunk(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"layers", "final_norm"}


def from_jax_params(tree, device="cpu"):
    """JAX parameter tree with numpy leaves → the port's tree on ``device``.
    Every Llama trunk in it (a ``{"layers", "final_norm"}`` dict) comes out
    per-layer; Mimi's codec transformers stay stacked, as the port keeps
    them."""
    out = tree_map(lambda a: _tensor(a).to(device), tree)
    if _is_trunk(out):
        return _per_layer(out)
    if isinstance(out, dict):
        for k, v in out.items():
            if _is_trunk(v):
                out[k] = _per_layer(v)
    return out
