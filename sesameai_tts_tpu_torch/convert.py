"""Parameter trees between the JAX package and the port.

``from_jax_params`` takes a CSM, Mimi or silentcipher-network parameter
tree of the JAX package whose leaves are numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the same
nesting with torch tensors (the network's tuples of ``{"w", "b"}`` conv
blocks, ``enc_m`` and ``dec_m`` as they are), and the CSM trunks in the
port's per-layer layout.  A JAX trunk may be stacked
(``{"layers": {name: (L, ...)}}``) or per-layer (``{"layers": (L ×
{name: ...})}``); int8 ``{"q", "scale"}`` and int4 ``{"q4", "scale"}``
leaves keep their keys.  ``from_jax_lora`` does the same for a LoRA
adapter tree (``training/lora.py``), whose stacked ``(L, din, r)`` and
``(L, r, dout)`` adapters become one ``{"a", "b"}`` pair per layer.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of nested dicts, lists, tuples and
    NamedTuples (None stays None), and to the leaves at the same places of
    the trees in ``rest``: ``fn(leaf, *rest_leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: tuple = ()) -> list:
    """(key path, leaf) of every leaf of ``tree`` in ``tree_map``'s order: a
    dict contributes its keys, a list or tuple its indices."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


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


def from_jax_lora(tree, device="cpu"):
    """JAX LoRA adapter tree with numpy leaves → the port's on ``device``:
    each trunk's stacked ``{"layers": {name: {"a": (L, din, r), "b": (L, r,
    dout)}}}`` becomes ``{"layers": (L × {name: {"a": (din, r), "b": (r,
    dout)}})}``; adapters outside ``layers`` keep their shapes."""
    out = tree_map(lambda a: _tensor(a).to(device), tree)
    for trunk in out.values():
        layers = trunk.get("layers") if isinstance(trunk, dict) else None
        if isinstance(layers, dict):
            L = next(iter(layers.values()))["a"].shape[0]
            trunk["layers"] = tuple(tree_map(lambda a, l=l: a[l].clone(), layers)
                                    for l in range(L))
    return out
