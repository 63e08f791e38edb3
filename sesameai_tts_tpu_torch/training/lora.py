"""LoRA finetuning: low-rank adapters over the CSM linears (port of
``sesameai_tts_tpu/training/lora.py``).

The base params stay frozen and the train step merges the adapters into
the dense weights inside the differentiated function, so the model code
needs no LoRA awareness and the optimizer state is that of the adapters
alone.  The adapters follow the port's per-layer layout: a target leaf
``(din, dout)`` of each layer gets ``{"a": (din, r), "b": (r, dout)}`` (the
JAX package stacks them ``(L, din, r)``; ``convert.py::from_jax_lora``
unstacks them).  ``a`` is a normal draw over ``sqrt(din)``, ``b`` zeros, so
the merge at init is exactly the base; ΔW = (alpha / r) · a @ b.  On a mesh
the adapters are replicated (drawn from the full tree's shapes) over a base
of tp shards, as the JAX package replicates them over its sharded base.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from sesameai_tts_tpu_torch.parallel.mesh import (
    csm_param_specs,
    placement_at,
    placements,
    shard_tensor,
    tp_rank,
    tp_size,
)

# the trunk linears; embeddings and heads stay frozen by default
DEFAULT_TARGETS = ("qkv", "o_proj", "w13", "w2")


def _iter_leaves(params, prefix: tuple = ()):
    """(key path, leaf) of nested dicts (sorted keys), lists and tuples."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _iter_leaves(params[k], prefix + (k,))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _iter_leaves(v, prefix + (i,))
    else:
        yield prefix, params


def init_lora_params(generator: torch.Generator, params: dict, rank: int,
                     targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32) -> dict:
    """→ ``{path...: {"a": A, "b": B}}`` mirroring ``params``'s nesting.

    Only leaves whose last key is in ``targets`` and which are at least 2-D
    get adapters.  ``a`` is drawn from ``generator`` (on its device, in
    ``_iter_leaves`` order) and moved to the leaf's device, so a seed gives
    the same adapters on every device.  A target that matches no leaf
    raises ``ValueError``."""
    if rank < 1:
        raise ValueError(f"rank must be ≥ 1, got {rank}")
    leaves = [(path, v) for path, v in _iter_leaves(params)
              if path[-1] in targets and v.dim() >= 2]
    if not leaves:
        raise ValueError(f"no LoRA targets matched {targets!r}")
    unmatched = [t for t in targets if t not in {path[-1] for path, _ in leaves}]
    if unmatched:
        # a typo must not silently train fewer adapters
        raise ValueError(
            f"LoRA target(s) {unmatched!r} matched no parameter leaf; available leaf names "
            f"include {sorted({p[-1] for p, v in _iter_leaves(params) if v.dim() >= 2})}")
    adapters = {}
    for path, v in leaves:
        *batch, din, dout = v.shape
        a = torch.randn((*batch, din, rank), generator=generator, device=generator.device)
        adapters[path] = {"a": (a / math.sqrt(din)).to(dtype).to(v.device),
                          "b": torch.zeros((*batch, rank, dout), dtype=dtype, device=v.device)}
    return _nest(params, adapters, ())


def _nest(params, adapters: dict, prefix: tuple):
    """The adapters (by key path) in ``params``'s nesting; subtrees without
    adapters are dropped from dicts and kept as ``{}`` in tuples."""
    if prefix in adapters:
        return adapters[prefix]
    if isinstance(params, dict):
        out = {}
        for k in sorted(params):
            sub = _nest(params[k], adapters, prefix + (k,))
            if sub:
                out[k] = sub
        return out
    if isinstance(params, (list, tuple)):
        subs = [_nest(v, adapters, prefix + (i,)) for i, v in enumerate(params)]
        return tuple(subs) if any(subs) else {}
    return {}


def merge_lora(params: dict, lora: dict, alpha: float = 16.0,
               tp: Optional[dist.ProcessGroup] = None, cfg=None) -> dict:
    """Dense params with ΔW = (alpha / r) · a @ b added on every adapted
    leaf (a new tree; the base is not written).

    With ``tp`` the base is this rank's shards of a CSM tree of config
    ``cfg`` (``parallel/mesh.py``) and the adapters are whole: a
    column-sharded leaf gets ``a @ b[:, cols]`` with the columns the rank
    holds (``qkv``'s heads, ``w13``'s w1|w3 blocks), a row-sharded one
    ``a[rows] @ b``, a replicated one all of ΔW."""
    n, r = tp_size(tp), tp_rank(tp)
    specs = csm_param_specs() if n > 1 else None

    def delta(path, ad):
        a, b = ad["a"], ad["b"]
        if specs is not None:
            spec = placement_at(specs, path)
            if isinstance(spec, placements()[0]):
                key = path[-1] if path[-1] in ("qkv", "w13") else None
                tcfg = getattr(cfg, path[0]) if key else None
                if spec.dim == 0:
                    a = shard_tensor(a, spec, n, r)
                else:
                    b = shard_tensor(b, spec, n, r, key, tcfg)
        return (alpha / ad["a"].shape[-1]) * (a @ b)

    def walk(p, l, path):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                lk = l.get(k, {}) if isinstance(l, dict) else {}
                if isinstance(lk, dict) and "a" in lk:
                    out[k] = v + delta(path + (k,), lk).to(v.dtype)
                else:
                    out[k] = walk(v, lk, path + (k,))
            return out
        if isinstance(p, (list, tuple)):
            ls = l if isinstance(l, (list, tuple)) else [{}] * len(p)
            return type(p)(walk(v, lv, path + (i,)) for i, (v, lv) in enumerate(zip(p, ls)))
        return p

    return walk(params, lora, ())


def count_params(tree) -> int:
    return sum(v.numel() for _, v in _iter_leaves(tree))
