"""Multi-card **inference** sharding: TP/DP decode over a device mesh (port of
``sesameai_tts_tpu/parallel/infer.py``).

* parameters shard Megatron-style over the ``'tp'`` axis, by the rules of
  ``parallel/mesh.py::csm_param_specs`` extended to the port's parameter
  layouts: per-layer trunks (bf16 / f32), int8 ``{"q","scale"}`` and int4
  ``{"q4","scale"}`` leaves;
* the backbone ``CSMState`` splits its batch over ``'dp'`` (each dp rank
  holds its rows) and its kv heads over ``'tp'`` (each tp rank holds the kv
  heads its q heads read), so a ``BatchedTTSServer`` slot pool spreads its
  sessions across cards;
* the decode functions (``models/csm.py``) take the tp group (``tp=``) and
  issue the collectives themselves: one all_reduce after each attention
  output and each MLP, one per embedding lookup.

Single-card remains the default; pass ``mesh=`` to
``runtime.loader.build_generator`` to opt in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sesameai_tts_tpu_torch.convert import to_device
from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.models.transformer import KVCache
from sesameai_tts_tpu_torch.ops.quant import is_quantized, is_quantized4
from sesameai_tts_tpu_torch.parallel.mesh import (
    csm_param_specs,
    placements,
    shard_params,
    tp_heads,
    trunk_group,
)


def _scale_spec(wspec):
    """Placement of a quant 'scale' leaf: the weight's minus its in-features
    axis — scale is (out,), so a column shard keeps it (dim 0) and a row
    shard replicates it."""
    Shard, Replicate = placements()
    if isinstance(wspec, Shard) and wspec.dim == 1:
        return Shard(0)
    return Replicate()


def _leaf_specs(spec, leaf):
    """Match a weight placement to the actual leaf: quantized leaves are
    ``{"q","scale"}`` / ``{"q4","scale"}`` dicts.  int8 q keeps the weight
    layout; packed int4 leaves are REPLICATED — the nibble packing pairs
    row d with row d+D/2, which a row-shard would split across devices
    (int4 is the single-card bandwidth play; use int8 with TP)."""
    Replicate = placements()[1]
    if is_quantized(leaf):
        return {"q": spec, "scale": _scale_spec(spec)}
    if is_quantized4(leaf):
        return {"q4": Replicate(), "scale": Replicate()}
    return spec


def infer_param_specs(params: dict) -> dict:
    """Placement tree matching ``params``' actual layout (per-layer trunks,
    bf16 / int8 / int4 leaves).  Base rules come from
    ``parallel/mesh.py::csm_param_specs``."""
    base = csm_param_specs()
    out = {}
    for name, spec in base.items():
        if name not in ("backbone", "decoder"):
            out[name] = _leaf_specs(spec, params[name])
            continue
        layer_specs = spec["layers"]
        out[name] = {
            "layers": tuple({k: _leaf_specs(layer_specs[k], wl[k]) for k in layer_specs}
                            for wl in params[name]["layers"]),
            "final_norm": spec["final_norm"],
        }
    return out


def tp_group(mesh: Optional[DeviceMesh]) -> Optional[dist.ProcessGroup]:
    """The mesh's 'tp' group, or None without a mesh or with tp = 1 (then no
    collective is issued)."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return mesh.get_group("tp")


def shard_csm_params(params: dict, mesh: DeviceMesh, cfg, device=None) -> dict:
    """This rank's shards of the full tree ``params`` (``cfg`` a
    ``CSMConfig``), each leaf cut where it lies and then moved to
    ``device`` (default: where it lies): only the shard reaches the card."""
    shards = shard_params(params, mesh, cfg)
    return shards if device is None else to_device(shards, device)


class StateSharding(NamedTuple):
    """This rank's part of a batched backbone state: its batch rows (all of
    them when the batch does not split over 'dp') and its kv heads."""

    rows: range
    kv_heads: range


def state_sharding(mesh: DeviceMesh, cfg, batch_size: int, params: dict) -> StateSharding:
    """Rows over 'dp' only when ``batch_size % dp == 0`` (a B=1 request on a
    dp > 1 mesh stays replicated; slot pools pick B as a multiple of dp), kv
    heads over 'tp' as the backbone's ``qkv`` is split (all of them for a
    replicated int4 backbone)."""
    dp, d = mesh.size(0), mesh.get_local_rank("dp")
    if dp > 1 and batch_size % dp == 0:
        per = batch_size // dp
        rows = range(d * per, (d + 1) * per)
    else:
        rows = range(batch_size)
    bb = cfg.backbone
    tp = trunk_group(params["backbone"], tp_group(mesh))
    n, r = (1, 0) if tp is None else (mesh.size(1), mesh.get_local_rank("tp"))
    return StateSharding(rows, tp_heads(bb.num_heads, bb.num_kv_heads, n, r)[1])


def shard_state(state: csm_model.CSMState, mesh: DeviceMesh, cfg,
                params: dict) -> csm_model.CSMState:
    """This rank's part (``state_sharding``) of a full batched CSMState."""
    sh = state_sharding(mesh, cfg, state.pos.shape[0], params)
    rows = slice(sh.rows.start, sh.rows.stop)
    heads = slice(sh.kv_heads.start, sh.kv_heads.stop)

    def part(a):
        return a[rows, heads].contiguous()

    return csm_model.CSMState(
        cache=KVCache(k=[part(a) for a in state.cache.k], v=[part(a) for a in state.cache.v]),
        pos=state.pos[rows].contiguous())


def shard_replicated(tree, mesh: DeviceMesh, device=None):
    """Replicate a tree (Mimi / watermark params) across the mesh: every rank
    keeps the whole tree, on ``device`` when given."""
    return tree if device is None else to_device(tree, device)
