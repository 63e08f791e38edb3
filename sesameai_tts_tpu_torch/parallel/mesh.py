"""Device mesh + sharding policy (port of ``sesameai_tts_tpu/parallel/mesh.py``).

A ``DeviceMesh`` over ('dp', 'tp') on an initialized ``torch.distributed``
process group, and the placement of every CSM parameter on it, written as
``Shard(dim)`` / ``Replicate()``.  Under XLA the JAX package annotates
shardings and the compiler inserts the collectives; here every rank holds
only its own shards (``local_shard``) and the model issues each collective
itself (``models/transformer.py``, ``models/csm.py``): explicit
Megatron-style tensor parallelism.

Sharding rules:
  * attention: q/k/v projections column-sharded over 'tp' (heads split),
    output row-sharded → one all_reduce;
  * MLP: w1/w3 column-sharded, w2 row-sharded → one all_reduce;
  * embeddings: vocab-sharded (a masked local lookup, then an all_reduce);
  * norms, the projection and the LM heads: replicated;
  * batch: split over 'dp'.

The fused leaves are not split contiguously.  The JAX spec column-shards
fused ``qkv`` and ``w13`` straight through, so its halves cross head and
w1|w3 boundaries and XLA reshards them; explicit TP needs every rank's
columns to be whole heads.  Rank r of a tp group of n holds:

  * ``qkv``: the q heads ``[r·H/n, (r+1)·H/n)`` and the kv heads those q
    heads read, ``[r·(H/n)/G, ...)`` with ``G = H/KV`` queries per kv head:
    ``KV/n`` of them when n divides KV, else the one kv head its q heads
    share (n > KV: that head is replicated on ``n/KV`` ranks).  Its columns
    are ``[q_r | k_r | v_r]``, each part in head order.  ``H % n != 0``, or
    neither of n and KV dividing the other, raises.
  * ``w13``: columns ``[w1[:, r·I/n : (r+1)·I/n] | w3[:, same]]``.
  * ``o_proj`` and ``w2``: the matching contiguous row blocks.
  * embeddings: rows ``[r·c, (r+1)·c)`` with ``c = ceil(V/n)`` (the last
    rank may hold fewer).
  * an int8 leaf's ``scale`` follows its weight's columns; a row-sharded
    weight's scale is replicated (it covers every row).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sesameai_tts_tpu_torch.ops.quant import is_quantized4


def placements():
    """DTensor's (Shard, Replicate), imported at first use: the models
    import this module, and ``torch.distributed.tensor`` takes ~1.5 s to
    import."""
    from torch.distributed.tensor import Replicate, Shard

    return Shard, Replicate


def make_mesh(dp: int = 1, tp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ('dp', 'tp') mesh over the first dp·tp ranks of the initialized
    process group.  Ranks ``d·tp .. d·tp + tp - 1`` form dp row d.  A rank
    on the card selects its device before this call (the loader uses
    ``cuda:<LOCAL_RANK>``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first "
                           "(parallel/distributed.py::initialize_multihost)")
    world = dist.get_world_size()
    if dp < 1 or tp < 1 or dp * tp > world:
        raise ValueError(f"make_mesh: need {dp * tp} ranks for dp={dp}, tp={tp}, have {world}")
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def trunk_param_specs() -> dict:
    """Placements of one per-layer transformer trunk: ``"layers"`` holds the
    placement of each layer's leaves (the JAX table's, less its stacked L
    axis)."""
    Shard, Replicate = placements()
    return {
        "layers": {
            "attn_norm": Replicate(),
            # fused qkv / w13 shard head-aligned and w1|w3-aligned (module
            # docstring): XLA reshards the JAX package's contiguous split, the
            # port issues each collective itself and needs whole heads per rank
            "qkv": Shard(1),
            "o_proj": Shard(0),
            "mlp_norm": Replicate(),
            "w13": Shard(1),
            "w2": Shard(0),
        },
        "final_norm": Replicate(),
    }


def csm_param_specs() -> dict:
    Shard, Replicate = placements()
    return {
        "backbone": trunk_param_specs(),
        "decoder": trunk_param_specs(),
        "text_embeddings": Shard(0),
        "audio_embeddings": Shard(0),
        "projection": Replicate(),
        # audio vocab is 2051 (odd — not tp-divisible); the heads are small,
        # so replicate them rather than pad the vocab
        "codebook0_head": Replicate(),
        "audio_head": Replicate(),
    }


def tp_size(tp: Optional[dist.ProcessGroup]) -> int:
    return 1 if tp is None else dist.get_world_size(tp)


def tp_rank(tp: Optional[dist.ProcessGroup]) -> int:
    return 0 if tp is None else dist.get_rank(tp)


def tp_heads(H: int, KV: int, n: int, r: int) -> Tuple[range, range]:
    """(q heads, kv heads) that rank r of a tp group of n holds (module
    docstring); raises when the heads do not split n ways."""
    if H % n or (KV % n and n % KV):
        raise ValueError(f"tp={n} does not split {H} query heads over {KV} kv heads: need "
                         f"H % tp == 0 and tp | KV or KV | tp")
    hl = H // n
    kl = KV // n if KV % n == 0 else 1
    k0 = (r * hl) // (H // KV)
    return range(r * hl, (r + 1) * hl), range(k0, k0 + kl)


def local_heads(cfg, tp: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(query heads, kv heads) of a trunk of config ``cfg`` on this rank."""
    q, kv = tp_heads(cfg.num_heads, cfg.num_kv_heads, tp_size(tp), tp_rank(tp))
    return len(q), len(kv)


def trunk_group(trunk_params: dict, tp: Optional[dist.ProcessGroup]):
    """The group a trunk's layers reduce over: ``tp``, or None when the trunk
    is replicated (an int4 trunk, ``parallel/infer.py``), which every rank
    then runs whole."""
    if tp is None or is_quantized4(trunk_params["layers"][0]["qkv"]):
        return None
    return tp


def _columns(key: str, cfg, width: int, n: int, r: int) -> torch.Tensor:
    """The columns of a fused trunk leaf (``qkv`` or ``w13``) that rank r
    holds, in their order on the rank."""
    if key == "qkv":
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if width != (H + 2 * KV) * hd:
            raise ValueError(f"qkv has {width} columns, want {(H + 2 * KV) * hd}")
        qh, kh = tp_heads(H, KV, n, r)

        def cols(base, heads):
            return [base + h * hd + j for h in heads for j in range(hd)]

        idx = cols(0, qh) + cols(H * hd, kh) + cols((H + KV) * hd, kh)
    else:  # w13: [w1 | w3]
        I = width // 2
        if I % n:
            raise ValueError(f"tp={n} does not divide the MLP width {I}")
        block = range(r * (I // n), (r + 1) * (I // n))
        idx = list(block) + [I + c for c in block]
    return torch.tensor(idx, dtype=torch.int64)


def _rows(length: int, n: int, r: int) -> slice:
    c = -(-length // n)
    return slice(min(r * c, length), min((r + 1) * c, length))


def shard_tensor(x: torch.Tensor, placement, n: int, r: int, key: Optional[str] = None,
                 cfg=None) -> torch.Tensor:
    """Rank r's part of ``x`` under ``placement`` in a tp group of n: the
    tensor itself for ``Replicate()``, else a contiguous copy of its block
    along the placement's dim; the columns of a fused trunk leaf (``key``
    ``"qkv"`` or ``"w13"`` with the trunk's ``cfg``) in the order the module
    docstring gives."""
    if isinstance(placement, placements()[1]) or n == 1:
        return x
    dim = placement.dim
    if key in ("qkv", "w13"):
        idx = _columns(key, cfg, x.shape[dim], n, r).to(x.device)
        return x.index_select(dim, idx)
    sl = [slice(None)] * x.dim()
    sl[dim] = _rows(x.shape[dim], n, r)
    # a copy, never a view: the full tensor must not stay alive behind its shard
    return x[tuple(sl)].clone(memory_format=torch.contiguous_format)


def _shard_tree(params, specs, n: int, r: int, key=None, cfg=None):
    if isinstance(params, dict) and not isinstance(specs, dict):
        # a quantized leaf under its weight's placement: only a replicated one
        # passes as it is; infer_param_specs gives a sharded one's scale
        if not isinstance(specs, placements()[1]):
            raise ValueError("a quantized leaf needs {'q', 'scale'} placements "
                             "(parallel/infer.py::infer_param_specs)")
        return params
    if isinstance(params, dict):
        return {k: _shard_tree(v, specs[k], n, r, k if k in ("qkv", "w13") else key, cfg)
                for k, v in params.items()}
    return shard_tensor(params, specs, n, r, key, cfg)


def local_shard(params: dict, cfg, n: int, r: int, specs: Optional[dict] = None) -> dict:
    """Rank r's shards of a full per-layer CSM tree (``cfg`` a ``CSMConfig``)
    in a tp group of n, under ``specs`` (default: the tree's own,
    ``parallel/infer.py::infer_param_specs``).  A pure function of the tree:
    the layout tests call it for every rank."""
    if specs is None:
        from sesameai_tts_tpu_torch.parallel.infer import infer_param_specs

        specs = infer_param_specs(params)
    out = {}
    for name, value in params.items():
        spec = specs[name]
        if name in ("backbone", "decoder"):
            tcfg = getattr(cfg, name)
            lspecs = spec["layers"]
            per_layer = lspecs if isinstance(lspecs, (tuple, list)) else [lspecs] * len(
                value["layers"])
            out[name] = {
                "layers": tuple(_shard_tree(wl, ls, n, r, cfg=tcfg)
                                for wl, ls in zip(value["layers"], per_layer)),
                "final_norm": shard_tensor(value["final_norm"], spec["final_norm"], n, r),
            }
        else:
            out[name] = _shard_tree(value, spec, n, r)
    return out


def shard_params(params: dict, mesh: DeviceMesh, cfg, specs: Optional[dict] = None) -> dict:
    """This rank's local shards of ``params`` on ``mesh``'s 'tp' axis."""
    return local_shard(params, cfg, mesh.size(1), mesh.get_local_rank("tp"), specs)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The dp-row rule: the batch axis split over 'dp', replicated over 'tp'
    (placements per mesh dim)."""
    Shard, Replicate = placements()
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    """The replicate rule: every rank holds the whole tensor."""
    Replicate = placements()[1]
    return (Replicate(), Replicate())
