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

For training: ``gather_params`` / ``all_gather_params`` put every rank's
shards (params, Adam moments or gradients) back into the full tree, the
inverse of ``local_shard``; ``kv_replica_group`` is the subgroup of tp
ranks that share a kv head; ``shard_batch`` gives a dp rank its rows of a
global batch (``dp_rows``: microbatch by microbatch under accumulation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sesameai_tts_tpu_torch.convert import tree_map, tree_paths
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


_FUSED = ("qkv", "w13")


def placement_at(specs, path: tuple):
    """The placement of the leaf at key ``path`` under ``specs``: a tree of
    placements whose trunk ``"layers"`` entry is one dict for every layer
    (``csm_param_specs``) or a tuple of them (``infer_param_specs``).  A
    quantized leaf (``{"q", "scale"}``) under a single placement must be
    replicated."""
    spec = specs
    for p in path:
        if not isinstance(spec, (dict, tuple, list)):
            if not isinstance(spec, placements()[1]):
                raise ValueError("a quantized leaf needs {'q', 'scale'} placements "
                                 "(parallel/infer.py::infer_param_specs)")
            break
        if isinstance(p, int) and isinstance(spec, dict):
            continue  # one placement dict serves every layer
        spec = spec[p]
    return spec


def _map_placed(fn, trees: list, cfg, specs):
    """``fn(leaves, placement, key, trunk_cfg)`` at every leaf of the
    same-shaped CSM trees ``trees`` → the tree of its results.  ``key`` is
    ``"qkv"`` or ``"w13"`` inside a fused trunk leaf (its quant parts
    included), ``trunk_cfg`` the trunk's config inside a trunk."""
    paths = iter(tree_paths(trees[0]))

    def leaf(*xs):
        path, _ = next(paths)
        key = next((p for p in path if p in _FUSED), None)
        tcfg = getattr(cfg, path[0]) if path[0] in ("backbone", "decoder") else None
        return fn(xs, placement_at(specs, path), key, tcfg)

    return tree_map(leaf, *trees)


def local_shard(params: dict, cfg, n: int, r: int, specs: Optional[dict] = None) -> dict:
    """Rank r's shards of a full per-layer CSM tree (``cfg`` a ``CSMConfig``)
    in a tp group of n, under ``specs`` (default: the tree's own,
    ``parallel/infer.py::infer_param_specs``).  A pure function of the tree:
    the layout tests call it for every rank."""
    if specs is None:
        from sesameai_tts_tpu_torch.parallel.infer import infer_param_specs

        specs = infer_param_specs(params)
    return _map_placed(lambda xs, p, key, tcfg: shard_tensor(xs[0], p, n, r, key, tcfg),
                       [params], cfg, specs)


def join_shards(parts: list, placement, key: Optional[str] = None, cfg=None) -> torch.Tensor:
    """The full tensor from every rank's part of it (rank order), the inverse
    of ``shard_tensor``: the first part of a replicated tensor; a fused
    trunk leaf's columns put back where ``_columns`` took them (a kv head
    held by several ranks is written by each, with the same values)."""
    if isinstance(placement, placements()[1]) or len(parts) == 1:
        return parts[0]
    dim, n = placement.dim, len(parts)
    if key not in _FUSED:
        return torch.cat(parts, dim)
    width = ((cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim if key == "qkv"
             else n * parts[0].shape[dim])
    shape = list(parts[0].shape)
    shape[dim] = width
    out = parts[0].new_empty(shape)
    for r, x in enumerate(parts):
        out.index_copy_(dim, _columns(key, cfg, width, n, r).to(x.device), x)
    return out


def gather_params(shards: list, cfg, specs: Optional[dict] = None) -> dict:
    """The full CSM tree from every tp rank's shards of it (a list in rank
    order; params, Adam moments or gradients), the inverse of
    ``local_shard``."""
    if specs is None:
        from sesameai_tts_tpu_torch.parallel.infer import infer_param_specs

        specs = infer_param_specs(shards[0])
    return _map_placed(lambda xs, p, key, tcfg: join_shards(list(xs), p, key, tcfg),
                       shards, cfg, specs)


def _all_gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> list:
    """Every rank's ``x`` (which may differ in length along ``dim``: the last
    rank's embedding rows), in rank order."""
    n = dist.get_world_size(group)
    # gloo passes a card's tensors through the host: gather them there
    x = (x.cpu() if dist.get_backend(group) == "gloo" else x).contiguous()
    length = torch.tensor([x.shape[dim]], device=x.device)
    lengths = [torch.zeros_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    lengths = [int(t) for t in lengths]
    if max(lengths) > x.shape[dim]:
        pad = list(x.shape)
        pad[dim] = max(lengths) - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return [t.narrow(dim, 0, m) for t, m in zip(out, lengths)]


def all_gather_params(local: dict, cfg, group: Optional[dist.ProcessGroup],
                      specs: Optional[dict] = None, dst: Optional[int] = None):
    """``gather_params`` across the ranks of ``group`` (every rank calls it
    with its own shards) → a copy of the full tree on the host, leaf by
    leaf, so that no more than one full leaf is on the device at a time.  With ``dst``
    only that rank of the group gets the tree, the others None.  Without a
    group the tree is the rank's own, on the host."""
    n = 1 if group is None else dist.get_world_size(group)
    keep = dst is None or n == 1 or dist.get_rank(group) == dst
    if specs is None:
        from sesameai_tts_tpu_torch.parallel.infer import infer_param_specs

        specs = infer_param_specs(local)

    def leaf(xs, placement, key, tcfg):
        x = xs[0]
        if n == 1 or isinstance(placement, placements()[1]):
            # a copy: the tree is a snapshot of a state a step updates in place
            return x.to("cpu", copy=True) if keep else None
        parts = _all_gather(x, placement.dim, group)
        return join_shards([t.cpu() for t in parts], placement, key, tcfg) if keep else None

    full = _map_placed(leaf, [local], cfg, specs)
    return full if keep else None


def shard_params(params: dict, mesh: DeviceMesh, cfg, specs: Optional[dict] = None) -> dict:
    """This rank's local shards of ``params`` on ``mesh``'s 'tp' axis."""
    return local_shard(params, cfg, mesh.size(1), mesh.get_local_rank("tp"), specs)


def dp_group(mesh: Optional[DeviceMesh]) -> Optional[dist.ProcessGroup]:
    """The mesh's 'dp' group, or None without a mesh or with dp = 1."""
    if mesh is None or mesh.size(0) == 1:
        return None
    return mesh.get_group("dp")


def kv_replica_group(cfg, mesh: DeviceMesh) -> Optional[dist.ProcessGroup]:
    """The ranks of this rank's tp group that hold its kv head, for a trunk
    of config ``cfg`` with fewer kv heads than tp ranks (each then on
    ``tp / KV`` consecutive ranks); None when every kv head is on one rank.
    A collective: every rank of the mesh calls it, in the same order (it
    makes the subgroups of every dp row)."""
    n, KV = mesh.size(1), cfg.num_kv_heads
    tp_heads(cfg.num_heads, KV, n, 0)  # raises for a tp the heads do not split
    if n <= KV:
        return None
    per = n // KV
    if per == n:
        return mesh.get_group("tp")
    mine, me = None, dist.get_rank()
    for row in mesh.mesh.tolist():
        for j in range(KV):
            ranks = row[j * per:(j + 1) * per]
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
    return mine


def dp_rows(batch_size: int, dp: int, d: int, accum_steps: int = 1) -> list:
    """The rows of a global batch that dp rank d of ``dp`` holds: for each of
    the ``accum_steps`` microbatches (rows ``[i·B/A, (i+1)·B/A)``, as the
    train step splits them) its d-th 1/dp slice, microbatch by microbatch,
    so the rank's i-th local microbatch is its part of global microbatch i.
    Raises unless dp divides each microbatch."""
    if batch_size % accum_steps or (batch_size // accum_steps) % dp:
        raise ValueError(f"a batch of {batch_size} in {accum_steps} microbatches does not "
                         f"split over dp={dp}")
    mb = batch_size // accum_steps
    part = mb // dp
    return [i * mb + d * part + j for i in range(accum_steps) for j in range(part)]


def shard_batch(batch, mesh: DeviceMesh, accum_steps: int = 1):
    """This rank's rows (``dp_rows``) of a global batch (a NamedTuple of
    numpy arrays or tensors with the batch first), as ``batch_sharding``
    places it."""
    rows = dp_rows(batch[0].shape[0], mesh.size(0), mesh.get_local_rank("dp"), accum_steps)
    return type(batch)(*(x[rows] for x in batch))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The dp-row rule: the batch axis split over 'dp', replicated over 'tp'
    (placements per mesh dim); ``shard_batch`` cuts it."""
    Shard, Replicate = placements()
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    """The replicate rule: every rank holds the whole tensor."""
    Replicate = placements()[1]
    return (Replicate(), Replicate())
