"""The port's sharding layout (``sesameai_tts_tpu_torch/parallel/mesh.py`` and
``infer.py``) against the JAX package's tables, and its shards put back
together: the placements name the same axes as the JAX specs leaf by leaf
(bf16, int8 and int4 trees; int4 replicated, a quant scale as
``_scale_spec``), and the tp shards of every rank reassemble the full tree
bit-equal through ``mesh.gather_params`` (the inverse of ``local_shard``
that the checkpoints and exports of sharded training use), at tp = 2 on
``csm_test_tiny`` (whose decoder's one kv head is replicated) and at tp =
2 and 4 on a narrow config with CSM-1B's head counts; each rank's
columns hold its heads."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
from sesameai_tts_tpu.models import csm as jm
from sesameai_tts_tpu.ops.quant import quantize_csm as j_quantize
from sesameai_tts_tpu.parallel import infer as j_infer
from sesameai_tts_tpu.parallel import mesh as j_mesh
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import (
    CSMConfig,
    TransformerConfig,
    csm_test_tiny,
    register_flavor,
)
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.ops.quant import quantize_csm
from sesameai_tts_tpu_torch.parallel import infer, mesh

# CSM-1B's head counts at head dim 4, two layers each
register_flavor("narrow-1B-heads", lambda: TransformerConfig(
    num_layers=2, num_heads=32, num_kv_heads=8, embed_dim=128, max_seq_len=64,
    intermediate_dim=64, dtype=torch.float32))
register_flavor("narrow-100M-heads", lambda: TransformerConfig(
    num_layers=2, num_heads=8, num_kv_heads=2, embed_dim=32, max_seq_len=64,
    intermediate_dim=64, dtype=torch.float32))
NARROW = CSMConfig(backbone_flavor="narrow-1B-heads", decoder_flavor="narrow-100M-heads",
                   text_vocab_size=130, audio_vocab_size=67, audio_num_codebooks=8)


def _walk(tree, path=()):
    """(path, leaf) pairs of nested dicts and tuples, in a fixed order; a
    JAX PartitionSpec and a torch placement are leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _as_placement(spec: P, drop_lead: bool = False):
    """A JAX spec as the placement that names the same axis."""
    axes = tuple(spec)[1:] if drop_lead else tuple(spec)
    return Shard(axes.index("tp")) if "tp" in axes else Replicate()


def test_specs_name_the_same_axes_as_the_jax_tables():
    """csm_param_specs / trunk_param_specs against the JAX tables: the
    trunk's per-layer placements are the stacked JAX specs less their L
    axis."""
    got = dict(_walk(mesh.csm_param_specs()))
    want = dict(_walk(j_mesh.csm_param_specs()))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == _as_placement(spec, drop_lead="layers" in path), path
    assert mesh.trunk_param_specs() == mesh.csm_param_specs()["backbone"]


def _trees(form: str):
    """(JAX per-layer tree, the port's tree) of csm_test_tiny in ``form``."""
    jp = jm.init_csm_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32)
    if form != "f32":
        jp = j_quantize(jp, bits=8 if form == "int8" else 4)
    jp = jm.unstack_csm_params(jp)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("form", ["f32", "int8", "int4"])
def test_infer_param_specs_match_the_jax_ones(form):
    """infer_param_specs leaf by leaf against the JAX package's on the same
    tree: int8 q as its weight and scale as ``_scale_spec``, int4
    replicated."""
    jp, tp = _trees(form)
    want = dict(_walk(j_infer.infer_param_specs(jp)))
    got = dict(_walk(infer.infer_param_specs(tp)))
    assert set(got) == set(want) == {p for p, _ in _walk(tp)}
    for path, spec in want.items():
        assert got[path] == _as_placement(spec), path
    if form == "int4":
        assert all(got[p] == Replicate() for p in got if "layers" in p)


# -- the shards put back together ----------------------------------------------------


def _assert_bit_equal(got, want):
    gl, wl = list(_walk(got)), list(_walk(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w), path


@pytest.mark.parametrize("cfg_name,n,form", [
    ("tiny", 2, "f32"), ("tiny", 2, "int8"), ("tiny", 2, "int4"),
    ("narrow", 2, "f32"), ("narrow", 4, "f32"), ("narrow", 4, "int8"),
])
def test_shards_reassemble_the_full_tree(cfg_name, n, form):
    cfg = csm_test_tiny() if cfg_name == "tiny" else NARROW
    params = init_csm_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    if form != "f32":
        params = quantize_csm(params, bits=8 if form == "int8" else 4)
    shards = [mesh.local_shard(params, cfg, n, r) for r in range(n)]
    _assert_bit_equal(mesh.gather_params(shards, cfg), params)
    # each rank holds H/n q heads and the kv heads they read
    for name in ("backbone", "decoder"):
        tcfg = getattr(cfg, name)
        qkv = shards[0][name]["layers"][0]["qkv"]
        width = (qkv["q4"] if form == "int4" else qkv["q"] if form == "int8" else qkv).shape[1]
        H, KV, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
        kv_local = KV if form == "int4" else max(KV // n, 1)
        h_local = H if form == "int4" else H // n
        assert width == (h_local + 2 * kv_local) * hd, (name, width)
    if form == "f32":
        for r in range(n):
            _assert_rank_blocks(params, shards[r], cfg, n, r)


def _assert_rank_blocks(params, shard, cfg, n, r):
    """Rank r's blocks, sliced straight from the layout that
    ``parallel/mesh.py``'s docstring states (not through its ``_columns``)."""
    for name in ("backbone", "decoder"):
        t = getattr(cfg, name)
        H, KV, hd, F = t.num_heads, t.num_kv_heads, t.head_dim, t.intermediate_dim
        hq = H // n
        kv0, nkv = (r * KV // n, KV // n) if KV % n == 0 else (r * hq // (H // KV), 1)
        full, mine = params[name]["layers"][0], shard[name]["layers"][0]
        q = full["qkv"][:, r * hq * hd:(r + 1) * hq * hd]
        k = full["qkv"][:, (H + kv0) * hd:(H + kv0 + nkv) * hd]
        v = full["qkv"][:, (H + KV + kv0) * hd:(H + KV + kv0 + nkv) * hd]
        assert torch.equal(mine["qkv"], torch.cat([q, k, v], dim=1)), name
        f = F // n
        w1, w3 = full["w13"][:, r * f:(r + 1) * f], full["w13"][:, F + r * f:F + (r + 1) * f]
        assert torch.equal(mine["w13"], torch.cat([w1, w3], dim=1)), name
        assert torch.equal(mine["o_proj"], full["o_proj"][r * hq * hd:(r + 1) * hq * hd]), name
        assert torch.equal(mine["w2"], full["w2"][r * f:(r + 1) * f]), name
    for key in ("text_embeddings", "audio_embeddings"):
        c = -(-params[key].shape[0] // n)
        assert torch.equal(shard[key], params[key][r * c:(r + 1) * c]), key


def test_the_decoders_kv_head_is_replicated_where_tp_exceeds_it():
    """csm_test_tiny's decoder (H 2, KV 1) at tp = 2 and the narrow
    decoder (H 8, KV 2) at tp = 4: ranks that share a kv head hold the same
    k and v columns."""
    for cfg, n in ((csm_test_tiny(), 2), (NARROW, 4)):
        params = init_csm_params(cfg, torch.Generator().manual_seed(1), torch.float32)
        dec = cfg.decoder
        hl, hd = dec.num_heads // n, dec.head_dim
        kv = [mesh.local_shard(params, cfg, n, r)["decoder"]["layers"][0]["qkv"][:, hl * hd:]
              for r in range(n)]
        per = n // dec.num_kv_heads  # ranks per kv head
        for r in range(n):
            assert torch.equal(kv[r], kv[r - r % per])
        assert torch.equal(kv[0], kv[-1]) == (dec.num_kv_heads == 1)
        assert mesh.tp_heads(dec.num_heads, dec.num_kv_heads, n, n - 1)[1] == range(
            dec.num_kv_heads - 1, dec.num_kv_heads)


def test_a_bad_tp_raises():
    with pytest.raises(ValueError):
        mesh.tp_heads(32, 8, 3, 0)  # 3 does not divide 32 heads
    with pytest.raises(ValueError):
        mesh.tp_heads(2, 1, 4, 0)  # csm_test_tiny's decoder cannot split 4 ways
    with pytest.raises(ValueError):
        mesh.tp_heads(24, 6, 4, 0)  # neither of tp and KV divides the other
    params = init_csm_params(csm_test_tiny(), torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError):
        mesh.local_shard(params, csm_test_tiny(), 4, 0)
    assert mesh.tp_heads(32, 8, 4, 3) == (range(24, 32), range(6, 8))
    assert mesh.tp_heads(8, 2, 4, 2) == (range(4, 6), range(1, 2))


def test_make_mesh_needs_the_process_group_and_enough_ranks(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(1, 2, device_type="cpu")
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(ValueError):
            mesh.make_mesh(dp=1, tp=2, device_type="cpu")  # a world of one
        m = mesh.make_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("dp", "tp") and tuple(m.shape) == (1, 1)
        assert infer.tp_group(m) is None  # tp = 1 issues no collective
        assert mesh.batch_sharding(m) == (Shard(0), Replicate())
        assert mesh.replicated(m) == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()
