"""The tensor-parallel backward of the port (``sesameai_tts_tpu_torch/parallel/
autograd.py``'s f/g pair in ``models/transformer.py``) and the layout pieces
that sharded training adds to ``parallel/mesh.py``, on the CPU in gloo
worlds of 2 and 4 ranks (the harness of ``tests/test_torch_parallel_infer.py``:
spawned ranks that import only the port):

* a tp trunk's forward and backward, with and without remat, on
  ``csm_test_tiny`` (whose decoder's one kv head is on both ranks at tp 2)
  and on a narrow config with CSM-1B's head counts at tp 2 and 4 (its
  decoder's two kv heads each on two ranks at tp 4): the output, the input
  gradient on every rank and the gathered weight and norm gradients
  (``train_step._GradSync`` sums the kv columns over ``kv_replica_group``)
  within 1e-5 of their peak of unsharded autograd's, and the logical norm
  within 1e-5 relative of the unsharded gradient's;
* ``kv_replica_group``'s groups, ``all_gather_params`` against the full
  tree, ``merge_lora`` on a sharded base against the shards of the merged
  tree, ``make_sharded_train_state`` against the shards of the same init;
* ``dp_rows`` / ``shard_batch``: the microbatch-major layout and the
  batches that do not split.

The unsharded references run in the test process, on the port."""

import numpy as np
import pytest
import torch
from test_torch_parallel_infer import _spawn

from sesameai_tts_tpu_torch.convert import tree_leaves, tree_map
from sesameai_tts_tpu_torch.core.config import CSMConfig, TransformerConfig, csm_test_tiny
from sesameai_tts_tpu_torch.core.config import register_flavor
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.models.transformer import precompute_rope, transformer_forward
from sesameai_tts_tpu_torch.parallel import mesh as pm

TOL = 1e-5  # of each tensor's peak (f32: the tp partial sums add in another order)
S = 12

# CSM-1B's head counts at head dim 4 (as tests/test_torch_parallel.py)
register_flavor("narrow-1B-heads", lambda: TransformerConfig(
    num_layers=2, num_heads=32, num_kv_heads=8, embed_dim=128, max_seq_len=64,
    intermediate_dim=64, dtype=torch.float32))
register_flavor("narrow-100M-heads", lambda: TransformerConfig(
    num_layers=2, num_heads=8, num_kv_heads=2, embed_dim=32, max_seq_len=64,
    intermediate_dim=64, dtype=torch.float32))
NARROW = CSMConfig(backbone_flavor="narrow-1B-heads", decoder_flavor="narrow-100M-heads",
                   text_vocab_size=130, audio_vocab_size=67, audio_num_codebooks=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    return csm_test_tiny() if name == "tiny" else NARROW


def _params(name):
    return init_csm_params(_cfg(name), torch.Generator().manual_seed(7), torch.float32)


def _inputs(tcfg, seed):
    """(x, dy, valid_len): two rows, the second right-padded."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, S, tcfg.embed_dim)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, S, tcfg.embed_dim)).astype(np.float32))
    return x, dy, torch.tensor([S, S - 3])


def _trunk_grads(trunk_params, tcfg, x, dy, valid_len, remat, tp=None):
    """(h, dx, grads of the trunk's leaves) of sum(trunk(x) * dy)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), trunk_params)
    x = x.clone().requires_grad_(True)
    with torch.enable_grad():
        h, _ = transformer_forward(leaves, tcfg, x, torch.zeros(2, dtype=torch.int64), None,
                                   precompute_rope(tcfg), valid_len=valid_len, remat=remat,
                                   tp=tp)
        grads = torch.autograd.grad((h * dy).sum(), [x] + tree_leaves(leaves))
    it = iter(grads[1:])
    return h.detach(), grads[0], tree_map(lambda _: next(it), leaves)


def _cases(n):
    return [(c, t, remat) for c in (("tiny", "narrow") if n == 2 else ("narrow",))
            for t in ("backbone", "decoder") for remat in (False, True)]


# -- ranks ---------------------------------------------------------------------


def _trunk_rank(rank, n):
    """Every trunk case of a world of n tp ranks, then the layout checks."""
    from sesameai_tts_tpu_torch.parallel.infer import tp_group
    from sesameai_tts_tpu_torch.training.lora import init_lora_params, merge_lora
    from sesameai_tts_tpu_torch.training.train_step import (
        _GradSync,
        make_optimizer,
        make_sharded_train_state,
    )

    mesh = pm.make_mesh(1, n, device_type="cpu")
    tp = tp_group(mesh)
    out = {"cases": {}}
    syncs = {c: _GradSync(_cfg(c), mesh) for c in ("tiny", "narrow") if n == 2 or c == "narrow"}
    for cname, trunk, remat in _cases(n):
        cfg = _cfg(cname)
        tcfg = getattr(cfg, trunk)
        shards = pm.shard_params(_params(cname), mesh, cfg)
        h, dx, grads = _trunk_grads(shards[trunk], tcfg, *_inputs(tcfg, 1), remat, tp)
        whole, norm = syncs[cname]({trunk: grads})
        out["cases"][(cname, trunk, remat)] = {
            "h": h, "dx": dx, "norm": float(norm),
            "grads": pm.all_gather_params(whole, cfg, tp, pm.csm_param_specs())[trunk]}
    out["kv_groups"] = {c: {t: (None if g is None else
                                torch.distributed.get_process_group_ranks(g))
                            for t, g in s.kv.items()} for c, s in syncs.items()}
    if n == 2:
        cfg = csm_test_tiny()
        params = _params("tiny")
        shards = pm.shard_params(params, mesh, cfg)
        out["gathered"] = pm.all_gather_params(shards, cfg, tp)
        out["gathered_dst"] = pm.all_gather_params(shards, cfg, tp, dst=1)
        lora = init_lora_params(torch.Generator().manual_seed(3), params, 2,
                                targets=("qkv", "o_proj", "w13", "w2", "text_embeddings"))
        lora = tree_map(lambda t: t + 0.1, lora)  # b nonzero: ΔW is not zero
        out["merged"] = merge_lora(shards, lora, 16.0, tp=tp, cfg=cfg)
        out["merged_want"] = pm.local_shard(merge_lora(params, lora, 16.0), cfg, n, rank)
        state = make_sharded_train_state(torch.Generator().manual_seed(7), cfg, mesh,
                                         make_optimizer())
        out["state_params"] = state.params
        out["state_mu_zero"] = all(not bool(t.any()) for t in tree_leaves(state.opt_state["mu"]))
        out["shards"] = shards
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results of the world of n tp ranks, spawned once each."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = _spawn(_trunk_rank, n, tmp_path_factory.mktemp(f"tp{n}"), n)
        return cache[n]

    return get


def _close(got, want, tol=TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), (err, want.abs().max().item())


@pytest.mark.parametrize("n", [2, 4])
def test_tp_trunk_gradients_equal_unsharded_autograd(worlds, n):
    ranks = worlds(n)
    for case in _cases(n):
        cname, trunk, remat = case
        cfg = _cfg(cname)
        tcfg = getattr(cfg, trunk)
        h, dx, grads = _trunk_grads(_params(cname)[trunk], tcfg, *_inputs(tcfg, 1), remat)
        norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads))).item()
        for r in ranks:
            got = r["cases"][case]
            _close(got["h"], h)
            _close(got["dx"], dx)  # the replicated input's gradient, whole on every rank
            assert torch.equal(got["dx"], ranks[0]["cases"][case]["dx"]), case
            np.testing.assert_allclose(got["norm"], norm, rtol=TOL)
        full = ranks[0]["cases"][case]["grads"]
        assert [t.shape for t in tree_leaves(full)] == [t.shape for t in tree_leaves(grads)]
        for g, w in zip(tree_leaves(full), tree_leaves(grads)):
            _close(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_kv_replica_groups(worlds, n):
    """tiny's decoder (KV 1) at tp 2: the tp group; the narrow decoder (KV 2)
    at tp 4: pairs of ranks; a trunk with a kv head a rank: none."""
    ranks = worlds(n)
    for r, out in enumerate(ranks):
        groups = out["kv_groups"]
        assert groups["narrow"]["backbone"] is None
        if n == 2:
            assert groups["tiny"] == {"backbone": None, "decoder": [0, 1]}
            assert groups["narrow"]["decoder"] is None
        else:
            assert groups["narrow"]["decoder"] == [r - r % 2, r - r % 2 + 1]


def test_all_gather_params_rebuilds_the_tree(worlds):
    ranks = worlds(2)  # the layout checks run in the tp 2 world
    full = _params("tiny")
    for r, out in enumerate(ranks):
        for g, w in zip(tree_leaves(out["gathered"]), tree_leaves(full)):
            assert g.device.type == "cpu" and torch.equal(g, w)
        assert (out["gathered_dst"] is None) == (r != 1)
    assert tree_leaves(ranks[1]["gathered_dst"])[0].shape == tree_leaves(full)[0].shape


def test_merge_lora_on_a_sharded_base(worlds):
    """The merge on each rank's shards equals that rank's shards of the
    merge of the full tree (columns of qkv and w13, rows of o_proj, w2 and
    the text embedding)."""
    ranks = worlds(2)  # the layout checks run in the tp 2 world
    for out in ranks:
        got, want = tree_leaves(out["merged"]), tree_leaves(out["merged_want"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, 1e-6)
        assert any(not torch.equal(g, s) for g, s in zip(got, tree_leaves(out["shards"])))


def test_make_sharded_train_state_is_the_shards_of_the_init(worlds):
    ranks = worlds(2)  # the layout checks run in the tp 2 world
    for out in ranks:
        for g, w in zip(tree_leaves(out["state_params"]), tree_leaves(out["shards"])):
            assert torch.equal(g, w)
        assert out["state_mu_zero"]


# -- the dp layout ---------------------------------------------------------------


class _StubMesh:
    def __init__(self, dp, d):
        self.dp, self.d = dp, d

    def size(self, dim):
        return self.dp if dim == 0 else 1

    def get_local_rank(self, name):
        return self.d


def test_dp_rows_are_microbatch_major():
    assert pm.dp_rows(8, 2, 0) == [0, 1, 2, 3]
    assert pm.dp_rows(8, 2, 1) == [4, 5, 6, 7]
    # two microbatches of 4 rows: each rank holds its half of each
    assert pm.dp_rows(8, 2, 0, accum_steps=2) == [0, 1, 4, 5]
    assert pm.dp_rows(8, 2, 1, accum_steps=2) == [2, 3, 6, 7]
    assert sorted(pm.dp_rows(12, 3, 0, 2) + pm.dp_rows(12, 3, 1, 2)
                  + pm.dp_rows(12, 3, 2, 2)) == list(range(12))


def test_shard_batch_takes_the_ranks_rows_and_refuses_uneven_splits():
    from sesameai_tts_tpu_torch.training.loss import Batch

    tokens = np.arange(8 * 3 * 2).reshape(8, 3, 2)
    batch = Batch(tokens, tokens > 5, np.ones((8, 3), bool))
    for accum in (1, 2):
        for d in (0, 1):
            got = pm.shard_batch(batch, _StubMesh(2, d), accum)
            rows = pm.dp_rows(8, 2, d, accum)
            assert isinstance(got, Batch)
            for g, x in zip(got, batch):
                np.testing.assert_array_equal(g, x[rows])
    t = Batch(*(torch.from_numpy(np.asarray(x)) for x in batch))
    assert torch.equal(pm.shard_batch(t, _StubMesh(2, 1)).tokens, t.tokens[4:])
    with pytest.raises(ValueError):
        pm.shard_batch(batch, _StubMesh(3, 0))  # 8 rows over dp 3
    with pytest.raises(ValueError):
        pm.shard_batch(batch, _StubMesh(2, 0), accum_steps=8)  # microbatches of 1 over dp 2
    with pytest.raises(ValueError):
        pm.shard_batch(batch, _StubMesh(2, 0), accum_steps=3)
