"""The port's attention (``sesameai_tts_tpu_torch/ops/attention.py``) on the
CPU against the JAX package at small f32 sizes: ``flash_attention_plain``
against the Pallas ``flash_attention`` in interpret mode, and against the
trunk's ``models/transformer.py::_attention`` at decode steps, a
right-padded prefill and a row with ``valid_len`` 0.  The wrapper runs the
plain version for CPU tensors without counting a launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.models.transformer import _attention as j_attention
from sesameai_tts_tpu.ops.attention import flash_attention as j_flash
from sesameai_tts_tpu_torch.ops import attention as ta

# f32, as tests/test_attention.py holds the Pallas kernel to XLA's attention
TOL = 2e-4


def _inputs(seed, B, H, KV, S, T, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    return q, k, v


def _plain(q, k, v, pos0, valid_end):
    return ta.flash_attention_plain(*(torch.from_numpy(np.asarray(a))
                                      for a in (q, k, v, pos0, valid_end))).numpy()


def _mask(pos0, valid_end, S, T):
    positions = pos0[:, None] + np.arange(S)[None, :]
    key_pos = np.arange(T)
    return (key_pos[None, None, :] <= positions[:, :, None]) & (
        key_pos[None, None, :] < valid_end[:, None, None])


@pytest.mark.parametrize("B,H,KV,S,T,hd,pos0", [
    (1, 4, 2, 128, 256, 64, 0),
    (1, 4, 2, 128, 256, 64, 100),  # decode-extension window
    (2, 8, 2, 256, 256, 64, 0),
])
def test_plain_matches_pallas_flash_attention(B, H, KV, S, T, hd, pos0):
    q, k, v = _inputs(0, B, H, KV, S, T, hd)
    p0 = np.full((B,), pos0, np.int32)
    valid = np.full((B,), pos0 + S - 7, np.int32)  # right-padded rows
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(p0),
                              jnp.asarray(valid), interpret=True))
    got = _plain(q, k, v, p0.astype(np.int64), valid.astype(np.int64))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hd,T", [(64, 32), (64, 256), (128, 32), (128, 256)])
def test_decode_step_matches_jax_attention(hd, T):
    B, H, KV = 2, 8, 2
    q, k, v = _inputs(1, B, H, KV, 1, T, hd)
    pos0 = np.array([0, T - 1])  # the first and the last slot of the cache
    valid_end = pos0 + 1
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(_mask(pos0, valid_end, 1, T)))
    np.testing.assert_allclose(_plain(q, k, v, pos0, valid_end), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_right_padded_prefill_and_empty_row_match_jax_attention():
    B, H, KV, S, T, hd = 3, 4, 2, 16, 64, 16
    q, k, v = _inputs(2, B, H, KV, S, T, hd)
    pos0 = np.array([0, 20, 0])
    # padded; full; valid_len 0 at position 0, where no slot is visible
    valid_end = pos0 + np.array([11, 16, 0])
    got = _plain(q, k, v, pos0, valid_end)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(_mask(pos0, valid_end, S, T)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert np.isfinite(got).all()
    assert not got[2].any()  # the row that sees no slot is exactly zero


# -- the split-K decode kernel's arithmetic -------------------------------------


def _to(a, dtype):
    """numpy f32 → torch in ``dtype`` (bf16 rounds to nearest even)."""
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _assert_split_close(got, want, v):
    """bf16: each weight moves by at most 2^-9 of itself wherever p is
    rounded, so the outputs (convex combinations of v's rows) differ by at
    most 2^-8 max|v|, plus one bf16 rounding of the output (< 1e-2
    relative): chip_smoke.py's stated tolerance.  f32: only the order of
    f32 sums and the exp factorization differ."""
    rel, vabs = (1e-2, 2**-8) if v.dtype == torch.bfloat16 else (1e-5, 1e-5)
    got, want, v = (a.float() if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32))
                    for a in (got, want, v))
    tol = rel * want.abs() + vabs * v.abs().max()
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


# (B, H, KV, T, hd, pos0 per row, valid_len per row): decode steps (S = 1)
_SPLIT_CASES = {
    "one row mid-cache": (1, 8, 2, 256, 64, (150,), (1,)),
    "two rows at different positions": (2, 8, 2, 256, 64, (20, 230), (1, 1)),
    "empty splits: 6 keys over many ranges": (1, 4, 2, 256, 16, (5,), (1,)),
    "row without keys beside a full one": (2, 4, 2, 256, 128, (0, 255), (0, 1)),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_matches_pallas_flash_attention(case, splits, dtype):
    """flash_attention_split_plain against the Pallas kernel in interpret
    mode (block_q = 1, so S = 1 steps) and against flash_attention_plain, in
    bf16 and f32."""
    B, H, KV, T, hd, pos0, valid_len = _SPLIT_CASES[case]
    q, k, v = (_to(a, dtype) for a in _inputs(4, B, H, KV, 1, T, hd))
    p0 = torch.tensor(pos0)
    ve = p0 + torch.tensor(valid_len)
    got = ta.flash_attention_split_plain(q, k, v, p0, ve, splits)
    assert got.dtype == dtype and got.shape == (B, H, 1, hd)
    _assert_split_close(got, ta.flash_attention_plain(q, k, v, p0, ve), v)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = [jnp.asarray(a.float().numpy()).astype(jdt) for a in (q, k, v)]
    want = j_flash(*jargs, jnp.asarray(p0.numpy(), jnp.int32), jnp.asarray(ve.numpy(), jnp.int32),
                   block_q=1, block_k=64, interpret=True)
    _assert_split_close(got, np.asarray(want.astype(jnp.float32)), v)
    for b, (p, n) in enumerate(zip(pos0, valid_len)):
        if p == 0 and n == 0:
            assert not got[b].any()  # a row that sees no slot is exactly 0


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_two_rows_match_plain(splits, dtype):
    """S = 2 (G * S = 4, the most a decode block holds): the causal mask
    inside the visible range."""
    q, k, v = (_to(a, dtype) for a in _inputs(5, 2, 4, 2, 2, 64, 64))
    p0, ve = torch.tensor([10, 40]), torch.tensor([12, 41])  # row 1's last query is past ve
    _assert_split_close(ta.flash_attention_split_plain(q, k, v, p0, ve, splits),
                        ta.flash_attention_plain(q, k, v, p0, ve), v)


@pytest.mark.parametrize("workers", [1, 4, 12, 64])
def test_split_ranges_cover_the_visible_keys(workers):
    for kend in range(0, 300):
        ranges = ta._split_ranges(kend, workers)
        assert len(ranges) == workers
        keys = [t for lo, hi in ranges for t in range(lo, hi)]
        assert keys == list(range(kend))  # disjoint, in order, every visible key once
        assert all(0 <= lo <= hi <= kend for lo, hi in ranges)  # an empty share exits cleanly
        chunk = -(-kend // workers)
        assert all(hi - lo <= chunk for lo, hi in ranges)  # even shares


@pytest.mark.parametrize("B,KV,T,hd,elem,want", [
    (1, 8, 2048, 64, 2, 16),  # backbone decode: 128 blocks, one 32-key tile per warp at T
    (2, 8, 2048, 64, 2, 16),
    (3, 8, 2048, 64, 2, 8),  # 264 // 24 = 11 blocks per cluster, down to a power of two
    (1, 2, 32, 128, 2, 1),  # decoder step: one block per KV head, a warp per 8 keys
    (2, 2, 100, 16, 4, 1),  # the tiny f32 flavor
    (64, 8, 2048, 64, 2, 1),  # a wide batch fills the card without splits
])
def test_decode_splits(B, KV, T, hd, elem, want):
    splits = ta._decode_splits(B, KV, T, hd, elem, sms=132)
    assert splits == want and 1 <= splits <= 16 and splits & (splits - 1) == 0
    # at a full cache each warp walks at most one tile, unless the cluster is capped
    wk = ta._decode_tile(hd, elem)
    assert splits == 16 or splits * 4 * wk >= T or 2 * splits * B * KV > 2 * 132


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = _inputs(3, 1, 4, 2, 5, 12, 16)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    pos0, valid_end = torch.tensor([3]), torch.tensor([7])
    before = ta.flash_attention.launches
    got = ta.flash_attention(*args, pos0, valid_end)
    assert ta.flash_attention.launches == before  # no kernel on the CPU
    assert torch.equal(got, ta.flash_attention_plain(*args, pos0, valid_end))
    with pytest.raises(ValueError, match="device"):
        ta.flash_attention(*(a.to("meta") for a in args), pos0, valid_end)


# -- the tensor-core prefill's arithmetic and tile plan -------------------------


# (B, H, KV, S, T, hd, pos0 per row, valid_len per row, Pallas block_q)
_TILED_CASES = {
    "causal prefill from 0, G=4": (1, 8, 2, 64, 128, 64, (0,), (64,), 16),
    "prefill after a cached context, G=4": (1, 8, 2, 32, 192, 64, (100,), (32,), 32),
    "right-padded row beside a row with valid_len 0": (2, 8, 2, 32, 128, 64, (0, 0), (20, 0), 16),
    "S=24 not a multiple of BQ=16, G=4": (1, 8, 2, 24, 128, 64, (5,), (24,), 8),
    "G=1: 64-row tiles, padded": (1, 2, 2, 40, 128, 64, (50,), (35,), 8),
    "hd 128, G=4": (1, 4, 1, 16, 64, 128, (0,), (16,), 16),
}


@pytest.mark.parametrize("case", sorted(_TILED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_plain_matches_pallas_flash_attention(case, dtype):
    """flash_attention_tiled_plain (p rounded to v's dtype at each 64-key
    tile's running max, l unrounded) against the Pallas kernel in interpret
    mode at block_k = 64, the same arithmetic, and against
    flash_attention_plain within the stated tolerance."""
    B, H, KV, S, T, hd, pos0, valid_len, block_q = _TILED_CASES[case]
    q, k, v = (_to(a, dtype) for a in _inputs(6, B, H, KV, S, T, hd))
    p0 = torch.tensor(pos0)
    ve = p0 + torch.tensor(valid_len)
    got = ta.flash_attention_tiled_plain(q, k, v, p0, ve)
    assert got.dtype == dtype and got.shape == (B, H, S, hd)
    _assert_split_close(got, ta.flash_attention_plain(q, k, v, p0, ve), v)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = [jnp.asarray(a.float().numpy()).astype(jdt) for a in (q, k, v)]
    want = j_flash(*jargs, jnp.asarray(p0.numpy(), jnp.int32), jnp.asarray(ve.numpy(), jnp.int32),
                   block_q=block_q, block_k=64, interpret=True)
    _assert_split_close(got, np.asarray(want.astype(jnp.float32)), v)
    for b, (p, n) in enumerate(zip(pos0, valid_len)):
        if p == 0 and n == 0:
            assert not got[b].any()  # a row that sees no slot is exactly 0


@pytest.mark.parametrize("block_k", [16, 64, 128])
def test_tiled_plain_in_f32_is_the_plain_version(block_k):
    """In f32 nothing is rounded, so the tile size only reorders f32 sums."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 2, 8, 2, 20, 100, 64))
    p0, ve = torch.tensor([0, 60]), torch.tensor([15, 80])
    got = ta.flash_attention_tiled_plain(q, k, v, p0, ve, block_k=block_k)
    torch.testing.assert_close(got, ta.flash_attention_plain(q, k, v, p0, ve), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,G,T,pos0,valid_len", [
    (512, 4, 2048, 0, 500),  # the voice-context prefill
    (64, 4, 2048, 500, 64),  # an utterance prefill after the context
    (768, 4, 2048, 0, 628),  # a rolling-context turn at the 768 bucket
    (64, 4, 2048, 0, 0),  # a row with valid_len 0
    (40, 1, 100, 50, 35),  # G = 1: 64 rows a tile; the cache ends mid-tile
    (24, 8, 256, 30, 24),  # G = 8: 8 rows a tile
    (16, 4, 32, 0, 16),  # the decoder's 32-slot cache at hd 128
])
def test_mma_tile_plan(S, G, T, pos0, valid_len):
    """BQ = 64 / G rows a query tile; a key tile is visited exactly when
    some row of the query tile sees one of its keys, and masked exactly when
    some row misses one of its keys (or the cache ends inside it)."""
    ve = pos0 + valid_len
    plan = ta._mma_tile_plan(S, G, T, pos0, ve)
    BQ = 64 // G
    assert [q0 for q0, _, _, _ in plan] == list(range(0, S, BQ))
    assert sum(rows for _, rows, _, _ in plan) == S
    for q0, rows, tiles, masked in plan:
        assert rows == min(BQ, S - q0)
        seen = [[t <= pos0 + q0 + i and t < ve and t < T for t in range(0, T + 64)]
                for i in range(rows)]
        want_tiles = [kt for kt in range(0, T, 64)
                      if any(any(r[kt:kt + 64]) for r in seen)]
        want_masked = [kt for kt in want_tiles if not all(all(r[kt:kt + 64]) for r in seen)]
        assert tiles == want_tiles and masked == want_masked


@pytest.mark.parametrize("dtype,hd,G,S,want", [
    (torch.bfloat16, 64, 4, 1, "split"),  # backbone decode step
    (torch.bfloat16, 128, 4, 1, "split"),  # decoder step
    (torch.bfloat16, 64, 4, 512, "mma"),  # voice-context prefill
    (torch.bfloat16, 64, 4, 64, "mma"),  # utterance prefill
    (torch.bfloat16, 128, 4, 16, "mma"),
    (torch.bfloat16, 64, 4, 2, "mma"),  # 8 query vectors: past the decode kernel's 4
    (torch.bfloat16, 16, 2, 37, "fma"),  # hd 16 has no tensor-core route
    (torch.float32, 64, 4, 512, "fma"),  # f32 stays on CUDA cores (no TF32)
    (torch.float32, 16, 2, 37, "fma"),  # the tiny f32 flavor's prefill
    (torch.float32, 16, 2, 1, "split"),
])
def test_route_by_dtype_and_head_dim(dtype, hd, G, S, want):
    assert ta._route(dtype, hd, G, S) == want


# -- the gradient ------------------------------------------------------------------

# (B, H, KV, S, T, hd, pos0 per row, valid_end per row): training's cache-free
# window (pos0 0, valid_end S), right padding, a row that sees no slot, G = 4 and
# G = 1, a window after a cached context, hd 64
_GRAD_CASES = {
    "window, G=2": (2, 4, 2, 12, 12, 16, (0, 0), (12, 12)),
    "right-padded row beside an empty one, G=4": (2, 8, 2, 10, 10, 16, (0, 0), (6, 0)),
    "after a context, G=1": (1, 2, 2, 6, 20, 16, (9,), (13,)),
    "hd 64, G=4": (1, 8, 2, 9, 9, 64, (0,), (9,)),
}


def _grad_inputs(case, seed=5):
    B, H, KV, S, T, hd, pos0, valid_end = case
    q, k, v = _inputs(seed, B, H, KV, S, T, hd)
    do = np.random.default_rng(seed + 1).standard_normal((B, H, S, hd)).astype(np.float32)
    return q, k, v, do, np.array(pos0), np.array(valid_end)


@pytest.mark.parametrize("case", list(_GRAD_CASES.values()), ids=list(_GRAD_CASES))
def test_bwd_plain_is_autograd_of_the_plain_version(case):
    """f32: the analytic gradient (D = rowsum(dO o O)) against torch.autograd
    through flash_attention_plain; only the order of f32 sums differs."""
    q, k, v, do, pos0, valid_end = _grad_inputs(case)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    p0, ve = torch.from_numpy(pos0), torch.from_numpy(valid_end)
    out = ta.flash_attention_plain(qt, kt, vt, p0, ve)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    got = ta.flash_attention_bwd_plain(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                       torch.from_numpy(do), p0, ve)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    for b in np.flatnonzero(valid_end <= 0):  # a row that sees no slot: zero gradients
        assert not got[0][b].any() and not got[1][b].any() and not got[2][b].any()


@pytest.mark.parametrize("case", list(_GRAD_CASES.values()), ids=list(_GRAD_CASES))
def test_function_gradient_matches_jax_attention(case):
    """The port's flash_attention with grad (FlashAttentionFn: the plain
    forward, flash_attention_bwd on the CPU) against jax.vjp of the JAX
    package's _attention under the same mask, f32."""
    import jax

    q, k, v, do, pos0, valid_end = _grad_inputs(case, seed=7)
    S, T = q.shape[2], k.shape[2]
    mask = jnp.asarray(_mask(pos0, valid_end, S, T))
    out, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, mask), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = ta.flash_attention(qt, kt, vt, torch.from_numpy(pos0), torch.from_numpy(valid_end))
    assert "FlashAttentionFn" in type(got_out.grad_fn).__name__
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    got = torch.autograd.grad(got_out, (qt, kt, vt), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_no_function_without_grad():
    """Decode and prefill (no grad, or no operand requiring grad) take the
    bare forward: no graph node."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 5, 12, 16))
    p0, ve = torch.tensor([0]), torch.tensor([5])
    assert ta.flash_attention(q, k, v, p0, ve).grad_fn is None
    with torch.no_grad():
        assert ta.flash_attention(q.requires_grad_(), k, v, p0, ve).grad_fn is None
    before = ta.flash_attention_bwd.launches
    ta.flash_attention(q, k, v, p0, ve).sum().backward()
    assert q.grad is not None and ta.flash_attention_bwd.launches == before  # the CPU: plain


# -- the backward kernels' tile plan and bf16 arithmetic ------------------------------


def _visible(S, T, pos0, valid_end):
    """(S, T + 64) bool: row i sees key t (keys past the cache see nothing)."""
    rows = pos0 + np.arange(S)[:, None]
    keys = np.arange(T + 64)[None, :]
    return (keys <= rows) & (keys < valid_end) & (keys < T)


@pytest.mark.parametrize("S,G,T,pos0,valid_end", [
    (256, 4, 256, 0, 256),  # main[train]'s backbone window
    (512, 4, 512, 0, 300),  # a right-padded row
    (256, 4, 256, 0, 0),  # a row that sees no key
    (32, 4, 32, 0, 32),  # the decoder's K positions: half a key tile
    (40, 1, 100, 30, 70),  # G = 1, a window after a context, ending mid-tile
    (20, 16, 20, 0, 20),  # G = 16: 4 rows a tile
    (37, 2, 37, 0, 30),  # the tiny flavor, ragged tiles
    (50, 3, 130, 60, 100),  # G = 3: 21 rows, 63 vectors a tile
])
def test_bwd_tile_plan(S, G, T, pos0, valid_end):
    """Each kernel covers every visible (query, key, head) pair exactly once,
    visits no tile that is wholly invisible, and masks exactly the tiles
    that some row misses some key of (the causal diagonal, valid_end or
    the cache's end)."""
    plan = ta._bwd_tile_plan(S, G, T, pos0, valid_end)
    seen = _visible(S, T, pos0, valid_end)
    BQ, BK = 64 // G, 64
    q_tiles = list(range(0, S, BQ))
    rect = {(q0, kt): seen[q0:q0 + BQ, kt:kt + BK] for q0 in q_tiles for kt in range(0, T, BK)}
    want_visits = {pair for pair, r in rect.items() if r.any()}
    want_masked = {pair for pair in want_visits if not rect[pair].all()}

    dq = plan["dq"]
    assert [q0 for q0, _, _, _ in dq] == q_tiles
    assert [rows for _, rows, _, _ in dq] == [min(BQ, S - q0) for q0 in q_tiles]
    dkdv = plan["dkdv"]
    assert [kt for kt, _, _, _ in dkdv] == list(range(0, T, BK))
    assert [keys for _, keys, _, _ in dkdv] == [min(BK, T - kt) for kt in range(0, T, BK)]
    for visits in (
        [((q0, kt), kt in masked) for q0, _, tiles, masked in dq for kt in tiles],
        [((q0, kt), q0 in masked) for kt, _, tiles, masked in dkdv for q0 in tiles],
    ):
        pairs = [pair for pair, _ in visits]
        assert len(pairs) == len(set(pairs)) and set(pairs) == want_visits
        assert {pair for pair, m in visits if m} == want_masked
        # every visible pair once, for each of the G heads of the tile's vectors
        covered = sum(int(rect[pair].sum()) * G for pair in pairs)
        assert covered == int(seen.sum()) * G
    if valid_end <= 0:
        assert all(not tiles for _, _, tiles, _ in dq + dkdv)


# (B, H, KV, S, hd, valid_end per row): the backbone's and the decoder's head
# counts (and one rank's of a tp = 2 mesh) at a small S, with a right-padded
# row and a row that sees no key
_BWD_MMA_CASES = {
    "backbone, a right-padded row": (2, 32, 8, 48, 64, (48, 30)),
    "backbone, a row without keys": (2, 32, 8, 24, 64, (24, 0)),
    "decoder": (4, 8, 2, 32, 128, (32,) * 4),
    "backbone tp2 shard": (2, 16, 4, 40, 64, (40, 40)),
    "decoder tp2 shard": (4, 4, 1, 32, 128, (32,) * 4),
    "tiny flavor": (2, 4, 2, 37, 16, (37, 20)),
}


@pytest.mark.parametrize("case", list(_BWD_MMA_CASES.values()), ids=list(_BWD_MMA_CASES))
def test_bwd_mma_plain_within_the_chip_gate(case):
    """The bf16 kernels' rounding (P and dS as hi + lo bf16 pairs, f32 sums)
    lies within chip_smoke.py's bf16 gate of the f32 gradient, on bf16
    inputs as the kernel phase makes them, o from the forward kernels'
    arithmetic; a row that sees no key gets exact zeros."""
    from chip_smoke import _BWD_TOL

    B, H, KV, S, hd, valid_end = case
    rng = np.random.default_rng(11)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q = randn(B, S, H, hd).transpose(1, 2)
    k, v = randn(B, KV, S, hd), randn(B, KV, S, hd)
    do = randn(B, S, H, hd).transpose(1, 2)
    p0, ve = torch.zeros(B, dtype=torch.int64), torch.tensor(valid_end)
    o = ta.flash_attention_tiled_plain(q, k, v, p0, ve)
    got = ta.flash_attention_bwd_mma_plain(q, k, v, o, do, p0, ve)
    want = ta.flash_attention_bwd_plain(q, k, v, o, do, p0, ve)
    rtol, atol_of_peak = _BWD_TOL["bfloat16"]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        w = w.float()
        diff = (g.float() - w).abs()
        assert bool((diff <= rtol * w.abs() + atol_of_peak * w.abs().max()).all()), \
            float(diff.max())
    for b, e in enumerate(valid_end):
        if e <= 0:
            assert not any(g[b].any() for g in got)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_bwd_route_by_dtype(dtype, want):
    assert ta._bwd_route(dtype) == want


@pytest.mark.parametrize("B,KV,S,T,G,want", [
    (2, 8, 256, 256, 4, 2),  # main[train]'s backbone: 64 key tiles x 2 = 128 blocks
    (2, 4, 256, 256, 4, 4),  # one tp 2 rank's backbone heads
    (2, 8, 512, 512, 4, 1),  # 128 blocks fill the card already
    (2, 8, 2048, 2048, 4, 1),
    (8, 2, 32, 32, 4, 2),  # the decoder: a walk of 2 query tiles
    (1, 4, 40, 100, 1, 1),  # G = 1: one query tile
    (1, 1, 1024, 64, 4, 8),  # at most 8
])
def test_bwd_splits(B, KV, S, T, G, want):
    assert ta._bwd_splits(B, KV, S, T, G, 132) == want
