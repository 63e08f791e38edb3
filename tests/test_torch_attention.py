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
