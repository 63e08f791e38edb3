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
