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
