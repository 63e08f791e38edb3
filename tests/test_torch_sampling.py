"""Port sampler vs ``sesameai_tts_tpu/ops/sampling.py``: with the same
injected Gumbel noise both packages draw the same tokens, for static and
per-slot topk and temperature, greedy topk <= 1, and rows holding -inf."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.ops import sampling as js
from sesameai_tts_tpu_torch.models.csm import frame_generator
from sesameai_tts_tpu_torch.ops import sampling as ts


def _logits(seed, shape=(4, 6, 67)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3).astype(np.float32), rng.gumbel(size=shape).astype(np.float32)


@pytest.mark.parametrize("topk", [2, 5, 40, 66, 67, 500])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_injected_gumbel_samples_equal(topk, temperature):
    logits, g = _logits(topk)
    want = js.sample_topk(None, jnp.asarray(logits), topk, temperature, gumbel=jnp.asarray(g))
    got = ts.sample_topk(None, torch.from_numpy(logits), topk, temperature, gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threshold_matches_jax():
    logits, _ = _logits(1, (3, 2051))
    for k in (1, 40, 2050):
        want = np.asarray(js.topk_threshold(jnp.asarray(logits), k))
        got = ts.topk_threshold(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got, want)
        # never drops a top-k token
        assert ((logits >= got).sum(-1) >= k).all()


def test_per_slot_topk_and_temperature_equal():
    logits, g = _logits(2, (5, 67))
    topk = np.array([1, 3, 10, 67, 200], np.int32)
    temp = np.array([0.5, 0.8, 1.0, 1.2, 2.0], np.float32)
    want = js.sample_topk(None, jnp.asarray(logits), jnp.asarray(topk), jnp.asarray(temp),
                          gumbel=jnp.asarray(g))
    got = ts.sample_topk(None, torch.from_numpy(logits), torch.from_numpy(topk),
                         torch.from_numpy(temp), gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == int(np.argmax(logits[0]))  # k=1 per slot is greedy


@pytest.mark.parametrize("topk", [0, 1])
def test_topk_one_is_argmax(topk):
    logits, _ = _logits(3)
    gen = torch.Generator().manual_seed(0)
    got = ts.sample_topk(gen, torch.from_numpy(logits), topk, 0.8)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_minus_inf_rows_equal_and_never_sampled():
    logits, g = _logits(4, (4, 67))
    logits[0, :60] = -np.inf  # 7 finite tokens
    logits[1, ::2] = -np.inf
    logits[2, :] = -np.inf  # all banned: a defined (if meaningless) token
    for topk in (3, 40):
        want = np.asarray(js.sample_topk(None, jnp.asarray(logits), topk, 0.9, gumbel=jnp.asarray(g)))
        got = ts.sample_topk(None, torch.from_numpy(logits), topk, 0.9,
                             gumbel=torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(got, want)
        for row in (0, 1, 3):
            assert np.isfinite(logits[row, got[row]])


def test_drawn_noise_is_gumbel_and_seeded_per_frame():
    a = ts.gumbel_noise(frame_generator(5, 3, "cpu"), (200_000,))
    b = ts.gumbel_noise(frame_generator(5, 3, "cpu"), (200_000,))
    c = ts.gumbel_noise(frame_generator(5, 4, "cpu"), (200_000,))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    # standard Gumbel: mean = Euler–Mascheroni, variance = π²/6
    assert abs(a.mean().item() - 0.5772) < 0.01
    assert abs(a.var().item() - np.pi**2 / 6) < 0.03
