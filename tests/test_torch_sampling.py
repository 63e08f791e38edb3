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


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("temperature,k", [(0.7, 10), (1.3, 5)])
def test_chi_square_against_exact_distribution(temperature, k, as_tensors):
    """Counterpart of tests/test_sampling.py's χ² test: N rows of one
    logits vector sampled with the noise of one ``frame_generator`` (the
    one noise source the port keeps; the decode reseeds one generator per
    frame with the same seed), temperature and topk as numbers or as the
    per-row tensors the captured decode step reads."""
    V, N = 50, 20_000
    logits = np.random.default_rng(4).standard_normal(V).astype(np.float32) * 2.0
    scaled = logits.astype(np.float64) / temperature
    masked = np.where(scaled < np.sort(scaled)[-k], -np.inf, scaled)
    p = np.exp(masked - masked.max())
    p /= p.sum()

    rows = torch.from_numpy(logits).expand(N, V)
    if as_tensors:
        topk, temp = torch.full((N,), k), torch.full((N,), temperature)
    else:
        topk, temp = k, temperature
    draws = ts.sample_topk(frame_generator(5, 0, "cpu"), rows, topk, temp).numpy()
    counts = np.bincount(draws, minlength=V)
    support = p > 0
    assert counts[~support].sum() == 0  # never outside the top k
    chi2 = np.sum((counts[support] - N * p[support]) ** 2 / (N * p[support]))
    assert chi2 < 30.0, f"chi2={chi2:.1f} (df={k - 1})"


@pytest.mark.parametrize("temperature,k", [(0.7, 3), (1.3, 66), (0.9, 500)])
def test_tensor_temperature_and_topk_sample_as_numbers(temperature, k):
    """The tensor branch (what the captured decode step runs) draws what
    the number branch draws, at every topk: below, at and above V."""
    logits, g = _logits(7, (4, 67))
    got = ts.sample_topk(None, torch.from_numpy(logits), torch.full((4,), k),
                         torch.full((4,), temperature), gumbel=torch.from_numpy(g))
    want = ts.sample_topk(None, torch.from_numpy(logits), k, temperature,
                          gumbel=torch.from_numpy(g))
    assert torch.equal(got, want)
