"""The port's native audio backend (``sesameai_tts_tpu_torch/audio/native.py``)
against the JAX package's bindings of the same ``native/audio.cpp`` and
against the port's numpy paths: the cases of ``tests/test_audio.py``, and
the port's ``resample_native`` equal to the JAX one sample for sample
(same library, same filter plan)."""

import numpy as np
import pytest

from sesameai_tts_tpu.audio import native as j_native
from sesameai_tts_tpu_torch.audio import native
from sesameai_tts_tpu_torch.audio.resample import resample
from sesameai_tts_tpu_torch.audio.segment import AudioClip


@pytest.fixture(scope="module", autouse=True)
def _library():
    """g++ builds native/ here; the JAX test skips without it, and so do these."""
    if not native.available():
        pytest.skip("native audio library unavailable (no g++)")


@pytest.mark.parametrize("rates", [(24_000, 44_100), (44_100, 24_000), (16_000, 24_000)])
def test_native_resample_matches_scipy_and_the_jax_binding(rates):
    """Within the JAX test's 5e-4 of the port's scipy ``resample`` away from
    the edges, and exactly the JAX package's ``resample_native``."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=4800).astype(np.float32) * 0.3
    ref = resample(x, *rates)
    nat = native.resample_native(x, *rates)
    assert nat.shape == ref.shape and nat.dtype == np.float32
    np.testing.assert_allclose(nat[100:-100], ref[100:-100], atol=5e-4)
    np.testing.assert_array_equal(nat, j_native.resample_native(x, *rates))


def test_native_resample_same_rate_is_identity():
    x = np.arange(10, dtype=np.float32)
    assert native.resample_native(x, 24_000, 24_000) is x


def test_native_helpers():
    x = np.ones(1000, np.float32) * 0.5
    y = native.fade_inplace(x.copy(), 100, 100)
    assert y[0] == 0.0 and abs(y[500] - 0.5) < 1e-6
    i16 = native.to_int16(np.array([0.0, 1.0, -1.0, 2.0], np.float32))
    assert list(i16) == [0, 32767, -32767, 32767]
    z = native.peak_normalize_inplace(np.array([0.25, -0.5], np.float32), 1.0)
    np.testing.assert_allclose(z, [0.5, -1.0], atol=1e-6)
    np.testing.assert_array_equal(
        z, j_native.peak_normalize_inplace(np.array([0.25, -0.5], np.float32), 1.0))


def test_native_fade_and_int16_sample_exact_vs_audioclip():
    """Sample-exact parity with the port's AudioClip: the fade ramps hit
    both linspace endpoints and int16 truncates like ndarray.astype."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=2400) * 0.4).astype(np.float32)
    sr = 24_000
    ms = 10.0  # 240 samples
    clip = AudioClip.from_float(x.copy(), sr).fade_in(ms).fade_out(ms)
    n = int(ms / 1000.0 * sr)
    np.testing.assert_array_equal(native.fade_inplace(x.copy(), n, n), clip.samples)

    y = (rng.normal(size=1000) * 1.2).astype(np.float32)  # some clipping
    np.testing.assert_array_equal(native.to_int16(y.copy()),
                                  AudioClip.from_float(y, sr).to_int16())


def test_unavailable_library_raises(monkeypatch):
    """Without the library, ``available()`` is False and each helper raises."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.to_int16(np.zeros(4, np.float32))
