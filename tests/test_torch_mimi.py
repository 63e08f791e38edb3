"""Port Mimi codec vs ``sesameai_tts_tpu/codec/mimi.py`` at
``mimi_test_tiny`` in f32: encode codes are equal, decode PCM agrees, and
chained streaming decode equals the offline decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.codec import mimi as jmimi
from sesameai_tts_tpu_torch.codec import conv as tconv
from sesameai_tts_tpu_torch.codec import mimi as tmimi
from sesameai_tts_tpu_torch.convert import from_jax_params

# f32 PCM after ~20 conv and transformer layers summed in another order;
# stated relative to the waveform's peak
PCM_RTOL = 1e-5


def _close_pcm(got, want, rtol=PCM_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def codec():
    jm = jmimi.Mimi(jmimi.mimi_test_tiny())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tmimi.Mimi(tmimi.mimi_test_tiny()), from_jax_params(jax.tree.map(np.asarray, jp))


def _wav(m, frames, seed):
    t = np.arange(frames * m.cfg.hop_length) / m.cfg.sample_rate
    noise = np.random.default_rng(seed).standard_normal(t.size) * 0.05
    return (0.5 * np.sin(2 * np.pi * 220 * t) + noise).astype(np.float32)[None, None]


@pytest.mark.parametrize("frames", [4, 16])
def test_encode_codes_equal(codec, frames):
    jm, jp, tm, tp = codec
    wav = _wav(jm, frames, frames)
    want = np.asarray(jm.encode(jp, jnp.asarray(wav)))
    got = tm.encode(tp, torch.from_numpy(wav))
    assert got.shape == (1, 8, frames)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_close_to_jax(codec):
    jm, jp, tm, tp = codec
    codes = np.random.default_rng(1).integers(0, 32, (1, 8, 6))
    want = np.asarray(jm.decode(jp, jnp.asarray(codes, jnp.int32)))
    got = tm.decode(tp, torch.from_numpy(codes))
    _close_pcm(got.numpy(), want)


def test_decode_clamps_codes_past_the_last_bin_like_jax(codec):
    """CSM's audio vocab exceeds Mimi's bins; both packages read the last bin."""
    jm, jp, tm, tp = codec
    codes = np.full((1, 8, 2), 40)  # bins = 32
    want = np.asarray(jm.decode(jp, jnp.asarray(codes, jnp.int32)))
    _close_pcm(tm.decode(tp, torch.from_numpy(codes)).numpy(), want)


def test_streaming_decode_chained_equals_offline(codec):
    _, _, tm, tp = codec
    codes = torch.from_numpy(np.random.default_rng(2).integers(0, 32, (1, 8, 9)))
    offline = tm.decode(tp, codes)
    state = tm.init_decode_state(1)
    parts, start = [], 0
    for n in (1, 3, 2, 3):
        wav, state = tm.decode_streaming(tp, codes[:, :, start:start + n], state)
        parts.append(wav)
        start += n
    _close_pcm(torch.cat(parts, dim=-1).numpy(), offline.numpy())


def test_replicate_padded_conv_streaming_equals_offline():
    spec = tconv.CausalConv1d(3, 5, 4, stride=2, pad_mode="replicate")
    p = spec.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 12, generator=torch.Generator().manual_seed(1))
    state = spec.init_state(2)
    ys = []
    for a, b in ((0, 4), (4, 6), (6, 12)):
        y, state = spec.apply_streaming(p, x[:, :, a:b], state)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, -1), spec.apply(p, x), rtol=1e-6, atol=1e-6)


def test_channelwise_transposed_conv_streaming_equals_offline():
    spec = tconv.CausalConvTranspose1d(4, 4, 4, stride=2, groups=4, bias=False)
    p = spec.init(torch.Generator().manual_seed(2))
    x = torch.randn(1, 4, 7, generator=torch.Generator().manual_seed(3))
    state = spec.init_state(1)
    ys = []
    for a, b in ((0, 2), (2, 3), (3, 7)):
        y, state = spec.apply_streaming(p, x[:, :, a:b], state)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, -1), spec.apply(p, x), rtol=1e-6, atol=1e-6)


def test_streaming_chunk_past_the_ring_slack_raises(codec):
    _, _, tm, tp = codec
    cap = tm.max_stream_chunk_frames
    codes = torch.zeros((1, 8, cap + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="ring slack"):
        tm.decode_streaming(tp, codes, tm.init_decode_state(1))
