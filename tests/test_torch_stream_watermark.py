"""The port's streaming resampling (``audio/resample.py``) and streaming
watermark (``watermark/stream.py``) against the JAX package.

``StreamingResampler`` fed random chunks gives the port's offline
``resample`` of the whole input bit for bit (the JAX package's, whose
filter scipy sees one f32 rounding apart, within 1e-6);
``resample_device`` equals ``resample_jax`` within f32 rounding;
``StreamingEmbedder`` gives the JAX package's output bit for bit on the
same chunks, and the 24 kHz ``StreamingWatermarker`` within 1e-5; the
streamed marks verify on every prefix of 4 s or more, unmarked audio does
not; the first marked samples leave after ~0.1 s of input; the stream is
the offline embed past its leading edge; and the silentcipher network's
streaming entry points take only that network."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.audio.resample import StreamingResampler as JStreamingResampler
from sesameai_tts_tpu.audio.resample import resample as j_resample
from sesameai_tts_tpu.audio.resample import resample_jax
from sesameai_tts_tpu.watermark import stream as j_stream
from sesameai_tts_tpu_torch.audio.resample import StreamingResampler, resample, resample_device
from sesameai_tts_tpu_torch.watermark import stream
from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK, load_watermarker, verify
from sesameai_tts_tpu_torch.watermark.dsp import WATERMARK_RATE

RATES = [(24_000, WATERMARK_RATE), (WATERMARK_RATE, 24_000)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wm():
    return load_watermarker(device="cpu")


def _speechlike(seconds: float, rate: int, seed=0) -> np.ndarray:
    """Colored noise under a syllable-rate envelope (tests/test_watermark.py)."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = lfilter([1.0], [1.0, -0.95], rng.normal(size=n).astype(np.float32)).astype(np.float32)
    t = np.arange(n) / rate
    x = x * (0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


def _fed(pipe, audio, seed, lo=97, hi=4001):
    """``audio`` through ``pipe.feed`` in random chunks, then ``close``."""
    rng = np.random.default_rng(seed)
    outs, i = [], 0
    while i < len(audio):
        c = int(rng.integers(lo, hi))
        outs.append(pipe.feed(audio[i:i + c]))
        i += c
    outs.append(pipe.close())
    return np.concatenate(outs)


@pytest.mark.parametrize("orig,new", RATES)
def test_streaming_resampler_bit_identical_to_offline(orig, new):
    x = (np.random.default_rng(11).normal(size=31007) * 0.3).astype(np.float32)
    ref = resample(x, orig, new)
    np.testing.assert_array_equal(ref, j_resample(x, orig, new))
    got = _fed(StreamingResampler(orig, new), x, seed=1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # the JAX package's streaming resampler, within its own test's tolerance
    np.testing.assert_allclose(got, _fed(JStreamingResampler(orig, new), x, seed=1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("orig,new", RATES)
def test_resample_device_equals_resample_jax(orig, new):
    x = (np.random.default_rng(5).normal(size=(2, 4801)) * 0.3).astype(np.float32)
    got = resample_device(torch.from_numpy(x), orig, new)
    want = np.asarray(resample_jax(jnp.asarray(x), orig, new))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), resample(x[0], orig, new), rtol=0, atol=1e-5)
    assert resample_device(torch.from_numpy(x), orig, orig) is not None


def test_streaming_embedder_equals_jax():
    audio = _speechlike(3.0, WATERMARK_RATE, seed=2)
    got = _fed(stream.StreamingEmbedder(CSM_1B_WATERMARK, 30.0), audio, seed=4)
    want = _fed(j_stream.StreamingEmbedder(CSM_1B_WATERMARK, 30.0), audio, seed=4)
    assert got.shape == (len(audio),)
    np.testing.assert_array_equal(got, want)


def test_streaming_watermarker_equals_jax():
    audio = _speechlike(2.0, 24_000, seed=6)
    got = _fed(stream.StreamingWatermarker(CSM_1B_WATERMARK, 24_000), audio, seed=8, lo=480,
               hi=7681)
    want = _fed(j_stream.StreamingWatermarker(CSM_1B_WATERMARK, 24_000), audio, seed=8,
                lo=480, hi=7681)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_streamed_prefixes_verify(wm):
    """Fed 20-320 ms chunks: the stream and its 4 s and 6.5 s prefixes verify
    with the offline verifier; the unmarked audio does not."""
    audio = _speechlike(9.0, 24_000, seed=13)
    sw = stream.make_streaming_watermarker(wm, CSM_1B_WATERMARK, 24_000)
    marked = _fed(sw, audio, seed=3, lo=480, hi=7681)
    assert abs(len(marked) - len(audio)) <= 2
    assert verify(wm, marked, 24_000, CSM_1B_WATERMARK)
    for prefix_s in (4.0, 6.5):
        assert verify(wm, marked[:int(prefix_s * 24_000)], 24_000, CSM_1B_WATERMARK), prefix_s
    assert not verify(wm, audio, 24_000, CSM_1B_WATERMARK)


def test_streaming_latency_bounded():
    """The first marked samples leave after ~0.1 s of input, not 4 s."""
    sw = stream.StreamingWatermarker(CSM_1B_WATERMARK, 24_000)
    audio = _speechlike(1.0, 24_000, seed=4)
    fed = 0
    for i in range(0, len(audio), 1920):  # one 80 ms frame at a time
        fed += 1920
        if len(sw.feed(audio[i:i + 1920])):
            break
    assert fed <= int(0.25 * 24_000)


def test_stream_is_the_offline_embed_past_its_edge(wm):
    audio = _speechlike(5.0, WATERMARK_RATE, seed=21)
    off, _ = wm.encode_wav(audio, WATERMARK_RATE, CSM_1B_WATERMARK, message_sdr=30.0)
    se = stream.StreamingEmbedder(CSM_1B_WATERMARK, message_sdr=30.0)
    got = np.concatenate([se.feed(audio[i:i + 4410]) for i in range(0, len(audio), 4410)]
                         + [se.close()])
    assert len(got) == len(audio)
    lo = 8 * 512 + 2048
    np.testing.assert_allclose(got[lo:], off[lo:], atol=2e-4)


def test_net_streaming_raises_and_other_backends_get_none(wm):
    """The DSP backend streams through StreamingWatermarker; an unknown
    backend gets None from both dispatchers (the caller marks ≥ 4 s groups),
    and the network's embedder refuses anything but a NetWatermarker (the
    network's own streaming: tests/test_torch_silentcipher.py)."""
    assert isinstance(stream.make_streaming_watermarker(wm, CSM_1B_WATERMARK, 24_000),
                      stream.StreamingWatermarker)
    assert stream.make_streaming_watermarker(object(), CSM_1B_WATERMARK, 24_000) is None
    assert stream.make_streaming_net_watermarker(object(), CSM_1B_WATERMARK, 24_000) is None
    assert stream.make_streaming_net_watermarker(wm, CSM_1B_WATERMARK, 24_000) is None
    with pytest.raises(TypeError, match="NetWatermarker"):
        stream.StreamingNetEmbedder(object(), CSM_1B_WATERMARK)
