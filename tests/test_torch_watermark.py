"""The port's DSP watermark (``watermark/dsp.py``, ``watermark/api.py``)
against the JAX package's on the same seeded signals: the marked audio
agrees within 1e-4 of the signal's peak, each package verifies the
other's marks with confidences within 1e-2, a wrong key and unmarked
audio are rejected, the file checker round-trips, and a silentcipher
checkpoint raises instead of falling back."""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from sesameai_tts_tpu.watermark import api as j_api
from sesameai_tts_tpu.watermark import dsp as j_dsp
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.watermark import api, dsp

KEY = dsp.CSM_1B_WATERMARK
RATE = dsp.WATERMARK_RATE
# the same f32 arithmetic (on the CPU both packages' FFTs are pocketfft):
# measured bit-equal on the CPU, so 1e-4 of the peak leaves room for
# rounding only
EMBED_ATOL_OF_PEAK = 1e-4
# z-scored correlations from rounding-level different residuals
CONF_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU work here is many small ops: with several test
    workers sharing the cores, torch's intra-op threads mostly wait on each
    other (on an 8-core host with six workers, a tiny decode ran ~50x slower
    at 8 threads than at 1), so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(seconds: float, rate: int, seed=0) -> np.ndarray:
    """Colored noise with a syllable-rate envelope (as tests/test_watermark.py)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = lfilter([1.0], [1.0, -0.95], rng.normal(size=n).astype(np.float32)).astype(np.float32)
    t = np.arange(n) / rate
    x = x * (0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


@pytest.fixture(scope="module")
def wms():
    return j_dsp.load_watermarker(), dsp.load_watermarker(device="cpu")


@pytest.fixture(scope="module")
def marked(wms):
    jw, tw = wms
    x = _speechlike(3.0, RATE)
    return x, jw.encode_wav(x, RATE, KEY)[0], tw.encode_wav(x, RATE, KEY)[0]


def test_encode_matches_jax(marked):
    x, y_jax, y_port = marked
    assert y_port.shape == x.shape and y_port.dtype == np.float32
    err = float(np.abs(y_port - y_jax).max())
    assert err <= EMBED_ATOL_OF_PEAK * np.abs(x).max(), err
    assert np.abs(y_port - x).max() > 1e-3  # the mark is there


@pytest.mark.parametrize("decoder", ["jax", "port"])
def test_each_package_verifies_the_others_mark(wms, marked, decoder):
    jw, tw = wms
    _, y_jax, y_port = marked
    dec = jw if decoder == "jax" else tw
    other = y_port if decoder == "jax" else y_jax
    got = dec.decode_wav(other, RATE, phase_shift_decoding=True, expected_message=KEY)
    assert got["status"] and got["messages"] == [KEY], got["confidence"]
    # the same audio decoded by both packages
    want = jw.decode_wav(other, RATE, phase_shift_decoding=True, expected_message=KEY)
    mine = tw.decode_wav(other, RATE, phase_shift_decoding=True, expected_message=KEY)
    assert abs(mine["confidence"] - want["confidence"]) <= CONF_ATOL


def test_blind_decode_and_aligned_decode_match_jax(wms, marked):
    jw, tw = wms
    _, y_jax, _ = marked
    for kw in ({}, {"phase_shift_decoding": True}):
        want, got = jw.decode_wav(y_jax, RATE, **kw), tw.decode_wav(y_jax, RATE, **kw)
        assert got["status"] == want["status"] and got["messages"] == want["messages"]
        assert abs(got["confidence"] - want["confidence"]) <= CONF_ATOL


@pytest.mark.parametrize("direction", ["port_marks", "jax_marks"])
def test_watermark_verify_through_24k_both_ways(wms, direction):
    jw, tw = wms
    audio = _speechlike(3.0, 24_000, seed=11)
    if direction == "port_marks":
        out, rate = api.watermark(tw, audio, 24_000, KEY)
        want, _ = j_api.watermark(jw, audio, 24_000, KEY)
        assert np.abs(out - want).max() <= EMBED_ATOL_OF_PEAK * np.abs(audio).max()
        assert j_api.verify(jw, out, rate, KEY)
    else:
        out, rate = j_api.watermark(jw, audio, 24_000, KEY)
    assert rate == 24_000
    assert api.verify(tw, out, rate, KEY)


def test_wrong_key_and_unmarked_audio_rejected(wms):
    _, tw = wms
    x = _speechlike(3.0, RATE, seed=3)
    wrong, _ = tw.encode_wav(x, RATE, [1, 2, 3, 4, 5])
    assert not api.verify(tw, wrong, RATE, KEY)
    plain = _speechlike(3.0, RATE, seed=7)
    res = tw.decode_wav(plain, RATE, phase_shift_decoding=True, expected_message=KEY)
    assert not res["status"]


def test_check_audio_from_file_roundtrip(wms, tmp_path, capsys):
    _, tw = wms
    audio = _speechlike(4.0, 24_000, seed=21)
    marked, rate = api.watermark(tw, audio, 24_000, KEY)
    good, plain = tmp_path / "marked.wav", tmp_path / "plain.wav"
    write_wav(str(good), marked, rate)
    write_wav(str(plain), audio, 24_000)
    assert api.check_audio_from_file(str(good), device="cpu") is True
    assert api.check_audio_from_file(str(plain), device="cpu") is False
    api.cli_check_audio(["--audio_path", str(good), "-d", "cpu"])
    out = capsys.readouterr().out
    assert f"Watermarked: {good}" in out and f"Not watermarked: {plain}" in out


def test_silentcipher_checkpoint_raises(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="silentcipher"):
        api.load_watermarker(ckpt_path=str(tmp_path / "sc.pth"), device="cpu")
    monkeypatch.setenv("SILENTCIPHER_CKPT", str(tmp_path / "sc.pth"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.load_watermarker(device="cpu")


def test_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_watermarker()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.cli_check_audio(["--audio_path", "unused.wav"])
