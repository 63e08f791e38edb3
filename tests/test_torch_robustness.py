"""The robustness tier (``tests/test_robustness.py``) and the service
layer's seed check (``tests/test_golden.py::
test_seed_repeatable_via_service_layer``) on the port, on the CPU at the
tiny flavors: the watermark under channel changes, the tokenizers on
unicode, the Generator on degenerate inputs, Mimi at its edges, and a seeded
``TTS.export_wav``.  Each case checks what its JAX twin checks: a property
of the port's output, or the port against the same reference (the
``tokenizers`` library for the native BPE)."""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from sesameai_tts_tpu_torch.audio.io import read_wav
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.runtime.loader import build_generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.service.tts import TTS
from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK, load_watermarker, verify
from sesameai_tts_tpu_torch.watermark.dsp import WATERMARK_RATE

TEXT = "The quick brown fox jumps over the lazy dog."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # eager CPU decode under several pytest workers waits on OpenMP threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _speechlike(seconds, rate, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = lfilter([1.0], [1.0, -0.95], rng.normal(size=n)).astype(np.float32)
    t = np.arange(n) / rate
    x *= (0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


# -- the watermark under channel changes -------------------------------------------


@pytest.fixture(scope="module")
def marked():
    wm = load_watermarker(device="cpu")
    audio = _speechlike(3.0, WATERMARK_RATE, seed=42)
    enc, _ = wm.encode_wav(audio, WATERMARK_RATE, CSM_1B_WATERMARK, message_sdr=30.0)
    return wm, enc


def test_watermark_survives_gain_change(marked):
    wm, enc = marked
    assert verify(wm, enc * 0.3, WATERMARK_RATE, CSM_1B_WATERMARK)
    assert verify(wm, np.clip(enc * 2.0, -1, 1), WATERMARK_RATE, CSM_1B_WATERMARK)


def test_watermark_survives_16bit_quantization(marked):
    wm, enc = marked
    pcm = np.round(np.clip(enc, -1, 1) * 32767) / 32767
    assert verify(wm, pcm.astype(np.float32), WATERMARK_RATE, CSM_1B_WATERMARK)


@pytest.mark.parametrize("trim_s", [0.0, 0.5, 1.33])
def test_watermark_survives_trimming(marked, trim_s):
    """A leading trim moves the chip-block grid; the decoder's offset search
    finds it again."""
    wm, enc = marked
    assert verify(wm, enc[int(trim_s * WATERMARK_RATE):], WATERMARK_RATE, CSM_1B_WATERMARK)


def test_watermark_rejects_noise(marked):
    wm, _ = marked
    noise = np.random.default_rng(9).normal(size=3 * WATERMARK_RATE).astype(np.float32)
    assert not verify(wm, noise * 0.1, WATERMARK_RATE, CSM_1B_WATERMARK)


# -- the tokenizers on unicode -----------------------------------------------------


@pytest.mark.parametrize("text", ["héllo wörld", "日本語テスト", "emoji 🎤 test",
                                  "mixed ASCII+日本"])
def test_byte_tokenizer_unicode_roundtrip(text):
    from sesameai_tts_tpu_torch.tokenizer.text import ByteTokenizer

    t = ByteTokenizer()
    assert t.decode(t.encode(text)) == text


def test_native_bpe_unicode_matches_rust(tmp_path):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    from sesameai_tts_tpu_torch.tokenizer.native_bpe import NativeBPETokenizer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=380,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(["héllo wörld 日本語 🎤 test"] * 30, trainer)
    path = str(tmp_path / "tok.json")
    tok.save(path)
    native = NativeBPETokenizer(path)
    for text in ["héllo wörld", "日本語", "🎤 emoji", "unseen ünïcode"]:
        assert native.encode(text)[1:-1] == tok.encode(text, add_special_tokens=False).ids, text


# -- the Generator on degenerate inputs --------------------------------------------


@pytest.fixture(scope="module")
def gen():
    return build_generator(tiny_spec(), device="cpu", decode_chunk_frames=4)


def test_empty_text_still_generates(gen):
    audio = gen.generate("", 1, [], max_audio_length_ms=240, temperature=0.8, topk=5)
    assert audio.dtype == np.float32  # the BOS / EOS rows alone are a prompt


def test_zero_budget(gen):
    audio = gen.generate("hi", 1, [], max_audio_length_ms=80, temperature=0.8, topk=5)
    assert audio.shape[0] <= gen._mimi.cfg.hop_length  # at most the prefill frame


def test_negative_speaker_id(gen):
    audio = gen.generate("speaker test", -1, [], max_audio_length_ms=240, temperature=0.8,
                         topk=5)
    assert audio.dtype == np.float32


# -- Mimi at its edges -------------------------------------------------------------


@pytest.fixture(scope="module")
def mimi():
    m = Mimi(mimi_test_tiny())
    return m, m.init(torch.Generator().manual_seed(0))


def test_mimi_silence_roundtrip(mimi):
    m, params = mimi
    hop = m.cfg.hop_length
    codes = m.encode(params, torch.zeros((1, 1, 4 * hop)))
    out = m.decode(params, codes)
    assert out.shape == (1, 1, 4 * hop)
    assert torch.isfinite(out).all()


def test_mimi_single_frame(mimi):
    m, params = mimi
    out = m.decode(params, torch.ones((1, m.cfg.num_codebooks, 1), dtype=torch.int64))
    assert out.shape == (1, 1, m.cfg.hop_length)
    assert torch.isfinite(out).all()


# -- the service layer's seed --------------------------------------------------------


def test_seed_repeatable_via_service_layer(tmp_path):
    tts = TTS(spec=tiny_spec(), enable_watermark=False, device="cpu")
    tts.load_model()
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    tts.export_wav(TEXT, a, seed=7)
    tts.export_wav(TEXT, b, seed=7)
    wa, _ = read_wav(a)
    wb, _ = read_wav(b)
    np.testing.assert_array_equal(wa, wb)
    tts.export_wav(TEXT, b, seed=8)
    wc, _ = read_wav(b)
    assert wa.shape != wc.shape or np.max(np.abs(wa - wc)) > 0
