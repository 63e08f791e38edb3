"""The port's service path (``service/tts.py`` ``TTS``, ``service/cli.py``,
``audio/segment.py``, ``utils/text.py``, ``runtime/streaming.py``)
against the JAX package at the tiny f32 flavor.

Both ``TTS`` engines get Generators over one parameter tree (the JAX
package draws it, the port converts it).  Greedy ``generate_with_context``
with and without a voice agrees within the Generator tests' PCM tolerance,
before and after the watermark; ``export_wav`` and ``say`` give clips of
the same count and lengths; the streaming writer writes the streamed
chunks; and the CLI runs on the CPU when asked, writes a 24 kHz WAV, and
raises without a card otherwise."""

import os

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.audio import segment as j_segment
from sesameai_tts_tpu.runtime import streaming as j_streaming
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu.service import tts as j_tts
from sesameai_tts_tpu.watermark import api as j_api
from sesameai_tts_tpu.utils import text as j_text
from sesameai_tts_tpu_torch.audio import segment
from sesameai_tts_tpu_torch.audio.io import read_wav, read_wav_mono, write_wav
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.runtime import streaming
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.service import cli
from sesameai_tts_tpu_torch.service import tts as t_tts
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer
from sesameai_tts_tpu_torch.utils import text
from sesameai_tts_tpu_torch.watermark import api as wm_api

# f32 PCM relative to its peak, as tests/test_torch_generator.py
PCM_RTOL = 1e-5
GREEDY = dict(temperature=1.0, topk=1)
# 75 frames of the tiny codec (48 samples each): 0.15 s at 24 kHz, long
# enough for the watermark to mark interior STFT frames
AUDIO_MS = 6_000
TEXTS = [
    "**bold** and `code` and [link](http://x) <b>tag</b>",
    "em—dash, wow!!! and well-known ... words",
    "First one. Second two! Third three? trailing",
    "  Spaced   out.\n\nNew paragraph?  Yes!  ",
    "Numbers 3.14 and e.g. abbreviations. Done.",
]


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


def _close_pcm(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_RTOL * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def voice_dir(tmp_path_factory):
    """One voice of two short 24 kHz clips with transcripts."""
    root = tmp_path_factory.mktemp("voices")
    vdir = root / "testvoice"
    vdir.mkdir()
    rng = np.random.default_rng(0)
    for i, words in enumerate(["hello there", "a second clip"]):
        write_wav(str(vdir / f"clip{i}.wav"), (rng.normal(size=4800) * 0.1).astype(np.float32),
                  24_000)
        (vdir / f"clip{i}.txt").write_text(words)
    return str(root)


@pytest.fixture(scope="module")
def engines(voice_dir):
    """(JAX TTS, port TTS) over one tiny parameter tree, voice loaded,
    watermark on."""
    jt = j_tts.TTS(spec=j_tiny_spec(), voices=voice_dir)
    jt.load_model()
    jg = jt.generator
    tt = t_tts.TTS(spec=tiny_spec(), voices=voice_dir, device="cpu")
    tt.generator = Generator(from_jax_params(jax.tree.map(np.asarray, jg._params)),
                             csm_test_tiny(), Mimi(mimi_test_tiny()),
                             from_jax_params(jax.tree.map(np.asarray, jg._mimi_params)),
                             TinyHashTokenizer(), decode_chunk_frames=4, device="cpu")
    tt.watermarker = wm_api.load_watermarker(device="cpu")
    for e in (jt, tt):
        e.load_voice("testvoice", warmup=False)
    return jt, tt


def _generate(engine, voice: bool, marked: bool, prompt="the quick brown fox jumps"):
    saved = engine.cached_context, engine.cached_segments, engine.enable_watermark
    try:
        if not voice:
            engine.cached_context, engine.cached_segments = None, []
        engine.enable_watermark = marked
        return engine.generate_with_context(prompt, max_audio_length_ms=AUDIO_MS, seed=0,
                                            **GREEDY)
    finally:
        engine.cached_context, engine.cached_segments, engine.enable_watermark = saved


@pytest.mark.parametrize("voice", [False, True])
def test_generate_with_context_equals_jax(engines, voice):
    """Unmarked, the port's PCM is the JAX package's within PCM_RTOL.  The
    watermark stage is then held on its own: the port's marked output is
    the JAX package's ``watermark`` of the port's unmarked PCM.  (Marking
    the two unmarked PCMs and comparing would amplify their 1e-6
    differences ~1e4-fold in the first samples, where the reference's
    overlap-add divides by Σ win² ≈ 1e-8; ``test_torch_watermark.py``
    holds the embed itself.)"""
    jt, tt = engines
    want = _generate(jt, voice, marked=False)
    got = _generate(tt, voice, marked=False)
    assert got.dtype == np.float32 and got.size > 0
    _close_pcm(got, want)
    marked = _generate(tt, voice, marked=True)
    j_marked, rate = j_api.watermark(jt.watermarker, got, 24_000, tt.watermark_key)
    assert rate == 24_000
    _close_pcm(marked, j_marked)
    n = min(marked.size, got.size)  # the 24 → 44.1 → 24 kHz trip may add a sample
    assert np.abs(marked[:n] - got[:n]).max() > 1e-4  # a mark was embedded


def test_export_wav_and_say_match_jax(engines, tmp_path):
    jt, tt = engines
    words = "One sentence. Two sentences! And a third?"
    kw = dict(seed=0, max_audio_length_ms=AUDIO_MS // 3, **GREEDY)
    clips = tt.export_wav(words, str(tmp_path / "port.wav"), **kw)
    jt.export_wav(words, str(tmp_path / "jax.wav"), **kw)
    said = tt.say(words, output_filename=str(tmp_path / "say.wav"), play=False, **kw)
    j_said = jt.say(words, output_filename=None, play=False, **kw)
    assert len(clips) == len(said) == len(j_said) == 3
    assert [len(c.samples) for c in clips] == [len(c.samples) for c in said] == \
        [len(c.samples) for c in j_said]
    port_wav, rate = read_wav_mono(str(tmp_path / "port.wav"))
    jax_wav, _ = read_wav_mono(str(tmp_path / "jax.wav"))
    assert rate == 24_000 and port_wav.shape == jax_wav.shape
    assert len(port_wav) == sum(len(c.samples) for c in clips)
    assert tt.fallbacks == 0


def test_export_wav_fallback_is_counted(engines, tmp_path, monkeypatch):
    _, tt = engines

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(tt, "generate_audio_segment", broken)
    before = tt.fallbacks
    clips = tt.export_wav("Fails here.", str(tmp_path / "f.wav"), max_retries=1)
    assert tt.fallbacks == before + 1 and len(clips) == 1
    assert not clips[0].samples.any() and len(clips[0]) == 1000


def test_generate_tts_audio_helper(engines):
    _, tt = engines
    path = text.generate_tts_audio("One short sentence.", tt, temperature=1.0, top_k=1)
    assert path is not None and os.path.exists(path)
    audio, rate = read_wav_mono(path)
    assert rate == 24_000 and len(audio) > 0
    os.remove(path)
    assert text.generate_tts_audio("", tt) is None


def test_streaming_audio_file_matches_stream(engines, tmp_path):
    jt, tt = engines
    gen = tt.generator
    out = str(tmp_path / "stream.wav")
    kw = dict(max_audio_length_ms=1200, chunk_frames=2, **GREEDY)
    n = streaming.generate_streaming_audio(gen, "streaming to a file", 1, [], out, **kw)
    chunks = list(gen.generate_stream("streaming to a file", 1, [], chunk_frames=2,
                                      max_audio_length_ms=1200, seed=0, **GREEDY))
    writer = streaming.AudioStreamWriter(str(tmp_path / "writer.wav"), gen.sample_rate)
    for c in chunks:
        writer.add_chunk(c)
    writer.write_file()
    assert n == len(chunks) > 0
    got, rate = read_wav(out)
    want, _ = read_wav(str(tmp_path / "writer.wav"))
    assert rate == 24_000 and np.array_equal(got, want)
    j_out = str(tmp_path / "jax.wav")
    assert j_streaming.generate_streaming_audio(jt.generator, "streaming to a file", 1, [],
                                                j_out, **kw) == n
    j_got, _ = read_wav(j_out)
    assert np.abs(j_got - got).max() <= 1.0 / 32767  # one 16-bit step


def test_audio_stream_writer_empty_noop(tmp_path):
    p = str(tmp_path / "never.wav")
    streaming.AudioStreamWriter(p, 24_000).write_file()
    assert not os.path.exists(p)


def test_audio_clip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=12_345) * 0.3).astype(np.float32)
    y = (rng.normal(size=777) * 0.2).astype(np.float32)
    for mod in (segment, j_segment):
        assert mod.AudioClip.silent(125, 24_000).samples.shape == (3000,)

    def ops(mod):
        a = mod.AudioClip.from_float(x, 24_000)
        b = mod.AudioClip.from_float(y, 24_000)
        return [a.normalize(0.9), a.fade_in(50), a.fade_out(80), a.pad(500, 100), a + b,
                mod.AudioClip.concat([a, b, a]), a.speedup(1.3), a.speedup(1.0)]

    for got, want in zip(ops(segment), ops(j_segment)):
        assert got.sample_rate == want.sample_rate and len(got) == len(want)
        assert got.duration_seconds == want.duration_seconds
        np.testing.assert_array_equal(got.samples, want.samples)
    a = segment.AudioClip.from_float(x, 24_000)
    np.testing.assert_array_equal(a.to_int16(), j_segment.AudioClip.from_float(x, 24_000)
                                  .to_int16())
    a.export(str(tmp_path / "a.wav"))
    j_segment.AudioClip.from_float(x, 24_000).export(str(tmp_path / "j.wav"))
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("s", TEXTS)
def test_text_utils_match_jax(s):
    assert text.clean_text_for_tts(s) == j_text.clean_text_for_tts(s)
    assert text.split_sentences(s) == j_text.split_sentences(s)
    assert text.split_clean_sentences(s) == j_text.split_clean_sentences(s)


@pytest.mark.parametrize("marked", [True, False])
def test_cli_on_cpu_writes_a_24khz_wav(tmp_path, voice_dir, marked):
    """Marked: with a voice (loaded and warmed up); unmarked: no voice."""
    out = tmp_path / "cli.wav"
    flags = ["--voices", voice_dir, "-v", "testvoice"] if marked else ["--no-watermark"]
    cli.main(["-d", "cpu", "--flavor", "test-tiny", "--topk", "5", "--seed", "0",
              "--max-ms", "1600", "--output", str(out), "hello from the cli. A second one."]
             + flags)
    audio, rate = read_wav(str(out))
    assert rate == 24_000 and audio.shape[0] == 1
    assert float(np.sqrt(np.mean(audio ** 2))) > 0


def test_cli_no_watermark_needs_the_tiny_flavor(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--no-watermark", "-d", "cpu", "hello"])
    assert "test-tiny" in capsys.readouterr().err


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--flavor", "test-tiny", "--output", str(tmp_path / "x.wav"), "hello"])
