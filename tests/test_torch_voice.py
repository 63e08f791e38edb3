"""The port's voice-preload path against the JAX package on the CPU, on a
voice directory the test writes: WAV I/O and resampling of 44.1 kHz stereo
clips, the voice registry (directory, JSON, module), ``_fit_context``,
``RollingContext``, and ``prepare_voice_context`` on tiny generators built
from one parameter tree, whose cached contexts give bit-equal greedy
frames."""

import json

import jax
import numpy as np
import pytest

from sesameai_tts_tpu.audio import io as j_io
from sesameai_tts_tpu.audio.resample import resample as j_resample
from sesameai_tts_tpu.runtime.context import RollingContext as JRollingContext
from sesameai_tts_tpu.runtime.loader import build_generator as j_build
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu.service import tts as j_tts
from sesameai_tts_tpu.service.voices import load_registry as j_load_registry
from sesameai_tts_tpu_torch.audio import io as t_io
from sesameai_tts_tpu_torch.audio.resample import resample
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.runtime.context import RollingContext
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.service import tts as t_tts
from sesameai_tts_tpu_torch.service.voices import load_registry
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

RATE = 44_100


def _clip(rng, seconds):
    """(2, T) stereo: a few harmonics under a slow envelope, plus noise."""
    t = np.arange(int(seconds * RATE)) / RATE
    f0 = rng.uniform(100, 220)
    tone = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    left = 0.3 * env * tone + 0.02 * rng.standard_normal(t.size)
    return np.stack([left, 0.8 * left]).astype(np.float32)


@pytest.fixture(scope="module")
def voice_dir(tmp_path_factory):
    """<root>/<voice>/clip*.wav + .txt: "short" fits the tiny context
    budget, "long" has a clip past the tiny codec window."""
    root = tmp_path_factory.mktemp("voices")
    rng = np.random.default_rng(0)
    for voice, clips in (("short", [(0.1, "hello there"), (0.06, "a second clip")]),
                         ("long", [(0.6, "one long reference clip")])):
        vdir = root / voice
        vdir.mkdir()
        for i, (seconds, text) in enumerate(clips):
            t_io.write_wav(str(vdir / f"clip{i}.wav"), _clip(rng, seconds), RATE)
            (vdir / f"clip{i}.txt").write_text(text)
    return root


def test_wav_io_and_resample_match_jax(voice_dir, tmp_path):
    path = str(voice_dir / "short" / "clip0.wav")
    for fn in ("read_wav", "read_wav_mono"):
        got, rate = getattr(t_io, fn)(path)
        want, want_rate = getattr(j_io, fn)(path)
        assert rate == want_rate == RATE and np.array_equal(got, want)
    mono, rate = t_io.read_wav_mono(path, 24_000)
    assert rate == 24_000 and mono.shape == (2400,)
    assert np.array_equal(mono, j_io.read_wav_mono(path, 24_000)[0])
    x = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
    for a, b in ((44_100, 24_000), (24_000, 44_100), (16_000, 24_000)):
        assert np.array_equal(resample(x, a, b), j_resample(x, a, b))
    # written by the port, read by the JAX package; the streaming header
    out = str(tmp_path / "out.wav")
    t_io.write_wav(out, mono, 24_000)
    assert np.array_equal(j_io.read_wav(out)[0], t_io.read_wav(out)[0])
    assert t_io.streaming_wav_header(24_000) == j_io.streaming_wav_header(24_000)


def test_registry_matches_jax(voice_dir, tmp_path):
    reg = load_registry(str(voice_dir))
    assert sorted(reg) == ["long", "short"] and len(reg["short"]) == 2
    assert reg == j_load_registry(str(voice_dir))
    rel = {"v": {f"short/{p.rsplit('/', 1)[1]}": t for p, t in reg["short"].items()}}
    reg_json = voice_dir / "voices.json"
    reg_json.write_text(json.dumps(rel))
    assert load_registry(str(reg_json)) == j_load_registry(str(reg_json)) == {"v": reg["short"]}
    module = voice_dir / "samples.py"
    module.write_text(f"SPEAKERS = {{'a': 1}}\nV = {rel['v']!r}\n")
    assert load_registry(str(module)) == j_load_registry(str(module)) == {"V": reg["short"]}


@pytest.mark.parametrize("budget", [300, 190, 60])
def test_fit_context_matches_jax(budget):
    def seg(n, tag):
        return np.full((n, 9), tag, np.int32), np.ones((n, 9), bool)

    segs = [seg(50, 1), seg(80, 2), seg(100, 3)]
    got, rows, trimmed = t_tts._fit_context(segs, budget)
    want, want_rows, want_trimmed = j_tts._fit_context(segs, budget)
    assert (rows, trimmed) == (want_rows, want_trimmed)
    assert len(got) == len(want)
    for (t, m), (wt, wm) in zip(got, want):
        assert np.array_equal(t, wt) and np.array_equal(m, wm)


def test_rolling_context_matches_jax():
    def pair(n, tag):
        return np.full((n, 5), tag, np.int32), np.ones((n, 5), bool)

    ours, theirs = RollingContext(max_positions=256), JRollingContext(max_positions=256)
    assert ours.budget == theirs.budget == 96  # 256 - 128 generation - 32 text
    steps = [("pin_prefix", ([pair(30, 1)],), {}), ("append", (pair(20, 2),), {}),
             ("append", (pair(25, 3),), {}), ("append", (pair(30, 4),), {}),
             ("append", (pair(90, 5),), {"oversize": "trim"})]
    for name, args, kw in steps:
        getattr(ours, name)(*args, **kw)
        getattr(theirs, name)(*args, **kw)
        assert (ours.prefix_rows, ours.window_rows, ours.total_rows) == (
            theirs.prefix_rows, theirs.window_rows, theirs.total_rows)
        assert [t[:, 0].tolist() for t, _ in ours.pairs()] == [
            t[:, 0].tolist() for t, _ in theirs.pairs()]
    assert ours.total_rows == 96 and ours.window_rows == 66  # tail of the oversize turn
    for ctx in (ours, theirs):
        with pytest.raises(ValueError, match="budget"):
            ctx.append(pair(90, 6))
        with pytest.raises(ValueError, match="prefix"):
            ctx.pin_prefix([pair(97, 7)])


@pytest.fixture(scope="module")
def generators():
    jg = j_build(j_tiny_spec(), decode_chunk_frames=4, offline_chunk_frames=4)
    csm = from_jax_params(jax.tree.map(np.asarray, jg._params))
    mimi = from_jax_params(jax.tree.map(np.asarray, jg._mimi_params))
    tg = Generator(csm, csm_test_tiny(), Mimi(mimi_test_tiny()), mimi, TinyHashTokenizer(),
                   decode_chunk_frames=4, device="cpu")
    return jg, tg


def test_generator_budgets_match_jax(generators):
    jg, tg = generators
    for name in ("max_seq_len", "context_budget", "max_clip_samples"):
        assert getattr(tg, name) == getattr(jg, name)
    assert tg.max_clip_samples < 0.6 * 24_000  # the "long" clip is trimmed


@pytest.mark.parametrize("voice", ["short", "long"])
def test_prepare_voice_context_matches_jax(generators, voice_dir, voice):
    jg, tg = generators
    clips = load_registry(str(voice_dir))[voice]
    got, rows, trimmed = t_tts.prepare_voice_context(tg, clips, voice)
    want, want_rows, want_trimmed = j_tts.prepare_voice_context(jg, clips, voice)
    assert (rows, trimmed) == (want_rows, want_trimmed) == (
        (rows, False) if voice == "short" else (tg.context_budget, True))
    assert len(got) == len(want)
    for (t, m), (wt, wm) in zip(got, want):
        assert np.array_equal(t, np.asarray(wt)) and np.array_equal(m, np.asarray(wm))
    if voice == "short":  # greedy frames from the cached voice context
        kw = dict(max_audio_length_ms=480, temperature=1.0, topk=1)
        frames = tg.generate_frames("next words", 0, [],
                                    cached_context=tg.precompute_context_state(got), **kw)
        want_frames = jg.generate_frames("next words", 0, [], seed=0,
                                         cached_context=jg.precompute_context_state(want), **kw)
        assert frames.shape[0] >= 1
        np.testing.assert_array_equal(frames, want_frames)
