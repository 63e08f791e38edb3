"""The port's Generator, end to end at the tiny f32 flavor, against the JAX
package's ``Generator`` fed the same weights: greedy frames are equal and
the PCM agrees.  In the port: stream == offline, the seeded frames do not
depend on the chunk schedule, and a cached voice context equals the same
context passed inline."""

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.runtime.loader import build_generator as j_build
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.runtime.frames import Segment
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

# f32 PCM, relative to its peak (see tests/test_torch_mimi.py)
PCM_RTOL = 1e-5
TEXT = "the quick brown fox jumps over the lazy dog"


@pytest.fixture(scope="module")
def pair():
    jg = j_build(j_tiny_spec(), decode_chunk_frames=4, offline_chunk_frames=4)
    csm = from_jax_params(jax.tree.map(np.asarray, jg._params))
    mimi = from_jax_params(jax.tree.map(np.asarray, jg._mimi_params))

    def port(decode_chunk_frames=4):
        return Generator(csm, csm_test_tiny(), Mimi(mimi_test_tiny()), mimi, TinyHashTokenizer(),
                         decode_chunk_frames=decode_chunk_frames, device="cpu")

    return jg, port


def _close_pcm(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_RTOL * np.abs(want).max())


def test_greedy_frames_and_pcm_equal_jax(pair):
    jg, port = pair
    tg = port()
    kw = dict(max_audio_length_ms=960, temperature=1.0, topk=1)
    want = jg.generate_frames(TEXT, 0, [], seed=0, **kw)
    got = tg.generate_frames(TEXT, 0, [], **kw)
    assert got.dtype == np.int32 and got.shape[1] == 8
    np.testing.assert_array_equal(got, want)
    _close_pcm(tg.generate(TEXT, 0, [], **kw), jg.generate(TEXT, 0, [], seed=0, **kw))


def test_greedy_frames_with_voice_context_equal_jax(pair):
    jg, port = pair
    tg = port()
    audio = np.sin(np.arange(3 * 1920) / 7.0).astype(np.float32) * 0.3
    kw = dict(max_audio_length_ms=480, temperature=1.0, topk=1)
    want = jg.generate_frames("next", 1, [_j_segment(0, TEXT, audio)], seed=0, **kw)
    got = tg.generate_frames("next", 1, [Segment(0, TEXT, audio)], **kw)
    np.testing.assert_array_equal(got, want)


def _j_segment(speaker, text, audio):
    from sesameai_tts_tpu.runtime.frames import Segment as JSegment

    return JSegment(speaker, text, audio)


def test_stream_equals_offline(pair):
    _, port = pair
    tg = port()
    kw = dict(max_audio_length_ms=800, temperature=0.9, topk=5, seed=3)
    offline = tg.generate(TEXT, 0, [], **kw)
    chunks = list(tg.generate_stream(TEXT, 0, [], chunk_frames=2, decode_chunk_frames=3, **kw))
    assert len(chunks[0]) == tg._hop and all(len(c) <= 2 * tg._hop for c in chunks[1:])
    _close_pcm(np.concatenate(chunks), offline)


def test_seeded_frames_do_not_depend_on_the_chunk_schedule(pair):
    _, port = pair
    kw = dict(max_audio_length_ms=1200, temperature=0.9, topk=5, seed=11)
    a = port(decode_chunk_frames=2).generate_frames(TEXT, 0, [], **kw)
    b = port(decode_chunk_frames=5).generate_frames(TEXT, 0, [], **kw)
    np.testing.assert_array_equal(a, b)
    c = port(decode_chunk_frames=5).generate_frames(TEXT, 0, [], **{**kw, "seed": 12})
    assert not np.array_equal(a, c)


def test_cached_context_equals_inline_and_is_not_consumed(pair):
    _, port = pair
    tg = port()
    audio = tg.generate("hello there", 0, [], max_audio_length_ms=400, temperature=0.9,
                        topk=5, seed=1)
    ctx = [Segment(0, "hello there", audio)]
    cached = tg.precompute_context_state(ctx)
    snapshot = [t.clone() for t in cached[0].cache.k]
    kw = dict(max_audio_length_ms=480, temperature=0.9, topk=5, seed=2)
    inline = tg.generate_frames("and more", 1, ctx, **kw)
    first = tg.generate_frames("and more", 1, [], cached_context=cached, **kw)
    again = tg.generate_frames("and more", 1, [], cached_context=cached, **kw)
    np.testing.assert_array_equal(first, inline)
    np.testing.assert_array_equal(again, inline)
    assert all(torch.equal(a, b) for a, b in zip(snapshot, cached[0].cache.k))


def test_budget_and_length_guards(pair):
    _, port = pair
    tg = port()
    frames = tg.generate_frames(TEXT, 0, [], max_audio_length_ms=320, temperature=0.9, topk=5)
    assert 1 <= frames.shape[0] <= 4
    with pytest.raises(ValueError, match="Inputs too long"):
        tg.generate_frames("word " * 300, 0, [], max_audio_length_ms=320)
