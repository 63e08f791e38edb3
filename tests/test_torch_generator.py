"""The port's Generator, end to end at the tiny f32 flavor, against the JAX
package's ``Generator`` fed the same weights: greedy frames are equal and
the PCM agrees, also after ``warmup`` and from a ``clone``.  In the port:
stream == offline, the seeded frames do not depend on the chunk schedule,
a cached voice context equals the same context passed inline, requests
with other sampling parameters on one Generator equal fresh Generators',
and the static decode state serves one request at a time."""

import threading

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


GREEDY = dict(max_audio_length_ms=960, temperature=1.0, topk=1)


def test_requests_with_other_sampling_on_one_generator_equal_fresh_ones(pair):
    """The static buffers hold one request's temperature and topk at a time:
    two requests with other values, one after the other on one Generator,
    give what each gives on a fresh Generator."""
    _, port = pair
    tg = port()
    kw = dict(max_audio_length_ms=800)
    first = tg.generate_frames(TEXT, 0, [], temperature=0.9, topk=5, seed=3, **kw)
    second = tg.generate_frames(TEXT, 0, [], temperature=0.6, topk=20, seed=4, **kw)
    np.testing.assert_array_equal(
        first, port().generate_frames(TEXT, 0, [], temperature=0.9, topk=5, seed=3, **kw))
    np.testing.assert_array_equal(
        second, port().generate_frames(TEXT, 0, [], temperature=0.6, topk=20, seed=4, **kw))


def test_warmup_returns_its_steps_and_keeps_greedy_output(pair):
    jg, port = pair
    tg = port()
    times = tg.warmup(serving_batch=2, encode_buckets=(4,))
    buckets = [b for b in tg._prefill_buckets if b <= tg.max_seq_len]
    assert set(times) == {f"prefill_{b}" for b in buckets} | {"first_chunk", "mimi_encode_4"}
    assert all(t >= 0 for t in times.values())
    assert set(tg._slots) == {1, 2}  # the static states of both batch sizes
    want = jg.generate_frames(TEXT, 0, [], seed=0, **GREEDY)
    np.testing.assert_array_equal(tg.generate_frames(TEXT, 0, [], **GREEDY), want)


def test_clone_shares_the_weights_and_has_its_own_state(pair):
    jg, port = pair
    tg = port()
    clone = tg.clone(decode_chunk_frames=2, seed=3)
    for name in ("_params", "_prefill_params", "_mimi_params"):
        a, b = getattr(tg, name), getattr(clone, name)
        leaves_a, leaves_b = jax.tree.leaves(a), jax.tree.leaves(b)
        assert [t.data_ptr() for t in leaves_a] == [t.data_ptr() for t in leaves_b]
    assert clone.metrics is not tg.metrics and clone._slots is not tg._slots
    assert (clone._decode_chunk_frames, tg._decode_chunk_frames) == (2, 4)
    # unseeded requests draw their seeds from the clone's own seed
    assert clone._utterance_seed(None) == int(np.random.default_rng(3).integers(2**63))
    want = jg.generate_frames(TEXT, 0, [], seed=0, **GREEDY)
    np.testing.assert_array_equal(clone.generate_frames(TEXT, 0, [], **GREEDY), want)
    assert clone.metrics.summary()["prefill_s"]["count"] == 1
    assert "prefill_s" not in tg.metrics.summary()
    np.testing.assert_array_equal(tg.generate_frames(TEXT, 0, [], **GREEDY), want)


def test_one_request_at_a_time_per_generator(pair):
    """A stream holds the static state until it ends or is closed: another
    request from the same thread raises, one from another thread waits."""
    _, port = pair
    tg = port()
    kw = dict(max_audio_length_ms=480, temperature=0.9, topk=5)
    want = {seed: tg.generate_frames(TEXT, 0, [], seed=seed, **kw) for seed in range(3)}
    stream = tg.generate_stream(TEXT, 0, [], seed=0, **kw)
    next(stream)
    with pytest.raises(RuntimeError, match="clone"):
        tg.generate_frames(TEXT, 0, [], seed=1, **kw)
    stream.close()
    np.testing.assert_array_equal(tg.generate_frames(TEXT, 0, [], seed=1, **kw), want[1])

    got, errors = {}, []

    def request(seed):
        try:
            got[seed] = tg.generate_frames(TEXT, 0, [], seed=seed, **kw)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=request, args=(seed,)) for seed in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for seed in range(3):
        np.testing.assert_array_equal(got[seed], want[seed])
