"""Port CSM model vs ``sesameai_tts_tpu/models/csm.py`` at ``csm_test_tiny``
in f32: greedy ``generate_frame``, ``decode_frames`` and the static-buffer
``decode_step`` (what the Generator captures as CUDA graphs) give equal
frames, dense and int8-quantized, and teacher-forced codebook-0 logits
agree.  In the port: sampled frames depend only on (seed, frame index),
equal those of one ``generate_frame`` per frame, and do not change when
temperature and topk come as tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
from sesameai_tts_tpu.models import csm as jm
from sesameai_tts_tpu.ops.quant import quantize_csm as j_quantize
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny as t_tiny
from sesameai_tts_tpu_torch.models import csm as tm
from sesameai_tts_tpu_torch.models.transformer import KVCache, precompute_rope

# f32 logits: the same arithmetic summed in another order
RTOL = 1e-5
K = 8


@pytest.fixture(scope="module", params=["dense", "int8"])
def params(request):
    jp = jm.init_csm_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32)
    if request.param == "int8":
        jp = j_quantize(jp)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _prompt(B=2, S=7, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    tokens[:, :, K] = rng.integers(2, 128, (B, S))
    mask[:, :, K] = True
    tokens[:, -2:, :K] = rng.integers(1, 67, (B, 2, K))  # two audio rows
    mask[:, -2:, :K] = True
    return tokens, mask


def _prefill(jp, tp, valid=None):
    tokens, mask = _prompt()
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    tv = None if valid is None else torch.from_numpy(np.asarray(valid))
    jf, js = jm.generate_frame(jp, j_tiny(), jm.init_state(j_tiny(), 2, jnp.float32),
                               jnp.asarray(tokens), jnp.asarray(mask), jax.random.PRNGKey(0),
                               1.0, 1, valid_len=jv)
    tf, ts = tm.generate_frame(tp, t_tiny(), tm.init_state(t_tiny(), 2, torch.float32),
                               torch.from_numpy(tokens).long(), torch.from_numpy(mask), None,
                               1.0, 1, valid_len=tv)
    return (jf, js), (tf, ts)


def test_embed_frames_matches_jax(params):
    jp, tp = params
    tokens, mask = _prompt()
    want = jm.embed_frames(jp, j_tiny(), jnp.asarray(tokens), jnp.asarray(mask))
    got = tm.embed_frames(tp, t_tiny(), torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("valid", [None, [7, 4], [7, 0]])
def test_generate_frame_greedy_equals_jax(params, valid):
    jp, tp = params
    (jf, js), (tf, ts) = _prefill(jp, tp, valid)
    if valid is not None and 0 in valid:  # an idle row: only its shape is defined
        np.testing.assert_array_equal(tf.numpy()[0], np.asarray(jf)[0])
    else:
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))


def test_decode_frames_greedy_equals_jax(params):
    jp, tp = params
    (jf, js), (tf, ts) = _prefill(jp, tp)
    done = np.array([False, False])
    j_frames, j_valid, j_done, _ = jm.decode_frames(
        jp, j_tiny(), js, jf, jnp.asarray(done), jax.random.PRNGKey(1), 5, 1.0, 1, start_index=1
    )
    t_frames, t_valid, t_done, t_state = tm.decode_frames(
        tp, t_tiny(), ts, tf, torch.from_numpy(done), 123, 5, 1.0, 1, start_index=1
    )
    np.testing.assert_array_equal(t_frames.numpy(), np.asarray(j_frames))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    assert t_state.pos.tolist() == [12, 12]


def test_teacher_forced_eval_matches_jax(params):
    jp, tp = params
    (_, js), (_, ts) = _prefill(jp, tp)
    teacher = np.random.default_rng(5).integers(0, 67, (3, 2, K)).astype(np.int32)
    j_frames, j_logits = jm.teacher_forced_eval(jp, j_tiny(), js, jnp.asarray(teacher))
    t_frames, t_logits = tm.teacher_forced_eval(tp, t_tiny(), ts, torch.from_numpy(teacher).long())
    assert t_logits.dtype == torch.float32
    want = np.asarray(j_logits)
    np.testing.assert_allclose(t_logits.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    np.testing.assert_array_equal(t_frames.numpy(), np.asarray(j_frames))


def test_sampled_frames_depend_only_on_seed_and_index(params):
    """Frame i's noise is frame_generator(seed, i): chunking 6 frames as
    2+4 gives the frames of one chunk of 6."""
    _, tp = params
    cfg = t_tiny()

    def run(chunks):
        tf, ts = _prefill_port(tp)
        frame, done, out, start = tf, torch.zeros(2, dtype=torch.bool), [], 1
        for n in chunks:
            frames, _, done, ts = tm.decode_frames(tp, cfg, ts, frame, done, 9, n, 0.9, 5,
                                                   start_index=start)
            out.append(frames)
            frame, start = frames[-1], start + n
        return torch.cat(out)

    assert torch.equal(run([6]), run([2, 4]))


def _prefill_port(tp):
    tokens, mask = _prompt()
    return tm.generate_frame(tp, t_tiny(), tm.init_state(t_tiny(), 2, torch.float32),
                             torch.from_numpy(tokens).long(), torch.from_numpy(mask),
                             tm.frame_generator(9, 0, "cpu"), 0.9, 5)


def test_bf16_head_logits_stay_f32():
    h = torch.randn(2, 64).to(torch.bfloat16)
    head = torch.randn(64, 67).to(torch.bfloat16)
    got = tm._head_logits(h, head)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, h.double().matmul(head.double()).float(), rtol=1e-6, atol=1e-5)


def test_decode_step_on_static_buffers_greedy_equals_jax(params):
    """Five ``decode_step`` calls on one set of buffers give JAX
    ``decode_frames``' greedy frames, and advance the position in place.
    The decoder cache starts as garbage: each frame writes every position
    before causal attention reads it, so it is never zeroed."""
    jp, tp = params
    (jf, js), (tf, ts) = _prefill(jp, tp)
    j_frames, j_valid, j_done, _ = jm.decode_frames(
        jp, j_tiny(), js, jf, jnp.zeros((2,), bool), jax.random.PRNGKey(1), 5, 1.0, 1,
        start_index=1
    )
    cfg = t_tiny()
    bufs = tm.init_decode_buffers(tp, cfg, 2)
    garbage = torch.Generator().manual_seed(0)
    for t in bufs.dec_cache.k + bufs.dec_cache.v:
        t.copy_(torch.randn(t.shape, generator=garbage) * 1e3)
    bufs.frame.copy_(tf)
    rope = precompute_rope(cfg.backbone)
    frames, valid = [], []
    for _ in range(5):
        tm.decode_step(tp, cfg, ts, bufs, None, True, rope)
        frames.append(bufs.frame.clone())
        valid.append(bufs.valid.clone())
    np.testing.assert_array_equal(torch.stack(frames).numpy(), np.asarray(j_frames))
    np.testing.assert_array_equal(torch.stack(valid).numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(bufs.done.numpy(), np.asarray(j_done))
    assert ts.pos.tolist() == [12, 12]


def _copy(state):
    return tm.CSMState(KVCache([t.clone() for t in state.cache.k],
                               [t.clone() for t in state.cache.v]), state.pos.clone())


def test_sampled_frames_equal_one_generate_frame_per_frame(params):
    """``decode_frames`` (one generator reseeded per frame, static buffers)
    gives the frames of the path it replaced: ``generate_frame`` on each
    feedback row with a fresh ``frame_generator(seed, i)`` and a fresh
    decoder cache, the EOS masking written out."""
    _, tp = params
    cfg = t_tiny()
    tf, ts = _prefill_port(tp)
    state = _copy(ts)
    frame, done, want = tf, torch.zeros(2, dtype=torch.bool), []
    for i in range(6):
        tokens = torch.cat([frame[:, None, :], torch.zeros((2, 1, 1), dtype=frame.dtype)], -1)
        new, state = tm.generate_frame(tp, cfg, state, tokens, tm._feedback_mask(2, K, "cpu"),
                                       tm.frame_generator(9, 1 + i, "cpu"), 0.9, 5)
        eos = (new == 0).all(dim=-1)
        valid = ~(done | eos)
        done = done | eos
        frame = torch.where(valid[:, None], new, 0)
        want.append(frame)
    got, _, _, got_state = tm.decode_frames(tp, cfg, ts, tf, torch.zeros(2, dtype=torch.bool),
                                            9, 6, 0.9, 5, start_index=1)
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(got_state.pos, state.pos)


def test_tensor_temperature_and_topk_give_the_frames_of_numbers(params):
    """Per-row tensors (what the captured sampled step reads from its
    buffers) and numbers give the same sampled frames."""
    _, tp = params
    cfg = t_tiny()
    tf, ts = _prefill_port(tp)
    copy = _copy(ts)
    done = torch.zeros(2, dtype=torch.bool)
    by_number, _, _, _ = tm.decode_frames(tp, cfg, ts, tf, done, 9, 4, 0.9, 5, start_index=1)
    by_tensor, _, _, _ = tm.decode_frames(tp, cfg, copy, tf, done, 9, 4, torch.full((2,), 0.9),
                                          torch.full((2,), 5), start_index=1)
    assert torch.equal(by_number, by_tensor)
