"""The port's training data, checkpoints and finetune CLI (``sesameai_tts_
tpu_torch/training/{data,checkpoint,finetune}.py``) on the CPU: the
``BatchLoader`` batches equal to the JAX package's for the same seed and a
shared stub encoder (both shuffle with ``np.random.default_rng``),
``prefetch``, ``load_directory`` in both conventions, a bit-exact resume of
a full ``TrainState``, ``latest_checkpoint`` past 8 digits, and the CLI's
smoke run, resume, eval split and ``--resume`` errors at the tiny flavor."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sesameai_tts_tpu.runtime.frames import FrameTokenizer as JFrameTokenizer
from sesameai_tts_tpu.runtime.frames import Segment as JSegment
from sesameai_tts_tpu.training import data as jdata
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.core.weights import load_pytree
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.runtime.frames import FrameTokenizer, Segment
from sesameai_tts_tpu_torch.training import checkpoint as ckpt_lib
from sesameai_tts_tpu_torch.training import train_step as ts
from sesameai_tts_tpu_torch.training.data import (
    BatchLoader,
    LoaderConfig,
    bucket_for,
    load_directory,
    pad_example,
    prefetch,
)
from sesameai_tts_tpu_torch.training.finetune import main
from sesameai_tts_tpu_torch.training.loss import Batch

CFG = csm_test_tiny()
K = CFG.audio_num_codebooks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubTextTok:
    def encode(self, text):
        return [1 + (ord(c) % 100) for c in text][:20]


def _stub_encoder(audio):
    """Deterministic fake Mimi: 1 frame per 100 samples, content-coded."""
    F = max(1, len(audio) // 100)
    seed = int(np.abs(audio).sum() * 1000) % 50
    return (np.arange(K)[:, None] + seed + np.arange(F)[None, :]) % 60 + 1


def _segments(n, rng, cls=Segment):
    return [cls(speaker=i % 2, text=f"utterance number {i}",
                audio=rng.standard_normal(100 * (2 + i % 5)).astype(np.float32))
            for i in range(n)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_loader_equals_jax(shuffle):
    """Three epochs of 7 clips over two buckets, a repetition-padded tail."""
    cfg = dict(batch_size=3, buckets=(32, 64, 128), seed=5, shuffle=shuffle)
    ours = BatchLoader(_segments(7, np.random.default_rng(0)),
                       FrameTokenizer(_StubTextTok(), _stub_encoder, K), LoaderConfig(**cfg))
    theirs = jdata.BatchLoader(_segments(7, np.random.default_rng(0), JSegment),
                               JFrameTokenizer(_StubTextTok(), _stub_encoder, K),
                               jdata.LoaderConfig(**cfg))
    for _ in range(3):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert isinstance(x, Batch)
            for u, w in zip(x, y):
                assert u.dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(u, np.asarray(w))


def test_bucket_pad_and_dropped():
    assert bucket_for(64, (64, 128)) == 64
    assert bucket_for(65, (64, 128)) == 128
    assert bucket_for(129, (64, 128)) is None
    tokens = np.ones((5, K + 1), np.int32)
    t, m, lm = pad_example(tokens, tokens.astype(bool), 8)
    assert t.shape == (8, K + 1) and lm.tolist() == [True] * 5 + [False] * 3
    assert not t[5:].any() and not m[5:].any()
    ftok = FrameTokenizer(_StubTextTok(), _stub_encoder, K)
    long = [Segment(0, "x", np.ones(100 * 200, np.float32))]
    loader = BatchLoader(_segments(2, np.random.default_rng(1)) + long, ftok,
                         LoaderConfig(batch_size=2, buckets=(64,)))
    assert loader.dropped == 1
    with pytest.raises(ValueError, match="no usable examples"):
        BatchLoader(long, ftok, LoaderConfig(batch_size=2, buckets=(64,)))


def test_prefetch_order_and_errors():
    assert list(prefetch(iter(range(10)), depth=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("boom")

    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_early_break_retires_worker():
    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    for _ in range(10):
        for x in prefetch(infinite(), depth=2):
            if x >= 3:
                break
    time.sleep(0.5)  # workers observe stop within their 0.1 s put timeout
    assert threading.active_count() <= before + 1


def test_load_directory_both_conventions(tmp_path):
    wav = np.sin(np.linspace(0, 100, 2400)).astype(np.float32)
    d1 = tmp_path / "sidecar"
    d1.mkdir()
    write_wav(str(d1 / "a.wav"), wav, 24_000)
    (d1 / "a.txt").write_text("hello side")
    write_wav(str(d1 / "skip.wav"), wav, 24_000)  # no txt → skipped
    segs = load_directory(str(d1))
    assert len(segs) == 1 and segs[0].text == "hello side" and segs[0].speaker == 0
    assert segs[0].audio.shape == (2400,)

    d2 = tmp_path / "meta"
    d2.mkdir()
    write_wav(str(d2 / "a.wav"), wav, 24_000)
    write_wav(str(d2 / "b.wav"), wav[::2].copy(), 12_000)  # resampled on read
    (d2 / "metadata.json").write_text(json.dumps(
        {"a.wav": {"text": "spoken A", "speaker": 3}, "b.wav": "spoken B"}))
    segs = load_directory(str(d2))
    assert [(s.text, s.speaker) for s in segs] == [("spoken A", 3), ("spoken B", 0)]
    assert segs[1].audio.shape == (2400,)


def _rand_batch(rng, B=2, S=24, audio_rows=16):
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    text = S - audio_rows
    tokens[:, :text, K] = rng.integers(1, CFG.text_vocab_size, (B, text))
    mask[:, :text, K] = True
    tokens[:, text:, :K] = rng.integers(1, CFG.audio_vocab_size, (B, audio_rows, K))
    mask[:, text:, :K] = True
    return ts.batch_to(Batch(tokens, mask, np.ones((B, S), bool)), "cpu")


def test_checkpoint_resume_bit_exact(tmp_path):
    """2 steps + save + restore + 2 steps == 4 straight steps: params, mu,
    nu and the counts, bit for bit (the decoder subset drawn per step)."""
    rng = np.random.default_rng(0)
    tx = ts.make_optimizer(lr=1e-3, warmup=2, total_steps=4)
    params = init_csm_params(CFG, torch.Generator().manual_seed(1), torch.float32)
    step_fn = ts.make_train_step(CFG, tx, decoder_frames=2)
    batches = [_rand_batch(rng) for _ in range(4)]

    def fresh():
        return ts.init_train_state(ts.tree_map(torch.clone, params), tx)

    ref = fresh()
    for b in batches:
        ref, _ = step_fn(ref, b)

    s = fresh()
    for b in batches[:2]:
        s, _ = step_fn(s, b)
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), s)
    assert os.path.basename(path) == "step_00000002"
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ck")) == path
    s2 = ckpt_lib.restore_checkpoint(path, fresh())
    assert int(s2.step) == 2 and s2.step.dtype == torch.int32
    for b in batches[2:]:
        s2, _ = step_fn(s2, b)
    for a, b in zip(ts.tree_leaves(tuple(ref)), ts.tree_leaves(tuple(s2))):
        assert torch.equal(a, b)


def test_latest_checkpoint_past_8_digits(tmp_path):
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "missing")) is None
    for step in (7, 99_999_999, 123_456_789):
        (tmp_path / f"step_{step:08d}").touch()
    (tmp_path / "step_00000008.tmp").touch()  # an interrupted save
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_123456789")


def _clips(root, n, seed, seconds=0.04):
    root.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        wav = (0.1 * rng.standard_normal(int(24_000 * seconds) * (i + 1))).astype(np.float32)
        write_wav(str(root / f"c{i}.wav"), wav, 24_000)
        (root / f"c{i}.txt").write_text(f"tiny clip {i}")
    return str(root)


def test_finetune_cli_smoke_and_resume(tmp_path):
    data = _clips(tmp_path / "clips", 3, 4)
    ckpt = str(tmp_path / "run")
    argv = ["--data", data, "--flavor", "test-tiny", "--steps", "3", "--batch-size", "2",
            "--buckets", "64,128", "--ckpt-dir", ckpt, "--save-every", "100",
            "--log-every", "1", "--warmup", "1", "-d", "cpu"]
    m = main(argv)
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert ckpt_lib.latest_checkpoint(ckpt).endswith("step_00000003")
    assert os.path.isfile(os.path.join(ckpt, "params"))  # the servable export
    main(argv + ["--steps", "5", "--resume"])
    assert ckpt_lib.latest_checkpoint(ckpt).endswith("step_00000005")


def test_finetune_cli_eval_split(tmp_path):
    data = _clips(tmp_path / "clips", 4, 6)
    m = main(["--data", data, "--flavor", "test-tiny", "--steps", "2", "--batch-size", "2",
              "--buckets", "64", "--eval-frac", "0.5", "--eval-every", "1", "--log-every", "1",
              "--warmup", "1", "-d", "cpu"])
    assert np.isfinite(m["eval_loss"])


def test_finetune_cli_resume_errors(tmp_path):
    with pytest.raises(SystemExit, match="ckpt-dir"):
        main(["--data", str(tmp_path), "--flavor", "test-tiny", "--resume"])
    data = _clips(tmp_path / "clips", 1, 7)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        main(["--data", data, "--flavor", "test-tiny", "--resume", "--batch-size", "1",
              "--buckets", "64", "--ckpt-dir", str(tmp_path / "empty"), "-d", "cpu"])


def test_finetune_cli_resume_is_bit_equal(tmp_path):
    """An unbroken 4-step run against the same run resumed from its step-2
    checkpoint (its step-4 one deleted): --resume replays the seeded batch
    stream, so both states are equal bit for bit."""
    data = _clips(tmp_path / "clips", 3, 8)
    argv = ["--data", data, "--flavor", "test-tiny", "--steps", "4", "--batch-size", "2",
            "--buckets", "64,128", "--log-every", "1", "--warmup", "1", "-d", "cpu"]
    main(argv + ["--ckpt-dir", str(tmp_path / "a"), "--save-every", "4"])
    b = tmp_path / "b"
    main(argv + ["--ckpt-dir", str(b), "--save-every", "2"])
    os.remove(b / "step_00000004")
    main(argv + ["--ckpt-dir", str(b), "--save-every", "2", "--resume"])
    states = [load_pytree(str(d / "step_00000004")) for d in (tmp_path / "a", b)]
    for x, y in zip(ts.tree_leaves(states[0]), ts.tree_leaves(states[1])):
        assert torch.equal(x, y)
