"""Training data: (transcript, wav) pairs → fixed-shape Batches (port of
``sesameai_tts_tpu/training/data.py``, numpy and threads, kept as the
port's own copy).

* rows come from the same ``FrameTokenizer`` as inference prompts
  (``runtime/frames.py``), so train-time rows equal inference-time rows;
* every example is right-padded to one of a fixed set of sequence-length
  buckets and batches are homogeneous per bucket;
* Mimi encoding happens once per example through the caller's encoder;
* ``prefetch`` overlaps host-side batching with device steps on a bounded
  background thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sesameai_tts_tpu_torch.runtime.frames import FrameTokenizer, Segment
from sesameai_tts_tpu_torch.training.loss import Batch

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def bucket_for(S: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket ≥ S, or None when the example is too long."""
    for b in sorted(buckets):
        if S <= b:
            return b
    return None


def pad_example(
    tokens: np.ndarray, mask: np.ndarray, bucket: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad (S, K+1) rows to ``bucket``; → (tokens, mask, loss_mask).

    Padding rows are all-zero with an all-False mask; ``loss_mask`` marks
    the real rows so ``csm_loss`` ignores the padding entirely.
    """
    S, W = tokens.shape
    assert S <= bucket, f"example length {S} exceeds bucket {bucket}"
    t = np.zeros((bucket, W), np.int32)
    m = np.zeros((bucket, W), bool)
    lm = np.zeros((bucket,), bool)
    t[:S], m[:S], lm[:S] = tokens, mask, True
    return t, m, lm


def load_directory(path: str, sample_rate: int = 24_000) -> List[Segment]:
    """Scan a dataset directory into Segments.

    Two conventions (matching the voice-registry conventions in
    service/voices.py): a ``metadata.json`` mapping
    ``{"clip.wav": {"text": ..., "speaker": 0}}`` (or plain
    ``{"clip.wav": "text"}``), else per-file ``clip.txt`` sidecars
    (speaker defaults to 0). WAVs resample to ``sample_rate`` on read.
    """
    from sesameai_tts_tpu_torch.audio.io import read_wav_mono

    meta_path = os.path.join(path, "metadata.json")
    entries: List[Tuple[str, str, int]] = []  # (wav_path, text, speaker)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        for wav, info in sorted(meta.items()):
            text, speaker = (
                (info, 0) if isinstance(info, str)
                else (info["text"], int(info.get("speaker", 0)))
            )
            entries.append((os.path.join(path, wav), text, speaker))
    else:
        for name in sorted(os.listdir(path)):
            if not name.endswith(".wav"):
                continue
            txt = os.path.join(path, name[:-4] + ".txt")
            if not os.path.exists(txt):
                continue
            with open(txt) as f:
                entries.append((os.path.join(path, name), f.read().strip(), 0))
    segments = []
    for wav_path, text, speaker in entries:
        audio, _ = read_wav_mono(wav_path, target_rate=sample_rate)
        segments.append(Segment(speaker=speaker, text=text, audio=audio))
    return segments


@dataclass
class LoaderConfig:
    batch_size: int = 4
    buckets: Sequence[int] = DEFAULT_BUCKETS
    seed: int = 0
    drop_remainder: bool = False  # short final groups pad by repetition
    shuffle: bool = True  # False → fixed order + fixed tail repetition
    #   (eval loaders: identical params must yield identical eval_loss)


class BatchLoader:
    """Shuffled, bucketed epochs of fixed-shape ``Batch``es.

    Tokenization (text BPE + Mimi encode through ``frame_tokenizer``)
    runs ONCE up front; epochs then just shuffle/regroup host arrays.
    Examples longer than the largest bucket are dropped with a count in
    ``self.dropped`` (no silent truncation — a cut row sequence would
    teach the model to stop mid-utterance).
    """

    def __init__(self, segments: Iterable[Segment],
                 frame_tokenizer: FrameTokenizer,
                 config: LoaderConfig = LoaderConfig()):
        self.cfg = config
        self._rng = np.random.default_rng(config.seed)
        self.examples: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.dropped = 0
        for seg in segments:
            tokens, mask = frame_tokenizer.segment(seg)
            b = bucket_for(tokens.shape[0], config.buckets)
            if b is None:
                self.dropped += 1
                continue
            self.examples.append((b, tokens, mask))
        if not self.examples:
            raise ValueError("no usable examples (all empty or over-length)")

    def __iter__(self) -> Iterator[Batch]:
        """One epoch: shuffle, group by bucket, yield (B, S, K+1) batches."""
        order = (
            self._rng.permutation(len(self.examples))
            if self.cfg.shuffle
            else np.arange(len(self.examples))
        )
        groups: dict = {}
        for i in order:
            b, tokens, mask = self.examples[i]
            groups.setdefault(b, []).append((tokens, mask))
            if len(groups[b]) == self.cfg.batch_size:
                yield self._assemble(b, groups.pop(b))
        for b, group in sorted(groups.items()):
            if self.cfg.drop_remainder:
                continue
            orig = len(group)
            while len(group) < self.cfg.batch_size:  # pad by repetition:
                group.append(group[len(group) % orig])  # keeps shapes fixed
            yield self._assemble(b, group)

    def _assemble(self, bucket: int, group) -> Batch:
        padded = [pad_example(t, m, bucket) for t, m in group]
        return Batch(
            tokens=np.stack([p[0] for p in padded]),
            mask=np.stack([p[1] for p in padded]),
            loss_mask=np.stack([p[2] for p in padded]),
        )


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` on a background thread, ``depth`` items ahead.

    Overlaps host-side batch assembly with device execution; exceptions
    re-raise at the consuming site.  Closing the generator early (the
    finetune loop breaks out of an infinite epoch iterator every run)
    unblocks and retires the worker — a plain ``q.put`` would leave one
    blocked thread behind per call in a long-lived process.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END, _ERR = object(), object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — reraised below
            _put((_ERR, e))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while True:  # release a worker mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break
