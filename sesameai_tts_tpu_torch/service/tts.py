"""The voice-preload path of the service layer (port of
``_fit_context`` and ``prepare_voice_context`` from
``sesameai_tts_tpu/service/tts.py``): read a voice's reference clips,
tail-trim them to the codec window and the KV budget, and tokenize them
into ``(tokens, mask)`` segments for ``Generator.precompute_context_state``
or a ``RollingContext`` prefix.

The ``TTS`` engine class of that module (warm-up, sentence pipeline,
playback, export) needs the watermark and is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict

from sesameai_tts_tpu_torch.audio.io import read_wav_mono
from sesameai_tts_tpu_torch.runtime.frames import Segment

logger = logging.getLogger(__name__)


def _fit_context(segs, budget: int):
    """Tail-trim tokenized ``(tokens, mask)`` segments to ≤ ``budget`` rows.

    Drops the OLDEST clips whole first; if the newest clip alone still
    exceeds the budget, keeps its tail rows — the most recent audio is
    what carries the prosody the next utterance continues from. Returns
    ``(segs, total_rows, trimmed)``.
    """
    total = sum(int(t.shape[0]) for t, _ in segs)
    if total <= budget:
        return list(segs), total, False
    segs = list(segs)
    while len(segs) > 1 and total > budget:
        total -= int(segs[0][0].shape[0])
        segs = segs[1:]
    if total > budget:
        t, m = segs[0]
        cut = total - budget
        segs[0] = (t[cut:], m[cut:])
        total = budget
    return segs, total, True


def prepare_voice_context(generator, clips: Dict[str, str], name: str = "voice"):
    """Read, clip-trim, tokenize and KV-fit a voice's
    ``{wav_path: transcript}`` clips into ``(tokens, mask)`` segments
    ready for ``precompute_context_state`` of ``generator`` (a
    ``runtime.generator.Generator``).

    Clips past the codec's one-pass encode window tail-trim BEFORE Mimi
    encode (they would raise, and their frames overflow the
    KV budget anyway), then the tokenized rows tail-trim to the
    generator's context budget.  Returns ``(segments, rows, trimmed)``.
    """
    max_clip = generator.max_clip_samples
    segments = []
    for path, text in clips.items():
        audio = read_wav_mono(path, generator.sample_rate)[0]
        if len(audio) > max_clip:
            # keep the TAIL (same policy as the frame-level trim)
            logger.warning(
                "voice clip %s (%.1f s) exceeds the longest usable "
                "context clip (%.1f s — the tighter of the codec encode "
                "window and the KV context budget); keeping the last "
                "%.1f s",
                path, len(audio) / generator.sample_rate,
                max_clip / generator.sample_rate,
                max_clip / generator.sample_rate,
            )
            audio = audio[-max_clip:]
        segments.append(Segment(speaker=1, text=text, audio=audio))
    tokenized = [generator.frame_tokenizer.segment(s) for s in segments]
    raw_rows = sum(int(t.shape[0]) for t, _ in tokenized)
    fitted, rows, trimmed = _fit_context(tokenized, generator.context_budget)
    if trimmed:
        logger.warning(
            "voice %r context (%d rows) exceeds the KV budget; "
            "tail-trimmed to %d rows — use shorter reference clips "
            "for full-fidelity voice conditioning",
            name, raw_rows, rows,
        )
    return fitted, rows, trimmed
