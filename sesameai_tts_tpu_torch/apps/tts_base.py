"""The application-layer TTS base shared by the web apps (port of
``sesameai_tts_tpu/apps/tts_base.py``).

Owns a TTS engine and a current voice, splits incoming text into
sentences, synthesizes them one at a time, and hands each clip to the UI
as the ``(sample_rate, float32 ndarray)`` streaming tuple.  Sentence and
clip state live in a thread-safe :class:`SentenceQueue`; synthesis runs
outside the queue lock so UI reads never wait on the card.

The engine is the port's ``TTS`` on ``device`` (the card unless the
caller asks for the CPU); a caller may inject a built one as ``tts=``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sesameai_tts_tpu_torch.audio.segment import AudioClip
from sesameai_tts_tpu_torch.runtime.loader import ModelSpec, csm_1b_spec
from sesameai_tts_tpu_torch.service.tts import TTS
from sesameai_tts_tpu_torch.utils.text import split_clean_sentences

log = logging.getLogger(__name__)

GradioAudio = Tuple[int, np.ndarray]


class SentenceQueue:
    """Thread-safe store for the sentence backlog and produced clips.

    The queue only grows within a session (indices stay stable for the
    UI's start/end ranges) until :meth:`clear` resets it.
    """

    def __init__(self):
        self.lock = threading.RLock()
        self._sentences: List[str] = []
        self._clips: List[Optional[AudioClip]] = []
        self.sample_rate: Optional[int] = None

    def enqueue(self, sentences: Sequence[str]) -> Tuple[int, int]:
        """Append sentences; returns their [start, end) index range."""
        with self.lock:
            start = len(self._sentences)
            self._sentences.extend(sentences)
            self._clips.extend([None] * len(sentences))
            return start, len(self._sentences)

    def get(self, index: int) -> Optional[str]:
        with self.lock:
            if 0 <= index < len(self._sentences):
                return self._sentences[index]
            return None

    def record(self, index: int, clip: AudioClip) -> None:
        with self.lock:
            if self.sample_rate is None:
                self.sample_rate = clip.sample_rate
            if 0 <= index < len(self._clips):
                self._clips[index] = clip

    def clips(self) -> List[AudioClip]:
        with self.lock:
            return [c for c in self._clips if c is not None]

    def clear(self) -> None:
        with self.lock:
            self._sentences = []
            self._clips = []
            self.sample_rate = None

    def __len__(self) -> int:
        with self.lock:
            return len(self._sentences)


class TTSBaseApp:
    """Engine + voice + sentence queue; the spine under every web app."""

    # clip shaping applied to each synthesized sentence
    FADE_MS = 50
    LEAD_SILENCE_MS = 150
    TAIL_SILENCE_MS = 150

    def __init__(
        self,
        voice: Optional[str] = None,
        spec: Optional[ModelSpec] = None,
        voices: Optional[str] = None,
        tts: Optional[TTS] = None,
        device="cuda",
    ):
        self.tts = tts or TTS(spec=spec or csm_1b_spec(), voices=voices, device=device)
        if self.tts.generator is None:
            self.tts.load_model()

        self.queue = SentenceQueue()
        self.current_voice: Optional[str] = None
        self.current_status = "engine up — no voice selected"
        self._select_initial_voice(voice)

    # -- views for subclasses and UIs ----------------------------------------

    @property
    def lock(self) -> threading.RLock:
        return self.queue.lock

    @property
    def sentences(self) -> List[str]:
        # a live reference: UI callbacks may read-only inspect the backlog
        return self.queue._sentences

    @property
    def current_sample_rate(self) -> Optional[int]:
        return self.queue.sample_rate

    # -- setup ---------------------------------------------------------------

    def _select_initial_voice(self, requested: Optional[str]) -> None:
        candidates = [requested] if requested else self.list_available_voices()[:1]
        for name in candidates:
            if not name:
                continue
            try:
                self.tts.load_voice(name)
            except Exception:
                log.exception("could not load startup voice %r", name)
                continue
            self.current_voice = name
            self.current_status = f"voice '{name}' loaded — ready"
            return

    # -- text ----------------------------------------------------------------

    def split_text_into_sentences(self, text: str) -> List[str]:
        return split_clean_sentences(text)

    # -- voices --------------------------------------------------------------

    def list_available_voices(self) -> List[str]:
        try:
            return self.tts.list_voices()
        except Exception:
            log.exception("voice registry unavailable")
            return []

    def change_voice(self, name: str) -> str:
        log.info("switching voice: %r -> %r", self.current_voice, name)
        try:
            self.tts.load_voice(name)
        except Exception as e:
            log.exception("voice switch failed")
            self.current_status = f"could not switch to voice '{name}': {e}"
        else:
            self.current_voice = name
            self.current_status = f"voice '{name}' loaded — ready"
        return self.current_status

    # -- synthesis -----------------------------------------------------------

    def synthesize_sentence(
        self,
        sentence: str,
        temperature: float = 0.8,
        topk: int = 40,
        speed_factor: float = 1.0,
    ) -> AudioClip:
        """One sentence → padded/faded AudioClip (no queue interaction)."""
        clip = self.tts.generate_audio_segment(
            sentence,
            temperature=temperature,
            topk=topk,
            fade_duration=self.FADE_MS,
            start_silence_duration=self.LEAD_SILENCE_MS,
            end_silence_duration=self.TAIL_SILENCE_MS,
        )
        if speed_factor != 1.0:
            clip = clip.speedup(playback_speed=speed_factor)
        return clip

    def generate_audio_for_sentence_index(
        self,
        sentence_index: int,
        temperature: float = 0.8,
        topk: int = 40,
        speed_factor: float = 1.0,
    ) -> Tuple[str, Optional[GradioAudio]]:
        """Synthesize queue item ``sentence_index``; returns
        ``(status, (sr, f32 pcm) | None)``, the UI streaming contract."""
        sentence = self.queue.get(sentence_index)
        total = len(self.queue)
        if sentence is None:
            self.current_status = (
                f"nothing queued at index {sentence_index} (queue holds {total})"
            )
            return self.current_status, None

        label = f"{sentence_index + 1}/{total}"
        self.current_status = f"synthesizing {label}: {sentence[:48]}"
        started = time.perf_counter()
        try:
            clip = self.synthesize_sentence(sentence, temperature, topk, speed_factor)
        except Exception as e:
            log.exception("synthesis failed at %s", label)
            self.current_status = f"sentence {label} failed ({e}) — skipping"
            return self.current_status, None

        self.queue.record(sentence_index, clip)
        self._store_audio_segment(clip, sentence_index)
        elapsed = time.perf_counter() - started
        tail = (
            "queue drained"
            if sentence_index >= len(self.queue) - 1
            else "continuing"
        )
        self.current_status = (
            f"sentence {label}: {clip.duration_seconds:.1f} s audio "
            f"in {elapsed:.1f} s — {tail}"
        )
        return self.current_status, clip.to_gradio()

    def _store_audio_segment(self, clip: AudioClip, sentence_index: int) -> None:
        """Subclass hook: called once per successfully synthesized clip."""
