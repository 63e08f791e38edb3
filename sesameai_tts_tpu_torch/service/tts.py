"""The service layer (port of ``sesameai_tts_tpu/service/tts.py``).

* ``prepare_voice_context``: read a voice's reference clips, tail-trim
  them to the codec window and the KV budget, and tokenize them into
  ``(tokens, mask)`` segments for ``Generator.precompute_context_state``
  or a ``RollingContext`` prefix.
* ``TTS``: the engine over a ``Generator``: voice registry, cached voice
  context, warm-up, ``generate_with_context`` (watermarked),
  ``generate_audio_segment`` (normalized, padded, faded), ``say`` (the
  sentence pipeline with overlapped playback and per-sentence RTF) and
  ``export_wav`` (per-sentence retries).  Like the JAX engine, ``say`` and
  ``export_wav`` put one second of silence in place of a sentence that
  keeps failing, and print the error.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import subprocess
import tempfile
import textwrap
import threading
import time
from typing import Dict, Optional

import numpy as np

from sesameai_tts_tpu_torch.audio.io import read_wav_mono
from sesameai_tts_tpu_torch.audio.resample import resample
from sesameai_tts_tpu_torch.audio.segment import AudioClip
from sesameai_tts_tpu_torch.runtime.frames import Segment
from sesameai_tts_tpu_torch.runtime.loader import ModelSpec, build_generator, csm_1b_spec
from sesameai_tts_tpu_torch.service.voices import load_registry
from sesameai_tts_tpu_torch.utils.text import split_sentences
from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK, load_watermarker, watermark

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


class TTS:
    """Text-to-speech engine over the port's Generator, on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, spec: Optional[ModelSpec] = None, voices: Optional[str] = None,
                 watermark_key=None, enable_watermark: bool = True, device="cuda"):
        self.spec = spec or csm_1b_spec()
        self.device = device
        self.generator = None
        self.watermarker = None
        self.voice_name: Optional[str] = None
        self.voice_data: Optional[Dict[str, str]] = None
        self.cached_context = None  # (CSMState, length) from the Generator
        self.cached_segments = []  # the fitted (tokens, mask) pairs
        self.registry = load_registry(voices)
        self.watermark_key = watermark_key or CSM_1B_WATERMARK
        self.enable_watermark = enable_watermark
        self.fallbacks = 0  # sentences say/export_wav replaced by silence

    # -- lifecycle ----------------------------------------------------------

    def load_model(self) -> None:
        """Build the Generator and the watermarker."""
        print("Open Sesame...")
        self.generator = build_generator(self.spec, device=self.device)
        if self.enable_watermark:
            self.watermarker = load_watermarker(device=self.generator.device)

    def list_voices(self) -> list:
        return list(self.registry.keys())

    def load_voice(self, voice_name: str, warmup: bool = True) -> None:
        """Load a voice's clips, tokenize them, prefill their context once
        (the KV prefix every utterance starts from), then warm up."""
        if voice_name not in self.registry:
            raise ValueError(
                f"Voice '{voice_name}' not found. Available voices: {self.list_voices()}")
        if self.generator is None:
            raise ValueError("Model not loaded. Call load_model() first.")
        self.voice_name = voice_name
        self.voice_data = self.registry[voice_name]
        print(f"Preparing reference audio context for voice: {voice_name}...")
        # every consumer, the uncached fallback of generate_with_context
        # included, sees the same clip- and KV-trimmed context
        fitted, _rows, _trimmed = prepare_voice_context(self.generator, self.voice_data,
                                                        voice_name)
        self.cached_segments = fitted
        self.cached_context = self.generator.precompute_context_state(fitted)
        print("Reference audio context prepared")
        if warmup:
            logger.debug("Warming up...")
            self.generate_audio_segment("I'm getting all warmed up for our chatting to begin.")

    # -- generation ---------------------------------------------------------

    def generate_with_context(self, prompt: str, speaker: int = 1,
                              max_audio_length_ms: float = 60_000, temperature: float = 0.9,
                              topk: int = 50, seed: Optional[int] = None) -> np.ndarray:
        """Generate from the cached voice context, then watermark.  ``seed``
        makes the utterance reproducible."""
        if self.generator is None:
            raise ValueError("Model not loaded. Call load_model() first.")
        audio = self.generator.generate(
            prompt, speaker, context=[] if self.cached_context else self.cached_segments,
            max_audio_length_ms=max_audio_length_ms, temperature=temperature, topk=topk,
            cached_context=self.cached_context, seed=seed)
        if self.enable_watermark and self.watermarker is not None and len(audio):
            sr = self.generator.sample_rate
            audio, wm_rate = watermark(self.watermarker, audio, sr, self.watermark_key)
            if wm_rate != sr:
                audio = resample(audio, wm_rate, sr)
        return audio

    def generate_audio_segment(self, prompt: str, fade_duration: int = 50,
                               start_silence_duration: int = 500,
                               end_silence_duration: int = 100, temperature: float = 0.8,
                               topk: int = 40, seed: Optional[int] = None,
                               max_audio_length_ms: float = 30_000) -> AudioClip:
        """→ a normalized, padded, faded clip."""
        audio = self.generate_with_context(prompt, speaker=1,
                                           max_audio_length_ms=max_audio_length_ms,
                                           temperature=temperature, topk=topk, seed=seed)
        clip = AudioClip.from_float(audio, self.generator.sample_rate).normalize()
        clip = clip.pad(start_silence_duration, end_silence_duration)
        return clip.fade_in(fade_duration).fade_out(fade_duration)

    # -- playback -----------------------------------------------------------

    @staticmethod
    def _play_clip(clip: AudioClip) -> None:
        """Play through ``ffplay`` from a temporary file; skipped with a
        warning where there is no ffplay."""
        if shutil.which("ffplay") is None:
            logger.warning("ffplay not found; skipping playback")
            return
        fd, path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        try:
            clip.export(path)
            subprocess.call(["ffplay", path, "-nodisp", "-autoexit", "-loglevel", "quiet"],
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        finally:
            os.remove(path)

    def say(self, text: str, output_filename: Optional[str] = "combined_output.wav",
            fallback_duration: int = 1000, fade_duration: int = 50,
            start_silence_duration: int = 500, end_silence_duration: int = 100,
            temperature: float = 0.8, topk: int = 40, play: bool = True,
            seed: Optional[int] = None, max_audio_length_ms: float = 30_000) -> list:
        """Sentence by sentence, each played while the next is generated,
        with its RTF printed → the clips.  Sentence i uses ``seed + i``;
        ``max_audio_length_ms`` caps each sentence."""
        sentences = split_sentences(textwrap.dedent(text).strip())
        if not sentences:
            print("No valid text to process")
            return []
        clips = []
        clip_queue: "queue.Queue[AudioClip]" = queue.Queue()
        stop_event = threading.Event()

        def player():
            while not stop_event.is_set() or not clip_queue.empty():
                try:
                    seg = clip_queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                try:
                    self._play_clip(seg)
                except Exception as e:  # the queue must still be acked
                    print(f"Playback error (continuing): {e}")
                finally:
                    clip_queue.task_done()

        player_thread = None
        if play:
            player_thread = threading.Thread(target=player, daemon=True)
            player_thread.start()
        for i, sentence in enumerate(sentences):
            try:
                start = time.time()
                print(f"> {sentence} ... ", end="", flush=True)
                seg = self.generate_audio_segment(
                    sentence, fade_duration=fade_duration,
                    start_silence_duration=start_silence_duration,
                    end_silence_duration=end_silence_duration, temperature=temperature,
                    topk=topk, seed=None if seed is None else seed + i,
                    max_audio_length_ms=max_audio_length_ms)
                proc = time.time() - start
                dur = seg.duration_seconds
                print(f"[Audio: {dur:.2f}s in {proc:.2f}s, "
                      f"RTF: {dur / proc if proc > 0 else float('inf'):.2f}x]")
            except KeyboardInterrupt:
                print("\nExiting due to KeyboardInterrupt")
                break
            except Exception as e:  # the silent fallback of the JAX engine
                print(f"Error generating audio for sentence: {sentence}: {e}")
                self.fallbacks += 1
                seg = AudioClip.silent(fallback_duration, self.sample_rate)
                seg = seg.fade_in(fade_duration).fade_out(fade_duration)
            clips.append(seg)
            if play:
                clip_queue.put(seg)
        if play:
            clip_queue.join()
            stop_event.set()
            player_thread.join(timeout=1.0)
        if output_filename and clips:
            combined = AudioClip.concat(clips)
            combined.export(output_filename)
            print(f"Export complete: {len(combined) / 1000:.2f} seconds of audio")
        return clips

    @property
    def sample_rate(self) -> int:
        return self.generator.sample_rate if self.generator else 24_000

    def export_wav(self, text: str, output_filename: str, fallback_duration: int = 1000,
                   max_retries: int = 2, temperature: float = 0.8, topk: int = 40,
                   seed: Optional[int] = None, max_audio_length_ms: float = 30_000) -> list:
        """Sentence by sentence, each retried up to ``max_retries`` times
        with its own seed (``seed + i``), into one WAV → the clips."""
        clips = []
        for i, sentence in enumerate(split_sentences(text)):
            seg = None
            sent_seed = None if seed is None else seed + i
            for attempt in range(max_retries + 1):
                try:
                    print(f"Export: Generating audio for sentence: {sentence} "
                          f"(Attempt {attempt + 1})")
                    seg = self.generate_audio_segment(
                        sentence, temperature=temperature, topk=topk, seed=sent_seed,
                        max_audio_length_ms=max_audio_length_ms)
                    break
                except Exception as e:
                    print(f"Export: Error for sentence: {sentence} (Attempt {attempt + 1}): {e}")
            if seg is None:
                print(f"Export: Using fallback for sentence: {sentence}")
                self.fallbacks += 1
                seg = AudioClip.silent(fallback_duration, self.sample_rate)
            clips.append(seg)
        if clips:
            combined = AudioClip.concat(clips)
            print(f"Exporting to {output_filename}...")
            combined.export(output_filename)
            print(f"Export complete: {len(combined) / 1000:.2f} seconds of audio")
        else:
            print("No audio segments to export")
        return clips
