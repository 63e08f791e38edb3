"""Full-duplex voice loop (port of ``sesameai_tts_tpu/apps/duplex.py``).

Per user turn: STT → the user turn appended to a rolling CSM context →
streaming LLM → incremental sentence split over the token deltas →
frame-granular TTS stream → the assistant's audio appended back into the
context.  The context is a ``RollingContext`` (a pinned voice prefix and
an evicting window, no hard wall at the KV capacity), and the audio goes
out per 80 ms frame.

The microphone layer (fastrtc) is injected: anything that calls
``respond(user_audio, sample_rate)`` and consumes the yielded
``(sample_rate, pcm)`` tuples works.  STT is likewise an injected
callable (``apps/audio_to_text.transcribe`` over an HTTP API, or a local
model).  The Generator runs on the card unless it was built for the CPU.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from sesameai_tts_tpu_torch.audio.resample import resample
from sesameai_tts_tpu_torch.llm.client import AskLLM
from sesameai_tts_tpu_torch.llm.client import global_config as llm_config
from sesameai_tts_tpu_torch.runtime.context import RollingContext
from sesameai_tts_tpu_torch.runtime.frames import Segment
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.utils.text import clean_text_for_tts

logger = logging.getLogger(__name__)


def sentence_stream(deltas: Iterator[str]) -> Iterator[str]:
    """Incremental sentence splitter over LLM token deltas: a sentence is
    yielded once text follows its boundary, so "1" + ".5" stays one
    number."""
    buf = ""
    for delta in deltas:
        buf += delta
        while True:
            m = re.search(r"(.+?[.!?])(?:\s+|$)", buf, re.S)
            if not m or m.end() >= len(buf):
                break  # keep accumulating until a boundary is confirmed
            yield m.group(1).strip()
            buf = buf[m.end():]
    tail = buf.strip()
    if tail:
        yield tail


class DuplexVoiceApp:
    """STT → LLM → TTS loop with rolling context recycling."""

    def __init__(
        self,
        generator: Generator,
        stt: Callable[[np.ndarray, int], str],
        llm: Optional[AskLLM] = None,
        voice_context: Optional[List] = None,  # Segments or (tokens, mask) pairs
        user_speaker: int = 0,
        bot_speaker: int = 1,
        max_dialog_segments: int = 7,
        temperature: float = 0.8,
        topk: int = 40,
        max_sentence_ms: float = 20_000.0,
    ):
        self.generator = generator
        self.stt = stt
        self.llm = llm or AskLLM("local-default", llm_config)
        self.user_speaker = user_speaker
        self.bot_speaker = bot_speaker
        self.temperature = temperature
        self.topk = topk
        self.max_sentence_ms = max_sentence_ms
        # the last turn's latency marks in seconds from its start: stt,
        # ttfs (first sentence) and ttff (first frame), None until reached
        self.marks = {}

        self.context = RollingContext(
            max_positions=generator._max_seq_len,
            max_segments=max_dialog_segments,
        )
        if voice_context:
            pairs = [
                generator.frame_tokenizer.segment(s) if isinstance(s, Segment) else s
                for s in voice_context
            ]
            self.context.pin_prefix(pairs)

    # -- one user turn ------------------------------------------------------

    def respond(
        self, user_audio: np.ndarray, sample_rate: int
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yields (sample_rate, pcm chunk) per generated frame; the latency
        marks (STT, first sentence, first frame) are logged and kept in
        ``marks``."""
        t0 = time.time()
        self.marks = {"stt": None, "ttfs": None, "ttff": None}
        user_text = self.stt(user_audio, sample_rate)
        self.marks["stt"] = time.time() - t0
        logger.info(f"stt: {self.marks['stt']:.2f}s — {user_text!r}")
        if not user_text.strip():
            return

        # the user turn joins the CSM context (text + their audio)
        if sample_rate != self.generator.sample_rate:
            user_audio = resample(user_audio, sample_rate, self.generator.sample_rate)
        # a live loop must degrade, not crash: an over-long turn keeps its tail
        self.context.append(
            self.generator.frame_tokenizer.segment(
                Segment(self.user_speaker, user_text, user_audio.astype(np.float32))
            ),
            oversize="trim",
        )

        deltas = self.llm.query(user_text, stream=True)
        for sentence in sentence_stream(deltas):
            if self.marks["ttfs"] is None:
                self.marks["ttfs"] = time.time() - t0
                logger.info(f"ttfs: {self.marks['ttfs']:.2f}s")
            sentence = clean_text_for_tts(sentence)
            if not sentence:
                continue

            def on_chunk(_):
                if self.marks["ttff"] is None:
                    self.marks["ttff"] = time.time() - t0
                    logger.info(f"ttff: {self.marks['ttff']:.2f}s")

            chunks = []
            for chunk in self.generator.generate_stream(
                sentence,
                self.bot_speaker,
                self.context.pairs(),
                max_audio_length_ms=self.max_sentence_ms,
                temperature=self.temperature,
                topk=self.topk,
                on_chunk_generated=on_chunk,
                chunk_frames=1,
            ):
                chunks.append(chunk)
                yield (self.generator.sample_rate, chunk)

            if chunks:
                bot_audio = np.concatenate(chunks)
                # recycle the assistant turn into the context
                self.context.append(
                    self.generator.frame_tokenizer.segment(
                        Segment(self.bot_speaker, sentence, bot_audio)
                    ),
                    oversize="trim",
                )

    def clear_dialog(self) -> None:
        self.context.clear()
        self.llm.history_manager.clear_history()


def main(argv=None):
    """Microphone loop through fastrtc when it is installed."""
    import argparse

    parser = argparse.ArgumentParser(description="Full-duplex voice chat (PyTorch)")
    parser.add_argument("--flavor", type=str, default="csm-1b",
                        choices=["csm-1b", "test-tiny"])
    parser.add_argument("-m", "--model", type=str, default="local-default")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="Device to run on (cuda or cpu)")
    args = parser.parse_args(argv)

    try:
        from fastrtc import ReplyOnPause, Stream  # type: ignore
    except ImportError:
        raise SystemExit(
            "fastrtc is not installed; install it for the mic loop. "
            "DuplexVoiceApp is usable programmatically without it."
        )

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec, test_tiny_spec

    spec = test_tiny_spec() if args.flavor == "test-tiny" else csm_1b_spec()
    gen = build_generator(spec, device=args.device)

    def stt_stub(audio, rate):
        raise SystemExit("wire an STT callable (e.g. whisper API) here")

    app = DuplexVoiceApp(gen, stt=stt_stub)

    def respond(audio):
        rate, pcm = audio
        yield from app.respond(np.asarray(pcm, np.float32), rate)

    Stream(ReplyOnPause(respond, can_interrupt=True)).ui.launch()


if __name__ == "__main__":
    main()
