"""LLM-connected web-app base (port of ``sesameai_tts_tpu/apps/web_base.py``).

An LLM client resolved from a model alias, the incremental
sentence→audio pump the chat and storyteller UIs drive, session
interrupt/reset, and runtime model switching.  The pump is a bounded
``for`` over the queued index range, cancelled cooperatively through a
generation token; LLM construction is one factory (``_swap_llm``) used
by both init and model switching.
"""

from __future__ import annotations

import abc
import logging
import os
import threading
from typing import Iterator, List, Optional, Tuple

from sesameai_tts_tpu_torch.apps.tts_base import GradioAudio, TTSBaseApp
from sesameai_tts_tpu_torch.llm.client import AskLLM, ModelManager
from sesameai_tts_tpu_torch.llm.client import global_config as llm_config

log = logging.getLogger(__name__)


class WebAppBase(TTSBaseApp, abc.ABC):
    def __init__(self, voice: Optional[str], model: str, **tts_kwargs):
        self.temp_audio_files: List[str] = []
        self.audio_segments: List = []
        self._cancel = threading.Event()
        # pump generation token: interrupt_and_reset increments it, and a
        # pump only runs while its captured generation is current (a shared
        # clearable Event would race: a new pump's clear() could revive an
        # old pump still inside a synthesis call)
        self._pump_gen = 0
        self.last_status = ""

        llm_config.VERBOSE = False
        self.model_manager = ModelManager(llm_config)
        self.available_models = llm_config.MODEL_OPTIONS
        self.llm = None
        self.current_model: Optional[str] = None
        self.current_resolved_alias: Optional[str] = None
        err = self._swap_llm(model)
        if err:
            raise ValueError(err)

        super().__init__(voice=voice, **tts_kwargs)

    # -- LLM wiring ----------------------------------------------------------

    def _swap_llm(self, alias: str) -> Optional[str]:
        """Resolve ``alias`` and point ``self.llm`` at it; returns an error
        string on failure (current client untouched), None on success."""
        resolved = self.model_manager.resolve_model_alias(alias)
        if not resolved:
            return f"no model matches alias '{alias}'"
        try:
            client = AskLLM(resolved_model_alias=resolved, config=llm_config)
        except Exception as e:
            log.exception("LLM init failed for %r", resolved)
            return f"LLM init failed for '{resolved}': {e}"
        self.llm = client
        self.current_resolved_alias = resolved
        self.current_model = resolved
        log.info("LLM ready: %s", resolved)
        return None

    def change_model(self, requested: str):
        err = self._swap_llm(requested)
        status = err or f"now answering with {self.current_model}"
        return self.update_status(status)

    def change_voice(self, voice: str):
        super().change_voice(voice)
        return self.update_status(self.current_status)

    # -- UI hooks (frontends override what they render) ----------------------

    def get_answer(self, query: str):
        """Frontend hook: produce an LLM answer for ``query``."""

    def update_status(self, message: str):
        """Surface ``message``: stored on the app (``last_status``) and
        returned, so UI event chains can wire it straight into a status
        Textbox.  Frontends may override to render elsewhere."""
        self.last_status = message
        return message

    def stream_audio_response(self, audio_chunk):
        """Frontend hook: push one audio tuple to the player."""

    def clear_ui(self):
        """Frontend hook: wipe rendered conversation state."""

    # -- session lifecycle ---------------------------------------------------

    def _store_audio_segment(self, clip, sentence_index):
        self.audio_segments.append(clip)

    def interrupt_and_reset(self):
        """Abort the running pump and empty the sentence backlog."""
        self._pump_gen += 1  # invalidates every in-flight pump
        self._cancel.set()
        self.queue.clear()
        self.audio_segments = []
        self.update_status("generation cancelled — queue emptied")

    def _purge_temp_files(self) -> None:
        leftover, self.temp_audio_files = self.temp_audio_files, []
        for path in leftover:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            except OSError:
                log.warning("temp file not removed: %s", path, exc_info=True)

    def clear_session(self):
        self._pump_gen += 1
        self._cancel.set()
        self._purge_temp_files()
        self.queue.clear()
        self.audio_segments = []
        self.clear_ui()

    # -- the sentence→audio pump ---------------------------------------------

    def sentence_generator_loop(
        self,
        start_index: int,
        end_index: int,
        active: bool,
        temperature: float = 0.7,
        speed_factor: float = 1.2,
        topk: int = 40,
    ) -> Iterator[Tuple[bool, Optional[GradioAudio]]]:
        """Drive sentences [start_index, end_index) through TTS, yielding
        ``(still_active, audio_tuple)`` per clip and a final
        ``(False, None)`` terminator, the contract the gradio audio
        components consume."""
        if not active:
            self.update_status("pump invoked while inactive — nothing to do")
            yield False, None
            return

        gen = self._pump_gen  # this pump is valid while gen is current
        self._cancel.clear()
        consecutive_failures = 0
        for index in range(start_index, end_index):
            if (
                gen != self._pump_gen
                or self._cancel.is_set()
                or index >= len(self.queue)
            ):
                self.update_status("generation cancelled — queue emptied")
                yield False, None
                return

            status, audio = self.generate_audio_for_sentence_index(
                index, temperature, topk=topk, speed_factor=speed_factor
            )
            self.update_status(status)
            if audio is None:
                if gen != self._pump_gen or index >= len(self.queue):
                    yield False, None  # cleared mid-flight by an interrupt
                    return
                # a failed sentence is skipped and the narration goes on;
                # three failures in a row mean the engine is down: stop
                consecutive_failures += 1
                if consecutive_failures >= 3:
                    self.update_status(
                        f"{consecutive_failures} consecutive sentence "
                        f"failures — engine looks down, aborting narration"
                    )
                    yield False, None
                    return
                self.update_status(
                    f"sentence {index + 1} failed — skipped, continuing"
                )
                continue
            consecutive_failures = 0
            self.stream_audio_response(audio)
            yield True, audio

        self.update_status("speech queue complete")
        yield False, None
