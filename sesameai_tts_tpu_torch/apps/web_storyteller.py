"""Storyteller app: long-form narration with per-prompt audio groups (port
of ``sesameai_tts_tpu/apps/web_storyteller.py``).

``StorytellerApp``: LLM story mode and pasted-text mode, a continuation
mode that appends sentences while the earlier prompts' audio replays,
per-prompt WAV persistence (``prompt_NN.wav`` in a session temp dir), and
a full-story combine into a timestamped file.  The Gradio UI in ``main``
is optional; the logic class does not need it.  The engine runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
from typing import List, Optional

from sesameai_tts_tpu_torch.apps.web_base import WebAppBase
from sesameai_tts_tpu_torch.audio.segment import AudioClip
from sesameai_tts_tpu_torch.llm.client import global_config as llm_config

logger = logging.getLogger(__name__)

STORYTELLER_SYSTEM_PROMPT = (
    "You are a master storyteller narrating aloud. Continue the story in "
    "flowing prose suitable for speech: no headings, no lists, no markup, "
    "numbers written as words. Keep continuity with everything so far."
)


class StorytellerApp(WebAppBase):
    def __init__(self, voice: Optional[str] = None, model: str = "local-default", **kw):
        llm_config.SYSTEM_MESSAGE = STORYTELLER_SYSTEM_PROMPT
        super().__init__(voice=voice, model=model, **kw)
        # one list of clips per prompt
        self.prompt_audio_segments: List[List[AudioClip]] = []
        self.story_parts: List[str] = []
        self.generated_prompt_wav_paths: List[str] = []  # per-prompt WAVs for
        #   the UI's segment-files list
        self._prompt_counter = 0  # monotonic across soft resets: a new
        #   story must not overwrite the previous story's WAVs
        self.session_dir = os.path.join(tempfile.gettempdir(), "storyteller_audio")
        self._reset_session_dir()

    def _reset_session_dir(self):
        """Fresh session dir on start."""
        shutil.rmtree(self.session_dir, ignore_errors=True)
        os.makedirs(self.session_dir, exist_ok=True)

    # -- story advancement --------------------------------------------------

    def continue_story(self, prompt: str, use_llm: bool = True,
                       is_continuation: bool = True):
        """Either ask the LLM to continue with `prompt`, or treat `prompt`
        as pasted story text directly (the two tab modes).
        ``is_continuation=False``
        is the "Start New Story/Text" button: in-memory story state and
        the UI file list reset, but WAVs already exported stay on disk
        (only the explicit Reset Session purges them — an accidental
        Enter must not delete narration).

        Yields (story_text, status, start_idx, end_idx, active,
        replay_audio). When continuing an existing story, ``replay_audio``
        on the final yield carries all previously narrated audio combined
        as a ``(sample_rate, float32)`` tuple so the player restarts from
        the top before the new part streams in."""
        prompt = (prompt or "").strip()
        if not prompt:
            yield self.story_text, "Empty prompt.", 0, 0, False, None
            return

        if not is_continuation and self.story_parts:
            # start-over is NON-destructive on disk: in-memory story and
            # the UI file list reset, but WAVs already exported stay (the
            # explicit Reset Session button purges them). Enter in the
            # prompt box routes here (Enter = new story): an accidental
            # keypress must not delete narration.
            self.interrupt_and_reset()
            self.story_parts = []
            self.prompt_audio_segments = []
            self.generated_prompt_wav_paths = []
            self.clear_ui()

        if use_llm:
            yield self.story_text, "Writing the next part...", 0, 0, False, None
            try:
                part = self.llm.query(prompt, plaintext_output=True, stream=False)
            except Exception as e:
                logger.exception("LLM failed")
                yield self.story_text, f"LLM error: {e}", 0, 0, False, None
                return
        else:
            part = prompt

        replay = self.replay_audio() if self.story_parts else None
        self.story_parts.append(part)
        self.prompt_audio_segments.append([])
        new_sentences = self.split_text_into_sentences(part)
        start_idx, end_idx = self.queue.enqueue(new_sentences)
        yield (
            self.story_text,
            f"Narrating {len(new_sentences)} sentences...",
            start_idx,
            end_idx,
            True,
            replay,
        )

    def replay_audio(self):
        """All previously narrated audio combined → (sr, float32) Gradio
        tuple, or None when nothing has been narrated yet."""
        clips = [c for group in self.prompt_audio_segments for c in group]
        if not clips:
            return None
        combined = AudioClip.concat(clips)
        return combined.sample_rate, combined.samples

    @property
    def story_text(self) -> str:
        return "\n\n".join(self.story_parts)

    def _store_audio_segment(self, clip: AudioClip, sentence_index: int):
        if not self.prompt_audio_segments:
            self.prompt_audio_segments.append([])
        self.prompt_audio_segments[-1].append(clip)

    # -- persistence --------------------------------------------------------

    def save_current_prompt_audio(self) -> Optional[str]:
        """Combine the latest prompt group → prompt_NN.wav."""
        if not self.prompt_audio_segments or not self.prompt_audio_segments[-1]:
            return None
        group = self.prompt_audio_segments[-1]
        combined = AudioClip.concat(group)
        self._prompt_counter += 1
        path = os.path.join(
            self.session_dir, f"prompt_{self._prompt_counter:02d}.wav"
        )
        combined.export(path)
        self.temp_audio_files.append(path)
        self.generated_prompt_wav_paths.append(path)
        return path

    def combine_full_story(self) -> Optional[str]:
        """All prompts → one timestamped WAV."""
        clips = [c for group in self.prompt_audio_segments for c in group]
        if not clips:
            return None
        combined = AudioClip.concat(clips)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.session_dir, f"story_{stamp}.wav")
        combined.export(path)
        return path

    def sentence_generator_loop(self, *args, **kwargs):
        """Auto-save the prompt group when the loop drains, and only after
        this run produced audio: an inactive or empty pump (empty prompt,
        failed LLM call) must not save the previous prompt's group again as
        a duplicate prompt_NN.wav."""
        produced = 0
        for item in super().sentence_generator_loop(*args, **kwargs):
            active, audio = item
            if active and audio is not None:
                produced += 1
            if not active and produced:
                saved = self.save_current_prompt_audio()
                if saved:
                    self.update_status(f"Saved prompt audio: {saved}")
            yield item

    def reset_story(self):
        """Hard reset (the Reset Session button): also wipes the session
        dir and every exported WAV."""
        self.story_parts = []
        self.prompt_audio_segments = []
        self.generated_prompt_wav_paths = []
        self._prompt_counter = 0
        self.clear_session()
        self._reset_session_dir()

    def clear_session_for_ui(self):
        """Reset + the full tuple of cleared UI values: chat/story, status,
        index, active, audio, segment files, story download, both text
        inputs."""
        self.reset_story()
        return ("", "Session reset. Ready.", (0, 0), False, None, [], [], "", "")

    def clear_ui(self):
        self.llm.history_manager.clear_history()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="CSM storyteller (PyTorch)")
    parser.add_argument("-m", "--model", type=str, default="local-default")
    parser.add_argument("-v", "--voice", type=str, default=None)
    parser.add_argument("--voices", type=str, default=None)
    parser.add_argument("--flavor", type=str, default="csm-1b",
                        choices=["csm-1b", "test-tiny"])
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="Device to run on (cuda or cpu)")
    parser.add_argument("--port", type=int, default=7861)
    args = parser.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(
            "gradio is not installed; install it to serve the web UI. "
            "The StorytellerApp logic class works without it."
        )

    from sesameai_tts_tpu_torch.runtime.loader import csm_1b_spec, test_tiny_spec

    spec = test_tiny_spec() if args.flavor == "test-tiny" else csm_1b_spec()
    app = StorytellerApp(voice=args.voice, model=args.model, spec=spec, voices=args.voices,
                         device=args.device)

    # status+reset header, voice radio beside the stream player, tts
    # sliders, New/Continue tab pairs, segment-file list, full-story save
    with gr.Blocks(title="Storyteller TTS (PyTorch)", theme=gr.themes.Soft()) as demo:
        gr.Markdown("# Storyteller TTS")

        with gr.Row():
            status = gr.Textbox(label="Status", lines=1, interactive=False,
                                value="Ready.", scale=8)
            reset_btn = gr.Button("Reset Session", variant="stop", scale=1,
                                  min_width=150)
        with gr.Row():
            voice_radio = gr.Radio(
                label="Select Voice", choices=app.list_available_voices(),
                value=app.current_voice, interactive=True, scale=4,
            )
            audio_out = gr.Audio(
                label="Narration Stream", autoplay=True, streaming=True,
                show_download_button=False, interactive=False, scale=6,
            )
        with gr.Row():
            temp = gr.Slider(
                0.1, 1.0, step=0.05, value=0.8, label="Temperature (Creativity)",
                info="Lower = more predictable, Higher = more creative", scale=3,
            )
            topk = gr.Slider(
                10, 100, step=5, value=40, label="Top-K (Variety)",
                info="Lower = more focused, Higher = more varied options", scale=3,
            )
            speed = gr.Slider(1.0, 2.0, step=0.05, value=1.0,  # speedup-only
                              label="Speech Speed", scale=2)

        rng_state = gr.State((0, 0))
        act_state = gr.State(False)

        with gr.Tabs():
            with gr.TabItem("LLM Story Generation"):
                prompt = gr.Textbox(
                    placeholder="Start or continue a story...",
                    label="LLM Prompt", lines=1,
                )
                with gr.Row():
                    new_story_btn = gr.Button("✨ Start New Story",
                                              variant="primary", size="sm")
                    continue_btn = gr.Button("➡️ Continue Story",
                                             variant="secondary", size="sm")
                story = gr.Textbox(label="Story so far", lines=12,
                                   interactive=False)
            with gr.TabItem("Pasted Text Input"):
                pasted = gr.Textbox(label="Paste Text Here", lines=10)
                with gr.Row():
                    new_text_btn = gr.Button("✨ Start New Text",
                                             variant="primary", size="sm")
                    append_text_btn = gr.Button("➡️ Append Text",
                                                variant="secondary", size="sm")

        seg_files = gr.File(label="Segment Audio Files (WAV)",
                            file_count="multiple", interactive=False, height=100)
        with gr.Row():
            save_btn = gr.Button("💾 Generate & Download Full Story (WAV)",
                                 scale=1)
            story_file = gr.File(label="Full Story Download(s)",
                                 file_count="multiple", interactive=False,
                                 scale=3, height=40)

        def drive(p, use_llm, is_continuation):
            for text, st, s, e, a, replay in app.continue_story(
                p, use_llm=use_llm, is_continuation=is_continuation
            ):
                # continuation: replay everything narrated so far first;
                # leave the player untouched (gr.update()) when there is
                # nothing to replay — a None would reset it mid-playback
                yield text, st, (s, e), a, (
                    replay if replay is not None else gr.update()
                ), app.generated_prompt_wav_paths

        def pump(rng, active, t, tk, sp):
            for act, audio in app.sentence_generator_loop(
                rng[0], rng[1], active, temperature=t, topk=int(tk),
                speed_factor=sp,
            ):
                yield (
                    audio if audio is not None else gr.update(),
                    app.generated_prompt_wav_paths,
                )

        drive_out = [story, status, rng_state, act_state, audio_out, seg_files]
        pump_in = [rng_state, act_state, temp, topk, speed]
        pump_out = [audio_out, seg_files]

        def wire(trigger, source, use_llm, is_continuation, clear_input):
            chain = trigger(
                drive, [source, gr.State(use_llm), gr.State(is_continuation)],
                drive_out,
            )
            if clear_input:
                chain = chain.then(lambda: "", [], [source])
            chain.then(pump, pump_in, pump_out)

        wire(new_story_btn.click, prompt, True, False, True)
        wire(continue_btn.click, prompt, True, True, True)
        wire(prompt.submit, prompt, True, False, True)  # Enter = new story
        wire(new_text_btn.click, pasted, False, False, False)
        wire(append_text_btn.click, pasted, False, True, False)

        save_btn.click(
            lambda: ([p] if (p := app.combine_full_story()) else [],
                     "Full story saved." if p else "Nothing to save."),
            [], [story_file, status],
        )
        reset_btn.click(
            app.clear_session_for_ui, [],
            [story, status, rng_state, act_state, audio_out, seg_files,
             story_file, prompt, pasted],
        )
        voice_radio.change(app.change_voice, [voice_radio], [status])

    demo.queue(max_size=20).launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
