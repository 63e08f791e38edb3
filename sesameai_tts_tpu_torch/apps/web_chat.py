"""Web chat app: conversational LLM + incremental TTS (port of
``sesameai_tts_tpu/apps/web_chat.py``).

``ChatApp`` carries the whole app logic (query → LLM → sentence split →
per-sentence audio streaming) with the companion system prompt (numbers
written for speech, no emojis or markup).  ``main`` builds the Gradio
Blocks UI when gradio is installed; the logic class does not need it.
The engine runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional, Tuple

from sesameai_tts_tpu_torch.apps.web_base import WebAppBase
from sesameai_tts_tpu_torch.llm.client import global_config as llm_config

logger = logging.getLogger(__name__)

COMPANION_SYSTEM_PROMPT = (
    "You are a friendly voice companion. Your replies are spoken aloud by a "
    "text-to-speech engine, so: write numbers out as words, avoid emojis, "
    "markup, bullet lists and code, keep sentences natural and conversational, "
    "and keep responses reasonably short unless asked for detail."
)


class ChatApp(WebAppBase):
    def __init__(self, voice: Optional[str] = None, model: str = "local-default", **kw):
        llm_config.SYSTEM_MESSAGE = COMPANION_SYSTEM_PROMPT
        super().__init__(voice=voice, model=model, **kw)
        self.messages = []  # chat history as (role, content) dicts

    # -- main query pipeline -------------------------------------------------

    def process_query(
        self, query: str, temperature: float = 0.9
    ) -> Iterator[Tuple[list, str, int, int, bool]]:
        """Yields (messages, status, start_idx, end_idx, active)."""
        query = (query or "").strip()
        if not query:
            yield self.messages, "Empty query.", 0, 0, False
            return

        self.messages.append({"role": "user", "content": query})
        yield self.messages, "Thinking...", 0, 0, False

        try:
            llm_config.TEMPERATURE = temperature
            response = self.llm.query(query, plaintext_output=True, stream=False)
        except Exception as e:
            logger.exception("LLM query failed")
            self.messages.append(
                {"role": "assistant", "content": f"(LLM error: {e})"}
            )
            yield self.messages, f"LLM error: {e}", 0, 0, False
            return

        self.messages.append({"role": "assistant", "content": response})

        new_sentences = self.split_text_into_sentences(response)
        start_idx, end_idx = self.queue.enqueue(new_sentences)

        yield (
            self.messages,
            f"Generating audio for {len(new_sentences)} sentences...",
            start_idx,
            end_idx,
            True,
        )

    def clear_ui(self):
        self.messages = []
        self.llm.history_manager.clear_history()

    def clear_session(self):
        """Full reset: chat history, LLM history, audio queue.  The base
        clear_session invokes our clear_ui override, which wipes messages
        + LLM history."""
        super().clear_session()
        return (
            [],
            f"Session cleared. Ready. (Model: {self.current_model}, "
            f"Voice: {self.current_voice})",
            None,
            (0, 0),
            False,
        )

    def update_system_prompt(self, new_prompt: str) -> str:
        """Swap the live system prompt and rebuild the LLM client with it."""
        with self.lock:
            old = llm_config.SYSTEM_MESSAGE
            llm_config.SYSTEM_MESSAGE = (new_prompt or "").strip()
            err = self._swap_llm(self.current_resolved_alias)
            if err:  # keep global config consistent with the live client
                llm_config.SYSTEM_MESSAGE = old
        if err:
            return f"Error updating system prompt: {err}"
        return f"System prompt updated. Model: {self.current_model}"


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="CSM web chat (PyTorch)")
    parser.add_argument("-m", "--model", type=str, default="local-default")
    parser.add_argument("-v", "--voice", type=str, default=None)
    parser.add_argument("--voices", type=str, default=None)
    parser.add_argument("--flavor", type=str, default="csm-1b",
                        choices=["csm-1b", "test-tiny"])
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="Device to run on (cuda or cpu)")
    parser.add_argument("--port", type=int, default=7860)
    args = parser.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(
            "gradio is not installed; install it to serve the web UI. "
            "The ChatApp logic class works without it."
        )

    from sesameai_tts_tpu_torch.runtime.loader import csm_1b_spec, test_tiny_spec

    spec = test_tiny_spec() if args.flavor == "test-tiny" else csm_1b_spec()
    app = ChatApp(voice=args.voice, model=args.model, spec=spec, voices=args.voices,
                  device=args.device)

    # controls column (player, status, prompt editor, model/voice/sliders)
    # beside the chat column (transcript + input + send/clear)
    with gr.Blocks(title="Sesame Chat (PyTorch)", theme=gr.themes.Soft()) as demo:
        gr.Markdown("# 💬 Chat with TTS")
        state_active = gr.State(False)
        state_range = gr.State((0, 0))

        with gr.Row():
            with gr.Column(scale=1):
                audio_out = gr.Audio(
                    label="TTS Narration", autoplay=True, streaming=True,
                    show_download_button=False, interactive=False,
                )
                status = gr.Textbox(label="Status", lines=3, interactive=False,
                                    value="Ready.")
                with gr.Accordion("System Prompt", open=False):
                    prompt_editor = gr.Textbox(
                        label="Edit System Prompt", lines=5, interactive=True,
                        value=COMPANION_SYSTEM_PROMPT,
                    )
                    update_prompt = gr.Button("Update System Prompt",
                                              variant="secondary")
                model_dd = gr.Dropdown(
                    choices=app.available_models, value=app.current_model,
                    label="Select Model", interactive=True,
                )
                voice_dd = gr.Dropdown(
                    choices=app.list_available_voices(), value=app.current_voice,
                    label="Select Voice", interactive=True,
                )
                temp = gr.Slider(0.1, 1.2, step=0.1, value=0.9,
                                 label="Temperature")
                speed = gr.Slider(
                    1.0, 2.0, step=0.05, value=1.0, label="Speech Speed",  # speedup-only (AudioClip.speedup no-ops <=1)
                    info="Higher values = faster speech (1.0 = normal speed)",
                )

            with gr.Column(scale=2):
                chatbot = gr.Chatbot(height=600, type="messages")
                query = gr.Textbox(
                    placeholder="Type your message here...", lines=1,
                    show_label=False, autofocus=True,
                )
                with gr.Row():
                    send = gr.Button("Send", variant="primary")
                    clear = gr.Button("Clear Conversation", variant="stop")

        def on_submit(q, t):
            final = None
            for msgs, st, s_idx, e_idx, active in app.process_query(q, t):
                final = (msgs, st, (s_idx, e_idx), active)
                yield msgs, st, (s_idx, e_idx), active
            if final is None:
                yield app.messages, "No response", (0, 0), False

        def on_audio(rng, active, t, sp):
            start_idx, end_idx = rng
            for act, audio in app.sentence_generator_loop(
                start_idx, end_idx, active, temperature=t, speed_factor=sp
            ):
                if audio is not None:
                    yield audio

        send.click(app.interrupt_and_reset, [], []).then(
            on_submit, [query, temp], [chatbot, status, state_range, state_active]
        ).then(lambda: "", [], [query]).then(
            on_audio, [state_range, state_active, temp, speed], [audio_out]
        )
        query.submit(app.interrupt_and_reset, [], []).then(
            on_submit, [query, temp], [chatbot, status, state_range, state_active]
        ).then(lambda: "", [], [query]).then(
            on_audio, [state_range, state_active, temp, speed], [audio_out]
        )
        clear.click(
            app.clear_session, [],
            [chatbot, status, audio_out, state_range, state_active],
        )
        voice_dd.change(app.change_voice, [voice_dd], [status])
        model_dd.change(app.change_model, [model_dd], [status])
        update_prompt.click(app.update_system_prompt, [prompt_editor], [status])

    demo.queue(max_size=20).launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
