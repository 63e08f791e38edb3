"""The port's app UIs: each ``main()`` of ``sesameai_tts_tpu_torch/apps``
builds its Blocks under ``tests/fake_gradio.py`` with ``--device cpu`` (as
``tests/test_apps_ui.py`` does for the JAX package), then the recorded
event chains are fired against the real app logic (tiny generator on the
CPU, fake LLM).  Without ``--device`` each ``main`` asks for the card, and
so raises on a host without one."""

import sys
import types

import numpy as np
import pytest
import torch

import fake_gradio
from sesameai_tts_tpu_torch.apps import duplex, web_chat, web_storyteller
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.llm.client import HistoryManager
from sesameai_tts_tpu_torch.service import tts as t_tts

SENTENCE_MS = 1600  # each sentence capped at 20 tiny frames


class FakeLLM:
    def __init__(self, response="One sentence. Two sentences!"):
        self.response = response
        self.history_manager = HistoryManager()

    def query(self, q, plaintext_output=True, stream=False):
        return iter([self.response]) if stream else self.response


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def voices_root(tmp_path):
    vdir = tmp_path / "v"
    vdir.mkdir()
    wav = (np.random.default_rng(0).normal(size=2400) * 0.1).astype(np.float32)
    write_wav(str(vdir / "c.wav"), wav, 24_000)
    (vdir / "c.txt").write_text("clip")
    return str(tmp_path)


@pytest.fixture()
def ui_env(monkeypatch, voices_root, tmp_path):
    monkeypatch.setitem(sys.modules, "gradio", fake_gradio)
    monkeypatch.setattr("sesameai_tts_tpu_torch.apps.web_base.AskLLM", lambda **kw: FakeLLM())
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the storyteller's session dir
    segment = t_tts.TTS.generate_audio_segment
    monkeypatch.setattr(t_tts.TTS, "generate_audio_segment",
                        lambda self, *a, **kw: segment(
                            self, *a, **{"max_audio_length_ms": SENTENCE_MS, **kw}))
    fake_gradio.Blocks.last = None
    return voices_root


def test_web_chat_main_wiring(ui_env):
    web_chat.main(["--flavor", "test-tiny", "-v", "v", "--voices", ui_env, "--device", "cpu"])
    demo = fake_gradio.Blocks.last
    assert demo is not None and demo.title == "Sesame Chat (PyTorch)"
    assert demo.queue_kwargs == {"max_size": 20}
    assert demo.launch_kwargs["server_port"] == 7860

    chatbot = next(c for c in demo.components if isinstance(c, fake_gradio.Chatbot))
    query = next(c for c in demo.components
                 if isinstance(c, fake_gradio.Textbox) and c.kwargs.get("autofocus"))
    audio_out = demo.by_label("TTS Narration")
    send = next(c for c in demo.components if c.value == "Send")
    clear = next(c for c in demo.components if c.value == "Clear Conversation")

    # send.click: interrupt → submit → clear-input → audio pump
    ev = demo.event_for(send, "click")
    assert len(ev.steps) == 4
    assert len(demo.event_for(query, "submit").steps) == 4

    query.value = "hello there"
    ev.fire()
    assert query.value == ""
    assert chatbot.value[-1]["role"] == "assistant"
    assert "sentence" in chatbot.value[-1]["content"].lower()
    sr, pcm = audio_out.value
    assert sr == 24_000 and pcm.dtype == np.float32 and len(pcm) > 0

    demo.event_for(clear, "click").fire()
    assert chatbot.value == [] and audio_out.value is None

    status = demo.by_label("Status")
    voice_dd = demo.by_label("Select Voice")
    demo.event_for(voice_dd, "change").fire()
    assert "v" in str(status.value)
    editor = demo.by_label("Edit System Prompt")
    editor.value = "You are a pirate narrator."
    update_btn = next(c for c in demo.components if c.value == "Update System Prompt")
    demo.event_for(update_btn, "click").fire()
    assert "updated" in str(status.value).lower()


def test_web_storyteller_main_wiring(ui_env):
    web_storyteller.main(["--flavor", "test-tiny", "-v", "v", "--voices", ui_env,
                          "--device", "cpu"])
    demo = fake_gradio.Blocks.last
    assert demo is not None and demo.title == "Storyteller TTS (PyTorch)"
    assert demo.launch_kwargs["server_port"] == 7861

    story = demo.by_label("Story so far")
    prompt = demo.by_label("LLM Prompt")
    pasted = demo.by_label("Paste Text Here")
    audio_out = demo.by_label("Narration Stream")
    seg_files = demo.by_label("Segment Audio Files (WAV)")
    status = demo.by_label("Status")
    buttons = {c.value: c for c in demo.components if isinstance(c, fake_gradio.Button)}

    for name, steps in [("✨ Start New Story", 3), ("➡️ Continue Story", 3),
                        ("✨ Start New Text", 2), ("➡️ Append Text", 2)]:
        assert len(demo.event_for(buttons[name], "click").steps) == steps
    assert len(demo.event_for(prompt, "submit").steps) == 3

    prompt.value = "begin the story"
    demo.event_for(buttons["✨ Start New Story"], "click").fire()
    assert prompt.value == ""
    assert "sentence" in str(story.value).lower()
    assert [p.endswith("prompt_01.wav") for p in seg_files.value] == [True]
    sr, pcm = audio_out.value
    assert sr == 24_000 and len(pcm) > 0

    pasted.value = "Direct text here."
    demo.event_for(buttons["✨ Start New Text"], "click").fire()
    assert pasted.value == "Direct text here."
    assert "direct text" in str(story.value).lower()
    assert seg_files.value and seg_files.value[-1].endswith(".wav")

    demo.event_for(buttons["💾 Generate & Download Full Story (WAV)"], "click").fire()
    story_file = demo.by_label("Full Story Download(s)")
    assert story_file.value and story_file.value[0].endswith(".wav")
    assert "saved" in str(status.value).lower()

    demo.event_for(buttons["Reset Session"], "click").fire()
    assert story.value == "" and seg_files.value == []


def _fake_fastrtc(monkeypatch):
    recorded = {}

    class ReplyOnPause:
        def __init__(self, fn, can_interrupt=False):
            recorded["fn"], recorded["can_interrupt"] = fn, can_interrupt

    class Stream:
        def __init__(self, handler):
            recorded["handler"] = handler
            self.ui = self

        def launch(self, **kw):
            recorded["launched"] = kw

    fake_rtc = types.ModuleType("fastrtc")
    fake_rtc.ReplyOnPause, fake_rtc.Stream = ReplyOnPause, Stream
    monkeypatch.setitem(sys.modules, "fastrtc", fake_rtc)
    monkeypatch.setattr("sesameai_tts_tpu_torch.apps.duplex.AskLLM", lambda *a, **kw: FakeLLM())
    return recorded


def test_duplex_main_wiring(monkeypatch):
    recorded = _fake_fastrtc(monkeypatch)
    duplex.main(["--flavor", "test-tiny", "--device", "cpu"])
    assert recorded["can_interrupt"] is True and "launched" in recorded
    # the wired handler is the documented stub: it demands a real STT
    gen = recorded["fn"]((24_000, np.zeros(2400, np.float32)))
    with pytest.raises(SystemExit, match="STT"):
        list(gen)


def test_duplex_main_without_fastrtc_exits_with_the_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastrtc", None)  # import fails
    with pytest.raises(SystemExit, match="fastrtc is not installed"):
        duplex.main(["--flavor", "test-tiny", "--device", "cpu"])


def test_web_main_without_gradio_exits(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    for main in (web_chat.main, web_storyteller.main):
        with pytest.raises(SystemExit, match="gradio is not installed"):
            main(["--flavor", "test-tiny", "--device", "cpu"])


@pytest.mark.parametrize("app", ["web_chat", "web_storyteller", "duplex"])
def test_main_without_device_asks_for_the_card(app, ui_env, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _fake_fastrtc(monkeypatch)
    main = {"web_chat": web_chat, "web_storyteller": web_storyteller, "duplex": duplex}[app].main
    argv = ["--flavor", "test-tiny"] + ([] if app == "duplex" else ["--voices", ui_env])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
