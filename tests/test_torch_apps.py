"""The port's app layer (``sesameai_tts_tpu_torch/apps``) against the JAX
package's at the tiny f32 flavor, on the CPU.

Both packages' ``TTS`` engines get Generators over one parameter tree (the
JAX package draws it, the port converts it), with the watermark off: the
apps only pass audio through it, ``tests/test_torch_service.py`` holds it,
and it amplifies 1e-6 PCM differences ~1e4-fold in its first samples.
The same fake LLM text and STT string drive ``ChatApp``, the storyteller
(both modes, the replay, the combined WAV) and ``DuplexVoiceApp.respond``
in both packages; greedy (``topk=1``), the port's clips equal the JAX
app's within ``PCM_RTOL`` of their peak (the Generator tests' bound,
``tests/test_torch_service.py::_close_pcm``) and the duplex context holds
the same rows after each turn.  The pump's abort after three failures and
its generation-token interrupt, the status strings and
``sentence_stream`` are held against the JAX functions exactly."""

import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.apps import duplex as j_duplex
from sesameai_tts_tpu.apps import tts_base as j_tts_base
from sesameai_tts_tpu.apps import web_chat as j_web_chat
from sesameai_tts_tpu.apps import web_storyteller as j_web_storyteller
from sesameai_tts_tpu.audio import segment as j_segment
from sesameai_tts_tpu.llm import client as j_client
from sesameai_tts_tpu.runtime import frames as j_frames
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu.service import tts as j_tts
from sesameai_tts_tpu_torch.apps import duplex, tts_base, web_chat, web_storyteller
from sesameai_tts_tpu_torch.audio import segment
from sesameai_tts_tpu_torch.audio.io import read_wav, write_wav
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.llm import client
from sesameai_tts_tpu_torch.runtime import frames
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.service import tts as t_tts
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

# f32 PCM relative to its peak, as tests/test_torch_service.py
PCM_RTOL = 1e-5
# each synthesized sentence is capped at 20 tiny frames in both packages
SENTENCE_MS = 1600
STORY = "Once upon a time. The crab left home."
CHAT_DELTAS = ["One sen", "tence. Two sen", "tences! And three", " more?"]

# the packages, side by side: (JAX, port)
PKGS = {
    "jax": dict(chat=j_web_chat, story=j_web_storyteller, duplex=j_duplex, base=j_tts_base,
                client=j_client, segment=j_segment, frames=j_frames,
                web_base="sesameai_tts_tpu.apps.web_base"),
    "port": dict(chat=web_chat, story=web_storyteller, duplex=duplex, base=tts_base,
                 client=client, segment=segment, frames=frames,
                 web_base="sesameai_tts_tpu_torch.apps.web_base"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread per test worker (see
    tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_llm_configs():
    """The apps write their package's ``global_config``; put it back."""
    saved = [(c.global_config, dict(vars(c.global_config))) for c in (j_client, client)]
    yield
    for cfg, values in saved:
        vars(cfg).update(values)


def _close_pcm(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_RTOL * max(np.abs(want).max(), 1e-6))


class FakeLLM:
    """A scripted LLM: the same text for every query, whole or as deltas."""

    def __init__(self, history_cls, deltas=("One sentence. Two sentences!",)):
        self.deltas = list(deltas)
        self.queries = []
        self.history_manager = history_cls()

    def query(self, q, plaintext_output=True, stream=False):
        self.queries.append((q, stream))
        return iter(self.deltas) if stream else "".join(self.deltas)


def _fake_llm(pkg, deltas):
    return FakeLLM(PKGS[pkg]["client"].HistoryManager, deltas)


@pytest.fixture(scope="module")
def voice_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    vdir = root / "v"
    vdir.mkdir()
    wav = (np.random.default_rng(0).normal(size=2400) * 0.1).astype(np.float32)
    write_wav(str(vdir / "c.wav"), wav, 24_000)
    (vdir / "c.txt").write_text("clip")
    return str(root)


@pytest.fixture(scope="module")
def engines(voice_dir):
    """{"jax": TTS, "port": TTS} over one tiny parameter tree, watermark off,
    each sentence capped at SENTENCE_MS."""
    jt = j_tts.TTS(spec=j_tiny_spec(), voices=voice_dir, enable_watermark=False)
    jt.load_model()
    jg = jt.generator
    tt = t_tts.TTS(spec=tiny_spec(), voices=voice_dir, enable_watermark=False, device="cpu")
    tt.generator = Generator(from_jax_params(jax.tree.map(np.asarray, jg._params)),
                             csm_test_tiny(), Mimi(mimi_test_tiny()),
                             from_jax_params(jax.tree.map(np.asarray, jg._mimi_params)),
                             TinyHashTokenizer(), decode_chunk_frames=4, device="cpu")
    for e in (jt, tt):
        e.generate_audio_segment = functools.partial(e.generate_audio_segment,
                                                     max_audio_length_ms=SENTENCE_MS)
    return {"jax": jt, "port": tt}


def _app(pkg, kind, engine, monkeypatch, tmp_path, deltas=(STORY,)):
    """A ChatApp or StorytellerApp of one package over ``engine`` with a
    FakeLLM, its session directory under tmp_path/pkg."""
    llm = _fake_llm(pkg, deltas)
    monkeypatch.setattr(PKGS[pkg]["web_base"] + ".AskLLM", lambda **kw: llm)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / pkg))
    (tmp_path / pkg).mkdir(exist_ok=True)
    mod = PKGS[pkg][kind]
    cls = mod.ChatApp if kind == "chat" else mod.StorytellerApp
    return cls(voice="v", model="local-default", tts=engine)


def _pump(app, s, e, **kw):
    return list(app.sentence_generator_loop(s, e, True, temperature=0.8, topk=1, **kw))


def _audio(items):
    return [a for _, a in items if a is not None]


def _same_clips(got, want):
    assert len(got) == len(want) > 0
    for (sr, pcm), (jsr, jpcm) in zip(got, want):
        assert sr == jsr == 24_000 and pcm.dtype == np.float32
        _close_pcm(pcm, jpcm)


# ---------------------------------------------------------------------------
# sentence_stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deltas", [
    ["Hel", "lo there. How ", "are you? I am", " fine. trailing bit"],
    ["It costs 1", ".5 dollars today", ". Done."],
    ["One.", " Two!", " Three?"],
    ["No boundary at all"],
    ["Ends on a boundary."],
    ["", "  ", "Wait... ", "what?!", " Yes."],
    ["Multi\nline. Next\n", "one!"],
    [],
])
def test_sentence_stream_equals_jax(deltas):
    got = list(duplex.sentence_stream(iter(deltas)))
    assert got == list(j_duplex.sentence_stream(iter(deltas)))


# ---------------------------------------------------------------------------
# chat
# ---------------------------------------------------------------------------


def test_chat_app_equals_jax(engines, monkeypatch, tmp_path):
    """process_query's yields, the pump's clips at topk=1 and speed 1.2 with
    its terminator, clear_session's UI tuple and update_system_prompt."""
    runs = {}
    for pkg in ("jax", "port"):
        app = _app(pkg, "chat", engines[pkg], monkeypatch, tmp_path, CHAT_DELTAS)
        outs = list(app.process_query("hello", temperature=0.9))
        _, _, s, e, active = outs[-1]
        assert active and e - s == 3
        pumped = _pump(app, s, e, speed_factor=1.2)
        assert pumped[-1] == (False, None)
        runs[pkg] = dict(app=app, outs=outs, pumped=pumped, status=app.last_status,
                         cleared=app.clear_session(), messages=list(app.messages),
                         prompt=app.update_system_prompt("You are a pirate narrator."),
                         system=PKGS[pkg]["client"].global_config.SYSTEM_MESSAGE)
    j, p = runs["jax"], runs["port"]
    assert [o[1:] for o in p["outs"]] == [o[1:] for o in j["outs"]]
    assert p["outs"][-1][0] == j["outs"][-1][0]
    assert p["outs"][-1][0][-1] == {"role": "assistant", "content": "".join(CHAT_DELTAS)}
    assert [a for a, _ in p["pumped"]] == [a for a, _ in j["pumped"]]
    _same_clips(_audio(p["pumped"]), _audio(j["pumped"]))
    assert p["status"] == j["status"] == "speech queue complete"
    assert p["cleared"][1:] == j["cleared"][1:] and p["cleared"][0] == []
    assert p["messages"] == j["messages"] == []
    assert p["prompt"] == j["prompt"] and "updated" in p["prompt"]
    assert p["system"] == j["system"] == "You are a pirate narrator."
    assert p["app"].llm is not j["app"].llm


def test_chat_pump_clip_is_the_engine_segment_sped_up(engines, monkeypatch, tmp_path):
    """One sentence through the pump equals ``generate_audio_segment`` with
    the app's shaping, then ``speedup(1.2)``, called directly."""
    app = _app("port", "chat", engines["port"], monkeypatch, tmp_path, ["Just this one."])
    _, _, s, e, _ = list(app.process_query("hi"))[-1]
    (sr, pcm), = _audio(_pump(app, s, e, speed_factor=1.2))
    direct = engines["port"].generate_audio_segment(
        "Just this one.", temperature=0.8, topk=1, fade_duration=app.FADE_MS,
        start_silence_duration=app.LEAD_SILENCE_MS, end_silence_duration=app.TAIL_SILENCE_MS,
    ).speedup(playback_speed=1.2)
    assert sr == direct.sample_rate
    np.testing.assert_array_equal(pcm, direct.samples)


# ---------------------------------------------------------------------------
# storyteller
# ---------------------------------------------------------------------------


def test_storyteller_equals_jax(engines, monkeypatch, tmp_path):
    """LLM mode, then pasted text: the replay carries exactly the audio
    narrated before the continuation, prompt WAVs are saved on drain, and
    the combined story WAV holds every narrated sample."""
    runs = {}
    for pkg in ("jax", "port"):
        app = _app(pkg, "story", engines[pkg], monkeypatch, tmp_path)
        first = list(app.continue_story("begin the story", use_llm=True))
        _, _, s, e, active, replay = first[-1]
        assert active and e - s == 2 and replay is None
        pumped = _pump(app, s, e)
        narrated = sum(len(c.samples) for g in app.prompt_audio_segments for c in g)
        second = list(app.continue_story("Direct text here. And more.", use_llm=False))
        _, _, s2, e2, active2, replay2 = second[-1]
        assert active2 and (s2, e2) == (2, 4)
        assert replay2[0] == 24_000 and len(replay2[1]) == narrated > 0
        pumped += _pump(app, s2, e2)
        clips = [c for g in app.prompt_audio_segments for c in g]
        path = app.combine_full_story()
        wav, rate = read_wav(path)
        assert rate == 24_000 and wav.shape == (1, sum(len(c.samples) for c in clips))
        runs[pkg] = dict(app=app, first=first, second=second, pumped=pumped, replay=replay2,
                         wav=wav[0], clips=clips)
    j, p = runs["jax"], runs["port"]
    assert [o[:5] for o in p["first"]] == [o[:5] for o in j["first"]]
    assert [o[:5] for o in p["second"]] == [o[:5] for o in j["second"]]
    assert p["app"].story_text == j["app"].story_text
    assert "Direct text here." in p["app"].story_text
    _same_clips(_audio(p["pumped"]), _audio(j["pumped"]))
    _same_clips([p["replay"]], [j["replay"]])
    assert [len(g) for g in p["app"].prompt_audio_segments] == [2, 2]
    assert [path.rsplit("/", 1)[1] for path in p["app"].generated_prompt_wav_paths] == \
        ["prompt_01.wav", "prompt_02.wav"]
    # 16-bit files: one LSB of rounding on top of the PCM bound
    assert p["wav"].shape == j["wav"].shape
    np.testing.assert_allclose(p["wav"], j["wav"], rtol=0,
                               atol=1 / 32767 + PCM_RTOL * np.abs(j["wav"]).max())


def test_storyteller_new_vs_continue_and_reset_equals_jax(engines, monkeypatch, tmp_path):
    """is_continuation=False restarts the story (files stay on disk);
    clear_session_for_ui returns the full cleared-UI tuple."""
    seen = {}
    for pkg in ("jax", "port"):
        app = _app(pkg, "story", engines[pkg], monkeypatch, tmp_path, ("A fox ran. It hid.",))
        _, _, s, e, _, _ = list(app.continue_story("go", use_llm=True))[-1]
        _pump(app, s, e)
        saved = list(app.generated_prompt_wav_paths)
        list(app.continue_story("more", use_llm=True, is_continuation=True))
        parts_after_continue = len(app.story_parts)
        fresh = list(app.continue_story("fresh", use_llm=True, is_continuation=False))
        state = (parts_after_continue, len(app.story_parts), app.generated_prompt_wav_paths,
                 fresh[-1][5], [o[:5] for o in fresh], app.llm.queries,
                 [p.rsplit("/", 1)[1] for p in saved], all(map(open, saved)))
        cleared = app.clear_session_for_ui()
        seen[pkg] = (state, cleared, app.story_parts, app.prompt_audio_segments,
                     app.temp_audio_files)
    assert seen["port"] == seen["jax"]
    state, cleared = seen["port"][:2]
    assert state[:4] == (2, 1, [], None) and len(cleared) == 9


# ---------------------------------------------------------------------------
# duplex
# ---------------------------------------------------------------------------


def test_duplex_respond_equals_jax(engines):
    """Three user turns of 16 kHz audio (resampled to 24 kHz), a streamed
    LLM reply split into sentences, one PCM chunk per frame: the same
    chunks, the same context rows after each turn, eviction under the
    tiny budget with the pinned prefix kept, and clear_dialog."""
    hop = engines["port"].generator._mimi.cfg.hop_length
    rng = np.random.default_rng(3)
    voice = (rng.normal(size=2 * hop) * 0.1).astype(np.float32)
    turns = [(rng.normal(size=3 * hop) * 0.1).astype(np.float32) for _ in range(3)]
    deltas = ["Hi hu", "man. All", " good? Yes", "."]
    runs = {}
    for pkg in ("jax", "port"):
        gen = engines[pkg].generator
        app = PKGS[pkg]["duplex"].DuplexVoiceApp(
            gen, stt=lambda audio, rate: "hello bot", llm=_fake_llm(pkg, deltas),
            voice_context=[PKGS[pkg]["frames"].Segment(1, "v", voice)], temperature=0.8,
            topk=1, max_sentence_ms=480)
        prefix = app.context.prefix_rows
        per_turn = []
        for audio in turns:
            chunks = list(app.respond(audio, 16_000))
            per_turn.append((chunks, app.context.window_rows, len(app.context._window),
                             app.context.prefix_rows))
        history = list(app.llm.history_manager.messages)
        app.clear_dialog()
        runs[pkg] = dict(app=app, prefix=prefix, turns=per_turn, history=history,
                         after_clear=(app.context.window_rows, app.context.prefix_rows))
    j, p = runs["jax"], runs["port"]
    assert p["prefix"] == j["prefix"] > 0
    for (chunks, rows, segs, prefix), (jchunks, jrows, jsegs, jprefix) in zip(p["turns"],
                                                                             j["turns"]):
        assert (rows, segs, prefix) == (jrows, jsegs, jprefix)
        assert prefix == p["prefix"] and 0 < rows <= p["app"].context.budget
        assert len(chunks) == len(jchunks) > 0
        for (sr, pcm), (jsr, jpcm) in zip(chunks, jchunks):
            assert sr == jsr == 24_000 and pcm.dtype == np.float32 and pcm.size == hop
            _close_pcm(pcm, jpcm)
    # 4 segments per turn (the user's + 3 sentences): the window evicted
    assert p["turns"][-1][2] < 4 * len(turns)
    assert p["app"].llm.queries == [("hello bot", True)] * len(turns)
    assert p["history"] == j["history"] == []  # the fake LLM keeps none
    assert p["after_clear"] == j["after_clear"] == (0, p["prefix"])
    assert set(p["app"].marks) == {"stt", "ttfs", "ttff"}
    assert 0 <= p["app"].marks["stt"] <= p["app"].marks["ttfs"] <= p["app"].marks["ttff"]


def test_duplex_empty_transcript_yields_nothing(engines):
    gen = engines["port"].generator
    app = duplex.DuplexVoiceApp(gen, stt=lambda audio, rate: "  ",
                                llm=_fake_llm("port", ["Never said."]))
    assert list(app.respond(np.zeros(480, np.float32), 24_000)) == []
    assert app.context.window_rows == 0 and app.llm.queries == []
    assert app.marks["ttfs"] is None and app.context.max_positions == gen.max_seq_len


# ---------------------------------------------------------------------------
# the pump and the base app, over a scripted engine
# ---------------------------------------------------------------------------


class _Engine:
    """A TTS stand-in: ``fail`` sentences raise, the rest give a short clip
    of the package's AudioClip; ``during`` runs inside a synthesis."""

    def __init__(self, pkg, fail=(), during=None):
        self.clip_cls = PKGS[pkg]["segment"].AudioClip
        self.generator = object()
        self.fail = set(fail)
        self.during = during
        self.voices = {"a": True}

    def list_voices(self):
        return list(self.voices)

    def load_voice(self, name, warmup=True):
        if name not in self.voices:
            raise ValueError(f"Voice '{name}' not found")

    def generate_audio_segment(self, text, **kw):
        if self.during:
            self.during()
        if text in self.fail:
            raise RuntimeError("engine down")
        return self.clip_cls.from_float(np.full(240, 0.5, np.float32), 24_000)


def _scripted(pkg, monkeypatch, **engine_kw):
    llm = _fake_llm(pkg, ["unused"])
    monkeypatch.setattr(PKGS[pkg]["web_base"] + ".AskLLM", lambda **kw: llm)
    return PKGS[pkg]["chat"].ChatApp(model="local-default", tts=_Engine(pkg, **engine_kw))


def _statuses(app):
    seen = []
    update = app.update_status

    def record(message):
        seen.append(message)
        return update(message)

    app.update_status = record
    return seen


def test_pump_aborts_after_three_failures_like_jax(monkeypatch):
    sentences = ["A one.", "B two.", "C three.", "D four.", "E five.", "F six."]
    fail = {"B two.", "C three.", "D four.", "E five."}
    runs = {}
    for pkg in ("jax", "port"):
        app = _scripted(pkg, monkeypatch, fail=fail)
        seen = _statuses(app)
        s, e = app.queue.enqueue(sentences)
        items = list(app.sentence_generator_loop(s, e, True, speed_factor=1.0))
        runs[pkg] = ([(a, None if x is None else x[0]) for a, x in items], seen,
                     app.current_status)
    assert runs["port"] == runs["jax"]
    items, seen, _ = runs["port"]
    assert items == [(True, 24_000), (False, None)]  # D four. is the third failure
    assert "3 consecutive sentence failures" in seen[-1]


def test_pump_generation_token_stops_a_stale_pump_like_jax(monkeypatch):
    """A pump interrupted mid-synthesis delivers that clip, then stops, even
    after a newer pump cleared the cancel event; an inactive pump only
    terminates."""
    runs = {}
    for pkg in ("jax", "port"):
        box = {}
        app = _scripted(pkg, monkeypatch, during=lambda: box.get("hook", lambda: None)())
        box["hook"] = lambda: (app.interrupt_and_reset(), box.pop("hook"))
        s, e = app.queue.enqueue(["First one.", "Second one."])
        old = app.sentence_generator_loop(s, e, True, speed_factor=1.0)
        first = next(old)
        s2, e2 = app.queue.enqueue(["Fresh one.", "Fresh two."])
        new = app.sentence_generator_loop(s2, e2, True, speed_factor=1.0)
        new_first = next(new)  # clears the shared cancel event
        stale = list(old)
        rest = list(new)
        idle = list(app.sentence_generator_loop(0, 2, False))
        runs[pkg] = [(a, x is None) for a, x in [first, new_first, *stale, *rest, *idle]] + \
            [app.last_status, app._pump_gen, len(app.queue)]
    assert runs["port"] == runs["jax"]
    assert runs["port"][:3] == [(True, False), (True, False), (False, True)]


def test_base_app_statuses_like_jax(monkeypatch):
    """Voice selection at start-up, change_voice's status strings, an empty
    index, speedup only when speed_factor != 1."""
    runs = {}
    for pkg in ("jax", "port"):
        app = PKGS[pkg]["base"].TTSBaseApp(tts=_Engine(pkg))
        out = [app.current_voice, app.current_status, app.change_voice("missing"),
               app.current_voice, app.change_voice("a"),
               app.generate_audio_for_sentence_index(5), app.split_text_into_sentences(
                   "**One** two. Three?  Four"), app.current_sample_rate]
        app.queue.enqueue(["Only one."])
        status, (sr, pcm) = app.generate_audio_for_sentence_index(0, speed_factor=1.0)
        out += [sr, pcm.size, app.current_sample_rate, len(app.queue.clips())]
        runs[pkg] = out
    assert runs["port"] == runs["jax"]
    assert runs["port"][:2] == ["a", "voice 'a' loaded — ready"]


def test_base_app_builds_its_engine_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tts_base.TTSBaseApp(spec=tiny_spec())
