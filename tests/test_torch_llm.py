"""The port's LLM client (``llm/client.py``) and ``apps/audio_to_text.py``
against the JAX package's, over a loopback stdlib HTTP server in the test
that serves ``/v1/chat/completions`` (whole and as SSE deltas) and
``/v1/audio/transcriptions``: the same request bodies, the same replies
and the same history, exactly."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from sesameai_tts_tpu.apps import audio_to_text as j_stt
from sesameai_tts_tpu.llm import client as j_client
from sesameai_tts_tpu_torch.apps import audio_to_text as stt
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.llm import client

REPLY = "It costs 1.5 dollars today. Fine! Done?"
DELTAS = ["It costs 1", ".5 dol", "lars today. Fi", "ne! Done?"]
TRANSCRIPT = "hello from the loopback"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.seen.append((self.path, dict(self.headers), body))
        if self.path.endswith("/audio/transcriptions"):
            self._json({"text": TRANSCRIPT})
            return
        req = json.loads(body)
        if not req["stream"]:
            self._json({"choices": [{"message": {"role": "assistant", "content": REPLY}}]})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        lines = [": keep-alive", ""]
        lines += [f"data: {json.dumps({'choices': [{'delta': {'content': d}}]})}"
                  for d in DELTAS]
        lines += ["data: " + json.dumps({"choices": [{"delta": {}}]}), "data: [DONE]",
                  "data: " + json.dumps({"choices": [{"delta": {"content": "after"}}]})]
        self.wfile.write("".join(line + "\n" for line in lines).encode())

    def _json(self, obj):
        data = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture()
def server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    httpd.seen = []
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}/v1"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _pair(base):
    """A JAX and a port client with the same configuration."""
    cfg = dict(API_BASE=base, API_KEY="k", SYSTEM_MESSAGE="Be brief.", TEMPERATURE=0.3,
               MAX_TOKENS=64, TIMEOUT=30.0)
    return (j_client.AskLLM("m", j_client.LLMConfig(**cfg)),
            client.AskLLM("m", client.LLMConfig(**cfg)))


def test_config_defaults_match_the_jax_package():
    assert client.LLMConfig() == client.LLMConfig(**vars(j_client.LLMConfig()))
    assert vars(client.global_config) == vars(j_client.LLMConfig())
    assert client.global_config is not j_client.global_config


@pytest.mark.parametrize("stream", [False, True])
def test_query_sends_the_jax_requests_and_keeps_its_history(server, stream):
    httpd, base = server
    clients = _pair(base)
    got = []
    for llm in clients:
        first = llm.query("first question", stream=stream)
        got.append((list(first) if stream else first,
                    llm.query("second", plaintext_output=True, stream=stream)))
        if stream:
            got[-1] = (got[-1][0], list(got[-1][1]))
    want_first = DELTAS if stream else REPLY
    assert got[0] == got[1] == (want_first, want_first)
    assert clients[0].history_manager.messages == clients[1].history_manager.messages
    assert [m["role"] for m in clients[1].history_manager.messages] == \
        ["user", "assistant"] * 2
    assert clients[1].history_manager.messages[1]["content"] == REPLY
    bodies = [(path, json.loads(body), head["Authorization"], head["Content-Type"])
              for path, head, body in httpd.seen]
    assert len(bodies) == 4 and bodies[:2] == bodies[2:]
    path, req, auth, ctype = bodies[3]
    assert path == "/v1/chat/completions" and auth == "Bearer k"
    assert ctype == "application/json"
    assert req["stream"] is stream and req["temperature"] == 0.3 and req["max_tokens"] == 64
    assert [m["role"] for m in req["messages"]] == ["system", "user", "assistant", "user"]


def test_closing_a_stream_early_records_the_partial_turn(server):
    _, base = server
    for llm in _pair(base):
        it = llm.query("q", stream=True)
        assert next(it) == DELTAS[0]
        it.close()
        assert llm.history_manager.messages == [
            {"role": "user", "content": "q"}, {"role": "assistant", "content": DELTAS[0]}]
        llm.history_manager.clear_history()
        assert llm.history_manager.messages == []


@pytest.mark.parametrize("requested", ["gpt-4o-mini", "llama", "MISTRAL", "small", "nope",
                                       "", "LLAMA-3-70B"])
def test_resolve_model_alias_equals_jax(requested):
    options = ["gpt-4o-mini", "llama-3-70b", "mistral-small", "tiny-small"]
    want = j_client.ModelManager(j_client.LLMConfig(MODEL_OPTIONS=options)) \
        .resolve_model_alias(requested)
    got = client.ModelManager(client.LLMConfig(MODEL_OPTIONS=options)) \
        .resolve_model_alias(requested)
    assert got == want


def test_transcribe_posts_the_jax_multipart_body(server, tmp_path):
    httpd, base = server
    wav = str(tmp_path / "turn.wav")
    write_wav(wav, (np.random.default_rng(0).normal(size=1600) * 0.1).astype(np.float32),
              16_000)
    assert j_stt.transcribe(wav, api_base=base, api_key="k", model="w") == TRANSCRIPT
    assert stt.transcribe(wav, api_base=base, api_key="k", model="w") == TRANSCRIPT
    (jpath, jhead, jbody), (path, head, body) = httpd.seen
    assert path == jpath == "/v1/audio/transcriptions"
    jb, b = jhead["Content-Type"].split("boundary=")[1], head["Content-Type"].split("boundary=")[1]
    assert body.replace(b.encode(), b"B") == jbody.replace(jb.encode(), b"B")
    assert body.count(open(wav, "rb").read()) == 1


def test_transcribe_main_prints_the_text(server, tmp_path, monkeypatch, capsys):
    _, base = server
    wav = str(tmp_path / "turn.wav")
    write_wav(wav, np.zeros(160, np.float32), 16_000)
    monkeypatch.setenv("OPENAI_API_BASE", base)
    stt.main([wav, "--model", "w"])
    assert TRANSCRIPT in capsys.readouterr().out
