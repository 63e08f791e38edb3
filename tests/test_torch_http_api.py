"""The port's HTTP front end (``service/http_api.py``) on an ephemeral port
over a tiny CPU engine: the cases of ``tests/test_http_api.py`` (WAV and
chunked PCM responses, the OpenAI speech surface with its wav / pcm formats,
audio and SSE streams and ``speed``, voices, health with the tick canary,
metrics, 429 with Retry-After under a burst, the request deadline, client
disconnects freeing the slot, and the watermark on every flagship output,
streamed ones through the streaming embedder), plus ``main`` on the CPU.
Every server is stopped in a fixture finalizer or a ``finally``."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer
from sesameai_tts_tpu_torch.service.http_api import serve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread per test worker (see
    tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    return build_generator(tiny_spec(), device="cpu", decode_chunk_frames=4)


@pytest.fixture(scope="module")
def api():
    gen = _tiny()
    engine = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    engine.start()
    from sesameai_tts_tpu_torch.runtime.frames import Segment

    hop = gen._mimi.cfg.hop_length
    seg = Segment(
        speaker=1, text="clip",
        audio=(np.random.default_rng(0).normal(size=2 * hop) * 0.1).astype(np.float32),
    )
    voices = {"demo": gen.precompute_context_state([seg])}
    httpd = serve(engine, host="127.0.0.1", port=0, voices=voices,
                  sample_rate=gen.sample_rate)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, gen
    httpd.shutdown()
    engine.stop()


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    return urllib.request.urlopen(req, timeout=300)


def test_healthz(api):
    base, _ = api
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["slots"] == 2
    assert info["voices"] == ["demo"]


def test_healthz_deep_canary(api):
    """/healthz?deep=1 returns the drift canary: the serving tick timed on
    its own state (the JAX package's link round trip has no counterpart)."""
    base, _ = api
    with urllib.request.urlopen(base + "/healthz?deep=1", timeout=300) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok"
    c = info["canary"]
    assert "rtt_ms" not in c and c["device"] == "cpu"
    assert c["tick_ms_per_frame_step"] > 0
    assert c["tick_frames_per_s"] > 0
    assert c["tick_batch"] == 2 and c["tick_frames"] == 4


def test_metrics_endpoint(api):
    """/metrics reports engine counters + TTFA percentiles after traffic."""
    base, _ = api
    with _post(base, "/tts", {"text": "metrics probe",
                              "max_audio_length_ms": 400, "topk": 5}) as r:
        r.read()
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        m = json.loads(r.read())
    assert m["sessions_total"] >= 1 and m["frames_total"] >= 1
    assert m["slots"] == 2 and 0 <= m["slots_occupied"] <= 2
    assert m["series"]["ttfa_s"]["count"] >= 1
    assert m["series"]["ttfa_s"]["p50"] > 0


def test_tts_wav(api):
    base, gen = api
    with _post(base, "/tts", {"text": "hello over http",
                              "max_audio_length_ms": 800,
                              "temperature": 0.9, "topk": 5}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = r.read()
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    pcm = np.frombuffer(wav[44:], "<i2")
    assert len(pcm) % gen._hop == 0 and len(pcm) > 0


def test_tts_stream_chunked(api):
    base, gen = api
    with _post(base, "/tts/stream", {"text": "stream me please",
                                     "max_audio_length_ms": 800,
                                     "temperature": 0.9, "topk": 5}) as r:
        assert r.headers["Content-Type"].startswith("audio/pcm")
        raw = r.read()  # urllib de-chunks
    pcm = np.frombuffer(raw, np.float32)
    assert len(pcm) % gen._hop == 0 and np.isfinite(pcm).all()


def test_tts_with_voice_and_errors(api):
    base, gen = api
    with _post(base, "/tts", {"text": "with a voice", "voice": "demo",
                              "max_audio_length_ms": 640,
                              "temperature": 0.9, "topk": 5}) as r:
        assert r.status == 200 and len(r.read()) > 44

    for body, code in (
        ({"text": ""}, 400),
        ({"text": "x", "voice": "nope"}, 404),
        ({"text": "y" * 5000}, 413),
    ):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/tts", body)
        assert ei.value.code == code

    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, "/nope", {"text": "x"})
    assert ei.value.code == 404


def test_backpressure_429_with_retry_after_no_hung_listeners():
    """A burst beyond the bounded admission backlog gets prompt 429s with
    Retry-After while accepted requests complete — no listener ever hangs
    Slots are pre-occupied by long sessions so the burst overflows the
    backlog instead of draining through it."""
    import threading

    gen = _tiny()
    engine = BatchedTTSServer(gen, slots=2, chunk_frames=4, max_pending=2)
    engine.start()
    httpd = serve(engine, host="127.0.0.1", port=0,
                  sample_rate=gen.sample_rate)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        # occupy both slots with long sessions (library submit — blocking
        # semantics — so they don't consume the HTTP backlog bound)
        long_sess = [engine.submit("occupy the pool for a while",
                                   max_audio_length_ms=20_000, topk=5)
                     for _ in range(2)]
        results = []

        def post():
            try:
                with _post(base, "/tts", {"text": "burst request",
                                          "max_audio_length_ms": 400,
                                          "topk": 5}) as r:
                    r.read()
                    results.append((200, None))
            except urllib.error.HTTPError as e:
                e.read()
                results.append((e.code, e.headers.get("Retry-After")))

        threads = [threading.Thread(target=post) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)  # zero hung listeners
        assert len(results) == 12
        codes = [c for c, _ in results]
        assert all(c in (200, 429) for c in codes), codes
        assert 429 in codes, "burst never saturated the bounded backlog"
        # every 429 carries an integer Retry-After advisory
        assert all(ra is not None and int(ra) >= 1
                   for c, ra in results if c == 429)
        for s in long_sess:
            s.cancel()
        for s in long_sess:
            s.audio(timeout=300)
        # the pool recovers: a fresh request succeeds
        with _post(base, "/tts", {"text": "after the burst",
                                  "max_audio_length_ms": 400, "topk": 5}) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        engine.stop()


def test_request_deadline_cancels_session():
    """An expired per-request deadline 500s the client AND cancels the
    session (frees its slot) — the server keeps serving afterwards."""
    gen = _tiny()
    engine = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    engine.start()
    httpd = serve(engine, host="127.0.0.1", port=0,
                  sample_rate=gen.sample_rate, request_timeout=0.05)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/tts", {"text": "deliberately very long budget",
                                 "max_audio_length_ms": 30_000, "topk": 5})
        assert ei.value.code == 500
        ei.value.read()
        # the timed-out session was cancelled: within a few ticks both
        # slots are free again and a direct submit completes
        s = engine.submit("recovers", max_audio_length_ms=400, topk=5)
        assert s.audio(timeout=300) is not None
    finally:
        httpd.shutdown()
        engine.stop()


def test_tts_watermarked_when_configured():
    """With a (watermarker, key) pair wired, the endpoint's output path
    embeds a verifiable provenance watermark and normalizes over-full-
    scale audio before the 16-bit WAV write (same invariant as the
    flagship CLI).  The tiny flavor cannot produce seconds of audio, so
    the handler's watermark+normalize path runs on a realistic-length
    synthetic signal."""
    from sesameai_tts_tpu_torch.service.http_api import TTSRequestHandler, _wav_bytes
    from sesameai_tts_tpu_torch.watermark.api import (
        CSM_1B_WATERMARK,
        load_watermarker,
        verify,
    )

    wm = load_watermarker(device="cpu")
    handler = type(
        "H", (TTSRequestHandler,),
        {"watermarker": (wm, CSM_1B_WATERMARK), "sample_rate": 24_000},
    )
    rng = np.random.default_rng(0)
    t = np.arange(2 * 24_000) / 24_000
    audio = (0.8 * np.sin(2 * np.pi * 220 * t)
             + 0.6 * rng.normal(size=t.shape)).astype(np.float32)  # peak > 1

    out = handler._maybe_watermark(handler, audio)
    peak = float(np.abs(out).max())
    if peak > 1.0:
        out = out / peak
    wav = _wav_bytes(out, 24_000)
    pcm = np.frombuffer(wav[44:], "<i2").astype(np.float32) / 32767.0
    assert np.abs(pcm).max() <= 1.0
    assert verify(wm, pcm, 24_000, CSM_1B_WATERMARK)


def test_tts_stream_watermarked_flows_through_streaming_embedder(api):
    """/tts/stream with a watermarker streams through the incremental
    embedder (watermark/stream.py): the full budget arrives, the length
    matches the unwatermarked stream to within resampler rounding, and
    the PCM differs (a mark was embedded)."""
    base, gen = api
    from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK, load_watermarker

    engine = BatchedTTSServer(gen, slots=1, chunk_frames=4)
    engine.start()
    httpd = serve(engine, host="127.0.0.1", port=0,
                  sample_rate=gen.sample_rate,
                  watermarker=(load_watermarker(device="cpu"), CSM_1B_WATERMARK))
    wm_base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        # greedy (topk=1) is PRNG-key-invariant, so the plain and
        # watermarked sessions decode identical frames — the only
        # difference left is the embedded mark
        body = {"text": "stream with provenance", "max_audio_length_ms": 800,
                "temperature": 1.0, "topk": 1}
        with _post(wm_base, "/tts/stream", body) as r:
            marked = np.frombuffer(r.read(), np.float32)
        with _post(base, "/tts/stream", body) as r:
            plain = np.frombuffer(r.read(), np.float32)
        assert abs(len(marked) - len(plain)) <= 2
        assert len(marked) > 0 and np.isfinite(marked).all()
        n = min(len(marked), len(plain))
        assert not np.allclose(marked[:n], plain[:n])  # embedding happened
    finally:
        httpd.shutdown()
        engine.stop()


def test_stream_client_disconnect_frees_slot(api):
    """A client that hangs up mid-/tts/stream gets its session cancelled
    (the handler's BrokenPipe path) so the slot stops burning its
    max_audio_length_ms budget."""
    import socket
    import struct
    import time as _time

    base, gen = api
    _serve = serve

    engine = BatchedTTSServer(gen, slots=1, chunk_frames=4)
    engine.start()
    httpd = _serve(engine, host="127.0.0.1", port=0,
                   sample_rate=gen.sample_rate)
    try:
        body = json.dumps({"text": "a very long stream nobody listens to",
                           "max_audio_length_ms": 60_000, "topk": 5}).encode()
        s = socket.create_connection(
            ("127.0.0.1", httpd.server_address[1]), timeout=300)
        s.sendall(b"POST /tts/stream HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        first = s.recv(65536)  # status line + headers (+ maybe chunks)
        assert b"200" in first.split(b"\r\n", 1)[0]
        deadline = _time.time() + 300
        while _time.time() < deadline:  # session reaches its slot first —
            if engine.metrics_summary()["slots_occupied"] == 1:  # else the
                break                   # final poll could pass vacuously
            _time.sleep(0.1)
        # hang up HARD (RST via zero-linger) so the server's next chunk
        # write raises instead of filling a dead socket's buffer
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        deadline = _time.time() + 300
        while _time.time() < deadline:
            if engine.metrics_summary()["slots_occupied"] == 0:
                break
            _time.sleep(0.25)
        else:
            raise AssertionError(
                "slot still occupied long after the client disconnected")
    finally:
        httpd.shutdown()
        engine.stop()


def test_openai_speech_wav_and_pcm(api):
    """OpenAI-compatible /v1/audio/speech: `input`/`voice` mapping, wav
    and pcm response formats, `speed` time-scale compression."""
    base, gen = api
    body = {"model": "csm-1b", "input": "openai compatible surface",
            "voice": "demo", "max_audio_length_ms": 800,
            "temperature": 0.9, "topk": 5}
    with _post(base, "/v1/audio/speech", body) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = r.read()
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    n_wav = len(np.frombuffer(wav[44:], "<i2"))
    assert n_wav > 0 and n_wav % gen._hop == 0

    with _post(base, "/v1/audio/speech",
               {**body, "response_format": "pcm"}) as r:
        assert r.headers["Content-Type"].startswith("audio/pcm")
        assert "s16le" in r.headers["Content-Type"]
        pcm = np.frombuffer(r.read(), "<i2")
    assert len(pcm) > 0 and len(pcm) % gen._hop == 0

    # speed > 1 shortens the audio (greedy: same frames both calls)
    fast_body = {"input": "speed comparison utterance", "voice": "demo",
                 "max_audio_length_ms": 1600, "temperature": 1.0, "topk": 1}
    with _post(base, "/v1/audio/speech", fast_body) as r:
        normal = np.frombuffer(r.read()[44:], "<i2")
    with _post(base, "/v1/audio/speech", {**fast_body, "speed": 2.0}) as r:
        fast = np.frombuffer(r.read()[44:], "<i2")
    assert 0 < len(fast) <= len(normal)


def test_openai_speech_errors(api):
    base, _ = api
    for body, code in (
        ({"voice": "demo"}, 400),                      # missing input
        ({"input": "x", "response_format": "mp3"}, 400),
        ({"input": "x", "speed": 0.5}, 400),           # slow-down unsupported
        ({"input": "x", "speed": "quick"}, 400),
        ({"input": "x", "voice": "nope"}, 404),
        ({"input": "x", "voice": ["alloy"]}, 400),     # unhashable voice
    ):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/audio/speech", body)
        assert ei.value.code == code, body


def test_openai_stock_voice_maps_to_default(api):
    """Stock SDK calls send OpenAI voice names; the server maps them to
    its default voice instead of 404ing (drop-in compatibility)."""
    base, gen = api
    with _post(base, "/v1/audio/speech",
               {"input": "alloy maps to the default voice",
                "voice": "alloy", "max_audio_length_ms": 640,
                "temperature": 0.9, "topk": 5}) as r:
        assert r.status == 200
        assert len(r.read()) > 44


def test_tts_rejects_hostile_parameters(api):
    """Out-of-range/overflowing sampler params get a 400 BEFORE reaching
    the shared decode program (temperature 0 → NaN logits; json 1e999 →
    inf → OverflowError in int(); inf budget → OverflowError in the
    admission loop; unhashable voice → TypeError)."""
    base, _ = api
    for body in (
        {"text": "x", "temperature": 0},
        {"text": "x", "temperature": float("nan")},
        {"text": "x", "topk": 0},
        {"text": "x", "speaker": 1e999},
        {"text": "x", "topk": 1e999},
        {"text": "x", "max_audio_length_ms": float("inf")},
        {"text": "x", "max_audio_length_ms": -5},
        {"text": "x", "voice": ["demo"]},
    ):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/tts", body)
        assert ei.value.code == 400, body


def test_openai_speech_stream_audio(api):
    """`stream_format: "audio"` streams the encoded bytes chunked: pcm =
    raw s16le; wav = streaming RIFF header (unknown-length sizes) +
    s16le frames. Greedy sampling → streamed pcm is byte-identical to
    the buffered pcm response."""
    base, gen = api
    body = {"input": "stream format audio utterance", "voice": "demo",
            "max_audio_length_ms": 800, "temperature": 1.0, "topk": 1,
            "response_format": "pcm"}
    with _post(base, "/v1/audio/speech", body) as r:
        buffered = r.read()
    with _post(base, "/v1/audio/speech",
               {**body, "stream_format": "audio"}) as r:
        assert r.headers["Content-Type"].startswith("audio/pcm")
        assert r.headers.get("Content-Length") is None  # chunked
        streamed = r.read()
    assert len(streamed) > 0 and len(streamed) % (2 * gen._hop) == 0
    # byte-identical unless the buffered path peak-normalized (>1.0 peak
    # on random weights) — then lengths still must match exactly
    assert len(streamed) == len(buffered)
    if np.abs(np.frombuffer(buffered, "<i2")).max() < 32700:
        assert streamed == buffered

    with _post(base, "/v1/audio/speech",
               {**body, "response_format": "wav",
                "stream_format": "audio"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = r.read()
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    assert wav[4:8] == b"\xff\xff\xff\xff"  # streaming: unknown length
    assert len(wav) == 44 + len(streamed)  # same frames, header in front

    # the streamed wav parses through the framework's own reader
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(wav)
        f.flush()
        from sesameai_tts_tpu_torch.audio.io import read_wav

        audio, rate = read_wav(f.name)
    assert rate == gen.sample_rate and audio.shape[1] == len(streamed) // 2


def test_openai_speech_stream_sse(api):
    """`stream_format: "sse"`: text/event-stream of speech.audio.delta
    events (base64 audio) closed by speech.audio.done — the OpenAI
    Audio API's SSE framing."""
    base, gen = api
    import base64

    body = {"input": "sse framing utterance", "voice": "demo",
            "max_audio_length_ms": 800, "temperature": 1.0, "topk": 1,
            "response_format": "pcm", "stream_format": "sse"}
    with _post(base, "/v1/audio/speech", body) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        raw = r.read().decode()
    events = [json.loads(line[len("data: "):])
              for line in raw.split("\n\n") if line.startswith("data: ")]
    assert events[-1]["type"] == "speech.audio.done"
    deltas = [e for e in events[:-1] if e["type"] == "speech.audio.delta"]
    assert deltas, "no audio deltas before done"
    pcm = b"".join(base64.b64decode(e["audio"]) for e in deltas)
    assert len(pcm) > 0 and len(pcm) % (2 * gen._hop) == 0

    # wav-over-sse: the streaming RIFF header rides the first delta so
    # every prefix of the reassembled bytes is a playable WAV
    with _post(base, "/v1/audio/speech",
               {**body, "response_format": "wav"}) as r:
        raw = r.read().decode()
    first = next(json.loads(line[len("data: "):])
                 for line in raw.split("\n\n") if line.startswith("data: "))
    assert base64.b64decode(first["audio"])[:4] == b"RIFF"


def test_openai_speech_stream_speed_buffers(api):
    """speed > 1 cannot stream incrementally (pitch-preserving speedup
    needs the full utterance): same framing, one buffered piece, and the
    audio is shorter than the unsped stream."""
    base, _ = api
    body = {"input": "speed streamed utterance for comparison",
            "voice": "demo", "max_audio_length_ms": 1600,
            "temperature": 1.0, "topk": 1, "response_format": "pcm",
            "stream_format": "audio"}
    with _post(base, "/v1/audio/speech", body) as r:
        normal = r.read()
    with _post(base, "/v1/audio/speech", {**body, "speed": 2.0}) as r:
        fast = r.read()
    assert 0 < len(fast) <= len(normal)

    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, "/v1/audio/speech",
              {"input": "x", "stream_format": "events"})
    assert ei.value.code == 400


def test_openai_models_listing(api):
    base, _ = api
    with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
        listing = json.loads(r.read())
    assert listing["object"] == "list"
    assert listing["data"][0]["id"] == "csm-1b"


def test_tts_priority_knob(api):
    """The "priority" body knob reaches the admission queue (lower
    admits first, runtime/serving.py); a non-integer value is a 400,
    never a crashed handler."""
    base, _ = api
    with _post(base, "/tts", {"text": "priority zero please",
                              "max_audio_length_ms": 400,
                              "priority": 0, "topk": 5}) as r:
        assert r.status == 200
        assert len(r.read()) > 44  # WAV header + some PCM
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/tts", {"text": "bad prio", "priority": "soon"})
    assert e.value.code == 400


def test_openai_speech_priority_knob(api):
    """/v1/audio/speech forwards the "priority" extension knob to the
    admission queue (and rejects junk with a 400, same as /tts)."""
    base, _ = api
    with _post(base, "/v1/audio/speech",
               {"input": "priority through openai", "response_format": "wav",
                "max_audio_length_ms": 400, "priority": 0, "topk": 5}) as r:
        assert r.status == 200
        assert len(r.read()) > 44
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/audio/speech", {"input": "x", "priority": "nope"})
    assert e.value.code == 400


def test_main_serves_on_the_cpu_when_asked(monkeypatch):
    """``main --device cpu --flavor test-tiny`` builds, warms up, starts the
    engine and binds; without a card the default device raises."""
    from sesameai_tts_tpu_torch.service import http_api

    made = {}

    def fake_serve(engine, host, port, voices, sample_rate, **kw):
        made.update(engine=engine, port=port, kw=kw)
        raise KeyboardInterrupt  # stands in for the serve loop's Ctrl-C

    monkeypatch.setattr(http_api, "serve", fake_serve)
    with pytest.raises(KeyboardInterrupt):
        http_api.main(["--device", "cpu", "--flavor", "test-tiny", "--slots", "2",
                       "--port", "0", "--max-positions", "128"])
    engine = made["engine"]
    try:
        assert engine.B == 2 and engine.chunk == 10 and engine.max_pending == 8
        assert made["kw"]["watermarker"] is None  # test-tiny only
        assert engine.gen.max_seq_len == 128 and engine.gen.device.type == "cpu"
        s = engine.submit("served from main", max_audio_length_ms=320, topk=5)
        assert s.audio(timeout=120).ndim == 1
    finally:
        engine.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            http_api.main(["--flavor", "test-tiny"])
