"""Headless HTTP serving API over the batched TTS engine (port of
``sesameai_tts_tpu/service/http_api.py``).  Stdlib ``http.server`` only:

    POST /tts           {"text": ..., "speaker": 1, "max_audio_length_ms":
                         30000, "temperature": 0.8, "topk": 40, "voice": ...,
                         "priority": 0|1 (optional; unset = derived — short
                         budgets admit ahead of bulk, runtime/serving.py)}
                        → audio/wav (16-bit PCM, 24 kHz)
    POST /tts/stream    same body → chunked audio/pcm;rate=24000;encoding=
                        float32 — chunks flush as the engine emits them
    POST /v1/audio/speech
                        OpenAI Audio-API-compatible: {"input": ..., "voice":
                        ..., "response_format": "wav"|"pcm", "speed": 1.0}
                        (plus the /tts extension knobs) → audio bytes.
                        "stream_format": "audio" streams the encoded bytes
                        chunked as the engine emits them (wav = streaming
                        RIFF header + s16le frames); "stream_format": "sse"
                        streams speech.audio.delta / speech.audio.done
                        events (text/event-stream, base64 audio).  Clients
                        written against the de-facto TTS serving protocol —
                        buffered or streaming — work unchanged.
    GET  /healthz       → {"status": "ok", "slots": B}; ``?deep=1`` adds the
                          tick canary (``BatchedTTSServer.link_canary``)
    GET  /metrics       → engine metrics JSON (TTFA/session percentiles,
                          frame + session counters, slot occupancy, the
                          sampler kernel's launches)

Concurrency rides the BatchedTTSServer slot pool: N in-flight requests
decode in the same batched step. Voices resolve through the registry
given to ``serve``.

    python -m sesameai_tts_tpu_torch.service.http_api --slots 8 [--model-path ...]

runs the server on the card; ``--device cpu --flavor test-tiny`` on the CPU.
"""

from __future__ import annotations

import io
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sesameai_tts_tpu_torch.audio.io import streaming_wav_header, write_wav
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, ServerSaturated

logger = logging.getLogger(__name__)


# the OpenAI Audio API's published voice names (voice is a REQUIRED
# request field there) — mapped to this server's default voice so stock
# SDK calls work unchanged against /v1/audio/speech
_OPENAI_STOCK_VOICES = frozenset({
    "alloy", "ash", "ballad", "cedar", "coral", "echo", "fable", "marin",
    "nova", "onyx", "sage", "shimmer", "verse",
})


def _wav_bytes(audio: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, audio, rate)  # the framework's one WAV serializer
    return buf.getvalue()


class _SessionFailed(Exception):
    """An engine session ended with an error mid-stream (distinct from
    transport/framing failures so callers can skip the redundant
    cancel())."""


class TTSRequestHandler(BaseHTTPRequestHandler):
    server_version = "sesameai-tts-tpu-torch/0.1"
    # HTTP/1.1 is REQUIRED for the chunked streaming responses — a 1.0
    # status line makes spec-compliant clients ignore Transfer-Encoding
    # and read the chunk framing as body bytes
    protocol_version = "HTTP/1.1"

    # injected by serve():
    engine: BatchedTTSServer = None
    voices: dict = {}
    watermarker = None  # (watermarker, key) for flagship provenance
    sample_rate: int = 24_000
    max_text_len: int = 4096
    model_name: str = "csm-1b"  # advertised on /v1/models
    # per-request deadline (seconds, TOTAL — not per chunk gap): on
    # expiry the session is cancelled so its slot stops burning budget
    # for a client that already got the error
    request_timeout: float = 600.0

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s %s", self.address_string(), fmt % args)

    def _read_body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0 or n > 1 << 20:
                raise ValueError("bad Content-Length")
            return json.loads(self.rfile.read(n))
        except Exception as e:
            self._error(400, f"invalid request body: {e}")
            return None

    def _error(self, code: int, msg: str, retry_after: Optional[float] = None):
        payload = json.dumps({"error": msg}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        if retry_after is not None:
            self.send_header("Retry-After", str(max(1, int(round(retry_after)))))
        self.end_headers()
        self.wfile.write(payload)

    def _submit(self, body: dict):
        text = body.get("text", "")
        if not isinstance(text, str) or not text.strip():
            self._error(400, "missing 'text'")
            return None
        if len(text) > self.max_text_len:
            self._error(413, f"text longer than {self.max_text_len} chars")
            return None
        cached = None
        voice = body.get("voice")
        if voice is not None:
            if not isinstance(voice, str):  # a list/dict is unhashable —
                self._error(400, "voice must be a string")  # .get would raise
                return None
            cached = self.voices.get(voice)
            if cached is None:
                self._error(404, f"unknown voice {voice!r}")
                return None
        try:
            # OverflowError: json parses 1e999 as inf; int(inf) raises it
            speaker = int(body.get("speaker", 1))
            max_ms = float(body.get("max_audio_length_ms", 30_000))
            temperature = float(body.get("temperature", 0.8))
            topk = int(body.get("topk", 40))
            # admission class (lower admits first); unset = derived from
            # max_audio_length_ms (short = interactive, runtime/serving.py)
            priority = body.get("priority")
            if priority is not None:
                priority = int(priority)
        except (TypeError, ValueError, OverflowError) as e:
            self._error(400, f"bad parameters: {e}")
            return None
        # range-check BEFORE the values reach the shared decode program:
        # temperature 0 divides logits to NaN (garbage audio with a 200),
        # topk < 1 violates the sampler's top-k contract (ops/sampling.py)
        if not (temperature > 0.0 and math.isfinite(temperature)):
            self._error(400, "temperature must be a finite number > 0")
            return None
        if topk < 1:
            self._error(400, "topk must be >= 1")
            return None
        if not (max_ms > 0 and math.isfinite(max_ms)):
            # inf passes >0 but int(inf/FRAME_MS) dies in the admission loop
            self._error(400, "max_audio_length_ms must be a finite number > 0")
            return None
        try:
            # non-blocking submit: a full admission backlog is prompt
            # backpressure (429 + Retry-After), never a hung listener
            return self.engine.submit(
                text.strip(),
                wait=False,
                speaker=speaker,
                max_audio_length_ms=max_ms,
                temperature=temperature,
                topk=topk,
                priority=priority,
                cached_context=cached,
            )
        except ServerSaturated as e:
            self._error(429, f"server saturated: {e}", retry_after=e.retry_after_s)
            return None
        except Exception as e:
            self._error(400, f"bad parameters: {e}")
            return None

    def do_GET(self):
        if self.path.split("?", 1)[0] == "/healthz":
            info = {"status": "ok", "slots": self.engine.B,
                    "voices": sorted(self.voices)}
            if "deep=1" in self.path.partition("?")[2].split("&"):
                # drift canary: times the serving tick on its own state, so
                # "code regressed" and "the card is slow" are told apart
                try:
                    info["canary"] = self.engine.link_canary()
                except Exception as e:
                    info["status"] = "degraded"
                    info["canary_error"] = repr(e)
            payload = json.dumps(info).encode()
        elif self.path == "/v1/models":
            # OpenAI client compatibility: SDKs list models before use
            payload = json.dumps({
                "object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "sesameai-tts-tpu-torch"}],
            }).encode()
        elif self.path == "/metrics":
            # engine metrics (TTFA/session percentiles, frame and session
            # counters, occupancy)
            payload = json.dumps(self.engine.metrics_summary()).encode()
        else:
            self._error(404, "unknown path")
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        if self.path == "/v1/audio/speech":
            self._openai_speech()
            return
        if self.path not in ("/tts", "/tts/stream"):
            self._error(404, "unknown path")
            return
        body = self._read_body()
        if body is None:
            return
        session = self._submit(body)
        if session is None:
            return

        if self.path == "/tts":
            try:
                audio = session.audio(timeout=self.request_timeout)
            except Exception as e:
                # a timeout leaves the session still decoding: cancel it so
                # the slot doesn't keep burning its full max_audio_length_ms
                # budget for a client that already got the error
                session.cancel()
                self._error(500, f"generation failed: {e}")
                return
            audio = self._maybe_watermark(audio)
            peak = float(np.abs(audio).max(initial=0.0))
            if peak > 1.0:
                # over-full-scale audio would CLIP in the 16-bit WAV
                # (destroying the watermark); the DSP watermark is
                # gain-robust, so scaling preserves verification
                audio = audio / peak
            wav = _wav_bytes(audio, self.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            try:
                self.wfile.write(wav)
            except (BrokenPipeError, ConnectionResetError):
                pass  # generation already complete; nothing to cancel
            return

        # /tts/stream — chunked raw float32 PCM, flushed as emitted.
        self.send_response(200)
        self.send_header(
            "Content-Type", "audio/pcm;rate=%d;encoding=float32" % self.sample_rate
        )
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for piece in self._iter_watermarked(session):
                self._write_chunk(piece.astype(np.float32).tobytes())
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            session.cancel()  # client hung up: free the slot
            self.close_connection = True
        except _SessionFailed:
            # abort WITHOUT the clean terminator: the client sees a
            # truncated chunked body, not a well-formed empty success
            logger.error("stream session failed: %s", session.error)
            self.close_connection = True
        except Exception:
            logger.exception("stream aborted")
            session.cancel()
            self.close_connection = True

    def _write_chunk(self, raw: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame, flushed immediately."""
        if not raw:
            return
        self.wfile.write(b"%x\r\n" % len(raw) + raw + b"\r\n")
        self.wfile.flush()

    def _iter_watermarked(self, session):
        """Yield float32 PCM pieces (watermarked when configured) as the
        engine emits them — the pump under /tts/stream and the OpenAI
        streaming framings.

        With a watermarker configured (flagship), PCM flows through the
        streaming embedder (watermark/stream.py): one continuous watermark
        across the whole response at ~0.1 s pipeline latency, every ≥4 s
        prefix verifiable.  Other backends fall back to ≥4 s watermarked
        groups.

        Raises TimeoutError when the per-request deadline expires and
        ``_SessionFailed`` when the engine session errored — callers
        translate those into their framing's abort semantics.
        """
        stream_wm = None
        group_samples = 0
        if self.watermarker is not None:
            from sesameai_tts_tpu_torch.watermark.stream import make_streaming_watermarker

            wm, key = self.watermarker
            stream_wm = make_streaming_watermarker(wm, key, self.sample_rate)
            if stream_wm is None:
                group_samples = 4 * self.sample_rate
        buf = []

        def wm_group(chunks):
            raw = np.concatenate(chunks).astype(np.float32)
            return self._maybe_watermark(raw).astype(np.float32)

        deadline = time.monotonic() + self.request_timeout
        while True:
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise TimeoutError(
                    f"request deadline ({self.request_timeout:.0f}s) exceeded"
                )
            chunk = session.chunks.get(timeout=rem)
            if chunk is None:
                break
            pcm = np.asarray(chunk, np.float32)
            if stream_wm is not None:
                piece = stream_wm.feed(pcm)
                if len(piece):
                    yield piece
            elif group_samples:
                buf.append(pcm)
                if sum(len(c) for c in buf) >= group_samples:
                    yield wm_group(buf)
                    buf = []
            elif len(pcm):
                yield pcm
        if session.error is not None:
            raise _SessionFailed(str(session.error))
        if stream_wm is not None:
            tail = stream_wm.close()
            if len(tail):
                yield tail
        elif buf:
            yield wm_group(buf)

    def _openai_speech(self):
        """OpenAI-compatible ``POST /v1/audio/speech``.

        Field mapping: ``input`` → text, ``voice`` → registry voice,
        ``model`` accepted and ignored (one model per server),
        ``response_format`` ∈ {"wav", "pcm"} (pcm = raw 16-bit
        little-endian mono at the engine sample rate — OpenAI's pcm
        semantics), ``speed`` ∈ [1.0, 4.0] via the pitch-preserving
        chunked speedup (audio/segment.py::speedup; slow-down is not
        implemented).  The /tts
        extension knobs (max_audio_length_ms, temperature, topk,
        speaker) pass through.  The watermark embeds AFTER the speed
        change so the delivered audio carries a verifiable mark.
        ``stream_format`` ∈ {"audio", "sse"} switches to the OpenAI
        streaming framings (``_openai_speech_stream``)."""
        body = self._read_body()
        if body is None:
            return
        text = body.get("input")
        if not isinstance(text, str) or not text.strip():
            self._error(400, "missing 'input'")
            return
        fmt = body.get("response_format", "wav")
        if fmt not in ("wav", "pcm"):
            self._error(
                400, f"unsupported response_format {fmt!r}; supported: wav, pcm"
            )
            return
        stream_format = body.get("stream_format")
        if stream_format is not None and stream_format not in ("audio", "sse"):
            self._error(
                400,
                f"unsupported stream_format {stream_format!r}; "
                "supported: audio, sse",
            )
            return
        try:
            speed = float(body.get("speed", 1.0))
        except (TypeError, ValueError):
            self._error(400, "speed must be a number")
            return
        if not 1.0 <= speed <= 4.0:
            self._error(
                400, "speed must be in [1.0, 4.0] (speed-up only)"
            )
            return
        voice = body.get("voice")
        if voice is not None and not isinstance(voice, str):
            self._error(400, "voice must be a string")  # lists are unhashable
            return
        if voice is not None and voice not in self.voices:
            # OpenAI's API REQUIRES a voice field and stock SDK calls send
            # names like "alloy" — a drop-in server must not 404 them.
            # Unrecognized OpenAI stock names map to the server default
            # (first registered voice, else context-free generation).
            if voice.lower() in _OPENAI_STOCK_VOICES:
                voice = sorted(self.voices)[0] if self.voices else None
        session = self._submit({
            "text": text,
            "voice": voice,
            "speaker": body.get("speaker", 1),
            "max_audio_length_ms": body.get("max_audio_length_ms", 30_000),
            "temperature": body.get("temperature", 0.8),
            "topk": body.get("topk", 40),
            "priority": body.get("priority"),
        })
        if session is None:
            return
        if stream_format is not None:
            self._openai_speech_stream(session, fmt, speed, stream_format)
            return
        try:
            audio = session.audio(timeout=self.request_timeout)
        except Exception as e:
            session.cancel()  # free the slot (same invariant as /tts)
            self._error(500, f"generation failed: {e}")
            return
        if speed > 1.0 and len(audio):
            from sesameai_tts_tpu_torch.audio.segment import AudioClip

            audio = AudioClip.from_float(audio, self.sample_rate).speedup(
                playback_speed=speed
            ).samples
        audio = self._maybe_watermark(audio)
        peak = float(np.abs(audio).max(initial=0.0))
        if peak > 1.0:  # 16-bit clipping would destroy the watermark
            audio = audio / peak
        if fmt == "wav":
            payload, ctype = _wav_bytes(audio, self.sample_rate), "audio/wav"
        else:
            payload = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
            ctype = "audio/pcm;rate=%d;encoding=s16le" % self.sample_rate
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # generation already complete; nothing to cancel

    def _openai_speech_stream(self, session, fmt: str, speed: float,
                              stream_format: str) -> None:
        """OpenAI Audio-API streaming framings over a live session.

        ``stream_format == "audio"``: chunked transfer of the encoded
        audio bytes as the engine emits them — for ``pcm`` raw s16le
        pieces, for ``wav`` a streaming RIFF header (unknown-length
        sizes) followed by s16le frames.  ``stream_format == "sse"``:
        ``text/event-stream`` of ``speech.audio.delta`` events carrying
        base64-encoded audio (encoded per ``response_format``) and a
        final ``speech.audio.done`` event — the OpenAI SDK's
        ``with_streaming_response`` / event-stream consumers work
        unchanged.  Audio is watermarked by the same streaming pump as
        /tts/stream.

        ``speed > 1`` cannot stream incrementally (the pitch-preserving
        speedup needs the whole utterance, audio/segment.py::speedup);
        the response keeps the requested framing but carries one
        buffered piece.
        """
        import base64

        def pieces():
            if speed > 1.0:
                audio = session.audio(timeout=self.request_timeout)
                if len(audio):
                    from sesameai_tts_tpu_torch.audio.segment import AudioClip

                    audio = AudioClip.from_float(
                        audio, self.sample_rate
                    ).speedup(playback_speed=speed).samples
                audio = self._maybe_watermark(np.asarray(audio, np.float32))
                peak = float(np.abs(audio).max(initial=0.0))
                if peak > 1.0:  # 16-bit clipping would destroy the watermark
                    audio = audio / peak
                if len(audio):
                    yield audio.astype(np.float32)
            else:
                yield from self._iter_watermarked(session)

        def encode(piece: np.ndarray) -> bytes:
            # same s16le encode as the buffered pcm path; per-piece clip
            # (a stream cannot be peak-normalized globally)
            return (np.clip(piece, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()

        if stream_format == "audio":
            ctype = ("audio/wav" if fmt == "wav" else
                     "audio/pcm;rate=%d;encoding=s16le" % self.sample_rate)
        else:
            ctype = "text/event-stream"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        if stream_format == "sse":
            self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        # the wav header rides the FIRST delta so every prefix of the
        # reassembled byte stream is a playable (streaming) WAV
        header = streaming_wav_header(self.sample_rate) if fmt == "wav" else b""
        try:
            if stream_format == "audio":
                self._write_chunk(header)
                for piece in pieces():
                    self._write_chunk(encode(piece))
            else:
                for piece in pieces():
                    evt = json.dumps({
                        "type": "speech.audio.delta",
                        "audio": base64.b64encode(
                            header + encode(piece)).decode(),
                    })
                    header = b""
                    self._write_chunk(b"data: " + evt.encode() + b"\n\n")
                self._write_chunk(b'data: {"type": "speech.audio.done"}\n\n')
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            session.cancel()  # client hung up: free the slot
            self.close_connection = True
        except _SessionFailed:
            logger.error("openai stream session failed: %s", session.error)
            self.close_connection = True
        except Exception:
            logger.exception("openai stream aborted")
            session.cancel()
            self.close_connection = True

    def _maybe_watermark(self, audio: np.ndarray) -> np.ndarray:
        if self.watermarker is None or not len(audio):
            return audio
        from sesameai_tts_tpu_torch.audio.resample import resample
        from sesameai_tts_tpu_torch.watermark.api import watermark

        wm, key = self.watermarker
        out, rate = watermark(wm, audio, self.sample_rate, key)
        if rate != self.sample_rate:
            out = resample(out, rate, self.sample_rate)
        return out


class _HTTPServer(ThreadingHTTPServer):
    # connections the listening socket queues before accept: a burst of
    # clients gets 429s from the handler, not resets from the kernel (the
    # socketserver default is 5)
    request_queue_size = 128


def serve(engine: BatchedTTSServer, host: str = "0.0.0.0", port: int = 8080,
          voices: Optional[dict] = None,
          sample_rate: int = 24_000,
          watermarker=None, model_name: str = "csm-1b",
          request_timeout: float = 600.0) -> ThreadingHTTPServer:
    """Start the HTTP front end (returns the server; call .shutdown()).

    ``watermarker``: optional (Watermarker, key) pair — REQUIRED for
    flagship deployments so the public endpoint never emits
    unwatermarked audio (the CLI enforces the same invariant).
    ``request_timeout``: total per-request deadline; an expired request
    gets a 500/truncated stream and its session is cancelled."""
    handler = type(
        "BoundHandler", (TTSRequestHandler,),
        {"engine": engine, "voices": voices or {}, "sample_rate": sample_rate,
         "watermarker": watermarker, "model_name": model_name,
         "request_timeout": request_timeout},
    )
    httpd = _HTTPServer((host, port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    logger.info("TTS HTTP API on %s:%d (%d slots)", host, port, engine.B)
    return httpd


def main(argv=None):
    import argparse

    # the serve command is an operator surface: its startup progress (model
    # build, voice preload, warmup timings, port bind) is logged by default
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    p = argparse.ArgumentParser(description="CSM TTS HTTP server (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("-d", "--device", default="cuda",
                   help="device to serve on (cuda or cpu)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="scheduler tick size in frames (default: 10 for <=8 slots, 5 "
                        "above). Smaller ticks bound TTFA under load tighter (an admission "
                        "waits out at most one tick in flight) at a throughput cost")
    p.add_argument("--model-path", default=None)
    p.add_argument("--mimi-path", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="'byte', 'tiny', or a local tokenizer.json path. Default: a "
                        "--model-path dir holding tokenizer.json supplies it; runs "
                        "without weights fall back to 'byte'")
    p.add_argument("--voices", default=None, help="voice directory root")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"])
    p.add_argument("--max-pending", type=int, default=None,
                   help="admission backlog bound (default: 4x slots). A full backlog "
                        "returns 429 + Retry-After instead of queueing requests without "
                        "bound. 0 = unbounded")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="total per-request deadline in seconds; expired requests are "
                        "cancelled and their slot freed")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=True,
                   help="before binding the port, capture the serving graphs and run "
                        "every prefill bucket, the first chunk and the batched codec "
                        "decode once (BatchedTTSServer.warmup). The graphs are captured "
                        "at start() either way; --no-warmup leaves the rest to the "
                        "first requests")
    p.add_argument("--max-positions", type=int, default=None,
                   help="backbone KV capacity in rows (default: the model's, 2048). The "
                        "decode step reads the whole static KV buffer of a slot, so a "
                        "server whose sessions fit fewer rows (voice context + text + "
                        "audio frames) decodes each step faster")
    p.add_argument("--no-quantize", action="store_true",
                   help="serve bf16 trunks instead of the weight-only int8 default")
    args = p.parse_args(argv)

    from sesameai_tts_tpu_torch.runtime.loader import (
        build_generator,
        csm_1b_spec,
        test_tiny_spec,
    )

    spec = (
        test_tiny_spec() if args.flavor == "test-tiny"
        else csm_1b_spec(args.model_path, args.mimi_path, args.tokenizer,
                         quantize=None if args.no_quantize else "int8")
    )
    if args.max_positions is not None:
        # the backbone flavor's max_seq_len is the trained ceiling;
        # spec.csm.max_seq_len is only the serving override
        from sesameai_tts_tpu_torch.core.config import get_flavor

        trained_cap = get_flavor(spec.csm.backbone_flavor).max_seq_len
        if args.max_positions < 64:
            p.error(
                f"--max-positions must be >= 64 (got {args.max_positions}): the backbone "
                "KV has to hold the voice context + text rows + generated audio frames"
            )
        if args.max_positions > trained_cap:
            p.error(
                f"--max-positions {args.max_positions} exceeds the model's trained "
                f"position ceiling ({trained_cap}); RoPE positions past it were never "
                "trained"
            )
        spec.csm = spec.csm.replace(max_seq_len=args.max_positions)
    gen = build_generator(spec, device=args.device)

    voices = {}
    if args.voices:
        from sesameai_tts_tpu_torch.service.tts import prepare_voice_context
        from sesameai_tts_tpu_torch.service.voices import load_registry

        for name, clips in load_registry(args.voices).items():
            # each voice's KV prefix is computed once; every request for the
            # voice copies it (no per-request context prefill)
            fitted, _rows, _trimmed = prepare_voice_context(gen, clips, name)
            voices[name] = gen.precompute_context_state(fitted)

    wm = None
    if args.flavor != "test-tiny":
        # flagship audio is always watermarked (the same invariant as the CLI)
        from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK, load_watermarker

        wm = (load_watermarker(device=args.device), CSM_1B_WATERMARK)

    if args.chunk_frames is None:
        args.chunk_frames = 10 if args.slots <= 8 else 5
    if args.max_pending is None:
        args.max_pending = 4 * args.slots
    engine = BatchedTTSServer(gen, slots=args.slots, chunk_frames=args.chunk_frames,
                              max_pending=args.max_pending or None)
    logger.info("scheduler tick: %d frames, backlog bound %s", args.chunk_frames,
                args.max_pending or "unbounded")
    if args.warmup:
        t0 = time.time()
        times = engine.warmup()
        logger.info("warmup: %d steps in %.1fs", len(times), time.time() - t0)
    engine.start()
    httpd = serve(engine, args.host, args.port, voices, gen.sample_rate,
                  watermarker=wm, model_name=args.flavor,
                  request_timeout=args.request_timeout)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        engine.stop()


if __name__ == "__main__":
    main()
