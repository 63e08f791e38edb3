"""One-shot WAV transcription through an OpenAI-compatible audio API (port
of ``sesameai_tts_tpu/apps/audio_to_text.py``): a multipart POST to
``{api_base}/audio/transcriptions`` with the standard library only."""

from __future__ import annotations

import argparse
import json
import os
import time
import urllib.request
import uuid


def transcribe(
    audio_path: str,
    api_base: str = None,
    api_key: str = None,
    model: str = "whisper-1",
) -> str:
    api_base = api_base or os.environ.get("OPENAI_API_BASE", "https://api.openai.com/v1")
    api_key = api_key or os.environ.get("OPENAI_API_KEY", "")

    boundary = uuid.uuid4().hex
    with open(audio_path, "rb") as f:
        file_data = f.read()

    parts = [
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\n{model}\r\n"
        .encode(),
        (
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{os.path.basename(audio_path)}\"\r\n"
            "Content-Type: audio/wav\r\n\r\n"
        ).encode() + file_data + b"\r\n",
        f"--{boundary}--\r\n".encode(),
    ]
    req = urllib.request.Request(
        f"{api_base}/audio/transcriptions",
        data=b"".join(parts),
        headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}",
            "Authorization": f"Bearer {api_key}",
        },
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read().decode())["text"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Transcribe a WAV file")
    parser.add_argument("audio_path")
    parser.add_argument("--model", default="whisper-1")
    args = parser.parse_args(argv)

    start = time.time()
    text = transcribe(args.audio_path, model=args.model)
    print(f"Transcription ({time.time() - start:.2f}s):\n{text}")


if __name__ == "__main__":
    main()
