"""Streaming audio sinks (port of ``sesameai_tts_tpu/runtime/streaming.py``).

``AudioStreamWriter`` collects chunks thread-safely and writes one WAV.
``generate_streaming_audio`` drives ``Generator.generate_stream`` with a
writer and an optional sounddevice player thread, printing wall-clock
progress.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.runtime.generator import Generator


class AudioStreamWriter:
    """Thread-safe chunk collector → one WAV write."""

    def __init__(self, filename: str, sample_rate: int):
        self.filename = filename
        self.sample_rate = sample_rate
        self.audio_chunks: List[np.ndarray] = []
        self.lock = threading.Lock()

    def add_chunk(self, chunk: np.ndarray) -> None:
        with self.lock:
            self.audio_chunks.append(np.asarray(chunk, np.float32))

    def write_file(self) -> None:
        with self.lock:
            if not self.audio_chunks:
                return
            audio = np.concatenate(self.audio_chunks)
            write_wav(self.filename, audio, self.sample_rate)


def generate_streaming_audio(
    generator: Generator,
    text: str,
    speaker: int,
    context: Sequence,
    output_file: str,
    max_audio_length_ms: float = 90_000,
    temperature: float = 0.7,
    topk: int = 30,
    play_audio: bool = False,
    chunk_frames: Optional[int] = None,
) -> int:
    """Generate with streaming output into ``output_file``; optionally play
    in realtime.  Returns the chunk count."""
    writer = AudioStreamWriter(output_file, generator.sample_rate)
    audio_queue: "queue.Queue[np.ndarray]" = queue.Queue()
    stop_event = threading.Event()
    player_thread = None

    if play_audio:
        try:
            import sounddevice as sd

            def audio_player():
                while not stop_event.is_set() or not audio_queue.empty():
                    try:
                        chunk = audio_queue.get(timeout=0.5)
                        sd.play(chunk, generator.sample_rate)
                        sd.wait()
                    except queue.Empty:
                        continue

            player_thread = threading.Thread(target=audio_player, daemon=True)
            player_thread.start()
        except ImportError:
            print(
                "sounddevice library not found. Install it to enable "
                "real-time playback."
            )
            play_audio = False

    def on_chunk_generated(chunk):
        writer.add_chunk(chunk)
        if play_audio:
            audio_queue.put(chunk)

    print("Generating audio in streaming mode...")
    start_time = time.time()
    chunk_count = 0
    try:
        for _ in generator.generate_stream(
            text=text,
            speaker=speaker,
            context=context,
            max_audio_length_ms=max_audio_length_ms,
            temperature=temperature,
            topk=topk,
            on_chunk_generated=on_chunk_generated,
            chunk_frames=chunk_frames,
        ):
            chunk_count += 1
    finally:
        # a mid-stream failure still writes the audio already collected
        # and retires the player thread
        writer.write_file()
        if play_audio and player_thread is not None:
            stop_event.set()
            player_thread.join()
    print(f"Audio generation completed in {time.time() - start_time:.2f} seconds")
    return chunk_count
