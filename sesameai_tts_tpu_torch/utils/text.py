"""Text cleaning and sentence splitting for TTS input (port of
``sesameai_tts_tpu/utils/text.py``): strip markdown, code, links and
HTML, whitelist TTS-safe characters, normalize whitespace and repeated
punctuation, em-dash → ellipsis.

The cleaner keeps the reference cleaner's two quirks, as the JAX package
does: the repeat-punctuation collapse also turns the substituted "..."
into ".", and the space-after-punctuation rule splits hyphenated words
("well-known" → "well- known").
"""

from __future__ import annotations

import re
from typing import List


def clean_text_for_tts(text) -> str:
    if not isinstance(text, str):
        text = str(text)

    text = text.replace("—", "...")
    text = re.sub(r"```[\s\S]*?```", "", text)  # code blocks
    text = re.sub(r"`[^`]*`", "", text)  # inline code
    text = re.sub(r"\[([^\]]+)\]\([^)]+\)", r"\1", text)  # md links → text
    text = re.sub(r"(\*\*|__)(.*?)\1", r"\2", text)  # bold
    text = re.sub(r"(\*|_)(.*?)\1", r"\2", text)  # italics
    text = re.sub(r"<[^>]*>", "", text)  # html tags
    text = re.sub(r"[^\w\s.,!?:;\'\"-]", "", text)  # charset whitelist
    text = re.sub(r"\s+", " ", text)  # whitespace
    text = re.sub(r"([.,!?:;-])\1+", r"\1", text)  # "!!" → "!"
    text = re.sub(r"([.,!?:;-])(\w)", r"\1 \2", text)  # space after punct
    return text.strip()


def generate_tts_audio(text: str, tts_instance, temperature: float = 0.7,
                       top_k=None) -> "str | None":
    """Clean text, synthesize with ``tts_instance.generate_audio_segment``,
    save to a temporary WAV and return its path; None on empty text or
    failure."""
    import logging
    import os
    import tempfile

    log = logging.getLogger(__name__)
    cleaned = clean_text_for_tts(text)
    if not cleaned:
        log.warning("Skipping TTS generation for empty or invalid text.")
        return None
    try:
        kwargs = {"temperature": temperature, "fade_duration": 50,
                  "start_silence_duration": 100, "end_silence_duration": 100}
        if top_k is not None:
            kwargs["topk"] = top_k
        clip = tts_instance.generate_audio_segment(cleaned, **kwargs)
        if clip is None or len(clip.samples) == 0:
            log.error("TTS generated empty audio segment.")
            return None
        fd, path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        clip.export(path)
        return path
    except Exception:
        log.exception("Error during TTS generation process")
        return None


def split_sentences(text: str) -> List[str]:
    """Split on whitespace after terminal punctuation (``(?<=[.!?])\\s+``)."""
    return [s for s in re.split(r"(?<=[.!?])\s+", text.strip()) if s.strip()]


def split_clean_sentences(text: str) -> List[str]:
    """Clean, then split after terminal punctuation, keeping each
    delimiter on its sentence."""
    cleaned = clean_text_for_tts(text)
    parts = re.split(r"([.!?])(\s+|$)", cleaned)
    out: List[str] = []
    current = ""
    for i in range(0, len(parts), 3):
        part = parts[i] if i < len(parts) else ""
        delim = parts[i + 1] if i + 1 < len(parts) else ""
        if part:
            current += part + delim
            if delim and current.strip():
                out.append(current.strip())
                current = ""
    if current.strip():
        out.append(current.strip())
    return [s for s in out if s]
