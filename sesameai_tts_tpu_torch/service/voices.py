"""Voice registry: named voices, each a ``{wav_path: transcript}`` dict
of reference clips (port of ``sesameai_tts_tpu/service/voices.py``).

Three sources: public dicts of a ``samples.py``-style module, a JSON file,
and a directory convention (``<dir>/<voice>/<clip>.wav`` beside
``<clip>.txt``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


VoiceData = Dict[str, str]  # wav_path -> transcript


def _is_voice_dict(obj) -> bool:
    """A voice registry dict maps wav paths (str/PathLike) to transcript
    strings.  Other public dicts in a samples-style module (speaker-id
    maps, config tables, ...) are not voices and must not crash
    discovery when their keys aren't paths."""
    return isinstance(obj, dict) and all(
        isinstance(k, (str, os.PathLike)) and isinstance(v, str)
        for k, v in obj.items()
    )


def _resolve_clip_paths(clips: dict, base: str) -> VoiceData:
    """Resolve relative wav paths against ``base`` (shared by the JSON
    and samples.py sources so the two branches can't drift)."""
    out: VoiceData = {}
    for p, t in clips.items():
        p = os.fspath(p)
        out[p if os.path.isabs(p) else os.path.join(base, p)] = t
    return out


def discover_from_module(module) -> Dict[str, VoiceData]:
    """Reflect public dict attributes of a samples-style module
    (reference tts_service.py:37-42)."""
    return {
        name: obj
        for name, obj in vars(module).items()
        if not name.startswith("__") and _is_voice_dict(obj)
    }


def discover_from_json(path: str) -> Dict[str, VoiceData]:
    """{"voice": {"clip.wav": "transcript", ...}, ...}; relative wav
    paths resolve against the JSON file's directory."""
    with open(path) as f:
        reg = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    return {
        voice: _resolve_clip_paths(clips, base) for voice, clips in reg.items()
    }


def discover_from_dir(root: str) -> Dict[str, VoiceData]:
    """<root>/<voice>/*.wav with sibling .txt transcripts."""
    out: Dict[str, VoiceData] = {}
    if not os.path.isdir(root):
        return out
    for voice in sorted(os.listdir(root)):
        vdir = os.path.join(root, voice)
        if not os.path.isdir(vdir):
            continue
        clips: VoiceData = {}
        for f in sorted(os.listdir(vdir)):
            if f.endswith(".wav"):
                txt = os.path.join(vdir, f[:-4] + ".txt")
                if os.path.exists(txt):
                    with open(txt) as t:
                        clips[os.path.join(vdir, f)] = t.read().strip()
        if clips:
            out[voice] = clips
    return out


def load_registry(spec: Optional[str] = None) -> Dict[str, VoiceData]:
    """spec: None ($SESAME_TTS_VOICES, then ./samples.py, then
    ./voices/), a .py module path, a .json path, or a directory."""
    if spec is None:
        env = os.environ.get("SESAME_TTS_VOICES")
        if env:
            return load_registry(env)
        if os.path.exists("samples.py"):
            return load_registry("samples.py")
        return discover_from_dir("voices")
    if spec.endswith(".json"):
        return discover_from_json(spec)
    if spec.endswith(".py"):
        import importlib.util

        name = os.path.splitext(os.path.basename(spec))[0]
        mod_spec = importlib.util.spec_from_file_location(name, spec)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        reg = discover_from_module(module)
        # samples.py-style modules use paths relative to their own repo
        # root (reference samples.py:4 ``AUDIO_DIR = Path("wav")``); the
        # reference only works when run from that directory. Resolve
        # relative clip paths against the module's directory so e.g.
        # ``--voices /path/to/checkout/samples.py`` works from anywhere.
        base = os.path.dirname(os.path.abspath(spec))
        return {
            voice: _resolve_clip_paths(clips, base)
            for voice, clips in reg.items()
        }
    return discover_from_dir(spec)
