"""sesameai_tts_tpu_torch — the PyTorch/CUDA port of ``sesameai_tts_tpu``.

Same module names and public functions as the JAX package, in PyTorch
idiom: plain functions over dictionaries of tensors, an explicit
``device``, explicit ``torch.Generator``s, and KV caches written in place.
The Pallas kernels of the JAX package are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` at first use.

Entry points (the card unless the caller passes ``device="cpu"``)::

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    gen = build_generator(csm_1b_spec(), device="cuda")

    python -m sesameai_tts_tpu_torch.service.cli -v <voice> "Hello." --output out.wav

Top-level conveniences, imported lazily::

    from sesameai_tts_tpu_torch import load_csm_1b, Segment, TTS, BatchedTTSServer
"""

__version__ = "0.1.0"

_LAZY = {
    "load_csm_1b": ("sesameai_tts_tpu_torch.runtime.loader", "load_csm_1b"),
    "build_generator": ("sesameai_tts_tpu_torch.runtime.loader", "build_generator"),
    "ModelSpec": ("sesameai_tts_tpu_torch.runtime.loader", "ModelSpec"),
    "Generator": ("sesameai_tts_tpu_torch.runtime.generator", "Generator"),
    "Segment": ("sesameai_tts_tpu_torch.runtime.frames", "Segment"),
    "TTS": ("sesameai_tts_tpu_torch.service.tts", "TTS"),
    "BatchedTTSServer": ("sesameai_tts_tpu_torch.runtime.serving", "BatchedTTSServer"),
    "generate_streaming_audio": ("sesameai_tts_tpu_torch.runtime.streaming",
                                 "generate_streaming_audio"),
    "AudioStreamWriter": ("sesameai_tts_tpu_torch.runtime.streaming", "AudioStreamWriter"),
    "watermark": ("sesameai_tts_tpu_torch.watermark.api", "watermark"),
    "verify": ("sesameai_tts_tpu_torch.watermark.api", "verify"),
    "load_watermarker": ("sesameai_tts_tpu_torch.watermark.api", "load_watermarker"),
    "CSM_1B_WATERMARK": ("sesameai_tts_tpu_torch.watermark.api", "CSM_1B_WATERMARK"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sesameai_tts_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
