"""The system under test: the port's ``Generator`` built from the weights
the benchmark drew, its ``BatchedTTSServer``, the cached voices, and the
warm-up of every shape the cell's traffic will use.

This module and the model families (``families/<model_type>.py``) are
the ones that import the port (``sesameai_tts_tpu_torch``): the
configurations, weights and quantization of the model come from the
cell's family.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import texts, weights
from benchmark.harness.client import Request, Sender


def _transformer_config(t: dict, dtype):
    from sesameai_tts_tpu_torch.core.config import RoPEConfig, TransformerConfig

    return TransformerConfig(num_layers=t["num_layers"], num_heads=t["num_heads"],
                             num_kv_heads=t["num_kv_heads"], embed_dim=t["embed_dim"],
                             max_seq_len=t["max_seq_len"], intermediate_dim=t["intermediate_dim"],
                             norm_eps=t["norm_eps"], rope=RoPEConfig(**t["rope"]), dtype=dtype)


def mimi_config(m: dict):
    """The port's MimiConfig holding the numbers of a configuration's
    ``mimi`` group (every family's codec)."""
    from sesameai_tts_tpu_torch.codec.mimi import MimiConfig
    from sesameai_tts_tpu_torch.codec.rvq import RVQConfig
    from sesameai_tts_tpu_torch.codec.seanet import SEANetConfig
    from sesameai_tts_tpu_torch.codec.transformer import CodecTransformerConfig

    seanet = dict(m["seanet"], ratios=tuple(m["seanet"]["ratios"]))
    return MimiConfig(sample_rate=m["sample_rate"], frame_rate=m["frame_rate"],
                      num_codebooks=m["num_codebooks"], seanet=SEANetConfig(**seanet),
                      transformer=CodecTransformerConfig(**m["transformer"]),
                      rvq=RVQConfig(**m["rvq"]), downsample_stride=m["downsample_stride"])


def port_configs(config: dict, name: str):
    """The port's (CSMConfig, MimiConfig) holding the file's numbers: the
    trunks are registered as flavors named after the configuration."""
    from sesameai_tts_tpu_torch.core.config import CSMConfig, register_flavor

    dtype = weights.dtype_of(config["dtype"])
    for part in ("backbone", "decoder"):
        cfg = _transformer_config(config[part], dtype)
        register_flavor(f"{name}/{part}", lambda cfg=cfg: cfg)
    csm = CSMConfig(backbone_flavor=f"{name}/backbone", decoder_flavor=f"{name}/decoder",
                    text_vocab_size=config["text_vocab_size"],
                    audio_vocab_size=config["audio_vocab_size"],
                    audio_num_codebooks=config["audio_num_codebooks"])
    return csm, mimi_config(config["mimi"])


def build(family, config: dict, name: str, seed: int, device, slots: int, chunk_frames: int,
          quantize: Optional[str] = "config", phase=lambda what: None):
    """The Generator over the weights that the model ``family`` draws from
    ``seed`` (quantized by the program as the configuration states, or as
    ``quantize`` overrides) and its pool → the server (not started).
    ``phase(name)`` is called as each step ends."""
    from sesameai_tts_tpu_torch.codec.mimi import Mimi
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer
    from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer

    phase("the port imported")
    torch.zeros(1, device=device)
    _sync(device)
    phase("device context")
    model_cfg, mimi_cfg = family.port(config, name)
    q = config.get("quantize") if quantize == "config" else quantize
    params = family.draw(config, seed, device)
    mimi_params = weights.draw_mimi(config, seed, device)
    _sync(device)
    phase("weights drawn")
    if q is not None:
        params = family.quantize(params, {"int8": 8, "int4": 4}[q])
        _sync(device)
    phase("weights quantized")
    gen = Generator(params, model_cfg, Mimi(mimi_cfg), mimi_params,
                    load_text_tokenizer(config["tokenizer"]), device=device,
                    seed=weights.sub_seeds(seed, 3)[2], fused_mlp=config.get("fused_mlp", False))
    _sync(device)
    phase("Generator built (kernels built or loaded, prefill shadow)")
    srv = BatchedTTSServer(gen, slots=slots, chunk_frames=chunk_frames)
    _sync(device)
    phase("pool built")
    return srv


def cache_voices(server, voices: List[texts.Voice]) -> None:
    """Each voice's prompt prefilled once through the program
    (``precompute_context_state``), its handle kept for ``cached_context``."""
    for v in voices:
        v.handle = server.gen.precompute_context_state([(v.tokens.astype(np.int32), v.mask)])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm(server, config: dict, voices: List[texts.Voice], plan: List[Request],
         timeout: float = 120.0) -> dict:
    """Before the window: requests like the plan's through the started
    pool, one for every 64-row band of text rows the plan holds (every
    prefill shape it will use), greedy and sampled, beside one another (the
    short ticks of an admission backlog) and then one alone (full ticks).
    → what ran."""
    bands = {}
    for r in plan:
        band = (texts.text_rows(config, voices[r.voice], r.text) - 1) // 64
        bands.setdefault(band, r)
    short = [Request(text=r.text, voice=r.voice, budget_ms=960.0, temperature=r.temperature,
                     topk=40 if i % 2 else 1) for i, r in enumerate(bands.values())]
    longest = max(plan, key=lambda r: len(r.text))
    alone = Request(text=longest.text, voice=longest.voice, budget_ms=2400.0, temperature=0.8,
                    topk=40)
    sender = Sender(server, voices)
    t0 = time.perf_counter()
    for batch in (short + [Request(text=r.text, voice=r.voice, budget_ms=960.0,
                                   temperature=0.8, topk=40) for r in short], [alone]):
        for r in batch:
            sender.send(r)
        for r in batch:
            r.session.audio(timeout=timeout)
    _sync(server.gen.device)
    return {"warm_requests": len(sender.sent), "warm_s": time.perf_counter() - t0,
            "bands": sorted(bands)}
