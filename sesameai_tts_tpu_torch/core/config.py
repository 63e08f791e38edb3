"""Typed configuration tree (port of ``sesameai_tts_tpu/core/config.py``).

Every field and flavor matches the JAX package; only ``dtype`` is a torch
dtype here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch


@dataclass(frozen=True)
class RoPEConfig:
    """Llama-3.2 scaled rotary embeddings (Meta's llama3 rescaling)."""

    base: float = 500_000.0
    scale_factor: int = 32
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    old_context_len: int = 8192


@dataclass(frozen=True)
class TransformerConfig:
    """One Llama-3.2-style trunk (embeddings in, hidden states out)."""

    num_layers: int
    num_heads: int
    num_kv_heads: int
    embed_dim: int
    max_seq_len: int
    intermediate_dim: int
    norm_eps: float = 1e-5
    rope: RoPEConfig = RoPEConfig()
    dtype: torch.dtype = torch.bfloat16  # params + activations; norms/logits in f32

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


FLAVORS: Dict[str, Callable[[], TransformerConfig]] = {}


def register_flavor(name: str, fn: Callable[[], TransformerConfig]) -> None:
    FLAVORS[name] = fn


def get_flavor(name: str) -> TransformerConfig:
    return FLAVORS[name]()


def llama3_2_1B() -> TransformerConfig:
    """Backbone flavor."""
    return TransformerConfig(
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        embed_dim=2048,
        max_seq_len=2048,
        intermediate_dim=8192,
    )


def llama3_2_100M() -> TransformerConfig:
    """Codebook-decoder flavor."""
    return TransformerConfig(
        num_layers=4,
        num_heads=8,
        num_kv_heads=2,
        embed_dim=1024,
        max_seq_len=2048,
        intermediate_dim=8192,
    )


def test_tiny() -> TransformerConfig:
    """CPU-testable backbone stand-in."""
    return TransformerConfig(
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        embed_dim=64,
        max_seq_len=256,
        intermediate_dim=128,
        dtype=torch.float32,
    )


def test_tiny_decoder() -> TransformerConfig:
    return TransformerConfig(
        num_layers=2,
        num_heads=2,
        num_kv_heads=1,
        embed_dim=32,
        max_seq_len=64,
        intermediate_dim=64,
        dtype=torch.float32,
    )


register_flavor("llama-1B", llama3_2_1B)
register_flavor("llama-100M", llama3_2_100M)
register_flavor("test-tiny", test_tiny)
register_flavor("test-tiny-decoder", test_tiny_decoder)


@dataclass(frozen=True)
class CSMConfig:
    """Backbone + codebook decoder + vocabularies (sesame/csm-1b values)."""

    backbone_flavor: str = "llama-1B"
    decoder_flavor: str = "llama-100M"
    text_vocab_size: int = 128_256
    audio_vocab_size: int = 2051
    audio_num_codebooks: int = 32
    # optional backbone KV/position capacity override (rows)
    max_seq_len: Optional[int] = None

    @property
    def backbone(self) -> TransformerConfig:
        cfg = get_flavor(self.backbone_flavor)
        if self.max_seq_len is not None and self.max_seq_len != cfg.max_seq_len:
            cfg = dataclasses.replace(cfg, max_seq_len=self.max_seq_len)
        return cfg

    @property
    def decoder(self) -> TransformerConfig:
        return get_flavor(self.decoder_flavor)

    @property
    def frame_width(self) -> int:
        """Columns per token frame: audio codebooks + 1 text column."""
        return self.audio_num_codebooks + 1

    def replace(self, **kw) -> "CSMConfig":
        return dataclasses.replace(self, **kw)


def csm_1b() -> CSMConfig:
    return CSMConfig()


def csm_test_tiny() -> CSMConfig:
    return CSMConfig(
        backbone_flavor="test-tiny",
        decoder_flavor="test-tiny-decoder",
        text_vocab_size=128,
        audio_vocab_size=67,
        audio_num_codebooks=8,
    )


@dataclass(frozen=True)
class SamplingConfig:
    """Top-k + temperature sampling knobs (CLI surface: 0.8 / 40)."""

    temperature: float = 0.8
    topk: int = 40


@dataclass(frozen=True)
class GenerationConfig:
    sampling: SamplingConfig = SamplingConfig()
    max_audio_length_ms: float = 90_000.0
    frame_ms: float = 80.0  # 12.5 Hz Mimi frame rate
    stream_chunk_frames: int = 1

    @property
    def max_frames(self) -> int:
        return int(self.max_audio_length_ms / self.frame_ms)
