"""Typed configuration tree (port of ``sesameai_tts_tpu/core/config.py``).

Every field and flavor of the Llama trunks matches the JAX package; only
``dtype`` is a torch dtype here.  ``HybridConfig`` is the port's own: a
backbone of LFM2's kind (gated short convolutions beside q/k-normed GQA,
dense then routed SwiGLU FFNs), which the JAX package does not have.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

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

    kind = "llama"  # the trunk's family (models/csm.py dispatches on it)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class HybridConfig:
    """An LFM2-MoE-style trunk (``models/hybrid.py``): ``layer_types`` names
    each layer's operator, "conv" (a gated short convolution over the last
    ``conv_L_cache`` rows) or "full_attention" (GQA with RMSNorm over each
    q and k head before RoPE in the half-split pairing); every layer then
    has a SwiGLU FFN, dense (``intermediate_dim``) in the first
    ``num_dense_layers`` and routed in the rest: ``num_experts`` experts of
    ``moe_intermediate_dim``, ``num_experts_per_tok`` a row chosen by
    σ(x·W_gate) (plus the expert bias when ``use_expert_bias``, for the
    choice only), their σ scores normalized to sum 1 when
    ``norm_topk_prob`` and scaled by ``routed_scaling_factor``."""

    num_layers: int
    num_heads: int
    num_kv_heads: int
    embed_dim: int
    max_seq_len: int
    intermediate_dim: int
    layer_types: Tuple[str, ...]
    num_dense_layers: int
    num_experts: int
    num_experts_per_tok: int
    moe_intermediate_dim: int
    conv_L_cache: int = 3
    use_expert_bias: bool = True
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    norm_eps: float = 1e-5
    rope: RoPEConfig = RoPEConfig(base=1_000_000.0, scale_factor=1)
    dtype: torch.dtype = torch.bfloat16

    kind = "hybrid"

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers or not set(self.layer_types) <= {
                "conv", "full_attention"}:
            raise ValueError(f"layer_types must name 'conv' or 'full_attention' for each of "
                             f"{self.num_layers} layers; got {self.layer_types}")
        if not 0 <= self.num_dense_layers <= self.num_layers:
            raise ValueError(f"num_dense_layers={self.num_dense_layers} outside "
                             f"[0, {self.num_layers}]")
        if not 1 <= self.num_experts_per_tok <= self.num_experts:
            raise ValueError(f"num_experts_per_tok={self.num_experts_per_tok} outside "
                             f"[1, num_experts={self.num_experts}]")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "full_attention")

    @property
    def conv_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "conv")


TrunkConfig = Union[TransformerConfig, HybridConfig]

FLAVORS: Dict[str, Callable[[], TrunkConfig]] = {}


def register_flavor(name: str, fn: Callable[[], TrunkConfig]) -> None:
    FLAVORS[name] = fn


def get_flavor(name: str) -> TrunkConfig:
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


def lfm2_8b_a1b() -> HybridConfig:
    """LiquidAI's LFM2-8B-A1B trunk (its config.json, ``model_type``
    ``lfm2_moe``) as a CSM backbone: 18 conv and 6 attention layers, 2 dense
    FFNs, then 22 of 32 experts with 4 a row."""
    c, a = "conv", "full_attention"
    return HybridConfig(
        num_layers=24,
        num_heads=32,
        num_kv_heads=8,
        embed_dim=2048,
        max_seq_len=2048,
        intermediate_dim=7168,
        layer_types=(c, c, a, c, c, c, a, c, c, c, a, c, c, c, a, c, c, c, a, c, c, a, c, c),
        num_dense_layers=2,
        num_experts=32,
        num_experts_per_tok=4,
        moe_intermediate_dim=1792,
    )


def test_tiny_hybrid() -> HybridConfig:
    """CPU-testable hybrid backbone: conv, conv, attention, conv; one dense
    FFN, then 3 routed ones of 8 experts, 2 a row."""
    c, a = "conv", "full_attention"
    return HybridConfig(
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        embed_dim=64,
        max_seq_len=256,
        intermediate_dim=96,
        layer_types=(c, c, a, c),
        num_dense_layers=1,
        num_experts=8,
        num_experts_per_tok=2,
        moe_intermediate_dim=32,
        dtype=torch.float32,
    )


register_flavor("llama-1B", llama3_2_1B)
register_flavor("llama-100M", llama3_2_100M)
register_flavor("test-tiny", test_tiny)
register_flavor("test-tiny-decoder", test_tiny_decoder)
register_flavor("lfm2-8B-A1B", lfm2_8b_a1b)
register_flavor("test-tiny-hybrid", test_tiny_hybrid)


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
    def backbone(self) -> TrunkConfig:
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


def csm_lfm2_8b_a1b() -> CSMConfig:
    """LFM2-8B-A1B's trunk as the backbone under CSM-1B's decoder, heads and
    Mimi (the pairing is this repository's; LFM2's 65,536-token vocabulary
    for the text rows)."""
    return CSMConfig(backbone_flavor="lfm2-8B-A1B", text_vocab_size=65_536)


def csm_test_tiny_hybrid() -> CSMConfig:
    return csm_test_tiny().replace(backbone_flavor="test-tiny-hybrid")


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
