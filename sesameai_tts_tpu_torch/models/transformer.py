"""Llama-3.2-style transformer trunk (port of
``sesameai_tts_tpu/models/transformer.py``).

GQA attention with llama3-scaled RoPE in the interleaved (meta) pairing,
RMSNorm, SwiGLU MLP and a static KV cache, embeddings in / hidden states
out.  Weights are stored ``(in, out)`` with fused ``qkv`` and ``w13``;
the trunk is per-layer: ``{"layers": (L × {name: tensor}), "final_norm"}``.
RMSNorm, RoPE and the attention softmax run in f32 islands.  Every
attention goes to ``ops/attention.py::flash_attention``: the CUDA kernel
for tensors on the card, its plain version on the CPU.

The KV cache is ``KVCache(k, v)`` of L per-layer ``(B, KV, T, hd)``
buffers, written IN PLACE by ``transformer_forward``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from sesameai_tts_tpu_torch.core.config import RoPEConfig, TransformerConfig
from sesameai_tts_tpu_torch.ops.attention import flash_attention
from sesameai_tts_tpu_torch.ops.quant import qdot, qmlp


def _scaled_rope_freqs(cfg: RoPEConfig, head_dim: int) -> torch.Tensor:
    """Per-pair inverse frequencies with Meta's llama3 long-context scaling."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / (cfg.base ** exponents)  # (head_dim/2,)
    if cfg.scale_factor and cfg.scale_factor > 1:
        low_freq_wavelen = cfg.old_context_len / cfg.low_freq_factor
        high_freq_wavelen = cfg.old_context_len / cfg.high_freq_factor
        wavelen = 2.0 * math.pi / freqs
        smooth = (cfg.old_context_len / wavelen - cfg.low_freq_factor) / (
            cfg.high_freq_factor - cfg.low_freq_factor
        )
        blended = (1.0 - smooth) * freqs / cfg.scale_factor + smooth * freqs
        freqs = torch.where(
            wavelen > low_freq_wavelen,
            freqs / cfg.scale_factor,
            torch.where(wavelen < high_freq_wavelen, freqs, blended),
        )
    return freqs


def precompute_rope(cfg: TransformerConfig, max_len: Optional[int] = None,
                    device="cpu") -> torch.Tensor:
    """(max_len or max_seq_len, head_dim/2, 2) [cos, sin] f32 table."""
    freqs = _scaled_rope_freqs(cfg.rope, cfg.head_dim)
    t = torch.arange(max_len or cfg.max_seq_len, dtype=torch.float32)
    angles = t[:, None] * freqs[None, :]
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1).to(device)


def apply_rope(x: torch.Tensor, rope_cs: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 2i], x[..., 2i+1]).

    x: (B, S, n, head_dim); rope_cs: (B, S, head_dim/2, 2) gathered at the
    token positions."""
    xf = x.float()
    xe = xf[..., 0::2]
    xo = xf[..., 1::2]
    cos = rope_cs[..., 0][:, :, None, :]
    sin = rope_cs[..., 1][:, :, None, :]
    re = xe * cos - xo * sin
    ro = xe * sin + xo * cos
    return torch.stack([re, ro], dim=-1).reshape(x.shape).to(x.dtype)


class KVCache(NamedTuple):
    """L per-layer (B, n_kv, max_seq, head_dim) buffers, updated in place."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]


def init_kv_cache(cfg: TransformerConfig, batch_size: int, dtype=None,
                  max_seq_len: Optional[int] = None, device="cpu") -> KVCache:
    dtype = dtype or cfg.dtype
    shape = (batch_size, cfg.num_kv_heads, max_seq_len or cfg.max_seq_len, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
    )


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 island, cast back to x.dtype, then times the scale."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale


def _update_cache(cache_k: torch.Tensor, new_k: torch.Tensor,
                  positions: torch.Tensor) -> None:
    """Write (B, KV, S, hd) into (B, KV, T, hd) at per-row positions (B, S),
    in place.  An out-of-range position raises (it never clamps)."""
    b = torch.arange(cache_k.shape[0], device=cache_k.device)[:, None]
    cache_k[b, :, positions] = new_k.transpose(1, 2).to(cache_k.dtype)


def transformer_forward(
    params: dict,
    cfg: TransformerConfig,
    x: torch.Tensor,  # (B, S, D) hidden states
    pos0: torch.Tensor,  # (B,) int — first position of this window
    cache: KVCache,  # written in place
    rope_cs: torch.Tensor,  # (max_seq, hd/2, 2)
    valid_len: Optional[torch.Tensor] = None,  # (B,) real rows (right-padded prefill)
    fused_mlp: bool = False,  # int8 MLPs through the fused quant_mlp kernel
) -> Tuple[torch.Tensor, KVCache]:
    """Run the trunk over the window [pos0, pos0+S) of every row: prefill,
    S=1 decode, or a right-padded batch with ``valid_len``."""
    B, S, D = x.shape
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]  # (B, S)
    rope_win = rope_cs[positions]  # (B, S, hd/2, 2)
    # keys at or past valid_end are masked: a right-padded prefill's padded
    # rows never become attendable; without valid_len this is the causal mask
    valid_end = pos0 + (valid_len if valid_len is not None else S)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = x
    for wl, lk, lv in zip(params["layers"], cache.k, cache.v):
        hn = rms_norm(h, wl["attn_norm"], cfg.norm_eps)
        qkv = qdot(hn, wl["qkv"])
        q = qkv[..., : H * hd].reshape(B, S, H, hd)
        k = qkv[..., H * hd : (H + KV) * hd].reshape(B, S, KV, hd)
        v = qkv[..., (H + KV) * hd :].reshape(B, S, KV, hd)
        q = apply_rope(q, rope_win).transpose(1, 2)  # (B, H, S, hd)
        k = apply_rope(k, rope_win).transpose(1, 2)
        v = v.transpose(1, 2)
        _update_cache(lk, k, positions)
        _update_cache(lv, v, positions)
        attn = flash_attention(q, lk, lv, pos0, valid_end)
        h = h + qdot(attn.transpose(1, 2).reshape(B, S, H * hd), wl["o_proj"])
        hn = rms_norm(h, wl["mlp_norm"], cfg.norm_eps)
        h = h + qmlp(hn, wl["w13"], wl["w2"], fused=fused_mlp)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), cache


def init_transformer_params(cfg: TransformerConfig, generator: torch.Generator,
                            dtype=None) -> dict:
    """Random per-layer params, drawn on the generator's device."""
    dtype = dtype or cfg.dtype
    D, F = cfg.embed_dim, cfg.intermediate_dim
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)).to(dtype)

    layers = tuple(
        {
            "attn_norm": torch.ones(D, dtype=dtype, device=dev),
            "qkv": w((D, (H + 2 * KV) * hd), D),
            "o_proj": w((H * hd, D), H * hd),
            "mlp_norm": torch.ones(D, dtype=dtype, device=dev),
            "w13": w((D, 2 * F), D),
            "w2": w((F, D), F),
        }
        for _ in range(cfg.num_layers)
    )
    return {"layers": layers, "final_norm": torch.ones(D, dtype=dtype, device=dev)}
