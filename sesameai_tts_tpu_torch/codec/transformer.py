"""Mimi's latent-domain transformer (port of
``sesameai_tts_tpu/codec/transformer.py``).

Pre-LayerNorm causal layers with interleaved-pair RoPE, exact-erf GELU
FFN, LayerScale residual gains and a sliding attention window of
``context`` positions.  Offline the window is a banded mask; streaming
keeps a ring-buffer KV cache (slot = pos mod capacity) that
``codec_transformer_forward`` writes IN PLACE.  Parameters stay stacked
on a leading layer axis, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CodecTransformerConfig:
    num_layers: int = 8
    d_model: int = 512
    num_heads: int = 8
    dim_feedforward: int = 2048
    context: int = 250
    max_period: float = 10_000.0
    layer_scale: float = 0.01
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def precompute_codec_rope(cfg: CodecTransformerConfig, max_len: int) -> torch.Tensor:
    hd = cfg.head_dim
    exponents = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    freqs = 1.0 / (cfg.max_period ** exponents)
    t = torch.arange(max_len, dtype=torch.float32)
    angles = t[:, None] * freqs[None, :]
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)


def apply_rope(x: torch.Tensor, rope_cs: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs; x (B, S, n, hd), rope_cs (B, S, hd/2, 2)."""
    xf = x.float()
    xe = xf[..., 0::2]
    xo = xf[..., 1::2]
    cos = rope_cs[..., 0][:, :, None, :]
    sin = rope_cs[..., 1][:, :, None, :]
    out = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def init_codec_transformer(generator: torch.Generator, cfg: CodecTransformerConfig,
                           dtype=torch.float32) -> dict:
    L, D, Fd = cfg.num_layers, cfg.d_model, cfg.dim_feedforward
    dev = generator.device

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev) * fan_in ** -0.5).to(dtype)

    def full(value):
        return torch.full((L, D), value, dtype=dtype, device=dev)

    return {
        "layers": {
            "norm1_w": full(1.0),
            "norm1_b": full(0.0),
            "qkv": w((L, D, 3 * D), D),  # packed qkv, stored (in, out)
            "out": w((L, D, D), D),
            "norm2_w": full(1.0),
            "norm2_b": full(0.0),
            "lin1": w((L, D, Fd), D),
            "lin2": w((L, Fd, D), Fd),
            "ls1": full(cfg.layer_scale),
            "ls2": full(cfg.layer_scale),
        }
    }


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


class CodecKVCache(NamedTuple):
    """Ring-buffer cache (L, B, H, capacity, hd) + stored absolute positions
    (L, B, capacity), -1 = empty.  Capacity exceeds context + chunk - 1."""

    k: torch.Tensor
    v: torch.Tensor
    key_pos: torch.Tensor


def init_codec_cache(cfg: CodecTransformerConfig, batch: int, dtype=torch.float32,
                     max_chunk: int = 128, device="cpu") -> CodecKVCache:
    cap = cfg.context + max_chunk
    shape = (cfg.num_layers, batch, cfg.num_heads, cap, cfg.head_dim)
    return CodecKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        key_pos=torch.full((cfg.num_layers, batch, cap), -1, dtype=torch.int64, device=device),
    )


def codec_transformer_forward(
    params: dict,
    cfg: CodecTransformerConfig,
    x: torch.Tensor,  # (B, S, D)
    pos0: torch.Tensor,  # (B,)
    rope_cs: torch.Tensor,  # (max_len, hd/2, 2)
    cache: Optional[CodecKVCache] = None,  # written in place
) -> Tuple[torch.Tensor, Optional[CodecKVCache]]:
    B, S, D = x.shape
    H, hd, C = cfg.num_heads, cfg.head_dim, cfg.context
    if cache is not None:
        cap = cache.k.shape[-2]
        if S > cap - C:
            # a larger chunk would clobber keys still inside earlier
            # queries' sliding windows
            raise ValueError(
                f"streaming chunk of {S} positions exceeds the ring slack ({cap - C})"
            )
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]  # (B, S)
    rope_win = rope_cs[positions]
    b_idx = torch.arange(B, device=x.device)[:, None]
    lw = params["layers"]

    h = x
    for l in range(cfg.num_layers):
        hn = _layer_norm(h, lw["norm1_w"][l], lw["norm1_b"][l], cfg.norm_eps)
        q, k, v = (hn @ lw["qkv"][l]).chunk(3, dim=-1)
        q = apply_rope(q.reshape(B, S, H, hd), rope_win).transpose(1, 2)
        k = apply_rope(k.reshape(B, S, H, hd), rope_win).transpose(1, 2)
        v = v.reshape(B, S, H, hd).transpose(1, 2)
        if cache is not None:
            lk, lv, lkp = cache.k[l], cache.v[l], cache.key_pos[l]
            slots = positions % lk.shape[-2]  # (B, S)
            lk[b_idx, :, slots] = k.transpose(1, 2)
            lv[b_idx, :, slots] = v.transpose(1, 2)
            lkp[b_idx, slots] = positions
            # key present, causal, inside the sliding window
            diff = positions[:, :, None] - lkp[:, None, :]
            mask = (lkp[:, None, :] >= 0) & (diff >= 0) & (diff < C)
            keys, values = lk, lv
        else:
            diff = positions[:, :, None] - positions[:, None, :]
            mask = (diff >= 0) & (diff < C)
            keys, values = k, v
        # f32 logits: operands upcast first (exact), f32 accumulation
        logits = torch.einsum("bhsd,bhtd->bhst", q.float(), keys.float())
        logits = logits / math.sqrt(hd)
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = torch.einsum("bhst,bhtd->bhsd", probs, values)
        attn = attn.transpose(1, 2).reshape(B, S, D)
        h = h + lw["ls1"][l] * (attn @ lw["out"][l])
        hn = _layer_norm(h, lw["norm2_w"][l], lw["norm2_b"][l], cfg.norm_eps)
        # exact (erf) GELU, as the reference transformer
        ff = F.gelu((hn @ lw["lin1"][l]).float(), approximate="none").to(h.dtype)
        h = h + lw["ls2"][l] * (ff @ lw["lin2"][l])
    return h, cache
