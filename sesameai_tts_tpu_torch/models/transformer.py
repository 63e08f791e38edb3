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
buffers, written IN PLACE by ``transformer_forward``.  Without a cache
(``cache=None``, training) each layer attends over its window's own keys
and values, and ``remat=True`` recomputes each layer's activations in the
backward pass.

With a tensor-parallel group (``tp=``, ``parallel/``) each rank holds its
shards of the layer's weights (``parallel/mesh.py`` gives the layout): its
q heads and the kv heads they read, its slice of the MLP, and the matching
rows of ``o_proj`` and ``w2``.  The layer then runs on the local heads and
sums the attention output's and the MLP's partial products with one
``all_reduce`` each (``parallel/autograd.py``'s g); the gradient of the
normed input that enters ``qkv`` and ``w13`` is summed over the group in
the backward pass (f).  Without a group the ops are the single-card ones.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from sesameai_tts_tpu_torch.core.config import RoPEConfig, TransformerConfig
from sesameai_tts_tpu_torch.ops.attention import flash_attention
from sesameai_tts_tpu_torch.ops.quant import qdot, qmlp
from sesameai_tts_tpu_torch.parallel.autograd import copy_to_tp, reduce_from_tp
from sesameai_tts_tpu_torch.parallel.mesh import local_heads, trunk_group


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
                  max_seq_len: Optional[int] = None, device="cpu",
                  num_kv_heads: Optional[int] = None) -> KVCache:
    """Zeros; ``num_kv_heads`` is a tensor-parallel rank's local count."""
    dtype = dtype or cfg.dtype
    shape = (batch_size, num_kv_heads or cfg.num_kv_heads, max_seq_len or cfg.max_seq_len,
             cfg.head_dim)
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
    cache: Optional[KVCache],  # written in place; None = cache-free (training)
    rope_cs: torch.Tensor,  # (max_seq, hd/2, 2)
    valid_len: Optional[torch.Tensor] = None,  # (B,) real rows (right-padded prefill)
    fused_mlp: bool = False,  # int8 MLPs through the fused quant_mlp kernel
    remat: bool = False,  # cache-free only: recompute each layer in the backward pass
    tp: Optional[dist.ProcessGroup] = None,  # tensor-parallel group of sharded params
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the trunk over the window [pos0, pos0+S) of every row: prefill,
    S=1 decode, or a right-padded batch with ``valid_len``.

    With ``cache=None`` (training) the keys and values are the window's own
    and the mask is the JAX package's ``tril & (key < valid_len)`` over the
    window (attention at ``pos0 = 0``, RoPE at the real positions); the
    result is ``(h, None)``.  ``remat`` wraps each layer in a non-reentrant
    ``torch.utils.checkpoint``, as ``jax.checkpoint`` per layer; under ``tp`` the recomputed
    forward issues its all_reduces again inside the backward pass, in the
    same order on every rank.  With ``tp`` the params and cache are this
    rank's shards (module docstring); a replicated (int4) trunk runs whole
    on every rank."""
    B, S, D = x.shape
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]  # (B, S)
    rope_win = rope_cs[positions]  # (B, S, hd/2, 2)
    tp = trunk_group(params, tp)
    H, KV = local_heads(cfg, tp)
    hd = cfg.head_dim
    if cache is None:
        attn_pos0 = torch.zeros_like(pos0)
        valid_end = valid_len if valid_len is not None else torch.full_like(pos0, S)
    else:
        attn_pos0 = pos0
        # keys at or past valid_end are masked: a right-padded prefill's padded
        # rows never become attendable; without valid_len this is the causal mask
        valid_end = pos0 + (valid_len if valid_len is not None else S)

    def layer(h, wl, lk=None, lv=None):
        hn = copy_to_tp(rms_norm(h, wl["attn_norm"], cfg.norm_eps), tp)
        qkv = qdot(hn, wl["qkv"])
        q = qkv[..., : H * hd].reshape(B, S, H, hd)
        k = qkv[..., H * hd : (H + KV) * hd].reshape(B, S, KV, hd)
        v = qkv[..., (H + KV) * hd :].reshape(B, S, KV, hd)
        q = apply_rope(q, rope_win).transpose(1, 2)  # (B, H, S, hd)
        k = apply_rope(k, rope_win).transpose(1, 2)
        v = v.transpose(1, 2)
        if lk is None:  # the kernel reads k and v as contiguous (B, KV, S, hd)
            lk, lv = k.contiguous(), v.contiguous()
        else:
            _update_cache(lk, k, positions)
            _update_cache(lv, v, positions)
        attn = flash_attention(q, lk, lv, attn_pos0, valid_end)
        out = qdot(attn.transpose(1, 2).reshape(B, S, H * hd), wl["o_proj"])
        h = h + reduce_from_tp(out, tp)
        hn = copy_to_tp(rms_norm(h, wl["mlp_norm"], cfg.norm_eps), tp)
        return h + reduce_from_tp(qmlp(hn, wl["w13"], wl["w2"], fused=fused_mlp), tp)

    h = x
    if cache is None:
        for wl in params["layers"]:
            if remat:
                h = torch.utils.checkpoint.checkpoint(layer, h, wl, use_reentrant=False)
            else:
                h = layer(h, wl)
    else:
        for wl, lk, lv in zip(params["layers"], cache.k, cache.v):
            h = layer(h, wl, lk, lv)
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
