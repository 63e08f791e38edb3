"""An LFM2-MoE-style trunk: gated short convolutions and q/k-normed GQA,
then dense or routed SwiGLU FFNs (``core/config.py::HybridConfig``).

The port's own: the JAX package has no such trunk.  Each layer is

    h = h + op(operator_norm(h));   h = h + ffn(ffn_norm(h))

where ``op`` is, by ``cfg.layer_types``:

- "conv", LFM2's gated short convolution: ``in_proj`` (D → 3D) gives B, C
  and x; the depthwise causal convolution of length ``conv_L_cache`` runs
  over B·x (no bias); its output times C goes through ``out_proj``;
- "full_attention": ``qkv``, RMSNorm over each q and k head
  (``q_norm``, ``k_norm``), RoPE in the half-split pairing (HF's
  ``rotate_half``) at θ ``rope.base`` unscaled, GQA through
  ``ops/attention.py::flash_attention``, ``o_proj``;

and ``ffn`` the dense SwiGLU (``w13``, ``w2``, as the Llama trunk's) in the
first ``num_dense_layers`` layers and the routed one
(``ops/moe.py::moe_ffn``: ``router``, ``expert_bias``, ``experts_w13``,
``experts_w2``) in the rest.  The final RMSNorm is LFM2's
``embedding_norm`` (``final_norm`` here).  Weights are stored (in, out),
as every trunk of the port; the conv taps (``conv``) are (D, L).

The state of a window's rows: the attention layers' KV cache
(``transformer.KVCache``, one entry an attention layer) and each conv
layer's last L-1 values of B·x before the window, (B, D, L-1) in the
model's dtype (``init_conv_state``), both written IN PLACE.  A
right-padded window (``valid_len``) leaves each row's conv state at its
last valid row; a row with ``valid_len`` 0 keeps its state.  RMSNorm,
RoPE, the convolution and the softmax run in f32 islands.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from sesameai_tts_tpu_torch.core.config import HybridConfig
from sesameai_tts_tpu_torch.models.transformer import (
    KVCache,
    _update_cache,
    rms_norm,
)
from sesameai_tts_tpu_torch.ops.attention import flash_attention
from sesameai_tts_tpu_torch.ops.moe import moe_ffn
from sesameai_tts_tpu_torch.ops.quant import qdot, qmlp


def init_attention_cache(cfg: HybridConfig, batch_size: int, dtype=None,
                         max_seq_len: Optional[int] = None, device="cpu") -> KVCache:
    """Zeros: one (B, KV, T, hd) pair an attention layer."""
    shape = (batch_size, cfg.num_kv_heads, max_seq_len or cfg.max_seq_len, cfg.head_dim)
    n = len(cfg.attention_layers)

    def zeros():
        return [torch.zeros(shape, dtype=dtype or cfg.dtype, device=device) for _ in range(n)]

    return KVCache(k=zeros(), v=zeros())


def init_conv_state(cfg: HybridConfig, batch_size: int, dtype=None,
                    device="cpu") -> List[torch.Tensor]:
    """Zeros: one (B, D, L-1) buffer a conv layer."""
    shape = (batch_size, cfg.embed_dim, cfg.conv_L_cache - 1)
    return [torch.zeros(shape, dtype=dtype or cfg.dtype, device=device) for _ in cfg.conv_layers]


def apply_rope_half(x: torch.Tensor, rope_cs: torch.Tensor) -> torch.Tensor:
    """Rotate the half-split pairs (x[..., i], x[..., i + hd/2]).

    x: (B, S, n, hd); rope_cs: (B, S, hd/2, 2) gathered at the positions."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = rope_cs[..., 0][:, :, None, :]
    sin = rope_cs[..., 1][:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def short_conv(wl: dict, x: torch.Tensor, state: torch.Tensor,
               valid_len: Optional[torch.Tensor]) -> torch.Tensor:
    """The gated short convolution over x (B, S, D) after the L-1 values of
    B·x in ``state`` (B, D, L-1) → (B, S, D); ``state`` ← the last L-1
    values of B·x up to each row's last valid row, in place."""
    Bn, S, D = x.shape
    L = wl["conv"].shape[-1]
    bcx = qdot(x, wl["in_proj"])
    b, c, xx = bcx[..., :D], bcx[..., D:2 * D], bcx[..., 2 * D:]
    bx = b * xx
    full = torch.cat([state.transpose(1, 2).to(bx.dtype), bx], dim=1)  # (B, L-1+S, D)
    taps = wl["conv"].float()
    fullf = full.float()
    conv = fullf[:, 0:S] * taps[:, 0]
    for i in range(1, L):
        conv = conv + fullf[:, i:i + S] * taps[:, i]
    end = torch.full((Bn,), S, dtype=torch.int64, device=x.device) if valid_len is None \
        else valid_len.to(torch.int64)
    idx = end[:, None] + torch.arange(L - 1, device=x.device)[None, :]  # (B, L-1)
    state.copy_(torch.gather(full, 1, idx[..., None].expand(Bn, L - 1, D)).transpose(1, 2))
    y = (c.float() * conv).to(x.dtype)
    return qdot(y, wl["out_proj"])


def hybrid_forward(
    params: dict,
    cfg: HybridConfig,
    x: torch.Tensor,  # (B, S, D) hidden states
    pos0: torch.Tensor,  # (B,) int — first position of this window
    cache: KVCache,  # the attention layers' (written in place)
    conv: List[torch.Tensor],  # the conv layers' states (written in place)
    rope_cs: torch.Tensor,  # (max_seq, hd/2, 2)
    valid_len: Optional[torch.Tensor] = None,  # (B,) real rows (right-padded prefill)
    moe_stats: Optional[torch.Tensor] = None,  # int32 [2]: ops/moe.py's counters
) -> torch.Tensor:
    """Run the trunk over the window [pos0, pos0+S) of every row (a
    prefill, an extend or an S=1 decode) → the final-normed hidden states
    (B, S, D); the cache and conv states are written in place."""
    B, S, D = x.shape
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]
    rope_win = rope_cs[positions]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    valid_end = pos0 + (valid_len if valid_len is not None else S)
    attn_i = conv_i = 0
    h = x
    for i, (kind, wl) in enumerate(zip(cfg.layer_types, params["layers"])):
        hn = rms_norm(h, wl["operator_norm"], cfg.norm_eps)
        if kind == "conv":
            out = short_conv(wl, hn, conv[conv_i], valid_len)
            conv_i += 1
        else:
            qkv = qdot(hn, wl["qkv"])
            q = rms_norm(qkv[..., :H * hd].reshape(B, S, H, hd), wl["q_norm"], cfg.norm_eps)
            k = rms_norm(qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd), wl["k_norm"],
                         cfg.norm_eps)
            v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd).transpose(1, 2)
            q = apply_rope_half(q, rope_win).transpose(1, 2)
            k = apply_rope_half(k, rope_win).transpose(1, 2)
            lk, lv = cache.k[attn_i], cache.v[attn_i]
            attn_i += 1
            _update_cache(lk, k, positions)
            _update_cache(lv, v, positions)
            attn = flash_attention(q, lk, lv, pos0, valid_end)
            out = qdot(attn.transpose(1, 2).reshape(B, S, H * hd), wl["o_proj"])
        h = h + out
        hn = rms_norm(h, wl["ffn_norm"], cfg.norm_eps)
        if i < cfg.num_dense_layers:
            h = h + qmlp(hn, wl["w13"], wl["w2"])
        else:
            h = h + moe_ffn(hn, wl, cfg, moe_stats)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def init_hybrid_params(cfg: HybridConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random per-layer params, drawn on the generator's device: linear
    weights scaled by 1/sqrt(fan in), norms and conv taps drawn near 1 and
    near 1/L (so a norm left out shows), a nonzero expert bias."""
    dtype = dtype or cfg.dtype
    D, Fd, Fe, E = cfg.embed_dim, cfg.intermediate_dim, cfg.moe_intermediate_dim, cfg.num_experts
    H, KV, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.conv_L_cache
    dev = generator.device

    def randn(shape, scale, mean=0.0):
        return (mean + scale * torch.randn(shape, generator=generator, device=dev)).to(dtype)

    def w(shape, fan_in):
        return randn(shape, 1.0 / math.sqrt(fan_in))

    layers = []
    for i, kind in enumerate(cfg.layer_types):
        wl = {"operator_norm": randn((D,), 0.1, 1.0), "ffn_norm": randn((D,), 0.1, 1.0)}
        if kind == "conv":
            wl.update(in_proj=w((D, 3 * D), D), conv=randn((D, L), 0.3, 1.0 / L),
                      out_proj=w((D, D), D))
        else:
            wl.update(qkv=w((D, (H + 2 * KV) * hd), D), q_norm=randn((hd,), 0.1, 1.0),
                      k_norm=randn((hd,), 0.1, 1.0), o_proj=w((H * hd, D), H * hd))
        if i < cfg.num_dense_layers:
            wl.update(w13=w((D, 2 * Fd), D), w2=w((Fd, D), Fd))
        else:
            wl.update(router=w((D, E), D), expert_bias=randn((E,), 0.1),
                      experts_w13=w((E, D, 2 * Fe), D), experts_w2=w((E, Fe, D), Fe))
        layers.append(wl)
    return {"layers": tuple(layers), "final_norm": randn((D,), 0.1, 1.0)}
