"""Mimi's decoder (Kyutai's codec, as CSM-1B uses it) in plain PyTorch:
codes → 24 kHz PCM, offline, in float32.

From the published description: split RVQ (1 semantic + 31 acoustic
codebooks, each an embedding gather summed, then each half's output
projection; a code past the last bin reads the last bin, as CSM's 2,051
audio ids exceed Mimi's 2,048 bins), a ×2 channel-wise causal transposed
upsample, an 8-layer causal transformer (pre-LayerNorm, interleaved-pair
RoPE, a sliding window of ``context`` positions, LayerScale gains, exact
GELU), and the SEANet decoder (causal convolutions, ELU, transposed
convolutions by the ratios 8, 6, 5, 4, one residual unit a stage).
Causal convolutions pad ``kernel - stride`` zeros on the left; a causal
transposed convolution keeps its first ``T * stride`` samples.

Imports nothing of the program under test.  ``round_weights`` is how a
control computes it in a lower precision.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def seanet_specs(s: dict, decoder: bool) -> list:
    """SEANet's layers in order: ("conv", in, out, kernel, stride,
    dilation), ("convtr", in, out, kernel, stride), ("elu",), or ("res",
    [conv, conv]) for a residual unit."""
    nf, ratios = s["n_filters"], list(s["ratios"])

    def res(dim, dilation):
        hidden = dim // s["compress"]
        return ("res", [("conv", dim, hidden, s["residual_kernel_size"], 1, dilation),
                        ("conv", hidden, dim, 1, 1, 1)])

    specs = []
    if not decoder:
        mult = 1
        specs.append(("conv", s["channels"], nf, s["kernel_size"], 1, 1))
        for ratio in reversed(ratios):
            for j in range(s["n_residual_layers"]):
                specs.append(res(mult * nf, s["dilation_base"] ** j))
            specs.append(("elu",))
            specs.append(("conv", mult * nf, mult * nf * 2, ratio * 2, ratio, 1))
            mult *= 2
        specs.append(("elu",))
        specs.append(("conv", mult * nf, s["dimension"], s["last_kernel_size"], 1, 1))
        return specs
    mult = 2 ** len(ratios)
    specs.append(("conv", s["dimension"], mult * nf, s["kernel_size"], 1, 1))
    for ratio in ratios:
        specs.append(("elu",))
        specs.append(("convtr", mult * nf, mult * nf // 2, ratio * 2, ratio))
        for j in range(s["n_residual_layers"]):
            specs.append(res(mult * nf // 2, s["dilation_base"] ** j))
        mult //= 2
    specs.append(("elu",))
    specs.append(("conv", nf, s["channels"], s["last_kernel_size"], 1, 1))
    return specs


def _causal_conv(x, p, spec, w_of):
    _, _, _, k, stride, dilation = spec
    pad = (k - 1) * dilation + 1 - stride
    y = F.conv1d(F.pad(x, (pad, 0)), w_of(p["w"]), None, stride=stride, dilation=dilation)
    return y + p["b"].float()[None, :, None]


def _causal_convtr(x, p, spec, w_of):
    _, _, _, k, stride = spec
    y = F.conv_transpose1d(x, w_of(p["w"]), None, stride=stride)
    return y[:, :, : x.shape[-1] * stride] + p["b"].float()[None, :, None]


def _rope(x, positions, max_period):
    """Interleaved pairs (x[..., 2i], x[..., 2i+1]) rotated by position ×
    max_period^(-2i/hd); x (B, S, H, hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / (max_period ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                device=x.device) / hd))
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1).reshape(x.shape)


def _transformer(h, lw, t: dict, w_of):
    """h (B, T, D) f32 → (B, T, D): causal, window of ``context`` keys."""
    B, T, D = h.shape
    H = t["num_heads"]
    hd = D // H
    pos = torch.arange(T, device=h.device)
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < t["context"])
    for l in range(t["num_layers"]):
        hn = F.layer_norm(h, (D,), lw["norm1_w"][l].float(), lw["norm1_b"][l].float(),
                          t["norm_eps"])
        q, k, v = (hn @ w_of(lw["qkv"][l])).chunk(3, dim=-1)
        q = _rope(q.reshape(B, T, H, hd), pos, t["max_period"]).transpose(1, 2)
        k = _rope(k.reshape(B, T, H, hd), pos, t["max_period"]).transpose(1, 2)
        v = v.reshape(B, T, H, hd).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(B, T, D)
        h = h + lw["ls1"][l].float() * (attn @ w_of(lw["out"][l]))
        hn = F.layer_norm(h, (D,), lw["norm2_w"][l].float(), lw["norm2_b"][l].float(),
                          t["norm_eps"])
        ff = F.gelu(hn @ w_of(lw["lin1"][l]), approximate="none")
        h = h + lw["ls2"][l].float() * (ff @ w_of(lw["lin2"][l]))
    return h


def _rvq_decode(q: dict, codes: torch.Tensor, n_sem: int, w_of) -> torch.Tensor:
    """codes (K, F) → latent (1, D, F)."""
    out = 0
    for part, rows in (("semantic", codes[:n_sem]), ("acoustic", codes[n_sem:])):
        cb = q[part]["codebooks"]
        idx = rows.clamp(0, cb.shape[1] - 1)
        summed = sum(w_of(cb[n])[idx[n]] for n in range(idx.shape[0]))
        out = out + summed @ w_of(q[part]["output_proj"])
    return out.T[None]


def round_weights(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """A weight in ``dtype`` with one f32 scale per tensor (its largest
    magnitude at the type's largest finite value), back in f32: the
    control's lower precision."""
    top = torch.finfo(dtype).max

    def w_of(w):
        wf = w.float()
        scale = wf.abs().max().clamp_min(1e-30) / top
        return (wf / scale).to(dtype).float() * scale

    return w_of


def decode(params: dict, m: dict, codes: torch.Tensor,
           w_of: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """codes (K, F) int on the params' device → (F * hop,) f32 PCM.
    ``w_of`` maps each weight to the f32 tensor the arithmetic uses
    (default: its exact f32 value)."""
    w_of = w_of or (lambda w: w.float())
    latent = _rvq_decode(params["quantizer"], codes, m["rvq"]["n_q_semantic"], w_of)
    s = m["downsample_stride"]
    latent = F.conv_transpose1d(latent, w_of(params["upsample"]["w"]), None, stride=s,
                                groups=latent.shape[1])[:, :, : latent.shape[-1] * s]
    h = _transformer(latent.transpose(1, 2), params["decoder_transformer"]["layers"],
                     m["transformer"], w_of).transpose(1, 2)
    x = h
    for spec, p in zip(seanet_specs(m["seanet"], True), params["decoder"]):
        if spec[0] == "elu":
            x = F.elu(x)
        elif spec[0] == "conv":
            x = _causal_conv(x, p, spec, w_of)
        elif spec[0] == "convtr":
            x = _causal_convtr(x, p, spec, w_of)
        else:
            y = x
            for sub, sp in zip(spec[1], p):
                y = _causal_conv(F.elu(y), sp, sub, w_of)
            x = x + y
    return x[0, 0]
