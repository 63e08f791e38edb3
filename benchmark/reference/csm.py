"""Sesame's CSM-1B in plain PyTorch, float32: what a served frame's
logits should be, given the prompt rows and the frames served before it.

From the published model: a Llama-3.2-style backbone (RMSNorm, GQA
attention with Llama-3 scaled RoPE on interleaved pairs, SwiGLU) over
frame rows, each row the masked sum of 32 audio-codebook embeddings and
one text embedding; codebook 0's logits from the backbone's last hidden
state; codebooks 1-31 from a small Llama-style decoder over 32 positions
(the projected backbone state, then the projected embeddings of the
frame's codebooks 0-30), one head per codebook.  A frame of all zeros
ends an utterance.

The trunks' linear weights are quantized here from the bf16 weights the
benchmark drew, weight-only and as the configuration states: int8 with
one scale per output column (|w|max / 127), int4 with one scale per
column and group of input rows (|w|max / 7), values rounded half to even
and clipped.  ``bits`` picks another width for a control (3 bits:
|w|max / 3, clipped to [-4, 3]).  Imports nothing of the program under
test.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

TRUNK_LINEARS = ("qkv", "o_proj", "w13", "w2")


def dequantized(w: torch.Tensor, bits: Optional[int], groups: int = 1) -> torch.Tensor:
    """(in, out) weight → its f32 value after weight-only quantization at
    ``bits`` (None: the exact f32 value), ``groups`` scale groups over the
    input rows."""
    wf = w.float()
    if bits is None:
        return wf
    top = 2 ** (bits - 1) - 1  # 127, 7, 3
    D, Fo = wf.shape
    g = wf.reshape(groups, D // groups, Fo)
    scale = torch.clamp_min(g.abs().amax(dim=1) / top, 1e-8)
    q = torch.clamp(torch.round(g / scale[:, None, :]), -top - 1, top)
    if bits == 8:
        q = q.clamp_min(-top)  # int8 is symmetric: [-127, 127]
    return (q * scale[:, None, :]).reshape(D, Fo)


def _rope_freqs(hd: int, rope: dict, device) -> torch.Tensor:
    """Llama-3's scaled inverse frequencies (its long-context rescaling)."""
    freqs = 1.0 / (rope["base"] ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    if rope["scale_factor"] and rope["scale_factor"] > 1:
        old = rope["old_context_len"]
        wavelen = 2.0 * math.pi / freqs
        smooth = (old / wavelen - rope["low_freq_factor"]) / (
            rope["high_freq_factor"] - rope["low_freq_factor"])
        blended = (1.0 - smooth) * freqs / rope["scale_factor"] + smooth * freqs
        freqs = torch.where(wavelen > old / rope["low_freq_factor"], freqs / rope["scale_factor"],
                            torch.where(wavelen < old / rope["high_freq_factor"], freqs, blended))
    return freqs.to(device)


def _rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1, interleaved pairs."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1).reshape(x.shape)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


class Trunk:
    """One trunk's layers, dequantized once to f32."""

    def __init__(self, params: dict, t: dict, bits: Optional[int], groups: int):
        self.t = t
        self.layers = [{k: (dequantized(v, bits, groups) if k in TRUNK_LINEARS else v.float())
                        for k, v in wl.items()} for wl in params["layers"]]
        self.final_norm = params["final_norm"].float()
        self.freqs = _rope_freqs(t["embed_dim"] // t["num_heads"], t["rope"],
                                 self.final_norm.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) at positions 0..S-1 → causal hidden states (B, S, D)."""
        t = self.t
        B, S, D = x.shape
        H, KV = t["num_heads"], t["num_kv_heads"]
        hd = D // H
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        h = x
        for wl in self.layers:
            hn = _rms(h, wl["attn_norm"], t["norm_eps"])
            qkv = hn @ wl["qkv"]
            q = _rope(qkv[..., :H * hd].reshape(B, S, H, hd), self.freqs).transpose(1, 2)
            k = _rope(qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd),
                      self.freqs).transpose(1, 2)
            v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd).transpose(1, 2)
            k = k.repeat_interleave(H // KV, dim=1)  # query head h reads kv head h // (H/KV)
            v = v.repeat_interleave(H // KV, dim=1)
            logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
            probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
            attn = (probs @ v).transpose(1, 2).reshape(B, S, H * hd)
            h = h + attn @ wl["o_proj"]
            hn = _rms(h, wl["mlp_norm"], t["norm_eps"])
            a = hn @ wl["w13"]
            Fi = a.shape[-1] // 2
            h = h + (F.silu(a[..., :Fi]) * a[..., Fi:]) @ wl["w2"]
        return _rms(h, self.final_norm, t["norm_eps"])


class CSM:
    """The reference model of one configuration at ``bits`` (None: the
    configuration's own quantization)."""

    def __init__(self, params: dict, config: dict, bits: Optional[int] = None):
        q = config.get("quantize")
        own = {None: None, "int8": 8, "int4": 4}[q]
        bits = own if bits is None else bits
        groups = config.get("int4_scale_groups", 2) if bits is not None and bits < 8 else 1
        self.config = config
        self.backbone = Trunk(params["backbone"], config["backbone"], bits, groups)
        self.decoder = Trunk(params["decoder"], config["decoder"], bits, groups)
        self.text_emb = params["text_embeddings"]
        self.audio_emb = params["audio_embeddings"]
        self.projection = params["projection"].float()
        self.head0 = params["codebook0_head"].float()
        self.heads = params["audio_head"].float()

    def embed(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(S, K+1) rows → (S, D): the masked sum of the row's embeddings."""
        K = self.config["audio_num_codebooks"]
        V = self.config["audio_vocab_size"]
        audio = self.audio_emb[tokens[:, :K] + torch.arange(K, device=tokens.device) * V].float()
        text = self.text_emb[tokens[:, K]].float()[:, None, :]
        emb = torch.cat([audio, text], dim=1)
        return (emb * mask[..., None]).sum(dim=1)

    def frame_logits(self, prompt: Tuple[torch.Tensor, torch.Tensor],
                     frames: torch.Tensor) -> torch.Tensor:
        """Prompt rows (tokens, mask), each (P, K+1), and the F frames
        served after it (F, K) → each served token's logits (F, K, V) f32,
        every frame conditioned on the frames served before it."""
        K = self.config["audio_num_codebooks"]
        V = self.config["audio_vocab_size"]
        tokens, mask = prompt
        Fn = frames.shape[0]
        fed = frames[:-1]  # frame j is predicted from the row after frame j-1
        rows = torch.zeros((fed.shape[0], K + 1), dtype=tokens.dtype, device=tokens.device)
        rows[:, :K] = fed
        rmask = torch.zeros_like(rows, dtype=torch.bool)
        rmask[:, :K] = True
        x = self.embed(torch.cat([tokens, rows]), torch.cat([mask, rmask]))
        h = self.backbone(x[None])[0, tokens.shape[0] - 1:]  # (F, D)
        out = torch.empty((Fn, K, V), dtype=torch.float32, device=h.device)
        out[:, 0] = h @ self.head0
        # the decoder: position 0 the projected hidden state, position i the
        # projected embedding of codebook i-1 of the same frame
        emb = self.audio_emb[frames[:, :K - 1]
                             + torch.arange(K - 1, device=frames.device) * V].float()
        xd = torch.cat([h[:, None, :], emb], dim=1) @ self.projection  # (F, K, Dd)
        hd = self.decoder(xd)
        out[:, 1:] = torch.einsum("fid,idv->fiv", hd[:, 1:], self.heads)
        return out
