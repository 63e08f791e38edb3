"""CSM with LFM2-8B-A1B's trunk as its backbone, in plain PyTorch, float32:
what a served frame's logits should be, given the prompt rows and the
frames served before it.

The backbone is LFM2-MoE as its configuration states (``configs/
csm-lfm2-8b-a1b-int8.json``, top-level keys as in the published
config.json) and as ``transformers``' ``modeling_lfm2`` and LFM2-MoE's
router describe it; every layer is

    h = h + op(operator_norm(h));   h = h + ffn(ffn_norm(h))

- a "conv" layer: ``in_proj`` → B, C, x; ``F.conv1d`` of B·x over the whole
  sequence, depthwise, causal, ``conv_L_cache`` taps, no bias; C times
  that; ``out_proj``;
- a "full_attention" layer: q, k, v; RMSNorm over each q and k head; RoPE
  in the half-split pairing (HF's ``rotate_half``) at θ ``rope_theta``;
  causal GQA over every row; the output projection;
- the FFN: SwiGLU of width ``intermediate_size`` in the first
  ``num_dense_layers`` layers; in the rest its own f32 routing, σ(x·W_gate),
  the expert bias added only to choose the top ``num_experts_per_tok``, the
  chosen σ scores divided by their sum + 1e-6 and times
  ``routed_scaling_factor``, then a loop over the experts, each over the
  rows routed to it;
- the final RMSNorm (LFM2's ``embedding_norm``).

CSM's frame rows, codebook-0 head, decoder and heads are CSM-1B's, shared
with ``reference/csm.py``.  The weights are the tree the benchmark drew
(the program's layout: (in, out) linears, fused ``qkv`` and ``w13``, the
experts stacked (E, in, out)).  Quantized here, as the configuration
states: every linear of the trunks int8 with one scale a column (of each
expert), |w|max / 127, rounded half to even; the conv taps, norms, router
and expert bias stay as drawn.  The int8 values are kept and each layer is
dequantized to f32 when it runs, so the reference fits beside a live pool.
``bits`` picks another width for a control (4: one scale a column and
half of the input rows, |w|max / 7).

Departures from the published description, each this benchmark's: the
LM head (tied to the embeddings) is not used, CSM's heads take its place;
the text embeddings are CSM's (65,536 rows: the vocabulary is LFM2's); the
pairing with CSM's decoder is this repository's.  Three options exist only
for the calibration of the comparison: ``conv_reset`` zeroes every conv
layer's past at each row after the prompt (a decode that dropped its conv
state), and ``expert_bias=False`` leaves the bias out of the choice (both
controls, which must come out not correct); ``bf16_activations`` rounds
the backbone's activations to bfloat16 where a bf16 program holds them
(each normed input, each layer part's output, the residual stream after
each add), all arithmetic still f32: how far that precision alone carries
a run from the f32 reference.  Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import csm as ref_csm

LINEARS = ("qkv", "o_proj", "w13", "w2", "in_proj", "out_proj", "experts_w13", "experts_w2")


def quantized(w: torch.Tensor, bits: Optional[int], groups: int = 1):
    """(..., in, out) weight → (values, scale) of its weight-only
    quantization at ``bits`` (one scale a column and group of input rows),
    or (the f32 weight, None) for ``bits`` None."""
    wf = w.float()
    if bits is None:
        return wf, None
    top = 2 ** (bits - 1) - 1
    *lead, D, Fo = wf.shape
    g = wf.reshape(*lead, groups, D // groups, Fo)
    scale = torch.clamp_min(g.abs().amax(dim=-2) / top, 1e-8)
    q = torch.clamp(torch.round(g / scale[..., None, :]), -top - 1, top)
    if bits == 8:
        q = q.clamp_min(-top)
    return q.to(torch.int8).reshape(*lead, D, Fo), scale


def dequantized(pair) -> torch.Tensor:
    values, scale = pair
    if scale is None:
        return values
    *lead, D, Fo = values.shape
    groups = scale.shape[-2]
    q = values.float().reshape(*lead, groups, D // groups, Fo)
    return (q * scale[..., None, :]).reshape(*lead, D, Fo)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope_half(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, S, hd) at positions 0..S-1, half-split pairs."""
    S, hd = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def route(x: torch.Tensor, gate: torch.Tensor, bias: Optional[torch.Tensor], k: int,
          norm: bool, scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """LFM2-MoE's routing in f32 → (ids (N, k), weights (N, k))."""
    scores = torch.sigmoid(x @ gate.float())
    choose = scores if bias is None else scores + bias.float()
    ids = choose.topk(k, dim=-1).indices
    w = scores.gather(-1, ids)
    if norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    return ids, w * scaling


class Backbone:
    """The LFM2-MoE trunk (module docstring), its linears kept quantized."""

    def __init__(self, params: dict, c: dict, bits: Optional[int], groups: int,
                 conv_reset: bool = False, expert_bias: bool = True,
                 bf16_activations: bool = False):
        self.c = c
        self.layers = [{k: (quantized(v, bits, groups) if k in LINEARS else v)
                        for k, v in wl.items()} for wl in params["layers"]]
        self.final_norm = params["final_norm"].float()
        self.conv_reset = conv_reset
        self.expert_bias = expert_bias
        self.bf16_activations = bf16_activations
        self.reset_from: Optional[int] = None  # the first row after the prompt

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """x as a bf16 program holds it, with ``bf16_activations``."""
        return x.to(torch.bfloat16).float() if self.bf16_activations else x

    def _layer(self, i: int) -> dict:
        return {k: (dequantized(v) if k in LINEARS else v.float())
                for k, v in self.layers[i].items()}

    def _conv(self, wl: dict, hn: torch.Tensor) -> torch.Tensor:
        D = self.c["hidden_size"]
        S = hn.shape[1]
        bcx = hn @ wl["in_proj"]
        b, cg, xx = bcx[..., :D], bcx[..., D:2 * D], bcx[..., 2 * D:]
        bx = (b * xx).transpose(1, 2)  # (B, D, S)
        taps = wl["conv"]  # (D, L)
        L = taps.shape[-1]
        conv = F.conv1d(bx, taps[:, None, :], padding=L - 1, groups=D)[..., :S]
        if self.conv_reset and self.reset_from is not None:
            r = self.reset_from
            conv[..., r:] = taps[:, L - 1:L] * bx[..., r:]
        return (cg * conv.transpose(1, 2)) @ wl["out_proj"]

    def _attention(self, wl: dict, hn: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, S, D = hn.shape
        H, KV = c["num_attention_heads"], c["num_key_value_heads"]
        hd = D // H
        qkv = hn @ wl["qkv"]
        q = _rms(qkv[..., :H * hd].reshape(B, S, H, hd), wl["q_norm"], c["norm_eps"])
        k = _rms(qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd), wl["k_norm"],
                 c["norm_eps"])
        v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd).transpose(1, 2)
        q = _rope_half(q.transpose(1, 2), c["rope_theta"])
        k = _rope_half(k.transpose(1, 2), c["rope_theta"])
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        causal = torch.ones(S, S, dtype=torch.bool, device=hn.device).tril()
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        return (probs @ v).transpose(1, 2).reshape(B, S, H * hd) @ wl["o_proj"]

    def _moe(self, wl: dict, hn: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, S, D = hn.shape
        x = hn.reshape(-1, D)
        bias = wl["expert_bias"] if self.expert_bias and c["use_expert_bias"] else None
        ids, w = route(x, wl["router"], bias,
                       c["num_experts_per_tok"], c["norm_topk_prob"],
                       c["routed_scaling_factor"])
        out = torch.zeros_like(x)
        w13, w2 = wl["experts_w13"], wl["experts_w2"]
        Fe = c["moe_intermediate_size"]
        for e in range(c["num_experts"]):
            rows, slot = (ids == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            a = x[rows] @ w13[e]
            y = (F.silu(a[:, :Fe]) * a[:, Fe:]) @ w2[e]
            out.index_add_(0, rows, y * w[rows, slot][:, None])
        return out.reshape(B, S, D)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) at positions 0..S-1 → causal hidden states (B, S, D)."""
        c = self.c
        act = self._act
        h = act(x)
        for i, kind in enumerate(c["layer_types"]):
            wl = self._layer(i)
            hn = act(_rms(h, wl["operator_norm"], c["norm_eps"]))
            h = act(h + act(self._conv(wl, hn) if kind == "conv" else self._attention(wl, hn)))
            hn = act(_rms(h, wl["ffn_norm"], c["norm_eps"]))
            if i < c["num_dense_layers"]:
                a = hn @ wl["w13"]
                Fd = a.shape[-1] // 2
                h = act(h + act((F.silu(a[..., :Fd]) * a[..., Fd:]) @ wl["w2"]))
            else:
                h = act(h + act(self._moe(wl, hn)))
            del wl
        return _rms(h, self.final_norm, c["norm_eps"])


class CSM(ref_csm.CSM):
    """The reference model of one configuration at ``bits`` (None: the
    configuration's own quantization), with the controls' options
    (module docstring)."""

    def __init__(self, params: dict, config: dict, bits: Optional[int] = None,
                 conv_reset: bool = False, expert_bias: bool = True,
                 bf16_activations: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        own = {None: None, "int8": 8, "int4": 4}[config.get("quantize")]
        bits = own if bits is None else bits
        groups = 2 if bits is not None and bits < 8 else 1
        self.config = config
        self.backbone = Backbone(params["backbone"], config, bits, groups, conv_reset,
                                 expert_bias, bf16_activations)
        self.decoder = ref_csm.Trunk(params["decoder"], config["decoder"], bits, groups)
        self.text_emb = params["text_embeddings"]
        self.audio_emb = params["audio_embeddings"]
        self.projection = params["projection"].float()
        self.head0 = params["codebook0_head"].float()
        self.heads = params["audio_head"].float()

    def frame_logits(self, prompt, frames: torch.Tensor) -> torch.Tensor:
        self.backbone.reset_from = prompt[0].shape[0]
        return super().frame_logits(prompt, frames)
