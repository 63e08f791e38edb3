"""The yardstick's work counts: the bytes and operations that CSM's work
needs at its published shapes, whatever kernel does it.

A roofline share is the least time the card could take for that work,
the larger of bytes over peak bandwidth and operations over peak rate,
divided by the time the kernel took.  Each input byte is counted once
and each output byte once; a quantized weight is read once a call.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

def linear_shapes(t: dict) -> List[Tuple[int, int]]:
    """(in, out) of one layer's qkv, o_proj, w13 and w2."""
    D, F, H, KV = t["embed_dim"], t["intermediate_dim"], t["num_heads"], t["num_kv_heads"]
    hd = D // H
    return [(D, (H + 2 * KV) * hd), (H * hd, D), (D, 2 * F), (F, D)]


def trunk_params(t: dict) -> int:
    return t["num_layers"] * sum(d * f for d, f in linear_shapes(t))


def decoder_passes(cfg: dict) -> int:
    """The decoder's passes a frame: the projected backbone state, then
    codebooks 0..K-2."""
    return cfg["audio_num_codebooks"]


def quant_calls(cfg: dict, part: Optional[str] = None) -> List[Tuple[int, int, int]]:
    """(in, out, calls) of every quantized product of one frame-step: the
    backbone step's, the decoder passes' (``part``), or both."""
    out = []
    if part in (None, "backbone"):
        out += [(d, f, cfg["backbone"]["num_layers"]) for d, f in linear_shapes(cfg["backbone"])]
    if part in (None, "decoder"):
        out += [(d, f, cfg["decoder"]["num_layers"] * decoder_passes(cfg))
                for d, f in linear_shapes(cfg["decoder"])]
    return out


def quant_work(cfg: dict, rows: int, bits: int, groups: int = 1,
               part: Optional[str] = None) -> Tuple[float, float]:
    """(bytes, operations) of one frame-step's quantized products at
    ``rows`` rows: the weight at ``bits`` a value, its f32 scales (one per
    column and group), x and y in bf16; 2 operations a multiply-add."""
    nbytes = flops = 0.0
    for d, f, calls in quant_calls(cfg, part):
        nbytes += calls * (d * f * bits / 8 + 4 * f * groups + 2 * rows * d + 2 * rows * f)
        flops += calls * 2.0 * rows * d * f
    return nbytes, flops


def _attention(t: dict, visible: int) -> Tuple[float, float]:
    """(bytes, operations) of one row's attention over ``visible`` keys in
    every layer of trunk ``t``: each visible key and value read once, q
    and the output once a head, bf16 elements; 4 operations a head,
    visible key and element (q·k and p·v)."""
    H, KV = t["num_heads"], t["num_kv_heads"]
    hd = t["embed_dim"] // H
    L = t["num_layers"]
    return L * 2.0 * (2 * KV * visible * hd + 2 * H * hd), L * 4.0 * H * hd * visible


def attention_work(cfg: dict, keys: Iterable[int],
                   part: Optional[str] = None) -> Tuple[float, float]:
    """(bytes, operations) of one frame-step's attention for the live rows
    whose backbone step attends ``keys`` cached rows each (``part``
    "backbone"), and whose decoder passes attend 1..K rows of the frame's
    own cache ("decoder"), or both."""
    nbytes = flops = 0.0
    for n in keys:
        todo = [(cfg["backbone"], n)] if part in (None, "backbone") else []
        if part in (None, "decoder"):
            todo += [(cfg["decoder"], i) for i in range(1, decoder_passes(cfg) + 1)]
        for t, m in todo:
            b, f = _attention(t, m)
            nbytes += b
            flops += f
    return nbytes, flops


def sample_flops(cfg: dict) -> float:
    """Model operations of sampling one frame from a backbone state:
    codebook 0's head, the decoder's passes with their attention and the
    projection, and the 31 heads."""
    bb, dec = cfg["backbone"], cfg["decoder"]
    V, K = cfg["audio_vocab_size"], cfg["audio_num_codebooks"]
    passes = decoder_passes(cfg)
    attention = sum(_attention(dec, i)[1] for i in range(1, passes + 1))
    return (2.0 * bb["embed_dim"] * V + attention
            + passes * (2.0 * trunk_params(dec) + 2.0 * bb["embed_dim"] * dec["embed_dim"])
            + (K - 1) * 2.0 * dec["embed_dim"] * V)


def frame_flops(cfg: dict, keys: int) -> float:
    """Model operations of one decoded frame of one row whose backbone
    step attends ``keys`` rows."""
    bb = cfg["backbone"]
    return 2.0 * trunk_params(bb) + _attention(bb, keys)[1] + sample_flops(cfg)


def prefill_flops(cfg: dict, rows: int, context: int) -> float:
    """Model operations of an admission: ``rows`` prompt rows after
    ``context`` cached rows through the backbone, then its frame."""
    bb = cfg["backbone"]
    visible = rows * context + rows * (rows + 1) // 2
    return 2.0 * trunk_params(bb) * rows + _attention(bb, 1)[1] * visible + sample_flops(cfg)


def bound_s(nbytes: float, flops: float, peak) -> float:
    """The least time the card could take: bytes or operations at peak."""
    return max(nbytes / peak.bytes_per_s, flops / peak.bf16_flops)


def prefill_attention_work(cfg: dict, rows: int, context: int) -> Tuple[float, float]:
    """(bytes, operations) of an admission's attention: ``rows`` prompt
    rows after ``context`` cached rows through the backbone (every key
    and value read once a layer, q and the output once a row), then its
    frame's decoder passes over 1..K rows."""
    bb = cfg["backbone"]
    H, KV = bb["num_heads"], bb["num_kv_heads"]
    hd = bb["embed_dim"] // H
    L = bb["num_layers"]
    visible = rows * context + rows * (rows + 1) // 2
    nbytes = L * 2.0 * (2 * KV * (context + rows) * hd + 2 * H * hd * rows)
    flops = L * 4.0 * H * hd * visible
    for i in range(1, decoder_passes(cfg) + 1):
        b, f = _attention(cfg["decoder"], i)
        nbytes += b
        flops += f
    return nbytes, flops
