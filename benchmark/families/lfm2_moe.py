"""The model family ``lfm2_moe``: CSM with LFM2-MoE's trunk as its backbone
(``configs/csm-lfm2-8b-a1b-int8.json``).  The configuration holds the
published LFM2 config.json's keys at its top level (the backbone) and
CSM-1B's ``decoder`` and ``mimi`` groups.

- ``draw``: the program's tree on the card, one ``randn`` a backbone layer
  (so the peak stays one layer above the tree), the decoder, embeddings
  and heads as ``harness/weights.py`` draws CSM's;
- ``port``: the port's ``HybridConfig`` backbone, registered as a flavor
  named after the configuration.  It imports the port's hybrid names
  first, so a port without them fails here, before any weight is drawn;
- ``reference``: ``reference/lfm2_moe.py`` (``conv_reset`` and
  ``expert_bias`` are its controls' options, ``bf16_activations`` its
  precision witness);
- the work counts at the published shapes: ``quant_work`` (the dense int8
  products, the experts left out), ``moe_work`` (the routed FFNs of one
  frame-step, from the experts hit), the attention of the 6 attention
  layers and the decoder, and the model operations with the active
  parameters (4 of 32 experts a row).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from benchmark.harness import system, weights, work
from benchmark.reference import lfm2_moe as ref_lfm2


def _trunk_config(config: dict, dtype):
    from sesameai_tts_tpu_torch.core.config import HybridConfig, RoPEConfig

    c = config
    return HybridConfig(
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], embed_dim=c["hidden_size"],
        max_seq_len=c["backbone_kv_rows"], intermediate_dim=c["intermediate_size"],
        layer_types=tuple(c["layer_types"]), num_dense_layers=c["num_dense_layers"],
        num_experts=c["num_experts"], num_experts_per_tok=c["num_experts_per_tok"],
        moe_intermediate_dim=c["moe_intermediate_size"], conv_L_cache=c["conv_L_cache"],
        use_expert_bias=c["use_expert_bias"], norm_topk_prob=c["norm_topk_prob"],
        routed_scaling_factor=float(c["routed_scaling_factor"]), norm_eps=c["norm_eps"],
        rope=RoPEConfig(base=float(c["rope_theta"]), scale_factor=1), dtype=dtype)


def port(config: dict, name: str):
    """The port's (CSMConfig, MimiConfig) for its ``Generator``."""
    from sesameai_tts_tpu_torch.core.config import CSMConfig, register_flavor

    dtype = weights.dtype_of(config["dtype"])
    backbone = _trunk_config(config, dtype)
    decoder = system._transformer_config(config["decoder"], dtype)
    register_flavor(f"{name}/backbone", lambda: backbone)
    register_flavor(f"{name}/decoder", lambda: decoder)
    csm = CSMConfig(backbone_flavor=f"{name}/backbone", decoder_flavor=f"{name}/decoder",
                    text_vocab_size=config["text_vocab_size"],
                    audio_vocab_size=config["audio_vocab_size"],
                    audio_num_codebooks=config["audio_num_codebooks"])
    return csm, system.mimi_config(config["mimi"])


def _layer(c: dict, i: int, kind: str, g: torch.Generator, dtype, device) -> dict:
    """Backbone layer ``i``: one draw cut into its linears, conv taps and
    expert bias (N(0, ``expert_bias_std``²)); norms 1 + N(0, 0.1²)."""
    D, H, KV = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd, L = D // H, c["conv_L_cache"]
    blocks: List[Tuple[str, tuple, float]] = []
    if kind == "conv":
        blocks += [("in_proj", (D, 3 * D), D ** -0.5), ("conv", (D, L), L ** -0.5),
                   ("out_proj", (D, D), D ** -0.5)]
    else:
        blocks += [("qkv", (D, (H + 2 * KV) * hd), D ** -0.5), ("o_proj", (H * hd, D),
                                                                (H * hd) ** -0.5)]
    if i < c["num_dense_layers"]:
        Fd = c["intermediate_size"]
        blocks += [("w13", (D, 2 * Fd), D ** -0.5), ("w2", (Fd, D), Fd ** -0.5)]
    else:
        E, Fe = c["num_experts"], c["moe_intermediate_size"]
        blocks += [("router", (D, E), D ** -0.5), ("expert_bias", (E,), c["expert_bias_std"]),
                   ("experts_w13", (E, D, 2 * Fe), D ** -0.5),
                   ("experts_w2", (E, Fe, D), Fe ** -0.5)]
    norms = [("operator_norm", (D,)), ("ffn_norm", (D,))]
    if kind != "conv":
        norms += [("q_norm", (hd,)), ("k_norm", (hd,))]
    drawn = weights._draw([(shape, scale) for _, shape, scale in blocks]
                          + [(shape, 0.1) for _, shape in norms], g, dtype, device)
    out = dict(zip([n for n, _, _ in blocks], drawn))
    for (n, _), t in zip(norms, drawn[len(blocks):]):
        out[n] = t.add_(1.0)
    return out


def draw(config: dict, seed: int, device) -> dict:
    """The program's weight tree, drawn from ``seed`` on ``device``."""
    dtype = weights.dtype_of(config["dtype"])
    g = torch.Generator(device=device).manual_seed(weights.sub_seeds(seed, 2)[0])
    D, Dd = config["hidden_size"], config["decoder"]["embed_dim"]
    V, K = config["audio_vocab_size"], config["audio_num_codebooks"]
    layers = tuple(_layer(config, i, kind, g, dtype, device)
                   for i, kind in enumerate(config["layer_types"]))
    final = weights._draw([((D,), 0.1)], g, dtype, device)[0].add_(1.0)
    decoder = weights._trunk(config["decoder"], g, dtype, device)
    text, audio, proj, head0, heads = weights._draw(
        [((config["text_vocab_size"], D), D ** -0.5), ((V * K, D), D ** -0.5),
         ((D, Dd), D ** -0.5), ((D, V), D ** -0.5), ((K - 1, Dd, V), Dd ** -0.5)],
        g, dtype, device)
    return {"backbone": {"layers": layers, "final_norm": final}, "decoder": decoder,
            "text_embeddings": text, "audio_embeddings": audio, "projection": proj,
            "codebook0_head": head0, "audio_head": heads}


def quantize(params: dict, bits: int) -> dict:
    """The tree as the program quantizes it (int8: the experts have no
    int4 kernel)."""
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm

    return quantize_csm(params, bits=bits)


def reference(params: dict, config: dict, bits=None, conv_reset: bool = False,
              expert_bias: bool = True, bf16_activations: bool = False) -> ref_lfm2.CSM:
    """The plain reference over ``params`` (``bits``, ``conv_reset``,
    ``expert_bias``: the controls'; ``bf16_activations``: the precision
    witness, ``reference/lfm2_moe.py``)."""
    return ref_lfm2.CSM(params, config, bits=bits, conv_reset=conv_reset,
                        expert_bias=expert_bias, bf16_activations=bf16_activations)


# -- the work counts ----------------------------------------------------------------


def _attention_trunk(c: dict) -> dict:
    """The backbone's attention layers as a trunk of ``harness/work.py``."""
    return {"num_layers": c["layer_types"].count("full_attention"),
            "num_heads": c["num_attention_heads"], "num_kv_heads": c["num_key_value_heads"],
            "embed_dim": c["hidden_size"]}


def _as_csm(c: dict) -> dict:
    """``c`` with a ``backbone`` group of its attention layers, for the
    shared counts of ``harness/work.py`` (attention, the decoder)."""
    return dict(c, backbone=_attention_trunk(c))


def dense_shapes(c: dict) -> List[Tuple[int, int, int]]:
    """(in, out, layers) of the backbone's dense products a row: the conv
    layers' in_proj and out_proj, the attention layers' qkv and o_proj,
    the dense FFNs' w13 and w2."""
    D, H, KV = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd, Fd = D // H, c["intermediate_size"]
    convs = c["layer_types"].count("conv")
    attns = c["layer_types"].count("full_attention")
    dense = c["num_dense_layers"]
    return [(D, 3 * D, convs), (D, D, convs), (D, (H + 2 * KV) * hd, attns), (H * hd, D, attns),
            (D, 2 * Fd, dense), (Fd, D, dense)]


def moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["num_dense_layers"]


def active_params(c: dict) -> float:
    """The backbone's weights one row multiplies by: the dense products,
    the conv taps, and in each routed layer the router and its row's
    ``num_experts_per_tok`` experts."""
    D, E, Fe = c["hidden_size"], c["num_experts"], c["moe_intermediate_size"]
    dense = sum(d * f * n for d, f, n in dense_shapes(c))
    taps = c["layer_types"].count("conv") * D * c["conv_L_cache"]
    routed = moe_layers(c) * (D * E + c["num_experts_per_tok"] * 3 * D * Fe)
    return float(dense + taps + routed)


def quant_work(cfg: dict, rows: int, bits: int, groups: int = 1,
               part: Optional[str] = None) -> Tuple[float, float]:
    """(bytes, operations) of one frame-step's dense quantized products at
    ``rows`` rows (``harness/work.py::quant_work``'s counting): the
    backbone's (the experts left out: ``moe_work``), the decoder passes'
    (``part``), or both."""
    calls = []
    if part in (None, "backbone"):
        calls += dense_shapes(cfg)
    if part in (None, "decoder"):
        calls += [(d, f, cfg["decoder"]["num_layers"] * work.decoder_passes(cfg))
                  for d, f in work.linear_shapes(cfg["decoder"])]
    nbytes = flops = 0.0
    for d, f, n in calls:
        nbytes += n * (d * f * bits / 8 + 4 * f * groups + 2 * rows * d + 2 * rows * f)
        flops += n * 2.0 * rows * d * f
    return nbytes, flops


def moe_work(cfg: dict, experts_hit: float, rows: int) -> Tuple[float, float]:
    """(bytes, operations) of one frame-step's routed FFNs at ``rows`` rows
    that hit ``experts_hit`` (layer, expert) pairs in all: each hit
    expert's int8 w13 and w2 and their f32 column scales read once; in each
    routed layer x in and y out in bf16 and the routing (int64 ids, f32
    weights) once; 2 operations a multiply-add of each row's
    ``num_experts_per_tok`` experts."""
    D, Fe, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    expert = 3 * D * Fe + 4 * (2 * Fe + D)
    layers = moe_layers(cfg)
    nbytes = experts_hit * expert + layers * rows * (2 * D + 2 * D + 12 * k)
    flops = layers * rows * k * 2.0 * 3 * D * Fe
    return nbytes, flops


def attention_work(cfg: dict, keys: Iterable[int],
                   part: Optional[str] = None) -> Tuple[float, float]:
    """``harness/work.py::attention_work`` over the 6 attention layers."""
    return work.attention_work(_as_csm(cfg), keys, part)


def prefill_attention_work(cfg: dict, rows: int, context: int) -> Tuple[float, float]:
    return work.prefill_attention_work(_as_csm(cfg), rows, context)


def frame_flops(cfg: dict, keys: int) -> float:
    """Model operations of one decoded frame of one row whose backbone step
    attends ``keys`` rows: the active parameters, the attention layers,
    then CSM's sampling of the frame."""
    c = _as_csm(cfg)
    return (2.0 * active_params(cfg) + work._attention(c["backbone"], keys)[1]
            + work.sample_flops(c))


def prefill_flops(cfg: dict, rows: int, context: int) -> float:
    """Model operations of an admission: ``rows`` prompt rows after
    ``context`` cached rows through the backbone (active parameters), then
    its frame."""
    c = _as_csm(cfg)
    visible = rows * context + rows * (rows + 1) // 2
    return (2.0 * active_params(cfg) * rows + work._attention(c["backbone"], 1)[1] * visible
            + work.sample_flops(c))
