"""The model's weights, drawn from the seed on the device in a few large
calls, in the type they are served in.

The benchmark makes the weights and hands the same tree to the program
(which quantizes it and keeps its own prefill shadow) and, drawn again
from the same seed after the window, to the plain reference (which
quantizes it itself).  The tree has the layout the port's ``Generator``
and ``Mimi`` read: per-layer trunk dicts with fused ``qkv`` and ``w13``
stored (in, out), and Mimi's nested lists and stacked transformer layers.

Each trunk is one ``randn`` over a buffer cut into per-kind blocks
(every layer's ``qkv``, then every ``o_proj``, ...), each block scaled
once by 1/sqrt(fan in); the embeddings and heads are a third buffer and
Mimi's weights a fourth.  A trunk's buffer is referenced only by its own
views, so it is freed once the program has quantized it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.mimi import seanet_specs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any whole
    number, negative or past 32 bits)."""
    ss = np.random.SeedSequence([seed % 2**64, 0x42454E43])
    return [int(x) >> 1 for x in ss.generate_state(n, np.uint64)]


def _draw(blocks: List[Tuple[tuple, float]], generator: torch.Generator, dtype,
          device) -> List[torch.Tensor]:
    """One ``randn`` cut into blocks of the given shapes, each scaled in
    place by its factor → the blocks (views of one buffer)."""
    sizes = [math.prod(shape) for shape, _ in blocks]
    buf = torch.randn(sum(sizes), generator=generator, device=device, dtype=dtype)
    out, at = [], 0
    for (shape, scale), n in zip(blocks, sizes):
        view = buf[at:at + n].view(shape)
        if scale != 1.0:
            view.mul_(scale)
        out.append(view)
        at += n
    return out


def _trunk(t: dict, generator: torch.Generator, dtype, device) -> dict:
    L, D, F = t["num_layers"], t["embed_dim"], t["intermediate_dim"]
    H, KV = t["num_heads"], t["num_kv_heads"]
    hd = D // H
    qkv, o, w13, w2 = _draw([((L, D, (H + 2 * KV) * hd), D ** -0.5),
                             ((L, H * hd, D), (H * hd) ** -0.5),
                             ((L, D, 2 * F), D ** -0.5),
                             ((L, F, D), F ** -0.5)], generator, dtype, device)
    layers = tuple({"attn_norm": torch.ones(D, dtype=dtype, device=device),
                    "qkv": qkv[i], "o_proj": o[i],
                    "mlp_norm": torch.ones(D, dtype=dtype, device=device),
                    "w13": w13[i], "w2": w2[i]} for i in range(L))
    return {"layers": layers, "final_norm": torch.ones(D, dtype=dtype, device=device)}


def draw_csm(config: dict, seed: int, device) -> dict:
    """The CSM tree of ``config`` in its ``dtype``, on ``device``."""
    dtype = dtype_of(config["dtype"])
    g = torch.Generator(device=device).manual_seed(sub_seeds(seed, 2)[0])
    bb, dec = config["backbone"], config["decoder"]
    D, Dd = bb["embed_dim"], dec["embed_dim"]
    V, K = config["audio_vocab_size"], config["audio_num_codebooks"]
    backbone = _trunk(bb, g, dtype, device)
    decoder = _trunk(dec, g, dtype, device)
    text, audio, proj, head0, heads = _draw([((config["text_vocab_size"], D), D ** -0.5),
                                             ((V * K, D), D ** -0.5),
                                             ((D, Dd), D ** -0.5),
                                             ((D, V), D ** -0.5),
                                             ((K - 1, Dd, V), Dd ** -0.5)], g, dtype, device)
    return {"backbone": backbone, "decoder": decoder, "text_embeddings": text,
            "audio_embeddings": audio, "projection": proj, "codebook0_head": head0,
            "audio_head": heads}


def _conv_shape(spec) -> Tuple[tuple, int]:
    """(weight shape, fan in) of a SEANet conv spec (reference/mimi.py)."""
    if spec[0] == "conv":
        _, cin, cout, k, _, _ = spec
        return (cout, cin, k), cin * k
    _, cin, cout, k, _ = spec
    return (cin, cout, k), cin * k


def draw_mimi(config: dict, seed: int, device) -> dict:
    """Mimi's tree (encoder and decoder, as a deployment holds it) in
    ``config['mimi_dtype']`` on ``device``."""
    dtype = dtype_of(config["mimi_dtype"])
    m = config["mimi"]
    g = torch.Generator(device=device).manual_seed(sub_seeds(seed, 2)[1])
    tf, rvq = m["transformer"], m["rvq"]
    Dm = m["seanet"]["dimension"]
    L, Dt, Fd = tf["num_layers"], tf["d_model"], tf["dim_feedforward"]

    # every weight leaf in one draw: (path, shape, scale)
    leaves: List[Tuple[tuple, tuple, float]] = []
    for part, decoder in (("encoder", False), ("decoder", True)):
        for i, spec in enumerate(seanet_specs(m["seanet"], decoder)):
            if spec[0] == "res":
                for j, sub in enumerate(spec[1]):
                    shape, fan = _conv_shape(sub)
                    leaves.append(((part, i, j), shape, fan ** -0.5))
            elif spec[0] != "elu":
                shape, fan = _conv_shape(spec)
                leaves.append(((part, i), shape, fan ** -0.5))
    for part in ("encoder_transformer", "decoder_transformer"):
        for key, shape, fan in (("qkv", (L, Dt, 3 * Dt), Dt), ("out", (L, Dt, Dt), Dt),
                                ("lin1", (L, Dt, Fd), Dt), ("lin2", (L, Fd, Dt), Fd)):
            leaves.append(((part, key), shape, fan ** -0.5))
    s = m["downsample_stride"]
    leaves.append((("downsample",), (Dm, Dm, 2 * s), (Dm * 2 * s) ** -0.5))
    leaves.append((("upsample",), (Dm, 1, 2 * s), (2 * s) ** -0.5))
    for part, n_q in (("semantic", rvq["n_q_semantic"]), ("acoustic", rvq["n_q_acoustic"])):
        leaves.append((("quantizer", part, "input_proj"), (rvq["input_dim"], rvq["dimension"]),
                       rvq["input_dim"] ** -0.5))
        leaves.append((("quantizer", part, "output_proj"), (rvq["dimension"], rvq["output_dim"]),
                       rvq["dimension"] ** -0.5))
        leaves.append((("quantizer", part, "codebooks"), (n_q, rvq["bins"], rvq["dimension"]),
                       1.0))
    drawn: Dict[tuple, torch.Tensor] = dict(zip(
        [path for path, _, _ in leaves],
        _draw([(shape, scale) for _, shape, scale in leaves], g, dtype, device)))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    out: dict = {}
    for part, decoder in (("encoder", False), ("decoder", True)):
        params = []
        for i, spec in enumerate(seanet_specs(m["seanet"], decoder)):
            if spec[0] == "elu":
                params.append(None)
            elif spec[0] == "res":
                params.append([{"w": drawn[(part, i, j)], "b": zeros(sub[2])}
                               for j, sub in enumerate(spec[1])])
            else:
                params.append({"w": drawn[(part, i)], "b": zeros(spec[2])})
        out[part] = params
    for part in ("encoder_transformer", "decoder_transformer"):
        out[part] = {"layers": {
            "norm1_w": full(1.0, L, Dt), "norm1_b": zeros(L, Dt),
            "qkv": drawn[(part, "qkv")], "out": drawn[(part, "out")],
            "norm2_w": full(1.0, L, Dt), "norm2_b": zeros(L, Dt),
            "lin1": drawn[(part, "lin1")], "lin2": drawn[(part, "lin2")],
            "ls1": full(tf["layer_scale"], L, Dt), "ls2": full(tf["layer_scale"], L, Dt),
        }}
    out["downsample"] = {"w": drawn[("downsample",)]}
    out["upsample"] = {"w": drawn[("upsample",)]}
    out["quantizer"] = {part: {k: drawn[("quantizer", part, k)]
                               for k in ("input_proj", "output_proj", "codebooks")}
                        for part in ("semantic", "acoustic")}
    return out
