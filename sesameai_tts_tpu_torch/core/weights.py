"""Checkpoint files → the port's parameter trees (port of
``sesameai_tts_tpu/core/weights.py``).

* ``load_csm_checkpoint(path, cfg)``: the torchtune-layout CSM state dict
  (``backbone.layers.N.attn.q_proj.weight`` …, the layout sesame/csm-1b
  publishes) → the port's CSM tree.  Linear weights transpose (torch
  stores (out, in); the tree stores (in, out)); q/k/v and w1/w3 fuse.
  ``save_csm_checkpoint`` is its inverse.
* ``load_mimi_checkpoint(path, mimi)``: a Mimi state dict in the moshi or
  the transformers ``MimiModel`` layout → the port's Mimi tree;
  ``mimi_hf_state_dict`` writes the transformers layout back.
* ``save_pytree`` / ``load_pytree``: any tree of tensors as one
  safetensors file keyed by the flattened key paths, with the tree's
  structure in the header's metadata.  This takes the place of the JAX
  package's orbax directories, which the port cannot read: an orbax
  directory raises ``ValueError``.

Everything loads on the host; the caller casts and moves the tree once.
The safetensors format is read and written here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header of ``{name: {dtype, shape, data_offsets}}``, then the raw C-order
bytes of every tensor.
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
from typing import Dict, Optional

import torch

from sesameai_tts_tpu_torch.convert import tree_map
from sesameai_tts_tpu_torch.core.config import CSMConfig, TransformerConfig

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors, read and written here
# ---------------------------------------------------------------------------


def _read_header(f) -> tuple:
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    return header, 8 + n


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file → {name: CPU tensor in its stored dtype}."""
    out = {}
    with open(path, "rb") as f:
        header, base = _read_header(f)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                                 f"reader does not take")
            begin, end = info["data_offsets"]
            buf = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            dtype = _ST_DTYPES[info["dtype"]]
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(info["shape"])
    return out


def _read_metadata(path: str) -> Dict[str, str]:
    with open(path, "rb") as f:
        return _read_header(f)[0].get("__metadata__", {})


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """{name: tensor} → a .safetensors file.  Each tensor is written from a
    contiguous CPU copy, in C order, so no layout is written transposed."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = metadata
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


# ---------------------------------------------------------------------------
# state dicts
# ---------------------------------------------------------------------------


def _strip_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Normalize the key prefixes real checkpoints carry: ``model.`` (hub
    mixin wrappers) and ``_orig_mod.`` (torch.compile'd modules)."""
    for prefix in ("model.", "_orig_mod."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return {k.replace("._orig_mod.", "."): v for k, v in sd.items()}


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors or torch .pt/.ckpt file → {name: CPU tensor}.

    Takes a model DIRECTORY too: model.safetensors, ckpt.pt or
    pytorch_model.bin in it, else its *.safetensors, every shard merged."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "ckpt.pt", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
            if not shards:
                raise FileNotFoundError(f"no checkpoint file found in {path}")
            merged: Dict[str, torch.Tensor] = {}
            for shard in shards:  # HF-style sharded export: every shard counts
                merged.update(_read_state_dict(shard))
            return merged
    if path.endswith(".safetensors"):
        return _strip_prefixes(read_safetensors(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return _strip_prefixes(dict(sd))


_CSM_KEYS = {"backbone", "decoder", "text_embeddings", "audio_embeddings", "projection",
             "codebook0_head", "audio_head"}


def _is_orbax_dir(path: str) -> bool:
    """An orbax pytree directory (what the JAX package's ``save_pytree``
    and its finetune export write), vs a hub-style weights directory."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, marker))
        for marker in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "d")
    )


def _refuse_orbax(path: str) -> None:
    if _is_orbax_dir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory of the JAX package, which the "
            f"port cannot read: export the tree with the port's save_pytree (one "
            f".safetensors file) or pass a torch/safetensors state dict"
        )


def _expect_shape(t: torch.Tensor, shape: tuple, name: str, dtype) -> torch.Tensor:
    """A checkpoint tensor at ``dtype``, failing loudly on a layout mismatch."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != expected "
                         f"{tuple(shape)} (wrong layout or incompatible config)")
    return t.to(dtype)


def _trunk(sd: Dict[str, torch.Tensor], prefix: str, cfg: TransformerConfig, dtype) -> dict:
    """torchtune llama3_2 trunk state dict → the port's per-layer trunk."""
    D, F = cfg.embed_dim, cfg.intermediate_dim
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(i, name, n_out, n_in):  # (out, in) in the file → (in, out)
        key = f"{prefix}.layers.{i}.{name}.weight"
        return _expect_shape(sd[key], (n_out, n_in), key, dtype).T

    def norm(i, name):
        key = f"{prefix}.layers.{i}.{name}.scale"
        return _expect_shape(sd[key], (D,), key, dtype)

    layers = tuple(
        {
            "attn_norm": norm(i, "sa_norm"),
            "qkv": torch.cat([lin(i, "attn.q_proj", H * hd, D), lin(i, "attn.k_proj", KV * hd, D),
                              lin(i, "attn.v_proj", KV * hd, D)], dim=1),
            "o_proj": lin(i, "attn.output_proj", D, H * hd).contiguous(),
            "mlp_norm": norm(i, "mlp_norm"),
            "w13": torch.cat([lin(i, "mlp.w1", F, D), lin(i, "mlp.w3", F, D)], dim=1),
            "w2": lin(i, "mlp.w2", D, F).contiguous(),
        }
        for i in range(cfg.num_layers)
    )
    key = f"{prefix}.norm.scale"
    return {"layers": layers, "final_norm": _expect_shape(sd[key], (D,), key, dtype)}


def _is_pytree_file(path: str) -> bool:
    """Whether ``path`` is a file written by ``save_pytree``."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            return False
        (n,) = struct.unpack("<Q", head)
        if n > min(os.path.getsize(path) - 8, 1 << 26):  # not a safetensors header
            return False
        try:
            header = json.loads(f.read(n))
        except ValueError:
            return False
    return isinstance(header, dict) and "tree" in header.get("__metadata__", {})


def load_csm_checkpoint(path: str, cfg: CSMConfig, dtype=torch.bfloat16) -> dict:
    """sesame/csm-1b torch checkpoint (a file or a model directory) → the
    port's CSM tree on the host at ``dtype``.  A missing key raises
    ``KeyError``, a wrong shape ``ValueError``.

    Also takes a port ``save_pytree`` file of the CSM tree (the finetune
    CLI's ``<ckpt-dir>/params`` export), which is already in the port's
    layout, as the JAX loader takes an orbax export."""
    _refuse_orbax(path)
    if _is_pytree_file(path):
        tree = load_pytree(path)
        if not isinstance(tree, dict) or set(tree) != _CSM_KEYS:
            raise ValueError(f"{path}: a save_pytree file, but not of a CSM parameter tree")
        for trunk, tcfg in (("backbone", cfg.backbone), ("decoder", cfg.decoder)):
            if len(tree[trunk]["layers"]) != tcfg.num_layers:
                raise ValueError(f"{path}: {trunk} has {len(tree[trunk]['layers'])} layers, "
                                 f"the config {tcfg.num_layers}")
        return tree_map(lambda t: t.to(dtype), tree)
    sd = _read_state_dict(path)
    bb, dec = cfg.backbone, cfg.decoder
    K, V = cfg.audio_num_codebooks, cfg.audio_vocab_size

    def get(key, shape):
        return _expect_shape(sd[key], shape, key, dtype)

    return {
        "backbone": _trunk(sd, "backbone", bb, dtype),
        "decoder": _trunk(sd, "decoder", dec, dtype),
        "text_embeddings": get("text_embeddings.weight", (cfg.text_vocab_size, bb.embed_dim)),
        "audio_embeddings": get("audio_embeddings.weight", (V * K, bb.embed_dim)),
        "projection": get("projection.weight", (dec.embed_dim, bb.embed_dim)).T.contiguous(),
        "codebook0_head": get("codebook0_head.weight", (V, bb.embed_dim)).T.contiguous(),
        "audio_head": get("audio_head", (K - 1, dec.embed_dim, V)),
    }


def save_csm_checkpoint(path: str, params: dict) -> None:
    """Inverse of ``load_csm_checkpoint``: the port's CSM tree → a f32
    torchtune-layout .safetensors file."""

    def f32(t):
        return t.detach().to("cpu", torch.float32)

    sd: Dict[str, torch.Tensor] = {}
    for prefix in ("backbone", "decoder"):
        trunk = params[prefix]
        for i, lp in enumerate(trunk["layers"]):
            qkv, w13 = f32(lp["qkv"]), f32(lp["w13"])
            h_hd = lp["o_proj"].shape[0]  # H·hd
            kv_hd = (qkv.shape[1] - h_hd) // 2  # KV·hd
            F = lp["w2"].shape[0]
            p = f"{prefix}.layers.{i}"
            sd[f"{p}.attn.q_proj.weight"] = qkv[:, :h_hd].T
            sd[f"{p}.attn.k_proj.weight"] = qkv[:, h_hd:h_hd + kv_hd].T
            sd[f"{p}.attn.v_proj.weight"] = qkv[:, h_hd + kv_hd:].T
            sd[f"{p}.attn.output_proj.weight"] = f32(lp["o_proj"]).T
            sd[f"{p}.mlp.w1.weight"] = w13[:, :F].T
            sd[f"{p}.mlp.w3.weight"] = w13[:, F:].T
            sd[f"{p}.mlp.w2.weight"] = f32(lp["w2"]).T
            sd[f"{p}.sa_norm.scale"] = f32(lp["attn_norm"])
            sd[f"{p}.mlp_norm.scale"] = f32(lp["mlp_norm"])
        sd[f"{prefix}.norm.scale"] = f32(trunk["final_norm"])
    sd["text_embeddings.weight"] = f32(params["text_embeddings"])
    sd["audio_embeddings.weight"] = f32(params["audio_embeddings"])
    sd["projection.weight"] = f32(params["projection"]).T
    sd["codebook0_head.weight"] = f32(params["codebook0_head"]).T
    sd["audio_head"] = f32(params["audio_head"])
    write_safetensors(path, sd)  # writes each transposed view in C order


# ---------------------------------------------------------------------------
# Mimi (moshi or transformers layout)
# ---------------------------------------------------------------------------


def _hf_mimi_to_moshi_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers ``MimiModel`` naming → moshi naming (the layout
    ``load_mimi_checkpoint`` maps).  Each side counts its own transformer
    layers, so a decode-only export still remaps its decoder."""
    out: Dict[str, torch.Tensor] = {}

    def _count_layers(side: str) -> int:
        return max((int(k.split(".")[2]) + 1 for k in sd if k.startswith(f"{side}.layers.")),
                   default=0)

    for k, v in sd.items():
        for side in ("encoder", "decoder"):
            if k.startswith(f"{side}.layers."):
                idx, sub = k[len(f"{side}.layers."):].split(".", 1)
                if sub.startswith("block."):
                    j, tail = sub[len("block."):].split(".", 1)
                    out[f"{side}.model.{idx}.block.{j}.conv.{tail}"] = v
                else:
                    out[f"{side}.model.{idx}.conv.{sub}"] = v
    for side in ("encoder_transformer", "decoder_transformer"):
        for i in range(_count_layers(side)):
            p, o = f"{side}.layers.{i}", f"{side}.transformer.layers.{i}"
            out[f"{o}.self_attn.in_proj_weight"] = torch.cat(
                [sd[f"{p}.self_attn.q_proj.weight"], sd[f"{p}.self_attn.k_proj.weight"],
                 sd[f"{p}.self_attn.v_proj.weight"]], 0)
            out[f"{o}.self_attn.out_proj.weight"] = sd[f"{p}.self_attn.o_proj.weight"]
            out[f"{o}.norm1.weight"] = sd[f"{p}.input_layernorm.weight"]
            out[f"{o}.norm1.bias"] = sd[f"{p}.input_layernorm.bias"]
            out[f"{o}.norm2.weight"] = sd[f"{p}.post_attention_layernorm.weight"]
            out[f"{o}.norm2.bias"] = sd[f"{p}.post_attention_layernorm.bias"]
            out[f"{o}.linear1.weight"] = sd[f"{p}.mlp.fc1.weight"]
            out[f"{o}.linear2.weight"] = sd[f"{p}.mlp.fc2.weight"]
            out[f"{o}.layer_scale_1.scale"] = sd[f"{p}.self_attn_layer_scale.scale"]
            out[f"{o}.layer_scale_2.scale"] = sd[f"{p}.mlp_layer_scale.scale"]
    out["downsample.conv.conv.weight"] = sd["downsample.conv.weight"]
    out["upsample.convtr.convtr.weight"] = sd["upsample.conv.weight"]
    for hf, mo in (("semantic_residual_vector_quantizer", "rvq_first"),
                   ("acoustic_residual_vector_quantizer", "rvq_rest")):
        out[f"quantizer.{mo}.input_proj.weight"] = sd[f"quantizer.{hf}.input_proj.weight"]
        out[f"quantizer.{mo}.output_proj.weight"] = sd[f"quantizer.{hf}.output_proj.weight"]
        n = sum(1 for k in sd
                if k.startswith(f"quantizer.{hf}.layers.") and k.endswith("embed_sum"))
        for i in range(n):
            base = f"quantizer.{hf}.layers.{i}.codebook"
            out[f"quantizer.{mo}.vq.layers.{i}._codebook.embedding_sum"] = sd[f"{base}.embed_sum"]
            out[f"quantizer.{mo}.vq.layers.{i}._codebook.cluster_usage"] = \
                sd[f"{base}.cluster_usage"]
    return out


def mimi_hf_state_dict(params: dict, mimi) -> Dict[str, torch.Tensor]:
    """The port's Mimi tree → a state dict in the transformers ``MimiModel``
    layout (the inverse of ``load_mimi_checkpoint`` on that layout, through
    ``_hf_mimi_to_moshi_keys``), f32 on the host.  Each codebook is written as
    ``embed_sum`` with a ``cluster_usage`` of one and ``initialized`` set, so
    it loads back exactly."""

    def f32(t):
        return t.detach().to("cpu", torch.float32).contiguous()

    sd: Dict[str, torch.Tensor] = {}
    for side in ("encoder", "decoder"):
        for i, (spec, p) in enumerate(zip(getattr(mimi, side).specs, params[side])):
            convs = ([(f"{side}.layers.{i}.conv", p)] if spec[0] in ("conv", "convtr")
                     else [(f"{side}.layers.{i}.block.{2 * j + 1}.conv", q)
                           for j, q in enumerate(p)] if spec[0] == "res" else [])
            for name, q in convs:
                sd[f"{name}.weight"] = f32(q["w"])
                if "b" in q:
                    sd[f"{name}.bias"] = f32(q["b"])
    for side in ("encoder_transformer", "decoder_transformer"):
        lay = params[side]["layers"]
        for i in range(lay["qkv"].shape[0]):
            p = f"{side}.layers.{i}"
            q, k, v = f32(lay["qkv"][i]).T.chunk(3, dim=0)
            sd[f"{p}.self_attn.q_proj.weight"] = q.contiguous()
            sd[f"{p}.self_attn.k_proj.weight"] = k.contiguous()
            sd[f"{p}.self_attn.v_proj.weight"] = v.contiguous()
            sd[f"{p}.self_attn.o_proj.weight"] = f32(lay["out"][i]).T.contiguous()
            sd[f"{p}.input_layernorm.weight"] = f32(lay["norm1_w"][i])
            sd[f"{p}.input_layernorm.bias"] = f32(lay["norm1_b"][i])
            sd[f"{p}.post_attention_layernorm.weight"] = f32(lay["norm2_w"][i])
            sd[f"{p}.post_attention_layernorm.bias"] = f32(lay["norm2_b"][i])
            sd[f"{p}.mlp.fc1.weight"] = f32(lay["lin1"][i]).T.contiguous()
            sd[f"{p}.mlp.fc2.weight"] = f32(lay["lin2"][i]).T.contiguous()
            sd[f"{p}.self_attn_layer_scale.scale"] = f32(lay["ls1"][i])
            sd[f"{p}.mlp_layer_scale.scale"] = f32(lay["ls2"][i])
    sd["downsample.conv.weight"] = f32(params["downsample"]["w"])
    sd["upsample.conv.weight"] = f32(params["upsample"]["w"])
    for hf, name in (("semantic_residual_vector_quantizer", "semantic"),
                     ("acoustic_residual_vector_quantizer", "acoustic")):
        qp = params["quantizer"][name]
        sd[f"quantizer.{hf}.input_proj.weight"] = f32(qp["input_proj"]).T.contiguous()[..., None]
        sd[f"quantizer.{hf}.output_proj.weight"] = f32(qp["output_proj"]).T.contiguous()[..., None]
        for i, cb in enumerate(qp["codebooks"]):
            base = f"quantizer.{hf}.layers.{i}.codebook"
            sd[f"{base}.embed_sum"] = f32(cb)
            sd[f"{base}.cluster_usage"] = torch.ones(cb.shape[0])
            sd[f"{base}.initialized"] = torch.ones(1)
    return sd


def load_mimi_checkpoint(path: str, mimi, dtype=torch.float32) -> dict:
    """Mimi state dict (moshi OR transformers layout, detected from the
    keys) → the port's Mimi tree on the host at ``dtype``.

    * SEANet: the checkpoint's ``{en,de}coder.model.N`` conv weights, by
      sequential index, zip 1:1 with the stack's spec order;
    * codec transformers: ``{en,de}coder_transformer.transformer.layers.N``
      → one stacked tree (packed qkv transposed to (in, out));
    * quantizer: ``quantizer.rvq_{first,rest}`` 1×1 projections and the
      per-stage codebooks (``embedding_sum / cluster_usage``, in f32).
    """
    _refuse_orbax(path)
    sd = {k: v.float() for k, v in _read_state_dict(path).items()}
    if any(k.startswith("encoder.layers.") for k in sd):
        sd = _hf_mimi_to_moshi_keys(sd)

    def seanet_params(prefix: str, module) -> list:
        pat = re.compile(rf"{prefix}\.model\.(\d+)\.(.*)")
        by_idx: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, v in sd.items():
            m = pat.match(k)
            if m:
                by_idx.setdefault(int(m.group(1)), {})[m.group(2)] = v
        ordered = [by_idx[i] for i in sorted(by_idx)]
        params, oi = [], 0
        for spec in module.specs:
            if spec[0] in ("conv", "convtr"):
                entry = ordered[oi]
                oi += 1
                p = {"w": next(v for k, v in entry.items() if k.endswith("weight")).to(dtype)}
                bias = [v for k, v in entry.items() if k.endswith("bias")]
                if bias:
                    p["b"] = bias[0].to(dtype)
                params.append(p)
            elif spec[0] == "res":
                entry = ordered[oi]
                oi += 1
                # residual block [ELU, conv, ELU, conv]: convs at indices 1 and 3
                sub = []
                for j in range(len(spec[1])):
                    p = {"w": entry[f"block.{2 * j + 1}.conv.conv.weight"].to(dtype)}
                    bias_key = f"block.{2 * j + 1}.conv.conv.bias"
                    if bias_key in entry:
                        p["b"] = entry[bias_key].to(dtype)
                    sub.append(p)
                params.append(sub)
            else:
                params.append(None)
        return params

    def transformer_params(prefix: str) -> dict:
        L = mimi.cfg.transformer.num_layers

        def stack(name, transpose=False):
            ts = [sd[f"{prefix}.layers.{i}.{name}"] for i in range(L)]
            return torch.stack([t.T if transpose else t for t in ts]).to(dtype)

        return {"layers": {
            "norm1_w": stack("norm1.weight"), "norm1_b": stack("norm1.bias"),
            "qkv": stack("self_attn.in_proj_weight", True),
            "out": stack("self_attn.out_proj.weight", True),
            "norm2_w": stack("norm2.weight"), "norm2_b": stack("norm2.bias"),
            "lin1": stack("linear1.weight", True), "lin2": stack("linear2.weight", True),
            "ls1": stack("layer_scale_1.scale"), "ls2": stack("layer_scale_2.scale"),
        }}

    def rvq_params(prefix: str, n_q: int) -> dict:
        def codebook(i):
            base = f"{prefix}.vq.layers.{i}._codebook"
            if f"{base}.embedding" in sd:
                return sd[f"{base}.embedding"]
            usage = sd[f"{base}.cluster_usage"].clamp_min(1e-5)
            return sd[f"{base}.embedding_sum"] / usage[:, None]

        return {
            "input_proj": sd[f"{prefix}.input_proj.weight"][:, :, 0].T.contiguous().to(dtype),
            "output_proj": sd[f"{prefix}.output_proj.weight"][:, :, 0].T.contiguous().to(dtype),
            "codebooks": torch.stack([codebook(i) for i in range(n_q)]).to(dtype),
        }

    up = mimi.upsample
    rvq = mimi.cfg.rvq
    return {
        "encoder": seanet_params("encoder", mimi.encoder),
        "decoder": seanet_params("decoder", mimi.decoder),
        "encoder_transformer": transformer_params("encoder_transformer.transformer"),
        "decoder_transformer": transformer_params("decoder_transformer.transformer"),
        "downsample": {"w": sd["downsample.conv.conv.weight"].to(dtype)},
        # channel-wise (groups=dimension) upsample: published checkpoints
        # ship (d, 1, 2s); a dense layout must not load into the grouped conv
        "upsample": {"w": _expect_shape(
            sd["upsample.convtr.convtr.weight"],
            (up.in_channels, up.out_channels // up.groups, up.kernel_size),
            "upsample.convtr.convtr.weight", dtype)},
        "quantizer": {
            "semantic": rvq_params("quantizer.rvq_first", rvq.n_q_semantic),
            "acoustic": rvq_params("quantizer.rvq_rest", rvq.n_q_acoustic),
        },
    }


# ---------------------------------------------------------------------------
# whole trees as one safetensors file
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]):
    """→ the tree's structure as JSON-able data, leaves named by key path."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{prefix}{k}.", out) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, f"{prefix}{i}.", out) for i, v in enumerate(tree)]}
    if tree is None:
        return None
    out[prefix[:-1]] = tree
    return prefix[:-1]


def _unflatten(struct_, tensors: Dict[str, torch.Tensor]):
    if struct_ is None:
        return None
    if isinstance(struct_, str):
        return tensors[struct_]
    (kind, body), = struct_.items()
    if kind == "dict":
        return {k: _unflatten(v, tensors) for k, v in body.items()}
    items = [_unflatten(v, tensors) for v in body]
    return items if kind == "list" else tuple(items)


def save_pytree(path: str, params) -> None:
    """A tree of tensors (nested dicts, lists, tuples, None) → one
    .safetensors file; its structure goes into the header's metadata."""
    tensors: Dict[str, torch.Tensor] = {}
    struct_ = _flatten(params, "", tensors)
    write_safetensors(path, tensors, {"tree": json.dumps(struct_)})


def load_pytree(path: str, like=None):
    """Inverse of ``save_pytree`` → the tree on the host.  With ``like``, the
    file must hold exactly ``like``'s leaves at their shapes, and each
    comes back at the dtype of its ``like`` leaf."""
    _refuse_orbax(path)
    meta = _read_metadata(path)
    if "tree" not in meta:
        raise ValueError(f"{path} was not written by save_pytree (no tree metadata)")
    tree = _unflatten(json.loads(meta["tree"]), read_safetensors(path))
    if like is None:
        return tree
    want: Dict[str, torch.Tensor] = {}
    _flatten(like, "", want)
    got: Dict[str, torch.Tensor] = {}
    _flatten(tree, "", got)
    if set(got) != set(want):
        raise ValueError(f"{path}: the tree's leaves differ from the expected ones: missing "
                         f"{sorted(set(want) - set(got))[:5]}, extra "
                         f"{sorted(set(got) - set(want))[:5]}")
    for name, t in want.items():
        if tuple(got[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(got[name].shape)}, expected "
                             f"{tuple(t.shape)}")
    return _unflatten(_flatten(like, "", {}), {k: got[k].to(v.dtype) for k, v in want.items()})
