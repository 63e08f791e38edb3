"""Model assembly (port of ``sesameai_tts_tpu/runtime/loader.py``): build
the CSM model, Mimi and the tokenizer and wrap them in a ``Generator``.

Weights come from local checkpoint files (``core/weights.py``) or, without
them, are random, drawn from ``spec.seed`` on the CPU and then moved, so
one seed gives the same weights on every device.  The CSM params and Mimi
draw from generators of their own (``init_models``), so the random codec
does not depend on whether a CSM checkpoint was given.  A loaded
checkpoint is read and cast on the host and moved to the device once.

On a mesh (``build_generator(mesh=)``, ``parallel/``) every rank draws or
reads the same full tree on the host and quantizes it on its device one
layer at a time, as one card does (the card's rounding of the scales is
not the host's, and the tp model must be the single-card model), bringing
each quantized layer back to the host; the Generator then cuts this rank's
shards on the host and moves only those to the card.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi, MimiConfig, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import to_device
from sesameai_tts_tpu_torch.core.config import (
    CSMConfig,
    csm_1b,
    csm_lfm2_8b_a1b,
    csm_test_tiny,
    csm_test_tiny_hybrid,
)
from sesameai_tts_tpu_torch.core.weights import load_csm_checkpoint, load_pytree
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.ops.quant import quantize_csm, quantize_trunk
from sesameai_tts_tpu_torch.runtime.generator import Generator, resolve_device
from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer

log = logging.getLogger(__name__)


@dataclass
class ModelSpec:
    """One typed config for model assembly."""

    csm: CSMConfig
    mimi: MimiConfig
    tokenizer: str  # 'byte' | 'tiny' | local tokenizer.json path or model dir
    csm_checkpoint: Optional[str] = None  # None → random init
    mimi_checkpoint: Optional[str] = None  # a save_pytree file; None → random init
    dtype: torch.dtype = torch.bfloat16
    mimi_dtype: torch.dtype = torch.float32  # codec params/activations
    seed: int = 0
    quantize: Optional[str] = None  # None | 'int8' | 'int4' (weight-only trunks)
    # int8 only: each decode-time MLP runs as one fused quant_mlp launch
    fused_mlp: bool = False


def resolve_tokenizer(tokenizer: Optional[str], csm_checkpoint: Optional[str]) -> str:
    """``None`` = infer: a checkpoint directory (or the directory of a
    checkpoint file) holding ``tokenizer.json`` supplies it; without one
    the byte tokenizer.  An explicit value always wins."""
    if tokenizer is not None:
        return tokenizer
    if csm_checkpoint:
        d = csm_checkpoint if os.path.isdir(csm_checkpoint) else os.path.dirname(csm_checkpoint)
        tj = os.path.join(d, "tokenizer.json")
        if os.path.isfile(tj):
            log.info("tokenizer auto-inferred from checkpoint layout: %s", tj)
            return tj
    return "byte"


def csm_1b_spec(csm_checkpoint: Optional[str] = None, mimi_checkpoint: Optional[str] = None,
                tokenizer: Optional[str] = None, quantize: Optional[str] = "int8", *,
                fused_mlp: bool = False) -> ModelSpec:
    """Flagship spec: int8 weight-only trunks by default (``quantize="int4"``
    halves the trunk bytes again, ``None`` is pure bf16), a bf16 Mimi, and
    ``fused_mlp=True`` for the fused int8 MLP.  ``tokenizer=None`` infers
    it from the checkpoint's directory (``resolve_tokenizer``)."""
    return ModelSpec(csm=csm_1b(), mimi=MimiConfig(),
                     tokenizer=resolve_tokenizer(tokenizer, csm_checkpoint),
                     csm_checkpoint=csm_checkpoint, mimi_checkpoint=mimi_checkpoint,
                     quantize=quantize, mimi_dtype=torch.bfloat16, fused_mlp=fused_mlp)


def test_tiny_spec() -> ModelSpec:
    return ModelSpec(csm=csm_test_tiny(), mimi=mimi_test_tiny(), tokenizer="tiny",
                     dtype=torch.float32)


def csm_lfm2_8b_a1b_spec(quantize: Optional[str] = "int8") -> ModelSpec:
    """LFM2-8B-A1B's trunk as CSM's backbone (``core/config.py::
    csm_lfm2_8b_a1b``), int8 (the experts have no int4 kernel), random
    weights, the byte tokenizer and a bf16 Mimi."""
    return ModelSpec(csm=csm_lfm2_8b_a1b(), mimi=MimiConfig(), tokenizer="byte",
                     quantize=quantize, mimi_dtype=torch.bfloat16)


def test_tiny_hybrid_spec() -> ModelSpec:
    """The tiny hybrid backbone (conv, conv, attention, conv; routed FFNs)
    under the tiny decoder and Mimi."""
    return ModelSpec(csm=csm_test_tiny_hybrid(), mimi=mimi_test_tiny(), tokenizer="tiny",
                     dtype=torch.float32)


def mimi_seed(seed: int) -> int:
    """The seed of the random Mimi params of a spec seeded ``seed``: a fixed
    function of it, apart from the CSM params' stream."""
    return int(np.random.SeedSequence([seed % 2**64, 0x4D494D49]).generate_state(1, np.uint64)[0])


def init_models(spec: ModelSpec, dtype: Optional[torch.dtype] = None):
    """(CSM params, Mimi, Mimi params) on the host: each from its checkpoint,
    else random.  The CSM params (at ``dtype``, default ``spec.dtype``) draw
    from ``torch.Generator().manual_seed(spec.seed)``, Mimi (at
    ``spec.mimi_dtype``) from a generator seeded ``mimi_seed(spec.seed)``,
    as the JAX loader splits its key into a CSM key and a Mimi key."""
    return (init_csm(spec, dtype), *init_mimi(spec))


def init_csm(spec: ModelSpec, dtype: Optional[torch.dtype] = None) -> dict:
    """The CSM params on the host, as ``init_models`` makes them."""
    dtype = dtype or spec.dtype
    if spec.csm_checkpoint:
        return load_csm_checkpoint(spec.csm_checkpoint, spec.csm, dtype)
    return init_csm_params(spec.csm, torch.Generator().manual_seed(spec.seed), dtype)


def init_mimi(spec: ModelSpec):
    """(Mimi, Mimi params) on the host, as ``init_models`` makes them."""
    mimi = Mimi(spec.mimi)
    mimi_params = mimi.init(torch.Generator().manual_seed(mimi_seed(spec.seed)),
                            spec.mimi_dtype)
    if spec.mimi_checkpoint:
        mimi_params = load_pytree(spec.mimi_checkpoint, like=mimi_params)
    return mimi, mimi_params


def rank_device(device):
    """A rank's card: ``cuda:<LOCAL_RANK>`` for a bare ``"cuda"`` (one process
    per card), else the device the caller gave (ranks sharing one card)."""
    if str(device) == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def _quantize_through(params: dict, bits: int, device) -> dict:
    """``quantize_csm`` of a host tree with each trunk layer quantized on
    ``device`` (its rounding) and brought back, so that no more than one
    layer is on the device at a time → the quantized tree on the host."""
    out = dict(params)
    for name in ("backbone", "decoder"):
        layers = []
        for wl in params[name]["layers"]:
            one = quantize_trunk({"layers": (to_device(wl, device),), "final_norm": None}, bits)
            layers.append(to_device(one["layers"][0], "cpu"))
        out[name] = {"layers": tuple(layers), "final_norm": params[name]["final_norm"]}
    return out


def build_generator(spec: ModelSpec, device="cuda", mesh=None, **gen_kwargs) -> Generator:
    """The model of ``spec`` (from its checkpoints, else random from its
    seed) on ``device`` (the card unless the caller asks for the CPU) →
    its Generator.  With ``mesh`` (``parallel/mesh.py::make_mesh``) the
    Generator runs tensor- and data-parallel on it, and this rank's device
    is ``cuda:<LOCAL_RANK>`` unless ``device`` names one."""
    device = resolve_device(device) if mesh is None else rank_device(device)
    if spec.quantize not in (None, "int8", "int4"):
        raise ValueError(f"quantize={spec.quantize!r}: use None, 'int8' or 'int4'")
    if spec.fused_mlp and spec.quantize != "int8":
        raise ValueError(f"fused_mlp=True needs quantize='int8', not {spec.quantize!r}")
    if spec.mimi.num_codebooks != spec.csm.audio_num_codebooks:
        raise ValueError("Mimi and CSM disagree on the number of codebooks")
    if (spec.csm_checkpoint and spec.tokenizer in ("byte", "tiny")
            and spec.csm.text_vocab_size > 10_000):
        # real weights expect Llama-3 128k-vocab ids; the 258-id byte
        # tokenizer would silently give garbage audio.  Small-vocab configs
        # (test flavors, exports trained from scratch) may pair a checkpoint
        # with the test tokenizers they were trained on.
        raise ValueError(
            "csm_checkpoint is set but tokenizer is the test "
            f"'{spec.tokenizer}' tokenizer. Pass tokenizer=<path to the "
            "Llama-3 tokenizer.json> when loading real CSM-1B weights."
        )
    csm_params, mimi, mimi_params = init_models(spec)
    bits = {None: None, "int8": 8, "int4": 4}[spec.quantize]
    if mesh is not None:  # the Generator moves only this rank's shards
        if bits is not None:
            csm_params = _quantize_through(csm_params, bits, device)
    else:
        csm_params = to_device(csm_params, device)
        if bits is not None:
            csm_params = quantize_csm(csm_params, bits=bits)
    mimi_params = to_device(mimi_params, device)
    tokenizer = load_text_tokenizer(spec.tokenizer)
    return Generator(csm_params, spec.csm, mimi, mimi_params, tokenizer, device=device,
                     fused_mlp=spec.fused_mlp, mesh=mesh, **gen_kwargs)


def load_csm_1b(csm_checkpoint: Optional[str] = None, mimi_checkpoint: Optional[str] = None,
                tokenizer: Optional[str] = None, device="cuda", **gen_kwargs) -> Generator:
    """Name-compatible entry point: the flagship spec from local files."""
    return build_generator(csm_1b_spec(csm_checkpoint, mimi_checkpoint, tokenizer),
                           device=device, **gen_kwargs)
