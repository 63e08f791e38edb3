"""Model assembly (port of ``sesameai_tts_tpu/runtime/loader.py``): build
the CSM model, Mimi and the tokenizer and wrap them in a ``Generator``.

Weights come from local checkpoint files (``core/weights.py``) or, without
them, are random, drawn from ``spec.seed`` on the CPU and then moved, so
one seed gives the same weights on every device.  A loaded checkpoint is
read and cast on the host and moved to the device once.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi, MimiConfig, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import to_device
from sesameai_tts_tpu_torch.core.config import CSMConfig, csm_1b, csm_test_tiny
from sesameai_tts_tpu_torch.core.weights import load_csm_checkpoint, load_pytree
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.ops.quant import quantize_csm
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


def build_generator(spec: ModelSpec, device="cuda", **gen_kwargs) -> Generator:
    """The model of ``spec`` (from its checkpoints, else random from its
    seed) on ``device`` (the card unless the caller asks for the CPU) →
    its Generator."""
    device = resolve_device(device)
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
    gen = torch.Generator().manual_seed(spec.seed)
    if spec.csm_checkpoint:
        csm_params = load_csm_checkpoint(spec.csm_checkpoint, spec.csm, spec.dtype)
    else:
        csm_params = init_csm_params(spec.csm, gen, spec.dtype)
    csm_params = to_device(csm_params, device)
    if spec.quantize is not None:
        csm_params = quantize_csm(csm_params, bits=4 if spec.quantize == "int4" else 8)
    mimi = Mimi(spec.mimi)
    mimi_params = mimi.init(gen, spec.mimi_dtype)
    if spec.mimi_checkpoint:
        mimi_params = load_pytree(spec.mimi_checkpoint, like=mimi_params)
    mimi_params = to_device(mimi_params, device)
    tokenizer = load_text_tokenizer(spec.tokenizer)
    return Generator(csm_params, spec.csm, mimi, mimi_params, tokenizer, device=device,
                     fused_mlp=spec.fused_mlp, **gen_kwargs)


def load_csm_1b(csm_checkpoint: Optional[str] = None, mimi_checkpoint: Optional[str] = None,
                tokenizer: Optional[str] = None, device="cuda", **gen_kwargs) -> Generator:
    """Name-compatible entry point: the flagship spec from local files."""
    return build_generator(csm_1b_spec(csm_checkpoint, mimi_checkpoint, tokenizer),
                           device=device, **gen_kwargs)
