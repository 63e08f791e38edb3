"""Model assembly (port of ``sesameai_tts_tpu/runtime/loader.py``): build
the CSM model, Mimi and the tokenizer and wrap them in a ``Generator``.

Weights are random, drawn from ``spec.seed`` on the CPU and then moved,
so one seed gives the same weights on every device.  Loading real
checkpoints is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi, MimiConfig, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import to_device
from sesameai_tts_tpu_torch.core.config import CSMConfig, csm_1b, csm_test_tiny
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.ops.quant import quantize_csm
from sesameai_tts_tpu_torch.runtime.generator import Generator, resolve_device
from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer


@dataclass
class ModelSpec:
    """One typed config for model assembly."""

    csm: CSMConfig
    mimi: MimiConfig
    tokenizer: str  # 'byte' | 'tiny'
    dtype: torch.dtype = torch.bfloat16
    mimi_dtype: torch.dtype = torch.float32  # codec params/activations
    seed: int = 0
    quantize: Optional[str] = None  # None | 'int8' | 'int4' (weight-only trunks)
    # int8 only: each decode-time MLP runs as one fused quant_mlp launch
    fused_mlp: bool = False


def csm_1b_spec(tokenizer: str = "byte", quantize: Optional[str] = "int8",
                fused_mlp: bool = False) -> ModelSpec:
    """Flagship spec: int8 weight-only trunks by default (``quantize="int4"``
    halves the trunk bytes again, ``None`` is pure bf16), a bf16 Mimi, and
    ``fused_mlp=True`` for the fused int8 MLP."""
    return ModelSpec(csm=csm_1b(), mimi=MimiConfig(), tokenizer=tokenizer,
                     quantize=quantize, mimi_dtype=torch.bfloat16, fused_mlp=fused_mlp)


def test_tiny_spec() -> ModelSpec:
    return ModelSpec(csm=csm_test_tiny(), mimi=mimi_test_tiny(), tokenizer="tiny",
                     dtype=torch.float32)


def build_generator(spec: ModelSpec, device="cuda", **gen_kwargs) -> Generator:
    """Random-init the model of ``spec`` on ``device`` (the card unless the
    caller asks for the CPU) and return its Generator."""
    device = resolve_device(device)
    if spec.quantize not in (None, "int8", "int4"):
        raise ValueError(f"quantize={spec.quantize!r}: use None, 'int8' or 'int4'")
    if spec.fused_mlp and spec.quantize != "int8":
        raise ValueError(f"fused_mlp=True needs quantize='int8', not {spec.quantize!r}")
    if spec.mimi.num_codebooks != spec.csm.audio_num_codebooks:
        raise ValueError("Mimi and CSM disagree on the number of codebooks")
    gen = torch.Generator().manual_seed(spec.seed)
    csm_params = to_device(init_csm_params(spec.csm, gen, spec.dtype), device)
    if spec.quantize is not None:
        csm_params = quantize_csm(csm_params, bits=4 if spec.quantize == "int4" else 8)
    mimi = Mimi(spec.mimi)
    mimi_params = to_device(mimi.init(gen, spec.mimi_dtype), device)
    tokenizer = load_text_tokenizer(spec.tokenizer)
    return Generator(csm_params, spec.csm, mimi, mimi_params, tokenizer, device=device,
                     fused_mlp=spec.fused_mlp, **gen_kwargs)
