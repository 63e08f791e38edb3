"""The model family ``csm``: Sesame's CSM, a Llama-3.2-shaped backbone
and codebook decoder over CSM's frame rows (``configs/csm-*.json``).

A thin adapter over the shared code: the weights of
``harness/weights.py``, the port's configurations of
``harness/system.py`` and its ``quantize_csm``, the plain reference of
``reference/csm.py`` and the work counts of ``harness/work.py``.
"""

from benchmark.harness import system, weights, work
from benchmark.reference import csm as ref_csm

quant_work = work.quant_work
attention_work = work.attention_work
prefill_attention_work = work.prefill_attention_work
frame_flops = work.frame_flops
prefill_flops = work.prefill_flops


def draw(config: dict, seed: int, device) -> dict:
    """The program's weight tree, drawn from ``seed`` on ``device``."""
    return weights.draw_csm(config, seed, device)


def port(config: dict, name: str):
    """The port's (CSMConfig, MimiConfig) for its ``Generator``."""
    return system.port_configs(config, name)


def quantize(params: dict, bits: int) -> dict:
    """The tree as the program quantizes it (``bits`` 8 or 4)."""
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm

    return quantize_csm(params, bits=bits)


def reference(params: dict, config: dict, bits=None) -> ref_csm.CSM:
    """The plain reference over ``params`` (``bits``: another width than
    the configuration's, for a control)."""
    return ref_csm.CSM(params, config, bits=bits)
