"""sesameai_tts_tpu_torch — the PyTorch/CUDA port of ``sesameai_tts_tpu``.

Same module names and public functions as the JAX package, in PyTorch
idiom: plain functions over dictionaries of tensors, an explicit
``device``, explicit ``torch.Generator``s, and KV caches written in place.
The int8 dequant-matmul that the JAX package runs as a Pallas kernel is a
hand-written CUDA kernel here (``csrc/quant_matmul.cu``), built with
``nvcc`` at first use.

Entry point::

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    gen = build_generator(csm_1b_spec(), device="cuda")
"""

__version__ = "0.1.0"
