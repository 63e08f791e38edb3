"""The port stands alone: importing every module of
``sesameai_tts_tpu_torch`` loads neither ``jax`` nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import sesameai_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in pkg._LAZY:  # the lazy top-level exports resolve
    getattr(pkg, name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "sesameai_tts_tpu" or k.startswith("sesameai_tts_tpu."))
for want in ("runtime.qa", "ops.kernels", "ops.attention", "audio.io", "audio.resample",
             "service.voices", "service.tts", "runtime.context", "runtime.graphs",
             "core.weights", "runtime.loader", "tokenizer.native_bpe", "tokenizer.text",
             "utils.text", "utils.profiling", "audio.segment", "watermark", "watermark.dsp",
             "watermark.api", "runtime.streaming", "service.cli"):
    assert "sesameai_tts_tpu_torch." + want in names, (want, names)
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 36, out.stdout  # every module of the slice was imported
    assert bad.strip() == "[]", bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from sesameai_tts_tpu_torch.runtime.generator import resolve_device
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    with pytest.raises(RuntimeError, match="CUDA"):
        build_generator(test_tiny_spec())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_fused_mlp_needs_int8_trunks():
    import dataclasses

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    for quantize in ("int4", None):
        spec = dataclasses.replace(test_tiny_spec(), quantize=quantize, fused_mlp=True)
        with pytest.raises(ValueError, match="fused_mlp"):
            build_generator(spec, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        build_generator(dataclasses.replace(test_tiny_spec(), quantize="int2"), device="cpu")
