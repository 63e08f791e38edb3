"""The port stands alone: importing every module of
``sesameai_tts_tpu_torch`` loads neither ``jax`` nor the JAX package, the
fixtures need neither ``tokenizers`` nor ``transformers``, the lazy
top-level exports are the JAX package's, and its entry points run on the
card unless the caller asks for the CPU."""

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
             "watermark.api", "runtime.streaming", "service.cli", "runtime.serving",
             "service.http_api", "service.prewarm", "watermark.stream", "watermark.net",
             "service.fixtures", "service.convert", "service.smoke"):
    assert "sesameai_tts_tpu_torch." + want in names, (want, names)
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 40, out.stdout  # every module of the slice was imported
    assert bad.strip() == "[]", bad


# tokenizers / transformers made unimportable: the fixtures write every
# upstream layout (the Llama-3 tokenizer.json, the transformers Mimi file)
# from the port's own code
_FIXTURES_PROBE = """
import sys, tempfile
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tokenizers", "transformers"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
from sesameai_tts_tpu_torch.service import fixtures
paths = fixtures.write_synthetic_weights(tempfile.mkdtemp(), "test-tiny")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sesameai_tts_tpu", "tokenizers",
                                    "transformers"))
print(sorted(paths), bad)
"""


def test_fixtures_need_neither_tokenizers_nor_transformers():
    out = subprocess.run([sys.executable, "-c", _FIXTURES_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
    assert "'silentcipher'" in out.stdout and "'mimi'" in out.stdout


# deliberate differences between the two packages' lazy exports (none)
_LAZY_ONLY_JAX: set = set()
_LAZY_ONLY_PORT: set = set()


def test_lazy_exports_match_the_jax_package():
    import sesameai_tts_tpu
    import sesameai_tts_tpu_torch

    ours, theirs = set(sesameai_tts_tpu_torch._LAZY), set(sesameai_tts_tpu._LAZY)
    assert theirs - ours == _LAZY_ONLY_JAX
    assert ours - theirs == _LAZY_ONLY_PORT
    for name in ours & theirs:  # the same module and attribute, in the port
        mod, attr = sesameai_tts_tpu_torch._LAZY[name]
        assert (mod.replace("sesameai_tts_tpu_torch", "sesameai_tts_tpu"), attr) \
            == sesameai_tts_tpu._LAZY[name]
    from sesameai_tts_tpu_torch import BatchedTTSServer
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer as direct

    assert BatchedTTSServer is direct


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
