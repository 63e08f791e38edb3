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
             "service.fixtures", "service.convert", "service.smoke", "audio.native",
             "llm", "llm.client", "apps", "apps.audio_to_text", "apps.tts_base",
             "apps.web_base", "apps.web_chat", "apps.web_storyteller", "apps.duplex",
             "training", "training.loss", "training.train_step", "training.lora",
             "training.data", "training.checkpoint", "training.finetune",
             "parallel", "parallel.mesh", "parallel.infer", "parallel.distributed",
             "parallel.autograd", "models.hybrid", "ops.moe"):
    assert "sesameai_tts_tpu_torch." + want in names, (want, names)
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 55, out.stdout  # every module of the slice was imported
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


def test_mesh_generator_defaults_to_its_rank_card():
    """On a mesh a bare "cuda" is this rank's card, cuda:<LOCAL_RANK>; a host
    without a card raises there as well, before the mesh is touched."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    with pytest.raises(RuntimeError, match="CUDA"):
        build_generator(test_tiny_spec(), mesh=object())


def test_finetune_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from sesameai_tts_tpu_torch.training.finetune import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data", str(tmp_path), "--flavor", "test-tiny"])


def test_attention_with_grad_takes_the_function(monkeypatch):
    """With grad enabled and q requiring grad, flash_attention goes through
    FlashAttentionFn whatever the device (here "meta" tensors and a stub
    forward stand in for the card's); without, the bare forward runs."""
    from sesameai_tts_tpu_torch.ops import attention as ta

    seen = []
    monkeypatch.setattr(ta, "_flash_attention_fwd",
                        lambda q, *a: seen.append(q.device.type) or torch.empty_like(q))
    q = torch.empty((1, 4, 3, 16), device="meta", requires_grad=True)
    k = v = torch.empty((1, 2, 3, 16), device="meta")
    pos0 = valid_end = torch.zeros(1, dtype=torch.int64, device="meta")
    out = ta.flash_attention(q, k, v, pos0, valid_end)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward" and seen == ["meta"]
    with torch.no_grad():
        assert ta.flash_attention(q, k, v, pos0, valid_end).grad_fn is None
    assert ta.flash_attention(q.detach(), k, v, pos0, valid_end).grad_fn is None
    assert len(seen) == 3


def test_quant_kernels_refuse_grad_on_the_card():
    """The check the three quant wrappers make on a CUDA tensor before they
    launch (tests/test_torch_kernels.py calls them on the card)."""
    from sesameai_tts_tpu_torch.ops import quant as tq

    x = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(TypeError, match="quant_mlp: the kernel has no gradient"):
        tq._refuse_grad("quant_mlp", x)
    with torch.no_grad():
        tq._refuse_grad("quant_mlp", x)
    tq._refuse_grad("quant_mlp", x.detach())


def test_fused_mlp_needs_int8_trunks():
    import dataclasses

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    for quantize in ("int4", None):
        spec = dataclasses.replace(test_tiny_spec(), quantize=quantize, fused_mlp=True)
        with pytest.raises(ValueError, match="fused_mlp"):
            build_generator(spec, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        build_generator(dataclasses.replace(test_tiny_spec(), quantize="int2"), device="cpu")
