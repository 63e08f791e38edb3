"""``sesame-tts-torch-convert`` (``service/convert.py``), as
``tests/test_convert_cli.py`` holds the JAX package's: each family's output
loads through the port's consumer (``ModelSpec`` / ``build_generator`` and
``load_watermarker``), equal to what the JAX package converts from the same
source; a missing source exits 2; the default device is the card."""

import os

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.convert import tree_map
from sesameai_tts_tpu_torch.core import weights
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.runtime.loader import build_generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.service.convert import main as convert_main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _csm_src(tmp_path, seed=0):
    params = init_csm_params(csm_test_tiny(), torch.Generator().manual_seed(seed), torch.float32)
    src = str(tmp_path / "csm.safetensors")
    weights.save_csm_checkpoint(src, params)
    return params, src


def test_convert_csm_cli(tmp_path, capsys):
    params, src = _csm_src(tmp_path)
    dst = str(tmp_path / "csm_dir")
    assert convert_main(["csm", src, dst, "--flavor", "test-tiny", "--dtype", "float32",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "round trip identical" in out and "wrote safetensors" in out
    loaded = weights.load_csm_checkpoint(dst, csm_test_tiny(), torch.float32)
    a, b = _flat(params), _flat(loaded)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_convert_csm_output_loads_via_modelspec_path(tmp_path):
    """The csm output directory is what ``ModelSpec.csm_checkpoint`` takes,
    and the JAX package's loader reads it too."""
    import jax.numpy as jnp

    from sesameai_tts_tpu.core.config import csm_test_tiny as j_csm_test_tiny
    from sesameai_tts_tpu.core.weights import load_csm_checkpoint as j_load

    params, src = _csm_src(tmp_path, seed=1)
    dst = str(tmp_path / "csm_dir")
    assert convert_main(["csm", src, dst, "--flavor", "test-tiny", "--dtype", "float32",
                         "--device", "cpu", "--no-verify"]) == 0
    spec = tiny_spec()
    spec.csm_checkpoint = dst
    gen = build_generator(spec, device="cpu")
    np.testing.assert_array_equal(gen._params["text_embeddings"].numpy(),
                                  params["text_embeddings"].numpy())
    jp = j_load(dst, j_csm_test_tiny(), jnp.float32)
    np.testing.assert_array_equal(np.asarray(jp["projection"]), params["projection"].numpy())


def test_convert_mimi_cli(tmp_path, capsys):
    """A transformers-layout Mimi file (the fixtures') and a moshi-layout one
    → a save_pytree file that ``ModelSpec.mimi_checkpoint`` loads."""
    from safetensors.numpy import save_file

    from sesameai_tts_tpu.codec.mimi import Mimi as JMimi
    from sesameai_tts_tpu.codec.mimi import mimi_test_tiny as j_mimi_test_tiny
    from sesameai_tts_tpu_torch.service.fixtures import write_mimi_checkpoint
    from test_mimi_loader import _synthetic_moshi_sd

    hf_src = write_mimi_checkpoint(str(tmp_path / "mimi_hf.safetensors"), "test-tiny", seed=2)
    moshi_src = str(tmp_path / "mimi_moshi.safetensors")
    save_file(_synthetic_moshi_sd(JMimi(j_mimi_test_tiny()), np.random.default_rng(0)),
              moshi_src)
    for src in (hf_src, moshi_src):
        dst = str(tmp_path / (os.path.basename(src) + ".converted"))
        assert convert_main(["mimi", src, dst, "--flavor", "test-tiny", "--dtype", "float32",
                             "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "encode→decode ok" in out and "wrote save_pytree" in out
        spec = tiny_spec()
        spec.mimi_checkpoint = dst
        gen = build_generator(spec, device="cpu")
        want = weights.load_mimi_checkpoint(src, gen._mimi)
        a, b = _flat(want), _flat(gen._mimi_params)
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_convert_silentcipher_cli(tmp_path, capsys):
    from sesameai_tts_tpu.watermark.net import load_silentcipher_checkpoint as j_load
    from sesameai_tts_tpu.watermark.net import silentcipher_test_tiny
    from sesameai_tts_tpu_torch.watermark.api import load_watermarker
    from sesameai_tts_tpu_torch.watermark.net import NetWatermarker
    from test_silentcipher import _build_torch_modules, _ckpt_dict, _hparams

    cfg = silentcipher_test_tiny()
    src = str(tmp_path / "sc.pt")
    torch.save(_ckpt_dict(*_build_torch_modules(cfg), _hparams(cfg)), src)
    dst = str(tmp_path / "sc.safetensors")
    assert convert_main(["silentcipher", src, dst, "--dtype", "float32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "encode_wav ok" in out and "wrote save_pytree" in out
    assert os.path.exists(dst + ".config.json")

    model = load_watermarker(ckpt_path=dst, device="cpu")  # the documented consumer
    assert isinstance(model, NetWatermarker)
    assert (model.cfg.n_fft, model.cfg.hop) == (cfg.n_fft, cfg.hop)
    y, _ = model.encode_wav(np.zeros(44_100, np.float32), 44_100, [1, 2, 3, 4, 5])
    assert y.shape == (44_100,)
    x = (np.random.default_rng(0).normal(size=4410) * 0.1).astype(np.float32)
    ours, _ = model.encode_wav(x, 44_100, [1, 2, 3, 4, 5])
    theirs, _ = j_load(src).encode_wav(x, 44_100, [1, 2, 3, 4, 5])
    np.testing.assert_allclose(ours - x, theirs - x, atol=1e-4 * np.abs(theirs - x).max())
    # --dtype bfloat16 keeps the network in f32, and says so
    assert convert_main(["silentcipher", src, str(tmp_path / "b.safetensors"),
                         "--device", "cpu"]) == 0
    assert "--dtype ignored" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["csm", "mimi", "silentcipher"])
def test_convert_missing_file(tmp_path, family):
    rc = convert_main([family, str(tmp_path / "nope.safetensors"), str(tmp_path / "out"),
                       "--device", "cpu", "--flavor", "test-tiny"])
    assert rc == 2


def test_convert_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, src = _csm_src(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_main(["csm", src, str(tmp_path / "out"), "--flavor", "test-tiny"])
