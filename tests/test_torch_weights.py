"""The port's checkpoint files (``core/weights.py``) against the JAX
package's: a JAX ``save_csm_checkpoint`` read by the port equals
``from_jax_params`` of the JAX load (f32 exact, bf16 bit-equal after the
same round-to-nearest cast) and the other way round; a bf16 file written
by ``safetensors.torch`` reads bit-equal through the port's own reader;
prefixes, sharded directories and ``.pt`` files load; a missing key or a
wrong shape raises; Mimi files in the transformers layout load as the JAX
loader loads them; ``save_pytree`` round-trips and an orbax directory
raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.codec.mimi import Mimi as JMimi
from sesameai_tts_tpu.codec.mimi import mimi_test_tiny as j_mimi_tiny
from sesameai_tts_tpu.core import weights as jw
from sesameai_tts_tpu.core.config import csm_test_tiny as j_csm_tiny
from sesameai_tts_tpu.models.csm import init_csm_params as j_init
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params, tree_map
from sesameai_tts_tpu_torch.core import weights
from sesameai_tts_tpu_torch.core.config import csm_test_tiny


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _assert_trees_equal(got, want):
    """Same structure, dtype, shape and bits."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    params = j_init(jax.random.PRNGKey(0), j_csm_tiny(), jnp.float32)
    path = str(tmp_path_factory.mktemp("csm") / "model.safetensors")
    jw.save_csm_checkpoint(path, params)
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_reads_jax_checkpoint(jax_ckpt, dtype):
    want = from_jax_params(jax.tree.map(np.asarray, jw.load_csm_checkpoint(
        jax_ckpt, j_csm_tiny(), getattr(jnp, dtype))))
    got = weights.load_csm_checkpoint(jax_ckpt, csm_test_tiny(), getattr(torch, dtype))
    _assert_trees_equal(got, want)


def test_jax_reads_port_checkpoint(tmp_path):
    params = from_jax_params(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3),
                                                             j_csm_tiny(), jnp.float32)))
    path = str(tmp_path / "port.safetensors")
    weights.save_csm_checkpoint(path, params)
    want = from_jax_params(jax.tree.map(np.asarray, jw.load_csm_checkpoint(
        path, j_csm_tiny(), jnp.float32)))
    _assert_trees_equal(want, params)
    _assert_trees_equal(weights.load_csm_checkpoint(path, csm_test_tiny(), torch.float32),
                        params)


def test_bf16_safetensors_file_reads_bit_equal(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    sd = {"a": torch.randn(3, 5, generator=g).bfloat16(),
          "b": torch.randn(7, generator=g), "c": torch.arange(6, dtype=torch.int8)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path)
    got = weights.read_safetensors(path)
    assert set(got) == set(sd)
    for k in sd:
        assert got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k])


def test_port_writer_reads_back_through_safetensors(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(1)
    base = torch.randn(4, 6, generator=g)
    sd = {"t": base.T, "bf": base.bfloat16(), "i": torch.arange(5)}  # a transposed view
    path = str(tmp_path / "y.safetensors")
    weights.write_safetensors(path, sd)
    got = load_file(path)
    for k in sd:
        assert torch.equal(got[k], sd[k].contiguous())


def test_prefixes_stripped_sharded_dir_merged_and_pt_loads(jax_ckpt, tmp_path):
    sd = weights.read_safetensors(jax_ckpt)
    want = weights.load_csm_checkpoint(jax_ckpt, csm_test_tiny(), torch.float32)
    # model. prefix and _orig_mod. inside, split over two shards of a dir
    keys = sorted(sd)
    shard_dir = tmp_path / "sharded"
    shard_dir.mkdir()
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        weights.write_safetensors(
            str(shard_dir / f"model-0000{i + 1}-of-00002.safetensors"),
            {f"model.{k.replace('.layers.', '._orig_mod.layers.', 1)}": sd[k] for k in part})
    _assert_trees_equal(
        weights.load_csm_checkpoint(str(shard_dir), csm_test_tiny(), torch.float32), want)
    pt_dir = tmp_path / "pt"
    pt_dir.mkdir()
    torch.save({"model": {f"_orig_mod.{k}": v for k, v in sd.items()}},
               str(pt_dir / "ckpt.pt"))
    _assert_trees_equal(weights.load_csm_checkpoint(str(pt_dir), csm_test_tiny(),
                                                    torch.float32), want)


def test_missing_key_or_wrong_shape_raises(jax_ckpt, tmp_path):
    sd = weights.read_safetensors(jax_ckpt)
    missing = dict(sd)
    del missing["decoder.layers.1.mlp.w2.weight"]
    weights.write_safetensors(str(tmp_path / "missing.safetensors"), missing)
    with pytest.raises(KeyError, match="decoder.layers.1.mlp.w2.weight"):
        weights.load_csm_checkpoint(str(tmp_path / "missing.safetensors"), csm_test_tiny())
    wrong = dict(sd)
    wrong["projection.weight"] = sd["projection.weight"].T.contiguous()
    weights.write_safetensors(str(tmp_path / "wrong.safetensors"), wrong)
    with pytest.raises(ValueError, match="projection.weight"):
        weights.load_csm_checkpoint(str(tmp_path / "wrong.safetensors"), csm_test_tiny())
    bigger = dataclasses.replace(csm_test_tiny(), text_vocab_size=999)
    with pytest.raises(ValueError, match="text_embeddings"):
        weights.load_csm_checkpoint(jax_ckpt, bigger)


def test_mimi_transformers_layout_equals_jax_load(tmp_path):
    from sesameai_tts_tpu.service.fixtures import write_mimi_checkpoint

    path = write_mimi_checkpoint(str(tmp_path / "mimi.safetensors"), flavor="test-tiny")
    want = from_jax_params(jax.tree.map(np.asarray, jw.load_mimi_checkpoint(
        path, JMimi(j_mimi_tiny()))))
    got = weights.load_mimi_checkpoint(path, Mimi(mimi_test_tiny()))
    _assert_trees_equal(got, want)


def test_pytree_roundtrip_and_like(tmp_path):
    mimi = Mimi(mimi_test_tiny())
    tree = mimi.init(torch.Generator().manual_seed(0), torch.bfloat16)
    path = str(tmp_path / "mimi.safetensors")
    weights.save_pytree(path, tree)
    _assert_trees_equal(weights.load_pytree(path), tree)
    like = mimi.init(torch.Generator().manual_seed(1), torch.float32)
    got = weights.load_pytree(path, like=like)
    _assert_trees_equal(got, tree_map(lambda t: t.float(), tree))
    with pytest.raises(ValueError, match="differ"):
        weights.load_pytree(path, like={"encoder": like["encoder"]})
    assert len(_leaves(tree)) > 20


def test_orbax_directory_raises(tmp_path):
    jw.save_pytree(str(tmp_path / "orbax"), {"a": jnp.ones((2,))})
    for load in (lambda p: weights.load_pytree(p),
                 lambda p: weights.load_csm_checkpoint(p, csm_test_tiny()),
                 lambda p: weights.load_mimi_checkpoint(p, Mimi(mimi_test_tiny()))):
        with pytest.raises(ValueError, match="orbax"):
            load(str(tmp_path / "orbax"))
