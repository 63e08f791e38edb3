"""The port's loader draws its random codec from a generator of its own: the
Mimi params do not depend on whether a CSM checkpoint was given, and the
finetune CLI's draws (``init_csm``, ``init_mimi``) are ``build_generator``'s
(the JAX loader splits ``PRNGKey(seed)`` into a CSM key and a Mimi key);
the CSM random init is still ``torch.Generator().manual_seed(seed)``."""

import dataclasses
import os

import pytest
import torch

from sesameai_tts_tpu_torch.convert import tree_leaves
from sesameai_tts_tpu_torch.core.weights import save_csm_checkpoint
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.runtime import loader
from sesameai_tts_tpu_torch.runtime.loader import build_generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_codec_does_not_depend_on_the_csm_checkpoint(tmp_path, seed):
    spec = dataclasses.replace(tiny_spec(), seed=seed)
    gen = build_generator(spec, device="cpu")
    path = os.path.join(tmp_path, "csm.safetensors")
    save_csm_checkpoint(path, gen._params)
    from_ckpt = build_generator(dataclasses.replace(spec, csm_checkpoint=path), device="cpu")
    _assert_trees_equal(from_ckpt._params, gen._params)  # f32 tiny: the round trip is exact
    _assert_trees_equal(from_ckpt._mimi_params, gen._mimi_params)


def test_init_models_draws_the_generators_codec_and_csm_init():
    spec = tiny_spec()
    gen = build_generator(spec, device="cpu")
    params, (mimi, mimi_params) = loader.init_csm(spec, torch.float32), loader.init_mimi(spec)
    _assert_trees_equal(params, loader.init_models(spec, torch.float32)[0])
    _assert_trees_equal(mimi_params, gen._mimi_params)
    _assert_trees_equal(params, gen._params)
    # the CSM random init is the seed's own generator, as before the codec's split
    _assert_trees_equal(params, init_csm_params(spec.csm, torch.Generator().manual_seed(0),
                                                torch.float32))
    # the codec's seed is a fixed function of the spec's seed, apart from it
    assert loader.mimi_seed(0) == loader.mimi_seed(0) != loader.mimi_seed(1)
    assert loader.mimi_seed(0) != 0


@pytest.mark.parametrize("bits", [8, 4])
def test_mesh_build_quantizes_layer_by_layer_as_the_whole_tree(bits):
    """On a mesh the loader quantizes one trunk layer at a time on the
    rank's device and keeps the result on the host: the same tree, leaf by
    leaf, as ``quantize_csm`` of the whole tree (its single-card path)."""
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm

    params = init_csm_params(tiny_spec().csm, torch.Generator().manual_seed(0), torch.float32)
    got = loader._quantize_through(params, bits, "cpu")
    _assert_trees_equal(got, quantize_csm(params, bits=bits))
    assert all(x.device.type == "cpu" for x in tree_leaves(got))
