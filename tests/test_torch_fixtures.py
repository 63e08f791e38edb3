"""The port's synthetic upstream artefacts (``service/fixtures.py``) against
the JAX package's writers, at the tiny flavor.

Each file the port writes has the JAX writer's keys, shapes and dtypes (the
JAX writer trains its tokenizer with ``tokenizers`` and builds its Mimi
file with ``transformers``' ``MimiModel``; the port uses neither), loads
through both packages' loaders, and the JAX writer's files load through the
port's loaders to the JAX loaders' values; the transformers ``MimiModel``
takes the port's Mimi file with ``strict=True``; the marker is the JAX
package's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.codec.mimi import Mimi as JMimi
from sesameai_tts_tpu.core import weights as j_weights
from sesameai_tts_tpu.service import fixtures as j_fixtures
from sesameai_tts_tpu.tokenizer.text import load_text_tokenizer as j_load_tokenizer
from sesameai_tts_tpu.watermark import net as j_net
from sesameai_tts_tpu_torch.codec.mimi import Mimi
from sesameai_tts_tpu_torch.convert import tree_map
from sesameai_tts_tpu_torch.core import weights
from sesameai_tts_tpu_torch.service import fixtures
from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer
from sesameai_tts_tpu_torch.watermark import net


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"port": paths, "jax": paths} of both writers' tiny artefacts."""
    root = tmp_path_factory.mktemp("fixtures")
    return {"port": fixtures.write_synthetic_weights(str(root / "port"), "test-tiny", seed=0),
            "jax": j_fixtures.write_synthetic_weights(str(root / "jax"), "test-tiny", seed=0)}


def _leaves(tree) -> list:
    """Leaves as numpy arrays, dicts in key order (the order jax.tree uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    return [tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)]


def _layout(sd: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in sd.items()}


def test_paths_and_marker_match_the_jax_writer(dirs):
    assert set(dirs["port"]) == set(dirs["jax"])
    for k in dirs["port"]:
        assert os.path.relpath(dirs["port"][k], os.path.dirname(dirs["port"]["marker"])) == \
            os.path.relpath(dirs["jax"][k], os.path.dirname(dirs["jax"]["marker"]))
    with open(dirs["port"]["marker"]) as f, open(dirs["jax"]["marker"]) as g:
        assert json.load(f) == json.load(g)


def test_configs_match_the_jax_fixture_configs():
    import dataclasses

    for flavor in ("csm-1b", "test-tiny"):
        ours, theirs = fixtures.fixture_csm_config(flavor), j_fixtures.fixture_csm_config(flavor)
        assert ours.text_vocab_size == theirs.text_vocab_size
        assert ours.audio_num_codebooks == theirs.audio_num_codebooks
        assert ours.backbone.embed_dim == theirs.backbone.embed_dim
        assert ours.backbone.num_layers == theirs.backbone.num_layers
        assert dataclasses.asdict(fixtures.fixture_mimi_config(flavor))["num_codebooks"] == \
            dataclasses.asdict(j_fixtures.fixture_mimi_config(flavor))["num_codebooks"]


def test_tokenizer_json_format_and_both_loaders(dirs):
    with open(dirs["port"]["tokenizer"]) as f, open(dirs["jax"]["tokenizer"]) as g:
        ours, theirs = json.load(f), json.load(g)
    assert set(ours) == set(theirs)
    for key in ("pre_tokenizer", "decoder", "normalizer", "post_processor", "added_tokens"):
        assert ours[key] == theirs[key], key
    assert {k for k in ours["model"] if k not in ("vocab", "merges")} == \
        {k for k in theirs["model"] if k not in ("vocab", "merges")}
    assert ours["model"]["type"] == "BPE"
    ids = sorted(ours["model"]["vocab"].values())
    assert ids == list(range(400)) and max(theirs["model"]["vocab"].values()) < 400
    cfg = fixtures.fixture_csm_config("test-tiny")
    text = "The quick brown fox jumps over 12345 lazy dogs!"
    a = load_text_tokenizer(dirs["port"]["tokenizer"]).encode(text)
    b = j_load_tokenizer(dirs["port"]["tokenizer"]).encode(text)
    assert a == b and max(a) < cfg.text_vocab_size
    assert load_text_tokenizer(dirs["jax"]["tokenizer"]).encode(text) == \
        j_load_tokenizer(dirs["jax"]["tokenizer"]).encode(text)


def test_csm_checkpoint_layout_and_both_loaders(dirs):
    ours = weights.read_safetensors(os.path.join(dirs["port"]["csm_dir"], "model.safetensors"))
    theirs = weights.read_safetensors(os.path.join(dirs["jax"]["csm_dir"], "model.safetensors"))
    assert _layout(ours) == _layout(theirs)
    cfg = fixtures.fixture_csm_config("test-tiny")
    jcfg = j_fixtures.fixture_csm_config("test-tiny")
    for d in (dirs["port"]["csm_dir"], dirs["jax"]["csm_dir"]):
        p = weights.load_csm_checkpoint(d, cfg, torch.float32)
        jp = j_weights.load_csm_checkpoint(d, jcfg, jnp.float32)
        np.testing.assert_array_equal(p["text_embeddings"].numpy(),
                                      np.asarray(jp["text_embeddings"]))
        np.testing.assert_array_equal(p["backbone"]["layers"][1]["qkv"].numpy(),
                                      np.asarray(jp["backbone"]["layers"]["qkv"][1]))
        np.testing.assert_array_equal(p["audio_head"].numpy(), np.asarray(jp["audio_head"]))


def test_mimi_checkpoint_layout_and_both_loaders(dirs):
    from transformers.models.mimi import MimiConfig, MimiModel

    ours = weights.read_safetensors(dirs["port"]["mimi"])
    theirs = weights.read_safetensors(dirs["jax"]["mimi"])
    assert _layout(ours) == _layout(theirs)
    # the transformers model itself takes the port's file, every key
    hf = MimiModel(MimiConfig(
        audio_channels=1, num_filters=4, upsampling_ratios=[4, 3, 2], hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=64, codebook_size=32, codebook_dim=16, num_quantizers=8,
        num_semantic_quantizers=1, sliding_window=16, vector_quantization_hidden_dimension=16,
        upsample_groups=32, frame_rate=500, sampling_rate=24_000, use_cache=False))
    hf.load_state_dict(ours, strict=True)

    mimi = Mimi(fixtures.fixture_mimi_config("test-tiny"))
    jmimi = JMimi(j_fixtures.fixture_mimi_config("test-tiny"))
    # the port's file loads back to the parameters it was written from
    want = mimi.init(torch.Generator().manual_seed(0), torch.float32)
    got = weights.load_mimi_checkpoint(dirs["port"]["mimi"], mimi)
    a, b = [], []
    tree_map(a.append, want)
    tree_map(b.append, got)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    # each file through both loaders gives the same tree
    for path in (dirs["port"]["mimi"], dirs["jax"]["mimi"]):
        p = weights.load_mimi_checkpoint(path, mimi)
        jp = j_weights.load_mimi_checkpoint(path, jmimi)
        assert [v.shape for v in _leaves(p)] == [v.shape for v in _leaves(jp)]
        np.testing.assert_array_equal(
            p["quantizer"]["acoustic"]["codebooks"].numpy(),
            np.asarray(jp["quantizer"]["acoustic"]["codebooks"]))
        np.testing.assert_array_equal(p["decoder"][2]["w"].numpy(),
                                      np.asarray(jp["decoder"][2]["w"]))


def test_silentcipher_checkpoint_layout_and_both_loaders(dirs):
    ours = torch.load(dirs["port"]["silentcipher"], weights_only=True)
    theirs = torch.load(dirs["jax"]["silentcipher"], weights_only=True)
    assert set(ours) == set(theirs)
    assert ours["hparams"] == theirs["hparams"]
    for module in ("enc_c", "dec_c", "dec_m", "enc_m"):
        assert _layout(ours[module]) == _layout(theirs[module]), module
    for path in (dirs["port"]["silentcipher"], dirs["jax"]["silentcipher"]):
        wm = net.load_silentcipher_checkpoint(path, device="cpu")
        jwm = j_net.load_silentcipher_checkpoint(path)
        assert wm.cfg.n_fft == jwm.cfg.n_fft == 128 and wm.cfg.hop == jwm.cfg.hop
        a, b = _leaves(wm.params), _leaves(jwm.params)
        assert [x.shape for x in a] == [y.shape for y in b]
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
