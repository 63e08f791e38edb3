"""The port's LoRA finetuning (``sesameai_tts_tpu_torch/training/lora.py``
and ``make_lora_train_step``) on the CPU: the merge at init is the base, ΔW
has rank r, only the adapters move, accumulation equals the full batch, an
unmatched target raises, two LoRA steps equal the JAX package's from the
same adapters (``convert.py::from_jax_lora``: the loss within 1e-5
relative, the adapters within 1e-5 absolute at lr 1e-3), and the CLI's
merged export loads through ``csm_checkpoint`` into a CPU Generator that
generates."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
from sesameai_tts_tpu.models.csm import init_csm_params as j_init
from sesameai_tts_tpu.training import lora as jlora
from sesameai_tts_tpu.training import train_step as jts
from sesameai_tts_tpu.training.loss import Batch as JBatch
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.convert import from_jax_lora, from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.core.weights import load_pytree
from sesameai_tts_tpu_torch.models.csm import init_csm_params
from sesameai_tts_tpu_torch.training import train_step as ts
from sesameai_tts_tpu_torch.training.finetune import main
from sesameai_tts_tpu_torch.training.loss import Batch
from sesameai_tts_tpu_torch.training.lora import (
    DEFAULT_TARGETS,
    count_params,
    init_lora_params,
    merge_lora,
)

JCFG, CFG = j_tiny(), csm_test_tiny()
K = CFG.audio_num_codebooks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return init_csm_params(CFG, torch.Generator().manual_seed(0), torch.float32)


def _arrays(seed, B=2, S=16, audio_rows=10):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    text = S - audio_rows
    tokens[:, :text, K] = rng.integers(1, CFG.text_vocab_size, (B, text))
    mask[:, :text, K] = True
    tokens[:, text:, :K] = rng.integers(1, CFG.audio_vocab_size, (B, audio_rows, K))
    mask[:, text:, :K] = True
    return tokens, mask, np.ones((B, S), bool)


def _batch(seed, **kw):
    return Batch(*(torch.from_numpy(a) for a in _arrays(seed, **kw)))


def _lora(base, seed, rank=2, **kw):
    return init_lora_params(torch.Generator().manual_seed(seed), base, rank, **kw)


def test_init_merge_is_identity(base):
    merged = merge_lora(base, _lora(base, 1), alpha=16.0)
    for a, b in zip(ts.tree_leaves(base), ts.tree_leaves(merged)):
        assert torch.equal(a, b)


def test_adapter_coverage_and_size(base):
    lora = _lora(base, 1)
    assert set(lora) == {"backbone", "decoder"}
    for trunk in ("backbone", "decoder"):
        layers = lora[trunk]["layers"]
        assert isinstance(layers, tuple) and len(layers) == len(base[trunk]["layers"])
        for layer, w in zip(layers, base[trunk]["layers"]):
            assert set(layer) == set(DEFAULT_TARGETS)
            for name, ab in layer.items():
                din, dout = w[name].shape
                assert ab["a"].shape == (din, 2) and ab["b"].shape == (2, dout)
                assert not ab["b"].any()
    assert count_params(lora) < 0.25 * count_params(base)
    # the same seed gives the same adapters
    for a, b in zip(ts.tree_leaves(lora), ts.tree_leaves(_lora(base, 1))):
        assert torch.equal(a, b)


def test_unmatched_targets_raise(base):
    with pytest.raises(ValueError, match="no LoRA targets"):
        _lora(base, 1, targets=("nope",))
    with pytest.raises(ValueError, match="oproj"):
        _lora(base, 1, targets=("qkv", "oproj"))


def test_merge_delta_has_rank_r(base):
    r = 2
    lora = ts.tree_map(lambda x: x + 0.01, _lora(base, 2, rank=r))
    merged = merge_lora(base, lora, alpha=8.0)
    d0 = (merged["backbone"]["layers"][0]["qkv"] - base["backbone"]["layers"][0]["qkv"]).numpy()
    s = np.linalg.svd(d0, compute_uv=False)
    assert s[0] > 1e-6
    np.testing.assert_allclose(s[r:], 0.0, atol=1e-5 * s[0])


def test_lora_step_updates_only_adapters(base):
    tx = ts.make_optimizer(lr=1e-2, warmup=1, total_steps=10)
    lora = _lora(base, 3)
    before = ts.tree_map(torch.clone, lora)
    base_before = ts.tree_map(torch.clone, base)
    state = ts.init_train_state(lora, tx)
    step = ts.make_lora_train_step(CFG, tx, alpha=16.0, decoder_frames=2)
    batch = _batch(0)
    state, m = step(state, base, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert set(state.opt_state["mu"]) == {"backbone", "decoder"}  # adapters only
    first = float(m["loss"])
    for _ in range(4):
        state, m = step(state, base, batch)
    assert float(m["loss"]) < first
    for a, b in zip(ts.tree_leaves(base_before), ts.tree_leaves(base)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(ts.tree_leaves(before),
                                                     ts.tree_leaves(state.params)))


def test_lora_accum_matches_full_batch(base):
    tx = ts.make_optimizer(lr=1e-3, warmup=1, total_steps=10)
    batch = _batch(1, B=4)
    out = []
    for accum in (1, 2):
        state = ts.init_train_state(_lora(base, 4), tx)
        step = ts.make_lora_train_step(CFG, tx, decoder_frames=2, accum_steps=accum)
        for _ in range(2):
            state, m = step(state, base, batch)
        out.append((state, m))
    np.testing.assert_allclose(float(out[0][1]["loss"]), float(out[1][1]["loss"]), rtol=1e-5)
    for a, b in zip(ts.tree_leaves(out[0][0].params), ts.tree_leaves(out[1][0].params)):
        assert (a - b).abs().max().item() <= 1e-6


def test_two_lora_steps_match_jax():
    jbase = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32)
    jl = jlora.init_lora_params(jax.random.PRNGKey(5), jbase, 2)
    jl = jax.tree.map(lambda x: x + 0.01, jl)  # b away from 0: every leaf gets a gradient
    np_l = jax.tree.map(np.asarray, jl)
    arrays = _arrays(2)
    jtx = jts.make_optimizer(lr=1e-3, warmup=1, total_steps=3)
    jstate = jts.init_train_state(jl, jtx)
    jstep = jts.make_lora_train_step(JCFG, jtx, alpha=16.0, decoder_frames=2, subset_rng=False)
    jms = []
    for _ in range(2):
        jstate, m = jstep(jstate, jbase, JBatch(*(jnp.asarray(a) for a in arrays)))
        jms.append(m)

    base = from_jax_params(jax.tree.map(np.asarray, jbase))
    tx = ts.make_optimizer(lr=1e-3, warmup=1, total_steps=3)
    state = ts.init_train_state(from_jax_lora(np_l), tx)
    step = ts.make_lora_train_step(CFG, tx, alpha=16.0, decoder_frames=2, subset_rng=False)
    for jm in jms:
        state, m = step(state, base, Batch(*(torch.from_numpy(a) for a in arrays)))
        for k in ("loss", "c0_loss", "decoder_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    want = from_jax_lora(jax.tree.map(np.asarray, jstate.params))
    for a, b in zip(ts.tree_leaves(want), ts.tree_leaves(state.params)):
        assert a.shape == b.shape and (a - b).abs().max().item() <= 1e-5


def test_finetune_cli_lora_export_serves(tmp_path):
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec

    data = tmp_path / "clips"
    data.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        write_wav(str(data / f"c{i}.wav"),
                  (0.1 * rng.standard_normal(960 * (i + 1))).astype(np.float32), 24_000)
        (data / f"c{i}.txt").write_text(f"lora clip {i}")
    ckpt = str(tmp_path / "run")
    # --save-every divides --steps: the last step is saved by the loop, and
    # the params export must still be written
    main(["--data", str(data), "--flavor", "test-tiny", "--steps", "2", "--batch-size", "2",
          "--buckets", "64", "--ckpt-dir", ckpt, "--save-every", "2", "--lora-rank", "2",
          "--log-every", "1", "--warmup", "1", "-d", "cpu"])
    like = init_csm_params(CFG, torch.Generator().manual_seed(0), torch.float32)
    params = load_pytree(os.path.join(ckpt, "params"), like)
    assert all(torch.isfinite(x).all() for x in ts.tree_leaves(params))
    # the adapters moved the merged weights away from the seed's base
    assert not torch.equal(params["backbone"]["layers"][0]["qkv"],
                           like["backbone"]["layers"][0]["qkv"])
    assert torch.equal(params["text_embeddings"], like["text_embeddings"])

    spec = dataclasses.replace(tiny_spec(), csm_checkpoint=os.path.join(ckpt, "params"))
    gen = build_generator(spec, device="cpu")
    for a, b in zip(ts.tree_leaves(gen._params), ts.tree_leaves(params)):
        assert torch.equal(a, b)
    audio = gen.generate("served from export", speaker=0, context=[],
                         max_audio_length_ms=400)
    assert audio.size > 0 and np.isfinite(audio).all()


def test_load_csm_checkpoint_takes_only_a_csm_pytree(tmp_path, base):
    from sesameai_tts_tpu_torch.core.weights import load_csm_checkpoint, save_pytree

    good, other = str(tmp_path / "params"), str(tmp_path / "other")
    save_pytree(good, base)
    got = load_csm_checkpoint(good, CFG, torch.bfloat16)
    for a, b in zip(ts.tree_leaves(base), ts.tree_leaves(got)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    save_pytree(other, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not of a CSM parameter tree"):
        load_csm_checkpoint(other, CFG)
    short = dict(base, backbone={"layers": base["backbone"]["layers"][:1],
                                 "final_norm": base["backbone"]["final_norm"]})
    save_pytree(other, short)
    with pytest.raises(ValueError, match="layers"):
        load_csm_checkpoint(other, CFG)
