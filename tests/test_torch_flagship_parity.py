"""Flagship-width parity of the port against the JAX package (the port's
counterpart of ``tests/test_flagship_parity.py``): real CSM-1B widths, not
the tiny flavors the other ``test_torch_*`` files use, so faults that only
appear at published values show (GQA 32/8 and 8/2 head splits, the llama3
RoPE band blending past the context knee, the (2051·32)-row audio
embedding offsets, K = 32 codebooks).

* One real-width backbone layer and one real-width decoder layer, port
  against JAX (f32, JAX at "highest" matmul precision), over a 13-row
  window at position 0 and at 1800 (past the knee, where the llama3 band
  blending engages) after a cache of random context rows: equal within
  1e-4 relative to the output's peak.  Both sum the
  same f32 products in another order; a wrong head split, RoPE band or
  mask moves the output by O(1).
* A greedy ``generate_frame`` at real hidden widths, K = 32, audio vocab
  2051, 2 layers per trunk (text vocab 2048: the table's size does not
  change the gather): the port's frame equals the JAX package's in at
  least 31 of 32 codebooks, the JAX test's own bar against its oracle
  (greedy argmax may flip only on a near-tie), and the codebook-0 logits
  agree within 1e-4 of their peak.

Marked ``slow``: minutes of CPU and ~3 GB of host memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.core import config as j_config
from sesameai_tts_tpu.models import csm as j_csm
from sesameai_tts_tpu.models import transformer as j_tf
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core import config as t_config
from sesameai_tts_tpu_torch.models import csm as t_csm
from sesameai_tts_tpu_torch.models import transformer as t_tf

LAYER_RTOL_OF_PEAK = 1e-4
LOGIT_RTOL_OF_PEAK = 1e-4


def _real_width(mod, flavor: str, num_layers: int, dtype):
    """The published flavor widths (llama-1B / llama-100M), depth cut."""
    if flavor == "backbone":
        return mod.TransformerConfig(num_layers=num_layers, num_heads=32, num_kv_heads=8,
                                     embed_dim=2048, max_seq_len=2048, intermediate_dim=8192,
                                     dtype=dtype, rope=mod.RoPEConfig())
    return mod.TransformerConfig(num_layers=num_layers, num_heads=8, num_kv_heads=2,
                                 embed_dim=1024, max_seq_len=2048, intermediate_dim=8192,
                                 dtype=dtype, rope=mod.RoPEConfig())


@pytest.fixture(autouse=True, scope="module")
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _close_of_peak(got, want, rtol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.slow
@pytest.mark.parametrize("flavor", ["backbone", "decoder"])
@pytest.mark.parametrize("pos0", [0, 1800])
def test_real_width_layer_equals_jax(flavor, pos0):
    jcfg = _real_width(j_config, flavor, 1, jnp.float32)
    tcfg = _real_width(t_config, flavor, 1, torch.float32)
    params = j_tf.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    B, S = 1, 13
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, S, jcfg.embed_dim),
                                     jnp.float32) * 0.5)
    # the cache's rows before pos0 hold a context both read (random keys and
    # values); the window's rows are written at pos0..pos0+S-1
    shape = (1, B, jcfg.num_kv_heads, jcfg.max_seq_len, jcfg.head_dim)
    rng = np.random.default_rng(2)
    k, v = (rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2))
    want, _ = j_tf.transformer_forward(params, jcfg, jnp.asarray(x),
                                       jnp.full((B,), pos0, jnp.int32),
                                       j_tf.KVCache(jnp.asarray(k), jnp.asarray(v)),
                                       j_tf.precompute_rope(jcfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    cache = t_tf.KVCache([torch.from_numpy(k[0].copy())], [torch.from_numpy(v[0].copy())])
    got, _ = t_tf.transformer_forward(tparams, tcfg, torch.from_numpy(x.copy()),
                                      torch.full((B,), pos0, dtype=torch.int64), cache,
                                      t_tf.precompute_rope(tcfg))
    _close_of_peak(got.numpy(), np.asarray(want), LAYER_RTOL_OF_PEAK)


@pytest.mark.slow
def test_generate_frame_flagship_dims_greedy_equals_jax():
    for mod, dtype in ((j_config, jnp.float32), (t_config, torch.float32)):
        mod.register_flavor("_flagship_test_bb",
                            lambda mod=mod, dtype=dtype: _real_width(mod, "backbone", 2, dtype))
        mod.register_flavor("_flagship_test_dec",
                            lambda mod=mod, dtype=dtype: _real_width(mod, "decoder", 2, dtype))
    kw = dict(backbone_flavor="_flagship_test_bb", decoder_flavor="_flagship_test_dec",
              text_vocab_size=2048, audio_vocab_size=2051, audio_num_codebooks=32)
    jcfg, tcfg = j_config.CSMConfig(**kw), t_config.CSMConfig(**kw)
    K = jcfg.audio_num_codebooks
    params = j_csm.init_csm_params(jax.random.PRNGKey(3), jcfg, jnp.float32)

    rng = np.random.default_rng(0)
    S = 9
    tokens = np.zeros((S, K + 1), np.int32)
    mask = np.zeros((S, K + 1), bool)
    tokens[:, K] = rng.integers(0, jcfg.text_vocab_size, S)
    mask[:, K] = True
    # an audio row exercises the per-codebook vocab offsets
    tokens[2, :K] = rng.integers(0, jcfg.audio_vocab_size, K)
    mask[2, :K] = True
    tokens[2, K] = 0
    mask[2, K] = False

    want, j_state = j_csm.generate_frame(
        params, jcfg, j_csm.init_state(jcfg, 1, jnp.float32), jnp.asarray(tokens[None]),
        jnp.asarray(mask[None]), jax.random.PRNGKey(0), 1.0, 1)
    # the codebook-0 logits of the same prompt, as generate_frame computes them
    x = j_csm.embed_frames(params, jcfg, jnp.asarray(tokens[None]), jnp.asarray(mask[None]))
    j_h, _ = j_tf.transformer_forward(params["backbone"], jcfg.backbone, x,
                                      jnp.zeros((1,), jnp.int32), None,
                                      j_tf.precompute_rope(jcfg.backbone))
    j_logits = np.asarray(j_h[:, -1] @ params["codebook0_head"])
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    del params, x, j_h
    tok = torch.from_numpy(tokens[None].astype(np.int64))
    msk = torch.from_numpy(mask[None])
    got, t_state = t_csm.generate_frame(tparams, tcfg, t_csm.init_state(tcfg, 1, torch.float32),
                                        tok, msk, None, 1.0, 1)
    got, want = got.numpy()[0], np.asarray(want)[0]
    assert got.shape == want.shape == (K,)
    agree = (got == want).mean()
    assert agree >= 31 / 32, f"flagship-dim greedy parity {agree}: {got} vs {want}"
    assert int(t_state.pos[0]) == int(j_state.pos[0]) == S
    t_h, _ = t_csm.backbone_last_hidden(tparams, tcfg, t_csm.init_state(tcfg, 1, torch.float32),
                                        tok, msk)
    t_logits = (t_h @ tparams["codebook0_head"]).numpy()
    _close_of_peak(t_logits, j_logits, LOGIT_RTOL_OF_PEAK)
