"""Port Llama trunk vs ``sesameai_tts_tpu/models/transformer.py`` at a tiny
f32 size: RoPE, RMSNorm, attention and ``transformer_forward`` with a KV
cache (prefill, S=1 decode, right-padded ``valid_len``) at B=2 with a
different ``pos0`` per row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.core.config import test_tiny as j_tiny
from sesameai_tts_tpu.models import transformer as jt
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import test_tiny as t_tiny
from sesameai_tts_tpu_torch.models import transformer as tt
from sesameai_tts_tpu_torch.ops.attention import flash_attention_plain

# f32 module outputs: the same arithmetic summed in another order
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def trunk():
    jp = jt.init_transformer_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def test_rope_table_and_rotation_match_jax():
    _close(tt.precompute_rope(t_tiny()), jt.precompute_rope(j_tiny()))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    cs = rng.standard_normal((2, 3, 8, 2)).astype(np.float32)
    _close(tt.apply_rope(torch.from_numpy(x), torch.from_numpy(cs)),
           jt.apply_rope(jnp.asarray(x), jnp.asarray(cs)))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    _close(tt.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jt.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    # bf16 input: the f32 island is cast back before the scale multiplies
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tt.rms_norm(xb, torch.from_numpy(s).to(torch.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16


def test_fully_masked_row_is_zero():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    # batch row 0 has valid_len 0 and sees nothing; the two query rows of
    # batch row 1, at positions 2 and 3, see the three slots below valid_end 3
    pos0, valid_end = np.array([0, 2]), np.array([0, 3])
    mask = np.zeros((2, 2, 6), bool)
    mask[1, :, :3] = True
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, pos0, valid_end)))
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, jt._attention(*(jnp.asarray(a) for a in (q, k, v, mask))))


def test_forward_prefill_decode_and_valid_len_match_jax(trunk):
    jp, tp = trunk
    cfg_j, cfg_t = j_tiny(), t_tiny()
    rope_j, rope_t = jt.precompute_rope(cfg_j), tt.precompute_rope(cfg_t)
    rng = np.random.default_rng(3)
    B, S = 2, 6
    pos0 = np.array([0, 5])
    jc = jt.init_kv_cache(cfg_j, B, jnp.float32)
    tc = tt.init_kv_cache(cfg_t, B, torch.float32)

    def step(x, pos, valid=None):
        nonlocal jc
        jh, jc = jt.transformer_forward(
            jp, cfg_j, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jc, rope_j,
            valid_len=None if valid is None else jnp.asarray(valid, jnp.int32),
        )
        th, _ = tt.transformer_forward(
            tp, cfg_t, torch.from_numpy(x), torch.from_numpy(pos), tc, rope_t,
            valid_len=None if valid is None else torch.from_numpy(valid),
        )
        _close(th, jh)
        for layer in range(cfg_t.num_layers):
            _close(tc.k[layer], jc.k[layer])
            _close(tc.v[layer], jc.v[layer])

    # prefill at per-row offsets, then one S=1 decode step per row
    step(rng.standard_normal((B, S, 64)).astype(np.float32), pos0)
    step(rng.standard_normal((B, 1, 64)).astype(np.float32), pos0 + S)
    # right-padded window: row 0 has 2 real rows, row 1 all 4
    step(rng.standard_normal((B, 4, 64)).astype(np.float32), pos0 + S + 1, np.array([2, 4]))


def test_cache_write_past_the_end_raises(trunk):
    _, tp = trunk
    cfg = t_tiny()
    cache = tt.init_kv_cache(cfg, 1, torch.float32, max_seq_len=8)
    rope = tt.precompute_rope(cfg)
    with pytest.raises((IndexError, RuntimeError)):
        tt.transformer_forward(tp, cfg, torch.zeros(1, 4, 64), torch.tensor([6]), cache, rope)


def test_forward_with_cache_matches_hf_llama(trunk):
    """The trunk with its cache and routed attention against an independent
    implementation: HF ``LlamaModel`` (tests/oracles.py) runs each row's
    whole sequence without a cache.  A right-padded prefill from position 0
    is compared on its real rows, then one S=1 decode step per row with the
    last row of HF's run over the extended sequence."""
    from oracles import build_hf_llama

    jp, tp = trunk
    cfg = t_tiny()
    hf = build_hf_llama(jp, j_tiny())
    rng = np.random.default_rng(4)
    B, S = 2, 9
    valid = np.array([9, 5])
    x = rng.standard_normal((B, S, cfg.embed_dim)).astype(np.float32)
    x_new = rng.standard_normal((B, 1, cfg.embed_dim)).astype(np.float32)
    cache = tt.init_kv_cache(cfg, B, torch.float32)
    rope = tt.precompute_rope(cfg)
    h, _ = tt.transformer_forward(tp, cfg, torch.from_numpy(x), torch.zeros(B, dtype=torch.int64),
                                  cache, rope, valid_len=torch.from_numpy(valid))
    step, _ = tt.transformer_forward(tp, cfg, torch.from_numpy(x_new), torch.from_numpy(valid),
                                     cache, rope)
    for b, n in enumerate(valid):
        seq = np.concatenate([x[b, :n], x_new[b]])[None]
        with torch.no_grad():
            want = hf(inputs_embeds=torch.from_numpy(seq)).last_hidden_state[0].numpy()
        # as tests/test_transformer.py holds the JAX trunk to the same oracle
        np.testing.assert_allclose(h[b, :n].numpy(), want[:n], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(step[b, 0].numpy(), want[n], rtol=2e-4, atol=2e-4)
