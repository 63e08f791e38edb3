"""Port int8 quantization vs the JAX package, and the kernel's plain version.

The JAX ``qdot`` on the CPU takes its dense-dequant branch (the Pallas
kernel has no interpret mode); the port's CPU ``qdot`` takes the same
branch.  The kernel itself runs only on the card: its test is in
``test_torch_kernels.py``, which imports no JAX so that it runs on a
machine with a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.ops import quant as jq
from sesameai_tts_tpu_torch.ops import quant as tq

# f32 sums of the same terms in another order
F32_RTOL = 1e-5


def _close(got, want, rtol=F32_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_weight_bytes_equal(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    assert tw["q"].dtype == torch.int8 and tw["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw["scale"].numpy(), np.asarray(jw["scale"]))
    np.testing.assert_array_equal(
        tq._dequant(tw, torch.float32).numpy(), np.asarray(jq._dequant(jw, jnp.float32))
    )


@pytest.fixture(scope="module")
def qweight():
    w = np.random.default_rng(1).standard_normal((64, 128)).astype(np.float32) / 8
    jw = jq.quantize_weight(jnp.asarray(w))
    return jw, {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}


@pytest.mark.parametrize("S", [1, 3, 64])
def test_qdot_matches_jax(qweight, S):
    jw, tw = qweight
    x = np.random.default_rng(S).standard_normal((S, 64)).astype(np.float32)
    want = np.asarray(jq.qdot(jnp.asarray(x), jw))
    _close(tq.qdot(torch.from_numpy(x), tw).numpy(), want)
    # a leading batch axis reshapes through
    got3 = tq.qdot(torch.from_numpy(x)[None], tw)
    assert got3.shape == (1, S, 128)


@pytest.mark.parametrize("S", [1, 3, 64])
def test_quant_matmul_plain_matches_jax_qdot(qweight, S):
    """The kernel's arithmetic rounds x to bf16; with bf16-valued x it is
    the dense-dequant product up to f32 rounding."""
    jw, tw = qweight
    x = np.random.default_rng(10 + S).standard_normal((S, 64)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jq.qdot(jnp.asarray(x), jw))
    got = tq.quant_matmul(torch.from_numpy(x), tw["q"], tw["scale"])
    assert got.dtype == torch.float32 and got.shape == (S, 128)
    _close(got.numpy(), want)
    # a bf16 caller gets bf16 back, one bf16 rounding of the same value
    got_bf16 = tq.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tw["q"], tw["scale"])
    assert got_bf16.dtype == torch.bfloat16
    _close(got_bf16.float().numpy(), want, rtol=2**-8)


def test_quant_matmul_cpu_runs_plain_without_launching(qweight):
    _, tw = qweight
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    before = tq.quant_matmul.launches
    got = tq.quant_matmul(x, tw["q"], tw["scale"])
    assert torch.equal(got, tq.quant_matmul_plain(x, tw["q"], tw["scale"]))
    assert tq.quant_matmul.launches == before


@pytest.mark.parametrize("S", [1, 2, 3, 8, 17, 64])
@pytest.mark.parametrize("D,F", [(2048, 3072), (2048, 16384), (8192, 2048), (1024, 1024),
                                 (8192, 1024), (64, 128), (100, 8)])
def test_split_plan_covers_the_reduction(S, D, F):
    splits, rows = tq._splits(S, D, F, sms=132)
    assert rows % 8 == 0 and 1 <= splits <= 65535
    assert splits * rows >= D and (splits - 1) * rows < D  # every split non-empty


def test_quantize_and_dequantize_csm_match_jax():
    import jax

    from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
    from sesameai_tts_tpu.models.csm import init_csm_params
    from sesameai_tts_tpu_torch.convert import from_jax_params

    jp = init_csm_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32)
    jqp = jq.quantize_csm(jp)
    tqp = tq.quantize_csm(from_jax_params(jax.tree.map(np.asarray, jp)))
    want = from_jax_params(jax.tree.map(np.asarray, jqp))
    for trunk in ("backbone", "decoder"):
        for got_l, want_l in zip(tqp[trunk]["layers"], want[trunk]["layers"]):
            for k in ("qkv", "o_proj", "w13", "w2"):
                assert torch.equal(got_l[k]["q"], want_l[k]["q"])
                assert torch.equal(got_l[k]["scale"], want_l[k]["scale"])
    jd = from_jax_params(jax.tree.map(np.asarray, jq.dequantize_csm(jqp, jnp.float32)))
    td = tq.dequantize_csm(tqp, torch.float32)
    for got_l, want_l in zip(td["decoder"]["layers"], jd["decoder"]["layers"]):
        for k in got_l:
            assert torch.equal(got_l[k], want_l[k])
    assert td["text_embeddings"] is tqp["text_embeddings"]  # shared, not copied
    with pytest.raises(ValueError):
        tq.quantize_csm(tqp, bits=4)

