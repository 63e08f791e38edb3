"""The port's hand-written kernels on the card, against their plain versions.

These tests need a CUDA card and ``nvcc``: they carry the ``gpu`` marker
and skip without a card.  They import torch and the port only, so they
run on a machine without JAX:

    python -m pytest tests/test_torch_kernels.py -m gpu -q
"""

import pytest
import torch

from sesameai_tts_tpu_torch.ops import quant as tq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _int8_weight(gen, D, F):
    q = torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
    return q, scale


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F", [(1, 2048, 3072), (2, 1024, 16384), (8, 1024, 1536),
                                   (17, 8192, 2048), (64, 8192, 1024), (3, 100, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_matmul_matches_plain(cuda, S, D, F, dtype):
    q, scale = _int8_weight(cuda, D, F)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(dtype)
    before = tq.quant_matmul.launches
    got = tq.quant_matmul(x, q, scale)
    assert tq.quant_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (S, F)
    want = tq.quant_matmul_plain(x, q, scale).float()
    # f32 sums in another order, then one rounding to x.dtype
    tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.gpu
def test_qdot_sends_quantized_products_to_the_kernel(cuda):
    q, scale = _int8_weight(cuda, 256, 64)
    x = torch.randn((2, 3, 256), generator=cuda, device="cuda").to(torch.bfloat16)
    before = tq.quant_matmul.launches
    got = tq.qdot(x, {"q": q, "scale": scale})
    assert tq.quant_matmul.launches == before + 1 and got.shape == (2, 3, 64)
    want = tq.quant_matmul_plain(x.reshape(6, 256), q, scale).reshape(2, 3, 64)
    tol = 1e-2 * want.float().abs() + 1e-3 * want.float().abs().max()
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.gpu
def test_quant_matmul_rejects_bad_inputs(cuda):
    q, scale = _int8_weight(cuda, 64, 32)
    x = torch.randn((4, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):
        tq.quant_matmul(x.t().contiguous().t(), q, scale)  # not contiguous
    with pytest.raises(ValueError):
        tq.quant_matmul(x, q[:, :30].contiguous(), scale[:30].contiguous())  # F % 8
    with pytest.raises(TypeError):
        tq.quant_matmul(x.half(), q, scale)
    with pytest.raises(ValueError):
        tq.quant_matmul(x, q.cpu(), scale)
