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


# -- quant4_matmul ------------------------------------------------------------


def _int4_weight(gen, D, F, G):
    q4 = torch.randint(-128, 128, (D // 2, F), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand((G, F), generator=gen, device="cuda") * 1e-2 + 1e-3
    return q4, scale


def _assert_close_to_plain(got, want):
    # the kernel and the plain version add the same exact f32 products in
    # another order, then round once to bf16: one bf16 ulp (<= 2^-7
    # relative) plus f32 rounding noise of the sum
    want = want.float()
    tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F,G", [(1, 2048, 3072, 2), (2, 1024, 16384, 2),
                                     (8, 1024, 1536, 8), (17, 8192, 2048, 64),
                                     (64, 8192, 1024, 2), (3, 96, 24, 6)])
def test_quant4_matmul_matches_plain(cuda, S, D, F, G):
    q4, scale = _int4_weight(cuda, D, F, G)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(torch.bfloat16)
    before = tq.quant4_matmul.launches
    got = tq.quant4_matmul(x, q4, scale)
    assert tq.quant4_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (S, F)
    _assert_close_to_plain(got, tq.quant4_matmul_plain(x, q4, scale))


@pytest.mark.gpu
def test_qdot_sends_int4_products_to_the_kernel(cuda):
    q4, scale = _int4_weight(cuda, 256, 64, 2)
    x = torch.randn((2, 3, 256), generator=cuda, device="cuda")  # f32 caller
    before = tq.quant4_matmul.launches
    got = tq.qdot(x, {"q4": q4, "scale": scale})
    assert tq.quant4_matmul.launches == before + 1
    assert got.shape == (2, 3, 64) and got.dtype == torch.float32
    want = tq.quant4_matmul_plain(x.reshape(6, 256).to(torch.bfloat16), q4, scale)
    _assert_close_to_plain(got.reshape(6, 64), want)


@pytest.mark.gpu
def test_quant4_matmul_rejects_bad_inputs(cuda):
    q4, scale = _int4_weight(cuda, 64, 32, 2)
    x = torch.randn((4, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(TypeError):
        tq.quant4_matmul(x.float(), q4, scale)  # the kernel takes bf16 x
    with pytest.raises(ValueError):
        tq.quant4_matmul(x, q4, scale[:1].contiguous())  # G odd
    with pytest.raises(ValueError):
        tq.quant4_matmul(x[:, :32].contiguous(), q4, scale)  # D != 2 * D/2
    with pytest.raises(ValueError):
        tq.quant4_matmul(x, q4.cpu(), scale)


# -- quant_mlp ----------------------------------------------------------------


def _mlp_weights(gen, D, F, Dout):
    q13, s13 = _int8_weight(gen, D, 2 * F)
    q2, s2 = _int8_weight(gen, F, Dout)
    return q13, s13, q2, s2


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F,Dout", [(1, 2048, 8192, 2048), (1, 1024, 8192, 1024),
                                        (8, 1024, 8192, 1024), (9, 2048, 8192, 2048),
                                        (64, 1024, 8192, 1024), (3, 64, 256, 24)])
def test_quant_mlp_matches_plain(cuda, S, D, F, Dout):
    q13, s13, q2, s2 = _mlp_weights(cuda, D, F, Dout)
    x = (torch.randn((S, D), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    before = tq.quant_mlp.launches
    got = tq.quant_mlp(x, q13, s13, q2, s2)
    assert tq.quant_mlp.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (S, Dout)
    # the w13 sums may round a1, a3 or h to the neighbouring bf16 value of
    # the plain version's; each such flip moves the output by a fraction of
    # one term of the F-long w2 sum, far inside the tolerance below
    _assert_close_to_plain(got, tq.quant_mlp_plain(x, q13, s13, q2, s2))


@pytest.mark.gpu
def test_qmlp_fused_sends_the_mlp_to_the_kernel(cuda):
    q13, s13, q2, s2 = _mlp_weights(cuda, 256, 128, 256)
    w13, w2 = {"q": q13, "scale": s13}, {"q": q2, "scale": s2}
    x = (torch.randn((1, 2, 256), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    mlp0, mm0 = tq.quant_mlp.launches, tq.quant_matmul.launches
    got = tq.qmlp(x, w13, w2, fused=True)
    assert (tq.quant_mlp.launches, tq.quant_matmul.launches) == (mlp0 + 1, mm0)
    assert got.shape == (1, 2, 256) and got.dtype == torch.bfloat16
    _assert_close_to_plain(got.reshape(2, 256), tq.quant_mlp_plain(x.reshape(2, 256), q13, s13,
                                                                   q2, s2))
    unfused = tq.qmlp(x, w13, w2)  # the default: two quant_matmul launches
    assert (tq.quant_mlp.launches, tq.quant_matmul.launches) == (mlp0 + 1, mm0 + 2)
    _assert_close_to_plain(got, unfused)


@pytest.mark.gpu
def test_quant_mlp_rejects_bad_inputs(cuda):
    q13, s13, q2, s2 = _mlp_weights(cuda, 64, 128, 32)
    x = torch.randn((4, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(TypeError):
        tq.quant_mlp(x.float(), q13, s13, q2, s2)
    with pytest.raises(ValueError):
        tq.quant_mlp(x, q13[:, :96].contiguous(), s13[:96].contiguous(), q2[:48].contiguous(),
                     s2)  # F = 48 is not a whole number of 64-wide tiles
    with pytest.raises(ValueError):
        tq.quant_mlp(torch.zeros((65, 64), dtype=torch.bfloat16, device="cuda"), q13, s13,
                     q2, s2)  # S > 64
    with pytest.raises(ValueError):
        tq.quant_mlp(x, q13, s13, q2.cpu(), s2)
