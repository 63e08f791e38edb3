"""The port's hand-written kernels on the card, against their plain versions.

These tests need a CUDA card and ``nvcc``: they carry the ``gpu`` marker
and skip without a card.  They import torch and the port only, so they
run on a machine without JAX:

    python -m pytest tests/test_torch_kernels.py -m gpu -q
"""

import pytest
import torch

from sesameai_tts_tpu_torch.ops import attention as ta
from sesameai_tts_tpu_torch.ops import quant as tq


def test_bindings_match_the_c_entry_points():
    """Every C entry point in csrc/ is bound with its own argument list: a
    pointer for each pointer parameter, an int for each int (ctypes would
    otherwise pass a shifted or truncated argument without complaint)."""
    import ctypes
    import re
    from pathlib import Path

    from sesameai_tts_tpu_torch.ops import kernels

    found = {}
    for src in (Path(kernels.__file__).parents[1] / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                           for p in params.split(",")]
            assert kernels._SOURCE_OF.get(name, name) == src.stem
    assert found == kernels._SIGNATURES


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


def _replayed(fn):
    """fn()'s output from a CUDA-graph replay (a fault in a cluster's
    combine or in a self-reset shows only there).  The capture runs on the
    stream of the warm-up, where quant_mlp has its persistent buffer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


# the flagship decode shapes at S = 1 (one cluster size each from 11 to 16),
# S in {2, 8} in the same kernel, S tiles past 8, and a ragged tiny shape
@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F", [(1, 2048, 3072), (1, 1024, 1024), (1, 8192, 1024),
                                   (1, 2048, 16384), (2, 1024, 16384), (8, 1024, 1536),
                                   (8, 8192, 2048), (17, 8192, 2048), (64, 8192, 1024),
                                   (3, 100, 24)])
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
@pytest.mark.parametrize("S,D,F", [(1, 1024, 1024), (1, 8192, 2048), (8, 2048, 3072)])
def test_quant_matmul_is_deterministic(cuda, S, D, F):
    """Splits add in a fixed order: repeated calls and a CUDA-graph replay
    give the same bits."""
    q, scale = _int8_weight(cuda, D, F)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(torch.bfloat16)
    first = tq.quant_matmul(x, q, scale)
    assert torch.equal(tq.quant_matmul(x, q, scale), first)
    assert torch.equal(_replayed(lambda: tq.quant_matmul(x, q, scale)), first)


# the tensor-core route (2 <= S <= 64): every n-tile count, at flagship
# shapes (decoder.w13, backbone.w2, decoder.o_proj), tp = 2 shard shapes
# (backbone.w13, decoder.qkv) and F % 16 == 8
_MMA_S = [2, 5, 8, 16, 33, 64]
_MMA_SHAPES = [(1024, 16384), (8192, 2048), (1024, 1024), (2048, 8192), (1024, 768),
               (1024, 1000)]


def _check_launch_and_bits(wrapper, call, want):
    """One launch, agreement with the plain version, and the same bits from
    a second call and from a CUDA-graph replay."""
    before = wrapper.launches
    got = call()
    assert wrapper.launches == before + 1
    _assert_close_to_plain(got, want)
    assert torch.equal(call(), got)
    assert torch.equal(_replayed(call), got)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("S", _MMA_S)
@pytest.mark.parametrize("D,F", _MMA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_matmul_tensor_cores(cuda, S, D, F, dtype):
    q, scale = _int8_weight(cuda, D, F)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(dtype)
    got = _check_launch_and_bits(tq.quant_matmul, lambda: tq.quant_matmul(x, q, scale),
                                 tq.quant_matmul_plain(x, q, scale))
    assert got.dtype == dtype and got.shape == (S, F)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_matmul_tensor_cores_stage_an_unaligned_x(cuda, dtype):
    """An x that starts off a 16-byte boundary (a view into a larger
    buffer) is staged one value at a time, to the same result."""
    q, scale = _int8_weight(cuda, 1024, 1536)
    buf = torch.randn(8 * 1024 + 1, generator=cuda, device="cuda").to(dtype)
    x = buf[1:].view(8, 1024)
    got = _check_launch_and_bits(tq.quant_matmul, lambda: tq.quant_matmul(x, q, scale),
                                 tq.quant_matmul_plain(x, q, scale))
    assert torch.equal(got, tq.quant_matmul(x.clone(), q, scale))


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


# the flagship decode shapes at S = 1 at the trunks' G = 2 and at 128-row
# groups (a split inside one group, or across several), every S tile, and a
# ragged tiny shape
@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F,G", [(1, 2048, 3072, 2), (1, 2048, 2048, 2), (1, 2048, 16384, 2),
                                     (1, 8192, 2048, 2), (1, 1024, 1536, 2), (1, 1024, 1024, 2),
                                     (1, 1024, 16384, 2), (1, 8192, 1024, 2),
                                     (1, 2048, 16384, 16), (1, 8192, 1024, 64),
                                     (1, 1024, 1024, 8), (2, 1024, 16384, 2),
                                     (4, 2048, 3072, 16), (8, 1024, 1536, 8),
                                     (17, 8192, 2048, 64), (64, 8192, 1024, 2), (3, 96, 24, 6),
                                     (1, 96, 24, 6)])
def test_quant4_matmul_matches_plain(cuda, S, D, F, G):
    q4, scale = _int4_weight(cuda, D, F, G)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(torch.bfloat16)
    before = tq.quant4_matmul.launches
    got = tq.quant4_matmul(x, q4, scale)
    assert tq.quant4_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (S, F)
    _assert_close_to_plain(got, tq.quant4_matmul_plain(x, q4, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F,G", [(1, 1024, 1024, 2), (1, 8192, 1024, 64),
                                     (1, 2048, 16384, 16), (8, 2048, 3072, 2)])
def test_quant4_matmul_is_deterministic(cuda, S, D, F, G):
    """The cluster's blocks add in rank order: repeated calls and a
    CUDA-graph replay give the same bits."""
    q4, scale = _int4_weight(cuda, D, F, G)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(torch.bfloat16)
    first = tq.quant4_matmul(x, q4, scale)
    assert torch.equal(tq.quant4_matmul(x, q4, scale), first)
    assert torch.equal(_replayed(lambda: tq.quant4_matmul(x, q4, scale)), first)


@pytest.mark.gpu
@pytest.mark.parametrize("S", _MMA_S)
@pytest.mark.parametrize("D,F", _MMA_SHAPES)
@pytest.mark.parametrize("G_of", ["halves", "128-row groups"])
def test_quant4_matmul_tensor_cores(cuda, S, D, F, G_of):
    q4, scale = _int4_weight(cuda, D, F, 2 if G_of == "halves" else D // 128)
    x = torch.randn((S, D), generator=cuda, device="cuda").to(torch.bfloat16)
    got = _check_launch_and_bits(tq.quant4_matmul, lambda: tq.quant4_matmul(x, q4, scale),
                                 tq.quant4_matmul_plain(x, q4, scale))
    assert got.dtype == torch.bfloat16 and got.shape == (S, F)


@pytest.mark.gpu
def test_quant4_matmul_tensor_cores_stage_an_unaligned_x(cuda):
    q4, scale = _int4_weight(cuda, 1024, 1536, 8)
    buf = torch.randn(8 * 1024 + 1, generator=cuda, device="cuda").to(torch.bfloat16)
    x = buf[1:].view(8, 1024)
    got = _check_launch_and_bits(tq.quant4_matmul, lambda: tq.quant4_matmul(x, q4, scale),
                                 tq.quant4_matmul_plain(x, q4, scale))
    assert torch.equal(got, tq.quant4_matmul(x.clone(), q4, scale))


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
                                        (64, 1024, 8192, 1024), (3, 64, 256, 24),
                                        (1, 256, 32768, 256), (2, 256, 65536, 64)])
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
@pytest.mark.parametrize("S,D,F,Dout", [(1, 2048, 8192, 2048), (1, 1024, 8192, 1024),
                                        (8, 2048, 8192, 2048), (64, 1024, 8192, 1024),
                                        (3, 64, 256, 24)])
def test_quant_mlp_is_deterministic(cuda, S, D, F, Dout):
    """One launch sums the tiles in a fixed order (cluster, then the grid's
    fixed tree): three calls in a row on one stream and a CUDA-graph replay
    give the first call's bits, so the grid barrier's counter resets."""
    q13, s13, q2, s2 = _mlp_weights(cuda, D, F, Dout)
    x = (torch.randn((S, D), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    first = tq.quant_mlp(x, q13, s13, q2, s2)
    for _ in range(3):
        assert torch.equal(tq.quant_mlp(x, q13, s13, q2, s2), first)
    assert torch.equal(_replayed(lambda: tq.quant_mlp(x, q13, s13, q2, s2)), first)
    assert torch.equal(tq.quant_mlp(x, q13, s13, q2, s2), first)  # after the replay


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,F,Dout", [(1, 1024, 8192, 1024), (9, 2048, 8192, 2048),
                                        (64, 1024, 8192, 1024)])
def test_quant_mlp_allocates_only_its_output(cuda, S, D, F, Dout):
    """The persistent buffer is allocated once per device and stream: a
    call then allocates its (S, Dout) bf16 output and nothing else."""
    q13, s13, q2, s2 = _mlp_weights(cuda, D, F, Dout)
    x = (torch.randn((S, D), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    tq.quant_mlp(x, q13, s13, q2, s2)  # the stream's buffer, once
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    outs = [tq.quant_mlp(x, q13, s13, q2, s2) for _ in range(3)]
    torch.cuda.synchronize()
    block = -(-S * Dout * 2 // 512) * 512  # the caching allocator's 512-byte blocks
    assert torch.cuda.memory_allocated() - before == len(outs) * block


# the tensor-core route (2 <= S <= 64): every n-tile count at the flagship
# MLPs, a tp = 2 shard, and a tiny shape whose w2 rows are not 16-byte
# aligned (phase 2 reads them from device memory)
_QMLP_MMA_S = [2, 3, 8, 17, 64]
_QMLP_MMA_SHAPES = [(2048, 8192, 2048), (1024, 8192, 1024), (2048, 4096, 2048), (64, 256, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("S", _QMLP_MMA_S)
@pytest.mark.parametrize("D,F,Dout", _QMLP_MMA_SHAPES)
def test_quant_mlp_tensor_cores(cuda, S, D, F, Dout):
    """One launch of the tensor-core route, against the plain version, and
    the same bits from a second call and from a CUDA-graph replay."""
    q13, s13, q2, s2 = _mlp_weights(cuda, D, F, Dout)
    x = (torch.randn((S, D), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    assert tq.quant_route(S) == "mma"
    got = _check_launch_and_bits(tq.quant_mlp, lambda: tq.quant_mlp(x, q13, s13, q2, s2),
                                 tq.quant_mlp_plain(x, q13, s13, q2, s2))
    assert got.dtype == torch.bfloat16 and got.shape == (S, Dout)


@pytest.mark.gpu
def test_quant_mlp_tensor_cores_refused_launch_raises(cuda, monkeypatch):
    """A plan whose blocks the card cannot hold at once (256 blocks of 32
    columns, one an SM by shared memory) is refused by the launch, and the
    wrapper raises without counting: nothing falls back."""
    q13, s13, q2, s2 = _mlp_weights(cuda, 1024, 8192, 1024)
    x = torch.randn((8, 1024), generator=cuda, device="cuda").to(torch.bfloat16)
    plan = tq._qmlp_mma_plan(8, 1024, 8192, 1024, 132, block_i=32)
    monkeypatch.setattr(tq, "_qmlp_mma_plan", lambda *a, **k: plan)
    before = tq.quant_mlp.launches
    with pytest.raises(RuntimeError):
        tq.quant_mlp(x, q13, s13, q2, s2)
    assert tq.quant_mlp.launches == before


@pytest.mark.gpu
def test_quant_mlp_refused_launch_raises(cuda, monkeypatch):
    """A grid whose clusters the card cannot hold at once (512 blocks of 16
    columns, one per SM by shared memory, in pairs) is refused by the
    launch, and the wrapper raises: nothing falls back."""
    q13, s13, q2, s2 = _mlp_weights(cuda, 1024, 8192, 1024)
    x = torch.randn((1, 1024), generator=cuda, device="cuda").to(torch.bfloat16)
    monkeypatch.setattr(tq, "_qmlp_geometry",
                        lambda *a: (16, 2, 256, 16, tq._QMLP_MAX_SMEM))
    before = tq.quant_mlp.launches
    with pytest.raises(RuntimeError):
        tq.quant_mlp(x, q13, s13, q2, s2)
    assert tq.quant_mlp.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [2, 8])
def test_qmlp_fused_sends_the_mlp_to_the_kernel(cuda, rows):
    q13, s13, q2, s2 = _mlp_weights(cuda, 256, 128, 256)
    w13, w2 = {"q": q13, "scale": s13}, {"q": q2, "scale": s2}
    x = (torch.randn((1, rows, 256), generator=cuda, device="cuda") * 0.3).to(torch.bfloat16)
    mlp0, mm0 = tq.quant_mlp.launches, tq.quant_matmul.launches
    got = tq.qmlp(x, w13, w2, fused=True)
    assert (tq.quant_mlp.launches, tq.quant_matmul.launches) == (mlp0 + 1, mm0)
    assert got.shape == (1, rows, 256) and got.dtype == torch.bfloat16
    _assert_close_to_plain(got.reshape(rows, 256), tq.quant_mlp_plain(x.reshape(rows, 256), q13,
                                                                      s13, q2, s2))
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


# -- flash_attention ----------------------------------------------------------


def _attn_inputs(gen, B, H, KV, S, T, hd, dtype):
    # q as the trunk hands it over: a (B, H, S, hd) view of (B, S, H, hd)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v


def _assert_attention_close(got, want, v):
    # bf16: the kernel rounds exp(s - m) at its running max to bf16, the
    # plain version the normalized probability; either moves a weight by at
    # most 2^-9 of itself, so the outputs, convex combinations of v's rows,
    # differ by at most 2^-8 max|v|, plus one bf16 rounding of the output
    # (< 1e-2 relative).  f32: only the order of the f32 sums differs.
    bf16 = v.dtype == torch.bfloat16
    want = want.float()
    tol = (1e-2 if bf16 else 1e-5) * want.abs() + (2**-8 if bf16 else 1e-5) * v.float().abs().max()
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,S,T,hd,pos0,valid_end", [
    (1, 32, 8, 512, 2048, 64, 0, 500),  # backbone prefill, right-padded
    (1, 32, 8, 64, 2048, 64, 500, 564),  # utterance prefill after a cached context
    (1, 32, 8, 768, 2048, 64, 0, 628),  # a rolling-context turn at the 768 bucket
    (1, 8, 2, 16, 32, 128, 0, 16),  # a prefill at hd 128
    (2, 8, 1, 40, 256, 64, 30, 60),  # G = 8: 8 rows a block, one tile straddled
    (1, 4, 4, 100, 300, 128, 150, 230),  # G = 1: 64 rows a block, a ragged last tile
    (1, 32, 8, 1, 2048, 64, 0, 1),  # backbone decode: split-K over the cache
    (1, 32, 8, 1, 2048, 64, 63, 64),
    (1, 32, 8, 1, 2048, 64, 64, 65),
    (1, 32, 8, 1, 2048, 64, 600, 601),
    (1, 32, 8, 1, 2048, 64, 1023, 1024),
    (1, 32, 8, 1, 2048, 64, 2047, 2048),
    (1, 32, 8, 2, 2048, 64, 700, 702),  # two rows (G * S = 8): the prefill kernel
    (1, 8, 4, 2, 512, 128, 300, 302),  # two rows (G * S = 4): the decode kernel
    (1, 8, 2, 1, 32, 128, 0, 1),  # decoder steps
    (1, 8, 2, 1, 32, 128, 31, 32),
    (2, 4, 2, 37, 100, 16, 5, 30),  # tiny flavor, ragged tiles
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_matches_plain(cuda, B, H, KV, S, T, hd, pos0, valid_end, dtype):
    q, k, v = _attn_inputs(cuda, B, H, KV, S, T, hd, dtype)
    p0 = torch.full((B,), pos0, device="cuda")
    ve = torch.full((B,), valid_end, device="cuda")
    before = ta.flash_attention.launches
    got = ta.flash_attention(q, k, v, p0, ve)
    assert ta.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, S, hd)
    _assert_attention_close(got, ta.flash_attention_plain(q, k, v, p0, ve), v)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,T,pos", [(64, 2048, (100, 1900)), (128, 32, (3, 30)),
                                      (16, 100, (0, 57))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_decode_rows_at_different_positions(cuda, hd, T, pos, dtype):
    H, KV = (32, 8) if hd == 64 else (8, 2) if hd == 128 else (4, 2)
    q, k, v = _attn_inputs(cuda, 2, H, KV, 1, T, hd, dtype)
    p0 = torch.tensor(pos, device="cuda")
    ve = p0 + 1
    got = ta.flash_attention(q, k, v, p0, ve)
    _assert_attention_close(got, ta.flash_attention_plain(q, k, v, p0, ve), v)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,S,T,hd,pos0", [(1, 32, 8, 1, 2048, 64, 1500),
                                                (1, 8, 2, 1, 32, 128, 31),
                                                (1, 32, 8, 64, 2048, 64, 500),
                                                (1, 32, 8, 512, 2048, 64, 0),
                                                (1, 8, 2, 16, 32, 128, 0)])
def test_flash_attention_is_deterministic(cuda, B, H, KV, S, T, hd, pos0):
    """The splits (and the prefill's single block per tile) combine in a
    fixed order: repeated calls and a CUDA-graph replay give the same bits."""
    q, k, v = _attn_inputs(cuda, B, H, KV, S, T, hd, torch.bfloat16)
    p0 = torch.full((B,), pos0, device="cuda")
    ve = p0 + S
    first = ta.flash_attention(q, k, v, p0, ve)
    assert torch.equal(ta.flash_attention(q, k, v, p0, ve), first)
    assert torch.equal(_replayed(lambda: ta.flash_attention(q, k, v, p0, ve)), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_decode_without_keys_is_zero(cuda, dtype):
    """A decode row at position 0 with valid_len 0 sees no slot: every split
    is empty and the output is exactly 0."""
    q, k, v = _attn_inputs(cuda, 2, 32, 8, 1, 2048, 64, dtype)
    p0 = torch.tensor([0, 900], device="cuda")
    ve = torch.tensor([0, 901], device="cuda")
    got = ta.flash_attention(q, k, v, p0, ve)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _assert_attention_close(got[1], ta.flash_attention_plain(q, k, v, p0, ve)[1], v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_row_without_keys_is_zero(cuda, dtype):
    q, k, v = _attn_inputs(cuda, 2, 32, 8, 64, 2048, 64, dtype)
    p0 = torch.tensor([0, 0], device="cuda")
    ve = torch.tensor([40, 0], device="cuda")  # row 1 has valid_len 0
    got = ta.flash_attention(q, k, v, p0, ve)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _assert_attention_close(got[0], ta.flash_attention_plain(q, k, v, p0, ve)[0], v)


@pytest.mark.gpu
def test_transformer_forward_sends_every_attention_to_the_kernel(cuda):
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.config import test_tiny
    from sesameai_tts_tpu_torch.models import transformer as tt

    cfg = test_tiny()
    params = tt.init_transformer_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn((2, 7, cfg.embed_dim), generator=torch.Generator().manual_seed(1))
    pos0, valid = torch.tensor([0, 3]), torch.tensor([7, 4])
    outs = []
    for dev in ("cpu", "cuda"):
        cache = tt.init_kv_cache(cfg, 2, torch.float32, device=dev)
        rope = tt.precompute_rope(cfg, device=dev)
        before = ta.flash_attention.launches
        h, _ = tt.transformer_forward(to_device(params, dev), cfg, x.to(dev), pos0.to(dev), cache,
                                      rope, valid_len=valid.to(dev))
        outs.append(h.cpu())
        assert ta.flash_attention.launches - before == (cfg.num_layers if dev == "cuda" else 0)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _attn_inputs(cuda, 1, 8, 2, 4, 64, 64, torch.bfloat16)
    p0, ve = torch.tensor([0], device="cuda"), torch.tensor([4], device="cuda")
    with pytest.raises(ValueError):
        ta.flash_attention(*_attn_inputs(cuda, 1, 8, 2, 4, 64, 32, torch.bfloat16), p0, ve)
    with pytest.raises(TypeError):
        ta.flash_attention(q.half(), k.half(), v.half(), p0, ve)
    with pytest.raises(TypeError):
        ta.flash_attention(q, k, v, p0.float(), ve)
    with pytest.raises(ValueError):
        ta.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, p0, ve)
    with pytest.raises(ValueError):
        ta.flash_attention(q, k, v, p0.cpu(), ve)
    qbuf = torch.randn((1, 4, 8 * 64 + 1), generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):  # a bf16 prefill row of q not on a 16-byte boundary
        ta.flash_attention(qbuf[..., :512].view(1, 4, 8, 64).transpose(1, 2), k, v, p0, ve)
    with pytest.raises(ValueError):  # 64 heads on one KV head: more than a block holds
        ta.flash_attention(*_attn_inputs(cuda, 1, 64, 1, 1, 64, 128, torch.bfloat16), p0, ve)


@pytest.mark.gpu
def test_a_graph_replay_counts_the_launches_its_capture_recorded(cuda):
    from sesameai_tts_tpu_torch.runtime import graphs

    q, k, v = _attn_inputs(cuda, 1, 8, 2, 1, 64, 64, torch.bfloat16)
    p0, ve = torch.tensor([10], device="cuda"), torch.tensor([11], device="cuda")
    out = torch.empty((1, 8, 1, 64), dtype=torch.bfloat16, device="cuda")
    side = torch.cuda.Stream()
    captured = graphs.capture(lambda: out.copy_(ta.flash_attention(q, k, v, p0, ve)), side,
                              torch.cuda.graph_pool_handle())
    before = ta.flash_attention.launches
    want = ta.flash_attention(q, k, v, p0, ve)
    out.zero_()
    for _ in range(3):
        captured.replay()
    torch.cuda.synchronize()
    assert captured.launches == {ta.flash_attention: 1}
    assert ta.flash_attention.launches - before == 1 + 3
    assert torch.equal(out, want)


@pytest.mark.gpu
def test_graphed_tiny_generator_equals_its_eager_step(cuda):
    """The tiny f32 model on the card: frames from the graph replays equal
    ``csm.generate_frame`` + ``csm.decode_frames`` run eagerly on the card,
    greedy and sampled, and each decoded frame replays the trunk's
    attention launches."""
    import numpy as np

    from sesameai_tts_tpu_torch.models import csm
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    gen = build_generator(test_tiny_spec(), device="cuda", decode_chunk_frames=3)
    cfg = gen._cfg
    text = "the quick brown fox"
    for temperature, topk, seed in ((1.0, 1, 0), (0.9, 5, 3), (0.6, 20, 4)):
        graphed = gen.generate_frames(text, 0, [], max_audio_length_ms=640,
                                      temperature=temperature, topk=topk, seed=seed)
        tokens, mask = gen._tokenize_prompt(text, 0, [])
        tok, msk, valid_len = gen._padded(tokens, mask, 64)
        state = csm.init_state(cfg, 1, torch.float32, device="cuda")
        frame, state = csm.generate_frame(gen._prefill_params, cfg, state, tok, msk,
                                          csm.frame_generator(seed, 0, "cuda"), temperature,
                                          topk, valid_len=valid_len, rope_cs=gen._rope)
        rest, valid, _, _ = csm.decode_frames(gen._params, cfg, state, frame,
                                              (frame == 0).all(-1), seed, 7, temperature, topk,
                                              rope_cs=gen._rope, start_index=1)
        frames = torch.cat([frame[None], rest])[:, 0]
        keep = torch.cat([~(frame == 0).all(-1)[None], valid])[:, 0]
        np.testing.assert_array_equal(graphed, frames[keep].cpu().numpy())
    per_frame = cfg.backbone.num_layers + cfg.audio_num_codebooks * cfg.decoder.num_layers
    replayed = sum(gen._graphs[(1, part, False)].launches.get(ta.flash_attention, 0)
                   for part in ("backbone", "sample"))
    assert replayed == per_frame


# -- flash_attention_bwd ------------------------------------------------------


def _assert_grad_close(got, want):
    # both take the same operand values and compute every sum in f32, in
    # another order; each rounds its f32 result to the dtype once (bf16: one
    # ulp, < 1e-2 relative, plus f32 noise well under 1e-3 of the peak)
    bf16 = want.dtype == torch.bfloat16
    want = want.float()
    tol = (1e-2 if bf16 else 1e-4) * want.abs() + (1e-3 if bf16 else 1e-4) * want.abs().max()
    assert bool(((got.float() - want).abs() <= tol).all()), float((got.float() - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,S,T,hd,pos0,valid_end", [
    (2, 32, 8, 512, 512, 64, (0, 0), (512, 512)),  # the backbone's training window
    (2, 32, 8, 256, 256, 64, (0, 0), (256, 200)),  # a right-padded row
    (8, 8, 2, 32, 32, 128, (0,) * 8, (32,) * 8),  # the decoder's K positions
    (2, 8, 2, 64, 64, 128, (0, 0), (64, 0)),  # a row that sees no key
    (2, 4, 2, 37, 37, 16, (0, 0), (37, 30)),  # tiny flavor, ragged tiles
    (1, 4, 4, 40, 100, 64, (30,), (70,)),  # G = 1, a window after a context
    (1, 16, 1, 20, 20, 64, (0,), (20,)),  # G = 16: four rows a tile
    (1, 4, 1, 256, 256, 64, (0,), (256,)),  # one KV head: dkdv clusters of 8
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_matches_plain(cuda, B, H, KV, S, T, hd, pos0, valid_end, dtype):
    q, k, v = _attn_inputs(cuda, B, H, KV, S, T, hd, dtype)
    p0, ve = torch.tensor(pos0, device="cuda"), torch.tensor(valid_end, device="cuda")
    o = ta.flash_attention(q, k, v, p0, ve)
    do = torch.randn(o.shape, generator=cuda, device="cuda").to(dtype)
    before = ta.flash_attention_bwd.launches
    got = ta.flash_attention_bwd(q, k, v, o, do, p0, ve)
    assert ta.flash_attention_bwd.launches == before + 1
    want = ta.flash_attention_bwd_plain(q, k, v, o, do, p0, ve)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        _assert_grad_close(g, w)
    again = ta.flash_attention_bwd(q, k, v, o, do, p0, ve)  # no atomics: bit-equal
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for b, e in enumerate(valid_end):
        if e <= 0:
            assert not any(g[b].any() for g in got)


@pytest.mark.gpu
def test_attention_gradient_goes_through_the_kernels(cuda):
    """A cache-free trunk on the card: its flash_attention calls with grad
    take FlashAttentionFn, whose backward launches flash_attention_bwd, and
    the gradients equal the CPU's (f32, TF32 off)."""
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.config import test_tiny
    from sesameai_tts_tpu_torch.models import transformer as tt

    cfg = test_tiny()
    params = tt.init_transformer_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn((2, 9, cfg.embed_dim), generator=torch.Generator().manual_seed(1))
    # a fixed projection of the output: (h ** 2).mean() of an RMS-normed h is
    # nearly constant, and its gradients are rounding noise
    w = torch.randn((2, 9, cfg.embed_dim), generator=torch.Generator().manual_seed(2))
    grads = []
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)  # new dicts: the leaves set below are this device's
        for layer, name in ((0, "qkv"), (1, "w2")):
            p["layers"][layer][name] = p["layers"][layer][name].detach().clone().requires_grad_()
        leaves = [p["layers"][0]["qkv"], p["layers"][1]["w2"]]
        before = (ta.flash_attention.launches, ta.flash_attention_bwd.launches)
        h, cache = tt.transformer_forward(p, cfg, x.to(dev), torch.zeros(2, dtype=torch.int64,
                                                                       device=dev),
                                          None, tt.precompute_rope(cfg, device=dev),
                                          valid_len=torch.tensor([9, 5], device=dev))
        assert cache is None
        grads.append([g.cpu() for g in torch.autograd.grad((h * w.to(dev)).sum(), leaves)])
        n = cfg.num_layers if dev == "cuda" else 0
        assert (ta.flash_attention.launches - before[0],
                ta.flash_attention_bwd.launches - before[1]) == (n, n)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5 * a.abs().max().item())


@pytest.mark.gpu
def test_quant_kernels_refuse_grad(cuda):
    """A kernel without a gradient raises rather than detach silently."""
    q, scale = _int8_weight(cuda, 64, 64)
    x = torch.randn((2, 64), generator=cuda, device="cuda").requires_grad_()
    with pytest.raises(TypeError, match="gradient"):
        tq.quant_matmul(x, q, scale)
    with torch.no_grad():
        tq.quant_matmul(x, q, scale)
    q4 = torch.randint(-128, 128, (32, 64), generator=cuda, device="cuda", dtype=torch.int8)
    with pytest.raises(TypeError, match="gradient"):
        tq.quant4_matmul(x.detach().to(torch.bfloat16).requires_grad_(), q4,
                         torch.rand((2, 64), device="cuda"))
    with pytest.raises(TypeError, match="gradient"):
        tq.quant_mlp(x.detach().to(torch.bfloat16).requires_grad_(), q.repeat(1, 2),
                     scale.repeat(2), q, scale)


@pytest.mark.gpu
def test_flash_attention_bwd_rejects_bad_inputs(cuda):
    q, k, v = _attn_inputs(cuda, 1, 8, 2, 4, 4, 64, torch.bfloat16)
    p0, ve = torch.tensor([0], device="cuda"), torch.tensor([4], device="cuda")
    o = ta.flash_attention(q, k, v, p0, ve)
    with pytest.raises(TypeError):
        ta.flash_attention_bwd(q, k, v, o, o.float(), p0, ve)
    with pytest.raises(ValueError):
        ta.flash_attention_bwd(q, k, v, o[:, :, :2], o, p0, ve)
    with pytest.raises(ValueError):
        ta.flash_attention_bwd(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, o, o,
                               p0, ve)
