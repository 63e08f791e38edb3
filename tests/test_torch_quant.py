"""Port int8 and int4 quantization vs the JAX package, and the kernels'
plain versions.

The JAX ``qdot`` on the CPU takes its dense-dequant branch; the port's CPU
``qdot`` takes the same branch.  ``quant4_matmul_plain`` and
``quant_mlp_plain`` are held against the JAX kernel bodies run by
``pl.pallas_call(..., interpret=True)`` on the CPU.  The kernels
themselves run only on the card: their tests are in
``test_torch_kernels.py``, which imports no JAX so that it runs on a
machine with a card.
"""

import math

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
    """Either route's launch: one cluster of at most 16 non-empty splits
    over D, within the kernel's limits."""
    if tq.quant_route(S) == "simt":
        vec, tpr, splits, rows = tq._qmm_geometry(D, F, sms=132)
        assert rows % 8 == 0 and F % vec == 0 and 32 % tpr == 0 and tpr * vec <= 256
    else:
        p = tq._qmm_mma_plan(S, D, F, sms=132)
        splits, rows = p.splits, p.rows
        assert rows % 16 == 0 and F % (2 * p.mt) == 0 and 8 * p.nt >= S
        assert (p.mt, p.nt, p.wk, p.wn) in _QMM_MMA_KERNELS
    assert 1 <= splits <= 16  # one cluster, at most 16 blocks
    assert splits * rows >= D and (splits - 1) * rows < D  # every split non-empty


# quant_matmul's decode shapes (chip_smoke.py's flagship linears) and one
# rank's shards of them at tp = 2
_FLAGSHIP = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
             (1024, 1536), (1024, 1024), (1024, 16384), (8192, 1024)]
_TP2 = [(2048, 1536), (1024, 2048), (2048, 8192), (4096, 2048),
        (1024, 768), (512, 1024), (1024, 8192), (4096, 1024)]
# the (mt, nt, wk) instantiations of quant_matmul.cu's and quant4_matmul.cu's
# tensor-core kernels
_QMM_MMA_KERNELS = {(4, 1, 4, 1), (8, 2, 4, 1), (4, 2, 4, 1), (4, 4, 2, 1), (2, 8, 1, 1)}
_Q4MM_MMA_KERNELS = {(4, 1, 4, 1), (4, 2, 4, 1), (2, 4, 2, 1), (2, 8, 1, 2)}
# the S = 1 launches of the CUDA-core route before the tensor-core route
# came, (vec, tpr, splits, rows): that route keeps them exactly
_QMM_S1_PLANS = {
    (2048, 3072): (16, 8, 11, 192), (2048, 2048): (16, 4, 9, 232),
    (2048, 16384): (16, 16, 5, 416), (8192, 2048): (16, 4, 9, 912),
    (1024, 1536): (16, 4, 11, 96), (1024, 1024): (16, 4, 16, 64),
    (1024, 16384): (16, 16, 5, 208), (8192, 1024): (16, 4, 16, 512),
    (2048, 1536): (16, 4, 11, 192), (1024, 2048): (16, 4, 9, 120),
    (2048, 8192): (16, 16, 9, 232), (4096, 2048): (16, 4, 9, 456),
    (1024, 768): (16, 4, 16, 64), (512, 1024): (16, 4, 16, 32),
    (1024, 8192): (16, 16, 9, 120), (4096, 1024): (16, 4, 16, 256),
}
_Q4MM_S1_PLANS = {
    (2048, 3072): (16, 2, 3, 344), (2048, 2048): (16, 2, 5, 208),
    (2048, 16384): (16, 2, 1, 1024), (8192, 2048): (16, 2, 5, 824),
    (1024, 1536): (16, 2, 4, 128), (1024, 1024): (16, 2, 5, 104),
    (1024, 16384): (16, 2, 1, 512), (8192, 1024): (16, 2, 9, 456),
    (2048, 1536): (16, 2, 6, 176), (1024, 2048): (16, 2, 4, 128),
    (2048, 8192): (16, 2, 2, 512), (4096, 2048): (16, 2, 5, 416),
    (1024, 768): (16, 2, 6, 88), (512, 1024): (16, 2, 5, 56),
    (1024, 8192): (16, 2, 2, 256), (4096, 1024): (16, 2, 9, 232),
}


@pytest.mark.parametrize("D,F", _FLAGSHIP)
def test_flagship_geometry_fills_the_card(D, F):
    """At S = 1 every flagship shape puts at least one block on each of the
    H100's 132 SMs, in clusters of at most 16 non-empty splits."""
    vec, tpr, splits, rows = tq._qmm_geometry(D, F, sms=132)
    blocks = splits * math.ceil(F / (vec * tpr))
    assert blocks >= 132 and splits <= 16
    assert vec == 16 and (splits - 1) * rows < D <= splits * rows


def _mma_coverage(plan, D, F):
    """The (row, column) visits of a tensor-core launch, walked as the
    kernel walks them: each split's warps w (w % wk along D, w // wk along
    F) take k-steps s = w % wk, + wk, ...; lane (g, t) loads rows k_begin +
    16 s + 4 t + i (i < 4, below the split's end) of its 2 * mt columns
    (those below F).  → (rows visited per column group, columns visited)."""
    rows, cols = [], []
    for split in range(plan.splits):
        begin, end = split * plan.rows, min(D, (split + 1) * plan.rows)
        for wk in range(plan.wk):
            for s in range(wk, math.ceil((end - begin) / 16), plan.wk):
                rows += [r for t in range(4) for i in range(4)
                         if (r := begin + 16 * s + 4 * t + i) < end]
    for tile in range(plan.grid(F)[1]):
        for wc in range(tq._MMA_WARPS // plan.wk):
            for g in range(8):
                f = tile * plan.cols + wc * 16 * plan.mt + g * 2 * plan.mt
                cols += [f + c for c in range(2 * plan.mt) if f < F]
    return rows, cols


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("D,F", _FLAGSHIP + _TP2 + [(100, 24), (1024, 1000)])
def test_qmm_plan_per_route(S, D, F):
    """quant_matmul's launch at the flagship and tp = 2 shard shapes (and a
    ragged D, and F % 16 == 8): S = 1 keeps the CUDA-core plan exactly; from
    S = 2 on the tensor-core plan visits every row of D and every column of
    F once, in clusters of at most 16 non-empty splits, with at most 65,535
    column tiles, no S axis in its grid, and at most 232,448 bytes of shared
    memory, enough for the kernel's layout."""
    if S == 1:
        assert tq.quant_route(S) == "simt"
        if (D, F) in _QMM_S1_PLANS:
            assert tq._qmm_geometry(D, F, sms=132) == _QMM_S1_PLANS[(D, F)]
        return
    assert tq.quant_route(S) == "mma"
    p = tq._qmm_mma_plan(S, D, F, sms=132)
    assert (p.mt, p.nt, p.wk, p.wn) in _QMM_MMA_KERNELS and F % (2 * p.mt) == 0 and 8 * p.nt >= S
    splits, tiles, z = p.grid(F)
    assert 1 <= splits <= 16 and tiles <= 65535 and z == 1
    assert (splits - 1) * p.rows < D <= splits * p.rows and p.rows % 16 == 0
    rows, cols = _mma_coverage(p, D, F)
    assert sorted(rows) == list(range(D)) and sorted(cols) == list(range(F))
    assert p.smem <= 232448 and p.smem == tq._qmm_mma_smem(S, p.mt, p.nt, p.wk, splits)
    # the x ring (3 chunks of 8 nt rows of 16 * 16 / mt * wk bf16, padded),
    # or the warps' sums after it, then the cluster's 4-vectors: splits *
    # ceil(S * cols / 4 / splits)
    ring = 3 * 8 * p.nt * (16 * 16 // p.mt * p.wk + 16) * 2
    assert p.smem >= max(ring, p.wk * 8 * p.nt * p.cols * 4) + S * p.cols * 4


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("G_of", ["halves", "128-row groups"])
@pytest.mark.parametrize("D,F", _FLAGSHIP + _TP2 + [(96, 24), (1024, 1000)])
def test_q4mm_plan_per_route(S, D, F, G_of):
    """quant4_matmul's launch, as ``test_qmm_plan_per_route``, over the D/2
    packed rows at G = 2 and at groups of 128 rows (16 for D = 96): every
    k-step of 16 packed rows lies inside one scale group."""
    G = 2 if G_of == "halves" else D // (128 if D >= 256 else 16)
    if S == 1:
        assert tq.quant_route(S) == "simt"
        if (D, F) in _Q4MM_S1_PLANS:
            assert tq._q4mm_geometry(D, F, G, sms=132) == _Q4MM_S1_PLANS[(D, F)]
        return
    p = tq._q4mm_mma_plan(S, D, F, G, sms=132)
    D2, gs = D // 2, D // G
    assert (p.mt, p.nt, p.wk, p.wn) in _Q4MM_MMA_KERNELS and F % (2 * p.mt) == 0 and 8 * p.nt >= S
    splits, tiles, z = p.grid(F)
    assert 1 <= splits <= 16 and tiles <= 65535 and z == 1
    assert (splits - 1) * p.rows < D2 <= splits * p.rows and p.rows % 16 == 0
    rows, cols = _mma_coverage(p, D2, F)
    assert sorted(rows) == list(range(D2)) and sorted(cols) == list(range(F))
    assert gs % 16 == 0 and all(r // 16 * 16 // gs == r // gs for r in rows)
    assert p.smem <= 232448 and p.smem == tq._q4mm_mma_smem(S, p.mt, p.nt, p.wk, splits)


@pytest.mark.parametrize("D,G", [(96, 4), (256, 32), (64, 2)])
def test_q4mm_plan_refuses_groups_that_cut_a_k_step(D, G):
    """A group of D/G packed rows that is not whole 16-row k-steps (or a G
    the kernel does not take) raises from S = 2 on; S = 1 takes any even G
    that divides D."""
    if (D // G) % 16:
        with pytest.raises(ValueError):
            tq._q4mm_mma_plan(2, D, 64, G, sms=132)
        tq._q4mm_geometry(D, 64, G, sms=132)
    else:
        assert tq._q4mm_mma_plan(2, D, 64, G, sms=132).rows % 16 == 0
    with pytest.raises(ValueError):
        tq._q4mm_mma_plan(2, D, 64, 3, sms=132)


@pytest.mark.parametrize("S", [0, 65, 128])
def test_quant_route_takes_1_to_64_rows(S):
    """The kernels take 1-64 rows; qdot sends more to x @ dequant(w)."""
    with pytest.raises(ValueError):
        tq.quant_route(S)


@pytest.fixture(scope="module")
def qweight_ragged():
    """int8 weight (200 → 128): 200 rows, not whole 16-row k-steps."""
    w = np.random.default_rng(3).standard_normal((200, 128)).astype(np.float32) / 8
    jw = jq.quantize_weight(jnp.asarray(w))
    return jw, {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}


def _qmv_kernel_body(x, jw, block_f=128):
    """The JAX int8 kernel body, run by ``pallas_call`` in interpret mode on
    the CPU, with ``quant_matmul_pallas``'s BlockSpecs (without the TPU
    memory space) and an f32 output."""
    import jax
    from jax.experimental import pallas as pl

    S, D = x.shape
    F = jw["q"].shape[1]
    return pl.pallas_call(
        jq._qmv_kernel,
        grid=(F // block_f,),
        in_specs=[
            pl.BlockSpec((S, D), lambda i: (0, 0)),
            pl.BlockSpec((D, block_f), lambda i: (0, i)),
            pl.BlockSpec((1, block_f), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((S, block_f), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((S, F), jnp.float32),
        interpret=True,
    )(x, jw["q"], jw["scale"].reshape(1, F))


@pytest.mark.parametrize("rows,warps", [(16, 1), (48, 2), (64, 4), (208, 4), (96, 1)])
@pytest.mark.parametrize("S", [2, 3, 8, 13, 64])
def test_quant_matmul_cluster_plain_matches_plain_and_jax_kernel_body(qweight_ragged, S, rows,
                                                                      warps):
    """The tensor-core route's order of sums (splits of ``rows`` rows, each
    split's 16-row k-steps dealt to ``warps`` warps in turn, warps and then
    blocks added in order) against ``quant_matmul_plain`` and the JAX
    kernel body in interpret mode: the same exact products, f32 sums in
    another order."""
    jw, tw = qweight_ragged
    x = np.random.default_rng(80 + S).standard_normal((S, 200)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32)))
    got = tq.quant_matmul_cluster_plain(xt, tw["q"], tw["scale"], rows, warps)
    assert got.dtype == torch.float32 and got.shape == (S, 128)
    _close(got.numpy(), tq.quant_matmul_plain(xt, tw["q"], tw["scale"]).numpy())
    _close(got.numpy(), np.asarray(_qmv_kernel_body(xb, jw)))
    # an f32 x is rounded to bf16 first, as the kernel stages it
    _close(tq.quant_matmul_cluster_plain(torch.from_numpy(x), tw["q"], tw["scale"], rows,
                                         warps).numpy(), got.numpy())
    got_bf16 = tq.quant_matmul_cluster_plain(xt.to(torch.bfloat16), tw["q"], tw["scale"], rows,
                                             warps)
    assert got_bf16.dtype == torch.bfloat16
    _close(got_bf16.float().numpy(), got.numpy(), rtol=2**-8)


@pytest.mark.parametrize("D,F", [(2048, 3072), (8192, 1024), (1024, 1000)])
@pytest.mark.parametrize("S", [2, 8, 64])
def test_quant_matmul_cluster_plain_at_the_plans(S, D, F):
    """The order of sums of each tensor-core plan at full width (the
    flagship shapes, and F % 16 == 8) against quant_matmul_plain."""
    rng = np.random.default_rng(D + S)
    q = torch.from_numpy(rng.integers(-127, 128, (D, F), dtype=np.int8))
    scale = torch.from_numpy(rng.random(F, dtype=np.float32) * 1e-2 + 1e-3)
    x = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(torch.bfloat16)
    p = tq._qmm_mma_plan(S, D, F, sms=132)
    got = tq.quant_matmul_cluster_plain(x.float(), q, scale, p.rows, p.wk)
    _close(got.numpy(), tq.quant_matmul_plain(x.float(), q, scale).numpy())


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
        tq.quantize_csm(tqp, bits=3)



# -- int4 -----------------------------------------------------------------------


@pytest.mark.parametrize("group", [16, 64, 128])  # 128 = in/2, the trunk default
def test_quantize_weight_int4_bytes_equal(group):
    w = np.random.default_rng(group).standard_normal((256, 48)).astype(np.float32) / 16
    jw = jq.quantize_weight_int4(jnp.asarray(w), group)
    tw = tq.quantize_weight_int4(torch.from_numpy(w), group)
    assert tw["q4"].dtype == torch.int8 and tw["q4"].shape == (128, 48)
    assert tw["scale"].shape == (256 // group, 48)
    np.testing.assert_array_equal(tw["q4"].numpy(), np.asarray(jw["q4"]))
    np.testing.assert_array_equal(tw["scale"].numpy(), np.asarray(jw["scale"]))
    lo, hi = tq._unpack_int4(tw["q4"])
    jlo, jhi = jq._unpack_int4(jw["q4"])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(
        tq._dequant4(tw, torch.float32).numpy(), np.asarray(jq._dequant4(jw, jnp.float32))
    )
    assert tq.is_quantized4(tw) and not tq.is_quantized(tw)


def test_quantize_weight_int4_rejects_ragged_groups():
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.zeros(96, 8), group=32)  # 96 % 64 != 0


@pytest.fixture(scope="module")
def q4weight():
    """int4 weight (256 → 256) at G = 2 (half-matrix groups) and G = 16."""
    w = np.random.default_rng(2).standard_normal((256, 256)).astype(np.float32) / 16
    out = {}
    for G in (2, 16):
        jw = jq.quantize_weight_int4(jnp.asarray(w), 256 // G)
        out[G] = (jw, {k: torch.from_numpy(np.array(v)) for k, v in jw.items()})
    return out


def _q4_kernel_body(x, jw, block_f=128, out_dtype=jnp.float32):
    """The JAX kernel body, run by ``pallas_call`` in interpret mode on the
    CPU, with ``quant4_matmul_pallas``'s BlockSpecs (without the TPU memory
    space)."""
    import jax
    from jax.experimental import pallas as pl

    S, D = x.shape
    D2, F = jw["q4"].shape
    G = jw["scale"].shape[0]
    return pl.pallas_call(
        jq._q4mv_kernel_factory(D, G),
        grid=(F // block_f,),
        in_specs=[
            pl.BlockSpec((S, D), lambda i: (0, 0)),
            pl.BlockSpec((D2, block_f), lambda i: (0, i)),
            pl.BlockSpec((G, block_f), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((S, block_f), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((S, F), out_dtype),
        interpret=True,
    )(x, jw["q4"], jw["scale"])


@pytest.mark.parametrize("G", [2, 16])
@pytest.mark.parametrize("S", [1, 3, 64])
def test_quant4_matmul_plain_matches_jax_kernel_body(q4weight, S, G):
    """Both take exact bf16 × nibble products in f32, scale each group's
    partial sums and add them in f32: they agree up to the order of f32
    sums (an f32 output, so no final rounding hides a difference)."""
    jw, tw = q4weight[G]
    x = np.random.default_rng(20 + S).standard_normal((S, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_q4_kernel_body(xb, jw))
    x_bf16_valued = torch.from_numpy(np.array(xb.astype(jnp.float32)))
    got = tq.quant4_matmul_plain(x_bf16_valued, tw["q4"], tw["scale"])
    assert got.dtype == torch.float32 and got.shape == (S, 256)
    _close(got.numpy(), want)
    # bf16 in, bf16 out: one rounding of the same sum
    got_bf16 = tq.quant4_matmul_plain(x_bf16_valued.to(torch.bfloat16), tw["q4"], tw["scale"])
    assert got_bf16.dtype == torch.bfloat16
    _close(got_bf16.float().numpy(), want, rtol=2**-8)


@pytest.mark.parametrize("G", [2, 16])
@pytest.mark.parametrize("S", [1, 3, 64])
def test_qdot_int4_matches_jax(q4weight, S, G):
    jw, tw = q4weight[G]
    x = np.random.default_rng(40 + S).standard_normal((S, 256)).astype(np.float32)
    want = np.asarray(jq.qdot(jnp.asarray(x), jw))
    _close(tq.qdot(torch.from_numpy(x), tw).numpy(), want)
    assert tq.qdot(torch.from_numpy(x)[None], tw).shape == (1, S, 256)


def test_quant4_matmul_cpu_runs_plain_without_launching(q4weight):
    _, tw = q4weight[2]
    x = torch.randn(5, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = tq.quant4_matmul.launches
    got = tq.quant4_matmul(x, tw["q4"], tw["scale"])
    assert torch.equal(got, tq.quant4_matmul_plain(x, tw["q4"], tw["scale"]))
    assert tq.quant4_matmul.launches == before


@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("D,F,G", [(2048, 3072, 2), (2048, 16384, 16), (8192, 2048, 2),
                                   (8192, 1024, 64), (1024, 1024, 2), (96, 24, 6),
                                   (1024, 1536, 8)])
def test_q4mm_geometry_covers_every_row(S, D, F, G):
    """Every packed row lies in exactly one split, every split is
    non-empty, a cluster holds at most 16 blocks, and the launch is one the
    kernel is built for; each split's group segments cover its rows once."""
    D2 = D // 2
    if tq.quant_route(S) == "simt":
        vec, tpr, splits, rows = tq._q4mm_geometry(D, F, G, sms=132)
        assert 1 <= splits <= 16 and rows >= tq._MIN_SPLIT_ROWS or splits == 1
        assert vec in (16, 8) and F % vec == 0 and 16 % tpr == 0
    else:
        p = tq._q4mm_mma_plan(S, D, F, G, sms=132)
        splits, rows = p.splits, p.rows
        assert 1 <= splits <= 16 and (p.mt, p.nt, p.wk, p.wn) in _Q4MM_MMA_KERNELS
        assert F % (2 * p.mt) == 0 and 8 * p.nt >= S
    assert splits * rows >= D2 and (splits - 1) * rows < D2  # every split non-empty
    covered = []
    for k in range(splits):
        begin, end = k * rows, min(D2, (k + 1) * rows)
        covered += [d for _, a, b in tq._q4mm_segments(D, G, begin, end) for d in range(a, b)]
    assert covered == list(range(D2))  # every packed row exactly once, in order


@pytest.mark.parametrize("G_of", ["halves", "128-row groups"])
@pytest.mark.parametrize("D,F", _FLAGSHIP)
def test_q4mm_flagship_geometry_fills_the_card(D, F, G_of):
    """At S = 1 every flagship shape puts a block on each of the H100's 132
    SMs, two from ~1 MB of packed weight on (one per 4 KB below that), in
    clusters of at most 16 non-empty splits, at the trunks' G = 2 and at
    G = D/128; the split count is the fewest that reaches that aim."""
    G = 2 if G_of == "halves" else D // 128
    vec, tpr, splits, rows = tq._q4mm_geometry(D, F, G, sms=132)
    tiles = math.ceil(F / (vec * tpr))
    want = min(2 * 132, max(132, D * F / 2 / 4096))
    assert splits * tiles >= want and (splits == 1 or (splits - 1) * tiles < want)
    assert splits <= 16 and vec == 16 and (splits - 1) * rows < D // 2 <= splits * rows


@pytest.mark.parametrize("D,G,begin,end", [(256, 2, 0, 128), (256, 2, 40, 96), (256, 16, 0, 24),
                                           (256, 16, 8, 120), (8192, 64, 456, 912),
                                           (2048, 16, 832, 1024), (96, 6, 0, 48),
                                           (96, 6, 16, 32), (256, 16, 64, 64)])
def test_q4mm_segments_scale_each_group_once_per_block(D, G, begin, end):
    """A block's rows [begin, end) are cut at group boundaries: each group
    it touches appears once, in order, with exactly its rows of that group."""
    gs = D // G
    segs = tq._q4mm_segments(D, G, begin, end)
    groups = [g for g, _, _ in segs]
    assert groups == sorted(set(groups))  # each group once: one scale multiply per group
    assert [d for _, a, b in segs for d in range(a, b)] == list(range(begin, end))
    for g, a, b in segs:
        assert g * gs <= a < b <= (g + 1) * gs  # inside its group, non-empty


@pytest.mark.parametrize("rows", [8, 24, 40, 128])
@pytest.mark.parametrize("G", [2, 16])
@pytest.mark.parametrize("S", [1, 3])
def test_quant4_matmul_cluster_plain_matches_plain_and_jax_kernel_body(q4weight, S, G, rows):
    """The kernel's order of sums (splits of ``rows`` packed rows, each
    group scaled inside each block that touches it, blocks added in rank
    order) against ``quant4_matmul_plain`` and the JAX kernel body in
    interpret mode: the same exact products, f32 sums in another order."""
    jw, tw = q4weight[G]
    x = np.random.default_rng(60 + S).standard_normal((S, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32)))
    got = tq.quant4_matmul_cluster_plain(xt, tw["q4"], tw["scale"], rows)
    assert got.dtype == torch.float32 and got.shape == (S, 256)
    _close(got.numpy(), tq.quant4_matmul_plain(xt, tw["q4"], tw["scale"]).numpy())
    _close(got.numpy(), np.asarray(_q4_kernel_body(xb, jw)))
    got_bf16 = tq.quant4_matmul_cluster_plain(xt.to(torch.bfloat16), tw["q4"], tw["scale"], rows)
    assert got_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("rows,warps", [(16, 1), (48, 2), (64, 4), (128, 4), (112, 1)])
@pytest.mark.parametrize("G", [2, 16])
@pytest.mark.parametrize("S", [2, 3, 8, 13, 64])
def test_quant4_matmul_cluster_plain_per_warp_matches_plain_and_jax_kernel_body(q4weight, S, G,
                                                                                rows, warps):
    """The tensor-core route's order of sums (each split's 16-row k-steps
    dealt to ``warps`` warps in turn, a warp's group partials scaled into
    its running sum as its k-steps leave the group, warps and then blocks
    added in order) against ``quant4_matmul_plain`` and the JAX kernel body
    in interpret mode: the same exact products, f32 sums in another order."""
    jw, tw = q4weight[G]
    x = np.random.default_rng(90 + S).standard_normal((S, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32)))
    got = tq.quant4_matmul_cluster_plain(xt, tw["q4"], tw["scale"], rows, warps)
    assert got.dtype == torch.float32 and got.shape == (S, 256)
    _close(got.numpy(), tq.quant4_matmul_plain(xt, tw["q4"], tw["scale"]).numpy())
    _close(got.numpy(), np.asarray(_q4_kernel_body(xb, jw)))
    got_bf16 = tq.quant4_matmul_cluster_plain(xt.to(torch.bfloat16), tw["q4"], tw["scale"],
                                              rows, warps)
    assert got_bf16.dtype == torch.bfloat16
    _close(got_bf16.float().numpy(), got.numpy(), rtol=2**-8)


def test_quant4_matmul_cluster_plain_per_warp_refuses_groups_that_cut_a_k_step(q4weight):
    _, tw = q4weight[16]
    x = torch.zeros((2, 256))
    scale8 = tw["scale"].reshape(8, 2, 256)[:, 0].contiguous()  # G = 8: groups of 32 rows
    tq.quant4_matmul_cluster_plain(x, tw["q4"], scale8, 64, 2)
    with pytest.raises(ValueError):  # groups of 16 rows are not whole k-steps of 32
        tq.quant4_matmul_cluster_plain(x, tw["q4"], tw["scale"], 64, 2, k_step=32)


def test_quantize_and_dequantize_csm_int4_match_jax():
    """A stacked JAX int4 tree converts to the port's per-layer leaves,
    equals the port's own ``quantize_csm(bits=4)``, and dequantizes alike."""
    import jax

    from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
    from sesameai_tts_tpu.models.csm import init_csm_params
    from sesameai_tts_tpu_torch.convert import from_jax_params

    jp = init_csm_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32)
    jqp = jq.quantize_csm(jp, bits=4)
    assert jqp["backbone"]["layers"]["qkv"]["q4"].ndim == 3  # stacked on L
    want = from_jax_params(jax.tree.map(np.asarray, jqp))
    tqp = tq.quantize_csm(from_jax_params(jax.tree.map(np.asarray, jp)), bits=4)
    for trunk in ("backbone", "decoder"):
        assert len(want[trunk]["layers"]) == len(tqp[trunk]["layers"]) == 2
        for got_l, want_l in zip(tqp[trunk]["layers"], want[trunk]["layers"]):
            for k in ("qkv", "o_proj", "w13", "w2"):
                assert torch.equal(got_l[k]["q4"], want_l[k]["q4"])
                assert torch.equal(got_l[k]["scale"], want_l[k]["scale"])
                assert want_l[k]["scale"].shape[0] == 2  # half-matrix groups
    jd = from_jax_params(jax.tree.map(np.asarray, jq.dequantize_csm(jqp, jnp.float32)))
    td = tq.dequantize_csm(tqp, torch.float32)
    for trunk in ("backbone", "decoder"):
        for got_l, want_l in zip(td[trunk]["layers"], jd[trunk]["layers"]):
            for k in got_l:
                assert torch.equal(got_l[k], want_l[k])


# -- the fused MLP ----------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp_weights():
    D, F, Dout = 128, 512, 128
    rng = np.random.default_rng(7)
    jw13 = jq.quantize_weight(jnp.asarray(rng.standard_normal((D, 2 * F)) * 0.05, jnp.float32))
    jw2 = jq.quantize_weight(jnp.asarray(rng.standard_normal((F, Dout)) * 0.05, jnp.float32))

    def torch_w(jw):
        return {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}

    return jw13, jw2, torch_w(jw13), torch_w(jw2)


def _bf16_x(S, seed):
    x = (np.random.default_rng(seed).standard_normal((S, 128)) * 0.3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("S", [1, 2, 8])
def test_quant_mlp_plain_matches_jax_kernel(mlp_weights, S):
    """quant_mlp_plain vs quant_mlp_pallas in interpret mode, bf16 x, at the
    same intermediate tile.  The w13 sums run in another order, so a few
    a1, a3 or h values may round to the neighbouring bf16 value; the bf16
    outputs then differ by a small fraction of their peak (2e-2 of it, the
    bound the JAX package's own fused-vs-unfused test uses)."""
    jw13, jw2, tw13, tw2 = mlp_weights
    xb, xt = _bf16_x(S, 30 + S)
    want = np.asarray(jq.quant_mlp_pallas(xb, jw13["q"], jw13["scale"], jw2["q"], jw2["scale"],
                                          block_i=256, interpret=True), np.float32)
    got = tq.quant_mlp_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"], block_i=256)
    assert got.dtype == torch.bfloat16 and got.shape == (S, 128)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("block_i", [64, 256, 512])
def test_quant_mlp_plain_matches_the_unfused_sequence(mlp_weights, block_i):
    """The fused arithmetic against the unfused kernels' (quant_matmul_plain
    for w13, the bf16 silu·gate walk, quant_matmul_plain for w2): the
    hidden h is the same, only the w2 sum is split into tiles, so the bf16
    outputs differ by at most one rounding (2^-7 relative) plus f32 noise."""
    _, _, tw13, tw2 = mlp_weights
    _, xt = _bf16_x(4, 3)
    a = tq.quant_matmul_plain(xt, tw13["q"], tw13["scale"])
    gate = torch.nn.functional.silu(a[:, :512].float()).to(torch.bfloat16)
    want = tq.quant_matmul_plain(gate * a[:, 512:], tw2["q"], tw2["scale"]).float()
    got = tq.quant_mlp_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"],
                             block_i=block_i).float()
    assert bool(((got - want).abs() <= 2**-7 * want.abs() + 1e-5 * want.abs().max()).all())


def test_quant_mlp_cpu_runs_plain_without_launching(mlp_weights):
    _, _, tw13, tw2 = mlp_weights
    _, xt = _bf16_x(3, 5)
    before = tq.quant_mlp.launches
    got = tq.quant_mlp(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"])
    assert torch.equal(got, tq.quant_mlp_plain(xt, tw13["q"], tw13["scale"], tw2["q"],
                                               tw2["scale"]))
    assert tq.quant_mlp.launches == before


@pytest.mark.parametrize("fused", [False, True])
def test_qmlp_on_the_cpu_is_the_unfused_sequence(mlp_weights, fused):
    """On the CPU the fused configuration changes nothing: qmlp runs the
    JAX package's unfused sequence of two dense-dequant products."""
    jw13, jw2, tw13, tw2 = mlp_weights
    x = np.random.default_rng(9).standard_normal((2, 3, 128)).astype(np.float32)
    want = np.asarray(jq.qmlp(jnp.asarray(x), jw13, jw2))
    before = tq.quant_mlp.launches
    _close(tq.qmlp(torch.from_numpy(x), tw13, tw2, fused=fused).numpy(), want)
    assert tq.quant_mlp.launches == before


# -- quant_mlp's launch geometry and order of sums ---------------------------------

_MLP_FLAGSHIP = [(2048, 8192, 2048), (1024, 8192, 1024)]  # backbone, decoder MLPs


_MLP_TP2 = [(2048, 4096, 2048), (1024, 4096, 1024)]  # one rank's shards at tp = 2


@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("D,F,Dout", _MLP_FLAGSHIP)
def test_qmlp_geometry_fits_one_wave(S, D, F, Dout):
    """quant_mlp.cu's launch on a 132-SM H100, per route.  S = 1: whole
    tiles, clusters of at most 16 that divide the grid and that the card
    holds at once (one wave), shared memory within a block's 227 KB and at
    least the layout's, the prefetched w2 rows even and within the tile,
    and at least one block per SM.  S >= 2 (the tensor-core route): one
    block an SM at most, every block resident (the grid barriers)."""
    if tq.quant_route(S) == "mma":
        plan = tq._qmlp_mma_plan(S, D, F, Dout, 132)
        assert F // plan.block_i <= 132
        # a second block on an SM would not fit beside the first
        assert 2 * (plan.smem + tq._QMLP_BLOCK_RESERVED) > tq._QMLP_SM_SMEM
        return
    block_i, cluster, threads, rows, smem = tq._qmlp_geometry(S, D, F, Dout, 132)
    blocks = F // block_i
    assert F % block_i == 0 and block_i in tq._QMLP_TILES
    assert 1 <= cluster <= 16 and blocks % cluster == 0
    per_sm = math.ceil(blocks / 132)
    assert per_sm <= 2 and blocks // cluster <= tq._QMLP_CLUSTER_SLOTS[per_sm][cluster]
    assert threads % 32 == 0 and threads * per_sm <= 512 and threads % block_i == 0
    assert 0 <= rows <= block_i and rows % 2 == 0
    need = tq._qmlp_smem_bytes(block_i, Dout, threads, cluster, rows)
    assert need <= smem <= tq._QMLP_MAX_SMEM
    # no more blocks share an SM than the grid needs: clusters spread out
    assert (per_sm + 1) * (smem + tq._QMLP_BLOCK_RESERVED) > tq._QMLP_SM_SMEM
    if S == 1:
        assert blocks >= 132 and rows == block_i  # the whole w2 tile is prefetched


@pytest.mark.parametrize("S,F,Dout", [(65, 256, 24), (1, 48, 24), (1, 256, 20)])
def test_qmlp_geometry_rejects_what_the_kernel_does_not_take(S, F, Dout):
    with pytest.raises(ValueError):
        tq._qmlp_geometry(S, 64, F, Dout, 132)


@pytest.mark.parametrize("D,F,Dout", _MLP_FLAGSHIP + _MLP_TP2)
def test_qmlp_mma_plan_covers_the_mlp(D, F, Dout):
    """The tensor-core plan at every S from 2 to 64, walked as the kernel
    walks it: the n-tiles hold S rows; F / block_i blocks of whole passes
    of 32-column warps, one block an SM on a 132-SM H100 (a second would
    not fit beside it: every block is resident for the grid barriers);
    8 warps in each phase; the column tiles and the splits of F cover Dout
    and F once, every split non-empty, all on the grid's blocks; shared
    memory the layout's and within 227 KB, its ring stages whole k-steps of
    every warp."""
    for S in range(2, 65):
        p = tq._qmlp_mma_plan(S, D, F, Dout, 132)
        blocks = F // p.block_i
        assert p.nt in tq._QMLP_MMA_NT and 8 * p.nt >= S  # the fewest n-tiles
        assert p.nt == 1 or S > 4 * p.nt
        assert F % p.block_i == 0 and p.block_i % p.pass_cols == 0 and blocks <= 132
        assert p.pass_cols // 32 * p.wk1 == 8 and p.cols // 64 * p.wk2 == 8
        tiles = -(-Dout // p.cols)
        assert tiles * p.splits <= blocks and p.rows % 16 == 0
        assert (p.splits - 1) * p.rows < F <= p.splits * p.rows
        assert p.kc1 % (16 * p.wk1) == 0 and p.kc2 % (16 * p.wk2) == 0  # whole k-steps a warp
        need = tq._qmlp_mma_smem(p.nt, p.pass_cols, p.cols, p.kc1, p.kc2)
        assert need <= p.smem <= tq._MAX_SMEM
        assert 2 * (p.smem + tq._QMLP_BLOCK_RESERVED) > tq._QMLP_SM_SMEM


@pytest.mark.parametrize("S,D,F,Dout", [(1, 64, 256, 64), (0, 64, 256, 64), (65, 64, 256, 64),
                                        (8, 64, 240, 64), (8, 64, 256, 60), (8, 72, 256, 64)])
def test_qmlp_mma_plan_refuses_what_the_route_does_not_take(S, D, F, Dout):
    """S outside 2..64 (S = 1 is the CUDA-core route), F not whole
    32-column groups, Dout % 8 != 0, D % 16 != 0."""
    with pytest.raises(ValueError):
        tq._qmlp_mma_plan(S, D, F, Dout, 132)
    if not 1 <= S <= 64:
        with pytest.raises(ValueError):
            tq.quant_route(S)


@pytest.mark.parametrize("wk,aw,sp", [(4, 128, 8), (2, 128, 64), (8, 64, 16), (1, 256, 64),
                                      (4, 256, 32)])
def test_qmlp_stage_rows_hold_whole_k_steps(wk, aw, sp):
    """A ring stage holds whole k-steps of every warp along the reduction,
    at most the aimed weight bytes unless a single round of k-steps is more,
    and the ring fits a block's shared memory; a larger stage would break
    one of these."""
    kc = tq._qmlp_stage_rows(wk, aw, sp)
    assert kc % (16 * wk) == 0
    assert kc * aw <= tq._QMLP_MMA_STAGE_BYTES or kc == 16 * wk
    ring = tq._QMLP_MMA_HEADER + tq._QMLP_MMA_STAGES * tq._qmlp_stage_bytes(kc, aw, sp)
    assert ring <= tq._MAX_SMEM
    bigger = 2 * kc
    assert bigger > 256 or bigger * aw > tq._QMLP_MMA_STAGE_BYTES or (
        tq._QMLP_MMA_HEADER + tq._QMLP_MMA_STAGES * tq._qmlp_stage_bytes(bigger, aw, sp)
        > tq._MAX_SMEM)


@pytest.mark.parametrize("S", [2, 3, 8, 17, 64])
def test_quant_mlp_mma_plain_matches_jax_kernel_and_plain(mlp_weights, S):
    """The tensor-core route's order of sums (warps over k-steps, the splits
    of F in order) at the plan's tile against quant_mlp_pallas in interpret
    mode at the same tile width (the fused-vs-unfused bound, as in
    test_quant_mlp_plain_matches_jax_kernel) and against quant_mlp_plain
    within the tolerance the card's kernel is held to (chip_smoke.py:
    1e-2 relative plus 1e-3 of the peak): phase 1's sums run in another
    order, so a few hidden values may round to the neighbouring bf16."""
    jw13, jw2, tw13, tw2 = mlp_weights
    xb, xt = _bf16_x(S, 70 + S)
    plan = tq._qmlp_mma_plan(S, 128, 512, 128, 132)
    got = tq.quant_mlp_mma_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"], plan)
    assert got.dtype == torch.bfloat16 and got.shape == (S, 128)
    want = np.asarray(jq.quant_mlp_pallas(xb, jw13["q"], jw13["scale"], jw2["q"], jw2["scale"],
                                          block_i=plan.block_i, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max() + 1e-6)
    plain = tq.quant_mlp_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"]).float()
    assert bool(((got.float() - plain).abs() <= 1e-2 * plain.abs() + 1e-3 * plain.abs().max())
                .all())


@pytest.mark.parametrize("warps", [(2, 1), (4, 2), (8, 4)])
def test_quant_mlp_mma_plain_walks_the_plan(warps):
    """The emulation at other warp counts and a ragged split of F (F = 480
    in splits of 208 rows): the same terms in another order, within the
    card's tolerance of quant_mlp_plain."""
    rng = np.random.default_rng(13)
    D, F, Dout = 96, 480, 40
    w13 = tq.quantize_weight(torch.from_numpy(rng.standard_normal((D, 2 * F)).astype(np.float32)))
    w2 = tq.quantize_weight(torch.from_numpy(rng.standard_normal((F, Dout)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((5, D)).astype(np.float32) * 0.3).to(torch.bfloat16)
    wk1, wk2 = warps
    plan = tq._QmlpPlan(1, 32, 256 // wk1, 512 // wk2, 208, 3, 128, 128, 0)
    assert (plan.wk1, plan.wk2) == warps
    got = tq.quant_mlp_mma_plain(x, w13["q"], w13["scale"], w2["q"], w2["scale"], plan).float()
    want = tq.quant_mlp_plain(x, w13["q"], w13["scale"], w2["q"], w2["scale"]).float()
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3 * want.abs().max()).all())


@pytest.mark.parametrize("S,block_i,cluster", [(1, 32, 2), (2, 32, 4), (3, 64, 1), (8, 32, 16)])
def test_quant_mlp_cluster_plain_matches_jax_kernel_and_plain(mlp_weights, S, block_i, cluster):
    """The kernel's order of sums (tiles in rank order inside a cluster, the
    clusters by the grid's lane-and-tree order) against quant_mlp_pallas in
    interpret mode at the same tile width (the fused-vs-unfused bound, as
    in test_quant_mlp_plain_matches_jax_kernel) and against quant_mlp_plain
    at that width (the same tile partials in another f32 order: one bf16
    rounding apart)."""
    jw13, jw2, tw13, tw2 = mlp_weights
    xb, xt = _bf16_x(S, 50 + S)
    got = tq.quant_mlp_cluster_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"],
                                     block_i, cluster)
    assert got.dtype == torch.bfloat16 and got.shape == (S, 128)
    want = np.asarray(jq.quant_mlp_pallas(xb, jw13["q"], jw13["scale"], jw2["q"], jw2["scale"],
                                          block_i=block_i, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max() + 1e-6)
    plain = tq.quant_mlp_plain(xt, tw13["q"], tw13["scale"], tw2["q"], tw2["scale"],
                               block_i=block_i).float()
    assert bool(((got.float() - plain).abs() <= 2**-7 * plain.abs() + 1e-5 * plain.abs().max())
                .all())


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_quant_mlp_cluster_plain_with_more_clusters_than_lanes(cluster):
    """64 tiles: up to 64 cluster partials, two or more per lane of the
    grid's sum, against quant_mlp_plain."""
    rng = np.random.default_rng(11)
    D, F, Dout = 64, 2048, 32
    w13 = tq.quantize_weight(torch.from_numpy(rng.standard_normal((D, 2 * F)).astype(np.float32)))
    w2 = tq.quantize_weight(torch.from_numpy(rng.standard_normal((F, Dout)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32) * 0.3).to(torch.bfloat16)
    got = tq.quant_mlp_cluster_plain(x, w13["q"], w13["scale"], w2["q"], w2["scale"], 32,
                                     cluster).float()
    want = tq.quant_mlp_plain(x, w13["q"], w13["scale"], w2["q"], w2["scale"]).float()
    assert bool(((got - want).abs() <= 2**-7 * want.abs() + 1e-5 * want.abs().max()).all())


@pytest.mark.parametrize("device,rows,kernel", [
    ("cuda", 1, True), ("cuda", 8, True), ("cuda", 64, True),  # decode and a serving pool
    ("cuda", 65, False), ("cuda", 512, False),  # more rows: x @ dequant(w), as the JAX qdot
    ("cpu", 1, False), ("cpu", 64, False),  # the CPU always takes the dequant branch
])
def test_qdot_kernel_routing(device, rows, kernel):
    """On the card a quantized product of at most 64 rows goes to its kernel
    and more rows to x @ dequant(w), the JAX package's qdot threshold
    (``sesameai_tts_tpu/ops/quant.py::qdot``); ``qmlp`` keeps its own S <= 64."""
    assert tq.routes_to_kernel(device, rows) is kernel


@pytest.mark.parametrize("S", [65, 72])
def test_qdot_over_64_rows_is_the_dequant_product(qweight, S):
    """Past 64 rows qdot is ``x @ dequant(w)``, equal to the JAX package's
    qdot (which takes the same branch there)."""
    jw, tw = qweight
    x = np.random.default_rng(S).standard_normal((S, 64)).astype(np.float32)
    got = tq.qdot(torch.from_numpy(x), tw)
    assert torch.equal(got, torch.from_numpy(x) @ tq._dequant(tw, torch.float32))
    _close(got.numpy(), np.asarray(jq.qdot(jnp.asarray(x), jw)))


def test_launch_counts_are_exact_across_threads():
    """``count_launch`` from many threads at a short switch interval loses no
    update, and a thread's ``recording()`` (a graph capture) takes its own
    calls only: the others still reach the count."""
    import sys
    import threading

    from sesameai_tts_tpu_torch.ops import kernels

    def wrapper():
        pass

    wrapper.launches = 0
    recorded = {}

    def count(n):
        for _ in range(n):
            kernels.count_launch(wrapper)

    def capture():
        with kernels.recording() as rec:
            count(500)
        recorded.update(rec)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count, args=(2000,)) for _ in range(16)]
        threads.append(threading.Thread(target=capture))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000
    assert recorded == {wrapper: 500}
