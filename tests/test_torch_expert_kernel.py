"""The routed FFN (``ops/moe.py``): LFM2-MoE's router, the grouped int8
expert kernel (``csrc/expert_swiglu.cu``) and its plain version.

The CPU tests hold the routing cases, the plain version against the dense
route (every expert over every row, weighted by the routing), which route
``moe_ffn`` takes (int8 experts the wrapper at any rows, unquantized ones
the dense route) and the wrapper's checks; the ``gpu`` tests, which skip
without a card, hold the kernel against the plain version at the
published expert shape (2,048 × 1,792, 32 experts, top 4) at 1, 16 and
64 rows with uneven routing, eagerly, from a CUDA-graph replay, and at
150 rows in chunks of 64.  The file imports no JAX:

    python -m pytest tests/test_torch_expert_kernel.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.ops import kernels
from sesameai_tts_tpu_torch.ops import moe
from sesameai_tts_tpu_torch.ops.quant import quantize_weight


def _experts(seed, E, D, Fe, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    w13 = quantize_weight(torch.randn((E, D, 2 * Fe), generator=g) / D ** 0.5)
    w2 = quantize_weight(torch.randn((E, Fe, D), generator=g) / Fe ** 0.5)
    return ({k: v.to(device) for k, v in w13.items()}, {k: v.to(device) for k, v in w2.items()})


def _routing(seed, N, E, k, skew=0.0):
    """ids (N, k) of distinct experts a row (row n prefers low experts with
    weight ``skew``: uneven routing), weights (N, k) f32."""
    rng = np.random.default_rng(seed)
    p = np.exp(-skew * np.arange(E))
    p /= p.sum()
    ids = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(N)])
    w = rng.uniform(0.05, 1.0, size=(N, k)).astype(np.float32)
    return torch.from_numpy(ids).long(), torch.from_numpy(w / w.sum(1, keepdims=True))


# -- the router --------------------------------------------------------------------


def test_the_bias_changes_the_choice_but_not_the_weights():
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    gate = torch.tensor([[2.0, 1.0, 0.0, -1.0], [0.0, 0.5, 1.5, 0.2]])
    bias = torch.tensor([0.0, 0.0, 0.0, 1.0])
    ids0, w0 = moe.route(x, gate, None, 2, norm_topk_prob=False)
    ids1, w1 = moe.route(x, gate, bias, 2, norm_topk_prob=False)
    scores = torch.sigmoid(x @ gate)
    assert ids0.tolist() == [[0, 1], [2, 1]]
    assert ids1.tolist() == [[3, 0], [3, 2]]  # expert 3 chosen through its bias
    # the weights are the chosen experts' σ scores, the bias left out
    assert torch.equal(w1, scores.gather(1, ids1))
    assert torch.equal(w0, scores.gather(1, ids0))


def test_norm_topk_prob_and_the_scaling():
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(1))
    gate = torch.randn(8, 6, generator=torch.Generator().manual_seed(2))
    ids, raw = moe.route(x, gate, None, 3, norm_topk_prob=False)
    ids2, normed = moe.route(x, gate, None, 3, norm_topk_prob=True, scaling=2.5)
    assert torch.equal(ids, ids2)
    want = raw / (raw.sum(dim=-1, keepdim=True) + 1e-6) * 2.5
    assert torch.allclose(normed, want, rtol=0, atol=0)
    assert torch.allclose(normed.sum(-1), torch.full((5,), 2.5), atol=1e-5)


def _dense_reference(x, ids, w, w13, w2):
    """Σ_j w[n, j] · SwiGLU of the dequantized expert ids[n, j], row by row."""
    out = torch.zeros_like(x)
    for n in range(x.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[n, j])
            a = x[n] @ (w13["q"][e].float() * w13["scale"][e])
            Fe = a.shape[-1] // 2
            h = torch.nn.functional.silu(a[:Fe]) * a[Fe:]
            out[n] += w[n, j] * (h @ (w2["q"][e].float() * w2["scale"][e]))
    return out


@pytest.mark.parametrize("case", ["uneven", "an expert with no rows", "every row on one expert"])
def test_the_plain_version_and_the_dense_route_agree(case):
    E, D, Fe, k, N = 6, 16, 8, 2, 7
    w13, w2 = _experts(3, E, D, Fe)
    x = torch.randn(N, D, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16).float()
    ids, w = _routing(5, N, E - 1, k, skew=1.0)  # expert E-1 takes no row
    if case == "uneven":
        ids = torch.where(ids == 0, torch.tensor(E - 1), ids)  # nor does expert 0 now
    if case == "every row on one expert":
        ids[:, 0] = E - 1
    want = _dense_reference(x, ids, w, w13, w2)
    stats = torch.zeros(2, dtype=torch.int32)
    plain = moe.expert_swiglu_plain(x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"],
                                    stats)
    dense = moe.moe_ffn_dense(x, ids, w, w13, w2)
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert stats.tolist() == [int((counts > 0).sum()), int(counts.max())]
    assert torch.allclose(plain, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(dense, want, atol=1e-4, rtol=1e-4)


def test_the_counters_add_over_calls():
    E = 4
    stats = torch.zeros(2, dtype=torch.int32)
    moe._record(stats, torch.tensor([[0, 1], [0, 2]]), E)
    moe._record(stats, torch.tensor([[3, 1]]), E)
    assert stats.tolist() == [3 + 2, 2]


def test_cpu_tensors_take_the_plain_path():
    w13, w2 = _experts(1, 4, 16, 8)
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ids, w = _routing(2, 3, 4, 2)
    before = moe.expert_swiglu.launches
    got = moe.expert_swiglu(x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    want = moe.expert_swiglu_plain(x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    assert torch.equal(got, want) and moe.expert_swiglu.launches == before


def _layer(w13, w2, D, E, seed=6):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn((D, E), generator=g), "expert_bias": torch.zeros(E),
            "experts_w13": w13, "experts_w2": w2}


_CFG = type("Cfg", (), {"use_expert_bias": True, "num_experts_per_tok": 2,
                        "norm_topk_prob": True, "routed_scaling_factor": 1.0})


@pytest.mark.parametrize("rows", [3, 70])
def test_moe_ffn_sends_int8_experts_to_the_wrapper_at_any_rows(monkeypatch, rows):
    E, D, Fe = 4, 16, 8
    w13, w2 = _experts(7, E, D, Fe)
    wl = _layer(w13, w2, D, E)
    x = torch.randn(rows, D, generator=torch.Generator().manual_seed(8)).to(torch.bfloat16)
    seen = []
    wrapper = moe.expert_swiglu

    def spy(xs, ids, *a, **kw):
        seen.append(xs.shape[0])
        return wrapper(xs, ids, *a, **kw)

    monkeypatch.setattr(moe, "expert_swiglu", spy)
    monkeypatch.setattr(moe, "moe_ffn_dense", lambda *a, **kw: pytest.fail("dense route"))
    stats = torch.zeros(2, dtype=torch.int32)
    got = moe.moe_ffn(x, wl, _CFG, stats)
    ids, w = moe.route(x, wl["router"], wl["expert_bias"], 2)
    want = moe.expert_swiglu_plain(x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    assert seen == [rows] and torch.equal(got, want)  # a CPU tensor: the plain version whole
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert stats.tolist() == [int((counts > 0).sum()), int(counts.max())]


def test_moe_ffn_sends_unquantized_experts_to_the_dense_route():
    E, D, Fe = 4, 16, 8
    w13, w2 = _experts(9, E, D, Fe)
    dense13 = w13["q"].float() * w13["scale"][:, None, :]
    dense2 = w2["q"].float() * w2["scale"][:, None, :]
    wl = _layer(dense13, dense2, D, E)
    x = torch.randn(5, D, generator=torch.Generator().manual_seed(10))
    ids, w = moe.route(x, wl["router"], wl["expert_bias"], 2)
    got = moe.moe_ffn(x, wl, _CFG)
    assert torch.equal(got, moe.moe_ffn_dense(x, ids, w, dense13, dense2))
    assert torch.allclose(got, _dense_reference(x, ids, w, w13, w2), atol=1e-5, rtol=1e-5)


def test_the_kernel_is_bound_and_counted():
    wrappers = kernels.wrappers()
    assert wrappers["expert_swiglu"] is moe.expert_swiglu
    assert kernels._SIGNATURES["expert_swiglu"][-1] is kernels._P


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _card_case(N, skew, seed=0):
    E, D, Fe, k = 32, 2048, 1792, 4
    w13, w2 = _experts(seed, E, D, Fe, "cuda")
    x = (torch.randn(N, D, generator=torch.Generator().manual_seed(seed + 1))
         .to(torch.bfloat16).cuda())
    ids, w = _routing(seed + 2, N, E, k, skew)
    return x, ids.cuda(), w.cuda(), w13, w2


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 16, 64])
@pytest.mark.parametrize("skew", [0.0, 0.3])
def test_the_kernel_matches_the_plain_version(cuda, N, skew):
    x, ids, w, w13, w2 = _card_case(N, skew)
    args = (x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    stats = torch.zeros(2, dtype=torch.int32, device="cuda")
    got = moe.expert_swiglu(*args, stats=stats)
    torch.cuda.synchronize()
    want = moe.expert_swiglu_plain(*args)  # the plain version on the card's tensors
    counts = torch.bincount(ids.reshape(-1), minlength=32)
    assert stats.tolist() == [int((counts > 0).sum()), int(counts.max())]
    err = (got.float() - want.float()).abs().max().item()
    # f32 sums in another order, then one bf16 rounding each side
    assert err <= 1e-2 * want.float().abs().max().item(), err
    again = moe.expert_swiglu(*args)
    assert torch.equal(got, again)  # no atomics in the sums: the same bits


@pytest.mark.gpu
def test_every_row_on_one_expert_and_a_graph_replay(cuda):
    x, _, w, w13, w2 = _card_case(64, 0.0, seed=3)
    rng = np.random.default_rng(4)
    others = [e for e in range(32) if e != 7]
    ids = torch.tensor([[7] + list(rng.choice(others, 3, replace=False)) for _ in range(64)],
                       device="cuda")
    args = (x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    eager = moe.expert_swiglu(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.expert_swiglu(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = moe.expert_swiglu(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    want = moe.expert_swiglu_plain(*args)
    assert (eager.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


@pytest.mark.gpu
def test_more_rows_than_the_kernel_takes_go_through_it_in_chunks(cuda):
    E, D, Fe = 32, 2048, 1792
    w13, w2 = _experts(5, E, D, Fe, "cuda")
    wl = {k: v.cuda() for k, v in _layer(None, None, D, E).items() if v is not None}
    wl.update(experts_w13=w13, experts_w2=w2)
    cfg = type("Cfg", (_CFG,), {"num_experts_per_tok": 4})
    x = (torch.randn(150, D, generator=torch.Generator().manual_seed(6)) / 4).to(
        torch.bfloat16).cuda()
    stats = torch.zeros(2, dtype=torch.int32, device="cuda")
    before = moe.expert_swiglu.launches
    got = moe.moe_ffn(x, wl, cfg, stats)
    assert moe.expert_swiglu.launches - before == 3 * 3  # 64 + 64 + 22 rows
    ids, w = moe.route(x, wl["router"], wl["expert_bias"], 4)
    want = moe.expert_swiglu_plain(x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert stats.tolist() == [int((counts > 0).sum()), int(counts.max())]
