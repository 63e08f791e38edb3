"""The sampler's kernel (``csrc/topk_sample.cu``) against the plain path.

``sample_topk`` sends a CPU tensor to ``sample_topk_plain`` (held against
the JAX package by ``tests/test_torch_sampling.py``) and a CUDA tensor to
the kernel.  The CPU tests here hold the routing and the wrapper's checks;
the ``gpu`` tests, which skip without a card, hold the kernel's tokens
bit-equal to the plain path's for the same noise, eagerly and from a
CUDA-graph replay.  The file imports no JAX:

    python -m pytest tests/test_torch_sampling_kernel.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.ops import kernels
from sesameai_tts_tpu_torch.ops import sampling as ts

# the card grid: (rows, V); 4,097 and 128,256 are past what a block keeps
# in registers, so they read the row again each pass
_GRID = [(1, 2051), (16, 2051), (64, 2051), (16, 128), (1, 4097), (16, 4097), (64, 4097),
         (1, 128256)]
_TEMPERATURES = (1e-4, 0.8, 1.0, 2.0)


def _ks(V):
    return (1, 2, 40, V - 1, V, V + 5)


def _inputs(seed, rows, V):
    """Logits with the hard rows first (-inf bans, an all-banned row, exact
    ties, logits of large magnitude), then N(0, 3²) rows; Gumbel noise."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, V)) * 3).astype(np.float32)
    hard = [
        lambda r: r.__setitem__(slice(0, V // 2), -np.inf),
        lambda r: r.__setitem__(slice(None), -np.inf),
        lambda r: r.__setitem__(slice(None), np.round(r)),
        lambda r: r.__setitem__(slice(None), r * np.float32(1e37)),
        lambda r: r.__setitem__(slice(None), r * np.float32(1e30)),
    ]
    for row, make in zip(logits, hard):
        make(row)
    return logits, rng.gumbel(size=(rows, V)).astype(np.float32)


def _plain(logits, gumbel, topk, temperature):
    """The plain path on the CPU, from numpy inputs."""
    as_t = (lambda v: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v)
    return ts.sample_topk_plain(None, torch.from_numpy(logits), as_t(topk), as_t(temperature),
                                gumbel=torch.from_numpy(gumbel)).numpy()


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True])
def test_cpu_tensors_take_the_plain_path(per_row):
    logits, g = _inputs(1, 6, 67)
    if per_row:
        topk, temperature = np.array([1, 2, 5, 40, 67, 72]), np.array(_TEMPERATURES * 2)[:6]
        topk, temperature = topk.astype(np.int64), temperature.astype(np.float32)
    else:
        topk, temperature = 5, 0.8
    want = _plain(logits, g, topk, temperature)
    as_t = (lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
    before = (ts.topk_sample.launches, ts.sample_topk_plain.launches)
    routed = ts.sample_topk(None, torch.from_numpy(logits), as_t(topk), as_t(temperature),
                            gumbel=torch.from_numpy(g))
    wrapped = ts.topk_sample(torch.from_numpy(logits), torch.from_numpy(g), as_t(temperature),
                             as_t(topk))
    np.testing.assert_array_equal(routed.numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert (ts.topk_sample.launches, ts.sample_topk_plain.launches) == before


def _bad_operands():
    logits, g = torch.zeros(4, 67), torch.zeros(4, 67)
    return {
        "f64 logits": ((logits.double(), g, 0.8, 5), TypeError),
        "bf16 gumbel": ((logits, g.bfloat16(), 0.8, 5), TypeError),
        "gumbel shape": ((logits, g[:, :66].contiguous(), 0.8, 5), ValueError),
        "logits not contiguous": ((torch.zeros(67, 4).t(), g, 0.8, 5), ValueError),
        "gumbel not contiguous": ((logits, torch.zeros(67, 4).t(), 0.8, 5), ValueError),
        "0-dim logits": ((torch.zeros(()), torch.zeros(()), 0.8, 5), ValueError),
        "no vocabulary": ((torch.zeros(4, 0), torch.zeros(4, 0), 0.8, 5), ValueError),
        "no rows": ((torch.zeros(0, 67), torch.zeros(0, 67), 0.8, 5), ValueError),
        "f64 temperature": ((logits, g, torch.full((4,), 0.8, dtype=torch.float64), 5),
                            TypeError),
        "int32 topk": ((logits, g, 0.8, torch.full((4,), 5, dtype=torch.int32)), TypeError),
        "temperature shape": ((logits, g, torch.full((3,), 0.8), 5), ValueError),
        "topk shape": ((logits, g, 0.8, torch.full((4, 1), 5)), ValueError),
        "topk not contiguous": ((logits, g, 0.8, torch.full((4, 2), 5)[:, 0]), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_topk_sample_rejects_bad_operands(case):
    args, error = _bad_operands()[case]
    with pytest.raises(error):
        ts.topk_sample(*args)


def test_every_kernel_has_a_counted_wrapper():
    wrappers = kernels.wrappers()
    assert tuple(wrappers) == kernels.KERNELS and wrappers["topk_sample"] is ts.topk_sample
    assert all(isinstance(fn.launches, int) for fn in wrappers.values())


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _replayed(fn):
    """fn()'s output from a CUDA-graph replay, warmed up on the capture's
    stream first (the sampled decode graph's way)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    out.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    return out


def _on_card(cuda, logits, g, topk, temperature, replay):
    """sample_topk on the card (the kernel) → (tokens, launches it made)."""
    to = (lambda v: torch.from_numpy(np.asarray(v)).to(cuda)
          if isinstance(v, np.ndarray) else v)
    args = (torch.from_numpy(logits).to(cuda), to(topk), to(temperature))
    noise = torch.from_numpy(g).to(cuda)
    before = ts.topk_sample.launches

    def call():
        return ts.sample_topk(None, *args, gumbel=noise)

    out = _replayed(call) if replay else call()
    torch.cuda.synchronize()
    return out.cpu().numpy(), ts.topk_sample.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("rows,V", _GRID)
def test_kernel_equals_plain_per_row(cuda, rows, V, replay):
    """Per-row k and temperature (the pool's form): row i of shift s takes
    the (k, temperature) pair i + s of the grid's 24, so one row sees them
    all and 64 rows see them at once."""
    logits, g = _inputs(rows * 7 + V, rows, V)
    pairs = [(k, t) for t in _TEMPERATURES for k in _ks(V)]
    for shift in range(len(pairs) if rows == 1 else 4):
        chosen = [pairs[(i + shift) % len(pairs)] for i in range(rows)]
        topk = np.array([k for k, _ in chosen], np.int64)
        temperature = np.array([t for _, t in chosen], np.float32)
        want = _plain(logits, g, topk, temperature)
        got, launches = _on_card(cuda, logits, g, topk, temperature, replay)
        np.testing.assert_array_equal(got, want, err_msg=f"k {topk} T {temperature}")
        assert launches == (2 if replay else 1)  # the warm-up, then the capture


@pytest.mark.gpu
@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("rows,V", [(1, 2051), (16, 2051), (16, 4097), (1, 128256)])
def test_kernel_equals_plain_scalar(cuda, rows, V, replay):
    """A number or a 0-dim tensor for k and for temperature."""
    logits, g = _inputs(rows * 11 + V, rows, V)
    for k in _ks(V)[1:]:
        for temperature in _TEMPERATURES:
            want = _plain(logits, g, k, temperature)
            for form_k, form_t in ((k, temperature),
                                   (np.array(k, np.int64), np.array(temperature, np.float32))):
                got, launches = _on_card(cuda, logits, g, form_k, form_t, replay)
                np.testing.assert_array_equal(got, want, err_msg=f"k {k} T {temperature}")
                assert launches == (2 if replay else 1)


@pytest.mark.gpu
def test_drawn_noise_and_greedy_numbers(cuda):
    """The c0 call (noise drawn inside from the generator) takes the same
    noise as gumbel_noise from that generator; a number topk <= 1 is the
    argmax and launches nothing; the plain path on the card is counted."""
    logits, _ = _inputs(3, 16, 2051)
    x = torch.from_numpy(logits).to(cuda)
    topk = torch.full((16,), 40, device=cuda)
    temperature = torch.full((16,), 0.8, device=cuda)
    got = ts.sample_topk(torch.Generator(device=cuda).manual_seed(9), x, topk, temperature)
    noise = ts.gumbel_noise(torch.Generator(device=cuda).manual_seed(9), x.shape)
    want = _plain(logits, noise.cpu().numpy(), topk.cpu().numpy(), temperature.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    before = (ts.topk_sample.launches, ts.sample_topk_plain.launches)
    for k in (0, 1):
        np.testing.assert_array_equal(ts.sample_topk(None, x, k, 0.8).cpu().numpy(),
                                      logits.argmax(-1))
    assert (ts.topk_sample.launches, ts.sample_topk_plain.launches) == before
    card_plain = ts.sample_topk_plain(None, x, topk, temperature, gumbel=noise)
    np.testing.assert_array_equal(card_plain.cpu().numpy(), want)
    assert ts.sample_topk_plain.launches == before[1] + 1


@pytest.mark.gpu
def test_kernel_rejects_a_tensor_on_another_device(cuda):
    x = torch.zeros(4, 67, device=cuda)
    with pytest.raises(ValueError):
        ts.topk_sample(x, torch.zeros(4, 67), 0.8, 5)
    with pytest.raises(ValueError):
        ts.topk_sample(x, torch.zeros_like(x), torch.full((4,), 0.8), 5)
