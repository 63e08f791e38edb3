"""The port's training objective and train steps (``sesameai_tts_tpu_torch/
training/{loss,train_step}.py``) on the CPU against the JAX package at the
tiny f32 flavor, inputs from a numpy seed and the JAX init converted by
``from_jax_params``:

* ``csm_loss`` (loss, ``c0_loss``, ``decoder_loss``) within 1e-5 relative,
  with the first-N decoder subset and with injected ``subset_r`` scores;
* every gradient leaf within 1e-5 of the leaf's largest magnitude (the
  attention's gradient is the port's ``flash_attention_bwd_plain``, JAX's
  is XLA's autodiff of ``_attention``);
* three ``make_train_step`` steps against optax's chain: params within
  1e-5 absolute (updates of lr = 1e-3 per step), ``mu`` and ``nu`` within
  1e-5 of each leaf's largest magnitude, the metrics (``grad_norm``
  included) within 1e-5 relative, and a first step of lr 0;
* the mixed-precision step, remat, gradient accumulation, the text-only
  batch and the per-step decoder subset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
from sesameai_tts_tpu.models.csm import init_csm_params as j_init
from sesameai_tts_tpu.training import train_step as jts
from sesameai_tts_tpu.training.loss import Batch as JBatch
from sesameai_tts_tpu.training.loss import csm_loss as j_loss
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.ops import attention as ta
from sesameai_tts_tpu_torch.training import train_step as ts
from sesameai_tts_tpu_torch.training.loss import Batch, csm_loss

JCFG, CFG = j_tiny(), csm_test_tiny()
K = CFG.audio_num_codebooks
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest magnitude
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's intra-op threads contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, B=2, S=16, audio_rows=8):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    text = S - audio_rows
    tokens[:, :text, K] = rng.integers(1, JCFG.text_vocab_size, (B, text))
    mask[:, :text, K] = True
    tokens[:, text:, :K] = rng.integers(1, JCFG.audio_vocab_size, (B, audio_rows, K))
    mask[:, text:, :K] = True
    return tokens, mask, np.ones((B, S), bool)


def _batches(arrays):
    return (JBatch(*(jnp.asarray(a) for a in arrays)),
            Batch(*(torch.from_numpy(a) for a in arrays)))


@pytest.fixture(scope="module")
def params():
    """(JAX params, numpy copy) of the tiny f32 init."""
    jp = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(np_tree):
    return from_jax_params(np_tree)


def _assert_leaves_close(want_tree, got_tree, rel=None, atol=None):
    want, got = ts.tree_leaves(want_tree), ts.tree_leaves(got_tree)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        tol = atol if atol is not None else rel * max(a.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= tol, ((a - b).abs().max().item(), tol)


def _assert_metrics_close(jm, tm, keys=("loss", "c0_loss", "decoder_loss")):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("subset", [None, "scores"])
def test_loss_matches_jax(params, subset):
    jp, np_p = params
    jb, tb = _batches(_arrays(1, S=24, audio_rows=14))
    r = None if subset is None else np.random.default_rng(2).random((2, 23), np.float32)
    _, jm = j_loss(jp, JCFG, jb, decoder_frames=3,
                   subset_r=None if r is None else jnp.asarray(r))
    loss, tm = csm_loss(_port(np_p), CFG, tb, decoder_frames=3,
                        subset_r=None if r is None else torch.from_numpy(r))
    assert tm["loss"] is loss
    _assert_metrics_close(jm, tm)


def test_gradients_match_jax(params):
    jp, np_p = params
    jb, tb = _batches(_arrays(3))
    (_, jm), jg = jax.value_and_grad(lambda p: j_loss(p, JCFG, jb, 2), has_aux=True)(jp)
    tm, tg = ts._value_and_grad(lambda p: csm_loss(p, CFG, tb, 2), _port(np_p))
    _assert_metrics_close(jm, tm)
    _assert_leaves_close(_port(jax.tree.map(np.asarray, jg)), tg, rel=GRAD_TOL)


def _jax_steps(jp, jb, n, **kw):
    tx = jts.make_optimizer(lr=1e-3, warmup=1, total_steps=3)
    state = jts.init_train_state(jax.tree.map(jnp.copy, jp), tx)
    step = jts.make_train_step(JCFG, tx, decoder_frames=2, subset_rng=False, **kw)
    metrics = []
    for _ in range(n):
        state, m = step(state, jb)
        metrics.append(m)
    return state, metrics


def _port_steps(np_p, tb, n, **kw):
    tx = ts.make_optimizer(lr=1e-3, warmup=1, total_steps=3)
    state = ts.init_train_state(_port(np_p), tx)
    step = ts.make_train_step(CFG, tx, decoder_frames=2, subset_rng=False, **kw)
    metrics = []
    for _ in range(n):
        state, m = step(state, tb)
        metrics.append(m)
    return state, metrics


def test_three_steps_match_optax(params):
    jp, np_p = params
    jb, tb = _batches(_arrays(4))
    jstate, jms = _jax_steps(jp, jb, 3)
    tx = ts.make_optimizer(lr=1e-3, warmup=1, total_steps=3)
    state = ts.init_train_state(_port(np_p), tx)
    step = ts.make_train_step(CFG, tx, decoder_frames=2, subset_rng=False)
    state, first = step(state, tb)
    # the schedule is read before the update: the first update has lr 0
    assert float(tx.learning_rate(torch.tensor(0, dtype=torch.int32))) == 0.0
    _assert_leaves_close(_port(np_p), state.params, atol=0.0)
    tms = [first]
    for _ in range(2):
        state, m = step(state, tb)
        tms.append(m)
    for jm, tm in zip(jms, tms):
        _assert_metrics_close(jm, tm, ("loss", "c0_loss", "decoder_loss", "grad_norm"))
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    adam = jstate.opt_state[1][0]
    assert int(state.opt_state["count"]) == int(adam.count) == 3
    _assert_leaves_close(_port(jax.tree.map(np.asarray, jstate.params)), state.params,
                         atol=PARAM_ATOL)
    for name in ("mu", "nu"):
        _assert_leaves_close(_port(jax.tree.map(np.asarray, getattr(adam, name))),
                             state.opt_state[name], rel=GRAD_TOL)


@pytest.mark.parametrize("total,warmup", [(10, 3), (5, 0), (4, 1)])
def test_learning_rate_is_optax_schedule(total, warmup):
    import optax

    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1),
                                              end_value=3e-5)
    tx = ts.make_optimizer(lr=3e-4, warmup=warmup, total_steps=total)
    for count in range(total + 3):
        got = float(tx.learning_rate(torch.tensor(count, dtype=torch.int32)))
        np.testing.assert_allclose(got, float(want(count)), rtol=1e-6, atol=1e-12)


def test_clip_scales_only_above_the_max_norm():
    """clip_by_global_norm(1.0): g / ‖g‖ (no epsilon) when ‖g‖ ≥ 1, g below."""
    tx = ts.make_optimizer(lr=1.0, weight_decay=0.0, warmup=0, total_steps=10)
    for scale, clipped in ((0.5, False), (3.0, True)):
        p = {"w": torch.zeros(4)}
        g = torch.tensor([scale, 0.0, 0.0, 0.0])
        state = tx.init(p)
        norm = tx.apply(p, {"w": g.clone()}, state)
        assert float(norm) == scale
        want = g / scale if clipped else g
        assert torch.equal(state["mu"]["w"], (1 - 0.9) * want)


def test_mixed_precision_step(params):
    """compute_dtype=bf16 with f32 params: the step's loss is that of the
    bf16-cast params, the master params stay f32 and move after the lr-0
    first step; against JAX's mixed step within 2e-2 relative (bf16
    rounding lands at other places in the two frameworks)."""
    jp, np_p = params
    jb, tb = _batches(_arrays(9))
    base = _port(np_p)
    _, ref = csm_loss(ts._cast_floating(base, torch.bfloat16), CFG, tb, decoder_frames=2)
    state, ms = _port_steps(np_p, tb, 2, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(ms[0]["loss"]), float(ref["loss"]), rtol=1e-6)
    assert all(x.dtype == torch.float32 for x in ts.tree_leaves(state.params))
    assert any(not torch.equal(a, b) for a, b in zip(ts.tree_leaves(base),
                                                     ts.tree_leaves(state.params)))
    _, jms = _jax_steps(jp, jb, 1, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(float(ms[0]["loss"]), float(jms[0]["loss"]), rtol=2e-2)


def test_remat_equals_no_remat(params, monkeypatch):
    """remat recomputes the backbone's layers in the backward pass (each
    attention runs twice there) and changes neither the loss nor a bit of
    the gradients."""
    _, np_p = params
    _, tb = _batches(_arrays(5))
    calls = []
    plain = ta.flash_attention_plain
    monkeypatch.setattr(ta, "flash_attention_plain", lambda *a: calls.append(1) or plain(*a))
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = ts._value_and_grad(lambda p: csm_loss(p, CFG, tb, 2, remat=remat),
                                        _port(np_p))
        out[remat] = out[remat] + (len(calls),)
    bb, dec = CFG.backbone.num_layers, CFG.decoder.num_layers
    assert out[False][2] == bb + dec and out[True][2] == 2 * bb + dec
    assert float(out[False][0]["loss"]) == float(out[True][0]["loss"])
    _assert_leaves_close(out[False][1], out[True][1], atol=0.0)


def test_accumulation_matches_jax_and_full_batch(params):
    """accum_steps=2 on a batch whose examples share one mask structure:
    against JAX's accumulated step, and against the port's full-batch step
    (the microbatch mean equals the full-batch masked mean there)."""
    jp, np_p = params
    jb, tb = _batches(_arrays(2, B=4, S=24, audio_rows=16))
    jstate, jms = _jax_steps(jp, jb, 2, accum_steps=2)
    state, ms = _port_steps(np_p, tb, 2, accum_steps=2)
    full, fms = _port_steps(np_p, tb, 2)
    for jm, m, fm in zip(jms, ms, fms):
        _assert_metrics_close(jm, m, ("loss", "c0_loss", "decoder_loss", "grad_norm"))
        np.testing.assert_allclose(float(m["loss"]), float(fm["loss"]), rtol=1e-5)
    _assert_leaves_close(_port(jax.tree.map(np.asarray, jstate.params)), state.params,
                         atol=PARAM_ATOL)
    _assert_leaves_close(full.params, state.params, atol=PARAM_ATOL)


def test_text_only_batch_has_zero_losses(params):
    _, np_p = params
    tokens = np.zeros((1, 8, K + 1), np.int32)
    mask = np.zeros((1, 8, K + 1), bool)
    mask[:, :, K] = True
    tokens[:, :, K] = np.arange(1, 9)
    _, tb = _batches((tokens, mask, np.ones((1, 8), bool)))
    loss, m = csm_loss(_port(np_p), CFG, tb, decoder_frames=2)
    assert float(loss) == 0.0 and float(m["c0_loss"]) == 0.0
    assert float(m["decoder_loss"]) == 0.0


def test_decoder_subset_varies_across_steps(params):
    """The per-step scores are a function of (seed, step) alone: other steps
    train other audio rows, the same step the same ones, and the c0 loss
    covers every audio row either way."""
    _, np_p = params
    r1 = ts._subset_scores(1, 2, 16, seed=0)
    r2 = ts._subset_scores(2, 2, 16, seed=0)
    assert r1.shape == (2, 15) and not torch.equal(r1, r2)
    assert torch.equal(r1, ts._subset_scores(1, 2, 16, seed=0))
    assert not torch.equal(r1, ts._subset_scores(1, 2, 16, seed=1))
    _, tb = _batches(_arrays(5, B=1))  # 8 audio rows, 2 trained
    p = _port(np_p)
    _, m1 = csm_loss(p, CFG, tb, decoder_frames=2, subset_r=r1[:1])
    _, m2 = csm_loss(p, CFG, tb, decoder_frames=2, subset_r=r2[:1])
    assert float(m1["decoder_loss"]) != float(m2["decoder_loss"])
    assert float(m1["c0_loss"]) == float(m2["c0_loss"])
    # the step draws them from its own counter
    tx = ts.make_optimizer(lr=1e-3, warmup=1, total_steps=4)
    step = ts.make_train_step(CFG, tx, decoder_frames=2, subset_seed=0)
    state = ts.init_train_state(p, tx)
    state, a = step(state, tb)
    state, b = step(state, tb)
    assert float(a["c0_loss"]) == float(m1["c0_loss"])  # lr 0 at the first step
    _, want = csm_loss(_port(np_p), CFG, tb, decoder_frames=2,
                       subset_r=ts._subset_scores(0, 1, 16, seed=0))
    assert float(a["decoder_loss"]) == float(want["decoder_loss"])


def test_eval_step_has_no_gradients(params):
    _, np_p = params
    _, tb = _batches(_arrays(6))
    p = _port(np_p)
    m = ts.make_eval_step(CFG, decoder_frames=2)(p, tb)
    _, want = csm_loss(p, CFG, tb, decoder_frames=2)
    assert m["loss"].grad_fn is None
    assert float(m["loss"]) == float(want["loss"])
