"""The port's sharded training (``make_sharded_train_state``, the train steps'
``mesh=``, ``shard_batch``, the checkpoints and ``sesame-tts-torch-finetune
--mesh``) on the CPU, in gloo worlds of spawned ranks that import only the
port (the harness of ``tests/test_torch_parallel_infer.py``), against the
JAX package's ``make_sharded_train_state`` + ``make_train_step`` on a mesh
of the same shape over conftest's virtual devices, from the same converted
init, at ``csm_test_tiny`` in f32:

* three dense steps on (dp, tp) = (1, 2), (2, 1) and (2, 2), with the
  per-step decoder subset on (the JAX step's scores replaced by the port's
  draws) and dp ranks that hold different audio-row counts: ``loss``,
  ``c0_loss``, ``decoder_loss`` and ``grad_norm`` within 1e-5 relative of
  JAX's and of the port's own unsharded step on the global batch; after
  three steps every gathered param and both Adam moments within 1e-5 of
  their peak of JAX's;
* ``accum_steps=2`` at (2, 1) against JAX's accumulated step;
* two LoRA steps on (1, 2) against JAX's ``make_lora_train_step`` over a
  sharded base: the adapters within 1e-5 of their peak, equal on both ranks;
* the CLI at (1, 2): an interrupted run resumed with ``--resume`` bit-equal
  to an unbroken one, the per-step losses within 1e-5 of the unsharded
  CLI's, the gathered checkpoint in the unsharded format and resumed by
  the unsharded CLI, the export served by a single-process Generator;
  ``--mesh`` with a dense ``--csm-checkpoint`` refused as the JAX CLI
  refuses it."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel_infer import _spawn

from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
from sesameai_tts_tpu.models.csm import init_csm_params as j_init
from sesameai_tts_tpu.parallel import mesh as j_mesh
from sesameai_tts_tpu.training import lora as jlora
from sesameai_tts_tpu.training import train_step as jts
from sesameai_tts_tpu.training.loss import Batch as JBatch
from sesameai_tts_tpu_torch.audio.io import write_wav
from sesameai_tts_tpu_torch.convert import from_jax_lora, from_jax_params, tree_leaves, tree_map
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.core.weights import load_pytree
from sesameai_tts_tpu_torch.training import train_step as ts
from sesameai_tts_tpu_torch.training.loss import Batch

JCFG, CFG = j_tiny(), csm_test_tiny()
K = CFG.audio_num_codebooks
RTOL = 1e-5
TOL = 1e-5  # of each leaf's peak
B, S, FRAMES, STEPS, LR = 4, 24, 3, 3, 1e-3
METRICS = ("loss", "c0_loss", "decoder_loss", "grad_norm")
# audio rows of each example (the rest text and padding): dp ranks of 2 rows
# hold 14 + 9 and 5 + 11 rows
AUDIO_ROWS = (14, 9, 5, 11)
CLI_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays():
    """The global batch: text rows, then audio rows, then padding."""
    rng = np.random.default_rng(11)
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    loss_mask = np.zeros((B, S), bool)
    for b, audio in enumerate(AUDIO_ROWS):
        text = 4 + b
        tokens[b, :text, K] = rng.integers(1, CFG.text_vocab_size, text)
        mask[b, :text, K] = True
        tokens[b, text:text + audio, :K] = rng.integers(1, CFG.audio_vocab_size, (audio, K))
        mask[b, text:text + audio, :K] = True
        loss_mask[b, :text + audio] = True
    return tokens, mask, loss_mask


def _jax_init():
    """(JAX init of seed 0, as its make_sharded_train_state draws it; the
    port's tree of it)."""
    jp = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _scores(steps):
    """The port's per-step subset scores of the global batch, (steps, B, S-1)."""
    return np.stack([ts._subset_scores(i, B, S, seed=0).numpy() for i in range(steps)])


def _port_tx():
    return ts.make_optimizer(lr=LR, warmup=1, total_steps=STEPS)


# -- ranks ---------------------------------------------------------------------


def _own(*trees):
    """Private copies of trees a rank was handed: the spawn passes tensors in
    memory that every rank shares, and a step updates its state in place."""
    return [tree_map(torch.clone, t) for t in trees]


def _steps_on_mesh(rank, dp, tp, params, arrays, accum_steps=1, steps=STEPS):
    """``steps`` sharded dense steps → (metrics per step, the gathered
    params and moments on rank 0)."""
    from sesameai_tts_tpu_torch.parallel.infer import tp_group
    from sesameai_tts_tpu_torch.parallel.mesh import (
        all_gather_params,
        make_mesh,
        shard_batch,
        shard_params,
    )

    params, = _own(params)
    mesh = make_mesh(dp, tp, device_type="cpu")
    tx = _port_tx()
    state = ts.init_train_state(shard_params(params, mesh, CFG), tx)
    step = ts.make_train_step(CFG, tx, decoder_frames=FRAMES, accum_steps=accum_steps,
                              mesh=mesh)
    batch = shard_batch(Batch(*(torch.from_numpy(a) for a in arrays)), mesh, accum_steps)
    ms = []
    for _ in range(steps):
        state, m = step(state, batch)
        ms.append({k: float(m[k]) for k in METRICS})
    full = {name: all_gather_params(tree, CFG, tp_group(mesh), dst=0)
            for name, tree in (("params", state.params), ("mu", state.opt_state["mu"]),
                               ("nu", state.opt_state["nu"]))}
    return ms, full if rank == 0 else None


def _lora_on_mesh(rank, base, lora, arrays, steps=2):
    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh, shard_params

    base, lora = _own(base, lora)
    mesh = make_mesh(1, 2, device_type="cpu")
    tx = _port_tx()
    state = ts.init_train_state(lora, tx)
    step = ts.make_lora_train_step(CFG, tx, alpha=16.0, decoder_frames=FRAMES,
                                   subset_rng=False, mesh=mesh)
    shards = shard_params(base, mesh, CFG)
    batch = Batch(*(torch.from_numpy(a) for a in arrays))
    ms = []
    for _ in range(steps):
        state, m = step(state, shards, batch)
        ms.append({k: float(m[k]) for k in METRICS})
    return ms, state.params


def _recording_cli(argv):
    """``finetune.main(argv)`` → the per-step metrics its steps returned."""
    from sesameai_tts_tpu_torch.training import finetune

    seen, update = [], ts._apply_update

    def record(*a, **kw):
        out = update(*a, **kw)
        seen.append({k: float(out[1][k]) for k in METRICS})
        return out

    ts._apply_update = record
    try:
        finetune.main(argv)
    finally:
        ts._apply_update = update
    return seen


def _cli_runs(argv, root):
    """The CLI at (1, 2): unbroken into ``root/a``; into ``root/b`` saved at
    step 2, its last checkpoint deleted, then resumed."""
    unbroken = _recording_cli(argv + ["--ckpt-dir", f"{root}/a", "--save-every", "2"])
    _recording_cli(argv + ["--ckpt-dir", f"{root}/b", "--save-every", "2"])
    if torch.distributed.get_rank() == 0:
        os.remove(f"{root}/b/step_{CLI_STEPS:08d}")
    torch.distributed.barrier()
    resumed = _recording_cli(argv + ["--ckpt-dir", f"{root}/b", "--save-every", "2",
                                     "--resume"])
    return unbroken, resumed


def _rank_12(rank, params, arrays, base, lora, cli_argv, root):
    out = {"dense": _steps_on_mesh(rank, 1, 2, params, arrays),
           "lora": _lora_on_mesh(rank, base, lora, arrays)}
    out["cli"] = _cli_runs(cli_argv, root)
    return out


def _rank_21(rank, params, arrays):
    return {"dense": _steps_on_mesh(rank, 2, 1, params, arrays),
            "accum": _steps_on_mesh(rank, 2, 1, params, arrays, accum_steps=2, steps=2)}


def _rank_22(rank, params, arrays):
    return {"dense": _steps_on_mesh(rank, 2, 2, params, arrays)}


# -- the JAX side ----------------------------------------------------------------


def _jax_steps(monkeypatch, dp, tp, steps=STEPS, accum_steps=1):
    """JAX's make_sharded_train_state + make_train_step on a (dp, tp) mesh of
    virtual devices, the subset scores the port's → (metrics per step, the
    final state's params and Adam moments in the port's layout)."""
    table = jnp.asarray(_scores(steps))
    monkeypatch.setattr(jts, "_subset_scores", lambda step, b, s, seed: table[step])
    mesh = j_mesh.make_mesh(dp, tp)
    tx = jts.make_optimizer(lr=LR, warmup=1, total_steps=STEPS)
    with mesh:
        state = jts.make_sharded_train_state(jax.random.PRNGKey(0), JCFG, mesh, tx)
        step = jts.make_train_step(JCFG, tx, decoder_frames=FRAMES, accum_steps=accum_steps)
        batch = jts.shard_batch(JBatch(*(jnp.asarray(a) for a in _arrays())), mesh)
        ms = []
        for _ in range(steps):
            state, m = step(state, batch)
            ms.append({k: float(m[k]) for k in METRICS})
    adam = state.opt_state[1][0]

    def port(tree):
        return from_jax_params(jax.tree.map(np.asarray, tree))

    return ms, {"params": port(state.params), "mu": port(adam.mu), "nu": port(adam.nu)}


def _port_unsharded(params, steps=STEPS, accum_steps=1):
    tx = _port_tx()
    state = ts.init_train_state(tree_map(torch.clone, params), tx)
    step = ts.make_train_step(CFG, tx, decoder_frames=FRAMES, accum_steps=accum_steps)
    batch = Batch(*(torch.from_numpy(a) for a in _arrays()))
    ms = []
    for _ in range(steps):
        state, m = step(state, batch)
        ms.append({k: float(m[k]) for k in METRICS})
    return ms


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-7, err_msg=k)


def _assert_trees(got, want, tol=TOL):
    g, w = tree_leaves(got), tree_leaves(want)
    assert [x.shape for x in g] == [x.shape for x in w]
    for a, b in zip(g, w):
        err = (a - b).abs().max().item()
        assert err <= tol * max(b.abs().max().item(), 1e-30), (err, b.abs().max().item())


@pytest.fixture(scope="module")
def init():
    return _jax_init()


def _clips(root, n=4, seconds=0.04):
    os.makedirs(root)
    rng = np.random.default_rng(12)
    for i in range(n):
        wav = (0.1 * rng.standard_normal(int(24_000 * seconds) * (i + 1))).astype(np.float32)
        write_wav(os.path.join(root, f"c{i}.wav"), wav, 24_000)
        with open(os.path.join(root, f"c{i}.txt"), "w") as f:
            f.write(f"mesh clip {i}")
    return root


@pytest.fixture(scope="module")
def lora_init():
    jbase = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32)
    jl = jax.tree.map(lambda x: x + 0.01, jlora.init_lora_params(jax.random.PRNGKey(5), jbase, 2))
    return jbase, jl


@pytest.fixture(scope="module")
def world_12(init, lora_init, tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh12")
    data = _clips(str(root / "clips"))
    argv = ["--data", data, "--flavor", "test-tiny", "--steps", str(CLI_STEPS),
            "--batch-size", "2", "--buckets", "64,128", "--eval-frac", "0.5",
            "--log-every", "1", "--warmup", "1", "-d", "cpu"]
    jbase, jl = lora_init
    ranks = _spawn(_rank_12, 2, root, init[1], _arrays(),
                   from_jax_params(jax.tree.map(np.asarray, jbase)),
                   from_jax_lora(jax.tree.map(np.asarray, jl)), argv + ["--mesh", "1,2"],
                   str(root))
    return ranks, argv, str(root)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_dense_steps_on_a_mesh_equal_jax_and_the_unsharded_step(init, world_12, tmp_path,
                                                                monkeypatch, dp, tp):
    if (dp, tp) == (1, 2):
        ranks = world_12[0]
    else:
        ranks = _spawn(_rank_21 if dp == 2 and tp == 1 else _rank_22, dp * tp, tmp_path,
                       init[1], _arrays())
    jms, jfull = _jax_steps(monkeypatch, dp, tp)
    for r in ranks:  # every rank reports the global metrics
        _assert_metrics(r["dense"][0], jms)
    _assert_metrics(ranks[0]["dense"][0], _port_unsharded(init[1]))
    full = ranks[0]["dense"][1]
    for name in ("params", "mu", "nu"):
        _assert_trees(full[name], jfull[name])
    if dp == 2:  # the ranks hold different audio-row counts
        from sesameai_tts_tpu_torch.parallel.mesh import dp_rows

        counts = [sum(AUDIO_ROWS[i] for i in dp_rows(B, 2, d)) for d in range(2)]
        assert counts[0] != counts[1]
        # the accumulated step: its microbatch-major rows against JAX's scan
        if tp == 1:
            ajms, ajfull = _jax_steps(monkeypatch, 2, 1, steps=2, accum_steps=2)
            _assert_metrics(ranks[0]["accum"][0], ajms)
            _assert_metrics(ranks[0]["accum"][0], _port_unsharded(init[1], 2, accum_steps=2))
            _assert_trees(ranks[0]["accum"][1]["params"], ajfull["params"])


def test_lora_steps_on_a_sharded_base_equal_jax(world_12, lora_init):
    """Two LoRA steps on (1, 2), the first-N decoder subset: the metrics
    within 1e-5 relative, the adapters within 1e-5 of their peak of JAX's
    and equal on both ranks."""
    jbase, jl = lora_init
    mesh = j_mesh.make_mesh(1, 2)
    tx = jts.make_optimizer(lr=LR, warmup=1, total_steps=STEPS)
    with mesh:
        base = j_mesh.shard_params(jbase, mesh, j_mesh.csm_param_specs())
        state = jts.init_train_state(jl, tx)
        step = jts.make_lora_train_step(JCFG, tx, alpha=16.0, decoder_frames=FRAMES,
                                        subset_rng=False)
        jms = []
        for _ in range(2):
            state, m = step(state, base, JBatch(*(jnp.asarray(a) for a in _arrays())))
            jms.append({k: float(m[k]) for k in METRICS})
    want = from_jax_lora(jax.tree.map(np.asarray, state.params))
    ranks = world_12[0]
    for r in ranks:
        ms, adapters = r["lora"]
        _assert_metrics(ms, jms)
        _assert_trees(adapters, want)
        for a, b in zip(tree_leaves(adapters), tree_leaves(ranks[0]["lora"][1])):
            assert torch.equal(a, b)  # replicated: equal on every rank


def test_finetune_cli_on_a_mesh_resumes_bit_equal_and_equals_one_process(world_12, tmp_path):
    """``--mesh 1,2``: the resumed run's checkpoint is bit-equal to the
    unbroken one's; the per-step losses equal the unsharded CLI's within
    1e-5; the gathered checkpoint has the unsharded run's tree and
    resumes there; the export serves from one process."""
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
    from sesameai_tts_tpu_torch.training import checkpoint as ckpt_lib

    ranks, argv, root = world_12
    unbroken, resumed = ranks[0]["cli"]
    assert ranks[1]["cli"] == ranks[0]["cli"]  # both ranks step on the global metrics
    assert len(unbroken) == CLI_STEPS and resumed == unbroken[2:]
    a, b = (load_pytree(f"{root}/{d}/step_{CLI_STEPS:08d}") for d in ("a", "b"))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)

    one = str(tmp_path / "one")
    single = _recording_cli(argv + ["--ckpt-dir", one, "--save-every", "2"])
    _assert_metrics(unbroken, single)
    want = load_pytree(f"{one}/step_{CLI_STEPS:08d}")
    like = tuple(ckpt_lib.restore_checkpoint(f"{one}/step_{CLI_STEPS:08d}", _tiny_state()))
    got = load_pytree(f"{root}/a/step_{CLI_STEPS:08d}", like)  # the unsharded tree's leaves
    assert [x.dtype for x in tree_leaves(got)] == [x.dtype for x in tree_leaves(want)]
    _assert_trees(got[0], want[0])

    # the mesh run's step-2 checkpoint resumed by the unsharded CLI
    c = tmp_path / "c"
    c.mkdir()
    shutil.copy(f"{root}/a/step_00000002", c / "step_00000002")
    again = _recording_cli(argv + ["--ckpt-dir", str(c), "--save-every", "2", "--resume"])
    _assert_metrics(again, unbroken[2:])

    spec = dataclasses.replace(tiny_spec(), csm_checkpoint=f"{root}/a/params")
    gen = build_generator(spec, device="cpu")
    _assert_trees(gen._params, load_pytree(f"{one}/params"))
    audio = gen.generate("served from a mesh", speaker=0, context=[], max_audio_length_ms=320)
    assert audio.size > 0 and np.isfinite(audio).all()


def _tiny_state():
    from sesameai_tts_tpu_torch.models.csm import init_csm_params

    return ts.init_train_state(init_csm_params(CFG, torch.Generator().manual_seed(0),
                                               torch.float32), _port_tx())


def test_mesh_with_a_dense_checkpoint_is_refused_before_any_init(tmp_path):
    """As ``sesameai_tts_tpu/training/finetune.py`` refuses it: before the
    process group, the codec or the data."""
    from sesameai_tts_tpu_torch.training import finetune

    with pytest.raises(SystemExit, match="csm-checkpoint"):
        finetune.main(["--data", str(tmp_path / "none"), "--flavor", "csm-1b",
                       "--csm-checkpoint", str(tmp_path / "params"), "--mesh", "1,2",
                       "-d", "cpu"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit, match="dp,tp"):
        finetune.main(["--data", str(tmp_path / "none"), "--mesh", "2", "-d", "cpu"])
