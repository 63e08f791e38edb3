"""The port's multi-card inference (``sesameai_tts_tpu_torch/parallel/``) on
the CPU: worlds of 2 and 4 processes over gloo, each rank holding its
tensor-parallel shards, against the JAX package (unsharded, and on its
mesh of conftest's virtual devices), one case per case of
``tests/test_parallel_infer.py``.

The ranks are spawned with ``torch.multiprocessing`` and meet at a
``FileStore`` under ``tmp_path`` (no TCP port).  They import only the port:
this module imports JAX and the JAX package inside the test functions, and
a rank imports the module for its worker function.  Greedy frames must be
exactly equal; logits within 1e-5 of their peak (f32: the tp partial sums
are added in another order)."""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sesameai_tts_tpu_torch.convert import from_jax_params, tree_map
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.models import csm as tm

LOGIT_TOL = 1e-5  # of the logits' peak
WORLD_TIMEOUT_S = 120  # a world that outlives this (a rank stuck in a collective) fails
K = 8
FRAMES = 5
TEXT = "hello mesh world"


# -- ranks ---------------------------------------------------------------------


def _rank_entry(rank, fn, world, tmp, env, args):
    torch.set_num_threads(1)
    os.environ.update(env)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = fn(rank, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp_path, *args, env=None):
    """Run ``fn(rank, *args)`` on ``world`` ranks → their results by rank; a
    rank that raises fails the test, and so does a world that outlives
    WORLD_TIMEOUT_S (every rank is stopped either way)."""
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, world, str(tmp_path), env or {}, args), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, f"the ranks outlived {WORLD_TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        assert not any(p.is_alive() for p in ctx.processes)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _mesh(dp, tp):
    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, device_type="cpu")


def _decode(params, B, tokens, mask, mesh=None, frames=FRAMES, fused_mlp=False):
    """generate_frame + decode_frames, greedy → (frame0, frames, valid,
    teacher-forced c0 logits over the decoded frames) as numpy; ``params``
    full, sharded here on ``mesh``."""
    from sesameai_tts_tpu_torch.parallel.infer import (
        shard_csm_params,
        shard_state,
        state_sharding,
        tp_group,
    )

    cfg = csm_test_tiny()
    tp, rows = None, range(B)
    full = params
    if mesh is not None:
        rows = state_sharding(mesh, cfg, B, params).rows
        params = shard_csm_params(params, mesh, cfg)
        tp = tp_group(mesh)
    rs = slice(rows.start, rows.stop)
    tok, msk = torch.from_numpy(tokens[rs]).long(), torch.from_numpy(mask[rs])

    def state():
        st = tm.init_state(cfg, B, torch.float32)
        return st if mesh is None else shard_state(st, mesh, cfg, full)

    kw = dict(fused_mlp=fused_mlp, tp=tp)
    f0, st = tm.generate_frame(params, cfg, state(), tok, msk, None, 1.0, 1, **kw)
    out, valid, _, _ = tm.decode_frames(params, cfg, st, f0, torch.zeros(len(rows), dtype=bool),
                                        8, frames, 1.0, 1, start_index=1, **kw)
    # teacher forcing over the decoded frames from the same prompt
    _, st = tm.backbone_last_hidden(params, cfg, state(), tok, msk, **kw)
    _, logits = tm.teacher_forced_eval(params, cfg, st, torch.cat([f0[None], out[:-1]]), **kw)
    return {"rows": (rows.start, rows.stop), "f0": f0.numpy(), "out": out.numpy(),
            "valid": valid.numpy(), "logits": logits.numpy()}


def _decode_rank(rank, params, B, tokens, mask, dp, tp, fused_mlp=False):
    return _decode(params, B, tokens, mask, _mesh(dp, tp), fused_mlp=fused_mlp)


# -- the JAX side --------------------------------------------------------------


def _prompt(B=1, S=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, S, K + 1), np.int64)
    mask = np.zeros((B, S, K + 1), bool)
    tokens[:, :, K] = rng.integers(1, 128, (B, S))
    mask[:, :, K] = True
    tokens[:, -2:, :K] = rng.integers(1, 67, (B, 2, K))  # two audio rows
    mask[:, -2:, :K] = True
    return tokens, mask


def _jax_params(key, quantized=False):
    import jax
    import jax.numpy as jnp

    from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
    from sesameai_tts_tpu.models import csm as jm
    from sesameai_tts_tpu.ops.quant import quantize_csm

    jp = jm.init_csm_params(jax.random.PRNGKey(key), j_tiny(), jnp.float32)
    # int8 stays layer-stacked: the JAX trees compile faster so; the port's
    # tree is per-layer either way (convert.py)
    return jax.jit(quantize_csm)(jp) if quantized else jp


def _jax_decode(jp, B, tokens, mask, mesh=None, frames=FRAMES):
    """The JAX package's generate_frame + decode_frames (greedy) and its
    teacher-forced logits over the same frames, unsharded or on ``mesh``."""
    import jax
    import jax.numpy as jnp

    from sesameai_tts_tpu.core.config import csm_test_tiny as j_tiny
    from sesameai_tts_tpu.models import csm as jm
    from sesameai_tts_tpu.parallel.infer import shard_csm_params, shard_state

    cfg = j_tiny()
    unstacked = jm.is_unstacked(jp["backbone"])

    def state():
        s = jm.init_state(cfg, B, jnp.float32, unstacked=unstacked)
        return s if mesh is None else shard_state(s, mesh)

    if mesh is not None:
        jp = shard_csm_params(jp, mesh)
    tok, msk = jnp.asarray(tokens, jnp.int32), jnp.asarray(mask)
    prefill = jax.jit(lambda p, st: jm.generate_frame(p, cfg, st, tok, msk,
                                                     jax.random.PRNGKey(7), 1.0, 1))
    f0, st = prefill(jp, state())
    out, valid, _, _ = jax.jit(lambda p, st, f0: jm.decode_frames(
        p, cfg, st, f0, jnp.zeros((B,), bool), jax.random.PRNGKey(8), frames, 1.0, 1,
        start_index=1))(jp, st, f0)
    _, st = prefill(jp, state())
    teacher = jnp.concatenate([f0[None], out[:-1]])
    # the port's backbone_last_hidden state: generate_frame's state is the same
    _, logits = jax.jit(lambda p, st, t: jm.teacher_forced_eval(p, cfg, st, t))(jp, st, teacher)
    return {"f0": np.asarray(f0), "out": np.asarray(out), "valid": np.asarray(valid),
            "logits": np.asarray(logits)}


def _assert_rows_match(ranks, want):
    """Every rank's rows equal ``want``'s: frames exactly, logits within
    LOGIT_TOL of their peak."""
    for got in ranks:
        r = slice(*got["rows"])
        np.testing.assert_array_equal(got["f0"], want["f0"][r])
        np.testing.assert_array_equal(got["out"], want["out"][:, r])
        np.testing.assert_array_equal(got["valid"], want["valid"][:, r])
        peak = np.abs(want["logits"]).max()
        np.testing.assert_allclose(got["logits"], want["logits"][:, r], rtol=0,
                                   atol=LOGIT_TOL * peak)


def _jax_mesh(dp, tp):
    from sesameai_tts_tpu.parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp)


# -- the cases of tests/test_parallel_infer.py ------------------------------------


_JAX_RUNS = {}


def _jax_runs(key, quantized, B, dp, tp):
    """The JAX package's decode of a seeded prompt, unsharded and on its
    (dp, tp) mesh, once per case (the fused case reuses the int8 one)."""
    k = (key, quantized, B, dp, tp)
    if k not in _JAX_RUNS:
        jp = _jax_params(key, quantized)
        tokens, mask = _prompt(B, seed=3 if B > 1 else 0)
        want = _jax_decode(jp, B, tokens, mask)
        on_mesh = _jax_decode(jp, B, tokens, mask, mesh=_jax_mesh(dp, tp))
        np.testing.assert_array_equal(on_mesh["out"], want["out"])
        _JAX_RUNS[k] = jp, tokens, mask, want, on_mesh
    return _JAX_RUNS[k]


@pytest.mark.parametrize("dp,tp,B,quantized,fused_mlp", [
    (1, 2, 1, False, False),  # test_tp_generate_frame_matches_unsharded
    (2, 2, 4, False, False),  # test_dp_tp_batched_decode_matches
    (1, 2, 1, True, False),   # test_unstacked_quantized_specs_and_parity
    (1, 2, 1, True, True),    # the fused MLP flag: on the CPU its plain sequence
], ids=["tp2", "dp2-tp2-b4", "tp2-int8", "tp2-int8-fused"])
def test_sharded_decode_equals_jax_unsharded_and_on_its_mesh(tmp_path, dp, tp, B, quantized,
                                                              fused_mlp):
    import jax

    jp, tokens, mask, want, on_mesh = _jax_runs(2 * quantized + (B > 1), quantized, B, dp, tp)
    params = from_jax_params(jax.tree.map(np.asarray, jp))
    ranks = _spawn(_decode_rank, dp * tp, tmp_path, params, B, tokens, mask, dp, tp, fused_mlp)
    _assert_rows_match(ranks, want)
    _assert_rows_match(ranks, on_mesh)


def _generator_rank(rank, jax_params):
    from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
    from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

    mesh = _mesh(1, 2)
    kw = dict(max_audio_length_ms=800, temperature=1.0, topk=1)
    gen = build_generator(tiny_spec(), device="cpu", mesh=mesh, decode_chunk_frames=4)
    frames = gen.generate_frames(TEXT, 1, [], **kw)
    audio = gen.generate(TEXT, 1, [], stream=True, **kw)
    csm, mimi = jax_params
    jgen = Generator(csm, csm_test_tiny(), Mimi(mimi_test_tiny()), mimi, TinyHashTokenizer(),
                     decode_chunk_frames=4, device="cpu", mesh=mesh)
    return {"frames": frames, "audio": audio, "jax_frames": jgen.generate_frames(TEXT, 1, [], **kw),
            "hop": gen._hop, "graphed": gen.graphed, "clone_mesh": gen.clone().mesh is mesh}


def test_generator_on_mesh_matches_single_device_and_jax(tmp_path):
    """build_generator(mesh=) frames equal the single-device port's; a
    Generator on the mesh fed the JAX package's weights equals the JAX
    Generator; the streamed audio is finite (Mimi replicated)."""
    import jax

    from sesameai_tts_tpu.runtime.loader import build_generator as j_build
    from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec

    kw = dict(max_audio_length_ms=800, temperature=1.0, topk=1)
    want = build_generator(tiny_spec(), device="cpu", decode_chunk_frames=4).generate_frames(
        TEXT, 1, [], **kw)
    jg = j_build(j_tiny_spec(), decode_chunk_frames=4)
    j_want = jg.generate_frames(TEXT, 1, [], seed=0, **kw)
    jax_params = tuple(from_jax_params(jax.tree.map(np.asarray, t))
                       for t in (jg._params, jg._mimi_params))
    for got in _spawn(_generator_rank, 2, tmp_path, jax_params):
        np.testing.assert_array_equal(got["frames"], want)
        np.testing.assert_array_equal(got["jax_frames"], j_want)
        audio = got["audio"]
        assert audio.ndim == 1 and np.isfinite(audio).all()
        assert len(audio) == len(want) * got["hop"]
        assert got["graphed"] is False and got["clone_mesh"]


SESSIONS = (("session zero text", 640), ("session one is a longer text", 480),
            ("cancelled at its first audio", 2400), ("two", 800))
CANCEL = 2
OVERLONG_TEXT = "word " * 300  # 302 prompt rows: more than the tiny cache's 256


def _server_codes(server, overlong=False):
    """SESSIONS greedy, the CANCEL-th one cancelled at its first audio → the
    other sessions' codes.  ``overlong``: first a session whose prompt does
    not fit the KV cache, which must fail alone, with its ValueError."""
    bad = None
    if overlong:
        bad = server.submit(OVERLONG_TEXT, max_audio_length_ms=640, temperature=1.0, topk=1)
    sessions = [server.submit(t, max_audio_length_ms=ms, temperature=1.0, topk=1)
                for t, ms in SESSIONS]
    assert sessions[CANCEL].chunks.get(timeout=60) is not None
    sessions[CANCEL].cancel()
    out = []
    for i, s in enumerate(sessions):
        audio = s.audio(timeout=120)
        if i == CANCEL:
            continue
        assert s.error is None, s.error
        assert audio.ndim == 1 and np.isfinite(audio).all()
        frames = np.concatenate(s.frames_out) if s.frames_out else np.zeros((0, K), np.int32)
        assert len(audio) == len(frames) * server.gen._hop
        out.append(frames)
    if bad is not None:
        with pytest.raises(ValueError, match="Inputs too long"):
            bad.audio(timeout=120)
    return out


def _server_rank(rank, dp, tp, overlong):
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    gen = build_generator(tiny_spec(), device="cpu", mesh=_mesh(dp, tp), decode_chunk_frames=4)
    server = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    if rank != 0:
        server.start()  # the follower loop, until rank 0 stops
        return None
    server.start()
    try:
        return _server_codes(server, overlong)
    finally:
        server.stop()


@pytest.mark.parametrize("dp,tp,overlong", [(2, 2, False), (2, 1, False), (1, 2, True)],
                         ids=["dp2-tp2", "dp2-tp1", "dp1-tp2-overlong"])
def test_batched_server_on_mesh(tmp_path, dp, tp, overlong):
    """BatchedTTSServer over a (dp, tp) mesh, a slot per dp row: the
    sessions complete, one is cancelled, and the others' greedy codes equal
    a one-process pool's.  With ``overlong`` a prompt too long for the cache
    comes first: it fails its own session only, on the mesh as on one
    process."""
    from sesameai_tts_tpu_torch.runtime.loader import build_generator
    from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    torch.set_num_threads(1)
    server = BatchedTTSServer(build_generator(tiny_spec(), device="cpu", decode_chunk_frames=4),
                              slots=2, chunk_frames=4)
    server.start()
    try:
        want = _server_codes(server, overlong)
    finally:
        server.stop()
    got = _spawn(_server_rank, dp * tp, tmp_path, dp, tp, overlong)[0]
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _bootstrap_rank(rank, params, tokens, mask):
    from sesameai_tts_tpu_torch.parallel.distributed import global_serving_mesh

    mesh = global_serving_mesh(tp=2, device_type="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (2, 2)
    for tp in (3, 8):  # 3 does not divide 4; 8 > the 4 ranks of the host
        with pytest.raises(ValueError):
            global_serving_mesh(tp=tp, device_type="cpu")
    return _decode(params, 4, tokens, mask, mesh)


def test_global_serving_mesh_and_bootstrap_contract(tmp_path):
    """The multi-host helpers: the global mesh keeps tp groups inside a host
    (LOCAL_WORLD_SIZE), rejects a tp that does not divide it, and drives
    the same sharded decode as make_mesh; the bootstrap validates its
    argument pairing and is a no-op for one process."""
    import jax

    from sesameai_tts_tpu_torch.parallel.distributed import initialize_multihost

    with pytest.raises(ValueError):
        initialize_multihost(coordinator_address="h:1234")  # missing process_id
    with pytest.raises(ValueError):
        initialize_multihost(process_id=1)  # missing the address
    initialize_multihost(num_processes=1)  # explicit single-process no-op
    assert not dist.is_initialized()

    jp, tokens, mask, want, on_mesh = _jax_runs(3, False, 4, 2, 2)
    params = from_jax_params(jax.tree.map(np.asarray, jp))
    ranks = _spawn(_bootstrap_rank, 4, tmp_path, params, tokens, mask,
                   env={"LOCAL_WORLD_SIZE": "4"})
    _assert_rows_match(ranks, want)
    _assert_rows_match(ranks, on_mesh)
