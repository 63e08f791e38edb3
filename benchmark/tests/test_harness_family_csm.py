"""The csm model family (``families/csm.py``) draws, refers and counts
exactly as the harness did before the model families were split out of
it: the pinned values below were computed with that harness (the commit
before ``families/`` existed) at the tiny configuration and the published
CSM-1B shapes, on the CPU."""

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark.harness import specs, texts, weights
from conftest import BENCH, TINY

TINY_CFG = json.loads((TINY / "configs" / "csm-tiny-int8.json").read_text())
CSM = specs.family(BENCH, "csm")

TREES = {
    "csm": "fcffc2f3381801f8a5727f71fc0d676d1f8aef4644763162a772d5c008efead8",
    "mimi": "92ac0d5d9f3ade2d3f5dd71f44b9d8fc24329dc03c3b93d4682d8e11f3ee1fb5",
}
# the reference's frame_logits (6, 8, 67) f32 at the configuration's int8 and
# at the control's 4 bits
LOGITS = {
    None: "a65ac3ac5fe128b7c28414065649981b0d200f95b33211f5c59ae1689cdfe845",
    4: "0ea6bbdfa604685b880522482ae123bd3417a63a6251a153a37ba13bed4963f5",
}
# frame_flops(cfg, 400), prefill_flops(cfg, 80, 200), quant_work(cfg, 16, bits,
# groups) whole and by part, attention_work(cfg, [600, 700]),
# prefill_attention_work(cfg, 80, 200)
COUNTS = {
    "csm-1b-int8": (9393608704.0, 165609412608.0, (4688904192.0, 144955146240.0),
                    [(993984512.0, 31138512896.0), (3694919680.0, 113816633344.0)],
                    (48234496.0, 187695104.0), (22347776.0, 2530476032.0)),
    "csm-1b-int4": (9393608704.0, 165609412608.0, (2435710976.0, 144955146240.0),
                    [(508952576.0, 31138512896.0), (1926758400.0, 113816633344.0)],
                    (48234496.0, 187695104.0), (22347776.0, 2530476032.0)),
}


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def tree_digest(tree) -> str:
    """SHA-256 over every leaf's path, dtype, shape and bytes, in key order."""
    h = hashlib.sha256()

    def walk(path, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{path}/{k}", x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{path}/{i}", v)
        elif x is None:
            h.update(f"{path}:None;".encode())
        else:
            h.update(f"{path}:{x.dtype}:{tuple(x.shape)};".encode())
            h.update(_bytes(x))

    walk("", tree)
    return h.hexdigest()


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("part", sorted(TREES))
def test_the_drawn_tree_is_the_parents(part):
    draw = CSM.draw if part == "csm" else weights.draw_mimi
    assert tree_digest(draw(TINY_CFG, 5, "cpu")) == TREES[part]


@pytest.mark.parametrize("bits", [None, 4])
def test_the_reference_logits_are_the_parents_to_the_bit(one_thread, bits):
    params = CSM.draw(TINY_CFG, 5, "cpu")
    rng = np.random.default_rng(0)
    voice = texts.make_voices(TINY_CFG, 1, (24, 24), rng)[0]
    tok, mask = texts.prompt_rows(TINY_CFG, voice, "some words to say")
    frames = torch.from_numpy(rng.integers(1, 60, size=(6, TINY_CFG["audio_num_codebooks"])))
    with torch.no_grad():
        logits = CSM.reference(params, TINY_CFG, bits=bits).frame_logits(
            (torch.from_numpy(tok), torch.from_numpy(mask)), frames)
    assert logits.shape == (6, 8, 67) and logits.dtype == torch.float32
    assert hashlib.sha256(_bytes(logits)).hexdigest() == LOGITS[bits]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_work_counts_are_the_parents(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    bits = {"int8": 8, "int4": 4}[cfg["quantize"]]
    groups = cfg.get("int4_scale_groups", 2) if bits == 4 else 1
    got = (CSM.frame_flops(cfg, 400), CSM.prefill_flops(cfg, 80, 200),
           CSM.quant_work(cfg, 16, bits, groups),
           [CSM.quant_work(cfg, 16, bits, groups, part) for part in ("backbone", "decoder")],
           CSM.attention_work(cfg, [600, 700]), CSM.prefill_attention_work(cfg, 80, 200))
    assert got == COUNTS[name]
