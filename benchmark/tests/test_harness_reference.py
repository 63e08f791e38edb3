"""The plain reference against the port at the tiny f32 flavors, and the
comparison's verdict on a sound run, its control and planted faults."""

import json

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import specs, system, texts, weights
from benchmark.reference import csm as ref_csm
from benchmark.reference import logits as ref_logits
from benchmark.reference import mimi as ref_mimi
from conftest import TINY

torch.set_num_threads(2)
CFG = json.loads((TINY / "configs" / "csm-tiny-int8.json").read_text())


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_reference_codebook0_logits_equal_the_port(quantize):
    from sesameai_tts_tpu_torch.models import csm as port
    from sesameai_tts_tpu_torch.models.transformer import precompute_rope
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm

    cfg = dict(CFG, quantize=quantize)
    port_cfg, _ = system.port_configs(cfg, f"ref-{quantize}")
    params = weights.draw_csm(cfg, 5, "cpu")
    qparams = quantize_csm(params, bits={"int8": 8, "int4": 4}[quantize])
    rng = np.random.default_rng(0)
    voice = texts.make_voices(cfg, 1, (24, 24), rng)[0]
    tok, mask = texts.prompt_rows(cfg, voice, "some words to say")
    frames = torch.from_numpy(rng.integers(1, 60, size=(6, cfg["audio_num_codebooks"])))
    rope = precompute_rope(port_cfg.backbone)
    state = port.init_state(port_cfg, 1, torch.float32)
    last_h, state = port.backbone_last_hidden(
        qparams, port_cfg, state, torch.from_numpy(tok)[None], torch.from_numpy(mask)[None],
        rope_cs=rope)
    first = last_h.float() @ qparams["codebook0_head"].float()
    _, rest = port.teacher_forced_eval(qparams, port_cfg, state, frames[:-1, None, :], rope_cs=rope)
    got = torch.cat([first, rest[:, 0]])
    want = ref_csm.CSM(params, cfg).frame_logits(
        (torch.from_numpy(tok), torch.from_numpy(mask)), frames)[:, 0]
    assert torch.allclose(got, want, atol=2e-5), (got - want).abs().max()


def test_reference_mimi_decode_equals_the_port():
    from sesameai_tts_tpu_torch.codec.mimi import Mimi

    _, mimi_cfg = system.port_configs(CFG, "ref-mimi")
    params = weights.draw_mimi(CFG, 3, "cpu")
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 67, size=(8, 40)))
    got = Mimi(mimi_cfg).decode(params, codes[None])[0, 0]
    want = ref_mimi.decode(params, CFG["mimi"], codes)
    assert got.shape == want.shape == (40 * 48,)
    assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()))


@pytest.fixture
def chat_cell(tiny_bench):
    bench, bj = tiny_bench
    return specs.load_cell("tiny-chat", bench, bj)


def test_a_sound_run_is_correct(chat_cell):
    out = bench_run.run_cell(chat_cell, 2**31 + 99, 2.0, False, device="cpu")
    assert out["ok"], out["check_lines"]
    assert out["readings"]["compared_tokens"] >= 16 and out["failed"] == 0


def test_the_control_is_not_correct(chat_cell):
    """The program's own lower path (int4 trunks for an int8
    configuration) against the reference at int8; and the lower
    references' readings beside the program's."""
    out = bench_run.run_cell(chat_cell, 2**31 + 99, 2.0, False, device="cpu", quantize="int4",
                             control=True)
    assert not out["ok"]
    r = out["readings"]
    assert r["logit_gap"] > chat_cell.settings["correct"]["logit_gap"]
    assert r["control_logit_gap"] > chat_cell.settings["correct"]["logit_gap"]
    assert r["control_pcm_err"] > chat_cell.settings["correct"]["pcm_err"]
    # each lower reference, put in the program's place, is not correct
    assert out["controls"] == {"tokens": False, "pcm": False}


def _token_altered(port):
    sample = port.sample_step

    def altered(params, cfg, bufs, *a, **k):
        sample(params, cfg, bufs, *a, **k)
        bufs.frame[:, 1] = torch.where(bufs.valid, (bufs.frame[:, 1] + 1) % cfg.audio_vocab_size,
                                       bufs.frame[:, 1])
    return "sample_step", altered


def _state_unchanged(port):
    step = port.backbone_step

    def unchanged(params, cfg, state, bufs, *a, **k):
        pos = state.pos.clone()
        step(params, cfg, state, bufs, *a, **k)
        state.pos.copy_(pos)
    return "backbone_step", unchanged


def _half_batch_left_out(port):
    step = port.backbone_step

    def half(params, cfg, state, bufs, *a, **k):
        B = bufs.last_h.shape[0]
        before = bufs.last_h.clone()
        step(params, cfg, state, bufs, *a, **k)
        if B > 1:
            bufs.last_h[B // 2:] = before[B // 2:]
    return "backbone_step", half


def _sampled_token_outside_topk(port):
    sample = port.sample_step

    def outside(params, cfg, bufs, *a, **k):
        sample(params, cfg, bufs, *a, **k)
        # a sampled row's codebook 1 taken from the far end of the vocabulary
        far = (bufs.frame[:, 1] + cfg.audio_vocab_size // 2) % cfg.audio_vocab_size
        bufs.frame[:, 1] = torch.where(bufs.valid & (bufs.topk > 1), far, bufs.frame[:, 1])
    return "sample_step", outside


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch_left_out,
                                   _sampled_token_outside_topk])
def test_a_broken_timed_path_is_not_correct(chat_cell, monkeypatch, fault):
    from sesameai_tts_tpu_torch.models import csm as port

    name, broken = fault(port)
    monkeypatch.setattr(port, name, broken)
    out = bench_run.run_cell(chat_cell, 2**31 + 99, 2.0, False, device="cpu")
    assert not out["ok"], out["check_lines"]


def test_altered_audio_is_not_correct(chat_cell, monkeypatch):
    from sesameai_tts_tpu_torch.runtime.generator import Generator

    tick = Generator._serve_tick

    def louder(self, *a, **k):
        frames, valid, done, pcm, state = tick(self, *a, **k)
        return frames, valid, done, pcm * 1.5, state

    monkeypatch.setattr(Generator, "_serve_tick", louder)
    out = bench_run.run_cell(chat_cell, 2**31 + 99, 2.0, False, device="cpu")
    assert not out["ok"]
    assert out["readings"]["pcm_err"] > chat_cell.settings["correct"]["pcm_err"]


def test_sampling_past_the_top_k_is_not_correct(chat_cell):
    """The pool's sampled rows drawn from every code (the fault that
    ``calibrate.py --fault topk-off`` plants on the card): greedy tokens
    and PCM stay right, only ``topk_gap`` sees it."""
    from benchmark import calibrate

    out = bench_run.run_cell(chat_cell, 2**31 + 99, 2.0, False, device="cpu",
                             fault=calibrate.topk_off)
    assert not out["ok"]
    r, limits = out["readings"], chat_cell.settings["correct"]
    assert r["sampled_tokens"] > 0 and r["topk_gap"] > limits["topk_gap"]
    assert r["logit_gap"] <= limits["logit_gap"] and r["pcm_err"] <= limits["pcm_err"]


def test_topk_gaps_are_zero_inside_the_top_k():
    logits = torch.tensor([[[5.0, 4.0, 3.0, 1.0, 0.5]]])
    served = torch.tensor([[[0, 2, 3, 4]]]).reshape(4, 1)
    gaps = ref_logits.topk_gaps(logits.expand(4, 1, 5), served, 3)
    assert gaps.flatten().tolist() == [0.0, 0.0, 2.0, 2.5]
