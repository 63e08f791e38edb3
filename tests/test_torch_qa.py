"""The port's int4 generator and quantization QA gate against the JAX package,
at the tiny f32 flavor.  Both packages get the same weights: the JAX
package builds and quantizes them, the port converts its trees."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.runtime import qa as jqa
from sesameai_tts_tpu.runtime.loader import build_generator as j_build
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.ops.quant import is_quantized4
from sesameai_tts_tpu_torch.runtime import qa as tqa
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

TEXT = "the quick brown fox jumps over the lazy dog"
QA_TEXT = "one two three four five six"
QA_STEPS = 12


def _pair(quantize):
    jg = j_build(dataclasses.replace(j_tiny_spec(), quantize=quantize), decode_chunk_frames=4,
                 offline_chunk_frames=4)
    csm = from_jax_params(jax.tree.map(np.asarray, jg._params))
    mimi = from_jax_params(jax.tree.map(np.asarray, jg._mimi_params))
    tg = Generator(csm, csm_test_tiny(), Mimi(mimi_test_tiny()), mimi, TinyHashTokenizer(),
                   decode_chunk_frames=4, device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def pairs():
    """(JAX, port) generators for the dense, int8 and int4 trees of one seed."""
    return {q: _pair(q) for q in (None, "int8", "int4")}


def test_int4_greedy_frames_equal_jax(pairs):
    jg, tg = pairs["int4"]
    assert is_quantized4(tg._params["backbone"]["layers"][0]["qkv"])
    kw = dict(max_audio_length_ms=1600, temperature=1.0, topk=1)
    want = jg.generate_frames(TEXT, 0, [], seed=0, **kw)
    got = tg.generate_frames(TEXT, 0, [], **kw)
    assert got.shape == want.shape and got.shape[0] > 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_prefill_shadow_equals_jax(pairs, quantize):
    """Quantized trees prefill through a dense shadow with the JAX
    package's values: bf16-dequantized trunks (exactly upcast to f32 here)."""
    jg, tg = pairs[quantize]
    want = from_jax_params(jax.tree.map(np.asarray, jg._prefill_params))
    for trunk in ("backbone", "decoder"):
        for got_l, want_l in zip(tg._prefill_params[trunk]["layers"], want[trunk]["layers"]):
            for k, w in got_l.items():
                assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
                assert torch.equal(w, want_l[k].float())


def test_trunk_weight_snr_matches_jax(pairs):
    jg, tg = pairs[None]
    want = jqa.trunk_weight_snr(jg._params)
    got = tqa.trunk_weight_snr(tg._params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)  # dB
    with pytest.raises(ValueError):
        tqa.trunk_weight_snr(pairs["int8"][1]._params)  # no dense matrices


def test_teacher_forced_agreement_matches_jax(pairs):
    """The int8 tiny generator against the dense one, in both packages: the
    same greedy codes agree or disagree at the same steps, and the logit
    SNRs agree to within 0.05 dB (the logits differ by f32 rounding of sums
    taken in another order; measured 3e-5 dB apart)."""
    (jq, tq_), (jr, tr) = pairs["int8"], pairs[None]
    want = jqa.teacher_forced_agreement(jq, jr, QA_TEXT, steps=QA_STEPS)
    got = tqa.teacher_forced_agreement(tq_, tr, QA_TEXT, steps=QA_STEPS)
    assert got["steps"] == want["steps"] > 1
    for key in ("code_match", "frame_match", "self_consistency"):
        assert got[key] == want[key], key
    assert got["self_consistency"] == 1.0
    assert abs(got["logit_snr_db"] - want["logit_snr_db"]) < 0.05


def test_quant_acceptance_gates(pairs):
    tq_, tr = pairs["int8"][1], pairs[None][1]
    rep = tqa.quant_acceptance(tq_, tr, QA_TEXT, steps=QA_STEPS)
    assert rep["gate_weight_snr_db"] == tqa.MIN_WEIGHT_SNR_DB == 35.0
    assert rep["gate_logit_snr_db"] == tqa.MIN_LOGIT_SNR_DB == 20.0
    assert rep["passed"] == (rep["weight_snr_min_db"] >= 35.0 and rep["logit_snr_db"] >= 20.0)
    strict = tqa.quant_acceptance(tq_, tr, QA_TEXT, steps=QA_STEPS, min_logit_snr_db=1e3)
    assert strict["passed"] is False


def test_twins_of_one_tree_agree_exactly(pairs):
    """A generator against itself: every code and the logits agree."""
    tg = pairs["int4"][1]
    rep = tqa.teacher_forced_agreement(tg, tg, QA_TEXT, steps=QA_STEPS)
    assert rep["code_match"] == rep["frame_match"] == rep["self_consistency"] == 1.0
    assert rep["logit_snr_db"] >= 199.0  # zero error, clamped at 1e-20


def test_loader_builds_int4_and_fused_specs():
    g4 = build_generator(dataclasses.replace(tiny_spec(), quantize="int4"), device="cpu")
    leaf = g4._params["decoder"]["layers"][0]["w2"]
    assert is_quantized4(leaf) and leaf["scale"].shape[0] == 2  # half-matrix groups
    assert g4._fused_mlp is False
    gf = build_generator(dataclasses.replace(tiny_spec(), quantize="int8", fused_mlp=True),
                         device="cpu")
    assert gf._fused_mlp is True
    frames = gf.generate_frames(TEXT, 0, [], max_audio_length_ms=480, temperature=1.0, topk=1)
    g8 = build_generator(dataclasses.replace(tiny_spec(), quantize="int8"), device="cpu")
    # on the CPU the fused configuration runs the unfused sequence
    np.testing.assert_array_equal(frames, g8.generate_frames(
        TEXT, 0, [], max_audio_length_ms=480, temperature=1.0, topk=1))
    spec = csm_1b_spec(quantize="int4")
    assert (spec.quantize, spec.fused_mlp, spec.mimi_dtype) == ("int4", False, torch.bfloat16)
    assert csm_1b_spec(fused_mlp=True).quantize == "int8"
