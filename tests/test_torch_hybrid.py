"""The hybrid backbone (``models/hybrid.py``: LFM2-MoE's gated short
convolutions, q/k-normed GQA and routed FFNs) through the port's CSM, on
the CPU at the tiny flavor (conv, conv, attention, conv; one dense FFN,
then 3 routed ones of 8 experts, top 2, a nonzero expert bias).

- The port against the plain reference of the benchmark
  (``benchmark/reference/lfm2_moe.py``, float32, full sequence, no cache):
  a prefill, then S = 1 decode steps through the cache and conv states,
  give the reference's hidden states and codebook-0 logits; so do a
  right-padded bucket prefill and a cached context extended by a padded
  prompt.
- The conv and attention layers against ``transformers``' ``Lfm2`` at a
  tiny size: the layer equations tied to a published implementation.
- A pool slot reused after another session serves the second session as a
  fresh pool does: no conv state leaks.
- A mesh Generator and the finetuner's loss refuse the hybrid backbone.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import specs, texts
from sesameai_tts_tpu_torch.core.config import (
    csm_lfm2_8b_a1b,
    csm_test_tiny_hybrid,
    get_flavor,
)
from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.models import hybrid
from sesameai_tts_tpu_torch.models.transformer import precompute_rope
from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_lfm2_8b_a1b_spec
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_hybrid_spec as tiny_hybrid_spec

ROOT = Path(__file__).resolve().parents[1]
TINY_CFG = json.loads((ROOT / "benchmark/tests/tiny/configs/lfm2-tiny-int8.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    """(params, the port's CSMConfig, the reference, a voice) of the tiny
    hybrid, f32, drawn by the benchmark's family from a seed."""
    fam = specs.family(ROOT / "benchmark", "lfm2_moe")
    cfg = dict(TINY_CFG, quantize=None)
    params = fam.draw(cfg, 11, "cpu")
    mcfg, _ = fam.port(cfg, "test-hybrid-parity")
    assert mcfg.backbone == get_flavor("test-tiny-hybrid")  # the port's own tiny flavor
    voice = texts.make_voices(cfg, 1, (20, 20), np.random.default_rng(1))[0]
    return params, mcfg, fam.reference(params, cfg), voice


def _rows(tokens, mask, pad=0):
    S, W = tokens.shape
    t = np.zeros((1, S + pad, W), np.int64)
    m = np.zeros((1, S + pad, W), bool)
    t[0, :S], m[0, :S] = tokens, mask
    return torch.from_numpy(t), torch.from_numpy(m), torch.tensor([S])


def _decode(params, mcfg, state, frames, rope):
    """Each of ``frames`` fed back at S = 1 → (F, D) hidden states."""
    K = mcfg.audio_num_codebooks
    out = []
    for f in frames:
        tok = torch.zeros((1, 1, K + 1), dtype=torch.int64)
        tok[0, 0, :K] = f
        mask = torch.ones((1, 1, K + 1), dtype=torch.bool)
        mask[..., K] = False
        h, state = csm_model.backbone_last_hidden(params, mcfg, state, tok, mask, rope_cs=rope)
        out.append(h)
    return torch.cat(out), state


@pytest.mark.parametrize("route", ["prefill", "padded prefill", "cached context + extend"])
def test_the_cached_steps_give_the_full_forward(model, route):
    params, mcfg, ref, voice = model
    K = mcfg.audio_num_codebooks
    text_tok, text_mask = texts.prompt_rows(TINY_CFG, voice, "the words of a short test")
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(1, 60, size=(7, K)))
    rope = precompute_rope(mcfg.backbone)
    state = csm_model.init_state(mcfg, 1, torch.float32)
    with torch.no_grad():
        if route == "cached context + extend":
            vt, vm, vl = _rows(voice.tokens.astype(np.int64), voice.mask, pad=9)
            cached = csm_model.extend_state(params, mcfg, state, vt, vm, vl, rope_cs=rope)
            state = csm_model.init_state(mcfg, 1, torch.float32)
            csm_model.load_state(state, cached)
            state = csm_model.CSMState(state.cache, cached.pos.clone(), state.conv)
            n_text = text_tok.shape[0] - voice.tokens.shape[0]
            tt, tm, tl = _rows(text_tok[-n_text:], text_mask[-n_text:], pad=5)
        else:
            tt, tm, tl = _rows(text_tok, text_mask, pad=6 if route == "padded prefill" else 0)
        h0, state = csm_model.backbone_last_hidden(params, mcfg, state, tt, tm, tl, rope_cs=rope)
        hs, _ = _decode(params, mcfg, state, frames[:-1], rope)
        got = torch.cat([h0, hs])
        prompt = (torch.from_numpy(text_tok), torch.from_numpy(text_mask))
        x = ref.embed(torch.cat([prompt[0], torch.nn.functional.pad(frames[:-1], (0, 1))]),
                      torch.cat([prompt[1], torch.ones((6, K + 1), dtype=torch.bool)
                                 .index_fill_(1, torch.tensor([K]), False)]))
        want = ref.backbone(x[None])[0, prompt[0].shape[0] - 1:]
        logits = ref.frame_logits(prompt, frames)[:, 0]
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()
    c0 = got @ params["codebook0_head"].float()
    assert torch.allclose(c0, logits, atol=2e-5, rtol=1e-4), (c0 - logits).abs().max()


def _hf_tiny():
    """A tiny transformers Lfm2Model (eager attention, no FFN resizing)
    with norms and conv taps away from their initial values, and the same
    weights in the port's layout."""
    from transformers import Lfm2Config, Lfm2Model

    torch.manual_seed(0)
    hf_cfg = Lfm2Config(vocab_size=32, hidden_size=64, intermediate_size=96,
                        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                        layer_types=["conv", "full_attention", "conv", "full_attention"],
                        conv_L_cache=3, block_auto_adjust_ff_dim=False, norm_eps=1e-5,
                        rope_theta=1e6, max_position_embeddings=64)
    hf_cfg._attn_implementation = "eager"
    hf = Lfm2Model(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name or "conv.weight" in name:
                p.add_(0.2 * torch.randn_like(p))
    cfg = hybrid.HybridConfig(
        num_layers=4, num_heads=4, num_kv_heads=2, embed_dim=64, max_seq_len=64,
        intermediate_dim=96, layer_types=tuple(hf_cfg.layer_types), num_dense_layers=4,
        num_experts=1, num_experts_per_tok=1, moe_intermediate_dim=8, dtype=torch.float32)
    layers = []
    for lay in hf.layers:
        wl = {"operator_norm": lay.operator_norm.weight.detach(),
              "ffn_norm": lay.ffn_norm.weight.detach(),
              "w13": torch.cat([lay.feed_forward.w1.weight.T, lay.feed_forward.w3.weight.T],
                               dim=1).detach(),
              "w2": lay.feed_forward.w2.weight.T.detach()}
        if lay.is_attention_layer:
            a = lay.self_attn
            wl.update(qkv=torch.cat([a.q_proj.weight.T, a.k_proj.weight.T, a.v_proj.weight.T],
                                    dim=1).detach(),
                      q_norm=a.q_layernorm.weight.detach(), k_norm=a.k_layernorm.weight.detach(),
                      o_proj=a.out_proj.weight.T.detach())
        else:
            c = lay.conv
            wl.update(in_proj=c.in_proj.weight.T.detach(), conv=c.conv.weight[:, 0].detach(),
                      out_proj=c.out_proj.weight.T.detach())
        layers.append(wl)
    params = {"layers": tuple(layers), "final_norm": hf.embedding_norm.weight.detach()}
    return hf, cfg, params


def test_the_conv_and_attention_layers_are_transformers_lfm2():
    hf, cfg, params = _hf_tiny()
    x = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(inputs_embeds=x, use_cache=False).last_hidden_state
        rope = precompute_rope(cfg)
        cache = hybrid.init_attention_cache(cfg, 2, torch.float32)
        conv = hybrid.init_conv_state(cfg, 2, torch.float32)
        # seven rows as a prefill, then four S = 1 steps through the state
        got = [hybrid.hybrid_forward(params, cfg, x[:, :7], torch.zeros(2, dtype=torch.int64),
                                     cache, conv, rope)]
        for t in range(7, 11):
            got.append(hybrid.hybrid_forward(params, cfg, x[:, t:t + 1],
                                             torch.full((2,), t, dtype=torch.int64),
                                             cache, conv, rope))
    got = torch.cat(got, dim=1)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()


def test_a_reused_slot_leaks_no_conv_state():
    """Session B on the one slot session A used gets the greedy frames of
    B alone (the Generator's B=1 ``generate_frames``), and the PCM of B on
    a fresh pool: its conv states came with its prefill, none of A's.  The
    pool's ticks and ``/metrics`` carry the experts counters."""
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    gen = build_generator(dataclasses.replace(tiny_hybrid_spec(), quantize="int8"),
                          device="cpu")
    greedy = dict(max_audio_length_ms=640, topk=1, temperature=1.0)

    def serve(texts_):
        srv = BatchedTTSServer(gen.clone(), slots=1, chunk_frames=3)
        srv.start()
        try:
            out = []
            for t in texts_:
                s = srv.submit(t, speaker=1, **greedy)
                out.append((s.audio(timeout=120), np.concatenate(s.frames_out)))
            # the routed backbone's counters: on each tick record and a /metrics series
            series = srv.metrics_summary()["series"]
            assert series["experts_hit"]["count"] > 0 and series["expert_rows_max"]["max"] >= 1
            ticks = [t for t in s.ticks if t.experts_hit is not None]
            assert ticks and all(0 < t.experts_hit <= 3 * 8 * t.n for t in ticks)
            return out
        finally:
            srv.stop()

    (_, frames_a), (pcm_b, frames_b) = serve(["the first session speaks", "and the second"])
    ((fresh_pcm, fresh_frames),) = serve(["and the second"])
    assert frames_a.shape[0] > 0
    np.testing.assert_array_equal(frames_b, gen.generate_frames("and the second", 1, [], **greedy))
    assert np.array_equal(frames_b, fresh_frames) and np.array_equal(pcm_b, fresh_pcm)


def test_the_state_carries_conv_rows_and_the_counters():
    cfg = csm_test_tiny_hybrid()
    state = csm_model.init_state(cfg, 3, torch.float32)
    bb = cfg.backbone
    assert len(state.cache.k) == len(bb.attention_layers) == 1
    assert [tuple(t.shape) for t in state.conv] == [(3, 64, 2)] * len(bb.conv_layers)
    params = csm_model.init_csm_params(cfg, torch.Generator().manual_seed(0))
    bufs = csm_model.init_decode_buffers(params, cfg, 3)
    assert bufs.moe_stats.dtype == torch.int32 and bufs.moe_stats.tolist() == [0, 0]
    state.conv[0].fill_(1.0)
    csm_model.load_state(state)
    assert all(float(t.abs().sum()) == 0 for t in state.conv)


def test_the_published_flavor():
    bb = csm_lfm2_8b_a1b().backbone
    assert (bb.num_layers, len(bb.conv_layers), bb.attention_layers) == (24, 18,
                                                                         (2, 6, 10, 14, 18, 21))
    assert (bb.embed_dim, bb.num_heads, bb.num_kv_heads, bb.head_dim) == (2048, 32, 8, 64)
    assert (bb.num_dense_layers, bb.intermediate_dim, bb.num_experts, bb.num_experts_per_tok,
            bb.moe_intermediate_dim) == (2, 7168, 32, 4, 1792)
    assert bb.rope.base == 1e6 and bb.conv_L_cache == 3 and bb.use_expert_bias
    assert csm_lfm2_8b_a1b().text_vocab_size == 65536
    spec = csm_lfm2_8b_a1b_spec()
    assert spec.csm == csm_lfm2_8b_a1b() and spec.quantize == "int8"


def test_a_mesh_and_the_finetuner_refuse_the_hybrid_backbone():
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.training import loss

    cfg = csm_test_tiny_hybrid()
    with pytest.raises(NotImplementedError, match="one card"):
        Generator({}, cfg, None, {}, None, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="Llama backbones"):
        loss.csm_loss({}, cfg, None)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        csm_model._refuse_tp(cfg, object())
