"""CSM dual-transformer model: 1B backbone + 100M codebook decoder (port of
``sesameai_tts_tpu/models/csm.py``).

Plain functions over a parameter dict.  ``CSMState`` carries the backbone
KV cache, which every call here updates IN PLACE, and the next position.
Randomness comes from one ``torch.Generator`` per frame: the c0 draw
first, then one ``(K-1, B, V)`` Gumbel draw for the codebook decoder.
``decode_frames`` seeds frame i's generator from (utterance seed, absolute
frame index) only, so every chunk schedule gives the same frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.models.transformer import (
    KVCache,
    clone_kv_cache,
    init_kv_cache,
    init_transformer_params,
    precompute_rope,
    transformer_forward,
)
from sesameai_tts_tpu_torch.ops.sampling import gumbel_noise, sample_topk


def init_csm_params(cfg: CSMConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random params (JAX package shapes), drawn on the generator's device."""
    bb, dec = cfg.backbone, cfg.decoder
    dtype = dtype or bb.dtype
    dev = generator.device
    scale_b = bb.embed_dim ** -0.5
    scale_d = dec.embed_dim ** -0.5

    def randn(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    return {
        "backbone": init_transformer_params(bb, generator, dtype),
        "decoder": init_transformer_params(dec, generator, dtype),
        "text_embeddings": randn((cfg.text_vocab_size, bb.embed_dim), scale_b),
        "audio_embeddings": randn(
            (cfg.audio_vocab_size * cfg.audio_num_codebooks, bb.embed_dim), scale_b
        ),
        "projection": randn((bb.embed_dim, dec.embed_dim), scale_b),
        "codebook0_head": randn((bb.embed_dim, cfg.audio_vocab_size), scale_b),
        "audio_head": randn(
            (cfg.audio_num_codebooks - 1, dec.embed_dim, cfg.audio_vocab_size), scale_d
        ),
    }


class CSMState(NamedTuple):
    """Backbone decoding state: the KV cache (updated in place) and the
    next position to write, (B,) on the device."""

    cache: KVCache
    pos: torch.Tensor


def init_state(cfg: CSMConfig, batch_size: int, dtype=None, device="cpu") -> CSMState:
    bb = cfg.backbone
    return CSMState(
        cache=init_kv_cache(bb, batch_size, dtype or bb.dtype, device=device),
        pos=torch.zeros(batch_size, dtype=torch.int64, device=device),
    )


def clone_state(state: CSMState) -> CSMState:
    """A copy whose cache later in-place writes leave the original intact."""
    return CSMState(cache=clone_kv_cache(state.cache), pos=state.pos.clone())


def frame_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of frame ``index`` of the utterance seeded ``seed``."""
    mixed = np.random.SeedSequence([seed % 2**64, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def embed_frames(params: dict, cfg: CSMConfig, tokens: torch.Tensor,
                 tokens_mask: torch.Tensor) -> torch.Tensor:
    """(B, S, K+1) tokens + bool mask → (B, S, D) masked-sum embedding.
    Columns 0..K-1 are the audio codebooks (flat table indexed ``token +
    codebook*vocab``), column K is the text token."""
    K = cfg.audio_num_codebooks
    audio_tok = tokens[..., :K] + torch.arange(K, device=tokens.device) * cfg.audio_vocab_size
    audio_emb = params["audio_embeddings"][audio_tok]  # (B, S, K, D)
    text_emb = params["text_embeddings"][tokens[..., K]][..., None, :]  # (B, S, 1, D)
    embeds = torch.cat([audio_emb, text_emb], dim=-2)
    return (embeds * tokens_mask[..., None]).sum(dim=-2)


def _head_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits of h @ head.  Both operands are upcast to f32 first: the
    upcast of a bf16 value is exact and so is the f32 product of two of
    them, so this is the JAX package's bf16-operand, f32-accumulate dot.  A
    bare bf16 matmul would round the logits to bf16."""
    return h.float() @ head.float()


def _decode_codebooks(
    params: dict,
    cfg: CSMConfig,
    last_h: torch.Tensor,  # (B, D_backbone)
    c0: torch.Tensor,  # (B,)
    generator: Optional[torch.Generator],
    temperature,
    topk,
    fused_mlp: bool = False,
) -> torch.Tensor:
    """Run the decoder AR over codebooks 1..K-1 → (B, K-1) samples.  The
    decoder cache is fresh every frame, positions 0..K-1."""
    dec = cfg.decoder
    K = cfg.audio_num_codebooks
    B = last_h.shape[0]
    dev = last_h.device
    dtype = params["projection"].dtype
    cache = init_kv_cache(dec, B, dtype, max_seq_len=K, device=dev)
    rope_cs = precompute_rope(dec, max_len=K, device=dev)

    def dec_step(x, pos):
        pos0 = torch.full((B,), pos, dtype=torch.int64, device=dev)
        h, _ = transformer_forward(params["decoder"], dec, x, pos0, cache, rope_cs,
                                   fused_mlp=fused_mlp)
        return h[:, 0, :]

    # position 0: the projected backbone hidden; its output is unused
    dec_step((last_h[:, None, :] @ params["projection"]).to(dtype), 0)

    greedy = isinstance(topk, (int, np.integer)) and topk <= 1
    gumbels = None if greedy else gumbel_noise(generator, (K - 1, B, cfg.audio_vocab_size))
    prev_c = c0
    cs = []
    for i in range(K - 1):
        emb = params["audio_embeddings"][prev_c + i * cfg.audio_vocab_size]
        h = dec_step((emb[:, None, :] @ params["projection"]).to(dtype), i + 1)
        logits = _head_logits(h, params["audio_head"][i])
        prev_c = sample_topk(None, logits, topk, temperature,
                             gumbel=None if greedy else gumbels[i])
        cs.append(prev_c)
    return torch.stack(cs, dim=1)


def extend_state(params: dict, cfg: CSMConfig, state: CSMState, tokens: torch.Tensor,
                 tokens_mask: torch.Tensor, valid_len: Optional[torch.Tensor] = None,
                 rope_cs: Optional[torch.Tensor] = None) -> CSMState:
    """Run the backbone over rows without sampling (a voice-context prefix)."""
    bb = cfg.backbone
    S = tokens.shape[1]
    if rope_cs is None:
        rope_cs = precompute_rope(bb, device=tokens.device)
    x = embed_frames(params, cfg, tokens, tokens_mask).to(params["projection"].dtype)
    _, cache = transformer_forward(params["backbone"], bb, x, state.pos, state.cache,
                                   rope_cs, valid_len=valid_len)
    return CSMState(cache=cache, pos=state.pos + (valid_len if valid_len is not None else S))


def generate_frame(
    params: dict,
    cfg: CSMConfig,
    state: CSMState,
    tokens: torch.Tensor,  # (B, S, K+1)
    tokens_mask: torch.Tensor,  # (B, S, K+1)
    generator: Optional[torch.Generator],
    temperature=0.8,
    topk=40,
    valid_len: Optional[torch.Tensor] = None,  # (B,) for right-padded prefill
    rope_cs: Optional[torch.Tensor] = None,
    fused_mlp: bool = False,
) -> Tuple[torch.Tensor, CSMState]:
    """One frame of K codes from a window of input rows (prefill: S prompt
    rows; decode: S=1 feedback row) → ((B, K) frame, new state).
    ``fused_mlp`` sends the int8 MLPs to the fused ``quant_mlp`` kernel."""
    bb = cfg.backbone
    B, S, _ = tokens.shape
    if rope_cs is None:
        rope_cs = precompute_rope(bb, device=tokens.device)
    x = embed_frames(params, cfg, tokens, tokens_mask).to(params["projection"].dtype)
    h, cache = transformer_forward(params["backbone"], bb, x, state.pos, state.cache,
                                   rope_cs, valid_len=valid_len, fused_mlp=fused_mlp)
    if valid_len is None:
        last_h = h[:, -1, :]
        new_pos = state.pos + S
    else:
        # clamp: a valid_len=0 row (an idle slot of a batched prefill)
        # would gather row -1; its output is meaningless but must be defined
        idx = torch.clamp_min(valid_len - 1, 0)
        last_h = h[torch.arange(B, device=h.device), idx]
        new_pos = state.pos + valid_len

    c0 = sample_topk(generator, _head_logits(last_h, params["codebook0_head"]),
                     topk, temperature)
    cs = _decode_codebooks(params, cfg, last_h, c0, generator, temperature, topk, fused_mlp)
    frame = torch.cat([c0[:, None], cs], dim=1)
    return frame, CSMState(cache=cache, pos=new_pos)


def _feedback_mask(B: int, K: int, device) -> torch.Tensor:
    """Feedback row mask: K audio columns on, the text column off."""
    mask = torch.ones((B, 1, K + 1), dtype=torch.bool, device=device)
    mask[..., K] = False
    return mask


def decode_frames(
    params: dict,
    cfg: CSMConfig,
    state: CSMState,
    prev_frame: torch.Tensor,  # (B, K) last sampled frame
    prev_done: torch.Tensor,  # (B,) bool — EOS already hit
    seed: int,
    num_frames: int,
    temperature=0.8,
    topk=40,
    rope_cs: Optional[torch.Tensor] = None,
    start_index: int = 0,
    fused_mlp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, CSMState]:
    """Generate ``num_frames`` more frames on the device, the all-zero-frame
    EOS rule applied as masking.  Frame ``start_index + i`` draws its noise
    from ``frame_generator(seed, start_index + i)``.

    Returns (frames (T, B, K), valid (T, B) bool, done (B,), new state)."""
    K = cfg.audio_num_codebooks
    B = prev_frame.shape[0]
    dev = prev_frame.device
    if rope_cs is None:
        rope_cs = precompute_rope(cfg.backbone, device=dev)
    mask_row = _feedback_mask(B, K, dev)
    zero_text = torch.zeros((B, 1, 1), dtype=prev_frame.dtype, device=dev)
    frame, done = prev_frame, prev_done
    frames, valids = [], []
    for i in range(num_frames):
        tokens = torch.cat([frame[:, None, :], zero_text], dim=-1)
        gen = frame_generator(seed, start_index + i, dev)
        new_frame, state = generate_frame(params, cfg, state, tokens, mask_row, gen,
                                          temperature, topk, rope_cs=rope_cs,
                                          fused_mlp=fused_mlp)
        is_eos = (new_frame == 0).all(dim=-1)
        valid = ~(done | is_eos)
        done = done | is_eos
        # post-EOS steps still run; their outputs are masked to zeros
        frame = torch.where(valid[:, None], new_frame, 0)
        frames.append(frame)
        valids.append(valid)
    return torch.stack(frames), torch.stack(valids), done, state


def teacher_forced_eval(
    params: dict,
    cfg: CSMConfig,
    state: CSMState,
    teacher: torch.Tensor,  # (T, B, K) fixed feedback trajectory
    rope_cs: Optional[torch.Tensor] = None,
    fused_mlp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode with the feedback forced to ``teacher`` → ((T, B, K)
    greedy frames, (T, B, V) f32 codebook-0 logits)."""
    bb = cfg.backbone
    K = cfg.audio_num_codebooks
    B = teacher.shape[1]
    dev = teacher.device
    if rope_cs is None:
        rope_cs = precompute_rope(bb, device=dev)
    mask_row = _feedback_mask(B, K, dev)
    zero_text = torch.zeros((B, 1, 1), dtype=teacher.dtype, device=dev)
    frames, logits_all = [], []
    for fin in teacher:
        tokens = torch.cat([fin[:, None, :], zero_text], dim=-1)
        x = embed_frames(params, cfg, tokens, mask_row).to(params["projection"].dtype)
        h, cache = transformer_forward(params["backbone"], bb, x, state.pos, state.cache,
                                       rope_cs, fused_mlp=fused_mlp)
        last_h = h[:, -1, :]
        c0_logits = _head_logits(last_h, params["codebook0_head"])
        c0 = c0_logits.argmax(dim=-1)
        cs = _decode_codebooks(params, cfg, last_h, c0, None, 1.0, 1, fused_mlp)
        frames.append(torch.cat([c0[:, None], cs], dim=1))
        logits_all.append(c0_logits)
        state = CSMState(cache=cache, pos=state.pos + 1)
    return torch.stack(frames), torch.stack(logits_all)
