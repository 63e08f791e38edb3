"""CSM dual-transformer model: 1B backbone + 100M codebook decoder (port of
``sesameai_tts_tpu/models/csm.py``).

Plain functions over a parameter dict.  ``CSMState`` carries the backbone
KV cache, which every call here updates IN PLACE, and the next position.
``decode_step`` decodes one frame on static buffers (``DecodeBuffers``)
and is what the Generator captures as CUDA graphs; ``decode_frames`` and
``generate_frame`` run the same steps eagerly.  Randomness comes from one
``torch.Generator`` seeded per frame from (utterance seed, absolute frame
index) only (``frame_seed``), so every chunk schedule gives the same
frames: the c0 draw first, then one ``(K-1, B, V)`` Gumbel draw for the
codebook decoder.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.models.transformer import (
    KVCache,
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


def load_state(dst: CSMState, src: Optional[CSMState] = None) -> None:
    """Overwrite ``dst`` in place with ``src`` (a cached voice context), or
    with the zeros of ``init_state`` when ``src`` is None."""
    if src is None:
        for t in dst.cache.k + dst.cache.v:
            t.zero_()
        dst.pos.zero_()
        return
    for d, s in zip(dst.cache.k + dst.cache.v, src.cache.k + src.cache.v):
        d.copy_(s)
    dst.pos.copy_(src.pos)


def frame_seed(seed: int, index: int) -> int:
    """The noise seed of frame ``index`` of the utterance seeded ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, index]).generate_state(1, np.uint64)[0])


def frame_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of frame ``index`` of the utterance seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(frame_seed(seed, index))


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


class DecodeBuffers(NamedTuple):
    """The static inputs and outputs of one decode step at batch B, written
    in place every frame, so that a CUDA graph captured over them serves
    every frame of every request."""

    frame: torch.Tensor  # (B, K) int64: the frame fed back in, the new frame out
    done: torch.Tensor  # (B,) bool: EOS already hit, in and out
    valid: torch.Tensor  # (B,) bool out: the new frame comes before EOS
    last_h: torch.Tensor  # (B, D) the backbone's hidden state the frame is sampled from
    temperature: torch.Tensor  # (B,) f32
    topk: torch.Tensor  # (B,) int64
    # the decoder's cache over the K codebook positions: every frame rewrites
    # every position before causal attention reads it, so it is never zeroed
    dec_cache: KVCache
    dec_rope: torch.Tensor  # (K, hd/2, 2) the decoder's RoPE table


def init_decode_buffers(params: dict, cfg: CSMConfig, batch_size: int,
                        device="cpu") -> DecodeBuffers:
    """Buffers for batch ``batch_size`` in the params' dtype; the sampling
    parameters start at temperature 1, topk 1."""
    dec, K = cfg.decoder, cfg.audio_num_codebooks
    dtype = params["projection"].dtype
    return DecodeBuffers(
        frame=torch.zeros((batch_size, K), dtype=torch.int64, device=device),
        done=torch.zeros(batch_size, dtype=torch.bool, device=device),
        valid=torch.zeros(batch_size, dtype=torch.bool, device=device),
        last_h=torch.zeros((batch_size, cfg.backbone.embed_dim), dtype=dtype, device=device),
        temperature=torch.ones(batch_size, dtype=torch.float32, device=device),
        topk=torch.ones(batch_size, dtype=torch.int64, device=device),
        dec_cache=init_kv_cache(dec, batch_size, dtype, max_seq_len=K, device=device),
        dec_rope=precompute_rope(dec, max_len=K, device=device),
    )


def is_greedy(topk) -> bool:
    """A number ``topk <= 1`` samples by exact argmax; a per-row tensor
    always takes the threshold (as ``sample_topk`` does)."""
    return isinstance(topk, (int, np.integer)) and topk <= 1


def set_sampling(bufs: DecodeBuffers, temperature, topk) -> None:
    """Write a request's temperature and topk (numbers or per-row tensors)
    into the buffers; a number is a fill, so no host copy is made."""
    for buf, value in ((bufs.temperature, temperature), (bufs.topk, topk)):
        if isinstance(value, torch.Tensor):
            buf.copy_(value)
        else:
            buf.fill_(value)


def _decode_codebooks(
    params: dict,
    cfg: CSMConfig,
    bufs: DecodeBuffers,
    c0: torch.Tensor,  # (B,)
    generator: Optional[torch.Generator],
    temperature,
    topk,
    fused_mlp: bool = False,
) -> torch.Tensor:
    """Run the decoder AR over codebooks 1..K-1 from ``bufs.last_h`` →
    (B, K-1) samples, positions 0..K-1 of ``bufs.dec_cache``."""
    dec = cfg.decoder
    K = cfg.audio_num_codebooks
    B = c0.shape[0]
    dev = c0.device
    dtype = params["projection"].dtype

    def dec_step(x, pos):
        pos0 = torch.full((B,), pos, dtype=torch.int64, device=dev)
        h, _ = transformer_forward(params["decoder"], dec, x, pos0, bufs.dec_cache,
                                   bufs.dec_rope, fused_mlp=fused_mlp)
        return h[:, 0, :]

    # position 0: the projected backbone hidden; its output is unused
    dec_step((bufs.last_h[:, None, :] @ params["projection"]).to(dtype), 0)

    greedy = is_greedy(topk)
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


def sample_step(params: dict, cfg: CSMConfig, bufs: DecodeBuffers,
                generator: Optional[torch.Generator], greedy: bool,
                fused_mlp: bool = False) -> None:
    """Sample a frame from ``bufs.last_h`` (c0 from the backbone's head, then
    codebooks 1..K-1 through the decoder) and apply the all-zero-frame EOS
    rule in place: ``bufs.valid`` = not (done or EOS), ``bufs.done`` |= EOS,
    ``bufs.frame`` = the frame, zeros once invalid.  A sampled step reads
    ``bufs.temperature`` and ``bufs.topk`` and draws the c0 noise, then one
    ``(K-1, B, V)`` block, from ``generator``; a greedy one draws nothing."""
    temperature, topk = (1.0, 1) if greedy else (bufs.temperature, bufs.topk)
    c0 = sample_topk(generator, _head_logits(bufs.last_h, params["codebook0_head"]),
                     topk, temperature)
    cs = _decode_codebooks(params, cfg, bufs, c0, generator, temperature, topk, fused_mlp)
    frame = torch.cat([c0[:, None], cs], dim=1)
    is_eos = (frame == 0).all(dim=-1)
    torch.logical_not(bufs.done | is_eos, out=bufs.valid)
    bufs.done.logical_or_(is_eos)
    # post-EOS steps still run; their outputs are masked to zeros
    bufs.frame.copy_(torch.where(bufs.valid[:, None], frame, 0))


def backbone_step(params: dict, cfg: CSMConfig, state: CSMState, bufs: DecodeBuffers,
                  rope_cs: torch.Tensor, fused_mlp: bool = False) -> None:
    """Feed ``bufs.frame`` back through the backbone at ``state.pos`` →
    ``bufs.last_h``; the KV cache is written and ``state.pos`` advances by
    one, both in place.

    ``state.pos`` stops at the cache's last slot, which later steps then
    rewrite: the JAX package's ``dynamic_update_slice`` clamps such a write
    to the same slot.  Only rows past their last frame get there (a serving
    pool's idle slots, and a tick's frames past a session's budget); the
    frames a request keeps never do (``Generator`` clamps the budget to the
    room left)."""
    B, K = bufs.frame.shape
    text = torch.zeros((B, 1, 1), dtype=bufs.frame.dtype, device=bufs.frame.device)
    tokens = torch.cat([bufs.frame[:, None, :], text], dim=-1)
    last_h, _ = backbone_last_hidden(params, cfg, state, tokens,
                                     _feedback_mask(B, K, tokens.device), rope_cs=rope_cs,
                                     fused_mlp=fused_mlp)
    bufs.last_h.copy_(last_h)
    state.pos.add_(1).clamp_(max=state.cache.k[0].shape[2] - 1)


def decode_step(params: dict, cfg: CSMConfig, state: CSMState, bufs: DecodeBuffers,
                generator: Optional[torch.Generator], greedy: bool, rope_cs: torch.Tensor,
                fused_mlp: bool = False) -> None:
    """One decoded frame on static buffers (the body of the JAX package's
    ``decode_frames`` scan): ``backbone_step`` then ``sample_step``.  It
    allocates nothing that outlives it, copies nothing from the host and
    reads the sampling parameters from ``bufs``, so a CUDA graph can
    capture it."""
    backbone_step(params, cfg, state, bufs, rope_cs, fused_mlp)
    sample_step(params, cfg, bufs, generator, greedy, fused_mlp)


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


def backbone_last_hidden(
    params: dict,
    cfg: CSMConfig,
    state: CSMState,
    tokens: torch.Tensor,  # (B, S, K+1)
    tokens_mask: torch.Tensor,  # (B, S, K+1)
    valid_len: Optional[torch.Tensor] = None,  # (B,) for right-padded prefill
    rope_cs: Optional[torch.Tensor] = None,
    fused_mlp: bool = False,
) -> Tuple[torch.Tensor, CSMState]:
    """The backbone over a window of rows → ((B, D) hidden state of each
    row's last valid row, new state); the cache is written in place."""
    bb = cfg.backbone
    B, S, _ = tokens.shape
    if rope_cs is None:
        rope_cs = precompute_rope(bb, device=tokens.device)
    x = embed_frames(params, cfg, tokens, tokens_mask).to(params["projection"].dtype)
    h, cache = transformer_forward(params["backbone"], bb, x, state.pos, state.cache,
                                   rope_cs, valid_len=valid_len, fused_mlp=fused_mlp)
    if valid_len is None:
        return h[:, -1, :], CSMState(cache=cache, pos=state.pos + S)
    # clamp: a valid_len=0 row (an idle slot of a batched prefill) would
    # gather row -1; its output is meaningless but must be defined
    idx = torch.clamp_min(valid_len - 1, 0)
    return h[torch.arange(B, device=h.device), idx], CSMState(cache=cache,
                                                              pos=state.pos + valid_len)


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
    last_h, state = backbone_last_hidden(params, cfg, state, tokens, tokens_mask, valid_len,
                                         rope_cs, fused_mlp)
    bufs = init_decode_buffers(params, cfg, tokens.shape[0], tokens.device)
    set_sampling(bufs, temperature, topk)
    bufs.last_h.copy_(last_h)
    sample_step(params, cfg, bufs, generator, is_greedy(topk), fused_mlp)
    return bufs.frame, state


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
    """Generate ``num_frames`` more frames on the device, eagerly, one
    ``decode_step`` each, the all-zero-frame EOS rule applied as masking.
    Frame ``start_index + i`` draws its noise from ``frame_generator(seed,
    start_index + i)``.  The cache is written in place; ``state.pos`` is not.

    Returns (frames (T, B, K), valid (T, B) bool, done (B,), new state)."""
    B = prev_frame.shape[0]
    dev = prev_frame.device
    if rope_cs is None:
        rope_cs = precompute_rope(cfg.backbone, device=dev)
    bufs = init_decode_buffers(params, cfg, B, dev)
    set_sampling(bufs, temperature, topk)
    bufs.frame.copy_(prev_frame)
    bufs.done.copy_(prev_done)
    state = CSMState(cache=state.cache, pos=state.pos.clone())
    generator = torch.Generator(device=dev)
    greedy = is_greedy(topk)
    frames, valids = [], []
    for i in range(num_frames):
        generator.manual_seed(frame_seed(seed, start_index + i))
        decode_step(params, cfg, state, bufs, generator, greedy, rope_cs, fused_mlp)
        frames.append(bufs.frame.clone())
        valids.append(bufs.valid.clone())
    return torch.stack(frames), torch.stack(valids), bufs.done.clone(), state


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
    K = cfg.audio_num_codebooks
    B = teacher.shape[1]
    dev = teacher.device
    if rope_cs is None:
        rope_cs = precompute_rope(cfg.backbone, device=dev)
    mask_row = _feedback_mask(B, K, dev)
    zero_text = torch.zeros((B, 1, 1), dtype=teacher.dtype, device=dev)
    bufs = init_decode_buffers(params, cfg, B, dev)
    frames, logits_all = [], []
    for fin in teacher:
        tokens = torch.cat([fin[:, None, :], zero_text], dim=-1)
        last_h, state = backbone_last_hidden(params, cfg, state, tokens, mask_row,
                                             rope_cs=rope_cs, fused_mlp=fused_mlp)
        bufs.last_h.copy_(last_h)
        c0_logits = _head_logits(last_h, params["codebook0_head"])
        c0 = c0_logits.argmax(dim=-1)
        cs = _decode_codebooks(params, cfg, bufs, c0, None, 1.0, 1, fused_mlp)
        frames.append(torch.cat([c0[:, None], cs], dim=1))
        logits_all.append(c0_logits)
    return torch.stack(frames), torch.stack(logits_all)
