"""Generation orchestration: the ``Generator`` (port of
``sesameai_tts_tpu/runtime/generator.py``).

Text (and optional voice-context segments) → bucketed prefill through the
dense shadow of the quantized trunks → chunks of ``decode_frames`` on the
device with one host EOS check per chunk → Mimi decode to 24 kHz PCM,
offline or streamed with carried codec state.

``seed`` makes an utterance reproducible and independent of the chunk
schedule: frame i (the prefill frame is 0) draws its noise from
``frame_generator(seed, i)``, so ``generate`` and ``generate_stream``
give the same frames for one seed.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi
from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.models.transformer import precompute_rope
from sesameai_tts_tpu_torch.ops.quant import dequantize_csm, is_quantized, is_quantized4
from sesameai_tts_tpu_torch.runtime.frames import (
    FrameTokenizer,
    Segment,
    pad_audio_to_frame_bucket,
)
from sesameai_tts_tpu_torch.utils.profiling import Metrics

log = logging.getLogger(__name__)

FRAME_MS = 80.0  # 12.5 Hz


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def _next_bucket(n: int, buckets: Sequence[int], room: Optional[int] = None) -> int:
    """Smallest bucket ≥ n, capped to ``room`` (slots left in the KV cache)
    so a padded prefill never writes past the cache end: a torch index
    write past the end raises.  When the bucket would spill past ``room``,
    take the largest 64-multiple that still fits."""
    for b in buckets:
        if n <= b:
            if room is None or b <= room:
                return b
            q = (room // 64) * 64
            return q if q >= n else room
    raise ValueError(f"Inputs too long, must be below max_seq_len: {n} > {buckets[-1]}")


class Generator:
    """Owns the CSM params, Mimi and the tokenizer; exposes generate,
    generate_stream and generate_frames."""

    def __init__(
        self,
        csm_params: dict,
        csm_cfg: CSMConfig,
        mimi: Mimi,
        mimi_params: dict,
        text_tokenizer,
        stream_chunk_frames: int = 1,
        decode_chunk_frames: int = 10,
        seed: int = 0,
        device="cuda",
        fused_mlp: bool = False,
    ):
        self.device = resolve_device(device)
        self._params = csm_params
        # the decode sends int8 MLPs to the fused quant_mlp kernel
        self._fused_mlp = fused_mlp
        # quantized trunks: a persistent dense shadow serves prefill (and
        # the voice-context extend), which is compute-bound; the decode
        # streams the int8 or int4 weights through their kernels
        trunk_layers = csm_params["backbone"]["layers"] + csm_params["decoder"]["layers"]
        if any(is_quantized(w) or is_quantized4(w) for wl in trunk_layers for w in wl.values()):
            # the shadow is bf16, as the JAX package's; a model of another
            # dtype multiplies by its exact upcast, as JAX's type promotion does
            dtype = csm_params["projection"].dtype
            shadow = dequantize_csm(csm_params, torch.bfloat16)
            for trunk in ("backbone", "decoder"):
                shadow[trunk]["layers"] = tuple({k: w.to(dtype) for k, w in wl.items()}
                                                for wl in shadow[trunk]["layers"])
            self._prefill_params = shadow
        else:
            self._prefill_params = csm_params
        self._cfg = csm_cfg
        self._mimi = mimi
        self._mimi_params = mimi_params
        self._mimi_dtype = mimi_params["upsample"]["w"].dtype
        self.sample_rate = mimi.cfg.sample_rate
        self._hop = mimi.cfg.hop_length
        self._stream_chunk_frames = stream_chunk_frames
        self._decode_chunk_frames = decode_chunk_frames
        self._seed_rng = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self._rope = precompute_rope(csm_cfg.backbone, device=self.device)
        self._max_seq_len = csm_cfg.backbone.max_seq_len
        self._prefill_buckets = [64, 128, 256, 384, 512, 768, 1024, 1536, 2048]
        self.metrics = Metrics()
        self._tokenizer = FrameTokenizer(
            text_tokenizer, self._encode_audio, csm_cfg.audio_num_codebooks
        )

    # -- helpers -------------------------------------------------------------

    def _encode_audio(self, audio: np.ndarray) -> np.ndarray:
        """(T,) float32 → (K, F) codes."""
        t0 = time.perf_counter()
        wav, frames = pad_audio_to_frame_bucket(audio, self._hop)
        codes = self._mimi.encode(self._mimi_params, torch.from_numpy(wav).to(self.device))
        codes = codes[0, :, :frames].cpu().numpy()
        self.metrics.record("encode_s", time.perf_counter() - t0)
        return codes

    def _tokenize_prompt(self, text, speaker, context):
        toks, masks = [], []
        for seg in list(context) + [None]:
            if seg is None:
                t, m = self._tokenizer.text_segment(text, speaker)
            elif isinstance(seg, Segment):
                t, m = self._tokenizer.segment(seg)
            else:  # pre-tokenized (tokens, mask) pair
                t, m = seg
            toks.append(t)
            masks.append(m)
        return np.concatenate(toks), np.concatenate(masks)

    def _utterance_seed(self, seed: Optional[int]) -> int:
        if seed is not None:
            return int(seed)
        with self._seed_lock:
            return int(self._seed_rng.integers(2**63))

    def _init_state(self, batch_size: int) -> csm_model.CSMState:
        return csm_model.init_state(self._cfg, batch_size, self._params["projection"].dtype,
                                    device=self.device)

    def _padded(self, tokens: np.ndarray, mask: np.ndarray, bucket: int):
        K = self._cfg.audio_num_codebooks
        S = tokens.shape[0]
        tok_pad = np.zeros((1, bucket, K + 1), np.int64)
        msk_pad = np.zeros((1, bucket, K + 1), bool)
        tok_pad[0, :S], msk_pad[0, :S] = tokens, mask
        valid = torch.tensor([S], dtype=torch.int64, device=self.device)
        return (torch.from_numpy(tok_pad).to(self.device),
                torch.from_numpy(msk_pad).to(self.device), valid)

    # -- what the voice-preload path reads -------------------------------------

    @property
    def max_seq_len(self) -> int:
        """KV-cache capacity in rows (context + utterance + frames)."""
        return self._max_seq_len

    @property
    def context_budget(self) -> int:
        """Rows a precomputed voice context may occupy: the KV capacity less
        a reserve (an eighth, at least 64) for the utterance's text and
        frames."""
        return max(16, self._max_seq_len - max(64, self._max_seq_len // 8))

    @property
    def max_clip_samples(self) -> int:
        """Longest context clip (in samples) worth encoding: the largest
        power-of-2 frame bucket (``frames.pad_audio_to_frame_bucket``) that
        stays inside the codec's RoPE window and is not strictly beyond
        ``context_budget`` rows, whose frames would be tail-trimmed before
        prefill anyway.  Longer clips are trimmed by the caller."""
        cfg = self._mimi.cfg
        frames_window = cfg.max_latent_positions // cfg.downsample_stride
        codec_cap = 1 << (frames_window.bit_length() - 1)
        budget_cap = 1 << (self.context_budget - 1).bit_length()  # pow2 ceil
        return min(codec_cap, budget_cap) * self._hop

    @property
    def frame_tokenizer(self) -> FrameTokenizer:
        return self._tokenizer

    # -- cached voice context --------------------------------------------------

    def precompute_context_state(self, context: Sequence) -> Tuple:
        """Run the backbone over a fixed context once; per-utterance prefill
        then covers only the new text rows.  Returns an opaque (state,
        length) handle for ``cached_context=``; generating from it never
        changes it."""
        toks, masks = [], []
        for seg in context:
            t, m = self._tokenizer.segment(seg) if isinstance(seg, Segment) else seg
            toks.append(t)
            masks.append(m)
        tokens, mask = np.concatenate(toks), np.concatenate(masks)
        S = tokens.shape[0]
        if S > self._max_seq_len - 16:
            raise ValueError(
                f"voice context is {S} rows but the KV cache holds {self._max_seq_len} "
                f"(>=16 must stay free for the utterance); use shorter reference clips"
            )
        bucket = _next_bucket(S, self._prefill_buckets, room=self._max_seq_len)
        tok, msk, valid = self._padded(tokens, mask, bucket)
        state = csm_model.extend_state(self._prefill_params, self._cfg, self._init_state(1),
                                       tok, msk, valid, rope_cs=self._rope)
        return state, S

    # -- generation -------------------------------------------------------------

    def _prefill_utterance(self, text, speaker, context, cached, max_gen,
                           temperature, topk, seed):
        """Prompt prep + prefill → (frame (1, K), state, done (1,), done as a
        host bool (the prefill's one sync), max_gen)."""
        if cached is not None:
            cached_state, ctx_len = cached
            tokens, mask = self._tokenizer.text_segment(text, speaker)
            base_state = csm_model.clone_state(cached_state)  # the cache is written in place
            total = ctx_len + tokens.shape[0]
        else:
            tokens, mask = self._tokenize_prompt(text, speaker, context)
            base_state = self._init_state(1)
            total = tokens.shape[0]
        # only a truly over-long prompt raises; an oversized budget is
        # clamped to the room left
        room = self._max_seq_len - total
        if room <= 8:
            raise ValueError(
                "Inputs too long, must be below max_seq_len - max_generation_len: "
                f"{self._max_seq_len - max_gen}"
            )
        max_gen = min(max_gen, room)
        S = tokens.shape[0]
        bucket = _next_bucket(S, self._prefill_buckets, room=self._max_seq_len - (total - S))
        t0 = time.perf_counter()
        tok, msk, valid = self._padded(tokens, mask, bucket)
        frame, state = csm_model.generate_frame(
            self._prefill_params, self._cfg, base_state, tok, msk,
            csm_model.frame_generator(seed, 0, self.device), temperature, topk,
            valid_len=valid, rope_cs=self._rope,
        )
        done = (frame == 0).all(dim=-1)
        finished = bool(done[0])
        self.metrics.record("prefill_s", time.perf_counter() - t0)
        return frame, state, done, finished, max_gen

    def _decode_chunk(self, state, frame, done, seed, n, start, temperature, topk):
        """``n`` frames from absolute index ``start`` → (frames (n, 1, K),
        number of valid frames (a host int: the chunk's one sync), done,
        state).  Records the chunk's wall time, sync included."""
        t0 = time.perf_counter()
        frames, valid, done, state = csm_model.decode_frames(
            self._params, self._cfg, state, frame, done, seed, n, temperature, topk,
            rope_cs=self._rope, start_index=start, fused_mlp=self._fused_mlp,
        )
        n_valid = int(valid[:, 0].sum())  # host EOS check; valid frames are a prefix
        self.metrics.record("decode_s", time.perf_counter() - t0)
        self.metrics.record("decoded_frames", n)
        return frames, n_valid, done, state

    def _generate_codes(self, text, speaker, context, max_audio_length_ms, temperature,
                        topk, cached_context, seed) -> torch.Tensor:
        """→ (F, K) valid frames on the device (no EOS frame)."""
        max_gen = int(max_audio_length_ms / FRAME_MS)
        seed = self._utterance_seed(seed)
        frame, state, done, finished, max_gen = self._prefill_utterance(
            text, speaker, context, cached_context, max_gen, temperature, topk, seed
        )
        if finished:
            return frame[:0]
        out = [frame]
        decoded = 1
        while decoded < max_gen:
            n = min(self._decode_chunk_frames, max_gen - decoded)
            frames, n_valid, done, state = self._decode_chunk(
                state, frame, done, seed, n, decoded, temperature, topk
            )
            decoded += n
            frame = frames[-1]
            out.append(frames[:n_valid, 0])
            if n_valid < n:
                break
        return torch.cat(out)

    def generate_frames(self, text, speaker, context, max_audio_length_ms=90_000,
                        temperature: float = 0.7, topk: int = 30, cached_context=None,
                        seed: Optional[int] = None) -> np.ndarray:
        """→ (F, K) int32 valid frames (no EOS frame)."""
        codes = self._generate_codes(text, speaker, context, max_audio_length_ms,
                                     temperature, topk, cached_context, seed)
        return codes.cpu().numpy().astype(np.int32)

    def generate(self, text: str, speaker: int, context: Sequence,
                 max_audio_length_ms: float = 90_000, temperature: float = 0.7,
                 topk: int = 30, stream: bool = False, cached_context=None,
                 seed: Optional[int] = None) -> np.ndarray:
        """Full-utterance generation → (F*hop,) float32 PCM.  ``stream=True``
        concatenates the streamed chunks; otherwise the frames are decoded
        in one offline Mimi pass (exact: the codec is causal)."""
        if stream:
            chunks = list(self.generate_stream(
                text, speaker, context, max_audio_length_ms, temperature, topk,
                cached_context=cached_context, seed=seed,
            ))
            return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
        codes = self._generate_codes(text, speaker, context, max_audio_length_ms,
                                     temperature, topk, cached_context, seed)
        if codes.shape[0] == 0:
            return np.zeros((0,), np.float32)
        return self._decode_codes(codes)

    def generate_stream(
        self,
        text: str,
        speaker: int,
        context: Sequence,
        max_audio_length_ms: float = 90_000,
        temperature: float = 0.7,
        topk: int = 30,
        on_chunk_generated: Optional[Callable[[np.ndarray], None]] = None,
        chunk_frames: Optional[int] = None,
        cached_context=None,
        decode_chunk_frames: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Iterator[np.ndarray]:
        """Yield PCM chunks as frames are generated: the prefill frame
        alone, then groups of ``chunk_frames`` frames.  Each decode chunk
        runs through the streaming Mimi decode with carried state."""
        max_gen = int(max_audio_length_ms / FRAME_MS)
        chunk_frames = chunk_frames or self._stream_chunk_frames
        decode_chunk = decode_chunk_frames or self._decode_chunk_frames
        ring_cap = self._mimi.max_stream_chunk_frames
        if decode_chunk > ring_cap:
            # the codec ring's slack caps the frames per chunk; the sampled
            # audio does not depend on the chunk size
            log.warning("decode_chunk_frames=%d exceeds the codec streaming ring "
                        "(%d frames/chunk); clamping", decode_chunk, ring_cap)
            decode_chunk = ring_cap
        seed = self._utterance_seed(seed)
        frame, state, done, finished, max_gen = self._prefill_utterance(
            text, speaker, context, cached_context, max_gen, temperature, topk, seed
        )
        if finished:
            return
        hop = self._hop

        def emit(chunk):
            if on_chunk_generated:
                on_chunk_generated(chunk)
            return chunk

        mimi_state = self._mimi.init_decode_state(1, self._mimi_dtype, self.device)
        wav_np, mimi_state = self._stream_pcm(frame[:, :, None], mimi_state)
        yield emit(wav_np)
        decoded = 1
        while decoded < max_gen:
            n = min(decode_chunk, max_gen - decoded)
            frames, n_valid, done, state = self._decode_chunk(
                state, frame, done, seed, n, decoded, temperature, topk
            )
            decoded += n
            frame = frames[-1]
            # post-EOS frames are zeros: the codec state consumes them, and
            # only the valid prefix of the PCM is emitted
            wav_np, mimi_state = self._stream_pcm(frames.permute(1, 2, 0), mimi_state)
            for start in range(0, n_valid, chunk_frames):
                g = min(chunk_frames, n_valid - start)
                yield emit(wav_np[start * hop:(start + g) * hop])
            if n_valid < n:
                break

    def _stream_pcm(self, codes: torch.Tensor, mimi_state):
        """(1, K, F) device codes → ((F*hop,) float32 PCM, new codec state)
        through the streaming decode.  Records the wall time, the copy to the
        host (a sync) included, as ``codec_s``."""
        t0 = time.perf_counter()
        wav, mimi_state = self._mimi.decode_streaming(self._mimi_params, codes, mimi_state)
        pcm = wav[0, 0].float().cpu().numpy()
        self.metrics.record("codec_s", time.perf_counter() - t0)
        return pcm, mimi_state

    def _decode_codes(self, codes: torch.Tensor) -> np.ndarray:
        """(F, K) device codes → (F*hop,) float32 PCM, one offline pass;
        recorded as ``codec_s``."""
        t0 = time.perf_counter()
        wav = self._mimi.decode(self._mimi_params, codes.T[None])
        pcm = wav[0, 0].float().cpu().numpy()
        self.metrics.record("codec_s", time.perf_counter() - t0)
        return pcm

    def decode_audio(self, frames: np.ndarray) -> np.ndarray:
        """(F, K) frames → (F*hop,) float32 PCM via one offline Mimi pass."""
        return self._decode_codes(torch.from_numpy(np.asarray(frames, np.int64)).to(self.device))
