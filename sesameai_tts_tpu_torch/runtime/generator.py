"""Generation orchestration: the ``Generator`` (port of
``sesameai_tts_tpu/runtime/generator.py``).

Text (and optional voice-context segments) → bucketed prefill through the
dense shadow of the quantized trunks → chunks of decoded frames with one
host EOS check per chunk → Mimi decode to 24 kHz PCM, offline or streamed
with carried codec state.

The decode runs on one static state per batch size (the backbone KV
cache, its position and ``csm.DecodeBuffers``), the counterpart of the
JAX package's donated state.  On a CUDA device each part of a frame is a
captured CUDA graph, replayed once per frame (the counterpart of the JAX
package's jitted ``decode`` programs): the backbone step, the sampling of
a decoded frame (decoder weights of the decode), and the sampling of the
prefill's frame (the prefill's weights, as the JAX prefill program).  One
graph per frame serves every chunk size.  Graphs are captured at a
request's start or in ``warmup``; a capture that fails raises.  On the
CPU the same step functions run eagerly.  The static state serves one
request at a time: a second one waits, and ``clone`` gives a Generator of
its own over the same weights.  Batched serving (``runtime/serving.py``)
runs its admissions on one clone (``_prefill_admission`` into a B=1 state
the server owns, ``_first_chunk``) and its pool on another
(``_serve_tick`` on the static state at B = slots), each on the clone's
own stream (``own_stream``).

``seed`` makes an utterance reproducible and independent of the chunk
schedule: frame i (the prefill frame is 0) draws its noise from the
Generator's one ``torch.Generator`` reseeded with ``frame_seed(seed, i)``
(a graph replays from the seed set before it), so ``generate`` and
``generate_stream`` give the same frames for one seed, and the same as
``csm.decode_frames``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi
from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.models.transformer import precompute_rope
from sesameai_tts_tpu_torch.ops.quant import dequantize_csm, is_quantized, is_quantized4
from sesameai_tts_tpu_torch.runtime import graphs
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


class _DecodeSlot(NamedTuple):
    """One batch size's static decode state."""

    state: csm_model.CSMState
    bufs: csm_model.DecodeBuffers


# the parts of a frame, each one graph on the card (see the module docstring)
_PARTS = ("backbone", "sample", "prefill_sample")


class Generator:
    """Owns the CSM params, Mimi and the tokenizer; exposes generate,
    generate_stream and generate_frames, plus warmup and clone."""

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
        self._rope = precompute_rope(csm_cfg.backbone, device=self.device)
        self._max_seq_len = csm_cfg.backbone.max_seq_len
        self._prefill_buckets = [64, 128, 256, 384, 512, 768, 1024, 1536, 2048]
        self._init_own(stream_chunk_frames, decode_chunk_frames, seed, text_tokenizer)

    def _init_own(self, stream_chunk_frames, decode_chunk_frames, seed, text_tokenizer):
        """What each Generator (and each clone) has of its own: knobs, seed,
        Metrics, the static decode states and their graphs."""
        self._stream_chunk_frames = stream_chunk_frames
        self._decode_chunk_frames = decode_chunk_frames
        self._seed_rng = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self.metrics = Metrics()
        self._tokenizer = FrameTokenizer(
            text_tokenizer, self._encode_audio, self._cfg.audio_num_codebooks
        )
        self._request_lock = threading.Lock()
        self._request_owner = None
        self._rng = torch.Generator(device=self.device)  # frame noise, reseeded per frame
        self._slots: Dict[int, _DecodeSlot] = {}
        self._graphs: Dict[tuple, graphs.CapturedGraph] = {}
        self._graph_stream = None
        self._graph_pool = None

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
        if self.device.type == "cuda":
            # the handle may be read on another stream (a serving admission)
            torch.cuda.current_stream(self.device).synchronize()
        return state, S

    # -- the static decode state and its graphs ----------------------------------

    def _slot(self, batch_size: int) -> _DecodeSlot:
        slot = self._slots.get(batch_size)
        if slot is None:
            slot = _DecodeSlot(self._init_state(batch_size),
                               csm_model.init_decode_buffers(self._params, self._cfg,
                                                             batch_size, self.device))
            self._slots[batch_size] = slot
        return slot

    def own_stream(self) -> Optional["torch.cuda.Stream"]:
        """The CUDA stream this Generator captures its graphs on (made at
        first use); None on the CPU.  A caller that runs this Generator on
        one thread beside another's work (``runtime/serving.py``) puts its
        calls there."""
        if self.device.type == "cpu":
            return None
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_stream

    def _step(self, batch_size: int, part: str, greedy: bool) -> Callable[[], None]:
        """The eager call of one part of a frame on the static state."""
        state, bufs = self._slot(batch_size)
        if part == "backbone":
            return lambda: csm_model.backbone_step(self._params, self._cfg, state, bufs,
                                                   self._rope, self._fused_mlp)
        if part == "sample":
            return lambda: csm_model.sample_step(self._params, self._cfg, bufs, self._rng,
                                                 greedy, self._fused_mlp)
        # the prefill's frame samples through the prefill weights, as the
        # JAX package's prefill program does
        return lambda: csm_model.sample_step(self._prefill_params, self._cfg, bufs, self._rng,
                                             greedy)

    @staticmethod
    def _key(batch_size: int, part: str, greedy: bool) -> tuple:
        return batch_size, part, greedy and part != "backbone"  # the backbone draws no noise

    def _run(self, batch_size: int, part: str, greedy: bool) -> None:
        """One part of a frame: its graph's replay on the card, the eager
        call on the CPU."""
        if self.device.type == "cpu":
            self._step(batch_size, part, greedy)()
        else:
            self._graphs[self._key(batch_size, part, greedy)].replay()

    def _capture(self, batch_size: int, greedy: bool, parts: Sequence[str] = _PARTS) -> dict:
        """Capture the graphs of ``parts`` at (batch size, greedy) that do
        not exist yet → {name: seconds}.  The capture's warm-up call writes
        the static state, so only a caller that holds it and loads it
        afterwards may capture.  On the CPU it makes the state only."""
        self._slot(batch_size)
        stream = self.own_stream()
        if stream is None:
            return {}
        times = {}
        for part in parts:
            key = self._key(batch_size, part, greedy)
            if key in self._graphs:
                continue
            self._slots[batch_size].state.pos.zero_()  # the warm-up step writes at pos
            sampled = part != "backbone" and not greedy
            captured = graphs.capture(self._step(batch_size, part, greedy), stream,
                                      self._graph_pool, self._rng if sampled else None)
            self._graphs[key] = captured
            kind = "" if part == "backbone" else "_greedy" if greedy else "_sampled"
            times[f"graph_b{batch_size}_{part}{kind}"] = captured.seconds
        return times

    @contextlib.contextmanager
    def _request(self):
        """Hold the static decode state for one request.  A request from
        another thread waits; one from the thread that holds it (an
        unfinished ``generate_stream``) raises: ``clone()`` serves requests
        at once."""
        me = threading.get_ident()
        if self._request_owner == me:
            raise RuntimeError("this Generator is already serving a request in this thread (an "
                               "unfinished generate_stream?); use clone() for another at once")
        with self._request_lock:
            self._request_owner = me
            try:
                yield
            finally:
                self._request_owner = None

    # -- generation -------------------------------------------------------------

    def _prefill_into(self, state, text, speaker, context, cached, max_gen, temperature,
                      topk, seed):
        """Prompt prep + prefill into the B=1 ``state`` (loaded here with the
        cached context, or zeros), then the prefill's frame sampled on the
        static B=1 buffers → (frame (1, K), done (1,) bool, max_gen), on the
        device: no host sync.  The caller holds ``_request``; the (1, greedy)
        graphs must exist on the card."""
        if cached is not None:
            cached_state, ctx_len = cached
            tokens, mask = self._tokenizer.text_segment(text, speaker)
            total = ctx_len + tokens.shape[0]
        else:
            tokens, mask = self._tokenize_prompt(text, speaker, context)
            cached_state = None
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
        _, bufs = self._slot(1)
        csm_model.load_state(state, cached_state)  # the cached context stays unchanged
        tok, msk, valid = self._padded(tokens, mask, bucket)
        last_h, prefilled = csm_model.backbone_last_hidden(
            self._prefill_params, self._cfg, state, tok, msk, valid, rope_cs=self._rope)
        bufs.last_h.copy_(last_h)
        state.pos.copy_(prefilled.pos)
        bufs.done.zero_()
        csm_model.set_sampling(bufs, temperature, topk)
        self._rng.manual_seed(csm_model.frame_seed(seed, 0))
        self._run(1, "prefill_sample", csm_model.is_greedy(topk))
        return bufs.frame.clone(), bufs.done.clone(), max_gen

    def _prefill_utterance(self, text, speaker, context, cached, max_gen,
                           temperature, topk, seed):
        """``_prefill_into`` the static B=1 state → (frame (1, K), whether it
        is EOS (a host bool: the prefill's one sync), max_gen).  The caller
        holds ``_request``."""
        self._capture(1, csm_model.is_greedy(topk))
        state, _ = self._slot(1)
        t0 = time.perf_counter()
        frame, done, max_gen = self._prefill_into(state, text, speaker, context, cached, max_gen,
                                                  temperature, topk, seed)
        finished = bool(done[0])
        self.metrics.record("prefill_s", time.perf_counter() - t0)
        return frame, finished, max_gen

    def _replay_frames(self, batch_size, seed, n, start, greedy):
        """``n`` frames from absolute index ``start`` on the static state at
        ``batch_size`` → (frames (n, B, K), valid (n, B)), new device tensors
        copied out of the static buffers, which the next frame overwrites."""
        _, bufs = self._slot(batch_size)
        frames = torch.empty((n,) + tuple(bufs.frame.shape), dtype=bufs.frame.dtype,
                             device=self.device)
        valid = torch.empty((n,) + tuple(bufs.valid.shape), dtype=torch.bool, device=self.device)
        for i in range(n):
            self._rng.manual_seed(csm_model.frame_seed(seed, start + i))
            self._run(batch_size, "backbone", greedy)
            self._run(batch_size, "sample", greedy)
            frames[i].copy_(bufs.frame)
            valid[i].copy_(bufs.valid)
        return frames, valid

    def _decode_chunk(self, seed, n, start, greedy):
        """``n`` frames from absolute index ``start`` on the static B=1
        state → (frames (n, 1, K), number of valid frames (a host int: the
        chunk's one sync)).  Records the chunk's wall time, sync included."""
        t0 = time.perf_counter()
        frames, valid = self._replay_frames(1, seed, n, start, greedy)
        n_valid = int(valid[:, 0].sum())  # host EOS check; valid frames are a prefix
        self.metrics.record("decode_s", time.perf_counter() - t0)
        self.metrics.record("decoded_frames", n)
        return frames, n_valid

    # -- the hooks of batched serving (runtime/serving.py) ------------------------

    def _prefill_admission(self, text, speaker, context, cached, max_gen, temperature, topk,
                           seed):
        """A serving admission's prefill: ``_prefill_into`` a new B=1
        ``CSMState`` that the caller owns (the serving pool copies it into a
        slot) → (frame (1, K), state, done (1,) bool, max_gen), all on the
        device, no host sync; ``prefill_s`` records the host's part.  Holds
        the static B=1 buffers while it runs; the (1, greedy) graphs of the
        prefill's frame must exist on the card."""
        t0 = time.perf_counter()
        with self._request():
            state = self._init_state(1)
            frame, done, max_gen = self._prefill_into(state, text, speaker, context, cached,
                                                      max_gen, temperature, topk, seed)
        self.metrics.record("prefill_s", time.perf_counter() - t0)
        return frame, state, done, max_gen

    def _first_chunk(self, frame: torch.Tensor):
        """The prefill's frame (1, K) through the streaming Mimi decode from a
        fresh codec state → ((1, hop) f32 PCM on the device, the codec state
        after it)."""
        mimi_state = self._mimi.init_decode_state(1, self._mimi_dtype, self.device)
        wav, mimi_state = self._mimi.decode_streaming(self._mimi_params, frame[:, :, None],
                                                      mimi_state)
        return wav[:, 0].float(), mimi_state

    def _serve_tick(self, batch_size: int, n: int, seed: int, greedy: bool, mimi_state):
        """One serving tick: ``n`` frames on the static state at
        ``batch_size`` (the serving pool; on the card ``n`` replays each of
        the ``backbone`` and ``sample`` graphs, frame i seeded
        ``frame_seed(seed, i)``), then the batched streaming Mimi decode of
        its (B, K, n) codes → (frames (n, B, K), valid (n, B), done (B,),
        PCM (B, n*hop) f32, the codec state after it), new device tensors:
        nothing the next tick overwrites.  No host sync."""
        _, bufs = self._slot(batch_size)
        frames, valid = self._replay_frames(batch_size, seed, n, 0, greedy)
        done = bufs.done.clone()
        wav, mimi_state = self._mimi.decode_streaming(self._mimi_params, frames.permute(1, 2, 0),
                                                      mimi_state)
        return frames, valid, done, wav[:, 0].float(), mimi_state

    def _generate_codes(self, text, speaker, context, max_audio_length_ms, temperature,
                        topk, cached_context, seed) -> torch.Tensor:
        """→ (F, K) valid frames on the device (no EOS frame)."""
        max_gen = int(max_audio_length_ms / FRAME_MS)
        seed = self._utterance_seed(seed)
        greedy = csm_model.is_greedy(topk)
        with self._request():
            frame, finished, max_gen = self._prefill_utterance(
                text, speaker, context, cached_context, max_gen, temperature, topk, seed
            )
            if finished:
                return frame[:0]
            out = [frame]
            decoded = 1
            while decoded < max_gen:
                n = min(self._decode_chunk_frames, max_gen - decoded)
                frames, n_valid = self._decode_chunk(seed, n, decoded, greedy)
                decoded += n
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
        runs through the streaming Mimi decode with carried state.  The
        Generator serves no other request until the stream ends or is
        closed."""
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
        greedy = csm_model.is_greedy(topk)
        hop = self._hop

        def emit(chunk):
            if on_chunk_generated:
                on_chunk_generated(chunk)
            return chunk

        with self._request():
            frame, finished, max_gen = self._prefill_utterance(
                text, speaker, context, cached_context, max_gen, temperature, topk, seed
            )
            if finished:
                return
            mimi_state = self._mimi.init_decode_state(1, self._mimi_dtype, self.device)
            wav_np, mimi_state = self._stream_pcm(frame[:, :, None], mimi_state)
            yield emit(wav_np)
            decoded = 1
            while decoded < max_gen:
                n = min(decode_chunk, max_gen - decoded)
                frames, n_valid = self._decode_chunk(seed, n, decoded, greedy)
                decoded += n
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

    # -- warmup and clone ---------------------------------------------------------

    def warmup(
        self,
        serving_batch: Optional[int] = None,
        tick_sizes: Sequence[int] = (),
        stream: bool = True,
        offline: bool = False,
        offline_budget_frames: int = 1125,
        encode_buckets: Sequence[int] = (),
    ) -> dict:
        """Do before traffic arrives what a first request would otherwise
        pay for → {name: seconds}:

        * capture the decode graphs at B=1, sampled and greedy (the
          backbone step, a decoded frame's sampling, the prefill frame's
          sampling), and at B=``serving_batch`` when given (the backbone
          step and a decoded frame's sampling; serving prefills eagerly);
        * run the prefill at every prompt bucket that fits the KV cache
          once (allocator and cuBLAS warm; cached-context prefills share
          the buckets), with its frame's sampling;
        * with ``stream``: the streaming Mimi decode of one frame
          (``first_chunk``);
        * the Mimi encode at each of ``encode_buckets`` (power-of-2 frame
          buckets, ``frames.pad_audio_to_frame_bucket``).

        The JAX package compiles one program per chunk size (``tick_sizes``,
        ``offline``'s ramp up to ``offline_budget_frames``); here one graph
        per frame part serves every chunk size, so those arguments add
        nothing.  Holds the static state, as a request does.
        """
        del tick_sizes, offline, offline_budget_frames  # see the docstring
        K = self._cfg.audio_num_codebooks
        times: dict = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[name] = time.perf_counter() - t0

        with self._request():
            for greedy in (False, True):
                times.update(self._capture(1, greedy))
                if serving_batch:
                    times.update(self._capture(serving_batch, greedy, ("backbone", "sample")))
            times.update(self._warm_prefill_buckets())
        if stream:
            timed("first_chunk", lambda: self._mimi.decode_streaming(
                self._mimi_params, torch.zeros((1, K, 1), dtype=torch.int64, device=self.device),
                self._mimi.init_decode_state(1, self._mimi_dtype, self.device)))
        for b in sorted(set(encode_buckets)):
            wav = torch.zeros((1, 1, b * self._hop), dtype=torch.float32, device=self.device)
            timed(f"mimi_encode_{b}", lambda: self._mimi.encode(self._mimi_params, wav))
        log.info("warmup: %d steps in %.1fs", len(times), sum(times.values()))
        return times

    def _warm_prefill_buckets(self) -> dict:
        """Run the prefill at every prompt bucket that fits the KV cache once,
        with its frame's greedy sampling, on the static B=1 state (zeroed
        after) → {"prefill_<bucket>": seconds}.  The caller holds
        ``_request``; the (1, greedy) prefill graph must exist on the card."""
        K = self._cfg.audio_num_codebooks
        state, bufs = self._slot(1)
        times = {}
        for b in self._prefill_buckets:
            if b > self._max_seq_len:
                break
            S = min(8, b)
            tokens = np.zeros((S, K + 1), np.int64)
            mask = np.zeros((S, K + 1), bool)
            mask[:, K] = True
            tok, msk, valid = self._padded(tokens, mask, b)
            t0 = time.perf_counter()
            csm_model.load_state(state)
            last_h, _ = csm_model.backbone_last_hidden(self._prefill_params, self._cfg, state,
                                                       tok, msk, valid, rope_cs=self._rope)
            bufs.last_h.copy_(last_h)
            self._run(1, "prefill_sample", True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            times[f"prefill_{b}"] = time.perf_counter() - t0
        csm_model.load_state(state)
        return times

    def clone(
        self,
        stream_chunk_frames: Optional[int] = None,
        decode_chunk_frames: Optional[int] = None,
        offline_chunk_frames: Optional[int] = None,
        seed: int = 0,
    ) -> "Generator":
        """A second Generator over the same device-resident weights.

        Shares ``_params``, the dense prefill shadow, Mimi and its params
        and the text tokenizer (no new weight memory); gets its own knobs,
        seed, ``Metrics``, static decode state and graphs (captured at its
        first request or ``warmup``).  A Generator serves one request at a
        time, so a clone is how two requests decode at once.
        ``offline_chunk_frames`` is the JAX package's offline chunk
        schedule, which the port does not have."""
        del offline_chunk_frames  # see the docstring
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)  # the shared, read-only fields
        new._init_own(
            self._stream_chunk_frames if stream_chunk_frames is None else stream_chunk_frames,
            self._decode_chunk_frames if decode_chunk_frames is None else decode_chunk_frames,
            seed, self._tokenizer.text_tokenizer)
        return new
