"""Mimi neural audio codec (port of ``sesameai_tts_tpu/codec/mimi.py``).

  24 kHz mono ⇄ 12.5 Hz frames of K RVQ codes (hop 1920 samples)

SEANet encoder (24 kHz → 25 Hz, dim 512) → 8-layer latent transformer →
×2 causal downsample (replicate-padded) → split RVQ; decode mirrors it
with a ×2 channel-wise (``groups=dim``) transposed upsample.  Streaming
decode threads a ``Mimi.DecodeState`` of conv overlap buffers and a ring
KV cache, streaming encode a ``Mimi.EncodeState`` of the same parts; the
ring caches are written in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from sesameai_tts_tpu_torch.codec.conv import CausalConv1d, CausalConvTranspose1d
from sesameai_tts_tpu_torch.codec.rvq import (
    RVQConfig,
    init_split_rvq,
    split_rvq_decode,
    split_rvq_encode,
)
from sesameai_tts_tpu_torch.codec.seanet import SEANetConfig, SEANetDecoder, SEANetEncoder
from sesameai_tts_tpu_torch.codec.transformer import (
    CodecKVCache,
    CodecTransformerConfig,
    codec_transformer_forward,
    init_codec_cache,
    init_codec_transformer,
    precompute_codec_rope,
)


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24_000
    frame_rate: float = 12.5
    num_codebooks: int = 32
    seanet: SEANetConfig = SEANetConfig()
    transformer: CodecTransformerConfig = CodecTransformerConfig()
    rvq: RVQConfig = RVQConfig()
    downsample_stride: int = 2  # 25 Hz encoder latent → 12.5 Hz quantizer rate

    @property
    def hop_length(self) -> int:
        """Samples per codec frame at the quantizer rate (1920 @ 24 kHz)."""
        return self.seanet.hop_length * self.downsample_stride

    @property
    def max_latent_positions(self) -> int:
        return 8192


def mimi_test_tiny() -> MimiConfig:
    """CPU-testable flavor: same topology, tiny widths."""
    return MimiConfig(
        num_codebooks=8,
        seanet=SEANetConfig(dimension=32, n_filters=4, ratios=(4, 3, 2)),
        transformer=CodecTransformerConfig(
            num_layers=2, d_model=32, num_heads=4, dim_feedforward=64, context=16
        ),
        rvq=RVQConfig(dimension=16, input_dim=32, output_dim=32, bins=32, n_q_acoustic=7),
    )


class Mimi:
    # transformer-ring headroom for one streamed chunk, in positions at the
    # post-upsample rate (init_codec_cache max_chunk)
    MAX_RING_CHUNK = 128

    def __init__(self, cfg: MimiConfig):
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg.seanet)
        self.decoder = SEANetDecoder(cfg.seanet)
        d = cfg.seanet.dimension
        s = cfg.downsample_stride
        # replicate-padded like the real model (transformers MimiConv1d
        # pad_mode='replicate')
        self.downsample = CausalConv1d(d, d, 2 * s, stride=s, bias=False, pad_mode="replicate")
        # channel-wise (groups=dimension), as every published checkpoint
        self.upsample = CausalConvTranspose1d(d, d, 2 * s, stride=s, groups=d, bias=False)
        self._rope_cs = precompute_codec_rope(cfg.transformer, cfg.max_latent_positions)

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        """Random params (JAX package structure) on the generator's device."""
        return {
            "encoder": self.encoder.init(generator, dtype),
            "decoder": self.decoder.init(generator, dtype),
            "encoder_transformer": init_codec_transformer(generator, self.cfg.transformer, dtype),
            "decoder_transformer": init_codec_transformer(generator, self.cfg.transformer, dtype),
            "downsample": self.downsample.init(generator, dtype),
            "upsample": self.upsample.init(generator, dtype),
            "quantizer": init_split_rvq(generator, self.cfg.rvq, dtype),
        }

    def _rope(self, device) -> torch.Tensor:
        if self._rope_cs.device != torch.device(device):
            self._rope_cs = self._rope_cs.to(device)
        return self._rope_cs

    def _check_latent_len(self, t25: int) -> None:
        """RoPE positions past ``max_latent_positions`` have no table row."""
        if t25 > self.cfg.max_latent_positions:
            raise ValueError(
                f"{t25} latent positions exceed max_latent_positions="
                f"{self.cfg.max_latent_positions} (~{self.cfg.max_latent_positions // 25} s "
                f"of audio); split the clip into chunks"
            )

    # -- offline -----------------------------------------------------------

    def encode(self, params: dict, wav: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) float in [-1, 1] → (B, K, F) int64 codes; T a multiple
        of hop_length."""
        self._check_latent_len(wav.shape[-1] // self.cfg.seanet.hop_length)
        latent = self.encoder.apply(params["encoder"], wav)  # (B, D, T25)
        B = latent.shape[0]
        pos0 = torch.zeros(B, dtype=torch.int64, device=wav.device)
        h, _ = codec_transformer_forward(params["encoder_transformer"], self.cfg.transformer,
                                         latent.transpose(1, 2), pos0, self._rope(wav.device))
        latent = self.downsample.apply(params["downsample"], h.transpose(1, 2))
        return split_rvq_encode(params["quantizer"], self.cfg.rvq, latent, self.cfg.num_codebooks)

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, F) codes → (B, 1, F*hop) wav in the decoder's dtype."""
        self._check_latent_len(codes.shape[-1] * self.cfg.downsample_stride)
        latent = split_rvq_decode(params["quantizer"], self.cfg.rvq, codes)
        latent = latent.to(params["upsample"]["w"].dtype)
        latent = self.upsample.apply(params["upsample"], latent)  # (B, D, T25)
        B = latent.shape[0]
        pos0 = torch.zeros(B, dtype=torch.int64, device=codes.device)
        h, _ = codec_transformer_forward(params["decoder_transformer"], self.cfg.transformer,
                                         latent.transpose(1, 2), pos0, self._rope(codes.device))
        return self.decoder.apply(params["decoder"], h.transpose(1, 2))

    # -- streaming decode --------------------------------------------------

    class DecodeState(NamedTuple):
        upsample: tuple
        tf_cache: CodecKVCache  # written in place by decode_streaming
        tf_pos: torch.Tensor  # (B,)
        seanet: list

    @property
    def max_stream_chunk_frames(self) -> int:
        """Largest per-chunk frame count ``decode_streaming`` supports: the
        decoder transformer runs at ``upsample.stride``× the code rate and
        its ring has ``MAX_RING_CHUNK`` positions of slack."""
        return self.MAX_RING_CHUNK // self.upsample.stride

    def init_decode_state(self, batch: int, dtype=torch.float32, device="cpu") -> "Mimi.DecodeState":
        return Mimi.DecodeState(
            upsample=self.upsample.init_state(batch, dtype, device),
            tf_cache=init_codec_cache(self.cfg.transformer, batch, dtype,
                                      max_chunk=self.MAX_RING_CHUNK, device=device),
            tf_pos=torch.zeros(batch, dtype=torch.int64, device=device),
            seanet=self.decoder.init_state(batch, dtype, device),
        )

    def decode_streaming(self, params: dict, codes: torch.Tensor,
                         state: "Mimi.DecodeState") -> Tuple[torch.Tensor, "Mimi.DecodeState"]:
        """Chunked decode with carried state: chaining chunks equals the
        offline decode of their concatenation."""
        latent = split_rvq_decode(params["quantizer"], self.cfg.rvq, codes)
        latent = latent.to(params["upsample"]["w"].dtype)
        latent, up_st = self.upsample.apply_streaming(params["upsample"], latent, state.upsample)
        h, tf_cache = codec_transformer_forward(
            params["decoder_transformer"], self.cfg.transformer, latent.transpose(1, 2),
            state.tf_pos, self._rope(codes.device), cache=state.tf_cache,
        )
        wav, seanet_st = self.decoder.apply_streaming(params["decoder"], h.transpose(1, 2),
                                                      state.seanet)
        return wav, Mimi.DecodeState(
            upsample=up_st,
            tf_cache=tf_cache,
            tf_pos=state.tf_pos + latent.shape[-1],
            seanet=seanet_st,
        )

    # -- streaming encode --------------------------------------------------

    class EncodeState(NamedTuple):
        seanet: list
        tf_cache: CodecKVCache  # written in place by encode_streaming
        tf_pos: torch.Tensor  # (B,)
        downsample: tuple

    def init_encode_state(self, batch: int, dtype=torch.float32, device="cpu") -> "Mimi.EncodeState":
        return Mimi.EncodeState(
            seanet=self.encoder.init_state(batch, dtype, device),
            tf_cache=init_codec_cache(self.cfg.transformer, batch, dtype, device=device),
            tf_pos=torch.zeros(batch, dtype=torch.int64, device=device),
            downsample=self.downsample.init_state(batch, dtype, device),
        )

    def encode_streaming(self, params: dict, wav: torch.Tensor,
                         state: "Mimi.EncodeState") -> Tuple[torch.Tensor, "Mimi.EncodeState"]:
        """Chunked encode with carried state: (B, 1, T) chunks whose codes,
        chained, equal the offline encode of their concatenation."""
        latent, seanet_st = self.encoder.apply_streaming(params["encoder"], wav, state.seanet)
        h, tf_cache = codec_transformer_forward(
            params["encoder_transformer"], self.cfg.transformer, latent.transpose(1, 2),
            state.tf_pos, self._rope(wav.device), cache=state.tf_cache,
        )
        latent2, down_st = self.downsample.apply_streaming(params["downsample"],
                                                           h.transpose(1, 2), state.downsample)
        codes = split_rvq_encode(params["quantizer"], self.cfg.rvq, latent2,
                                 self.cfg.num_codebooks)
        return codes, Mimi.EncodeState(
            seanet=seanet_st,
            tf_cache=tf_cache,
            tf_pos=state.tf_pos + latent.shape[-1],
            downsample=down_st,
        )
