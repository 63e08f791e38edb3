"""Residual vector quantization, Mimi's split RVQ: 1 semantic + N acoustic
codebooks over the same latent (port of ``sesameai_tts_tpu/codec/rvq.py``).

Nearest neighbour per stage is ``argmax(x·Eᵀ − ‖E‖²/2)``; decode is an
embedding gather and sum, then the output projection.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RVQConfig:
    dimension: int = 256  # codebook dim
    input_dim: int = 512
    output_dim: int = 512
    bins: int = 2048
    n_q_semantic: int = 1
    n_q_acoustic: int = 31

    @property
    def total_codebooks(self) -> int:
        return self.n_q_semantic + self.n_q_acoustic


def _init_rvq(generator: torch.Generator, cfg: RVQConfig, n_q: int, dtype) -> dict:
    dev = generator.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {
        "input_proj": (randn((cfg.input_dim, cfg.dimension)) * cfg.input_dim ** -0.5).to(dtype),
        "output_proj": (randn((cfg.dimension, cfg.output_dim)) * cfg.dimension ** -0.5).to(dtype),
        "codebooks": randn((n_q, cfg.bins, cfg.dimension)).to(dtype),
    }


def init_split_rvq(generator: torch.Generator, cfg: RVQConfig, dtype=torch.float32) -> dict:
    return {
        "semantic": _init_rvq(generator, cfg, cfg.n_q_semantic, dtype),
        "acoustic": _init_rvq(generator, cfg, cfg.n_q_acoustic, dtype),
    }


def _rvq_encode(params: dict, x: torch.Tensor, n_q: int) -> torch.Tensor:
    """x (B, F, input_dim) → codes (B, n_q, F)."""
    residual = x.float() @ params["input_proj"].float()  # (B, F, d)
    codes = []
    for codebook in params["codebooks"][:n_q].float():
        scores = torch.einsum("bfd,nd->bfn", residual, codebook) - 0.5 * (
            codebook * codebook
        ).sum(dim=-1)
        idx = scores.argmax(dim=-1)  # (B, F)
        residual = residual - codebook[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def _rvq_decode(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q, F) → (B, F, output_dim) f32.  A code past the last
    bin reads the last bin, as the JAX package's clamping gather does (the
    CSM audio vocab, 2051, exceeds Mimi's 2048 bins)."""
    cb = params["codebooks"]
    codes = codes.clamp(0, cb.shape[1] - 1)
    summed = sum(cb[n][codes[:, n]].float() for n in range(codes.shape[1]))
    return summed @ params["output_proj"].float()


def split_rvq_encode(params: dict, cfg: RVQConfig, latent: torch.Tensor,
                     num_codebooks: int) -> torch.Tensor:
    """latent (B, input_dim, F) → codes (B, K, F); code 0 is semantic."""
    if not cfg.n_q_semantic <= num_codebooks <= cfg.total_codebooks:
        raise ValueError(
            f"num_codebooks={num_codebooks} outside [{cfg.n_q_semantic}, {cfg.total_codebooks}] "
            f"for this RVQ config"
        )
    x = latent.transpose(1, 2)
    sem = _rvq_encode(params["semantic"], x, cfg.n_q_semantic)
    ac = _rvq_encode(params["acoustic"], x, num_codebooks - cfg.n_q_semantic)
    return torch.cat([sem, ac], dim=1)


def split_rvq_decode(params: dict, cfg: RVQConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, K, F) → latent (B, output_dim, F) f32."""
    sem = _rvq_decode(params["semantic"], codes[:, : cfg.n_q_semantic])
    ac = _rvq_decode(params["acoustic"], codes[:, cfg.n_q_semantic:])
    return (sem + ac).transpose(1, 2)
