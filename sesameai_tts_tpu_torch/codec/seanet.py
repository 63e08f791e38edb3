"""SEANet convolutional encoder/decoder, Mimi's acoustic front and back end
(port of ``sesameai_tts_tpu/codec/seanet.py``).

Causal ELU conv stacks with residual units, strided ratios [8, 6, 5, 4]
(24 kHz ↔ 25 Hz latent), channel doubling per stage and a mirrored
transposed-conv decoder.  Offline and streaming application both walk one
flat spec list; streaming threads per-conv overlap buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from sesameai_tts_tpu_torch.codec.conv import CausalConv1d, CausalConvTranspose1d


@dataclass(frozen=True)
class SEANetConfig:
    """Mimi's published SEANet hyperparameters."""

    channels: int = 1
    dimension: int = 512
    n_filters: int = 64
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 6, 5, 4)  # decoder order; encoder uses reversed
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


def _elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x.float()).to(x.dtype)


def _res_block_specs(cfg: SEANetConfig, dim: int, dilation: int):
    hidden = dim // cfg.compress
    return [
        CausalConv1d(dim, hidden, cfg.residual_kernel_size, dilation=dilation),
        CausalConv1d(hidden, dim, 1),
    ]


class SEANetEncoder:
    """conv stem → per-stage [res-units, ELU, strided conv ×2ch] → ELU → final conv."""

    def __init__(self, cfg: SEANetConfig):
        self.cfg = cfg
        self.specs: List = []  # ("conv", spec) | ("convtr", spec) | ("elu",) | ("res", [specs])
        mult = 1
        self.specs.append(("conv", CausalConv1d(cfg.channels, mult * cfg.n_filters, cfg.kernel_size)))
        for ratio in reversed(cfg.ratios):
            for j in range(cfg.n_residual_layers):
                self.specs.append(
                    ("res", _res_block_specs(cfg, mult * cfg.n_filters, cfg.dilation_base ** j))
                )
            self.specs.append(("elu",))
            self.specs.append(
                ("conv", CausalConv1d(mult * cfg.n_filters, mult * cfg.n_filters * 2,
                                      ratio * 2, stride=ratio))
            )
            mult *= 2
        self.specs.append(("elu",))
        self.specs.append(("conv", CausalConv1d(mult * cfg.n_filters, cfg.dimension,
                                                cfg.last_kernel_size)))

    def init(self, generator: torch.Generator, dtype=torch.float32) -> list:
        params = []
        for spec in self.specs:
            if spec[0] in ("conv", "convtr"):
                params.append(spec[1].init(generator, dtype))
            elif spec[0] == "res":
                params.append([s.init(generator, dtype) for s in spec[1]])
            else:
                params.append(None)
        return params

    def apply(self, params: list, x: torch.Tensor) -> torch.Tensor:
        for spec, p in zip(self.specs, params):
            if spec[0] in ("conv", "convtr"):
                x = spec[1].apply(p, x)
            elif spec[0] == "elu":
                x = _elu(x)
            else:  # residual block
                y = x
                for s, sp in zip(spec[1], p):
                    y = s.apply(sp, _elu(y))
                x = x + y
        return x

    def init_state(self, batch: int, dtype=torch.float32, device="cpu") -> list:
        states = []
        for spec in self.specs:
            if spec[0] in ("conv", "convtr"):
                states.append(spec[1].init_state(batch, dtype, device))
            elif spec[0] == "res":
                states.append([s.init_state(batch, dtype, device) for s in spec[1]])
            else:
                states.append(None)
        return states

    def apply_streaming(self, params: list, x: torch.Tensor, state: list):
        new_states = []
        for spec, p, st in zip(self.specs, params, state):
            if spec[0] in ("conv", "convtr"):
                x, nst = spec[1].apply_streaming(p, x, st)
                new_states.append(nst)
            elif spec[0] == "elu":
                x = _elu(x)
                new_states.append(None)
            else:
                y = x
                nsts = []
                for s, sp, sst in zip(spec[1], p, st):
                    y, nst = s.apply_streaming(sp, _elu(y), sst)
                    nsts.append(nst)
                x = x + y
                new_states.append(nsts)
        return x, new_states


class SEANetDecoder:
    """conv stem → per-stage [ELU, convtr ÷2ch, res-units] → ELU → final conv."""

    def __init__(self, cfg: SEANetConfig):
        self.cfg = cfg
        self.specs: List = []
        mult = 2 ** len(cfg.ratios)
        self.specs.append(("conv", CausalConv1d(cfg.dimension, mult * cfg.n_filters, cfg.kernel_size)))
        for ratio in cfg.ratios:
            self.specs.append(("elu",))
            self.specs.append(
                ("convtr", CausalConvTranspose1d(mult * cfg.n_filters, mult * cfg.n_filters // 2,
                                                 ratio * 2, stride=ratio))
            )
            for j in range(cfg.n_residual_layers):
                self.specs.append(
                    ("res", _res_block_specs(cfg, mult * cfg.n_filters // 2, cfg.dilation_base ** j))
                )
            mult //= 2
        self.specs.append(("elu",))
        self.specs.append(("conv", CausalConv1d(cfg.n_filters, cfg.channels, cfg.last_kernel_size)))

    # the traversal is the encoder's; only the spec list differs
    init = SEANetEncoder.init
    init_state = SEANetEncoder.init_state
    apply = SEANetEncoder.apply
    apply_streaming = SEANetEncoder.apply_streaming
