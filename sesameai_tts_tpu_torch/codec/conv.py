"""Causal 1-D convolutions with explicit streaming state (port of
``sesameai_tts_tpu/codec/conv.py``).

Convolutions over ``(B, C, T)`` with torch-layout kernels, through
``torch.nn.functional.conv1d``/``conv_transpose1d`` (the JAX package left
them to XLA).  Streaming carries overlap buffers:

* causal conv: left-pad ``k_eff - stride``; streamed by prepending the
  saved input tail;
* causal transposed conv: emit ``T*stride`` samples and carry the
  trailing ``k - stride`` partial sums (bias applied once on emit).

Chunk lengths must be multiples of the stride.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: int = 1, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x (B, C_in, T), w (C_out, C_in/groups, K); VALID padding."""
    y = F.conv1d(x.to(w.dtype), w, None, stride=stride, dilation=dilation, groups=groups)
    if b is not None:
        y = y + b[None, :, None]
    return y


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Full (untrimmed) transposed conv, w (C_in, C_out/groups, K): output
    length T*stride + K - stride."""
    y = F.conv_transpose1d(x.to(w.dtype), w, None, stride=stride, groups=groups)
    if b is not None:
        y = y + b[None, :, None]
    return y


class ConvState(NamedTuple):
    buf: torch.Tensor  # (B, C_in, pad) saved input tail
    primed: torch.Tensor  # (B,) bool: False until that row saw a chunk


class CausalConv1d(NamedTuple):
    """Static conv spec; params are a dict {'w': ..., 'b': ...}.

    ``pad_mode``: 'zeros' (SEANet convs) or 'replicate' (the Mimi
    downsample); streaming replicate primes the overlap buffer from the
    first chunk's first sample."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "zeros"

    @property
    def pad(self) -> int:
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        if k_eff < self.stride:
            raise ValueError(f"effective kernel {k_eff} < stride {self.stride}")
        return k_eff - self.stride

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        fan_in = self.in_channels // self.groups * self.kernel_size
        w = torch.randn(
            (self.out_channels, self.in_channels // self.groups, self.kernel_size),
            generator=generator, device=generator.device,
        ) * fan_in ** -0.5
        p = {"w": w.to(dtype)}
        if self.bias:
            p["b"] = torch.zeros(self.out_channels, dtype=dtype, device=generator.device)
        return p

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Offline causal conv over (B, C, T), T a multiple of stride."""
        if self.pad_mode == "replicate":
            x = torch.cat([x[:, :, :1].expand(-1, -1, self.pad), x], dim=-1)
        else:
            x = F.pad(x, (self.pad, 0))
        return conv1d(x, params["w"], params.get("b"), self.stride, self.dilation, self.groups)

    def init_state(self, batch: int, dtype=torch.float32, device="cpu") -> ConvState:
        return ConvState(
            buf=torch.zeros((batch, self.in_channels, self.pad), dtype=dtype, device=device),
            primed=torch.zeros(batch, dtype=torch.bool, device=device),
        )

    def apply_streaming(self, params: dict, x: torch.Tensor,
                        state: ConvState) -> Tuple[torch.Tensor, ConvState]:
        buf = state.buf.to(x.dtype)
        if self.pad_mode == "replicate" and self.pad > 0:
            # before any chunk arrived the saved tail is a placeholder:
            # substitute this chunk's first sample, exactly the offline pad
            buf = torch.where(state.primed[:, None, None], buf, x[:, :, :1].expand_as(buf))
        xp = torch.cat([buf, x], dim=-1)
        y = conv1d(xp, params["w"], params.get("b"), self.stride, self.dilation, self.groups)
        new_buf = xp[:, :, xp.shape[-1] - self.pad:]
        return y, ConvState(buf=new_buf, primed=torch.ones_like(state.primed))


class ConvTrState(NamedTuple):
    tail: torch.Tensor  # (B, C_out, K - stride) pending partial sums (no bias)


class CausalConvTranspose1d(NamedTuple):
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    groups: int = 1
    bias: bool = True

    @property
    def trim(self) -> int:
        return self.kernel_size - self.stride

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        fan_in = self.in_channels // self.groups * self.kernel_size
        w = torch.randn(
            (self.in_channels, self.out_channels // self.groups, self.kernel_size),
            generator=generator, device=generator.device,
        ) * fan_in ** -0.5
        p = {"w": w.to(dtype)}
        if self.bias:
            p["b"] = torch.zeros(self.out_channels, dtype=dtype, device=generator.device)
        return p

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        y = conv_transpose1d(x, params["w"], params.get("b"), self.stride, self.groups)
        return y[:, :, : x.shape[-1] * self.stride]

    def init_state(self, batch: int, dtype=torch.float32, device="cpu") -> ConvTrState:
        return ConvTrState(
            tail=torch.zeros((batch, self.out_channels, self.trim), dtype=dtype, device=device)
        )

    def apply_streaming(self, params: dict, x: torch.Tensor,
                        state: ConvTrState) -> Tuple[torch.Tensor, ConvTrState]:
        y = conv_transpose1d(x, params["w"], None, self.stride, self.groups)
        T_out = x.shape[-1] * self.stride
        if self.trim > 0:
            y[:, :, : self.trim] += state.tail.to(y.dtype)  # y is ours: add in place
        new_tail = y[:, :, T_out:]
        out = y[:, :, :T_out]
        if "b" in params:
            out = out + params["b"][None, :, None]
        return out, ConvTrState(tail=new_tail)
