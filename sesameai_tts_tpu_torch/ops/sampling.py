"""Top-k + temperature sampling on the device (port of
``sesameai_tts_tpu/ops/sampling.py``).

Temperature-scale, keep the top k, draw by Gumbel-argmax.  The top-k
threshold (the k-th largest logit) comes from the JAX package's
fixed-depth 32-way bracket search, ported as written so that a sample
with injected Gumbel noise equals the JAX package's.  The mask never
drops a top-k token; it may keep a token within range/2^20 of the k-th
value.  With ``topk <= 1`` sampling is exact greedy argmax, also for one
row of a per-row ``topk`` (a greedy session in a sampled serving batch).

``sample_topk`` runs ``sample_topk_plain`` (the JAX package's ops as torch
ops) for a CPU tensor, and for a CUDA tensor the kernel ``topk_sample``
(``csrc/topk_sample.cu``: the same arithmetic, bit for bit for the same
noise, in one launch).  ``topk_sample.launches`` counts the kernel's
launches; ``sample_topk_plain.launches`` counts the plain path's calls on
a device other than the CPU, which only a yardstick makes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from sesameai_tts_tpu_torch.ops.kernels import check_operands, count_launch, launch

_DEFAULT_PHASES = 4
_WAYS = 32


def topk_threshold(logits: torch.Tensor, k, iters: int = _DEFAULT_PHASES) -> torch.Tensor:
    """k-th largest value along the last axis via ``iters`` phases of
    ``_WAYS``-way bracket search over the finite logits.  ``k`` is an int
    or a tensor broadcastable to ``logits.shape[:-1] + (1,)``.  Returns
    shape ``logits.shape[:-1] + (1,)``."""
    finite = torch.isfinite(logits)
    lo = torch.where(finite, logits, float("inf")).amin(dim=-1, keepdim=True)
    hi = torch.where(finite, logits, float("-inf")).amax(dim=-1, keepdim=True)
    degenerate = ~torch.isfinite(lo)  # all-banned row: keep a valid bracket
    lo = torch.where(degenerate, -1.0, lo)
    hi = torch.where(degenerate, 1.0, hi)
    hi = hi + 0.001 * (hi - lo) + 1e-6  # count(>= hi) < k from the start

    fracs = torch.arange(1, _WAYS, dtype=torch.float32, device=logits.device) / _WAYS
    fracs = fracs.reshape((_WAYS - 1,) + (1,) * logits.dim())
    for _ in range(iters):
        mids = lo + (hi - lo) * fracs  # (W-1, ..., 1) ascending
        enough = (logits[None] >= mids).sum(dim=-1, keepdim=True) >= k
        n_enough = enough.sum(dim=0)  # (..., 1) in [0, W-1]
        all_mids = torch.cat([lo[None], mids, hi[None]], dim=0)  # (W+1, ..., 1)
        idx = torch.stack([n_enough, n_enough + 1])
        lo, hi = torch.take_along_dim(all_mids, idx, dim=0)
    return lo


def gumbel_noise(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel f32 noise on the generator's device.  The two logs
    run in f64: the CPU build's f32 ``log`` of a tensor large enough to be
    split across threads gave results ~1e-5 apart on the same input in two
    calls of one process (one that also runs JAX), so one seed drew two
    different noises."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny).double()
    return (-torch.log(-torch.log(u))).float()


def sample_topk_plain(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (..., vocab)
    topk: Union[int, torch.Tensor],
    temperature: Union[float, torch.Tensor],
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``sample_topk`` as the JAX package's ops, on any device: the CPU
    path, and the reference the kernel is held to."""
    if logits.device.type != "cpu":
        count_launch(sample_topk_plain)
    logits = raw = logits.float()
    static_k = isinstance(topk, (int, np.integer))
    if static_k and topk <= 1:
        return logits.argmax(dim=-1)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.to(device=logits.device, dtype=torch.float32)
        if temperature.dim():
            temperature = temperature[..., None]
    logits = logits / temperature  # a Python float divides as an f32 scalar
    if not static_k:
        # per-slot topk: k >= V keeps everything; k <= 1 is the exact argmax
        # below (the threshold alone may keep a near-tie within its bracket)
        k = torch.as_tensor(topk, device=logits.device)[..., None]
        masked = torch.where(logits < topk_threshold(logits, k), float("-inf"), logits)
    elif topk < logits.shape[-1]:
        masked = torch.where(logits < topk_threshold(logits, topk), float("-inf"), logits)
    else:
        masked = logits
    if gumbel is None:
        gumbel = gumbel_noise(generator, logits.shape)
    sample = (masked + gumbel).argmax(dim=-1)
    if static_k:
        return sample
    return torch.where(k[..., 0] <= 1, raw.argmax(dim=-1), sample)


sample_topk_plain.launches = 0


def sample_topk(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (..., vocab)
    topk: Union[int, torch.Tensor],
    temperature: Union[float, torch.Tensor],
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int64 samples of shape ``logits.shape[:-1]``.

    ``topk`` and ``temperature`` may be per-slot ``(...,)`` tensors.
    ``gumbel`` injects the noise; otherwise it is drawn from ``generator``.
    A CPU tensor takes ``sample_topk_plain``; a CUDA tensor the kernel, or
    the exact argmax for a number ``topk <= 1``."""
    if logits.device.type == "cpu":
        return sample_topk_plain(generator, logits, topk, temperature, gumbel)
    if isinstance(topk, (int, np.integer)):
        if topk <= 1:
            return logits.float().argmax(dim=-1)
    else:
        topk = torch.as_tensor(topk, device=logits.device).long()
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.to(device=logits.device, dtype=torch.float32)
    if gumbel is None:
        gumbel = gumbel_noise(generator, logits.shape)
    return topk_sample(logits.float(), gumbel, temperature, topk)


def _per_row(name: str, value, dtype: torch.dtype, rows_shape: torch.Size):
    """A number, or a tensor of ``dtype`` with shape () or ``rows_shape``
    (one value a row), else ValueError / TypeError."""
    if not isinstance(value, torch.Tensor):
        return value
    if value.dtype != dtype:
        raise TypeError(f"topk_sample: {name} must be {dtype}, got {value.dtype}")
    if value.dim() and value.shape != rows_shape:
        raise ValueError(f"topk_sample: {name} has shape {tuple(value.shape)}; want () or "
                         f"{tuple(rows_shape)}")
    return value


def topk_sample(logits: torch.Tensor, gumbel: torch.Tensor,
                temperature: Union[float, torch.Tensor],
                topk: Union[int, torch.Tensor]) -> torch.Tensor:
    """Draw one token a row of ``logits`` (..., V) f32 by Gumbel-argmax
    with the noise ``gumbel`` (same shape, f32) over the top ``topk`` of
    ``logits / temperature`` → int64 ``logits.shape[:-1]``.  ``temperature``
    (f32) and ``topk`` (int64) are numbers, 0-dim tensors or one value a
    row.  A row with k <= 1 takes the argmax of its raw logits.  CUDA
    tensors launch ``csrc/topk_sample.cu`` (or raise); CPU tensors run
    ``sample_topk_plain``.  ``topk_sample.launches`` counts launches."""
    if logits.dtype != torch.float32 or gumbel.dtype != torch.float32:
        raise TypeError(f"topk_sample: want f32 logits and gumbel; got {logits.dtype}, "
                        f"{gumbel.dtype}")
    if logits.dim() < 1 or logits.shape[-1] < 1 or logits.numel() == 0:
        raise ValueError(f"topk_sample: want logits (..., V) with rows and V >= 1; got "
                         f"{tuple(logits.shape)}")
    if gumbel.shape != logits.shape:
        raise ValueError(f"topk_sample: gumbel {tuple(gumbel.shape)} != logits "
                         f"{tuple(logits.shape)}")
    rows_shape, V = logits.shape[:-1], logits.shape[-1]
    temperature = _per_row("temperature", temperature, torch.float32, rows_shape)
    topk = _per_row("topk", topk, torch.int64, rows_shape)
    tensors = {"logits": logits, "gumbel": gumbel}
    tensors.update({name: t for name, t in (("temperature", temperature), ("topk", topk))
                    if isinstance(t, torch.Tensor)})
    check_operands("topk_sample", tensors, logits.device)
    if logits.device.type == "cpu":
        return sample_topk_plain(None, logits, topk, temperature, gumbel)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_sample: unsupported device {logits.device}")
    rows = logits.numel() // V
    if rows * V >= 2**31:
        raise ValueError(f"topk_sample: rows * V must be < 2^31 (rows={rows}, V={V})")
    out = torch.empty(rows_shape, dtype=torch.int64, device=logits.device)
    if isinstance(temperature, torch.Tensor):
        t_ptr, t_stride, t_value = temperature.data_ptr(), int(temperature.dim() > 0), 0.0
    else:
        t_ptr, t_stride, t_value = None, 0, float(temperature)
    if isinstance(topk, torch.Tensor):
        k_ptr, k_stride, k_value = topk.data_ptr(), int(topk.dim() > 0), 0
    else:  # k <= 1 and k >= V keep their meaning in an int
        k_ptr, k_stride, k_value = None, 0, max(0, min(int(topk), V + 1))
    launch("topk_sample", logits.data_ptr(), gumbel.data_ptr(), t_ptr, k_ptr, out.data_ptr(),
           rows, V, t_stride, k_stride, t_value, k_value,
           torch.cuda.current_stream(logits.device).cuda_stream)
    count_launch(topk_sample)
    return out


topk_sample.launches = 0
