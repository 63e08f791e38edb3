"""Top-k + temperature sampling on the device (port of
``sesameai_tts_tpu/ops/sampling.py``).

Temperature-scale, keep the top k, draw by Gumbel-argmax.  The top-k
threshold (the k-th largest logit) comes from the JAX package's
fixed-depth 32-way bracket search, ported as written so that a sample
with injected Gumbel noise equals the JAX package's.  The mask never
drops a top-k token; it may keep a token within range/2^20 of the k-th
value.  With ``topk <= 1`` sampling is exact greedy argmax, also for one
row of a per-row ``topk`` (a greedy session in a sampled serving batch).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

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


def sample_topk(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (..., vocab)
    topk: Union[int, torch.Tensor],
    temperature: Union[float, torch.Tensor],
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int64 samples of shape ``logits.shape[:-1]``.

    ``topk`` and ``temperature`` may be per-slot ``(...,)`` tensors.
    ``gumbel`` injects the noise; otherwise it is drawn from ``generator``."""
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
