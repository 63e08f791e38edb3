"""The gaps of served tokens in reference logits, shared by every model
family: (F, K, V) logits of F frames of K codebooks against the (F, K)
tokens that were served."""

from __future__ import annotations

from typing import List

import torch


def greedy_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(F, K, V) reference logits and (F, K) served tokens → how far each
    served token's logit lies below the reference's best (0 where the
    reference agrees)."""
    best = logits.amax(dim=-1)
    got = torch.take_along_dim(logits, served[..., None].long(), dim=-1)[..., 0]
    return best - got


def topk_gaps(logits: torch.Tensor, served: torch.Tensor, k: int) -> torch.Tensor:
    """(F, K, V) reference logits and (F, K) served tokens → how far each
    served token's logit lies below the reference's k-th best (0 inside
    the reference's top k)."""
    kth = logits.topk(k, dim=-1).values[..., -1]
    got = torch.take_along_dim(logits, served[..., None].long(), dim=-1)[..., 0]
    return (kth - got).clamp_min(0.0)


def argmax_gaps(logits: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """The gaps, in ``logits``, of the tokens that ``other`` (logits of a
    control at the same positions) puts first."""
    return greedy_gaps(logits, other.argmax(dim=-1))


def widest(gaps: List[torch.Tensor]) -> float:
    return max((float(g.max()) for g in gaps if g.numel()), default=float("nan"))
