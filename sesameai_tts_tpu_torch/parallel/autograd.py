"""The Megatron f/g pair: the tensor-parallel collectives as autograd
functions.

A tp rank holds a column block of each column-sharded matmul (``qkv``,
``w13``) and the matching row block of each row-sharded one (``o_proj``,
``w2``, the vocab-sharded embeddings), ``parallel/mesh.py``:

* ``copy_to_tp`` (f) goes where a replicated activation enters a
  column-sharded matmul: the identity forward, an all_reduce of the
  gradient backward, because each rank's input gradient is the part its
  columns contribute;
* ``reduce_from_tp`` (g) goes after a row-sharded matmul or a sharded
  lookup: an all_reduce forward, the identity backward, because the sum's
  gradient is already whole on every rank.

An in-place ``dist.all_reduce`` is invisible to autograd (it passes the
gradient through as the identity), and ``torch.distributed.nn``'s
differentiable all_reduce sums the gradient again, scaling it by tp.

Both take an explicit group and do nothing without one.
``reduce_from_tp`` sums in place (``ctx.mark_dirty``): no producer it
follows (a matmul, a lookup, a concatenation) saves its output for
backward, so serving and training run the same op with no copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """f: ``x`` forward, the gradient summed over ``group`` backward."""
    if group is None:
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """g: ``x`` summed over ``group`` forward, the gradient as it is
    backward.  The sum is in place: ``x`` is returned."""
    if group is None:
        return x
    return _ReduceFromTP.apply(x, group)
