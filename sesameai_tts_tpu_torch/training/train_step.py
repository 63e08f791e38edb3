"""Train steps: the CSM loss's gradients and optax's AdamW chain, step for
step (port of ``sesameai_tts_tpu/training/train_step.py``; the sharded
helpers belong to the parallel slice).

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...), b1=0.9, b2=0.95, eps=1e-8))``
written as tensor functions over an ``opt_state`` tree of tensors
(``{"count", "mu", "nu"}``), so ``save_pytree`` checkpoints it:

* the gradients are scaled by ``1 / ‖g‖`` only when ``‖g‖ ≥ 1`` (no
  epsilon), and the ``grad_norm`` metric is the unclipped norm;
* weight decay applies to every leaf, norms and embeddings included;
* the learning rate is read at the count *before* the update, so the
  first update of a warmup has lr 0.

A step updates the state's tensors IN PLACE (params, ``mu``, ``nu``,
``count``) and returns a new ``TrainState`` over them: the JAX step donates
its state.  Gradients come from ``torch.autograd.grad`` on detached
leaves, so stored params never require grad.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.convert import tree_leaves, tree_map
from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.training.loss import Batch, csm_loss

_METRICS = ("loss", "c0_loss", "decoder_loss")


class TrainState(NamedTuple):
    params: dict
    opt_state: dict  # {"count": int32 scalar, "mu": tree, "nu": tree}
    step: torch.Tensor  # int32 scalar


@dataclass(frozen=True)
class AdamW:
    """optax's chain(clip_by_global_norm, adamw(warmup-cosine schedule))."""

    lr: float
    weight_decay: float
    warmup: int
    total_steps: int
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    max_norm: float = 1.0

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """``warmup_cosine_decay_schedule(0, lr, warmup, max(total_steps,
        warmup + 1), end_value=0.1 * lr)`` at ``count``, in f32 on its
        device."""
        c = count.float()
        if self.warmup > 0:  # linear_schedule(0, lr, warmup)
            frac = 1 - torch.clamp(c, 0, self.warmup) / self.warmup
            warm = (0.0 - self.lr) * frac + self.lr
        else:
            warm = torch.zeros_like(c)
        decay_steps = max(self.total_steps, self.warmup + 1) - self.warmup
        alpha = 0.0 if self.lr == 0.0 else (self.lr * 0.1) / self.lr
        t = torch.clamp(c - self.warmup, max=decay_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / decay_steps))
        return torch.where(c < self.warmup, warm, self.lr * ((1 - alpha) * cosine + alpha))

    @torch.no_grad()
    def apply(self, params, grads, opt_state) -> torch.Tensor:
        """Update ``params`` and ``opt_state`` in place from ``grads`` → the
        unclipped global norm."""
        g_leaves = tree_leaves(grads)
        g_norm = torch.sqrt(sum((g * g).sum() for g in g_leaves))
        keep = g_norm < self.max_norm
        count = opt_state["count"]
        lr = -self.learning_rate(count)
        count_inc = torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)
        bc1 = 1 - self.b1 ** count_inc.float()
        bc2 = 1 - self.b2 ** count_inc.float()
        for p, g, mu, nu in zip(tree_leaves(params), g_leaves, tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"])):
            g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.max_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
            u = u + self.weight_decay * p
            p.copy_((p + lr.to(u.dtype) * u).to(p.dtype))
        count.copy_(count_inc)
        return g_norm


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01, warmup: int = 100,
                   total_steps: int = 10_000) -> AdamW:
    """``total_steps`` is the cosine horizon: pass the run's length (the
    finetune CLI passes ``--steps``)."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup=warmup, total_steps=total_steps)


def init_train_state(params: dict, tx: AdamW) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _cast_floating(tree, dtype):
    """Cast floating leaves to ``dtype`` (integer leaves pass)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _subset_scores(step: int, B: int, S: int, seed: int) -> torch.Tensor:
    """(B, S-1) uniform scores for the decoder-loss row subset, on the CPU,
    from (seed, step) alone, so every frame is eventually trained and a
    resumed run draws what an unbroken one does.  Drawn for the full batch
    before any microbatch split."""
    mixed = np.random.SeedSequence([seed % 2**64, int(step)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed))
    return torch.rand((B, S - 1), generator=gen)


def _apply_update(tx: AdamW, state: TrainState, grads, metrics: dict):
    metrics["grad_norm"] = tx.apply(state.params, grads, state.opt_state)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def _accum_grads(grads_fn, params, batch: Batch, accum_steps: int, subset_r=None):
    """``grads_fn(params, batch, subset_r) → (metrics, grads)`` once, or over
    ``accum_steps`` leading-axis microbatches with f32 gradient sums; the
    gradients and metrics are then the microbatch mean.  ``subset_r``
    splits with the batch."""
    if accum_steps == 1:
        return grads_fn(params, batch, subset_r)
    B = batch.tokens.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
    mb = B // accum_steps
    gsum = msum = None
    for i in range(accum_steps):
        rows = slice(i * mb, (i + 1) * mb)
        metrics, grads = grads_fn(params, Batch(*(x[rows] for x in batch)),
                                  None if subset_r is None else subset_r[rows])
        if gsum is None:
            gsum = tree_map(lambda g: g.float(), grads)
            msum = {k: metrics[k].detach() for k in _METRICS}
        else:
            gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
            msum = {k: msum[k] + metrics[k].detach() for k in _METRICS}
    grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype), gsum, params)
    return {k: v / accum_steps for k, v in msum.items()}, grads


def _value_and_grad(loss_fn, params):
    """(metrics, grads) of ``loss_fn(params) → (loss, metrics)`` at
    ``params``, differentiated on detached leaves."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return ({k: metrics[k].detach() for k in _METRICS}, tree_map(lambda _: next(grads), leaves))


def _subset_for(state: TrainState, batch: Batch, subset_rng: bool, seed: int):
    if not subset_rng:
        return None
    B, S = batch.tokens.shape[:2]
    return _subset_scores(int(state.step), B, S, seed).to(batch.tokens.device)


def make_train_step(cfg: CSMConfig, tx: AdamW, decoder_frames: int = 4, remat: bool = False,
                    accum_steps: int = 1, compute_dtype=None, subset_rng: bool = True,
                    subset_seed: int = 0):
    """→ ``train_step(state, batch) → (state, metrics)``; updates the
    state's tensors in place.

    ``remat`` recomputes the backbone's layer activations in the backward
    pass; ``accum_steps > 1`` splits the batch into microbatches (the
    microbatch mean); ``compute_dtype=torch.bfloat16`` with f32 params runs
    the forward and backward in bf16 (the cast is inside the differentiated
    function, so gradients land in f32); ``subset_rng=False`` pins the
    first-N decoder subset."""

    def _grads(params, batch, subset_r):
        def loss_fn(p):
            if compute_dtype is not None:
                p = _cast_floating(p, compute_dtype)
            return csm_loss(p, cfg, batch, decoder_frames, remat=remat, subset_r=subset_r)

        return _value_and_grad(loss_fn, params)

    def train_step(state: TrainState, batch: Batch):
        subset_r = _subset_for(state, batch, subset_rng, subset_seed)
        metrics, grads = _accum_grads(_grads, state.params, batch, accum_steps, subset_r)
        return _apply_update(tx, state, grads, metrics)

    return train_step


def make_lora_train_step(cfg: CSMConfig, tx: AdamW, alpha: float = 16.0,
                         decoder_frames: int = 4, remat: bool = False, accum_steps: int = 1,
                         compute_dtype=None, subset_rng: bool = True, subset_seed: int = 0):
    """→ ``train_step(state, base_params, batch) → (state, metrics)``.

    ``state.params`` is the LoRA adapter tree (``training/lora.py``); the
    frozen base is merged with the adapters inside the differentiated
    function, so only the adapters get gradients and optimizer state."""
    from sesameai_tts_tpu_torch.training.lora import merge_lora

    def train_step(state: TrainState, base_params: dict, batch: Batch):
        def _grads(lora, b, subset_r):
            def loss_fn(l):
                merged = merge_lora(base_params, l, alpha)
                if compute_dtype is not None:
                    merged = _cast_floating(merged, compute_dtype)
                return csm_loss(merged, cfg, b, decoder_frames, remat=remat, subset_r=subset_r)

            return _value_and_grad(loss_fn, lora)

        subset_r = _subset_for(state, batch, subset_rng, subset_seed)
        metrics, grads = _accum_grads(_grads, state.params, batch, accum_steps, subset_r)
        return _apply_update(tx, state, grads, metrics)

    return train_step


def make_eval_step(cfg: CSMConfig, decoder_frames: int = 4, compute_dtype=None):
    """→ ``eval_step(params, batch) → metrics``, without gradients."""

    @torch.no_grad()
    def eval_step(params: dict, batch: Batch) -> dict:
        if compute_dtype is not None:
            params = _cast_floating(params, compute_dtype)
        return csm_loss(params, cfg, batch, decoder_frames)[1]

    return eval_step


def make_lora_eval_step(cfg: CSMConfig, alpha: float = 16.0, decoder_frames: int = 4,
                        compute_dtype=None):
    """→ ``eval_step(lora, base_params, batch) → metrics``; merges first."""
    from sesameai_tts_tpu_torch.training.lora import merge_lora

    @torch.no_grad()
    def eval_step(lora: dict, base_params: dict, batch: Batch) -> dict:
        merged = merge_lora(base_params, lora, alpha)
        if compute_dtype is not None:
            merged = _cast_floating(merged, compute_dtype)
        return csm_loss(merged, cfg, batch, decoder_frames)[1]

    return eval_step


def batch_to(batch: Batch, device) -> Batch:
    """A Batch of numpy arrays (the loader's) or tensors → tensors on
    ``device``."""
    return Batch(*(torch.as_tensor(x).to(device) for x in batch))

