"""Train steps: the CSM loss's gradients and optax's AdamW chain, step for
step (port of ``sesameai_tts_tpu/training/train_step.py``).

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

On a ('dp', 'tp') mesh (``mesh=``, ``parallel/mesh.py``) each rank holds
its tp shards of the params and moments (``make_sharded_train_state``)
and its dp rows of the global batch (``shard_batch``); the step computes
what the unsharded step computes on the whole batch.  XLA adds the JAX
package's collectives; here the loss sums its normalizers over 'dp'
(``training/loss.py``), the trunks differentiate through
``parallel/autograd.py``'s f/g pair, and ``_GradSync`` makes each
gradient leaf the logical one before the update:

1. every leaf is summed over 'dp';
2. the kv columns of a ``qkv`` whose kv head is on several tp ranks are
   summed over those ranks (``kv_replica_group``): each holds the part its
   own query heads give;
3. a replicated leaf (norms, ``projection``, the heads) is left alone: f/g
   already make its gradient whole and equal on every tp rank.

The clip norm is that of the logical tree: each sharded leaf's square sum
summed over 'tp', a kv column held by m ranks counted 1/m times on each, a
replicated leaf once, so ``grad_norm`` is ``optax.global_norm`` of the
full gradient.  LoRA adapters are replicated: a rank's adapter gradient is
the part of the base shard it holds, so it is summed over 'tp', then 'dp'.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

import torch.distributed as dist

from sesameai_tts_tpu_torch.convert import tree_leaves, tree_map, tree_paths
from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.parallel.infer import tp_group
from sesameai_tts_tpu_torch.parallel.mesh import (
    csm_param_specs,
    dp_group,
    dp_rows,
    kv_replica_group,
    local_heads,
    placement_at,
    placements,
    shard_params,
)
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
    def apply(self, params, grads, opt_state, g_norm=None) -> torch.Tensor:
        """Update ``params`` and ``opt_state`` in place from ``grads`` → the
        unclipped global norm: ``g_norm`` when given (a sharded tree's
        logical norm, ``_GradSync``), else that of the leaves here."""
        g_leaves = tree_leaves(grads)
        if g_norm is None:
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


def make_sharded_train_state(generator: torch.Generator, cfg: CSMConfig, mesh, tx: AdamW,
                             dtype=torch.float32, device=None) -> TrainState:
    """``init_train_state`` of this rank's shards on ``mesh``: the params that
    ``init_csm_params`` draws from ``generator`` (the whole tree, as one card
    draws it), cut by ``shard_params`` and moved to ``device`` (default:
    where they were drawn), and the moments ``tx.init`` makes on them."""
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.models.csm import init_csm_params

    params = shard_params(init_csm_params(cfg, generator, dtype), mesh, cfg)
    return init_train_state(params if device is None else to_device(params, device), tx)


class _GradSync:
    """A rank's gradient tree → the logical one, and its global norm, on a
    mesh (module docstring).  ``adapters``: the tree is LoRA adapters over a
    sharded base.  Makes the kv replica groups, a collective, when built."""

    def __init__(self, cfg: CSMConfig, mesh, adapters: bool = False):
        self.cfg, self.adapters = cfg, adapters
        self.tp, self.dp = tp_group(mesh), dp_group(mesh)
        self.kv = {} if adapters else {name: kv_replica_group(getattr(cfg, name), mesh)
                                       for name in ("backbone", "decoder")}

    def __call__(self, grads):
        Shard = placements()[0]
        specs = csm_param_specs()
        out, whole, part = [], [], []
        for path, g in tree_paths(grads):
            g = g.contiguous()
            sharded = self.tp is not None and isinstance(
                placement_at(specs, path[:-1] if self.adapters else path), Shard)
            if self.adapters and sharded:  # the part of the base shard this rank holds
                dist.all_reduce(g, group=self.tp)
            if self.dp is not None:
                dist.all_reduce(g, group=self.dp)
            kv = None if self.adapters or path[-1] != "qkv" else self.kv[path[0]]
            if kv is not None:
                tcfg = getattr(self.cfg, path[0])
                c0 = local_heads(tcfg, self.tp)[0] * tcfg.head_dim
                cols = g[:, c0:].contiguous()
                dist.all_reduce(cols, group=kv)
                g[:, c0:] = cols
                part.append((g[:, :c0] * g[:, :c0]).sum()
                            + (cols * cols).sum() / dist.get_world_size(kv))
            elif sharded and not self.adapters:
                part.append((g * g).sum())
            else:
                whole.append((g * g).sum())
            out.append(g)
        sq = sum(whole)
        if part:
            held = sum(part)
            if self.tp is not None:
                dist.all_reduce(held, group=self.tp)
            sq = sq + held
        leaves = iter(out)
        return tree_map(lambda _: next(leaves), grads), torch.sqrt(sq)


def _mesh_parts(mesh):
    """(tp group, dp group, dp size, dp rank) of ``mesh``; no groups without one."""
    if mesh is None:
        return None, None, 1, 0
    return tp_group(mesh), dp_group(mesh), mesh.size(0), mesh.get_local_rank("dp")


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


def _apply_update(tx: AdamW, state: TrainState, grads, metrics: dict, sync=None):
    """The optimizer half of a step; on a mesh ``sync`` (``_GradSync``) first
    makes the gradients the logical ones."""
    norm = None
    if sync is not None:
        grads, norm = sync(grads)
    metrics["grad_norm"] = tx.apply(state.params, grads, state.opt_state, norm)
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


def _subset_for(state: TrainState, batch: Batch, subset_rng: bool, seed: int, n_dp: int = 1,
                d: int = 0, accum_steps: int = 1):
    """The step's scores for this rank's rows: drawn for the global batch
    (``n_dp`` times the local one), then its rows as ``shard_batch`` took
    them."""
    if not subset_rng:
        return None
    B, S = batch.tokens.shape[:2]
    scores = _subset_scores(int(state.step), B * n_dp, S, seed)
    if n_dp > 1:
        scores = scores[dp_rows(B * n_dp, n_dp, d, accum_steps)]
    return scores.to(batch.tokens.device)


def make_train_step(cfg: CSMConfig, tx: AdamW, decoder_frames: int = 4, remat: bool = False,
                    accum_steps: int = 1, compute_dtype=None, subset_rng: bool = True,
                    subset_seed: int = 0, mesh=None):
    """→ ``train_step(state, batch) → (state, metrics)``; updates the
    state's tensors in place.

    ``remat`` recomputes the backbone's layer activations in the backward
    pass; ``accum_steps > 1`` splits the batch into microbatches (the
    microbatch mean); ``compute_dtype=torch.bfloat16`` with f32 params runs
    the forward and backward in bf16 (the cast is inside the differentiated
    function, so gradients land in f32); ``subset_rng=False`` pins the
    first-N decoder subset.  ``mesh``: the state holds this rank's shards
    and the batch its rows (module docstring); every rank of the mesh
    builds the step (a collective) and calls it."""
    tp, dp, n_dp, d = _mesh_parts(mesh)
    sync = None if mesh is None else _GradSync(cfg, mesh)

    def _grads(params, batch, subset_r):
        def loss_fn(p):
            if compute_dtype is not None:
                p = _cast_floating(p, compute_dtype)
            return csm_loss(p, cfg, batch, decoder_frames, remat=remat, subset_r=subset_r,
                            tp=tp, dp=dp)

        return _value_and_grad(loss_fn, params)

    def train_step(state: TrainState, batch: Batch):
        subset_r = _subset_for(state, batch, subset_rng, subset_seed, n_dp, d, accum_steps)
        metrics, grads = _accum_grads(_grads, state.params, batch, accum_steps, subset_r)
        return _apply_update(tx, state, grads, metrics, sync)

    return train_step


def make_lora_train_step(cfg: CSMConfig, tx: AdamW, alpha: float = 16.0,
                         decoder_frames: int = 4, remat: bool = False, accum_steps: int = 1,
                         compute_dtype=None, subset_rng: bool = True, subset_seed: int = 0,
                         mesh=None):
    """→ ``train_step(state, base_params, batch) → (state, metrics)``.

    ``state.params`` is the LoRA adapter tree (``training/lora.py``); the
    frozen base is merged with the adapters inside the differentiated
    function, so only the adapters get gradients and optimizer state.  On
    a ``mesh`` the base is this rank's shards and the adapters replicated."""
    from sesameai_tts_tpu_torch.training.lora import merge_lora

    tp, dp, n_dp, d = _mesh_parts(mesh)
    sync = None if mesh is None else _GradSync(cfg, mesh, adapters=True)

    def train_step(state: TrainState, base_params: dict, batch: Batch):
        def _grads(lora, b, subset_r):
            def loss_fn(l):
                merged = merge_lora(base_params, l, alpha, tp=tp, cfg=cfg)
                if compute_dtype is not None:
                    merged = _cast_floating(merged, compute_dtype)
                return csm_loss(merged, cfg, b, decoder_frames, remat=remat, subset_r=subset_r,
                                tp=tp, dp=dp)

            return _value_and_grad(loss_fn, lora)

        subset_r = _subset_for(state, batch, subset_rng, subset_seed, n_dp, d, accum_steps)
        metrics, grads = _accum_grads(_grads, state.params, batch, accum_steps, subset_r)
        return _apply_update(tx, state, grads, metrics, sync)

    return train_step


def make_eval_step(cfg: CSMConfig, decoder_frames: int = 4, compute_dtype=None, mesh=None):
    """→ ``eval_step(params, batch) → metrics``, without gradients (on a
    ``mesh``: shards and this rank's rows in, the global metrics out)."""
    tp, dp, _, _ = _mesh_parts(mesh)

    @torch.no_grad()
    def eval_step(params: dict, batch: Batch) -> dict:
        if compute_dtype is not None:
            params = _cast_floating(params, compute_dtype)
        return csm_loss(params, cfg, batch, decoder_frames, tp=tp, dp=dp)[1]

    return eval_step


def make_lora_eval_step(cfg: CSMConfig, alpha: float = 16.0, decoder_frames: int = 4,
                        compute_dtype=None, mesh=None):
    """→ ``eval_step(lora, base_params, batch) → metrics``; merges first."""
    from sesameai_tts_tpu_torch.training.lora import merge_lora

    tp, dp, _, _ = _mesh_parts(mesh)

    @torch.no_grad()
    def eval_step(lora: dict, base_params: dict, batch: Batch) -> dict:
        merged = merge_lora(base_params, lora, alpha, tp=tp, cfg=cfg)
        if compute_dtype is not None:
            merged = _cast_floating(merged, compute_dtype)
        return csm_loss(merged, cfg, batch, decoder_frames, tp=tp, dp=dp)[1]

    return eval_step


def batch_to(batch: Batch, device) -> Batch:
    """A Batch of numpy arrays (the loader's) or tensors → tensors on
    ``device``."""
    return Batch(*(torch.as_tensor(x).to(device) for x in batch))

