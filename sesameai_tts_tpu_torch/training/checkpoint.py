"""TrainState checkpoint/resume, step-numbered files (port of
``sesameai_tts_tpu/training/checkpoint.py``).

A checkpoint is the FULL ``TrainState`` (params, optimizer state, step) as
one ``save_pytree`` file ``<ckpt_dir>/step_XXXXXXXX``, so a resumed run
continues bit for bit where it stopped (momentum and schedule included).
The JAX package writes an orbax directory of the same name.

On a mesh (``mesh=``) the file holds the logical tree, as the JAX
package's orbax checkpoint holds the logical arrays: the tp shards of the
params and moments (``cfg`` given) are gathered and rank 0 writes the file
an unsharded run writes; a restore reads it and takes this rank's shards,
so a checkpoint resumes on any mesh and on one card.  A replicated state
(LoRA adapters, ``cfg`` None) is written by rank 0 as it is.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from sesameai_tts_tpu_torch.convert import to_device, tree_map
from sesameai_tts_tpu_torch.core.weights import load_pytree, save_pytree
from sesameai_tts_tpu_torch.parallel.infer import tp_group
from sesameai_tts_tpu_torch.parallel.mesh import (
    all_gather_params,
    csm_param_specs,
    shard_params,
)
from sesameai_tts_tpu_torch.training.train_step import TrainState

_STEP_NAME = re.compile(r"^step_(\d{8,})$")  # :08d widens past 8 digits


def _like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` at ``ref``'s dtype and device; a shape that differs raises."""
    if t.shape != ref.shape:
        raise ValueError(f"a checkpoint leaf of shape {tuple(t.shape)} where this rank "
                         f"holds {tuple(ref.shape)}")
    return t.to(device=ref.device, dtype=ref.dtype)


def _gather_state(state: TrainState, mesh, cfg) -> Optional[TrainState]:
    """The logical TrainState on the host of the mesh's rank 0 (None on the
    others): the tp shards of the params and moments gathered when ``cfg``
    is given.  Only dp row 0 gathers; the rows hold the same state."""
    if dist.get_rank() != 0 and (cfg is None or mesh.get_local_rank("dp") != 0):
        return None
    if cfg is None:
        return TrainState(*to_device(tuple(state), "cpu"))
    tp = tp_group(mesh)

    def full(tree):
        return all_gather_params(tree, cfg, tp, csm_param_specs(), dst=0)

    params, mu, nu = full(state.params), full(state.opt_state["mu"]), full(state.opt_state["nu"])
    if dist.get_rank() != 0:
        return None
    return TrainState(params, {"count": state.opt_state["count"].cpu(), "mu": mu, "nu": nu},
                      state.step.cpu())


def save_checkpoint(ckpt_dir: str, state: TrainState, mesh=None, cfg=None) -> str:
    """Write ``ckpt_dir/step_XXXXXXXX`` (through a temporary file, so a
    crash never leaves a partial checkpoint under that name) → its path.
    On a ``mesh`` every rank calls it and returns when rank 0 has written
    the logical state (module docstring)."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{int(state.step):08d}")
    if mesh is not None:
        state = _gather_state(state, mesh, cfg)
    if state is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_pytree(path + ".tmp", tuple(state))
        os.replace(path + ".tmp", path)
    if mesh is not None:
        dist.barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                   if (m := _STEP_NAME.match(name)))
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{steps[-1]:08d}")


def restore_checkpoint(path: str, like: TrainState, mesh=None, cfg=None) -> TrainState:
    """Restore a TrainState; ``like`` (from ``init_train_state``, or this
    rank's ``make_sharded_train_state``) gives the structure, shapes, dtypes
    and devices.  On a ``mesh`` with ``cfg`` the file's logical params and
    moments are cut to this rank's shards first.  ``step`` comes back as an
    int32 tensor."""
    if mesh is not None and cfg is not None:
        params, opt_state, step = load_pytree(path)

        def shard(tree):
            return shard_params(tree, mesh, cfg, csm_param_specs())

        opt_state = {"count": opt_state["count"], "mu": shard(opt_state["mu"]),
                     "nu": shard(opt_state["nu"])}
        params, opt_state = tree_map(_like, (like.params, like.opt_state),
                                     (shard(params), opt_state))
    else:
        params, opt_state, step = load_pytree(path, tuple(like))
        params, opt_state = tree_map(lambda t, ref: t.to(ref.device), (params, opt_state),
                                     (like.params, like.opt_state))
    return TrainState(params=params, opt_state=opt_state,
                      step=step.to(device=like.step.device, dtype=torch.int32))
