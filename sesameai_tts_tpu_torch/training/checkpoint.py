"""TrainState checkpoint/resume, step-numbered files (port of
``sesameai_tts_tpu/training/checkpoint.py``).

A checkpoint is the FULL ``TrainState`` (params, optimizer state, step) as
one ``save_pytree`` file ``<ckpt_dir>/step_XXXXXXXX``, so a resumed run
continues bit for bit where it stopped (momentum and schedule included).
The JAX package writes an orbax directory of the same name.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from sesameai_tts_tpu_torch.convert import tree_map
from sesameai_tts_tpu_torch.core.weights import load_pytree, save_pytree
from sesameai_tts_tpu_torch.training.train_step import TrainState

_STEP_NAME = re.compile(r"^step_(\d{8,})$")  # :08d widens past 8 digits


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write ``ckpt_dir/step_XXXXXXXX`` (through a temporary file, so a
    crash never leaves a partial checkpoint under that name) → its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{int(state.step):08d}")
    save_pytree(path + ".tmp", tuple(state))
    os.replace(path + ".tmp", path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                   if (m := _STEP_NAME.match(name)))
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{steps[-1]:08d}")


def restore_checkpoint(path: str, like: TrainState) -> TrainState:
    """Restore a TrainState; ``like`` (from ``init_train_state``) gives the
    structure, shapes, dtypes and devices.  ``step`` comes back as an int32
    tensor."""
    params, opt_state, step = load_pytree(path, tuple(like))
    params, opt_state = tree_map(lambda t, ref: t.to(ref.device), (params, opt_state),
                                 (like.params, like.opt_state))
    return TrainState(params=params, opt_state=opt_state,
                      step=step.to(device=like.step.device, dtype=torch.int32))
