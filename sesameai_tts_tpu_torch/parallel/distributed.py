"""Multi-host bootstrap: ``torch.distributed`` + a global mesh (port of
``sesameai_tts_tpu/parallel/distributed.py``).

What a multi-card deployment needs from the framework is the bootstrap:
join the process group, then build ONE global ('dp', 'tp') mesh over every
rank with 'tp' inside a host (tensor-parallel traffic stays on NVLink) and
'dp' spanning hosts (batch-parallel traffic crosses them).  One process
per card, as ``torchrun --nproc-per-node N`` starts them.

Single-process use never calls this.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sesameai_tts_tpu_torch.parallel.mesh import make_mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group.

    With no arguments, reads torchrun's environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK); otherwise rendezvous at
    ``tcp://<coordinator_address>`` as rank ``process_id`` of
    ``num_processes``.  The backend is ``nccl`` where a card is visible and
    ``gloo`` on the CPU; ranks that share one card pass ``backend="gloo"``
    themselves (NCCL refuses two ranks on one device).  No-op for an
    explicit single-process spec."""
    if num_processes == 1:
        return
    if (coordinator_address is None) != (process_id is None):
        raise ValueError(
            "coordinator_address and process_id must be given together "
            "(or both omitted for torchrun's environment)"
        )
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        kw = {} if num_processes is None else {"world_size": num_processes}
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def global_serving_mesh(tp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """('dp','tp') mesh over ALL ranks.

    'tp' groups stay within a host: ranks are numbered host by host
    (torchrun), so consecutive groups of ``tp`` ranks are local as long as
    ``tp`` divides the ranks per host (``LOCAL_WORLD_SIZE``, default the
    world)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if tp > per_host or per_host % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the ranks per host {per_host} "
            "so tensor-parallel collectives stay inside a host"
        )
    if world % tp != 0:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    return make_mesh(dp=world // tp, tp=tp, device_type=device_type)
