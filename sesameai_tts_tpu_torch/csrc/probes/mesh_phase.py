"""chip_smoke.py's tp = 2 shard-shape kernel rows and ``main[mesh]`` phase
alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/mesh_phase.py [--no-shards] [--no-mesh]

Builds the kernels, holds ``quant_matmul``, ``quant_mlp`` and
``flash_attention`` against their plain versions at one rank's shard shapes
of a tp = 2 mesh (``chip_smoke.phase_shards``), then runs
``chip_smoke.phase_mesh`` (CSM-1B int8 on two processes that share the one
card over gloo: a tp = 2 Generator against the single-process one, a
dp = 2 BatchedTTSServer against a one-process pool).  About four minutes
with the build.  Needs a card; not part of the package's build or tests.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import attention, kernels, quant  # noqa: E402

if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = cs.phase_device(torch)
    peak_bw, peak_flops = cs._peaks(name)
    cs.phase_build(kernels)
    if "--no-shards" not in sys.argv:
        t0 = time.time()
        cs.phase_shards(torch, quant, attention, peak_bw, peak_flops)
        print(f"tp2 shards phase {time.time() - t0:.1f} s", flush=True)
    if "--no-mesh" not in sys.argv:
        wrappers = {n: getattr(attention if n.startswith("flash_attention") else quant, n)
                    for n in kernels.KERNELS}
        t0 = time.time()
        result = cs.phase_mesh(torch, wrappers, card)
        print(f"main[mesh] phase {time.time() - t0:.1f} s", flush=True)
        print(json.dumps(result["launches"]), flush=True)
    print(card, flush=True)
