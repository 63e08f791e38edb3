"""chip_smoke.py's ``main[serve]`` phase alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/serve_phase.py

Builds the kernels, then runs ``chip_smoke.phase_serve`` (CSM-1B int8, an
8-slot ``BatchedTTSServer``, in-process traffic, the HTTP API, the pool's
graphs against the eager step) and prints its lines, about a minute.
Needs a card; not part of the package's build or tests.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import attention, kernels, quant  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.time()
kernels.build_kernels()
print(f"kernels built in {time.time() - t0:.1f} s {kernels.build_seconds}", flush=True)
_, card = cs.phase_device(torch)
wrappers = {n: getattr(attention if n.startswith("flash_attention") else quant, n) for n in kernels.KERNELS}
t0 = time.time()
cs.phase_serve(torch, wrappers, card)
print(f"main[serve] phase {time.time() - t0:.1f} s", flush=True)
print(card, flush=True)
