"""chip_smoke.py's ``main[apps]`` phase alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/apps_phase.py

Builds the kernels and a warmed CSM-1B int8 Generator (bf16 Mimi, random
weights from seed 0), then runs ``chip_smoke.phase_apps`` on it: chat,
storyteller and four duplex turns over a loopback LLM/STT server, the
streaming Mimi encode against the offline one, the native audio backend.
Prints its lines, about two minutes with the build.  Needs a card; not part
of the package's build or tests.
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
gen, _ = cs._build_generator(torch, "apps", {})
t0 = time.time()
cs.phase_apps(torch, wrappers, gen, card)
print(f"main[apps] phase {time.time() - t0:.1f} s", flush=True)
print(card, flush=True)
