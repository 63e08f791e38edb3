"""chip_smoke.py's ``main[smoke]`` phase alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/smoke_phase.py

Builds the kernels, then runs ``chip_smoke.phase_smoke``: the silentcipher
network at the real grid (card against CPU, stream against offline), then
the real-weights rehearsal (``fixtures.write_synthetic_weights(tmp,
"csm-1b")`` → ``smoke.main(["--weights-dir", tmp])``), and prints its lines.
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
cs.phase_smoke(torch, wrappers, card)
print(f"main[smoke] phase {time.time() - t0:.1f} s", flush=True)
print(card, flush=True)
