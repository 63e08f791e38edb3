"""chip_smoke.py's ``flash_attention_bwd`` kernel phase and ``main[train]``
phase alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/train_phase.py [--no-train]

Builds the kernels, holds ``flash_attention_bwd`` against its plain version
at the training shapes (``chip_smoke.phase_flash_attention_bwd``), then
runs ``chip_smoke.phase_train`` (CSM-1B full width: a mixed full finetune,
an interrupted LoRA run resumed against an unbroken one, the export served,
the tiny step card against CPU) and prints the kernel's line as
``chip_smoke.py`` prints it.  About two minutes with the build.  Needs a
card; not part of the package's build or tests.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.core.config import csm_1b  # noqa: E402
from sesameai_tts_tpu_torch.ops import attention, kernels, quant  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
name, card = cs.phase_device(torch)
peak_bw, peak_flops = cs._peaks(name)
cs.phase_build(kernels)
t0 = time.time()
rows = cs.phase_flash_attention_bwd(torch, attention, peak_bw, peak_flops,
                                    next(f for key, f in cs._F32_FLOPS if key in name))
print(f"flash_attention_bwd phase {time.time() - t0:.1f} s", flush=True)
if "--no-train" not in sys.argv:
    wrappers = {n: getattr(attention if n.startswith("flash_attention") else quant, n)
                for n in kernels.KERNELS}
    t0 = time.time()
    result = cs.phase_train(torch, wrappers, card)
    print(f"main[train] phase {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(cs._bwd_entry(rows, {"train": result["full"]["launches"]}, csm_1b())),
          flush=True)
print(card, flush=True)
