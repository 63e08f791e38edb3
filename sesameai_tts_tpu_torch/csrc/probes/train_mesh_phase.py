"""chip_smoke.py's ``flash_attention_bwd`` kernel phase and ``main[train_mesh]``
phase alone, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/train_mesh_phase.py [--no-kernels]

Builds the kernels, holds ``flash_attention_bwd`` against its plain version
at the training shapes, one tp = 2 rank's heads among them
(``chip_smoke.phase_flash_attention_bwd``), then runs
``chip_smoke.phase_train_mesh`` (``sesame-tts-torch-finetune --mesh`` at
CSM-1B full width on two processes that share the one card over gloo: dense
at dp 1, tp 2 against one card, LoRA at dp 2 against one process, the
gathered export served) and prints the backward kernel's line as
``chip_smoke.py`` prints it.  About four minutes with the build.  Needs a
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
from sesameai_tts_tpu_torch.ops import kernels  # noqa: E402

if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = cs.phase_device(torch)
    peak_bw, peak_flops = cs._peaks(name)
    cs.phase_build(kernels)
    rows = None
    if "--no-kernels" not in sys.argv:
        t0 = time.time()
        rows = cs.phase_flash_attention_bwd(torch, attention, peak_bw, peak_flops,
                                            next(f for key, f in cs._F32_FLOPS if key in name))
        print(f"flash_attention_bwd phase {time.time() - t0:.1f} s", flush=True)
    wrappers = kernels.wrappers()
    t0 = time.time()
    result = cs.phase_train_mesh(torch, wrappers, card)
    print(f"main[train_mesh] phase {time.time() - t0:.1f} s", flush=True)
    if rows is not None:
        entry = cs._bwd_entry(rows, {"train": result["launches"],
                                     "train_mesh": result["launches"]}, csm_1b())
        print(json.dumps(entry["tp2"]), flush=True)
    print(card, flush=True)
