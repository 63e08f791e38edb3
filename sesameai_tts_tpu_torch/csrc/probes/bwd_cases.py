"""Every ``flash_attention_bwd`` case of ``chip_smoke.py`` and a few more
shapes, on the card, reported case by case instead of stopping at the first
that fails.

    python3 sesameai_tts_tpu_torch/csrc/probes/bwd_cases.py

Builds the kernels, then for each case in bf16 and f32 prints the dkdv
cluster size (``_bwd_splits``), each gradient's largest ratio of its error
to ``chip_smoke._BWD_TOL``'s bound (a case passes below 1), whether a
repeated call is bit-equal, whether a row that sees no key gets exact
zeros, and the call's device time (CUDA-graph replay).  The extra shapes
cover G = 1, 3 and 16, a window after a cached context, hd 16 with ragged
tiles and clusters of 4 and 8.  About a minute after the build.  Needs a
card; not part of the package's build or tests.
"""
import os
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import attention as ta  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels  # noqa: E402

# (label, B, H, KV, hd, S, valid_end per row, T, pos0 per row)
EXTRA = (
    ("G=1 after a context", 1, 4, 4, 64, 40, (70,), 100, (30,)),
    ("G=16", 1, 16, 1, 64, 20, (20,), 20, (0,)),
    ("tiny hd16 ragged", 2, 4, 2, 16, 37, (37, 30), 37, (0, 0)),
    ("G=3 after a context", 1, 6, 2, 64, 50, (100,), 130, (60,)),
    ("splits 8", 1, 4, 1, 64, 512, (512,), 64, (0,)),
    ("splits 8 hd128 padded", 1, 4, 1, 128, 512, (300,), 64, (0,)),
    ("splits 4 hd16", 1, 4, 1, 16, 256, (256,), 128, (0,)),
)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    kernels.build_kernels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(label, B, H, KV, hd, S, ve, S, (0,) * B)
             for label, B, H, KV, hd, S, ve in cs._BWD_CASES] + list(EXTRA)
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol_of_peak = cs._BWD_TOL[str(dtype).split(".")[-1]]
        for label, B, H, KV, hd, S, valid_end, T, pos0 in cases:
            try:
                def randn(*shape):
                    return torch.randn(shape, generator=gen, device="cuda").to(dtype)

                q = randn(B, S, H, hd).transpose(1, 2)
                k, v = randn(B, KV, T, hd), randn(B, KV, T, hd)
                p0 = torch.tensor(pos0, device="cuda")
                ve = torch.tensor(valid_end, device="cuda")
                o = ta.flash_attention(q, k, v, p0, ve)
                do = randn(B, S, H, hd).transpose(1, 2)
                got = ta.flash_attention_bwd(q, k, v, o, do, p0, ve)
                want = ta.flash_attention_bwd_plain(q, k, v, o, do, p0, ve)
                again = ta.flash_attention_bwd(q, k, v, o, do, p0, ve)
                torch.cuda.synchronize()
                ratios = []
                for g, w in zip(got, want):
                    w = w.float()
                    bound = rtol * w.abs() + atol_of_peak * w.abs().max()
                    ratios.append(round(float(((g.float() - w).abs() / bound).max()), 3))
                equal = all(torch.equal(x, y) for x, y in zip(got, again))
                zero = all(not g[b].any() for g in got for b, e in enumerate(valid_end) if e <= 0)
                ms = cs._device_ms(torch, lambda i: ta.flash_attention_bwd(q, k, v, o, do, p0, ve),
                                   10)
                print(f"splits {ta._bwd_splits(B, KV, S, T, H // KV, sms)} {label:30s} "
                      f"{str(dtype)[6:]:9s} gate {ratios} bit_equal {equal} zero {zero} "
                      f"ms {ms:.4f}", flush=True)
            except Exception:  # report and go on to the next case
                print(f"{label} {dtype} raised:\n{traceback.format_exc()[-1500:]}", flush=True)
                torch.cuda.synchronize()


if __name__ == "__main__":
    main()
