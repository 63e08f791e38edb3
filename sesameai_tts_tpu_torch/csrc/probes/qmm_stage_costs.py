"""What each stage of quant_matmul's tensor-core kernel costs, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmm_stage_costs.py

Builds copies of ``csrc/quant_matmul.cu`` under ``build/qmm_stages/``, each
with one stage of ``qmm_mma`` taken out (the products, the int8 -> bf16
conversion, the x staging, the B fragments' shared loads, the weight
loads), and times every copy's ``quant_matmul_mma`` at a few flagship
shapes and plans by CUDA events over launches that cycle the weight past
L2.  A copy computes garbage; only its time is read.  The time a stage
saves when it is taken out bounds what it costs.  Needs a card and nvcc;
not part of the package's build or tests.
"""
import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, HERE)
import torch  # noqa: E402
from sesameai_tts_tpu_torch.ops import quant  # noqa: E402

SRC = os.path.join(HERE, "sesameai_tts_tpu_torch", "csrc", "quant_matmul.cu")
OUT = os.path.join(HERE, "build", "qmm_stages")
# (label, text of the stage in qmm_mma, what takes its place)
CUTS = [
    ("no mma", "        for (int n = 0; n < NT; ++n) mma_bf16(acc[j][n], a, b[n][0], b[n][1]);",
     "        for (int n = 0; n < NT; ++n) acc[j][n][0] += __uint_as_float(a[0] & b[n][0]);"),
    ("no conversion", None, None),  # filled below: the a[4] initializer
    ("no x staging", "    if (c < chunks) {\n      const int c0 = k_begin + c * KC;",
     "    if (c < 0) {\n      const int c0 = k_begin + c * KC;"),
    ("no B loads",
     "        const uint2 v = *reinterpret_cast<const uint2*>(xc + (8 * n + gid) * XS + 16 * k + 4 * t);",
     "        const uint2 v = make_uint2(gid * 977u + n, t * 131u + k);"),
    ("no weight loads",
     "      if (active && r < k_end) v = __ldg(reinterpret_cast<const R*>(q + static_cast<size_t>(r) * F + f));",
     "      if (active && r < 0) v = __ldg(reinterpret_cast<const R*>(q + static_cast<size_t>(r) * F + f));"),
]
# (shape, D, F, S, mt, nt, wk, splits)
CASES = [
    ("decoder.w13", 1024, 16384, 8, 4, 1, 4, 1),
    ("backbone.w2", 8192, 2048, 8, 4, 1, 4, 8),
    ("decoder.w13", 1024, 16384, 64, 2, 8, 1, 2),
    ("backbone.w2", 8192, 2048, 64, 2, 8, 1, 8),
    ("decoder.o_proj", 1024, 1024, 64, 2, 8, 1, 8),
]


def variants():
    src = open(SRC).read()
    start = src.index("        const uint32_t a[4] = {bf16_pair(int8_f32(fl[0], byte)")
    conv = src[start:src.index("};", start) + 2]
    out = {"base": src}
    for label, old, new in CUTS:
        if label == "no conversion":
            old, new = conv, "        const uint32_t a[4] = {fl[0], fl[1], fl[2], fl[3]};"
        if old not in src:
            raise SystemExit(f"{label}: the stage's text is not in {SRC}")
        out[label] = src.replace(old, new)
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    jobs = {}
    for label, text in variants().items():
        name = label.replace(" ", "_")
        with open(os.path.join(OUT, f"{name}.cu"), "w") as f:
            f.write(text)
        jobs[label] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-diag-suppress", "177", "-o",
             os.path.join(OUT, f"{name}.so"), os.path.join(OUT, f"{name}.cu")])
    fns = {}
    for label, proc in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"{label}: nvcc failed")
        fn = getattr(ctypes.CDLL(os.path.join(OUT, f"{label.replace(' ', '_')}.so")),
                     "quant_matmul_mma")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, D, F, S, mt, nt, wk, want in CASES:
        qs = [torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(max(2, math.ceil(160e6 / (D * F))))]
        scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.empty((S, F), dtype=torch.bfloat16, device="cuda")
        rows = math.ceil(math.ceil(D / want) / 16) * 16
        splits = math.ceil(D / rows)
        smem = quant._qmm_mma_smem(S, mt, nt, wk, splits)
        times = []
        for label, fn in fns.items():
            def run(i):
                err = fn(x.data_ptr(), qs[i % len(qs)].data_ptr(), scale.data_ptr(), y.data_ptr(),
                         S, D, F, splits, rows, mt, nt, wk, smem, 1, stream)
                if err:
                    raise SystemExit(f"{label}: launch failed, CUDA error {err}")
            for i in range(3):
                run(i)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(60):
                run(i)
            end.record()
            end.synchronize()
            times.append(f"{label} {start.elapsed_time(end) / 60 * 1e3:.2f}")
        print(f"{shape} S={S} (mt, nt, wk)={(mt, nt, wk)} splits={splits} us: "
              + " | ".join(times), flush=True)


if __name__ == "__main__":
    main()
