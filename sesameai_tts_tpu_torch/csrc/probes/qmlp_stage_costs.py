"""What each stage of quant_mlp's tensor-core route costs, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_stage_costs.py

Builds copies of ``csrc/quant_mlp.cu`` under ``build/qmlp_stages/``, each
with one stage of ``qmlp_mma`` taken out (the products, the weights' or
the activations' copies into the ring, phase 2, the grid barriers) or
changed (one thread waits on a stage's mbarrier, no watchdog timer in the
waits), and
times every copy's ``quant_mlp_mma`` at the flagship MLPs by CUDA-graph
replay over launches that cycle the weights past L2, at the current
plan.  A copy computes garbage; only its time is read.  The time a stage saves when it is taken out bounds what it
costs.  Needs a card and nvcc; not part of the package's build or tests.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, HERE)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels, quant  # noqa: E402

SRC = os.path.join(HERE, "sesameai_tts_tpu_torch", "csrc", "quant_mlp.cu")
OUT = os.path.join(HERE, "build", "qmlp_stages")
# (label, text of the stage in qmlp_mma, what takes its place)
CUTS = [
    ("no mma",
     "          for (int n = 0; n < NT; ++n) mma_bf16(acc[h][j][n], af, bf[n][0], bf[n][1]);",
     "          for (int n = 0; n < NT; ++n) acc[h][j][n][0] += __uint_as_float(af[0] & bf[n][0]);"),
    ("no weight copies",
     "      mbar_expect_tx(bar, static_cast<uint32_t>(n * rb));\n      tensor_copy(dst, w.map, w.x0,",
     "      mbar_expect_tx(bar, 0u);\n      if (r0 < 0) tensor_copy(dst, w.map, w.x0,"),
    ("no activation copies", "      stage_rows(reinterpret_cast<__nv_bfloat16*>(st + a_bytes), xst, b,",
     "      if (S < 0) stage_rows(reinterpret_cast<__nv_bfloat16*>(st + a_bytes), xst, b,"),
    ("no phase 2", "  if (b < col_tiles * splits) {", "  if (b < col_tiles * splits && S < 0) {"),
    ("no grid barriers", "  grid_barrier(barrier);\n\n  // ---- phase 2",
     "\n\n  // ---- phase 2"),
    ("one waiter", "    if (w.map != nullptr) mbar_wait(",
     "    if (w.map != nullptr && threadIdx.x == 0) mbar_wait("),
    ("no timer in waits", "    if (!done && global_ns() - start > WATCHDOG_NS) __trap();\n  }\n}",
     "  }\n}"),
]
CASES = [("backbone.mlp", 2048, 8192, 2048, S) for S in (2, 8, 64)] + [
    ("decoder.mlp", 1024, 8192, 1024, S) for S in (8, 64)]


def variants():
    src = open(SRC).read()
    out = {"base": src}
    for label, old, new in CUTS:
        if old not in src:
            raise SystemExit(f"{label}: the stage's text is not in {SRC}")
        out[label] = src.replace(old, new)
    # the second grid barrier too
    out["no grid barriers"] = out["no grid barriers"].replace(
        "  grid_barrier(barrier);\n\n  // ---- y:", "\n\n  // ---- y:")
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
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", os.path.join(OUT, f"{name}.so"),
             os.path.join(OUT, f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for label, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{label}: nvcc failed\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "qmlp_mma" in line or "spill" in line]
        print(label, "|", " ".join(spills[-6:]) if label == "base" else "", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"{label.replace(' ', '_')}.so"))
        lib.quant_mlp_mma.argtypes = kernels._SIGNATURES["quant_mlp_mma"]
        lib.quant_mlp_mma.restype = ctypes.c_int
        libs[label] = lib
    name, card = cs.phase_device(torch)
    kernels.build_kernels(force=True)
    own = kernels._libs["quant_mlp"]
    sms = quant._sms(torch.device("cuda"))
    plan_of = quant._qmlp_mma_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, D, F, Dout, S in CASES:
        q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
        q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
        s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3 + 1e-4
        s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = cs._copies(2 * D * F + F * Dout)
        mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
        plan = plan_of(S, D, F, Dout, sms)
        row = {}
        for label, lib in libs.items():
            kernels._libs["quant_mlp"] = lib
            try:
                row[label] = round(cs._device_ms(torch, lambda i: quant.quant_mlp(
                    x, mats[i % copies][0], s13, mats[i % copies][1], s2),
                    max(copies, 20)) * 1e3, 2)
            finally:
                kernels._libs["quant_mlp"] = own
        print(f"{card} {shape} S={S} {plan} us: {row}", flush=True)
        del mats, q13, q2
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
