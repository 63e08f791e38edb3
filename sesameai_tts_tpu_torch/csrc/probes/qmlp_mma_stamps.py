"""Where one launch of quant_mlp's tensor-core route spends its time, block
by block, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_mma_stamps.py

Copies csrc/quant_mlp.cu to build/qmlp_mma_stamps/ with a %globaltimer
stamp written by thread 0 of every block at ten points of ``qmlp_mma``
(start; phase 1's first ring stage in, its products done, h written; out
of the first grid barrier; phase 2's first stage in, its products done, its
partial written; out of the second grid barrier; end), builds it with nvcc
and launches it through ``ops/quant.py::quant_mlp`` with the current plan at
the flagship MLPs, S = 8 and 64, weights cycled past L2.  Prints, per
point, the earliest, median and latest block in µs after the first block
started.  The package's source holds no stamps.  Needs a card and nvcc;
not part of the package's build or tests.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np

here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, here)
import torch  # noqa: E402
from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels, quant  # noqa: E402

POINTS = ("start", "p1 first stage in", "p1 products", "h written", "barrier 1 out",
          "p2 first stage in", "p2 products", "partial written", "barrier 2 out", "end")
SLOTS = 10
# (statement of quant_mlp.cu's qmlp_mma, point, stamp before or after it)
MARKS = (
    ("  constexpr int sp = 8 * NT;\n  if (threadIdx.x == 0) {", 0, "after-line"),
    ("      mma_walk<NT>(acc, w, col, x, D, 0, S, wk, wk_n, kc1, region, bars, stages);", 2,
     "after"),
    ("  grid_barrier(barrier);\n\n  // ---- phase 2", 3, "before"),
    ("  // ---- phase 2: h @ the block's w2 tile", 4, "before"),
    ("    mma_walk<NT>(acc, w, col, hbuf, F, ks * rows, S, wk, wk_n, kc2, region, bars, stages);",
     6, "after"),
    ("  grid_barrier(barrier);\n\n  // ---- y:", 7, "before"),
    ("  // ---- y: the splits' partials", 8, "before"),
)
FIRST_STAGE = "    __syncthreads();  // stage c is in, and every warp is done with stage c - 1\n"


def stamp(i, cond="threadIdx.x == 0"):
    return f"if ({cond}) g_stamps[blockIdx.x * {SLOTS} + {i}] = global_ns();\n"


src = open(os.path.join(here, "sesameai_tts_tpu_torch/csrc/quant_mlp.cu")).read()
src = src.replace("namespace cg = cooperative_groups;",
                  "namespace cg = cooperative_groups;\n"
                  f"__device__ unsigned long long g_stamps[{SLOTS} * 1024];", 1)
for text, i, where in MARKS:
    assert text in src, f"quant_mlp.cu no longer has {text!r}"
    if where == "after-line":
        head, tail = text.split("\n", 1)
        src = src.replace(text, head + "\n" + stamp(i) + tail, 1)
    else:
        src = src.replace(text, stamp(i) + text if where == "before" else text + "\n" + stamp(i),
                          1)
assert FIRST_STAGE in src
src = src.replace(FIRST_STAGE, FIRST_STAGE + stamp(1, "threadIdx.x == 0 && c == 0 && b_ld == D_")
                  + stamp(5, "threadIdx.x == 0 && c == 0 && b_ld != D_"), 1)
src = src.replace("uint64_t* bars, int& stages) {", "uint64_t* bars, int& stages, int D_) {", 1)
src = src.replace("region, bars, stages);", "region, bars, stages, D);")
end = src.rindex("}", 0, src.index("// libcuda's cuTensorMapEncodeTiled"))  # qmlp_mma's
src = src[:end] + stamp(9) + src[end:]
src += ('\nextern "C" int qmlp_read_stamps(void* host) {\n'
        '  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')
out = os.path.join(here, "build", "qmlp_mma_stamps")
os.makedirs(out, exist_ok=True)
cu, so = os.path.join(out, "quant_mlp.cu"), os.path.join(out, "quant_mlp.so")
with open(cu, "w") as f:
    f.write(src)
subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
lib = ctypes.CDLL(so)
lib.quant_mlp_mma.argtypes = kernels._SIGNATURES["quant_mlp_mma"]
lib.quant_mlp_mma.restype = ctypes.c_int

name, card = cs.phase_device(torch)
kernels.build_kernels()
kernels._libs["quant_mlp"] = lib
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(0)
for label, D, F, Dout in (("backbone.mlp", 2048, 8192, 2048), ("decoder.mlp", 1024, 8192, 1024)):
    q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
    q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
    copies = cs._copies(2 * D * F + F * Dout)
    mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
    s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3
    s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2
    for S in (8, 64):
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
        for i in range(2 * copies):
            a, b = mats[i % copies]
            y = quant.quant_mlp(x, a, s13, b, s2)
        torch.cuda.synchronize()
        want = quant.quant_mlp_plain(x, a, s13, b, s2).float()
        ok = bool(((y.float() - want).abs() <= 1e-2 * want.abs() + 1e-3 * want.abs().max())
                  .all())
        host = np.zeros(SLOTS * 1024, np.uint64)
        assert lib.qmlp_read_stamps(host.ctypes.data_as(ctypes.c_void_p)) == 0
        plan = quant._qmlp_mma_plan(S, D, F, Dout, sms)
        blocks = F // plan.block_i
        ns = host[: blocks * SLOTS].reshape(blocks, SLOTS).astype(np.int64)
        us = (ns - ns[:, 0].min()) / 1e3
        print(f"{label} S={S}: {blocks} blocks, {plan}, last launch within tolerance {ok}")
        for i, point in enumerate(POINTS):
            print(f"   {point:18s} min {us[:, i].min():7.2f}  median {np.median(us[:, i]):7.2f}  "
                  f"max {us[:, i].max():7.2f} us")
    del mats
    torch.cuda.empty_cache()
print(card)
