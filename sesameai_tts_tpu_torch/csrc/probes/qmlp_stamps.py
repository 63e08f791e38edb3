"""Where one quant_mlp launch spends its time, block by block, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_stamps.py

Copies csrc/quant_mlp.cu to build/qmlp_stamps/ with a %globaltimer stamp
written by thread 0 of every block at seven points (start, h done, the w2
tile in shared memory, the w2 partial, the cluster's sum written, out of
the grid barrier, end), builds it with nvcc and launches it at S = 1 with
ops/quant.py's geometry for the backbone's and the decoder's MLP (weights
cycled past L2) and for a call with D = 16 and 8 output columns (the fixed
costs).  Prints, per point, the earliest, median and latest block in µs
after the first block started.  The package's source holds no stamps.
Needs a card and nvcc; not part of the package's build or tests.
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

POINTS = ("start", "h done", "w2 tile in", "w2 partial", "cluster sum written",
          "grid barrier out", "end")
# (statement of quant_mlp.cu, point, stamp before or after it)
MARKS = (
    ("  if (csize > 1) cluster_arrive_relaxed();", 0, "after"),
    ("  // ---- phase 2: the w2 tile", 1, "before"),
    ("  mbar_wait(bar, 0);", 2, "after"),
    ("  if (csize > 1) cluster_wait();", 3, "before"),
    ("  grid_barrier(barrier);", 4, "before"),
    ("  grid_barrier(barrier);", 5, "after"),
)


def stamp(i):
    return f"if (threadIdx.x == 0) g_stamps[blockIdx.x * 8 + {i}] = global_ns();\n"


src = open(os.path.join(here, "sesameai_tts_tpu_torch/csrc/quant_mlp.cu")).read()
src = src.replace("namespace cg = cooperative_groups;",
                  "namespace cg = cooperative_groups;\n__device__ unsigned long long g_stamps[8 * 2048];",
                  1)
for text, i, where in MARKS:
    assert text in src, f"quant_mlp.cu no longer has {text!r}"
    src = src.replace(text, stamp(i) + text if where == "before" else text + "\n" + stamp(i), 1)
end = src.rindex("}", 0, src.index("// The most clusters of"))  # the kernel's last brace
src = src[:end] + stamp(6) + src[end:]
src += ('\nextern "C" int qmlp_read_stamps(void* host) {\n'
        '  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')
out = os.path.join(here, "build", "qmlp_stamps")
os.makedirs(out, exist_ok=True)
cu, so = os.path.join(out, "quant_mlp.cu"), os.path.join(out, "quant_mlp.so")
with open(cu, "w") as f:
    f.write(src)
subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
lib = ctypes.CDLL(so)
launch = lib.quant_mlp
launch.argtypes = kernels._SIGNATURES["quant_mlp"]
launch.restype = ctypes.c_int

name, card = cs.phase_device(torch)
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(0)
for label, D, F, Dout in (("backbone.mlp", 2048, 8192, 2048), ("decoder.mlp", 1024, 8192, 1024),
                          ("fixed costs (D=16, Dout=8)", 16, 8192, 8)):
    q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
    q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
    copies = cs._copies(2 * D * F + F * Dout)
    mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
    s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3
    s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2
    x = torch.randn((1, D), generator=gen, device="cuda").to(torch.bfloat16)
    block_i, cluster, threads, rows, smem = quant._qmlp_geometry(1, D, F, Dout, sms)
    part, word = quant._qmlp_workspace(x.device, quant._qmlp_parts(F, Dout, block_i, cluster))
    y = torch.empty((1, Dout), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for i in range(2 * copies):
        a, b = mats[i % copies]
        err = launch(x.data_ptr(), a.data_ptr(), s13.data_ptr(), b.data_ptr(), s2.data_ptr(),
                     y.data_ptr(), part.data_ptr(), word.data_ptr(), D, F, Dout, block_i,
                     cluster, threads, rows, smem, stream)
        assert err == 0, f"launch failed: CUDA error {err}"
    torch.cuda.synchronize()
    want = quant.quant_mlp_plain(x, a, s13, b, s2).float()
    ok = bool(((y.float() - want).abs() <= 1e-2 * want.abs() + 1e-3 * want.abs().max()).all())
    host = np.zeros(8 * 2048, np.uint64)
    assert lib.qmlp_read_stamps(host.ctypes.data_as(ctypes.c_void_p)) == 0
    blocks = F // block_i
    ns = host[: blocks * 8].reshape(blocks, 8)[:, : len(POINTS)].astype(np.int64)
    us = (ns - ns[:, 0].min()) / 1e3
    print(f"{label}: {blocks} blocks, geometry {(block_i, cluster, threads, rows, smem)}, "
          f"last launch within tolerance {ok}")
    for i, point in enumerate(POINTS):
        print(f"   {point:20s} min {us[:, i].min():7.2f}  median {np.median(us[:, i]):7.2f}  "
              f"max {us[:, i].max():7.2f} us")
    del mats
    torch.cuda.empty_cache()
print(card)
