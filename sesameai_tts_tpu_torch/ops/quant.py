"""Weight-only int8 quantization and the int8 dequant-matmul kernel
(port of ``sesameai_tts_tpu/ops/quant.py``).

A quantized weight is the dict ``{"q": int8 (in, out), "scale": f32
(out,)}``, a drop-in leaf of the per-layer trunk dicts.  Single-stream AR
decode streams every trunk weight once per step, so int8 halves the bytes
the decode moves; ``quant_matmul`` reads the int8 weight straight from
device memory and never materializes a bf16 copy of it.

``quant_matmul`` launches the CUDA kernel in ``csrc/quant_matmul.cu`` for
a CUDA tensor and runs ``quant_matmul_plain`` (the same arithmetic as
torch ops) for a CPU tensor.  The library is built with ``nvcc`` into the
checkout's ``build/`` directory at first use, so importing this module
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import Union

import torch
import torch.nn.functional as F_

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "quant_matmul.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIBRARY = _BUILD_DIR / "quant_matmul.so"
_COLS_PER_BLOCK = 512  # csrc/quant_matmul.cu COLS_PER_BLOCK
_MIN_SPLIT_ROWS = 32  # fewest weight rows one block reduces over
_BLOCKS_PER_SM = 8  # blocks of the partial-sum kernel aimed at per SM

_lib = None
_lib_lock = threading.Lock()


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., in, out) float → {"q": int8, "scale": f32 (..., out)}."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 127.0  # per output channel
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _dequant(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (w["q"].float() * w["scale"][..., None, :]).to(dtype)


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------


def build_kernel() -> ctypes.CDLL:
    """Compile ``csrc/quant_matmul.cu`` for sm_90a (once) and load it."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        stale = (
            not _LIBRARY.exists()
            or _LIBRARY.stat().st_mtime < _SOURCE.stat().st_mtime
        )
        if stale:
            from torch.utils.cpp_extension import CUDA_HOME

            if CUDA_HOME is None:
                raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                os.path.join(CUDA_HOME, "bin", "nvcc"),
                "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-o", str(tmp), str(_SOURCE),
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, _LIBRARY)  # atomic: a concurrent loader sees old or new
        lib = ctypes.CDLL(str(_LIBRARY))
        lib.quant_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        lib.quant_matmul.restype = ctypes.c_int
        _lib = lib
        return lib


def _s_tile(S: int) -> int:
    return 1 if S == 1 else 2 if S == 2 else 4 if S <= 4 else 8


def _splits(S: int, D: int, F: int, sms: int):
    """(splits, rows_per_split): split the reduction over D across blocks
    until the partial-sum grid has about ``_BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs, keeping at least ``_MIN_SPLIT_ROWS`` rows per block.
    Every split is non-empty."""
    tiles = math.ceil(F / _COLS_PER_BLOCK) * math.ceil(S / _s_tile(S))
    want = math.ceil(sms * _BLOCKS_PER_SM / tiles)
    splits = max(1, min(want, D // _MIN_SPLIT_ROWS))
    rows = math.ceil(D / splits)
    rows = math.ceil(rows / 8) * 8
    return math.ceil(D / rows), rows


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic as torch ops: bf16(x) @ bf16(q) with f32
    accumulation (bf16 × bf16 products are exact in f32), × scale in f32,
    cast to x.dtype.  For the CPU tests and the on-card comparison."""
    acc = x.to(torch.bfloat16).float() @ q.to(torch.bfloat16).float()
    return (acc * scale.float()).to(x.dtype)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (S, D) bf16|f32 @ dequant(q (D, F) int8, scale (F,) f32) → (S, F)
    in x.dtype.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``quant_matmul_plain``.  ``quant_matmul.launches`` counts launches."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(
            f"quant_matmul: want x (S, D), q (D, F), scale (F,); got "
            f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}"
        )
    S, D = x.shape
    D2, F = q.shape
    if D2 != D or scale.shape[0] != F:
        raise ValueError(
            f"quant_matmul: shape mismatch x {tuple(x.shape)}, q {tuple(q.shape)}, "
            f"scale {tuple(scale.shape)}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8 or (
        scale.dtype != torch.float32
    ):
        raise TypeError(
            f"quant_matmul: want x bf16|f32, q int8, scale f32; got "
            f"{x.dtype}, {q.dtype}, {scale.dtype}"
        )
    if q.device != x.device or scale.device != x.device:
        raise ValueError("quant_matmul: x, q and scale must be on one device")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul: x, q and scale must be contiguous")
    if F % 8 != 0 or S * F >= 2**31:
        raise ValueError(f"quant_matmul: need F % 8 == 0 and S*F < 2^31 (S={S}, F={F})")
    lib = build_kernel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, rows = _splits(S, D, F, sms)
    y = torch.empty((S, F), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, S, F), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), ws.data_ptr(),
        S, D, F, splits, rows, _s_tile(S), int(x.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def qdot(x: torch.Tensor, w: Union[torch.Tensor, dict]) -> torch.Tensor:
    """Matmul against a maybe-quantized weight. x: (..., in); w: (in, out)
    tensor or int8 dict.

    On the card every quantized product goes to the ``quant_matmul``
    kernel.  On the CPU it is the JAX package's CPU branch, ``x @
    dequant(w, x.dtype)``, so the CPU tests compare like with like.

    Precision contract (as in the JAX package): the kernel computes bf16
    activations × bf16-dequantized weights with f32 accumulation; an f32
    caller gets f32 back, not f32 dot precision.
    """
    if not is_quantized(w):
        return x @ w
    if x.device.type == "cuda":
        lead = x.shape[:-1]
        D = x.shape[-1]
        F = w["q"].shape[-1]
        out = quant_matmul(x.reshape(-1, D).contiguous(), w["q"], w["scale"])
        return out.reshape(*lead, F)
    return x @ _dequant(w, x.dtype)


def qmlp(x: torch.Tensor, w13, w2) -> torch.Tensor:
    """SwiGLU MLP against maybe-quantized weights: silu(x@W1)·(x@W3) @ W2,
    as two ``qdot``s (the JAX package's default, unfused sequence)."""
    a = qdot(x, w13)
    F = a.shape[-1] // 2
    gate = F_.silu(a[..., :F].float()).to(x.dtype)
    return qdot(gate * a[..., F:], w2)


# ---------------------------------------------------------------------------
# Parameter-tree helpers
# ---------------------------------------------------------------------------

_TRUNK_QUANT_KEYS = ("qkv", "o_proj", "w13", "w2")


def dequantize_csm(params: dict, dtype=torch.bfloat16) -> dict:
    """Materialize dense trunks from a quantized tree once (the prefill
    shadow: long prefills are compute-bound and run as a plain forward).
    Non-trunk leaves are shared by reference."""

    def deq_leaf(w):
        return _dequant(w, dtype) if is_quantized(w) else w

    def deq_trunk(trunk):
        return {
            "layers": tuple({k: deq_leaf(v) for k, v in wl.items()} for wl in trunk["layers"]),
            "final_norm": trunk["final_norm"],
        }

    out = dict(params)
    out["backbone"] = deq_trunk(params["backbone"])
    out["decoder"] = deq_trunk(params["decoder"])
    return out


def quantize_trunk(trunk_params: dict, bits: int = 8) -> dict:
    """Quantize qkv, o_proj, w13 and w2 of every layer to int8."""
    if bits != 8:
        raise ValueError("only per-channel int8 (bits=8) is ported")
    layers = []
    for wl in trunk_params["layers"]:
        wl = dict(wl)
        for k in _TRUNK_QUANT_KEYS:
            wl[k] = quantize_weight(wl[k])
        layers.append(wl)
    return {"layers": tuple(layers), "final_norm": trunk_params["final_norm"]}


def quantize_csm(params: dict, backbone: bool = True, decoder: bool = True,
                 bits: int = 8) -> dict:
    """Quantize the trunks; embeddings and the small per-frame heads stay
    in the model dtype."""
    out = dict(params)
    if backbone:
        out["backbone"] = quantize_trunk(params["backbone"], bits)
    if decoder:
        out["decoder"] = quantize_trunk(params["decoder"], bits)
    return out
