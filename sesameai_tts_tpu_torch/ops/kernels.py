"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Every kernel is a CUDA C++ source with a plain C entry point of the same
name.  ``build_kernels`` compiles each for ``sm_90a`` with ``nvcc`` into
the checkout's git-ignored ``build/torch_kernels/`` (one ``nvcc`` per
source, all started together) and loads it with ``ctypes``; ``launch``
calls an entry point and raises on a non-zero CUDA error.  Nothing here
runs when the module is imported, so importing it needs neither ``nvcc``
nor a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name → the C entry point's argument types (pointers, ints, stream)
_SIGNATURES = {
    "quant_matmul": [_P] * 4 + [_I] * 9 + [_P],
    "quant4_matmul": [_P] * 4 + [_I] * 9 + [_P],
    "quant_mlp": [_P] * 8 + [_I] * 10 + [_P],
    "flash_attention": [_P] * 6 + [_I] * 15 + [_P],
}
KERNELS = tuple(_SIGNATURES)

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
# seconds each kernel's nvcc took in this process (kernels built from source)
build_seconds: Dict[str, float] = {}


def _library(name: str) -> Path:
    return _BUILD_DIR / f"{name}.so"


def build_kernels(force: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` for sm_90a (once; ``force`` rebuilds
    from the checkout's sources) and load them.  The ``nvcc`` runs start
    together, one per source.  → {kernel name: library}."""
    with _lib_lock:
        if _libs and not force:
            return _libs
        stale = [
            name for name in _SIGNATURES
            if force or not _library(name).exists()
            or _library(name).stat().st_mtime < (_CSRC / f"{name}.cu").stat().st_mtime
        ]
        if stale:
            from torch.utils.cpp_extension import CUDA_HOME

            if CUDA_HOME is None:
                raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            jobs = {}
            for name in stale:
                tmp = _library(name).with_suffix(f".{os.getpid()}.tmp")
                cmd = [
                    os.path.join(CUDA_HOME, "bin", "nvcc"),
                    "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(tmp), str(_CSRC / f"{name}.cu"),
                ]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
                jobs[name] = (proc, tmp, time.perf_counter())
            failed = []
            for name, (proc, tmp, t0) in jobs.items():
                out, err = proc.communicate()
                build_seconds[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}\n{err}")
                else:
                    os.replace(tmp, _library(name))  # atomic: a loader sees old or new
            if failed:
                raise RuntimeError("\n".join(failed))
        for name, argtypes in _SIGNATURES.items():
            lib = ctypes.CDLL(str(_library(name)))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; a non-zero CUDA error raises."""
    err = getattr(build_kernels()[name], name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def check_operands(name: str, tensors: dict, device: torch.device) -> None:
    """Every operand on ``device`` and contiguous, else ValueError."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
