"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Every kernel is a CUDA C++ source with a plain C entry point of the same
name (and, for a kernel with a second route, a second entry point).  ``build_kernels`` compiles each for ``sm_90a`` with ``nvcc`` into
the checkout's git-ignored ``build/torch_kernels/`` (one ``nvcc`` per
source, all started together) and loads it with ``ctypes``; ``launch``
calls an entry point and raises on a non-zero CUDA error; ``count_launch``
adds to a wrapper's ``launches`` count, safely across threads, and
``wrappers`` maps each kernel to its wrapper.  Nothing
here runs when the module is imported, so importing it needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point → its argument types (pointers, ints, floats, stream)
_SIGNATURES = {
    "quant_matmul": [_P] * 4 + [_I] * 8 + [_P],
    "quant_matmul_mma": [_P] * 4 + [_I] * 10 + [_P],
    "quant4_matmul": [_P] * 4 + [_I] * 8 + [_P],
    "quant4_matmul_mma": [_P] * 4 + [_I] * 11 + [_P],
    "quant_mlp": [_P] * 8 + [_I] * 8 + [_P],
    "quant_mlp_mma": [_P] * 9 + [_I] * 13 + [_P],
    "flash_attention": [_P] * 6 + [_I] * 15 + [_P],
    "flash_attention_bwd": [_P] * 12 + [_I] * 21 + [_P],
    "topk_sample": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "expert_swiglu": [_P] * 11 + [_I] * 5 + [_P],
}
# entry points that live in another kernel's source (a second route)
_SOURCE_OF = {"quant_matmul_mma": "quant_matmul", "quant4_matmul_mma": "quant4_matmul",
              "quant_mlp_mma": "quant_mlp"}
# the kernels: one source and one wrapper each
KERNELS = tuple(name for name in _SIGNATURES if name not in _SOURCE_OF)
# the ops module (ops/<module>.py) of each kernel's wrapper, if not quant
_MODULE_OF = {"flash_attention": "attention", "flash_attention_bwd": "attention",
              "topk_sample": "sampling", "expert_swiglu": "moe"}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
# seconds each kernel's nvcc took in this process (kernels built from source)
build_seconds: Dict[str, float] = {}
# the wrappers' launch counts are read-modify-written by every thread that
# launches (serving decodes on one thread while it admits on another)
_count_lock = threading.Lock()
_recording = threading.local()


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
            name for name in KERNELS
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
        for name in KERNELS:
            _libs[name] = ctypes.CDLL(str(_library(name)))
        for entry, argtypes in _SIGNATURES.items():
            fn = getattr(_libs[_SOURCE_OF.get(entry, entry)], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return _libs


def wrappers() -> Dict[str, Callable]:
    """{kernel name: its wrapper}, whose ``launches`` count its launches."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"sesameai_tts_tpu_torch.ops.{_MODULE_OF.get(name, 'quant')}"), name) for name in KERNELS}


def launch(entry: str, *args) -> None:
    """Call the C entry point ``entry``; a non-zero CUDA error raises."""
    err = getattr(build_kernels()[_SOURCE_OF.get(entry, entry)], entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def count_launch(wrapper: Callable, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper.launches``; inside this thread's
    ``recording()`` they go to the recording instead."""
    counts = getattr(_recording, "counts", None)
    if counts is not None:
        counts[wrapper] = counts.get(wrapper, 0) + n
        return
    with _count_lock:
        wrapper.launches += n


@contextlib.contextmanager
def recording() -> Iterator[Dict[Callable, int]]:
    """Collect this thread's ``count_launch`` calls in a dict instead of the
    wrappers' counts (a CUDA-graph capture records launches; other threads
    keep counting theirs)."""
    prev = getattr(_recording, "counts", None)
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = prev


def check_operands(name: str, tensors: dict, device: torch.device) -> None:
    """Every operand on ``device`` and contiguous, else ValueError."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
