#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sesameai_tts_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and ``nvcc``; exits non-zero without them.
Phases, each of which fails the run if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel of the main path from ``csrc/``;
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes, timed beside the plain version, one library call
   and the card's bound;
4. main path: CSM-1B int8 with a bf16 Mimi, random weights from a seed,
   three requests (offline, streamed, voice context) through the
   Generator; the launch counts show the path went through the kernels;
5. slice parity: the tiny f32 model, greedy, on the card equals the CPU.

Prints a JSON line of kernel results, then on its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# peak device-memory rate (bytes/s) and dense bf16 tensor rate (FLOP/s) by
# card name (NVIDIA data sheets)
_PEAKS = (
    ("H200", 4.8e12, 989e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100", 3.35e12, 989e12),
)

# the decode-time trunk linears, (name, D, F, launches per decoded frame):
# the backbone runs 16 layers once, the decoder 4 layers 32 times
_FLAGSHIP_SHAPES = (
    ("backbone.qkv", 2048, 3072, 16),
    ("backbone.o_proj", 2048, 2048, 16),
    ("backbone.w13", 2048, 16384, 16),
    ("backbone.w2", 8192, 2048, 16),
    ("decoder.qkv", 1024, 1536, 128),
    ("decoder.o_proj", 1024, 1024, 128),
    ("decoder.w13", 1024, 16384, 128),
    ("decoder.w2", 8192, 1024, 128),
)
_S_VALUES = (1, 8, 64)
# kernel vs plain: both accumulate bf16 products in f32, in another order,
# and round to bf16, so they may differ by one bf16 ulp (<= 2^-7 relative)
# plus f32 rounding noise of the sum
_RTOL = 1e-2
_ATOL_OF_PEAK = 1e-3

TEXT_1 = "Hello from the port. This sentence is spoken by random weights."
TEXT_2 = "And this one continues in the same voice."
AUDIO_MS = 3000


class PhaseError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    raise PhaseError(f"no peak rates known for card {name!r}")


def phase_device(torch):
    _check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return name


def phase_build(quant):
    quant._LIBRARY.unlink(missing_ok=True)  # always build from the checkout's source
    t0 = time.perf_counter()
    quant.build_kernel()
    print(f"build: quant_matmul in {time.perf_counter() - t0:.2f} s", flush=True)


def _events_ms(torch, run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _eager_ms(torch, fn, reps: int) -> float:
    """Mean time per call of fn(i) issued from Python, by CUDA events: the
    device's time when it is the bottleneck, else the host's."""
    fn(0)
    torch.cuda.synchronize()
    return _events_ms(torch, lambda: [fn(i) for i in range(reps)]) / reps


def _device_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Mean device time per call of fn(i): reps calls captured in one CUDA
    graph and replayed, so host overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms / (replays * reps)


def phase_kernels(torch, quant, peak_bw, peak_flops):
    """quant_matmul vs quant_matmul_plain at every flagship shape.  Timed
    over enough weight copies to overflow the 50 MB L2, as on the decode
    path, where each frame streams 4.5 GB of weights."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, D, F, per_frame in _FLAGSHIP_SHAPES:
        q = torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = max(2, math.ceil(160e6 / (D * F)))
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        w = quant._dequant({"q": q, "scale": scale}, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        for S in _S_VALUES:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            got = quant.quant_matmul(x, q, scale)
            want = quant.quant_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            peak = want.float().abs().max().item()
            ok = bool((diff <= _RTOL * want.float().abs() + _ATOL_OF_PEAK * peak).all())
            reps = max(copies, 20)
            kernel = lambda i: quant.quant_matmul(x, qs[i % copies], scale)  # noqa: E731
            plain = lambda i: quant.quant_matmul_plain(x, qs[i % copies], scale)  # noqa: E731
            library = lambda i: torch.matmul(x, ws[i % copies])  # noqa: E731
            kernel_ms = _device_ms(torch, kernel, reps)
            plain_ms = _device_ms(torch, plain, min(reps, 8))
            library_ms = _device_ms(torch, library, reps)
            kernel_eager_ms = _eager_ms(torch, kernel, reps)
            nbytes = D * F + 2 * S * D + 2 * S * F + 4 * F
            bound_ms = max(nbytes / peak_bw, 2 * S * D * F / peak_flops) * 1e3
            row = {
                "shape": name, "S": S, "D": D, "F": F, "per_frame": per_frame,
                "max_abs_err": diff.max().item(), "peak_abs": peak, "ok": ok,
                "kernel_ms": kernel_ms, "kernel_eager_ms": kernel_eager_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": "bytes" if nbytes / peak_bw >=
                2 * S * D * F / peak_flops else "operations",
            }
            rows.append(row)
            print("kernel " + json.dumps(row), flush=True)
            _check(ok, f"quant_matmul disagrees with its plain version at {name} S={S}: "
                       f"max abs err {row['max_abs_err']} (peak {peak})")
        del qs, ws, w, q
        torch.cuda.empty_cache()
    return rows


def phase_main_path(torch, quant):
    import numpy as np

    from sesameai_tts_tpu_torch.runtime.frames import Segment
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    t0 = time.perf_counter()
    gen = build_generator(csm_1b_spec(), device="cuda")
    torch.cuda.synchronize()
    print(f"main: built CSM-1B int8 + bf16 Mimi in {time.perf_counter() - t0:.1f} s", flush=True)
    # warm-up (cuBLAS/cuDNN handles, allocator): not counted
    gen.generate("warm up", 0, [], max_audio_length_ms=240, temperature=0.8, topk=40, seed=7)
    torch.cuda.synchronize()

    sr = gen.sample_rate
    gen.metrics.reset()
    quant.quant_matmul.launches = 0
    t0 = time.perf_counter()
    offline = gen.generate(TEXT_1, 0, [], max_audio_length_ms=AUDIO_MS, temperature=0.8,
                           topk=40, seed=0)
    t_offline = time.perf_counter() - t0

    t0 = time.perf_counter()
    first_chunk_s, chunks = None, []
    for chunk in gen.generate_stream(TEXT_1, 0, [], max_audio_length_ms=AUDIO_MS,
                                     temperature=0.8, topk=40, seed=0):
        if first_chunk_s is None:
            first_chunk_s = time.perf_counter() - t0
        chunks.append(chunk)
    t_stream = time.perf_counter() - t0
    streamed = np.concatenate(chunks)

    t0 = time.perf_counter()
    ctx = gen.precompute_context_state([Segment(0, TEXT_1, offline)])
    voiced = gen.generate(TEXT_2, 0, [], max_audio_length_ms=AUDIO_MS, temperature=0.8,
                          topk=40, cached_context=ctx, seed=1)
    t_voice = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = quant.quant_matmul.launches

    summary = gen.metrics.summary()
    decoded = int(summary["decoded_frames"]["total"])
    decode_s = summary["decode_s"]["total"]
    rel = float(np.abs(streamed - offline).max() / max(np.abs(offline).max(), 1e-12)) \
        if streamed.shape == offline.shape else float("inf")
    result = {
        "frames": {"offline": offline.size // gen._hop, "stream": streamed.size // gen._hop,
                   "voice": voiced.size // gen._hop, "decoded": decoded},
        "audio_s": {"offline": offline.size / sr, "stream": streamed.size / sr,
                    "voice": voiced.size / sr},
        "rtf": {"offline": t_offline / (offline.size / sr), "stream": t_stream / (streamed.size / sr),
                "voice": t_voice / (voiced.size / sr)},
        "first_chunk_ms": first_chunk_s * 1e3,
        "ms_per_decoded_frame": decode_s / decoded * 1e3,
        # where the three requests' wall time went; the rest is host-side
        # tokenization and the voice context's backbone pass
        "wall_s": t_offline + t_stream + t_voice,
        "breakdown_s": {k: summary[k]["total"] for k in ("prefill_s", "decode_s", "codec_s",
                                                         "encode_s") if k in summary},
        "quant_matmul_launches": launches,
        "stream_vs_offline_rel_err": rel,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("main " + json.dumps(result), flush=True)
    for name, pcm in (("offline", offline), ("stream", streamed), ("voice", voiced)):
        _check(pcm.size > 0 and bool(np.isfinite(pcm).all()), f"{name} PCM empty or not finite")
    _check(launches == 576 * decoded,
           f"quant_matmul launched {launches} times for {decoded} decoded frames "
           f"(want 576 per frame)")
    # same seed ⇒ same frames; the PCM then differs only by the bf16
    # rounding of chunked vs whole-utterance codec convolutions
    _check(streamed.shape == offline.shape and rel < 5e-2,
           f"streamed != offline: shapes {streamed.shape} vs {offline.shape}, rel err {rel}")
    print("profile " + json.dumps(_profile_decode(torch, gen)), flush=True)
    del gen
    torch.cuda.empty_cache()
    return result, launches


def _profile_decode(torch, gen) -> dict:
    """Device busy share and kernel mix of one short request (prefill + 9
    decoded frames) under torch.profiler; after the counted run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_frames(TEXT_2, 0, [], max_audio_length_ms=800, temperature=0.8, topk=40,
                            seed=2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    if not kernels:
        return {"window": "prefill + 9 decoded frames", "device_time": "not measured",
                "wall_ms_profiled": wall_ms}

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    qmm = sum(dev_us(e) for e in kernels if "qmm_" in e.key) / 1e3
    return {
        "window": "prefill + 9 decoded frames, profiled",
        "wall_ms_profiled": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "quant_matmul_device_ms": qmm,
        "top": [[e.key[:70], dev_us(e) / 1e3, e.count] for e in top],
    }


def phase_parity(torch):
    import numpy as np

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    outs = {}
    for device in ("cpu", "cuda"):
        gen = build_generator(test_tiny_spec(), device=device, decode_chunk_frames=4)
        frames = gen.generate_frames("the quick brown fox jumps", 0, [],
                                     max_audio_length_ms=1200, temperature=1.0, topk=1)
        outs[device] = (frames, gen.decode_audio(frames))
    (f_cpu, a_cpu), (f_gpu, a_gpu) = outs["cpu"], outs["cuda"]
    err = float(np.abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else float("inf")
    peak = float(np.abs(a_cpu).max())
    result = {"frames": int(f_cpu.shape[0]), "frames_equal": bool(np.array_equal(f_cpu, f_gpu)),
              "pcm_max_abs_err": err, "pcm_peak": peak}
    print("parity " + json.dumps(result), flush=True)
    _check(result["frames_equal"], "tiny greedy frames differ between cuda and cpu")
    # f32 with TF32 off: only the order of sums differs
    _check(err <= 1e-4 * max(peak, 1.0), f"tiny PCM differs between cuda and cpu: {err}")
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from sesameai_tts_tpu_torch.ops import quant
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script: {e}", file=sys.stderr)
        return 1
    if not os.path.abspath(quant.__file__).startswith(HERE + os.sep):
        print("chip_smoke: the port package was not imported from this checkout", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        name = phase_device(torch)
        peak_bw, peak_flops = _peaks(name)
        phase_build(quant)
        rows = phase_kernels(torch, quant, peak_bw, peak_flops)
        _, launches = phase_main_path(torch, quant)
        phase_parity(torch)
    except Exception as e:  # any phase failing fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # one entry per kernel; its times are the sum over one decoded frame's
    # launches at the main path's S=1, the per-shape rows beside them
    main_rows = [r for r in rows if r["S"] == 1]

    def per_frame(key):
        return sum(r[key] * r["per_frame"] for r in main_rows)

    entry = {
        "name": "quant_matmul",
        "route": "cuda",
        "source": "sesameai_tts_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "sesameai_tts_tpu/ops/quant.py:135",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_frame("kernel_ms"),
        "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": "bytes",
        "library_ms": per_frame("library_ms"),
        "timed_as": "device time (CUDA graph replay, weights past L2) summed over one "
                    "decoded frame's 576 launches at S=1",
        "shapes": [{k: r[k] for k in ("shape", "S", "D", "F", "kernel_ms", "kernel_eager_ms",
                                      "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
                   for r in rows],
    }
    entry["max_err"] = entry["max_abs_err"]
    entry["kernel_ms"] = entry["ms"]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
