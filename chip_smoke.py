#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sesameai_tts_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and ``nvcc``; exits non-zero without them.
Phases, each of which fails the run if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel in ``csrc/`` (one ``nvcc`` per source, all
   started together) and print each build's time;
3. kernels vs plain: ``quant_matmul``, ``quant4_matmul``, ``quant_mlp``
   and ``flash_attention`` against their plain PyTorch versions at the
   main paths' shapes (and the tensor-core prefill at hd 128), eagerly
   and from a CUDA-graph replay, a repeated call and the replay bit-equal
   to the first call, each timed beside its plain version, a library
   yardstick and the card's bound (``quant_mlp`` also beside the port's
   unfused int8 pair: two ``quant_matmul`` calls around the silu and
   product);
4. main paths, CSM-1B at full width with a bf16 Mimi and random weights
   from a seed, one configuration at a time: int8 trunks (offline,
   streamed and voice-context requests), int4 trunks and the fused int8
   MLP (offline and streamed each), and the voice-preload path (int8: two
   ~16 s 44.1 kHz stereo reference clips through the voice registry and
   ``prepare_voice_context`` into a 512-row context prefill, offline and
   streamed requests from the cached context, one rolling-context turn).
   Each Generator is warmed up first (``Generator.warmup``: the decode
   step's CUDA graphs are captured then), so every decoded frame is a
   graph replay.  Exact launch counts, added by the replays, show that
   each path went through its kernels.  Then, on each path, the graphs
   against the eager step (``csm.generate_frame`` + ``csm.decode_frames``)
   on the card: greedy and seeded frames bit-equal, a second (temperature,
   topk) on the same graphs bit-equal, a clone with another chunk size
   giving the same frames without new weight memory; and the same
   requests on an eager twin of the Generator, timed beside the graphed
   ones.  Then each configuration's profiled windows (device busy share,
   kernel mix), graphed and eager, the graphed step's device time by CUDA
   events and the sampler's threshold search alone.  Before the profiled
   windows, ``main[cli]``: the command line from files (a 6.2 GB CSM-1B
   checkpoint written and read back bit-equal, a Llama-3-format
   tokenizer.json, a Mimi ``save_pytree`` file, a voice) speaks two
   sentences into a watermarked WAV; its launches, the WAV, the watermark
   and greedy frames against a Generator built in memory are checked.
   Then ``main[serve]``: an 8-slot ``BatchedTTSServer`` over CSM-1B int8
   (``phase_serve``: 12 in-process sessions with exact launches and PCM
   equal to the offline decode of their frames, the HTTP API with the
   streaming watermark and a burst answered 429, the pool's graphed tick
   bit-equal to the eager step, no graph captured after ``start()``).
   Then ``main[smoke]`` (``phase_smoke``): the silentcipher network at the
   real grid (44.1 kHz, n_fft 2048, hop 512, 5 × 256, hidden 32) on a 12.6 s
   clip, encode and phase-shift decode on the card against the CPU and the
   streaming embed against the offline one; then the real-weights rehearsal,
   ``sesame-tts-torch-fixtures`` files of CSM-1B → ``sesame-tts-torch-smoke
   --weights-dir`` (convert, load int8, generate, quant gate, codec, the
   network's watermark, /tts and /tts/stream), exit code 0, the network's
   streaming blocks on the card, quant_matmul and flash_attention launched;
5. QA at full width: teacher-forced agreement of the int4 generator with
   the dense twin of its own tree, and of the fused generator with the
   unfused one, against thresholds; the int8 and int4 acceptance reports
   against the bf16 tree, as information;
6. slice parity: the tiny f32 model, greedy, on the card equals the CPU.

Prints the card's name and power limit, a JSON line of kernel results,
then on its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
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
# int4 scale groups: the trunks' default G = 2 (half-matrix groups) at
# every shape, and G = D/128 (group = 128) at two of them
_INT4_FINE_GROUPS = ("backbone.w13", "decoder.w2")
# the decode-time MLPs, (name, D, F, Dout, launches per decoded frame)
_MLP_SHAPES = (
    ("backbone.mlp", 2048, 8192, 2048, 16),
    ("decoder.mlp", 1024, 8192, 1024, 128),
)
# every S tile of the three quant kernels (1, 2, 4, 8): S = 1 is the
# single-stream decode, S = 2 the rehearsal's 2-slot serving pool, S = 8 the
# 8-slot pool, S = 64 the widest qdot sends to a kernel
_S_VALUES = (1, 2, 4, 8, 64)
# kernel vs plain: both accumulate exact bf16 x integer products in f32, in
# another order, and round to bf16, so they may differ by one bf16 ulp
# (<= 2^-7 relative) plus f32 rounding noise of the sum; in quant_mlp a few
# hidden values may round to the neighbouring bf16 value, each moving the
# output by a fraction of one of its F terms, well inside the same bound
_RTOL = 1e-2
_ATOL_OF_PEAK = 1e-3

TEXT_1 = "Hello from the port. This sentence is spoken by random weights."
TEXT_2 = "And this one continues in the same voice."
AUDIO_MS = 2000
# the graph checks: 12 frames each, (label, temperature, topk, seed); the
# captured graphs read the sampling parameters from buffers, so the second
# sampled request runs on the graphs the first one used
GRAPH_CHECK_MS = 960
GRAPH_CHECKS = (("greedy", 1.0, 1, 0), ("sampled", 0.8, 40, 5), ("second_sampling", 0.6, 20, 6))
GRAPH_STEP_FRAMES = 16  # frames of the graphed step timed by CUDA events, from a 600-row cache

# the main paths: ModelSpec fields, kernel launches per decoded frame, and
# whether the voice-context request runs
_PATHS = (
    ("int8", {}, {"quant_matmul": 576, "quant4_matmul": 0, "quant_mlp": 0}, True),
    ("int4", {"quantize": "int4"}, {"quant_matmul": 0, "quant4_matmul": 576, "quant_mlp": 0},
     False),
    ("fused", {"fused_mlp": True}, {"quant_matmul": 288, "quant4_matmul": 0, "quant_mlp": 144},
     False),
)

# flash_attention phase: (label, B, H, KV, hd, T, S, pos0 per row, valid_len
# per row).  Backbone H 32 / KV 8 / hd 64 over its 2048-slot cache, decoder
# H 8 / KV 2 / hd 128 over its fresh 32-slot cache of each frame
_ATTN_CASES = (
    ("backbone prefill S=512 (context)", 1, 32, 8, 64, 2048, 512, (0,), (500,)),
    ("backbone prefill S=64 (utterance)", 1, 32, 8, 64, 2048, 64, (500,), (64,)),
    ("backbone decode pos 0", 1, 32, 8, 64, 2048, 1, (0,), (1,)),
    ("backbone decode pos 63", 1, 32, 8, 64, 2048, 1, (63,), (1,)),
    ("backbone decode pos 64", 1, 32, 8, 64, 2048, 1, (64,), (1,)),
    ("backbone decode pos 600", 1, 32, 8, 64, 2048, 1, (600,), (1,)),
    ("backbone decode pos 1023", 1, 32, 8, 64, 2048, 1, (1023,), (1,)),
    ("backbone decode pos 2047", 1, 32, 8, 64, 2048, 1, (2047,), (1,)),
    ("backbone decode B=2 pos 100 / 1900", 2, 32, 8, 64, 2048, 1, (100, 1900), (1, 1)),
    ("backbone decode B=2, row 0 valid_len 0", 2, 32, 8, 64, 2048, 1, (0, 900), (0, 1)),
    ("decoder step pos 0", 1, 8, 2, 128, 32, 1, (0,), (1,)),
    ("decoder step pos 31", 1, 8, 2, 128, 32, 1, (31,), (1,)),
    ("backbone prefill S=64, row 1 valid_len 0", 2, 32, 8, 64, 2048, 64, (0, 0), (40, 0)),
    ("backbone prefill S=768 (rolling turn)", 1, 32, 8, 64, 2048, 768, (0,), (628,)),
    # a serving pool of 8 slots: every row at its own position (mean 600)
    ("backbone decode B=8, pos 100-1100", 8, 32, 8, 64, 2048, 1,
     (100, 250, 400, 550, 650, 800, 950, 1100), (1,) * 8),
    ("decoder step B=8 pos 0", 8, 8, 2, 128, 32, 1, (0,) * 8, (1,) * 8),
    ("decoder step B=8 pos 31", 8, 8, 2, 128, 32, 1, (31,) * 8, (1,) * 8),
    # not on a main path: the tensor-core prefill at hd 128
    ("prefill hd 128", 1, 8, 2, 128, 32, 16, (0,), (16,)),
)
_FRAME_CACHE_FILL = 600  # the backbone cache fill of the per-frame sum
# flash_attention vs plain, bf16: the kernel rounds exp(s - m) at its
# running max to bf16 before the PV product (as the TPU kernel does), the
# plain version rounds the normalized probability.  Either moves a weight
# by at most 2^-9 of itself, so the outputs, convex combinations of v's
# rows, differ by at most 2^-8 max|v|; one bf16 rounding of the output is
# inside the 1e-2 relative term
_ATTN_ATOL_OF_VMAX = 2.0 ** -8

VOICE_CLIP_S = 16.0  # two reference clips of this length at 44.1 kHz stereo
VOICE_TRANSCRIPTS = (
    "The first reference clip holds a calm voice.",
    "A second clip adds more of the same speaker.",
)
TEXT_3 = "The rolling context keeps the voice and the dialog."

# main[cli]: the command line's two sentences, each capped at CLI_MAX_MS (random
# weights rarely end a sentence early, so each is about that long); the greedy
# check's cap.  Each sentence is marked on its own grid, as in the JAX package,
# so a decode of the whole WAV finds one sentence's mark among the other's
# audio: on one H100 80GB HBM3 at 700 W two 12.6 s clips verified alone at
# 7.0 / 6.6 and the WAV at 3.87 (threshold 4; the JAX package's checker reads
# the same file the same way).  Each sentence's stretch of the WAV is checked.
CLI_SENTENCES = ("The command line reads its weights from files.",
                 "Then it speaks with the voice it was given.")
CLI_MAX_MS = 12_000
GREEDY_MS = 1600

# main[serve]: BatchedTTSServer(slots=8, chunk_frames=10, max_pending=32) at
# CSM-1B width.  In-process traffic, 12 sessions against 8 slots, (budget ms,
# temperature, topk): 4 interactive (2 s) and 8 bulk (6 s), two at topk=1;
# SERVE_CANCEL is cancelled after its first chunk, SERVE_LONG_PROMPT's prompt
# leaves SERVE_ROOM rows of KV cache, fewer than a tick's frames
SERVE_SLOTS, SERVE_CHUNK, SERVE_MAX_PENDING = 8, 10, 32
SERVE_SESSIONS = (
    (2000, 1.0, 1), (2000, 0.8, 40), (2000, 0.7, 20), (2000, 0.9, 5),
    (6000, 1.0, 1), (6000, 0.8, 40), (6000, 0.6, 10), (6000, 0.8, 30),
    (6000, 0.9, 50), (6000, 0.7, 40), (6000, 0.8, 20), (6000, 1.0, 3),
)
SERVE_CANCEL, SERVE_LONG_PROMPT, SERVE_ROOM = 5, 11, 9
SERVE_STREAM_MS = 8000  # the streamed HTTP responses (>= 4 s verify)
SERVE_BURST = 64  # /tts requests at once against max_pending=32 with every slot busy

# main[smoke]: the silentcipher network at the real grid (SilentCipherConfig(),
# the fixture's hidden 32) on a SMOKE_CLIP_S clip made at 24 kHz and resampled
# to 44.1 kHz: 1,086 STFT frames, bucketed to 2,048.  Card against CPU: both run
# f32 convolutions (TF32 off) and FFTs of other libraries; the residual's
# bound is 1e-3 of its peak and the decoded confidences' 1e-4 (the mean of
# 5 probabilities, each a softmax of bin-averaged logits).  The stream against
# the offline residual, both on the card: the JAX package's 5e-5 + 1e-3·max.
# Residuals are compared at gain 1 and at the 24 kHz that watermark() ships:
# above the carrier's ~12 kHz band the bins hold rounding noise, whose phase
# (spec / |spec|) each FFT library and batch size draws differently, so the
# network's residual there differs by ~20 % of its peak at 44.1 kHz (printed
# as full_band_*; csrc/probes/net_stages.py splits it by stage), and
# encode_wav's α, which divides by the residual's energy over the full band,
# by ~1e-3 (printed as alpha_card_over_cpu and encode_wav_resid_*).  So α is
# gated twice: the gain encode_wav applied on the card against the closed form
# sqrt(Σx² / Σresid²)·10^(-sdr/20) over the clip's n samples of its own unit
# residual, in f64 on the host (SMOKE_ALPHA_SELF_TOL: f32 sums and the
# y - x rounding), and against the CPU's α (SMOKE_ALPHA_CPU_TOL, 5x the
# noise-band reading of 9.9e-4; 0.05 dB of mark level).  alpha_bucket_fault
# prints what a sum over the bucket in place of n would give.
SMOKE_CLIP_S = 12.6
SMOKE_RESID_TOL = 1e-3
SMOKE_CONF_TOL = 1e-4
SMOKE_ALPHA_SELF_TOL = 1e-4
SMOKE_ALPHA_CPU_TOL = 5e-3

QA_TEXT = "Teacher forcing holds two generators to one trajectory of frames."
QA_STEPS = 32  # the gated pairs
QA_INFO_STEPS = 16  # the informational acceptance reports
# logit SNR floors of the two same-function pairs (see phase_qa).  On one
# H100 80GB HBM3 at 700 W the pairs measured 36.7 dB (int4, the same in two
# runs) and 38.6-38.7 dB (fused): bf16 rounding at other points of the same
# arithmetic.  A kernel fault (a wrong group scale, a lost nibble, a dropped
# tile) moves the logits by O(1) of their size, toward the 3.5 dB that int4
# weights give against the bf16 tree, so 30 dB keeps ~7 dB of margin below
# the measurements and far above any fault.
QA_MIN_SNR_DB = {"int4_vs_dense_twin": 30.0, "fused_vs_unfused": 30.0}


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return name, card


def phase_build(kernels):
    t0 = time.perf_counter()
    kernels.build_kernels(force=True)  # always build from the checkout's sources
    for name in kernels.KERNELS:
        print(f"build: {name} in {kernels.build_seconds[name]:.2f} s", flush=True)
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s (in parallel)", flush=True)


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


_SIDE_STREAM = []


def _side_stream(torch):
    """The one stream that every warm-up and capture below runs on: a
    buffer kept per stream, as quant_mlp's, is then made once, not per
    capture."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    return _SIDE_STREAM[0]


def _device_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Mean device time per call of fn(i): reps calls captured in one CUDA
    graph and replayed, so host overhead drops out."""
    side = _side_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms / (replays * reps)


def _copies(nbytes: int) -> int:
    """Weight copies to cycle through so that the timed loop streams past
    the 50 MB L2, as on the decode path (GBs of weights per frame)."""
    return max(2, math.ceil(160e6 / nbytes))


def _replayed(torch, fn):
    """fn(0)'s output from a CUDA-graph replay: a fault in a cluster's
    combine, or state that a launch leaves behind, shows only there."""
    side = _side_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(0)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    out = out.clone()
    del graph
    return out


def _measure(torch, label: str, row: dict, got, want, kernel, plain, library, copies: int,
             nbytes: float, flops: float, peak_bw: float, peak_flops: float,
             atol: float = None) -> dict:
    """Check got (and the output of a CUDA-graph replay of the same call)
    against want within the stated tolerance (``atol`` replaces the default
    absolute term), check that a second call and the replay give got's
    bits, time the kernel, its plain version and the library yardstick
    (None: not timed), and add the bound.  kernel(0) is got's call."""
    again = kernel(0)
    replayed = _replayed(torch, kernel)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    atol = _ATOL_OF_PEAK * peak if atol is None else atol
    tol = _RTOL * want.float().abs() + atol
    diff = (got.float() - want.float()).abs()
    replay_diff = (replayed.float() - want.float()).abs()
    ok = bool((diff <= tol).all()) and bool((replay_diff <= tol).all())
    deterministic = bool(torch.equal(again, got)) and bool(torch.equal(replayed, got))
    reps = max(copies, 20)
    t_bytes, t_ops = nbytes / peak_bw, flops / peak_flops
    row.update({
        "max_abs_err": diff.max().item(), "replay_max_abs_err": replay_diff.max().item(),
        "peak_abs": peak, "atol": atol, "ok": ok, "bit_equal_repeat_and_replay": deterministic,
        "kernel_ms": _device_ms(torch, kernel, reps),
        "kernel_eager_ms": _eager_ms(torch, kernel, reps),
        "plain_ms": _device_ms(torch, plain, min(reps, 8)),
        "library_ms": None if library is None else _device_ms(torch, library, reps),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    })
    print(f"kernel {label} " + json.dumps(row), flush=True)
    _check(ok, f"{label} disagrees with its plain version at {row}")
    _check(deterministic, f"{label}: a repeated or graph-replayed call changed the bits at {row}")
    return row


def phase_quant_matmul(torch, quant, peak_bw, peak_flops):
    """quant_matmul vs quant_matmul_plain at every flagship shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, D, F, per_frame in _FLAGSHIP_SHAPES:
        q = torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = _copies(D * F)
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        w = quant._dequant({"q": q, "scale": scale}, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        for S in _S_VALUES:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            vec, tpr, splits, _, s_tile = quant._qmm_geometry(S, D, F, quant._sms(x.device))
            blocks = splits * math.ceil(F / (vec * tpr)) * math.ceil(S / s_tile)
            rows.append(_measure(
                torch, "quant_matmul",
                {"shape": name, "S": S, "D": D, "F": F, "per_frame": per_frame,
                 "cluster": splits, "blocks": blocks},
                quant.quant_matmul(x, q, scale), quant.quant_matmul_plain(x, q, scale),
                lambda i: quant.quant_matmul(x, qs[i % copies], scale),
                lambda i: quant.quant_matmul_plain(x, qs[i % copies], scale),
                lambda i: torch.matmul(x, ws[i % copies]),
                copies, D * F + 2 * S * D + 2 * S * F + 4 * F, 2 * S * D * F,
                peak_bw, peak_flops))
        del qs, ws, w, q
        torch.cuda.empty_cache()
    return rows


def phase_quant4_matmul(torch, quant, peak_bw, peak_flops):
    """quant4_matmul vs quant4_matmul_plain at every flagship shape at the
    default G = 2, and at G = D/128 at two of them."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    cases = [(name, D, F, n, 2) for name, D, F, n in _FLAGSHIP_SHAPES]
    cases += [(name, D, F, n, D // 128) for name, D, F, n in _FLAGSHIP_SHAPES
              if name in _INT4_FINE_GROUPS]
    for name, D, F, per_frame, G in cases:
        q4 = torch.randint(-128, 128, (D // 2, F), generator=gen, device="cuda",
                           dtype=torch.int8)
        scale = torch.rand((G, F), generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = _copies(D * F // 2)
        q4s = [q4] + [q4.clone() for _ in range(copies - 1)]
        w = quant._dequant4({"q4": q4, "scale": scale}, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(_copies(2 * D * F) - 1)]
        for S in _S_VALUES:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            vec, tpr, splits, _, s_tile = quant._q4mm_geometry(S, D, F, G, quant._sms(x.device))
            blocks = splits * math.ceil(F / (vec * tpr)) * math.ceil(S / s_tile)
            rows.append(_measure(
                torch, "quant4_matmul",
                {"shape": name, "S": S, "D": D, "F": F, "G": G, "per_frame": per_frame,
                 "cluster": splits, "blocks": blocks},
                quant.quant4_matmul(x, q4, scale), quant.quant4_matmul_plain(x, q4, scale),
                lambda i: quant.quant4_matmul(x, q4s[i % copies], scale),
                lambda i: quant.quant4_matmul_plain(x, q4s[i % copies], scale),
                lambda i: torch.matmul(x, ws[i % len(ws)]),
                copies, D * F // 2 + 4 * G * F + 2 * S * D + 2 * S * F, 2 * S * D * F,
                peak_bw, peak_flops))
        del q4s, ws, w, q4
        torch.cuda.empty_cache()
    return rows


def phase_quant_mlp(torch, quant, peak_bw, peak_flops):
    """quant_mlp vs quant_mlp_plain at the backbone and decoder MLPs, with
    the launch geometry in each row.  The library yardstick is the dense
    bf16 SwiGLU sequence: three torch.matmul calls, silu and a product.  A
    second yardstick, ``unfused_ms``, is the port's own unfused int8 path on
    the same weights: two quant_matmul calls around the silu and product."""
    F_ = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, D, F, Dout, per_frame in _MLP_SHAPES:
        q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda",
                            dtype=torch.int8)
        q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
        s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3 + 1e-4
        s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2 + 1e-3
        weight_bytes = 2 * D * F + F * Dout
        copies = _copies(weight_bytes)
        mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
        w13 = quant._dequant({"q": q13, "scale": s13}, torch.bfloat16)
        w2 = quant._dequant({"q": q2, "scale": s2}, torch.bfloat16)
        dense = [(w13[:, :F].contiguous(), w13[:, F:].contiguous(), w2)]
        dense += [tuple(t.clone() for t in dense[0]) for _ in range(_copies(2 * weight_bytes) - 1)]
        del w13

        def library(i, x=None):
            w1, w3, w2_ = dense[i % len(dense)]
            return torch.matmul(F_.silu(torch.matmul(x, w1)) * torch.matmul(x, w3), w2_)

        for S in _S_VALUES:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            block_i, cluster, threads, prefetch, smem, _ = quant._qmlp_geometry(
                S, D, F, Dout, quant._sms(x.device))
            row = _measure(
                torch, "quant_mlp",
                {"shape": name, "S": S, "D": D, "F": F, "Dout": Dout, "per_frame": per_frame,
                 "block_i": block_i, "cluster": cluster, "blocks": F // block_i,
                 "threads": threads, "prefetch_rows": prefetch, "smem": smem},
                quant.quant_mlp(x, q13, s13, q2, s2), quant.quant_mlp_plain(x, q13, s13, q2, s2),
                lambda i: quant.quant_mlp(x, mats[i % copies][0], s13, mats[i % copies][1], s2),
                lambda i: quant.quant_mlp_plain(x, mats[i % copies][0], s13, mats[i % copies][1],
                                                s2),
                lambda i: library(i, x),
                copies, weight_bytes + 4 * (2 * F + Dout) + 2 * S * D + 2 * S * Dout,
                2 * S * (2 * D * F + F * Dout), peak_bw, peak_flops)
            row["unfused_ms"] = _device_ms(torch, lambda i: quant.qmlp(
                x, {"q": mats[i % copies][0], "scale": s13},
                {"q": mats[i % copies][1], "scale": s2}), max(copies, 20))
            print(f"kernel quant_mlp {name} S={S} unfused pair ms {row['unfused_ms']:.6f}",
                  flush=True)
            rows.append(row)
        del mats, dense, q13, q2
        torch.cuda.empty_cache()
    return rows


def _attn_work(B, H, KV, hd, S, pos0, valid_len, elem: int):
    """(bytes, operations) one flash_attention call must move and do: q and
    the output once, k and v of every slot some row sees once, 4*hd
    operations per visible (query, slot) pair and head."""
    nbytes, pairs = 2 * B * H * S * hd * elem, 0
    for p0, n in zip(pos0, valid_len):
        end = p0 + n
        nbytes += 2 * KV * min(end, p0 + S) * hd * elem
        pairs += sum(max(0, min(p0 + i + 1, end)) for i in range(S))
    return nbytes, 4 * hd * H * pairs


def phase_flash_attention(torch, attention, peak_bw, peak_flops):
    """flash_attention vs flash_attention_plain at the trunks' shapes, in
    bf16.  The backbone's cache is cycled through copies past the 50 MB L2
    (on the decode path it is read after a frame's GBs of weights); the
    decoder's 32-slot cache is fresh and hot every frame, as on the path.
    The library yardstick is one scaled_dot_product_attention call with the
    same boolean mask (enable_gqa), not timed on the row that sees no key,
    where it gives NaN."""
    F_ = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for label, B, H, KV, hd, T, S, pos0, valid_len in _ATTN_CASES:
        q = randn(B, S, H, hd).transpose(1, 2)  # as the trunk hands it over
        cache_bytes = 2 * B * KV * T * hd * 2
        copies = _copies(cache_bytes) if T > 32 else 2
        kvs = [(randn(B, KV, T, hd), randn(B, KV, T, hd)) for _ in range(copies)]
        p0 = torch.tensor(pos0, device="cuda")
        ve = p0 + torch.tensor(valid_len, device="cuda")
        k, v = kvs[0]
        got = attention.flash_attention(q, k, v, p0, ve)
        want = attention.flash_attention_plain(q, k, v, p0, ve)
        empty = [b for b, n in enumerate(valid_len) if pos0[b] == 0 and n == 0]
        torch.cuda.synchronize()
        for b in empty:
            _check(not bool(got[b].any()), f"flash_attention: {label}: row {b} is not 0")
        library = None
        if not empty:
            positions = p0[:, None] + torch.arange(S, device="cuda")[None, :]
            key_pos = torch.arange(T, device="cuda")
            mask = ((key_pos[None, None, :] <= positions[:, :, None])
                    & (key_pos[None, None, :] < ve[:, None, None]))[:, None]

            def library(i):
                kc, vc = kvs[i % copies]
                return F_.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                                       enable_gqa=True)

        nbytes, flops = _attn_work(B, H, KV, hd, S, pos0, valid_len, 2)
        rows.append(_measure(
            torch, "flash_attention",
            {"shape": label, "B": B, "H": H, "KV": KV, "hd": hd, "T": T, "S": S,
             "pos0": list(pos0), "valid_len": list(valid_len), "copies": copies,
             "route": attention._route(q.dtype, hd, H // KV, S)},
            got, want,
            lambda i: attention.flash_attention(q, *kvs[i % copies], p0, ve),
            lambda i: attention.flash_attention_plain(q, *kvs[i % copies], p0, ve),
            library, copies, nbytes, flops, peak_bw, peak_flops,
            atol=_ATTN_ATOL_OF_VMAX * v.float().abs().max().item()))
        del kvs
        torch.cuda.empty_cache()
    return rows


def _reset_counts(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def _counts(wrappers) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def _attention_launches(cfg, decoded: int, prefills: int, extends: int) -> int:
    """flash_attention launches of a run, from the code: a decoded frame
    runs the backbone once (one per backbone layer) and the decoder once
    per codebook (position 0 takes the projected backbone state), one per
    decoder layer each; an utterance prefill samples a frame the same way;
    a voice-context prefill (extend_state) runs the backbone only."""
    per_frame = cfg.backbone.num_layers + cfg.audio_num_codebooks * cfg.decoder.num_layers
    return per_frame * (decoded + prefills) + cfg.backbone.num_layers * extends


def _build_generator(torch, path: str, spec_fields: dict):
    """Build one configuration at CSM-1B width, ``warmup`` it (the decode
    graphs are captured, every prefill bucket runs once) and decode a frame
    offline through Mimi (cuDNN); nothing of it is counted.  → (gen, its
    warm-up seconds and device memory)."""
    import numpy as np

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    t0 = time.perf_counter()
    gen = build_generator(csm_1b_spec(**spec_fields), device="cuda")
    torch.cuda.synchronize()
    built_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    print(f"main[{path}]: built CSM-1B + bf16 Mimi in {time.perf_counter() - t0:.1f} s",
          flush=True)
    warm = gen.warmup()
    gen.decode_audio(np.zeros((2, gen._cfg.audio_num_codebooks), np.int32))
    torch.cuda.synchronize()
    setup = {"warmup_s": warm,
             "capture_s": {k: v for k, v in warm.items() if k.startswith("graph_")},
             "memory_gb": {"built": built_gb, "after_warmup": torch.cuda.memory_allocated() / 1e9}}
    print(f"main[{path}] warmup " + json.dumps(setup), flush=True)
    return gen, setup


def _eager_twin(gen):
    """A clone of gen (same weights) whose decode step runs eagerly on the
    card: the yardstick the graphs are checked and timed against.  The
    library has no such mode (on a CUDA device it only replays graphs), so
    the twin replaces the clone's two graph methods with the eager call."""
    twin = gen.clone()

    def capture(batch_size, greedy, parts=None):
        twin._slot(batch_size)
        return {}

    twin._capture = capture
    twin._run = lambda batch_size, part, greedy: twin._step(batch_size, part, greedy)()
    return twin


def _stream(gen, text, context, **kw):
    """→ (PCM, wall seconds, seconds to the first chunk) of generate_stream."""
    import numpy as np

    t0 = time.perf_counter()
    first_chunk_s, chunks = None, []
    for chunk in gen.generate_stream(text, 0, context, max_audio_length_ms=AUDIO_MS,
                                     temperature=0.8, topk=40, seed=0, **kw):
        if first_chunk_s is None:
            first_chunk_s = time.perf_counter() - t0
        chunks.append(chunk)
    return np.concatenate(chunks), time.perf_counter() - t0, first_chunk_s


def _requests(torch, gen, text: str, cached=None, voice: bool = False):
    """A path's offline and streamed requests (and the voice-context one)
    → (outputs {name: (PCM, wall s)}, seconds to the first streamed chunk)."""
    from sesameai_tts_tpu_torch.runtime.frames import Segment

    t0 = time.perf_counter()
    offline = gen.generate(text, 0, [], max_audio_length_ms=AUDIO_MS, temperature=0.8,
                           topk=40, cached_context=cached, seed=0)
    outputs = {"offline": (offline, time.perf_counter() - t0)}
    streamed, t_stream, first_chunk_s = _stream(gen, text, [], cached_context=cached)
    outputs["stream"] = (streamed, t_stream)
    if voice:
        t0 = time.perf_counter()
        ctx = gen.precompute_context_state([Segment(0, TEXT_1, offline)])
        voiced = gen.generate(TEXT_2, 0, [], max_audio_length_ms=AUDIO_MS, temperature=0.8,
                              topk=40, cached_context=ctx, seed=1)
        outputs["voice"] = (voiced, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return outputs, first_chunk_s


def _timing(torch, gen, outputs: dict, first_chunk_s: float) -> dict:
    """ms per decoded frame, RTF, first-chunk latency and peak memory of a
    run's requests, from gen's Metrics."""
    sr = gen.sample_rate
    summary = gen.metrics.summary()
    decoded = int(summary["decoded_frames"]["total"])
    return {
        "frames": {**{k: pcm.size // gen._hop for k, (pcm, _) in outputs.items()},
                   "decoded": decoded},
        "audio_s": {k: pcm.size / sr for k, (pcm, _) in outputs.items()},
        "rtf": {k: t / (pcm.size / sr) for k, (pcm, t) in outputs.items()},
        "first_chunk_ms": first_chunk_s * 1e3,
        "ms_per_decoded_frame": summary["decode_s"]["total"] / decoded * 1e3,
        # where the requests' wall time went; the rest is host-side
        # tokenization and the voice context's backbone pass
        "wall_s": sum(t for _, t in outputs.values()),
        "breakdown_s": {k: summary[k]["total"] for k in ("prefill_s", "decode_s", "codec_s",
                                                         "encode_s") if k in summary},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def _report(torch, gen, path: str, outputs: dict, first_chunk_s: float, launches: dict,
            per_frame: dict, extends: int, extra: dict = None) -> dict:
    """Print a path's result line and check it: PCM finite, the quant
    kernels' exact launches per decoded frame, flash_attention's exact
    launches (``_attention_launches``), streamed == offline."""
    import numpy as np

    summary = gen.metrics.summary()
    decoded = int(summary["decoded_frames"]["total"])
    prefills = summary["prefill_s"]["count"]
    offline, streamed = outputs["offline"][0], outputs["stream"][0]
    rel = float(np.abs(streamed - offline).max() / max(np.abs(offline).max(), 1e-12)) \
        if streamed.shape == offline.shape else float("inf")
    want_attention = _attention_launches(gen._cfg, decoded, prefills, extends)
    result = {
        "path": path,
        "decode": "CUDA graph replays",
        **_timing(torch, gen, outputs, first_chunk_s),
        "prefills": prefills,
        "context_prefills": extends,
        "launches": launches,
        "launches_per_decoded_frame": {k: v / decoded for k, v in launches.items()},
        "flash_attention_expected": want_attention,
        "stream_vs_offline_rel_err": rel,
        **(extra or {}),
    }
    print(f"main[{path}] " + json.dumps(result), flush=True)
    for name, (pcm, _) in outputs.items():
        _check(pcm.size > 0 and bool(np.isfinite(pcm).all()),
               f"{path}: {name} PCM empty or not finite")
    _check(prefills == len(outputs), f"{path}: {prefills} prefills for {len(outputs)} requests")
    for kernel, n in per_frame.items():
        _check(launches[kernel] == n * decoded,
               f"{path}: {kernel} launched {launches[kernel]} times for {decoded} decoded "
               f"frames (want {n} per frame)")
    _check(launches["flash_attention"] == want_attention,
           f"{path}: flash_attention launched {launches['flash_attention']} times, want "
           f"{want_attention} ({decoded} decoded frames, {prefills} prefills, {extends} "
           f"context prefills)")
    # same seed ⇒ same frames; the PCM then differs only by the bf16
    # rounding of chunked vs whole-utterance codec convolutions
    _check(streamed.shape == offline.shape and rel < 5e-2,
           f"{path}: streamed != offline: shapes {streamed.shape} vs {offline.shape}, "
           f"rel err {rel}")
    return result


def _eager_frames(torch, gen, text: str, temperature, topk, seed: int, frames: int,
                  cached=None):
    """One request's valid frames computed eagerly on the card by the
    model's functions, as the Generator computes them: the bucketed prefill
    through ``csm.generate_frame`` on the prefill weights, then
    ``csm.decode_frames`` → (F, K) int32."""
    from sesameai_tts_tpu_torch.models import csm
    from sesameai_tts_tpu_torch.runtime.generator import _next_bucket

    cfg = gen._cfg
    state = csm.init_state(cfg, 1, gen._params["projection"].dtype, device=gen.device)
    if cached is not None:
        csm.load_state(state, cached[0])
        tokens, mask = gen.frame_tokenizer.text_segment(text, 0)
        ctx_rows = cached[1]
    else:
        tokens, mask = gen._tokenize_prompt(text, 0, [])
        ctx_rows = 0
    bucket = _next_bucket(tokens.shape[0], gen._prefill_buckets,
                          room=gen.max_seq_len - ctx_rows)
    tok, msk, valid_len = gen._padded(tokens, mask, bucket)
    frame, state = csm.generate_frame(gen._prefill_params, cfg, state, tok, msk,
                                      csm.frame_generator(seed, 0, gen.device), temperature,
                                      topk, valid_len=valid_len, rope_cs=gen._rope)
    first_valid = ~(frame == 0).all(dim=-1)
    rest, valid, _, _ = csm.decode_frames(gen._params, cfg, state, frame, ~first_valid, seed,
                                          frames - 1, temperature, topk, rope_cs=gen._rope,
                                          start_index=1, fused_mlp=gen._fused_mlp)
    out = torch.cat([frame[None], rest])[:, 0]
    keep = torch.cat([first_valid[None], valid])[:, 0]
    return out[keep].cpu().numpy().astype("int32")


def _frame_launches(gen) -> dict:
    """Port kernel launches one decoded frame replays (the backbone and the
    sampling graphs at B = 1, sampled)."""
    out = {}
    for part in ("backbone", "sample"):
        for fn, n in gen._graphs[(1, part, False)].launches.items():
            out[fn.__name__] = out.get(fn.__name__, 0) + n
    return out


def phase_graphs(torch, gen, path: str, per_frame: dict, text: str, cached=None) -> dict:
    """The captured graphs against the eager step on the card, on one
    path: each of ``GRAPH_CHECKS`` (greedy, sampled, a second temperature
    and topk on the same graphs) gives the frames of ``_eager_frames``,
    bit for bit; each frame replays exactly the path's launches; a clone
    with another decode chunk size gives the seeded frames again, shares
    the weights' storage and adds no weight memory."""
    import numpy as np

    want = {**per_frame, "flash_attention": _attention_launches(gen._cfg, 1, 0, 0)}
    got = _frame_launches(gen)
    result = {"launches_per_frame_replayed": got}
    _check(all(got.get(k, 0) == n for k, n in want.items()),
           f"{path}: a replayed frame launches {got}, want {want}")
    n_graphs = len(gen._graphs)
    frames = GRAPH_CHECK_MS // 80
    graphed = {}
    for label, temperature, topk, seed in GRAPH_CHECKS:
        graphed[label] = gen.generate_frames(text, 0, [], max_audio_length_ms=GRAPH_CHECK_MS,
                                             temperature=temperature, topk=topk,
                                             cached_context=cached, seed=seed)
        eager = _eager_frames(torch, gen, text, temperature, topk, seed, frames, cached)
        equal = graphed[label].shape == eager.shape and bool(np.array_equal(graphed[label], eager))
        result[label] = {"temperature": temperature, "topk": topk, "seed": seed,
                         "frames": int(graphed[label].shape[0]), "bit_equal_to_eager": equal}
        _check(equal, f"{path}: graphed {label} frames differ from the eager step's: "
                      f"{graphed[label].shape} vs {eager.shape}")
    _check(len(gen._graphs) == n_graphs,
           f"{path}: the requests captured new graphs ({n_graphs} → {len(gen._graphs)})")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    clone = gen.clone(decode_chunk_frames=3)
    _, temperature, topk, seed = GRAPH_CHECKS[1]
    chunked = clone.generate_frames(text, 0, [], max_audio_length_ms=GRAPH_CHECK_MS,
                                    temperature=temperature, topk=topk, cached_context=cached,
                                    seed=seed)
    torch.cuda.synchronize()
    weight = gen._params["projection"]
    result["clone"] = {
        "decode_chunk_frames": 3, "frames_equal": bool(np.array_equal(chunked,
                                                                      graphed["sampled"])),
        "added_gb": (torch.cuda.memory_allocated() - before) / 1e9,
        "shares_weights": clone._params["projection"].data_ptr() == weight.data_ptr(),
        "own_metrics": clone.metrics is not gen.metrics,
        "graphs": len(clone._graphs),
    }
    del clone
    _collect(torch)
    print(f"graphs[{path}] " + json.dumps(result), flush=True)
    _check(result["clone"]["frames_equal"],
           f"{path}: the seeded frames depend on the chunk size (3 vs 10)")
    _check(result["clone"]["shares_weights"] and result["clone"]["own_metrics"],
           f"{path}: the clone does not share the weights or shares the Metrics")
    # the static state is 64 MiB; one more copy of the weights would be GBs
    _check(result["clone"]["added_gb"] < 0.5,
           f"{path}: the clone added {result['clone']['added_gb']:.2f} GB")
    return result


def _eager_run(torch, gen, text: str, cached=None, voice: bool = False) -> dict:
    """The path's requests on an eager twin of gen, timed as the graphed
    ones (the graphed Generator's memory stays allocated beside it)."""
    twin = _eager_twin(gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outputs, first_chunk_s = _requests(torch, twin, text, cached, voice)
    result = {"decode": "eager", **_timing(torch, twin, outputs, first_chunk_s)}
    del twin
    _collect(torch)
    return result


def phase_main_path(torch, wrappers, path: str, spec_fields: dict, per_frame: dict,
                    voice: bool):
    """One configuration of the serving path at CSM-1B width: offline and
    streamed requests (and a 2 s voice-context one) on the graphs, launch
    counts checked exactly; then the graph checks and the eager twin."""
    gen, setup = _build_generator(torch, path, spec_fields)
    gen.metrics.reset()
    _reset_counts(wrappers)
    outputs, first_chunk_s = _requests(torch, gen, TEXT_1, voice=voice)
    launches = _counts(wrappers)
    result = _report(torch, gen, path, outputs, first_chunk_s, launches, per_frame,
                     extends=int(voice), extra=setup)
    result["graph_checks"] = phase_graphs(torch, gen, path, per_frame, TEXT_1)
    result["eager"] = _eager_run(torch, gen, TEXT_1, voice=voice)
    print(f"eager[{path}] " + json.dumps(result["eager"]), flush=True)
    del gen
    _collect(torch)
    return result


def _write_voice(root: str) -> str:
    """Two ~16 s 44.1 kHz stereo clips, synthesized from a seed (a gliding
    harmonic tone under a syllable-rate envelope, plus noise), with their
    transcripts in a voices.json → its path."""
    import numpy as np

    from sesameai_tts_tpu_torch.audio.io import write_wav

    rate = 44_100
    rng = np.random.default_rng(0)
    t = np.arange(int(VOICE_CLIP_S * rate)) / rate
    clips = {}
    for i, text in enumerate(VOICE_TRANSCRIPTS):
        f0 = 120.0 + 25.0 * np.sin(2 * np.pi * 0.3 * t + i)
        phase = 2 * np.pi * np.cumsum(f0) / rate
        tone = sum(np.sin(h * phase) / h for h in range(1, 9))
        env = np.clip(np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6)), 0.0, None)
        left = 0.25 * env * tone + 0.01 * rng.standard_normal(t.size)
        name = f"clip{i}.wav"
        write_wav(os.path.join(root, name), np.stack([left, 0.9 * left]), rate)
        clips[name] = text
    path = os.path.join(root, "voices.json")
    with open(path, "w") as f:
        json.dump({"clone": clips}, f)
    return path


def phase_voice_path(torch, wrappers, per_frame: dict):
    """The voice-preload path on CSM-1B int8: a voice registry on disk →
    ``prepare_voice_context`` (read_wav_mono → resample → Mimi encode) →
    one context prefill at the 512-row bucket (flash_attention at S=512,
    T=2048) → offline and streamed requests from the cached context → one
    RollingContext turn (voice prefix pinned, the first utterance appended
    as a dialog segment) whose prompt exceeds 512 rows."""
    import tempfile

    from sesameai_tts_tpu_torch.runtime.context import RollingContext
    from sesameai_tts_tpu_torch.runtime.frames import Segment
    from sesameai_tts_tpu_torch.runtime.generator import _next_bucket
    from sesameai_tts_tpu_torch.service.tts import prepare_voice_context
    from sesameai_tts_tpu_torch.service.voices import load_registry

    gen, setup = _build_generator(torch, "voice", {})
    with tempfile.TemporaryDirectory() as tmp:
        registry = load_registry(_write_voice(tmp))
        gen.metrics.reset()
        _reset_counts(wrappers)
        t0 = time.perf_counter()
        segments, rows, trimmed = prepare_voice_context(gen, registry["clone"], "clone")
        prepare_s = time.perf_counter() - t0
    bucket = _next_bucket(rows, gen._prefill_buckets, room=gen.max_seq_len)
    t0 = time.perf_counter()
    ctx = gen.precompute_context_state(segments)
    torch.cuda.synchronize()
    context_prefill_s = time.perf_counter() - t0

    outputs, first_chunk_s = _requests(torch, gen, TEXT_2, cached=ctx)
    offline = outputs["offline"][0]

    rolling = RollingContext(max_positions=gen.max_seq_len)
    rolling.pin_prefix(segments)
    t0 = time.perf_counter()
    rolling.append(gen.frame_tokenizer.segment(Segment(0, TEXT_2, offline)))
    turn_rows = rolling.total_rows + gen.frame_tokenizer.text_segment(TEXT_3, 1)[0].shape[0]
    turn = gen.generate(TEXT_3, 1, rolling.pairs(), max_audio_length_ms=AUDIO_MS,
                        temperature=0.8, topk=40, seed=2)
    outputs["rolling_turn"] = (turn, time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    result = _report(torch, gen, "voice", outputs, first_chunk_s, launches, per_frame,
                     extends=1, extra={
                         **setup, "context_rows": rows, "context_bucket": bucket,
                         "context_trimmed": trimmed, "prepare_voice_s": prepare_s,
                         "context_prefill_ms": context_prefill_s * 1e3,
                         "rolling_turn_prompt_rows": turn_rows,
                         "rolling_turn_bucket": _next_bucket(turn_rows, gen._prefill_buckets,
                                                             room=gen.max_seq_len)})
    _check(385 <= rows <= 512 and bucket == 512 and not trimmed,
           f"voice: context of {rows} rows (bucket {bucket}, trimmed {trimmed}); want 385-512 "
           f"rows in the 512-row bucket")
    _check(turn_rows > 512, f"voice: the rolling turn's prompt is {turn_rows} rows, not > 512")
    result["graph_checks"] = phase_graphs(torch, gen, "voice", per_frame, TEXT_2, cached=ctx)
    result["eager"] = _eager_run(torch, gen, TEXT_2, cached=ctx)
    print("eager[voice] " + json.dumps(result["eager"]), flush=True)
    del gen
    _collect(torch)
    return result


def _tokenizer_backend(tok) -> dict:
    """Which tokenizer backend loaded, and whether it tokenizes as Llama-3
    does everywhere (the native BPE without ``regex`` approximates the
    pretokenizer off ASCII)."""
    from sesameai_tts_tpu_torch.tokenizer import native_bpe, text

    if isinstance(tok, native_bpe.NativeBPETokenizer):
        return {"backend": "native_bpe", "exact": native_bpe.has_exact_pretokenizer()}
    return {"backend": type(tok).__name__, "exact": isinstance(tok, text.HFTokenizer)}


def _confidence(wm, audio, rate: int) -> float:
    """The verify statistic of the CSM key in 24 kHz audio (``verify``
    thresholds it at ``wm.verify_threshold``)."""
    from sesameai_tts_tpu_torch.audio.resample import resample
    from sesameai_tts_tpu_torch.watermark import dsp

    return wm.decode_wav(resample(audio, rate, dsp.WATERMARK_RATE), dsp.WATERMARK_RATE,
                         phase_shift_decoding=True,
                         expected_message=dsp.CSM_1B_WATERMARK)["confidence"]


def _watermark_timing(torch, wm, audio, rate: int) -> dict:
    """ms per second of audio of ``watermark`` and ``verify`` on the card
    (the host's 24 ↔ 44.1 kHz resampling included), and of the on-card
    embed and decode alone at 44.1 kHz, best of 3 (the first call of each
    is a warm-up)."""
    from sesameai_tts_tpu_torch.audio.resample import resample
    from sesameai_tts_tpu_torch.watermark import api, dsp

    key, sr = dsp.CSM_1B_WATERMARK, dsp.WATERMARK_RATE
    x44 = resample(audio, rate, sr)
    calls = {
        "watermark": lambda: api.watermark(wm, audio, rate, key),
        "verify": lambda: api.verify(wm, audio, rate, key),
        "encode_wav_44k": lambda: wm.encode_wav(x44, sr, key, message_sdr=30.0),
        "decode_wav_44k": lambda: wm.decode_wav(x44, sr, phase_shift_decoding=True,
                                                expected_message=key),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()  # returns host numpy: the device work has ended
            best = min(best, time.perf_counter() - t0)
        out[name] = best * 1e3 / (len(audio) / rate)
    return out


def phase_cli(torch, wrappers, per_frame: dict):
    """The port's command line at CSM-1B width on the card, from files:
    CSM-1B parameters drawn from seed 0 (f32) → ``save_csm_checkpoint`` into
    ``<tmp>/csm/model.safetensors`` beside the port's Llama-3-format
    ``bench_tokenizer.json`` as ``tokenizer.json``; bf16 Mimi parameters →
    ``save_pytree``; a voice of two synthesized clips.  The checkpoint loads
    back bit-equal to the bf16 cast of the drawn parameters.  Then
    ``service.cli.main`` (int8 and the watermark, as its defaults) speaks two
    sentences with that voice into a WAV; launch counts, the WAV (24 kHz
    mono, each sentence audible past its lead-in, no silent fallback,
    verified as watermarked; the same request unmarked does not verify) and
    greedy frames of a Generator built from the checkpoint against one
    built from the drawn parameters in memory are checked."""
    import shutil
    import tempfile

    import numpy as np

    from sesameai_tts_tpu_torch.audio.io import read_wav, write_wav
    from sesameai_tts_tpu_torch.codec.mimi import Mimi, MimiConfig
    from sesameai_tts_tpu_torch.convert import to_device, tree_map
    from sesameai_tts_tpu_torch.core import weights
    from sesameai_tts_tpu_torch.core.config import csm_1b
    from sesameai_tts_tpu_torch.models.csm import init_csm_params
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.service import cli, tts
    from sesameai_tts_tpu_torch.watermark import api

    cfg = csm_1b()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    result = {"tmp_free_gb": shutil.disk_usage(tmp).free / 1e9}
    seen = {"requests": []}
    saved = tts.TTS.load_model, tts.TTS.generate_audio_segment, tts.TTS.export_wav
    try:
        # the files
        t0 = time.perf_counter()
        params = init_csm_params(cfg, torch.Generator().manual_seed(0), torch.float32)
        result["draw_s"] = time.perf_counter() - t0
        csm_dir = os.path.join(tmp, "csm")
        os.makedirs(csm_dir)
        t0 = time.perf_counter()
        weights.save_csm_checkpoint(os.path.join(csm_dir, "model.safetensors"), params)
        result["save_s"] = time.perf_counter() - t0
        result["checkpoint_gb"] = os.path.getsize(os.path.join(csm_dir, "model.safetensors")) / 1e9
        shutil.copy(os.path.join(HERE, "sesameai_tts_tpu_torch", "assets", "bench_tokenizer.json"),
                    os.path.join(csm_dir, "tokenizer.json"))
        mimi = Mimi(MimiConfig())
        mimi_params = mimi.init(torch.Generator().manual_seed(1), torch.bfloat16)
        mimi_path = os.path.join(tmp, "mimi.safetensors")
        weights.save_pytree(mimi_path, mimi_params)
        voices = _write_voice(tmp)

        # the round trip: bit-equal after the same cast
        bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
        del params
        t0 = time.perf_counter()
        loaded = weights.load_csm_checkpoint(csm_dir, cfg, torch.bfloat16)
        result["load_s"] = time.perf_counter() - t0
        want, got = [], []
        tree_map(want.append, bf16)
        tree_map(got.append, loaded)
        equal = len(want) == len(got) and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(want, got))
        result["checkpoint_bit_equal"] = equal
        del loaded, want, got
        gc.collect()
        _check(equal, "cli: the checkpoint read back differs from the parameters written")

        # the command line, with the engine and its sentences observed
        def load_model(self):
            seen["engine"] = self
            t0 = time.perf_counter()
            saved[0](self)
            torch.cuda.synchronize()
            seen["build_s"] = time.perf_counter() - t0

        def generate_audio_segment(self, prompt, *a, **kw):
            t0 = time.perf_counter()
            clip = saved[1](self, prompt, *a, **kw)
            seen["requests"].append((prompt, time.perf_counter() - t0,
                                     len(clip.samples) / clip.sample_rate))
            return clip

        def export_wav(self, *a, **kw):
            seen["clips"] = saved[2](self, *a, **kw)
            return seen["clips"]

        tts.TTS.load_model = load_model
        tts.TTS.generate_audio_segment = generate_audio_segment
        tts.TTS.export_wav = export_wav
        out_wav = os.path.join(tmp, "out.wav")
        argv = ["--model-path", csm_dir, "--mimi-path", mimi_path, "--voices", voices,
                "-v", "clone", "--seed", "0", "--max-ms", str(CLI_MAX_MS), "--output", out_wav,
                " ".join(CLI_SENTENCES)]
        _reset_counts(wrappers)
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        result["cli_s"] = time.perf_counter() - t0
        launches = _counts(wrappers)
        tts.TTS.load_model, tts.TTS.generate_audio_segment, tts.TTS.export_wav = saved
        engine, gen = seen["engine"], seen["engine"].generator
        summary = gen.metrics.summary()
        decoded = int(summary["decoded_frames"]["total"])
        prefills = summary["prefill_s"]["count"]
        # the decode graphs were captured inside the CLI's first request:
        # each capture's eager warm-up call launched what one replay does
        warm = {}
        for g in gen._graphs.values():
            for fn, n in g.launches.items():
                warm[fn.__name__] = warm.get(fn.__name__, 0) + n
        want_attention = _attention_launches(cfg, decoded, prefills, extends=1)
        sr = gen.sample_rate
        lead = int(0.5 * sr)  # generate_audio_segment's 500 ms of leading silence
        clips = seen["clips"]
        rms = [float(np.sqrt(np.mean(c.samples[lead:] ** 2))) for c in clips]
        wav, rate = read_wav(out_wav)
        # each sentence's stretch of the WAV, as a file of its own
        t0 = time.perf_counter()
        marked_ok, start = [], 0
        for i, c in enumerate(clips):
            part = os.path.join(tmp, f"sentence{i}.wav")
            write_wav(part, wav[0, start:start + len(c.samples)], rate)
            marked_ok.append(api.check_audio_from_file(part))
            start += len(c.samples)
        check_s = time.perf_counter() - t0
        whole_ok = api.check_audio_from_file(out_wav)
        # the first sentence's request again, unmarked (the CLI's seed 0 + 0)
        engine.enable_watermark = False
        raw = engine.generate_with_context(CLI_SENTENCES[0], temperature=0.8, topk=40, seed=0,
                                           max_audio_length_ms=CLI_MAX_MS)
        raw_ok = api.verify(engine.watermarker, raw, sr, engine.watermark_key)
        requests = [{"text": p, "wall_s": w, "audio_s": a, "rtf": w / a}
                    for p, w, a in seen["requests"]]
        result.update({
            "build_s": seen["build_s"],
            "tokenizer": _tokenizer_backend(gen._tokenizer.text_tokenizer),
            "requests": requests,
            "wav": {"rate": rate, "channels": int(wav.shape[0]), "seconds": wav.shape[1] / rate},
            "clip_rms_past_lead_in": rms,
            "fallbacks": engine.fallbacks,
            "sentences_verified": marked_ok, "check_audio_s": check_s,
            "whole_wav_verified": whole_ok,
            "verify_confidence": {"wav": _confidence(engine.watermarker, wav[0], rate),
                                  "raw": _confidence(engine.watermarker, raw, sr),
                                  **{f"clip{i}": _confidence(engine.watermarker, c.samples, sr)
                                     for i, c in enumerate(clips)}},
            "raw_verified": raw_ok,
            "watermark_ms_per_audio_s": _watermark_timing(torch, engine.watermarker, raw, sr),
            "decoded_frames": decoded, "prefills": prefills, "context_prefills": 1,
            "launches": launches, "capture_warmup_launches": warm,
            "launches_per_decoded_frame": {
                k: (launches[k] - warm.get(k, 0)) / decoded for k in per_frame},
            "flash_attention_expected": want_attention + warm.get("flash_attention", 0),
        })

        # greedy: the checkpoint-built Generator against one built in memory
        in_memory = Generator(quantize_csm(to_device(bf16, "cuda")), cfg, gen._mimi,
                              to_device(mimi_params, "cuda"), gen._tokenizer.text_tokenizer,
                              device="cuda")
        ref = tts.TTS(spec=engine.spec, voices=voices, enable_watermark=False)
        ref.generator = in_memory
        ref.load_voice("clone", warmup=False)
        greedy = {}
        for name, e in (("checkpoint", engine), ("in_memory", ref)):
            pcm = e.generate_with_context(CLI_SENTENCES[1], topk=1, temperature=1.0, seed=0,
                                          max_audio_length_ms=GREEDY_MS)
            frames = e.generator.generate_frames(CLI_SENTENCES[1], 1, [], topk=1,
                                                 temperature=1.0, seed=0,
                                                 max_audio_length_ms=GREEDY_MS,
                                                 cached_context=e.cached_context)
            greedy[name] = (frames, pcm)
        (f_ckpt, p_ckpt), (f_mem, p_mem) = greedy["checkpoint"], greedy["in_memory"]
        result["greedy"] = {
            "frames": int(f_ckpt.shape[0]),
            "frames_equal": f_ckpt.shape == f_mem.shape and bool(np.array_equal(f_ckpt, f_mem)),
            "pcm_max_abs_diff": float(np.abs(p_ckpt - p_mem).max())
            if p_ckpt.shape == p_mem.shape else None}
        del in_memory, ref, engine, gen
        seen.clear()
    finally:
        tts.TTS.load_model, tts.TTS.generate_audio_segment, tts.TTS.export_wav = saved
        shutil.rmtree(tmp, ignore_errors=True)
        _collect(torch)
    print("main[cli] " + json.dumps(result), flush=True)
    _check(rate == 24_000 and wav.shape[0] == 1, f"cli: the WAV is {rate} Hz, {wav.shape[0]} ch")
    _check(len(clips) == len(CLI_SENTENCES), f"cli: {len(clips)} clips for "
                                             f"{len(CLI_SENTENCES)} sentences")
    _check(result["fallbacks"] == 0, f"cli: {result['fallbacks']} sentences fell back to silence")
    _check(all(r > 1e-3 for r in rms), f"cli: a clip is silent past its lead-in: RMS {rms}")
    _check(all(marked_ok), f"cli: check_audio_from_file does not find the watermark in each "
                           f"sentence of the WAV: {marked_ok}")
    _check(not raw_ok, "cli: the unmarked audio of the same request verifies as watermarked")
    for kernel, n in per_frame.items():
        got = launches[kernel] - warm.get(kernel, 0)
        _check(got == n * decoded, f"cli: {kernel} launched {got} times past the capture for "
                                   f"{decoded} decoded frames (want {n} per frame)")
    _check(launches["flash_attention"] == result["flash_attention_expected"],
           f"cli: flash_attention launched {launches['flash_attention']} times, want "
           f"{result['flash_attention_expected']}")
    _check(result["greedy"]["frames_equal"],
           "cli: the checkpoint-built Generator's greedy frames differ from the in-memory one's")
    return result


def _speechlike(seconds: float, rate: int, seed: int):
    """A gliding harmonic tone under a syllable-rate envelope, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    phase = 2 * np.pi * np.cumsum(130.0 + 30.0 * np.sin(2 * np.pi * 0.4 * t)) / rate
    tone = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0.0, None)
    return (0.25 * env * tone + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _net_on_card(torch, sc_path: str) -> dict:
    """The silentcipher network at the real grid, card against CPU and the
    card's stream against its offline embed (see SMOKE_* above), its times
    and peak memory on the card, and the card's residual and probabilities
    with TF32 left on (information)."""
    import contextlib
    from unittest import mock

    import numpy as np

    from sesameai_tts_tpu_torch.audio.resample import resample
    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.watermark import net, stream
    from sesameai_tts_tpu_torch.watermark.api import CSM_1B_WATERMARK as key

    gpu = net.load_silentcipher_checkpoint(sc_path)  # the default device: the card
    cpu = net.load_silentcipher_checkpoint(sc_path, device="cpu")
    cfg, sr = gpu.cfg, gpu.cfg.sample_rate
    devices = set()
    tree_map(lambda t: devices.add(t.device.type), gpu.params)
    x = resample(_speechlike(SMOKE_CLIP_S, 24_000, 3), 24_000, sr)
    nf = net._frames_for(len(x), cfg)

    def probs(model, y):
        xp, n, frames = model._padded(y)
        return net._decode(model.params, cfg, xp, frames, n).cpu().numpy()

    def unit_resid(model, whole=False):  # the offline residual at gain 1
        xp, _, frames = model._padded(x)
        msg = torch.tensor(key, device=model.device)
        r = net._embed(model.params, cfg, xp, msg, frames, len(x))[0]
        return (r if whole else r[:len(x)]).cpu().numpy()

    def closed_form_alpha(resid):  # encode_wav's gain, in f64 on the host
        x64, r64 = x.astype(np.float64), resid.astype(np.float64)
        return float(np.sqrt((x64 @ x64) / (r64 @ r64)) * 10.0 ** (-cfg.default_message_sdr / 20))

    # cuDNN's default (TF32 on), as a library user has it: the network's
    # own scope must turn TF32 off for its convolutions
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y_gpu, _ = gpu.encode_wav(x, sr, key)
        d_gpu = gpu.decode_wav(y_gpu, sr, phase_shift_decoding=True, expected_message=key)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        t0 = time.perf_counter()
        y_cpu, _ = cpu.encode_wav(x, sr, key)
        d_cpu = cpu.decode_wav(y_gpu, sr, phase_shift_decoding=True, expected_message=key)
        cpu_s = time.perf_counter() - t0
        p_gpu, p_cpu = probs(gpu, y_gpu), probs(cpu, y_gpu)
        off, off_cpu = unit_resid(gpu), unit_resid(cpu)
        off_bucket = unit_resid(gpu, whole=True)
        se = stream.StreamingNetEmbedder(gpu, key, alpha=1.0)
        rng = np.random.default_rng(5)
        outs, i = [], 0
        t0 = time.perf_counter()
        while i < len(x):
            c = int(rng.integers(2_000, 9_000))
            outs.append(se.feed(x[i:i + c]))
            i += c
        outs.append(se.close())
        stream_s = time.perf_counter() - t0
        y_stream = np.concatenate(outs)
        with mock.patch.object(net, "_full_f32", contextlib.nullcontext):
            off_tf32 = unit_resid(gpu)
            p_tf32 = probs(gpu, y_gpu)
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32
    r_gpu, r_cpu = y_gpu - x, y_cpu - x
    # the band the service ships: watermark() resamples the marked 44.1 kHz
    # audio to the caller's 24 kHz
    r24_gpu, r24_cpu, s24, off24, off24_cpu, off24_tf32 = (
        resample(r, sr, 24_000) for r in (r_gpu, r_cpu, y_stream - x, off, off_cpu, off_tf32))

    def of_max(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    # the gain encode_wav applied: the least-squares fit of its residual
    # to the unit one
    alpha_gpu = float((r_gpu.astype(np.float64) @ off) / (off.astype(np.float64) @ off))
    alpha_cpu = float((r_cpu.astype(np.float64) @ off_cpu)
                      / (off_cpu.astype(np.float64) @ off_cpu))

    out = {
        "grid": {"sample_rate": sr, "n_fft": cfg.n_fft, "hop": cfg.hop,
                 "message": [cfg.message_len, cfg.vocab],
                 "hidden": int(gpu.params["enc_c"][0]["w"].shape[0])},
        "clip_s": SMOKE_CLIP_S, "frames": nf, "bucket": net._bucket_frames(nf),
        "params_device": sorted(devices),
        "resid_max_abs": float(np.abs(off_cpu).max()),
        "resid_card_vs_cpu_of_max": of_max(off24, off24_cpu),
        "full_band_resid_card_vs_cpu_of_max": of_max(off, off_cpu),
        # encode_wav's residual is α times the one above; α's Σresid² takes in
        # the noise-phase band too
        "encode_wav_resid_card_vs_cpu_of_max": of_max(r24_gpu, r24_cpu),
        "alpha_card_over_cpu": alpha_gpu / alpha_cpu,
        "alpha_card_over_closed_form": alpha_gpu / closed_form_alpha(off),
        "alpha_bucket_fault_over_closed_form": (
            float(np.sqrt((x.astype(np.float64) @ x) / (off_bucket.astype(np.float64) @ off_bucket))
                  * 10.0 ** (-cfg.default_message_sdr / 20)) / closed_form_alpha(off)),
        "bucket_tail_resid_energy_share": float(
            (off_bucket[len(x):].astype(np.float64) ** 2).sum()
            / (off_bucket.astype(np.float64) ** 2).sum()),
        "argmax_equal": bool((p_gpu.argmax(axis=1) == p_cpu.argmax(axis=1)).all()),
        "probs_max_abs_diff": float(np.abs(p_gpu - p_cpu).max()),
        "confidence": {"card": d_gpu["confidence"], "cpu": d_cpu["confidence"]},
        "expected_confidence": {"card": d_gpu["expected_confidence"],
                                "cpu": d_cpu["expected_confidence"]},
        "stream_vs_offline_max_abs": float(np.abs(s24 - off24).max()),
        "stream_tolerance": 5e-5 + 1e-3 * float(np.abs(off24).max()),
        "full_band_stream_vs_offline_max_abs": float(np.abs((y_stream - x) - off).max()),
        "stream_len_equal": len(y_stream) == len(x),
        "stream_ms_per_audio_s": stream_s * 1e3 / SMOKE_CLIP_S,
        "cpu_encode_decode_s": cpu_s,
        "peak_device_gb": peak_gb,
        "tf32_on": {"resid_card_vs_cpu_of_max": of_max(off24_tf32, off24_cpu),
                    "argmax_equal": bool((p_tf32.argmax(axis=1)
                                          == p_cpu.argmax(axis=1)).all()),
                    "probs_max_abs_diff": float(np.abs(p_tf32 - p_cpu).max())},
        "ms_per_audio_s": _watermark_timing(torch, gpu, resample(x, sr, 24_000), 24_000),
    }
    del gpu, cpu
    return out


def phase_smoke(torch, wrappers, card: str):
    """The real-weights rehearsal on the card, after the silentcipher network
    alone at the real grid (``_net_on_card``): ``fixtures.write_synthetic_weights
    (tmp, "csm-1b")`` writes upstream-layout files (a 6.2 GB f32 torchtune CSM-1B
    checkpoint with a Llama-3-format tokenizer.json, a transformers-layout Mimi
    file, a silentcipher .pth at ``hidden=32``), then ``smoke.main(["--weights-dir",
    tmp])`` converts, loads (int8), generates, runs the quant gate, the codec, the
    watermark through the network and the HTTP API, whose /tts/stream carries the
    network's streamed mark.  Its return code must be 0; the network's streaming
    blocks must have run on the card; quant_matmul and flash_attention must have
    launched."""
    import contextlib
    import shutil
    import tempfile

    from sesameai_tts_tpu_torch.service import fixtures, smoke
    from sesameai_tts_tpu_torch.watermark import stream

    tmp = tempfile.mkdtemp(prefix="chip_smoke_smoke_")
    result = {"card": card, "tmp_free_gb": shutil.disk_usage(tmp).free / 1e9}
    blocks = {"calls": 0, "devices": set()}
    net_block = stream._net_block_segs

    def counted(model, *a, **kw):
        blocks["calls"] += 1
        blocks["devices"].add(model.device.type)
        return net_block(model, *a, **kw)

    try:
        t0 = time.perf_counter()
        paths = fixtures.write_synthetic_weights(os.path.join(tmp, "weights"), "csm-1b", seed=0)
        result["fixtures_s"] = time.perf_counter() - t0
        result["fixtures_gb"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(os.path.dirname(paths["marker"])) for f in files) / 1e9
        result["net"] = _net_on_card(torch, paths["silentcipher"])
        print("main[smoke] net " + json.dumps(result["net"]), flush=True)
        _collect(torch)

        stream._net_block_segs = counted
        tee = _Tee(sys.stdout)
        _reset_counts(wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = smoke.main(["--weights-dir", os.path.dirname(paths["marker"])])
        torch.cuda.synchronize()
        result["smoke_s"] = time.perf_counter() - t0
        result["launches"] = _counts(wrappers)
    finally:
        stream._net_block_segs = net_block
        shutil.rmtree(tmp, ignore_errors=True)
        _collect(torch)
    lines = "".join(tee.lines).splitlines()
    result["rc"] = rc
    result["checks"] = [ln for ln in lines if ln.startswith(("[PASS]", "[FAIL]", "[info]"))]
    result["stream_blocks"] = {"calls": blocks["calls"], "devices": sorted(blocks["devices"])}
    print("main[smoke] " + json.dumps(result), flush=True)
    n = result["net"]
    _check(n["params_device"] == ["cuda"], f"smoke: the network's params are on "
                                           f"{n['params_device']}, not the card")
    _check(n["resid_card_vs_cpu_of_max"] <= SMOKE_RESID_TOL,
           f"smoke: the card's residual is {n['resid_card_vs_cpu_of_max']:.2e} of max|resid| "
           f"from the CPU's (limit {SMOKE_RESID_TOL})")
    _check(abs(n["alpha_card_over_closed_form"] - 1) <= SMOKE_ALPHA_SELF_TOL,
           f"smoke: encode_wav's gain on the card is {n['alpha_card_over_closed_form']} of "
           f"sqrt(Σx²/Σresid²)·10^(-sdr/20) over the clip (limit {SMOKE_ALPHA_SELF_TOL})")
    _check(abs(n["alpha_card_over_cpu"] - 1) <= SMOKE_ALPHA_CPU_TOL,
           f"smoke: encode_wav's gain on the card is {n['alpha_card_over_cpu']} of the CPU's "
           f"(limit {SMOKE_ALPHA_CPU_TOL})")
    _check(n["argmax_equal"], "smoke: the decoded argmax message differs, card against CPU")
    for k in ("confidence", "expected_confidence"):
        _check(abs(n[k]["card"] - n[k]["cpu"]) <= SMOKE_CONF_TOL,
               f"smoke: {k} {n[k]['card']} on the card, {n[k]['cpu']} on the CPU")
    _check(n["stream_len_equal"] and n["stream_vs_offline_max_abs"] <= n["stream_tolerance"],
           f"smoke: the stream is {n['stream_vs_offline_max_abs']:.2e} from the offline "
           f"residual (limit {n['stream_tolerance']:.2e})")
    _check(rc == 0, f"smoke: sesame-tts-torch-smoke --weights-dir exited {rc}")
    _check(any(ln.startswith("[PASS] serve") and "stream through StreamingNetEmbedder" in ln
               for ln in lines), "smoke: /tts/stream did not stream the network's mark")
    _check(any(ln.startswith("[PASS] watermark: NetWatermarker") for ln in lines),
           "smoke: the watermark check did not run the network")
    _check(blocks["calls"] > 0 and blocks["devices"] == {"cuda"},
           f"smoke: the network's streaming blocks ran {blocks['calls']} times on "
           f"{sorted(blocks['devices'])}")
    for k in ("quant_matmul", "flash_attention"):
        _check(result["launches"][k] > 0, f"smoke: {k} did not launch in the rehearsal")
    return result


def _post(base: str, path: str, body: dict, timeout: float = 300):
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _text_of_rows(gen, rows: int) -> str:
    """The shortest prefix of a long text whose prompt is ``rows`` rows (a
    prompt grows by at most one row per character)."""
    text = "a serving prompt that fills the cache " * (rows // 4 + 1)

    def n_rows(n):
        return gen._tokenize_prompt(text[:n], 0, [])[0].shape[0]

    lo, hi = 0, len(text)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if n_rows(mid) < rows else (lo, mid)
    _check(n_rows(lo) == rows, f"serve: no prefix of the text is {rows} rows")
    return text[:lo]


def _pool_tensors(srv):
    """The pool's static tensors (state and decode buffers of the tick clone)."""
    from sesameai_tts_tpu_torch.runtime.serving import _tensors

    return list(_tensors(srv._ticker._slot(srv.B)))


def _pool_ticks(torch, srv, greedy: bool, ms0, seed: int = 77):
    """One tick of the pool as it stands, on the graphs and then on the eager
    step from the same state (restored in between) → (graphed, eager): each
    (frames, valid, done, PCM) on the host, plus the graphed tick's wall ms
    (synchronized)."""
    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.runtime.serving import _on

    t = srv._ticker
    snapshot = [x.clone() for x in _pool_tensors(srv)]
    out = {}
    for mode in ("graphed", "eager"):
        for dst, src in zip(_pool_tensors(srv), snapshot):
            dst.copy_(src)
        if mode == "eager":  # the yardstick of _eager_twin, on the pool's own state
            t._run = lambda b, part, g: t._step(b, part, g)()
        try:
            with _on(t):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = t._serve_tick(srv.B, srv.chunk, seed, greedy,
                                    tree_map(lambda x: x.clone(), ms0))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            t.__dict__.pop("_run", None)
        out[mode] = ([x.cpu().numpy() for x in res[:4]], wall_ms)
    for dst, src in zip(_pool_tensors(srv), snapshot):
        dst.copy_(src)
    return out


def phase_serve(torch, wrappers, card: str):
    """Batched serving and the HTTP API at CSM-1B width (int8, bf16 Mimi):
    ``BatchedTTSServer(slots=8, chunk_frames=10, max_pending=32)``,
    ``warmup`` before ``start`` and no graph captured after it.  12
    in-process sessions against 8 slots (``SERVE_SESSIONS``): each ends,
    its delivered PCM equals the offline Mimi decode of its delivered
    frames, and the launches are exact (quant_matmul 576 per frame-step at
    S = 8, flash_attention 144 per frame-step and per admission).  Then
    over HTTP with the DSP watermark: 8 concurrent /tts, a /tts/stream and
    an SSE /v1/audio/speech whose streamed marks verify, a burst past
    max_pending answered 429 with Retry-After, /healthz?deep=1 with the
    canary.  Then, the server stopped, 8 fresh admissions in the pool: one
    tick on the graphs bit-equal to the eager step from the same state,
    sampled (mixed temperature and topk) and greedy.  Prints the numbers of
    the serving cell."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, Session, _on
    from sesameai_tts_tpu_torch.service.http_api import serve
    from sesameai_tts_tpu_torch.watermark import api

    gen, setup = _build_generator(torch, "serve", {})
    torch.cuda.reset_peak_memory_stats()
    srv = BatchedTTSServer(gen, slots=SERVE_SLOTS, chunk_frames=SERVE_CHUNK,
                           max_pending=SERVE_MAX_PENDING)
    t0 = time.perf_counter()
    warm = srv.warmup()
    warmup_s = time.perf_counter() - t0
    clones = (srv._ticker, srv._admitter, srv._canary)

    def n_graphs():
        return sum(len(c._graphs) for c in clones) + len(gen._graphs)

    graphs_at_start = n_graphs()
    srv.start()
    result = {"card": card, "warmup_s": warmup_s,
              "capture_s": {k: v for k, v in warm.items() if "graph_" in k},
              "graphs": graphs_at_start}
    wm = api.load_watermarker(device=gen.device)
    httpd = None
    try:
        # -- in-process traffic, counted
        texts = [f"Session {i} of the serving phase speaks one sentence." for i in
                 range(len(SERVE_SESSIONS))]
        texts[SERVE_LONG_PROMPT] = _text_of_rows(gen, gen.max_seq_len - SERVE_ROOM)
        srv.metrics.reset()
        srv._admitter.metrics.reset()
        _reset_counts(wrappers)
        t0 = time.perf_counter()
        sessions = [srv.submit(text, speaker=0, max_audio_length_ms=ms, temperature=temp,
                               topk=k)
                    for text, (ms, temp, k) in zip(texts, SERVE_SESSIONS)]
        victim = sessions[SERVE_CANCEL]
        chunks = [victim.chunks.get(timeout=120)]
        victim.cancel()
        while chunks[-1] is not None:
            chunks.append(victim.chunks.get(timeout=120))
        audio = [np.concatenate([c for c in chunks if c is not None]) if s is victim
                 else s.audio(timeout=300) for s in sessions]
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while (srv._inflight is not None or any(srv._sessions)) and time.monotonic() < deadline:
            time.sleep(0.01)
        launches = _counts(wrappers)
        frame_steps = int(srv.metrics.summary()["tick_frames"]["total"])
        admissions = int(srv._admitter.metrics.summary()["prefill_s"]["count"])
        frames = [np.concatenate(s.frames_out) if s.frames_out
                  else np.zeros((0, gen._cfg.audio_num_codebooks), np.int32) for s in sessions]
        rel = []
        for f, pcm in zip(frames, audio):
            _check(pcm.shape[0] == f.shape[0] * gen._hop and bool(np.isfinite(pcm).all()),
                   f"serve: {pcm.shape[0]} samples for {f.shape[0]} frames, or not finite")
            if f.shape[0]:
                ref = gen.decode_audio(f)
                rel.append(float(np.abs(pcm - ref).max() / max(np.abs(ref).max(), 1e-12)))
        ttfa = np.array([s.first_audio_at - s.submitted_at for s in sessions
                         if s.first_audio_at is not None]) * 1e3
        delivered = sum(int(f.shape[0]) for f in frames)
        greedy_prefix = {}
        for i, (ms, _, k) in enumerate(SERVE_SESSIONS):
            if k == 1:
                ref = gen.generate_frames(texts[i], 0, [], max_audio_length_ms=ms,
                                          temperature=1.0, topk=1)
                n = min(len(ref), len(frames[i]))
                same = np.all(ref[:n] == frames[i][:n], axis=1)
                greedy_prefix[i] = {"frames": int(frames[i].shape[0]), "b1_frames": len(ref),
                                    "shared_prefix": int(n if same.all() else same.argmin())}
        result["traffic"] = {
            "card": card, "sessions": len(sessions), "wall_s": wall, "delivered_frames": delivered,
            "aggregate_frames_per_s": delivered / wall,
            "frame_steps": frame_steps, "admissions": admissions,
            "slot_use": delivered / max(frame_steps * srv.B, 1),
            "ttfa_ms": {"p50": float(np.percentile(ttfa, 50)),
                        "p95": float(np.percentile(ttfa, 95)), "max": float(ttfa.max())},
            "session_frames": [int(f.shape[0]) for f in frames],
            "long_prompt_frames": int(frames[SERVE_LONG_PROMPT].shape[0]),
            "stream_vs_offline_rel_err_max": max(rel),
            "launches": launches,
            "greedy_prefix_vs_b1_generate_frames": greedy_prefix,
        }
        print("main[serve] traffic " + json.dumps(result["traffic"]), flush=True)
        _check(all(s.finished_at is not None or s is victim for s in sessions),
               "serve: a session did not end")
        _check(max(rel) < 5e-2, f"serve: delivered PCM != offline decode of its frames: {rel}")
        _check(1 <= frames[SERVE_LONG_PROMPT].shape[0] <= SERVE_ROOM,
               f"serve: the long-prompt session gave {frames[SERVE_LONG_PROMPT].shape[0]} "
               f"frames with {SERVE_ROOM} rows of room")
        want = {"quant_matmul": 576 * frame_steps, "quant4_matmul": 0, "quant_mlp": 0,
                "flash_attention": 144 * (frame_steps + admissions)}
        _check(launches == want, f"serve: launches {launches}, want {want} ({frame_steps} "
                                 f"frame-steps at B={srv.B}, {admissions} admissions)")

        # -- over HTTP, the watermark on
        httpd = serve(srv, host="127.0.0.1", port=0, sample_rate=gen.sample_rate,
                      watermarker=(wm, api.CSM_1B_WATERMARK))
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        http = {"card": card}
        replies = []

        def tts(i):
            with _post(base, "/tts", {"text": f"Client {i} asks over HTTP.",
                                      "max_audio_length_ms": 2000}) as r:
                replies.append((r.status, r.headers["Content-Type"], r.read()))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tts, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        http["tts_8_clients_s"] = time.perf_counter() - t0
        _check(len(replies) == 8 and all(st == 200 and ct == "audio/wav" and w[:4] == b"RIFF"
                                         and len(w) > 44 for st, ct, w in replies),
               f"serve: /tts replies {[(st, ct, len(w)) for st, ct, w in replies]}")
        with _post(base, "/tts/stream", {"text": "A streamed answer carries its mark.",
                                         "max_audio_length_ms": SERVE_STREAM_MS}) as r:
            streamed = np.frombuffer(r.read(), np.float32)
        body = {"input": "The speech endpoint streams events.", "response_format": "pcm",
                "stream_format": "sse", "max_audio_length_ms": SERVE_STREAM_MS}
        with _post(base, "/v1/audio/speech", body) as r:
            ctype = r.headers["Content-Type"]
            raw = r.read().decode()
        events = [json.loads(line[len("data: "):]) for line in raw.split("\n\n")
                  if line.startswith("data: ")]
        sse = np.frombuffer(b"".join(base64.b64decode(e["audio"]) for e in events
                                     if e["type"] == "speech.audio.delta"),
                            "<i2").astype(np.float32) / 32767.0
        http["stream"] = {"seconds": streamed.size / gen.sample_rate,
                          "peak": float(np.abs(streamed).max()),
                          "confidence": _confidence(wm, streamed, gen.sample_rate)}
        http["sse"] = {"seconds": sse.size / gen.sample_rate, "events": len(events),
                       "last": events[-1]["type"] if events else None,
                       "confidence": _confidence(wm, sse, gen.sample_rate)}
        _check(streamed.size >= 4 * gen.sample_rate
               and http["stream"]["confidence"] >= wm.verify_threshold,
               f"serve: the streamed response does not verify: {http['stream']}")
        _check(ctype == "text/event-stream" and http["sse"]["last"] == "speech.audio.done"
               and sse.size > 0, f"serve: SSE response {ctype} {http['sse']}")

        # a burst past max_pending with every slot busy: 429 + Retry-After
        hold = [srv.submit(f"Holder {i} keeps a slot busy.", max_audio_length_ms=30_000)
                for i in range(srv.B)]
        deadline = time.monotonic() + 60
        while srv.metrics_summary()["slots_occupied"] < srv.B and time.monotonic() < deadline:
            time.sleep(0.02)
        # an admission's wall time (prefill + first chunk + its fetch) while
        # the full pool ticks on the card beside it; the idle figure is below
        busy_admit_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            item = srv._dispatch_admission(Session(text=texts[i], speaker=0,
                                                   max_audio_length_ms=2000))
            _check(item is not None, "serve: an admission beside the busy pool failed")
            item[-1].wait()
            busy_admit_ms.append((time.perf_counter() - t0) * 1e3)
        http["admission_ms_beside_full_pool"] = busy_admit_ms
        codes = []

        def burst(i):
            try:
                with _post(base, "/tts", {"text": f"Burst {i}.",
                                          "max_audio_length_ms": 400}) as r:
                    r.read()
                    codes.append((r.status, None))
            except urllib.error.HTTPError as e:
                e.read()
                codes.append((e.code, e.headers.get("Retry-After")))
            except OSError as e:  # a reset connection: no reply at all
                codes.append((0, repr(e)))

        threads = [threading.Thread(target=burst, args=(i,)) for i in range(SERVE_BURST)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while (len(codes) < SERVE_BURST - SERVE_MAX_PENDING - 2 * srv.B
               and time.monotonic() < deadline):
            time.sleep(0.02)
        for s in hold:
            s.cancel()
        for t in threads:
            t.join(timeout=300)
        rejected = [ra for c, ra in codes if c == 429]
        http["burst"] = {"requests": SERVE_BURST, "replies": len(codes),
                         "ok": sum(c == 200 for c, _ in codes), "429": len(rejected),
                         "retry_after": sorted(set(rejected))}
        _check(len(codes) == SERVE_BURST and all(c in (200, 429) for c, _ in codes),
               f"serve: burst replies {http['burst']}")
        _check(rejected and all(ra is not None and int(ra) >= 1 for ra in rejected),
               f"serve: no 429 with Retry-After in the burst: {http['burst']}")
        with urllib.request.urlopen(base + "/healthz?deep=1", timeout=300) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            http["metrics_sessions_total"] = json.loads(r.read())["sessions_total"]
        http["healthz"] = health
        print("main[serve] http " + json.dumps(http), flush=True)
        _check(health["status"] == "ok" and health["canary"]["tick_batch"] == srv.B,
               f"serve: /healthz?deep=1 gave {health}")
        result["http"] = http
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
    result["graphs_after_traffic"] = n_graphs()
    _check(result["graphs_after_traffic"] == graphs_at_start,
           f"serve: graphs were captured after start(): {graphs_at_start} → "
           f"{result['graphs_after_traffic']}")

    # -- the pool's graphs against the eager step, from 8 fresh admissions
    admit_ms = []
    for slot in range(srv.B):
        ms, temp, k = SERVE_SESSIONS[slot]
        session = Session(text=texts[slot], speaker=0, max_audio_length_ms=6000,
                          temperature=temp, topk=k)
        t0 = time.perf_counter()
        item = srv._dispatch_admission(session)
        _check(item is not None, f"serve: admission failed: {session.error}")
        item[-1].wait()
        admit_ms.append((time.perf_counter() - t0) * 1e3)
        with _on(srv._ticker):
            srv._attach(slot, item)
    torch.cuda.synchronize()
    ms0 = tree_map(lambda x: x.clone(), srv._mimi_state)
    checks = {}
    for label, greedy in (("sampled", False), ("greedy", True)):
        if greedy:
            srv._ticker._slot(srv.B).bufs.topk.fill_(1)
        ticks = _pool_ticks(torch, srv, greedy, ms0)
        (g, g_ms), (e, e_ms) = ticks["graphed"], ticks["eager"]
        checks[label] = {"frames_bit_equal": bool(np.array_equal(g[0], e[0])),
                         "valid_equal": bool(np.array_equal(g[1], e[1])),
                         "pcm_max_abs_diff": float(np.abs(g[3] - e[3]).max()),
                         "tick_ms_graphed": g_ms, "tick_ms_eager": e_ms}
    codes = torch.from_numpy(g[0]).to(srv._ticker.device).permute(1, 2, 0)
    with _on(srv._ticker):
        t = srv._ticker
        mimi_ms = []
        for _ in range(3):
            state = tree_map(lambda x: x.clone(), ms0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._mimi.decode_streaming(t._mimi_params, codes, state)
            torch.cuda.synchronize()
            mimi_ms.append((time.perf_counter() - t0) * 1e3)
    canary_b8 = srv.link_canary()
    del srv
    _collect(torch)
    srv1 = BatchedTTSServer(gen, slots=1, chunk_frames=SERVE_CHUNK)
    canary_b1 = srv1.link_canary()
    del srv1
    result.update({
        "graph_vs_eager": checks,
        "admission_ms": {"p50": float(np.median(admit_ms)), "max": max(admit_ms),
                         "what": "prefill + first chunk + its fetch, one at a time"},
        "mimi_ms_per_tick": min(mimi_ms),
        "mimi_share_of_tick": min(mimi_ms) / checks["sampled"]["tick_ms_graphed"],
        "canary": {"b8": canary_b8, "b1": canary_b1},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "memory_gb": setup["memory_gb"],
    })
    print("main[serve] " + json.dumps({k: v for k, v in result.items()
                                       if k not in ("traffic", "http")}), flush=True)
    for label, c in checks.items():
        _check(c["frames_bit_equal"] and c["valid_equal"],
               f"serve: the pool's {label} tick on the graphs differs from the eager step: {c}")
    del gen
    _collect(torch)
    return result


def _collect(torch) -> None:
    """Free the device memory of generators the caller has dropped: a
    Generator holds a reference cycle (its tokenizer's audio encoder)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_profile(torch, wrappers):
    """Each configuration's profiled windows, after every counted request
    (a torch.profiler session leaves the host slower at issuing kernels
    for the rest of the process, so no counted request may follow one):
    the window of one short request on the graphs and on the eager twin,
    and the graphed step alone (``_graph_step``).  Then the sampler's
    threshold search alone."""
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    for path, fields, _, _ in _PATHS:
        gen = build_generator(csm_1b_spec(**fields), device="cuda")
        gen.warmup()
        result = {"graphed": _profile_decode(torch, gen, wrappers),
                  "step": _graph_step(torch, gen)}
        twin = _eager_twin(gen)
        twin.generate("warm up", 0, [], max_audio_length_ms=240, temperature=0.8, topk=40,
                      seed=7)
        result["eager"] = _profile_decode(torch, twin, wrappers)
        print(f"profile[{path}] " + json.dumps(result), flush=True)
        del gen, twin
        _collect(torch)
    print("sampler " + json.dumps(_sampler_timing(torch)), flush=True)


# kernel kinds of the device split, by a piece of the kernel's name; the
# first match names the kind
_KINDS = (
    ("quant_matmul", "qmm_"), ("quant4_matmul", "q4mm_"), ("quant_mlp", "qmlp_"),
    ("flash_attention", "flash_fwd"), ("direct_copy", "direct_copy"), ("cat", "CatArray"),
    ("index / gather", "index"), ("random", "distribution"), ("reduce", "reduce_kernel"),
    ("cuBLAS", "gemm"), ("cuBLAS", "gemv"), ("cuBLAS", "cutlass"),
    ("elementwise, other", "elementwise"),
)


def _device_kernels(torch, prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _split(kernels, per: int = 1) -> dict:
    """{kind: [device ms, launches]} of profiled kernels, divided by per."""
    out = {}
    for e in kernels:
        kind = next((k for k, piece in _KINDS if piece in e.key), "other")
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + _dev_us(e) / 1e3 / per, n + e.count / per)
    return {k: [round(ms, 4), n] for k, (ms, n) in sorted(out.items(), key=lambda kv: -kv[1][0])}


def _profile_decode(torch, gen, wrappers) -> dict:
    """Device busy share and kernel mix of one short request (prefill + 4
    decoded frames) under torch.profiler, device activity only (host-side
    events make the trace's processing take minutes), with the port
    kernels' launches in the window beside the profiler's count of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _counts(wrappers)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_frames(TEXT_2, 0, [], max_audio_length_ms=400, temperature=0.8, topk=40,
                            seed=2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    port_launches = {k: n - before[k] for k, n in _counts(wrappers).items()}
    kernels = _device_kernels(torch, prof)
    if not kernels:
        return {"window": "prefill + 4 decoded frames", "device_time": "not measured",
                "wall_ms_profiled": wall_ms, "port_launches": port_launches}
    device_ms = sum(_dev_us(e) for e in kernels) / 1e3
    split = _split(kernels)
    return {
        "window": "prefill + 4 decoded frames, profiled",
        "wall_ms_profiled": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "port_launches": port_launches,
        "port_launches_seen": {k: split.get(k, [0, 0])[1] for k in port_launches},
        "split": split,
        "top": [[e.key[:70], _dev_us(e) / 1e3, e.count]
                for e in sorted(kernels, key=_dev_us, reverse=True)[:8]],
    }


def _graph_step(torch, gen) -> dict:
    """The graphed step alone: ``GRAPH_STEP_FRAMES`` sampled frames as
    back-to-back replays of the backbone and sampling graphs from a
    ``_FRAME_CACHE_FILL``-row cache, timed by CUDA events (device ms per
    frame; the host only launches the graphs) and by the host's clock
    until the last launch returns (the host's ms per frame), then the same
    frames under the profiler, split by kernel kind per frame."""
    from torch.profiler import ProfilerActivity, profile

    from sesameai_tts_tpu_torch.models import csm

    backbone, sample = gen._graphs[(1, "backbone", False)], gen._graphs[(1, "sample", False)]
    state, bufs = gen._slot(1)

    def frames():
        for _ in range(GRAPH_STEP_FRAMES):
            backbone.replay()
            sample.replay()

    with gen._request():
        csm.set_sampling(bufs, 0.8, 40)
        state.pos.fill_(_FRAME_CACHE_FILL)
        frames()
        state.pos.fill_(_FRAME_CACHE_FILL)
        torch.cuda.synchronize()
        ms = _events_ms(torch, frames) / GRAPH_STEP_FRAMES
        state.pos.fill_(_FRAME_CACHE_FILL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames()  # the launches return before the device ends
        host_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEP_FRAMES
        torch.cuda.synchronize()
        state.pos.fill_(_FRAME_CACHE_FILL)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            frames()
            torch.cuda.synchronize()
        csm.load_state(state)
    kernels = _device_kernels(torch, prof)
    result = {"frames": GRAPH_STEP_FRAMES, "cache_rows": _FRAME_CACHE_FILL,
              "device_ms_per_frame_events": ms, "host_launch_ms_per_frame": host_ms}
    if kernels:
        result.update({
            "profiled_kernel_ms_per_frame": sum(_dev_us(e) for e in kernels) / 1e3
            / GRAPH_STEP_FRAMES,
            "kernels_per_frame": sum(e.count for e in kernels) / GRAPH_STEP_FRAMES,
            "split_per_frame": _split(kernels, GRAPH_STEP_FRAMES)})
    else:
        result["profiled"] = "no device kernels seen"
    return result


def _sampler_timing(torch) -> dict:
    """The sampler's top-k threshold (the JAX package's 4-phase 32-way
    bracket search, ``topk_threshold``) and a whole ``sample_topk`` with
    tensor temperature and topk, as the sampled graph calls them, on one
    (1, 2051) row: device µs per call by CUDA-graph replay, and per
    decoded frame (K = 32 calls); ``torch.topk``'s k-th value beside."""
    from sesameai_tts_tpu_torch.ops import sampling

    gen = torch.Generator(device="cuda").manual_seed(4)
    logits = torch.randn((1, 2051), generator=gen, device="cuda") * 3
    gumbel = sampling.gumbel_noise(gen, logits.shape)
    k = torch.full((1,), 40, dtype=torch.int64, device="cuda")
    temperature = torch.full((1,), 0.8, device="cuda")
    calls = {
        "topk_threshold": lambda i: sampling.topk_threshold(logits, k[..., None]),
        "sample_topk": lambda i: sampling.sample_topk(None, logits, k, temperature,
                                                      gumbel=gumbel),
        "torch.topk kth value": lambda i: torch.topk(logits, 40).values[..., -1:],
    }
    out = {}
    for name, fn in calls.items():
        us = _device_ms(torch, fn, 64) * 1e3
        out[name] = {"us_per_call": us, "ms_per_frame": us * 32 / 1e3}
    return out


def _sibling(gen, params, fused_mlp: bool = False):
    """A Generator over another CSM tree that shares gen's codec and text
    tokenizer."""
    from sesameai_tts_tpu_torch.runtime.generator import Generator

    return Generator(params, gen._cfg, gen._mimi, gen._mimi_params,
                     gen._tokenizer.text_tokenizer, device=gen.device, fused_mlp=fused_mlp)


def phase_qa(torch):
    """Teacher-forced agreement at full width, from one bf16 tree (seed 0).

    Gated pairs: each computes one function twice and differs only in the
    kernel's arithmetic, so the codebook-0 logits must agree closely:
    - the int4 generator against a twin that runs the dense bf16
      dequantization of the same int4 tree (its prefill shadow);
    - the fused int8 generator against the unfused one on the same tree.
    Both sides round activations to bf16 at every trunk linear; they differ
    in where the f32 sums are cut and whether a product's output rounds to
    bf16 before the next op.  Informational: ``quant_acceptance`` of int8
    and of int4 against the bf16 tree (random weights at half-matrix int4
    groups sit below the int8 gate, so int4 is not gated on it)."""
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm
    from sesameai_tts_tpu_torch.runtime import qa
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    t0 = time.perf_counter()
    dense = build_generator(csm_1b_spec(quantize=None), device="cuda")
    g8 = _sibling(dense, quantize_csm(dense._params, bits=8))
    fused = _sibling(dense, g8._params, fused_mlp=True)
    g4 = _sibling(dense, quantize_csm(dense._params, bits=4))
    g4_twin = _sibling(dense, g4._prefill_params)  # dense bf16 of the same int4 tree
    built_s = time.perf_counter() - t0
    result = {"steps": QA_STEPS, "built_s": built_s}
    for name, gen_q, gen_ref in (("int4_vs_dense_twin", g4, g4_twin),
                                 ("fused_vs_unfused", fused, g8)):
        t0 = time.perf_counter()
        rep = qa.teacher_forced_agreement(gen_q, gen_ref, QA_TEXT, steps=QA_STEPS)
        result[name] = {**rep, "min_logit_snr_db": QA_MIN_SNR_DB[name],
                        "s": time.perf_counter() - t0}
        print(f"qa {name} " + json.dumps(result[name]), flush=True)
    for name, gen_q in (("int8_acceptance", g8), ("int4_acceptance", g4)):
        t0 = time.perf_counter()
        result[name] = {**qa.quant_acceptance(gen_q, dense, QA_TEXT, steps=QA_INFO_STEPS),
                        "s": time.perf_counter() - t0}
        print(f"qa {name} (information) " + json.dumps(result[name]), flush=True)
    del dense, g8, fused, g4, g4_twin
    _collect(torch)
    for name, floor in QA_MIN_SNR_DB.items():
        rep = result[name]
        _check(rep["steps"] >= 30, f"qa {name}: only {rep['steps']} steps evaluated")
        _check(rep["self_consistency"] == 1.0,
               f"qa {name}: the teacher-forced replay does not reproduce the decode")
        _check(rep["logit_snr_db"] >= floor,
               f"qa {name}: logit SNR {rep['logit_snr_db']:.2f} dB < {floor} dB")
    return result


def phase_parity(torch, attention):
    """The tiny f32 model, greedy, on the card (its attention through the
    f32 hd-16 kernel) against the CPU (the plain version)."""
    import numpy as np

    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec

    outs = {}
    for device in ("cpu", "cuda"):
        gen = build_generator(test_tiny_spec(), device=device, decode_chunk_frames=4)
        before = attention.flash_attention.launches
        frames = gen.generate_frames("the quick brown fox jumps", 0, [],
                                     max_audio_length_ms=1200, temperature=1.0, topk=1)
        launched = attention.flash_attention.launches - before
        outs[device] = (frames, gen.decode_audio(frames))
    (f_cpu, a_cpu), (f_gpu, a_gpu) = outs["cpu"], outs["cuda"]
    err = float(np.abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else float("inf")
    peak = float(np.abs(a_cpu).max())
    result = {"frames": int(f_cpu.shape[0]), "frames_equal": bool(np.array_equal(f_cpu, f_gpu)),
              "pcm_max_abs_err": err, "pcm_peak": peak, "flash_attention_launches": launched}
    print("parity " + json.dumps(result), flush=True)
    _check(launched > 0, "tiny model on the card did not launch flash_attention")
    _check(result["frames_equal"], "tiny greedy frames differ between cuda and cpu")
    # f32 with TF32 off: only the order of sums differs
    _check(err <= 1e-4 * max(peak, 1.0), f"tiny PCM differs between cuda and cpu: {err}")
    return result


def _entry(name: str, source: str, replaces: str, rows, launches: dict, path: str,
           library: str) -> dict:
    """One kernel's line: times summed over one decoded frame's launches at
    the main path's S=1 (the default G=2 for int4), shape rows beside."""
    main_rows = [r for r in rows if r["S"] == 1 and r.get("G", 2) == 2]

    def per_frame(key):
        return sum(r[key] * r["per_frame"] for r in main_rows)

    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[path][name],
        "launches_by_path": {p: c[name] for p, c in launches.items() if c[name]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_frame("kernel_ms"),
        "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": "bytes",
        "library_ms": per_frame("library_ms"),
        "library": library,
        **({"unfused_pair_ms": per_frame("unfused_ms")} if "unfused_ms" in main_rows[0] else {}),
        "timed_as": f"device time (CUDA graph replay, weights past L2) summed over one "
                    f"decoded frame's launches on the {path} path at S=1",
        "shapes": [{k: r[k] for k in ("shape", "S", "D", "F", "G", "Dout", "kernel_ms",
                                      "kernel_eager_ms", "plain_ms", "library_ms", "bound_ms",
                                      "unfused_ms", "block_i", "threads", "prefetch_rows",
                                      "smem", "cluster", "blocks", "max_abs_err",
                                      "replay_max_abs_err") if k in r}
                   for r in rows],
    }
    entry["max_err"] = entry["max_abs_err"]
    entry["kernel_ms"] = entry["ms"]
    return entry


def _flash_entry(rows, launches: dict, cfg, peak_bw: float) -> dict:
    """flash_attention's line: times summed over one decoded frame's
    launches (the backbone's layers at a ``_FRAME_CACHE_FILL``-row cache,
    the decoder's layers at each of its codebook steps, each decoder call
    taken as the mean of its first and last positions), shape rows beside.
    The bound is summed exactly over the frame's calls."""
    bb, dec = cfg.backbone, cfg.decoder
    backbone = next(r for r in rows if r["S"] == 1 and r["pos0"] == [_FRAME_CACHE_FILL])
    decoder = [r for r in rows if r["hd"] == dec.head_dim and r["S"] == 1 and r["B"] == 1]
    n_bb, n_dec = bb.num_layers, cfg.audio_num_codebooks * dec.num_layers

    def per_frame(key):
        return backbone[key] * n_bb + sum(r[key] for r in decoder) / len(decoder) * n_dec

    t_bound = backbone["bound_ms"] * n_bb
    for p in range(cfg.audio_num_codebooks):
        nbytes, _ = _attn_work(1, dec.num_heads, dec.num_kv_heads, dec.head_dim, 1, (p,), (1,),
                               2)
        t_bound += dec.num_layers * nbytes / peak_bw * 1e3
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "sesameai_tts_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sesameai_tts_tpu/ops/attention.py:86",
        "launches": launches["voice"]["flash_attention"],
        "launches_by_path": {p: c["flash_attention"] for p, c in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_frame("kernel_ms"),
        "plain_ms": per_frame("plain_ms"),
        "bound_ms": t_bound,
        "bound_by": "bytes",
        "library_ms": per_frame("library_ms"),
        "library": "torch.nn.functional.scaled_dot_product_attention, boolean mask, "
                   "enable_gqa=True",
        "timed_as": f"device time (CUDA graph replay; the backbone cache cycled past L2) summed "
                    f"over one decoded frame's {n_bb} backbone calls at a "
                    f"{_FRAME_CACHE_FILL}-row cache and {n_dec} decoder calls",
        "shapes": [{k: r[k] for k in ("shape", "S", "route", "pos0", "valid_len", "kernel_ms",
                                      "kernel_eager_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "max_abs_err", "replay_max_abs_err", "atol")}
                   for r in rows],
    }
    entry["max_err"] = entry["max_abs_err"]
    entry["kernel_ms"] = entry["ms"]
    return entry


def _frame_step_b8(rows: dict, cfg, peak_bw: float) -> dict:
    """One frame-step of a serving pool of 8 slots, summed over its launches
    as ``_entry`` / ``_flash_entry`` sum a decoded frame: the quant kernels'
    S=8 rows (int4 at its default G=2), and flash_attention's B=8 rows (the
    backbone's rows at their own positions, the decoder's the mean of its
    first and last codebook step; the bound summed over every step)."""
    out = {}
    for name in ("quant_matmul", "quant4_matmul", "quant_mlp"):
        eight = [r for r in rows[name] if r["S"] == 8 and r.get("G", 2) == 2]
        out[name] = {k: sum(r[k] * r["per_frame"] for r in eight)
                     for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    attn = [r for r in rows["flash_attention"] if r["B"] == 8]
    backbone = next(r for r in attn if r["hd"] == cfg.backbone.head_dim)
    decoder = [r for r in attn if r["hd"] == cfg.decoder.head_dim]
    n_bb, n_dec = cfg.backbone.num_layers, cfg.audio_num_codebooks * cfg.decoder.num_layers
    fa = {k: backbone[k] * n_bb + sum(r[k] for r in decoder) / len(decoder) * n_dec
          for k in ("kernel_ms", "plain_ms", "library_ms")}
    dec = cfg.decoder
    fa["bound_ms"] = backbone["bound_ms"] * n_bb + sum(
        dec.num_layers * _attn_work(8, dec.num_heads, dec.num_kv_heads, dec.head_dim, 1,
                                    (p,) * 8, (1,) * 8, 2)[0] / peak_bw * 1e3
        for p in range(cfg.audio_num_codebooks))
    out["flash_attention"] = fa
    return out

def _graphed_vs_eager(paths: dict) -> dict:
    """Each path's end-to-end numbers on the graphs beside the eager twin's."""
    keys = ("ms_per_decoded_frame", "rtf", "first_chunk_ms", "peak_mem_gb")
    return {path: {"graphed": {k: r[k] for k in keys}, "eager": {k: r["eager"][k] for k in keys},
                   "capture_s": r["capture_s"], "memory_gb": r["memory_gb"],
                   "clone_added_gb": r["graph_checks"]["clone"]["added_gb"]}
            for path, r in paths.items()}


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
        from sesameai_tts_tpu_torch.core.config import csm_1b
        from sesameai_tts_tpu_torch.ops import attention, kernels, quant
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script: {e}", file=sys.stderr)
        return 1
    if not os.path.abspath(quant.__file__).startswith(HERE + os.sep):
        print("chip_smoke: the port package was not imported from this checkout", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_s = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[label] = round(time.perf_counter() - t0, 1)
        return out

    wrappers = {name: getattr(attention if name == "flash_attention" else quant, name)
                for name in kernels.KERNELS}
    try:
        name, card = phase_device(torch)
        peak_bw, peak_flops = _peaks(name)
        timed("build", phase_build, kernels)
        rows = {k: timed(k, fn, torch, mod, peak_bw, peak_flops) for k, fn, mod in (
            ("quant_matmul", phase_quant_matmul, quant),
            ("quant4_matmul", phase_quant4_matmul, quant),
            ("quant_mlp", phase_quant_mlp, quant),
            ("flash_attention", phase_flash_attention, attention))}
        paths = {}
        for path, fields, per_frame, voice in _PATHS:
            paths[path] = timed(f"main[{path}]", phase_main_path, torch, wrappers, path,
                                fields, per_frame, voice)
        paths["voice"] = timed("main[voice]", phase_voice_path, torch, wrappers, _PATHS[0][2])
        cli = timed("main[cli]", phase_cli, torch, wrappers, _PATHS[0][2])
        serving = timed("main[serve]", phase_serve, torch, wrappers, card)
        rehearsal = timed("main[smoke]", phase_smoke, torch, wrappers, card)
        launches = {path: r["launches"] for path, r in paths.items()}
        launches["cli"] = cli["launches"]
        launches["serve"] = serving["traffic"]["launches"]
        launches["smoke"] = rehearsal["launches"]
        print("graphed vs eager " + json.dumps(_graphed_vs_eager(paths)), flush=True)
        timed("profile", phase_profile, torch, wrappers)
        timed("qa", phase_qa, torch)
        timed("parity", phase_parity, torch, attention)
    except Exception as e:  # any phase failing fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    entries = [
        _entry("quant_matmul", "sesameai_tts_tpu_torch/csrc/quant_matmul.cu",
               "sesameai_tts_tpu/ops/quant.py:135", rows["quant_matmul"], launches, "int8",
               "torch.matmul on a pre-dequantized bf16 weight"),
        _entry("quant4_matmul", "sesameai_tts_tpu_torch/csrc/quant4_matmul.cu",
               "sesameai_tts_tpu/ops/quant.py:202", rows["quant4_matmul"], launches, "int4",
               "torch.matmul on a pre-dequantized bf16 weight"),
        _entry("quant_mlp", "sesameai_tts_tpu_torch/csrc/quant_mlp.cu",
               "sesameai_tts_tpu/ops/quant.py:286", rows["quant_mlp"], launches, "fused",
               "several calls: torch.matmul x3, silu and a product on dense bf16 weights"),
        _flash_entry(rows["flash_attention"], launches, csm_1b(), peak_bw),
    ]
    decode_ms = {r["pos0"][0]: r["kernel_ms"] for r in rows["flash_attention"]
                 if r["S"] == 1 and r["B"] == 1 and r["hd"] == 64}
    print("kernel flash_attention per decoded frame " + json.dumps(
        {**{k: entries[-1][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "timed_as")},
         "backbone_decode_2047_over_600": decode_ms[2047] / decode_ms[600]}), flush=True)
    print("kernel per frame-step at B=8 " + json.dumps(_frame_step_b8(rows, csm_1b(), peak_bw)),
          flush=True)
    print("kernel flash_attention prefill per call (us) " + json.dumps(
        {r["shape"]: {k: None if r[k] is None else r[k] * 1e3
                      for k in ("kernel_ms", "library_ms", "bound_ms", "plain_ms")}
         for r in rows["flash_attention"] if r["S"] > 1}), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"{json.dumps(phase_s)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
