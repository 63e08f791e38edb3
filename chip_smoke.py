#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sesameai_tts_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and ``nvcc``; exits non-zero without them.
Phases, each of which fails the run if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel in ``csrc/`` (one ``nvcc`` per source, all
   started together) and print each build's time;
3. kernels vs plain: ``quant_matmul``, ``quant4_matmul`` (each row
   naming its route: the CUDA cores at S = 1, the tensor cores at 2-64),
   ``quant_mlp`` and ``flash_attention`` against their plain PyTorch
   versions at the main paths' shapes (and the tensor-core prefill at hd
   128), eagerly
   and from a CUDA-graph replay, a repeated call and the replay bit-equal
   to the first call, each timed beside its plain version, a library
   yardstick and the card's bound (``quant_mlp`` also beside the port's
   unfused int8 pair: two ``quant_matmul`` calls around the silu and
   product); then ``flash_attention_bwd`` against
   ``flash_attention_bwd_plain`` at the training shapes (backbone S = 256,
   512, 2048, a right-padded row, a row without keys; decoder S = 32; one
   tp = 2 rank's heads of each at S = 256 and 32), bf16 (the tensor-core
   route) and f32 (the CUDA-core route), each timed beside its plain
   version, the backward of one ``scaled_dot_product_attention`` call and
   the card's bound, and summed over a mixed training step's 16 backbone
   calls (S = 256, and 2048) and 4 decoder calls; then
   ``quant_matmul``, ``quant_mlp`` and ``flash_attention`` at one rank's
   shard shapes of a tp = 2 mesh (``phase_shards``: the eight trunk linears
   at S = 1 and 2, the MLPs at I/2, decode and prefill attention over the
   local heads), the same checks and times;
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
   events and the sampler alone, its kernel against its plain path at one
   stream's shape and the pool's.  Before the profiled
   windows, ``main[cli]``: the command line from files (a 6.2 GB CSM-1B
   checkpoint written and read back bit-equal, a Llama-3-format
   tokenizer.json, a Mimi ``save_pytree`` file, a voice) speaks two
   sentences into a watermarked WAV; its launches, the WAV, the watermark
   and greedy frames against a Generator built in memory are checked.
   Right after the int8 path, ``main[apps]`` (``phase_apps``): the app
   layer on a clone of its warmed Generator over a loopback LLM/STT server
   on 127.0.0.1: ChatApp (query → sentence pump, a topk=1 re-run against
   the engine), StorytellerApp (LLM and pasted continuations, the replay,
   the combined WAV) and four DuplexVoiceApp turns (16 kHz user audio →
   rolling context with a pinned voice prefix → streamed reply → one
   frame per chunk), quant_matmul and flash_attention counted over them;
   then Mimi.encode_streaming against Mimi.encode, f32 on the card, and
   the native (g++) audio backend against the numpy paths.
   Then ``main[serve]``: an 8-slot ``BatchedTTSServer`` over CSM-1B int8
   (``phase_serve``: 12 in-process sessions with exact launches and PCM
   equal to the offline decode of their frames, the HTTP API with the
   streaming watermark and a burst answered 429, the pool's graphed tick
   bit-equal to the eager step, no graph captured after ``start()``).
   Then ``main[hybrid]`` (``phase_hybrid``): LFM2-8B-A1B as CSM's backbone
   (int8, weights drawn on the card): ``expert_swiglu`` against
   ``expert_swiglu_plain`` at the published expert shape with the model's
   own routing at 1, 16 and 64 rows, eagerly and from a graph replay,
   timed beside its plain version and the card's bound; then a 16-slot
   pool's graphed tick bit-equal to the eager step, sampled and greedy,
   with exact launches (``expert_swiglu`` 66 a frame-step: 3 in each of
   22 routed layers) and the experts-hit counters read from the card.
   Then ``main[smoke]`` (``phase_smoke``): the silentcipher network at the
   real grid (44.1 kHz, n_fft 2048, hop 512, 5 × 256, hidden 32) on a 12.6 s
   clip, encode and phase-shift decode on the card against the CPU and the
   streaming embed against the offline one; then the real-weights rehearsal,
   ``sesame-tts-torch-fixtures`` files of CSM-1B → ``sesame-tts-torch-smoke
   --weights-dir`` (convert, load int8, generate, quant gate, codec, the
   network's watermark, /tts and /tts/stream), exit code 0, the network's
   streaming blocks on the card, quant_matmul and flash_attention launched.
   Then ``main[train]`` (``phase_train``): ``sesame-tts-torch-finetune`` at
   CSM-1B full width from the random init: a mixed full finetune whose loss
   falls, an interrupted LoRA run resumed bit-equal to an unbroken one, its
   merged export served (int8), the tiny train step card against CPU, exact
   forward and backward attention launches.
   Then ``main[mesh]`` (``phase_mesh``): processes that this script spawns
   share the one card over gloo as a mesh, CSM-1B int8 from seed 0 on each:
   (a) dp 1, tp 2: a Generator serves a greedy 2 s and a sampled request,
   both ranks' frames identical, the PCM finite and 80 ms per frame, exact
   launches per step on each rank, the teacher-forced logits over the
   greedy frames within 30 dB SNR of the parent's single-process Generator;
   (b) dp 2, tp 1: a 4-slot ``BatchedTTSServer``, 2 slots and CUDA graphs
   per rank, six greedy sessions (one cancelled), each finished session's
   codes equal to a one-process 2-slot pool's.
   Then ``main[train_mesh]`` (``phase_train_mesh``): ``sesame-tts-torch-
   finetune --mesh`` at CSM-1B full width on two spawned ranks sharing the
   card over gloo: (a) dense at dp 1, tp 2, one f32 step against the
   one-card step (loss, grad_norm), then a mixed finetune whose export is
   gathered and (c) served by a one-card int8 Generator; (b) LoRA at dp 2,
   tp 1 with remat, the adapters equal on both ranks and close to one
   process's; exact attention launches a rank at the rank's local heads;
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
# S = 1 is the single-stream decode (quant_matmul and quant4_matmul on the
# CUDA cores), S = 2 the rehearsal's 2-slot serving pool, S = 8 the 8-slot
# pool, S = 64 the widest qdot sends to a kernel (2-64 on the tensor cores,
# for quant_mlp too)
_S_VALUES = (1, 2, 4, 8, 64)
# one rank's shards at tp = 2 (parallel/mesh.py): the trunk linears (qkv
# holds H/2 q heads and their kv heads: the decoder's one of its 2; w13 I/2
# columns of w1 and of w3; o_proj and w2 half their rows), the MLPs at I/2,
# and the attention of the local heads; the main[mesh] path's shapes
_TP2_SHAPES = (
    ("backbone.qkv tp2", 2048, 1536, 16),
    ("backbone.o_proj tp2", 1024, 2048, 16),
    ("backbone.w13 tp2", 2048, 8192, 16),
    ("backbone.w2 tp2", 4096, 2048, 16),
    ("decoder.qkv tp2", 1024, 768, 128),
    ("decoder.o_proj tp2", 512, 1024, 128),
    ("decoder.w13 tp2", 1024, 8192, 128),
    ("decoder.w2 tp2", 4096, 1024, 128),
)
_TP2_MLP_SHAPES = (
    ("backbone.mlp tp2", 2048, 4096, 2048, 16),
    ("decoder.mlp tp2", 1024, 4096, 1024, 128),
)
# S = 1 a rank's decode; S = 2 its rows of a 4-slot pool; S = 64 a prompt's
# rows through the backbone's shards in (a)'s prefill (qdot's kernel route)
_TP2_S_VALUES = (1, 2, 64)
_TP2_ATTN_CASES = (
    ("backbone decode tp2 pos 600", 1, 16, 4, 64, 2048, 1, (600,), (1,)),
    ("decoder step tp2 pos 0", 1, 4, 1, 128, 32, 1, (0,), (1,)),
    ("decoder step tp2 pos 31", 1, 4, 1, 128, 32, 1, (31,), (1,)),
    ("backbone prefill tp2 S=512", 1, 16, 4, 64, 2048, 512, (0,), (500,)),
)
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
# of them, the frames under the profiler (its trace costs ~0.1 ms of host
# time per kernel, ~10,800 kernels a frame; depth cut from 16 to fit the run)
GRAPH_STEP_PROFILED_FRAMES = 4

# the main paths: ModelSpec fields, kernel launches per decoded frame, and
# whether the voice-context request runs
_PATHS = (
    ("int8", {}, {"quant_matmul": 576, "quant4_matmul": 0, "quant_mlp": 0, "expert_swiglu": 0},
     True),
    ("int4", {"quantize": "int4"}, {"quant_matmul": 0, "quant4_matmul": 576, "quant_mlp": 0,
                                    "expert_swiglu": 0}, False),
    ("fused", {"fused_mlp": True}, {"quant_matmul": 288, "quant4_matmul": 0, "quant_mlp": 144,
                                    "expert_swiglu": 0}, False),
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

# flash_attention_bwd phase: (label, B, H, KV, hd, S, valid_end per row), every
# call cache-free (T = S, pos0 0) as in training: the backbone at the main[train]
# bucket (S = 256), at 512 and 2048, a right-padded row, a row that sees no key,
# and the decoder over its K = 32 positions (B = batch 2 x 4 decoder frames)
_BWD_CASES = (
    ("backbone S=256", 2, 32, 8, 64, 256, (256, 256)),
    ("backbone S=512", 2, 32, 8, 64, 512, (512, 512)),
    ("backbone S=2048", 2, 32, 8, 64, 2048, (2048, 2048)),
    ("backbone S=512 right-padded", 2, 32, 8, 64, 512, (512, 300)),
    ("backbone S=256 row without keys", 2, 32, 8, 64, 256, (256, 0)),
    ("decoder S=32", 8, 8, 2, 128, 32, (32,) * 8),
    # one rank's heads on a tp = 2 mesh (main[train_mesh] (a)): the backbone's
    # 16 query and 4 kv heads, the decoder's 4 and its 1
    ("backbone tp2 shard S=256", 2, 16, 4, 64, 256, (256, 256)),
    ("decoder tp2 shard S=32", 8, 4, 1, 128, 32, (32,) * 8),
)
# dense f32 rate outside the tensor cores, by card name (NVIDIA data sheets):
# the bound of an f32 gradient, whose products run on CUDA cores
_F32_FLOPS = (("H200", 67e12), ("H100 NVL", 60e12), ("H100 PCIe", 51e12), ("H100", 67e12))
# both take the same operand values and sum in f32 in another order, then
# round to the dtype once: bf16 within one ulp (1e-2 relative) plus f32 noise
# under 1e-3 of the peak; f32 within 1e-4 relative plus 1e-4 of the peak
_BWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}

# main[train]: CSM-1B at full width from the random init of seed 0; speech-like
# 24 kHz clips with transcripts, half held out (--eval-frac 0.5), so the two
# training clips make one batch of 2 per epoch and every step sees it
TRAIN_CLIPS_S = (2.2, 3.1, 4.4, 5.6)
TRAIN_STEPS = 5  # the full mixed finetune
# its learning rate: at the CLI's default 1e-4 the random init's loss overshoots
# within the five steps (PERF.md §6)
TRAIN_LR = 3e-5
LORA_STEPS, LORA_SPLIT = 4, 2  # LoRA steps, and the saved step an interrupted run resumes from
TRAIN_SERVE_MS = 2000
# card vs CPU at the tiny f32 flavor (TF32 off: only the order of f32 sums differs)
TRAIN_PARITY_LOSS_RTOL = 1e-5
TRAIN_PARITY_GRAD_TOL = 1e-4  # of each leaf's largest magnitude

# main[train_mesh]: sesame-tts-torch-finetune --mesh at CSM-1B full width (the init
# and clips of main[train]) on two ranks that share the card over gloo
TRAIN_MESH_TIMEOUT_S = 600  # a world of ranks, set-up included
TRAIN_MESH_LOSS_RTOL = 1e-5  # (a) f32 on tp 2 against one card: the tp sums add in
TRAIN_MESH_NORM_RTOL = 1e-4  # another order (TF32 off)
# (b) LoRA on dp 2 against one process: the first step's gradient (the sum of
# the two ranks' rows) at the same point, then the adapters after the run,
# which Adam's normalized steps pull apart where an element's gradient is
# near its rounding: such an element moves by up to ~lr a step either way
TRAIN_MESH_LORA_LOSS_RTOL = 1e-4
TRAIN_MESH_LORA_GRAD_TOL = 1e-4  # of each gradient leaf's peak
TRAIN_MESH_LORA_TOL = 1e-2  # of each adapter leaf's peak
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
SERVE_TICK_REPS = 3  # graphed ticks from one state, the fastest kept (the pools' tick ms)

# main[hybrid]: LFM2-8B-A1B as CSM's backbone, int8.  The expert kernel at
# these rows (one stream, the benchmark's 16-slot pool, the kernel's most);
# a pool of HYBRID_SLOTS, one admission a slot; per frame-step the launches
# of 18 conv (in_proj, out_proj), 6 attention (qkv, o_proj) and 2 dense
# FFN (w13, w2) layers, 22 routed layers (up, down, sum) and CSM-1B's
# 32 decoder passes
HYBRID_ROWS = (1, 16, 64)
HYBRID_SLOTS = 16
HYBRID_PER_FRAME = {"quant_matmul": 36 + 12 + 4 + 512, "quant4_matmul": 0, "quant_mlp": 0,
                    "flash_attention": 6 + 128, "flash_attention_bwd": 0, "expert_swiglu": 66}

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

# main[apps]: the app layer on a clone of the int8 path's warmed Generator,
# over a loopback OpenAI-compatible server on 127.0.0.1 (a stand-in for the
# LLM and transcription endpoints; no network).  The reply is three
# sentences; its SSE deltas split words and the decimal "2.5", which
# sentence_stream keeps whole (the chat's split_clean_sentences, as in the
# JAX package, spaces it to "2. 5" and queues four sentences).  Every
# synthesized sentence is capped at AUDIO_MS, the other paths' request budget.
APPS_REPLY = "The loopback model answers in three sentences. It costs 2.5 dollars today! " \
             "Is that fine?"
APPS_DELTAS = ("The loop", "back model answers in three sen", "tences. It costs 2", ".5 dol",
               "lars today! Is that", " fine?")
APPS_TRANSCRIPT = "Tell me something about the weather."
APPS_PASTED = "The pasted part has two sentences. It ends right here."
APPS_SPEED = 1.2
APPS_TURNS = 4  # duplex user turns of APPS_TURN_S at APPS_TURN_RATE (resampled to 24 kHz)
APPS_TURN_S, APPS_TURN_RATE = 4.0, 16_000
APPS_PCM_TOL = 1e-3  # the topk=1 re-run against the direct call, of its peak
# A8: a 12.6 s clip padded to whole 2-frame chunks, streamed in 2-frame chunks
# against the offline encode, both f32 on the card with TF32 off; codebook 0
# must agree on this share of frames (the CPU tests hold all codebooks exact)
APPS_ENCODE_CHUNK = 2
APPS_ENCODE_MIN_EQUAL = 0.99
APPS_NATIVE_TOL = 5e-4  # resample_native vs resample, as tests/test_audio.py

# main[mesh]: CSM-1B int8 at full width on a mesh of processes that share the
# one card over gloo.  (a) dp 1, tp 2: a greedy request of MESH_MS and a
# sampled one of MESH_SAMPLED_MS on a Generator, teacher-forced logits over the greedy frames held
# against the parent's single-process Generator (both prefill through the
# int8 trunks, so the two differ only in the order of the tp partial sums);
# (b) dp 2, tp 1: a 4-slot BatchedTTSServer, 2 slots per rank, warmed up on
# every rank, over MESH_SESSIONS (text, ms) greedy, one cancelled at its
# first audio, each finished session's codes equal to a one-process 2-slot
# pool's, on a mesh of one and on no mesh (the single-card server)
MESH_TEXT = "The mesh speaks."
MESH_SAMPLED_TEXT = "Two ranks, one voice."
MESH_MS = 2000
MESH_SAMPLED_MS = 800
MESH_MIN_SNR_DB = 30.0
MESH_SESSIONS = (("First of six.", 1600), ("The second one is longer.", 2400),
                 ("Third.", 800), ("The fourth runs the longest of them all.", 3200),
                 ("Five, cancelled.", 2000), ("And six.", 1200))
MESH_CANCEL = 4
MESH_CHUNK = 10
MESH_TIMEOUT_S = 420  # a world of ranks, set-up included

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
             atol: float = None, plain_eager: bool = False) -> dict:
    """Check got (and the output of a CUDA-graph replay of the same call)
    against want within the stated tolerance (``atol`` replaces the default
    absolute term), check that a second call and the replay give got's
    bits, time the kernel, its plain version (issued from Python with
    ``plain_eager``: a plain version that syncs cannot be captured) and
    the library yardstick (None: not timed), and add the bound.  kernel(0)
    is got's call."""
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
        "plain_ms": (_eager_ms if plain_eager else _device_ms)(torch, plain, min(reps, 8)),
        "library_ms": None if library is None else _device_ms(torch, library, reps),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    })
    print(f"kernel {label} " + json.dumps(row), flush=True)
    _check(ok, f"{label} disagrees with its plain version at {row}")
    _check(deterministic, f"{label}: a repeated or graph-replayed call changed the bits at {row}")
    return row


def _quant_launch(quant, sms: int, S: int, D: int, F: int, G: int = None) -> dict:
    """quant_matmul's (G None) or quant4_matmul's route, cluster size and
    blocks at this shape."""
    route = quant.quant_route(S)
    if route == "simt":
        vec, tpr, splits, _ = (quant._qmm_geometry(D, F, sms) if G is None
                               else quant._q4mm_geometry(D, F, G, sms))
        cols = vec * tpr
    else:
        plan = (quant._qmm_mma_plan(S, D, F, sms) if G is None
                else quant._q4mm_mma_plan(S, D, F, G, sms))
        splits, cols = plan.splits, plan.cols
    return {"route": route, "cluster": splits, "blocks": splits * math.ceil(F / cols)}


def phase_quant_matmul(torch, quant, peak_bw, peak_flops, shapes=_FLAGSHIP_SHAPES,
                       s_values=_S_VALUES):
    """quant_matmul vs quant_matmul_plain at every flagship shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, D, F, per_frame in shapes:
        q = torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = _copies(D * F)
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        w = quant._dequant({"q": q, "scale": scale}, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        for S in s_values:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            rows.append(_measure(
                torch, "quant_matmul",
                {"shape": name, "S": S, "D": D, "F": F, "per_frame": per_frame,
                 **_quant_launch(quant, quant._sms(x.device), S, D, F)},
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
            rows.append(_measure(
                torch, "quant4_matmul",
                {"shape": name, "S": S, "D": D, "F": F, "G": G, "per_frame": per_frame,
                 **_quant_launch(quant, quant._sms(x.device), S, D, F, G)},
                quant.quant4_matmul(x, q4, scale), quant.quant4_matmul_plain(x, q4, scale),
                lambda i: quant.quant4_matmul(x, q4s[i % copies], scale),
                lambda i: quant.quant4_matmul_plain(x, q4s[i % copies], scale),
                lambda i: torch.matmul(x, ws[i % len(ws)]),
                copies, D * F // 2 + 4 * G * F + 2 * S * D + 2 * S * F, 2 * S * D * F,
                peak_bw, peak_flops))
        del q4s, ws, w, q4
        torch.cuda.empty_cache()
    return rows


def _qmlp_launch(quant, sms: int, S: int, D: int, F: int, Dout: int) -> dict:
    """quant_mlp's route and launch at this shape: at S = 1 the CUDA-core
    geometry (tile, cluster, threads, prefetched w2 rows), else the
    tensor-core plan (tile, its passes, n-tiles, the phase-2 column tile
    (chunk), its splits of F and their rows, the ring's stage rows per
    phase); no cluster."""
    if quant.quant_route(S) == "simt":
        block_i, cluster, threads, prefetch, smem = quant._qmlp_geometry(S, D, F, Dout, sms)
        return {"route": "simt", "block_i": block_i, "cluster": cluster,
                "blocks": F // block_i, "threads": threads, "prefetch_rows": prefetch,
                "smem": smem}
    p = quant._qmlp_mma_plan(S, D, F, Dout, sms)
    return {"route": "mma", "block_i": p.block_i, "cluster": 1, "blocks": F // p.block_i,
            "threads": 32 * quant._QMLP_MMA_WARPS, "pass_cols": p.pass_cols, "nt": p.nt,
            "chunk": p.cols, "splits": p.splits, "rows": p.rows, "stage_rows": [p.kc1, p.kc2],
            "smem": p.smem}


def phase_quant_mlp(torch, quant, peak_bw, peak_flops, shapes=_MLP_SHAPES, s_values=_S_VALUES):
    """quant_mlp vs quant_mlp_plain at the backbone and decoder MLPs, with
    the launch geometry in each row.  The library yardstick is the dense
    bf16 SwiGLU sequence: three torch.matmul calls, silu and a product.  A
    second yardstick, ``unfused_ms``, is the port's own unfused int8 path on
    the same weights: two quant_matmul calls around the silu and product."""
    F_ = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, D, F, Dout, per_frame in shapes:
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

        for S in s_values:
            x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
            row = _measure(
                torch, "quant_mlp",
                {"shape": name, "S": S, "D": D, "F": F, "Dout": Dout, "per_frame": per_frame,
                 **_qmlp_launch(quant, quant._sms(x.device), S, D, F, Dout)},
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


def phase_flash_attention(torch, attention, peak_bw, peak_flops, cases=_ATTN_CASES):
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

    for label, B, H, KV, hd, T, S, pos0, valid_len in cases:
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


def _bwd_work(B, H, KV, hd, S, valid_end, elem: int):
    """(bytes, operations) one cache-free flash_attention_bwd call must move
    and do: q, o, dO and dq once, k, v, dk and dv once, 10 * hd operations
    per visible (query, key) pair and head (five products)."""
    nbytes = (4 * B * H * S * hd + 4 * B * KV * S * hd) * elem
    pairs = sum(sum(min(i + 1, max(e, 0)) for i in range(S)) for e in valid_end)
    return nbytes, 10 * hd * H * pairs


def phase_flash_attention_bwd(torch, attention, peak_bw, peak_flops, f32_flops):
    """flash_attention_bwd vs flash_attention_bwd_plain at the training
    shapes, in bf16 and f32: each gradient within ``_BWD_TOL``, a repeated
    call bit-equal (no atomics), a row that sees no key exactly 0.  The
    kernel and the plain version are timed by CUDA-graph replay; the library
    yardstick is ``torch.autograd.grad`` through one
    ``scaled_dot_product_attention`` call with the same boolean mask
    (``enable_gqa``), its backward alone (a graph of forward and backward
    less a graph of the forward), not on the row that sees no key, where it
    gives NaN."""
    F_ = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, KV, hd, S, valid_end in _BWD_CASES:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q = randn(B, S, H, hd).transpose(1, 2)  # as the trunk hands it over
            k, v = randn(B, KV, S, hd), randn(B, KV, S, hd)
            p0 = torch.zeros(B, dtype=torch.int64, device="cuda")
            ve = torch.tensor(valid_end, device="cuda")
            o = attention.flash_attention(q, k, v, p0, ve)
            do = randn(B, S, H, hd).transpose(1, 2)  # the grad of the trunk's head merge
            got = attention.flash_attention_bwd(q, k, v, o, do, p0, ve)
            want = attention.flash_attention_bwd_plain(q, k, v, o, do, p0, ve)
            again = attention.flash_attention_bwd(q, k, v, o, do, p0, ve)
            torch.cuda.synchronize()
            rtol, atol_of_peak = _BWD_TOL[str(dtype).split(".")[-1]]
            errs, ok = [], True
            for g, w in zip(got, want):
                w = w.float()
                diff = (g.float() - w).abs()
                errs.append(diff.max().item())
                ok &= bool((diff <= rtol * w.abs() + atol_of_peak * w.abs().max()).all())
            deterministic = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            empty = [b for b, e in enumerate(valid_end) if e <= 0]
            zero = all(not bool(g[b].any()) for g in got for b in empty)
            library_ms = None
            if not empty:
                positions = torch.arange(S, device="cuda")
                mask = ((positions[None, :] <= positions[:, None])[None]
                        & (positions[None, None, :] < ve[:, None, None]))[:, None]

                def sdpa(i, backward=True):
                    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                    out = F_.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                          enable_gqa=True)
                    return torch.autograd.grad(out, (ql, kl, vl), do) if backward else out

                # its backward alone: forward + backward less the forward, each
                # by CUDA-graph replay
                library_ms = (_device_ms(torch, sdpa, 5)
                              - _device_ms(torch, lambda i: sdpa(i, backward=False), 5))
            elem = q.element_size()
            nbytes, flops = _bwd_work(B, H, KV, hd, S, valid_end, elem)
            t_bytes = nbytes / peak_bw
            t_ops = flops / (peak_flops if dtype == torch.bfloat16 else f32_flops)
            row = {"shape": label, "dtype": str(dtype).split(".")[-1],
                   "route": attention._bwd_route(dtype), "B": B, "H": H, "KV": KV,
                   "hd": hd, "S": S, "valid_end": list(valid_end),
                   "max_abs_err": max(errs), "errs_dq_dk_dv": errs, "ok": ok,
                   "bit_equal_repeat": deterministic, "empty_rows_zero": zero,
                   "kernel_ms": _device_ms(torch, lambda i: attention.flash_attention_bwd(
                       q, k, v, o, do, p0, ve), 10),
                   "kernel_eager_ms": _eager_ms(torch, lambda i: attention.flash_attention_bwd(
                       q, k, v, o, do, p0, ve), 10),
                   "plain_ms": _device_ms(torch, lambda i: attention.flash_attention_bwd_plain(
                       q, k, v, o, do, p0, ve), 3),
                   "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            print("kernel flash_attention_bwd " + json.dumps(row), flush=True)
            _check(ok, f"flash_attention_bwd disagrees with its plain version at {row}")
            _check(deterministic, f"flash_attention_bwd: a repeated call changed the bits at {row}")
            _check(zero, f"flash_attention_bwd: a row that sees no key has a gradient at {row}")
            rows.append(row)
            del q, k, v, o, do, got, want, again
            torch.cuda.empty_cache()
    from sesameai_tts_tpu_torch.core.config import csm_1b

    for step in _bwd_steps(rows, csm_1b()):
        print("kernel flash_attention_bwd step " + json.dumps(step), flush=True)
    return rows


def _bwd_steps(rows, cfg):
    """The phase's rows summed over a mixed training step's backward calls,
    with no further timing: the backbone's layers at S = 256 (main[train]'s
    bucket) or S = 2048 (the largest), the decoder's layers at S = 32, in
    each dtype."""
    n_bb, n_dec = cfg.backbone.num_layers, cfg.decoder.num_layers
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    steps = []
    for S in (256, 2048):
        step = {"backbone_S": S, "decoder_S": 32, "backbone_calls": n_bb, "decoder_calls": n_dec}
        for dtype in ("bfloat16", "float32"):
            bb = next(r for r in rows if r["shape"] == f"backbone S={S}" and r["dtype"] == dtype)
            dec = next(r for r in rows if r["shape"] == "decoder S=32" and r["dtype"] == dtype)
            step[dtype] = {k: None if bb[k] is None or dec[k] is None
                           else bb[k] * n_bb + dec[k] * n_dec for k in keys}
            step[dtype]["route"] = bb["route"]
        steps.append(step)
    return steps


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
        "breakdown_s": {k: summary[k]["total"] for k in ("prefill_s", "decode_s")
                        if k in summary},
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
    _check(launches["flash_attention_bwd"] == 0,
           f"{path}: inference launched flash_attention_bwd {launches['flash_attention_bwd']} "
           f"times")
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
    counts checked exactly; then the graph checks and the eager twin.  →
    (result, the warmed Generator, which the caller frees)."""
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
    return result, gen


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


def _pool_ticks(torch, srv, greedy: bool, ms0, seed: int = 77, modes=("graphed", "eager")):
    """One tick of the pool as it stands, on the graphs and then on the eager
    step from the same state (restored in between) → {mode: ((frames,
    valid, done, PCM) on the host, the tick's wall ms, synchronized)}."""
    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.runtime.serving import _on

    t = srv._ticker
    snapshot = [x.clone() for x in _pool_tensors(srv)]
    out = {}
    for mode in modes:
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


def _admit_all(srv, texts) -> list:
    """One fresh admission in every slot of a stopped pool → ms each
    (prefill + first chunk + its fetch, one at a time)."""
    from sesameai_tts_tpu_torch.runtime.serving import Session, _on

    admit_ms = []
    for slot in range(srv.B):
        ms, temp, k = SERVE_SESSIONS[slot]
        session = Session(text=texts[slot], speaker=0, max_audio_length_ms=6000,
                          temperature=temp, topk=k)
        t0 = time.perf_counter()
        item = srv._dispatch_admission(session)
        _check(item is not None, f"serve: admission failed: {session.error}")
        item.fetch.wait()
        admit_ms.append((time.perf_counter() - t0) * 1e3)
        with _on(srv._ticker):
            srv._attach(slot, item)
    return admit_ms


def _tick_checks(torch, srv, ms0) -> dict:
    """The pool's tick on its graphs against the eager step from the same
    state, sampled then greedy (topk 1 in every slot from then on)."""
    import numpy as np

    checks = {}
    for label, greedy in (("sampled", False), ("greedy", True)):
        if greedy:
            srv._ticker._slot(srv.B).bufs.topk.fill_(1)
        ticks = _pool_ticks(torch, srv, greedy, ms0)
        (g, g_ms), (e, e_ms) = ticks["graphed"], ticks["eager"]
        checks[label] = {"frames_bit_equal": bool(np.array_equal(g[0], e[0])),
                         "valid_equal": bool(np.array_equal(g[1], e[1])),
                         "pcm_max_abs_diff": float(np.abs(g[3] - e[3]).max()),
                         "tick_ms_graphed": g_ms, "tick_ms_eager": e_ms,
                         "frames": int(g[0].shape[0])}
    return checks


def _tick_ms_per_frame_step(torch, srv, ms0, reps: int = SERVE_TICK_REPS):
    """The fastest of ``reps`` graphed greedy ticks from the same state, in
    wall ms per frame-step (synchronized; Mimi's decode of the tick
    included) → (that, the first tick's (frames, valid, done, PCM))."""
    runs = [_pool_ticks(torch, srv, True, ms0, modes=("graphed",))["graphed"]
            for _ in range(reps)]
    return min(ms for _, ms in runs) / runs[0][0][0].shape[0], runs[0][0]


def _fused_pool(torch, wrappers, gen, texts, unfused_tick_ms: float) -> dict:
    """The fused-MLP configuration's pool: ``Generator(fused_mlp=True)`` on
    gen's int8 tree, ``BatchedTTSServer(slots=8, chunk_frames=10)``,
    warmed, 8 fresh admissions, then its tick on the graphs against the
    eager step, sampled and greedy: bit-equal, and the launches exact
    (quant_mlp 144 and quant_matmul 288 a frame-step, at S = 8;
    flash_attention 144; topk_sample 32 a sampled one).  Its graphed
    tick's ms per frame-step beside the unfused pool's, taken the same
    way."""
    import numpy as np

    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    fgen = _sibling(gen, gen._params, fused_mlp=True)
    srv = BatchedTTSServer(fgen, slots=SERVE_SLOTS, chunk_frames=SERVE_CHUNK)
    t0 = time.perf_counter()
    srv.warmup()
    warmup_s = time.perf_counter() - t0
    admit_ms = _admit_all(srv, texts)
    torch.cuda.synchronize()
    ms0 = tree_map(lambda x: x.clone(), srv._mimi_state)
    _reset_counts(wrappers)
    checks = _tick_checks(torch, srv, ms0)
    launches = _counts(wrappers)
    steps = 2 * sum(c["frames"] for c in checks.values())  # graphed and eager ticks
    per_frame = next(launches for path, _, launches, _ in _PATHS if path == "fused")
    want = {**{k: n * steps for k, n in per_frame.items()}, "flash_attention": 144 * steps,
            "flash_attention_bwd": 0, "topk_sample": 32 * 2 * checks["sampled"]["frames"]}
    tick_ms, _ = _tick_ms_per_frame_step(torch, srv, ms0)
    out = {"slots": srv.B, "warmup_s": warmup_s, "admission_ms_p50": float(np.median(admit_ms)),
           "graph_vs_eager": checks, "frame_steps": steps, "launches": launches,
           "tick_ms_per_frame_step": tick_ms, "unfused_tick_ms_per_frame_step": unfused_tick_ms}
    print("main[serve] fused pool " + json.dumps(out), flush=True)
    for label, c in checks.items():
        _check(c["frames_bit_equal"] and c["valid_equal"],
               f"serve: the fused pool's {label} tick on the graphs differs from the eager "
               f"step: {c}")
    _check(launches == want, f"serve: the fused pool's launches {launches}, want {want} "
                             f"({steps} frame-steps at B={srv.B})")
    del srv, fgen
    _collect(torch)
    return out


def _expert_rows(torch, moe, peak_bw, peak_flops, layers, cfg) -> list:
    """expert_swiglu against expert_swiglu_plain on two routed layers'
    int8 experts (352 MB each, past the L2), at each of ``HYBRID_ROWS``
    with the first layer's own routing of random rows; the plain version
    (a host sync an expert) timed as issued from Python."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    D, Fe, E, k = cfg.embed_dim, cfg.moe_intermediate_dim, cfg.num_experts, \
        cfg.num_experts_per_tok
    ops = [(wl["experts_w13"]["q"], wl["experts_w13"]["scale"], wl["experts_w2"]["q"],
            wl["experts_w2"]["scale"]) for wl in layers]
    expert_bytes = 3 * D * Fe + 4 * (2 * Fe + D)
    rows = []
    for N in HYBRID_ROWS:
        x = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
        ids, w = moe.route(x, layers[0]["router"], layers[0]["expert_bias"], k,
                           cfg.norm_topk_prob, cfg.routed_scaling_factor)
        w = w.contiguous()
        hit = int(torch.unique(ids).numel())
        stats = torch.zeros(2, dtype=torch.int32, device="cuda")
        got = moe.expert_swiglu(x, ids, w, *ops[0], stats=stats)
        counts = torch.bincount(ids.reshape(-1), minlength=E)
        _check(stats.tolist() == [hit, int(counts.max())],
               f"expert_swiglu at {N} rows counted {stats.tolist()}, want "
               f"{[hit, int(counts.max())]}")
        rows.append(_measure(
            torch, "expert_swiglu",
            {"shape": f"{E} experts {D}x{Fe}, top {k}", "S": N, "experts_hit": hit,
             "expert_rows_max": int(counts.max())},
            got, moe.expert_swiglu_plain(x, ids, w, *ops[0]),
            lambda i: moe.expert_swiglu(x, ids, w, *ops[i % len(ops)]),
            lambda i: moe.expert_swiglu_plain(x, ids, w, *ops[i % len(ops)]), None,
            len(ops), hit * expert_bytes + N * (4 * D + 12 * k), 2.0 * N * k * 3 * D * Fe,
            peak_bw, peak_flops, plain_eager=True))
    return rows


def phase_hybrid(torch, wrappers, peak_bw, peak_flops, card: str) -> dict:
    """LFM2-8B-A1B as CSM's backbone, int8 (module docstring): the model
    drawn on the card from seed 0 (the loader's spec, ``init_csm_params``
    on a CUDA generator, ``quantize_csm``), the expert kernel on its
    layers (``_expert_rows``), then a 16-slot ``BatchedTTSServer``:
    16 admissions, the pool's tick on the graphs against the eager step,
    sampled and greedy, with exact launches (``HYBRID_PER_FRAME``), and
    one graphed tick whose experts-hit counters are read from the card."""
    import numpy as np

    from sesameai_tts_tpu_torch.codec.mimi import Mimi
    from sesameai_tts_tpu_torch.convert import to_device, tree_map
    from sesameai_tts_tpu_torch.models.csm import init_csm_params
    from sesameai_tts_tpu_torch.ops import moe
    from sesameai_tts_tpu_torch.ops.quant import quantize_csm
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.runtime.loader import csm_lfm2_8b_a1b_spec, init_mimi
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, Session, _on
    from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer

    spec = csm_lfm2_8b_a1b_spec()
    cfg = spec.csm
    t0 = time.perf_counter()
    params = init_csm_params(cfg, torch.Generator(device="cuda").manual_seed(spec.seed),
                             torch.bfloat16)
    params = quantize_csm(params, bits=8)
    mimi_params = to_device(init_mimi(spec)[1], "cuda")
    gen = Generator(params, cfg, Mimi(spec.mimi), mimi_params,
                    load_text_tokenizer(spec.tokenizer), device="cuda")
    torch.cuda.synchronize()
    out = {"card": card, "built_s": time.perf_counter() - t0,
           "built_gb": torch.cuda.memory_allocated() / 1e9}
    bb = cfg.backbone
    routed = [wl for i, wl in enumerate(params["backbone"]["layers"])
              if i >= bb.num_dense_layers]
    _check(len(routed) * 3 == HYBRID_PER_FRAME["expert_swiglu"],
           f"hybrid: {len(routed)} routed layers")
    out["kernel"] = _expert_rows(torch, moe, peak_bw, peak_flops, routed[:2], bb)
    del params, routed

    srv = BatchedTTSServer(gen, slots=HYBRID_SLOTS, chunk_frames=SERVE_CHUNK)
    t0 = time.perf_counter()
    srv.warmup()
    out["warmup_s"] = time.perf_counter() - t0
    for slot in range(srv.B):
        session = Session(text=f"Slot {slot} of the routed pool reads a longer paragraph aloud.",
                          speaker=0, max_audio_length_ms=6000, temperature=0.8, topk=40)
        item = srv._dispatch_admission(session)
        _check(item is not None, f"hybrid: admission failed: {session.error}")
        item.fetch.wait()
        with _on(srv._ticker):
            srv._attach(slot, item)
    torch.cuda.synchronize()
    ms0 = tree_map(lambda x: x.clone(), srv._mimi_state)
    _reset_counts(wrappers)
    checks = _tick_checks(torch, srv, ms0)
    launches = _counts(wrappers)
    steps = 2 * sum(c["frames"] for c in checks.values())  # graphed and eager ticks
    want = {**{k: n * steps for k, n in HYBRID_PER_FRAME.items()},
            "topk_sample": 32 * 2 * checks["sampled"]["frames"]}
    out.update(graph_vs_eager=checks, frame_steps=steps, launches=launches)
    out["tick_ms_per_frame_step"], _ = _tick_ms_per_frame_step(torch, srv, ms0)

    t = srv._ticker
    stats = t._slot(srv.B).bufs.moe_stats
    with _on(t):  # one graphed sampled tick, its counters left in place
        stats.zero_()
        res = t._serve_tick(srv.B, srv.chunk, 91, False, tree_map(lambda x: x.clone(), ms0))
        torch.cuda.synchronize()
    frames = int(res[0].shape[0])
    hit, rows_max = stats.tolist()
    layers = HYBRID_PER_FRAME["expert_swiglu"] // 3
    out["counters"] = {"frame_steps": frames, "experts_hit": hit, "expert_rows_max": rows_max,
                       "experts_hit_per_layer": hit / max(frames * layers, 1)}
    print("main[hybrid] " + json.dumps(out), flush=True)
    for label, c in checks.items():
        _check(c["frames_bit_equal"] and c["valid_equal"],
               f"hybrid: the pool's {label} tick on the graphs differs from the eager step: {c}")
    _check(launches == want, f"hybrid: the pool's launches {launches}, want {want} "
                             f"({steps} frame-steps at B={srv.B})")
    _check(frames > 0 and frames * layers <= hit <= frames * layers * bb.num_experts
           and 1 <= rows_max <= srv.B,
           f"hybrid: the tick's counters {out['counters']} ({frames} frame-steps, "
           f"{layers} routed layers of {bb.num_experts} experts, {srv.B} rows)")
    _check(np.isfinite(res[3].float().cpu().numpy()).all(), "hybrid: the tick's PCM")
    del srv, gen, res
    _collect(torch)
    return out


def phase_serve(torch, wrappers, card: str):
    """Batched serving and the HTTP API at CSM-1B width (int8, bf16 Mimi):
    ``BatchedTTSServer(slots=8, chunk_frames=10, max_pending=32)``,
    ``warmup`` before ``start`` and no graph captured after it.  12
    in-process sessions against 8 slots (``SERVE_SESSIONS``): each ends,
    its delivered PCM equals the offline Mimi decode of its delivered
    frames, and the launches are exact (quant_matmul 576 per frame-step at
    S = 8, flash_attention 144 per frame-step and per admission; topk_sample
    32 a sampled one, and the plain sampler never on the card).  Then
    over HTTP with the DSP watermark: 8 concurrent /tts, a /tts/stream and
    an SSE /v1/audio/speech whose streamed marks verify, a burst past
    max_pending answered 429 with Retry-After, /healthz?deep=1 with the
    canary.  Then, the server stopped, 8 fresh admissions in the pool: one
    tick on the graphs bit-equal to the eager step from the same state,
    sampled (mixed temperature and topk: topk_sample 32 a frame-step) and
    greedy (none).  Prints the numbers of the serving cell."""
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
        sampler = srv.metrics_summary()["sampler_launches"]
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
            "sampler_launches": sampler,
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
                "flash_attention": 144 * (frame_steps + admissions), "flash_attention_bwd": 0,
                "expert_swiglu": 0}
        draws = launches["topk_sample"]  # 32 a sampled frame-step or sampled admission
        _check({k: v for k, v in launches.items() if k != "topk_sample"} == want,
               f"serve: launches {launches}, want {want} ({frame_steps} frame-steps at "
               f"B={srv.B}, {admissions} admissions)")
        _check(draws % 32 == 0 and 0 < draws <= 32 * (frame_steps + admissions)
               and sampler["topk_sample"] >= draws and sampler["sample_topk_plain"] == 0,
               f"serve: topk_sample launched {draws} times ({frame_steps} frame-steps, "
               f"{admissions} admissions), /metrics' sampler {sampler}")

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
            item.fetch.wait()
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
    admit_ms = _admit_all(srv, texts)
    torch.cuda.synchronize()
    ms0 = tree_map(lambda x: x.clone(), srv._mimi_state)
    _reset_counts(wrappers)
    checks = _tick_checks(torch, srv, ms0)
    tick_draws = _counts(wrappers)["topk_sample"]  # the sampled tick graphed and eager
    tick_ms, g = _tick_ms_per_frame_step(torch, srv, ms0)
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
    sampled_steps = 2 * checks["sampled"]["frames"]
    result.update({
        "graph_vs_eager": checks,
        "tick_topk_sample_per_frame_step": {"sampled": tick_draws / sampled_steps, "greedy": 0},
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
    _check(tick_draws == 32 * sampled_steps,
           f"serve: topk_sample launched {tick_draws} times for {sampled_steps} sampled "
           f"frame-steps and a greedy tick (want 32 a sampled frame-step, none greedy)")
    # -- the fused-MLP configuration's pool on the same int8 tree (quant_mlp at S = 8)
    result["fused_pool"] = _fused_pool(torch, wrappers, gen, texts, tick_ms)
    del gen
    _collect(torch)
    return result


class _Loopback:
    """A stdlib HTTP server on 127.0.0.1 at an ephemeral port that answers as
    an OpenAI-compatible endpoint: ``/v1/chat/completions`` gives APPS_REPLY
    whole, or as SSE deltas (APPS_DELTAS) when the request streams;
    ``/v1/audio/transcriptions`` gives APPS_TRANSCRIPT.  ``requests`` counts
    the posts by path."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        loop = self
        self.requests = {}
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    loop.requests[self.path] = loop.requests.get(self.path, 0) + 1
                if self.path == "/v1/audio/transcriptions":
                    return self._send("application/json",
                                      json.dumps({"text": APPS_TRANSCRIPT}).encode())
                if not json.loads(body)["stream"]:
                    return self._send("application/json", json.dumps(
                        {"choices": [{"message": {"role": "assistant",
                                                  "content": APPS_REPLY}}]}).encode())
                events = [json.dumps({"choices": [{"delta": {"content": d}}]})
                          for d in APPS_DELTAS] + ["[DONE]"]
                self._send("text/event-stream",
                           "".join(f"data: {e}\n\n" for e in events).encode())

            def _send(self, ctype, data):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _apps_chat(tts, gen) -> dict:
    """ChatApp.process_query over the loopback LLM, then the pump over its
    sentences; then the first sentence again at topk=1 through the pump
    against the engine called directly (codes exact, PCM within
    APPS_PCM_TOL of its peak)."""
    import numpy as np

    from sesameai_tts_tpu_torch.apps.web_chat import ChatApp

    app = ChatApp(voice="clone", model="local-default", tts=tts)
    t0 = time.perf_counter()
    outs = list(app.process_query("What does the loopback model say?", temperature=0.9))
    llm_s = time.perf_counter() - t0
    _, status, start, end, active = outs[-1]
    _check(active and end - start == len(app.split_text_into_sentences(APPS_REPLY)),
           f"apps/chat: process_query queued {end - start} sentences ({status!r})")
    sentences, first_audio_s, items = [], None, []
    t_prev = time.perf_counter()
    for act, audio in app.sentence_generator_loop(start, end, active, temperature=0.8,
                                                  speed_factor=APPS_SPEED, topk=40):
        now = time.perf_counter()
        items.append((act, audio))
        if audio is not None:
            if first_audio_s is None:
                first_audio_s = now - t0
            sr, pcm = audio
            _check(sr == 24_000 and pcm.dtype == np.float32 and bool(np.isfinite(pcm).all())
                   and float(np.abs(pcm).max()) > 0.0,
                   f"apps/chat: clip {len(sentences)} is not finite non-silent f32 at 24 kHz")
            sentences.append({"wall_s": now - t_prev, "audio_s": pcm.size / sr,
                              "rtf": (now - t_prev) / (pcm.size / sr)})
        t_prev = now
    _check(len(sentences) == end - start and items[-1] == (False, None),
           f"apps/chat: {len(sentences)} clips for {end - start} sentences, last item "
           f"{items[-1][0]}")

    codes = []
    generate_codes = gen._generate_codes

    def recording(*args, **kwargs):
        out = generate_codes(*args, **kwargs)
        codes.append(out.cpu().numpy())
        return out

    sentence = app.queue.get(start)
    gen._generate_codes = recording
    try:
        s, e = app.queue.enqueue([sentence])
        (_, (_, piped)), _ = list(app.sentence_generator_loop(
            s, e, True, temperature=0.8, speed_factor=APPS_SPEED, topk=1))
        direct = tts.generate_audio_segment(
            sentence, temperature=0.8, topk=1, fade_duration=app.FADE_MS,
            start_silence_duration=app.LEAD_SILENCE_MS,
            end_silence_duration=app.TAIL_SILENCE_MS).speedup(playback_speed=APPS_SPEED).samples
    finally:
        del gen._generate_codes
    codes_equal = len(codes) == 2 and np.array_equal(codes[0], codes[1])
    pcm_err = float(np.abs(piped - direct).max() / np.abs(direct).max()) \
        if piped.shape == direct.shape else float("inf")
    _check(codes_equal, "apps/chat: the topk=1 re-run's codes differ from the direct call's")
    _check(pcm_err <= APPS_PCM_TOL,
           f"apps/chat: the topk=1 re-run's PCM is {pcm_err:.3g} of its peak from the direct "
           f"call's (> {APPS_PCM_TOL})")
    return {"llm_query_s": llm_s, "query_to_first_audio_s": first_audio_s,
            "sentences": sentences,
            "rerun_topk1": {"codes_equal": codes_equal, "frames": int(codes[0].shape[0]),
                            "pcm_bit_equal": bool(np.array_equal(piped, direct)),
                            "pcm_max_err_of_peak": pcm_err}}


def _apps_story(tts) -> dict:
    """StorytellerApp: one continuation from the loopback LLM, one of pasted
    text, each pumped to the end, then the combined story WAV."""
    import shutil

    from sesameai_tts_tpu_torch.apps.web_storyteller import StorytellerApp
    from sesameai_tts_tpu_torch.audio.io import read_wav

    app = StorytellerApp(voice="clone", model="local-default", tts=tts)
    try:
        parts = []
        for prompt, use_llm in (("Tell the story of a lighthouse.", True), (APPS_PASTED, False)):
            narrated = sum(c.samples.size for g in app.prompt_audio_segments for c in g)
            t0 = time.perf_counter()
            _, status, start, end, active, replay = list(app.continue_story(prompt, use_llm))[-1]
            replay_n = 0 if replay is None else replay[1].size
            _check(active and end > start, f"apps/story: nothing queued ({status!r})")
            _check(replay_n == narrated,
                   f"apps/story: the replay holds {replay_n} samples, {narrated} were narrated")
            items = list(app.sentence_generator_loop(start, end, active, temperature=0.8,
                                                     speed_factor=1.0, topk=40))
            clips = [a for _, a in items if a is not None]
            _check(len(clips) == end - start and items[-1] == (False, None),
                   f"apps/story: {len(clips)} clips for {end - start} sentences")
            parts.append({"use_llm": use_llm, "sentences": end - start,
                          "replay_samples": replay_n, "wall_s": time.perf_counter() - t0,
                          "audio_s": sum(pcm.size for _, pcm in clips) / 24_000})
        narrated = sum(c.samples.size for g in app.prompt_audio_segments for c in g)
        wav, rate = read_wav(app.combine_full_story())
        _check(rate == 24_000 and wav.shape == (1, narrated),
               f"apps/story: the story WAV holds {wav.shape} at {rate} Hz, {narrated} samples "
               f"were narrated")
        return {"parts": parts, "story_samples": narrated,
                "prompt_wavs": len(app.generated_prompt_wav_paths)}
    finally:
        app.reset_story()
        shutil.rmtree(app.session_dir, ignore_errors=True)


def _apps_duplex(gen, segments, base: str) -> dict:
    """DuplexVoiceApp over the loopback LLM and STT: APPS_TURNS user turns of
    APPS_TURN_RATE audio, each reply streamed one frame per chunk."""
    import tempfile

    import numpy as np

    from sesameai_tts_tpu_torch.apps.audio_to_text import transcribe
    from sesameai_tts_tpu_torch.apps.duplex import DuplexVoiceApp, sentence_stream
    from sesameai_tts_tpu_torch.audio.io import write_wav

    _check(len(list(sentence_stream(iter(APPS_DELTAS)))) == 3,
           "apps/duplex: sentence_stream does not split the streamed reply into 3 sentences")

    def stt(audio, rate):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "turn.wav")
            write_wav(path, audio, rate)
            return transcribe(path, api_base=base, api_key="loopback")

    app = DuplexVoiceApp(gen, stt=stt, voice_context=segments, temperature=0.8, topk=40,
                         max_sentence_ms=AUDIO_MS)
    ctx = app.context
    prefix_rows, prefix = ctx.prefix_rows, list(ctx._prefix)
    appended = []
    append = ctx.append
    ctx.append = lambda pair, oversize="raise": (appended.append(int(pair[0].shape[0])),
                                                 append(pair, oversize))
    turns = []
    for i in range(APPS_TURNS):
        user = _speechlike(APPS_TURN_S, APPS_TURN_RATE, 100 + i)
        t0 = time.perf_counter()
        chunks = list(app.respond(user, APPS_TURN_RATE))
        wall = time.perf_counter() - t0
        _check(bool(chunks) and all(sr == 24_000 and pcm.dtype == np.float32
                                    and bool(np.isfinite(pcm).all()) for sr, pcm in chunks),
               f"apps/duplex: turn {i} gave {len(chunks)} chunks, not all finite f32 at 24 kHz")
        _check(ctx.window_rows <= ctx.max_positions,
               f"apps/duplex: turn {i} left {ctx.window_rows} window rows")
        frames = sum(pcm.size for _, pcm in chunks) // gen._hop
        turns.append({"stt_ms": app.marks["stt"] * 1e3, "ttfs_ms": app.marks["ttfs"] * 1e3,
                      "ttff_ms": app.marks["ttff"] * 1e3, "chunks": len(chunks),
                      "chunk_sizes": sorted({int(pcm.size) for _, pcm in chunks}),
                      "window_rows": ctx.window_rows, "segments": len(ctx._window),
                      "frames": frames, "frames_per_s": frames / wall, "wall_s": wall})
    _check(len(appended) > len(ctx._window) and ctx.prefix_rows == prefix_rows
           and ctx._prefix == prefix,
           f"apps/duplex: {len(appended)} segments appended, {len(ctx._window)} in the window, "
           f"prefix {ctx.prefix_rows} rows (pinned {prefix_rows})")
    app.clear_dialog()
    _check(ctx.window_rows == 0 and ctx.prefix_rows == prefix_rows
           and not app.llm.history_manager.messages,
           "apps/duplex: clear_dialog left the window or the LLM history")
    return {"prefix_rows": prefix_rows, "max_positions": ctx.max_positions,
            "budget": ctx.budget, "appended_rows": appended, "turns": turns}


def _apps_encode(torch, gen) -> dict:
    """A8: Mimi.encode_streaming in APPS_ENCODE_CHUNK-frame chunks against the
    offline Mimi.encode, f32 on the card (TF32 off), each timed on its second
    run."""
    from sesameai_tts_tpu_torch.convert import tree_map

    mimi, hop = gen._mimi, gen._hop
    params = tree_map(lambda t: t.float(), gen._mimi_params)
    clip = _speechlike(SMOKE_CLIP_S, 24_000, 7)
    frames = -(-clip.size // (hop * APPS_ENCODE_CHUNK)) * APPS_ENCODE_CHUNK
    wav = torch.zeros(1, 1, frames * hop, device=gen.device)
    wav[0, 0, :clip.size] = torch.from_numpy(clip).to(gen.device)

    def offline():
        return mimi.encode(params, wav)

    def streamed():
        state = mimi.init_encode_state(1, torch.float32, gen.device)
        out = []
        for i in range(0, frames, APPS_ENCODE_CHUNK):
            codes, state = mimi.encode_streaming(
                params, wav[:, :, i * hop:(i + APPS_ENCODE_CHUNK) * hop], state)
            out.append(codes)
        return torch.cat(out, dim=-1)

    runs = {}
    for name, fn in (("offline", offline), ("streamed", streamed)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = fn()
        torch.cuda.synchronize()
        runs[name] = ((time.perf_counter() - t0) * 1e3, codes.cpu().numpy())
    want, got = runs["offline"][1], runs["streamed"][1]
    _check(got.shape == want.shape == (1, mimi.cfg.num_codebooks, frames),
           f"apps/encode: streamed codes {got.shape}, offline {want.shape}")
    equal = (got == want).mean(axis=(0, 2))
    _check(equal[0] >= APPS_ENCODE_MIN_EQUAL,
           f"apps/encode: codebook 0 agrees on {equal[0]:.4f} of frames "
           f"(< {APPS_ENCODE_MIN_EQUAL})")
    audio_s = frames * hop / 24_000
    del params
    return {"frames": frames, "chunk_frames": APPS_ENCODE_CHUNK, "audio_s": audio_s,
            "equal_share_by_codebook": [float(x) for x in equal],
            "ms_per_audio_s": {k: v[0] / audio_s for k, v in runs.items()}}


def _apps_native() -> dict:
    """A14: the g++-built native audio backend against the port's numpy paths
    on a SMOKE_CLIP_S clip."""
    import numpy as np

    from sesameai_tts_tpu_torch.audio import native
    from sesameai_tts_tpu_torch.audio.resample import resample
    from sesameai_tts_tpu_torch.audio.segment import AudioClip

    _check(native.available(), "apps/native: the native audio library did not build")
    clip = _speechlike(SMOKE_CLIP_S, 24_000, 8)
    out, ms = {}, {}
    for name, fn in (("scipy", resample), ("native", native.resample_native)) * 2:
        t0 = time.perf_counter()
        out[name] = fn(clip, 24_000, 44_100)
        ms[name] = (time.perf_counter() - t0) * 1e3  # the second run of each
    err = float(np.abs(out["native"][100:-100] - out["scipy"][100:-100]).max()) \
        if out["native"].shape == out["scipy"].shape else float("inf")
    _check(err <= APPS_NATIVE_TOL,
           f"apps/native: resample_native is {err:.3g} from resample (> {APPS_NATIVE_TOL})")
    n = int(50 / 1000 * 24_000)  # the apps' 50 ms fades
    faded = AudioClip.from_float(clip.copy(), 24_000).fade_in(50).fade_out(50)
    fade_exact = bool(np.array_equal(native.fade_inplace(clip.copy(), n, n), faded.samples))
    loud = clip * 5.0  # some samples clip
    int16_exact = bool(np.array_equal(native.to_int16(loud.copy()),
                                      AudioClip.from_float(loud, 24_000).to_int16()))
    _check(fade_exact and int16_exact,
           f"apps/native: fade exact {fade_exact}, int16 exact {int16_exact}")
    return {"resample_24k_to_44k1_max_err": err, "resample_ms": ms, "fade_exact": fade_exact,
            "int16_exact": int16_exact}


def phase_apps(torch, wrappers, gen, card: str) -> dict:
    """The app layer at CSM-1B width on a warmed clone of ``gen`` (int8, bf16
    Mimi) over a loopback LLM/STT server (``_Loopback``): ChatApp
    (process_query → pump, a topk=1 re-run against the engine),
    StorytellerApp (LLM and pasted continuations, the replay, the combined
    WAV) and DuplexVoiceApp (APPS_TURNS turns: transcribe → RollingContext
    with a ~500-row pinned voice prefix → streamed LLM → sentence_stream →
    generate_stream one frame per chunk); quant_matmul and flash_attention
    launches counted over the three.  Then Mimi.encode_streaming against
    Mimi.encode (A8) and the native audio backend (A14)."""
    import functools
    import tempfile

    from sesameai_tts_tpu_torch.llm import client
    from sesameai_tts_tpu_torch.service.tts import TTS, prepare_voice_context
    from sesameai_tts_tpu_torch.service.voices import load_registry
    from sesameai_tts_tpu_torch.watermark import api

    t_phase = time.perf_counter()
    app_gen = gen.clone()
    warm = app_gen.warmup()
    result = {"card": card, "warmup_s": sum(warm.values())}
    saved = dict(vars(client.global_config))
    loop = _Loopback()
    try:
        client.global_config.API_BASE, client.global_config.API_KEY = loop.base, "loopback"
        with tempfile.TemporaryDirectory() as tmp:
            voices = _write_voice(tmp)
            tts = TTS(voices=voices, device=gen.device)
            tts.generator = app_gen
            tts.watermarker = api.load_watermarker(device=gen.device)
            # every synthesized sentence (the voice warm-up's too) at the request budget
            tts.generate_audio_segment = functools.partial(tts.generate_audio_segment,
                                                           max_audio_length_ms=AUDIO_MS)
            segments, _, _ = prepare_voice_context(app_gen, load_registry(voices)["clone"],
                                                   "clone")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts(wrappers)
            t0 = time.perf_counter()
            result["chat"] = _apps_chat(tts, app_gen)
            print("main[apps] chat " + json.dumps(result["chat"]), flush=True)
            result["story"] = _apps_story(tts)
            print("main[apps] story " + json.dumps(result["story"]), flush=True)
            result["duplex"] = _apps_duplex(app_gen, segments, loop.base)
            torch.cuda.synchronize()
            result["launches"] = _counts(wrappers)
            result["apps_s"] = time.perf_counter() - t0
            result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            print("main[apps] duplex " + json.dumps(result["duplex"]), flush=True)
        result["loopback_requests"] = dict(loop.requests)
    finally:
        loop.close()
        vars(client.global_config).update(saved)
    for name in ("quant_matmul", "flash_attention"):
        _check(result["launches"][name] > 0,
               f"apps: {name} was not launched by the apps ({result['launches']})")
    del tts, app_gen
    _collect(torch)
    result["encode"] = _apps_encode(torch, gen)
    print("main[apps] encode_streaming " + json.dumps(result["encode"]), flush=True)
    result["native"] = _apps_native()
    print("main[apps] native " + json.dumps(result["native"]), flush=True)
    result["phase_s"] = time.perf_counter() - t_phase
    print("main[apps] " + json.dumps({k: result[k] for k in (
        "card", "warmup_s", "launches", "apps_s", "peak_mem_gb", "loopback_requests",
        "phase_s")}), flush=True)
    return result


class _Interrupted(Exception):
    """A training run stopped from outside, as a killed job stops."""


class _StepProbe:
    """Wraps the train step's two halves (``train_step._accum_grads``: the
    forward and backward; ``train_step._apply_update``: the optimizer) with
    device synchronizations and host clocks, and keeps every step's loss
    and the last TrainState.  With ``stop_after`` the run is interrupted
    (``_Interrupted``) when it starts the step after that many; with
    ``keep_grads`` it keeps the gradient the first update applies."""

    def __init__(self, torch, ts, stop_after=None, keep_grads=False):
        self.torch, self.ts, self.stop_after = torch, ts, stop_after
        self.grads, self.update = ts._accum_grads, ts._apply_update
        self.apply, self.keep_grads, self.first_grads = ts.AdamW.apply, keep_grads, None
        self.fwd_bwd_s, self.opt_s, self.losses, self.c0, self.state = [], [], [], [], None
        self.norms = []

    def __enter__(self):
        torch = self.torch

        def grads(*a, **kw):
            if self.stop_after is not None and len(self.losses) >= self.stop_after:
                raise _Interrupted()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.grads(*a, **kw)
            torch.cuda.synchronize()
            self.fwd_bwd_s.append(time.perf_counter() - t0)
            return out

        def update(tx, state, g, metrics, *sync):
            t0 = time.perf_counter()
            out = self.update(tx, state, g, metrics, *sync)
            torch.cuda.synchronize()
            self.opt_s.append(time.perf_counter() - t0)
            self.losses.append(float(metrics["loss"]))
            self.c0.append(float(metrics["c0_loss"]))
            self.norms.append(float(metrics["grad_norm"]))
            self.state = out[0]
            return out

        def apply(tx, params, g, *rest):
            if self.first_grads is None:  # the logical gradient, summed on a mesh
                self.first_grads = self.ts.tree_map(lambda t: t.detach().clone(), g)
            return self.apply(tx, params, g, *rest)

        self.ts._accum_grads, self.ts._apply_update = grads, update
        if self.keep_grads:
            self.ts.AdamW.apply = apply
        return self

    def __exit__(self, *exc):
        self.ts._accum_grads, self.ts._apply_update = self.grads, self.update
        self.ts.AdamW.apply = self.apply

    def timing(self, rows_per_step: int) -> dict:
        step_s = [a + b for a, b in zip(self.fwd_bwd_s, self.opt_s)]
        steady = step_s[1:] or step_s  # the first step warms the allocator and cuBLAS
        mean = sum(steady) / len(steady)
        return {"steps": len(step_s), "s_per_step": step_s,
                "fwd_bwd_s": self.fwd_bwd_s, "optimizer_s": self.opt_s,
                "steps_per_s": 1.0 / mean, "rows_per_s": rows_per_step / mean,
                "losses": self.losses, "c0_losses": self.c0, "grad_norms": self.norms}


def _write_clips(root: str) -> str:
    """Speech-like 24 kHz clips of ``TRAIN_CLIPS_S`` seconds with transcripts."""
    from sesameai_tts_tpu_torch.audio.io import write_wav

    os.makedirs(root)
    for i, sec in enumerate(TRAIN_CLIPS_S):
        write_wav(os.path.join(root, f"clip{i}.wav"), _speechlike(sec, 24_000, 40 + i), 24_000)
        with open(os.path.join(root, f"clip{i}.txt"), "w") as f:
            f.write(f"Clip number {i} of the training phase says a few plain words.")
    return root


def _tree_diff(ts, a, b) -> dict:
    """Largest absolute difference of each differing leaf of two trees."""
    leaves = []
    for i, (x, y) in enumerate(zip(ts.tree_leaves(a), ts.tree_leaves(b))):
        if not bool(x.equal(y)):
            leaves.append((i, (x.float() - y.float()).abs().max().item()))
    return {"leaves": len(ts.tree_leaves(a)), "differing": leaves[:10]}


def _train_parity(torch, wrappers) -> dict:
    """One train step's loss and every gradient leaf at the tiny f32 flavor,
    on the card (the attention's kernels forward and backward) against the
    CPU (their plain versions)."""
    import numpy as np

    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.config import csm_test_tiny
    from sesameai_tts_tpu_torch.models.csm import init_csm_params
    from sesameai_tts_tpu_torch.training import train_step as ts
    from sesameai_tts_tpu_torch.training.loss import Batch, csm_loss

    cfg = csm_test_tiny()
    K = cfg.audio_num_codebooks
    rng = np.random.default_rng(0)
    B, S, text = 2, 40, 12
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    tokens[:, :text, K] = rng.integers(1, cfg.text_vocab_size, (B, text))
    mask[:, :text, K] = True
    tokens[:, text:, :K] = rng.integers(1, cfg.audio_vocab_size, (B, S - text, K))
    mask[:, text:, :K] = True
    loss_mask = np.ones((B, S), bool)
    loss_mask[1, 30:] = False  # a right-padded example
    params = init_csm_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    r = ts._subset_scores(0, B, S, seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        batch = ts.batch_to(Batch(tokens, mask, loss_mask), dev)
        _reset_counts(wrappers)
        out[dev] = ts._value_and_grad(
            lambda p: csm_loss(p, cfg, batch, 2, subset_r=r.to(dev)), to_device(params, dev))
        torch.cuda.synchronize()
        out[dev] = out[dev] + (_counts(wrappers),)
    (m_cpu, g_cpu, _), (m_gpu, g_gpu, launches) = out["cpu"], out["cuda"]
    rel = [((a - b.cpu()).abs().max() / a.abs().max().clamp_min(1e-30)).item()
           for a, b in zip(ts.tree_leaves(g_cpu), ts.tree_leaves(g_gpu))]
    loss_rel = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    layers = cfg.backbone.num_layers + cfg.decoder.num_layers
    result = {"loss_cpu": float(m_cpu["loss"]), "loss_card": float(m_gpu["loss"]),
              "loss_rel_err": loss_rel, "grad_leaves": len(rel), "grad_max_rel_err": max(rel),
              "launches": launches, "want_attention_launches": layers}
    _check(loss_rel <= TRAIN_PARITY_LOSS_RTOL, f"train parity: loss differs {result}")
    _check(max(rel) <= TRAIN_PARITY_GRAD_TOL, f"train parity: a gradient leaf differs {result}")
    _check(launches["flash_attention"] == layers and launches["flash_attention_bwd"] == layers,
           f"train parity: the tiny step did not go through the kernels {result}")
    return result


def phase_train(torch, wrappers, card: str) -> dict:
    """main[train]: ``sesame-tts-torch-finetune`` at CSM-1B full width (the
    random init of seed 0, the bench Llama-3-format tokenizer), on the card.

    (a) a full finetune, ``--dtype mixed``, batch 2 of the one training batch
    at the 256 bucket, ``TRAIN_STEPS`` steps at ``TRAIN_LR``: the loss finite and below the
    first step's at the end, the c0 loss of step 2 equal to step 1's (the
    first update has lr 0), exact launches (per step 20 flash_attention
    forward and 20 flash_attention_bwd, per eval batch 20 forward);
    (b) LoRA rank 16 at f32 with ``--remat``: an unbroken ``LORA_STEPS``-step
    run against one interrupted after its save at ``LORA_SPLIT`` and resumed
    with ``--resume`` (both ``--steps LORA_STEPS``, one schedule): adapters,
    Adam moments and counts bit-equal; forward launches 36 per step with
    remat (the backbone's 16 recomputed);
    (c) the resumed run's merged export served through
    ``csm_1b_spec(csm_checkpoint=<ckpt>/params)`` (int8): one request;
    (d) the tiny f32 flavor's train step, card against CPU.
    cuDNN runs deterministic algorithms for the phase, so the codec's encodes
    are equal across runs."""
    import shutil
    import tempfile

    import numpy as np

    from sesameai_tts_tpu_torch.core.config import csm_1b
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    from sesameai_tts_tpu_torch.training import finetune
    from sesameai_tts_tpu_torch.training import train_step as ts

    t_phase = time.perf_counter()
    cfg = csm_1b()
    per_pass = cfg.backbone.num_layers + cfg.decoder.num_layers
    tokenizer = os.path.join(HERE, "sesameai_tts_tpu_torch", "assets", "bench_tokenizer.json")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    result = {"card": card}
    try:
        data = _write_clips(os.path.join(tmp, "clips"))
        common = ["--data", data, "--flavor", "csm-1b", "--tokenizer", tokenizer,
                  "--batch-size", "2", "--buckets", "256,512", "--eval-frac", "0.5",
                  "--warmup", "1", "--log-every", "1", "-d", "cuda"]
        rows_per_step = 2 * 256

        # (a) the full mixed finetune
        _reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _StepProbe(torch, ts) as probe:
            metrics = finetune.main(common + ["--dtype", "mixed", "--steps", str(TRAIN_STEPS),
                                              "--lr", str(TRAIN_LR)])
        torch.cuda.synchronize()
        full = {"run_s": time.perf_counter() - t0, "final": metrics,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": _counts(wrappers), **probe.timing(rows_per_step)}
        del probe.state
        _collect(torch)
        print("main[train] full " + json.dumps(full), flush=True)
        losses = full["losses"]
        _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
               f"train: {len(losses)} steps or a loss not finite: {losses}")
        _check(losses[-1] < losses[0], f"train: the full finetune's loss did not fall: {losses}")
        _check(full["c0_losses"][1] == full["c0_losses"][0],
               f"train: the first update (lr 0) moved the params: {full['c0_losses']}")
        evals = 1  # one held-out batch, evaluated once at the end
        want = {"flash_attention": per_pass * (TRAIN_STEPS + evals),
                "flash_attention_bwd": per_pass * TRAIN_STEPS}
        got = {k: full["launches"][k] for k in want}
        _check(got == want, f"train: launches {got}, want {want}")
        _check(all(full["launches"][k] == 0 for k in ("quant_matmul", "quant4_matmul",
                                                        "quant_mlp")),
               f"train: a quant kernel ran in dense training: {full['launches']}")
        result["full"] = full

        # (b) LoRA at f32: an unbroken run against one interrupted after its
        # save at LORA_SPLIT and resumed, both with --steps LORA_STEPS (one
        # schedule)
        lora = common + ["--dtype", "f32", "--lora-rank", "16", "--remat",
                         "--steps", str(LORA_STEPS)]
        ckpt = ["--ckpt-dir", os.path.join(tmp, "lora"), "--save-every", str(LORA_SPLIT)]
        runs = {}
        for name, argv, stop in (("unbroken", [], None), ("interrupted", ckpt, LORA_SPLIT),
                                 ("resumed", ckpt + ["--resume"], None)):
            _reset_counts(wrappers)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = None
            with _StepProbe(torch, ts, stop_after=stop) as probe:
                try:
                    metrics = finetune.main(lora + argv)
                except _Interrupted:
                    pass
            torch.cuda.synchronize()
            runs[name] = {"run_s": time.perf_counter() - t0, "final": metrics,
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "launches": _counts(wrappers), **probe.timing(rows_per_step)}
            runs[name]["state"] = probe.state
            steps = len(runs[name]["losses"])
            evals = 0 if stop else 1
            want = {"flash_attention": (per_pass + cfg.backbone.num_layers) * steps
                    + per_pass * evals, "flash_attention_bwd": per_pass * steps}
            got = {k: runs[name]["launches"][k] for k in want}
            _check(got == want, f"train: LoRA {name}: launches {got}, want {want}")
            print(f"main[train] lora {name} " + json.dumps(
                {k: v for k, v in runs[name].items() if k != "state"}), flush=True)
            _collect(torch)
        a, b = runs["unbroken"]["state"], runs["resumed"]["state"]
        diff = {"adapters": _tree_diff(ts, a.params, b.params),
                "opt_state": _tree_diff(ts, a.opt_state, b.opt_state),
                "step": [int(a.step), int(b.step)]}
        print("main[train] lora resume vs unbroken " + json.dumps(diff), flush=True)
        _check(not diff["adapters"]["differing"] and not diff["opt_state"]["differing"]
               and int(a.step) == int(b.step) == LORA_STEPS,
               f"train: the resumed LoRA run is not bit-equal to the unbroken one: {diff}")
        _check(runs["resumed"]["losses"] == runs["unbroken"]["losses"][LORA_SPLIT:],
               f"train: resumed losses {runs['resumed']['losses']} != "
               f"{runs['unbroken']['losses']}")
        result["lora"] = {k: {x: y for x, y in r.items() if x != "state"} for k, r in runs.items()}
        result["lora"]["resume_vs_unbroken"] = diff
        del runs, a, b
        _collect(torch)

        # (c) serve the merged export (int8)
        t0 = time.perf_counter()
        gen = build_generator(csm_1b_spec(csm_checkpoint=os.path.join(tmp, "lora", "params"),
                                          tokenizer=tokenizer), device="cuda")
        built_s = time.perf_counter() - t0
        pcm = gen.generate("The finetuned model speaks one sentence.", 0, [],
                           max_audio_length_ms=TRAIN_SERVE_MS, topk=1)
        torch.cuda.synchronize()
        result["serve"] = {"build_s": built_s, "samples": int(pcm.size),
                           "rms": float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
                           if pcm.size else 0.0,
                           "export_gb": os.path.getsize(os.path.join(tmp, "lora", "params")) / 1e9}
        print("main[train] serve " + json.dumps(result["serve"]), flush=True)
        _check(pcm.size > 0 and bool(np.isfinite(pcm).all()),
               "train: the served export gave no or non-finite audio")
        del gen
        _collect(torch)

        # (d) card against CPU, tiny
        result["parity"] = _train_parity(torch, wrappers)
        print("main[train] parity " + json.dumps(result["parity"]), flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn
        shutil.rmtree(tmp, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"main[train] summary " + json.dumps({
        "full_steps_per_s": result["full"]["steps_per_s"],
        "full_rows_per_s": result["full"]["rows_per_s"],
        "full_s_per_step_fwd_bwd": result["full"]["fwd_bwd_s"],
        "full_s_per_step_optimizer": result["full"]["optimizer_s"],
        "full_peak_mem_gb": result["full"]["peak_mem_gb"],
        "lora_steps_per_s": result["lora"]["unbroken"]["steps_per_s"],
        "lora_peak_mem_gb": result["lora"]["unbroken"]["peak_mem_gb"],
        "phase_s": result["phase_s"], "card": card}), flush=True)
    return result


def phase_shards(torch, quant, attention, peak_bw, peak_flops):
    """The kernels at one rank's tp = 2 shard shapes (``_TP2_*``), against
    their plain versions as in the phases above, then each kernel's time
    summed over one decoded frame's launches on one rank of a tp = 2 mesh."""
    rows = {
        "quant_matmul": phase_quant_matmul(torch, quant, peak_bw, peak_flops, _TP2_SHAPES,
                                           _TP2_S_VALUES),
        "quant_mlp": phase_quant_mlp(torch, quant, peak_bw, peak_flops, _TP2_MLP_SHAPES,
                                     _TP2_S_VALUES),
        "flash_attention": phase_flash_attention(torch, attention, peak_bw, peak_flops,
                                                 _TP2_ATTN_CASES),
    }
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    frame = {name: {k: sum(r[k] * r["per_frame"] for r in rows[name] if r["S"] == 1)
                    for k in keys} for name in ("quant_matmul", "quant_mlp")}
    attn = rows["flash_attention"]
    backbone = next(r for r in attn if r["S"] == 1 and r["hd"] == 64)
    decoder = [r for r in attn if r["hd"] == 128]
    frame["flash_attention"] = {k: backbone[k] * 16 + sum(r[k] for r in decoder) / len(decoder)
                                * 128 for k in keys}
    print("kernel per decoded frame on one rank at tp=2 " + json.dumps(frame), flush=True)
    rows["per_frame"] = frame
    return rows


def _snr_db(np, got, want) -> float:
    """Median over steps of 10 log10(sum want^2 / sum (got - want)^2)."""
    err = got - want
    return float(np.median(10.0 * np.log10(np.sum(want * want, axis=-1)
                                           / np.maximum(np.sum(err * err, axis=-1), 1e-20))))


def _teacher_logits(torch, gen, text: str, teacher):
    """The teacher-forced codebook-0 logits over ``teacher`` (T, 1, K) after
    the unpadded prompt of ``text``, prefilled through the int8 trunks
    (``gen._params``, on a mesh this rank's shards) → (T, V) f32 numpy."""
    from sesameai_tts_tpu_torch.models import csm

    tokens, mask = gen._tokenize_prompt(text, 0, [])
    with gen._request(), torch.no_grad():
        state = gen._init_state(1)
        _, state = csm.backbone_last_hidden(
            gen._params, gen._cfg, state, torch.from_numpy(tokens[None]).to(gen.device),
            torch.from_numpy(mask[None]).to(gen.device), rope_cs=gen._rope, tp=gen._tp)
        _, logits = csm.teacher_forced_eval(gen._params, gen._cfg, state,
                                            torch.from_numpy(teacher).to(gen.device),
                                            rope_cs=gen._rope, tp=gen._tp)
    return logits[:, 0].float().cpu().numpy()


def _mesh_rank(rank: int, world: int, tmp: str, case: str) -> None:
    """One rank of main[mesh] (a process the phase spawns): joins a gloo
    group of ``world`` at a FileStore in ``tmp``, sharing cuda:0 with the
    other ranks, builds CSM-1B int8 from seed 0 on the case's mesh, runs the
    case and writes its results to ``tmp/rank<r>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from sesameai_tts_tpu_torch.ops import kernels
    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    if not torch.cuda.is_available():
        raise RuntimeError(f"main[mesh] rank {rank}: no CUDA device (a rank on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda:0")  # the context exists before the mesh
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    # the ranks share one card: NCCL refuses that, so the caller asks for gloo
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    wrappers = kernels.wrappers()
    out = {"rank": rank}
    try:
        dp, tp = (1, 2) if case == "tp" else (2, 1)
        t0 = time.perf_counter()
        gen = build_generator(csm_1b_spec(), device="cuda:0", mesh=make_mesh(dp, tp))
        torch.cuda.synchronize()
        out.update(build_s=time.perf_counter() - t0, graphed=gen.graphed,
                   built_gb=torch.cuda.memory_allocated() / 1e9,
                   build_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   device=str(gen.device))
        torch.cuda.reset_peak_memory_stats()
        if case == "tp":
            out.update(_mesh_tp_case(torch, np, gen, wrappers))
        else:
            srv = BatchedTTSServer(gen, slots=4, chunk_frames=MESH_CHUNK)
            t0 = time.perf_counter()
            srv.warmup()  # every rank: its graphs, prefill buckets and codec, before traffic
            out["warmup_s"] = time.perf_counter() - t0
            if rank == 0:
                out.update(_mesh_serve(torch, np, srv))
            else:
                t0 = time.perf_counter()
                srv.start()  # the follower loop, until rank 0 stops the server
                out["follower_s"] = time.perf_counter() - t0
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _mesh_tp_case(torch, np, gen, wrappers) -> dict:
    """main[mesh] (a) on one rank: the greedy and the sampled request with
    launches counted, then the teacher-forced logits over the greedy frames."""
    from sesameai_tts_tpu_torch.ops.quant import routes_to_kernel
    from sesameai_tts_tpu_torch.runtime.generator import _next_bucket

    buckets = [_next_bucket(gen._tokenize_prompt(text, 0, [])[0].shape[0], gen._prefill_buckets,
                            room=gen.max_seq_len) for text in (MESH_TEXT, MESH_SAMPLED_TEXT)]
    _reset_counts(wrappers)
    t0 = time.perf_counter()
    greedy = gen.generate_frames(MESH_TEXT, 0, [], max_audio_length_ms=MESH_MS,
                                 temperature=1.0, topk=1, seed=1)
    greedy_s = time.perf_counter() - t0
    sampled = gen.generate_frames(MESH_SAMPLED_TEXT, 0, [], max_audio_length_ms=MESH_SAMPLED_MS,
                                  temperature=0.8, topk=40, seed=5)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    m = gen.metrics.summary()
    decoded = int(m["decoded_frames"]["total"])
    pcm = gen.decode_audio(greedy)
    teacher = np.zeros((len(greedy), 1, greedy.shape[1]), np.int64)
    teacher[:, 0] = greedy
    t0 = time.perf_counter()
    logits = _teacher_logits(torch, gen, MESH_TEXT, teacher)
    return {
        "greedy": greedy.tolist(), "sampled": sampled.tolist(), "buckets": buckets,
        # a prefill of at most 64 rows sends the backbone's linears to the kernel
        "prefills_to_kernel": sum(routes_to_kernel("cuda", b) for b in buckets),
        "launches": launches, "decoded_frames": decoded, "requests": 2,
        "ms_per_decoded_frame": m["decode_s"]["total"] / decoded * 1e3,
        "prefill_ms": m["prefill_s"]["mean"] * 1e3, "greedy_request_s": greedy_s,
        "pcm_samples": int(pcm.shape[0]), "pcm_finite": bool(np.isfinite(pcm).all()),
        "pcm_peak": float(np.abs(pcm).max()), "hop": gen._hop,
        "teacher_forced_s": time.perf_counter() - t0, "logits": logits.tolist(),
    }


def _mesh_sessions(np, srv) -> dict:
    """MESH_SESSIONS on a started server, greedy, the MESH_CANCEL-th one
    cancelled at its first audio → {"codes": per session (None: the
    cancelled one), timing}."""
    t0 = time.perf_counter()
    sessions = [srv.submit(text, max_audio_length_ms=ms, temperature=1.0, topk=1)
                for text, ms in MESH_SESSIONS]
    first = sessions[MESH_CANCEL].chunks.get(timeout=300)
    sessions[MESH_CANCEL].cancel()
    codes = []
    for i, s in enumerate(sessions):
        audio = s.audio(timeout=300)
        _check(np.isfinite(audio).all(), f"main[mesh]: session {i} PCM is not finite")
        frames = np.concatenate(s.frames_out) if s.frames_out else np.zeros((0, 32), np.int32)
        if i == MESH_CANCEL:
            _check(first is not None, "main[mesh]: the cancelled session had no first audio")
            codes.append(None)
            continue
        _check(len(audio) == len(frames) * srv.gen._hop,
               f"main[mesh]: session {i}: {len(audio)} samples for {len(frames)} frames")
        codes.append(frames.tolist())
    wall = time.perf_counter() - t0
    m = srv.metrics.summary()
    frames_total = srv.metrics_summary()["frames_total"]
    return {"codes": codes, "wall_s": wall, "frames_total": frames_total,
            "frames_per_s": frames_total / wall, "ticks": m["tick_frames"]["count"],
            "frame_steps": m["tick_frames"]["total"],
            "ms_per_frame_step": wall / m["tick_frames"]["total"] * 1e3,
            "ttfa_p50_s": m["ttfa_s"]["p50"], "ttfa_max_s": m["ttfa_s"]["max"]}


def _mesh_serve(torch, np, srv) -> dict:
    """main[mesh] (b) on rank 0: start the pool (graphs captured per rank),
    serve MESH_SESSIONS, stop (the followers leave their loops)."""
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    try:
        out = _mesh_sessions(np, srv)
    finally:
        srv.stop()
    out.update(start_s=start_s, graphs=len(srv._ticker._graphs),
               rows=[srv._rows.start, srv._rows.stop])
    return out


def _run_world(torch, world: int, case: str, target=None, extra=(),
               timeout: float = MESH_TIMEOUT_S) -> list:
    """Spawn ``world`` ranks of ``target`` (default ``_mesh_rank``) and case
    ``case`` on the one card and wait for them (``timeout`` at most; a rank
    that fails or outlives it fails the phase, and every rank is stopped) →
    their results by rank."""
    import tempfile

    import torch.multiprocessing as mp

    target = target or _mesh_rank
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(target, args=(world, tmp, case, *extra), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                _check(time.monotonic() < deadline,
                       f"{target.__name__} {case}: the ranks outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def phase_mesh(torch, wrappers, card: str) -> dict:
    """main[mesh]: the port's Generator and BatchedTTSServer on a mesh of two
    processes sharing the one H100 over gloo (see MESH_*), held against the
    parent's single-process int8 Generator and a one-process 2-slot pool, on
    a mesh of one and as the single-card server."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh
    from sesameai_tts_tpu_torch.runtime.generator import Generator
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    print(f"main[mesh]: two ranks share the one card ({card}) over backend=gloo, "
          "spawned by this script", flush=True)
    t0 = time.perf_counter()
    tp_ranks = _run_world(torch, 2, "tp")
    tp_s = time.perf_counter() - t0
    r0, r1 = tp_ranks
    for key in ("greedy", "sampled"):
        _check(r0[key] == r1[key], f"main[mesh] (a): the ranks' {key} frames differ")
    greedy = np.asarray(r0["greedy"], np.int64)
    _check(len(greedy) > 1, "main[mesh] (a): the greedy request gave no frames")
    _check(r0["pcm_finite"] and r0["pcm_samples"] == len(greedy) * r0["hop"]
           and r0["hop"] * 1000 == 80 * 24000,
           f"main[mesh] (a): PCM {r0['pcm_samples']} samples for {len(greedy)} frames")
    _check(not r0["graphed"] and not r1["graphed"], "main[mesh] (a): a tp step was graphed")
    steps = r0["decoded_frames"] + r0["requests"]  # the prefill's frame is a step too
    # a decoded frame: 64 backbone and 512 decoder linears, 16 + 128 attentions;
    # a prefill step: the backbone over the prompt (its 64 linears on the
    # kernel at <= 64 rows), then the prefill frame's decoder
    want = {"quant_matmul": 576 * steps - 64 * (r0["requests"] - r0["prefills_to_kernel"]),
            "flash_attention": 144 * steps}
    for r in tp_ranks:
        for name, n in want.items():
            _check(r["launches"][name] == n,
                   f"main[mesh] (a) rank {r['rank']}: {r['launches'][name]} {name} launches, "
                   f"want {n}")
        _check(r["launches"]["quant4_matmul"] == r["launches"]["quant_mlp"] == 0
               and r["launches"]["flash_attention_bwd"] == 0,
               f"main[mesh] (a) rank {r['rank']}: other kernels launched {r['launches']}")
    # the parent's single-process int8 Generator: the teacher-forced logits
    # over the mesh's greedy frames, and its own greedy codes beside them
    t0 = time.perf_counter()
    gen = build_generator(csm_1b_spec(), device="cuda")
    cfg = gen._cfg
    teacher = greedy[:, None, :]
    ref = _teacher_logits(torch, gen, MESH_TEXT, teacher)
    snrs = [_snr_db(np, np.asarray(r["logits"], np.float32), ref) for r in tp_ranks]
    single = gen.generate_frames(MESH_TEXT, 0, [], max_audio_length_ms=MESH_MS,
                                 temperature=1.0, topk=1, seed=1)
    n = min(len(single), len(greedy))
    agreement = {"code_match": float((single[:n] == greedy[:n]).mean()),
                 "frame_match": float((single[:n] == greedy[:n]).all(axis=1).mean()),
                 "frames": [len(greedy), len(single)]}
    a = {"seconds": tp_s, "logit_snr_db": snrs, "min_logit_snr_db": MESH_MIN_SNR_DB,
         "greedy_agreement_with_single": agreement, "frames": len(greedy),
         **{k: r0[k] for k in ("ms_per_decoded_frame", "prefill_ms", "buckets",
                               "decoded_frames", "teacher_forced_s", "pcm_peak")},
         "per_rank": [{k: r[k] for k in ("rank", "build_s", "built_gb", "build_peak_gb",
                                         "peak_gb", "ms_per_decoded_frame", "launches",
                                         "device")}
                      for r in tp_ranks],
         "expected_launches": want}
    print("main[mesh] (a) dp 1 tp 2 " + json.dumps(a), flush=True)
    for snr in snrs:
        _check(snr >= MESH_MIN_SNR_DB,
               f"main[mesh] (a): teacher-forced logit SNR {snr:.2f} dB < {MESH_MIN_SNR_DB}")
    # (b): the ranks' pool, then the one-process pool of 2 slots on a mesh of
    # one (its prefill is a mesh's: no dense shadow), the per-rank pool
    t0 = time.perf_counter()
    dp_ranks = _run_world(torch, 2, "dp")
    dp_s = time.perf_counter() - t0
    got = dp_ranks[0]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            one = Generator(gen._params, cfg, gen._mimi, gen._mimi_params,
                            gen._tokenizer.text_tokenizer, device="cuda",
                            mesh=make_mesh(1, 1))
            ref_srv = BatchedTTSServer(one, slots=2, chunk_frames=MESH_CHUNK)
            ref_srv.warmup()
            ref_srv.start()
            try:
                ref_out = _mesh_sessions(np, ref_srv)
            finally:
                ref_srv.stop()
        finally:
            dist.destroy_process_group()
    # and the single-card server (no mesh, no plan, its pipelined admissions)
    # on a clone of the parent's Generator that prefills through the int8
    # trunks, the route a mesh's prefill takes, in place of its dense shadow
    solo = gen.clone()
    solo._prefill_params = solo._params
    card_srv = BatchedTTSServer(solo, slots=2, chunk_frames=MESH_CHUNK)
    card_srv.warmup()
    card_srv.start()
    try:
        card_out = _mesh_sessions(np, card_srv)
    finally:
        card_srv.stop()
    equal, card_equal = [], []
    for i, (g, w, c) in enumerate(zip(got["codes"], ref_out["codes"], card_out["codes"])):
        if i == MESH_CANCEL:
            continue
        equal.append(g == w)
        card_equal.append(g == c)
    b = {"seconds": dp_s, "graphed": [r["graphed"] for r in dp_ranks],
         "graphs_rank0": got["graphs"], "rows_rank0": got["rows"],
         "sessions_equal_to_one_process_pool": equal,
         "sessions_equal_to_single_card_server": card_equal,
         "frames": [None if c is None else len(c) for c in got["codes"]],
         **{k: got[k] for k in ("ticks", "frame_steps", "ms_per_frame_step", "frames_per_s",
                                "ttfa_p50_s", "ttfa_max_s", "wall_s", "start_s")},
         "one_process_pool": {k: ref_out[k] for k in ("ticks", "ms_per_frame_step",
                                                      "frames_per_s", "ttfa_p50_s")},
         "single_card_server": {k: card_out[k] for k in ("ticks", "ms_per_frame_step",
                                                         "frames_per_s", "ttfa_p50_s")},
         "per_rank": [{k: r.get(k) for k in ("rank", "build_s", "built_gb", "build_peak_gb",
                                             "peak_gb", "warmup_s", "follower_s")}
                      for r in dp_ranks]}
    print("main[mesh] (b) dp 2 tp 1 " + json.dumps(b), flush=True)
    _check(all(r["graphed"] for r in dp_ranks), "main[mesh] (b): a tp = 1 rank is not graphed")
    _check(all(equal), f"main[mesh] (b): session codes differ from the one-process pool: "
                       f"{equal}")
    _check(all(card_equal), f"main[mesh] (b): session codes differ from the single-card "
                            f"server's: {card_equal}")
    del gen, one, ref_srv, solo, card_srv
    return {"tp": a, "dp": b, "launches": {**{name: 0 for name in wrappers},
                                           **r0["launches"]}}


def _train_mesh_runs(data: str, out_dir: str) -> dict:
    """{name: (finetune argv, global padded rows a step, eval batches)} of
    the runs of the main[train_mesh] world, in order: (a) dense at dp 1,
    tp 2, f32 then mixed; (b) LoRA at dp 2, tp 1.  Without ``--mesh`` an
    argv is the one-card run it is held against."""
    tokenizer = os.path.join(HERE, "sesameai_tts_tpu_torch", "assets", "bench_tokenizer.json")
    common = ["--data", data, "--flavor", "csm-1b", "--tokenizer", tokenizer,
              "--buckets", "256,512", "--eval-frac", "0.5", "--warmup", "1", "--log-every",
              "1", "-d", "cuda"]
    return {
        "f32": (common + ["--mesh", "1,2", "--dtype", "f32", "--batch-size", "1",
                          "--steps", "1", "--lr", str(TRAIN_LR)], 256, 2),
        "mixed": (common + ["--mesh", "1,2", "--dtype", "mixed", "--batch-size", "2",
                            "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
                            "--ckpt-dir", os.path.join(out_dir, "dense"),
                            "--save-every", "1000"], 512, 1),
        "lora": (common + ["--mesh", "2,1", "--dtype", "f32", "--batch-size", "2",
                           "--lora-rank", "16", "--remat", "--steps", str(LORA_STEPS)], 512, 1)}


def _without_mesh(argv: list) -> list:
    i = argv.index("--mesh")
    return argv[:i] + argv[i + 2:]


def _train_mesh_rank(rank: int, world: int, tmp: str, case: str, data: str,
                     out_dir: str) -> None:
    """One rank of main[train_mesh] (a process the phase spawns): joins a
    gloo group of ``world`` at a FileStore in ``tmp``, sharing cuda:0, runs
    the finetunes of ``_train_mesh_runs`` (each on its own mesh of the two
    ranks) with the kernels, the attention's head counts and the collectives
    counted, and writes its results to ``tmp/rank<r>.json`` (the LoRA run's
    adapters and first gradient to ``out_dir``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from sesameai_tts_tpu_torch.core.weights import save_pytree
    from sesameai_tts_tpu_torch.models import transformer
    from sesameai_tts_tpu_torch.ops import kernels
    from sesameai_tts_tpu_torch.training import finetune
    from sesameai_tts_tpu_torch.training import train_step as ts

    if not torch.cuda.is_available():
        raise RuntimeError(f"main[train_mesh] rank {rank}: no CUDA device (a rank on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the codec's encodes equal across processes, as in main[train]
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda:0")
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    wrappers = kernels.wrappers()
    heads, collectives = set(), {}
    attend = transformer.flash_attention

    def recording(q, k, *rest):
        heads.add((q.shape[1], k.shape[1], q.shape[3]))  # (H, KV, hd) a call runs at
        return attend(q, k, *rest)

    transformer.flash_attention = recording
    for name in ("all_reduce", "all_gather", "barrier"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **kw):
            collectives[_name] = collectives.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    out = {"rank": rank, "runs": {}}
    try:
        for name, (argv, rows, evals) in _train_mesh_runs(data, out_dir).items():
            _reset_counts(wrappers)
            heads.clear()
            collectives.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _StepProbe(torch, ts, keep_grads=name == "lora") as probe:
                metrics = finetune.main(argv)
            torch.cuda.synchronize()
            out["runs"][name] = {
                "run_s": time.perf_counter() - t0, "final": metrics,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": _counts(wrappers), "heads": sorted(heads),
                "collectives": dict(collectives), "eval_batches": evals,
                **probe.timing(rows)}
            if name == "lora":
                save_pytree(os.path.join(out_dir, f"adapters_rank{rank}"), probe.state.params)
                save_pytree(os.path.join(out_dir, f"grads_rank{rank}"), probe.first_grads)
            del probe.state, probe.first_grads
            _collect(torch)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _one_card_run(torch, wrappers, ts, finetune, argv: list, rows: int):
    """The one-card finetune a mesh run is held against, in this process →
    (its probe's timing, its last state)."""
    _reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    with _StepProbe(torch, ts, keep_grads=True) as probe:
        finetune.main(_without_mesh(argv))
    torch.cuda.synchronize()
    run = {**probe.timing(rows), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": _counts(wrappers)}
    return run, probe


def _check_train_mesh_ranks(ranks: list, cfg) -> None:
    """Both ranks log the same losses; exact forward and backward attention
    launches a rank, at the rank's local heads; no quant kernel."""
    from sesameai_tts_tpu_torch.parallel.mesh import tp_heads

    per_pass = cfg.backbone.num_layers + cfg.decoder.num_layers
    bb = cfg.backbone
    for name, run in ranks[0]["runs"].items():
        n = 1 if name == "lora" else 2  # the run's tp
        want_heads = sorted([len(h) for h in tp_heads(t.num_heads, t.num_kv_heads, n, 0)]
                            + [t.head_dim] for t in (bb, cfg.decoder))
        other = ranks[1]["runs"][name]
        _check(run["losses"] == other["losses"] and run["grad_norms"] == other["grad_norms"],
               f"main[train_mesh] {name}: the ranks logged different losses "
               f"{run['losses']} / {other['losses']}")
        for r in ranks:
            got = r["runs"][name]
            steps = len(got["losses"])
            remat = bb.num_layers * steps if name == "lora" else 0
            want = {"flash_attention": per_pass * (steps + got["eval_batches"]) + remat,
                    "flash_attention_bwd": per_pass * steps}
            launched = {k: got["launches"][k] for k in want}
            _check(launched == want, f"main[train_mesh] {name} rank {r['rank']}: launches "
                                     f"{launched}, want {want}")
            _check(all(got["launches"][k] == 0 for k in ("quant_matmul", "quant4_matmul",
                                                          "quant_mlp")),
                   f"main[train_mesh] {name}: a quant kernel ran: {got['launches']}")
            _check(got["heads"] == want_heads, f"main[train_mesh] {name} rank {r['rank']}: "
                                               f"attention at {got['heads']}, want {want_heads}")


def phase_train_mesh(torch, wrappers, card: str) -> dict:
    """main[train_mesh]: ``sesame-tts-torch-finetune --mesh`` at CSM-1B full
    width (the random init of seed 0, the bench tokenizer, the clips of
    main[train]) on worlds of two ranks that this script spawns and that
    share the one card over gloo (NCCL refuses two ranks on one card; a
    dense dp gradient all_reduce at full width through the host is not run).
    One world of two ranks runs the three finetunes, each on its own mesh.

    (a) dense at dp 1, tp 2: one f32 step at B 1 × 256 against the one-card
    f32 step on the same batch (loss within ``TRAIN_MESH_LOSS_RTOL``,
    ``grad_norm`` within ``TRAIN_MESH_NORM_RTOL``); then ``--dtype mixed``
    at B 2 × 256 for ``TRAIN_STEPS`` steps (both ranks log the same losses,
    the last below the first), its TrainState checkpoint and export
    gathered by rank 0;
    (b) LoRA rank 16 at dp 2, tp 1, f32 with ``--remat``: the first
    update's gradient (summed over dp) within ``TRAIN_MESH_LORA_GRAD_TOL``
    of a one-process run's on the same global batch, the per-step losses
    within ``TRAIN_MESH_LORA_LOSS_RTOL``, the final adapters bit-equal on
    both ranks and within ``TRAIN_MESH_LORA_TOL`` of the one process's;
    (c) the gathered export of (a) served by a one-card int8 Generator;
    exact attention launches a rank (forward and backward, at the rank's
    local heads), the step times, peak memory and collectives a rank."""
    import shutil
    import tempfile

    import numpy as np

    from sesameai_tts_tpu_torch.core.config import csm_1b
    from sesameai_tts_tpu_torch.core.weights import load_pytree
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    from sesameai_tts_tpu_torch.training import finetune
    from sesameai_tts_tpu_torch.training import train_step as ts

    t_phase = time.perf_counter()
    cfg = csm_1b()
    tokenizer = os.path.join(HERE, "sesameai_tts_tpu_torch", "assets", "bench_tokenizer.json")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    print(f"main[train_mesh]: two ranks share the one card ({card}) over backend=gloo, "
          "spawned by this script", flush=True)
    result = {"card": card}
    try:
        data = _write_clips(os.path.join(tmp, "clips"))
        runs = _train_mesh_runs(data, tmp)
        t0 = time.perf_counter()
        ranks = _run_world(torch, 2, "train", _train_mesh_rank, (data, tmp),
                           TRAIN_MESH_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        _check_train_mesh_ranks(ranks, cfg)
        # (a) dense, dp 1 tp 2
        f32_argv = runs["f32"][0]
        one, probe = _one_card_run(torch, wrappers, ts, finetune, f32_argv, 256)
        del probe
        _collect(torch)
        mesh_f32 = ranks[0]["runs"]["f32"]
        parity = {"loss_mesh": mesh_f32["losses"][0], "loss_one_card": one["losses"][0],
                  "grad_norm_mesh": mesh_f32["grad_norms"][0],
                  "grad_norm_one_card": one["grad_norms"][0]}
        parity["loss_rel_err"] = abs(parity["loss_mesh"] - parity["loss_one_card"]) / abs(
            parity["loss_one_card"])
        parity["grad_norm_rel_err"] = abs(parity["grad_norm_mesh"]
                                          - parity["grad_norm_one_card"]) / abs(
            parity["grad_norm_one_card"])
        mixed = ranks[0]["runs"]["mixed"]
        a = {"world_s": world_s, "f32_parity": parity,
             "f32_one_card": {k: one[k] for k in ("fwd_bwd_s", "optimizer_s", "peak_mem_gb")},
             "per_rank": [{name: {k: v for k, v in r["runs"][name].items() if k != "launches"}
                           for name in ("f32", "mixed")} for r in ranks],
             "launches_rank0": {name: ranks[0]["runs"][name]["launches"]
                                for name in ("f32", "mixed")}}
        dense = os.path.join(tmp, "dense")
        ckpt = sorted(n for n in os.listdir(dense) if n.startswith("step_"))
        a["checkpoint_gb"] = [os.path.getsize(os.path.join(dense, n)) / 1e9 for n in ckpt]
        print("main[train_mesh] (a) dp 1 tp 2 " + json.dumps(a), flush=True)
        _check(parity["loss_rel_err"] <= TRAIN_MESH_LOSS_RTOL,
               f"main[train_mesh] (a): the f32 tp 2 loss differs from one card's {parity}")
        _check(parity["grad_norm_rel_err"] <= TRAIN_MESH_NORM_RTOL,
               f"main[train_mesh] (a): the f32 tp 2 grad_norm differs from one card's {parity}")
        losses = mixed["losses"]
        _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
               f"main[train_mesh] (a): the mixed tp 2 finetune's losses {losses}")
        result["a"] = a
        _check(ckpt == [f"step_{TRAIN_STEPS:08d}"], f"main[train_mesh] (a): checkpoints {ckpt}")
        os.remove(os.path.join(dense, ckpt[0]))  # 19 GB of f32 params and moments

        # (b) LoRA, dp 2 tp 1
        one, probe = _one_card_run(torch, wrappers, ts, finetune, runs["lora"][0], 512)
        want = [t.float().cpu() for t in ts.tree_leaves(probe.state.params)]
        want_grads = [t.float().cpu() for t in ts.tree_leaves(probe.first_grads)]
        del probe
        _collect(torch)

        def rel_errs(got, want):
            return [((g.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                    for g, w in zip(got, want)]

        adapters = [ts.tree_leaves(load_pytree(os.path.join(tmp, f"adapters_rank{r}")))
                    for r in range(2)]
        grads = ts.tree_leaves(load_pytree(os.path.join(tmp, "grads_rank0")))
        bit_equal = all(torch.equal(x, y) for x, y in zip(*adapters))
        errs, grad_errs = rel_errs(adapters[0], want), rel_errs(grads, want_grads)
        lora = ranks[0]["runs"]["lora"]
        loss_errs = [abs(x - y) / abs(y) for x, y in zip(lora["losses"], one["losses"])]
        b = {"adapters_bit_equal_across_ranks": bit_equal,
             "adapter_leaves": len(want), "adapter_max_rel_err": max(errs),
             "first_grad_max_rel_err": max(grad_errs),
             "loss_rel_errs": loss_errs, "losses_one_process": one["losses"],
             "one_process": {k: one[k] for k in ("fwd_bwd_s", "optimizer_s", "peak_mem_gb",
                                                 "steps_per_s")},
             "per_rank": [{k: v for k, v in r["runs"]["lora"].items() if k != "launches"}
                          for r in ranks],
             "launches_rank0": lora["launches"]}
        print("main[train_mesh] (b) dp 2 tp 1 lora " + json.dumps(b), flush=True)
        _check(bit_equal, "main[train_mesh] (b): the ranks' adapters differ")
        _check(len(adapters[0]) == len(want) == len(grads)
               and max(grad_errs) <= TRAIN_MESH_LORA_GRAD_TOL
               and max(errs) <= TRAIN_MESH_LORA_TOL
               and max(loss_errs) <= TRAIN_MESH_LORA_LOSS_RTOL,
               f"main[train_mesh] (b): the dp 2 LoRA run differs from one process: the "
               f"first gradient {max(grad_errs)}, the adapters {max(errs)} of a leaf's "
               f"peak, losses {loss_errs}")
        result["b"] = b

        # (c) the gathered export of (a), served on one card (int8)
        t0 = time.perf_counter()
        gen = build_generator(csm_1b_spec(csm_checkpoint=os.path.join(dense, "params"),
                                          tokenizer=tokenizer), device="cuda")
        built_s = time.perf_counter() - t0
        pcm = gen.generate("The model trained on two ranks speaks.", 0, [],
                           max_audio_length_ms=TRAIN_SERVE_MS, topk=1)
        torch.cuda.synchronize()
        result["c"] = {"build_s": built_s, "samples": int(pcm.size),
                       "export_gb": os.path.getsize(os.path.join(dense, "params")) / 1e9,
                       "rms": float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
                       if pcm.size else 0.0}
        print("main[train_mesh] (c) serve " + json.dumps(result["c"]), flush=True)
        _check(pcm.size > 0 and bool(np.isfinite(pcm).all()),
               "main[train_mesh] (c): the served export gave no or non-finite audio")
        del gen
        _collect(torch)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn
        shutil.rmtree(tmp, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    result["launches"] = ranks[0]["runs"]["mixed"]["launches"]
    print("main[train_mesh] summary " + json.dumps({
        "tp2_mixed_s_per_step_fwd_bwd": mixed["fwd_bwd_s"],
        "tp2_mixed_s_per_step_optimizer": mixed["optimizer_s"],
        "tp2_mixed_steps_per_s": mixed["steps_per_s"],
        "tp2_mixed_peak_mem_gb_per_rank": [r["runs"]["mixed"]["peak_mem_gb"] for r in ranks],
        "tp2_mixed_collectives_rank0": mixed["collectives"],
        "dp2_lora_steps_per_s": lora["steps_per_s"],
        "dp2_lora_peak_mem_gb_per_rank": [r["runs"]["lora"]["peak_mem_gb"] for r in ranks],
        "dp2_lora_collectives_rank0": lora["collectives"],
        "phase_s": result["phase_s"], "card": card}), flush=True)
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
    and the graphed step alone (``_graph_step``), with the seconds each
    part took.  The fused configuration runs on the int8 Generator's tree
    (``build_generator`` quantizes both alike; only the MLP route differs),
    so it is not drawn twice.  Then the sampler alone, kernel and plain
    path (``_sampler_timing``)."""
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    base = None
    for path, fields, _, _ in _PATHS:
        seconds = {}
        t0 = time.perf_counter()
        if fields.get("fused_mlp"):
            gen = _sibling(base, base._params, fused_mlp=True)
        else:
            gen = build_generator(csm_1b_spec(**fields), device="cuda")
        gen.warmup()
        seconds["build_and_warmup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = {"graphed": _profile_decode(torch, gen, wrappers)}
        seconds["graphed_window"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["step"] = _graph_step(torch, gen)
        seconds["graph_step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = _eager_twin(gen)
        twin.generate("warm up", 0, [], max_audio_length_ms=240, temperature=0.8, topk=40,
                      seed=7)
        seconds["eager_twin_warmup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["eager"] = _profile_decode(torch, twin, wrappers)
        seconds["eager_window"] = time.perf_counter() - t0
        result["seconds"] = seconds
        print(f"profile[{path}] " + json.dumps(result), flush=True)
        del twin
        if path == "int8":
            base = gen
        del gen
        _collect(torch)
    del base
    _collect(torch)
    print("sampler " + json.dumps(_sampler_timing(torch)), flush=True)


# kernel kinds of the device split, by a piece of the kernel's name; the
# first match names the kind
_KINDS = (
    ("quant_matmul", "qmm_"), ("quant4_matmul", "q4mm_"), ("quant_mlp", "qmlp_"),
    ("flash_attention", "flash_fwd"), ("topk_sample", "topk_sample"),
    ("direct_copy", "direct_copy"), ("cat", "CatArray"),
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
    until the last launch returns (the host's ms per frame), then the first
    ``GRAPH_STEP_PROFILED_FRAMES`` of them under the profiler, split by
    kernel kind per frame."""
    from torch.profiler import ProfilerActivity, profile

    from sesameai_tts_tpu_torch.models import csm

    backbone, sample = gen._graphs[(1, "backbone", False)], gen._graphs[(1, "sample", False)]
    state, bufs = gen._slot(1)

    def frames(n=GRAPH_STEP_FRAMES):
        for _ in range(n):
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
            frames(GRAPH_STEP_PROFILED_FRAMES)
            torch.cuda.synchronize()
        csm.load_state(state)
    kernels = _device_kernels(torch, prof)
    result = {"frames": GRAPH_STEP_FRAMES, "cache_rows": _FRAME_CACHE_FILL,
              "device_ms_per_frame_events": ms, "host_launch_ms_per_frame": host_ms}
    if kernels:
        result.update({
            "profiled_frames": GRAPH_STEP_PROFILED_FRAMES,
            "profiled_kernel_ms_per_frame": sum(_dev_us(e) for e in kernels) / 1e3
            / GRAPH_STEP_PROFILED_FRAMES,
            "kernels_per_frame": sum(e.count for e in kernels) / GRAPH_STEP_PROFILED_FRAMES,
            "split_per_frame": _split(kernels, GRAPH_STEP_PROFILED_FRAMES)})
    else:
        result["profiled"] = "no device kernels seen"
    return result


def _sampler_timing(torch) -> dict:
    """The sampler at one stream's shape (1, 2051) and the pool's (16,
    2051), per-row topk 40 and temperature 0.8 as the sampled graph passes
    them (the pool's rows also one in 8 greedy): the kernel
    (``sample_topk``'s CUDA route) and the plain path
    (``sample_topk_plain``, the JAX package's ops) on the same noise, device
    µs per call by CUDA-graph replay and per frame-step (K = 32 calls),
    their tokens bit-equal, the bound (the logits and noise read once at
    3.35 TB/s), the plain path's top-k threshold alone and ``torch.topk``'s
    k-th value beside."""
    from sesameai_tts_tpu_torch.ops import sampling

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for rows in (1, 16):
        logits = torch.randn((rows, 2051), generator=gen, device="cuda") * 3
        gumbel = sampling.gumbel_noise(gen, logits.shape)
        k = torch.full((rows,), 40, dtype=torch.int64, device="cuda")
        k[7::8] = 1
        temperature = torch.full((rows,), 0.8, device="cuda")
        kernel = sampling.sample_topk(None, logits, k, temperature, gumbel=gumbel)
        plain = sampling.sample_topk_plain(None, logits, k, temperature, gumbel=gumbel)
        calls = {
            "kernel": lambda i: sampling.sample_topk(None, logits, k, temperature,
                                                     gumbel=gumbel),
            "plain": lambda i: sampling.sample_topk_plain(None, logits, k, temperature,
                                                          gumbel=gumbel),
            "plain topk_threshold": lambda i: sampling.topk_threshold(logits, k[..., None]),
            "torch.topk kth value": lambda i: torch.topk(logits, 40).values[..., -1:],
        }
        shape = {"bit_equal": bool(torch.equal(kernel, plain)),
                 "bound_us": (2 * logits.numel() * 4 + rows * 8) / 3.35e12 * 1e6}
        for name, fn in calls.items():
            us = _device_ms(torch, fn, 64) * 1e3
            shape[name] = {"us_per_call": us, "ms_per_frame_step": us * 32 / 1e3}
        _check(shape["bit_equal"], f"sampler: kernel != plain at ({rows}, 2051)")
        out[f"({rows}, 2051)"] = shape
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
        "shapes": [{k: r[k] for k in ("shape", "S", "route", "D", "F", "G", "Dout", "kernel_ms",
                                      "kernel_eager_ms", "plain_ms", "library_ms", "bound_ms",
                                      "unfused_ms", "block_i", "threads", "prefetch_rows",
                                      "smem", "cluster", "blocks", "max_abs_err",
                                      "replay_max_abs_err") if k in r}
                   for r in rows],
    }
    entry["max_err"] = entry["max_abs_err"]
    entry["kernel_ms"] = entry["ms"]
    return entry


def _expert_entry(rows, launches: dict) -> dict:
    """expert_swiglu's line: times at the 16-slot pool's rows summed over a
    frame-step's 22 calls (one a routed layer), shape rows beside."""
    pool = next(r for r in rows if r["S"] == HYBRID_SLOTS)
    calls = HYBRID_PER_FRAME["expert_swiglu"] // 3
    keys = ("shape", "S", "experts_hit", "expert_rows_max", "kernel_ms", "kernel_eager_ms",
            "plain_ms", "bound_ms", "max_abs_err", "replay_max_abs_err")
    return {
        "name": "expert_swiglu", "route": "cuda",
        "source": "sesameai_tts_tpu_torch/csrc/expert_swiglu.cu",
        "replaces": "no Pallas counterpart: LFM2-MoE's routed experts",
        "launches": launches["hybrid"]["expert_swiglu"],
        "launches_by_path": {p: c["expert_swiglu"] for p, c in launches.items()
                             if c.get("expert_swiglu")},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: pool[k] * calls for k in ("kernel_ms", "plain_ms", "bound_ms")},
        "ms": pool["kernel_ms"] * calls, "bound_by": "bytes", "library_ms": None,
        "library": "not timed here (csrc/probes/expert_timing.py: a loop of torch.matmul "
                   "over the hit experts)",
        "timed_as": f"device time (CUDA graph replay, two layers' experts) of one call at "
                    f"{HYBRID_SLOTS} rows, times the {calls} routed layers of a frame-step",
        "shapes": [{k: r[k] for k in keys if k in r} for r in rows],
    }


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


def _bwd_entry(rows, launches: dict, cfg) -> dict:
    """flash_attention_bwd's line: times summed over one main[train] step's
    launches, the backbone's layers at the 256 bucket and the decoder's
    layers over its K positions, in bf16 (the full mixed finetune, whose
    launches it reports) and in f32 (the LoRA runs); shape rows beside."""
    n_bb, n_dec = cfg.backbone.num_layers, cfg.decoder.num_layers

    def per_step(key, dtype):
        bb = next(r for r in rows if r["shape"] == "backbone S=256" and r["dtype"] == dtype)
        dec = next(r for r in rows if r["shape"] == "decoder S=32" and r["dtype"] == dtype)
        if bb[key] is None or dec[key] is None:
            return None
        return bb[key] * n_bb + dec[key] * n_dec

    backbone = next(r for r in rows if r["shape"] == "backbone S=256" and r["dtype"] == "bfloat16")
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    shard = {r["shape"]: r for r in rows if "tp2 shard" in r["shape"] and r["dtype"] == "bfloat16"}
    tp2 = {k: shard["backbone tp2 shard S=256"][k] * n_bb + shard["decoder tp2 shard S=32"][k]
           * n_dec for k in keys}
    tp2.update(launches=launches.get("train_mesh", {}).get("flash_attention_bwd"),
               timed_as=f"device time summed over one main[train_mesh] (a) mixed step's "
                        f"{n_bb} backbone calls at H 16 / KV 4 and {n_dec} decoder calls at "
                        f"H 4 / KV 1 on one rank of a tp = 2 mesh (bf16)")
    entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "sesameai_tts_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "sesameai_tts_tpu/models/transformer.py:230 (no Pallas counterpart: the "
                    "gradient XLA's autodiff gives _attention)",
        "launches": launches["train"]["flash_attention_bwd"],
        "launches_by_path": {p: c["flash_attention_bwd"] for p, c in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step("kernel_ms", "bfloat16"),
        "plain_ms": per_step("plain_ms", "bfloat16"),
        "bound_ms": per_step("bound_ms", "bfloat16"),
        "bound_by": backbone["bound_by"],
        "library_ms": per_step("library_ms", "bfloat16"),
        "library": "torch.autograd.grad through one "
                   "torch.nn.functional.scaled_dot_product_attention call, boolean mask, "
                   "enable_gqa=True (its backward alone: CUDA-graph replays of forward and "
                   "backward less the forward's)",
        "f32_step": {k: per_step(k, "float32") for k in keys},
        "tp2": tp2,
        "timed_as": f"device time (CUDA graph replay) summed over one main[train] step's "
                    f"{n_bb} backbone calls at S=256 and {n_dec} decoder calls at S=32 (bf16)",
        "shapes": [{k: r[k] for k in ("shape", "dtype", "route", "S", "valid_end", "kernel_ms",
                                      "kernel_eager_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "max_abs_err")} for r in rows],
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

    wrappers = kernels.wrappers()
    try:
        name, card = phase_device(torch)
        peak_bw, peak_flops = _peaks(name)
        timed("build", phase_build, kernels)
        rows = {k: timed(k, fn, torch, mod, peak_bw, peak_flops) for k, fn, mod in (
            ("quant_matmul", phase_quant_matmul, quant),
            ("quant4_matmul", phase_quant4_matmul, quant),
            ("quant_mlp", phase_quant_mlp, quant),
            ("flash_attention", phase_flash_attention, attention))}
        rows["flash_attention_bwd"] = timed(
            "flash_attention_bwd", phase_flash_attention_bwd, torch, attention, peak_bw,
            peak_flops, next(f for key, f in _F32_FLOPS if key in name))
        shards = timed("tp2 shards", phase_shards, torch, quant, attention, peak_bw, peak_flops)
        paths = {}
        for path, fields, per_frame, voice in _PATHS:
            paths[path], gen = timed(f"main[{path}]", phase_main_path, torch, wrappers, path,
                                     fields, per_frame, voice)
            if path == "int8":  # the apps run on a clone of this warmed Generator
                apps = timed("main[apps]", phase_apps, torch, wrappers, gen, card)
            del gen
            _collect(torch)
        paths["voice"] = timed("main[voice]", phase_voice_path, torch, wrappers, _PATHS[0][2])
        cli = timed("main[cli]", phase_cli, torch, wrappers, _PATHS[0][2])
        serving = timed("main[serve]", phase_serve, torch, wrappers, card)
        _collect(torch)
        hybrid = timed("main[hybrid]", phase_hybrid, torch, wrappers, peak_bw, peak_flops, card)
        rehearsal = timed("main[smoke]", phase_smoke, torch, wrappers, card)
        _collect(torch)
        training = timed("main[train]", phase_train, torch, wrappers, card)
        _collect(torch)
        mesh = timed("main[mesh]", phase_mesh, torch, wrappers, card)
        _collect(torch)
        train_mesh = timed("main[train_mesh]", phase_train_mesh, torch, wrappers, card)
        launches = {path: r["launches"] for path, r in paths.items()}
        launches["mesh"] = mesh["launches"]
        launches["train_mesh"] = train_mesh["launches"]
        launches["train"] = training["full"]["launches"]
        launches["cli"] = cli["launches"]
        launches["serve"] = serving["traffic"]["launches"]
        launches["smoke"] = rehearsal["launches"]
        launches["apps"] = apps["launches"]
        launches["hybrid"] = hybrid["launches"]
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
        _bwd_entry(rows["flash_attention_bwd"], launches, csm_1b()),
    ]
    entries.append(_expert_entry(hybrid["kernel"], launches))
    for entry in entries:  # one rank's shard shapes on a tp = 2 mesh (main[mesh] (a))
        if entry["name"] in shards:
            entry["tp2"] = {
                **shards["per_frame"][entry["name"]],
                "launches": launches["mesh"][entry["name"]],
                "timed_as": "device time summed over one decoded frame's launches on one rank",
                "shapes": [{k: r[k] for k in ("shape", "S", "route", "kernel_ms", "plain_ms",
                                              "library_ms", "bound_ms", "max_abs_err") if k in r}
                           for r in shards[entry["name"]]]}
    decode_ms = {r["pos0"][0]: r["kernel_ms"] for r in rows["flash_attention"]
                 if r["S"] == 1 and r["B"] == 1 and r["hd"] == 64}
    print("kernel flash_attention per decoded frame " + json.dumps(
        {**{k: entries[3][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "timed_as")},
         "backbone_decode_2047_over_600": decode_ms[2047] / decode_ms[600]}), flush=True)
    print("kernel per frame-step at B=8 " + json.dumps(_frame_step_b8(rows, csm_1b(), peak_bw)),
          flush=True)
    print("kernel flash_attention prefill per call (us) " + json.dumps(
        {r["shape"]: {k: None if r[k] is None else r[k] * 1e3
                      for k in ("kernel_ms", "library_ms", "bound_ms", "plain_ms")}
         for r in rows["flash_attention"] if r["S"] > 1}), flush=True)
    print("kernel flash_attention_bwd per call (us) " + json.dumps(
        {f"{r['shape']} {r['dtype']}": {"route": r["route"], **{
            k: None if r[k] is None else r[k] * 1e3
            for k in ("kernel_ms", "library_ms", "bound_ms", "plain_ms")}}
         for r in rows["flash_attention_bwd"]}), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"{json.dumps(phase_s)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
