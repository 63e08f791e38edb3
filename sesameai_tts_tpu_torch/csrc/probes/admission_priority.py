"""Does a high-priority stream speed up serving admissions beside a busy
pool?  A/B on the card, in turns: the admission clone's stream at normal,
high, high, normal priority.

    python3 sesameai_tts_tpu_torch/csrc/probes/admission_priority.py

One CSM-1B int8 Generator; per turn a ``BatchedTTSServer(slots=8,
chunk_frames=10)`` warmed up and started, ``chip_smoke.py``'s 12-session
traffic of ``main[serve]`` (TTFA p50 / p95 / max, aggregate decoded
frames/s), then 8 long sessions fill the pool and 4 admissions (prefill +
first chunk + its fetch) are timed one at a time beside it.  The library
gives each clone a normal-priority stream; this probe swaps the admission
clone's before ``warmup``.  Needs a card; not part of the package.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels  # noqa: E402
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, Session  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
kernels.build_kernels()
_, card = cs.phase_device(torch)
gen, _ = cs._build_generator(torch, "probe", {})
texts = [f"Session {i} of the serving phase speaks one sentence."
         for i in range(len(cs.SERVE_SESSIONS))]
texts[cs.SERVE_LONG_PROMPT] = cs._text_of_rows(gen, gen.max_seq_len - cs.SERVE_ROOM)
for variant in ("normal", "high", "high", "normal"):
    srv = BatchedTTSServer(gen, slots=8, chunk_frames=10, max_pending=32)
    if variant == "high":
        srv._admitter._graph_stream = torch.cuda.Stream(priority=-1)
        srv._admitter._graph_pool = torch.cuda.graph_pool_handle()
    srv.warmup()
    srv.start()
    t0 = time.perf_counter()
    sessions = [srv.submit(t, speaker=0, max_audio_length_ms=ms, temperature=temp, topk=k)
                for t, (ms, temp, k) in zip(texts, cs.SERVE_SESSIONS)]
    for s in sessions:
        s.audio(timeout=300)
    wall = time.perf_counter() - t0
    ttfa = np.array([s.first_audio_at - s.submitted_at for s in sessions]) * 1e3
    frames = sum(sum(f.shape[0] for f in s.frames_out) for s in sessions)
    hold = [srv.submit(f"Holder {i}.", max_audio_length_ms=30_000) for i in range(8)]
    while srv.metrics_summary()["slots_occupied"] < 8:
        time.sleep(0.02)
    busy = []
    for i in range(4):
        t1 = time.perf_counter()
        item = srv._dispatch_admission(Session(text=texts[i], speaker=0,
                                               max_audio_length_ms=2000))
        item.fetch.wait()
        busy.append((time.perf_counter() - t1) * 1e3)
    for s in hold:
        s.cancel()
    srv.stop()
    print("probe " + json.dumps({
        "variant": variant, "priority": srv._admitter._graph_stream.priority,
        "ttfa_ms": [float(np.percentile(ttfa, q)) for q in (50, 95, 100)],
        "aggregate_frames_per_s": frames / wall, "admission_beside_full_pool_ms": busy,
        "frame_steps": srv.metrics.summary()["tick_frames"]["total"]}), flush=True)
    del srv, sessions, hold
    cs._collect(torch)
print(card, flush=True)
