"""Where does a serving admission's time go beside a busy pool?  On the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/admission_trace.py

One CSM-1B int8 Generator, a started ``BatchedTTSServer(slots=8,
chunk_frames=10)``.  An admission (prefill + first chunk + its fetch) is
timed in three parts: the host's (until ``_dispatch_admission`` returns,
everything enqueued), the device span (CUDA events on the admission
stream before its first and after its last work) and the total to its
fetch; three times with the pool idle, three times while 8 long sessions
keep it ticking.  A host part that stays put while the device span grows
puts the wait on the card (the admission's kernels wait behind the
pool's); a host part that grows puts it on the host.  Needs a card; not
part of the package.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels  # noqa: E402
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, Session  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
kernels.build_kernels()
_, card = cs.phase_device(torch)
gen, _ = cs._build_generator(torch, "probe", {})
srv = BatchedTTSServer(gen, slots=8, chunk_frames=10, max_pending=32)
srv.warmup()
srv.start()
stream = srv._admitter.own_stream()


def admission() -> dict:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(stream)
    t0 = time.perf_counter()
    item = srv._dispatch_admission(Session(text="Session 0 of the serving phase speaks.",
                                           speaker=0, max_audio_length_ms=2000))
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record(stream)
    item.fetch.wait()
    total_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return {"host_ms": host_ms, "device_span_ms": start.elapsed_time(end), "total_ms": total_ms}


try:
    idle = [admission() for _ in range(3)]
    hold = [srv.submit(f"Holder {i} keeps a slot busy.", max_audio_length_ms=30_000)
            for i in range(8)]
    while srv.metrics_summary()["slots_occupied"] < 8:
        time.sleep(0.02)
    busy = [admission() for _ in range(3)]
    for s in hold:
        s.cancel()
finally:
    srv.stop()
print("admission " + json.dumps({"card": card, "pool_idle": idle, "pool_busy": busy}),
      flush=True)
print(card, flush=True)
