"""How fast the card's event clock drifts against ``time.perf_counter``.

    python3 sesameai_tts_tpu_torch/csrc/probes/clock_drift.py [--seconds 60]

On a card, with the card idle: every 50 ms it records a timing event
between two host readings and waits for it, so the offset (host time −
device time) lies between the reading before the record and the one after
the wait.  It prints one JSON line: the samples, the widest bracket, the
slope of the brackets' middles against host time (ppm: the drift that
``utils/profiling.py::DeviceClock`` allows for, by default 100 ppm), the
largest residual from that line and the largest step between two
neighbouring samples' middles.  Not part of the package's build or tests.
"""

import argparse
import json
import time

import numpy as np
import torch


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=60.0)
    args = p.parse_args()
    first = torch.cuda.Event(enable_timing=True)
    first.record()
    first.synchronize()
    host, lo, hi = [], [], []
    end = time.perf_counter() + args.seconds
    while time.perf_counter() < end:
        ev = torch.cuda.Event(enable_timing=True)
        r = time.perf_counter()
        ev.record()
        ev.synchronize()
        h = time.perf_counter()
        d = first.elapsed_time(ev) * 1e-3
        host.append(0.5 * (r + h))
        lo.append(r - d)
        hi.append(h - d)
        time.sleep(0.05)
    t, lo, hi = np.asarray(host), np.asarray(lo), np.asarray(hi)
    mid = 0.5 * (lo + hi)
    slope, icpt = np.polyfit(t - t[0], mid, 1)
    resid = mid - (icpt + slope * (t - t[0]))
    print(json.dumps({"device": torch.cuda.get_device_name(), "samples": int(t.size),
                      "seconds": float(t[-1] - t[0]), "bracket_us_max": 1e6 * float((hi - lo).max()),
                      "bracket_us_p50": 1e6 * float(np.median(hi - lo)),
                      "drift_ppm": 1e6 * float(slope), "residual_us_max": 1e6 * float(abs(resid).max()),
                      "step_us_max": 1e6 * float(abs(np.diff(mid)).max())}))


if __name__ == "__main__":
    main()
