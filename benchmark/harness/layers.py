"""The per-layer readings that the metric readers share: the kernels'
roofline shares from the profiled sub-window of the window and the
card's idle share from its utilization counter (``harness/trace.py``),
and the window's model operations.  The bytes and operations come from
the cell's model family (``families/<model_type>.py``).

The work a roofline is held to comes from what the sub-window served,
not from the kernels that did it: each tick's frame-steps at B = slots
(every trunk weight once a call; attention over the rows each live
session's cache holds at the tick's launch, its decoder passes over
1..K rows) and each admission's prefill begun in it.  A session's cache
holds its prompt's rows and the frames it was sent before the tick.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness import texts
from benchmark.harness.peaks import peak_of
from benchmark.harness.work import bound_s


def _kernel_share(run, pattern: str, need_s: float) -> Optional[float]:
    """``need_s`` (the least time at peak) over the summed device time
    of the sub-window's kernels matching ``pattern``, in percent; None
    where the sub-window ran none."""
    spent = run.trace.kernel_s(pattern)
    return None if spent <= 0 else 100.0 * need_s / spent


def quant_roofline(run, pattern: str, bits: int) -> Optional[float]:
    """The share, in percent, of the roofline of the sub-window's
    quantized products (every trunk weight once a call at S = slots rows,
    at ``bits``) that the kernels matching ``pattern`` reached."""
    peak = peak_of(run.device_name or "")
    if run.trace is None or peak is None:
        return None
    cfg, family = run.config, run.cell.family
    groups = cfg.get("int4_scale_groups", 2) if bits == 4 else 1
    per_step = sum(bound_s(*family.quant_work(cfg, run.slots, bits, groups, part), peak)
                   for part in ("backbone", "decoder"))
    steps = sum(t.frames for t in run.trace.ticks())
    return _kernel_share(run, pattern, steps * per_step)


def _prompts(run) -> dict:
    """Session id → (the request's prompt rows, its voice's rows)."""
    out = {}
    for r in run.requests:
        if r.session is not None:
            voice = run.voices[r.voice]
            out[id(r.session)] = voice.tokens.shape[0] + texts.text_rows(run.config, voice, r.text)
    return out


def attention_roofline(run, pattern: str) -> Optional[float]:
    """The attention kernels' share, in percent, of the roofline of what
    the sub-window's ticks and admissions need (module docstring)."""
    peak = peak_of(run.device_name or "")
    if run.trace is None or peak is None:
        return None
    cfg, family = run.config, run.cell.family
    prompts = _prompts(run)
    need = 0.0
    for t in run.trace.ticks():
        keys = [prompts[sid] + sent + j + 1 for sid, sent in t.live if sid in prompts
                for j in range(t.frames)]
        for part in ("backbone", "decoder"):
            need += bound_s(*family.attention_work(cfg, keys, part), peak)
    by_speaker = {v.speaker: v for v in run.voices}
    for p in run.trace.prefills():
        text, speaker = p.text
        voice = by_speaker[speaker]
        rows = texts.text_rows(cfg, voice, text)
        need += bound_s(*family.prefill_attention_work(cfg, rows, voice.tokens.shape[0]), peak)
    return _kernel_share(run, pattern, need)


def idle_pct(run) -> Optional[float]:
    """The share of the traced run's window before its profiled sub-window
    in which the card's utilization counter saw no kernel running."""
    if run.trace is None or run.busy_pct is None:
        return None
    return 100.0 - run.busy_pct


def mfu(run) -> Optional[float]:
    """The window's model operations (admissions whose first chunk came
    in it, frames delivered in it) over its seconds at the dense bf16
    peak, in percent."""
    peak = peak_of(run.device_name or "")
    if peak is None:
        return None
    cfg, family = run.config, run.cell.family
    flops = 0.0
    for r in run.requests:
        voice = run.voices[r.voice]
        ctx = voice.tokens.shape[0]
        rows = texts.text_rows(cfg, voice, r.text)
        done = 0
        for t, n in r.chunk_log:
            frames = n // run.hop
            if run.t0 <= t < run.t1:
                for j in range(done, done + frames):
                    flops += (family.prefill_flops(cfg, rows, ctx) if j == 0
                              else family.frame_flops(cfg, ctx + rows + j))
            done += frames
    return 100.0 * flops / (run.seconds * peak.bf16_flops)
