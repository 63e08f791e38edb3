"""moe_matmul_roofline: the routed experts' share of their roofline in the
profiled sub-window of the window (harness/trace.py): the least time the
card could take for the bytes and operations of the sub-window's
frame-steps' routed FFNs (the family's ``moe_work``: each hit expert's
int8 weights read once, the activations at S = slots rows), over the
``expert_swiglu`` kernels' summed device time there.  The experts hit a
frame-step are the pool's own counter (each tick record's
``experts_hit``, summed over its frame-steps), averaged over the stamped
ticks of the window before the sub-window.  None for a family without
experts, a program without the counter, or a trace without the kernels."""

from benchmark.harness import spans
from benchmark.harness.peaks import peak_of
from benchmark.harness.work import bound_s

PATTERN = r"\bexpert_(up|down|sum)_kernel"


def read(run, name):
    peak = peak_of(run.device_name or "")
    moe_work = getattr(run.cell.family, "moe_work", None)
    if run.trace is None or peak is None or moe_work is None:
        return None
    ticks = [t for t in spans.window_ticks(run) if getattr(t, "experts_hit", None) is not None]
    steps = sum(t.n for t in ticks)
    spent = run.trace.kernel_s(PATTERN)
    if not steps or spent <= 0:
        return None
    hit = sum(t.experts_hit for t in ticks) / steps
    sub_steps = sum(t.frames for t in run.trace.ticks())
    return 100.0 * sub_steps * bound_s(*moe_work(run.config, hit, run.slots), peak) / spent
