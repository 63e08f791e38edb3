"""CUDA graphs of the decode step, and the kernel launches each replays.

A replay launches the kernels its capture recorded without calling their
wrappers, so a ``CapturedGraph`` keeps how many launches of each port
kernel the capture recorded and adds them to the wrappers' ``launches``
counts at every replay; the capture itself launches nothing and counts
nothing.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from sesameai_tts_tpu_torch.ops.attention import flash_attention
from sesameai_tts_tpu_torch.ops.quant import quant4_matmul, quant_matmul, quant_mlp

COUNTED = (quant_matmul, quant4_matmul, quant_mlp, flash_attention)


def launch_counts() -> Dict[Callable, int]:
    return {fn: fn.launches for fn in COUNTED}


class CapturedGraph:
    """A captured CUDA graph, replayed on the current stream."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: Dict[Callable, int],
                 seconds: float):
        self._graph = graph
        self.launches = launches  # per replay, by wrapper
        self.seconds = seconds  # warm-up and capture

    def replay(self) -> None:
        self._graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n


def capture(fn: Callable[[], None], stream: "torch.cuda.Stream", pool,
            generator: Optional[torch.Generator] = None) -> CapturedGraph:
    """Run ``fn`` once eagerly on ``stream`` (it builds the kernels, makes
    cuBLAS's workspace and ``quant_mlp``'s per-stream buffer there), then
    capture one call of it on the same stream into ``pool``.  ``fn`` must
    write its results into tensors made before the capture; the warm-up
    call writes them too.  A ``generator`` that ``fn`` draws from is
    registered with the graph: each replay then draws from its current
    seed and offset, as the same calls made eagerly would.  A failure
    raises; there is no eager fallback."""
    t0 = time.perf_counter()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # thread_local: another thread's work on another stream may go on
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        fn()
    recorded = {}
    for wrapper, n in before.items():
        recorded[wrapper] = wrapper.launches - n
        wrapper.launches = n
    torch.cuda.synchronize()
    return CapturedGraph(graph, {f: n for f, n in recorded.items() if n},
                         time.perf_counter() - t0)
