"""Two facts the graphed decode step rests on, checked on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/graph_rng.py

1. A CUDA generator registered with a CUDA graph
   (``CUDAGraph.register_generator_state``) and reseeded with
   ``manual_seed`` before a replay makes the replay draw what the same
   calls draw eagerly after the same seed (the c0 draw, then the
   codebook block, as ``csm.sample_step`` draws them).
2. On the card, dividing by a Python float is not dividing by a tensor
   holding it: the count of elements of a (4096, 2051) f32 tensor that
   differ, and the same count against a multiply by the reciprocal.

Needs a card; not part of the package's build or tests.
"""
import sys, torch
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
print("register_generator_state", hasattr(torch.cuda.CUDAGraph, "register_generator_state"))
gen = torch.Generator(device="cuda")
def draws():
    a = torch.rand((1, 2051), generator=gen, device="cuda")
    b = torch.rand((31, 1, 2051), generator=gen, device="cuda")
    return a, b
eager = {}
for s in (123, 456):
    gen.manual_seed(s); a, b = draws(); eager[s] = (a.clone(), b.clone())
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    draws()
torch.cuda.current_stream().wait_stream(side)
g = torch.cuda.CUDAGraph()
g.register_generator_state(gen)
with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
    ga, gb = draws()
for s in (456, 123, 456):
    gen.manual_seed(s); g.replay(); torch.cuda.synchronize()
    print("seed", s, "equal", torch.equal(ga, eager[s][0]), torch.equal(gb, eager[s][1]), flush=True)
x = torch.randn(4096, 2051, device="cuda")
t = torch.full((1,), 0.8, device="cuda")
print("div by float vs tensor: differing elements", int((x / 0.8 != x / t[..., None]).sum()), flush=True)
print("div by float vs reciprocal mul:", int((x / 0.8 != x * (1 / torch.tensor(0.8, dtype=torch.float32)).item()).sum()))
