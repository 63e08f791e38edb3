"""Deploy-time warm-up (port of ``sesameai_tts_tpu/service/prewarm.py``):
``sesame-tts-torch-prewarm``.

On the card the one artefact that outlives a process is the kernels built
into the checkout's ``build/`` (``ops/kernels.py``): CUDA graphs, cuBLAS
and cuDNN plans and the caching allocator's pools live and die with the
process.  So this command builds the four kernels (a server start then
loads them instead of running ``nvcc``) and runs the same warm-up set a
``sesame-tts-torch-serve`` start runs (``BatchedTTSServer.warmup`` +
``Generator.warmup``), to check it and print its times:

    sesame-tts-torch-prewarm --flavor csm-1b --slots 8 [--model-path ... --mimi-path ...]

The JAX package's ``--cache-dir`` names its persistent XLA compile cache;
nothing here has one to fill, so the flag has no counterpart.  Runs on the
card; ``--device cpu --flavor test-tiny`` runs it on the CPU, where there
are no kernels to build.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

logger = logging.getLogger("sesameai_tts_tpu_torch.prewarm")


def prewarm(gen, slots, chunk_frames, offline: bool = True,
            encode_buckets=(16, 32, 64)) -> dict:
    """The serve-start warm-up set (graphs, prefill buckets, first chunk,
    the batched codec decode) and the single-stream one (B=1 graphs, the
    Mimi encode buckets) → {step: seconds}.  ``offline`` goes to
    ``Generator.warmup``, as in the JAX package (one graph per frame part
    serves every chunk size here, so it adds no step)."""
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    engine = BatchedTTSServer(gen, slots=slots, chunk_frames=chunk_frames)
    times = engine.warmup()
    times.update(gen.warmup(offline=offline, encode_buckets=encode_buckets))
    return times


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    p = argparse.ArgumentParser(
        description="build the port's kernels and run the serve-path warm-up set once")
    p.add_argument("-d", "--device", default="cuda", help="device (cuda or cpu)")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"])
    p.add_argument("--model-path", default=None)
    p.add_argument("--mimi-path", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--slots", type=int, default=4,
                   help="pool size to warm (match the serve config)")
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="tick size (default: serve's rule: 10 for <=8 slots, 5 above)")
    p.add_argument("--max-positions", type=int, default=None,
                   help="KV capacity override; match serve's")
    p.add_argument("--no-offline", action="store_true",
                   help="accepted so the JAX package's command lines parse; passed to "
                        "Generator.warmup, which ignores it (one graph per frame part "
                        "serves every chunk size, so there is no offline ramp to skip)")
    args = p.parse_args(argv)

    from sesameai_tts_tpu_torch.runtime.generator import resolve_device
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec, test_tiny_spec

    device = resolve_device(args.device)
    if device.type == "cuda":
        from sesameai_tts_tpu_torch.ops import kernels

        t0 = time.time()
        kernels.build_kernels()
        logger.info("kernels: %.1fs (%s)", time.time() - t0,
                    ", ".join(f"{k}={v:.1f}s" for k, v in kernels.build_seconds.items())
                    or "already built")
    spec = (
        test_tiny_spec() if args.flavor == "test-tiny"
        else csm_1b_spec(args.model_path, args.mimi_path, args.tokenizer)
    )
    if args.max_positions is not None:
        spec.csm = spec.csm.replace(max_seq_len=args.max_positions)
    if args.chunk_frames is None:
        args.chunk_frames = 10 if args.slots <= 8 else 5

    t0 = time.time()
    gen = build_generator(spec, device=device)
    build_s = time.time() - t0
    logger.info("build: %.1fs", build_s)

    t0 = time.time()
    times = prewarm(gen, args.slots, args.chunk_frames, offline=not args.no_offline)
    wall = time.time() - t0
    slowest = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    logger.info("prewarm: %d steps in %.1fs (slowest: %s)", len(times), wall,
                ", ".join(f"{k}={v:.1f}s" for k, v in slowest))
    # a machine-readable line for deploy tooling
    print(json.dumps({
        "programs": len(times),
        "build_s": round(build_s, 1),
        "warmup_wall_s": round(wall, 1),
        "slots": args.slots,
        "chunk_frames": args.chunk_frames,
    }), file=sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
