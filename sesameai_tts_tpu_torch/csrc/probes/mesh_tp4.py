"""``main[mesh]`` (a) at tp = 4 over NCCL, one process per card: the
tensor-parallel Generator on four H100s, where the decoder's kv heads (2)
are each replicated on two ranks.

    python3 sesameai_tts_tpu_torch/csrc/probes/mesh_tp4.py         # four cards
    python3 sesameai_tts_tpu_torch/csrc/probes/mesh_tp4.py --cpu   # rehearsal

Spawns four ranks that meet at ``tcp://localhost:<a free port>``
(``initialize_multihost``), builds CSM-1B int8 from seed 0 on
``make_mesh(1, 4)`` (each rank on ``cuda:<rank>``), serves a greedy 2 s
request and a sampled 0.8 s one, checks that every rank returns the same
frames and the launches per step, and times the eager step.  Rank 0 then
builds the single-card Generator and holds the teacher-forced logits over
the greedy frames against it (SNR, as ``chip_smoke.py`` does at tp = 2).
``--cpu`` runs the same on four CPU processes over gloo at a narrow config
with CSM-1B's head counts (backbone H 32 / KV 8, decoder H 8 / KV 2, head
dim 8) in f32, unquantized, where the mesh's frames must equal the single
process's exactly.  Not part of the package's build or tests.
"""
import json
import os
import socket
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

WORLD = 4
CPU = "--cpu" in sys.argv


def _spec():
    import torch

    from sesameai_tts_tpu_torch.core.config import CSMConfig, TransformerConfig, register_flavor
    from sesameai_tts_tpu_torch.runtime.loader import ModelSpec, csm_1b_spec
    from sesameai_tts_tpu_torch.codec.mimi import mimi_test_tiny

    if not CPU:
        return csm_1b_spec()
    register_flavor("probe-1B-heads", lambda: TransformerConfig(
        num_layers=2, num_heads=32, num_kv_heads=8, embed_dim=256, max_seq_len=256,
        intermediate_dim=128, dtype=torch.float32))
    register_flavor("probe-100M-heads", lambda: TransformerConfig(
        num_layers=2, num_heads=8, num_kv_heads=2, embed_dim=64, max_seq_len=64,
        intermediate_dim=128, dtype=torch.float32))
    return ModelSpec(csm=CSMConfig(backbone_flavor="probe-1B-heads",
                                   decoder_flavor="probe-100M-heads", text_vocab_size=300,
                                   audio_vocab_size=67, audio_num_codebooks=8),
                     mimi=mimi_test_tiny(), tokenizer="byte", dtype=torch.float32)


def _rank(rank, port, tmp):
    import numpy as np
    import torch

    import chip_smoke as cs
    from sesameai_tts_tpu_torch.ops import attention, kernels, quant
    from sesameai_tts_tpu_torch.parallel.distributed import initialize_multihost
    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh
    from sesameai_tts_tpu_torch.runtime.loader import build_generator

    torch.set_num_threads(1 if CPU else 2)
    device = "cpu" if CPU else f"cuda:{rank}"
    if not CPU:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"localhost:{port}", WORLD, rank, backend="gloo" if CPU else "nccl")
    wrappers = {n: getattr(attention if n.startswith("flash_attention") else quant, n)
                for n in kernels.KERNELS}
    try:
        t0 = time.perf_counter()
        gen = build_generator(_spec(), device=device,
                              mesh=make_mesh(1, WORLD, "cpu" if CPU else "cuda"))
        build_s = time.perf_counter() - t0
        cs._reset_counts(wrappers)
        kw = dict(temperature=1.0, topk=1, seed=1)
        greedy = gen.generate_frames(cs.MESH_TEXT, 0, [], max_audio_length_ms=cs.MESH_MS, **kw)
        sampled = gen.generate_frames(cs.MESH_SAMPLED_TEXT, 0, [],
                                      max_audio_length_ms=cs.MESH_SAMPLED_MS, temperature=0.8,
                                      topk=40, seed=5)
        launches = cs._counts(wrappers)
        m = gen.metrics.summary()
        teacher = greedy[:, None, :].astype(np.int64)
        logits = cs._teacher_logits(torch, gen, cs.MESH_TEXT, teacher)
        out = {"rank": rank, "build_s": build_s, "greedy": greedy.tolist(),
               "sampled": sampled.tolist(), "launches": launches,
               "decoded_frames": int(m["decoded_frames"]["total"]),
               "ms_per_decoded_frame": m["decode_s"]["total"] / m["decoded_frames"]["total"] * 1e3,
               "prefill_ms": m["prefill_s"]["mean"] * 1e3, "graphed": gen.graphed,
               "peak_gb": None if CPU else torch.cuda.max_memory_allocated() / 1e9}
        if rank == 0:
            np.save(os.path.join(tmp, "logits.npy"), logits)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def main():
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from sesameai_tts_tpu_torch.ops import kernels
    from sesameai_tts_tpu_torch.runtime.loader import build_generator

    if not CPU and torch.cuda.device_count() < WORLD:
        print(f"mesh_tp4: needs {WORLD} cards, has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if not CPU:
        name, card = cs.phase_device(torch)
        cs.phase_build(kernels)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_rank, args=(port, tmp), nprocs=WORLD, join=True,
                           start_method="spawn")
        world_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(WORLD)]
        logits = np.load(os.path.join(tmp, "logits.npy"))
    for r in ranks[1:]:
        assert r["greedy"] == ranks[0]["greedy"] and r["sampled"] == ranks[0]["sampled"], \
            f"rank {r['rank']}'s frames differ from rank 0's"
    greedy = np.asarray(ranks[0]["greedy"], np.int64)
    steps = ranks[0]["decoded_frames"] + 2
    dev = "cpu" if CPU else "cuda:0"
    gen = build_generator(_spec(), device=dev)
    ref = cs._teacher_logits(torch, gen, cs.MESH_TEXT, greedy[:, None, :])
    single = gen.generate_frames(cs.MESH_TEXT, 0, [], max_audio_length_ms=cs.MESH_MS,
                                 temperature=1.0, topk=1, seed=1)
    n = min(len(single), len(greedy))
    cfg = gen._cfg
    per_step = {"flash_attention": cfg.backbone.num_layers
                + cfg.audio_num_codebooks * cfg.decoder.num_layers}
    report = {
        "world_s": world_s, "frames": len(greedy), "steps": steps,
        "logit_snr_db": cs._snr_db(np, logits, ref),
        "code_match_with_single": float((single[:n] == greedy[:n]).mean()),
        "frames_equal_single": bool(n == len(greedy) == len(single)
                                    and (single == greedy).all()),
        "flash_attention_expected": per_step["flash_attention"] * steps,
        "per_rank": [{k: r[k] for k in ("rank", "build_s", "ms_per_decoded_frame",
                                        "prefill_ms", "graphed", "peak_gb", "launches")}
                     for r in ranks]}
    print("mesh tp4 " + json.dumps(report), flush=True)
    if CPU:  # f32, unquantized: the mesh must equal one process exactly (no kernel runs)
        assert report["frames_equal_single"], report
    else:
        for r in ranks:
            assert r["launches"]["flash_attention"] == report["flash_attention_expected"], r
        assert report["logit_snr_db"] >= cs.MESH_MIN_SNR_DB, report
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
