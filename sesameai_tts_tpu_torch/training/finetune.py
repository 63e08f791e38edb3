"""Finetuning CLI: dataset directory → trained CSM checkpoint (port of
``sesameai_tts_tpu/training/finetune.py``).  On the card unless ``-d cpu``.

    sesame-tts-torch-finetune --data clips/ --flavor test-tiny --steps 50 \\
        --ckpt-dir ckpt/run1 --save-every 25 -d cpu
    torchrun --nproc-per-node 2 -m sesameai_tts_tpu_torch.training.finetune \\
        --data clips/ --flavor test-tiny --mesh 1,2 -d cpu

* dataset: ``metadata.json`` or ``.txt`` sidecars next to WAVs
  (``training/data.py::load_directory``), resampled to 24 kHz;
* the codec and a random init are drawn as ``runtime/loader.py::
  build_generator`` draws them (``loader.init_csm`` and ``init_mimi``: the
  CSM params and Mimi from generators of their own, both from the spec's
  seed, each drawn once), so a run
  without checkpoints trains against the codec that its export is served
  with;
* training dtype is f32 by default; ``--dtype mixed`` keeps f32 params and
  Adam moments and runs the forward and backward in bf16, ``--dtype bf16``
  keeps bf16 params; quantized serving forms come after training;
* checkpoints are full TrainStates (``training/checkpoint.py``):
  ``--resume`` continues bit for bit: it also replays the seeded batch
  stream past the saved step's batches, so the resumed run trains on the
  batches an unbroken one would (the JAX CLI restarts the stream).  The
  final params also land in ``<ckpt-dir>/params``, loadable as
  ``ModelSpec.csm_checkpoint``;
* ``--lora-rank N`` trains rank-N adapters over the trunk linears instead
  of the full model (``training/lora.py``); the export is the MERGED dense
  tree, so it serves like a full finetune's;
* ``--mesh dp,tp`` trains on a ('dp', 'tp') mesh of ranks (``parallel/``,
  ``training/train_step.py``): a dense state as each rank's tp shards, or
  a LoRA base as shards under replicated adapters, each rank taking its dp
  rows of the seeded batches, so it trains as one process on the whole
  batch does.  Each rank of ``torchrun`` joins the process group from its
  environment (on cards, a card a rank: ``cuda:<LOCAL_RANK>``); a caller
  that joined one itself (ranks sharing a card over gloo) keeps it.  Rank
  0 logs and writes the checkpoints and the export, all of the logical
  tree, so a mesh run resumes on any mesh and its export serves on one
  card.  A dense ``--csm-checkpoint`` with ``--mesh`` is refused.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch
import torch.distributed

from sesameai_tts_tpu_torch.parallel.infer import tp_group
from sesameai_tts_tpu_torch.parallel.mesh import (
    all_gather_params,
    csm_param_specs,
    shard_batch,
    shard_params,
)
from sesameai_tts_tpu_torch.training import checkpoint as ckpt_lib
from sesameai_tts_tpu_torch.training.data import (
    BatchLoader,
    LoaderConfig,
    load_directory,
    prefetch,
)
from sesameai_tts_tpu_torch.training.train_step import (
    batch_to,
    init_train_state,
    make_eval_step,
    make_lora_eval_step,
    make_lora_train_step,
    make_optimizer,
    make_sharded_train_state,
    make_train_step,
)


def build_frame_tokenizer(spec, mimi, mimi_params, device):
    """FrameTokenizer (the spec's text tokenizer + ``Mimi.encode`` on
    ``device``, padded to power-of-2 frame buckets as the Generator pads)
    without a Generator: training needs tokenization, not the decode."""
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.runtime.frames import FrameTokenizer, pad_audio_to_frame_bucket
    from sesameai_tts_tpu_torch.tokenizer.text import load_text_tokenizer

    mimi_params = to_device(mimi_params, device)
    hop = mimi.cfg.hop_length

    @torch.no_grad()
    def encode_audio(audio: np.ndarray) -> np.ndarray:
        wav, frames = pad_audio_to_frame_bucket(audio, hop)
        codes = mimi.encode(mimi_params, torch.from_numpy(wav).to(device))
        return codes[0, :, :frames].cpu().numpy()

    return FrameTokenizer(load_text_tokenizer(spec.tokenizer), encode_audio,
                          spec.csm.audio_num_codebooks)


def _join_mesh(args, spec, device):
    """``--mesh dp,tp`` → (the mesh, this rank's device).  A dense finetune
    over a ``--csm-checkpoint`` is refused before any init, as the JAX CLI
    refuses it; the process group is joined from torchrun's environment
    unless the caller has joined one."""
    from sesameai_tts_tpu_torch.parallel.distributed import initialize_multihost
    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh
    from sesameai_tts_tpu_torch.runtime.loader import rank_device

    try:
        dp, tp = (int(x) for x in args.mesh.split(","))
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: give dp,tp (e.g. 1,2)") from None
    if spec.csm_checkpoint and not args.lora_rank:
        raise SystemExit("--mesh with --csm-checkpoint: a dense finetune on a mesh starts from "
                         "the random init or resumes a TrainState with --resume (or use "
                         "--lora-rank, which loads the base directly)")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not torch.distributed.is_initialized():
        initialize_multihost()
    return make_mesh(dp, tp, device_type=device.type), device


def finetune(args) -> dict:
    """Run the loop; returns the last metrics as floats (CLI + tests entry)."""
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.weights import save_pytree
    from sesameai_tts_tpu_torch.runtime.generator import resolve_device
    from sesameai_tts_tpu_torch.runtime.loader import (
        csm_1b_spec,
        init_csm,
        init_mimi,
        test_tiny_spec,
    )

    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")

    if args.flavor == "test-tiny":
        spec = test_tiny_spec()
    else:
        spec = csm_1b_spec(csm_checkpoint=args.csm_checkpoint,
                           mimi_checkpoint=args.mimi_checkpoint, tokenizer=args.tokenizer,
                           quantize=None)  # training runs dense; quantize at serve time
    mesh = None
    if args.mesh:
        mesh, device = _join_mesh(args, spec, args.device)
    else:
        device = resolve_device(args.device)
    lead = mesh is None or mesh.get_rank() == 0  # logs and writes the files
    log = print if lead else (lambda *a, **kw: None)

    # 'mixed' = f32 master params + Adam moments, bf16 forward/backward
    # (the cast happens inside the differentiated step)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "mixed": torch.float32}[args.dtype]
    compute_dtype = torch.bfloat16 if args.dtype == "mixed" else None
    mimi, mimi_params = init_mimi(spec)
    ftok = build_frame_tokenizer(spec, mimi, mimi_params, device)
    del mimi_params
    segments = load_directory(args.data, sample_rate=spec.mimi.sample_rate)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # rows past max_seq_len have no RoPE row: buckets beyond it are dropped
    # (their examples fall to the loader's over-length count), and only a
    # run where nothing fits stops
    max_pos = spec.csm.backbone.max_seq_len
    if max(buckets) > max_pos:
        kept = tuple(b for b in buckets if b <= max_pos)
        if not kept:
            raise SystemExit(f"every --buckets value exceeds the backbone's max_seq_len {max_pos}")
        log(f"buckets > max_seq_len {max_pos} dropped: {[b for b in buckets if b > max_pos]} "
            f"(over-length clips are skipped with a count)", file=sys.stderr)
        buckets = kept
    eval_segments: list = []
    if args.eval_frac > 0 and len(segments) > 1:
        # seeded split so --resume sees the same held-out set
        order = np.random.default_rng(args.seed).permutation(len(segments))
        n_eval = min(max(1, round(len(segments) * args.eval_frac)), len(segments) - 1)
        eval_segments = [segments[i] for i in order[:n_eval]]
        segments = [segments[i] for i in order[n_eval:]]
    # every rank of a mesh runs the same seeded loader and keeps its rows
    loader = BatchLoader(segments, ftok, LoaderConfig(batch_size=args.batch_size,
                                                      buckets=buckets, seed=args.seed))
    if loader.dropped:
        log(f"dropped {loader.dropped} over-length examples", file=sys.stderr)
    eval_loader = None
    if eval_segments:
        try:
            eval_loader = BatchLoader(eval_segments, ftok, LoaderConfig(
                batch_size=args.batch_size, buckets=buckets, seed=args.seed, shuffle=False))
        except ValueError:
            log("eval split has no usable examples (all over-length); eval disabled",
                file=sys.stderr)

    warmup = args.warmup
    if warmup >= args.steps:
        # a run that never leaves warmup peaks on its last update: clamp
        warmup = max(1, args.steps // 10)
        log(f"warmup {args.warmup} >= steps {args.steps}; clamped to {warmup}",
            file=sys.stderr)
    tx = make_optimizer(args.lr, args.weight_decay, warmup, total_steps=args.steps)
    base_params = None  # the frozen base in LoRA mode
    if mesh is not None and not args.lora_rank:
        state = make_sharded_train_state(torch.Generator().manual_seed(spec.seed), spec.csm,
                                         mesh, tx, dtype, device)
    else:
        params = init_csm(spec, dtype)
        if args.lora_rank:
            from sesameai_tts_tpu_torch.training.lora import init_lora_params

            # the adapters from the full tree's shapes, replicated on a mesh
            lora = init_lora_params(torch.Generator().manual_seed(args.seed + 1), params,
                                    args.lora_rank, tuple(args.lora_targets.split(",")), dtype)
            if mesh is not None:
                params = shard_params(params, mesh, spec.csm)
            base_params = to_device(params, device)
            state = init_train_state(to_device(lora, device), tx)
        else:
            state = init_train_state(to_device(params, device), tx)
        del params
    # a dense state on a mesh is this rank's shards of the logical tree
    sharded_cfg = spec.csm if mesh is not None and not args.lora_rank else None

    if args.resume:
        path = ckpt_lib.latest_checkpoint(args.ckpt_dir)
        if not path:
            # the user asked to resume: retraining from scratch into the
            # directory they thought held their run is the worst outcome
            raise SystemExit(f"--resume: no checkpoint found in {args.ckpt_dir!r}; drop "
                             f"--resume to start fresh, or fix --ckpt-dir")
        state = ckpt_lib.restore_checkpoint(path, state, mesh, sharded_cfg)
        log(f"resumed from {path} (step {int(state.step)})", file=sys.stderr)

    if args.lora_rank:
        lora_step = make_lora_train_step(
            spec.csm, tx, alpha=args.lora_alpha, decoder_frames=args.decoder_frames,
            remat=args.remat, accum_steps=args.accum_steps, compute_dtype=compute_dtype,
            subset_seed=args.seed, mesh=mesh)
        step_fn = lambda s, b: lora_step(s, base_params, b)  # noqa: E731
    else:
        step_fn = make_train_step(
            spec.csm, tx, decoder_frames=args.decoder_frames, remat=args.remat,
            accum_steps=args.accum_steps, compute_dtype=compute_dtype, subset_seed=args.seed,
            mesh=mesh)

    def to_rank(b, accum_steps=1):
        """A loader batch → this rank's rows of it, on the device."""
        return batch_to(b if mesh is None else shard_batch(b, mesh, accum_steps), device)

    def epochs():
        while True:
            yield from loader

    # the batches the steps before `start` took: a resumed run skips them
    batches = itertools.islice(epochs(), int(state.step), None)

    eval_fn = None
    if eval_loader is not None:
        if args.lora_rank:
            lora_eval = make_lora_eval_step(spec.csm, alpha=args.lora_alpha,
                                            decoder_frames=args.decoder_frames,
                                            compute_dtype=compute_dtype, mesh=mesh)
            eval_fn = lambda s, b: lora_eval(s.params, base_params, b)  # noqa: E731
        else:
            dense_eval = make_eval_step(spec.csm, args.decoder_frames,
                                        compute_dtype=compute_dtype, mesh=mesh)
            eval_fn = lambda s, b: dense_eval(s.params, b)  # noqa: E731

    def evaluate(state) -> float:
        """Held-out loss, deterministic (unshuffled loader, first-N decoder
        subset), batches pooled by their audio row count."""
        tot = w = 0.0
        for b in eval_loader:
            rows = float(np.asarray(b.mask[..., 0] & b.loss_mask).sum())
            tot += float(eval_fn(state, to_rank(b))["loss"]) * rows
            w += rows
        return tot / max(w, 1.0)

    metrics = {}
    t0 = time.time()
    start = int(state.step)
    last_saved_step = -1
    for batch in prefetch(batches, depth=2):
        if int(state.step) >= args.steps:
            break
        state, metrics = step_fn(state, to_rank(batch, args.accum_steps))
        step = int(state.step)  # one host sync per step
        if step % args.log_every == 0 or step == args.steps:
            rate = (step - start) / max(time.time() - t0, 1e-9)
            log(f"step {step}/{args.steps} loss {float(metrics['loss']):.4f} "
                f"(c0 {float(metrics['c0_loss']):.4f} dec "
                f"{float(metrics['decoder_loss']):.4f}) {rate:.2f} steps/s", file=sys.stderr)
        if eval_fn and args.eval_every and step % args.eval_every == 0:
            eval_loss = evaluate(state)
            log(f"step {step} eval_loss {eval_loss:.4f}", file=sys.stderr)
        if args.ckpt_dir and step % args.save_every == 0:
            ckpt_lib.save_checkpoint(args.ckpt_dir, state, mesh, sharded_cfg)
            last_saved_step = step
    if eval_fn is not None:
        metrics = dict(metrics)
        metrics["eval_loss"] = evaluate(state)
        log(f"final eval_loss {metrics['eval_loss']:.4f}", file=sys.stderr)
    if args.ckpt_dir:
        if last_saved_step != int(state.step):
            # the periodic save may already hold this step: a csm-1b
            # TrainState is ~25 GB rewritten for nothing otherwise
            ckpt_lib.save_checkpoint(args.ckpt_dir, state, mesh, sharded_cfg)
        # the params export always runs (the servable artifact); in LoRA
        # mode the adapters are merged into the dense weights; on a mesh
        # the shards are gathered and rank 0 writes the full tree
        export = state.params
        if args.lora_rank:
            from sesameai_tts_tpu_torch.training.lora import merge_lora

            with torch.no_grad():
                export = merge_lora(base_params, state.params, args.lora_alpha,
                                    tp=tp_group(mesh), cfg=spec.csm)
        if mesh is not None:
            export = all_gather_params(export, spec.csm, tp_group(mesh), csm_param_specs(),
                                       dst=0) if mesh.get_local_rank("dp") == 0 else None
        if lead:
            save_pytree(os.path.join(args.ckpt_dir, "params"), export)
        if mesh is not None:
            torch.distributed.barrier()
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", required=True, help="dataset dir (wav + txt/metadata.json)")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"])
    p.add_argument("--csm-checkpoint", default=None)
    p.add_argument("--mimi-checkpoint", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="default: auto-inferred from the checkpoint dir's tokenizer.json, "
                        "else 'byte'")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--buckets", default="64,128,256,512,1024,2048")
    p.add_argument("--eval-frac", type=float, default=0.0,
                   help=">0 holds out that fraction of clips (seeded split) and reports "
                        "eval_loss")
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval cadence in steps (0 = only at the end)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--decoder-frames", type=int, default=4)
    p.add_argument("--lora-rank", type=int, default=0,
                   help="0 = full finetune; >0 trains rank-r LoRA adapters over "
                        "--lora-targets and exports merged params")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-targets", default="qkv,o_proj,w13,w2")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "mixed"],
                   help="mixed = f32 params/optimizer, bf16 compute")
    p.add_argument("--mesh", default=None,
                   help="dp,tp (e.g. 1,2): train on a mesh of dp*tp ranks, each holding its "
                        "tp shards and its dp rows of every batch (torchrun starts the ranks)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' to run without one)")
    args = p.parse_args(argv)
    metrics = finetune(args)
    if not args.mesh or torch.distributed.get_rank() == 0:
        print(f"final: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
