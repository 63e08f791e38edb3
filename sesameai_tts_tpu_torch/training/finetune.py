"""Finetuning CLI: dataset directory → trained CSM checkpoint (port of
``sesameai_tts_tpu/training/finetune.py``; the ``--mesh`` option belongs
to the parallel slice).  On the card unless ``-d cpu``.

    sesame-tts-torch-finetune --data clips/ --flavor test-tiny --steps 50 \\
        --ckpt-dir ckpt/run1 --save-every 25 -d cpu

* dataset: ``metadata.json`` or ``.txt`` sidecars next to WAVs
  (``training/data.py::load_directory``), resampled to 24 kHz;
* the codec and a random init are drawn as ``runtime/loader.py::
  build_generator`` draws them (``loader.init_models``: the CSM params and
  Mimi from generators of their own, both from the spec's seed), so a run
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
  tree, so it serves like a full finetune's.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch

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
    make_train_step,
)


def init_models(spec, dtype):
    """(CSM params, Mimi, Mimi params) on the host, drawn or read as
    ``build_generator`` does (``runtime/loader.py::init_models``), the CSM
    params at ``dtype``: an export of this run decodes with the codec it
    trained against."""
    from sesameai_tts_tpu_torch.runtime import loader

    return loader.init_models(spec, dtype)


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


def finetune(args) -> dict:
    """Run the loop; returns the last metrics as floats (CLI + tests entry)."""
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.weights import save_pytree
    from sesameai_tts_tpu_torch.runtime.generator import resolve_device
    from sesameai_tts_tpu_torch.runtime.loader import csm_1b_spec, test_tiny_spec

    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")
    device = resolve_device(args.device)

    if args.flavor == "test-tiny":
        spec = test_tiny_spec()
    else:
        spec = csm_1b_spec(csm_checkpoint=args.csm_checkpoint,
                           mimi_checkpoint=args.mimi_checkpoint, tokenizer=args.tokenizer,
                           quantize=None)  # training runs dense; quantize at serve time

    # 'mixed' = f32 master params + Adam moments, bf16 forward/backward
    # (the cast happens inside the differentiated step)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "mixed": torch.float32}[args.dtype]
    compute_dtype = torch.bfloat16 if args.dtype == "mixed" else None
    params, mimi, mimi_params = init_models(spec, dtype)
    ftok = build_frame_tokenizer(spec, mimi, mimi_params, device)
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
        print(f"buckets > max_seq_len {max_pos} dropped: {[b for b in buckets if b > max_pos]} "
              f"(over-length clips are skipped with a count)", file=sys.stderr)
        buckets = kept
    eval_segments: list = []
    if args.eval_frac > 0 and len(segments) > 1:
        # seeded split so --resume sees the same held-out set
        order = np.random.default_rng(args.seed).permutation(len(segments))
        n_eval = min(max(1, round(len(segments) * args.eval_frac)), len(segments) - 1)
        eval_segments = [segments[i] for i in order[:n_eval]]
        segments = [segments[i] for i in order[n_eval:]]
    loader = BatchLoader(segments, ftok, LoaderConfig(batch_size=args.batch_size,
                                                      buckets=buckets, seed=args.seed))
    if loader.dropped:
        print(f"dropped {loader.dropped} over-length examples", file=sys.stderr)
    eval_loader = None
    if eval_segments:
        try:
            eval_loader = BatchLoader(eval_segments, ftok, LoaderConfig(
                batch_size=args.batch_size, buckets=buckets, seed=args.seed, shuffle=False))
        except ValueError:
            print("eval split has no usable examples (all over-length); eval disabled",
                  file=sys.stderr)

    warmup = args.warmup
    if warmup >= args.steps:
        # a run that never leaves warmup peaks on its last update: clamp
        warmup = max(1, args.steps // 10)
        print(f"warmup {args.warmup} >= steps {args.steps}; clamped to {warmup}",
              file=sys.stderr)
    tx = make_optimizer(args.lr, args.weight_decay, warmup, total_steps=args.steps)
    params = to_device(params, device)
    base_params = None  # the frozen base in LoRA mode
    if args.lora_rank:
        from sesameai_tts_tpu_torch.training.lora import init_lora_params

        base_params = params
        lora = init_lora_params(torch.Generator().manual_seed(args.seed + 1), base_params,
                                args.lora_rank, tuple(args.lora_targets.split(",")), dtype)
        state = init_train_state(lora, tx)
    else:
        state = init_train_state(params, tx)
    del params

    if args.resume:
        path = ckpt_lib.latest_checkpoint(args.ckpt_dir)
        if not path:
            # the user asked to resume: retraining from scratch into the
            # directory they thought held their run is the worst outcome
            raise SystemExit(f"--resume: no checkpoint found in {args.ckpt_dir!r}; drop "
                             f"--resume to start fresh, or fix --ckpt-dir")
        state = ckpt_lib.restore_checkpoint(path, state)
        print(f"resumed from {path} (step {int(state.step)})", file=sys.stderr)

    if args.lora_rank:
        lora_step = make_lora_train_step(
            spec.csm, tx, alpha=args.lora_alpha, decoder_frames=args.decoder_frames,
            remat=args.remat, accum_steps=args.accum_steps, compute_dtype=compute_dtype,
            subset_seed=args.seed)
        step_fn = lambda s, b: lora_step(s, base_params, b)  # noqa: E731
    else:
        step_fn = make_train_step(
            spec.csm, tx, decoder_frames=args.decoder_frames, remat=args.remat,
            accum_steps=args.accum_steps, compute_dtype=compute_dtype, subset_seed=args.seed)

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
                                            compute_dtype=compute_dtype)
            eval_fn = lambda s, b: lora_eval(s.params, base_params, b)  # noqa: E731
        else:
            dense_eval = make_eval_step(spec.csm, args.decoder_frames,
                                        compute_dtype=compute_dtype)
            eval_fn = lambda s, b: dense_eval(s.params, b)  # noqa: E731

    def evaluate(state) -> float:
        """Held-out loss, deterministic (unshuffled loader, first-N decoder
        subset), batches pooled by their audio row count."""
        tot = w = 0.0
        for b in eval_loader:
            rows = float(np.asarray(b.mask[..., 0] & b.loss_mask).sum())
            tot += float(eval_fn(state, batch_to(b, device))["loss"]) * rows
            w += rows
        return tot / max(w, 1.0)

    metrics = {}
    t0 = time.time()
    start = int(state.step)
    last_saved_step = -1
    for batch in prefetch(batches, depth=2):
        if int(state.step) >= args.steps:
            break
        state, metrics = step_fn(state, batch_to(batch, device))
        step = int(state.step)  # one host sync per step
        if step % args.log_every == 0 or step == args.steps:
            rate = (step - start) / max(time.time() - t0, 1e-9)
            print(f"step {step}/{args.steps} loss {float(metrics['loss']):.4f} "
                  f"(c0 {float(metrics['c0_loss']):.4f} dec "
                  f"{float(metrics['decoder_loss']):.4f}) {rate:.2f} steps/s", file=sys.stderr)
        if eval_fn and args.eval_every and step % args.eval_every == 0:
            print(f"step {step} eval_loss {evaluate(state):.4f}", file=sys.stderr)
        if args.ckpt_dir and step % args.save_every == 0:
            ckpt_lib.save_checkpoint(args.ckpt_dir, state)
            last_saved_step = step
    if eval_fn is not None:
        metrics = dict(metrics)
        metrics["eval_loss"] = evaluate(state)
        print(f"final eval_loss {metrics['eval_loss']:.4f}", file=sys.stderr)
    if args.ckpt_dir:
        if last_saved_step != int(state.step):
            # the periodic save may already hold this step: a csm-1b
            # TrainState is ~25 GB rewritten for nothing otherwise
            ckpt_lib.save_checkpoint(args.ckpt_dir, state)
        # the params export always runs (the servable artifact); in LoRA
        # mode the adapters are merged into the dense weights
        export = state.params
        if args.lora_rank:
            from sesameai_tts_tpu_torch.training.lora import merge_lora

            with torch.no_grad():
                export = merge_lora(base_params, state.params, args.lora_alpha)
        save_pytree(os.path.join(args.ckpt_dir, "params"), export)
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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' to run without one)")
    args = p.parse_args(argv)
    metrics = finetune(args)
    print(f"final: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
