"""Checkpoint conversion (port of ``sesameai_tts_tpu/service/convert.py``):
published torch checkpoints → the files the port's consumers load, as an
explicit, offline step, ``sesame-tts-torch-convert``::

    sesame-tts-torch-convert csm  model.safetensors  /ckpt/csm_dir
    sesame-tts-torch-convert mimi model.safetensors  /ckpt/mimi.safetensors
    sesame-tts-torch-convert silentcipher ckpt.pth   /ckpt/silentcipher.safetensors

Each family writes what its consumer reads:

* ``csm`` → a directory with ``model.safetensors`` in the torchtune layout
  (``ModelSpec.csm_checkpoint`` takes the directory);
* ``mimi`` → one ``save_pytree`` file (``ModelSpec.mimi_checkpoint``);
* ``silentcipher`` → one ``save_pytree`` file and ``<dst>.config.json``
  beside it (``load_watermarker(ckpt_path=...)`` / ``SILENTCIPHER_CKPT``).

The JAX package writes orbax directories where this writes safetensors
files.  ``--verify`` (the default) checks each tree before it is written: the
CSM file read back equal, one Mimi encode → decode, one silentcipher embed,
the forwards on ``--device`` (the card unless the caller asks for the CPU),
so a bad layout fails here and not at serve time.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _tree_stats(tree) -> str:
    from sesameai_tts_tpu_torch.convert import tree_map

    leaves = []
    tree_map(leaves.append, tree)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    return f"{len(leaves)} leaves, {n_bytes / 2 ** 20:.1f} MiB"


def _convert_csm(src: str, dst: str, dtype, verify: bool, flavor: str, device) -> None:
    from sesameai_tts_tpu_torch.convert import tree_map
    from sesameai_tts_tpu_torch.core.config import csm_1b, csm_test_tiny
    from sesameai_tts_tpu_torch.core.weights import load_csm_checkpoint, save_csm_checkpoint

    cfg = csm_test_tiny() if flavor == "test-tiny" else csm_1b()
    params = load_csm_checkpoint(src, cfg, dtype)
    print(f"converted CSM tree: {_tree_stats(params)}")
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, "model.safetensors")
    save_csm_checkpoint(out, params)
    if verify:
        want, got = [], []
        tree_map(want.append, params)
        tree_map(got.append, load_csm_checkpoint(out, cfg, dtype))
        if len(want) != len(got) or not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise ValueError(f"{out}: the checkpoint read back differs from the tree written")
        print("verify: save→load round trip identical")
    print(f"wrote safetensors checkpoint: {out} (load via ModelSpec.csm_checkpoint={dst!r})")


def _convert_mimi(src: str, dst: str, dtype, verify: bool, flavor: str, device) -> None:
    from sesameai_tts_tpu_torch.codec.mimi import Mimi, MimiConfig, mimi_test_tiny
    from sesameai_tts_tpu_torch.convert import to_device
    from sesameai_tts_tpu_torch.core.weights import load_mimi_checkpoint, save_pytree

    mimi = Mimi(mimi_test_tiny() if flavor == "test-tiny" else MimiConfig())
    params = load_mimi_checkpoint(src, mimi, dtype)
    print(f"converted Mimi tree: {_tree_stats(params)}")
    if verify:  # one encode → decode, so a shape or layout error fails here
        on_device = to_device(params, device)
        with torch.no_grad():
            wav = torch.zeros((1, 1, mimi.cfg.hop_length * 4), dtype=dtype, device=device)
            codes = mimi.encode(on_device, wav)
            out = mimi.decode(on_device, codes)
        print(f"verify: encode→decode ok (codes {tuple(codes.shape)}, wav {tuple(out.shape)})")
        del on_device
    save_pytree(dst, params)
    print(f"wrote save_pytree checkpoint: {dst}")


def _convert_silentcipher(src: str, dst: str, dtype, verify: bool, flavor: str,
                          device) -> None:
    from sesameai_tts_tpu_torch.watermark.net import load_silentcipher_checkpoint, save_converted

    model = load_silentcipher_checkpoint(src, device=device)
    if dtype != torch.float32:
        # the network's STFT and convs run in float32, and at a few MB there
        # is nothing to save: the tree stays f32
        print("note: the silentcipher net runs float32; --dtype ignored for this family")
    print(f"converted silentcipher tree (float32): {_tree_stats(model.params)}")
    if verify:
        rate = model.cfg.sample_rate  # a checkpoint's hparams may give another rate
        y, _ = model.encode_wav(np.zeros(rate, np.float32), rate, [212, 211, 146, 56, 201])
        print(f"verify: encode_wav ok ({len(y)} samples @ {rate} Hz)")
    cfg_path = save_converted(dst, model.params, model.cfg)
    print(f"wrote save_pytree checkpoint: {dst} (+ {cfg_path})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert published torch checkpoints to the port's files")
    p.add_argument("family", choices=["csm", "mimi", "silentcipher"])
    p.add_argument("src", help="torch checkpoint (.pt / .pth / .safetensors / model dir)")
    p.add_argument("dst", help="output: a directory for csm, a .safetensors file otherwise")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--verify", action=argparse.BooleanOptionalAction, default=True,
                   help="check the converted tree before writing it (default: on)")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"],
                   help="model shapes the checkpoint must match")
    p.add_argument("-d", "--device", default="cuda",
                   help="device of the verify forwards (cuda or cpu)")
    args = p.parse_args(argv)

    from sesameai_tts_tpu_torch.runtime.generator import resolve_device

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    fn = {"csm": _convert_csm, "mimi": _convert_mimi,
          "silentcipher": _convert_silentcipher}[args.family]
    try:
        fn(args.src, args.dst, dtype, args.verify, args.flavor, resolve_device(args.device))
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
