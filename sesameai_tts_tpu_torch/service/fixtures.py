"""Synthetic, layout-exact upstream artefacts: the real-weights rehearsal
(port of ``sesameai_tts_tpu/service/fixtures.py``), ``sesame-tts-torch-fixtures``.

Without published checkpoints, the first real-weights day would be the
first time the convert → quantize → serve path meets the upstream layouts.
This module writes random-weight files in exactly those layouts, from the
repository alone (no download, no ``tokenizers``, no ``transformers``):

* ``csm-1b/``: a model directory with ``model.safetensors`` in the
  torchtune state-dict layout sesame/csm-1b publishes
  (``backbone.layers.N.attn.q_proj.weight`` …, ``save_csm_checkpoint``)
  and a Llama-3-format ``tokenizer.json`` (byte-level BPE with the
  ``<|begin_of_text|>`` / ``<|end_of_text|>`` specials), so the tokenizer is
  found beside the checkpoint;
* ``mimi.safetensors``: the transformers ``MimiModel`` state-dict layout
  (the published kyutai Mimi port), from the port's own Mimi parameters
  (``core/weights.py::mimi_hf_state_dict``);
* ``silentcipher.pth``: the silentcipher torch checkpoint layout
  (``enc_c`` / ``dec_c`` / ``dec_m`` / ``enc_m`` state dicts of Conv2d +
  BatchNorm stacks and the message embedding, plus ``hparams``);
* ``SYNTHETIC_WEIGHTS.json``: tells the smoke harness the weights are
  random, so its quality-gated checks become informational while every
  layout and pipeline check stays gated.

``sesame-tts-torch-smoke --weights-dir <dir>`` then runs the documented
procedure end to end on them.  The weights are random: these files check
layouts and pipelines, never audio quality.  Everything here is host work.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "bench_tokenizer.json")


def fixture_csm_config(flavor: str = "csm-1b"):
    """The CSM config the fixture checkpoint is shaped for.  The tiny flavor
    widens text_vocab to 512 so the real-format tokenizer (400 ids) fits its
    embedding table."""
    from sesameai_tts_tpu_torch.core.config import csm_1b, csm_test_tiny

    if flavor == "csm-1b":
        return csm_1b()
    return csm_test_tiny().replace(text_vocab_size=512)


def fixture_mimi_config(flavor: str = "csm-1b"):
    from sesameai_tts_tpu_torch.codec.mimi import MimiConfig, mimi_test_tiny

    return MimiConfig() if flavor == "csm-1b" else mimi_test_tiny()


def write_tokenizer_json(path: str, vocab_size: int = 400) -> str:
    """A Llama-3-format ``tokenizer.json`` of ``vocab_size`` ids: the port's
    byte-level BPE asset (two specials, the 256-symbol byte alphabet, then
    one id per merge in merge order) cut after its first
    ``vocab_size - 258`` merges, which is again a complete BPE."""
    with open(_ASSET) as f:
        tok = json.load(f)
    model = tok["model"]
    if not 258 < vocab_size <= len(model["vocab"]):
        raise ValueError(f"vocab_size {vocab_size} outside (258, {len(model['vocab'])}]")
    model["vocab"] = {t: i for t, i in model["vocab"].items() if i < vocab_size}
    model["merges"] = model["merges"][:vocab_size - 258]
    with open(path, "w") as f:
        json.dump(tok, f, ensure_ascii=False)
    return path


def write_csm_dir(outdir: str, flavor: str = "csm-1b", seed: int = 0) -> str:
    """Random CSM parameters drawn from ``seed`` → ``<outdir>/model.safetensors``
    in the torchtune key layout, f32 (``save_csm_checkpoint``, the tested
    inverse of the loader), with ``tokenizer.json`` beside it."""
    from sesameai_tts_tpu_torch.core.weights import save_csm_checkpoint
    from sesameai_tts_tpu_torch.models.csm import init_csm_params

    os.makedirs(outdir, exist_ok=True)
    params = init_csm_params(fixture_csm_config(flavor), torch.Generator().manual_seed(seed),
                             torch.float32)
    save_csm_checkpoint(os.path.join(outdir, "model.safetensors"), params)
    del params
    write_tokenizer_json(os.path.join(outdir, "tokenizer.json"))
    return outdir


def write_mimi_checkpoint(path: str, flavor: str = "csm-1b", seed: int = 0) -> str:
    """Random Mimi parameters drawn from ``seed`` → a safetensors file in the
    transformers ``MimiModel`` layout (f32; codebooks as ``embed_sum`` with
    unit ``cluster_usage`` and ``initialized`` set)."""
    from sesameai_tts_tpu_torch.codec.mimi import Mimi
    from sesameai_tts_tpu_torch.core.weights import mimi_hf_state_dict, write_safetensors

    mimi = Mimi(fixture_mimi_config(flavor))
    params = mimi.init(torch.Generator().manual_seed(seed), torch.float32)
    write_safetensors(path, mimi_hf_state_dict(params, mimi))
    return path


def _silentcipher_state(cfg, g: torch.Generator, hidden: int) -> dict:
    """enc_c / dec_c / dec_m state dicts and the enc_m table in silentcipher's
    module layout: ``main.N.conv.*`` + ``main.N.bn.*`` per Conv2d + BN + ReLU
    block, ``main.N.weight/bias`` for a stack's plain final conv."""

    def relu_block(cin, cout) -> dict:
        return {
            "conv.weight": torch.randn((cout, cin, 3, 3), generator=g) / (cin * 9) ** 0.5,
            "conv.bias": torch.randn(cout, generator=g) * 0.1,
            "bn.weight": 1.0 + 0.2 * torch.randn(cout, generator=g),
            "bn.bias": torch.randn(cout, generator=g),
            "bn.running_mean": torch.randn(cout, generator=g),
            "bn.running_var": 0.5 + 1.5 * torch.rand(cout, generator=g),
            "bn.num_batches_tracked": torch.tensor(0),
        }

    def conv(cin, cout) -> dict:
        return {"weight": torch.randn((cout, cin, 3, 3), generator=g) / (cin * 9) ** 0.5,
                "bias": torch.randn(cout, generator=g) * 0.1}

    def stack(cin, cout, n_blocks, last_relu=False) -> dict:
        blocks = ([relu_block(cin, hidden)] + [relu_block(hidden, hidden)
                                               for _ in range(n_blocks - 2)]
                  + [relu_block(hidden, cout) if last_relu else conv(hidden, cout)])
        return {f"main.{i}.{k}": v for i, b in enumerate(blocks) for k, v in b.items()}

    return {
        "enc_c": stack(1, hidden, 3, last_relu=True),
        "dec_c": stack(1 + hidden + cfg.message_len, 1, 4),
        "dec_m": stack(1, cfg.message_len * cfg.vocab, 3),
        "enc_m": {"weight": torch.randn((cfg.vocab, cfg.n_bins), generator=g)},
    }


def write_silentcipher_checkpoint(path: str, flavor: str = "csm-1b", seed: int = 0,
                                  hidden: int = 32) -> str:
    """A silentcipher-layout torch checkpoint drawn from ``seed``: the
    ``enc_c`` / ``dec_c`` / ``dec_m`` / ``enc_m`` state dicts and ``hparams``
    that ``watermark/net.py::load_silentcipher_checkpoint`` reads.
    ``hidden`` sets the stacks' width (the converter infers every size)."""
    from sesameai_tts_tpu_torch.watermark.net import SilentCipherConfig, silentcipher_test_tiny

    cfg = SilentCipherConfig() if flavor == "csm-1b" else silentcipher_test_tiny()
    ckpt = _silentcipher_state(cfg, torch.Generator().manual_seed(seed), hidden)
    ckpt["hparams"] = {"sample_rate": cfg.sample_rate, "n_fft": cfg.n_fft,
                       "hop_length": cfg.hop, "message_len": cfg.message_len}
    torch.save(ckpt, path)
    return path


def write_synthetic_weights(outdir: str, flavor: str = "csm-1b", seed: int = 0) -> dict:
    """Every upstream-layout artefact and the SYNTHETIC marker → their paths.
    The flagship is full size (~6.5 GB of f32 CSM weights): the rehearsal
    exercises real shapes and real conversion times."""
    os.makedirs(outdir, exist_ok=True)
    paths = {
        "csm_dir": write_csm_dir(os.path.join(outdir, "csm-1b"), flavor, seed),
        "mimi": write_mimi_checkpoint(os.path.join(outdir, "mimi.safetensors"), flavor, seed),
        "silentcipher": write_silentcipher_checkpoint(
            os.path.join(outdir, "silentcipher.pth"), flavor, seed),
    }
    paths["tokenizer"] = os.path.join(paths["csm_dir"], "tokenizer.json")
    marker = os.path.join(outdir, "SYNTHETIC_WEIGHTS.json")
    with open(marker, "w") as f:
        json.dump({"flavor": flavor, "seed": seed,
                   "note": "random weights — layout rehearsal only"}, f)
    paths["marker"] = marker
    return paths


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="write synthetic layout-exact upstream checkpoints "
                    "(the real-weights rehearsal)")
    p.add_argument("outdir")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    paths = write_synthetic_weights(args.outdir, args.flavor, args.seed)
    for k, v in paths.items():
        print(f"{k}: {v}")
    print(f"next: sesame-tts-torch-smoke --weights-dir {args.outdir}"
          + (" --flavor test-tiny" if args.flavor == "test-tiny" else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
