"""One-command real-weights acceptance smoke (port of
``sesameai_tts_tpu/service/smoke.py``), ``sesame-tts-torch-smoke``.

On a machine with the published checkpoints this turns the documented
procedure (docs/REAL_WEIGHTS.md) into one command::

    sesame-tts-torch-smoke --model-path /ckpt/csm_dir --mimi-path /ckpt/mimi.safetensors \\
        --tokenizer /path/tokenizer.json [--silentcipher /ckpt/silentcipher.safetensors]

With ``--weights-dir <dir>`` (upstream-layout files: what
``sesame-tts-torch-fixtures`` writes, and what a sesame/csm-1b + kyutai Mimi
+ silentcipher download holds) the whole procedure runs as one command:
convert → quantize → serve → speak → verify.  A ``SYNTHETIC_WEIGHTS.json``
marker turns the quality-gated checks into information (random weights have
no codec fidelity and recover no watermark); layout and pipeline checks stay
gated.  Runs on ``--device`` (the card unless the caller asks for the CPU).

Checks, each printed PASS/FAIL with its seconds:
  0. convert   — (--weights-dir) Mimi and silentcipher torch files → the
                 port's files (``sesame-tts-torch-convert``)
  1. load      — the checkpoints load through ``ModelSpec`` / ``build_generator``
  2. generate  — a short utterance gives 24 kHz audio with a sane RMS
  3. greedy    — topk=1 generation is seed-invariant (two runs agree)
  3b. quant    — (int8/int4 specs) the quantization gate (``runtime/qa.py``):
                 weight-SNR ≥ 35 dB on every trunk matrix and teacher-forced
                 logit-SNR ≥ 20 dB against a dense bf16 twin; the logit half
                 informational on synthetic weights
  4. codec     — Mimi encode → decode of the generated audio reaches a
                 speech-grade SNR
  5. watermark — embed → verify through the active backend (the
                 silentcipher network when a checkpoint is given)
  6. serve     — the batched engine and the HTTP API deliver a watermarked
                 WAV on /tts and a streamed, watermarked PCM body on
                 /tts/stream
  7. rtf       — median RTF over 3 runs (printed, not gated)

Exit code 0 if and only if every gated check passes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _convert(args, p) -> bool:
    """Check 0: the upstream files under ``--weights-dir`` → the port's files
    under ``<dir>/_converted`` (kept and reused by later runs); points the
    args at them."""
    from sesameai_tts_tpu_torch.service.convert import main as convert_main

    wd = args.weights_dir
    csm_dir = os.path.join(wd, "csm-1b")
    mimi_src = os.path.join(wd, "mimi.safetensors")
    wm_src = os.path.join(wd, "silentcipher.pth")
    for q in (csm_dir, mimi_src, wm_src):
        if not os.path.exists(q):
            p.error(f"--weights-dir is missing {q}")
    dt = "bfloat16" if args.flavor == "csm-1b" else "float32"
    mimi_dst = os.path.join(wd, "_converted", "mimi.safetensors")
    wm_dst = os.path.join(wd, "_converted", "silentcipher.safetensors")
    os.makedirs(os.path.dirname(mimi_dst), exist_ok=True)
    for family, src, dst, dtype in (("mimi", mimi_src, mimi_dst, dt),
                                    ("silentcipher", wm_src, wm_dst, "float32")):
        if not os.path.exists(dst) and convert_main(
                [family, src, dst, "--flavor", args.flavor, "--dtype", dtype,
                 "--device", args.device]):
            return False
    args.model_path, args.mimi_path, args.silentcipher = csm_dir, mimi_dst, wm_dst
    return True


def _spec(args):
    import torch

    from sesameai_tts_tpu_torch.runtime.loader import (
        ModelSpec,
        csm_1b_spec,
        resolve_tokenizer,
        test_tiny_spec,
    )
    from sesameai_tts_tpu_torch.service.fixtures import fixture_csm_config, fixture_mimi_config

    if args.weights_dir:
        # an explicit spec: the fixtures' tiny flavor widens text_vocab for
        # the real-format tokenizer; the flagship is csm_1b_spec's (int8
        # trunks, bf16 Mimi)
        flagship = args.flavor == "csm-1b"
        return ModelSpec(
            csm=fixture_csm_config(args.flavor), mimi=fixture_mimi_config(args.flavor),
            tokenizer=args.tokenizer or resolve_tokenizer(None, args.model_path),
            csm_checkpoint=args.model_path, mimi_checkpoint=args.mimi_path,
            dtype=torch.bfloat16 if flagship else torch.float32,
            mimi_dtype=torch.bfloat16 if flagship else torch.float32,
            quantize="int8" if flagship else None)
    if args.flavor == "test-tiny":
        return test_tiny_spec()
    return csm_1b_spec(args.model_path, args.mimi_path, args.tokenizer)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="real-weights acceptance smoke (PyTorch)")
    p.add_argument("--model-path", default=None)
    p.add_argument("--mimi-path", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--silentcipher", default=None,
                   help="silentcipher checkpoint: a torch file or a converted one (optional)")
    p.add_argument("--text", default="The quick brown fox jumps over the lazy dog.")
    p.add_argument("--output", default=None, help="also write the WAV here")
    p.add_argument("--flavor", default="csm-1b", choices=["csm-1b", "test-tiny"],
                   help="test-tiny runs the whole harness on random tiny weights (a "
                        "self-test: the codec check FAILS by design on random weights)")
    p.add_argument("--weights-dir", default=None,
                   help="directory of UPSTREAM-layout files (csm-1b/ model dir with "
                        "tokenizer.json, mimi.safetensors, silentcipher.pth: what "
                        "sesame-tts-torch-fixtures writes and a real download mirrors). "
                        "Runs convert → quantize → serve → speak → verify as one command. "
                        "With a SYNTHETIC_WEIGHTS.json marker the quality-gated checks "
                        "are informational; layouts and pipelines stay gated")
    p.add_argument("-d", "--device", default="cuda", help="device (cuda or cpu)")
    args = p.parse_args(argv)

    from sesameai_tts_tpu_torch.runtime.generator import resolve_device

    resolve_device(args.device)
    results = []
    clock = [time.perf_counter()]

    def check(name, ok, detail=""):
        now = time.perf_counter()
        results.append((name, bool(ok)))
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail} ({now - clock[0]:.1f} s)",
              flush=True)
        clock[0] = now

    synthetic = False
    if args.weights_dir:
        synthetic = os.path.exists(os.path.join(args.weights_dir, "SYNTHETIC_WEIGHTS.json"))
        try:
            ok, why = _convert(args, p), "a conversion failed"
        except Exception as e:
            ok, why = False, repr(e)
        check("convert", ok, f"mimi + silentcipher at {args.weights_dir}/_converted" if ok
              else why)
        if not ok:
            return _report(results)
    if args.flavor == "csm-1b":
        if not (args.model_path and args.mimi_path):
            p.error("--model-path and --mimi-path are required for the csm-1b flavor")
        from sesameai_tts_tpu_torch.runtime.loader import resolve_tokenizer

        args.tokenizer = resolve_tokenizer(args.tokenizer, args.model_path)
        if args.tokenizer == "byte":
            p.error("no tokenizer found: pass --tokenizer, or ship tokenizer.json next to "
                    "the model checkpoint (the HF layout)")

    from sesameai_tts_tpu_torch.runtime.loader import build_generator

    try:
        spec = _spec(args)
        gen = build_generator(spec, device=args.device)
        check("load", True, f"tokenizer {spec.tokenizer!r}, quantize {spec.quantize}, "
                            f"device {gen.device}")
    except Exception as e:
        check("load", False, repr(e))
        return _report(results)

    try:
        audio = gen.generate(args.text, 1, [], max_audio_length_ms=6_000, temperature=0.8,
                             topk=40)
        rms = float(np.sqrt((audio ** 2).mean())) if len(audio) else 0.0
        ok = len(audio) > 0 and bool(np.isfinite(audio).all())
        detail = f"{len(audio) / gen.sample_rate:.1f}s audio, rms {rms:.3f}"
        if synthetic:
            # random weights bound neither Mimi's level nor the EOS frame:
            # the pipeline facts stay gated, the level is information
            check("generate", ok, detail + " (informational: synthetic weights — level "
                                           "not gated)")
        else:
            ok = ok and 1e-4 < rms < 1.0
            check("generate", ok, detail)
        if args.output and ok:
            from sesameai_tts_tpu_torch.audio.io import write_wav

            write_wav(args.output, audio, gen.sample_rate)
            print(f"  wrote {args.output}")
    except Exception as e:
        check("generate", False, repr(e))
        return _report(results)

    try:
        a = gen.generate(args.text, 1, [], max_audio_length_ms=2_000, temperature=1.0, topk=1)
        b = gen.generate(args.text, 1, [], max_audio_length_ms=2_000, temperature=1.0, topk=1)
        check("greedy", len(a) == len(b) and np.allclose(a, b, atol=1e-5),
              "topk=1 seed-invariant")
    except Exception as e:
        check("greedy", False, repr(e))

    # the quantization gate (runtime/qa.py) decides the exit code on real
    # weights; below it, serve bf16 (quantize=None)
    if spec.quantize in ("int8", "int4"):
        try:
            import dataclasses

            from sesameai_tts_tpu_torch.runtime.qa import quant_acceptance

            gen_ref = build_generator(dataclasses.replace(spec, quantize=None),
                                      device=args.device)
            rep = quant_acceptance(gen, gen_ref, text=args.text + " " + args.text, steps=100)
            del gen_ref  # free the dense twin before serving
            detail = (f"weight-SNR min {rep['weight_snr_min_db']} dB (gate "
                      f"≥{rep['gate_weight_snr_db']:.0f}), teacher-forced logit-SNR "
                      f"{rep['logit_snr_db']} dB (gate ≥{rep['gate_logit_snr_db']:.0f}), "
                      f"per-code match {rep['code_match']} over {rep['steps']} steps")
            if synthetic:
                # random weights: argmax margins ~0 make the match rate
                # meaningless; the weight-SNR half still holds
                check("quant", rep["weight_snr_min_db"] >= rep["gate_weight_snr_db"],
                      detail + " (informational: synthetic weights — logit gate not applied)")
            else:
                check("quant", rep["passed"], detail + (
                    "" if rep["passed"] else " — BELOW GATE: serve bf16 (quantize=None)"))
        except Exception as e:
            check("quant", False, repr(e))

    try:
        hop = gen._hop
        clip = audio[:(len(audio) // hop) * hop]
        codes = np.asarray(gen._encode_audio(clip))  # (K, F)
        recon = gen.decode_audio(codes.T)  # decode takes (F, K)
        n = min(len(clip), len(recon))
        err = clip[:n] - recon[:n]
        snr = 10 * np.log10(float((clip[:n] ** 2).sum()) / max(float((err ** 2).sum()), 1e-12))
        # re-coding already coded audio is near-transparent for a healthy
        # codec; random weights give < 0 dB
        if synthetic and snr <= 5.0:
            check("codec", True, f"re-encode SNR {snr:.1f} dB (informational: synthetic "
                                 "weights — pipeline ran, quality not gated)")
        else:
            check("codec", snr > 5.0, f"re-encode SNR {snr:.1f} dB")
    except Exception as e:
        check("codec", False, repr(e))

    wm_pair = None
    try:
        from sesameai_tts_tpu_torch.watermark.api import (
            CSM_1B_WATERMARK,
            load_watermarker,
            verify,
            watermark,
        )

        wm = load_watermarker(ckpt_path=args.silentcipher, device=args.device)
        wm_pair = (wm, CSM_1B_WATERMARK)
        carrier = audio
        # ~4 s is the minimum; 9 s gives the DSP detector √2 of headroom on
        # the tiny flavor's spectrally odd random-weights audio
        need = int(9 * gen.sample_rate)
        if len(carrier) < need:  # tiny or early-EOS runs: tile the clip
            carrier = np.tile(carrier, -(-need // max(len(carrier), 1)))[:need]
        marked, rate = watermark(wm, carrier, gen.sample_rate, CSM_1B_WATERMARK)
        recovered = verify(wm, marked, rate, CSM_1B_WATERMARK)
        pipeline_ok = len(marked) > 0 and bool(np.isfinite(marked).all())
        if synthetic and not recovered:
            # a random-weights network cannot recover its message: the
            # embed → verify pipeline ran; recovery needs trained weights
            check("watermark", pipeline_ok, f"{type(wm).__name__} embed→verify ran; "
                                            "recovered=False (informational: synthetic weights)")
        else:
            check("watermark", recovered and pipeline_ok, type(wm).__name__)
    except Exception as e:
        check("watermark", False, repr(e))

    # serve: the batched engine and the HTTP API deliver a watermarked WAV
    # and a watermarked stream over the wire
    try:
        from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer
        from sesameai_tts_tpu_torch.service import http_api
        from sesameai_tts_tpu_torch.watermark.stream import make_streaming_watermarker

        eng = BatchedTTSServer(gen, slots=2, chunk_frames=10 if args.flavor == "csm-1b" else 4)
        eng.start()
        httpd = http_api.serve(eng, host="127.0.0.1", port=0, sample_rate=gen.sample_rate,
                               watermarker=wm_pair)
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            status, wav_bytes = _post(base + "/tts", args.text)
            stream_status, pcm_bytes = _post(base + "/tts/stream", args.text)
            pcm = np.frombuffer(pcm_bytes, np.float32)
            embedder = (type(make_streaming_watermarker(wm_pair[0], wm_pair[1],
                                                        gen.sample_rate)._emb).__name__
                        if wm_pair else None)
            ok = (status == 200 and wav_bytes[:4] == b"RIFF" and stream_status == 200
                  and len(pcm_bytes) % 4 == 0 and bool(np.isfinite(pcm).all()))
            check("serve", ok, f"POST /tts → {len(wav_bytes)} WAV bytes, POST /tts/stream → "
                               f"{len(pcm)} PCM samples (watermarked: {wm_pair is not None}, "
                               f"stream through {embedder})")
        finally:
            httpd.shutdown()
            eng.stop()
    except Exception as e:
        check("serve", False, repr(e))

    rtfs = []
    for _ in range(3):
        t0 = time.perf_counter()
        a = gen.generate(args.text, 1, [], max_audio_length_ms=6_000, temperature=0.8, topk=40)
        if len(a):  # random tiny weights can end on frame 1 → 0 s of audio
            rtfs.append((time.perf_counter() - t0) / (len(a) / gen.sample_rate))
    if rtfs:
        print(f"[info] RTF median-of-3: {float(np.median(rtfs)):.4f} "
              f"({time.perf_counter() - clock[0]:.1f} s)", flush=True)
    else:
        print("[info] RTF: no audio produced (immediate EOS) — skipped")
    return _report(results)


def _post(url: str, text: str):
    import json
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({"text": text, "max_audio_length_ms": 2_000}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read()


def _report(results) -> int:
    failed = [n for n, ok in results if not ok]
    print(f"\nsmoke: {len(results) - len(failed)}/{len(results)} checks passed"
          + (f" — FAILED: {', '.join(failed)}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
