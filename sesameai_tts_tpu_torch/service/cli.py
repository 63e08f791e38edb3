"""Command line (port of ``sesameai_tts_tpu/service/cli.py``):
``-d/--device``, ``-v/--voice``, positional text, ``--output``,
``--temp/--temperature``, ``--topk``; no text → interactive mode.  Also
checkpoint and tokenizer paths, the test-tiny flavor, the watermark
switch (test-tiny only) and the voice registry.

    python -m sesameai_tts_tpu_torch.service.cli -v <voice> "Hello world." \\
        --output out.wav --model-path <csm dir> --mimi-path <mimi.safetensors>

Runs on the card; ``-d cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Sesame CSM-1B Text-to-Speech (PyTorch)")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="Device to run on (cuda or cpu)")
    parser.add_argument("-v", "--voice", type=str, default=None,
                        help="Voice to use (from the voice registry)")
    parser.add_argument("text", type=str, nargs="?", help="Text to synthesize")
    parser.add_argument("--output", type=str, default="output.wav")
    parser.add_argument("--temp", "--temperature", type=float, default=0.8, dest="temp",
                        help="Temperature for generation (0.1-1.0)")
    parser.add_argument("--topk", type=int, default=40, help="Top-K (10-100)")
    parser.add_argument("--model-path", type=str, default=None,
                        help="Local CSM checkpoint (.safetensors/.pt or a model directory); "
                             "random init if omitted")
    parser.add_argument("--mimi-path", type=str, default=None,
                        help="Local Mimi parameters (a .safetensors file written by "
                             "core.weights.save_pytree); random init if omitted")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="'byte', 'tiny', or a local tokenizer.json path. Default: a "
                             "--model-path directory holding tokenizer.json supplies it; "
                             "runs without weights fall back to 'byte'")
    parser.add_argument("--voices", type=str, default=None,
                        help="Voice registry: samples.py path, JSON, or directory")
    parser.add_argument("--flavor", type=str, default="csm-1b", choices=["csm-1b", "test-tiny"])
    parser.add_argument("--no-watermark", action="store_true",
                        help="Disable the watermark (test-tiny flavor only; flagship "
                             "generation is always watermarked)")
    parser.add_argument("--max-ms", type=float, default=30_000,
                        help="Per-sentence generation cap in milliseconds")
    parser.add_argument("--seed", type=int, default=None,
                        help="Reproducible synthesis: sentence i of the input uses seed+i")
    parser.add_argument("--no-quantize", action="store_true",
                        help="Serve the trunks in bf16 instead of the weight-only int8 default")
    args = parser.parse_args(argv)

    if args.no_watermark and args.flavor != "test-tiny":
        parser.error("--no-watermark is restricted to --flavor test-tiny")

    from sesameai_tts_tpu_torch.runtime.loader import csm_1b_spec, test_tiny_spec
    from sesameai_tts_tpu_torch.service.tts import TTS

    if args.flavor == "test-tiny":
        spec = test_tiny_spec()
    else:
        spec = csm_1b_spec(args.model_path, args.mimi_path, args.tokenizer,
                           quantize=None if args.no_quantize else "int8")

    tts_engine = TTS(spec=spec, voices=args.voices, enable_watermark=not args.no_watermark,
                     device=args.device)
    tts_engine.load_model()

    if args.voice:
        tts_engine.load_voice(args.voice)
    elif tts_engine.list_voices():
        tts_engine.load_voice(tts_engine.list_voices()[0])
    else:
        print("No voices registered; generating without voice context")

    if args.text:
        tts_engine.export_wav(args.text, args.output, temperature=args.temp, topk=args.topk,
                              seed=args.seed, max_audio_length_ms=args.max_ms)
        return
    print(f"Interactive mode (temp={args.temp}, topk={args.topk})")
    while True:
        try:
            text = input("> ")
            if text.lower() in ("exit", "quit"):
                break
            if text.strip():
                tts_engine.say(text, output_filename=None, temperature=args.temp,
                               topk=args.topk, seed=args.seed, max_audio_length_ms=args.max_ms)
        except (EOFError, KeyboardInterrupt):
            break
    print("\nExiting interactive mode.")


if __name__ == "__main__":
    main()
