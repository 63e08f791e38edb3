"""Whether what the timed path served is correct: the plain reference
(``benchmark/reference``) against the tokens and PCM the pool handed to
the clients in the window.

Run once the window has closed, the device's peak memory read and the
program freed.  The weights are drawn again from the seed (the same bits
the program was given); the reference quantizes them itself and rebuilds
every prompt from the benchmark's own rows.  Two numbers are compared:

- ``logit_gap``: over every token of every greedy request that finished,
  how far the served token's logit lies below the reference's best, at
  each position, teacher-forced on the served frames (the prefill's frame
  through the bf16 shadow, the graphed frame-steps at B = slots with the
  quantized products and attention, the sampler);
- ``pcm_err``: over a sample of finished requests drawn from the seed,
  the longest among them, the relative L2 distance of the PCM the client
  received from the reference's Mimi decode of the served frames (the
  streaming decode in every tick);
- ``topk_gap``: over a sample of finished sampled requests drawn from the
  seed, the longest among them, how far each served token's logit lies
  below the reference's k-th best (k the request's top-k), 0 inside the
  reference's top k: a token the sampler may not draw.

``control`` computes, at the same positions, the gap of the token a
lower-precision reference puts first, and the PCM of a Mimi with fp8
weights: the readings a lower precision gives.
"""

from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np
import torch

from benchmark.harness import texts, weights
from benchmark.reference import logits as ref_logits
from benchmark.reference import mimi as ref_mimi

LOWER_BITS = {"int8": 4, "int4": 3, None: 8}
PCM_REQUESTS = 8  # finished requests whose PCM is decoded again
SAMPLED_REQUESTS = 48  # finished sampled requests whose tokens are checked
NUMBERS = ("logit_gap", "topk_gap", "pcm_err")


def _sample(requests: list, n: int, frames_of, rng: np.random.Generator) -> list:
    """The longest of ``requests`` and ``n`` − 1 others drawn by ``rng``."""
    if not requests:
        return []
    longest = max(requests, key=lambda r: frames_of(r).shape[0])
    rest = [r for r in requests if r is not longest]
    return [longest] + [rest[i] for i in rng.permutation(len(rest))[:n - 1]]


def _prompt(config, voices, r, device):
    tok, mask = texts.prompt_rows(config, voices[r.voice], r.text)
    return torch.from_numpy(tok).to(device), torch.from_numpy(mask).to(device)


def compare(family, config: dict, seed: int, device, voices, finished: list,
            rng: np.random.Generator, control: bool = False) -> dict:
    """The readings of the served requests ``finished``, against the
    reference of the model ``family`` → a dict of numbers (and the
    controls' with ``control``)."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K = config["audio_num_codebooks"]
    out = {"compared_tokens": 0, "compared_requests": 0, "sampled_tokens": 0,
           "sampled_requests": 0, "pcm_requests": 0}

    def frames_of(r):
        return r.frames(K)

    sampled = _sample([r for r in finished if not r.greedy], SAMPLED_REQUESTS, frames_of, rng)
    with torch.no_grad():
        params = family.draw(config, seed, device)
        model = family.reference(params, config)
        lower = family.reference(params, config, bits=LOWER_BITS[config.get("quantize")]) \
            if control else None
        gaps, ctrl = [], []
        for r in finished:
            if not r.greedy:
                continue
            frames = torch.from_numpy(r.frames(K)).to(device)
            if frames.shape[0] == 0:
                continue
            prompt = _prompt(config, voices, r, device)
            logits = model.frame_logits(prompt, frames)
            gaps.append(ref_logits.greedy_gaps(logits, frames))
            out["compared_tokens"] += frames.numel()
            out["compared_requests"] += 1
            if lower is not None:
                ctrl.append(ref_logits.argmax_gaps(logits, lower.frame_logits(prompt, frames)))
            del logits
        out["logit_gap"] = ref_logits.widest(gaps)
        if lower is not None:
            out["control_logit_gap"] = ref_logits.widest(ctrl)
        beyond = []
        for r in sampled:
            frames = torch.from_numpy(r.frames(K)).to(device)
            if frames.shape[0] == 0:
                continue
            logits = model.frame_logits(_prompt(config, voices, r, device), frames)
            beyond.append(ref_logits.topk_gaps(logits, frames, r.topk))
            out["sampled_tokens"] += frames.numel()
            out["sampled_requests"] += 1
            del logits
        out["topk_gap"] = ref_logits.widest(beyond) if beyond else 0.0
        del model, lower, params

        mparams = weights.draw_mimi(config, seed, device)
        m = config["mimi"]
        pick = _sample(finished, PCM_REQUESTS, frames_of, rng)
        errs, ctrl_errs = [], []
        fp8 = ref_mimi.round_weights(torch.float8_e4m3fn) if control else None
        for r in pick:
            frames = r.frames(K)
            got = r.audio()
            if frames.shape[0] == 0 or got.shape[0] != frames.shape[0] * hop(m):
                errs.append(math.inf)
                continue
            codes = torch.from_numpy(frames.T.copy()).to(device)
            want = ref_mimi.decode(mparams, m, codes)
            got_t = torch.from_numpy(got).to(device).float()
            errs.append(float((got_t - want).norm() / want.norm().clamp_min(1e-30)))
            if fp8 is not None:
                low = ref_mimi.decode(mparams, m, codes, fp8)
                ctrl_errs.append(float((low - want).norm() / want.norm().clamp_min(1e-30)))
        out["pcm_requests"] = len(pick)
        out["pcm_err"] = max(errs) if errs else float("nan")
        if fp8 is not None:
            out["control_pcm_err"] = max(ctrl_errs) if ctrl_errs else float("nan")
    out["reference_s"] = time.perf_counter() - t0
    return out


def hop(m: dict) -> int:
    """PCM samples a codec frame (1,920 at 24 kHz and 12.5 frames/s)."""
    hop = m["downsample_stride"]
    for r in m["seanet"]["ratios"]:
        hop *= r
    return hop


def verdict(readings: dict, limits: dict, min_tokens: int) -> Tuple[bool, List[str]]:
    """Each number against its limit → (correct, the lines that say so)."""
    lines, ok = [], True
    for name in NUMBERS:
        value, limit = readings.get(name), limits[name]
        good = value is not None and not math.isnan(value) and value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    enough = readings.get("compared_tokens", 0) >= min_tokens
    ok &= enough
    lines.append(f"check compared_tokens {readings.get('compared_tokens', 0)} limit >= "
                 f"{min_tokens} {'ok' if enough else 'FAILED'}")
    return ok, lines


def limits_line(readings: dict, limits: dict, min_tokens: int) -> dict:
    """The compared numbers beside their limits, for the result's line."""
    out = {name: {"value": readings.get(name), "limit": limits[name]} for name in NUMBERS}
    out["compared_tokens"] = {"value": readings.get("compared_tokens", 0), "limit": min_tokens}
    return out


def control_verdicts(readings: dict, limits: dict, min_tokens: int) -> dict:
    """Each control put in the program's place → whether the verdict
    calls it correct: the tokens a lower-precision reference puts first
    (``tokens``), the PCM of a Mimi with fp8 weights (``pcm``)."""
    out = {}
    for kind, swap in (("tokens", {"logit_gap": readings.get("control_logit_gap")}),
                       ("pcm", {"pcm_err": readings.get("control_pcm_err")})):
        if None not in swap.values():
            out[kind] = verdict(dict(readings, **swap), limits, min_tokens)[0]
    return out


def forbidden_modules(names=("jax", "jaxlib", "flax", "sesameai_tts_tpu")) -> List[str]:
    """Loaded modules whose top-level name is one of ``names``, compared
    whole (``sesameai_tts_tpu_torch`` is not ``sesameai_tts_tpu``)."""
    import sys

    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)

