"""Quantization acceptance QA: the gate that decides whether a quantized
tree may serve (port of ``sesameai_tts_tpu/runtime/qa.py``).

Two measurements:

* **weight SNR** (:func:`trunk_weight_snr`): the int8 quantizer's own
  dequantization error over every trunk matrix of a dense tree (gate: min
  ≥ 35 dB; random and trained weights both measure ~40 dB).
* **teacher-forced agreement** (:func:`teacher_forced_agreement`): both
  generators replay the same fixed trajectory
  (``models/csm.py::teacher_forced_eval``) and their per-step greedy
  frames and codebook-0 logits are compared.  It catches everything
  downstream of the weights: kernel faults, scale mix-ups.  Free-running
  streams are chaotic on random weights, so the number that transfers is
  the logit SNR (gate: ≥ 20 dB); the code match rate is informative only
  on trained weights, whose argmax margins are decisive.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.ops.quant import _TRUNK_QUANT_KEYS, quantize_weight

# documented gates: below either, serve bf16
MIN_WEIGHT_SNR_DB = 35.0
MIN_LOGIT_SNR_DB = 20.0


def trunk_weight_snr(dense_params: dict) -> Tuple[float, float]:
    """(min_db, median_db) of the int8 quantizer's dequantization error
    over every trunk matrix of a dense (unquantized) CSM tree, in f32."""
    snrs = []
    for trunk in ("backbone", "decoder"):
        for wl in dense_params[trunk]["layers"]:
            for k in _TRUNK_QUANT_KEYS:
                if k in wl and not isinstance(wl[k], dict):
                    wf = wl[k].float()
                    qw = quantize_weight(wf)
                    err = qw["q"].float() * qw["scale"][..., None, :] - wf
                    snr = 10.0 * torch.log10(
                        (wf * wf).sum() / torch.clamp_min((err * err).sum(), 1e-20))
                    snrs.append(float(snr))
    if not snrs:
        raise ValueError("no dense trunk matrices found (already quantized?)")
    return float(min(snrs)), float(np.median(snrs))


def teacher_forced_agreement(gen_q, gen_ref, text: str, steps: int = 100,
                             speaker: int = 1) -> dict:
    """Replay one fixed trajectory through both generators' trees and
    compare their per-step predictions under identical history.

    The teacher trajectory is ``gen_q``'s own greedy stream; trajectories
    shorter than ``steps`` (early EOS) are evaluated over the real prefix.

    Returns ``code_match`` / ``frame_match`` (per-code / whole-frame greedy
    agreement), ``logit_snr_db`` (median per-step codebook-0 logit SNR),
    ``self_consistency`` (``gen_q``'s forced predictions reproduce its own
    free-run trajectory: a canary that the teacher-forced program matches
    the decode) and ``steps`` evaluated.
    """
    cfg = gen_q._cfg
    K = cfg.audio_num_codebooks
    traj = gen_q.generate_frames(text, speaker, [], max_audio_length_ms=(steps + 2) * 80.0,
                                 temperature=1.0, topk=1, seed=0)
    if len(traj) < 2:
        raise ValueError(f"teacher trajectory too short ({len(traj)} frames): "
                         "use a longer text or raise max length")
    n_real = min(steps, len(traj) - 1)
    teacher = np.zeros((steps, 1, K), np.int64)
    teacher[: min(steps, len(traj)), 0] = traj[:steps]

    def _tf(gen):
        # greedy (topk=1) draws no noise: the seed only names the generator
        with gen._request():
            gen._prefill_utterance(text, speaker, [], None, steps + 2, 1.0, 1, seed=0)
            frames, logits = csm_model.teacher_forced_eval(
                gen._params, cfg, gen._slot(1).state, torch.from_numpy(teacher).to(gen.device),
                rope_cs=gen._rope, fused_mlp=gen._fused_mlp)
        return (frames[:n_real, 0].cpu().numpy(),
                logits[:n_real, 0].float().cpu().numpy())

    fr_q, lg_q = _tf(gen_q)
    fr_r, lg_r = _tf(gen_ref)
    err = lg_q - lg_r
    snr_steps = 10.0 * np.log10(np.sum(lg_r * lg_r, axis=1)
                                / np.maximum(np.sum(err * err, axis=1), 1e-20))
    return {
        "code_match": float((fr_q == fr_r).mean()),
        "frame_match": float((fr_q == fr_r).all(axis=1).mean()),
        "logit_snr_db": float(np.median(snr_steps)),
        "self_consistency": float((fr_q == traj[1: n_real + 1]).mean()),
        "steps": int(n_real),
    }


def quant_acceptance(gen_q, gen_ref, text: str, steps: int = 100,
                     min_weight_snr_db: float = MIN_WEIGHT_SNR_DB,
                     min_logit_snr_db: float = MIN_LOGIT_SNR_DB, speaker: int = 1) -> dict:
    """The executable gate: weight SNR from the dense twin's params plus
    teacher-forced agreement between the twins; ``passed`` says whether the
    quantized tree may serve."""
    w_min, w_med = trunk_weight_snr(gen_ref._params)
    tf = teacher_forced_agreement(gen_q, gen_ref, text, steps, speaker)
    rep = {
        "weight_snr_min_db": round(w_min, 1),
        "weight_snr_median_db": round(w_med, 1),
        **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in tf.items()},
        "gate_weight_snr_db": min_weight_snr_db,
        "gate_logit_snr_db": min_logit_snr_db,
    }
    rep["passed"] = bool(w_min >= min_weight_snr_db and tf["logit_snr_db"] >= min_logit_snr_db)
    return rep
