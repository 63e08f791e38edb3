"""Watermark embed and verify (port of ``sesameai_tts_tpu/watermark/api.py``).

``watermark``: resample to the watermarker's rate, embed the 5-byte key,
resample back.  ``verify``: resample to that rate, decode with the
phase-shift search, compare the message with the key.
``check_audio_from_file`` and ``cli_check_audio`` (the
``sesame-tts-torch-check-audio`` script) verify a WAV file.

Two backends behind one API:

* **net** (``watermark/net.py``): the silentcipher 44.1 kHz encoder and
  decoder network and its checkpoint converter, chosen when
  ``load_watermarker(ckpt_path=...)`` or ``SILENTCIPHER_CKPT`` names a
  silentcipher checkpoint.  With the published weights this is the
  reference's provenance scheme.
* **dsp** (``watermark/dsp.py``): the self-verifying STFT spread-spectrum
  watermark, the default without a checkpoint.  It is the JAX package's
  scheme, so either package verifies the other's marks; it is not
  silentcipher-compatible.

``watermark`` and ``verify`` resample to the backend's own rate
(``watermarker.cfg.sample_rate`` for the network, whose checkpoint may
carry another rate than 44.1 kHz).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from sesameai_tts_tpu_torch.audio.io import read_wav_mono
from sesameai_tts_tpu_torch.audio.resample import resample
from sesameai_tts_tpu_torch.watermark.dsp import (  # noqa: F401  (re-exported)
    CSM_1B_GH_WATERMARK,
    CSM_1B_WATERMARK,
    WATERMARK_RATE,
    Watermarker,
)
from sesameai_tts_tpu_torch.watermark.dsp import load_watermarker as _load_dsp


def load_watermarker(verify_threshold: float = None, blind_threshold: float = None,
                     ckpt_path: Optional[str] = None, hparams: Optional[dict] = None,
                     device="cuda"):
    """The watermarker on ``device`` (the card unless the caller asks for the
    CPU): the silentcipher network when ``ckpt_path`` or
    ``SILENTCIPHER_CKPT`` names its checkpoint (a torch file or the port's
    converted form; ``hparams`` override its grid), else the DSP scheme.
    Both offer ``encode_wav`` / ``decode_wav`` as the reference calls them."""
    ckpt_path = ckpt_path or os.environ.get("SILENTCIPHER_CKPT")
    if ckpt_path:
        from sesameai_tts_tpu_torch.watermark.net import load_silentcipher_checkpoint

        return load_silentcipher_checkpoint(ckpt_path, hparams, device=device)
    return _load_dsp(verify_threshold, blind_threshold, device=device)


def _rate(watermarker) -> int:
    """The backend's operating rate: 44.1 kHz for the DSP scheme and the
    published silentcipher model; a converted checkpoint may carry another
    (silentcipher also ships a 16 kHz model)."""
    return getattr(getattr(watermarker, "cfg", None), "sample_rate", WATERMARK_RATE)


def watermark(watermarker, audio: np.ndarray, sample_rate: int, watermark_key: List[int],
              message_sdr: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Embed ``watermark_key`` → (marked audio, its sample rate: the lower
    of the input's and the watermarker's).  The strength defaults to the
    watermarker's calibration (30 dB below the signal for the DSP scheme,
    the reference's 36 dB for the network)."""
    if message_sdr is None:
        message_sdr = getattr(watermarker, "default_message_sdr", 30.0)
    wm_rate = _rate(watermarker)
    audio_wm = resample(audio, sample_rate, wm_rate)
    encoded, _ = watermarker.encode_wav(audio_wm, wm_rate, watermark_key,
                                        calc_sdr=False, message_sdr=message_sdr)
    output_sample_rate = min(wm_rate, sample_rate)
    return resample(encoded, wm_rate, output_sample_rate), output_sample_rate


def verify(watermarker, watermarked_audio: np.ndarray, sample_rate: int,
           watermark_key: List[int]) -> bool:
    """True when the audio carries ``watermark_key``."""
    wm_rate = _rate(watermarker)
    audio_wm = resample(watermarked_audio, sample_rate, wm_rate)
    result = watermarker.decode_wav(audio_wm, wm_rate, phase_shift_decoding=True,
                                    expected_message=watermark_key)
    return bool(result["status"] and result["messages"][0] == watermark_key)


def check_audio_from_file(audio_path: str, device="cuda") -> bool:
    watermarker = load_watermarker(device=device)
    audio, sample_rate = read_wav_mono(audio_path)
    is_watermarked = verify(watermarker, audio, sample_rate, CSM_1B_WATERMARK)
    print(f"{'Watermarked' if is_watermarked else 'Not watermarked'}: {audio_path}")
    return is_watermarked


def cli_check_audio(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Check a WAV file for the CSM watermark")
    parser.add_argument("--audio_path", type=str, required=True)
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="Device to verify on (cuda or cpu)")
    args = parser.parse_args(argv)
    check_audio_from_file(args.audio_path, device=args.device)


if __name__ == "__main__":
    cli_check_audio()
