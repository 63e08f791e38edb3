"""Watermark embed and verify (port of ``sesameai_tts_tpu/watermark/api.py``).

``watermark``: resample to the watermarker's 44.1 kHz, embed the 5-byte
key, resample back.  ``verify``: resample to 44.1 kHz, decode with the
phase-shift search, compare the message with the key.
``check_audio_from_file`` and ``cli_check_audio`` (the
``sesame-tts-torch-check-audio`` script) verify a WAV file.

The port has the DSP scheme of ``watermark/dsp.py`` only: it is the JAX
package's scheme, so either package verifies the other's marks.  The
learned silentcipher network (the JAX package's ``watermark/net.py``) is
not ported yet, so a silentcipher checkpoint raises instead of quietly
marking with another scheme.
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
                     ckpt_path: Optional[str] = None, device="cuda") -> Watermarker:
    """The DSP watermarker on ``device`` (the card unless the caller asks
    for the CPU).  A silentcipher checkpoint (``ckpt_path``, or
    ``SILENTCIPHER_CKPT`` set) raises ``NotImplementedError``: that network
    is not ported, and marking with the DSP scheme instead would give
    audio that silentcipher does not verify."""
    ckpt_path = ckpt_path or os.environ.get("SILENTCIPHER_CKPT")
    if ckpt_path:
        raise NotImplementedError(
            f"silentcipher checkpoint {ckpt_path!r}: the learned watermark network "
            f"(watermark/net.py of the JAX package) is not ported to PyTorch yet (ROADMAP "
            f"A12, 'silentcipher watermark'); unset SILENTCIPHER_CKPT to use the DSP scheme"
        )
    return _load_dsp(verify_threshold, blind_threshold, device=device)


def watermark(watermarker, audio: np.ndarray, sample_rate: int, watermark_key: List[int],
              message_sdr: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Embed ``watermark_key`` → (marked audio, its sample rate: the lower
    of the input's and the watermarker's).  The strength defaults to the
    watermarker's calibration (30 dB below the signal for the DSP scheme)."""
    if message_sdr is None:
        message_sdr = getattr(watermarker, "default_message_sdr", 30.0)
    audio_wm = resample(audio, sample_rate, WATERMARK_RATE)
    encoded, _ = watermarker.encode_wav(audio_wm, WATERMARK_RATE, watermark_key,
                                        calc_sdr=False, message_sdr=message_sdr)
    output_sample_rate = min(WATERMARK_RATE, sample_rate)
    return resample(encoded, WATERMARK_RATE, output_sample_rate), output_sample_rate


def verify(watermarker, watermarked_audio: np.ndarray, sample_rate: int,
           watermark_key: List[int]) -> bool:
    """True when the audio carries ``watermark_key``."""
    audio_wm = resample(watermarked_audio, sample_rate, WATERMARK_RATE)
    result = watermarker.decode_wav(audio_wm, WATERMARK_RATE, phase_shift_decoding=True,
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
