"""``sesame-tts-torch-smoke`` (``service/smoke.py``), as
``tests/test_service.py`` holds the JAX package's: the tiny flavor runs every
check on the CPU, its random-weights codec check fails as it must and sets
the exit code; the real-weights rehearsal (``sesame-tts-torch-fixtures`` →
``sesame-tts-torch-smoke --weights-dir``) passes every check in a
subprocess, the watermark through the silentcipher network, offline and
streamed; the default device is the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.service import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_cli_test_tiny_flavor(capsys, monkeypatch):
    """Random tiny weights: every check runs, each pipeline check passes and
    the codec gate fails (random weights cannot reconstruct audio), so a
    real-weights failure is detected, not skipped.

    The watermark check tiles the tiny model's ~0.15 s of random-weights
    audio to 9 s; whether the DSP scheme verifies on such a carrier depends
    on the carrier (the port's sampled audio is not the JAX package's).  So
    the check is held to the JAX package on the same carrier: the same
    marked audio, the same verdict, and the check's line says that verdict."""
    from sesameai_tts_tpu.watermark import api as j_api
    from sesameai_tts_tpu_torch.watermark import api

    seen = {}
    watermark, verify = api.watermark, api.verify

    def watermark_seen(wm, audio, rate, key, *a, **kw):
        seen["carrier"], seen["rate"] = np.array(audio), rate
        seen["marked"], out_rate = watermark(wm, audio, rate, key, *a, **kw)
        return seen["marked"], out_rate

    def verify_seen(*a, **kw):
        seen.setdefault("verdicts", []).append(verify(*a, **kw))
        return seen["verdicts"][-1]

    monkeypatch.setattr(api, "watermark", watermark_seen)
    monkeypatch.setattr(api, "verify", verify_seen)
    rc = smoke.main(["--flavor", "test-tiny", "--device", "cpu", "--text", "Smoke self test."])
    out = capsys.readouterr().out
    for name in ("load", "generate", "greedy", "serve"):
        assert f"[PASS] {name}" in out, out
    assert "[FAIL] codec" in out  # random weights: the gate works
    assert "RTF median-of-3" in out
    assert rc == 1  # a failing check sets the exit code

    jwm = j_api.load_watermarker()
    jmarked, _ = j_api.watermark(jwm, seen["carrier"], seen["rate"], j_api.CSM_1B_WATERMARK)
    np.testing.assert_allclose(seen["marked"], jmarked,
                               atol=1e-4 * np.abs(seen["carrier"]).max())
    verdict = j_api.verify(jwm, jmarked, seen["rate"], j_api.CSM_1B_WATERMARK)
    assert seen["verdicts"] == [verdict]
    assert f"[{'PASS' if verdict else 'FAIL'}] watermark: Watermarker" in out


def test_dress_rehearsal_synthetic_weights(tmp_path):
    """The real-weights rehearsal as a user types it: the fixtures' tiny
    upstream-layout files, then convert → load → generate → codec →
    watermark → serve in one command; quality checks informational under
    the synthetic marker, every layout and pipeline check gated."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    wd = str(tmp_path / "weights")
    gen = subprocess.run(
        [sys.executable, "-m", "sesameai_tts_tpu_torch.service.fixtures", wd,
         "--flavor", "test-tiny"], env=env, capture_output=True, text=True, timeout=600)
    assert gen.returncode == 0, gen.stderr[-2000:]
    assert os.path.exists(os.path.join(wd, "csm-1b", "tokenizer.json"))
    run = subprocess.run(
        [sys.executable, "-m", "sesameai_tts_tpu_torch.service.smoke", "--weights-dir", wd,
         "--flavor", "test-tiny", "--device", "cpu", "--text", "Dress rehearsal."],
        env=env, capture_output=True, text=True, timeout=900)
    out = run.stdout
    assert run.returncode == 0, out[-2000:] + run.stderr[-2000:]
    assert "[PASS] convert" in out
    assert "tokenizer.json" in out  # found beside the checkpoint
    assert "[PASS] load" in out
    assert "[PASS] watermark: NetWatermarker" in out
    assert "[PASS] serve" in out and "watermarked: True" in out
    assert "stream through StreamingNetEmbedder" in out
    assert "[FAIL]" not in out
    assert os.path.exists(os.path.join(wd, "_converted", "silentcipher.safetensors.config.json"))


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.main(["--flavor", "test-tiny"])
