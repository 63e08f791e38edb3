"""On the card: the control at a cell's own size.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
def test_int4_trunks_under_the_int8_cell_are_not_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload",
                          "int8-chat-poisson", "--seeds", "4000000001", "--seconds", "20",
                          "--program-lower"], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["program"] == "int4" and line["correct"] is False
