"""The port's cluster gates, second half (see test_torch_gates_a.py): each
``python -m ceph_tpu_torch.tools.non_regression --<gate> --device cpu``
process exits 0 at the gate's default seconds and prints its summary."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


SUMMARIES = {
    "chaos": " 0 failures",
    "slow-ops": "slow-ops cleared after recovery",
    "crash": ", 0 failures",
    "full": "leg backfillfull done",
    "rebalance": "leg backfillfull-park done",
    "lifecycle": "arc complete",
}


@pytest.mark.parametrize("gate", list(SUMMARIES))
def test_gate_passes(gate):
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.non_regression",
         f"--{gate}", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert SUMMARIES[gate] in proc.stdout
