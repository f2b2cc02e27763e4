"""The port's cluster gates, first half: ``python -m
ceph_tpu_torch.tools.non_regression --<gate> --device cpu`` at each gate's
default seconds, as a process of its own (the gates set process-wide
switches), must exit 0 as the reference's does.  The gates' own counts
(sheds, promotions, kills) depend on timing, so only the exit code and the
gate's byte-identity checks are held.  The other half is in
test_torch_gates_b.py, so that neither file runs past a minute."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_gate(gate):
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.non_regression",
         f"--{gate}", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_device_parity_engages_the_device_arm_in_one_child_only():
    out = run_gate("device-parity")
    children = {}
    for line in out.splitlines():
        for arm in ("device", "host"):
            prefix = f"device parity {arm} child: "
            if line.startswith(prefix):
                children[arm] = json.loads(line[len(prefix):])
    assert children["device"]["device_arm"] == 1
    assert (children["device"]["device_installs"]
            + children["device"]["h2d_installs"]) > 0
    assert children["host"]["device_arm"] == 0
    assert "writeback objects byte-identical across slab arms" in out


SUMMARIES = {
    "wire-floor": "byte-identical across multi-lane (4) and single-lane",
    "qos": ", 0 failures",
    "tier": ", 0 failures",
}


@pytest.mark.parametrize("gate", list(SUMMARIES))
def test_gate_passes(gate):
    assert SUMMARIES[gate] in run_gate(gate)
