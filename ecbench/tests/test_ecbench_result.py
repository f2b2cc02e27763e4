"""The result line: its keys, the cell's metrics, the check's numbers last;
the run's exits where there is no card or no program."""

import os
import shutil
import subprocess
import sys

import pytest

from ecbench import spec
from ecbench.tests.helpers import CELLS, ROOT, run_small


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    r = run_small(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(r) == keys + ["checks"]  # the compared numbers come last
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    expected = {m["name"] for m in spec.load_cell(ROOT, cell, trace).metrics}
    if not trace:  # every end-to-end metric; per-layer ones where readable
        assert set(r["metrics"]) == expected
    else:
        assert set(r["metrics"]) <= expected
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert {"bad_bytes", "bad_answers", "failed_ops"} == set(r["checks"])
    for c in r["checks"].values():
        assert c == {"value": 0, "limit": 0}


def test_same_seed_same_objects():
    from ecbench.harness import make_objects

    a = make_objects(2**31 + 99, 3, 4096)
    b = make_objects(2**31 + 99, 3, 4096)
    c = make_objects(2**31 + 100, 3, 4096)
    assert [bytes(x) for x in a] == [bytes(x) for x in b]
    assert bytes(a[0]) != bytes(c[0]) and bytes(a[0]) != bytes(a[1])


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(ROOT)
    assert p.returncode == 3 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_paths_alone_exit_without_a_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "ecbench"), tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = _run(str(tmp_path), env=env)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, tmp_path):
    """A short run of the cell on the card, as the command line runs it."""
    import json
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
