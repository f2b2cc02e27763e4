"""Small cells on the CPU for the benchmark's tests."""

import io
import json
import os
import time

from ecbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
#: the cells of BENCHMARK.json, by name
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_sizes(workload: str) -> dict:
    """Sizes a CPU test can hold: 8 objects of one alignment unit."""
    return {"object_size": 655360 if workload.startswith("cauchy") else 65536,
            "objects": 8}


def run_small(workload: str, seed: int = 2**31 + 7, trace: bool = False,
              root: str = ROOT, make_codec=None, seconds: float = 0.5,
              sizes: dict = None) -> dict:
    """One run of a cell on the CPU at small sizes; its result object."""
    return harness.run_cell(
        workload, seed, seconds, trace, t_start=time.perf_counter(),
        root=root, device="cpu", sizes=sizes or small_sizes(workload),
        make_codec=make_codec, err=io.StringIO())
