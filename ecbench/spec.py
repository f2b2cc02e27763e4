"""Finding a cell's files by name.

``BENCHMARK.json`` names every cell, configuration and metric; each of them
is a file of its own under this folder:

    configs/<config>.json        the configuration (the entry's ``file``)
    traffic/<traffic>.json       the traffic mix's parameters
    kinds/<op>.py                the operation a mix's ``op`` names
    references/<reference>.py    the plain reference a configuration names
    metrics/<metric>.py          the reader of one metric

No cell's name appears in the code: adding a cell, a configuration, a mix or
a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

#: the checkout this folder sits in
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpecError(Exception):
    """A cell, file or entry that the benchmark cannot find or read."""


def load_module(folder: str, name: str, root: str = ROOT) -> ModuleType:
    """<root>/ecbench/<folder>/<name>.py as a module (names may hold
    dots)."""
    path = os.path.join(root, "ecbench", folder, f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no ecbench/{folder}/{name}.py under {root}")
    spec = importlib.util.spec_from_file_location(
        f"ecbench.{folder}.{name.replace('.', '__').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing {path}") from e


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict  # the configuration's file
    mix: dict  # the traffic mix's file
    metrics: List[dict]  # entries of end_to_end (trace 0) or per_layer (1)


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether `metric` is read in `cell`: listed there, or, without a
    ``workloads`` key, wherever its end-to-end metric is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(root: str, workload: str, trace: bool) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    mix = _json(os.path.join(root, "ecbench", "traffic",
                             f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    metrics = e2e if not trace else [
        m for m in bench["per_layer"] if applies(m, workload, reported)]
    return Cell(workload, int(entry["chips"]), config, mix, metrics)


def readers(metrics: List[dict], root: str = ROOT) -> Dict[str, ModuleType]:
    """metric name -> its reader module (metrics/<name>.py)."""
    return {m["name"]: load_module("metrics", m["name"], root)
            for m in metrics}
