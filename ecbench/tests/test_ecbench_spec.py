"""BENCHMARK.json against the contract's shape, and every name found by
its file: cells, configurations, mixes, kinds, references, metrics."""

import json
import os
import re
import shutil

import pytest

from ecbench import spec
from ecbench.tests.helpers import BENCH, CELLS, ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ecbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("ecbench/")
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    e2e = spec.load_cell(ROOT, cell, trace=False)
    layer = spec.load_cell(ROOT, cell, trace=True)
    reported = {m["name"] for m in e2e.metrics}
    assert "setup_s" in reported and len(reported) >= 2
    assert layer.metrics
    for m in layer.metrics:  # each moves a metric this cell reports
        assert m["moves"] in reported
    assert spec.readers(e2e.metrics) and spec.readers(layer.metrics)
    spec.load_module("kinds", e2e.mix["op"])
    spec.load_module("references", e2e.config["reference"])
    assert e2e.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)


def test_no_cell_name_in_the_harness_code():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for folder in ("", "kinds", "metrics", "references"):
        for name in os.listdir(os.path.join(here, folder)):
            if name.endswith(".py"):
                text = open(os.path.join(here, folder, name)).read()
                for cell in CELLS:
                    assert cell not in text, (name, cell)


def test_added_config_mix_and_metric_are_found(tmp_path):
    """A configuration, a traffic mix and a metric added as new files and
    entries in a copy, editing no file that is there, run as a cell."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "ecbench"), root / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.load(open(os.path.join(ROOT, "ecbench/configs/rs-k8m3.json")))
    config.update(name="rs-k6m2", profile=dict(config["profile"], k="6",
                                               m="2"))
    (root / "ecbench/configs/rs-k6m2.json").write_text(json.dumps(config))
    mix = json.load(open(os.path.join(ROOT, "ecbench/traffic/encode.json")))
    mix.update(callers=2)
    (root / "ecbench/traffic/encode-2.json").write_text(json.dumps(mix))
    (root / "ecbench/metrics/op_p50_ms.py").write_text(
        "from ecbench import readers\n\n\ndef read(run):\n"
        "    return readers.percentile_ms(run, 50)\n")
    bench["configs"].append({"name": "rs-k6m2", "source": "test",
                             "file": "ecbench/configs/rs-k6m2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "rs-k6m2.encode-2",
                               "config": "rs-k6m2", "traffic": "encode-2",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_GBps":
            m["workloads"].append("rs-k6m2.encode-2")
    bench["per_layer"].append({"name": "op_p50_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "codec entry", "moves": "encode_GBps",
                               "workloads": ["rs-k6m2.encode-2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "ecbench").rglob("*")
              if p.is_file() and p.suffix in (".py", ".json")}
    r = run_small("rs-k6m2.encode-2", root=str(root))
    assert r["correct"] and set(r["metrics"]) == {"encode_GBps", "setup_s"}
    r = run_small("rs-k6m2.encode-2", root=str(root), trace=True)
    assert r["correct"] and "op_p50_ms" in r["metrics"]
    for p, data in before.items():  # nothing that was there was edited
        if p.name not in ("rs-k6m2.json", "encode-2.json", "op_p50_ms.py"):
            assert p.read_bytes() == data, p
