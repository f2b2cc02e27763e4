"""The program's own spans and seam-step counters over a traced window
(program_trace.py and the readers that name it): read on the program, left
out without its process tracer, and the stall line."""

import types

import numpy as np
import pytest

from ecbench import program_trace, spec
from ecbench.tests.helpers import CELLS, ROOT, run_small

#: the readers of the program's spans and seam-step counters
NEW = {"prepare_ms.encode", "relayout_ms.encode", "select_ms.decode",
       "stack_ms.decode", "seam_h2d_ms.encode", "seam_h2d_ms.decode",
       "seam_d2h_ms.encode", "seam_d2h_ms.decode"}


def card_path_codec(config, device):
    """The cell's codec on the CPU, taking the seam's card path: the card
    stood in for by the host, so the seam times its steps."""
    import torch
    from ceph_tpu_torch.ec.registry import registry

    codec = registry.factory(config["plugin"], "", config["profile"],
                             device=device)
    codec.device = types.SimpleNamespace(type="card")
    codec._to_device = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint8))
    return codec


def new_metrics(cell):
    return {m["name"] for m in spec.load_cell(ROOT, cell, True).metrics} & NEW


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_the_program(cell, capsys):
    r = run_small(cell, trace=True, make_codec=card_path_codec)
    assert r["correct"]
    assert len(new_metrics(cell)) == 4
    assert new_metrics(cell) <= set(r["metrics"])
    for name in new_metrics(cell):
        assert r["metrics"][name]["value"] > 0, name
    err = capsys.readouterr().err
    assert ", 0 dropped" in err and "placement check:" in err
    assert "stalls:" in err


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_process_tracer_the_run_leaves_its_spans_out(
        cell, monkeypatch):
    from ceph_tpu_torch.common import tracing

    with_it = run_small(cell, trace=True, make_codec=card_path_codec)
    monkeypatch.delattr(tracing, "PROCESS")
    without = run_small(cell, trace=True, make_codec=card_path_codec)
    assert without["correct"]
    spans = {n for n in NEW if not n.startswith("seam_")}
    assert set(without["metrics"]) == set(with_it["metrics"]) - spans
    assert program_trace.WINDOW.spans == {}


@pytest.mark.parametrize("name", sorted(n for n in NEW
                                        if n.startswith("seam_")))
def test_step_readers_need_the_step_counters(name):
    reader = spec.load_module("metrics", name)
    family = name.rsplit(".", 1)[1]
    step = name.split("_")[1] + "_s"
    seam = {"apply_s": {"avgcount": 4, "sum": 0.01}}
    run = types.SimpleNamespace(family=family, counters={"ec_plugin": seam})
    assert reader.read(run) is None  # a seam without steps, as before them
    seam[step] = {"avgcount": 4, "sum": 0.002}
    assert reader.read(run) == pytest.approx(0.5)
    run.family = "decode" if family == "encode" else "encode"
    assert reader.read(run) is None


def _spans(per_second, slow_at, grows):
    """A root an op at `per_second` ops a second, a quarter of that in the
    second `slow_at`, where its child `grows` takes 40 times as long."""
    spans = {"ec.encode": [], "ec.encode_prepare": [], grows: []}
    for s in range(6):
        n = per_second // 4 if s == slow_at else per_second
        step = 1_000_000_000 // n
        for i in range(n):
            a = s * 1_000_000_000 + i * step
            spans["ec.encode"].append((a, a + step - 1))
            spans["ec.encode_prepare"].append((a, a + step // 10))
            d = step // 2 if s == slow_at else step // 20
            spans[grows].append((a + step // 10, a + step // 10 + d))
    return spans


def test_stalls_name_the_span_that_grew():
    line = program_trace.stalls(_spans(100, 3, "ec_plugin.h2d"))
    assert line.startswith("seconds [3] of 5 under half the median")
    assert "other seconds: ec.encode 39.999999 against 9.999999" in line
    assert line.split("below it ")[1].startswith("ec_plugin.h2d 20.0 against")
    line = program_trace.stalls(_spans(100, None, "ec_plugin.h2d"))
    assert line.startswith("none: every second")
    assert program_trace.stalls({}) == "no codec calls"


@pytest.mark.parametrize("name", [m["name"] for m in spec._json(
    f"{ROOT}/BENCHMARK.json")["end_to_end"]])
def test_no_end_to_end_reader_turns_the_tracer_on(name):
    reader = spec.load_module("metrics", name)
    assert program_trace.SET not in getattr(reader, "COUNTERS", ())


def test_the_window_is_dumped_in_turns():
    from ceph_tpu_torch.common import tracing

    window = program_trace._Window()
    window.dump()
    try:
        with pytest.raises(RuntimeError, match="already on"):
            program_trace._Window().dump()
        tracing.PROCESS.disable()
        with pytest.raises(RuntimeError, match="tracer off"):
            window.dump()
    finally:
        tracing.PROCESS.disable()
        tracing.PROCESS.drain()
    assert not tracing.PROCESS.enabled
