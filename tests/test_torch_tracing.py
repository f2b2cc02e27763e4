"""The port's process tracer (ceph_tpu_torch.common.tracing) and the spans
and seam-step counters of its codec path, on the CPU.

Off, a plugin=cuda encode and degraded decode record nothing and their
chunks equal jerasure's.  On, each codec call is one root span with its
steps nested under it, all in its trace.  The ring drains, counts what it
dropped, stamps on time.time_ns() and keeps threads apart.  The seam's
h2d / launch / d2h counters sit inside its apply averages."""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.common.tracing import PROCESS, Tracer, span
from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF, CudaPlugin
from tests.test_codecs import make, payload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUCHY = dict(technique="cauchy_good", k=10, m=4, w=8, packetsize=2048)
RS = dict(technique="reed_sol_van", k=8, m=3, w=8)
#: each call's spans: name -> the name of its parent ("" for the root);
#: gf2.sched_compile appears under the launch on a schedule LRU miss
ENCODE_TREE = {"ec.encode": "", "ec.encode_prepare": "ec.encode",
               "ec.to_rows": "ec.encode", "ec_plugin.apply_rows": "ec.encode",
               "ec_plugin.h2d": "ec_plugin.apply_rows",
               "ec_plugin.launch": "ec_plugin.apply_rows",
               "ec_plugin.d2h": "ec_plugin.apply_rows",
               "ec.from_rows": "ec.encode"}
DECODE_TREE = {"ec.decode": "", "ec.decode_select": "ec.decode",
               "ec.stack_survivors": "ec.decode",
               "ec_plugin.apply": "ec.decode",
               "ec_plugin.h2d": "ec_plugin.apply",
               "ec_plugin.launch": "ec_plugin.apply",
               "ec_plugin.d2h": "ec_plugin.apply"}


def cuda_codec(profile):
    return CudaPlugin().factory(
        {"plugin": "cuda", **{k: str(v) for k, v in profile.items()}},
        device="cpu")


def jerasure_chunks(profile, data):
    ref = make("jerasure", **profile)
    return ref.encode(set(range(ref.get_chunk_count())), data)


@pytest.fixture
def tracer():
    """The process tracer on, and off again after the test."""
    PROCESS.enable()
    yield PROCESS
    PROCESS.disable()
    PROCESS.drain()


def encode_call(profile, size):
    codec = cuda_codec(profile)
    data = payload(size, seed=11)
    return codec, data, lambda: codec.encode(
        set(range(codec.get_chunk_count())), data)


def degraded_call(profile, size, lost=(2,)):
    codec = cuda_codec(profile)
    data = payload(size, seed=12)
    n, k = codec.get_chunk_count(), codec.get_data_chunk_count()
    enc = codec.encode(set(range(n)), data)
    survivors = {c: enc[c] for c in range(n) if c not in lost}
    return codec, data, lambda: codec.decode(set(range(k)), survivors,
                                             len(enc[0]))


def test_tracer_off_records_nothing_and_chunks_match_jerasure():
    PROCESS.drain()
    codec, data, call = encode_call(CAUCHY, 655360)
    out = call()
    want = jerasure_chunks(CAUCHY, data)
    assert sorted(out) == sorted(want)
    for c in want:
        assert np.array_equal(out[c], want[c]), c
    codec, data, call = degraded_call(RS, 65536)
    out = call()
    want = jerasure_chunks(RS, data)
    assert sorted(out) == list(range(8))
    for c in out:
        assert np.array_equal(out[c], want[c]), c
    assert PROCESS.drain() == ([], 0)
    assert span("a") is span("b")  # off: the one shared no-op


@pytest.mark.parametrize("make_call,profile,size,tree", [
    (encode_call, CAUCHY, 655360, ENCODE_TREE),
    (degraded_call, RS, 65536, DECODE_TREE),
], ids=["cauchy-encode", "rs-degraded-decode"])
def test_each_call_is_one_root_with_its_steps_nested(tracer, make_call,
                                                     profile, size, tree):
    _, _, call = make_call(profile, size)
    tracer.drain()
    for _ in range(2):  # the first call may compile its schedule
        call()
    spans, dropped = tracer.drain()
    assert dropped == 0
    by_id = {s[3]: s for s in spans}
    roots = [s for s in spans if s[4] == 0]
    assert [r[0] for r in roots] == [n for n, p in tree.items() if not p] * 2
    for root in roots:
        mine = [s for s in spans if s[5] == root[3]]  # its trace
        names = sorted(s[0] for s in mine if s[0] != "gf2.sched_compile")
        assert names == sorted(tree)
        for name, start, end, sid, parent, trace, thread in mine:
            assert start <= end and trace == root[3]
            assert thread == root[6]
            if sid == root[3]:
                continue
            outer = by_id[parent]
            want = ("ec_plugin.launch" if name == "gf2.sched_compile"
                    else tree[name])
            assert outer[0] == want, name
            assert outer[1] <= start and end <= outer[2], name


def test_drain_empties_counts_overflow_and_stamps_on_time_ns():
    before = time.time_ns()
    PROCESS.enable(capacity=4)
    try:
        for i in range(10):
            with span(f"s{i}"):
                pass
    finally:
        PROCESS.disable()
    after = time.time_ns()
    spans, dropped = PROCESS.drain()
    assert [s[0] for s in spans] == ["s6", "s7", "s8", "s9"]
    assert dropped == 6
    assert all(before <= s[1] <= s[2] <= after for s in spans)
    assert PROCESS.drain() == ([], 0)
    assert tracing.CAPACITY >= 1 << 20  # a traced window's ~0.4 M spans


def test_threads_keep_their_own_nesting(tracer):
    """More threads than cores, a short switch interval: every span's parent
    is the span its own thread opened around it, in one trace."""
    threads, depth, rounds = 16, 3, 50
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(rounds):
            with span("t0"):
                with span("t1"):
                    with span("t2"):
                        pass

    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans, dropped = tracer.drain()
    assert dropped == 0 and len(spans) == threads * depth * rounds
    by_id = {s[3]: s for s in spans}
    for name, _, _, sid, parent, trace, thread in spans:
        if name == "t0":
            assert parent == 0 and trace == sid
        else:
            outer = by_id[parent]
            assert outer[0] == f"t{int(name[1]) - 1}"
            assert outer[6] == thread and outer[5] == trace


def test_seam_step_counters_sit_inside_the_seam(monkeypatch):
    """On the card path (the card stood in for by the host), every dispatch
    times its h2d, launch and d2h steps, and their sums stay at or under
    the seam's apply averages; the chunks still equal jerasure's."""
    steps = ("h2d_s", "launch_s", "d2h_s", "apply_s", "apply_rows_s")
    before = {n: PLUGIN_PERF.get(n) for n in steps}  # (count, seconds)
    results = []
    for make_call, profile, size in ((encode_call, CAUCHY, 655360),
                                     (degraded_call, RS, 65536)):
        codec, data, call = make_call(profile, size)
        monkeypatch.setattr(codec, "device", types.SimpleNamespace(type="card"))
        monkeypatch.setattr(codec, "_to_device", lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint8)))
        results.append((profile, data, call()))
    delta = {n: [a - b for a, b in zip(PLUGIN_PERF.get(n), before[n])]
             for n in steps}
    assert delta["apply_rows_s"][0] >= 1 and delta["apply_s"][0] >= 1
    dispatches = delta["apply_s"][0] + delta["apply_rows_s"][0]
    for n in ("h2d_s", "launch_s", "d2h_s"):
        assert delta[n][0] == dispatches, n
    parts = sum(delta[n][1] for n in ("h2d_s", "launch_s", "d2h_s"))
    assert 0 < parts <= delta["apply_s"][1] + delta["apply_rows_s"][1]
    for profile, data, out in results:
        want = jerasure_chunks(profile, data)
        for c in out:
            assert np.array_equal(out[c], want[c]), (profile, c)


def test_daemon_spans_dump_seconds_on_the_same_clock():
    t = Tracer(max_spans=4)
    before = time.time()
    with t.new_trace("op") as sp:
        sp.child("sub").finish()
    after = time.time()
    dumped = t.dump()
    assert [d["name"] for d in dumped] == ["sub", "op"]
    for d in dumped:
        assert before - 1e-3 <= d["start"] <= after + 1e-3
        assert 0 <= d["duration"] <= after - before + 1e-3
        assert isinstance(d["span_id"], str) and len(d["span_id"]) == 16


def test_common_tracing_imports_no_torch():
    probe = ("import sys\n"
             "import ceph_tpu_torch.common.tracing as t\n"
             "with t.span('x'):\n"
             "    pass\n"
             "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
