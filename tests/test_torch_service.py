"""The port's BatchingQueue against ceph_tpu's on the same seeded inputs.

Every lane runs through ceph_tpu.parallel.service.BatchingQueue on JAX's CPU
backend and through ceph_tpu_torch.parallel.service.BatchingQueue on
device="cpu" (the kernels' plain versions), with the reference's numpy
oracle `_cpu_apply_request` as a second opinion.  GF(2) is exact: every
comparison is byte for byte.  Then the queue's own mechanics: group submits,
split-phase launch/complete, flush causes, submit-time checks, and the
breaker, which fails a group with -EIO where the reference would serve it on
the host.
"""

import errno
import time

import numpy as np
import pytest
import torch

from ceph_tpu.ec.matrices import matrix_to_bitmatrix, vandermonde_coding_matrix
from ceph_tpu.parallel import service as ref
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.parallel import service
from ceph_tpu_torch.parallel.service import LANES, BatchingQueue

K, M = 4, 2
WIDTHS = (1024, 2048, 4096)  # byte columns of the three requests a lane gets
TIMEOUT = 60


def bitmatrix(w: int) -> np.ndarray:
    return matrix_to_bitmatrix(vandermonde_coding_matrix(K, M, w), w)


def lane_matrix(kind: str, w: int) -> np.ndarray:
    """The matrix as ecutil submits it: uint8 on the packed-bit lanes, int8
    on the int8-plane lanes."""
    return bitmatrix(w).astype(np.uint8 if kind.startswith("packedbit")
                               else np.int8)


def lane_inputs(kind: str, w: int, seed: int):
    """Three requests for `kind`: packed uint8 rows, int8 bit-planes
    (planar) or uint32 plane words (packedbit_planes)."""
    rng = np.random.default_rng(seed)
    data = [rng.integers(0, 256, (K, B), dtype=np.uint8) for B in WIDTHS]
    if kind == "planar":
        return [ref._np_unpack_bits(d, w) for d in data]
    if kind == "packedbit_planes":
        return [ref._np_words(ref._np_unpack_bits(d, 8)) for d in data]
    return data


def port_input(kind: str, x: np.ndarray):
    """What the port takes: plane lanes take tensors (plane words as int32
    carrying the uint32 bits); byte lanes take numpy."""
    if kind == "planar":
        return torch.from_numpy(x)
    if kind == "packedbit_planes":
        return torch.from_numpy(x.view(np.int32))
    return x


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    return np.asarray(x)


def assert_same(got, want, label: str) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        g, w = as_np(g), as_np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            f"{label}: {g.dtype}{g.shape} against {w.dtype}{w.shape}"
        assert np.array_equal(g, w), f"{label}: contents differ"


SUBMIT = {"packed": "submit", "planar": "submit_planar",
          "resident": "submit_resident", "packedbit": "submit_packedbit",
          "packedbit_resident": "submit_packedbit_resident",
          "packedbit_planes": "submit_packedbit_planes"}


@pytest.fixture
def queues():
    """Port queues made by the test, each closed at its end; none may leave
    its worker thread running."""
    made = []

    def make(**kw):
        q = BatchingQueue(device="cpu", **kw)
        made.append(q)
        return q

    yield make
    for q in made:
        q.close()
        assert not q._worker.is_alive(), "a queue thread outlived its test"


@pytest.fixture(scope="module")
def ref_queue():
    q = ref.BatchingQueue(max_delay=0.05, mesh=False)
    yield q
    q.close()


@pytest.fixture(scope="module")
def port_queue():
    q = BatchingQueue(device="cpu", max_delay=0.05)
    yield q
    q.close()
    assert not q._worker.is_alive()


@pytest.mark.parametrize("kind,w", [
    ("packed", 8), ("packed", 16), ("planar", 8), ("planar", 16),
    ("resident", 8), ("resident", 16), ("packedbit", 8),
    ("packedbit_resident", 8), ("packedbit_planes", 8)])
def test_lane_matches_reference(kind, w, ref_queue, port_queue):
    """Three requests of different widths on one lane, coalesced: each
    result equals the reference queue's and _cpu_apply_request's."""
    mb = lane_matrix(kind, w)
    inputs = lane_inputs(kind, w, seed=len(kind) * 100 + w)
    ref_futs = [getattr(ref_queue, SUBMIT[kind])(mb, x, w, M) for x in inputs]
    port_futs = [getattr(port_queue, SUBMIT[kind])(mb, port_input(kind, x),
                                                   w, M) for x in inputs]
    for i, (x, rf, pf) in enumerate(zip(inputs, ref_futs, port_futs)):
        want = ref._cpu_apply_request(kind, mb, x, w, M)
        got = pf.result(timeout=TIMEOUT)
        assert_same(got, want, f"{kind} w={w} request {i} vs oracle")
        assert_same(got, rf.result(timeout=TIMEOUT),
                    f"{kind} w={w} request {i} vs reference queue")
    d = port_queue.perf.dump()
    assert d[f"submit_{kind}"] >= 3 and d["breaker_fallback"] == 0


def test_counter_schema_is_the_references():
    """The `ec_cuda` set has the reference's `ec_tpu` names and kinds."""
    mine = service._build_ec_cuda_perf()
    theirs = ref._build_ec_tpu_perf()
    assert mine.name == "ec_cuda"
    assert ({n: s["type"] for n, s in mine.schema().items()}
            == {n: s["type"] for n, s in theirs.schema().items()})
    assert LANES == ref.LANES


def test_submit_group_matches_per_item_submits_and_coalesces(queues):
    mb = lane_matrix("packedbit", 8)
    bufs = lane_inputs("packedbit", 8, seed=11) * 2
    q = queues(max_delay=60.0)  # only the group's own wakeup cuts a round
    futs = q.submit_group([(mb, b, 8, M, "packedbit") for b in bufs])
    q.flush()
    group_out = [f.result(timeout=TIMEOUT) for f in futs]
    assert q.dispatches == 1, "a group submit must land in ONE dispatch"
    singles = []
    for b in bufs:
        f = q.submit_packedbit(mb, b, 8, M)
        q.flush()
        singles.append(f.result(timeout=TIMEOUT))
    for g, s, b in zip(group_out, singles, bufs):
        assert np.array_equal(g, s)
        assert np.array_equal(g, ref._cpu_apply_request("packedbit", mb, b,
                                                        8, M))
    d = q.perf.dump()
    assert d["submit_group"] == 1
    assert d["group_submit_size"]["count"] == 1
    assert d["group_submit_size"]["sum"] == float(len(bufs))
    assert d["submit_packedbit"] == 2 * len(bufs)
    assert d["group_size"]["sum"] == float(2 * len(bufs))


@pytest.mark.parametrize("kind", ["packed", "packedbit"])
def test_split_phase_launch_complete_is_byte_exact(kind, queues):
    """Both rounds launched before either completes (the double-buffered
    worker's order): round 2's staging must not disturb round 1's results."""
    from concurrent.futures import Future

    mb = lane_matrix(kind, 8)
    rng = np.random.default_rng(21)
    q = queues(max_delay=60.0)  # worker stays idle

    def group(widths):
        g = service._Group(mbits=mb, w=8, out_rows=M, kind=kind)
        datas, futs = [], []
        for B in widths:
            d = rng.integers(0, 256, (K, B), dtype=np.uint8)
            f = Future()
            g.requests.append(service._Request(d, f, time.monotonic(), None))
            datas.append(d)
            futs.append(f)
        return g, datas, futs

    g1, d1, f1 = group((1024, 1024, 1024))
    g2, d2, f2 = group((2048, 2048))
    l1 = q._launch_safe([g1])
    l2 = q._launch_safe([g2])
    assert all(not f.done() for f in f1 + f2)
    q._complete_safe(l1)
    q._complete_safe(l2)
    for d, f in zip(d1 + d2, f1 + f2):
        assert np.array_equal(f.result(timeout=5),
                              ref._cpu_apply_request(kind, mb, d, 8, M))


def test_backlog_holds_round_in_flight_and_overlaps(queues):
    mb = lane_matrix("packed", 8)
    rng = np.random.default_rng(22)
    q = queues(max_pending_bytes=1, max_delay=0.001)
    late = []

    def inject_backlog():
        # runs on the worker right after a round launches: queue the next
        # round so the backlog check holds the launched one in flight
        q._launch_hook = None  # once
        d = rng.integers(0, 256, (K, 2048), dtype=np.uint8)
        late.append((d, q.submit(mb, d, 8, M)))

    q._launch_hook = inject_backlog
    d0 = rng.integers(0, 256, (K, 1024), dtype=np.uint8)
    out0 = q.submit(mb, d0, 8, M).result(timeout=TIMEOUT)
    assert np.array_equal(out0, ref._cpu_apply_request("packed", mb, d0, 8, M))
    d1, f1 = late[0]
    assert np.array_equal(f1.result(timeout=TIMEOUT),
                          ref._cpu_apply_request("packed", mb, d1, 8, M))
    assert q.overlapped_rounds >= 1


@pytest.mark.parametrize("cause", ["bytes", "delay", "forced"])
def test_flush_causes_counted(cause, queues):
    mb = lane_matrix("packedbit", 8)
    d = lane_inputs("packedbit", 8, seed=5)[0]  # 4 KiB
    kw = {"bytes": dict(max_pending_bytes=d.nbytes, max_delay=60.0),
          "delay": dict(max_delay=0.001),
          "forced": dict(max_delay=60.0)}[cause]
    q = queues(**kw)
    f = q.submit_packedbit(mb, d, 8, M)
    if cause == "forced":
        q.flush()
    assert np.array_equal(f.result(timeout=TIMEOUT),
                          ref._cpu_apply_request("packedbit", mb, d, 8, M))
    d = q.perf.dump()
    assert {c: d[f"flush_{c}"] for c in ("bytes", "delay", "forced")} == {
        c: int(c == cause) for c in ("bytes", "delay", "forced")}
    assert d["dispatch"] == 1 and d["queue_wait"]["avgcount"] == 1


def test_submission_checks(queues):
    """Misaligned packedbit_resident requests are refused at submission (a
    launch would fail every request coalesced with them); so are w != 8 on
    the packed-bit lanes and unknown lanes."""
    q = queues(max_delay=60.0)
    mb = lane_matrix("packedbit", 8)
    with pytest.raises(ValueError, match="32-byte-column"):
        q.submit_packedbit_resident(mb, np.zeros((K, 1000), np.uint8), 8, M)
    with pytest.raises(ValueError, match="w=8"):
        q.submit_packedbit(mb, np.zeros((K, 1024), np.uint8), 16, M)
    with pytest.raises(ValueError, match="unknown lane"):
        q.submit_group([(mb, np.zeros((K, 1024), np.uint8), 8, M, "bogus")])
    assert q.submits == 0 and q._pending == 0
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit_packedbit(mb, np.zeros((K, 1024), np.uint8), 8, M)


def test_queue_runs_on_cuda_unless_told_cpu(monkeypatch):
    """No device argument means CUDA, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchingQueue(device=asked)


def test_reads_the_references_environment(monkeypatch, queues):
    monkeypatch.setenv("CEPH_TPU_BATCH_DELAY", "0.25")
    monkeypatch.setenv("CEPH_TPU_DISPATCH_TIMEOUT", "7")
    monkeypatch.setenv("CEPH_TPU_INJECT_DISPATCH_DELAY", "0.5")
    q = queues()
    assert (q.max_delay, q.dispatch_timeout, q.inject_dispatch_delay) == (
        0.25, 7.0, 0.5)
    assert queues(max_delay=0.125).max_delay == 0.125  # an argument wins
    monkeypatch.setenv("CEPH_TPU_BATCH_DELAY", "soon")
    assert queues().max_delay == 0.002  # malformed: the default


def _eio(fut) -> ErasureCodeError:
    with pytest.raises(ErasureCodeError) as ei:
        fut.result(timeout=TIMEOUT)
    assert ei.value.errno_code == -errno.EIO
    return ei.value


@pytest.mark.parametrize("phase", ["launch", "complete"])
def test_dispatch_error_fails_group_with_eio_then_probe_recovers(
        phase, monkeypatch, queues):
    """A dispatch that raises fails every future of its group with -EIO
    (no host route), trips the lane, and the open lane refuses groups
    without touching the device; after the cooldown one probe closes it."""
    mb = lane_matrix("packedbit", 8)
    bufs = lane_inputs("packedbit", 8, seed=31)
    calls = []
    healthy = service.gf2_apply_packedbit

    def boom(*args, **kw):
        calls.append(1)
        if phase == "launch":
            raise RuntimeError("device dead")
        return healthy(*args, **kw)

    monkeypatch.setattr(service, "gf2_apply_packedbit", boom)
    q = queues(max_delay=60.0)
    if phase == "complete":
        def broken(g, state):
            raise RuntimeError("copy back failed")
        monkeypatch.setattr(q, "_complete_packedbit", broken)
    futs = q.submit_group([(mb, b, 8, M, "packedbit") for b in bufs])
    q.flush()
    for f in futs:
        err = _eio(f)
        assert "packedbit" in str(err) and "cpu" in str(err)
        assert isinstance(err.__cause__, RuntimeError)
    assert len(calls) == 1
    assert q.perf.get("breaker_trip") == 1
    assert q.open_lanes() == ["packedbit"]
    assert q.perf.get("breaker_open_lanes") == 1
    assert q.dump_timeline(1)[0]["error"].startswith("RuntimeError")

    # open (the cooldown pinned, so a slow host cannot end it): refused
    # with -EIO, the device not called
    with q._breaker_lock:
        q._breakers["packedbit"].open_until = time.monotonic() + 60
    f = q.submit_packedbit(mb, bufs[0], 8, M)
    q.flush()
    assert "breaker open" in str(_eio(f))
    assert len(calls) == 1
    # the other lanes still dispatch
    f = q.submit(lane_matrix("packed", 8), bufs[0], 8, M)
    q.flush()
    assert np.array_equal(f.result(timeout=TIMEOUT),
                          ref._cpu_apply_request("packed", mb, bufs[0], 8, M))

    # cooldown elapsed: one probe on the repaired lane closes the breaker
    monkeypatch.setattr(service, "gf2_apply_packedbit", healthy)
    q.__dict__.pop("_complete_packedbit", None)
    with q._breaker_lock:
        q._breakers["packedbit"].open_until = time.monotonic() - 1
    f = q.submit_packedbit(mb, bufs[0], 8, M)
    q.flush()
    assert np.array_equal(f.result(timeout=TIMEOUT), ref._cpu_apply_request(
        "packedbit", mb, bufs[0], 8, M))
    d = q.perf.dump()
    assert (d["breaker_probe"], d["breaker_recover"], d["breaker_open_lanes"],
            d["breaker_fallback"]) == (1, 1, 0, 0)
    assert q.open_lanes() == []


def test_slow_dispatch_trips_the_watchdog(queues):
    """A dispatch that completes past dispatch_timeout delivers its results
    and trips the lane; the next group fails with -EIO."""
    mb = lane_matrix("packed", 8)
    d = lane_inputs("packed", 8, seed=3)[0]
    want = ref._cpu_apply_request("packed", mb, d, 8, M)
    # flushed on this thread, so the breaker has tripped when flush returns
    q = queues(max_delay=60.0)
    q.dispatch_timeout = 0.05
    q.inject_dispatch_delay = 0.12
    f = q.submit(mb, d, 8, M)
    q.flush()
    assert np.array_equal(f.result(timeout=TIMEOUT), want)
    assert q.perf.get("breaker_trip") == 1
    q.inject_dispatch_delay = 0.0
    with q._breaker_lock:
        q._breakers["packed"].open_until = time.monotonic() + 60
    f = q.submit(mb, d, 8, M)
    q.flush()
    _eio(f)
    # a straggler's success is no probe: the breaker stays open
    q._breaker_success("packed")
    assert q.open_lanes() == ["packed"]


def test_worker_survives_an_exception_outside_the_lanes(queues, monkeypatch):
    """An error in the worker's own bookkeeping fails the round's futures
    and leaves the thread serving the next round."""
    mb = lane_matrix("packedbit", 8)
    d = lane_inputs("packedbit", 8, seed=9)[0]
    q = queues(max_delay=0.001)
    real = q._launch_safe
    monkeypatch.setattr(q, "_launch_safe", lambda groups: 1 / 0)
    _eio(q.submit_packedbit(mb, d, 8, M))
    monkeypatch.setattr(q, "_launch_safe", real)
    assert np.array_equal(q.submit_packedbit(mb, d, 8, M).result(
        timeout=TIMEOUT), ref._cpu_apply_request("packedbit", mb, d, 8, M))
    assert q._worker.is_alive()


class _Span:
    """A recording span: the duck type the queue's `span=` takes."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def child(self, name):
        self.log.append(("child", self.name, name))
        return _Span(self.log, name)

    def tag(self, key, value):
        self.log.append(("tag", self.name, key, value))
        return self

    def event(self, what):
        self.log.append(("event", self.name, what))

    def finish(self):
        self.log.append(("finish", self.name))


def test_span_events_match_the_references(queues):
    """submit -> coalesce -> dispatch child (tags, launched, fan-out) ->
    fan-out: the same events, in the same order, as the reference's."""
    mb = lane_matrix("packedbit", 8)
    bufs = lane_inputs("packedbit", 8, seed=41)[:2]
    logs = []
    for q in (ref.BatchingQueue(max_delay=60.0, mesh=False),
              queues(max_delay=60.0)):
        log = []
        try:
            futs = [q.submit_packedbit(mb, b, 8, M, span=_Span(log, "op"))
                    for b in bufs]
            q.flush()
            for f in futs:
                f.result(timeout=TIMEOUT)
        finally:
            q.close()
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("event", "ec batch dispatch", "launched") in logs[1]


def test_counters_and_timeline_lead_the_futures(queues):
    """A done-callback of a group's future already sees the group counted:
    the port records dispatch_dev, group_size and the timeline entry before
    the fan-out resolves the futures (the reference records them after, so
    a read right after an op can miss it)."""
    mb = lane_matrix("packedbit", 8)
    q = queues(max_delay=60.0)
    seen = []

    def read(_fut):
        d = q.perf.dump()
        seen.append((d["dispatch_dev"]["avgcount"], d["group_size"]["sum"],
                     [r["group_size"] for r in q.dump_timeline(8)]))

    futs = [q.submit_packedbit(mb, b, 8, M)
            for b in lane_inputs("packedbit", 8, seed=43)]
    futs[0].add_done_callback(read)
    q.flush()
    for f in futs:
        f.result(timeout=TIMEOUT)
    assert seen == [(1, 3.0, [3])]


def test_timeline_on_the_admin_socket(queues):
    class Asok:
        def register(self, name, fn, desc):
            self.name, self.fn = name, fn

    mb = lane_matrix("packedbit", 8)
    q = queues(max_delay=60.0)
    for b in lane_inputs("packedbit", 8, seed=2):
        q.submit_packedbit(mb, b, 8, M)
    q.flush()
    asok = Asok()
    q.register_asok(asok)
    recs = asok.fn({"count": 1})
    assert asok.name == "dump_ec_batch_timeline" and len(recs) == 1
    assert recs[0]["lane"] == "packedbit" and recs[0]["group_size"] == 3
    assert recs[0]["bytes"] == K * sum(WIDTHS)


def test_finished_round_is_fanned_out_before_the_next_is_cut(queues):
    """A round held in flight because more work is queued is completed as
    soon as the device has finished it, not when the next round is cut: here
    the next round waits for a flush, and the first resolves before it."""
    mb = lane_matrix("packed", 8)
    rng = np.random.default_rng(23)
    first = rng.integers(0, 256, (K, 2048), dtype=np.uint8)
    q = queues(max_pending_bytes=first.nbytes, max_delay=60.0)
    late = []

    def inject_backlog():
        # below the bytes threshold and inside the window: not yet due
        q._launch_hook = None
        d = rng.integers(0, 256, (K, 1024), dtype=np.uint8)
        late.append((d, q.submit(mb, d, 8, M)))

    q._launch_hook = inject_backlog
    out = q.submit(mb, first, 8, M).result(timeout=TIMEOUT)
    assert np.array_equal(out, ref._cpu_apply_request("packed", mb, first, 8, M))
    d1, f1 = late[0]
    assert not f1.done() and q.dispatches == 1
    assert q.overlapped_rounds == 0
    q.flush()
    assert np.array_equal(f1.result(timeout=TIMEOUT),
                          ref._cpu_apply_request("packed", mb, d1, 8, M))
    assert q.perf.get("flush_bytes") == q.perf.get("flush_forced") == 1
