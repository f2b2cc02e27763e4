# Copy of ceph_tpu/common/tracked_op.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""In-flight op tracking with event timelines.

Role-equivalent of the reference's TrackedOp/OpTracker (reference
src/common/TrackedOp.h): every client op AND every OSD-side op — EC
sub-writes, recovery pushes, tier promotions, the evict agent — gets a
TrackedOp at dispatch; pipeline stages call ``mark_event`` with names
from the shared EVENT VOCABULARY below; the admin socket serves
``dump_ops_in_flight``, ``dump_historic_ops`` (a bounded ring of
recently completed ops) and ``dump_historic_slow_ops`` (ops that aged
past the complaint threshold) — the primary live-debugging tool for
stuck I/O.  TrackedOp carries the op's trace span (``trace``), so the
timeline and the cross-daemon span tree name the same op.

Event vocabulary (client-op timelines; sub-ops use a compact subset):

    initiated             op record created (implicit: initiated_at)
    queued_for_pg         entered the sharded op queue
    reached_pg            dequeued; the PG handler is running
    backoff               dropped-and-blocked (MOSDBackoff sent)
    rmw_read              partial-overwrite base read started
    ec_encode_dispatched  encode submitted to the device queue
    encoded               encode results in hand
    sub_writes_sent       the k+m fan-out is on the wire
    waiting_for_subops    parked gathering sub-write acks
    commit_gathered       quorum of sub-write acks arrived
    decode_dispatched     (reads) decode submitted to the device queue
    decoded               (reads) decode results in hand
    commit_sent           reply handed to the client connection
    done                  finish() (implicit: done_at)

Per-phase latencies: on completion the tracker turns adjacent event
pairs into named phases (``PHASES``) and feeds the ``optracker`` perf
set (one longrunavg + one power-of-2 µs histogram per phase) plus a
bounded raw-sample ring that ``phase_percentiles()`` reduces to
p50/p99/p999 — the numbers the BENCH record embeds.

Thread-safety: seq allocation is per-tracker, the in-flight map and
history rings mutate only under the tracker lock, and a single op's
event list is bounded (``max_events``) so a stuck op polled by a
watchdog cannot grow its timeline without bound.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder

# adjacent-event pairs -> phase name (per-phase latency accounting);
# both the write and read pipelines resolve to the same phase names so
# one schema serves `perf dump`, the BENCH record, and the tests
PHASES: Dict[tuple, str] = {
    ("queued_for_pg", "reached_pg"): "queue_wait",
    ("ec_encode_dispatched", "encoded"): "ec_dispatch",
    ("decode_dispatched", "decoded"): "ec_dispatch",
    # the write path marks waiting_for_subops right after
    # sub_writes_sent, so the gather window is measured from there
    ("waiting_for_subops", "commit_gathered"): "subop_wait",
    # reads: sub-read fan-out + gather, the read-side analog
    ("sub_reads_sent", "decode_dispatched"): "subop_wait",
}

PHASE_NAMES = ("queue_wait", "ec_dispatch", "subop_wait")


def build_optracker_perf() -> PerfCounters:
    """The `optracker` counter set — one per daemon Context, carried by
    `perf dump` / mgr /metrics.  Schema:

      op_created / op_done   u64         tracked ops created / completed
      slow_ops_observed      u64         completions past the complaint
                                         threshold
      events_dropped         u64         mark_event calls absorbed by the
                                         per-op event bound
      inflight               u64         ops currently tracked (gauge)
      op_lat                 longrunavg  whole-op seconds
      lat_<phase>            longrunavg  per-phase seconds
      hist_<phase>_us        histogram   per-phase µs (power-of-2)
    """
    b = PerfCountersBuilder("optracker")
    b.add_u64_counter("op_created", "tracked ops created")
    b.add_u64_counter("op_done", "tracked ops completed")
    b.add_u64_counter("slow_ops_observed",
                      "completions past the complaint threshold")
    b.add_u64_counter("events_dropped",
                      "mark_event calls absorbed by the per-op bound")
    b.add_u64("inflight", "ops currently tracked (gauge)")
    b.add_time_avg("op_lat", "whole-op seconds")
    for phase in PHASE_NAMES:
        b.add_time_avg(f"lat_{phase}", f"{phase} seconds per op")
        b.add_histogram(f"hist_{phase}_us", f"{phase} microseconds")
    return b.create_perf_counters()


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over raw samples (q in [0, 1])."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def percentile_summary(samples: List[float]) -> Dict[str, float]:
    """{p50_us, p99_us, p999_us, count} over raw SECONDS samples — the
    one reduction behind phase_percentiles and the BENCH record (bench
    merges samples across OSDs first, then calls this)."""
    return {"p50_us": round(percentile(samples, 0.50) * 1e6, 1),
            "p99_us": round(percentile(samples, 0.99) * 1e6, 1),
            "p999_us": round(percentile(samples, 0.999) * 1e6, 1),
            "count": len(samples)}


class TrackedOp:
    __slots__ = ("tracker", "seq", "desc", "reqid", "initiated_at",
                 "events", "done_at", "trace", "complaint_ok", "_dropped",
                 "qos_tag")

    def __init__(self, tracker: "OpTracker", desc: str, reqid: str = "",
                 trace: Any = None):
        self.tracker = tracker
        self.seq = tracker._next_seq()
        self.desc = desc
        self.reqid = reqid
        self.initiated_at = time.time()
        self.events: List[Dict[str, Any]] = []
        self.done_at: Optional[float] = None
        # the op's trace span (tracing.Span), when one is attached: the
        # timeline and the span tree name the same op
        self.trace = trace
        # complaint_ok=False exempts the op from slow-op aging: ops that
        # LEGITIMATELY park for seconds (a notify gathering watcher
        # acks) must not raise SLOW_OPS on a healthy cluster
        self.complaint_ok = True
        self._dropped = 0
        # tenant-class tag (qos.tenant_class of the op's client): when
        # set, phase samples ALSO land in a per-class ring keyed
        # "cls:<tag>|<phase>" — the per-tenant-class percentile path the
        # macro bench reduces ("" = untagged, no extra ring)
        self.qos_tag = ""

    def mark_event(self, event: str) -> None:
        # bounded: a stuck op re-marked by a poller must not grow its
        # timeline without bound (the reference caps events per op too)
        if len(self.events) >= self.tracker.max_events:
            self._dropped += 1
            self.tracker.perf.inc("events_dropped")
            return
        self.events.append({"time": time.time(), "event": event})

    def finish(self) -> None:
        if self.done_at is None:
            self.done_at = time.time()
            self.tracker._complete(self)

    @property
    def duration(self) -> float:
        return (self.done_at or time.time()) - self.initiated_at

    def phase_latencies(self) -> Dict[str, float]:
        """Adjacent-event-pair phases (PHASES) -> seconds."""
        out: Dict[str, float] = {}
        prev_name, prev_t = "initiated", self.initiated_at
        for ev in self.events:
            phase = PHASES.get((prev_name, ev["event"]))
            if phase is not None:
                out[phase] = ev["time"] - prev_t
            prev_name, prev_t = ev["event"], ev["time"]
        return out

    def dump(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "seq": self.seq,
            "description": self.desc,
            "initiated_at": self.initiated_at,
            "age": self.duration,
            "done": self.done_at is not None,
            "type_data": {"events": list(self.events)},
        }
        if self.reqid:
            d["reqid"] = self.reqid
        if self.trace is not None:
            d["trace_id"] = self.trace.trace_id
            d["span_id"] = self.trace.span_id
        if self._dropped:
            d["events_dropped"] = self._dropped
        return d


class OpTracker:
    """Thread-safe op tracker: one per daemon Context.

    ``slow_threshold`` is the complaint age (reference
    osd_op_complaint_time): completed ops that took at least this long
    join the slow ring; in-flight ops older than it surface through
    ``slow_op_summary`` (the SLOW_OPS health feed)."""

    SAMPLE_RING = 2048  # raw per-phase samples kept for percentiles
    # bound on DISTINCT sample-ring keys: the per-class keys derive from
    # the wire-controlled client name, so without a cap a sender minting
    # a fresh tenant class per op would grow a new ring forever; at the
    # cap, samples for NEW tagged keys are dropped (untagged phase rings
    # are few and always created first)
    MAX_SAMPLE_KEYS = 256

    def __init__(self, history_size: int = 20, history_slow_size: int = 20,
                 slow_threshold: float = 2.0, max_events: int = 128,
                 perf: Optional[PerfCounters] = None):
        self._lock = threading.Lock()
        self._seq = itertools.count(1)  # per-tracker, allocated under lock
        self._in_flight: Dict[int, TrackedOp] = {}
        self._history: Deque[TrackedOp] = collections.deque(maxlen=history_size)
        self._slow: Deque[TrackedOp] = collections.deque(maxlen=history_slow_size)
        self.slow_threshold = slow_threshold
        self.max_events = max_events
        self.perf = perf if perf is not None else build_optracker_perf()
        self._samples: Dict[str, Deque[float]] = {}

    def _next_seq(self) -> int:
        with self._lock:
            return next(self._seq)

    def create(self, desc: str, reqid: str = "",
               trace: Any = None) -> TrackedOp:
        op = TrackedOp(self, desc, reqid=reqid, trace=trace)
        with self._lock:
            self._in_flight[op.seq] = op
            # gauge published under the tracker lock: a set() outside it
            # can lose the race with a concurrent create/complete and
            # leave a stale inflight count until the next op
            self.perf.set("inflight", len(self._in_flight))
        self.perf.inc("op_created")
        return op

    def _complete(self, op: TrackedOp) -> None:
        slow = op.complaint_ok and op.duration >= self.slow_threshold
        with self._lock:
            self._in_flight.pop(op.seq, None)
            self._history.append(op)
            if slow:
                self._slow.append(op)
            self.perf.set("inflight", len(self._in_flight))
        self.perf.inc("op_done")
        self.perf.tinc("op_lat", op.duration)
        if slow:
            self.perf.inc("slow_ops_observed")
        for phase, dt in op.phase_latencies().items():
            self.perf.tinc(f"lat_{phase}", dt)
            self.perf.hinc(f"hist_{phase}_us", dt * 1e6)
            keys = (phase,) if not op.qos_tag \
                else (phase, f"cls:{op.qos_tag}|{phase}")
            with self._lock:
                for key in keys:
                    ring = self._samples.get(key)
                    if ring is None:
                        if len(self._samples) >= self.MAX_SAMPLE_KEYS:
                            continue  # key-cardinality bound (see above)
                        ring = self._samples[key] = collections.deque(
                            maxlen=self.SAMPLE_RING)
                    ring.append(dt)

    # -- percentiles ---------------------------------------------------------

    def phase_samples(self) -> Dict[str, List[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._samples.items()}

    def clear_samples(self) -> None:
        with self._lock:
            self._samples.clear()

    def phase_percentiles(self) -> Dict[str, Dict[str, float]]:
        """{phase: {p50, p99, p999, count}} in MICROSECONDS — the shape
        the BENCH record embeds."""
        return {phase: percentile_summary(samples)
                for phase, samples in self.phase_samples().items()}

    # -- slow-op health feed -------------------------------------------------

    def slow_op_summary(self, complaint: Optional[float] = None) -> Dict[str, Any]:
        """In-flight ops older than the complaint threshold — what the
        SLOW_OPS health check reports (count + oldest age + samples)."""
        threshold = self.slow_threshold if complaint is None else complaint
        now = time.time()
        with self._lock:
            aged = [op for op in self._in_flight.values()
                    if op.complaint_ok
                    and now - op.initiated_at >= threshold]
        aged.sort(key=lambda o: o.initiated_at)
        return {
            "count": len(aged),
            "oldest_age": round(now - aged[0].initiated_at, 3) if aged else 0.0,
            "complaint_time": threshold,
            "ops": [{"description": op.desc,
                     "age": round(now - op.initiated_at, 3),
                     "last_event": op.events[-1]["event"] if op.events
                     else "initiated"}
                    for op in aged[:8]],
        }

    # -- dumps ---------------------------------------------------------------

    def dump_ops_in_flight(self) -> Dict[str, Any]:
        with self._lock:
            ops = list(self._in_flight.values())
        dumped = [op.dump() for op in ops]
        return {"num_ops": len(dumped), "ops": dumped}

    def dump_historic_ops(self) -> Dict[str, Any]:
        with self._lock:
            ops = list(self._history)
        dumped = [op.dump() for op in ops]
        return {"num_ops": len(dumped), "ops": dumped}

    def dump_historic_slow_ops(self) -> Dict[str, Any]:
        with self._lock:
            ops = list(self._slow)
        dumped = [op.dump() for op in ops]
        return {"num_ops": len(dumped),
                "complaint_time": self.slow_threshold,
                "ops": dumped}

    def register_asok(self, asok) -> None:
        asok.register("dump_ops_in_flight", lambda a: self.dump_ops_in_flight(),
                      "in-flight ops with event timelines")
        asok.register("dump_historic_ops", lambda a: self.dump_historic_ops(),
                      "recently completed ops")
        asok.register("dump_historic_slow_ops",
                      lambda a: self.dump_historic_slow_ops(),
                      "recent ops slower than the complaint threshold")
