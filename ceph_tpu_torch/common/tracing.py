# Copy of ceph_tpu/common/tracing.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Distributed-trace spans (zipkin/blkin + jaeger wrapper role).

Role-equivalent of the reference's ZTracer/jaeger integration (reference
src/common/zipkin_trace.h, src/common/tracer.{h,cc}): ops carry a trace
with named spans; pipeline stages open child spans ("start ec write",
per-shard sub-writes, ECBackend.cc:2027,2113) and annotate events.

Cross-daemon stitching: ids are RANDOM 64-bit hex strings (unique across
processes and hosts, not a per-process counter), and a (trace_id,
parent span_id) pair rides the wire on the data-plane messages
(MOSDOp, MECSubWrite/Reply, MOSDBackoff, MOSDPGHitSet — types.py).  The
receiving daemon calls ``Tracer.join`` to open a child span of the
remote parent, so a client write stitches into ONE tree:
client_op -> osd_op -> ec write -> k+m ec_sub_write spans, each span
recorded in its OWN daemon's ring.

Spans land in a bounded per-daemon ring dumped via the admin socket
(``dump_traces``; ``dump_trace`` filters one trace_id) — the in-process
stand-in for shipping to a collector.  ``tools/trace_export.py`` gathers
the per-daemon rings and emits Jaeger-compatible JSON for a whole op.

Code with no daemon context (the codec path: ec/base.py, ec/codecs.py,
ec/plugins/cuda.py, ops/gf2.py) opens spans with the module-level
``span(name)`` of the process tracer, ``PROCESS``.  It is off by default,
and off a span is one flag read returning a shared no-op.  On, spans nest
per thread; a root span opens a trace, and its children share its trace id.
Ids are process-local integers.

Every stamp is ``time.time_ns()`` (CLOCK_REALTIME), the clock that
torch.profiler's chrome traces run on (``ts`` * 1000 +
``baseTimeNanoseconds``), so spans can be laid on a device trace by their
own stamps; that trace has been seen a millisecond off, so check the
placement (a marker kernel launched after a stamp) where it matters.  Dumps
keep the daemon spans' seconds.

This module imports no torch: reactor workers import ``common/``.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple


def _new_id() -> str:
    """Random 64-bit hex id: unique across daemons/hosts (a per-process
    counter would collide the moment two daemons' spans stitch)."""
    return os.urandom(8).hex()


class Span:
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end", "events", "tags")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.start = time.time_ns()
        self.end: Optional[int] = None
        self.events: List[Dict[str, Any]] = []
        self.tags: Dict[str, Any] = {}

    def event(self, name: str) -> None:
        self.events.append({"time": time.time(), "event": name})

    def tag(self, key: str, value: Any) -> "Span":
        """Attach a key/value annotation (zipkin binary-annotation role):
        the batching queue tags dispatch spans with lane, group size, and
        byte counts so the asok timeline is self-describing."""
        self.tags[key] = value
        return self

    def child(self, name: str) -> "Span":
        return self.tracer._span(name, self.trace_id, self.span_id)

    def context(self):
        """(trace_id, span_id) — what rides the wire so the receiving
        daemon can ``join`` as a child of this span."""
        return self.trace_id, self.span_id

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time_ns()
            self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def dump(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start / 1e9,
                "duration": ((self.end or time.time_ns()) - self.start) / 1e9,
                "events": list(self.events), "tags": dict(self.tags)}


class Tracer:
    def __init__(self, max_spans: int = 256, enabled: bool = True,
                 service: str = ""):
        self.enabled = enabled
        # the daemon name, stamped into every dumped span so a
        # cross-daemon trace export can label processes (jaeger's
        # processes map) without knowing which ring a span came from
        self.service = service
        self._ring: Deque[Span] = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()

    def new_trace(self, name: str) -> Span:
        return self._span(name, _new_id(), None)

    def join(self, name: str, trace_id: str,
             parent_id: Optional[str] = None) -> Span:
        """Open a span under a REMOTE parent: the receiving half of
        cross-daemon propagation (the wire carried (trace_id,
        parent span_id); this daemon's span becomes its child)."""
        return self._span(name, trace_id, parent_id or None)

    def _span(self, name: str, trace_id: str, parent_id: Optional[str]) -> Span:
        return Span(self, name, trace_id, parent_id)

    def _record(self, span: Span) -> None:
        if self.enabled:
            with self._lock:
                self._ring.append(span)

    def dump(self) -> List[Dict[str, Any]]:
        # snapshot FIRST: worker threads finish spans concurrently, and
        # iterating the live deque from the asok thread would raise
        # "deque mutated during iteration" mid-dump
        with self._lock:
            spans = list(self._ring)
        out = []
        for s in spans:
            d = s.dump()
            if self.service:
                d["service"] = self.service
            out.append(d)
        return out

    def spans_for(self, trace_id: str) -> List[Dict[str, Any]]:
        """Every recorded span of one trace (the `dump_trace <id>` asok
        answer; tools/trace_export.py stitches these across daemons)."""
        return [d for d in self.dump() if d["trace_id"] == trace_id]

    def register_asok(self, asok) -> None:
        asok.register("dump_traces", lambda a: self.dump(),
                      "recent trace spans")
        asok.register(
            "dump_trace",
            lambda a: {"trace_id": a.get("trace_id", ""),
                       "spans": self.spans_for(a.get("trace_id", ""))},
            "spans of one trace (trace_id=<hex>)")


# -- the process tracer: spans of code with no daemon context ----------------

#: a finished process span: (name, start_ns, end_ns, span id, parent id or
#: 0 for a root, trace id, thread ident)
Record = Tuple[str, int, int, int, int, int, int]

#: spans the process ring holds by default: a 51 s window of 4 MiB codec
#: calls on a fast host records about 0.4 M
CAPACITY = 1 << 20

_on = False  # read by span() on every call: the off path's only cost


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _ProcessSpan:
    __slots__ = ("name", "start", "span_id", "parent_id", "trace_id",
                 "_outer")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_ProcessSpan":
        tracer = PROCESS
        outer = getattr(tracer._local, "current", None)
        self._outer = outer
        self.span_id = next(tracer._ids)
        if outer is None:  # a root opens a trace
            self.parent_id, self.trace_id = 0, self.span_id
        else:
            self.parent_id, self.trace_id = outer.span_id, outer.trace_id
        tracer._local.current = self
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        tracer = PROCESS
        tracer._local.current = self._outer
        next(tracer._recorded)
        tracer._ring.append((self.name, self.start, end, self.span_id,
                             self.parent_id, self.trace_id,
                             threading.get_ident()))


class ProcessTracer:
    """The process-wide tracer behind ``span()``: finished spans as
    ``Record`` tuples in a bounded ring, the oldest dropped (and counted)
    when it is full."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._ring: Deque[Record] = collections.deque(maxlen=CAPACITY)
        self._recorded = itertools.count()  # spans ended into this ring

    def enable(self, capacity: int = CAPACITY) -> None:
        """Start recording into an empty ring of `capacity` spans."""
        global _on
        self._ring = collections.deque(maxlen=capacity)
        self._recorded = itertools.count()
        _on = True

    @property
    def enabled(self) -> bool:
        return _on

    def disable(self) -> None:
        """Stop opening spans; spans open now still record when they end."""
        global _on
        _on = False

    def drain(self) -> Tuple[List[Record], int]:
        """(the recorded spans in the order they ended, how many were
        dropped since the ring was last emptied); empties the ring."""
        ring, recorded = self._ring, next(self._recorded)
        self._ring = collections.deque(maxlen=ring.maxlen)
        self._recorded = itertools.count()
        spans = list(ring)
        return spans, max(0, recorded - len(spans))


PROCESS = ProcessTracer()


def span(name: str):
    """A span of the process tracer around a block (``with
    span("ec.encode"):``); off, the shared no-op."""
    if not _on:
        return _NO_SPAN
    return _ProcessSpan(name)
