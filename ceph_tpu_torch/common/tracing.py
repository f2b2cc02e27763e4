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
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Deque, Dict, List, Optional

import time


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
        self.start = time.time()
        self.end: Optional[float] = None
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
            self.end = time.time()
            self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def dump(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start,
                "duration": (self.end or time.time()) - self.start,
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
