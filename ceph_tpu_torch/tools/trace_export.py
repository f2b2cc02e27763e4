# Copy of ceph_tpu/tools/trace_export.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Export one stitched op trace as Jaeger-compatible JSON.

The per-daemon tracer rings each hold only their OWN spans of a
cross-daemon trace (client root, the primary's osd_op/ec write spans,
every sub-write peer's span).  This tool gathers `dump_trace <id>`
answers across daemons and emits the whole tree in Jaeger's JSON upload
shape (the `jaeger-ui` / `jaeger query` import format), so one EC write
renders as client -> primary -> k+m sub-write peers under a single
traceID.

    python -m ceph_tpu_torch.tools.trace_export --asok-dir DIR --trace <hex>
    python -m ceph_tpu_torch.tools.trace_export --asok-dir DIR --trace <hex> -o op.json

In-process callers (tests, bench) use ``collect_spans`` /
``to_jaeger`` directly with tracer objects or pre-dumped span lists.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys
from typing import Any, Dict, Iterable, List


def collect_spans(sources: Iterable[Any], trace_id: str) -> List[Dict]:
    """Gather one trace's spans from a mix of sources: Tracer objects,
    span-dump lists, or {"spans": [...]} asok replies."""
    spans: List[Dict] = []
    seen = set()
    for src in sources:
        if hasattr(src, "spans_for"):
            got = src.spans_for(trace_id)
        elif isinstance(src, dict):
            got = src.get("spans", [])
        else:
            got = [d for d in src if d.get("trace_id") == trace_id]
        for d in got:
            key = d.get("span_id")
            if key in seen:
                continue
            seen.add(key)
            spans.append(d)
    return spans


def resolve_parents(spans: List[Dict]) -> Dict[str, int]:
    """{span_id -> child count}; spans whose parent_id names a span NOT
    in the set are orphans (a daemon's ring evicted the parent)."""
    ids = {d["span_id"] for d in spans}
    orphans = sum(1 for d in spans
                  if d.get("parent_id") and d["parent_id"] not in ids)
    children: Dict[str, int] = {}
    for d in spans:
        p = d.get("parent_id")
        if p:
            children[p] = children.get(p, 0) + 1
    children["__orphans__"] = orphans
    return children


def to_jaeger(trace_id: str, spans: List[Dict]) -> Dict:
    """Jaeger JSON upload shape: {"data": [{"traceID", "spans": [...],
    "processes": {...}}]}.  Timestamps are µs since epoch; parent links
    become CHILD_OF references."""
    processes: Dict[str, Dict] = {}
    proc_ids: Dict[str, str] = {}

    def proc_for(service: str) -> str:
        pid = proc_ids.get(service)
        if pid is None:
            pid = proc_ids[service] = f"p{len(proc_ids) + 1}"
            processes[pid] = {"serviceName": service or "unknown",
                              "tags": []}
        return pid

    jspans = []
    for d in spans:
        refs = []
        if d.get("parent_id"):
            refs.append({"refType": "CHILD_OF", "traceID": trace_id,
                         "spanID": d["parent_id"]})
        tags = [{"key": k, "type": "string", "value": str(v)}
                for k, v in (d.get("tags") or {}).items()]
        logs = [{"timestamp": int(ev["time"] * 1e6),
                 "fields": [{"key": "event", "type": "string",
                             "value": ev["event"]}]}
                for ev in (d.get("events") or [])]
        jspans.append({
            "traceID": trace_id,
            "spanID": d["span_id"],
            "operationName": d.get("name", ""),
            "references": refs,
            "startTime": int(d["start"] * 1e6),
            "duration": max(1, int(d.get("duration", 0.0) * 1e6)),
            "tags": tags,
            "logs": logs,
            "processID": proc_for(d.get("service", "")),
        })
    jspans.sort(key=lambda s: s["startTime"])
    return {"data": [{"traceID": trace_id, "spans": jspans,
                      "processes": processes}]}


async def _gather_asok(asok_dir: str, trace_id: str) -> List[Dict]:
    from ceph_tpu_torch.common.admin_socket import asok_command

    sources = []
    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        try:
            reply = await asok_command(path, "dump_trace",
                                       trace_id=trace_id)
        except Exception as e:  # daemon gone / asok stale: skip, note it
            print(f"warn: {path}: {e}", file=sys.stderr)
            continue
        # label spans with the daemon the socket belongs to when the
        # tracer didn't stamp a service
        name = os.path.basename(path)[:-len(".asok")]
        for d in reply.get("spans", []):
            d.setdefault("service", name)
        sources.append(reply)
    return collect_spans(sources, trace_id)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="export one stitched trace "
                                            "as Jaeger JSON")
    p.add_argument("--asok-dir", required=True,
                   help="directory of daemon .asok sockets")
    p.add_argument("--trace", required=True, help="trace id (hex)")
    p.add_argument("-o", "--out", default="",
                   help="output file (default stdout)")
    args = p.parse_args(argv)
    spans = asyncio.run(_gather_asok(args.asok_dir, args.trace))
    if not spans:
        print(f"no spans found for trace {args.trace}", file=sys.stderr)
        return 1
    doc = to_jaeger(args.trace, spans)
    links = resolve_parents(spans)
    if links.get("__orphans__"):
        print(f"warn: {links['__orphans__']} spans reference parents "
              f"not in the export (ring eviction?)", file=sys.stderr)
    text = json.dumps(doc, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {len(spans)} spans to {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
