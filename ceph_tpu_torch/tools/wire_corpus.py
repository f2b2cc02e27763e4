# Copy of ceph_tpu/tools/wire_corpus.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Wire-format corpus: archived encoded frames of the core message
types, replayed against today's decoder (reference ceph-object-corpus +
src/test/encoding/readable.sh: every archived past version must stay
decodable, so an accidental field rename / layout change is caught the
round it happens, not at the first mixed-version cluster).

    python -m ceph_tpu_torch.tools.wire_corpus --create          # archive current
    python -m ceph_tpu_torch.tools.wire_corpus --check           # replay archive
    python -m ceph_tpu_torch.tools.wire_corpus --check --strict  # + coverage walk

``--strict`` additionally fails on any FIXED message type missing
corpus coverage (no archived frame), dencoder coverage (its fixed codec
must round-trip a default instance), or — for versioned (v2+) types — a
golden old-build frame under corpus/wire/golden.  The walk lives in
``coverage_gaps()`` so the tpu-lint wire-ABI family reuses the SAME
implementation (one source of truth for what "covered" means).

Each archived frame is a self-contained binary file:

    [u16 type_id][u16 version][u8 fixed][u32 plen][payload][u32 blen][blob]

plus a sidecar .json with the expected decoded field values (bytes as
hex) — the check decodes the frame with TODAY's decode_message and
compares field-for-field, so both the binary layout and the field NAMES
are pinned.  Data-plane types archive their FIXED layout; control-plane
types archive their pickled layout.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
from typing import Any, Dict, List, Tuple

_FRAME_HDR = struct.Struct("<HHBI")

CORPUS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "corpus", "wire")


def _sample_messages() -> List[Any]:
    """Representative instances of the core message set — every field
    non-default so a dropped/renamed field cannot hide behind a
    default value."""
    from ceph_tpu_torch.rados import types as t
    from ceph_tpu_torch.rados.tiering import HitSetArchive

    # deterministic hit-set archive (explicit clocks, seeded blake2b
    # hashing): the MOSDPGHitSet frame below pins the BloomHitSet /
    # HitSetArchive BINARY encoding alongside the message layout —
    # an accidental re-layout of either fails the corpus check
    arch = HitSetArchive(period=2.0, count=4, target_size=32,
                         fpp=0.05, seed=77, now=100.0)
    arch.record("corpus/hot", now=100.5)
    arch.record("corpus/hot", now=102.5)  # rotates the first interval
    arch.record("corpus/warm", now=102.6)

    from ceph_tpu_torch.rados.messenger import MLaneHello, MLaneSegment
    from ceph_tpu_torch.rados.clog import ClogEntry, encode_entries

    # deterministic cluster-log blob: the MLog/MLogReply/MCrashReport
    # frames below pin the ClogEntry BINARY codec (append-only records)
    # alongside the message layouts
    clog_blob = encode_entries([
        ClogEntry(stamp=1700000000.25, name="osd.3", channel="cluster",
                  prio=3, seq=9001, message="corpus warn line", idx=41),
        ClogEntry(stamp=1700000001.5, name="mon.0", channel="audit",
                  prio=1, seq=77, message="from='client' cmd='MPoolSet'",
                  idx=42),
    ])

    return [
        t.MOSDOp(op="write", pool_id=3, oid="corpus/oid", data=b"payload",
                 epoch=11, reqid="req-1", offset=4096, cls="lock",
                 method="lock", snapc_seq=9, snapc_snaps=[9, 4, 2],
                 snap_read=7, snap_id=5, pg=12, cursor="after",
                 max_entries=64, nspace="blue", fadvise="willneed",
                 trace_id="deadbeefcafef00d", span_id="0123456789abcdef",
                 client="client.gold.7", gseq=17),
        t.MOSDOp(op="multi", pool_id=1, oid="m", reqid="r2",
                 ops=[("setxattr", {"name": "a", "value": b"v"}),
                      ("omap_set", {"entries": {"k": b"x"}})]),
        t.MOSDOpReply(ok=False, error="nope", code=-17, data=b"reply",
                      oids=["a", "b"], cursor="cur", backoff=0.25,
                      reqid="rq", version=(7 << 32) | 3, map_epoch=21,
                      gseq=18),
        t.MECSubWrite(pool_id=2, pg=5, from_osd=3, epoch=13, oid="obj",
                      shard=4, chunk=b"chunkdata", version=99,
                      object_size=1234, chunk_crc=0xDEAD, tid="t1",
                      reply_to=("127.0.0.1", 6800), log_entry=b"LE",
                      chunk_off=8192, shard_size=65536, prior_version=42,
                      hinfo=b"HINFO", trace_id="deadbeefcafef00d",
                      span_id="fedcba9876543210", gseq=19),
        t.MECSubWriteReply(tid="t1", shard=4, ok=False,
                           trace_id="deadbeefcafef00d",
                           span_id="fedcba9876543210", gseq=20),
        t.MECSubRead(pool_id=2, pg=5, oid="obj", shard=1, tid="t2",
                     reply_to=("host", 1), extents=[(0, 4096), (8192, 64)],
                     want_hinfo=True, gseq=21),
        # chunk_crc stays default: it is SENDER-LOCAL (not in
        # FIXED_FIELDS — the frame's blob-crc slot carries it), so the
        # decoded archive must see the dataclass default
        t.MECSubReadReply(tid="t2", shard=1, ok=True, chunk=b"bytes",
                          version=7, object_size=55, hinfo=b"H", gseq=22),
        t.MECSubDelete(pool_id=1, pg=2, oid="gone", shard=0, tid="t3",
                       reply_to=("h", 2)),
        # writeback fast-ack plane: the raw-dirty install (every field
        # non-default) plus the post-flush clear broadcast — both legs
        # of the cache-tier durability quorum are corpus-pinned
        t.MCacheDirty(pool_id=3, pg=6, from_osd=1, epoch=27,
                      oid="wb/obj", op="install", data=b"rawdirty",
                      version=41, object_size=8, tid="t-wb1",
                      reply_to=("127.0.0.1", 6802), log_entry=b"LE",
                      peers=[1, 2, 3], gseq=25),
        t.MCacheDirty(pool_id=3, pg=6, from_osd=1, epoch=28,
                      oid="wb/obj", op="clear", version=41,
                      object_size=8, gseq=26),
        t.MCacheDirtyAck(tid="t-wb1", osd=2, ok=False, gseq=27),
        t.MPushShard(pool_id=1, pg=0, oid="pushed", shard=2,
                     chunk=b"recovered", version=3, object_size=9,
                     hinfo=b"HH", gseq=23),
        t.MPushShard(pool_id=1, pg=0, oid="pushed2", shard=2,
                     chunk=b"r2", version=3, object_size=2,
                     xattrs={"lock.x": b"owner"}),
        t.MListShards(pool_id=4, tid="t4"),
        t.MFetchShards(pool_id=4, oid="a", tid="t5",
                       reply_to=("h", 9)),
        t.MPGInfoReq(pool_id=1, pg=7, tid="t6"),
        t.MPGLogReq(pool_id=1, pg=7, since=(3, 9), tid="t7"),
        t.MOSDPing(op="ping", from_osd=2, epoch=5),
        t.MGetMap(min_epoch=4, tid="t8"),
        t.MSnapOp(pool_id=2, op="mksnap", snap_id=0, name="snapname",
                  tid="t9"),
        t.MSnapOpReply(tid="t9", ok=False, error="bad", code=-22,
                       snap_id=6),
        t.MSetXattrs(pool_id=1, oid="x", shard=0,
                     xattrs={"k": b"v"}, removals=["old"]),
        t.MSetOmap(pool_id=1, oid="x", shard=0, clear=True,
                   entries={"a": b"1"}, removals=["b"]),
        t.MWatchNotify(pool_id=1, oid="w", notify_id="n1",
                       payload=b"ping"),
        t.MNotifyAck(notify_id="n1", watcher=("h", 3)),
        t.MBackfillReserve(pool_id=1, pg=3, op="request", from_osd=2,
                           tid="t10", reply_to=("h", 4)),
        # v2 carries the refusal reason ("toofull" = backfillfull
        # target); v1 frames decode with reason defaulting (golden)
        t.MBackfillReserveReply(tid="t10", osd_id=4, ok=False,
                                reason="toofull"),
        # liveness ping v4: health checks + the statfs the mon's
        # fullness derivation runs on (v3 golden pins truncated decode;
        # the scrub-era health SHAPE — OSD_SCRUB_ERRORS/PG_INCONSISTENT
        # riding the dict — is pinned here, with the pre-scrub-era
        # content replay-guarded by golden MPing.v4_prescrubera)
        t.MPing(osd_id=3, epoch=21, addr=("127.0.0.1", 6801),
                health={"SLOW_OPS": {"severity": "warning",
                                     "summary": "1 slow ops",
                                     "count": 1},
                        "OSD_SCRUB_ERRORS": {"severity": "error",
                                             "summary": "2 scrub errors",
                                             "count": 2},
                        "PG_INCONSISTENT": {
                            "severity": "error",
                            "summary": "1 pg(s) inconsistent",
                            "count": 1, "pgs": ["1.3"]}},
                statfs={"total": 1 << 30, "used": 900 << 20,
                        "avail": (1 << 30) - (900 << 20),
                        "num_objects": 12},
                # v5: the unflushed-dirt roster the mon's
                # safe-to-destroy / ok-to-stop predicates consume
                cache_dirty=[("3:wb/obj", [1, 2, 3]),
                             ("1:solo", [3])]),
        # v3: the embedded OsdInfo/incremental records grew the
        # crush_weight tail (golden MMapReply.v2_precrushweight pins
        # the pre-change decode).  Archived with default payloads —
        # the map itself is not JSON-able; the sidecar pins the field
        # NAMES and the golden frame pins a real-map decode.
        t.MMapReply(tid="t19"),
        t.MOsdMembership(op="crush-reweight", osd_id=4, weight=2.5,
                         tid="t20"),
        # runtime crush topology plane: the hierarchy-surgery command
        # (v2 tail: force) and its typed reply
        t.MCrushOp(op="move", name="host2", bucket_type="host",
                   dest="rack1", weight=3.5, tid="t21", force=True),
        t.MCrushOpReply(tid="t21", ok=False,
                        error="EINVAL: would create a cycle", epoch=55),
        # data-safety predicates: the query and the render-friendly
        # reply (v2 tail: the cache-dirt clause counters/keys)
        t.MOsdPredicate(op="ok-to-stop", osd_ids=[2, 5], tid="t22"),
        t.MOsdPredicateReply(tid="t22", op="ok-to-stop", safe=False,
                             unsafe_ids=[5],
                             reasons=["pg 1.3 would drop below "
                                      "min_size"],
                             pgs_checked=16, dirty_blocked=2,
                             dirty_keys=["3:wb/obj@osd.5"]),
        t.MSetFullRatio(which="backfillfull", ratio=0.9, tid="t18"),
        t.MOSDFailure(target_osd=4, from_osd=1, failed_for=12.5,
                      tid="t11"),
        t.MOSDBackoff(op="unblock", pool_id=2, pg=9, id="bk-1", epoch=33,
                      duration=1.5, trace_id="deadbeefcafef00d",
                      span_id="0011223344556677"),
        t.MOSDPGHitSet(pool_id=3, pg=7, from_osd=2, epoch=44,
                       archive=arch.encode(now=103.0),
                       trace_id="deadbeefcafef00d",
                       span_id="8899aabbccddeeff"),
        t.MGetHealth(tid="t12", detail=True),
        t.MHealthReply(tid="t12", health={
            "status": "HEALTH_WARN",
            "checks": {"SLOW_OPS": {"severity": "warning",
                                    "summary": "1 slow ops"}},
            "muted": {}}),
        t.MHealthMute(check="SLOW_OPS", ttl=30.0, unmute=False,
                      tid="t13"),
        # cluster log + crash telemetry plane (clog.py): the ClogEntry
        # blob codec and every frame of the plane are corpus-pinned
        t.MLog(who="osd.3", entries=clog_blob),
        t.MLogAck(who="osd.3", last_seq=9001),
        t.MLogSubscribe(tid="t14", channel="audit", level=3, last_n=20,
                        sub=True),
        t.MLogReply(tid="t14", entries=clog_blob),
        t.MCrashReport(entity="osd.3", crash_id="2026-08-03_12:00:00Z_abc",
                       stamp=1700000002.75, version="1.0.0-tpu",
                       exception="RuntimeError('corpus')",
                       backtrace="Traceback...\n  corpus frame\n",
                       recent=clog_blob, tid="t15"),
        t.MCrashReportAck(tid="t15", ok=False),
        t.MCrashQuery(tid="t16", op="prune", crash_id="2026-08-03_x",
                      keep=86400.0),
        t.MCrashQueryReply(tid="t16", ok=False, error="no crash",
                           crashes=[{"crash_id": "c1", "entity": "osd.1"}]),
        t.MCommand(tid="t17", target="osd.0", prefix="config set",
                   args={"key": "debug_ms", "value": "10"}),
        t.MCommandReply(tid="t17", ok=True, result={"success": True}),
        # wire-plane negotiation + fragmentation types (messenger.py):
        # the lane-handshake fields and the striped-segment layout are
        # corpus-pinned like every other data-plane type
        MLaneHello(group="aabbccdd00112233", lane=2, n_lanes=4,
                   proc="feedface", flags=1),
        MLaneSegment(gseq=24, idx=1, nfrags=3, total=48, off=16,
                     type_id=30, version=6, fixed=True,
                     header=b"HDRBYTES", chunk=b"C" * 16),
    ]


def _encode_frame(msg: Any) -> Tuple[bytes, Dict]:
    from ceph_tpu_torch.rados.messenger import encode_payload_parts

    payload, blob, fixed = encode_payload_parts(msg)
    blob_b = b"" if blob is None else bytes(blob)
    frame = (_FRAME_HDR.pack(type(msg).TYPE_ID, type(msg).VERSION,
                             1 if fixed else 0, len(payload))
             + payload + struct.pack("<I", len(blob_b)) + blob_b)
    expect = {k: _norm(v) for k, v in msg.__dict__.items()}
    return frame, {"type": type(msg).__name__,
                   "type_id": type(msg).TYPE_ID,
                   "version": type(msg).VERSION,
                   "fixed": bool(fixed),
                   "fields": expect}


def _norm(v: Any) -> Any:
    """Decoded value -> comparable JSON-ish form (tuples and lists
    collapse; bytes to hex)."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {"__hex__": bytes(v).hex()}
    if isinstance(v, tuple):
        return [_norm(x) for x in v]
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {"__dict__": {k: _norm(x) for k, x in v.items()}}
    return v


def create(directory: str = CORPUS_DIR) -> int:
    os.makedirs(directory, exist_ok=True)
    names = set()
    for msg in _sample_messages():
        frame, meta = _encode_frame(msg)
        base = meta["type"]
        n = 2
        while base in names:  # numbered variants: nothing overwrites
            base = f"{meta['type']}.alt{n}"
            n += 1
        names.add(base)
        with open(os.path.join(directory, base + ".frame"), "wb") as f:
            f.write(frame)
        with open(os.path.join(directory, base + ".json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
    print(f"archived {len(names)} frames to {directory}")
    return 0


def check(directory: str = CORPUS_DIR) -> int:
    import ceph_tpu_torch.rados.types  # noqa: F401 — registers the message set
    from ceph_tpu_torch.rados.messenger import decode_message

    failures = []
    frames = sorted(n for n in os.listdir(directory)
                    if n.endswith(".frame"))
    if not frames:
        print(f"no archived frames in {directory}", file=sys.stderr)
        return 1
    import dataclasses

    for name in frames:
        try:
            with open(os.path.join(directory, name), "rb") as f:
                raw = f.read()
            with open(os.path.join(directory,
                                   name[:-6] + ".json")) as f:
                meta = json.load(f)
            type_id, version, fixed, plen = _FRAME_HDR.unpack_from(raw, 0)
            off = _FRAME_HDR.size
            payload = raw[off:off + plen]
            off += plen
            (blen,) = struct.unpack_from("<I", raw, off)
            blob = raw[off + 4:off + 4 + blen] if blen else None
        except Exception as e:
            failures.append(f"{name}: unreadable archive entry: {e}")
            continue
        try:
            msg = decode_message(type_id, version, payload, blob,
                                 bool(fixed))
        except Exception as e:
            failures.append(f"{name}: decode failed: {e}")
            continue
        got = {k: _norm(v) for k, v in msg.__dict__.items()}
        want = meta["fields"]
        if got != want:
            diffs = sorted(set(got) ^ set(want)) or [
                k for k in want if got.get(k) != want[k]]
            failures.append(f"{name}: field drift: {diffs}")
            continue
        # pickled payloads restore ARCHIVED attribute names verbatim, so
        # equality above cannot catch a rename of a control-plane field:
        # also pin the archive's names against the CURRENT dataclass
        # declaration
        names_now = {f.name for f in dataclasses.fields(type(msg))}
        if set(want) != names_now:
            failures.append(
                f"{name}: declared fields drifted: "
                f"{sorted(set(want) ^ names_now)}")
    # golden replay: frames archived by OLDER builds (e.g. pre-trace-id
    # layouts) must still DECODE — field values aren't compared (the new
    # fields default), only that the truncated-tail rule holds
    golden_dir = os.path.join(directory, "golden")
    golden = sorted(n for n in os.listdir(golden_dir)
                    if n.endswith(".frame")) \
        if os.path.isdir(golden_dir) else []
    for name in golden:
        try:
            with open(os.path.join(golden_dir, name), "rb") as f:
                raw = f.read()
            type_id, version, fixed, plen = _FRAME_HDR.unpack_from(raw, 0)
            off = _FRAME_HDR.size
            payload = raw[off:off + plen]
            off += plen
            (blen,) = struct.unpack_from("<I", raw, off)
            blob = raw[off + 4:off + 4 + blen] if blen else None
            decode_message(type_id, version, payload, blob, bool(fixed))
        except Exception as e:
            failures.append(f"golden/{name}: old frame no longer "
                            f"decodes: {e}")
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    print(f"{len(frames)} archived frames decode byte-exactly"
          + (f"; {len(golden)} golden old frames still decode"
             if golden else ""))
    return 0


class CoverageGap:
    """One FIXED message type missing one leg of its safety net."""

    __slots__ = ("type_name", "kind", "file", "line", "message")

    def __init__(self, type_name: str, kind: str, file: str, line: int,
                 message: str):
        self.type_name = type_name
        self.kind = kind  # "corpus" | "dencoder" | "golden"
        self.file = file
        self.line = line
        self.message = message


def _decl_site(cls) -> Tuple[str, int]:
    """(repo-relative file, line) a message class is declared at."""
    import inspect

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        src = inspect.getsourcefile(cls)
        _, line = inspect.getsourcelines(cls)
        return os.path.relpath(src, repo), line
    except (OSError, TypeError):
        return "corpus/wire", 1


def fixed_types() -> Dict[int, type]:
    """Registered message types with a FIXED binary layout (the
    data-plane set whose bytes the corpus pins).  Scoped to classes
    declared inside the ceph_tpu package: tests register fixture
    messages into the same process-global registry, and those are not
    wire ABI."""
    import ceph_tpu_torch.mgr.daemon  # noqa: F401 — registers mgr types
    import ceph_tpu_torch.rados.types  # noqa: F401 — registers the core set
    from ceph_tpu_torch.rados.messenger import _MSG_TYPES

    return {tid: cls for tid, cls in _MSG_TYPES.items()
            if getattr(cls, "FIXED_FIELDS", None) is not None
            and cls.__module__.startswith("ceph_tpu_torch.")}


def coverage_gaps(directory: str = CORPUS_DIR) -> List[CoverageGap]:
    """The coverage walk ``--strict`` and tpu-lint share: every FIXED
    type needs an archived frame, a dencoder round-trip, and (when
    versioned) a golden old-build frame."""
    from ceph_tpu_torch.rados.messenger import decode_message, \
        encode_payload_parts

    gaps: List[CoverageGap] = []
    frames = set(os.listdir(directory)) if os.path.isdir(directory) \
        else set()
    golden_dir = os.path.join(directory, "golden")
    golden = set(os.listdir(golden_dir)) if os.path.isdir(golden_dir) \
        else set()
    for tid, cls in sorted(fixed_types().items()):
        name = cls.__name__
        file, line = _decl_site(cls)
        if not any(f == f"{name}.frame"
                   or (f.startswith(f"{name}.alt") and f.endswith(".frame"))
                   for f in frames):
            gaps.append(CoverageGap(
                name, "corpus", file, line,
                f"FIXED message {name} (id {tid}) has no archived frame "
                f"in corpus/wire — run `wire_corpus --create` after "
                f"adding it to _sample_messages()"))
        try:
            msg = cls()
            payload, blob, fixed = encode_payload_parts(msg)
            back = decode_message(
                tid, cls.VERSION, payload,
                None if blob is None else bytes(blob), fixed)
            if {k: _norm(v) for k, v in back.__dict__.items()} \
                    != {k: _norm(v) for k, v in msg.__dict__.items()}:
                raise ValueError("default instance did not round-trip "
                                 "field-identically")
        except Exception as e:
            gaps.append(CoverageGap(
                name, "dencoder", file, line,
                f"FIXED message {name} fails the dencoder round-trip: "
                f"{type(e).__name__}: {e}"))
        if cls.VERSION >= 2 and not any(
                f.startswith(f"{name}.") and f.endswith(".frame")
                for f in golden):
            gaps.append(CoverageGap(
                name, "golden", file, line,
                f"FIXED message {name} is v{cls.VERSION} but has no "
                f"golden old-build frame under corpus/wire/golden — "
                f"archive a pre-bump frame so the truncated-tail decode "
                f"rule stays replay-guarded"))
    return gaps


def check_strict(directory: str = CORPUS_DIR) -> int:
    gaps = coverage_gaps(directory)
    for g in gaps:
        print(f"FAIL {g.file}:{g.line}: [{g.kind}] {g.message}",
              file=sys.stderr)
    if not gaps:
        print(f"{len(fixed_types())} FIXED types fully covered "
              f"(corpus + dencoder + golden where versioned)")
    return 1 if gaps else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="wire-format corpus")
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--strict", action="store_true",
                   help="with --check: also fail on FIXED types missing "
                        "corpus/dencoder/golden coverage")
    p.add_argument("--dir", default=CORPUS_DIR)
    args = p.parse_args(argv)
    if args.create:
        return create(args.dir)
    rc = check(args.dir)
    if args.strict:
        rc = check_strict(args.dir) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
