# Copy of ceph_tpu/rados/clog.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Cluster log + crash telemetry plane.

Role-equivalent of the reference's LogClient/LogMonitor pair
(reference src/common/LogClient.cc, src/mon/LogMonitor.cc) and the crash
module (src/pybind/mgr/crash + the ceph-crash spool agent):

- ``LogClient``: every daemon owns one; ``clog.info/warn/error`` stamp a
  ``ClogEntry`` on a channel (``cluster`` by default, ``audit`` for admin
  commands), queue it, and a flush task batches pending entries into
  ``MLog`` frames sent to the mon.  Entries are ACKED (``MLogAck`` carries
  the highest seq the mon has durably taken) and everything unacked is
  resent next flush — the mon dedupes by (sender, seq), so mon failover
  and dropped acks cannot lose or double entries.

- ``LogMonitor``: the mon-side state machine — a bounded
  (``mon_cluster_log_entries``) tail of the cluster log that rides the
  mon's paxos snapshot, per-sender last-seq dedupe, the crash-report
  registry (``ceph crash ls/info/archive/prune``), and the RECENT_CRASH
  health check.  The Monitor streams newly committed entries to
  subscribed sessions (``ceph -w``).

- Crash telemetry: ``build_crash_report`` captures a dying daemon's
  ``Log.dump_recent`` ring at max verbosity + backtrace + identity into
  an ``MCrashReport``; when the mon is unreachable the report spools to
  a crash dir (cephadm crash-dir style) and replays at next boot.

The ``ClogEntry`` binary codec is append-only with per-record length
prefixes: new fields append at the record tail, old decoders skip the
remainder, and records from OLDER builds (shorter) decode with defaults —
the truncated-tail discipline every wire blob in this tree follows,
pinned by corpus goldens.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import time
import traceback
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

# clog priorities (reference CLOG_DEBUG..CLOG_ERROR, LogEntry.h)
CLOG_DEBUG = 0
CLOG_INFO = 1
CLOG_SEC = 2
CLOG_WARN = 3
CLOG_ERROR = 4

PRIO_NAMES = {CLOG_DEBUG: "DBG", CLOG_INFO: "INF", CLOG_SEC: "SEC",
              CLOG_WARN: "WRN", CLOG_ERROR: "ERR"}
PRIO_BY_NAME = {"debug": CLOG_DEBUG, "info": CLOG_INFO, "sec": CLOG_SEC,
                "warn": CLOG_WARN, "warning": CLOG_WARN,
                "error": CLOG_ERROR, "err": CLOG_ERROR}

# default retained cluster-log tail (reference mon_cluster_log_* family)
DEFAULT_LOG_ENTRIES = 500
# unarchived crashes newer than this raise RECENT_CRASH (reference
# mgr/crash warn_recent_interval: two weeks)
DEFAULT_CRASH_WARN_AGE = 14 * 24 * 3600.0
DEFAULT_CRASH_MAX = 64


def _cget(conf, key, default):
    try:
        v = conf.get(key, default)
    except Exception:
        return default
    return default if v is None else v


@dataclass
class ClogEntry:
    """One cluster-log line (reference LogEntry, src/common/LogEntry.h):
    who said it, on which channel, at what priority.  ``seq`` is the
    SENDER's monotonic sequence (the ack/dedupe key); ``idx`` is the
    mon-assigned global position (the watcher-stream cursor) — 0 until
    the LogMonitor takes the entry."""

    stamp: float = 0.0
    name: str = ""
    channel: str = "cluster"
    prio: int = CLOG_INFO
    seq: int = 0
    message: str = ""
    idx: int = 0

    def render(self) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.stamp))
        frac = f"{self.stamp % 1:.3f}"[1:]
        return (f"{ts}{frac} {self.name} [{PRIO_NAMES.get(self.prio, '?')}]"
                f" ({self.channel}) {self.message}")


# -- binary codec ------------------------------------------------------------
# blob = u8 version | u32 count | count x record
# record = u32 reclen | d stamp | s name | s channel | q prio | Q seq
#          | s message | Q idx
# (s = u32-length-prefixed utf8.)  APPEND-ONLY: new fields append inside
# the record; reclen lets old decoders skip them, and records from older
# builds (shorter) decode with defaults — corpus-golden-pinned.

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_D = struct.Struct("<d")
_Q = struct.Struct("<q")
_QU = struct.Struct("<Q")
CLOG_CODEC_VERSION = 1


def _pack_s(s: str) -> bytes:
    b = (s or "").encode()
    return _U32.pack(len(b)) + b


def encode_entries(entries: List[ClogEntry]) -> bytes:
    parts = [_U8.pack(CLOG_CODEC_VERSION), _U32.pack(len(entries))]
    for e in entries:
        rec = b"".join((
            _D.pack(e.stamp), _pack_s(e.name), _pack_s(e.channel),
            _Q.pack(e.prio), _QU.pack(e.seq), _pack_s(e.message),
            _QU.pack(e.idx),
        ))
        parts.append(_U32.pack(len(rec)))
        parts.append(rec)
    return b"".join(parts)


def decode_entries(blob: bytes) -> List[ClogEntry]:
    if not blob:
        return []
    mv = memoryview(blob)
    off = 1  # version byte: layout within records is reclen-guarded
    (count,) = _U32.unpack_from(blob, off)
    off += 4
    out: List[ClogEntry] = []

    def _s(rec: memoryview, roff: int):
        (n,) = _U32.unpack_from(rec, roff)
        roff += 4
        return bytes(rec[roff:roff + n]).decode(), roff + n

    for _ in range(count):
        (reclen,) = _U32.unpack_from(blob, off)
        off += 4
        rec = mv[off:off + reclen]
        off += reclen
        e = ClogEntry()
        try:
            roff = 0
            e.stamp = _D.unpack_from(rec, roff)[0]
            roff += 8
            e.name, roff = _s(rec, roff)
            e.channel, roff = _s(rec, roff)
            e.prio = _Q.unpack_from(rec, roff)[0]
            roff += 8
            e.seq = _QU.unpack_from(rec, roff)[0]
            roff += 8
            e.message, roff = _s(rec, roff)
            e.idx = _QU.unpack_from(rec, roff)[0]
        except struct.error:
            pass  # truncated tail (older sender): remaining fields default
        out.append(e)
    return out


def encode_recent(ring) -> bytes:
    """The local Log ring ((stamp, subsys, level, message) tuples) as a
    ClogEntry blob — the crash report's max-verbosity history."""
    return encode_entries([
        ClogEntry(stamp=st, name="", channel=subsys, prio=lvl, message=msg)
        for st, subsys, lvl, msg in ring])


# -- LogClient ----------------------------------------------------------------


class LogClient:
    """Daemon-side cluster-log submitter (reference src/common/LogClient).

    Entries queue locally (bounded; overflow drops oldest and counts),
    the flush task batches them into MLog frames on a short cadence
    (errors kick an immediate flush), and unacked entries resend every
    flush until the mon acks their seq — mon-side (sender, seq) dedupe
    makes the resend idempotent.  Seqs start from a boot-time epoch so a
    restarted daemon reusing its name cannot collide with its past
    life's acked window."""

    def __init__(self, messenger, mons, name: str, conf=None,
                 local_log=None):
        self.messenger = messenger
        self.mons = mons  # MonTargets
        self.name = name
        self.conf = conf if conf is not None else {}
        self.local_log = local_log
        self._pending: "OrderedDict[int, ClogEntry]" = OrderedDict()
        self._max_pending = int(_cget(self.conf, "clog_max_pending", 2048))
        self._batch_max = 256
        self.dropped = 0
        self.sent = 0
        self.acked = 0
        # boot-time seq epoch (micros << 8): a restarted daemon reusing
        # its name starts past its old life's acked window, so the mon's
        # last_seq dedupe cannot swallow post-restart entries
        self._seq = int(time.time() * 1e6) << 8
        self._interval = float(
            _cget(self.conf, "mon_client_log_interval", 0.25))
        self._task: Optional[asyncio.Task] = None
        self._kick: Optional[asyncio.Event] = None
        self._stopped = False

    # -- emit -----------------------------------------------------------------

    def do_log(self, channel: str, prio: int, message: str) -> ClogEntry:
        if self._task is None and not self._stopped:
            # self-heal a client created before its event loop existed:
            # the first emit from inside a loop starts the flush task
            try:
                self.start()
            except RuntimeError:
                pass  # still no loop: entries queue for a later flush
        self._seq += 1
        e = ClogEntry(stamp=time.time(), name=self.name, channel=channel,
                      prio=prio, seq=self._seq, message=str(message))
        self._pending[e.seq] = e
        while len(self._pending) > self._max_pending:
            self._pending.popitem(last=False)
            self.dropped += 1
        if self.local_log is not None:
            # mirror into the daemon's own log (and its crash ring)
            self.local_log.dout(
                "clog", 1,
                f"[{channel} {PRIO_NAMES.get(prio, '?')}] {message}")
        if prio >= CLOG_ERROR and self._kick is not None:
            self._kick.set()
        return e

    def debug(self, message: str, channel: str = "cluster") -> None:
        self.do_log(channel, CLOG_DEBUG, message)

    def info(self, message: str, channel: str = "cluster") -> None:
        self.do_log(channel, CLOG_INFO, message)

    def warn(self, message: str, channel: str = "cluster") -> None:
        self.do_log(channel, CLOG_WARN, message)

    def error(self, message: str, channel: str = "cluster") -> None:
        self.do_log(channel, CLOG_ERROR, message)

    def audit(self, message: str, prio: int = CLOG_INFO) -> None:
        self.do_log("audit", prio, message)

    # -- ack / flush ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    def handle_ack(self, msg) -> None:
        """MLogAck: the mon durably holds everything <= last_seq."""
        if getattr(msg, "who", "") and msg.who != self.name:
            return
        last = int(getattr(msg, "last_seq", 0) or 0)
        for seq in [s for s in self._pending if s <= last]:
            self._pending.pop(seq, None)
            self.acked += 1

    async def flush_now(self) -> bool:
        """One send attempt of everything pending (oldest first, batch-
        bounded).  True when a batch went out on the wire; the ack (and
        the pending-drop) arrives via the daemon's dispatcher."""
        if not self._pending:
            return True
        from ceph_tpu_torch.rados.types import MLog

        batch = list(self._pending.values())[: self._batch_max]
        try:
            await self.messenger.send(
                self.mons.current,
                MLog(who=self.name, entries=encode_entries(batch)))
            self.sent += len(batch)
            return True
        except (ConnectionError, OSError, asyncio.TimeoutError):
            self.mons.rotate()
            return False

    def start(self) -> None:
        if self._task is None:
            self._kick = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            await self.flush_now()  # best-effort final drain
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await asyncio.wait_for(self._kick.wait(),
                                       timeout=self._interval)
            except asyncio.TimeoutError:
                pass
            self._kick.clear()
            if self._pending:
                await self.flush_now()


# -- LogMonitor ---------------------------------------------------------------


class LogMonitor:
    """Mon-side cluster-log + crash state (reference src/mon/LogMonitor.cc
    + the mgr/crash module's registry).  Pure state machine: the Monitor
    owns paxos replication (this state rides its snapshot) and watcher
    streaming; everything here is synchronous and unit-testable."""

    def __init__(self, conf=None, local_log=None, name: str = "mon"):
        self.conf = conf if conf is not None else {}
        self.local_log = local_log
        self.name = name
        self.max_entries = int(
            _cget(self.conf, "mon_cluster_log_entries", DEFAULT_LOG_ENTRIES))
        self.entries: "deque[ClogEntry]" = deque(maxlen=self.max_entries)
        self.last_seq: Dict[str, int] = {}
        self._idx = 0
        self._own_seq = int(time.time() * 1000) << 16
        self.crashes: Dict[str, Dict] = {}
        self.crash_warn_age = float(
            _cget(self.conf, "mon_crash_warn_age", DEFAULT_CRASH_WARN_AGE))
        self.crash_max = int(
            _cget(self.conf, "mon_crash_max", DEFAULT_CRASH_MAX))
        # stored-ring byte budget per crash: the registry rides EVERY
        # paxos snapshot, so an unbounded dump_recent blob would be
        # re-pickled on every subsequent commit forever
        self.crash_recent_max = int(
            _cget(self.conf, "mon_crash_recent_max_bytes", 32 << 10))

    @property
    def last_idx(self) -> int:
        return self._idx

    # -- log ingest -----------------------------------------------------------

    def submit(self, who: str, entries: List[ClogEntry]) -> int:
        """Take a sender's batch: entries at or below the sender's acked
        seq are resends and drop; the rest get a global idx and join the
        tail.  Returns the sender's new last seq (the MLogAck value)."""
        last = self.last_seq.get(who, 0)
        for e in sorted(entries, key=lambda x: x.seq):
            if e.seq <= last:
                continue
            last = e.seq
            e.name = e.name or who
            self._append(e)
        if who:
            self.last_seq[who] = last
            while len(self.last_seq) > 1024:
                self.last_seq.pop(next(iter(self.last_seq)))
        return last

    def log(self, channel: str, prio: int, message: str,
            name: str = "") -> ClogEntry:
        """Mon-originated entry (mark-downs, boots, audit lines)."""
        self._own_seq += 1
        e = ClogEntry(stamp=time.time(), name=name or self.name,
                      channel=channel, prio=prio, seq=self._own_seq,
                      message=str(message))
        self._append(e)
        return e

    def _append(self, e: ClogEntry) -> None:
        self._idx += 1
        e.idx = self._idx
        self.entries.append(e)
        if self.local_log is not None:
            self.local_log.dout("clog", 2, e.render())

    # -- log queries ----------------------------------------------------------

    def tail(self, n: int = 0, level: Optional[int] = None,
             channel: str = "") -> List[ClogEntry]:
        """`ceph log last [n] [level] [channel]`: the newest n matching
        entries, oldest first (n<=0: everything retained)."""
        out = [e for e in self.entries
               if (level is None or e.prio >= level)
               and (not channel or e.channel == channel)]
        return out[-n:] if n and n > 0 else out

    def since(self, idx: int, level: Optional[int] = None,
              channel: str = "") -> List[ClogEntry]:
        """Entries with a global idx strictly past ``idx`` (the watcher
        stream cursor)."""
        return [e for e in self.entries
                if e.idx > idx
                and (level is None or e.prio >= level)
                and (not channel or e.channel == channel)]

    def channel_counts(self, level: int = CLOG_WARN) -> Dict[str, int]:
        """Per-channel count of retained entries at >= level (the BENCH
        record's cluster-log summary)."""
        out: Dict[str, int] = {}
        for e in self.entries:
            if e.prio >= level:
                out[e.channel] = out.get(e.channel, 0) + 1
        return out

    # -- crash registry -------------------------------------------------------

    def add_crash(self, report) -> bool:
        """Take an MCrashReport; False when the id is already known
        (spool replay / resend).  Oldest crashes prune past crash_max."""
        cid = report.crash_id
        if not cid or cid in self.crashes:
            return False
        recent = bytes(report.recent or b"")
        if len(recent) > self.crash_recent_max:
            # keep the NEWEST entries that fit the byte budget (the
            # moments before the crash are the valuable ones)
            ents = decode_entries(recent)
            while ents and len(recent) > self.crash_recent_max:
                ents = ents[max(1, len(ents) // 4):]
                recent = encode_entries(ents)
        self.crashes[cid] = {
            "crash_id": cid,
            "entity": report.entity,
            "stamp": float(report.stamp),
            "version": report.version,
            "exception": report.exception,
            "backtrace": report.backtrace,
            "recent": recent,
            "archived": False,
        }
        while len(self.crashes) > self.crash_max:
            oldest = min(self.crashes.values(), key=lambda c: c["stamp"])
            self.crashes.pop(oldest["crash_id"], None)
        return True

    def crash_ls(self, include_archived: bool = True) -> List[Dict]:
        rows = [
            {"crash_id": c["crash_id"], "entity": c["entity"],
             "stamp": c["stamp"], "exception": c["exception"],
             "archived": bool(c.get("archived"))}
            for c in self.crashes.values()
            if include_archived or not c.get("archived")
        ]
        rows.sort(key=lambda r: r["stamp"])
        return rows

    def crash_info(self, crash_id: str) -> Optional[Dict]:
        c = self.crashes.get(crash_id)
        if c is None:
            return None
        out = dict(c)
        out["recent"] = [
            {"stamp": e.stamp, "subsys": e.channel, "level": e.prio,
             "message": e.message}
            for e in decode_entries(c.get("recent") or b"")]
        return out

    def crash_archive(self, crash_id: str = "") -> int:
        """Archive one crash ('' = all): it stays listable but stops
        raising RECENT_CRASH.  Returns how many flipped."""
        n = 0
        for c in self.crashes.values():
            if (not crash_id or c["crash_id"] == crash_id) \
                    and not c.get("archived"):
                c["archived"] = True
                n += 1
        return n

    def crash_prune(self, keep_seconds: float) -> int:
        """Drop crashes older than ``keep_seconds`` (reference
        `ceph crash prune <keep>` keeps <keep> days)."""
        cutoff = time.time() - max(0.0, keep_seconds)
        dead = [cid for cid, c in self.crashes.items()
                if c["stamp"] < cutoff]
        for cid in dead:
            del self.crashes[cid]
        return len(dead)

    def health_checks(self) -> Dict[str, Dict]:
        """RECENT_CRASH (reference mgr/crash health warning): unarchived
        crashes newer than mon_crash_warn_age."""
        now = time.time()
        recent = [c for c in self.crashes.values()
                  if not c.get("archived")
                  and now - c["stamp"] < self.crash_warn_age]
        if not recent:
            return {}
        daemons = sorted({c["entity"] for c in recent})
        return {"RECENT_CRASH": {
            "severity": "warning",
            "count": len(recent),
            "summary": f"{len(recent)} daemons have recently crashed"
                       if len(recent) > 1 else
                       f"1 daemon has recently crashed",
            "detail": [f"{c['entity']} crashed at "
                       f"{time.strftime('%Y-%m-%dT%H:%M:%S', time.localtime(c['stamp']))}"
                       f": {c['exception']}" for c in recent[:16]],
        }}

    # -- snapshot (rides the mon's paxos state) -------------------------------

    def snapshot(self) -> Dict:
        return {
            "entries": [
                (e.stamp, e.name, e.channel, e.prio, e.seq, e.message,
                 e.idx) for e in self.entries],
            "last_seq": dict(self.last_seq),
            "idx": self._idx,
            "crashes": {cid: dict(c) for cid, c in self.crashes.items()},
        }

    def load(self, state: Optional[Dict]) -> None:
        """Adopt a committed snapshot, MERGING entries the local (leader)
        state appended after the snapshot was taken: a concurrent write's
        audit line must not vanish because another write's commit landed
        first.  Peons have no local appends, so this degrades to replace."""
        if not state:
            return
        snap = [ClogEntry(*t) for t in state.get("entries", [])]
        snap_idx = int(state.get("idx", 0))
        keep = [e for e in self.entries if e.idx > snap_idx]
        self.entries = deque(snap + keep, maxlen=self.max_entries)
        self.last_seq = dict(state.get("last_seq", {}))
        for e in keep:
            if e.name and e.seq:
                self.last_seq[e.name] = max(
                    self.last_seq.get(e.name, 0), e.seq)
        self._idx = max(self._idx, snap_idx)
        crashes = {cid: dict(c)
                   for cid, c in state.get("crashes", {}).items()}
        for cid, c in self.crashes.items():
            crashes.setdefault(cid, c)
        self.crashes = crashes


# -- crash capture + spool ----------------------------------------------------


def make_crash_id(stamp: Optional[float] = None) -> str:
    ts = time.strftime("%Y-%m-%d_%H:%M:%S",
                       time.gmtime(stamp if stamp is not None
                                   else time.time()))
    return f"{ts}Z_{uuid.uuid4().hex[:12]}"


def build_crash_report(exc: BaseException, entity: str,
                       version: str = "", log=None):
    """Capture a dying daemon's state into an MCrashReport: the full
    dump_recent ring at max verbosity (including the separately pinned
    error entries), the backtrace, and the daemon identity/version —
    the ceph-crash meta file, as a wire frame."""
    from ceph_tpu_torch.rados.types import MCrashReport

    ring = log.dump_recent() if log is not None else []
    return MCrashReport(
        entity=entity,
        crash_id=make_crash_id(),
        stamp=time.time(),
        version=version,
        exception=repr(exc),
        backtrace="".join(traceback.format_exception(exc)),
        recent=encode_recent(ring),
    )


def spool_crash(crash_dir: str, report) -> str:
    """Persist a crash report the mon could not take (cephadm crash-dir
    style: one ``<crash_id>/meta`` JSON per crash); replayed at next
    boot by ``replay_crash_spool``."""
    d = os.path.join(crash_dir, report.crash_id)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "meta")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "crash_id": report.crash_id,
            "entity": report.entity,
            "stamp": report.stamp,
            "version": report.version,
            "exception": report.exception,
            "backtrace": report.backtrace,
            "recent_hex": bytes(report.recent or b"").hex(),
        }, f)
    os.replace(tmp, path)
    return path


def list_spooled(crash_dir: str) -> List[Any]:
    """Spooled reports, oldest first (unreadable entries skipped)."""
    from ceph_tpu_torch.rados.types import MCrashReport

    out = []
    if not crash_dir or not os.path.isdir(crash_dir):
        return out
    for name in sorted(os.listdir(crash_dir)):
        path = os.path.join(crash_dir, name, "meta")
        try:
            with open(path) as f:
                meta = json.load(f)
            out.append(MCrashReport(
                entity=meta.get("entity", ""),
                crash_id=meta.get("crash_id", name),
                stamp=float(meta.get("stamp", 0.0)),
                version=meta.get("version", ""),
                exception=meta.get("exception", ""),
                backtrace=meta.get("backtrace", ""),
                recent=bytes.fromhex(meta.get("recent_hex", ""))))
        except (OSError, ValueError, TypeError):
            continue
    out.sort(key=lambda r: r.stamp)
    return out


def clear_spooled(crash_dir: str, crash_id: str) -> None:
    d = os.path.join(crash_dir, crash_id)
    try:
        os.unlink(os.path.join(d, "meta"))
        os.rmdir(d)
    except OSError:
        pass


async def replay_crash_spool(crash_dir: str, send: Callable) -> int:
    """Boot-time spool replay: ``send(report)`` must return truthy on a
    durable mon ack; acked spool entries are removed.  Returns how many
    replayed."""
    n = 0
    for report in list_spooled(crash_dir):
        try:
            ok = await send(report)
        except Exception:
            ok = False
        if ok:
            clear_spooled(crash_dir, report.crash_id)
            n += 1
    return n


def describe_command(msg, max_len: int = 160) -> str:
    """One-line audit rendering of a mon write command: the type name
    plus EVERY scalar field (blobs/maps and empty strings elided) —
    what lands on the ``audit`` channel for every admin mutation.  An
    audit record favors completeness over brevity: dropping falsy
    values would erase `osd down 0`'s target (0 is a valid osd id)."""
    parts = []
    for k, v in vars(msg).items():
        if k in ("tid", "inner", "entries", "recent", "backtrace"):
            continue
        if isinstance(v, (str, int, float, bool)) and v != "":
            s = str(v)
            if len(s) > 48:
                s = s[:45] + "..."
            parts.append(f"{k}={s}")
    out = f"{type(msg).__name__} {' '.join(parts)}".strip()
    return out[:max_len]
