# Copy of ceph_tpu/rados/pglog.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; what it reads back from the
# wire or a store unpickles through rados/unpickle.py.
"""PG log: the per-PG replicated operation log driving delta recovery.

Role-equivalent of the reference's PGLog (reference src/osd/PGLog.{h,cc}):
every PG mutation appends a log entry (version, object, op, prior_version,
reqid) on EVERY acting shard, atomically with the object write.  The log
is the source of three guarantees:

- **dup detection**: a client resend (same reqid) is recognized and not
  re-applied (reference pg log dup entries; our mon does the same for its
  own writes);
- **delta recovery**: after an interval change, peers diff logs — entries
  the authoritative log has past a peer's last_update become that peer's
  *missing set*, and only those objects move (PGLog::merge_log /
  calc_missing); a peer whose last_update predates the log tail cannot be
  caught up by log replay and falls back to BACKFILL (full scan);
- **divergence handling**: a shard holding entries NEWER than the
  authoritative head (it accepted writes the failed primary never
  committed cluster-wide) rolls them back (reference rollback machinery,
  ECBackend::rollback_append).

Versions are (epoch, seq) pairs ordered lexicographically, the reference's
eversion_t.  Persistence: entries ride the object store's omap under a
per-PG meta object, written in the SAME transaction as the shard data.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ceph_tpu_torch.rados import unpickle

Version = Tuple[int, int]  # (epoch, seq) — eversion_t role

ZERO: Version = (0, 0)


def pack_eversion(v: Version) -> int:
    """eversion -> one epoch-major ordered int, the version stamped on
    shard metadata.  Shard 'newest' resolution (reads, recovery, backfill)
    thereby follows PG-log order, never wall clocks: a failover primary on
    a slow clock still outranks pre-failover writes because its epoch is
    higher (the reference orders by eversion_t everywhere, e.g.
    src/osd/osd_types.h eversion_t)."""
    return (v[0] << 32) | (v[1] & 0xFFFFFFFF)


@dataclass
class LogEntry:
    version: Version
    op: str  # "write" | "delete"
    oid: str
    prior_version: Version = ZERO
    reqid: str = ""
    object_version: int = 0  # the data version stamped on the shards

    def encode(self) -> bytes:
        return pickle.dumps(self.__dict__, protocol=5)

    @classmethod
    def decode(cls, blob: bytes) -> "LogEntry":
        e = cls.__new__(cls)
        e.__dict__.update(unpickle.loads(blob))
        return e


@dataclass
class PGLog:
    """In-memory log window [tail, head] plus a reqid dup set."""

    entries: List[LogEntry] = field(default_factory=list)
    tail: Version = ZERO  # everything <= tail has been trimmed
    max_entries: int = 500  # osd_min_pg_log_entries role
    _dups: Dict[str, Version] = field(default_factory=dict)

    @property
    def head(self) -> Version:
        return self.entries[-1].version if self.entries else self.tail

    def next_version(self, epoch: int) -> Version:
        h = self.head
        return (epoch, h[1] + 1)

    def append(self, entry: LogEntry) -> List[str]:
        """Append; returns omap keys of trimmed entries (caller removes
        them in its transaction — reference pg log trim)."""
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)
        if entry.reqid:
            self._dups[entry.reqid] = entry.version
        return self._trim()

    def _trim(self) -> List[str]:
        trimmed: List[str] = []
        while len(self.entries) > self.max_entries:
            dropped = self.entries.pop(0)
            self.tail = dropped.version
            trimmed.append(self._okey(dropped.version))
        while len(self._dups) > 4 * self.max_entries:
            self._dups.pop(next(iter(self._dups)))
        return trimmed

    def has_reqid(self, reqid: str) -> bool:
        return bool(reqid) and reqid in self._dups

    def latest_entry(self, oid: str) -> Optional[LogEntry]:
        """The newest log entry touching `oid` within the window, or None
        when the object has no entry here (trimmed away, or never
        written) — callers must then fall back to shard queries.  This is
        the primary's authoritative per-object version source (reference
        pg_log_t objects index role)."""
        for e in reversed(self.entries):
            if e.oid == oid:
                return e
        return None

    def entries_after(self, version: Version) -> Optional[List[LogEntry]]:
        """Entries with version > `version`, or None if `version` predates
        the tail (log can't catch that peer up -> backfill)."""
        if version < self.tail:
            return None
        return [e for e in self.entries if e.version > version]

    # -- recovery computation ------------------------------------------------

    def calc_missing(self, since: Version) -> Optional[Dict[str, LogEntry]]:
        """Objects a peer at `since` is missing: latest entry per oid among
        entries after `since` (None -> backfill needed)."""
        delta = self.entries_after(since)
        if delta is None:
            return None
        missing: Dict[str, LogEntry] = {}
        for e in delta:
            missing[e.oid] = e
        return missing

    def divergent_against(self, auth_head: Version) -> List[LogEntry]:
        """Our entries newer than the authoritative head: to roll back."""
        return [e for e in self.entries if e.version > auth_head]

    def rewind_to(self, version: Version) -> None:
        """Drop entries newer than `version` (after their effects were
        rolled back)."""
        self.entries = [e for e in self.entries if e.version <= version]

    # -- persistence ---------------------------------------------------------

    OMAP_PREFIX = "log."

    @staticmethod
    def _okey(version: Version) -> str:
        return f"{PGLog.OMAP_PREFIX}{version[0]:012d}.{version[1]:012d}"

    def omap_entries(self, entry: LogEntry) -> Dict[str, bytes]:
        """The omap mutation persisting one append (goes into the same
        store transaction as the shard write)."""
        return {self._okey(entry.version): entry.encode(),
                "info": pickle.dumps({"tail": self.tail}, protocol=5)}

    @classmethod
    def load(cls, omap: Dict[str, bytes], max_entries: int = 500) -> "PGLog":
        log = cls(max_entries=max_entries)
        info = omap.get("info")
        if info is not None:
            log.tail = tuple(unpickle.loads(info).get("tail", ZERO))
        entries = sorted(
            (k, v) for k, v in omap.items() if k.startswith(cls.OMAP_PREFIX)
        )
        for _, blob in entries:
            e = LogEntry.decode(blob)
            e.version = tuple(e.version)
            e.prior_version = tuple(e.prior_version)
            if e.version > log.tail:
                log.entries.append(e)
                if e.reqid:
                    log._dups[e.reqid] = e.version
        return log

