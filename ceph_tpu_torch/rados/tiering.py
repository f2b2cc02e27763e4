# Copy of ceph_tpu/rados/tiering.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Cache-tier machinery: HitSet temperature tracking + promote/evict policy.

Role-equivalent of the reference's cache-tier subsystem (reference
src/osd/HitSet.{h,cc} BloomHitSet over CompressibleBloomFilter,
src/common/bloom_filter.hpp; the tiering agent loop in
src/osd/PrimaryLogPG.cc agent_work/agent_choose_mode; promotion throttles
osd_tier_promote_max_objects_sec/_bytes_sec in OSD::promote_throttle).
Here the "fast tier" is not a second pool but the device itself:
PlanarShardStore HBM residents serve reads with zero shard reads and zero
decode, and this module supplies the POLICY for what deserves to stay
resident — per-PG bloom-filter hit archives rotated on hit_set_period,
a temperature estimator scored by which archived intervals contain an
object, token-bucket promotion throttles, and coldest-first eviction
candidate selection for the best-effort tier agent.

Everything here is pure state + math (no asyncio, no messenger): the OSD
owns the read-path hooks and the agent task; tests drive these classes
directly with injected clocks.
"""

from __future__ import annotations

import hashlib
import math
import struct
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder

# -- BloomHitSet -------------------------------------------------------------

_HITSET_MAGIC = 0xB1F5
_HITSET_VERSION = 1
# header: magic, version, seed, nhash, nbits, inserted, fpp (f64)
_HITSET_HDR = struct.Struct("<HHQHIIId")

_ARCHIVE_MAGIC = 0xA8C1
_ARCHIVE_VERSION = 1
# header: magic, version, n_sets, period, count, target_size, fpp
_ARCHIVE_HDR = struct.Struct("<HHIdIId")
_INTERVAL_HDR = struct.Struct("<ddI")  # start, end, blob length


class BloomHitSet:
    """Seeded double-hash bloom filter over object names (reference
    BloomHitSet / CompressibleBloomFilter): k index functions derived
    from two independent 64-bit digests as h1 + i*h2 (Kirsch-Mitzenmacher
    double hashing), sized from an expected insert count and a target
    false-positive rate.  The encoding is a pinned binary layout (struct
    header + raw bit bytes) checked by the wire corpus, so archives
    written by one version keep decoding in the next.
    """

    __slots__ = ("seed", "fpp", "target_size", "nbits", "nhash",
                 "inserted", "_bits")

    def __init__(self, target_size: int = 128, fpp: float = 0.05,
                 seed: int = 0):
        if not (0.0 < fpp < 1.0):
            raise ValueError(f"fpp must be in (0, 1), got {fpp}")
        target_size = max(1, int(target_size))
        # standard bloom sizing: m = -n*ln(p)/ln(2)^2, k = m/n * ln(2)
        nbits = int(math.ceil(-target_size * math.log(fpp)
                              / (math.log(2.0) ** 2)))
        self.nbits = max(8, nbits)
        self.nhash = max(1, int(round(self.nbits / target_size
                                      * math.log(2.0))))
        self.seed = seed & 0xFFFFFFFFFFFFFFFF
        self.fpp = fpp
        self.target_size = target_size
        self.inserted = 0
        self._bits = bytearray((self.nbits + 7) // 8)

    # -- hashing -------------------------------------------------------------

    def _digests(self, oid: str) -> Tuple[int, int]:
        """Two independent 64-bit digests of oid under this filter's
        seed.  blake2b is deterministic across processes and platforms
        (Python's hash() is salted per process and would make encoded
        hitsets meaningless to a peer)."""
        h = hashlib.blake2b(oid.encode(),
                            digest_size=16,
                            salt=self.seed.to_bytes(8, "little"))
        d = h.digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1  # odd: full period mod m
        return h1, h2

    def insert(self, oid: str) -> None:
        h1, h2 = self._digests(oid)
        for i in range(self.nhash):
            bit = (h1 + i * h2) % self.nbits
            self._bits[bit >> 3] |= 1 << (bit & 7)
        self.inserted += 1

    def __contains__(self, oid: str) -> bool:
        h1, h2 = self._digests(oid)
        for i in range(self.nhash):
            bit = (h1 + i * h2) % self.nbits
            if not self._bits[bit >> 3] & (1 << (bit & 7)):
                return False
        return True

    contains = __contains__

    # -- introspection -------------------------------------------------------

    def fill_ratio(self) -> float:
        ones = sum(bin(b).count("1") for b in self._bits)
        return ones / self.nbits

    def estimated_fpp(self) -> float:
        """The CURRENT false-positive probability from the observed fill
        ratio: P(all k probed bits set) = fill^k.  At the design insert
        count this approaches the configured target fpp."""
        return self.fill_ratio() ** self.nhash

    # -- binary encoding (pinned by the wire corpus) -------------------------

    def encode(self) -> bytes:
        return _HITSET_HDR.pack(_HITSET_MAGIC, _HITSET_VERSION, self.seed,
                                self.nhash, self.nbits, self.inserted,
                                self.target_size, self.fpp) + bytes(self._bits)

    @classmethod
    def decode(cls, blob: bytes, off: int = 0) -> Tuple["BloomHitSet", int]:
        """(hitset, next offset).  Raises ValueError on a foreign blob —
        a truncated or re-laid-out archive must fail loudly, not decode
        into a filter that answers garbage."""
        if len(blob) - off < _HITSET_HDR.size:
            raise ValueError("hitset blob truncated")
        magic, version, seed, nhash, nbits, inserted, target, fpp = \
            _HITSET_HDR.unpack_from(blob, off)
        if magic != _HITSET_MAGIC:
            raise ValueError(f"bad hitset magic {magic:#x}")
        if version > _HITSET_VERSION:
            raise ValueError(f"hitset version {version} from the future")
        # parameter sanity: the constructor can only produce nbits >= 8
        # and 1 <= nhash (k = m/n*ln2 stays small).  A blob outside
        # those ranges is corrupt or hostile — nbits=0 would divide by
        # zero on the primary read path, nhash=0 makes contains()
        # vacuously True (every object reads hot -> mass promotion).
        if nbits < 8 or not (1 <= nhash <= 64) or not (0.0 < fpp < 1.0):
            raise ValueError(
                f"implausible hitset params nbits={nbits} nhash={nhash} "
                f"fpp={fpp}")
        off += _HITSET_HDR.size
        nbytes = (nbits + 7) // 8
        if len(blob) - off < nbytes:
            raise ValueError("hitset bits truncated")
        hs = cls.__new__(cls)
        hs.seed = seed
        hs.fpp = fpp
        hs.target_size = target
        hs.nbits = nbits
        hs.nhash = nhash
        hs.inserted = inserted
        hs._bits = bytearray(blob[off:off + nbytes])
        return hs, off + nbytes


# -- per-PG archive ----------------------------------------------------------


class HitSetArchive:
    """One PG's rotating hit history (reference pg_hit_set_history_t +
    the in-memory HitSet the primary populates): a CURRENT BloomHitSet
    collecting this interval's hits plus up to ``count`` archived
    (start, end, hitset) intervals, newest first.  Rotation happens
    lazily on record()/rotate_due() when ``period`` elapses, so an idle
    PG costs nothing.

    Temperature is scored by WHICH intervals contain the object: the
    current set weighs 1.0 and each older archived interval half the
    previous (the reference agent's hit_set_grade_decay_rate shape), so
    a value in (0, 2) normalized to [0, 1] by the maximum possible
    score.  Recency is the reference's min_read_recency_for_promote
    operand: how many CONSECUTIVE sets, newest first (current included),
    contain the object.
    """

    def __init__(self, period: float = 2.0, count: int = 8,
                 target_size: int = 128, fpp: float = 0.05,
                 seed: int = 0, now: Optional[float] = None):
        self.period = max(1e-3, float(period))
        self.count = max(1, int(count))
        self.target_size = int(target_size)
        self.fpp = float(fpp)
        self.seed = seed
        now = time.monotonic() if now is None else now
        self.current_start = now
        self._gen = 0  # rotations so far: varies the per-interval seed
        self.current = self._fresh()
        # newest first; maxlen enforces hit_set_count expiry
        self.archived: Deque[Tuple[float, float, BloomHitSet]] = deque(
            maxlen=self.count)

    def _fresh(self) -> BloomHitSet:
        # distinct seed per interval: one unlucky oid/seed collision must
        # not read as "hot in every interval" forever
        return BloomHitSet(self.target_size, self.fpp,
                           seed=(self.seed << 16) ^ self._gen)

    def params_key(self) -> Tuple:
        """Identity of the tunables: a pool-opt change retunes archives
        (see :meth:`retune`)."""
        return (self.period, self.count, self.target_size, self.fpp)

    def retune(self, period: float, count: int, target_size: int,
               fpp: float) -> None:
        """Adopt new tunables WITHOUT discarding temperature history.
        The r10 behavior rebuilt the archive from scratch on any pool
        param change, flash-freezing the whole working set cold (every
        resident read as temperature 0 and the next agent pass evicted
        the lot).  Old intervals were sized for different guarantees,
        but they are still EVIDENCE of heat — they keep scoring; only
        future intervals are sized to the new params, and the archive
        re-bounds to the new count (oldest intervals expire first)."""
        self.period = max(1e-3, float(period))
        self.count = max(1, int(count))
        self.target_size = int(target_size)
        self.fpp = float(fpp)
        if self.archived.maxlen != self.count:
            keep = list(self.archived)[:self.count]
            self.archived = deque(keep, maxlen=self.count)

    # -- recording -----------------------------------------------------------

    def rotate_due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return now - self.current_start >= self.period

    def rotate(self, now: Optional[float] = None) -> None:
        """Archive the current interval and start a fresh one.  Empty
        intervals archive too — an interval with no hits is evidence of
        coldness, and skipping it would inflate recency across idle
        gaps."""
        now = time.monotonic() if now is None else now
        self.archived.appendleft((self.current_start, now, self.current))
        self._gen += 1
        self.current_start = now
        self.current = self._fresh()

    def record(self, oid: str, now: Optional[float] = None) -> bool:
        """Record one hit; returns True when this call ROTATED the
        archive (the owner replicates the encoded archive to peers on
        rotation, so a failover primary inherits temperature state)."""
        now = time.monotonic() if now is None else now
        rotated = False
        if self.rotate_due(now):
            self.rotate(now)
            rotated = True
        self.current.insert(oid)
        return rotated

    # -- scoring -------------------------------------------------------------

    def recency(self, oid: str) -> int:
        """Consecutive newest-first sets containing oid, current first
        (reference min_read_recency_for_promote semantics: 1 = in the
        current interval, 2 = current + previous, ...)."""
        n = 0
        if oid in self.current:
            n = 1
        else:
            return 0
        for _, _, hs in self.archived:
            if oid in hs:
                n += 1
            else:
                break
        return n

    def temperature(self, oid: str) -> float:
        """[0, 1] score: geometric decay over intervals, newest hottest.
        Monotone in interval membership — adding a hit in ANY interval
        never lowers the score, and a hit in a newer interval always
        outweighs the same hit in an older one."""
        score = 1.0 if oid in self.current else 0.0
        w = 0.5
        total = 1.0
        for _, _, hs in self.archived:
            if oid in hs:
                score += w
            total += w
            w *= 0.5
        return score / total

    def estimated_fpp(self) -> float:
        """Worst CURRENT fpp across live intervals (the `tier` perf
        gauge): when this exceeds the configured target the sets are
        overfull for their sizing and temperatures read hot."""
        worst = self.current.estimated_fpp()
        for _, _, hs in self.archived:
            worst = max(worst, hs.estimated_fpp())
        return worst

    # -- encode/decode (rides MOSDPGHitSet; pinned by the wire corpus) -------

    def encode(self, now: Optional[float] = None) -> bytes:
        """The whole archive, current interval included (closed at
        ``now``): the receiving peer reconstructs temperature state
        as-of this instant."""
        now = time.monotonic() if now is None else now
        sets: List[Tuple[float, float, BloomHitSet]] = [
            (self.current_start, now, self.current)]
        sets.extend(self.archived)
        parts = [_ARCHIVE_HDR.pack(_ARCHIVE_MAGIC, _ARCHIVE_VERSION,
                                   len(sets), self.period, self.count,
                                   self.target_size, self.fpp)]
        for start, end, hs in sets:
            blob = hs.encode()
            parts.append(_INTERVAL_HDR.pack(start, end, len(blob)))
            parts.append(blob)
        return b"".join(parts)

    @classmethod
    def decode(cls, blob: bytes,
               now: Optional[float] = None) -> "HitSetArchive":
        """Rebuild an archive from a peer's encoding.  The sender's
        timestamps are ITS monotonic clock — meaningless on this host —
        so every interval is rebased such that the sender's "now" (the
        close of its live current interval) maps to OUR `now`: relative
        ages survive the handoff, and rotate_due keeps working on the
        receiver instead of comparing clocks from different boots."""
        if len(blob) < _ARCHIVE_HDR.size:
            raise ValueError("hitset archive truncated")
        magic, version, n_sets, period, count, target, fpp = \
            _ARCHIVE_HDR.unpack_from(blob, 0)
        if magic != _ARCHIVE_MAGIC:
            raise ValueError(f"bad archive magic {magic:#x}")
        if version > _ARCHIVE_VERSION:
            raise ValueError(f"archive version {version} from the future")
        off = _ARCHIVE_HDR.size
        sets: List[Tuple[float, float, BloomHitSet]] = []
        for _ in range(n_sets):
            if len(blob) - off < _INTERVAL_HDR.size:
                raise ValueError("archive interval header truncated")
            start, end, _blen = _INTERVAL_HDR.unpack_from(blob, off)
            off += _INTERVAL_HDR.size
            hs, off = BloomHitSet.decode(blob, off)
            sets.append((start, end, hs))
        arch = cls(period=period, count=count, target_size=target, fpp=fpp)
        if sets:
            now = time.monotonic() if now is None else now
            shift = now - sets[0][1]  # sender's now -> our now
            # the encoder's first set was its live current interval:
            # adopt it as ours so recency survives the handoff
            arch.current_start = sets[0][0] + shift
            arch.current = sets[0][2]
            arch.archived.extend((s + shift, e + shift, h)
                                 for s, e, h in sets[1:])
            arch._gen = len(sets)
        return arch

    def dump(self) -> Dict[str, Any]:
        """`dump_hit_sets` admin-socket shape."""
        def one(start: float, end: float, hs: BloomHitSet) -> Dict[str, Any]:
            return {"start": round(start, 3), "end": round(end, 3),
                    "inserted": hs.inserted, "nbits": hs.nbits,
                    "nhash": hs.nhash,
                    "fill_ratio": round(hs.fill_ratio(), 4),
                    "estimated_fpp": round(hs.estimated_fpp(), 6)}

        return {
            "period": self.period, "count": self.count,
            "target_size": self.target_size, "target_fpp": self.fpp,
            "current": one(self.current_start, time.monotonic(),
                           self.current),
            "archived": [one(s, e, h) for s, e, h in self.archived],
        }


# -- promotion throttle ------------------------------------------------------


class PromoteThrottle:
    """Token-bucket pair bounding promotion load (reference
    osd_tier_promote_max_objects_sec / _bytes_sec in
    OSD::promote_throttle): a promotion is admitted only when BOTH
    buckets have capacity; refused promotions stay cold and retry on a
    later read.  Buckets hold at most one second's budget, so an idle
    period cannot bank an unbounded burst."""

    def __init__(self, max_objects_sec: float = 32.0,
                 max_bytes_sec: float = 64 << 20,
                 now: Optional[float] = None):
        self.max_objects_sec = float(max_objects_sec)
        self.max_bytes_sec = float(max_bytes_sec)
        # the objects bucket must hold at least ONE whole object, or a
        # fractional rate (0.5 objects/sec = one promotion every 2s)
        # could never admit anything
        self._obj_cap = max(1.0, self.max_objects_sec)
        now = time.monotonic() if now is None else now
        self._objects = self._obj_cap
        self._bytes = self.max_bytes_sec
        self._stamp = now

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self._stamp)
        self._stamp = now
        self._objects = min(self._obj_cap,
                            self._objects + dt * self.max_objects_sec)
        self._bytes = min(self.max_bytes_sec,
                          self._bytes + dt * self.max_bytes_sec)

    def allow(self, nbytes: int, now: Optional[float] = None) -> bool:
        """True (and charge the buckets) when a promotion of nbytes may
        proceed now.  A zero/negative limit disables that dimension."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        need_obj = 1.0 if self.max_objects_sec > 0 else 0.0
        need_bytes = float(nbytes) if self.max_bytes_sec > 0 else 0.0
        if self._objects < need_obj or self._bytes < need_bytes:
            return False
        self._objects -= need_obj
        self._bytes -= need_bytes
        return True


# -- eviction policy ---------------------------------------------------------


def eviction_candidates(entries: Iterable[Tuple[Any, int]],
                        temperature_of: Callable[[Any], float],
                        need_bytes: int) -> List[Tuple[Any, int]]:
    """Coldest-temperature-first eviction plan (reference
    agent_work's evict_effort ordering): ``entries`` is (key, nbytes)
    in LRU order (oldest first); ties on temperature break toward the
    LRU-older entry.  Returns the (key, nbytes) prefix whose combined
    footprint covers ``need_bytes``.  Pure function — the agent applies
    the plan against the live store and counts entries that vanished
    underneath it (LRU races) as no-ops."""
    if need_bytes <= 0:
        return []
    ranked = sorted(
        ((temperature_of(key), i, key, nbytes)
         for i, (key, nbytes) in enumerate(entries)),
        key=lambda t: (t[0], t[1]))
    plan: List[Tuple[Any, int]] = []
    freed = 0
    for _temp, _i, key, nbytes in ranked:
        if freed >= need_bytes:
            break
        plan.append((key, nbytes))
        freed += nbytes
    return plan


# -- the `tier` perf set -----------------------------------------------------


def build_tier_perf() -> PerfCounters:
    """Per-OSD `tier` counter set (dumped via `perf dump`, scraped by
    the mgr's /metrics, embedded in the BENCH record)."""
    return (
        PerfCountersBuilder("tier")
        .add_u64_counter("read_hits_recorded", "client reads recorded "
                                               "into the PG hit sets")
        .add_u64_counter("write_hits_recorded",
                         "client writes recorded into the PG hit sets "
                         "(write heat drives promotion like read heat)")
        .add_u64_counter("write_installs",
                         "writes that installed a resident through the "
                         "recency/throttle gate")
        .add_u64_counter("write_install_gated",
                         "write installs refused by the write-recency "
                         "gate (cold write set stays cold)")
        .add_u64_counter("write_install_throttled",
                         "write installs refused by the promote "
                         "throttle")
        .add_u64_counter("hitset_rotations", "hit-set intervals archived")
        .add_u64_counter("resident_hit",
                         "reads served from a device resident "
                         "(zero shard reads, zero decode)")
        .add_u64_counter("resident_hit_bytes",
                         "bytes served from device residents")
        .add_u64_counter("promote", "objects promoted to device residency")
        .add_u64_counter("promote_bytes", "logical bytes promoted")
        .add_u64_counter("promote_throttled",
                         "promotions refused by the rate throttle")
        .add_u64_counter("promote_stale",
                         "promotions abandoned (object changed while "
                         "the promote encode was in flight)")
        .add_u64_counter("promote_skipped",
                         "promotions skipped (codec not planar-eligible "
                         "or fadvise dontneed)")
        .add_u64_counter("agent_evict", "agent evictions applied")
        .add_u64_counter("agent_evict_bytes",
                         "resident bytes freed by the agent")
        .add_u64_counter("agent_evict_noop",
                         "agent evictions that found the entry already "
                         "gone (LRU race; counted, not an error)")
        .add_u64_counter("agent_pass", "agent passes that ran")
        .add_u64_counter("agent_skip",
                         "agent passes that found residency under target")
        .add_u64_counter("flush_agent",
                         "dirty residents flushed by the agent "
                         "(dirty-ratio / age / fullness pressure)")
        .add_u64_counter("flush_evict",
                         "dirty residents flushed to unblock an "
                         "eviction (flush-before-evict)")
        .add_u64_counter("flush_demote",
                         "dirty residents flushed on primaryship loss "
                         "(writeback is never the only copy)")
        .add_u64_counter("flush_rmw",
                         "dirty residents flushed ahead of a partial "
                         "(RMW) overwrite")
        .add_u64_counter("flush_scrub",
                         "dirty residents flushed ahead of a deep "
                         "scrub of their PG")
        .add_u64_counter("flush_error",
                         "flush attempts that failed (ENOSPC / raced "
                         "install) and left the entry dirty")
        .add_u64_counter("dirty_subread_served",
                         "peer sub-reads answered from dirty resident "
                         "pages (store copy was deferred)")
        .add_u64_counter("wb_repl_acks",
                         "writeback puts fast-acked at the cache quorum "
                         "(raw dirty replicas on osd_cache_min_size "
                         "processes; EC encode deferred to flush)")
        .add_u64_counter("wb_repl_bytes",
                         "raw dirty bytes replicated to cache peers on "
                         "the fast-ack path")
        .add_u64_counter("wb_dirty_adopted",
                         "raw dirty replicas adopted from a writeback "
                         "primary (replica-side MCacheDirty installs)")
        .add_u64_counter("wb_quorum_short",
                         "writeback puts that fell back to synchronous "
                         "writethrough (acting cache peers below "
                         "osd_cache_min_size, or replica acks short)")
        .add_u64_counter("flush_encodes",
                         "deferred k+m EC encodes performed by the "
                         "flush path (one per raw dirty object destaged)")
        .add_time_avg("agent_pass_s", "agent pass wall seconds")
        .add_u64("flush_backlog_bytes",
                 "acked-but-not-EC-durable raw dirty bytes awaiting "
                 "flush on this OSD (gauge)")
        .add_u64("resident_target_bytes",
                 "effective target_max_bytes (gauge)")
        .add_u64("hitset_fpp_ppm",
                 "worst live hit-set estimated false-positive rate, "
                 "parts per million (gauge)")
        .add_u64("hit_sets", "live per-PG hit-set archives (gauge)")
        .create_perf_counters()
    )
