# Copy of ceph_tpu/rados/extent_cache.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Primary-side extent cache (reference src/osd/ExtentCache.{h,cc}).

The reference pins the stripe extents an in-flight RMW read/wrote so
back-to-back partial overwrites to one object pipeline instead of
re-reading (`reserve_extents_for_rmw` / `present_rmw_update`, used at
ECBackend.cc:1952,2070).  This cache is its role-equivalent at the
granularity the RMW path actually uses: per-object EXTENT maps, versioned
— a partial overwrite caches only the stripes it decoded and wrote, and
the next overlapping write serves its RMW read from those extents without
touching the shards.

Entries are versioned: a get at the wrong version misses (the object
moved under us — failover, recovery push, concurrent interval), and any
put at a newer version drops the stale extents.  Whole-object entries are
extents covering [0, size) with `full=True`, preserving the previous
whole-object behavior for reads and full writes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

Key = Tuple[int, str]  # (pool_id, oid)


class _Entry:
    __slots__ = ("version", "extents", "full", "size")

    def __init__(self, version: int):
        self.version = version
        # sorted non-overlapping [start, bytes] runs
        self.extents: List[Tuple[int, bytes]] = []
        self.full = False  # extents cover the whole object
        self.size = 0  # object size when full; else last known size hint

    def insert(self, start: int, data: bytes) -> None:
        """Insert/overwrite a run, merging overlaps and adjacency."""
        merged: List[Tuple[int, bytes]] = []
        placed = False
        new_start, new_data = start, data
        for s, b in self.extents:
            e = s + len(b)
            if e < new_start or s > new_start + len(new_data):
                merged.append((s, b))
                continue
            # overlap/adjacent: splice the old run around the new bytes
            lo = min(s, new_start)
            pre = b[: max(0, new_start - s)]
            post = b[max(0, new_start + len(new_data) - s):]
            new_data = pre + new_data + post
            new_start = lo
        for i, (s, _b) in enumerate(merged):
            if s > new_start:
                merged.insert(i, (new_start, new_data))
                placed = True
                break
        if not placed:
            merged.append((new_start, new_data))
        self.extents = merged

    def read(self, start: int, length: int) -> Optional[bytes]:
        """The bytes of [start, start+length) iff FULLY covered."""
        end = start + length
        if self.full and start >= self.size:
            return b""  # past EOF on a fully-known object reads as empty
        for s, b in self.extents:
            e = s + len(b)
            if s <= start < e:
                if end <= e:
                    return b[start - s: end - s]
                if self.full and e == self.size:
                    # short tail of a fully-known object: zero-extend is
                    # NOT valid for RMW reads (stripes past EOF are
                    # synthesized by the caller) — return what exists
                    return b[start - s:]
                return None
        return None


class ExtentCache:
    def __init__(self, max_objects: int = 64):
        self.max_objects = max_objects
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()

    def _entry_for_put(self, key: Key, version: int) -> Optional[_Entry]:
        ent = self._entries.get(key)
        if ent is not None and ent.version > version:
            return None  # stale write-back: newer state already cached
        if ent is None or ent.version < version:
            ent = _Entry(version)
            self._entries[key] = ent
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_objects:
            self._entries.popitem(last=False)
        return ent

    def put_full(self, key: Key, version: int, data: bytes) -> None:
        ent = self._entry_for_put(key, version)
        if ent is None:
            return
        ent.extents = [(0, bytes(data))]
        ent.full = True
        ent.size = len(data)

    def put_extent(self, key: Key, version: int, start: int,
                   data: bytes, size_hint: int = 0,
                   carry_from: int = 0) -> None:
        """Cache one extent at `version`.  ``carry_from``: when the cached
        entry sits at exactly that (older) version, upgrade it in place
        and KEEP its other extents — valid only when the caller knows the
        version step changed nothing outside this extent (the primary's
        own RMW write, serialized per PG).  ``size_hint`` records the
        object size the caller learned (shard metadata) so later RMW
        planners need not re-stat."""
        ent = self._entries.get(key)
        if (carry_from and ent is not None and not ent.full
                and ent.version == carry_from and version > carry_from):
            ent.version = version
            self._entries.move_to_end(key)
        else:
            ent = self._entry_for_put(key, version)
            if ent is None:
                return
        ent.insert(start, bytes(data))
        if ent.full:
            ent.size = max(ent.size, start + len(data))
        elif size_hint:
            ent.size = max(ent.size, size_hint)

    def get_full(self, key: Key) -> Optional[Tuple[int, bytes]]:
        ent = self._entries.get(key)
        if ent is None or not ent.full:
            return None
        self._entries.move_to_end(key)
        return ent.version, ent.extents[0][1] if ent.extents else b""

    def get_range(self, key: Key, start: int,
                  length: int) -> Optional[Tuple[int, bytes, int]]:
        """(version, bytes, size_hint) for [start, start+length) when
        fully cached (size_hint 0 = unknown)."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        got = ent.read(start, length)
        if got is None:
            return None
        self._entries.move_to_end(key)
        return ent.version, got, ent.size

    def drop(self, key: Key) -> None:
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)
