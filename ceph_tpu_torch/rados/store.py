# Copy of ceph_tpu/rados/store.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Object stores: the per-OSD persistence layer.

Equivalent role to the reference's ObjectStore hierarchy (reference
src/os/ObjectStore.h:229 queue_transactions): atomic transactions over
(object, shard) -> bytes + metadata, with commit callbacks.  MemStore is
the RAM store the reference also ships for testing (src/os/memstore/);
DirStore persists shards as files (a minimal filestore) so OSD restart
tests survive process death.
"""

from __future__ import annotations

import errno
import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

Key = Tuple[int, str, int]  # (pool_id, oid, shard)


class ENOSPCError(OSError):
    """Typed out-of-space failure (reference -ENOSPC from
    BlueStore::_do_alloc_write past osd_failsafe_full_ratio): raised by a
    store BEFORE it mutates anything, so a refused transaction leaves the
    store byte-identical.  The OSD turns this into a typed ENOSPC reply
    the client treats as definitive (no resend loop)."""

    def __init__(self, message: str):
        super().__init__(errno.ENOSPC, message)


class Owned:
    """Write-ownership marker (reference bufferlist move semantics on
    queue_transactions): the writer guarantees the wrapped buffer is
    never read or written by it again, so a RAM-backed store may keep
    the view as-is instead of taking the defensive freeze copy it
    otherwise needs — with local fast dispatch, sub-write chunks arrive
    by reference over encode-output arrays, and copying 16 MiB per
    shard per write is the single largest cost on the daemon data
    path.  Disk-backed stores unwrap and copy to media regardless."""

    __slots__ = ("view",)

    def __init__(self, buf):
        self.view = buf if isinstance(buf, memoryview) else memoryview(buf)


def unwrap(chunk):
    return chunk.view if isinstance(chunk, Owned) else chunk


@dataclass
class ShardMeta:
    version: int = 0
    object_size: int = 0  # original (untrimmed) object length
    chunk_crc: int = 0  # crc32 of the shard (HashInfo role,
    # reference src/osd/ECUtil.h:101-160)


@dataclass
class Transaction:
    """Atomic batch of shard writes/deletes plus omap mutations (the PG
    log rides omap in the same transaction as the data, the reference's
    log_operation + queue_transactions coupling)."""

    writes: List[Tuple[Key, bytes, ShardMeta]] = field(default_factory=list)
    deletes: List[Key] = field(default_factory=list)
    omap_sets: List[Tuple[Key, Dict[str, bytes]]] = field(default_factory=list)
    omap_rms: List[Tuple[Key, List[str]]] = field(default_factory=list)

    def write(self, key: Key, chunk: bytes, meta: ShardMeta) -> None:
        self.writes.append((key, chunk, meta))

    def delete(self, key: Key) -> None:
        self.deletes.append(key)

    def omap_set(self, key: Key, entries: Dict[str, bytes]) -> None:
        self.omap_sets.append((key, dict(entries)))

    def omap_rm(self, key: Key, keys: List[str]) -> None:
        self.omap_rms.append((key, list(keys)))


class ObjectStore:
    # byte ceiling (0 = unlimited) + the last-resort guard protecting the
    # store itself (reference osd_failsafe_full_ratio): a transaction
    # whose writes would push used bytes past failsafe_ratio * capacity
    # is refused with a typed ENOSPCError BEFORE anything mutates.
    # Deletes always pass — they are the only way back out of full.
    capacity_bytes: int = 0
    failsafe_ratio: float = 0.97

    def queue_transaction(self, txn: Transaction, on_commit=None) -> None:
        raise NotImplementedError

    def statfs(self) -> Dict[str, int]:
        """Uniform utilization shape every store reports (reference
        ObjectStore::statfs): {total, used, avail, num_objects}.
        total == 0 means no configured capacity (unlimited)."""
        n = sum(1 for p in self.list_pools()
                for _ in self.list_objects(p))
        return {"total": int(self.capacity_bytes), "used": 0,
                "avail": int(self.capacity_bytes), "num_objects": n}

    def _check_failsafe(self, incoming_bytes: int, used_bytes: int) -> None:
        """Refuse (typed ENOSPC) when accepting ``incoming_bytes`` more
        would cross the failsafe ceiling.  Conservative: freed bytes from
        same-transaction deletes/overwrites are not credited — near the
        failsafe line the store errs on refusal (delete-only transactions
        carry no writes and always pass)."""
        cap = int(self.capacity_bytes or 0)
        if cap <= 0 or incoming_bytes <= 0:
            return
        ceiling = int(cap * float(self.failsafe_ratio))
        if used_bytes + incoming_bytes > ceiling:
            raise ENOSPCError(
                f"failsafe full: used {used_bytes} + incoming "
                f"{incoming_bytes} > {ceiling} "
                f"({self.failsafe_ratio:g} of {cap})")

    def read(self, key: Key) -> Optional[Tuple[bytes, ShardMeta]]:
        raise NotImplementedError

    def list_objects(self, pool_id: int) -> Iterable[Tuple[str, int]]:
        """Yield (oid, shard) pairs stored for a pool."""
        raise NotImplementedError

    def list_pools(self) -> Iterable[int]:
        """Pool ids with at least one stored shard (boot-time sweep for
        pools deleted while this OSD was down)."""
        raise NotImplementedError

    def omap_get(self, key: Key) -> Dict[str, bytes]:
        return {}

    def omap_set(self, key: Key, entries: Dict[str, bytes]) -> None:
        raise NotImplementedError

    def omap_rm(self, key: Key, keys: List[str]) -> None:
        raise NotImplementedError

    def getattr(self, key: Key, name: str) -> Optional[bytes]:
        return None

    def setattr(self, key: Key, name: str, value: bytes) -> None:
        raise NotImplementedError

    def rmattr(self, key: Key, name: str) -> None:
        raise NotImplementedError

    def getattrs(self, key: Key) -> Dict[str, bytes]:
        return {}


class MemStore(ObjectStore):
    def __init__(self, capacity_bytes: int = 0,
                 failsafe_ratio: float = 0.97) -> None:
        self.capacity_bytes = int(capacity_bytes or 0)
        self.failsafe_ratio = float(failsafe_ratio or 0.97)
        self._data: Dict[Key, Tuple[bytes, ShardMeta]] = {}
        self._omap: Dict[Key, Dict[str, bytes]] = {}
        self._xattrs: Dict[Key, Dict[str, bytes]] = {}
        self._used_bytes = 0  # data bytes held (incremental, O(1) statfs)

    def queue_transaction(self, txn: Transaction, on_commit=None) -> None:
        # failsafe BEFORE any mutation: a refused transaction must leave
        # the store byte-identical (the test pins this).  Guarded like
        # the disk stores: the unlimited config skips even the cheap sum.
        if self.capacity_bytes:
            self._check_failsafe(
                sum(len(unwrap(c)) for _k, c, _m in txn.writes),
                self._used_bytes)
        for key in txn.deletes:
            old = self._data.pop(key, None)
            if old is not None:
                self._used_bytes -= len(old[0])
            self._omap.pop(key, None)
        for key, chunk, meta in txn.writes:
            if isinstance(chunk, Owned):
                # ownership handed over: keep the view, no copy
                chunk = chunk.view
            elif not isinstance(chunk, bytes):
                # freeze at the durability boundary: with local fast
                # dispatch chunks arrive BY REFERENCE (memoryview over
                # a sender buffer) — a real store copies to media here,
                # the RAM store must copy too or later buffer reuse
                # would corrupt "persisted" data
                chunk = bytes(chunk)
            prev = self._data.get(key)
            if prev is not None:
                self._used_bytes -= len(prev[0])
            self._used_bytes += len(chunk)
            self._data[key] = (chunk, meta)
        for key, entries in txn.omap_sets:
            self._omap.setdefault(key, {}).update(entries)
        for key, keys in txn.omap_rms:
            table = self._omap.get(key)
            if table:
                for k in keys:
                    table.pop(k, None)
        if on_commit is not None:
            on_commit()

    def omap_get(self, key: Key) -> Dict[str, bytes]:
        return dict(self._omap.get(key, {}))

    def omap_set(self, key: Key, entries: Dict[str, bytes]) -> None:
        self._omap.setdefault(key, {}).update(entries)

    def omap_rm(self, key: Key, keys: List[str]) -> None:
        table = self._omap.get(key)
        if table:
            for k in keys:
                table.pop(k, None)

    def getattr(self, key: Key, name: str) -> Optional[bytes]:
        return self._xattrs.get(key, {}).get(name)

    def setattr(self, key: Key, name: str, value: bytes) -> None:
        self._xattrs.setdefault(key, {})[name] = value

    def rmattr(self, key: Key, name: str) -> None:
        self._xattrs.get(key, {}).pop(name, None)

    def getattrs(self, key: Key) -> Dict[str, bytes]:
        return dict(self._xattrs.get(key, {}))

    def read(self, key: Key) -> Optional[Tuple[bytes, ShardMeta]]:
        return self._data.get(key)

    def list_objects(self, pool_id: int):
        for (pid, oid, shard) in list(self._data):
            if pid == pool_id:
                yield oid, shard

    def list_pools(self):
        return sorted({pid for (pid, _o, _s) in self._data})

    def statfs(self) -> Dict[str, int]:
        total = int(self.capacity_bytes or 0)
        used = self._used_bytes
        return {"total": total, "used": used,
                "avail": max(0, total - used) if total else 0,
                "num_objects": len(self._data)}


class DirStore(ObjectStore):
    """File-per-shard store with a sidecar json for metadata; writes are
    tmp+rename atomic."""

    def __init__(self, path: str, capacity_bytes: int = 0,
                 failsafe_ratio: float = 0.97) -> None:
        self.path = path
        self.capacity_bytes = int(capacity_bytes or 0)
        self.failsafe_ratio = float(failsafe_ratio or 0.97)
        os.makedirs(path, exist_ok=True)

    def _file(self, key: Key) -> str:
        # hex-encode the oid: filenames stay unambiguous for ANY oid bytes
        # (slashes, '__', unicode) and list parsing can invert exactly
        pid, oid, shard = key
        return os.path.join(self.path, f"{pid}__{oid.encode().hex()}__{shard}")

    def queue_transaction(self, txn: Transaction, on_commit=None) -> None:
        if self.capacity_bytes:
            # _used_bytes is a directory sweep: only pay it when a
            # ceiling is actually configured
            self._check_failsafe(
                sum(len(unwrap(c)) for _k, c, _m in txn.writes),
                self._used_bytes())
        for key in txn.deletes:
            for suffix in ("", ".meta"):
                try:
                    os.unlink(self._file(key) + suffix)
                except FileNotFoundError:
                    pass
        for key, chunk, meta in txn.writes:
            chunk = unwrap(chunk)  # file write copies to media anyway
            path = self._file(key)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(chunk)
            os.replace(tmp, path)
            with open(path + ".meta.tmp", "w") as f:
                json.dump(meta.__dict__, f)
            os.replace(path + ".meta.tmp", path + ".meta")
        # legacy filestore: no omap support (BlueStore carries the PG log)
        if on_commit is not None:
            on_commit()

    def read(self, key: Key) -> Optional[Tuple[bytes, ShardMeta]]:
        path = self._file(key)
        try:
            with open(path, "rb") as f:
                chunk = f.read()
            with open(path + ".meta") as f:
                meta = ShardMeta(**json.load(f))
            return chunk, meta
        except FileNotFoundError:
            return None

    def list_objects(self, pool_id: int):
        prefix = f"{pool_id}__"
        for name in os.listdir(self.path):
            if name.startswith(prefix) and not name.endswith((".meta", ".tmp")):
                try:
                    _, oid_hex, shard = name.rsplit("__", 2)
                    yield bytes.fromhex(oid_hex).decode(), int(shard)
                except ValueError:
                    # foreign or legacy-named file in the store dir: never
                    # poison listing/repair for every other object
                    continue

    def list_pools(self):
        pools = set()
        for name in os.listdir(self.path):
            if name.endswith((".meta", ".tmp")):
                continue
            pid, sep, _ = name.partition("__")
            if sep and pid.isdigit():
                pools.add(int(pid))
        return sorted(pools)

    def _used_bytes(self) -> int:
        used = n = 0
        for name in os.listdir(self.path):
            if name.endswith((".meta", ".tmp")):
                continue
            try:
                used += os.stat(os.path.join(self.path, name)).st_size
                n += 1
            except OSError:
                pass
        self._last_count = n
        return used

    def statfs(self) -> Dict[str, int]:
        total = int(self.capacity_bytes or 0)
        used = self._used_bytes()
        return {"total": total, "used": used,
                "avail": max(0, total - used) if total else 0,
                "num_objects": getattr(self, "_last_count", 0)}


def shard_crc(chunk: bytes) -> int:
    """crc32 of a shard chunk (deep-scrub comparison value)."""
    from ceph_tpu_torch.utils.checksum import checksum

    return checksum(chunk) & 0xFFFFFFFF
