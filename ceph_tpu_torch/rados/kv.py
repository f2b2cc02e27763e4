# Copy of ceph_tpu/rados/kv.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; what it reads back from the
# wire or a store unpickles through rados/unpickle.py.
"""KeyValueDB: the metadata-store abstraction under BlueStore-lite.

Role-equivalent of the reference's KeyValueDB over RocksDB (reference
src/kv/KeyValueDB.h, RocksDBStore.cc): prefixed keyspaces, atomic write
batches, prefix iteration.  The durable implementation is a write-ahead
log + in-memory table with snapshot compaction — the same recovery
contract as the reference (a committed batch survives crash; a torn tail
record is discarded), sized for metadata volumes, not a general LSM.

Record format in the WAL: [u32 len][u32 crc][pickled batch].  Compaction
writes a full snapshot and truncates the log.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib

from ceph_tpu_torch.utils.checksum import checksum
from ceph_tpu_torch.rados import unpickle
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

_REC = struct.Struct("<II")


class WriteBatch:
    """Atomic batch (reference KeyValueDB::Transaction)."""

    def __init__(self):
        self.ops: List[Tuple[str, str, str, Optional[bytes]]] = []

    def set(self, prefix: str, key: str, value: bytes) -> None:
        self.ops.append(("set", prefix, key, value))

    def rm(self, prefix: str, key: str) -> None:
        self.ops.append(("rm", prefix, key, None))

    def rm_prefix(self, prefix: str) -> None:
        self.ops.append(("rmpfx", prefix, "", None))


class KeyValueDB:
    def submit(self, batch: WriteBatch) -> None:
        raise NotImplementedError

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(KeyValueDB):
    def __init__(self):
        self._tables: Dict[str, Dict[str, bytes]] = {}

    def _apply(self, batch: WriteBatch) -> None:
        for op, prefix, key, value in batch.ops:
            table = self._tables.setdefault(prefix, {})
            if op == "set":
                table[key] = value
            elif op == "rm":
                table.pop(key, None)
            elif op == "rmpfx":
                table.clear()

    def submit(self, batch: WriteBatch) -> None:
        self._apply(batch)

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self._tables.get(prefix, {}).get(key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        yield from sorted(self._tables.get(prefix, {}).items())


class WalDB(MemDB):
    """Durable MemDB: every batch is WAL-appended before apply; snapshot +
    log truncation when the log grows past `compact_bytes`."""

    def __init__(self, path: str, compact_bytes: int = 4 << 20):
        super().__init__()
        self.path = path
        self.compact_bytes = compact_bytes
        os.makedirs(path, exist_ok=True)
        self._snap_path = os.path.join(path, "snapshot.db")
        self._log_path = os.path.join(path, "wal.log")
        self._recover()
        self._log = open(self._log_path, "ab")

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                self._tables = unpickle.load(f)
        if os.path.exists(self._log_path):
            valid_end = 0
            with open(self._log_path, "rb") as f:
                while True:
                    hdr = f.read(_REC.size)
                    if len(hdr) < _REC.size:
                        break
                    length, crc = _REC.unpack(hdr)
                    blob = f.read(length)
                    if len(blob) < length:
                        break  # torn tail: committed prefix only
                    # algorithm-agnostic verify: a WAL written by a build
                    # whose checksum resolved differently (crc32c vs
                    # zlib, either direction) must not be mistaken for a
                    # torn tail — that would TRUNCATE committed batches
                    from ceph_tpu_torch.utils.checksum import verify_any

                    if not verify_any(blob, crc):
                        break
                    valid_end = f.tell()
                    batch = WriteBatch()
                    batch.ops = unpickle.loads(blob)
                    self._apply(batch)
            # truncate the torn tail: appends after it would sit behind
            # garbage and be unreachable to the NEXT recovery
            if valid_end < os.path.getsize(self._log_path):
                with open(self._log_path, "r+b") as f:
                    f.truncate(valid_end)

    # -- commits -------------------------------------------------------------

    def submit(self, batch: WriteBatch) -> None:
        blob = pickle.dumps(batch.ops, protocol=5)
        self._log.write(_REC.pack(len(blob), checksum(blob)) + blob)
        self._log.flush()
        os.fsync(self._log.fileno())
        self._apply(batch)
        if self._log.tell() >= self.compact_bytes:
            self.compact()

    def compact(self) -> None:
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._tables, f, protocol=5)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        self._log.close()
        self._log = open(self._log_path, "wb")

    def close(self) -> None:
        try:
            self._log.close()
        except Exception:
            pass
