# Copy of ceph_tpu/rados/bluestore.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; what it reads back from the
# wire or a store unpickles through rados/unpickle.py.
"""BlueStore-lite: block-file object store with WAL, checksums, allocator.

Role-equivalent of the reference's BlueStore (reference
src/os/bluestore/BlueStore.cc): object data lives in one raw block file
carved by an extent allocator; all metadata (object -> extents, per-extent
crc32c checksums, shard meta, xattrs, omap) lives in a KeyValueDB whose WAL
provides the commit point — a transaction is durable exactly when its
metadata batch hits the KV WAL.  Small writes are DEFERRED
(bluestore_prefer_deferred_size): the data rides inside the KV record and
is flushed to the block file after commit, saving the block-file sync on
the latency path; large writes go to freshly allocated extents first
(copy-on-write — crash before KV commit leaves the old object intact),
then the metadata flips atomically.

Checksums: per-extent, algorithm selected by bluestore_csum_type
(crc32c default, zlib, none — reference csum_type per blob), verified
on every read BEFORE decompression; bluestore_debug_inject_read_err /
_csum_err_probability inject failures for the EIO-handling tests
(reference src/common/options/global.yaml.in:4977,5017).

Compression (reference BlueStore _do_write compression at blob
granularity): per-POOL mode/algorithm from pool opts (`ceph osd pool
set NAME compression_mode aggressive` -> pg_pool_t::opts -> OSDMap ->
set_pool_opts here), falling back to bluestore_compression_mode/
_algorithm conf.  zlib / zstd / lzma; a blob is stored compressed only
when >= bluestore_compression_min_blob_size and the result beats
bluestore_compression_required_ratio (default 0.875) — otherwise raw,
exactly the reference's required-ratio discipline.  Checksums cover
the STORED (compressed) bytes, so a corrupted compressed extent fails
the csum before the decompressor ever sees it.

Recovery contract: open() replays the KV WAL (WalDB does this), then
flushes any deferred writes recorded-but-not-flushed.  The allocator
rebuilds its free map from the extent metadata.
"""

from __future__ import annotations

import os
import pickle
import random
import zlib

from ceph_tpu_torch.utils.checksum import checksum
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ceph_tpu_torch.rados.kv import KeyValueDB, MemDB, WalDB, WriteBatch
from ceph_tpu_torch.rados import unpickle
from ceph_tpu_torch.rados.store import (ENOSPCError,  # noqa: F401 (re-export)
                                  Key, ObjectStore, ShardMeta, Transaction,
                                  unwrap as store_unwrap)

PREFIX_OBJ = "O"  # object metadata (extents, csums, ShardMeta, xattrs)
PREFIX_DEFERRED = "D"  # deferred write payloads awaiting block flush
PREFIX_OMAP = "M"  # per-object sorted key/value (PG log lives here)
PREFIX_SUPER = "S"  # store-wide state (size watermark)


class EIOError(IOError):
    """Read failed checksum / injected EIO (the OSD turns this into the
    shard-level error path the reference tests with test-erasure-eio.sh)."""


@dataclass
class _Onode:
    """Object metadata record (BlueStore onode role)."""

    extents: List[Tuple[int, int]] = field(default_factory=list)  # (off, len)
    csums: List[int] = field(default_factory=list)  # per-extent, of STORED bytes
    meta: ShardMeta = field(default_factory=ShardMeta)
    deferred: bool = False  # data still only in the KV (deferred write)
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    # blob compression (reference bluestore_blob_t compressed flag):
    # algorithm name or None; raw_len pins the decompressed size
    compression: Optional[str] = None
    raw_len: int = -1
    csum_type: str = "crc32c"


# gated like auth.py's `cryptography` import: hosts without `zstandard`
# still run every non-zstd cluster shape — only the actual use of a
# zstd-compressed blob raises (writes degrade to raw with a warning at
# the caller; reads of an EXISTING zstd blob must raise, never return
# garbage)
try:
    import zstandard as _zstandard
except ImportError:
    _zstandard = None


def _require_zstd():
    if _zstandard is None:
        raise ImportError(
            "the `zstandard` package is required for zstd-compressed "
            "blobs but is not installed; pick compression_algorithm "
            "zlib/lzma or install zstandard")
    return _zstandard


def _compress(algo: str, raw) -> bytes:
    if algo == "zstd":
        return _require_zstd().ZstdCompressor(level=1).compress(bytes(raw))
    if algo == "lzma":
        import lzma

        return lzma.compress(bytes(raw), preset=0)
    return zlib.compress(bytes(raw), 1)


def _decompress(algo: str, data: bytes) -> bytes:
    if algo == "zstd":
        return _require_zstd().ZstdDecompressor().decompress(data)
    if algo == "lzma":
        import lzma

        return lzma.decompress(data)
    return zlib.decompress(data)


def _okey(key: Key) -> str:
    pid, oid, shard = key
    return f"{pid}/{oid.encode().hex()}/{shard}"


def _unokey(s: str) -> Key:
    pid, oid_hex, shard = s.split("/")
    return int(pid), bytes.fromhex(oid_hex).decode(), int(shard)


class Allocator:
    """Free-extent allocator (AvlAllocator role): first-fit with merge."""

    def __init__(self, size: int):
        self.size = size
        self.free: List[Tuple[int, int]] = [(0, size)] if size else []

    def allocate(self, want: int) -> int:
        for i, (off, length) in enumerate(self.free):
            if length >= want:
                if length == want:
                    self.free.pop(i)
                else:
                    self.free[i] = (off + want, length - want)
                return off
        # grow the device (file-backed: sparse growth is free); the grown
        # region beyond this allocation joins the free list
        off = self.size
        grow = max(want, 1 << 20)
        self.size += grow
        if grow > want:
            self.release(off + want, grow - want)
        return off

    def release(self, off: int, length: int) -> None:
        self.free.append((off, length))
        self.free.sort()
        merged: List[Tuple[int, int]] = []
        for o, l in self.free:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + l)
            else:
                merged.append((o, l))
        self.free = merged

    def reserve(self, off: int, length: int) -> None:
        """Mark [off, off+len) used (startup rebuild)."""
        out = []
        for o, l in self.free:
            if off >= o + l or off + length <= o:
                out.append((o, l))
                continue
            if o < off:
                out.append((o, off - o))
            if off + length < o + l:
                out.append((off + length, o + l - off - length))
        self.free = out
        self.size = max(self.size, off + length)


class BlueStore(ObjectStore):
    def __init__(self, path: Optional[str] = None,
                 conf: Optional[dict] = None,
                 db: Optional[KeyValueDB] = None):
        self.conf = conf or {}
        self.path = path
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self.db: KeyValueDB = db or WalDB(os.path.join(path, "db"))
            self._block_path = os.path.join(path, "block")
            if not os.path.exists(self._block_path):
                open(self._block_path, "wb").close()
            # r+b: positioned writes (a+b would append regardless of seek)
            self._block = open(self._block_path, "r+b")
        else:
            self.db = db or MemDB()
            self._block = None
            self._blob: Dict[int, bytes] = {}  # off -> data (RAM mode)
        self.alloc = Allocator(0)
        # configured byte ceiling + failsafe (reference bluestore
        # bluefs/statfs capacity + osd_failsafe_full_ratio): 0 = grow
        # forever (the pre-capacity behavior, default)
        self.capacity_bytes = int(self.conf.get(
            "osd_store_capacity_bytes", 0) or 0)
        self.failsafe_ratio = float(self.conf.get(
            "osd_failsafe_full_ratio", 0.97) or 0.97)
        self._onodes: Dict[Key, _Onode] = {}
        # per-pool store options pushed from the OSDMap (pg_pool_t::opts
        # role): compression_mode/algorithm/ratio/min_blob_size
        self.pool_opts: Dict[int, Dict[str, str]] = {}
        self._compress_warned: set = set()
        # committed-but-unflushed deferred writes, drained in batches off
        # the commit latency path (bluestore deferred_batch semantics)
        self._deferred_pending: List[Tuple[Key, _Onode, bytes]] = []
        self._deferred_batch_max = 16
        self._load()
        self._flush_deferred()

    # -- startup -------------------------------------------------------------

    def _load(self) -> None:
        for k, v in self.db.iterate(PREFIX_OBJ):
            onode: _Onode = unpickle.loads(v)
            key = _unokey(k)
            self._onodes[key] = onode
            for off, length in onode.extents:
                self.alloc.reserve(off, length)

    def _flush_deferred(self) -> None:
        """Finish deferred writes that committed but weren't flushed to the
        block file before shutdown (BlueStore deferred replay)."""
        for k, v in list(self.db.iterate(PREFIX_DEFERRED)):
            key = _unokey(k)
            onode = self._onodes.get(key)
            if onode is not None and onode.deferred:
                self._write_extents(onode.extents, v)
                onode.deferred = False
                batch = WriteBatch()
                batch.set(PREFIX_OBJ, _okey(key),
                          pickle.dumps(onode, protocol=5))
                batch.rm(PREFIX_DEFERRED, k)
                self.db.submit(batch)
            else:
                batch = WriteBatch()
                batch.rm(PREFIX_DEFERRED, k)
                self.db.submit(batch)

    # -- block IO ------------------------------------------------------------

    def _write_extents(self, extents: List[Tuple[int, int]], data: bytes) -> None:
        pos = 0
        for off, length in extents:
            piece = data[pos:pos + length]
            if self._block is not None:
                self._block.seek(off)
                self._block.write(piece)
            else:
                self._blob[off] = piece
            pos += length
        if self._block is not None:
            self._block.flush()

    def _read_extents(self, extents: List[Tuple[int, int]]) -> bytes:
        out = []
        for off, length in extents:
            if self._block is not None:
                self._block.seek(off)
                out.append(self._block.read(length))
            else:
                out.append(self._blob.get(off, b"")[:length])
        return b"".join(out)

    # -- ObjectStore interface -----------------------------------------------

    def queue_transaction(self, txn: Transaction,
                          on_commit: Optional[Callable[[], None]] = None) -> None:
        """Apply atomically: ONE KV batch is the commit point for every
        write/delete in the transaction (ObjectStore::queue_transactions
        with register_on_commit semantics)."""
        prefer_deferred = int(self.conf.get("bluestore_prefer_deferred_size",
                                            32768) or 0)
        # failsafe BEFORE any mutation (KV batch, allocator, block file):
        # a refused transaction leaves the store byte-identical.  The
        # common no-ceiling config skips both sums (the free-list walk
        # would otherwise tax every write for a guaranteed no-op check).
        if self.capacity_bytes:
            self._check_failsafe(
                sum(len(store_unwrap(c)) for _k, c, _m in txn.writes),
                self.alloc.size - sum(l for _, l in self.alloc.free))
        batch = WriteBatch()
        freed: List[Tuple[int, int]] = []
        for key in txn.deletes:
            onode = self._onodes.pop(key, None)
            if onode is not None:
                freed.extend(onode.extents)
            batch.rm(PREFIX_OBJ, _okey(key))
            batch.rm(PREFIX_DEFERRED, _okey(key))
            batch.rm_prefix(PREFIX_OMAP + _okey(key))
        for key, entries in txn.omap_sets:
            for k, v in entries.items():
                batch.set(PREFIX_OMAP + _okey(key), k, v)
        for key, keys in txn.omap_rms:
            for k in keys:
                batch.rm(PREFIX_OMAP + _okey(key), k)
        deferred_flush: List[Tuple[Key, _Onode, bytes]] = []
        for key, chunk, meta in txn.writes:
            chunk = store_unwrap(chunk)  # disk store copies to media anyway
            old = self._onodes.get(key)
            if old is not None:
                freed.extend(old.extents)
            onode = _Onode(meta=meta,
                           xattrs=dict(old.xattrs) if old else {})
            # blob compression decision (reference _do_write + the
            # required-ratio gate): per-pool opts override global conf
            raw_len = len(chunk)
            popts = self.pool_opts.get(key[0], {})
            mode = popts.get("compression_mode",
                             self.conf.get("bluestore_compression_mode",
                                           "none")) or "none"
            # passive = compress only on a client compressible-hint
            # (reference alloc-hint plumbing); no hints exist in this
            # transaction format, so passive stores raw — treating it
            # as aggressive would invert its documented meaning
            if mode in ("aggressive", "force"):
                algo = popts.get(
                    "compression_algorithm",
                    self.conf.get("bluestore_compression_algorithm",
                                  "zlib"))
                min_blob = int(popts.get(
                    "compression_min_blob_size",
                    self.conf.get("bluestore_compression_min_blob_size",
                                  4096)))
                ratio = float(popts.get(
                    "compression_required_ratio",
                    self.conf.get("bluestore_compression_required_ratio",
                                  0.875)))
                if raw_len >= min_blob:
                    try:
                        cand = _compress(algo, chunk)
                    except Exception as e:
                        cand = None
                        # loudly, once per (pool, algo): a missing
                        # compressor module must not silently store a
                        # "compressed" pool raw forever
                        warn_key = (key[0], algo)
                        if warn_key not in self._compress_warned:
                            self._compress_warned.add(warn_key)
                            print(f"bluestore: pool {key[0]} "
                                  f"compression_algorithm={algo} "
                                  f"unavailable ({e}); storing raw")
                    if cand is not None and len(cand) <= raw_len * ratio:
                        chunk = cand
                        onode.compression = algo
                        onode.raw_len = raw_len
            onode.csum_type = str(self.conf.get("bluestore_csum_type",
                                                "crc32c") or "crc32c")
            off = self.alloc.allocate(max(1, len(chunk)))
            onode.extents = [(off, len(chunk))]
            onode.csums = [self._csum(onode.csum_type, chunk)]
            if len(chunk) <= prefer_deferred:
                # deferred: payload rides the KV WAL (pickled) — needs
                # real bytes, a memoryview cannot serialize
                if not isinstance(chunk, bytes):
                    chunk = bytes(chunk)
                onode.deferred = True
                batch.set(PREFIX_DEFERRED, _okey(key), chunk)
                deferred_flush.append((key, onode, chunk))
            else:
                # large write: data to fresh extents BEFORE commit (COW)
                self._write_extents(onode.extents, chunk)
            self._onodes[key] = onode
            batch.set(PREFIX_OBJ, _okey(key), pickle.dumps(onode, protocol=5))
        self.db.submit(batch)  # <- THE commit point
        if on_commit is not None:
            on_commit()
        # post-commit: deferred payloads drain in batches so a small write
        # costs ONE fsync on the latency path (the open-time replay covers
        # anything pending at a crash)
        self._deferred_pending.extend(deferred_flush)
        if len(self._deferred_pending) >= self._deferred_batch_max:
            self.flush_deferred_batch()
        for off, length in freed:
            self.alloc.release(off, length)

    def flush_deferred_batch(self) -> None:
        if not self._deferred_pending:
            return
        pending, self._deferred_pending = self._deferred_pending, []
        b2 = WriteBatch()
        for key, onode, chunk in pending:
            if self._onodes.get(key) is not onode:
                continue  # overwritten/deleted since; its extents are gone
            self._write_extents(onode.extents, chunk)
            onode.deferred = False
            b2.set(PREFIX_OBJ, _okey(key), pickle.dumps(onode, protocol=5))
            b2.rm(PREFIX_DEFERRED, _okey(key))
        if b2.ops:
            self.db.submit(b2)

    @staticmethod
    def _csum(ctype: str, data) -> int:
        if ctype == "none":
            return 0
        if ctype == "zlib":
            return zlib.crc32(bytes(data)) & 0xFFFFFFFF
        return checksum(data) & 0xFFFFFFFF

    def set_pool_opts(self, pool_id: int, opts: Dict[str, str]) -> None:
        """OSDMap pool-opts push (pg_pool_t::opts role)."""
        if opts:
            self.pool_opts[pool_id] = dict(opts)
        else:
            self.pool_opts.pop(pool_id, None)

    def read(self, key: Key) -> Optional[Tuple[bytes, ShardMeta]]:
        onode = self._onodes.get(key)
        if onode is None:
            return None
        if self.conf.get("bluestore_debug_inject_read_err", False):
            raise EIOError(f"injected read error on {key}")
        if onode.deferred:
            data = self.db.get(PREFIX_DEFERRED, _okey(key)) or b""
        else:
            data = self._read_extents(onode.extents)
        prob = float(self.conf.get(
            "bluestore_debug_inject_csum_err_probability", 0.0) or 0.0)
        if prob and random.random() < prob:
            raise EIOError(f"injected csum error on {key}")
        # verify BEFORE decompression, over the stored bytes: a
        # corrupted compressed extent must fail here, never feed the
        # decompressor garbage (pre-selection onode pickles lack the
        # csum_type field; verify_any keeps them readable)
        if getattr(onode, "csum_type", "crc32c") != "none":
            pos = 0
            for (off, length), want in zip(onode.extents, onode.csums):
                from ceph_tpu_torch.utils.checksum import verify_any

                if not verify_any(data[pos:pos + length], want):
                    raise EIOError(f"checksum mismatch on {key} @{off}")
                pos += length
        comp = getattr(onode, "compression", None)
        if comp:
            try:
                data = _decompress(comp, data)
            except Exception as e:
                raise EIOError(
                    f"decompression failed on {key} ({comp}): {e}")
            raw_len = getattr(onode, "raw_len", -1)
            if raw_len >= 0 and len(data) != raw_len:
                raise EIOError(
                    f"decompressed length mismatch on {key}: "
                    f"{len(data)} != {raw_len}")
        return data, onode.meta

    def list_objects(self, pool_id: int) -> Iterable[Tuple[str, int]]:
        for (pid, oid, shard) in list(self._onodes):
            if pid == pool_id:
                yield oid, shard

    def list_pools(self) -> Iterable[int]:
        return sorted({pid for (pid, _o, _s) in self._onodes})

    # -- xattrs / omap (HashInfo + PG log substrate) -------------------------

    def setattr(self, key: Key, name: str, value: bytes) -> None:
        onode = self._onodes.get(key)
        if onode is None:
            onode = _Onode()
            self._onodes[key] = onode
        onode.xattrs[name] = value
        batch = WriteBatch()
        batch.set(PREFIX_OBJ, _okey(key), pickle.dumps(onode, protocol=5))
        self.db.submit(batch)

    def getattr(self, key: Key, name: str) -> Optional[bytes]:
        onode = self._onodes.get(key)
        return onode.xattrs.get(name) if onode else None

    def rmattr(self, key: Key, name: str) -> None:
        onode = self._onodes.get(key)
        if onode is None or name not in onode.xattrs:
            return
        del onode.xattrs[name]
        batch = WriteBatch()
        batch.set(PREFIX_OBJ, _okey(key), pickle.dumps(onode, protocol=5))
        self.db.submit(batch)

    def getattrs(self, key: Key) -> Dict[str, bytes]:
        onode = self._onodes.get(key)
        return dict(onode.xattrs) if onode else {}

    def omap_set(self, key: Key, entries: Dict[str, bytes]) -> None:
        batch = WriteBatch()
        for k, v in entries.items():
            batch.set(PREFIX_OMAP + _okey(key), k, v)
        self.db.submit(batch)

    def omap_get(self, key: Key) -> Dict[str, bytes]:
        return dict(self.db.iterate(PREFIX_OMAP + _okey(key)))

    def omap_rm(self, key: Key, keys: List[str]) -> None:
        batch = WriteBatch()
        for k in keys:
            batch.rm(PREFIX_OMAP + _okey(key), k)
        self.db.submit(batch)

    # -- admin ----------------------------------------------------------------

    def statfs(self) -> Dict[str, int]:
        free = sum(l for _, l in self.alloc.free)
        used = self.alloc.size - free
        total = int(self.capacity_bytes or 0)
        # uniform shape first (total/used/avail, total==0 = unlimited);
        # size/free kept for the allocator-view consumers
        return {"total": total, "used": used,
                "avail": max(0, total - used) if total else 0,
                "num_objects": len(self._onodes),
                "size": self.alloc.size, "free": free}

    def close(self) -> None:
        self.flush_deferred_batch()
        self.db.close()
        if self._block is not None:
            self._block.close()
