"""Paged resident store: page-table residency of EC shard rows for the cache
tier, on the card.

Copy of ceph_tpu/rados/pagestore.py at commit 645aba9, on PyTorch.  The
budget is one pool carved into fixed-size pages (``page_bytes``); a
resident's plane words are TRIMMED to their true width and flattened
row-major across a page table (ordered page ids, ragged last page), so

- objects of mixed sizes share the pool at page granularity (the pow2 pad
  of a monolithic buffer never lands; ``frag_saved_bytes`` gauges it),
- eviction frees exactly the pages it needs, including PARTIAL eviction:
  ``shed_parity`` drops the page suffix holding the parity rows while the
  data-row prefix keeps serving reads,
- every page carries a DIRTY bit for writeback: a writeback install pins a
  :class:`WritebackRecord` with its dirty pages, ``drop`` refuses dirty
  entries until the owner flushes, and ``clear_dirty`` is
  generation-tokened, so a flush that raced an overwrite never marks the
  newer write clean.

Residents come in three layouts, told apart by dtype: packed-bit plane
words (int32 carrying the reference's uint32 bits, w=8), int8 bit-planes
(any w), and raw whole-object bytes (uint8, ``w=0``, ``put_raw``).

The pool is committed lazily, in sub-slabs of 256 pages, and has two arms
behind one page table:

- the HOST arm: sub-slabs are numpy arrays, installs and gathers are
  memcpys, and the converters (``to_packedbit``/``from_packedbit``) run on
  the store's device at the page-table edge.  Byte-identical to the
  reference's host arm.
- the DEVICE arm: sub-slabs are int32 tensors on the store's device, and
  installs and gathers are the torch ops of ceph_tpu_torch/ops/slab.py.  A
  host-sourced install crosses to the card as ONE non-blocking copy of the
  zero-padded page image from pinned memory (``h2d_installs``); a resident
  already on the device (a queue product, packed-bit words or int8 planes)
  installs with no host copy (``device_installs``), and ``admit`` of
  packed-bit rows writes its words straight into its pages
  (``to_packedbit_paged``).  Each resident keeps its page table
  (``PageTable``, with the pages' addresses on the card), built at install.
  Reads of packed-bit words (``read``, ``read_paged``: ecutil's planar
  helpers) go from the pages to the bytes in one launch
  (``from_packedbit_paged``) and cross to the host as one copy into pinned
  memory; ``gather_rows`` stays on the device.  Bytes leave the card only at
  the declared exits (``d2h_gathers``, see ``SLAB_IO_BOUNDARY``).  Nothing
  on this arm falls back to host pages.

Device and arm.  The store takes a torch ``device`` (the card unless the
caller names the CPU; it raises without one), and ``device_arm`` picks the
arm: None means the device arm iff the device is CUDA.
``CEPH_TPU_DEVICE_SLAB=1``/``0`` overrides either way.  The tests run the
device arm's code on CPU tensors.

Thread-safe under one mutex; the OSD's event loop, the batching worker and
tests may touch it concurrently.  Slab operations run under it on the
stream current at the call, and on CUDA each waits for the previous slab
operation when that ran on another stream, so installs and gathers stay in
order across streams.  A gather returns a fresh tensor, which keeps the
bytes it read across later installs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder
from ceph_tpu_torch.ops.cuda_packedbit import (from_packedbit_paged,
                                               to_packedbit_paged)
from ceph_tpu_torch.ops.slab import (PageTable, gather_words, install_pages,
                                     is_device_array, new_subslab)
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device

_SLAB_SHIFT = 8  # 2**8 pages per lazily committed sub-slab

# the functions that may bring gathered slab bytes to the host: the
# pagestore's packed-byte exits
SLAB_IO_BOUNDARY = ("read", "read_paged")

_STAGING_ALIGN = 4096

#: dtype of packed-bit plane words (the reference's uint32 bits)
_WORDS = np.dtype(np.int32)


def install_staging(nbytes: int, device: DeviceLike = None) -> memoryview:
    """Host staging for received blobs that will be installed: pinned memory
    from torch's caching host allocator when `device` is the card (the
    install's host->device copy then reads it directly), page-aligned host
    memory when it is the CPU.  The view keeps its allocation alive."""
    n = int(nbytes)
    if resolve_device(device).type == "cuda":
        pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return memoryview(pinned.numpy()).cast("B")
    raw = np.empty(n + _STAGING_ALIGN, dtype=np.uint8)
    off = (-raw.ctypes.data) % _STAGING_ALIGN
    return memoryview(raw[off:off + n]).cast("B")


def device_slab_resolved(flag: Optional[bool] = None,
                         device: DeviceLike = None) -> bool:
    """Whether a store's device arm engages.  CEPH_TPU_DEVICE_SLAB=1/0 wins
    either way; then a False flag (``osd_tier_device_slab``) pins the host
    arm; otherwise the device arm iff `device` resolves to the card."""
    env = os.environ.get("CEPH_TPU_DEVICE_SLAB", "")
    if env in ("0", "1"):
        return env == "1"
    if flag is not None and not flag:
        return False
    return resolve_device(device).type == "cuda"


@dataclass
class WritebackRecord:
    """The flush contract a writeback install pins with its dirty pages:
    everything the owner needs to replay the DEFERRED local store apply
    later, byte-identically to the write-through path, without the
    original write in hand.  Opaque to the store itself."""

    pool_id: int
    oid: str
    pg: int
    version: int
    object_size: int
    hinfo: bytes
    shards: Tuple[int, ...]           # local shards whose apply deferred
    crcs: Dict[int, int] = field(default_factory=dict)


@dataclass
class CacheDirtyRecord:
    """The flush contract a fast-ack writeback put pins with its RAW dirty
    object (w=0 entry, whole-object bytes: no EC encode happened yet).
    ``primary`` names the OSD that installed the write; ``peers`` is the
    full cache replica set, primary included.  Generation-tokened and
    version-fenced like :class:`WritebackRecord`; opaque to the store."""

    pool_id: int
    oid: str
    pg: int
    version: int
    object_size: int
    primary: int
    peers: Tuple[int, ...] = ()


class _Entry:
    __slots__ = ("pages", "table", "dtype", "rows", "cols", "itemsize", "w",
                 "n_rows", "meta", "trim", "data_rows", "mono_bytes",
                 "total_words", "live_pages", "dirty", "dirty_info",
                 "dirty_since", "dirty_gen")


class _PackedRows:
    """[n, B] uint8 rows on the store's device that ``admit`` installs as
    their plane words, written straight into the pages (the device arm's
    ``to_packedbit_paged``); shaped as those words."""

    dtype = torch.int32

    def __init__(self, data: torch.Tensor):
        self.data = data
        self.shape = (data.shape[0] * 8, -(-data.shape[1] // 32))


def _to_host(out: torch.Tensor) -> np.ndarray:
    """The one device->host copy of a paged read: into pinned memory from
    torch's caching host allocator, waited for; the result is a view of
    that memory.  A CPU tensor is its own host copy."""
    if out.device.type == "cpu":
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host.numpy()


def build_pagestore_perf() -> PerfCounters:
    """The `pagestore` counter set (the reference's names and kinds)."""
    return (
        PerfCountersBuilder("pagestore")
        .add_u64_counter("admit", "residents installed into pages")
        .add_u64_counter("hit", "resident lookups served")
        .add_u64_counter("miss", "lookups that fell to the cold path")
        .add_u64_counter("evict", "whole residents evicted")
        .add_u64_counter("page_evictions", "pages freed by eviction "
                                           "(partial sheds included)")
        .add_u64_counter("parity_sheds",
                         "partial evictions that dropped only the "
                         "parity-row page suffix (data keeps serving)")
        .add_u64_counter("writeback_installs",
                         "dirty installs that deferred a local store "
                         "apply to flush")
        .add_u64_counter("flushes", "dirty residents flushed clean")
        .add_u64_counter("flush_bytes", "shard bytes written back by "
                                        "flushes")
        .add_u64_counter("evict_refused_dirty",
                         "drops refused because pages were dirty "
                         "(flush-before-evict held)")
        .add_u64_counter("install_refused",
                         "installs refused (pool full of dirty or "
                         "oversized resident)")
        .add_u64("pages_total", "page pool size (gauge)")
        .add_u64("pages_used", "pages currently owned by residents "
                               "(gauge)")
        .add_u64("dirty_pages", "pages carrying unflushed writeback "
                                "data (gauge)")
        .add_u64("dirty_bytes", "page bytes carrying unflushed "
                                "writeback data (gauge)")
        .add_u64("resident_bytes", "page bytes held by residents "
                                   "(gauge)")
        .add_u64("entries", "resident objects (gauge)")
        .add_u64("memo_bytes", "exit-boundary memo footprint, "
                               "page-rounded (gauge)")
        .add_u64("frag_saved_bytes",
                 "bytes the paged layout saves vs the monolithic "
                 "pow2-bucketed layout for the live residents (gauge, "
                 "floored at 0)")
        .add_u64("device_slabs", "committed device sub-slabs (gauge; 0 "
                                 "on the host arm)")
        .add_u64_counter("h2d_installs",
                         "installs whose page image crossed host->device "
                         "as ONE async copy (host-sourced bytes)")
        .add_u64_counter("device_installs",
                         "installs consumed device-native (queue-"
                         "produced residents; zero host copies)")
        .add_u64_counter("d2h_gathers",
                         "device->host materializations of gathered "
                         "slab bytes at the declared exit boundaries")
        .add_time_avg("pack_s", "device->host pack seconds at the exit "
                                "boundary")
        .add_time_avg("unpack_s", "host->device unpack seconds at "
                                  "admission")
        .create_perf_counters()
    )


def _host_array(bits) -> np.ndarray:
    """A resident's rows as a numpy array (a device tensor is copied to the
    host); uint32 words are taken as the int32 words they carry."""
    if isinstance(bits, torch.Tensor):
        bits = bits.detach().cpu().numpy()
    arr = np.asarray(bits)
    return arr.view(np.int32) if arr.dtype == np.uint32 else arr


class PagedResidentStore:
    """Residency manager behind the tier (the PlanarShardStore surface:
    put_planar/get_planar/touch/gather_rows/drop/peek/memo), backed by the
    page pool above instead of a buffer per object."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 page_bytes: int = 64 << 10, queue: Optional[Any] = None,
                 device: DeviceLike = None,
                 device_arm: Optional[bool] = None):
        page_bytes = max(256, int(page_bytes))
        page_bytes -= page_bytes % 4  # whole words per page
        self.page_bytes = page_bytes
        self.page_words = page_bytes // 4
        self._pages_total = max(1, int(capacity_bytes) // page_bytes)
        self.queue = queue
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # arm selection: the environment wins both ways, then an explicit
        # choice (tests force the device arm onto CPU tensors), then the
        # device arm iff the store's device is the card
        env = os.environ.get("CEPH_TPU_DEVICE_SLAB", "")
        if env in ("0", "1"):
            self.device_arm = env == "1"
        elif device_arm is not None:
            self.device_arm = bool(device_arm)
        else:
            self.device_arm = self.device.type == "cuda"
        self._slabs: List[Optional[np.ndarray]] = []
        self._dev_slabs: List[Optional[torch.Tensor]] = []
        # on CUDA: the stream of the last slab operation and an event after
        # it, so that an operation on another stream waits for it
        self._slab_stream = None
        self._slab_event = (torch.cuda.Event() if self.device.type == "cuda"
                            else None)
        self.h2d_installs = 0
        self.device_installs = 0
        self.d2h_gathers = 0
        self._free: List[int] = []
        self._next_page = 0
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._memo: Dict[Any, Tuple[Any, Any]] = {}
        self.memo_bytes = 0          # page-rounded
        self._memo_raw: Dict[Any, int] = {}
        self._pages_used = 0
        self._dirty_page_count = 0
        self._gen = 0  # install generations: flush tokens never collide
        self._mono_bytes = 0         # monolithic-equivalent footprint
        self.admits = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.perf = build_pagestore_perf()
        self.perf.set("pages_total", self._pages_total)
        self.perf.resync = self._resync_gauges

    # -- capacity ------------------------------------------------------------

    @property
    def capacity_bytes(self) -> int:
        return self._pages_total * self.page_bytes

    @capacity_bytes.setter
    def capacity_bytes(self, value: int) -> None:
        # the budget is one shared pool: it only ever GROWS; sub-slabs
        # commit lazily, so raising the ceiling costs nothing up front
        with self._lock:
            self._pages_total = max(self._pages_total,
                                    max(1, int(value) // self.page_bytes))
            self.perf.set("pages_total", self._pages_total)

    @property
    def pages_total(self) -> int:
        return self._pages_total

    @property
    def pages_used(self) -> int:
        return self._pages_used

    @property
    def resident_bytes(self) -> int:
        return self._pages_used * self.page_bytes

    @property
    def dirty_pages(self) -> int:
        return self._dirty_page_count

    @property
    def dirty_bytes(self) -> int:
        return self._dirty_page_count * self.page_bytes

    # -- page pool (callers hold the lock) -----------------------------------

    def _page(self, pid: int) -> np.ndarray:
        slab = pid >> _SLAB_SHIFT
        while len(self._slabs) <= slab:
            self._slabs.append(None)
        if self._slabs[slab] is None:
            self._slabs[slab] = np.empty(
                (1 << _SLAB_SHIFT, self.page_words), dtype=_WORDS)
        return self._slabs[slab][pid & ((1 << _SLAB_SHIFT) - 1)]

    def _dev_slab(self, s: int) -> torch.Tensor:
        """Lazily committed device sub-slab ``s`` (lock held), zeroed so the
        ragged install tail is well defined."""
        while len(self._dev_slabs) <= s:
            self._dev_slabs.append(None)
        if self._dev_slabs[s] is None:
            self._dev_slabs[s] = new_subslab(1 << _SLAB_SHIFT,
                                             self.page_words, self.device)
            self.perf.set("device_slabs", self._device_slab_count())
        return self._dev_slabs[s]

    def _device_slab_count(self) -> int:
        return sum(1 for x in self._dev_slabs if x is not None)

    def _slab_stream_begin(self):
        """Before a slab operation (lock held): on CUDA, the current stream,
        made to wait for the previous slab operation if that ran on another
        stream.  None on the CPU."""
        if self._slab_event is None:
            return None
        stream = torch.cuda.current_stream(self.device)
        if self._slab_stream is not None and self._slab_stream != stream:
            stream.wait_event(self._slab_event)
        return stream

    def _slab_stream_end(self, stream) -> None:
        """After a slab operation (lock held): mark where it ends."""
        if stream is not None:
            self._slab_event.record(stream)
            self._slab_stream = stream

    def _available_pages(self) -> int:
        return len(self._free) + (self._pages_total - self._next_page)

    def _alloc_page(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._next_page < self._pages_total:
            pid = self._next_page
            self._next_page += 1
            return pid
        return None

    def _free_entry_pages(self, e: _Entry) -> int:
        freed = 0
        for i, pid in enumerate(e.pages):
            if pid is not None:
                self._free.append(pid)
                e.pages[i] = None
                freed += 1
        self._pages_used -= freed
        self._dirty_page_count -= len(e.dirty)
        e.dirty.clear()
        e.live_pages = 0
        return freed

    def _remove_entry(self, key: Any) -> int:
        """Free a key's pages and bookkeeping; lock held.  Returns pages
        freed."""
        e = self._entries.pop(key, None)
        if e is None:
            return 0
        freed = self._free_entry_pages(e)
        self._mono_bytes -= e.mono_bytes
        self._memo_discard(key)
        return freed

    def _sync_gauges(self) -> None:
        """Lock held."""
        self.perf.set("pages_used", self._pages_used)
        self.perf.set("dirty_pages", self._dirty_page_count)
        self.perf.set("dirty_bytes",
                      self._dirty_page_count * self.page_bytes)
        self.perf.set("resident_bytes",
                      self._pages_used * self.page_bytes)
        self.perf.set("entries", len(self._entries))
        self.perf.set("memo_bytes", self.memo_bytes)
        self.perf.set("pages_total", self._pages_total)
        self.perf.set("frag_saved_bytes", max(0, self.frag_saved_signed))
        self.perf.set("device_slabs", self._device_slab_count())

    def _resync_gauges(self) -> None:
        with self._lock:
            self._sync_gauges()

    @property
    def frag_saved_signed(self) -> int:
        """Monolithic-equivalent footprint minus actual page footprint.
        Positive = the pow2 pad the paged layout never allocated minus the
        ragged-tail waste it did; can go (slightly) negative for tiny
        residents whose tail waste exceeds their pad."""
        return self._mono_bytes - self._pages_used * self.page_bytes

    # -- install -------------------------------------------------------------

    @staticmethod
    def _trim_cols(dtype: np.dtype, cols: int, trim: Optional[int]) -> int:
        """Array columns to keep for a pre-pad packed byte width of
        ``trim``: plane words carry 32 packed byte columns each; int8 plane
        columns are byte columns, rounded up to whole words so any bit-row
        range stays word-aligned in the flattened pool."""
        if not trim or trim <= 0:
            return cols
        if np.dtype(dtype) == _WORDS:
            return min(cols, -(-int(trim) // 32))
        return min(cols, ((int(trim) + 3) // 4) * 4)

    def _install_pages_locked(self, src, rows: int, keep: int, cols: int,
                              total_words: int, from_device: bool):
        """Device-arm install (lock held): allocate page ids and the page
        table, then write the words into the pages: admitted rows
        (``_PackedRows``) as their plane words by to_packedbit_paged;
        anything else as a zero-padded page image built on the device (from
        a device resident with no host copy, or from host rows with ONE
        non-blocking copy out of pinned memory), written into each touched
        sub-slab with one slab_install.  Returns (page ids, table)."""
        npages = -(-total_words // self.page_words) if total_words else 0
        pages: List[Optional[int]] = []
        for _ in range(npages):
            pid = self._alloc_page()
            assert pid is not None  # _available_pages said so
            pages.append(pid)
        if not npages:
            return pages, None
        stream = self._slab_stream_begin()
        table = PageTable(pages, {s: self._dev_slab(s) for s in
                                  sorted({p >> _SLAB_SHIFT for p in pages})},
                          self.page_words, _SLAB_SHIFT)
        if from_device:
            data = src.data if isinstance(src, _PackedRows) else src
            if stream is not None:
                # the caller may free its product once this returns: its
                # memory must wait for the writes below on this stream
                data.record_stream(stream)
            self.device_installs += 1
            self.perf.inc("device_installs")
        if isinstance(src, _PackedRows):
            to_packedbit_paged(src.data, table)
            self._slab_stream_end(stream)
            return pages, table
        n = npages * self.page_words
        if from_device:
            image = torch.zeros(n, dtype=torch.int32, device=self.device)
            image[:total_words].view(src.dtype).view(rows, cols)[
                :, :keep].copy_(src[:, :keep])
        else:
            host = torch.zeros(n, dtype=torch.int32,
                               pin_memory=self.device.type == "cuda")
            host.numpy()[:total_words] = src
            image = host.to(self.device, non_blocking=True)  # the ONE h2d
            self.h2d_installs += 1
            self.perf.inc("h2d_installs")
        install_pages(table, image.view(npages, self.page_words))
        self._slab_stream_end(stream)
        return pages, table

    def put_planar(self, key: Any, bits, w: int = 8,
                   n_rows: Optional[int] = None, meta: Any = None,
                   trim: Optional[int] = None,
                   data_rows: Optional[int] = None,
                   dirty_rows: Optional[Iterable[Tuple[int, int]]] = None,
                   dirty_info: Any = None,
                   now: Optional[float] = None) -> bool:
        """Install a resident into pages.  ``bits`` is packed-bit words
        (int32, or the reference's uint32 on the host), int8 planes or raw
        uint8 rows, as a tensor or numpy array.  ``trim`` (pre-pad packed
        byte width) drops the encode lane's pad before paging.
        ``data_rows`` marks the bit-row prefix that is data (shed_parity
        boundary).  ``dirty_rows`` marks bit-row ranges whose store apply is
        DEFERRED (writeback); ``dirty_info`` carries the owner's flush
        contract.  Returns False, with nothing installed, when the pool
        cannot fit the resident even after evicting every clean colder
        entry (the caller takes the uninstalled path; refusal is counted,
        never an error)."""
        # device-native install: a resident already on the store's device
        # (a queue product, or admitted rows) never bounces through host
        # memory
        from_device = isinstance(bits, _PackedRows) or (
            self.device_arm and is_device_array(bits, self.device)
            and bits.dtype in (torch.int32, torch.int8))
        if from_device:
            src = bits
            dtype = np.dtype(np.int32 if bits.dtype == torch.int32
                             else np.int8)
        else:
            src = _host_array(bits)
            dtype = src.dtype
        rows, cols_full = int(src.shape[0]), int(src.shape[1])
        if n_rows is None:
            n_rows = rows // w
        itemsize = dtype.itemsize
        mono_bytes = rows * cols_full * itemsize
        keep = cols = self._trim_cols(dtype, cols_full, trim)
        if dtype != _WORDS and cols % 4:
            # rows that are not words stay word-aligned in the flattened
            # pool (gather addresses bit-rows as cols*itemsize//4 words):
            # pad the row width up to whole words; `trim` keeps the true
            # byte width for read()'s final slice
            cols += 4 - cols % 4
        if not from_device:
            arr = src[:, :keep]
            if cols > keep:
                arr = np.pad(arr, ((0, 0), (0, cols - keep)))
            src = np.ascontiguousarray(arr).reshape(-1).view(_WORDS)
        total_words = rows * cols * itemsize // 4
        npages = max(1, -(-total_words // self.page_words))
        with self.perf.time_avg("unpack_s"), self._lock:
            self._remove_entry(key)
            if npages > self._pages_total:
                self.perf.inc("install_refused")
                self._sync_gauges()
                return False
            while self._available_pages() < npages:
                victim = None
                for k, e in self._entries.items():  # LRU-oldest first
                    if not e.dirty:
                        victim = k
                        break
                if victim is None:
                    self.perf.inc("install_refused")
                    self._sync_gauges()
                    return False
                freed = self._remove_entry(victim)
                self.evictions += 1
                self.perf.inc("evict")
                self.perf.inc("page_evictions", freed)
            e = _Entry()
            e.table = None
            if self.device_arm:
                e.pages, e.table = self._install_pages_locked(
                    src, rows, keep, cols, total_words, from_device)
            else:
                e.pages = []
                off = 0
                while off < total_words:
                    pid = self._alloc_page()
                    assert pid is not None  # _available_pages said so
                    n = min(self.page_words, total_words - off)
                    self._page(pid)[:n] = src[off:off + n]
                    e.pages.append(pid)
                    off += n
            e.dtype = dtype
            e.rows = rows
            e.cols = cols
            e.itemsize = itemsize
            e.w = w
            e.n_rows = n_rows
            e.meta = meta
            e.trim = trim
            e.data_rows = data_rows
            e.mono_bytes = mono_bytes
            e.total_words = total_words
            e.live_pages = len(e.pages)
            e.dirty = set()
            e.dirty_info = dirty_info
            e.dirty_since = time.monotonic() if now is None else now
            self._gen += 1
            e.dirty_gen = self._gen
            self._pages_used += len(e.pages)
            self._mono_bytes += mono_bytes
            if dirty_rows:
                row_words = cols * itemsize // 4
                for r0, r1 in dirty_rows:
                    p0 = (r0 * row_words) // self.page_words
                    p1 = -(-(r1 * row_words) // self.page_words)
                    e.dirty.update(range(p0, min(p1, len(e.pages))))
                self._dirty_page_count += len(e.dirty)
            self._entries[key] = e
            self._entries.move_to_end(key)
            self.admits += 1
            self._sync_gauges()
        self.perf.inc("admit")
        if dirty_rows and e.dirty:
            self.perf.inc("writeback_installs")
        return True

    # -- raw dirty objects (writeback fast-ack path) -------------------------

    def put_raw(self, key: Any, data: bytes, meta: Any = None,
                dirty_info: Any = None,
                now: Optional[float] = None) -> bool:
        """Install the WHOLE-OBJECT bytes as a raw dirty resident (no EC
        encode has happened; the flush path owns the k+m destage).  Layout:
        one uint8 bit-row padded to a whole word, ``w=0`` as the raw
        sentinel (the planar helpers see a zero-height gather range and
        fall through; ``trim`` keeps the true byte length).  Every page is
        dirty.  Same refusal contract as put_planar."""
        raw = np.frombuffer(bytes(data), dtype=np.uint8)
        if len(raw) % 4:
            raw = np.pad(raw, (0, 4 - len(raw) % 4))
        return self.put_planar(key, raw.reshape(1, -1), w=0, n_rows=1,
                               meta=meta, trim=len(data),
                               dirty_rows=[(0, 1)], dirty_info=dirty_info,
                               now=now)

    def is_raw(self, key: Any) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return e is not None and e.w == 0

    def read_raw(self, key: Any) -> Optional[bytes]:
        """The raw entry's object bytes (None when absent, partial, or not a
        raw entry).  On the device arm the copy to the host here is the
        declared exit."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.w != 0:
                return None
            trim = e.trim
            bits = self._gather_locked(e, 0, e.rows)
        if bits is None:
            return None
        out = _host_array(bits).view(np.uint8).reshape(-1)
        self.note_d2h()
        return out[:trim].tobytes()

    # -- lookup --------------------------------------------------------------

    def _gather_locked(self, e: _Entry, r0: int, r1: int):
        row_words = e.cols * e.itemsize // 4
        w0, w1 = r0 * row_words, r1 * row_words
        if w1 > e.total_words or w0 < 0 or w1 <= w0:
            return None
        p0, p1 = w0 // self.page_words, -(-w1 // self.page_words)
        span = e.pages[p0:p1]
        if any(p is None for p in span):
            return None
        if self.device_arm:
            return self._gather_device_locked(e, r0, r1, w0, w1)
        out = np.empty(w1 - w0, dtype=_WORDS)
        pos = 0
        for i, pid in enumerate(span):
            page = self._page(pid)
            start = (w0 - p0 * self.page_words) if i == 0 else 0
            avail = min(self.page_words,
                        e.total_words - (p0 + i) * self.page_words)
            take = min(avail - start, (w1 - w0) - pos)
            out[pos:pos + take] = page[start:start + take]
            pos += take
        if e.dtype != _WORDS:
            return out.view(e.dtype).reshape(r1 - r0, e.cols)
        return out.reshape(r1 - r0, e.cols)

    def _gather_device_locked(self, e: _Entry, r0: int, r1: int,
                              w0: int, w1: int) -> torch.Tensor:
        """Device-arm gather (lock held): one slab_gather per touched
        sub-slab run, concatenated and sliced on the device.  The result is
        a fresh tensor, never a slab view: it stays valid across later
        installs and stays on the device; the host exits are read(),
        read_paged() and ecutil's ``_pack_rows`` (counted as
        ``d2h_gathers`` through note_d2h)."""
        stream = self._slab_stream_begin()
        out = gather_words(e.table, w0, w1 - w0)
        self._slab_stream_end(stream)
        if e.dtype != _WORDS:
            # little-endian words -> their bytes, LSB first, as numpy's
            # .view gives them on the host arm
            out = out.view(torch.int8 if e.dtype == np.int8 else torch.uint8)
        return out.view(r1 - r0, e.cols)

    def gather_rows(self, key: Any, r0: int, r1: int):
        """[r1-r0, cols] rows gathered from the page table (numpy on the
        host arm, a tensor on the device arm), or None when the entry is
        absent or any needed page was evicted (a partial resident can still
        serve any fully covered row range: the data-row prefix after a
        parity shed).  No LRU side effects (``touch`` owns those)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            return self._gather_locked(e, r0, r1)

    def touch(self, key: Any):
        """(w, n_rows, meta) with LRU refresh and hit/miss counting: the
        read path's entry probe, materializing nothing."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        self.perf.inc("hit" if e is not None else "miss")
        return None if e is None else (e.w, e.n_rows, e.meta)

    def entry_info(self, key: Any):
        """(w, n_rows, meta) without LRU or counter side effects."""
        with self._lock:
            e = self._entries.get(key)
        return None if e is None else (e.w, e.n_rows, e.meta)

    def resident_meta(self, key: Any):
        """The entry's caller meta (the OSD stores (version, n_cols,
        object_size)), or None: the policy probe shape."""
        info = self.entry_info(key)
        return None if info is None else info[2]

    def get_planar(self, key: Any):
        """(bits, w, n_rows, meta) or None; refreshes LRU position.  Gathers
        the WHOLE resident: None when partial (parity shed)."""
        got = self.touch(key)
        if got is None:
            return None
        w, n_rows, meta = got
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            bits = self._gather_locked(e, 0, e.rows)
        if bits is None:
            return None
        return (bits, w, n_rows, meta)

    def peek(self, key: Any):
        """get_planar without LRU order or counter side effects."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            bits = self._gather_locked(e, 0, e.rows)
        if bits is None:
            return None
        return (bits, e.w, e.n_rows, e.meta)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def entry_nbytes(self, key: Any) -> int:
        """Live page footprint of one entry (0 when absent)."""
        with self._lock:
            e = self._entries.get(key)
            return e.live_pages * self.page_bytes if e is not None else 0

    def entries_snapshot(self) -> List[Tuple[Any, int]]:
        """(key, page-footprint bytes) in LRU order, oldest first: the tier
        agent's eviction-candidate input."""
        with self._lock:
            return [(k, e.live_pages * self.page_bytes)
                    for k, e in self._entries.items()]

    # -- host boundary (the PlanarShardStore surface) ------------------------

    def _on_device(self, bits) -> torch.Tensor:
        """Gathered rows as a tensor on the store's device (host-arm numpy
        rows cross once, for the converter)."""
        if isinstance(bits, torch.Tensor):
            return bits
        return torch.from_numpy(np.ascontiguousarray(bits)).to(self.device)

    def admit(self, key: Any, rows: np.ndarray, w: int = 8,
              meta: Any = None, layout: str = "planes") -> bool:
        """Convert packed [n, B] uint8 rows on the store's device (plane
        words for layout="packedbit", w=8 only; int8 planes for "planes")
        and keep them page-resident (PlanarShardStore.admit contract).  On
        the device arm packed-bit words are written straight into the pages
        (to_packedbit_paged), so no converted tensor exists: the return is
        put_planar's, whether the rows were installed."""
        from ceph_tpu_torch.ops.gf2 import to_packedbit, to_planar

        data = self._on_device(rows)
        if layout == "packedbit":
            if w != 8:
                raise ValueError("packed-bit residency is the w=8 byte "
                                 f"layout, got w={w}")
            bits = (_PackedRows(data.contiguous()) if self.device_arm
                    else to_packedbit(data))
        else:
            bits = to_planar(data, w)
        return self.put_planar(key, bits, w=w, n_rows=rows.shape[0],
                               meta=meta, trim=rows.shape[1])

    def note_d2h(self) -> None:
        """Count ONE device->host copy at a declared exit boundary (this
        module's read(); ecutil's ``_pack_rows`` callers).  No-op on the
        host arm: nothing left the device."""
        if self.device_arm:
            self.d2h_gathers += 1
            self.perf.inc("d2h_gathers")

    def read_paged(self, key: Any, r0: int, r1: int, out_rows: int, L: int,
                   cs: int = 0, object_size: int = 0) -> Optional[np.ndarray]:
        """Bit-rows r0..r1 of a packed-bit resident on the device arm packed
        to host bytes in one launch from its pages (from_packedbit_paged)
        and one copy into pinned memory (a SLAB_IO_BOUNDARY exit, counted
        in ``d2h_gathers``): [out_rows, L'] shard rows, or with cs > 0 the
        object's first object_size stripe-major bytes, flat.  L' is L cut
        to the resident's kept width, as a slice of the gathered rows would
        cut it; an object read raises ValueError, as the reshape of such
        rows would, unless L' is L // cs (at least 1) chunks.  None when
        the entry is absent, partial over the range, or not packed-bit
        words on the device arm: the caller then takes gather_rows.  No LRU
        or hit/miss side effects."""
        if not self.device_arm:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.dtype != _WORDS:
                return None
            row_words = e.cols
            w0, w1 = r0 * row_words, r1 * row_words
            if w1 > e.total_words or w0 < 0 or w1 <= w0 or any(
                    p is None for p in e.pages[w0 // self.page_words:
                                               -(-w1 // self.page_words)]):
                return None
            if r1 - r0 != out_rows * 8:
                raise ValueError(f"read_paged: {r1 - r0} plane rows for "
                                 f"{out_rows} rows")
            width = min(L, 32 * row_words)
            if cs and width != max(1, L // cs) * cs:
                raise ValueError(f"read_paged: rows of {width} bytes are "
                                 f"not {max(1, L // cs)} chunks of {cs}")
            stream = self._slab_stream_begin()
            out = from_packedbit_paged(e.table, w0, row_words, out_rows,
                                       width, cs, object_size)
            self._slab_stream_end(stream)
        host = _to_host(out)
        self.note_d2h()
        return host

    def read(self, key: Any) -> Optional[np.ndarray]:
        """The resident rows packed back to [n, B] uint8 host bytes; None
        when absent or partial.  On the device arm packed-bit words go
        through read_paged (one launch from the pages, one copy into pinned
        memory); other layouts gather and convert on the device, and the
        copy here is the single device->host copy (the SLAB_IO_BOUNDARY
        exit)."""
        from ceph_tpu_torch.ops.gf2 import from_packedbit, from_planar

        with self._lock:
            e = self._entries.get(key)
            paged = self.device_arm and e is not None and e.dtype == _WORDS
            if paged:
                rows, cols, trim = e.rows, e.cols, e.trim
        if paged:
            got = self.touch(key)
            if got is None:
                return None
            t0 = time.monotonic()
            out = self.read_paged(key, 0, rows, got[1], 32 * cols
                                  if trim is None else trim)
            if out is not None:
                self.perf.tinc("pack_s", time.monotonic() - t0)
            return out
        got = self.get_planar(key)
        if got is None:
            return None
        bits, w, n_rows, _meta = got
        with self._lock:
            e = self._entries.get(key)
            trim = e.trim if e is not None else None
        if w == 0:
            # raw whole-object entry (put_raw): the single uint8 bit-row IS
            # the bytes
            out = _host_array(bits).view(np.uint8).reshape(1, -1)
            self.note_d2h()
            return out if trim is None else out[:, :trim]
        bits = self._on_device(bits)
        with self.perf.time_avg("pack_s"):
            if bits.dtype == torch.int32:
                out = from_packedbit(bits, n_rows)
            else:
                out = from_planar(bits, w, n_rows)
            out = (out if trim is None else out[:, :trim]).cpu().numpy()
        self.note_d2h()
        return out

    # -- eviction ------------------------------------------------------------

    def drop(self, key: Any, force: bool = False) -> bool:
        """Remove `key` if resident; True when an entry was dropped.  A
        DIRTY entry refuses (flush-before-evict: writeback pages must never
        be the only copy of acked data) unless ``force``: deletes and
        overwrite-failure cleanup force, because there the data itself is
        going away.  Dropping an absent key is a supported no-op."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._memo_discard(key)
                self._sync_gauges()
                return False
            if e.dirty and not force:
                self.perf.inc("evict_refused_dirty")
                return False
            freed = self._remove_entry(key)
            self.evictions += 1
            self._sync_gauges()
        self.perf.inc("evict")
        self.perf.inc("page_evictions", freed)
        return True

    def shed_parity(self, key: Any) -> int:
        """Partial eviction: free the CLEAN page suffix past the data-row
        boundary (the parity rows).  The data prefix keeps serving reads
        through gather_rows; get_planar and planar_rows see a partial
        resident and fall back.  Returns bytes freed (0 when no boundary
        was recorded, nothing to shed, or the suffix holds dirty pages)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.data_rows is None or e.data_rows >= e.rows:
                return 0
            row_words = e.cols * e.itemsize // 4
            boundary = -(-(e.data_rows * row_words) // self.page_words)
            freed = 0
            for i in range(boundary, len(e.pages)):
                if e.pages[i] is None or i in e.dirty:
                    continue
                self._free.append(e.pages[i])
                e.pages[i] = None
                e.live_pages -= 1
                freed += 1
            self._pages_used -= freed
            if freed:
                self._sync_gauges()
        if freed:
            self.perf.inc("parity_sheds")
            self.perf.inc("page_evictions", freed)
        return freed * self.page_bytes

    # -- dirty lifecycle (writeback) -----------------------------------------

    def is_dirty(self, key: Any) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return bool(e is not None and e.dirty)

    def has_dirty(self) -> bool:
        return self._dirty_page_count > 0

    def peek_dirty(self, key: Any):
        """(dirty_info, generation token) or None.  The token pins the exact
        install the caller is about to flush."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or not e.dirty:
                return None
            return (e.dirty_info, e.dirty_gen)

    def dirty_items(self) -> List[Tuple[Any, Any, int, float]]:
        """Snapshot of (key, dirty_info, generation, dirty_since),
        oldest-dirty first: the flush agent's input."""
        with self._lock:
            items = [(k, e.dirty_info, e.dirty_gen, e.dirty_since)
                     for k, e in self._entries.items() if e.dirty]
        items.sort(key=lambda t: t[3])
        return items

    def clear_dirty(self, key: Any, gen: int) -> bool:
        """Mark the entry clean after a successful flush, only when ``gen``
        still names the install the caller flushed (an overwrite
        re-installed and bumped the generation: its dirt is NOT flushed,
        and clearing it would lose acked data)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.dirty_gen != gen or not e.dirty:
                return False
            self._dirty_page_count -= len(e.dirty)
            e.dirty.clear()
            e.dirty_info = None
            self._gen += 1
            e.dirty_gen = self._gen
            self._sync_gauges()
        return True

    # -- exit-boundary memo (page-granular accounting) -----------------------

    def _memo_charge(self, nbytes: int) -> int:
        return -(-nbytes // self.page_bytes) * self.page_bytes

    def _memo_discard(self, key: Any) -> None:
        """Lock held."""
        got = self._memo.pop(key, None)
        if got is not None:
            self.memo_bytes -= self._memo_charge(self._memo_raw.pop(key))

    def memo_get(self, key: Any, version: Any):
        with self._lock:
            if key not in self._entries:
                return None
            got = self._memo.get(key)
        if got is None or got[0] != version:
            return None
        return got[1]

    def memo_put(self, key: Any, version: Any, value: Any) -> None:
        """Record the packed host result of this resident at `version`.  The
        cap is accounted in PAGE units against the pool's byte size, so the
        memo gauge never drifts from the granularity residency is budgeted
        in.  Ignored when the entry is not resident or the memo is at its
        budget."""
        charge = self._memo_charge(len(value))
        with self._lock:
            if key not in self._entries:
                return
            self._memo_discard(key)
            if self.memo_bytes + charge > self.capacity_bytes:
                self.perf.set("memo_bytes", self.memo_bytes)
                return
            self._memo[key] = (version, value)
            self._memo_raw[key] = len(value)
            self.memo_bytes += charge
            self.perf.set("memo_bytes", self.memo_bytes)

    # -- introspection -------------------------------------------------------

    def page_stats(self) -> Dict[str, int]:
        with self._lock:
            partial = sum(1 for e in self._entries.values()
                          if e.live_pages < len(e.pages))
            return {
                "page_bytes": self.page_bytes,
                "pages_total": self._pages_total,
                "pages_used": self._pages_used,
                "dirty_pages": self._dirty_page_count,
                "dirty_bytes": self._dirty_page_count * self.page_bytes,
                "dirty_entries": sum(1 for e in self._entries.values()
                                     if e.dirty),
                "partial_residents": partial,
                "frag_saved_bytes": max(0, self.frag_saved_signed),
                "monolithic_equiv_bytes": self._mono_bytes,
                "device_arm": int(self.device_arm),
                "device_slabs": self._device_slab_count(),
                "h2d_installs": self.h2d_installs,
                "device_installs": self.device_installs,
                "d2h_gathers": self.d2h_gathers,
            }

    def stats(self) -> Dict[str, int]:
        return {"resident_bytes": self.resident_bytes,
                "memo_bytes": self.memo_bytes,
                "entries": len(self._entries), "admits": self.admits,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "pages_total": self._pages_total,
                "pages_used": self._pages_used,
                "dirty_pages": self._dirty_page_count,
                "frag_saved_bytes": self.frag_saved_signed,
                "monolithic_equiv_bytes": self._mono_bytes,
                "device_arm": int(self.device_arm),
                "device_slabs": self._device_slab_count(),
                "h2d_installs": self.h2d_installs,
                "device_installs": self.device_installs,
                "d2h_gathers": self.d2h_gathers}
