"""Stripe-batching dispatch queue: many small EC requests, one kernel launch
a round.

Copy of ceph_tpu/parallel/service.py:72-1531 at commit 645aba9 (the
BatchingQueue, its lanes, breaker and counters, and PlanarShardStore, the
monolithic resident store), on PyTorch, with its mesh seam as of commit
d2d1706.  Not copied: the host GF(2) mirrors, because the port has no CPU
route (below).

The queue aggregates encode/decode requests from many objects and ops,
concatenates them column-wise into one [rows, sum(B)] buffer per (matrix,
layout) group, runs ONE lane call of ops/gf2.py on it, and fans the results
back out.  submit() is non-blocking and returns a Future; a worker thread
cuts a round when pending bytes cross `max_pending_bytes` or the oldest
request has waited `max_delay`; flush() drains synchronously.

The six lanes and the port function each launches:

    packed              gf2_apply_bytes        K1 (w=8), K2 (w=16, w=4)
    planar              gf2_matmul             K2, over device int8 planes
    resident            gf2_encode_resident    K2, parity bytes + planes
    packedbit           gf2_apply_packedbit    K4
    packedbit_resident  gf2_encode_packedbit_resident  K4, bytes + plane words
    packedbit_planes    gf2_xor_packed         K3, over device plane words

Byte results (packed, packedbit, and the parity half of the resident lanes)
resolve to host numpy arrays, copies that own their memory; plane results
resolve to tensors on the queue's device.  Plane words are int32 tensors
carrying the reference's uint32 bits.

Device, streams and staging.  The queue runs on the CUDA device unless
``device="cpu"`` is given (resolve_device; it raises without a card).  On
the CPU every lane runs its kernels' plain versions, synchronously.  On
CUDA the queue owns two streams.  A round's byte requests are copied into a
pinned host buffer (torch's caching host allocator: freed blocks are reused,
and a block freed while a non-blocking copy reads it waits for that copy)
and sent to the card with a non-blocking copy on the copy-in stream; the
lane's kernel and the copy of its byte result into another pinned buffer
run on the compute stream, after an event of the copy-in; an event recorded
after them is the round's `done`.  So round N+1's host->device copy can run
under round N's kernel and device->host copy, if the host stages N+1 before
the device has finished N.  (`overlapped_rounds` counts rounds launched
while the previous one was still in flight: the launch order, not what the
device overlapped, which only a profiler trace shows.)  The copy into
pinned memory is a host memcpy on the worker thread (JAX's device_put
returns at once), so the device has mostly finished a round before the next
is staged: the worker fans a round out as soon as its `done` event has
completed, unless the next round is already due, which it launches first.
A round's futures resolve only after its `done` event has completed, and
fan-out copies out of the pinned buffer.  Device tensors a caller submits
are waited for (an event recorded on the submitter's stream at submit) and
kept alive for the compute stream (record_stream); device tensors a caller
receives are record_stream'ed on the submitter's stream, so that freeing
them there cannot hand their memory to the next round.  Columns are not
padded to buckets: the kernels take any B.

Device-dispatch circuit breaker, as the reference's but with no CPU route:
every lane has a breaker.  CLOSED: groups go to the device; a launch or
completion that raises fails every future of its group with
ErasureCodeError(-EIO) naming the lane and the device, and trips the lane
OPEN; a dispatch that completes but exceeds ``dispatch_timeout`` trips it
after the fact.  OPEN: the lane's groups fail with -EIO until the cooldown
elapses (doubling per consecutive trip, capped).  HALF-OPEN: one group
probes the device; success closes the breaker, failure re-opens it.
``inject_dispatch_delay`` slows dispatches to exercise the watchdog.  Where
the reference would serve a group on the host, the port fails it, so
`breaker_fallback` stays 0.

Environment, read at construction, the reference's names:
CEPH_TPU_BATCH_DELAY (default max_delay, seconds), CEPH_TPU_DISPATCH_TIMEOUT
(watchdog seconds), CEPH_TPU_INJECT_DISPATCH_DELAY (seconds added to every
dispatch).  The reference's ``use_pallas`` argument is not taken.

Device mesh (parallel/mesh.py).  ``mesh=None`` auto-detects
(``shared_mesh(device)``: every card when two or more are visible, 8 shards
of the queue's device under CEPH_TPU_MESH=1, else none), ``mesh=False`` pins
the queue to its one device, and a MeshDispatcher is used as given.  On a
mesh every lane pads its batch's columns so that each shard is a whole
number of symbols (packed, resident: w/8 bytes), of 32-byte plane words
(packedbit, packedbit_resident) or of columns (planar, packedbit_planes),
lays it across the mesh (``shard_batch``), runs the lane's own kernel once a
shard on the shard's device, and gathers the products in column order onto
the queue's device; the fan-out slices real columns only, and `bytes` counts
the batch before the pad.  So byte results come back through one pinned
buffer, and plane results (which the reference leaves sharded across its
chips) are one tensor on the queue's device.  Every other card of the mesh
has its own compute stream, current on that card while a round launches:
the copies to and from it and its kernels run there, ordered against the
queue's streams by torch's cross-device copies, so the round's `done` event
on the queue's compute stream follows every shard.  A shard that fails
fails its group with -EIO, like any dispatch error (the reference serves a
sick mesh's batch on one device).

Observability: the `ec_cuda` counter set (schema in _build_ec_cuda_perf,
the reference's `ec_tpu` names and kinds), `dump_timeline()` for the
`dump_ec_batch_timeline` admin-socket command, and trace spans: a `span=`
parent gets submit/coalesce/fan-out events plus a child span per dispatch
tagged with lane, group size and bytes.  `span` and `tracer` are any
objects with the reference's `child`/`event`/`tag`/`finish`/`new_trace`.
"""

from __future__ import annotations

import collections
import contextlib
import errno
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ops.gf2 import (bitmatrix_to_tensor, from_packedbit,
                                    from_planar, gf2_apply_bytes,
                                    gf2_apply_packedbit, gf2_encode_packedbit_resident,
                                    gf2_encode_resident, gf2_matmul, gf2_xor_packed,
                                    to_packedbit, to_planar)
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device

#: the six dispatch lanes, in promotion order (int8 trio, packed-bit trio)
LANES = ("packed", "planar", "resident",
         "packedbit", "packedbit_resident", "packedbit_planes")


def _build_ec_cuda_perf() -> PerfCounters:
    """The `ec_cuda` counter set (the reference's `ec_tpu` schema):

      submit               u64         requests accepted, all lanes
      submit_<lane>        u64         requests accepted per lane
      bytes_<lane>         u64         packed-equivalent bytes submitted per lane
      dispatch             u64         device calls issued
      sharded_dispatch     u64         dispatches laid across the device mesh
      overlapped_rounds    u64         rounds launched while the previous one
                                       was in flight (launch order)
      bytes                u64         bytes dispatched
      queue_wait           longrunavg  submit -> launch wait per request
      dispatch_dev         longrunavg  launch -> fan-out seconds per dispatch, host
                                       included: staging into pinned memory,
                                       the device's work, the wait until the
                                       worker sees it done, the fan-out
      group_size           histogram   coalesced requests per dispatch (pow2 buckets)
      submit_group         u64         multi-item submit_group() calls
      group_submit_size    histogram   items per submit_group() call
      flush_bytes          u64         rounds cut by the bytes threshold
      flush_delay          u64         rounds cut by max_delay expiry
      flush_forced         u64         rounds cut by an explicit flush()/close()
      breaker_trip         u64         lane breaker trips
      breaker_probe        u64         half-open device re-probes
      breaker_recover      u64         breakers closed by a successful probe
      breaker_fallback     u64         groups served on the host (always 0 here)
      breaker_open_lanes   u64         lanes currently tripped open (gauge)
    """
    b = PerfCountersBuilder("ec_cuda")
    b.add_u64_counter("submit", "requests accepted across all lanes")
    b.add_u64_counter("dispatch", "device calls issued")
    b.add_u64_counter("sharded_dispatch",
                      "dispatches that ran across the device mesh")
    b.add_u64_counter("overlapped_rounds",
                      "rounds whose launch overlapped the previous fetch")
    b.add_u64_counter("bytes", "bytes dispatched to the device")
    for lane in LANES:
        b.add_u64_counter(f"submit_{lane}", f"requests on the {lane} lane")
        b.add_u64_counter(f"bytes_{lane}",
                          f"packed-equivalent bytes submitted on {lane}")
    b.add_time_avg("queue_wait", "submit -> launch coalescing wait")
    b.add_time_avg("dispatch_dev",
                   "launch -> fan-out seconds: staging, device, fan-out")
    b.add_histogram("group_size", "coalesced requests per dispatch")
    b.add_u64_counter("submit_group", "multi-item group submits")
    b.add_histogram("group_submit_size", "items per group submit")
    b.add_u64_counter("flush_bytes", "rounds flushed by the bytes threshold")
    b.add_u64_counter("flush_delay", "rounds flushed by max_delay expiry")
    b.add_u64_counter("flush_forced", "rounds flushed by explicit flush()")
    b.add_u64_counter("breaker_trip",
                      "lane breaker trips (dispatch raised or exceeded "
                      "dispatch_timeout)")
    b.add_u64_counter("breaker_probe", "half-open device re-probes")
    b.add_u64_counter("breaker_recover",
                      "breakers closed by a successful probe")
    b.add_u64_counter("breaker_fallback",
                      "groups served by the host CPU path (none: the port "
                      "fails them with -EIO)")
    b.add_u64("breaker_open_lanes", "lanes currently tripped open (gauge)")
    return b.create_perf_counters()


def _env_float(name: str, default: float) -> float:
    """A float from the environment; unset, empty or malformed -> default."""
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


class _LaneBreaker:
    """Per-lane circuit breaker state.  closed -> (trip) -> open ->
    (cooldown elapses) -> one half-open probe -> closed on success, or
    re-open with doubled cooldown on failure."""

    __slots__ = ("state", "open_until", "cooldown", "probing")

    CLOSED = "closed"
    OPEN = "open"

    def __init__(self):
        self.state = self.CLOSED
        self.open_until = 0.0
        self.cooldown = 0.0
        self.probing = False


class _Request(NamedTuple):
    """One queued lane submission.  t_submit feeds the queue_wait latency;
    span threads the submitter's trace through coalesce -> dispatch ->
    fan-out.  On CUDA, `stream` is the submitter's current stream (device
    results are record_stream'ed on it) and `ready` an event recorded on it
    after a device input was written."""

    regions: Any
    future: Future
    t_submit: float
    span: Any = None
    stream: Any = None
    ready: Any = None


@dataclass
class _Group:
    mbits: np.ndarray
    w: int
    out_rows: int
    kind: str = "packed"  # one of LANES
    requests: List[_Request] = field(default_factory=list)
    pending_bytes: int = 0


@dataclass
class _Launched:
    """One launched dispatch awaiting completion (fan-out)."""

    group: _Group
    state: Any
    t_launch: float
    span: Any = None  # child of a submitter's trace, or queue-tracer root
    wait_s: float = 0.0  # mean submit->launch wait across the group
    done: Any = None  # CUDA event after the round's last operation

    def finished(self) -> bool:
        return self.done is None or self.done.query()


class BatchingQueue:
    #: seconds between polls of an in-flight round's `done` event
    POLL_S = 0.0005

    def __init__(
        self,
        # 16 MiB of packed bytes a round (the reference's default)
        max_pending_bytes: int = 16 << 20,
        max_delay: Optional[float] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        # mesh=None: auto-detect; mesh=False: this one device
        if mesh is None:
            from ceph_tpu_torch.parallel.mesh import shared_mesh

            mesh = shared_mesh(self.device)
        self.mesh = mesh or None
        self.max_pending_bytes = max_pending_bytes
        # an explicit max_delay wins over CEPH_TPU_BATCH_DELAY
        if max_delay is None:
            max_delay = _env_float("CEPH_TPU_BATCH_DELAY", 0.002)
        self.max_delay = max_delay
        self.perf = _build_ec_cuda_perf()
        # optional per-daemon tracer: dispatch spans with no submitter
        # parent root here
        self.tracer = None
        # bounded ring of recent dispatches for `dump_ec_batch_timeline`
        self.timeline: "collections.deque" = collections.deque(maxlen=128)
        self.dispatch_timeout = _env_float("CEPH_TPU_DISPATCH_TIMEOUT", 30.0)
        # slow every device dispatch by this many seconds (0 = off)
        self.inject_dispatch_delay = _env_float(
            "CEPH_TPU_INJECT_DISPATCH_DELAY", 0.0)
        self.breaker_cooldown = 1.0
        self.breaker_cooldown_max = 30.0
        self._breakers: Dict[str, _LaneBreaker] = {}
        self._breaker_lock = threading.Lock()
        # test seam: invoked (worker thread) after a round is launched,
        # before the backlog check
        self._launch_hook = None
        # the other cards of a mesh: a compute stream each
        self._shard_streams: Dict[torch.device, Any] = {}
        if self.device.type == "cuda":
            self._copy_in = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)
            for dev in (self.mesh.unique_devices if self.mesh else ()):
                if dev != self.device:
                    self._shard_streams[dev] = torch.cuda.Stream(dev)
        else:
            self._copy_in = self._compute = None
        # bit-matrices on the device for the int8-plane lanes, by content
        self._mats: "OrderedDict" = OrderedDict()
        self._mats_lock = threading.Lock()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._groups: Dict[Tuple, _Group] = {}
        self._pending = 0
        self._oldest: Optional[float] = None
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ec-batch")
        self._worker.start()

    # -- counter views ---------------------------------------------------------

    @property
    def submits(self) -> int:
        return self.perf.get("submit")

    @property
    def dispatches(self) -> int:
        return self.perf.get("dispatch")

    @property
    def bytes_dispatched(self) -> int:
        return self.perf.get("bytes")

    @property
    def sharded_dispatches(self) -> int:
        return self.perf.get("sharded_dispatch")

    @property
    def overlapped_rounds(self) -> int:
        return self.perf.get("overlapped_rounds")

    def dump_timeline(self, count: int = 32) -> List[Dict[str, Any]]:
        """Most-recent-first dispatch records for the admin-socket command
        `dump_ec_batch_timeline`: lane, group size, bytes, queue wait,
        device seconds, and the error of a group that failed."""
        return list(self.timeline)[-max(1, int(count)):][::-1]

    def register_asok(self, asok) -> None:
        """Expose the dispatch timeline on a daemon's admin socket
        (`dump_ec_batch_timeline [count=N]`)."""
        asok.register(
            "dump_ec_batch_timeline",
            lambda a: self.dump_timeline(int(a.get("count", 32))),
            "recent EC batch dispatches (lane, group size, wait, device s)")

    # -- client side -------------------------------------------------------

    def submit(
        self, mbits: np.ndarray, regions: np.ndarray, w: int, out_rows: int,
        span=None,
    ) -> "Future[np.ndarray]":
        """Queue (mbits @ regions) over the byte layout: [n, B] uint8 rows
        in; resolves to the [out_rows, B] uint8 parity/reconstruction."""
        return self._submit(mbits, regions, w, out_rows, "packed", span)

    def submit_planar(
        self, mbits: np.ndarray, bits, w: int, out_rows: int, span=None
    ) -> "Future[torch.Tensor]":
        """Queue (mbits @ bits) over int8 bit-planes ([rows*w, Bcols], a
        tensor on the queue's device); resolves to the [out_rows*w, Bcols]
        int8 planes on the device, unpacked."""
        return self._submit(mbits, bits, w, out_rows, "planar", span)

    def submit_resident(
        self, mbits: np.ndarray, rows: np.ndarray, w: int, out_rows: int,
        span=None,
    ) -> "Future[tuple]":
        """The residency write path: packed [n, B] uint8 rows in, one call
        (unpack + matmul + parity pack); resolves to (packed parity numpy
        [out_rows, B], all planes [(n+out_rows)*w, Bc] int8 on the
        device)."""
        return self._submit(mbits, rows, w, out_rows, "resident", span)

    def submit_packedbit(
        self, mbits: np.ndarray, regions: np.ndarray, w: int, out_rows: int,
        span=None,
    ) -> "Future[np.ndarray]":
        """Queue a [out_rows*8, n*8] GF(2) bit-matrix over packed [n, B]
        uint8 rows through the packed-bit XOR-schedule lane (one K4 launch
        per coalesced group); resolves to the [out_rows, B] uint8 result.
        Encode generators and decode matrices alike: each matrix is its
        own group and its own schedule in the LRU."""
        self._check_w8(w)
        return self._submit(mbits, regions, w, out_rows, "packedbit", span)

    def submit_packedbit_resident(
        self, mbits: np.ndarray, rows: np.ndarray, w: int, out_rows: int,
        span=None,
    ) -> "Future[tuple]":
        """Packed-bit residency write path: packed [n, B] uint8 rows in
        (B % 32 == 0); resolves to (packed parity numpy [out_rows, B], data
        and parity plane words [(n+out_rows)*8, B//32] int32 on the
        device)."""
        self._check_w8(w)
        if rows.shape[1] % 32:
            # reject at submission: a misaligned request that reached a
            # launch would fail every request coalesced with it
            raise ValueError(
                "packedbit_resident requests must be 32-byte-column "
                f"aligned, got width {rows.shape[1]}")
        return self._submit(mbits, rows, w, out_rows, "packedbit_resident",
                            span)

    def submit_packedbit_planes(
        self, mbits: np.ndarray, planes, w: int, out_rows: int, span=None
    ) -> "Future[torch.Tensor]":
        """Queue an XOR schedule over plane words ([rows*8, Wc] int32, a
        tensor on the queue's device); resolves to the [out_rows*8, Wc]
        words on the device."""
        self._check_w8(w)
        return self._submit(mbits, planes, w, out_rows, "packedbit_planes",
                            span)

    @staticmethod
    def _check_w8(w: int) -> None:
        if w != 8:
            raise ValueError(f"the packed-bit lanes take w=8, got w={w}")

    def submit_group(self, items, span=None) -> List[Future]:
        """Queue a LIST of lane submissions, each (mbits, regions, w,
        out_rows, kind), under one lock acquisition and one worker wakeup:
        the whole-stripe-group handoff seam (a recovery round's re-encodes,
        a batch of writes).  Items sharing a dispatch signature land in the
        same group exactly as per-item submits would; returns the per-item
        futures, index-aligned."""
        futs: List[Future] = []
        sizes: List[int] = []
        now = time.monotonic()
        if span is not None:
            span.event(f"ec submit group n={len(items)}")
        syncs = [self._caller_sync(item[1]) for item in items]
        with self._cv:
            if self._stop:
                raise RuntimeError("BatchingQueue is closed")
            for (mbits, regions, w, out_rows, kind), sync in zip(items, syncs):
                fut: Future = Future()
                futs.append(fut)
                sizes.append(self._queue_locked(
                    mbits, regions, w, out_rows, kind, fut, now, span, sync))
            if items:
                self._cv.notify()
        for (_, _, _, _, kind), nbytes in zip(items, sizes):
            self._count_submit(kind, nbytes)
        if len(items) > 1:
            self.perf.inc("submit_group")
            self.perf.hinc("group_submit_size", len(items))
        return futs

    def _caller_sync(self, regions) -> Tuple[Any, Any]:
        """(submitter's current stream, event after its writes to a device
        input) on CUDA; (None, None) on the CPU."""
        if self._compute is None:
            return None, None
        stream = torch.cuda.current_stream(self.device)
        ready = None
        if isinstance(regions, torch.Tensor) and regions.is_cuda:
            ready = torch.cuda.Event()
            ready.record(stream)
        return stream, ready

    def _queue_locked(self, mbits, regions, w, out_rows, kind, fut,
                      now, span, sync) -> int:
        """Insert one request into its dispatch group (caller holds the
        lock).  Returns the packed-equivalent byte size counted."""
        if kind not in LANES:
            raise ValueError(f"unknown lane {kind!r}")
        # the full dispatch signature: the same matrix bytes under another
        # w, output arity or lane is another computation
        key = (w, out_rows, kind, mbits.shape, mbits.tobytes())
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(
                mbits=mbits, w=w, out_rows=out_rows, kind=kind)
        group.requests.append(_Request(regions, fut, now, span, *sync))
        nbytes = self._req_bytes(kind, mbits, regions)
        group.pending_bytes += nbytes
        self._pending += nbytes
        if self._oldest is None:
            self._oldest = now
        return nbytes

    def _count_submit(self, kind: str, nbytes: int) -> None:
        self.perf.inc("submit")
        self.perf.inc(f"submit_{kind}")
        self.perf.inc(f"bytes_{kind}", nbytes)

    def _submit(self, mbits, regions, w, out_rows, kind,
                span=None) -> Future:
        fut: Future = Future()
        now = time.monotonic()
        if span is not None:
            span.event(f"ec submit lane={kind}")
        sync = self._caller_sync(regions)
        with self._cv:
            if self._stop:
                raise RuntimeError("BatchingQueue is closed")
            nbytes = self._queue_locked(mbits, regions, w, out_rows, kind,
                                        fut, now, span, sync)
            self._cv.notify()
        self._count_submit(kind, nbytes)
        return fut

    def flush(self) -> None:
        """Synchronously drain everything queued right now."""
        with self._cv:
            groups = self._take_locked()
        if groups:
            self.perf.inc("flush_forced")
        self._dispatch(groups)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=5)
        self.flush()

    # -- worker side -------------------------------------------------------

    @staticmethod
    def _req_bytes(kind: str, mbits: np.ndarray, regions) -> int:
        # flush thresholds are in packed bytes
        if kind == "planar":
            # int8 planes carry a bit a byte
            return regions.shape[1] * mbits.shape[1] // 8
        if kind == "packedbit_planes":
            # plane words carry a bit a bit: plane bytes == packed bytes
            return int(regions.shape[0]) * int(regions.shape[1]) * 4
        return int(regions.nbytes)

    def _take_locked(self, budget: Optional[int] = None) -> List[_Group]:
        """Detach queued work for one round.  With a `budget`, the round is
        bounded to about `budget` packed bytes (whole requests, at least
        one) and the remainder stays queued, so a deep backlog becomes a
        sequence of rounds the worker can pipeline."""
        if budget is None:
            groups = [g for g in self._groups.values() if g.requests]
            self._groups = {}
            self._pending = 0
            self._oldest = None
            return groups
        taken: List[_Group] = []
        taken_bytes = 0
        for key in list(self._groups):
            if taken_bytes >= budget:
                break
            g = self._groups[key]
            if not g.requests:
                del self._groups[key]
                continue
            if taken_bytes + g.pending_bytes <= budget:
                taken.append(g)
                taken_bytes += g.pending_bytes
                del self._groups[key]
                continue
            # split the group: take a FIFO prefix of its requests and move
            # the remainder to the back, so a lane hot enough to fill every
            # round cannot starve the (matrix, kind) groups behind it
            part = _Group(mbits=g.mbits, w=g.w, out_rows=g.out_rows,
                          kind=g.kind)
            while g.requests and (taken_bytes < budget
                                  or not part.requests):
                req = g.requests.pop(0)
                n = self._req_bytes(g.kind, g.mbits, req.regions)
                part.requests.append(req)
                part.pending_bytes += n
                g.pending_bytes -= n
                taken_bytes += n
            if part.requests:
                taken.append(part)
            del self._groups[key]
            if g.requests:
                self._groups[key] = g  # re-insert at tail
            break
        self._pending = sum(g.pending_bytes
                            for g in self._groups.values())
        if self._pending <= 0:
            self._oldest = None
        # else: keep _oldest, so the remainder goes in the next round
        return taken

    def _run(self) -> None:
        # double-buffered: each round is staged and launched without
        # waiting, and the previous round is completed after it, so round
        # N+1's host->device copy can run under round N's kernel and
        # device->host copy.  A launched round is held in flight only while
        # more work is queued and its `done` event has not completed (the
        # worker polls it while it waits), so a round the device has
        # finished is fanned out without waiting for the next round to be
        # cut.  An exception fails the futures in hand; it never ends the
        # thread.
        inflight: Optional[list] = None
        while True:
            groups: List[_Group] = []
            try:
                cause = None  # why this round was cut: bytes | delay
                with self._cv:
                    while not self._stop:
                        if self._pending >= self.max_pending_bytes:
                            cause = "bytes"
                            break
                        if inflight is not None and all(
                                lc.finished() for lc in inflight):
                            break  # the device is done: fan it out now
                        if self._oldest is not None:
                            remaining = self.max_delay - (
                                time.monotonic() - self._oldest)
                            if remaining <= 0:
                                cause = "delay"
                                break
                            if inflight is not None:
                                remaining = min(remaining, self.POLL_S)
                            self._cv.wait(timeout=remaining)
                        elif inflight is not None:
                            break  # nothing queued: fetch the in-flight round
                        else:
                            self._cv.wait()
                    stop = self._stop
                    if not stop and cause is not None:
                        groups = self._take_locked(
                            budget=self.max_pending_bytes)
                if stop:
                    if inflight is not None:
                        inflight, done = None, inflight
                        self._complete_safe(done)
                    return
                if groups and cause is not None:
                    self.perf.inc(f"flush_{cause}")
                launched = self._launch_safe(groups)
                if inflight is not None:
                    if launched:
                        self.perf.inc("overlapped_rounds")
                    inflight, done = None, inflight
                    self._complete_safe(done)
                with self._cv:
                    more = self._pending > 0 and not self._stop
                if launched and more:
                    inflight = launched  # overlap with the next round
                elif launched:
                    self._complete_safe(launched)
            except Exception as e:
                for g in groups + [lc.group for lc in inflight or ()]:
                    self._fail_group(g, e)
                inflight = None

    def _dispatch_span(self, g: _Group):
        """A span for one device dispatch: child of the first submitter's
        trace when one rode in, else a root on the queue's own tracer; None
        when neither exists (tracing off)."""
        parent = next((req.span for req in g.requests
                       if req.span is not None), None)
        if parent is not None:
            sp = parent.child("ec batch dispatch")
        elif self.tracer is not None:
            sp = self.tracer.new_trace("ec batch dispatch")
        else:
            return None
        return (sp.tag("lane", g.kind)
                  .tag("group_size", len(g.requests))
                  .tag("bytes", g.pending_bytes))

    # -- circuit breaker (device-dispatch watchdog) ------------------------

    def _breaker(self, kind: str) -> _LaneBreaker:
        br = self._breakers.get(kind)
        if br is None:
            br = self._breakers[kind] = _LaneBreaker()
        return br

    def open_lanes(self) -> List[str]:
        """Lane names whose breaker is currently OPEN (their groups fail
        with -EIO): the BREAKER_OPEN health check's feed."""
        with self._breaker_lock:
            return [k for k, b in self._breakers.items()
                    if b.state == _LaneBreaker.OPEN]

    def _gauge_open_lanes_locked(self) -> None:
        self.perf.set("breaker_open_lanes",
                      sum(1 for b in self._breakers.values()
                          if b.state == _LaneBreaker.OPEN))

    def _breaker_refuses(self, kind: str) -> bool:
        """True = fail this group (breaker open); False = dispatch it to
        the device (closed, or the half-open probe)."""
        with self._breaker_lock:
            br = self._breakers.get(kind)
            if br is None or br.state != _LaneBreaker.OPEN:
                return False
            if time.monotonic() >= br.open_until and not br.probing:
                br.probing = True  # half-open: ONE group probes the device
                self.perf.inc("breaker_probe")
                return False
            return True

    def _breaker_failure(self, kind: str) -> None:
        with self._breaker_lock:
            br = self._breaker(kind)
            br.cooldown = (min(br.cooldown * 2, self.breaker_cooldown_max)
                           if br.cooldown else self.breaker_cooldown)
            br.state = _LaneBreaker.OPEN
            br.open_until = time.monotonic() + br.cooldown
            br.probing = False
            self.perf.inc("breaker_trip")
            self._gauge_open_lanes_locked()

    def _breaker_success(self, kind: str) -> None:
        with self._breaker_lock:
            br = self._breakers.get(kind)
            if br is None or br.state == _LaneBreaker.CLOSED:
                return
            if not br.probing:
                # a straggler from before the trip completing fine is no
                # evidence about the lane's current health
                return
            br.state = _LaneBreaker.CLOSED
            br.cooldown = 0.0
            br.probing = False
            self.perf.inc("breaker_recover")
            self._gauge_open_lanes_locked()

    def _fail_group(self, g: _Group, cause: BaseException,
                    wait_s: float = 0.0) -> None:
        """Fail every pending future of the group with
        ErasureCodeError(-EIO) naming the lane, the device and the cause."""
        err = ErasureCodeError(
            -errno.EIO, f"ec_cuda lane {g.kind} on {self.device} failed: "
            f"{type(cause).__name__}: {cause}")
        err.__cause__ = cause
        failed = 0
        for req in g.requests:
            try:
                req.future.set_exception(err)
                failed += 1
            except InvalidStateError:
                pass  # resolved, or cancelled by its submitter
        if failed:
            self.timeline.append({
                "ts": time.time(), "lane": g.kind,
                "group_size": len(g.requests), "bytes": g.pending_bytes,
                "queue_wait_s": round(wait_s, 6), "device_s": 0.0,
                "error": f"{type(cause).__name__}: {cause}"})

    # -- launch and completion ---------------------------------------------

    def _on_device(self):
        """The queue's device and compute stream as current (CUDA), for
        whatever thread launches, and each other card of a mesh's compute
        stream as current on that card."""
        if self._compute is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        for stream in self._shard_streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        stack.enter_context(torch.cuda.stream(self._compute))
        return stack

    def _launch_safe(self, groups: List[_Group]) -> list:
        launched = []
        for g in groups:
            if not g.requests:
                continue
            try:
                lc = self._launch_group(g)
            except Exception as e:
                self._fail_group(g, e)
                continue
            if lc is not None:
                launched.append(lc)
        if launched and self._launch_hook is not None:
            self._launch_hook()
        return launched

    def _launch_group(self, g: _Group) -> Optional[_Launched]:
        now = time.monotonic()
        # queue-wait: how long each request coalesced before launch
        wait_s = 0.0
        for req in g.requests:
            w = now - req.t_submit
            self.perf.tinc("queue_wait", w)
            wait_s += w
            if req.span is not None:
                req.span.event(f"ec coalesced lane={g.kind} "
                               f"group={len(g.requests)}")
        wait_s /= len(g.requests)
        if self._breaker_refuses(g.kind):
            self._fail_group(g, RuntimeError(
                "lane breaker open after a dispatch failure"), wait_s)
            return None
        sp = self._dispatch_span(g)
        if self.inject_dispatch_delay:
            # counted into the dispatch's elapsed time (t_launch = now), so
            # the watchdog sees the slow dispatch
            time.sleep(self.inject_dispatch_delay)
        try:
            with self._on_device():
                state = getattr(self, f"_launch_{g.kind}")(g)
                done = None
                if self._compute is not None:
                    done = torch.cuda.Event()
                    done.record(self._compute)
        except Exception as e:
            if sp is not None:
                sp.event(f"launch failed: {type(e).__name__}")
                sp.finish()
            self._breaker_failure(g.kind)
            self._fail_group(g, e, wait_s)
            return None
        if sp is not None:
            sp.event("launched")
        return _Launched(g, state, now, sp, wait_s, done)

    def _complete_safe(self, launched: list) -> None:
        for lc in launched:
            g = lc.group
            try:
                if lc.done is not None:
                    lc.done.synchronize()  # kernel and copies finished
                device_s = time.monotonic() - lc.t_launch
                # counted before the fan-out resolves the group's futures,
                # so that whoever reads the counters or the timeline once
                # its op is done sees that op (the reference counts after)
                self.perf.tinc("dispatch_dev", device_s)
                self.perf.hinc("group_size", len(g.requests))
                self.timeline.append({
                    "ts": time.time(), "lane": g.kind,
                    "group_size": len(g.requests),
                    "bytes": g.pending_bytes,
                    "queue_wait_s": round(lc.wait_s, 6),
                    "device_s": round(device_s, 6)})
                getattr(self, f"_complete_{g.kind}")(g, lc.state)
            except Exception as e:
                if lc.span is not None:
                    lc.span.event(f"complete failed: {type(e).__name__}")
                    lc.span.finish()
                self._breaker_failure(g.kind)
                self._fail_group(g, e, lc.wait_s)
                continue
            if self.dispatch_timeout and device_s > self.dispatch_timeout:
                # completed, but over the watchdog's budget: the lane is
                # sick, so trip until a probe proves it healthy
                self._breaker_failure(g.kind)
            else:
                self._breaker_success(g.kind)
            if lc.span is not None:
                lc.span.event("fan-out")
                lc.span.finish()
            for req in g.requests:
                if req.span is not None:
                    req.span.event(f"ec fan-out lane={g.kind}")

    def _dispatch(self, groups: List[_Group]) -> None:
        # synchronous drain (flush()/close()): launch then complete
        self._complete_safe(self._launch_safe(groups))

    def _note_dispatch(self, nbytes: int) -> None:
        """Dispatch-complete accounting shared by every lane.  On a mesh
        every dispatch is sharded: a shard that fails fails its group."""
        self.perf.inc("dispatch")
        if self.mesh is not None:
            self.perf.inc("sharded_dispatch")
        self.perf.inc("bytes", nbytes)

    @staticmethod
    def _resolve(req: _Request, value) -> None:
        # a submitter may have been cancelled while waiting (an async op
        # torn down mid-flight): its result is dropped
        try:
            req.future.set_result(value)
        except InvalidStateError:
            pass

    # -- staging (runs under _on_device) -----------------------------------

    def _mesh_width(self, cols: int, align: int) -> int:
        """A batch's width on the mesh: each shard a whole number of
        `align`-column units (the batch's own width without a mesh)."""
        if self.mesh is None:
            return cols
        return self.mesh.pad_cols(-(-cols // align)) * align

    def _stage(self, g: _Group, align: int = 1):
        """Coalesce a group's packed uint8 requests column-wise into one
        [n, sum(B)] batch on the device (zero columns after them up to the
        mesh's width): on CUDA through a pinned buffer and a non-blocking
        copy on the copy-in stream, which the compute stream waits for.
        Returns (widths, batch, nbytes); nbytes counts the requests' bytes,
        not the pad."""
        widths = [req.regions.shape[1] for req in g.requests]
        rows, cols = g.requests[0].regions.shape[0], sum(widths)
        nbytes = rows * cols
        padded = self._mesh_width(cols, align)
        if self._compute is None:
            regions = [np.asarray(req.regions, dtype=np.uint8)
                       for req in g.requests]
            if padded > cols:
                regions.append(np.zeros((rows, padded - cols), np.uint8))
            batch = (np.concatenate(regions, axis=1) if len(regions) > 1
                     else np.ascontiguousarray(regions[0]))
            return widths, torch.from_numpy(batch), nbytes
        host = torch.empty((rows, padded), dtype=torch.uint8, pin_memory=True)
        view = host.numpy()
        off = 0
        for width, req in zip(widths, g.requests):
            view[:, off:off + width] = req.regions
            off += width
        view[:, off:] = 0
        with torch.cuda.stream(self._copy_in):
            batch = torch.empty((rows, padded), dtype=torch.uint8,
                                device=self.device)
            batch.copy_(host, non_blocking=True)
            staged = torch.cuda.Event()
            staged.record(self._copy_in)
        batch.record_stream(self._compute)
        self._compute.wait_event(staged)
        return widths, batch, nbytes

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        """A uint8 device result as a numpy array the fan-out may read once
        the round's `done` event has completed: on CUDA a view of a pinned
        buffer filled by a non-blocking copy on the compute stream."""
        if self._compute is None:
            return out.numpy()
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host.numpy()

    def _device_batch(self, g: _Group) -> torch.Tensor:
        """A plane group's requests, on the device, concatenated
        column-wise on the compute stream after each submitter's writes."""
        parts = []
        for req in g.requests:
            x = req.regions
            if not isinstance(x, torch.Tensor):
                a = np.ascontiguousarray(x)
                x = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                     else a)
            if x.device != self.device:
                x = x.to(self.device)
            if req.ready is not None:
                self._compute.wait_event(req.ready)
            if x.is_cuda:
                x.record_stream(self._compute)
            parts.append(x)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _device_mbits(self, mbits: np.ndarray,
                      device: Optional[torch.device] = None) -> torch.Tensor:
        """The int8 bit-matrix on `device` (the queue's by default: a shard
        reads the copy on its own), cached by device and content (64)."""
        device = self.device if device is None else device
        key = (device, mbits.shape,
               np.ascontiguousarray(mbits, dtype=np.int8).tobytes())
        with self._mats_lock:
            t = self._mats.get(key)
            if t is not None:
                self._mats.move_to_end(key)
                return t
        t = bitmatrix_to_tensor(mbits, device)
        with self._mats_lock:
            self._mats[key] = t
            while len(self._mats) > 64:
                self._mats.popitem(last=False)
        return t

    def _hand_over(self, g: _Group, out: torch.Tensor) -> None:
        """Device results go to callers on their own streams: record each
        submitter's stream on the result's memory, so that freeing it there
        waits for that stream's work before the memory is reused."""
        if self._compute is None:
            return
        seen = set()
        for req in g.requests:
            s = req.stream
            if s is not None and s.cuda_stream not in seen:
                seen.add(s.cuda_stream)
                out.record_stream(s)

    def _gathered(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Shard products concatenated in column order on the queue's
        device."""
        return torch.cat([p if p.device == self.device
                          else p.to(self.device, non_blocking=True)
                          for p in parts], dim=-1)

    def _on_shards(self, batch: torch.Tensor, fn):
        """fn(batch) on the queue's device; on a mesh, fn of each shard on
        the shard's device (the batch's columns zero-padded to a multiple
        of the mesh's size first, unless _stage padded them), and each
        product (fn returns a tensor or a tuple of them) gathered in column
        order onto the queue's device."""
        if self.mesh is None:
            return fn(batch)
        cols = batch.shape[-1]
        width = self._mesh_width(cols, 1)
        if width != cols:
            padded = batch.new_zeros((*batch.shape[:-1], width))
            padded[..., :cols] = batch
            batch = padded
        outs = []
        for part, _bounds in self.mesh.shard_batch(batch):
            with (torch.cuda.device(part.device) if part.is_cuda
                  else contextlib.nullcontext()):
                outs.append(fn(part))
        if isinstance(outs[0], tuple):
            return tuple(self._gathered([o[i] for o in outs])
                         for i in range(len(outs[0])))
        return self._gathered(outs)

    # -- lanes ---------------------------------------------------------------

    def _launch_packed(self, g: _Group):
        # a shard holds whole symbols: w=16 takes byte pairs
        widths, batch, nbytes = self._stage(g, max(1, g.w // 8))
        out = self._on_shards(batch, lambda x: gf2_apply_bytes(
            self._device_mbits(g.mbits, x.device), x, g.w, g.out_rows))
        return widths, self._to_host(out), nbytes

    def _complete_packed(self, g: _Group, state) -> None:
        widths, out, nbytes = state
        self._note_dispatch(nbytes)
        off = 0
        for width, req in zip(widths, g.requests):
            # a copy: the pinned buffer is reused, and a view would pin the
            # whole batch for as long as one result lives
            self._resolve(req, out[:, off:off + width].copy())
            off += width

    def _launch_planar(self, g: _Group):
        """Matmul-only dispatch over int8 planes on the device; results
        stay there as planes."""
        widths = [req.regions.shape[1] for req in g.requests]
        out = self._on_shards(self._device_batch(g), lambda x: gf2_matmul(
            self._device_mbits(g.mbits, x.device), x))
        return widths, out

    def _complete_planar(self, g: _Group, state) -> None:
        widths, out = state
        self._note_dispatch(sum(widths) * g.mbits.shape[1] // 8)
        self._hand_over(g, out)
        off = 0
        for width, req in zip(widths, g.requests):
            self._resolve(req, out[:, off:off + width])
            off += width

    def _launch_resident(self, g: _Group):
        """Residency write path: one call (unpack, matmul, parity pack),
        both products fanned out: packed parity for persistence, planes to
        stay on the device."""
        widths, batch, nbytes = self._stage(g, max(1, g.w // 8))
        packed, all_bits = self._on_shards(
            batch, lambda x: gf2_encode_resident(
                self._device_mbits(g.mbits, x.device), x, g.w, g.out_rows))
        # the batch's width after any mesh pad: planar columns per byte
        # column relate all_bits to the columns the product saw
        return (widths, self._to_host(packed), all_bits, nbytes,
                batch.shape[1])

    def _complete_resident(self, g: _Group, state) -> None:
        widths, packed, all_bits, nbytes, cols = state
        self._note_dispatch(nbytes)
        self._hand_over(g, all_bits)
        # planar columns per byte column depend on w (w=16: B/2, w=4: 2B)
        cfac = all_bits.shape[1] / cols
        off = 0
        for width, req in zip(widths, g.requests):
            c0, c1 = int(off * cfac), int((off + width) * cfac)
            self._resolve(req, (packed[:, off:off + width].copy(),
                                all_bits[:, c0:c1]))
            off += width

    def _launch_packedbit(self, g: _Group):
        """One K4 launch over the coalesced packed rows: bytes -> plane
        words -> XOR schedule -> bytes, the schedule from the LRU."""
        # whole 32-byte plane words a shard
        widths, batch, nbytes = self._stage(g, 32)
        out = self._on_shards(batch, lambda x: gf2_apply_packedbit(g.mbits, x))
        return widths, self._to_host(out), nbytes

    # the same packed-byte fan-out
    _complete_packedbit = _complete_packed

    def _launch_packedbit_resident(self, g: _Group):
        """Packed-bit residency write path: one K4 launch, both products
        fanned out (parity bytes, data and parity plane words).  Request
        widths are whole words (submit_packedbit_resident checks), so the
        word slices of the fan-out are exact."""
        # whole 32-byte plane words a shard, so the gathered words are the
        # unsharded batch's
        widths, batch, nbytes = self._stage(g, 32)
        packed, planes = self._on_shards(
            batch, lambda x: gf2_encode_packedbit_resident(g.mbits, x))
        return widths, self._to_host(packed), planes, nbytes

    def _complete_packedbit_resident(self, g: _Group, state) -> None:
        # every plane result is a slice of the one batched tensor: sibling
        # requests alias it, so no consumer may write into one in place
        widths, packed, planes, nbytes = state
        self._note_dispatch(nbytes)
        self._hand_over(g, planes)
        if len(g.requests) == 1 and packed.shape[1] == widths[0]:
            # one request and no pad: the whole product, no slice
            self._resolve(g.requests[0], (packed.copy(), planes))
            return
        off = 0
        for width, req in zip(widths, g.requests):
            self._resolve(req, (packed[:, off:off + width].copy(),
                                planes[:, off // 32:(off + width) // 32]))
            off += width

    def _launch_packedbit_planes(self, g: _Group):
        """Schedule-only dispatch over plane words on the device (one K3
        launch); results stay there as words."""
        widths = [req.regions.shape[1] for req in g.requests]  # words
        return widths, self._on_shards(self._device_batch(g),
                                       lambda x: gf2_xor_packed(g.mbits, x))

    def _complete_packedbit_planes(self, g: _Group, state) -> None:
        widths, out = state
        # plane words carry a bit a bit: C rows x words x 4 bytes
        self._note_dispatch(sum(widths) * 4 * g.mbits.shape[1])
        self._hand_over(g, out)
        off = 0
        for width, req in zip(widths, g.requests):
            self._resolve(req, out[:, off:off + width])
            off += width


class PlanarShardStore:
    """Device-resident planar shard cache: one tensor per resident.

    Copy of ceph_tpu/parallel/service.py:1194-1531 at commit 645aba9.  Rows
    of packed uint8 shard bytes are admitted ONCE (one conversion on the
    device) and then live there as packed-bit plane words (int32, w=8, K5)
    or int8 bit-planes (any w); every later EC op on them (decode, scrub
    re-encode, recovery) is a GF(2) product chaining device buffers (K3 on
    words, K2 on planes), and bytes are packed back exactly once, when they
    leave for the wire or the store (K6 on words).

    Capacity is a hard byte budget over the device footprint: the
    least-recently-used entries are evicted, so the store degrades to the
    packed path, never to an out-of-memory error.  Thread-safe.  The store
    runs on `device` (the card unless the caller names the CPU); with a
    `queue`, ``apply`` rides its plane lanes and coalesces across objects.
    """

    def __init__(self, capacity_bytes: int = 256 << 20,
                 queue: Optional[BatchingQueue] = None,
                 device: DeviceLike = None):
        self.capacity_bytes = capacity_bytes
        self.queue = queue
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._bytes: Dict[Any, int] = {}
        self._trim: Dict[Any, int] = {}  # packedbit admits: true width
        # exit-boundary memo: key -> (version, packed host result).  Lives
        # and dies WITH the entry, so a memo can never outlive or contradict
        # its resident; host memory, capped at capacity_bytes
        self._memo: Dict[Any, Tuple[Any, Any]] = {}
        self.memo_bytes = 0
        self.resident_bytes = 0
        self.admits = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.perf = (
            PerfCountersBuilder("planar_store")
            .add_u64_counter("admit", "packed rows admitted (one unpack)")
            .add_u64_counter("hit", "resident lookups served")
            .add_u64_counter("miss", "lookups that fell to the packed path")
            .add_u64_counter("evict", "LRU evictions under the byte budget")
            .add_u64("resident_bytes", "planar device footprint (gauge)")
            .add_u64("entries", "resident objects (gauge)")
            .add_u64("memo_bytes",
                     "exit-boundary packed memo host footprint (gauge)")
            .add_time_avg("pack_s",
                          "device->host pack seconds at the exit boundary")
            .add_time_avg("unpack_s",
                          "host->device unpack seconds at admission")
            .create_perf_counters())
        self.perf.resync = self._resync_gauges

    def _resync_gauges(self) -> None:
        # gauges are written under the store lock everywhere: an unlocked
        # write could overwrite a newer value with a stale one
        with self._lock:
            self.perf.set("resident_bytes", self.resident_bytes)
            self.perf.set("entries", len(self._entries))
            self.perf.set("memo_bytes", self.memo_bytes)

    # -- host boundary (conversions paid here, once) -------------------------

    def admit(self, key: Any, rows: np.ndarray, w: int = 8,
              meta: Any = None, layout: str = "planes") -> torch.Tensor:
        """Convert packed [n, B] uint8 rows on the device and keep them
        resident under `key`; returns the resident tensor.  layout="planes"
        stores int8 bit-planes (any w); "packedbit" stores int32 plane words
        (w=8 only, 1/8th the footprint), trimmed back to B on read."""
        with self.perf.time_avg("unpack_s"):
            data = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
            if layout == "packedbit":
                if w != 8:
                    raise ValueError("packed-bit residency is the w=8 byte "
                                     f"layout, got w={w}")
                bits = to_packedbit(data)
                self.put_planar(key, bits, w=w, n_rows=rows.shape[0],
                                meta=meta, trim=rows.shape[1])
            else:
                bits = to_planar(data, w)
                self.put_planar(key, bits, w=w, n_rows=rows.shape[0],
                                meta=meta)
        self.admits += 1
        self.perf.inc("admit")
        return bits

    def read(self, key: Any) -> Optional[np.ndarray]:
        """The resident rows packed back to [n, B] uint8 host bytes: the
        EXIT boundary.  None when not resident.  The dtype tells the layouts
        apart (int32 words, int8 planes)."""
        got = self.get_planar(key)
        if got is None:
            return None
        bits, w, n_rows, _meta = got
        with self.perf.time_avg("pack_s"):
            if bits.dtype == torch.int32:
                out = from_packedbit(bits, n_rows)
                with self._lock:
                    trim = self._trim.get(key)
                if trim is not None:
                    out = out[:, :trim]
            else:
                out = from_planar(bits, w, n_rows)
            return out.cpu().numpy()

    # -- resident side (no conversion anywhere below) ------------------------

    def put_planar(self, key: Any, bits: torch.Tensor, w: int = 8,
                   n_rows: Optional[int] = None, meta: Any = None,
                   trim: Optional[int] = None) -> None:
        """`meta` is caller state carried with the entry (the OSD stores
        the object version there, so a read can reject a stale resident).
        `trim` is the true byte width of a packed-bit admit, installed under
        the same lock as the entry."""
        if n_rows is None:
            n_rows = bits.shape[0] // w
        nbytes = bits.numel() * bits.element_size()
        with self._lock:
            if key in self._entries:
                self.resident_bytes -= self._bytes[key]
            self._entries[key] = (bits, w, n_rows, meta)
            self._entries.move_to_end(key)
            self._bytes[key] = nbytes
            self._memo_discard(key)  # new rows: the stale memo dies
            if trim is None:
                self._trim.pop(key, None)  # a re-put resets the trim
            else:
                self._trim[key] = trim
            self.resident_bytes += nbytes
            evicted = 0
            while self.resident_bytes > self.capacity_bytes and self._entries:
                old_key, _ = self._entries.popitem(last=False)
                self.resident_bytes -= self._bytes.pop(old_key)
                self._trim.pop(old_key, None)
                self._memo_discard(old_key)
                self.evictions += 1
                evicted += 1
            self.perf.set("resident_bytes", self.resident_bytes)
            self.perf.set("entries", len(self._entries))
        if evicted:
            self.perf.inc("evict", evicted)

    def get_planar(self, key: Any):
        """(bits, w, n_rows, meta) or None; refreshes LRU position."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        self.perf.inc("hit" if ent is not None else "miss")
        return ent

    # -- the residency protocol shared with PagedResidentStore ---------------
    # (ceph_tpu_torch/rados/pagestore.py): ecutil's planar_* helpers speak
    # these shapes, so either store can sit behind the cache tier.

    def touch(self, key: Any):
        """(w, n_rows, meta) with LRU refresh and hit/miss counting."""
        ent = self.get_planar(key)
        return None if ent is None else (ent[1], ent[2], ent[3])

    def entry_info(self, key: Any):
        """(w, n_rows, meta) without LRU or counter side effects."""
        with self._lock:
            ent = self._entries.get(key)
        return None if ent is None else (ent[1], ent[2], ent[3])

    def resident_meta(self, key: Any):
        """The entry's caller meta, or None: the policy probe shape."""
        info = self.entry_info(key)
        return None if info is None else info[2]

    def gather_rows(self, key: Any, r0: int, r1: int):
        """The resident's bit-rows [r0, r1) (a view of its tensor), or
        None.  No LRU side effects."""
        with self._lock:
            ent = self._entries.get(key)
        if ent is None or r1 > ent[0].shape[0]:
            return None
        return ent[0][r0:r1]

    def apply(self, key: Any, mbits: np.ndarray, out_rows: int,
              out_key: Any = None) -> Optional[torch.Tensor]:
        """Apply a bit-matrix to the resident rows (encode with a generator,
        reconstruct with an inverted signature matrix, scrub re-encode):
        the XOR schedule (K3) on plane words, gf2_matmul (K2) on int8
        planes.  The result stays on the device, stored under `out_key`
        when given.  None when `key` is not resident.  Routes through the
        batching queue when one is attached (cross-object coalescing)."""
        got = self.get_planar(key)
        if got is None:
            return None
        bits, w, _, _meta = got
        if bits.dtype == torch.int32:
            mb = np.asarray(mbits, dtype=np.uint8)
            if self.queue is not None:
                out = self.queue.submit_packedbit_planes(
                    mb, bits, w, out_rows).result()
            else:
                out = gf2_xor_packed(mb, bits)
        elif self.queue is not None:
            out = self.queue.submit_planar(
                np.asarray(mbits), bits, w, out_rows).result()
        else:
            out = gf2_matmul(bitmatrix_to_tensor(mbits, self.device), bits)
        if out_key is not None:
            self.put_planar(out_key, out, w=w, n_rows=out_rows)
        return out

    def drop(self, key: Any, force: bool = False) -> bool:
        """Remove `key` if resident; True when an entry was dropped.
        Dropping an absent key is a supported no-op.  ``force`` is the
        paged store's dirty override, a no-op here, where nothing is ever
        dirty; taken so that callers speak one surface."""
        with self._lock:
            dropped = key in self._entries
            if dropped:
                del self._entries[key]
                self.resident_bytes -= self._bytes.pop(key)
                self._trim.pop(key, None)
            self._memo_discard(key)
            self.perf.set("resident_bytes", self.resident_bytes)
            self.perf.set("entries", len(self._entries))
        return dropped

    def peek(self, key: Any):
        """(bits, w, n_rows, meta) or None without touching LRU order or
        the hit/miss counters."""
        with self._lock:
            return self._entries.get(key)

    def entries_snapshot(self) -> List[Tuple[Any, int]]:
        """(key, device nbytes) pairs in LRU order, oldest first: the tier
        agent's eviction-candidate input."""
        with self._lock:
            return [(k, self._bytes[k]) for k in self._entries]

    def _memo_discard(self, key: Any) -> None:
        """Drop a key's memo and its byte accounting (lock held)."""
        got = self._memo.pop(key, None)
        if got is not None:
            self.memo_bytes -= len(got[1])

    def memo_get(self, key: Any, version: Any):
        """The exit-boundary memo for `key` at `version`, or None; only
        while the entry is resident."""
        with self._lock:
            if key not in self._entries:
                return None
            got = self._memo.get(key)
        if got is None or got[0] != version:
            return None
        return got[1]

    def memo_put(self, key: Any, version: Any, value: Any) -> None:
        """Record the packed host result of this resident at `version`, so
        that later resident hits skip the device pack.  Ignored when the
        entry is not resident or the memo is at its budget
        (capacity_bytes)."""
        nbytes = len(value)
        with self._lock:
            if key not in self._entries:
                return
            self._memo_discard(key)
            if self.memo_bytes + nbytes > self.capacity_bytes:
                self.perf.set("memo_bytes", self.memo_bytes)
                return
            self._memo[key] = (version, value)
            self.memo_bytes += nbytes
            self.perf.set("memo_bytes", self.memo_bytes)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> Dict[str, int]:
        return {"resident_bytes": self.resident_bytes,
                "memo_bytes": self.memo_bytes,
                "entries": len(self._entries), "admits": self.admits,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
