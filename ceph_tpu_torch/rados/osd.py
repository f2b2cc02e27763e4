# Copy of ceph_tpu/rados/osd.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.  The seams onto the device
# differ: the daemon's device is ``osd_ec_device`` (the card unless the
# conf names the CPU), which its codecs, the shared queue and the resident
# store run on; the perf sets are the port's (``ec_cuda``, the cuda plugin's
# ``ec_plugin``); and what it reads from the wire unpickles through
# rados/unpickle.py.
"""OSD daemon: the EC data plane.

Role-equivalent of the reference's OSD + ECBackend (reference
src/osd/OSD.cc, src/osd/ECBackend.cc): boots against the mon, heartbeats,
and for PGs where it is primary drives the EC pipeline in the reference's
order — submit -> write plan -> encode -> per-shard fan-out -> commit
gather -> client ack (ECBackend.cc:1525 -> 1889 -> 1989 -> 2159) — with the
TPU twist that encode/decode ride the pool codec's device dispatch (and the
codec's batching, plugin=tpu).  Degraded reads reconstruct transparently
(objects_read_and_reconstruct, ECBackend.cc:2401); recovery re-creates
missing shards on the current acting set and pushes them (RecoveryOp
IDLE->READING->WRITING, ECBackend.cc:590-745).

Client and sub-ops ride a sharded op queue (op_shardedwq, OSD.h:1590) with
a pluggable WPQ/mClock scheduler (osd_op_queue); PG id pins an op to a
shard so per-PG ordering holds.  Liveness is two-tier like the reference:
OSD<->OSD heartbeats (OSD::heartbeat OSD.cc:5837, handle_osd_ping :5417)
produce MOSDFailure reports to the mon when a peer misses its grace, and
the mon's own laggard scan is the fallback.  Per-daemon observability:
perf counters, TrackedOp timelines, and an optional admin socket
(`status`, `perf dump`, `dump_ops_in_flight`).

Write path bookkeeping matches the reference's shape: every mutation
appends a PG log entry (src/osd/PGLog.cc) on each acting shard in the same
store transaction as the data; client resends dedupe against the log's
reqid set; recovery is two-phase — log-driven delta recovery for peers
whose logs overlap, backfill scan otherwise.  Partial overwrites take the
read-modify-write path with a primary-side extent cache
(try_state_to_reads + ExtentCache roles); deep scrub recomputes shard crcs
against stored meta and repairs mismatches (be_deep_scrub).
"""

from __future__ import annotations

import asyncio
import contextlib
import errno
import json
import os
import pickle
import random
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import registry
from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
from ceph_tpu_torch.rados.extent_cache import ExtentCache
from ceph_tpu_torch.utils.checksum import verify_any as crc_verify_any
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device
from ceph_tpu_torch.rados.ecutil import (HashInfo, StripeInfo,
                                   batched_encode_async,
                                   batched_encode_group_async,
                                   decode_object_async,
                                   planar_eligible, planar_encode_async,
                                   planar_object_bytes, planar_rows,
                                   planar_shard_bytes)
from ceph_tpu_torch.rados.clog import (LogClient, build_crash_report,
                                 replay_crash_spool, spool_crash)
from ceph_tpu_torch.rados.messenger import (TRANSPORT_ERRORS, BufferList,
                                      Messenger, as_bytes)
from ceph_tpu_torch.rados import unpickle
from ceph_tpu_torch.rados.monclient import MonTargets
from ceph_tpu_torch.rados.peering import (
    ACTIVE,
    BACKFILLING,
    CLEAN,
    GET_INFO,
    GET_LOG,
    GET_MISSING,
    RECOVERING,
    WAIT_LOCAL_RESERVE,
    WAIT_REMOTE_RESERVE,
    PGMachine,
    ReservationSlots,
)
from ceph_tpu_torch.rados.pagestore import CacheDirtyRecord
from ceph_tpu_torch.rados.pglog import ZERO, LogEntry, PGLog, pack_eversion
from ceph_tpu_torch.rados.qos import (QosParams, QosTracker, build_scheduler_perf,
                                pool_qos, primary_spread, qos_op_cost,
                                tenant_class)
from ceph_tpu_torch.rados.scheduler import (
    CLASS_BEST_EFFORT,
    CLASS_CLIENT,
    CLASS_FLUSH,
    CLASS_REBALANCE,
    CLASS_RECOVERY,
    CLASS_SCRUB,
    ShardedOpQueue,
)
from ceph_tpu_torch.rados.store import (ENOSPCError, MemStore, ObjectStore,
                                  ShardMeta, Transaction, shard_crc,
                                  Owned as StoreOwned)
from ceph_tpu_torch.rados.tiering import (HitSetArchive, PromoteThrottle,
                                    build_tier_perf, eviction_candidates)
from ceph_tpu_torch.rados.auth import TicketKeyring
from ceph_tpu_torch.rados.types import (
    MAuthRotating,
    MAuthRotatingReply,
    MAuthTicket,
    MAuthTicketReply,
    MBackfillReserve,
    MBackfillReserveReply,
    MCacheDirty,
    MCacheDirtyAck,
    MCommand,
    MCommandReply,
    MCrashReportAck,
    MECSubRollback,
    MBootReply,
    MGetMap,
    MLogAck,
    MECSubDelete,
    MECSubRead,
    MECSubReadReply,
    MECSubWrite,
    MECSubWriteReply,
    MFetchShards,
    MFetchShardsReply,
    MListShards,
    MListShardsReply,
    MMapReply,
    MOSDFailure,
    MOSDOp,
    MOSDOpReply,
    MOSDBackoff,
    MOSDPGHitSet,
    MOSDPGTemp,
    MOSDPing,
    MOsdBoot,
    MPGInfoReply,
    MPGInfoReq,
    MPGLogReply,
    MPGLogReq,
    MPing,
    FULL_SEVERITY,
    is_delete_only_multi,
    is_read_only_multi,
    MPushShard,
    MNotifyAck,
    MScrubShard,
    MScrubShardReply,
    MSetOmap,
    MSetXattrs,
    MWatchNotify,
    OSDMap,
    PoolInfo,
    osd_crush_weight,
    ALL_NSPACES,
    is_snap_clone,
    snap_clone_oid,
    snap_head,
    split_ns,
)


def _ns_match(oid: str, nspace: str) -> bool:
    """Listing namespace filter (reference pgnls oloc nspace): "" means
    the DEFAULT namespace only; the ALL_NSPACES sentinel matches
    everything."""
    return nspace == ALL_NSPACES or split_ns(oid)[0] == nspace


PGMETA_PREFIX = "__pgmeta_"  # per-PG metadata object carrying the PG log

# rollback slot: each shard keeps its PREVIOUS version at shard+PREV_SLOT
# (the reference retains old extents as rollback info in the EC
# transaction, ECBackend rollback_append/ECTransaction) so a failed
# overwrite that lands on some shards cannot destroy the last complete
# version of the object
PREV_SLOT = 1 << 20

# ONE stripe-batching queue per process, shared by every OSD instance in
# it: the device is a process-level resource, and cross-daemon coalescing
# (a vstart cluster runs many OSDs in one process) only helps — more
# concurrent stripes per dispatch.  Lazy: processes that never touch an
# EC pool never start the worker thread.
_BATCH_QUEUE = None
_BATCH_QUEUE_LOCK = threading.Lock()


def _same_device(have: torch.device, want: torch.device, what: str) -> None:
    """The first creator of a process-shared resource decides its device;
    a later daemon asking for another one is a misconfiguration."""
    if have != want:
        raise RuntimeError(f"the process {what} runs on {have}; a daemon "
                           f"asked for {want} (osd_ec_device)")


def shared_batching_queue(device: DeviceLike = None):
    """The process queue on `device` (``osd_ec_device``: the card unless
    the caller names the CPU), or None when batching would lose: on a
    daemon told to use the CPU the codecs' numpy table paths beat a trip
    through the queue, so it engages there only under
    CEPH_TPU_FORCE_BATCH=1 (tests exercising coalescing on the CPU; perf
    experiments), as the reference's does on a CPU backend.  The CPU is
    never chosen because CUDA is missing: asking for the card on a host
    without one raises."""
    global _BATCH_QUEUE
    dev = resolve_device(device)
    if dev.type == "cpu" and os.environ.get("CEPH_TPU_FORCE_BATCH") != "1":
        return None
    with _BATCH_QUEUE_LOCK:
        if _BATCH_QUEUE is None:
            from ceph_tpu_torch.parallel.service import BatchingQueue

            _BATCH_QUEUE = BatchingQueue(device=dev)
        _same_device(_BATCH_QUEUE.device, dev, "batching queue")
        return _BATCH_QUEUE


_PLANAR_STORE = None


def shared_planar_store(capacity_bytes: int = 0, page_bytes: int = 0,
                        paged: Optional[bool] = None,
                        device_arm: Optional[bool] = None,
                        device: DeviceLike = None):
    """The process-wide resident store behind the cache tier.  Engages
    under the same conditions as the batching queue, on the same device;
    None otherwise.  All in-process OSDs share one device budget; keys are
    namespaced per OSD.

    Two flavors behind one surface (the residency protocol:
    put_planar/touch/gather_rows/drop/memo): the PAGED store
    (ceph_tpu_torch/rados/pagestore.py — page table, ragged tails, per-page
    dirty bits; the default, and the only flavor that can run
    writeback) and the monolithic PlanarShardStore
    (osd_tier_pagestore=false or CEPH_TPU_PAGESTORE=0 — the bench A/B
    arm).  The FIRST creator decides the flavor and the device for the
    process; later callers only ever raise the shared byte budget, and
    one asking for another device raises.

    ``device_arm`` picks the paged store's arm (the reference's ``device``
    flag, ``osd_tier_device_slab``): None = the device arm iff the store's
    device is the card, False = the pinned host arm;
    CEPH_TPU_DEVICE_SLAB=1/0 overrides either way inside the store."""
    global _PLANAR_STORE
    queue = shared_batching_queue(device)
    if queue is None:
        return None
    with _BATCH_QUEUE_LOCK:
        if _PLANAR_STORE is None:
            use_paged = True if paged is None else bool(paged)
            if os.environ.get("CEPH_TPU_PAGESTORE", "") == "0":
                use_paged = False
            if use_paged:
                from ceph_tpu_torch.rados.pagestore import PagedResidentStore

                _PLANAR_STORE = PagedResidentStore(
                    capacity_bytes=capacity_bytes or (256 << 20),
                    page_bytes=page_bytes or (64 << 10), queue=queue,
                    device=queue.device, device_arm=device_arm)
            else:
                from ceph_tpu_torch.parallel.service import PlanarShardStore

                _PLANAR_STORE = PlanarShardStore(
                    capacity_bytes=capacity_bytes or (256 << 20),
                    queue=queue, device=queue.device)
        else:
            _same_device(_PLANAR_STORE.device, queue.device, "resident store")
            if capacity_bytes and capacity_bytes > _PLANAR_STORE.capacity_bytes:
                # the budget is one shared device pool: any daemon asking
                # for more raises it (first-wins would silently drop the knob)
                _PLANAR_STORE.capacity_bytes = capacity_bytes
        return _PLANAR_STORE


class OSD:
    def __init__(
        self,
        mon_addr: Tuple[str, int],
        store: Optional[ObjectStore] = None,
        conf: Optional[dict] = None,
        osd_id: int = -1,
    ):
        self.conf = conf or {}
        # one mon addr or a monmap list; RPCs rotate on mon failure
        self.mons = MonTargets(mon_addr)
        self.store = store or MemStore()
        self.osd_id = osd_id
        self.messenger = Messenger(f"osd.{osd_id}", self.conf, entity_type="osd")
        self.osdmap: Optional[OSDMap] = None
        self._codecs: Dict[int, object] = {}
        self._sinfos: Dict[int, StripeInfo] = {}
        self._pending: Dict[str, asyncio.Future] = {}
        self._collectors: Dict[str, asyncio.Queue] = {}
        self._ping_task: Optional[asyncio.Task] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._repair_task: Optional[asyncio.Task] = None
        # metadata-replication retry queue (per peer, FIFO — ordering
        # matters: an omap clear+set sequence applied out of order is a
        # different omap).  A transient send failure must NOT leave a
        # replica permanently stale: RGW bucket indexes and cls lock
        # state ride this path, and a failover primary would serve the
        # stale copy.
        self._meta_repl_pending: Dict[int, deque] = {}
        self._meta_repl_task: Optional[asyncio.Task] = None
        self.addr: Optional[Tuple[str, int]] = None
        self._stopped = False
        # observability (CephContext role): perf counters + op tracker;
        # the admin socket starts only when admin_socket_dir is configured
        self.ctx = Context(f"osd.{osd_id}",
                           conf if isinstance(conf, dict) else None)
        # the messenger's douts ride this daemon's log (debug_ms levels,
        # runtime-mutable via asok/`ceph tell` config set)
        self.messenger.log = self.ctx.log
        # cluster-log client (LogClient role): clog.info/warn/error land
        # in the mon's paxos-replicated cluster log; renamed + started
        # once the boot reply fixes our id
        self.clog = LogClient(self.messenger, self.mons, f"osd.{osd_id}",
                              self.conf, local_log=self.ctx.log)
        # crash telemetry: reports spool here when the mon is
        # unreachable (replayed at next boot); the dev inject flag makes
        # the next ping tick die — the crash-plane CI gate's trigger
        self._crash_dir = str(self.conf.get("crash_dir", "") or "")
        self._inject_crash = bool(
            self.conf.get("osd_debug_inject_crash", False))
        self._fatal_task: Optional[asyncio.Task] = None
        # stamp trace-id/parent-span context onto outbound data-plane
        # messages (cross-daemon stitching); decode always tolerates
        # absent fields, so this only gates the SENDING side
        self._trace_on = bool(self.conf.get("ms_trace_propagation", True))
        self.perf = self.ctx.perf.add(
            PerfCountersBuilder("osd")
            .add_u64_counter("op", "client ops")
            .add_u64_counter("op_w", "client writes")
            .add_u64_counter("op_r", "client reads")
            .add_time_avg("op_lat", "client op latency")
            .add_u64_counter("subop_w", "EC sub-writes applied")
            .add_u64_counter("subop_r", "EC sub-reads served")
            .add_u64_counter("pools_purged",
                             "deleted pools locally purged")
            .add_u64_counter("rmw_partial", "stripe-scoped partial overwrites")
            .add_u64_counter("rmw_extent_hits",
                             "RMW reads served from the extent cache")
            .add_u64_counter("planar_read_hits",
                             "reads served from planar HBM residents "
                             "with zero shard reads")
            .add_u64_counter("rmw_read_bytes", "bytes read for stripe RMW")
            .add_u64_counter("recovery_subchunk_bytes",
                             "helper bytes read by sub-chunk repair")
            .add_u64_counter("recovery_push", "recovery shards pushed")
            .add_u64_counter("stray_purged", "stray shards purged after backfill")
            .add_u64_counter("unfound_reverted",
                             "shards reverted to rollback slots (unfound)")
            .add_u64_counter("recovery_errors", "repair rounds that errored")
            .add_u64_counter("op_queued", "ops entering the sharded queue")
            .add_u64_counter("op_dequeued", "ops drained")
            .add_time_avg("op_queue_lat", "op service time")
            .add_u64_counter("heartbeat_failures", "peer failures reported")
            .add_u64_counter("backoffs_sent",
                             "MOSDBackoff blocks sent (op dropped, client "
                             "parks until release)")
            .add_u64_counter("backoffs_released",
                             "MOSDBackoff unblocks sent")
            .add_u64_counter("meta_repl_dropped",
                             "metadata replications dropped on queue "
                             "overflow (replica stale until scrub)")
            .add_u64_counter("op_unexpected_error",
                             "ops failed by an unclassified exception")
            .add_u64_counter("full_rejects",
                             "writes refused typed ENOSPC (FULL acting "
                             "member or local failsafe)")
            .add_u64_counter("backfill_toofull_refusals",
                             "backfill reservations refused because this "
                             "OSD is past its backfillfull ratio")
            .add_u64_counter("backfill_bytes_moved",
                             "shard bytes pushed by backfill/recovery "
                             "sweeps this OSD led")
            .add_u64_counter("rebalance_push",
                             "shards pushed by pure REBALANCE sweeps "
                             "(membership/weight change, no redundancy "
                             "loss)")
            .add_u64_counter("rebalance_bytes_moved",
                             "shard bytes moved by pure rebalance sweeps "
                             "(the bench arm's MB/s-moved numerator)")
            .add_u64_counter("scrub_errors_found",
                             "shard mismatches found by deep scrub "
                             "(crc/hinfo/absence)")
            .add_u64_counter("scrub_repaired",
                             "scrub-found shards repaired by re-encode "
                             "+ push")
            .add_u64("ec_batch_ops",
                     "requests submitted to the shared queue (gauge)")
            .add_u64("ec_batch_dispatches",
                     "device dispatches issued by the shared queue (gauge)")
            .add_u64("ec_batch_bytes",
                     "bytes pushed through the shared queue (gauge)")
            .create_perf_counters()
        )
        # the `osd_scheduler` set: per-class queue flow, the dmClock
        # serving split, and the QoS shed counter — one set per daemon
        # (the queue's shards share it), riding perf dump -> mgr /metrics
        self.sched_perf = self.ctx.perf.add(build_scheduler_perf())
        self.op_queue = ShardedOpQueue(
            int(self.conf.get("osd_op_num_shards", 4) or 4), self.conf,
            perf=self.perf, sched_perf=self.sched_perf)
        # OSD-level per-client admission tracker (qos.QosTracker): sees
        # every arriving client data op at FULL offered rate (per-shard
        # scheduler states each see ~1/n_shards), so the saturation shed
        # can name the most over-limit client
        self.qos = QosTracker(
            int(self.conf.get("osd_qos_max_clients", 4096) or 4096),
            arrears_cap=float(
                self.conf.get("osd_qos_arrears_cap", 2.0) or 2.0))
        # OSD<->OSD heartbeat state (two-tier failure detection);
        # _hb_reported maps peer -> last MOSDFailure stamp so reports
        # re-send while the peer stays silent (evidence at the mon expires)
        self._hb_last: Dict[int, float] = {}
        self._hb_reported: Dict[int, float] = {}
        # per-PG logs (src/osd/PGLog.cc role), lazily loaded from omap
        self._pglogs: Dict[Tuple[int, int], PGLog] = {}
        # reqids whose write failed min_size: a resend must RE-EXECUTE,
        # not be acked as a dup
        self._failed_writes: Set[str] = set()
        # class-call results by reqid (non-idempotent methods must not
        # re-execute on a resend); notify resends arriving while the first
        # execution is still gathering await its future
        self._call_results: Dict[str, MOSDOpReply] = {}
        self._notify_inflight: Dict[str, asyncio.Future] = {}
        # per-object critical sections for in-OSD class calls (the
        # ClassHandler PG-lock role; see _do_call): (pool, oid) ->
        # [lock, refcount] — refcounted so eviction can never orphan a
        # lock some waiter still holds a reference to
        self._cls_locks: Dict[Tuple[int, str], list] = {}
        # (pool, oid) -> {watcher addr} (reference Watch registry; watchers
        # re-register after a primary change, as librados clients do)
        self._watchers: Dict[Tuple[int, str], Set[Tuple[str, int]]] = {}
        # primary-side cache of decoded objects pinned across RMW rounds
        # (src/osd/ExtentCache.{h,cc} role)
        self._extent_cache = ExtentCache(max_objects=64)
        # acting set of the last DIFFERENT interval per PG: the set a
        # pg_temp request points the mon at when a remapped PG needs
        # backfill (the data lives with the prior interval's members)
        self._prior_acting: Dict[Tuple[int, int], List[int]] = {}
        # peering statecharts for PGs this OSD leads (reference
        # PeeringState machine per PG) + reservation throttles bounding
        # concurrent recovery (reference local/remote AsyncReserver,
        # osd_max_backfills) + per-PG membership history since the PG was
        # last clean (past_intervals role: the OSDs that may hold shards,
        # the scope set for deletes/hunts/backfill instead of O(cluster)
        # broadcasts)
        self._pg_machines: Dict[Tuple[int, int], PGMachine] = {}
        # default 4 (reference defaults to 1, but its recovery pipeline is
        # object-granular and overlaps with IO; our per-PG sweep is
        # coarser, so a 1-slot default starves replenishment under churn)
        max_backfills = int(self.conf.get("osd_max_backfills", 4) or 1)
        self._local_reserver = ReservationSlots(max_backfills)
        self._remote_reserver = ReservationSlots(max_backfills)
        self._past_members: Dict[Tuple[int, int], Set[int]] = {}
        # (oid, version) pairs observed partial-above-newest-complete in a
        # COMPLETE listing, per PG: confirmed again next pass => revert
        # (pool, pg) -> {(oid, version): first_seen_monotonic} for versions
        # newer than the newest complete one (unfound-revert grace clock)
        self._partial_newer: Dict[Tuple[int, int], Dict[Tuple[str, int], float]] = {}
        # (pool, pg) -> last self-scheduled deep-scrub time (monotonic);
        # the scrub scheduler picks the oldest-due PG each tick
        self._last_scrub: Dict[Tuple[int, int], float] = {}
        self._last_scrub_scan = 0.0
        self._scrub_task: Optional[asyncio.Task] = None
        # scrub-found inconsistency per PG this OSD leads: (pool, pg) ->
        # {"errors", "repaired", "stamp"} for the most recent scrub pass
        # that found mismatches.  Rides the MPing health field as
        # OSD_SCRUB_ERRORS / PG_INCONSISTENT; CLEARED when a later
        # scrub/repair pass of the PG verifies zero mismatches (repair
        # confirmed — the raise/clear lifecycle `ceph pg repair` drives).
        self._scrub_errors: Dict[Tuple[int, int], Dict[str, float]] = {}
        # (epoch, {pool_id: distinct primaries}) memo for the cross-OSD
        # QoS normalization divisor (qos.primary_spread): O(pg_num)
        # CRUSH work, recomputed only when the map moves
        self._spread_memo: Tuple[int, Dict[int, int]] = (-1, {})
        # active MOSDBackoff blocks this primary holds on clients:
        # (pool, pg) -> {"id": block id, "conns": {id(conn): conn}} —
        # released (unblock sent to every registered conn) when the PG's
        # peering pass reaches Active, or when we stop being primary
        self._backoffs_sent: Dict[Tuple[int, int], Dict] = {}
        # the process-wide stripe-batching queue (None = batching off):
        # every EC encode/decode this daemon issues is submitted here so
        # CONCURRENT ops coalesce into one device dispatch (SURVEY.md
        # §7.5; the reference's per-stripe ECUtil::encode loop inverted
        # at process scope)
        # the daemon's EC device (osd_ec_device): resolved here whatever
        # else is configured, so an OSD asked for the card on a host
        # without one fails at start instead of serving on the CPU
        self._ec_device = resolve_device(
            self.conf.get("osd_ec_device", "cuda"))
        self._ec_queue = (shared_batching_queue(self._ec_device)
                          if self.conf.get("osd_ec_batching", True) else None)
        if self._ec_queue is not None:
            # device-dispatch watchdog knobs (BatchingQueue circuit
            # breaker): a configured timeout/injected delay applies to
            # the PROCESS queue — last writer wins, matching the queue's
            # process-shared nature
            t = float(self.conf.get("osd_ec_dispatch_timeout", 0) or 0)
            if t:
                self._ec_queue.dispatch_timeout = t
            d = float(self.conf.get(
                "osd_debug_inject_dispatch_delay", 0) or 0)
            if d:
                self._ec_queue.inject_dispatch_delay = d
        # bit-planar HBM residency (VERDICT r03 #1): full-object EC
        # writes leave their shard rows planar-resident on the device, so
        # later decodes, repair re-encodes, and recovery packs are
        # matmul-only (or pack-only) instead of re-unpacking — the
        # pack/unpack boundary is paid once per resident lifetime
        self._planar = (
            shared_planar_store(
                int(self.conf.get("osd_ec_planar_bytes", 0) or 0),
                page_bytes=int(
                    self.conf.get("osd_tier_page_bytes", 64 << 10) or 0),
                paged=bool(self.conf.get("osd_tier_pagestore", True)),
                # None = auto (device arm iff the store is on the card);
                # an explicit false config pins the host arm.  The port's
                # store compiles nothing per geometry, so it has no
                # osd_tier_slab_prewarm option.
                device_arm=(None if self.conf.get("osd_tier_device_slab",
                                                  True) else False),
                device=self._ec_device)
            if self.conf.get("osd_ec_planar_residency", True) else None)
        # cache-tier policy state (ceph_tpu/rados/tiering.py): per-PG
        # bloom hit-set archives, the promotion rate throttle, and the
        # best-effort tier agent that makes HBM residency a POLICY —
        # hot objects are promoted into the planar store, cold residents
        # evicted coldest-temperature-first.  Hit recording runs even
        # without a device (temperatures are cheap and feed `tier
        # status`); promotion/eviction engage only when _planar exists.
        self._hit_sets: Dict[Tuple[int, int], HitSetArchive] = {}
        # per-PG epoch of the last ACCEPTED archive push (fencing:
        # cross-sender delivery has no wire ordering, see
        # _handle_pg_hit_set)
        self._hit_set_epochs: Dict[Tuple[int, int], int] = {}
        self._promote_throttle = PromoteThrottle(
            float(self.conf.get("osd_tier_promote_max_objects_sec", 32)
                  or 0),
            float(self.conf.get("osd_tier_promote_max_bytes_sec", 64 << 20)
                  or 0))
        self.tier_perf = self.ctx.perf.add(build_tier_perf())
        self._tier_agent_busy = False
        self._last_tier_scan = 0.0
        # promotions in flight, keyed by planar key: N hot reads racing
        # before the first install must fund ONE encode, not N
        self._promoting: Set[Tuple[int, int, str]] = set()
        # fast-ack raw destage single-flight: a key being flushed by
        # one plane (agent / fence / recovery replay) must not be
        # re-encoded concurrently by another
        self._raw_flush_inflight: Set[Tuple[int, int, str]] = set()
        # EC data-plane observability: ONE `perf dump` on this daemon
        # carries the whole pipeline breakdown — the messenger's `wire`
        # set (framing vs socket io), the shared queue's `ec_cuda` set
        # (per-lane submits/bytes, queue-wait/dispatch latencies, flush
        # causes), the gf2 `gf2_sched` schedule-cache set, the cuda
        # plugin's `ec_plugin` seam set (device dispatches and failures —
        # the non-queue path), and the resident store's `pagestore` or
        # `planar_store` set.  The queue/store/sched/plugin
        # sets are process-shared (as the resources are); every
        # colocated OSD dumps the same numbers.
        self.ctx.perf.add(self.messenger.perf)
        from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF
        from ceph_tpu_torch.ops.gf2 import SCHED_PERF

        self.ctx.perf.add(SCHED_PERF)
        self.ctx.perf.add(PLUGIN_PERF)
        if self._ec_queue is not None:
            self.ctx.perf.add(self._ec_queue.perf)
            if self._ec_queue.tracer is None:
                # dispatch spans with no submitter parent (repair/bench
                # traffic) root in this daemon's trace ring
                self._ec_queue.tracer = self.ctx.tracer
        if self._planar is not None:
            self.ctx.perf.add(self._planar.perf)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> int:
        self.messenger.dispatcher = self._dispatch
        self.messenger.group_dispatcher = self._dispatch_group
        self.addr = await self.messenger.bind()
        boot = MOsdBoot(osd_id=self.osd_id, addr=self.addr)
        # a no-quorum window answers boot with osd_id=-1: retry, don't run
        # as a ghost daemon the mon will never recognize
        for attempt in range(8):
            reply = await self._mon_rpc(boot, MBootReply)
            if reply.osd_id >= 0:
                break
            self.mons.rotate()
            await asyncio.sleep(0.25 * (attempt + 1))
        else:
            raise RuntimeError("mon refused boot (no quorum?)")
        self.osd_id = reply.osd_id
        self.messenger.name = f"osd.{self.osd_id}"
        # centralized config distributed at boot (ConfigMonitor role);
        # merged BEFORE the boot-time peering kick below so cluster-wide
        # settings (osd_auto_repair, repair delays) govern it
        cluster_conf = getattr(reply, "cluster_conf", None)
        if cluster_conf:
            if hasattr(self.conf, "set"):
                # per-key: one bad replicated value must not brick boot
                for k, v in cluster_conf.items():
                    try:
                        self.conf.set(k, v, source="mon")
                    except ValueError:
                        pass
            else:
                for k, v in cluster_conf.items():
                    self.conf.setdefault(k, v)
        if self.conf.get("auth_cephx", False):
            await self._refresh_auth()
            self.messenger.keyring_refresh = self._refresh_auth
        # through _on_map, NOT direct assignment: a freshly added OSD can
        # already be primary of remapped PGs (crush reshuffles on boot),
        # and those PGs need their peering kicked NOW — waiting for the
        # next epoch that happens to touch them leaves them driverless
        # while the old holders keep failing
        self._on_map(reply.osdmap)
        interval = self.conf.get("osd_heartbeat_interval", 0.3)
        loop = asyncio.get_running_loop()
        # the daemon loops run under the daemon crash guard: an
        # unexpected exception becomes a crash report + clog entry +
        # clean shutdown, not a silently dead task
        self._ping_task = loop.create_task(
            self._guarded(self._ping_loop, interval))
        self._hb_task = loop.create_task(
            self._guarded(self._heartbeat_loop, interval))
        self.op_queue.start()
        self.ctx.name = f"osd.{self.osd_id}"
        self.ctx.log.name = f"osd.{self.osd_id}"
        self.ctx.tracer.service = f"osd.{self.osd_id}"
        self.clog.name = f"osd.{self.osd_id}"
        self.clog.start()
        if self._crash_dir:
            # replay reports spooled while the mon was unreachable
            # (cephadm crash-dir flow); acked entries leave the spool
            await replay_crash_spool(self._crash_dir, self._send_crash)
        # mon-distributed config landed after the Context was built:
        # re-apply the op-tracker thresholds it governs
        self.ctx.op_tracker.slow_threshold = float(
            self.conf.get("osd_op_complaint_time", 2.0) or 2.0)
        if self._ec_queue is not None:
            # in-process execute() works without the unix socket, so the
            # timeline command registers whether or not asok_dir is set
            self._ec_queue.register_asok(self.ctx.asok)
        # in-process execute() works without the unix socket (the asok
        # command registers whether or not asok_dir is set, like the EC
        # batch timeline above)
        self.ctx.asok.register(
            "dump_hit_sets", lambda a: self._dump_hit_sets(),
            "per-PG hit-set archives (intervals, fill, estimated fpp)")
        self.ctx.asok.register(
            "tier status", lambda a: self.tier_status(),
            "cache-tier residency/promotion/eviction status")
        self.ctx.asok.register(
            "dump_op_queue", lambda a: self.dump_op_queue(),
            "per-class/per-client queue depths and dmClock tags")
        self.ctx.asok.register(
            "dump_reactors", lambda a: self.messenger.dump_reactors(),
            "wire plane: reactor worker shards, per-peer lane state, "
            "colocated rings")
        self.ctx.asok.register(
            "inject_crash", lambda a: self.inject_crash(),
            "raise a fatal exception in the next ping tick "
            "(crash-telemetry exercise)")
        # single-PG scrub/repair (reference `ceph pg scrub/repair
        # <pgid>`): reached via the MCommand tell path aimed at the
        # PG's primary — the hooks are async; execute_async awaits them
        self.ctx.asok.register(
            "pg scrub",
            lambda a: self._pg_admin_scrub(a.get("pgid", ""),
                                           repair=False),
            "deep-scrub one PG this OSD leads (pgid=<pool>.<hex>)")
        self.ctx.asok.register(
            "pg repair",
            lambda a: self._pg_admin_scrub(a.get("pgid", ""),
                                           repair=True),
            "scrub + repair + verify one PG this OSD leads "
            "(pgid=<pool>.<hex>)")
        asok_dir = self.conf.get("admin_socket_dir")
        if asok_dir:
            self.ctx.asok.register(
                "status", lambda a: self.status(), "osd status")
            await self.ctx.asok.start(f"{asok_dir}/osd.{self.osd_id}.asok")
        return self.osd_id

    def status(self) -> dict:
        return {
            "osd_id": self.osd_id,
            "epoch": self.osdmap.epoch if self.osdmap else 0,
            "op_queue_depth": self.op_queue.depth(),
            "hb_peers": sorted(self._hb_last),
        }

    def dump_op_queue(self) -> dict:
        """asok ``dump_op_queue``: the sharded queue's per-class /
        per-client depths and current dmClock tags, plus the admission
        tracker's per-client over-limit excess (the shed-ranking view)."""
        out = self.op_queue.dump()
        out["admission"] = self.qos.dump()
        return out

    # -- daemon crash guard (the ceph-crash agent role) ----------------------

    async def _guarded(self, fn, *args) -> None:
        """Top-level exception hook around a serve loop: capture the
        dump_recent ring + backtrace + identity into a crash report,
        deliver it to the mon (spool to crash_dir when unreachable),
        shout on the cluster log, and stop the daemon — a dying OSD must
        leave a trace an operator (and `non_regression --crash`) can
        query."""
        try:
            await fn(*args)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            await self._on_fatal(e)

    async def _on_fatal(self, exc: BaseException) -> None:
        entity = f"osd.{self.osd_id}"
        self.ctx.log.error("osd", f"fatal: {exc!r}")
        report = build_crash_report(exc, entity, version=self.ctx.version,
                                    log=self.ctx.log)
        self.clog.error(f"{entity} crashed: {exc!r} "
                        f"(crash id {report.crash_id})")
        delivered = await self._send_crash(report)
        if not delivered and self._crash_dir:
            try:
                spool_crash(self._crash_dir, report)
            except OSError:
                pass
        try:
            await self.clog.flush_now()
        except Exception:
            pass
        # the daemon dies (we may be running inside a task stop()
        # cancels, so the shutdown detaches)
        if not self._stopped:
            self._fatal_task = asyncio.get_running_loop().create_task(
                self.stop())

    async def _send_crash(self, report) -> bool:
        """Deliver one crash report to the mon; True only on a durable
        ack (the spool-replay contract)."""
        try:
            ack = await self._mon_rpc(report, MCrashReportAck)
            return bool(getattr(ack, "ok", False))
        except Exception:
            return False

    def inject_crash(self) -> dict:
        """Dev/CI hook (asok ``inject_crash`` / osd_debug_inject_crash):
        the next ping tick raises, exercising the whole crash plane."""
        self._inject_crash = True
        return {"injected": True, "osd": self.osd_id}

    async def stop(self) -> None:
        self._stopped = True
        await self.clog.stop()
        for t in (self._ping_task, self._hb_task, self._repair_task,
                  self._meta_repl_task, self._scrub_task):
            if t:
                t.cancel()
        for m in self._pg_machines.values():
            if m.task is not None:
                m.task.cancel()
        await self.op_queue.stop()
        await self.ctx.shutdown()
        await self.messenger.shutdown()
        if self._planar is not None:
            # the shared store is process-global but keys are namespaced
            # per OSD: a stopped daemon's residents — dirty fast-ack
            # copies included — are process memory that a real dead OSD
            # loses, so drop them (kill_osd honesty: a revived id must
            # re-earn its pages, and surviving replicas' copies are the
            # ONLY cache-tier copies of its acked writebacks)
            snap = getattr(self._planar, "entries_snapshot", None)
            if snap is not None:
                for key, _nb in snap():
                    if isinstance(key, tuple) and key \
                            and key[0] == self.osd_id:
                        self._planar.drop(key, force=True)
        close = getattr(self.store, "close", None)
        if close is not None:
            close()

    @property
    def mon_addr(self):
        return self.mons.current

    async def _refresh_auth(self) -> None:
        """cephx-lite daemon setup: fetch the rotating service secrets
        (ticket validation) and our own service ticket (OSD->OSD dials)
        from the mon.  Called at boot and periodically so rotations
        propagate (reference RotatingKeyRing refresh)."""
        try:
            rot = await self._mon_rpc(MAuthRotating(), MAuthRotatingReply)
            if getattr(rot, "denied", False):
                raise PermissionError(
                    "mon refused rotating keys (connection not "
                    "daemon-authenticated)")
            if self.messenger.keyring is None:
                self.messenger.keyring = TicketKeyring()
            self.messenger.keyring.load(rot.keys)
            tkt = await self._mon_rpc(
                MAuthTicket(entity=f"osd.{self.osd_id}", entity_type="osd"),
                MAuthTicketReply)
            if getattr(tkt, "denied", False):
                raise PermissionError(
                    "mon refused osd ticket (connection not "
                    "daemon-authenticated)")
            self.messenger.ticket = bytes.fromhex(tkt.ticket)
            self.messenger.session_key = bytes.fromhex(tkt.session_key)
        except TRANSPORT_ERRORS as e:
            self.ctx.log.error("osd", f"auth refresh failed: {e}")
            if isinstance(e, PermissionError) and \
                    self.messenger.ticket is not None:
                # an expired/refused ticket wedges every dial (a presented
                # ticket MUST verify — no silent fallback): drop it so the
                # next refresh re-proves the bootstrap secret instead
                self.messenger.ticket = None
                self.messenger.session_key = None

    def _health_checks(self) -> Dict[str, Dict]:
        """Daemon-observed health checks riding the liveness ping (the
        reference's OSD -> mon health report path): SLOW_OPS from the op
        tracker's complaint aging, BREAKER_OPEN from the device-dispatch
        circuit breaker, TIER_OVER_TARGET from planar residency vs the
        agent's budget.  Empty dict = healthy; the mon clears a check
        when the next report omits it."""
        checks: Dict[str, Dict] = {}
        slow = self.ctx.op_tracker.slow_op_summary()
        if slow["count"]:
            checks["SLOW_OPS"] = {
                "severity": "warning",
                "summary": f"{slow['count']} slow ops, oldest "
                           f"{slow['oldest_age']:.1f}s "
                           f"(complaint time {slow['complaint_time']:g}s)",
                "count": slow["count"],
                "oldest_age": slow["oldest_age"],
                "detail": [f"{o['description']} age {o['age']:.1f}s "
                           f"last event {o['last_event']}"
                           for o in slow["ops"]],
            }
        if self._ec_queue is not None:
            lanes = self._ec_queue.open_lanes()
            if lanes:
                checks["BREAKER_OPEN"] = {
                    "severity": "warning",
                    "summary": f"{len(lanes)} device-dispatch lanes open "
                               f"(CPU fallback): {sorted(lanes)}",
                    "lanes": sorted(lanes),
                }
        if self._planar is not None:
            target = self._tier_effective_target()
            resident = self._planar.resident_bytes
            if target and resident > target:
                checks["TIER_OVER_TARGET"] = {
                    "severity": "warning",
                    "summary": f"tier resident {resident} bytes over "
                               f"target {target}",
                    "resident_bytes": resident,
                    "target_bytes": target,
                }
        if self._scrub_errors:
            # scrub-found inconsistency (reference OSD_SCRUB_ERRORS +
            # PG_INCONSISTENT off scrub stats): raised while any PG this
            # OSD leads had mismatches on its last scrub; cleared when a
            # later scrub/repair pass verifies the PG clean (the next
            # ping omits the check and the mon drops it)
            keys = sorted(self._scrub_errors)  # numeric (pool, pg) order
            pgs = [f"{k[0]}.{k[1]:x}" for k in keys]
            n_err = int(sum(rec.get("errors", 0)
                            for rec in self._scrub_errors.values()))
            checks["OSD_SCRUB_ERRORS"] = {
                "severity": "error",
                "summary": f"{n_err} scrub errors",
                "count": n_err,
            }
            checks["PG_INCONSISTENT"] = {
                "severity": "error",
                "summary": f"{len(pgs)} pg(s) inconsistent "
                           f"(scrub found shard mismatches)",
                "count": len(pgs),
                "pgs": pgs,
                "detail": [
                    f"pg {pgid} inconsistent: "
                    f"{int(rec.get('errors', 0))} mismatched shard(s), "
                    f"{int(rec.get('repaired', 0))} repaired; run "
                    f"`ceph pg repair {pgid}` (or wait for the next "
                    f"scrub) to verify and clear"
                    for pgid, rec in zip(pgs, (
                        self._scrub_errors[k] for k in keys))],
            }
        toofull = sorted(
            f"{k[0]}.{k[1]:x}" for k, m in self._pg_machines.items()
            if getattr(m, "backfill_toofull", False))
        if toofull:
            # the `backfill_toofull` PG state (reference PG_BACKFILL_FULL
            # health check): reservation refused by a BACKFILLFULL
            # target; the PG parks and retries until space frees
            checks["PG_BACKFILL_FULL"] = {
                "severity": "warning",
                "summary": f"{len(toofull)} pg(s) backfill_toofull "
                           f"(reservation refused by a backfillfull "
                           f"target)",
                "count": len(toofull),
                "pgs": toofull,
                "detail": [f"pg {p} backfill parked: target past its "
                           f"backfillfull ratio; retrying" for p in
                           toofull],
            }
        return checks

    # -- capacity / fullness plane -------------------------------------------

    def _inject_full_ratio(self) -> Optional[float]:
        """Dev knob: force this OSD's REPORTED utilization so CI can
        drive the whole fullness ladder without writing gigabytes.
        Sources (first match wins): conf ``osd_debug_inject_full``, the
        daemon Context's config layer (asok / `ceph tell ... config
        set` mutate THAT one live — a dict-conf'd vstart daemon keeps a
        separate Config there), then the ``CEPH_TPU_INJECT_FULL`` env.
        Value: ``RATIO`` (applies to this OSD) or
        ``ID:RATIO[,ID:RATIO...]`` (in-process clusters share one
        conf/env, so the ladder needs per-OSD aim)."""
        ctx_conf = getattr(self.ctx, "conf", None)
        for raw in (self.conf.get("osd_debug_inject_full", ""),
                    ctx_conf.get("osd_debug_inject_full", "")
                    if ctx_conf is not None
                    and ctx_conf is not self.conf else "",
                    os.environ.get("CEPH_TPU_INJECT_FULL", "")):
            if not raw:
                continue
            for part in str(raw).split(","):
                part = part.strip()
                if not part:
                    continue
                sid, sep, r = part.partition(":")
                try:
                    if not sep:
                        return float(part)
                    if int(sid) == self.osd_id:
                        return float(r)
                except (TypeError, ValueError):
                    continue
        return None

    def _statfs(self) -> Dict[str, int]:
        """Effective store utilization: every store implements the
        uniform statfs shape now (total == 0 = no configured capacity),
        with the fullness-injection knob applied on top."""
        st = dict(self.store.statfs())
        missing = {"total", "used", "avail", "num_objects"} - set(st)
        assert not missing, \
            f"{type(self.store).__name__}.statfs() missing {missing}"
        inj = self._inject_full_ratio()
        if inj is not None and inj >= 0:
            total = int(st.get("total") or 0) or (1 << 30)
            st["total"] = total
            st["used"] = int(total * inj)
            st["avail"] = max(0, total - st["used"])
            st["injected"] = True
        return st

    def _failsafe_full(self, extra_bytes: int = 0) -> bool:
        """Would accepting ``extra_bytes`` more cross the failsafe
        ceiling (osd_failsafe_full_ratio of capacity)?  The last-resort
        guard protecting the store itself; injection-aware so CI can
        exercise it."""
        # hot path (every shard write): the common no-ceiling,
        # no-injection case must not pay a statfs sweep
        if not int(getattr(self.store, "capacity_bytes", 0) or 0) \
                and self._inject_full_ratio() is None:
            return False
        st = self._statfs()
        total = int(st.get("total") or 0)
        if total <= 0:
            return False
        ratio = float(self.conf.get("osd_failsafe_full_ratio", 0.97)
                      or 0.97)
        return int(st.get("used") or 0) + extra_bytes > int(total * ratio)

    def _my_full_state(self) -> str:
        """This OSD's fullness state: the mon-derived map state, or the
        LOCAL effective ratio vs the map thresholds when that is more
        severe (the local view leads the mon by up to a ping)."""
        if self.osdmap is None:
            return ""
        state = self.osdmap.full_state(self.osd_id)
        st = self._statfs()
        total = int(st.get("total") or 0)
        if total > 0:
            local = self.osdmap.state_for_ratio(
                int(st.get("used") or 0) / total)
            if FULL_SEVERITY[local] > FULL_SEVERITY[state]:
                state = local
        return state

    def _full_block_reply(self, op: MOSDOp) -> Optional[MOSDOpReply]:
        """Typed-ENOSPC write gate (reference PrimaryLogPG check_full +
        the osdmap full handling): a mutation targeting a PG whose
        acting set contains a FULL OSD — or arriving at a failsafe-full
        primary — fails FAST with ENOSPC (definitive at the client; no
        eternal resend loop).  Reads are untouched.  DELETES are
        explicitly exempt (op delete, snap-trim, and delete-only
        multis): deleting is the only way out of full, so the delete
        path threads through every gate."""
        if self.osdmap is None or op.op not in ("write", "multi", "call"):
            return None
        if op.op == "multi" and (is_delete_only_multi(op)
                                 or is_read_only_multi(op)):
            # delete-only compounds drain; read-only compounds observe —
            # neither adds bytes, neither is gated
            return None
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None or not op.oid:
            return None
        pg = self.osdmap.object_to_pg(pool, op.oid)
        acting = self.osdmap.pg_to_acting(pool, pg)
        full = [a for a in acting if a != CRUSH_ITEM_NONE
                and self.osdmap.full_state(a) == "full"]
        if full:
            self.perf.inc("full_rejects")
            return MOSDOpReply(
                ok=False, code=-errno.ENOSPC,
                error=f"ENOSPC: pg {op.pool_id}.{pg:x} acting set has "
                      f"full osd(s) {full}; delete data or raise the "
                      f"full ratio")
        if self._failsafe_full(len(op.data) if op.data else 0):
            self.perf.inc("full_rejects")
            return MOSDOpReply(
                ok=False, code=-errno.ENOSPC,
                error=f"ENOSPC: osd.{self.osd_id} past failsafe ratio")
        return None

    async def _ping_loop(self, interval: float) -> None:
        ticks = 0
        while not self._stopped:
            if self._inject_crash:
                # dev/CI crash injection: a REAL unexpected exception in
                # the daemon's main loop, caught only by the guard
                self._inject_crash = False
                raise RuntimeError(
                    "injected crash (osd_debug_inject_crash)")
            try:
                await self.messenger.send(
                    self.mons.current,
                    MPing(osd_id=self.osd_id,
                          epoch=self.osdmap.epoch if self.osdmap else 0,
                          addr=self.addr or ("", 0),
                          health=self._health_checks(),
                          # statfs piggybacks the liveness ping (v4):
                          # the mon's fullness derivation runs on it
                          statfs=self._statfs(),
                          # v5: unflushed-dirt roster for the mon's
                          # safe-to-destroy / ok-to-stop predicates
                          cache_dirty=self._cache_dirty_summary()),
                )
            except TRANSPORT_ERRORS:
                self.mons.rotate()  # that mon looks dead
            ticks += 1
            self._maybe_schedule_scrubs()
            self._maybe_schedule_tier_agent()
            if self._ec_queue is not None:
                # mirror the shared queue's stats into this daemon's
                # counters (perf dump / prometheus visibility); submits
                # vs dispatches is the coalescing ratio
                self.perf.set("ec_batch_ops", self._ec_queue.submits)
                self.perf.set("ec_batch_dispatches", self._ec_queue.dispatches)
                self.perf.set("ec_batch_bytes", self._ec_queue.bytes_dispatched)
            if ticks % 3 == 0:
                await self._report_to_mgr()
            if self.conf.get("auth_cephx", False):
                ttl = float(self.conf.get("auth_ticket_ttl", 3600.0) or 3600.0)
                period = max(1, int(ttl / 4 / max(interval, 0.01)))
                if ticks % period == 0:
                    await self._refresh_auth()
            await asyncio.sleep(interval)

    async def _report_to_mgr(self) -> None:
        """Push perf/status to the mgr (MMgrReport flow) when one is
        configured (mgr_addr rides the centralized config)."""
        raw = self.conf.get("mgr_addr", "")
        if not raw:
            return
        try:
            host, port = str(raw).rsplit(":", 1)
            from ceph_tpu_torch.mgr.daemon import MMgrReport

            await asyncio.wait_for(
                self.messenger.send(
                    (host, int(port)),
                    MMgrReport(name=f"osd.{self.osd_id}",
                               perf=self.ctx.perf.dump(),
                               status=self.status(), stamp=time.time()),
                    peer_type="mgr"),
                timeout=2.0)  # a stalled mgr must not starve mon pings
        except TRANSPORT_ERRORS:
            pass

    async def _heartbeat_loop(self, interval: float) -> None:
        """OSD<->OSD liveness (maybe_update_heartbeat_peers + heartbeat,
        OSD.cc:5278,5837): ping every up peer; a peer silent past the grace
        is reported to the mon as MOSDFailure."""
        grace = float(self.conf.get("osd_heartbeat_grace", 2.0) or 2.0)
        while not self._stopped:
            await asyncio.sleep(interval)
            if self.osdmap is None:
                continue
            now = time.monotonic()
            peers = [o for o in self.osdmap.osds.values()
                     if o.up and o.osd_id != self.osd_id]
            for o in peers:
                try:
                    await self.messenger.send(
                        o.addr, MOSDPing(op="ping", from_osd=self.osd_id,
                                         stamp=now,
                                         epoch=self.osdmap.epoch))
                except ConnectionRefusedError:
                    # nothing is LISTENING at the peer's address: the
                    # process is gone, not slow — report immediately
                    # instead of burning the grace window (the reference
                    # reports connection faults ahead of ping timeouts).
                    # A restarting OSD re-boots and re-registers, so a
                    # false positive costs one re-peer, not data.
                    if now - self._hb_reported.get(o.osd_id, -1e9) > 1.0:
                        self._hb_reported[o.osd_id] = now
                        self.perf.inc("heartbeat_failures")
                        try:
                            await self.messenger.send(
                                self.mons.current,
                                MOSDFailure(target_osd=o.osd_id,
                                            from_osd=self.osd_id,
                                            failed_for=grace))
                        except TRANSPORT_ERRORS:
                            pass
                except TRANSPORT_ERRORS:
                    pass
                last = self._hb_last.setdefault(o.osd_id, now)
                last_report = self._hb_reported.get(o.osd_id, -1e9)
                if now - last > grace and now - last_report > grace:
                    # re-report each grace interval while the peer stays
                    # silent: the mon ages out stale reporter evidence, so
                    # one-shot reports could never meet a multi-reporter
                    # threshold (reference re-sends MOSDFailure too)
                    self._hb_reported[o.osd_id] = now
                    self.perf.inc("heartbeat_failures")
                    try:
                        await self.messenger.send(
                            self.mons.current,
                            MOSDFailure(target_osd=o.osd_id,
                                        from_osd=self.osd_id,
                                        failed_for=now - last))
                    except TRANSPORT_ERRORS:
                        pass
            # prune state for peers no longer up in the map
            live = {o.osd_id for o in peers}
            for dead in list(self._hb_last):
                if dead not in live:
                    self._hb_last.pop(dead, None)
                    self._hb_reported.pop(dead, None)

    async def _mon_rpc(self, msg, reply_type):
        """Send to a mon and wait for the typed reply; rotate through the
        monmap on timeout (peons forward writes to the leader).  Pending
        futures key on a per-RPC tid echoed by the mon, so two concurrent
        RPCs expecting the same reply type cannot clobber each other;
        type-name keying remains only for untagged messages."""
        if hasattr(msg, "tid"):
            if not msg.tid:
                msg.tid = uuid.uuid4().hex
            key = f"monrpc-{msg.tid}"
        else:
            key = f"monrpc-{reply_type.__name__}"
        last: Exception = TimeoutError("no mon reachable")
        try:
            for _ in range(len(self.mons)):
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                self._pending[key] = fut
                try:
                    await self.messenger.send(self.mons.current, msg)
                    return await asyncio.wait_for(fut, timeout=10)
                except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                    last = e
                    self.mons.rotate()
        finally:
            self._pending.pop(key, None)
        raise last

    # -- codecs --------------------------------------------------------------

    def _codec(self, pool: PoolInfo):
        codec = self._codecs.get(pool.pool_id)
        if codec is None:
            profile = dict(pool.profile)
            # on the daemon's EC device, like its queue and resident store
            codec = registry.factory(
                profile.get("plugin", "jerasure"), profile.get("directory", ""),
                profile, device=self._ec_device)
            self._codecs[pool.pool_id] = codec
        return codec

    def _sinfo(self, pool: PoolInfo) -> StripeInfo:
        """Per-pool stripe geometry (the reference's sinfo, ECUtil.h:27):
        stripe_unit rides the pool profile (or osd_ec_stripe_unit), rounded
        up to the codec's per-chunk alignment so every stripe's chunks land
        on codec block boundaries."""
        si = self._sinfos.get(pool.pool_id)
        if si is None:
            codec = self._codec(pool)
            k = codec.get_data_chunk_count()
            if pool.stripe_width:
                su = max(1, pool.stripe_width // k)
            else:
                su = int(pool.profile.get(
                    "stripe_unit",
                    self.conf.get("osd_ec_stripe_unit", 4096)) or 4096)
            cs = codec.get_chunk_size(k * max(1, su))
            si = StripeInfo(k, cs * k)
            self._sinfos[pool.pool_id] = si
        return si

    # -- dispatch ------------------------------------------------------------

    def _resolve_monrpc(self, msg) -> None:
        fut = None
        tid = getattr(msg, "tid", "")
        if tid:
            fut = self._pending.pop(f"monrpc-{tid}", None)
        if fut is None:
            fut = self._pending.pop(f"monrpc-{type(msg).__name__}", None)
        if fut and not fut.done():
            fut.set_result(msg)

    async def _dispatch_group(self, conn, msgs) -> None:
        """Whole-group handoff from the messenger rx batch (frames that
        were already buffered on the transport).  Partitioning preserves
        per-connection order — only CONSECUTIVE runs of one type batch:
        sub-write runs apply together and coalesce their replies into
        one flush window; everything else (including MOSDOps, whose
        sharded-op-queue enqueue already returns at queue time, so a
        batch of writes reaches the BatchingQueue's coalescing window
        together) dispatches singly in arrival order."""
        i = 0
        n = len(msgs)
        while i < n:
            if isinstance(msgs[i], MECSubWrite):
                j = i
                while j < n and isinstance(msgs[j], MECSubWrite):
                    j += 1
                try:
                    await self._handle_sub_write_group(msgs[i:j])
                except (asyncio.CancelledError, GeneratorExit):
                    raise
                except Exception:
                    import traceback

                    traceback.print_exc()
                i = j
                continue
            try:
                await self._dispatch(conn, msgs[i])
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                import traceback

                traceback.print_exc()
            i += 1

    async def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, MMapReply):
            if msg.osdmap is not None:
                self._on_map(msg.osdmap)
            elif msg.incrementals and self.osdmap is not None:
                # apply the delta chain to a copy; on a broken chain fall
                # back to a full-map fetch (reference subscriber behavior)
                m = pickle.loads(pickle.dumps(self.osdmap, protocol=5))
                if all(m.apply_incremental(inc) for inc in msg.incrementals):
                    self._on_map(m)
                else:
                    asyncio.get_running_loop().create_task(self._fetch_full_map())
            self._resolve_monrpc(msg)
        elif isinstance(msg, MBootReply):
            self._resolve_monrpc(msg)
        elif isinstance(msg, (MAuthRotatingReply, MAuthTicketReply)):
            self._resolve_monrpc(msg)
        elif isinstance(msg, MOSDPing):
            if msg.op == "ping":
                try:
                    await conn.send(MOSDPing(op="reply", from_osd=self.osd_id,
                                             stamp=msg.stamp))
                except (ConnectionError, OSError):
                    pass
            else:
                self._hb_last[msg.from_osd] = time.monotonic()
                self._hb_reported.pop(msg.from_osd, None)
        elif isinstance(msg, MOSDOp):
            # a wire blob may have landed as an uninitialized-buffer VIEW
            # (MOSDOp.BLOB_VIEW_OK): only the write path is audited for
            # buffer semantics — every other op's handlers (object
            # classes, multi vectors) get real bytes
            if msg.op != "write" \
                    and not isinstance(msg.data, (bytes, bytearray)):
                msg.data = as_bytes(msg.data)
            # op tracking starts at ARRIVAL (not at dequeue) so the
            # queued_for_pg -> reached_pg gap measures real queue wait;
            # when the client propagated a trace context, our op span
            # JOINS it as a child — the cross-daemon stitch point
            tracked = self._track_client_op(msg)
            # client ops ride the sharded op queue: PG-pinned shard keeps
            # per-PG order; scheduler arbitrates client vs recovery
            # classes; a full queue blocks HERE so the messenger stops
            # reading and backpressure reaches the sender
            pg_key = self._pg_key_of(msg)
            if msg.op in ("notify", "deep-scrub", "repair"):
                # notify gathers watcher acks for seconds and touches no
                # PG state: it runs as its OWN task so neither the shard
                # worker nor this serve loop blocks (a watcher callback
                # may issue ops through both).  deep-scrub/repair are
                # multi-second fan-out sweeps whose per-object work now
                # waits its dmClock turn (CLASS_SCRUB/CLASS_RECOVERY)
                # through _background_throttle — run them OUTSIDE the
                # queue so a sweep never holds a shard slot hostage
                # while its own throttle items wait behind it
                t = asyncio.get_running_loop().create_task(
                    self._handle_client_op(conn, msg))
                self.messenger._tasks.add(t)
                t.add_done_callback(self.messenger._tasks.discard)
                return
            op_class = {"repair": CLASS_RECOVERY,
                        "deep-scrub": CLASS_BEST_EFFORT}.get(
                msg.op, CLASS_CLIENT)
            # per-client QoS: resolve the sender's profile from the
            # pool's osdmap-distributed opts and observe the ARRIVAL in
            # the admission tracker (the offered-rate view the
            # saturation shed ranks over — shed arrivals count too, with
            # the tracker's arrears cap bounding the memory); the same
            # profile seeds the op's per-client dmClock state in the
            # scheduler shard
            client = getattr(msg, "client", "")
            qos_params: Optional[QosParams] = None
            # byte-COST of this op in dmClock tag units (qos.qos_op_cost
            # — 1 + bytes/osd_qos_cost_per_io): both the admission
            # tracker and the per-client scheduler tags advance by it,
            # so a bandwidth hog issuing few large ops cannot escape a
            # limit declared in ops/sec
            qcost = qos_op_cost(len(msg.data) if msg.data else 0,
                                self.conf)
            if client and op_class == CLASS_CLIENT:
                pool = self.osdmap.pools.get(msg.pool_id) \
                    if self.osdmap else None
                qos_params = pool_qos(pool, client, self.conf) \
                    if pool is not None else None
                if qos_params is not None:
                    # cross-OSD normalization: the declared profile is
                    # the tenant's CLUSTER-WIDE entitlement; this OSD
                    # enforces its 1/spread share so N independent
                    # primaries sum to the nominal rate, not N x it
                    if self.conf.get("osd_qos_normalize_spread", True):
                        qos_params = qos_params.normalized(
                            self._primary_spread(pool))
                    self.qos.observe(client, qos_params, cost=qcost)
            # arrival-side saturation shed: a saturated OSD drops-and-
            # blocks HERE, before the op consumes a queue slot — the
            # post-dequeue point would drop a whole admitted burst in
            # lockstep instead of letting the first qmax ops through
            if await self._maybe_shed_queue(conn, msg):
                tracked.mark_event("backoff")
                if tracked.trace is not None:
                    tracked.trace.tag("backoff", True)
                    tracked.trace.finish()
                tracked.finish()
                return
            try:
                await self.op_queue.enqueue(
                    pg_key, lambda: self._handle_client_op(conn, msg),
                    op_class, cost=max(1, len(msg.data) // 4096),
                    client=client if qos_params is not None else "",
                    qos=qos_params, qos_cost=qcost,
                )
            except BaseException:
                # cancelled (or failed) while parked on a full queue:
                # the handler will never run, so the tracked op must not
                # sit in the in-flight map forever raising SLOW_OPS —
                # and its span must still record (spans only land in the
                # ring on finish)
                if tracked.done_at is None:
                    tracked.mark_event("enqueue_aborted")
                    if tracked.trace is not None:
                        tracked.trace.tag("aborted", True)
                        tracked.trace.finish()
                    tracked.finish()
                raise
        elif isinstance(msg, MECSubWrite):
            await self._handle_sub_write(msg)
        elif isinstance(msg, MCacheDirty):
            await self._handle_cache_dirty(msg)
        elif isinstance(msg, MECSubRead):
            await self._handle_sub_read(msg)
        elif isinstance(msg, MECSubDelete):
            await self._handle_sub_delete(msg)
        elif isinstance(msg, MListShards):
            await self._handle_list_shards(msg)
        elif isinstance(msg, MFetchShards):
            await self._handle_fetch_shards(msg)
        elif isinstance(msg, MPushShard):
            self._apply_push(msg)
        elif isinstance(msg, MPGInfoReq):
            await self._handle_pg_info(msg)
        elif isinstance(msg, MPGLogReq):
            await self._handle_pg_log_req(msg)
        elif isinstance(msg, MScrubShard):
            await self._handle_scrub_shard(msg)
        elif isinstance(msg, MBackfillReserve):
            await self._handle_backfill_reserve(msg)
        elif isinstance(msg, MECSubRollback):
            self._handle_sub_rollback(msg)
        elif isinstance(msg, MNotifyAck):
            q = self._collectors.get(msg.notify_id)
            if q is not None:
                q.put_nowait(msg)
        elif isinstance(msg, MSetXattrs):
            key = (msg.pool_id, msg.oid, msg.shard)
            try:
                for name, value in msg.xattrs.items():
                    self.store.setattr(key, name, value)
                for name in msg.removals:
                    self.store.rmattr(key, name)
            except NotImplementedError:
                pass
        elif isinstance(msg, MSetOmap):
            key = (msg.pool_id, msg.oid, msg.shard)
            try:
                if msg.clear:
                    self.store.omap_rm(key, list(self.store.omap_get(key)))
                if msg.entries:
                    self.store.omap_set(key, msg.entries)
                if msg.removals:
                    self.store.omap_rm(key, msg.removals)
            except NotImplementedError:
                pass
        elif isinstance(msg, MLogAck):
            self.clog.handle_ack(msg)
        elif isinstance(msg, MCommand):
            # `ceph tell osd.N <cmd>` (reference MCommand): run the
            # admin-socket command in-process — config set/get (runtime
            # debug levels), perf dump, dump_ops_in_flight, ... — and
            # reply on the same connection.  With auth configured, only
            # authenticated peers may drive it.
            if self.conf.get("auth_cephx", False) and \
                    getattr(conn, "auth_kind", "none") == "none":
                reply = MCommandReply(tid=msg.tid, ok=False,
                                      error="EPERM: unauthenticated tell")
            else:
                try:
                    result = await self.ctx.asok.execute_async(
                        msg.prefix, **(msg.args or {}))
                    reply = MCommandReply(tid=msg.tid, ok=True,
                                          result=result)
                except Exception as e:
                    reply = MCommandReply(
                        tid=msg.tid, ok=False,
                        error=f"{type(e).__name__}: {e}")
            try:
                await conn.send(reply)
            except (ConnectionError, OSError):
                pass
        elif isinstance(msg, MCrashReportAck):
            self._resolve_monrpc(msg)
        elif isinstance(msg, MOSDPGHitSet):
            self._handle_pg_hit_set(msg)
        elif isinstance(msg, MPGLogReply) and not msg.tid:
            # unsolicited authoritative log push from the primary: merge
            # (with divergent-entry rollback) so our head catches up
            entries = []
            for blob in msg.entries:
                e = LogEntry.decode(blob)
                e.version = tuple(e.version)
                e.prior_version = tuple(e.prior_version)
                entries.append(e)
            if entries:
                await self._merge_log_entries(msg.pool_id, msg.pg, entries)
        elif isinstance(
            msg, (MECSubWriteReply, MECSubReadReply, MListShardsReply,
                  MFetchShardsReply, MPGInfoReply, MPGLogReply,
                  MScrubShardReply, MBackfillReserveReply, MCacheDirtyAck)
        ):
            q = self._collectors.get(msg.tid)
            if q is not None:
                q.put_nowait(msg)

    async def _fetch_full_map(self) -> None:
        try:
            await self._mon_rpc(MGetMap(min_epoch=0), MMapReply)
        except TRANSPORT_ERRORS:
            pass

    def _on_map(self, osdmap: OSDMap) -> None:
        old = self.osdmap
        if old is not None and osdmap.epoch <= old.epoch:
            return
        # push per-pool store options (pg_pool_t::opts role) so the
        # ObjectStore applies compression policy at its blob boundary
        spo = getattr(self.store, "set_pool_opts", None)
        if spo is not None:
            for pool in osdmap.pools.values():
                spo(pool.pool_id, getattr(pool, "opts", {}) or {})
        if old is None:
            # FIRST map after boot: pools deleted while this OSD was
            # down never produce an old→new transition here, so sweep
            # the persistent store for pools absent from the map
            # (reference: PG deletion resumes on activation)
            try:
                for pid in self.store.list_pools():
                    if pid not in osdmap.pools:
                        self._purge_pool(pid)
            except NotImplementedError:
                pass
        changed_pgs: List[Tuple[PoolInfo, int]] = []
        if old is not None and self._mapping_inputs_changed(old, osdmap):
            # remember the outgoing interval's acting set for PGs whose
            # mapping changed (past_intervals role): it is the set a
            # pg_temp request must name during backfill, and its members
            # accumulate in _past_members (the scope set for deletes,
            # shard hunts and backfill until the PG is clean again).  The
            # pool DELETION (reference PG deletion after `osd pool rm`):
            # a pool present in the old map and gone from the new one is
            # authoritatively deleted cluster-wide — purge every local
            # object/shard of it, its PG logs, and its cache entries
            for gone_id in [p for p in old.pools if p not in osdmap.pools]:
                self._purge_pool(gone_id)
            # dual-CRUSH scan only runs when a mapping INPUT changed (osd
            # states, weights, pools, pg_temp, crush) — config-only
            # epochs skip it.
            for pool in osdmap.pools.values():
                old_pool = old.pools.get(pool.pool_id)
                if old_pool is None:
                    # the pool APPEARED between our old and new maps.  If
                    # it appeared in the very epoch it was created, it is
                    # brand new (no writes can predate us).  If our map
                    # JUMPED past its creation (created_epoch < new
                    # epoch, or an unknown pre-field 0), its PGs may
                    # carry history our logs never saw: kick peering and
                    # mark the interval "unknown prior" (empty prior
                    # acting) so the mutation backoff gate holds writes
                    # until the authoritative log is merged.
                    created = getattr(pool, "created_epoch", 0)
                    if 0 < created and created > old.epoch \
                            and created == osdmap.epoch:
                        continue  # appeared the epoch it was created
                    for pg in range(pool.pg_num):
                        changed_pgs.append((pool, pg))
                        self._prior_acting.setdefault(
                            (pool.pool_id, pg), [])
                    continue
                if old_pool.pg_num != pool.pg_num:
                    # PG split/merge: every object REHASHES, so any OSD
                    # that held any of the pool's PGs may hold objects of
                    # any NEW pg — seed every new pg's interval history
                    # with the union of the old mapping's members, or
                    # backfill/hunt scope would never visit the old
                    # holders and the data would sit stranded
                    old_members = set()
                    for opg in range(old_pool.pg_num):
                        old_members.update(
                            a for a in old.pg_to_acting(old_pool, opg)
                            if a != CRUSH_ITEM_NONE)
                    for npg in range(pool.pg_num):
                        self._past_members.setdefault(
                            (pool.pool_id, npg), set()).update(old_members)
                for pg in range(max(pool.pg_num, old_pool.pg_num)):
                    key = (pool.pool_id, pg)
                    oa = (old.pg_to_acting(old_pool, pg)
                          if pg < old_pool.pg_num else [])
                    na = (osdmap.pg_to_acting(pool, pg)
                          if pg < pool.pg_num else [])
                    if oa == na:
                        continue
                    if pg < pool.pg_num:  # a shrunk-away pg needs no kick
                        changed_pgs.append((pool, pg))
                    self._past_members.setdefault(key, set()).update(
                        a for a in oa if a != CRUSH_ITEM_NONE)
                    if key in old.pg_temp and key not in osdmap.pg_temp:
                        # the override was CLEARED: backfill to the crush
                        # set completed, so the outgoing acting (the
                        # override itself) is obsolete history — recording
                        # it would let a later transient degradation
                        # reinstall a long-stale interval as pg_temp
                        self._prior_acting.pop(key, None)
                    else:
                        self._prior_acting[key] = oa
            # prune intervals of deleted pools (bounded memory)
            for d in (self._prior_acting, self._past_members,
                      self._pg_machines, self._partial_newer,
                      self._hit_sets, self._hit_set_epochs,
                      self._scrub_errors):
                for key in [k for k in d if k[0] not in osdmap.pools]:
                    d.pop(key, None)
        elif old is None:
            # first map: every PG we lead needs an initial peering pass
            changed_pgs = [(pool, pg) for pool in osdmap.pools.values()
                           for pg in range(pool.pg_num)]
            # a pool that predates this map (or an unknown pre-field 0)
            # may carry history our logs never saw — a freshly-booted
            # primary must merge the authoritative log before serving
            # mutations (empty prior = "unknown prior interval", the
            # backoff gate's failover condition)
            for pool, pg in changed_pgs:
                created = getattr(pool, "created_epoch", 0)
                if not created or created < osdmap.epoch:
                    self._prior_acting.setdefault((pool.pool_id, pg), [])
        self.osdmap = osdmap
        # writeback demote fence: any dirty resident whose PG we no
        # longer lead flushes NOW — the next primary's sub-reads hit our
        # backing store, and "writeback is never the only copy of acked
        # data" means a demoted primary may not keep deferred local
        # applies parked in HBM pages
        self._tier_flush_demoted()
        # fast-ack replay sweep: raw dirty copies whose recorded primary
        # is no longer this PG's primary either flush HERE (we inherited
        # primaryship — complete the dead primary's deferred destage) or
        # get pushed to the new primary (we hold a replica copy it needs)
        self._tier_raw_replay_sweep()
        # primaryship may have moved: cached decodes can silently go stale
        # across an interval we didn't serve (ExtentCache is per-interval)
        self._extent_cache.clear()
        # invalidate only codecs whose pool profile actually changed —
        # plugin=tpu codecs carry jit caches worth keeping across epochs
        for pool_id in list(self._codecs):
            new_pool = osdmap.pools.get(pool_id)
            old_pool = old.pools.get(pool_id) if old else None
            if new_pool is None or old_pool is None or new_pool.profile != old_pool.profile:
                self._codecs.pop(pool_id, None)
                self._sinfos.pop(pool_id, None)
        # revoke remote backfill-reservation grants whose requesting
        # primary is no longer this PG's primary (or is down): its release
        # message will never come, and without revocation a few primary
        # deaths would permanently exhaust the slots (reference: remote
        # reservations are cancelled on interval change / peer reset)
        def _grant_still_valid(key, grantee, _t):
            if grantee is None:
                return True  # local grant, owned by a task on this OSD
            pool = osdmap.pools.get(key[0])
            if pool is None:
                return False
            info = osdmap.osds.get(grantee)
            if info is None or not info.up:
                return False
            acting = osdmap.pg_to_acting(pool, key[1])
            return self._primary(pool, key[1], acting) == grantee

        self._remote_reserver.revoke_stale(_grant_still_valid)
        # release client backoffs for PGs we no longer lead: the new
        # primary has no state for our blocks, and the client's own
        # primary-change check drops them too — belt and braces
        for key in list(self._backoffs_sent):
            pool = osdmap.pools.get(key[0])
            if pool is None or key[1] >= pool.pg_num or self._primary(
                    pool, key[1],
                    osdmap.pg_to_acting(pool, key[1])) != self.osd_id:
                self._release_backoffs(key)
        # drop scrub-error records for PGs we no longer lead: only the
        # primary scrubs, so a record held past primaryship loss (or a
        # pool deletion) would raise PG_INCONSISTENT forever with no
        # pass left to clear it — the new primary's scrub owns the state
        for key in list(self._scrub_errors):
            pool = osdmap.pools.get(key[0])
            if pool is None or key[1] >= pool.pg_num or self._primary(
                    pool, key[1],
                    osdmap.pg_to_acting(pool, key[1])) != self.osd_id:
                self._scrub_errors.pop(key, None)
        # event-driven recovery (reference AdvMap/ActMap): kick the peering
        # statechart for exactly the PGs whose mapping changed — repair
        # traffic for one failed OSD touches only that OSD's PGs
        if self.conf.get("osd_auto_repair", True):
            for pool, pg in changed_pgs:
                acting = osdmap.pg_to_acting(pool, pg)
                if self._primary(pool, pg, acting) == self.osd_id:
                    self._kick_peering(pool, pg, acting)

    @staticmethod
    def _mapping_inputs_changed(old: OSDMap, new: OSDMap) -> bool:
        """True when something that can move a PG mapping changed between
        two maps: OSD up/in/weight states, pools, pg_temp, or crush."""
        if old.pg_temp != new.pg_temp or old.pools != new.pools:
            return True
        if old.pg_upmap != new.pg_upmap:
            return True
        if old.primary_affinity != new.primary_affinity:
            return True
        # same crush-change heuristic the incremental diff uses
        if (old.crush.devices() != new.crush.devices()
                or old.crush.rules.keys() != new.crush.rules.keys()):
            return True
        if old.osds.keys() != new.osds.keys():
            return True
        return any(
            (o.up, o.in_cluster, o.weight, osd_crush_weight(o))
            != (new.osds[i].up, new.osds[i].in_cluster,
                new.osds[i].weight, osd_crush_weight(new.osds[i]))
            for i, o in old.osds.items()
        )

    def _machine(self, pool_id: int, pg: int) -> PGMachine:
        key = (pool_id, pg)
        m = self._pg_machines.get(key)
        if m is None:
            m = self._pg_machines[key] = PGMachine(pool_id, pg)
        return m

    def _kick_peering(self, pool: PoolInfo, pg: int,
                      acting: List[int]) -> None:
        """Open a new interval on the PG's statechart and (re)start its
        peering task.  A task already running for an older interval keeps
        running but aborts at its next is_stale check."""
        m = self._machine(pool.pool_id, pg)
        if not m.new_interval(self.osdmap.epoch, acting):
            return
        if m.task is not None and not m.task.done():
            # the running pass belongs to a dead interval and may be
            # blocked in a multi-second gather against a zombie peer —
            # cancel it NOW; waiting for its next staleness check would
            # delay recovery past the next failure
            m.task.cancel()
        m.task = asyncio.get_running_loop().create_task(
            self._run_peering(pool.pool_id, pg))

    def _kick_recovery(self, pool: PoolInfo, pg: int) -> None:
        """Restart the PG's peering task WITHOUT an interval change — used
        when a write completes degraded (a member missed its sub-write):
        the pass re-peers, computes the peer's missing set from the log,
        and re-pushes promptly (the reference's write-time missing-set
        update)."""
        if not self.conf.get("osd_auto_repair", True):
            return
        m = self._machine(pool.pool_id, pg)
        if m.task is None or m.task.done():
            m.task = asyncio.get_running_loop().create_task(
                self._run_peering(pool.pool_id, pg))

    async def _run_peering(self, pool_id: int, pg: int) -> None:
        """Walk one PG through the peering statechart:

            GetInfo -> GetLog -> GetMissing -> Active
              -> Recovering (missing-set-scoped pushes)      [local slot]
              -> WaitLocal/RemoteBackfillReserved
              -> Backfilling (per-PG scoped copy sweep)      [both slots]
              -> Clean

        (reference PeeringState.cc transitions; recovery runs off peering
        events, not timers).  The loop re-enters GetInfo whenever the
        interval advances underneath it."""
        m = self._machine(pool_id, pg)
        if any(a == CRUSH_ITEM_NONE for a in m.acting):
            # degraded: every member of the acting set is load-bearing for
            # redundancy — recover immediately, don't coalesce
            await asyncio.sleep(0.05)
        else:
            await asyncio.sleep(self.conf.get("osd_repair_delay", 0.5))
        delay = self.conf.get("osd_recovery_retry", 1.0)
        while True:  # until Clean / deposed / stopped; backoff on retries
            epoch = m.interval_epoch
            pool = self.osdmap.pools.get(pool_id)
            if pool is None or self._stopped:
                self._release_backoffs((pool_id, pg))
                return
            acting = self.osdmap.pg_to_acting(pool, pg)
            if self._primary(pool, pg, acting) != self.osd_id:
                self._release_backoffs((pool_id, pg))
                return  # not ours this interval
            try:
                done, _pushed = await self._peer_and_recover_pg(
                    m, pool, pg, acting)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                done = False
            except ErasureCodeError as e:
                self.perf.inc("recovery_errors")
                self.ctx.log.error(
                    "osd", f"peering pg {pool_id}.{pg} codec error: {e}")
                self._release_backoffs((pool_id, pg))
                return
            except Exception as e:
                self.perf.inc("recovery_errors")
                self.ctx.log.error(
                    "osd",
                    f"peering pg {pool_id}.{pg}: {type(e).__name__}: {e}")
                done = False
            # the pass merged the authoritative log (Active or beyond):
            # clients parked on this PG may resend now — their reqids
            # dedupe against the merged log
            if m.state not in (GET_INFO, GET_LOG, GET_MISSING):
                self._release_backoffs((pool_id, pg))
            if done and not m.is_stale(epoch):
                return
            if m.is_stale(epoch):
                delay = self.conf.get("osd_recovery_retry", 1.0)
                continue  # interval advanced: re-peer immediately
            if m.reserve_blocked:
                if getattr(m, "backfill_toofull", False):
                    # a BACKFILLFULL target refused: space frees on the
                    # delete/agent cadence, not the slot cadence — park
                    # longer (liveness: the retry keeps running until
                    # the target drops below its ratio)
                    retry = float(self.conf.get(
                        "osd_backfill_toofull_retry", 1.0) or 1.0)
                    await asyncio.sleep(retry * (0.75 + 0.5
                                                 * random.random()))
                    continue
                # a reservation was refused, not a verification failure:
                # slots free in O(one backfill) — retry quickly, with
                # jitter so colliding primaries don't re-collide forever
                await asyncio.sleep(0.15 + 0.2 * random.random())
                continue
            await asyncio.sleep(delay)
            delay = min(delay * 1.6, 15.0)

    async def _peer_and_recover_pg(self, m: PGMachine, pool: PoolInfo,
                                   pg: int, acting: List[int],
                                   force_backfill: bool = False,
                                   reset_interval: bool = False,
                                   ) -> Tuple[bool, int]:
        """One full statechart pass for one PG.  Returns (clean, pushed):
        clean=True when the PG reached Clean (or needed nothing) this
        interval.  ``force_backfill`` runs the copy sweep even when the
        logs agree — the admin repair path uses it to catch silently-lost
        shards the logs cannot see.  ``reset_interval`` applies
        new_interval under the machine lock (admin repair must not mutate
        statechart state while the event-driven task is mid-pass)."""
        async with m.lock:
            if reset_interval:
                m.new_interval(self.osdmap.epoch, acting)
            return await self._peer_and_recover_pg_locked(
                m, pool, pg, acting, force_backfill)

    async def _peer_and_recover_pg_locked(
        self, m: PGMachine, pool: PoolInfo, pg: int,
        acting: List[int], force_backfill: bool = False,
    ) -> Tuple[bool, int]:
        epoch = m.interval_epoch
        key = (pool.pool_id, pg)
        log = self._pglog(pool.pool_id, pg)
        pushed = 0
        if self.ctx.log.wants("osd", 10):
            # guarded: peering passes are frequent under thrash, and the
            # whole point of debug_osd 10 is turning THIS on at runtime
            self.ctx.dout("osd", 10,
                          f"peering pg {pool.pool_id}.{pg:x} pass start: "
                          f"epoch {epoch} acting {acting} "
                          f"log head {log.head}")
        # -- GetInfo: every acting peer's last_update ------------------------
        m.transition(GET_INFO)
        infos, backfill = await self._peer_pg(pool, pg, acting)
        if m.is_stale(epoch):
            return False, pushed
        m.peer_info = dict(infos)
        # an acting member that did not answer GetInfo (lost frame, boot
        # race) is INVISIBLE, not absent: we cannot know what it lacks, so
        # the pass can neither skip it nor declare Clean — route it through
        # backfill (whose holdings listing retries it) and verify later
        live_acting = {a for a in acting if a != CRUSH_ITEM_NONE}
        if not live_acting <= set(infos):
            backfill = True
        # -- GetLog: adopt from peers AHEAD of us ----------------------------
        m.transition(GET_LOG)
        pulled = await self._pull_log_from_ahead(pool, pg, infos, log)
        backfill |= pulled
        if m.is_stale(epoch):
            return False, pushed
        # -- GetMissing: per-peer missing sets from the log ------------------
        m.transition(GET_MISSING)
        m.missing = {}
        for osd, last in infos.items():
            if osd == self.osd_id or last >= log.head:
                continue
            miss = log.calc_missing(last)
            if miss is None:
                backfill = True  # log window can't bridge: needs backfill
            elif miss:
                m.missing[osd] = miss
        # -- Active ----------------------------------------------------------
        m.transition(ACTIVE)
        if m.missing:
            m.transition(RECOVERING)
            got_slot = await self._local_reserver.acquire(
                key, priority=1, timeout=10.0)
            try:
                if m.is_stale(epoch):
                    return False, pushed
                pushed += await self._push_missing(pool, pg, acting, m.missing,
                                                   log)
            finally:
                if got_slot:
                    self._local_reserver.release(key)
            # an interval change mid-push may have reset the statechart
            # to GetInfo under us (new_interval runs lock-free from
            # _kick_peering; only m.task is cancelled, and THIS pass may
            # be the repair/admin one) — never transition out of a dead
            # interval
            if m.is_stale(epoch):
                return False, pushed
            m.transition(ACTIVE)
        if m.is_stale(epoch):
            return False, pushed
        # an active override means the crush up-set still needs filling —
        # the override primary (us) drives that backfill even though its
        # own acting peers are all caught up
        backfill |= bool(self.osdmap.pg_temp.get(key)) or force_backfill
        # the mapping changed since this PG was last clean: a surviving
        # member may have MOVED POSITION (it holds shard i, now serves
        # shard j) — its log is current, so log recovery skips it, but its
        # data is wrong for its seat.  Only the backfill sweep compares
        # data-at-position; run it until a verified-clean pass pops the
        # interval record.  _past_members forces the sweep for the same
        # reason even after _prior_acting was popped (pg_temp clearing
        # pops it): a LEAVER of the interval (an out/reweighted-away
        # member) may still hold strays, and only the sweep's listing
        # sees and purges them — without this, the pass after a pg_temp
        # clear would skip straight to Clean and strand the leaver's
        # shards forever.
        backfill |= key in self._prior_acting
        backfill |= key in self._past_members
        covered = True
        if backfill:
            await self._maybe_request_pg_temp(pool, pg, acting)
            if m.is_stale(epoch):
                # installing the override changed the mapping: the next
                # round (as override primary, possibly another OSD) drives
                # the backfill
                return False, pushed
            ran, bf_pushed, covered = await self._reserved_backfill(
                m, pool, pg)
            pushed += bf_pushed
            if not ran or m.is_stale(epoch):
                return False, pushed
        # -- Clean -----------------------------------------------------------
        # Clean requires a VERIFIED no-op pass: pushes are fire-and-forget,
        # so a pass that pushed anything (or saw an unanswered peer, or
        # found uncovered up-set positions) only made progress — the retry
        # loop re-peers and Clean is declared when a full pass finds
        # nothing left to do.  Declaring Clean optimistically would drop
        # the interval history (_past_members) while data is still in
        # flight, and the next failure could land before it ever arrived.
        if pushed or not covered:
            return False, pushed
        if self.osdmap.pg_temp.get(key):
            await self._clear_done_pg_temps(pool, pushed, None)
            if self.osdmap.pg_temp.get(key):
                return False, pushed  # override still serving: not clean
        if m.is_stale(epoch):
            return False, pushed  # interval moved while we verified
        m.transition(CLEAN)
        self._past_members.pop(key, None)
        self._prior_acting.pop(key, None)
        return True, pushed

    async def _pull_log_from_ahead(self, pool: PoolInfo, pg: int,
                                   infos: Dict[int, Tuple[int, int]],
                                   log: PGLog) -> bool:
        """GetLog role: pull entries from the furthest-ahead peer and adopt
        them (with divergent-entry rollback).  Returns True when objects
        were adopted (their shards need resync = backfill)."""
        ahead = [(osd, v) for osd, v in infos.items() if v > log.head]
        adopted = False
        for osd, _v in sorted(ahead, key=lambda t: t[1], reverse=True)[:1]:
            tid = uuid.uuid4().hex
            q = self._collector(tid)
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MPGLogReq(pool_id=pool.pool_id, pg=pg, since=log.head,
                              tid=tid, reply_to=self.addr))
            except TRANSPORT_ERRORS:
                continue
            for r in await self._gather(tid, q, 1, timeout=0.8):
                if r.backfill:
                    adopted = True
                    continue
                entries = []
                for blob in r.entries:
                    e = LogEntry.decode(blob)
                    e.version = tuple(e.version)
                    e.prior_version = tuple(e.prior_version)
                    entries.append(e)
                merged = await self._merge_log_entries(pool.pool_id, pg,
                                                       entries)
                if merged:
                    adopted = True
        return adopted

    async def _push_missing(self, pool: PoolInfo, pg: int,
                            acting: List[int],
                            missing: Dict[int, Dict[str, LogEntry]],
                            log: PGLog) -> int:
        """Recovering role: push exactly the objects each lagging peer's
        log says it lacks (missing-set-scoped, reference PGLog missing),
        then advance the peer's log."""
        pushed = 0
        for osd, miss in missing.items():
            shard_of_peer = None
            for shard, a in enumerate(acting):
                if a == osd:
                    shard_of_peer = shard
                    break
            for oid, entry in miss.items():
                # log-driven recovery is classed work too: each push
                # waits its CLASS_RECOVERY dmClock turn
                await self._background_throttle(
                    CLASS_RECOVERY, (pool.pool_id << 20) | pg)
                if entry.op == "delete":
                    try:
                        await self.messenger.send(
                            self.osdmap.addr_of(osd),
                            MECSubDelete(pool_id=pool.pool_id, pg=pg, oid=oid,
                                         shard=-1, tid="", reply_to=self.addr))
                        pushed += 1
                    except TRANSPORT_ERRORS:
                        pass
                    continue
                if shard_of_peer is None:
                    continue
                read = await self._do_read(
                    MOSDOp(op="read", pool_id=pool.pool_id, oid=oid))
                if not read.ok:
                    continue
                encoded = await self._encode_for(
                    pool, as_bytes(read.data), oid=oid, version=read.version)
                push = MPushShard(
                    pool_id=pool.pool_id, pg=pg, oid=oid, shard=shard_of_peer,
                    chunk=bytes(encoded[shard_of_peer]), version=read.version,
                    object_size=len(read.data),
                    hinfo=self._hinfo_for(pool, encoded))
                try:
                    await self.messenger.send(self.osdmap.addr_of(osd), push)
                    pushed += 1
                    self._note_backfill_push(len(push.chunk),
                                             rebalance=False)
                except TRANSPORT_ERRORS:
                    pass
            # the peer now holds the objects: advance its log so the next
            # GetInfo round sees it caught up (and its dup set learns the
            # replayed reqids)
            last = self._machine(pool.pool_id, pg).peer_info.get(osd)
            delta = log.entries_after(last) if last is not None else None
            if delta:
                await self._push_log_to_peer(pool.pool_id, pg, osd, delta)
        return pushed

    async def _reserved_backfill(self, m: PGMachine, pool: PoolInfo,
                                 pg: int) -> Tuple[bool, int, bool]:
        """Backfill under reservations: take a local slot, then a remote
        slot on every backfill target, run the per-PG scoped copy sweep,
        release everything.  Returns (ran, shards_pushed, fully_covered)."""
        key = (pool.pool_id, pg)
        epoch = m.interval_epoch
        m.reserve_blocked = False
        # a degraded PG (holes in the acting set) recovers redundancy, not
        # placement: it outranks plain rebalancing in the slot queues
        # (reference recovery-vs-backfill priority)
        degraded = any(a == CRUSH_ITEM_NONE
                       for a in self.osdmap.pg_to_acting(pool, pg))
        m.transition(WAIT_LOCAL_RESERVE)
        if not await self._local_reserver.acquire(
                key, priority=2 if degraded else 0, timeout=15.0):
            # the acquire waited: an interval change may have reset the
            # statechart to GetInfo lock-free underneath this pass —
            # transitions out of a dead interval are illegal
            if not m.is_stale(epoch):
                m.transition(ACTIVE)
            m.reserve_blocked = True
            return False, 0, False
        targets: List[int] = []
        granted: List[int] = []
        try:
            if m.is_stale(epoch):
                return False, 0, False
            m.transition(WAIT_REMOTE_RESERVE)
            targets = sorted({
                osd for osd in self._raw_up(pool, pg)
                if osd != CRUSH_ITEM_NONE and osd != self.osd_id
            })
            m.backfill_targets = targets
            # DEGRADED PGs skip remote reservations entirely: restoring
            # redundancy is the one thing reservations must never delay
            # (the reference throttles backfill, not degraded recovery —
            # partial-grant livelock here would leave objects one failure
            # from loss while primaries politely retry)
            if not degraded:
                toofull = False
                for osd in targets:
                    ok, reason = await self._remote_reserve(
                        pool.pool_id, pg, osd)
                    if ok:
                        granted.append(osd)
                    elif reason == "toofull":
                        toofull = True
                if m.is_stale(epoch):
                    return False, 0, False
                if len(granted) < len(targets):
                    # partial grant: back off rather than hog slots.
                    # A toofull refusal parks the PG as
                    # backfill_toofull (surfaced in health detail);
                    # the retry loop re-requests with backoff and the
                    # reservation succeeds once the target frees space.
                    m.transition(ACTIVE)
                    m.reserve_blocked = True
                    m.backfill_toofull = toofull
                    return False, 0, False
            m.backfill_toofull = False
            m.transition(BACKFILLING)
            # renew remote leases while the sweep runs: grant times refresh
            # on re-request, so only holders that actually died (and can't
            # renew) age past osd_backfill_reserve_lease and get expired
            lease = self._reserve_lease()

            async def _renew_leases() -> None:
                while True:
                    await asyncio.sleep(max(lease / 3.0, 0.5))
                    for osd in granted:
                        await self._remote_reserve(pool.pool_id, pg, osd)

            renewer = (asyncio.get_running_loop().create_task(_renew_leases())
                       if granted else None)
            try:
                pushed, _holdings, covered = await self._backfill_pg(pool, pg)
            finally:
                if renewer is not None:
                    renewer.cancel()
            if m.is_stale(epoch):
                return False, pushed, False
            m.transition(ACTIVE)
            return True, pushed, covered
        finally:
            # local slot first and synchronously: this block can run under
            # task cancellation, and the slot must never leak.
            # _remote_release swallows its own transport errors.
            self._local_reserver.release(key)
            for osd in granted:
                await self._remote_release(pool.pool_id, pg, osd)

    async def _remote_reserve(self, pool_id: int, pg: int,
                              osd: int) -> Tuple[bool, str]:
        """Request one backfill slot on ``osd``: (granted, refusal
        reason).  reason == "toofull" marks a BACKFILLFULL target (the
        caller parks the PG rather than hammering the slot queue)."""
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        try:
            await self.messenger.send(
                self.osdmap.addr_of(osd),
                MBackfillReserve(op="request", pool_id=pool_id, pg=pg,
                                 from_osd=self.osd_id, tid=tid,
                                 reply_to=self.addr))
        except TRANSPORT_ERRORS:
            self._collectors.pop(tid, None)
            return False, ""
        for r in await self._gather(tid, q, 1, timeout=0.8):
            return bool(r.ok), str(getattr(r, "reason", "") or "")
        return False, ""

    async def _remote_release(self, pool_id: int, pg: int, osd: int) -> None:
        try:
            await self.messenger.send(
                self.osdmap.addr_of(osd),
                MBackfillReserve(op="release", pool_id=pool_id, pg=pg,
                                 from_osd=self.osd_id))
        except TRANSPORT_ERRORS:
            pass

    def _handle_sub_rollback(self, msg: MECSubRollback) -> None:
        """Revert one shard to its rollback slot (primary-confirmed the
        newer version is unrecoverable cluster-wide).  With no PREV copy,
        drop the orphaned shard — it can never decode and its version
        guard would hold the seat hostage against restore pushes."""
        key = (msg.pool_id, msg.oid, msg.shard)
        cur = self._store_read(key)
        if cur is None or cur[1].version != msg.bad_version:
            return  # already moved on
        prev_key = (msg.pool_id, msg.oid, msg.shard + PREV_SLOT)
        prev = self._store_read(prev_key)
        txn = Transaction()
        if prev is not None:
            txn.write(key, prev[0], prev[1])
            txn.delete(prev_key)
        else:
            txn.delete(key)
        self._cache_drop(msg.pool_id, msg.oid)
        self.store.queue_transaction(txn)
        self.perf.inc("unfound_reverted")

    async def _handle_backfill_reserve(self, msg: MBackfillReserve) -> None:
        key = (msg.pool_id, msg.pg)
        if msg.op == "release":
            self._remote_reserver.release(key)
            return
        if FULL_SEVERITY[self._my_full_state()] >= \
                FULL_SEVERITY["backfillfull"]:
            # BACKFILLFULL (or worse): refuse the reservation — backfill
            # onto an OSD that cannot hold the data would burn the wire
            # and then fail at the failsafe (reference
            # PeeringState::Active react RemoteBackfillReserved
            # TOO_FULL).  The primary parks the PG backfill_toofull and
            # retries with backoff; renewals for ALREADY-granted slots
            # refuse too, so a sweep racing the threshold stops at the
            # next lease renewal.
            self.perf.inc("backfill_toofull_refusals")
            self.ctx.dout("osd", 2,
                          f"backfill reserve pg {msg.pool_id}.{msg.pg:x} "
                          f"refused: {self._my_full_state()}")
            try:
                await self.messenger.send(
                    tuple(msg.reply_to),
                    MBackfillReserveReply(tid=msg.tid, osd_id=self.osd_id,
                                          ok=False, reason="toofull"))
            except TRANSPORT_ERRORS:
                pass
            return
        was_held = key in self._remote_reserver.held
        if not was_held and len(self._remote_reserver.held) >= \
                self._remote_reserver.slots:
            # all slots taken: expire leases whose grant outlived the
            # reservation lease (a primary that died without releasing —
            # its release message is not retried) so one crashed peer
            # cannot wedge backfill onto this OSD forever
            lease = self._reserve_lease()
            now = time.monotonic()
            self._remote_reserver.revoke_stale(
                lambda _k, g, t: g is None or now - t < lease)
        ok = self._remote_reserver.try_acquire(key, grantee=msg.from_osd)
        try:
            await self.messenger.send(
                tuple(msg.reply_to),
                MBackfillReserveReply(tid=msg.tid, osd_id=self.osd_id, ok=ok))
        except TRANSPORT_ERRORS:
            # only roll back a slot THIS request took: a duplicate request
            # for an already-held key must not free the real holder's slot
            if ok and not was_held:
                self._remote_reserver.release(key)

    def dump_peering(self) -> List[Dict[str, object]]:
        """Admin-socket hook: every PG statechart + reservation state."""
        out = [m.dump() for m in self._pg_machines.values()]
        out.append({"local_reserver": self._local_reserver.dump(),
                    "remote_reserver": self._remote_reserver.dump()})
        return out

    # -- sub-op RPC plumbing -------------------------------------------------

    def _collector(self, tid: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._collectors[tid] = q
        return q

    async def _gather(self, tid: str, q: asyncio.Queue, expected: int, timeout: float = 5.0):
        out = []
        try:
            for _ in range(expected):
                out.append(await asyncio.wait_for(q.get(), timeout=timeout))
        except asyncio.TimeoutError:
            pass
        finally:
            self._collectors.pop(tid, None)
        return out

    # -- client ops (primary) ------------------------------------------------

    def _store_read(self, key):
        """store.read with EIO absorbed to a missing-shard result: a bad
        local shard must degrade, never crash, the op (EIO handling the
        reference tests via bluestore read-error injection)."""
        try:
            return self.store.read(key)
        except IOError:
            return None

    # -- PG log --------------------------------------------------------------

    @staticmethod
    def _pgmeta_key(pool_id: int, pg: int) -> Tuple[int, str, int]:
        return (pool_id, f"{PGMETA_PREFIX}{pg}", -1)

    def _pglog(self, pool_id: int, pg: int) -> PGLog:
        log = self._pglogs.get((pool_id, pg))
        if log is None:
            omap = {}
            try:
                omap = self.store.omap_get(self._pgmeta_key(pool_id, pg))
            except (IOError, OSError):
                pass  # unreadable pgmeta: start a fresh log (redo covers)
            maxe = int(self.conf.get("osd_min_pg_log_entries", 500) or 500)
            log = PGLog.load(omap, max_entries=maxe) if omap \
                else PGLog(max_entries=maxe)
            self._pglogs[(pool_id, pg)] = log
        return log

    def _log_in_txn(self, txn: Transaction, pool_id: int, pg: int,
                    entry: LogEntry) -> None:
        """Append to the in-memory log and persist the entry in the SAME
        transaction as the data (reference log_operation +
        queue_transactions coupling)."""
        log = self._pglog(pool_id, pg)
        if entry.version <= log.head:
            return  # replayed/duplicate entry
        trimmed = log.append(entry)
        key = self._pgmeta_key(pool_id, pg)
        txn.omap_set(key, log.omap_entries(entry))
        if trimmed:
            txn.omap_rm(key, trimmed)

    def _list_pool_objects(self, pool_id: int):
        """list_objects minus PG metadata objects and rollback slots."""
        for oid, shard in self.store.list_objects(pool_id):
            if not oid.startswith(PGMETA_PREFIX) and shard < PREV_SLOT:
                yield oid, shard

    # -- extent cache (primary-side RMW pinning) ------------------------------

    def _cache_put(self, pool_id: int, oid: str, version: int,
                   data: bytes) -> None:
        self._extent_cache.put_full((pool_id, oid), version, data)

    def _cache_get(self, pool_id: int, oid: str) -> Optional[Tuple[int, bytes]]:
        return self._extent_cache.get_full((pool_id, oid))

    def _cache_drop(self, pool_id: int, oid: str) -> None:
        self._extent_cache.drop((pool_id, oid))
        if self._planar is not None:
            # force past the dirty guard: every _cache_drop site is a
            # delete, a pool purge, or failed-write cleanup — the data
            # the dirty pages were protecting is itself going away (or
            # was never acked), so flush-before-evict does not apply
            self._planar.drop(self._planar_key(pool_id, oid), force=True)

    def _planar_key(self, pool_id: int, oid: str):
        # namespaced per OSD: in-process clusters share one store/budget
        return (self.osd_id, pool_id, oid)

    def _paged_store(self):
        """The shared resident store WHEN it is the paged flavor (dirty
        tracking / page table / writeback live only there); None under
        the monolithic r10 store or no store at all."""
        s = self._planar
        return s if (s is not None and hasattr(s, "dirty_items")) else None

    def _purge_pool(self, pool_id: int) -> None:
        """Delete every locally stored object of a pool removed from the
        map (reference PG deletion): data shards, rollback slots, PG
        logs, and cache residents all go."""
        txn = Transaction()
        seen = set()
        try:
            for oid, shard in self.store.list_objects(pool_id):
                txn.delete((pool_id, oid, shard))
                seen.add(oid)
        except NotImplementedError:
            return
        if txn.deletes:
            self.store.queue_transaction(txn)
        for oid in seen:
            self._cache_drop(pool_id, snap_head(oid))
        for key in [k for k in self._pglogs if k[0] == pool_id]:
            del self._pglogs[key]
        for d in (self._past_members, self._prior_acting, self._hit_sets,
                  self._hit_set_epochs):
            for k in [k for k in d if k[0] == pool_id]:
                d.pop(k, None)
        self.tier_perf.set("hit_sets", len(self._hit_sets))
        self.perf.inc("pools_purged")

    def _mark_failed_write(self, reqid: str) -> None:
        if reqid:
            self._failed_writes.add(reqid)
            while len(self._failed_writes) > 1024:
                self._failed_writes.pop()

    def _pg_key_of(self, op: MOSDOp) -> int:
        if self.osdmap is None:
            return 0
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return op.pool_id
        return (op.pool_id << 20) | self.osdmap.object_to_pg(pool, op.oid)

    def _primary_spread(self, pool: PoolInfo) -> int:
        """Distinct primaries across ``pool``'s PGs under the current
        map (qos.primary_spread), memoized per epoch — the cross-OSD
        QoS normalization divisor resolved on every client op."""
        epoch = self.osdmap.epoch if self.osdmap else 0
        memo_epoch, by_pool = self._spread_memo
        if memo_epoch != epoch:
            by_pool = {}
            self._spread_memo = (epoch, by_pool)
        spread = by_pool.get(pool.pool_id)
        if spread is None:
            spread = by_pool[pool.pool_id] = primary_spread(
                self.osdmap, pool)
        return spread

    async def _background_throttle(self, op_class: str, pg_key: int,
                                   cost: int = 1) -> None:
        """One unit of background work (a scrub'd object, a backfill
        push) waits its dmClock turn in the sharded op queue under its
        background class (reference: recovery/scrub ops ride the op
        queue with osd_mclock_profile service classes).  The waiter
        carries NO order_key — background sweeps need scheduling
        arbitration against client ops, not the per-PG ordering chain
        (chaining onto a PG's client tail from inside a long-running
        sweep could deadlock the sweep against its own queue slot).
        Under mClock the class's (r, w, l, burst) profile shapes when
        the slot is granted; an idle OSD grants immediately through the
        work-conserving fallback.  WPQ arbitrates by class priority.
        No-op when osd_background_qos is off or the OSD is stopping."""
        if self._stopped or not self.conf.get("osd_background_qos", True):
            return
        fut = asyncio.get_running_loop().create_future()

        async def _granted() -> None:
            if not fut.done():
                fut.set_result(None)

        await self.op_queue.enqueue(pg_key, _granted, op_class=op_class,
                                    cost=max(1, cost), ordered=False)
        await fut

    def _track_client_op(self, op: MOSDOp):
        """TrackedOp + trace span for one arriving client op.  The span
        joins the client's propagated trace context when one rode the
        wire (ms_trace_propagation), else roots a fresh trace; the
        TrackedOp carries it so the asok timeline and the stitched span
        tree name the same op.  Attached as a private attribute — resends
        overwrite it, and the attribute never rides a wire encode (fixed
        layouts enumerate FIXED_FIELDS; the only pickled MOSDOp variant,
        `multi`, is deep-copied by the local fastpath before delivery)."""
        prev = getattr(op, "_tracked", None)
        if prev is not None and prev.done_at is None:
            # a resend/duplicate delivery of the SAME op object (local
            # fastpath hands by reference) displaces the prior record:
            # finish it (and its span — spans only record on finish) so
            # neither can dangle forever
            if prev.trace is not None:
                prev.trace.finish()
            prev.finish()
        t_tid = getattr(op, "trace_id", "")
        if t_tid:
            span = self.ctx.tracer.join(f"osd_op {op.op}", t_tid,
                                        getattr(op, "span_id", "") or None)
        else:
            span = self.ctx.tracer.new_trace(f"osd_op {op.op}")
        span.tag("osd", self.osd_id)
        if op.reqid:
            span.tag("reqid", op.reqid)
        tracked = self.ctx.op_tracker.create(
            f"osd_op({op.op} {op.pool_id}:{op.oid})", reqid=op.reqid,
            trace=span)
        # tenant-class tag: phase samples also land in per-class rings
        # ("cls:<name>|<phase>") so the macro bench can reduce
        # per-tenant-class p50/p99/p999 from the same optracker path.
        # "|" is the ring-key separator and the client name is
        # wire-controlled: sanitize so a crafted name cannot mislabel
        # the per-class reduction
        tracked.qos_tag = tenant_class(
            getattr(op, "client", "")).replace("|", "_")
        if op.op == "notify":
            # a notify legitimately parks for its whole watcher-ack
            # gather window — aging it would raise SLOW_OPS on every
            # notify with one sluggish watcher
            tracked.complaint_ok = False
        tracked.mark_event("queued_for_pg")
        op._tracked = tracked
        return tracked

    async def _handle_client_op(self, conn, op: MOSDOp) -> None:
        tracked = getattr(op, "_tracked", None)
        if tracked is None or tracked.done_at is not None:
            tracked = self._track_client_op(op)
        t0 = time.monotonic()
        self.perf.inc("op")
        if op.op == "write":
            self.perf.inc("op_w")
        elif op.op == "read":
            self.perf.inc("op_r")
        try:
            await self._handle_client_op_inner(conn, op, tracked)
        finally:
            self.perf.tinc("op_lat", time.monotonic() - t0)
            if tracked.trace is not None:
                tracked.trace.finish()
            tracked.mark_event("done")
            tracked.finish()

    # ops the backoff gate may drop-and-block (client data plane; admin
    # fan-outs like repair/deep-scrub/pgls answer normally)
    _BACKOFF_OPS = frozenset(("write", "read", "delete", "multi", "stat",
                              "call"))
    # mutations gated by the peering-window check (reads can serve from
    # any interval; mutations must not race the authoritative log merge).
    # "call" belongs here: class-call results dedupe through the
    # primary-LOCAL _call_results cache, so a failover resend racing the
    # prior primary is exactly the non-idempotent double-execute window.
    _BACKOFF_MUTATIONS = frozenset(("write", "delete", "multi", "call"))

    async def _maybe_shed_queue(self, conn, op: MOSDOp) -> bool:
        """Arrival-side saturation shed (the "queue" backoff reason):
        when admitted-but-unfinished ops exceed osd_backoff_queue_depth
        (0 disables; under per-PG chaining an overload lives in RUNNING
        chains, not the scheduler queue, so raw depth() would never see
        it), the arriving op is dropped and its client blocked for a
        short timed window via MOSDBackoff.  The shed is QoS-DIRECTED
        when client identities are in play: if any client's OFFERED rate
        is past its limit (qos.QosTracker), only over-limit clients' ops
        are shed — the flooder parks while the reserved tenant keeps
        being admitted; with nobody over limit the legacy
        shed-the-arrival behavior applies.  Returns True when the op was
        dropped."""
        if self.osdmap is None or op.op not in self._BACKOFF_OPS:
            return False
        if op.op == "delete" or (op.op == "multi"
                                 and is_delete_only_multi(op)):
            # deletes thread through every gate (pausewr, the full
            # check, AND this shed): under capacity pressure they are
            # the only way out, and a saturated-because-full OSD
            # shedding its deletes would deadlock the drain
            return False
        qmax = int(self.conf.get("osd_backoff_queue_depth", 0) or 0)
        if not qmax or self.op_queue.inflight_ops <= qmax:
            return False
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None or not op.oid:
            return False
        shed, qos_directed = self.qos.should_shed(
            getattr(op, "client", ""),
            float(self.conf.get("osd_qos_shed_grace", 0.25) or 0.0))
        if not shed:
            # an over-limit client exists and it is not this one: admit
            # (the flooder eats the shed at its own next arrival)
            return False
        if qos_directed:
            self.sched_perf.inc("qos_shed")
        pg = self.osdmap.object_to_pg(pool, op.oid)
        self.ctx.dout(
            "osd", 2,
            f"qos shed {'directed' if qos_directed else 'legacy'}: "
            f"client={getattr(op, 'client', '')!r} op={op.op} "
            f"pg={op.pool_id}.{pg:x} inflight={self.op_queue.inflight_ops}")
        await self._send_queue_block(conn, (op.pool_id, pg), op)
        return True

    async def _send_queue_block(self, conn, key: Tuple[int, int],
                                op: MOSDOp) -> None:
        """Send the timed MOSDBackoff block for a queue-saturation shed
        (expiry-released: the client resends after osd_backoff_secs)."""
        self.perf.inc("backoffs_sent")
        tracked = getattr(op, "_tracked", None)
        b_tid = b_sid = ""
        if self._trace_on and tracked is not None \
                and tracked.trace is not None:
            b_tid, b_sid = tracked.trace.context()
        msg = MOSDBackoff(
            op="block", pool_id=key[0], pg=key[1], id=uuid.uuid4().hex,
            epoch=self.osdmap.epoch,
            duration=float(self.conf.get("osd_backoff_secs", 0.5) or 0.5),
            trace_id=b_tid, span_id=b_sid)
        try:
            await conn.send(msg)
        except TRANSPORT_ERRORS:
            pass  # op dropped either way; client times out + resends

    def _op_backoff_reason(self, op: MOSDOp) -> Optional[Tuple[Tuple[int, int], str]]:
        """((pool, pg), reason) when this op must be BLOCKED via
        MOSDBackoff instead of served (reference PrimaryLogPG
        maybe_handle_backoff / the waiting_for_peered queue):

        - "peering": a mutation while the PG's peering pass has not yet
          merged the authoritative log AND the window is actually unsafe
          — the interval moved primaryship onto us (a resend racing the
          prior primary's in-flight sub-writes could double-execute its
          reqid) or the PG is below min_size (the write would only burn
          EAGAIN retries).  Healthy same-primary intervals (pool create,
          rebalance without failover) serve ops as before.

        (The "queue" saturation shed moved to the ARRIVAL side —
        _maybe_shed_queue — so a saturated OSD drops before the op
        consumes a queue slot.)
        """
        if self.osdmap is None or op.op not in self._BACKOFF_OPS:
            return None
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None or not op.oid:
            return None
        pg = self.osdmap.object_to_pg(pool, op.oid)
        key = (op.pool_id, pg)
        if op.op not in self._BACKOFF_MUTATIONS:
            return None
        m = self._pg_machines.get(key)
        if m is None or m.task is None or m.task.done() \
                or m.state not in (GET_INFO, GET_LOG, GET_MISSING):
            return None
        acting = self.osdmap.pg_to_acting(pool, pg)
        live = [a for a in acting if a != CRUSH_ITEM_NONE]
        prior = self._prior_acting.get(key)
        failover = prior is not None and self.osdmap.primary_of(
            prior, seed=(op.pool_id << 20) | pg) != self.osd_id
        if len(live) < pool.min_size or failover:
            return key, "peering"
        return None

    async def _maybe_backoff(self, conn, op: MOSDOp) -> bool:
        """Send an MOSDBackoff block and DROP the op when the PG's
        peering window cannot serve it right now; returns True when the
        op was dropped.  The client parks everything for the PG until
        the unblock (the conn registers for release) or until
        ``duration`` expires (the liveness bound for a dying primary).
        Queue-saturation sheds live on the arrival side
        (_maybe_shed_queue)."""
        got = self._op_backoff_reason(op)
        if got is None:
            return False
        key, reason = got
        ent = self._backoffs_sent.get(key)
        bid = ent["id"] if ent is not None else uuid.uuid4().hex
        duration = float(self.conf.get("osd_backoff_max", 3.0) or 3.0)
        self.perf.inc("backoffs_sent")
        tracked = getattr(op, "_tracked", None)
        b_tid = b_sid = ""
        if self._trace_on and tracked is not None \
                and tracked.trace is not None:
            # the block rides the op's trace: the client sees WHY its op
            # parked inside the same stitched tree
            b_tid, b_sid = tracked.trace.context()
        msg = MOSDBackoff(op="block", pool_id=key[0], pg=key[1], id=bid,
                          epoch=self.osdmap.epoch, duration=duration,
                          trace_id=b_tid, span_id=b_sid)
        try:
            await conn.send(msg)
        except TRANSPORT_ERRORS:
            return True  # op dropped either way; client times out + resends
        if reason == "peering":
            ent = self._backoffs_sent.setdefault(
                key, {"id": bid, "conns": {}})
            ent["conns"][id(conn)] = conn
        return True

    def _release_backoffs(self, key: Tuple[int, int]) -> None:
        """Unblock every client parked on this PG (peering reached
        Active / primaryship moved off us).  Sends ride their own task —
        callers sit on the peering/map path and must not serialize on
        client sockets."""
        ent = self._backoffs_sent.pop(key, None)
        if ent is None or not ent["conns"]:
            return
        self.perf.inc("backoffs_released", len(ent["conns"]))
        msg = MOSDBackoff(op="unblock", pool_id=key[0], pg=key[1],
                          id=ent["id"],
                          epoch=self.osdmap.epoch if self.osdmap else 0)

        async def _send() -> None:
            for c in ent["conns"].values():
                try:
                    await c.send(msg)
                except TRANSPORT_ERRORS:
                    pass  # client's park duration is the liveness bound

        try:
            t = asyncio.get_running_loop().create_task(_send())
        except RuntimeError:
            return  # no loop (teardown): clients release on expiry
        self.messenger._tasks.add(t)
        t.add_done_callback(self.messenger._tasks.discard)

    async def _handle_client_op_inner(self, conn, op: MOSDOp,
                                      tracked) -> None:
        tracked.mark_event("reached_pg")
        try:
            if op.epoch > (self.osdmap.epoch if self.osdmap else 0):
                # epoch barrier (reference require_same_or_newer_map): the
                # client computed its target on a newer map than ours —
                # deciding primaryship on the stale one could execute an
                # op we no longer own.  Catch up first.
                await self._fetch_full_map()
            if await self._maybe_backoff(conn, op):
                tracked.mark_event("backoff")
                return  # dropped: the client parks and resends on release
            full_reply = self._full_block_reply(op)
            if full_reply is not None:
                # fullness gate: typed ENOSPC, definitive at the client
                # (reads and deletes never land here)
                tracked.mark_event("full_reject")
                reply = full_reply
            elif op.op == "write":
                reply = await self._do_write(op)
            elif op.op == "read":
                reply = await self._snap_routed(op, self._do_read)
                if reply.ok and op.snap_read == 0:
                    # tier policy hook: record the hit in the PG's
                    # hit-set archive and maybe promote (client reads
                    # only — internal reads via _do_read must not heat
                    # the working set)
                    self._tier_observe_read(op, reply)
                # byte-COST catch-up for reads: the op carried no
                # payload at arrival (cost observed as 1 IO), but the
                # served bytes are the bandwidth a read hog consumes —
                # charge the admission tracker the byte increment now
                # so a few-large-GETs tenant ranks by its true load
                # (the reference mClock costs reads by length too)
                if reply.ok and reply.data is not None \
                        and getattr(op, "client", ""):
                    nbytes = len(reply.data)
                    if nbytes:
                        pool = self.osdmap.pools.get(op.pool_id) \
                            if self.osdmap else None
                        if pool is not None:
                            params = pool_qos(pool, op.client, self.conf)
                            self.qos.observe(
                                op.client, params,
                                cost=qos_op_cost(nbytes, self.conf) - 1.0)
            elif op.op == "delete":
                reply = await self._do_delete(op)
            elif op.op == "snap-trim":
                reply = await self._do_snap_trim(op)
            elif op.op == "pgls":
                reply = await self._do_pgls(op)
            elif op.op == "list":
                reply = MOSDOpReply(ok=True, oids=[
                    o for o in self._list_heads(op.pool_id)
                    if _ns_match(o, op.nspace)])
            elif op.op == "repair":
                pool = self.osdmap.pools.get(op.pool_id)
                if pool is not None:
                    await self.repair_pool(pool)
                reply = MOSDOpReply(ok=True)
            elif op.op == "call":
                reply = await self._do_call(op)
            elif op.op == "multi":
                reply = await self._do_multi(op)
            elif op.op == "stat":
                reply = await self._snap_routed(op, self._do_stat)
            elif op.op == "watch":
                reply = await self._do_watch(op)
            elif op.op == "unwatch":
                reply = await self._do_watch(op, remove=True)
            elif op.op == "notify":
                reply = await self._do_notify(op)
            elif op.op == "deep-scrub":
                pool = self.osdmap.pools.get(op.pool_id)
                if pool is None:
                    reply = MOSDOpReply(ok=False, code=-errno.ENOENT,
                                        error="no such pool")
                else:
                    summary = await self.deep_scrub_pool(pool)
                    reply = MOSDOpReply(ok=True, data=pickle.dumps(summary))
            elif op.op == "statfs":
                # per-OSD store utilization (reference
                # ObjectStore::statfs feeding `ceph osd df`): every
                # store implements the uniform {total, used, avail,
                # num_objects} shape now (total == 0 = no configured
                # capacity); _statfs asserts it and applies injection
                stats = self._statfs()
                stats["store"] = type(self.store).__name__
                reply = MOSDOpReply(ok=True,
                                    data=json.dumps(stats).encode())
            else:
                reply = MOSDOpReply(ok=False, code=-errno.EINVAL,
                                    error=f"bad op {op.op}")
        except ErasureCodeError as e:
            # the codec REJECTED the operation (unsatisfiable decode,
            # profile violation): deterministic, so definitive
            reply = MOSDOpReply(ok=False, code=-errno.EBADMSG,
                                error=f"ec error: {e}")
        except ENOSPCError as e:
            # the failsafe (OSD-level or the store's own last-resort
            # guard) refused BEFORE mutating anything: typed and
            # definitive — resending into a full store cannot succeed,
            # deleting is the cure
            self.perf.inc("full_rejects")
            reply = MOSDOpReply(ok=False, code=-errno.ENOSPC,
                                error=f"ENOSPC: {e.strerror}")
        except Exception as e:
            # unexpected: conservatively retryable (transient state races
            # dominate here; a true logic bug surfaces in the counter)
            self.perf.inc("op_unexpected_error")
            reply = MOSDOpReply(ok=False, code=-errno.EIO,
                                error=f"{type(e).__name__}: {e}")
        reply.reqid = op.reqid
        # our epoch rides every reply: on retryable errors the client
        # fences its re-target on at least this epoch
        reply.map_epoch = self.osdmap.epoch if self.osdmap else 0
        tracked.mark_event("commit_sent")
        try:
            await conn.send(reply)
        except ConnectionError:
            pass

    def _acting(self, pool: PoolInfo, oid: str) -> Tuple[int, List[int]]:
        pg = self.osdmap.object_to_pg(pool, oid)
        return pg, self.osdmap.pg_to_acting(pool, pg)

    def _primary(self, pool: PoolInfo, pg: int, acting: List[int]):
        return self.osdmap.primary_of(acting, seed=(pool.pool_id << 20) | pg)

    # -- snapshots (reference SnapMapper.h:43, PrimaryLogPG::make_writeable,
    #    librados selfmanaged snap ops IoCtxImpl.cc) --------------------------

    SNAPSET_XATTR = "snapset_key"

    def _load_snapset(self, pool_id: int, oid: str) -> Dict:
        """The object's SnapSet (per-object clone list, reference
        SnapSet in osd_types.h): {"seq", "born", "whiteout",
        "clones": [[clone_id, [snaps...]], ...]}."""
        try:
            raw = self.store.getattr((pool_id, oid, 0), self.SNAPSET_XATTR)
        except (IOError, OSError):
            raw = None
        if not raw:
            return {"seq": 0, "born": 0, "whiteout": False, "clones": []}
        try:
            return json.loads(raw)
        except (ValueError, KeyError, TypeError):
            return {"seq": 0, "born": 0, "whiteout": False, "clones": []}

    async def _save_snapset(self, pool: PoolInfo, pg: int,
                            acting: List[int], oid: str, ss: Dict) -> None:
        """Persist the SnapSet on the head's canonical shard and replicate
        to the acting members (same pattern as cls xattrs: a failover
        primary must resolve snap reads without the old primary)."""
        blob = json.dumps(ss).encode()
        self.store.setattr((pool.pool_id, oid, 0), self.SNAPSET_XATTR, blob)
        for osd in acting:
            if osd in (CRUSH_ITEM_NONE, self.osd_id):
                continue
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MSetXattrs(pool_id=pool.pool_id, oid=oid, shard=0,
                               xattrs={self.SNAPSET_XATTR: blob}))
            except TRANSPORT_ERRORS:
                pass  # recovery pushes carry xattrs; scrub repairs drift

    def _live_snaps(self, pool: PoolInfo, snaps: List[int]) -> List[int]:
        # IntervalSet membership: O(log runs) per id, no materialization
        return [s for s in snaps if s not in pool.removed_snaps]

    async def _make_writeable(self, op: MOSDOp, pool: PoolInfo, pg: int,
                              acting: List[int]) -> Optional[MOSDOpReply]:
        """COW before the first write past a new snap (the reference's
        make_writeable): clone the current head into a clone object
        (placed in the SAME PG — object_to_pg hashes the head name) and
        record it in the SnapSet.  Clone writes ride the normal write
        pipeline, so they are erasure-coded, logged, and recoverable like
        any object.

        Returns an error reply the parent write must surface (and NOT
        proceed past) when snapshot preservation could not be guaranteed;
        None means the write may go ahead.  The born/absent branches fire
        only on VERIFIED absence (typed -ENOENT / whiteout) — a transient
        head-read failure (-EAGAIN degraded, -EIO) on an existing object
        must not skip the COW clone, or the pre-snap bytes are destroyed.
        """
        if is_snap_clone(op.oid) or op.snapc_seq <= 0:
            return None
        snapc = self._live_snaps(pool, op.snapc_snaps)
        ss = self._load_snapset(op.pool_id, op.oid)
        newer = [s for s in snapc if s > ss["seq"]]
        if newer:
            head = await self._do_read(
                MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid))
            if head.ok and not ss.get("whiteout"):
                clone_id = max(newer)
                wr = await self._do_write(MOSDOp(
                    op="write", pool_id=op.pool_id,
                    oid=snap_clone_oid(op.oid, clone_id),
                    data=as_bytes(head.data),
                    reqid=uuid.uuid4().hex))
                if not wr.ok:
                    # the clone did not durably land (below min_size, …):
                    # overwriting the head now would lose the pre-snap
                    # bytes.  Fail the parent write retryably instead.
                    return MOSDOpReply(
                        ok=False, code=-errno.EAGAIN,
                        error=f"snap clone write failed: {wr.error}",
                        backoff=float(
                            self.conf.get("osd_backoff_secs", 0.5) or 0))
                ss["clones"].append([clone_id, sorted(newer)])
            elif head.ok or head.code == -errno.ENOENT:
                # verified absence: whiteout head, or every possible
                # holder answered ENOENT (_absent_reply discipline)
                if not head.ok and ss["seq"] == 0 and not ss["clones"]:
                    # object is being CREATED under this context: snaps at
                    # or before snapc_seq predate it (existence-at-snap)
                    ss["born"] = op.snapc_seq
                else:
                    # the object was ABSENT (whiteout, or vanished) while
                    # these snaps were taken: record that, or recreating
                    # the head would make reads at those snaps serve
                    # FUTURE data
                    absent = ss.setdefault("absent", [])
                    absent.extend(s for s in newer if s not in absent)
            else:
                # transient head-read failure (-EAGAIN, -EIO): existence
                # is UNKNOWN — neither clone nor record absence.  The
                # parent write must back off rather than mutate the head.
                return MOSDOpReply(
                    ok=False, code=-errno.EAGAIN,
                    error=f"snap COW head read failed: {head.error}",
                    backoff=float(
                        self.conf.get("osd_backoff_secs", 0.5) or 0))
        if op.snapc_seq > ss["seq"]:
            ss["seq"] = op.snapc_seq
            ss["whiteout"] = False
            await self._save_snapset(pool, pg, acting, op.oid, ss)
        elif ss.get("whiteout"):
            ss["whiteout"] = False
            await self._save_snapset(pool, pg, acting, op.oid, ss)
        return None

    def _resolve_snap_read(self, pool: PoolInfo, oid: str,
                           snap: int) -> Optional[str]:
        """Which object serves a read at `snap`: the covering clone, the
        (unchanged-since) head, or None for ENOENT (removed snap, or the
        object did not exist at that snap)."""
        if snap in pool.removed_snaps:
            return None
        ss = self._load_snapset(pool.pool_id, oid)
        if 0 < snap <= ss.get("born", 0):
            return None  # created after the snapshot
        if snap in ss.get("absent", ()):
            return None  # object was deleted while this snap was taken
        removed = pool.removed_snaps
        for clone_id, snaps in sorted(ss["clones"]):
            live = [s for s in snaps if s not in removed]
            if live and clone_id >= snap:
                # first clone at-or-past the snap holds the bytes as they
                # were WHEN that snap was live (reference clone coverage)
                return snap_clone_oid(oid, clone_id)
        if ss.get("whiteout"):
            return None  # deleted after the last clone: gone at this snap
        return oid  # unchanged since the snap: the head serves

    async def _snap_routed(self, op: MOSDOp, handler) -> MOSDOpReply:
        """Route a read/stat through snap resolution when snap_read is
        set; a whiteout head answers ENOENT even for head reads."""
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error="no such pool")
        snap = getattr(op, "snap_read", 0)
        if snap > 0 and not is_snap_clone(op.oid):
            target = self._resolve_snap_read(pool, op.oid, snap)
            if target is None:
                return MOSDOpReply(ok=False, code=-errno.ENOENT,
                                   error="object not found (at snap)")
            if target != op.oid:
                routed = MOSDOp(op=op.op, pool_id=op.pool_id, oid=target,
                                reqid=op.reqid)
                return await handler(routed)
        elif not is_snap_clone(op.oid):
            ss = self._load_snapset(op.pool_id, op.oid)
            if ss.get("whiteout"):
                return MOSDOpReply(ok=False, code=-errno.ENOENT,
                                   error="object not found")
        return await handler(op)

    async def _do_pgls(self, op: MOSDOp) -> MOSDOpReply:
        """Paginated listing of ONE PG's objects (reference do_pgnls,
        PrimaryLogPG.cc): the primary answers from its local shards —
        after backfill it holds a shard of every object in the PG — so
        admin listings fan out to per-PG primaries and page, instead of
        broadcasting to every OSD.  Returns up to max_entries heads past
        `cursor`, plus the resume cursor ("" when exhausted)."""
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error="no such pool")
        pg = op.pg
        acting = self.osdmap.pg_to_acting(pool, pg)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        limit = op.max_entries or 512
        heads = sorted({
            snap_head(oid)
            for oid, _ in self._list_pool_objects(op.pool_id)
            if self.osdmap.object_to_pg(pool, oid) == pg
        })
        out: List[str] = []
        for oid in heads:
            if op.cursor and oid <= op.cursor:
                continue
            if is_snap_clone(oid):
                continue
            if not _ns_match(oid, op.nspace):
                continue
            if self._load_snapset(op.pool_id, oid).get("whiteout"):
                continue
            out.append(oid)
            if len(out) >= limit:
                break
        exhausted = not out or out[-1] == (heads[-1] if heads else "")
        return MOSDOpReply(ok=True, oids=out,
                           cursor="" if exhausted else out[-1])

    def _list_heads(self, pool_id: int) -> List[str]:
        """User-visible listing: heads only — no clones, no whiteouts."""
        out = []
        for oid in sorted({oid for oid, _ in
                           self._list_pool_objects(pool_id)}):
            if is_snap_clone(oid):
                continue
            if self._load_snapset(pool_id, oid).get("whiteout"):
                continue
            out.append(oid)
        return out

    async def _do_snap_trim(self, op: MOSDOp) -> MOSDOpReply:
        """Remove one snap pool-wide for the PGs this OSD leads
        (reference snap trimmer + SnapMapper reverse index; here the
        per-PG object walk is the scoped listing already used by
        backfill).  Idempotent — safe to re-run."""
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error="no such pool")
        snapid = op.snap_id
        trimmed = 0
        heads = {snap_head(oid)
                 for oid, _ in self._list_pool_objects(op.pool_id)}
        for oid in sorted(heads):
            pg, acting = self._acting(pool, oid)
            if self._primary(pool, pg, acting) != self.osd_id:
                continue
            ss = self._load_snapset(op.pool_id, oid)
            if (not ss["clones"] and not ss.get("whiteout")
                    and snapid not in ss.get("absent", ())):
                continue
            changed = False
            if snapid in ss.get("absent", ()):
                ss["absent"] = [s for s in ss["absent"] if s != snapid]
                changed = True
            kept = []
            for clone_id, snaps in ss["clones"]:
                live = [s for s in snaps if s != snapid]
                if live != snaps:
                    changed = True
                if live:
                    kept.append([clone_id, live])
                else:
                    # no snap references the clone: delete it
                    await self._do_delete(MOSDOp(
                        op="delete", pool_id=op.pool_id,
                        oid=snap_clone_oid(oid, clone_id),
                        reqid=uuid.uuid4().hex))
                    trimmed += 1
                    changed = True
            ss["clones"] = kept
            if ss.get("whiteout") and not kept:
                # a deleted head whose last clone just went: fully gone.
                # Persist the emptied clone list FIRST so the delete path
                # (which re-reads the SnapSet) takes the real-delete
                # branch instead of re-whiteouting.
                await self._save_snapset(pool, pg, acting, oid, ss)
                await self._do_delete(MOSDOp(
                    op="delete", pool_id=op.pool_id, oid=oid,
                    reqid=uuid.uuid4().hex))
                trimmed += 1
                continue
            if changed:
                await self._save_snapset(pool, pg, acting, oid, ss)
        return MOSDOpReply(ok=True, data=str(trimmed).encode())

    async def _do_write(self, op: MOSDOp) -> MOSDOpReply:
        pool = self.osdmap.pools[op.pool_id]
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        live = [a for a in acting if a != CRUSH_ITEM_NONE]
        if len(live) < pool.min_size:
            return MOSDOpReply(
                ok=False, code=-errno.EAGAIN,
                error=f"degraded below min_size ({len(live)}/{pool.min_size})",
                backoff=float(self.conf.get("osd_backoff_secs", 0.5) or 0),
            )
        log = self._pglog(op.pool_id, pg)
        if log.has_reqid(op.reqid) and op.reqid not in self._failed_writes:
            # client resend of an op we already applied (pg log dups role)
            return MOSDOpReply(ok=True)
        self._failed_writes.discard(op.reqid)
        if op.offset >= 0 and not op.data:
            return MOSDOpReply(ok=True)  # zero-length overwrite: no-op
        cow_err = await self._make_writeable(op, pool, pg, acting)
        if cow_err is not None:
            return cow_err
        if pool.pool_type != "ec":
            return await self._do_write_replicated(op, pool, pg, acting)
        codec = self._codec(pool)
        sinfo = self._sinfo(pool)
        n = codec.get_chunk_count()
        tracked = getattr(op, "_tracked", None)
        parent = tracked.trace if tracked is not None else None
        # the EC pipeline span is a CHILD of the op span (which itself
        # joined the client's trace): the whole write renders as one tree
        span = (parent.child("ec write") if parent is not None
                else self.ctx.tracer.new_trace("ec write"))
        span.event("start ec write")

        def mark(event: str) -> None:
            if tracked is not None:
                tracked.mark_event(event)
        # splice plan: chunk_off >= 0 means each shard splices `blobs[shard]`
        # into its stored blob at chunk_off (per-stripe RMW, the reference's
        # write plan ECTransaction.cc:37-95); -1 replaces the whole blob
        data = op.data
        chunk_off = -1
        shard_size = 0
        base_version = 0
        object_size = len(op.data)
        full_for_cache: Optional[bytes] = bytes(op.data)
        if op.offset >= 0:
            span.event("rmw read")
            mark("rmw_read")
            # writeback fence: a partial overwrite splices against the
            # STORED shard blobs, and a dirty resident means the stored
            # local shard is behind the acked bytes — flush it first so
            # the splice precondition (prior_version match) composes
            # with reality instead of degrading every RMW to a full
            # rewrite
            _ps = self._paged_store()
            if _ps is not None \
                    and _ps.is_dirty(self._planar_key(op.pool_id, op.oid)):
                if await self._tier_flush_any(
                        self._planar_key(op.pool_id, op.oid)):
                    self.tier_perf.inc("flush_rmw")
                else:
                    self.tier_perf.inc("flush_error")
            # partial overwrite: read ONLY the stripes the write touches
            # (try_state_to_reads, ECBackend.cc:1915); the extent cache
            # pins recently decoded objects so back-to-back partial writes
            # skip the read entirely
            s0, slen = sinfo.offset_len_to_stripe_bounds(
                op.offset, len(op.data))
            seg: Optional[bytes] = None
            cached = self._cache_get(op.pool_id, op.oid)
            if cached is not None:
                base_version, cached_data = cached
                base = bytearray(cached_data)
                if len(base) < op.offset:
                    base.extend(b"\x00" * (op.offset - len(base)))
                base[op.offset:op.offset + len(op.data)] = op.data
                full = bytes(base)
                object_size = len(full)
                seg = full[s0:s0 + slen]
                full_for_cache = full
            else:
                # extent-granular hit (reference ExtentCache pinning): a
                # prior RMW on an overlapping range left its decoded
                # stripes here — no shard reads at all
                ranged = self._extent_cache.get_range(
                    (op.pool_id, op.oid), s0, slen)
                got = None
                if ranged is not None and ranged[2] > 0                         and len(ranged[1]) == slen:
                    base_version, stripes, old_size = ranged
                    self.perf.inc("rmw_extent_hits")
                    got = (old_size, stripes, base_version)
                else:
                    got = await self._read_stripe_range(
                        op, pool, codec, sinfo, s0, slen)
                if got is not None:
                    old_size, stripes, base_version = got
                    seg_buf = bytearray(stripes)
                    lo = op.offset - s0
                    seg_buf[lo:lo + len(op.data)] = op.data
                    seg = bytes(seg_buf)
                    object_size = max(old_size, op.offset + len(op.data))
                    full_for_cache = None  # only the segment is in hand
                else:
                    # degraded / inconsistent / absent: whole-object path
                    read = await self._do_read(
                        MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid))
                    base = bytearray(as_bytes(read.data)) \
                        if read.ok else bytearray()
                    if len(base) < op.offset:
                        base.extend(b"\x00" * (op.offset - len(base)))
                    base[op.offset:op.offset + len(op.data)] = op.data
                    data = bytes(base)
                    object_size = len(data)
                    full_for_cache = data
            if seg is not None:
                self.perf.inc("rmw_partial")
                data = seg
                chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(s0)
                shard_size = sinfo.logical_to_next_chunk_offset(object_size)
        # encode BEFORE allocating the PG-log eversion: the batched encode
        # awaits the device queue, and the version->local-apply window
        # below must stay SYNCHRONOUS — a concurrent log merge (repair
        # task / unsolicited log reply) advancing the head across an await
        # would invalidate a version handed out earlier.
        planar = None
        # write heat + the install decision (the r10 OPEN tail): writes
        # record into the hit set like reads, and residency on write
        # rides the same recency/throttle gate as read promotion — a
        # refused install takes the cheaper non-resident encode lane
        install = self._tier_write_install(op, pool, pg, acting,
                                           len(data),
                                           full=chunk_off < 0)
        if install == "writeback" and chunk_off < 0:
            # replicated-writeback fast ack: commit the RAW object on
            # the cache quorum (our dirty pages + osd_cache_min_size-1
            # acting peers' adopted copies) and ack NOW — the k+m
            # encode and the sub-write fan-out move wholesale into the
            # flush path (_tier_flush_raw_key).  None = quorum short /
            # store refusal: fall through to the synchronous
            # write-through shape below, counted wb_quorum_short.
            fast = await self._tier_fast_ack_write(
                op, pool, pg, acting, data, object_size, span, mark)
            if fast is not None:
                span.finish()
                return fast
            install = "clean"
        mark("ec_encode_dispatched")
        if install is not None and self._planar is not None \
                and chunk_off < 0:
            # full-object write: leave the shard rows planar-resident so
            # later decodes / repair re-encodes skip the unpack boundary
            planar = await planar_encode_async(codec, sinfo, data,
                                               queue=self._ec_queue,
                                               span=span)
        if planar is not None:
            blobs = planar[0]
        else:
            blobs = await batched_encode_async(codec, sinfo, data,
                                               queue=self._ec_queue,
                                               span=span)
        span.event("encoded")
        mark("encoded")
        # one crc pass per shard, shared by the hinfo record and every
        # sub-write's chunk_crc (a fresh object's chained hinfo crc IS
        # the shard crc)
        shard_crcs = ([shard_crc(blobs[i])
                       for i in range(codec.get_chunk_count())]
                      if chunk_off < 0 else None)
        hinfo_blob = (self._hinfo_for(pool, blobs, crcs=shard_crcs)
                      if chunk_off < 0 else b"")
        # Allocate the eversion only after every await above; from here to
        # the local apply the path is synchronous, so the head cannot move
        # underneath us.
        entry = LogEntry(version=log.next_version(self.osdmap.epoch),
                         op="write", oid=op.oid, prior_version=log.head,
                         reqid=op.reqid)
        version = pack_eversion(entry.version)
        entry.object_version = version
        entry_blob = entry.encode()
        tid = uuid.uuid4().hex
        local_ok = 0
        wb_shards: set = set()
        if chunk_off < 0 and planar is None and self._planar is not None:
            # gated / ineligible / empty full write: it supersedes any
            # existing resident, and the resident must die NOW, dirty
            # included — the write-through applies below land the newer
            # version, and a surviving writeback record would later
            # replay its OLD deferred shard bytes over them (the flush
            # validates against the resident's own meta; same
            # synchronous window as the applies, so the agent cannot
            # interleave)
            self._planar.drop(self._planar_key(op.pool_id, op.oid),
                              force=True)
        if install == "writeback" and planar is not None:
            # writeback: the local shard applies defer into dirty pages
            # (log entry commits NOW, flush replays the applies later);
            # still synchronous — no await between the eversion above
            # and here, so the head cannot move underneath the install
            locals_ = [s for s, o_ in enumerate(acting)
                       if o_ == self.osd_id]
            if locals_:
                wb_shards = self._tier_writeback_install(
                    op, pool, pg, planar, version, object_size, entry,
                    locals_, shard_crcs, hinfo_blob, data)
                if wb_shards:
                    span.event(f"writeback install ({len(wb_shards)} "
                               f"local applies deferred)")
        remote: List[Tuple[int, int]] = []  # (shard, osd)
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            if osd == self.osd_id:
                if shard in wb_shards:
                    # deferred to flush: the dirty page IS this shard's
                    # copy until then (counted acked — same durability
                    # as the store apply, both are process-local)
                    local_ok += 1
                    continue
                # the local shard gets a sub-write span of its own, so
                # the stitched trace shows ALL k+m shard applies (the
                # remote peers record theirs in their own rings)
                with span.child(f"ec_sub_write s{shard}") as lsp:
                    lsp.tag("osd", self.osd_id).tag("local", True)
                    # memoryview, not bytes(): ownership of the fresh
                    # encode-output row passes to the store (Owned
                    # marking in _apply_shard_write) — no per-shard copy
                    if self._apply_shard_write(
                        op.pool_id, op.oid, shard,
                        memoryview(np.ascontiguousarray(blobs[shard])),
                        version,
                        object_size, pg=pg, entry=entry,
                        chunk_off=chunk_off,
                        shard_size=shard_size, hinfo=hinfo_blob,
                        prior_version=base_version,
                        chunk_crc=(shard_crcs[shard]
                                   if shard_crcs is not None else None),
                    ):
                        local_ok += 1
            else:
                remote.append((shard, osd))
        q = self._collector(tid)
        sends = []
        # trace propagation on the fan-out: each peer joins a child
        # ec_sub_write span under OUR ec-write span (feature-gated)
        w_tid, w_sid = (span.context() if self._trace_on else ("", ""))
        for shard, osd in remote:
            # memoryview: the shard row rides the messenger's blob lane
            # without a bytes() copy; crc reuses the per-shard pass above
            chunk = memoryview(np.ascontiguousarray(blobs[shard]))
            crc = (shard_crcs[shard] if shard_crcs is not None
                   else shard_crc(chunk))
            msg = MECSubWrite(
                pool_id=op.pool_id, pg=pg, oid=op.oid, shard=shard, chunk=chunk,
                version=version, object_size=object_size,
                chunk_crc=crc, tid=tid, reply_to=self.addr,
                log_entry=entry_blob, chunk_off=chunk_off,
                shard_size=shard_size, hinfo=hinfo_blob,
                prior_version=base_version,
                from_osd=self.osd_id, epoch=self.osdmap.epoch,
                trace_id=w_tid, span_id=w_sid,
            )
            sends.append(self.messenger.send(self.osdmap.addr_of(osd), msg))
        # under a pg_temp override the up-set members it keeps out of
        # their positions are backfill targets: each also gets its shard
        # and the log entry (no ack awaited), the way Ceph sends writes to
        # its backfill targets.  Without it a PG written faster than its
        # backfill passes run never has a pass that pushes nothing, so it
        # never turns clean and its override (and the out OSD's strays)
        # stays forever.
        fills = []
        if self.osdmap.pg_temp.get((op.pool_id, pg)):
            fill_tid = uuid.uuid4().hex
            up = self._raw_up(pool, pg)
            for shard, osd in enumerate(up[:len(acting)]):
                if osd in (CRUSH_ITEM_NONE, acting[shard], self.osd_id):
                    continue
                chunk = memoryview(np.ascontiguousarray(blobs[shard]))
                fills.append(self.messenger.send(
                    self.osdmap.addr_of(osd), MECSubWrite(
                        pool_id=op.pool_id, pg=pg, oid=op.oid, shard=shard,
                        chunk=chunk, version=version,
                        object_size=object_size,
                        chunk_crc=(shard_crcs[shard]
                                   if shard_crcs is not None
                                   else shard_crc(chunk)),
                        tid=fill_tid, reply_to=self.addr,
                        log_entry=entry_blob,
                        chunk_off=chunk_off, shard_size=shard_size,
                        hinfo=hinfo_blob, prior_version=base_version,
                        from_osd=self.osd_id, epoch=self.osdmap.epoch)))
        # CONCURRENT stripe fan-out: all k+m sub-writes enqueue and their
        # per-connection flushes interleave on the loop, instead of each
        # send serializing on the previous one's socket drain; a failed
        # send counts as a missing ack, not a 5s stall
        sent = 0
        results = await asyncio.gather(*sends, *fills, return_exceptions=True)
        for got in results[:len(sends)]:
            if got is None:
                sent += 1
            elif not isinstance(got, TRANSPORT_ERRORS):
                raise got  # framing bug etc: crash loudly (the _serve rule)
        span.event(f"sub writes sent ({sent})")
        mark("sub_writes_sent")
        mark("waiting_for_subops")
        replies = await self._gather(tid, q, sent)
        span.event("commit gathered")
        mark("commit_gathered")
        span.finish()
        acks = local_ok + sum(1 for r in replies if r.ok)  # self + remote
        if acks < pool.min_size:
            # the entry is logged but the write failed: a same-reqid resend
            # must re-execute rather than be deduped into false success
            self._mark_failed_write(op.reqid)
            self._cache_drop(op.pool_id, op.oid)
            return MOSDOpReply(
                ok=False, code=-errno.EBUSY,
                error=f"write acked by {acks} < min_size {pool.min_size}"
            )
        if acks < len(live):
            # acked but DEGRADED: a member missed its sub-write (lost
            # frame, refused splice).  The reference marks it missing and
            # recovers promptly; waiting for the next interval change
            # would leave the object one failure from loss
            self._kick_recovery(pool, pg)
        if planar is not None and not wb_shards:
            # install the residency only once the write is DURABLE (and
            # under the version it landed as): a failed write must not
            # leave resident rows that reads would serve.  (A writeback
            # install already landed — dirty, pre-fan-out — because its
            # pages ARE the deferred local applies.)
            pkey = self._planar_key(op.pool_id, op.oid)
            k_ = codec.get_data_chunk_count()
            if self._install_resident(pkey, planar, version,
                                      object_size, k_):
                # seed the exit-boundary memo with the just-written
                # bytes: the first resident-hit read serves host bytes
                # instead of paying a device pack (memo_put contract)
                if isinstance(data, bytes) and len(data) == object_size:
                    self._planar.memo_put(pkey, version, data)
        if full_for_cache is not None:
            self._cache_put(op.pool_id, op.oid, version, full_for_cache)
        elif chunk_off >= 0:
            # segment RMW: pin the freshly-written stripes at the NEW
            # version; carry_from upgrades the entry in place (nothing
            # outside this extent changed — our write made the version)
            self._extent_cache.put_extent(
                (op.pool_id, op.oid), version,
                sinfo.aligned_chunk_offset_to_logical_offset(chunk_off),
                data, size_hint=object_size, carry_from=base_version)
        else:
            self._cache_drop(op.pool_id, op.oid)
        return MOSDOpReply(ok=True)

    async def _read_stripe_range(self, op: MOSDOp, pool: PoolInfo, codec,
                                 sinfo: StripeInfo, s0: int,
                                 slen: int) -> Optional[Tuple[int, bytes, int]]:
        """Stripe-scoped RMW read: fetch only the affected chunk ranges of
        a decodable shard set (extent sub-reads) and decode just those
        stripes.  Returns (object_size, segment_bytes, base_version) — the
        segment covers logical [s0, s0+slen) zero-padded past EOF — or None
        when a consistent single-version cut isn't cheaply available
        (degraded, mid-write drift, absent object) and the caller must take
        the full reconstructing read."""
        pg, acting = self._acting(pool, op.oid)
        k = codec.get_data_chunk_count()
        chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(s0)
        clen = slen // k
        available = {shard: osd for shard, osd in enumerate(acting)
                     if osd != CRUSH_ITEM_NONE}
        mapping = codec.get_chunk_mapping()
        want = {mapping[i] if mapping else i for i in range(k)}
        try:
            plan = codec.minimum_to_decode(want, set(available))
        except ErasureCodeError:
            return None
        # a cut older than the log's committed head is a stale survivor;
        # when the log holds NO entry for this oid (trimmed, or written in
        # a prior interval) the log cannot corroborate — stat-probe the
        # shards OUTSIDE the plan in the same fan-out and refuse the cut
        # if any of them holds a newer version (a consistent k-subset of
        # stale survivors would otherwise pass and an acked write's bytes
        # would be spliced away)
        log = self._pglog(op.pool_id, pg)
        latest_logged = max(
            (e.object_version for e in log.entries if e.oid == op.oid),
            default=0)
        probe = ([s for s in available if s not in plan]
                 if latest_logged == 0 else [])
        tid = uuid.uuid4().hex
        pieces: Dict[int, bytes] = {}
        versions: Dict[int, int] = {}
        probe_versions: Dict[int, int] = {}
        sizes: Dict[int, int] = {}
        remote = []
        for shard in list(plan) + probe:
            osd = available[shard]
            stat_only = shard not in plan
            if osd == self.osd_id:
                got = self._store_read((op.pool_id, op.oid, shard))
                if got is not None:
                    blob, meta = got
                    if stat_only:
                        probe_versions[shard] = meta.version
                    else:
                        pieces[shard] = bytes(blob[chunk_off:chunk_off + clen])
                        versions[shard] = meta.version
                        sizes[shard] = meta.object_size
            else:
                remote.append((shard, osd, stat_only))
        q = self._collector(tid)
        sent = 0
        for shard, osd, stat_only in remote:
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MECSubRead(pool_id=op.pool_id, pg=pg, oid=op.oid,
                               shard=shard, tid=tid, reply_to=self.addr,
                               extents=[(0, 0)] if stat_only
                               else [(chunk_off, clen)]))
                sent += 1
            except TRANSPORT_ERRORS:
                pass
        plan_set = set(plan)
        for r in await self._gather(tid, q, sent):
            if r.ok and r.shard in plan_set:
                # extents replies ride as a BufferList of views (local
                # fastpath hands it over by reference): materialize here
                pieces[r.shard] = as_bytes(r.chunk)
                versions[r.shard] = r.version
                sizes[r.shard] = r.object_size
            elif r.ok:
                probe_versions[r.shard] = r.version
        if len(pieces) < k or len(set(versions.values())) != 1:
            return None
        cut_version = max(versions.values())
        if cut_version < latest_logged:
            return None
        if any(v > cut_version for v in probe_versions.values()):
            return None  # someone holds newer: the cut is a stale survivor
        arrays = {}
        for shard, piece in pieces.items():
            if len(piece) < clen:  # stripes past EOF read back as zeros
                piece = piece + b"\x00" * (clen - len(piece))
            self.perf.inc("rmw_read_bytes", len(piece))
            arrays[shard] = np.frombuffer(piece, dtype=np.uint8)
        seg = await decode_object_async(codec, sinfo, arrays, slen,
                                        queue=self._ec_queue)
        return sizes[next(iter(sizes))], seg, max(versions.values())

    async def _do_read(self, op: MOSDOp,
                       exclude_shards: frozenset = frozenset()) -> MOSDOpReply:
        """Reconstructing read.  `exclude_shards` drops shards KNOWN bad
        (scrub found a crc mismatch) from every source, so a repair read
        cannot launder corruption back into the object."""
        pool = self.osdmap.pools[op.pool_id]
        if pool.pool_type != "ec":
            return await self._do_read_replicated(op, pool, exclude_shards)
        codec = self._codec(pool)
        pg, acting = self._acting(pool, op.oid)
        k = codec.get_data_chunk_count()
        if (self._planar is not None and not exclude_shards
                and self._primary(pool, pg, acting) == self.osd_id):
            # planar fast path — a TRUE zero-shard-read: the primary's PG
            # log is the authoritative per-object version source, so when
            # the HBM resident matches the log's newest entry for this
            # oid, the data rows pack straight out — no sub-reads, no
            # decode.  Any mismatch (trimmed window, rewound log, stale
            # resident, delete) falls through to the quorum path.
            # exclude_shards (scrub repair) always takes the quorum path:
            # repair must observe the STORED shards, not our cache.
            ent = self._pglog(op.pool_id, pg).latest_entry(op.oid)
            if ent is not None and ent.op == "write":
                # meta-only probe (no gather): the paged store would pay
                # a page-table gather for a get_planar here, and the
                # memo inside planar_object_bytes serves the common case
                meta = self._planar.resident_meta(
                    self._planar_key(op.pool_id, op.oid))
                if meta is not None:
                    if (meta and len(meta) >= 3
                            and meta[0] == ent.object_version):
                        data = planar_object_bytes(
                            self._planar,
                            self._planar_key(op.pool_id, op.oid),
                            ent.object_version, k,
                            self._sinfo(pool).chunk_size, meta[2])
                        if data is None:
                            # raw fast-ack resident (w=0, whole-object
                            # bytes, no planar rows): the memo inside
                            # planar_object_bytes missed — gather the
                            # object straight off the page table
                            rr = getattr(self._planar, "read_raw", None)
                            data = rr(self._planar_key(
                                op.pool_id, op.oid)) if rr else None
                        if data is not None:
                            self.perf.inc("planar_read_hits")
                            self.tier_perf.inc("resident_hit")
                            self.tier_perf.inc("resident_hit_bytes",
                                               len(data))
                            t = getattr(op, "_tracked", None)
                            if t is not None:
                                t.mark_event("resident_hit")
                            return MOSDOpReply(ok=True, data=data,
                                               version=ent.object_version)
        available = {
            shard: osd for shard, osd in enumerate(acting)
            if osd != CRUSH_ITEM_NONE and shard not in exclude_shards
        }
        # ask the codec which shards suffice (subchunk-aware plan); the
        # wanted shards are the codec's DATA positions, which mapped codecs
        # (lrc) place at chunk_index(i), not at 0..k-1
        mapping = codec.get_chunk_mapping()
        want = {mapping[i] if mapping else i for i in range(k)}
        try:
            plan = codec.minimum_to_decode(want, set(available))
        except ErasureCodeError:
            # fewer than k live ACTING members (e.g. a pg_temp override
            # whose members died): the data may still exist on past
            # holders — fall through to the shard hunt instead of failing
            plan = []
        tid = uuid.uuid4().hex
        chunks: Dict[int, bytes] = {}
        versions: Dict[int, int] = {}
        sizes: Dict[int, int] = {}
        remote = []
        for shard in plan:
            osd = available[shard]
            if osd == self.osd_id:
                got = self._store_read((op.pool_id, op.oid, shard))
                if got is not None:
                    chunks[shard] = got[0]
                    versions[shard] = got[1].version
                    sizes[shard] = got[1].object_size
            else:
                remote.append((shard, osd))
        q = self._collector(tid)
        tracked = getattr(op, "_tracked", None)
        if tracked is not None:
            tracked.mark_event("sub_reads_sent")
        sent = 0
        for shard, osd in remote:
            msg = MECSubRead(
                pool_id=op.pool_id, pg=pg, oid=op.oid, shard=shard, tid=tid,
                reply_to=self.addr,
            )
            try:
                await self.messenger.send(self.osdmap.addr_of(osd), msg)
                sent += 1
            except TRANSPORT_ERRORS:
                pass
        for r in await self._gather(tid, q, sent):
            if r.ok:
                chunks[r.shard] = r.chunk
                versions[r.shard] = r.version
                sizes[r.shard] = r.object_size
        # consistent-version cut: only shards at ONE version may mix in a
        # decode.  Prefer the newest version that is COMPLETE (>= k
        # shards): a failed overwrite can leave a partial newer version
        # that must not poison reads of the intact older one (the
        # reference's last_complete / rollback semantics).
        newest = max(versions.values()) if versions else -1
        complete = {s: c for s, c in chunks.items() if versions[s] == newest}
        if len(complete) < k:
            # shard hunt: shards carry their id, so a degraded read
            # survives placement drift between failure and recovery
            # (send_all_remaining_reads + missing-set role).  Scoped to
            # the PG's possible holders first; if that cannot assemble k
            # shards (purge/bookkeeping messages can be lost under churn)
            # retry once as a cluster-wide broadcast before failing.
            viable: List[int] = []
            by_version: Dict[int, Dict[int, Tuple[bytes, int]]] = {}
            hunt_complete = False
            for broadcast in (False, True):
                hunted, hunt_complete = await self._fetch_all_shards(
                    op.pool_id, op.oid, broadcast=broadcast)
                by_version = {}
                for s_, c_ in chunks.items():
                    by_version.setdefault(versions[s_], {})[s_] = (c_, sizes[s_])
                for shard, chunk, version, osize in hunted:
                    if shard in exclude_shards:
                        continue
                    by_version.setdefault(version, {}).setdefault(
                        shard, (chunk, osize))
                viable = [v for v, m in by_version.items() if len(m) >= k]
                if viable:
                    break
            if not by_version:
                return self._absent_reply(hunt_complete, "shards")
            if not viable:
                return MOSDOpReply(ok=False, code=-errno.EAGAIN,
                                   error="cannot reconstruct: shards missing")
            newest = max(viable)
            chunks = {s_: cm[0] for s_, cm in by_version[newest].items()}
            sizes = {s_: cm[1] for s_, cm in by_version[newest].items()}
            versions = {s_: newest for s_ in chunks}
        else:
            chunks = complete
        object_size = sizes[max(sizes, key=lambda s: versions.get(s, 0))]
        if self._planar is not None:
            # planar residency: the resident rows at this exact version
            # ARE the object — pack the data rows once, skip the decode
            got_planar = planar_object_bytes(
                self._planar, self._planar_key(op.pool_id, op.oid),
                newest, k, self._sinfo(pool).chunk_size, object_size)
            if got_planar is not None:
                # decode skipped (shard reads already happened): counts
                # as a resident hit for the tier — the resident absorbed
                # the decode dispatch even though the log could not
                # corroborate the zero-shard-read path above
                self.tier_perf.inc("resident_hit")
                self.tier_perf.inc("resident_hit_bytes", len(got_planar))
                self._cache_put(op.pool_id, op.oid, newest, got_planar)
                return MOSDOpReply(ok=True, data=got_planar, version=newest)
        arrays = {s: np.frombuffer(c, dtype=np.uint8) for s, c in chunks.items()}
        if tracked is not None:
            tracked.mark_event("decode_dispatched")
        # scatter=True: the healthy-read fast path hands back a
        # BufferList of stripe VIEWS over the sub-read reply buffers —
        # the reply writev's them as one blob, no gather copy on the
        # primary.  Consumers that need contiguous bytes (RMW base,
        # recovery re-encode, the local-fastpath client) materialize at
        # their own boundary (messenger.as_bytes).
        data = await decode_object_async(codec, self._sinfo(pool), arrays,
                                         object_size, queue=self._ec_queue,
                                         scatter=True)
        if tracked is not None:
            tracked.mark_event("decoded")
        if not isinstance(data, BufferList):
            # a scatter result is views over this read's rx buffers; the
            # RMW cache wants a stable contiguous copy — caching it would
            # re-pay exactly the gather the scatter path avoids
            self._cache_put(op.pool_id, op.oid, newest, data)
        return MOSDOpReply(ok=True, data=data, version=newest)

    class _AllShards:
        """Replicated 'encoding': every position gets the full object."""

        def __init__(self, data: bytes):
            self.data = data

        def __getitem__(self, shard: int) -> bytes:
            return self.data

    async def _encode_for(self, pool: PoolInfo, data: bytes,
                          oid: Optional[str] = None, version: int = -1):
        if pool.pool_type == "ec":
            if self._planar is not None and oid is not None:
                # residency: the resident planar rows at this version ARE
                # the encoded object — one pack, zero matmuls
                rows = planar_rows(
                    self._planar, self._planar_key(pool.pool_id, oid),
                    version)
                if rows is not None:
                    return rows
            return await batched_encode_async(
                self._codec(pool), self._sinfo(pool), data,
                queue=self._ec_queue)
        return OSD._AllShards(data)

    def _cls_xattrs(self, pool_id: int, oid: str) -> Dict[str, bytes]:
        """Object-class xattrs to ride a recovery push — minus the
        hinfo_key record, which is per-shard state the push recomputes."""
        attrs = dict(self.store.getattrs((pool_id, oid, 0)))
        attrs.pop(HashInfo.XATTR_KEY, None)
        return attrs

    def _hinfo_for(self, pool: PoolInfo, encoded,
                   crcs: Optional[List[int]] = None) -> bytes:
        """HashInfo blob for a freshly (re-)encoded object (rides recovery
        pushes so the hinfo_key xattr survives, ECUtil.h:101).  A fresh
        object's chained crc equals the plain shard crc, so callers that
        already computed per-shard crcs pass them instead of re-hashing
        every chunk."""
        if pool.pool_type != "ec":
            return b""
        n = self._codec(pool).get_chunk_count()
        if crcs is not None:
            sizes = len(encoded[0])
            h = HashInfo(n, total_chunk_size=sizes, crcs=list(crcs))
            return h.encode()
        h = HashInfo(n)
        h.append({i: bytes(encoded[i]) for i in range(n)})
        return h.encode()

    # -- ReplicatedBackend (reference src/osd/ReplicatedBackend.cc) ----------

    async def _do_write_replicated(self, op: MOSDOp, pool: PoolInfo,
                                   pg: int, acting: List[int]) -> MOSDOpReply:
        """Full copies to every acting position; same log/ack machinery as
        EC but without encode.  Dedupe/failed-write gating already happened
        in _do_write, the single entry point."""
        log = self._pglog(op.pool_id, pg)
        data = op.data
        if op.offset >= 0:
            cached = self._cache_get(op.pool_id, op.oid)
            if cached is not None:
                base = bytearray(cached[1])
            else:
                read = await self._do_read_replicated(
                    MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid), pool)
                base = bytearray(read.data) if read.ok else bytearray()
            if len(base) < op.offset:
                base.extend(b"\x00" * (op.offset - len(base)))
            base[op.offset:op.offset + len(op.data)] = op.data
            data = bytes(base)
        entry = LogEntry(version=log.next_version(self.osdmap.epoch),
                         op="write", oid=op.oid, prior_version=log.head,
                         reqid=op.reqid)
        version = pack_eversion(entry.version)
        entry.object_version = version
        entry_blob = entry.encode()
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        sent = 0
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            if osd == self.osd_id:
                self._apply_shard_write(op.pool_id, op.oid, shard, data,
                                        version, len(data), pg=pg, entry=entry)
            else:
                try:
                    await self.messenger.send(
                        self.osdmap.addr_of(osd),
                        MECSubWrite(pool_id=op.pool_id, pg=pg, oid=op.oid,
                                    shard=shard, chunk=data, version=version,
                                    object_size=len(data),
                                    chunk_crc=shard_crc(data), tid=tid,
                                    reply_to=self.addr, log_entry=entry_blob,
                                    from_osd=self.osd_id,
                                    epoch=self.osdmap.epoch))
                    sent += 1
                except TRANSPORT_ERRORS:
                    pass
        replies = await self._gather(tid, q, sent)
        acks = 1 + sum(1 for r in replies if r.ok)
        if acks < pool.min_size:
            self._mark_failed_write(op.reqid)
            return MOSDOpReply(
                ok=False, code=-errno.EBUSY,
                error=f"write acked by {acks} < min_size {pool.min_size}")
        if acks < len([a for a in acting if a != CRUSH_ITEM_NONE]):
            self._kick_recovery(pool, pg)  # degraded write: recover now
        self._cache_put(op.pool_id, op.oid, version, data)
        return MOSDOpReply(ok=True)

    async def _do_read_replicated(self, op: MOSDOp, pool: PoolInfo,
                                  exclude_shards: frozenset = frozenset()
                                  ) -> MOSDOpReply:
        """Serve from the local copy, else ask acting peers; newest wins."""
        pg, acting = self._acting(pool, op.oid)
        best: Optional[Tuple[bytes, int, int]] = None  # data, version, size
        for shard, osd in enumerate(acting):
            if osd != self.osd_id or shard in exclude_shards:
                continue
            got = self._store_read((op.pool_id, op.oid, shard))
            if got is not None and (best is None or got[1].version > best[1]):
                best = (got[0], got[1].version, got[1].object_size)
        # a local copy older than what the PG log says was committed is a
        # stale survivor from a degraded write: hunt for the newer copy
        log = self._pglog(op.pool_id, pg)
        latest_logged = max(
            (e.object_version for e in log.entries if e.oid == op.oid),
            default=0,
        )
        if best is not None and best[1] < latest_logged:
            best = None
        hunt_complete = True
        if best is None:
            # a copy is a copy regardless of the position key it was stored
            # under in an earlier interval: hunt every up OSD for any shard
            # of the oid and take the newest (placement-drift tolerance)
            hunted, hunt_complete = await self._fetch_all_shards(
                op.pool_id, op.oid)
            for shard, chunk, version, osize in hunted:
                if shard in exclude_shards:
                    continue
                if best is None or version > best[1]:
                    best = (chunk, version, osize)
        if best is None:
            return self._absent_reply(hunt_complete, "copies")
        data, version, size = best
        self._cache_put(op.pool_id, op.oid, version, data[:size])
        return MOSDOpReply(ok=True, data=data[:size], version=version)

    # -- object classes (reference src/cls/, ClassHandler) -------------------

    async def _do_call(self, op: MOSDOp) -> MOSDOpReply:
        from ceph_tpu_torch.services.cls import ClsContext
        from ceph_tpu_torch.services.cls import registry as cls_registry

        pool = self.osdmap.pools[op.pool_id]
        if pool.pool_type == "ec":
            # reference parity: EC pools do not support class calls
            return MOSDOpReply(ok=False, code=-errno.EOPNOTSUPP,
                               error="EOPNOTSUPP: class calls on EC pools")
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        # class methods are not idempotent (refcount.get): a resend whose
        # reply was lost must return the ORIGINAL result, not re-execute
        if op.reqid and op.reqid in self._call_results:
            return self._call_results[op.reqid]
        fn = cls_registry.get(op.cls, op.method)
        if fn is None:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error=f"ENOENT: no class {op.cls}.{op.method}")
        # cls state lives under a CANONICAL shard key (0) so it survives
        # acting-position drift; data via the replicated read path (a
        # just-promoted primary may not hold a local copy)
        key = (op.pool_id, op.oid, 0)
        # the read-execute-write MUST be atomic per object — that is the
        # entire contract in-OSD classes exist for (reference
        # ClassHandler under the PG lock, src/osd/ClassHandler.cc).  The
        # sharded queue serializes per PG in steady state, but a map
        # race around pool creation can key two calls differently, so
        # the primary holds its own per-object critical section.
        async with self._object_critical_section(op.pool_id, op.oid):
            # resend racing the original: it queued on the lock; replay
            # the original's reply instead of re-executing
            if op.reqid and op.reqid in self._call_results:
                return self._call_results[op.reqid]
            reply = await self._do_call_locked(op, pool, pg, acting, fn,
                                               key)
        if reply.ok:
            self._cache_call_reply(op.reqid, reply)
        return reply

    @contextlib.asynccontextmanager
    async def _object_critical_section(self, pool_id: int, oid: str):
        """Refcounted per-object mutex shared by cls calls and compound
        (multi) ops — the two must be mutually atomic.  Eviction never
        orphans a lock another task still waits on."""
        from ceph_tpu_torch.common.lockdep import make_async_mutex

        ent = self._cls_locks.setdefault(
            (pool_id, oid), [make_async_mutex("osd-cls-call"), 0])
        ent[1] += 1  # waiter refcount
        try:
            async with ent[0]:
                yield
        finally:
            ent[1] -= 1
            while len(self._cls_locks) > 512:
                k = next(iter(self._cls_locks))
                if self._cls_locks[k][1] > 0:
                    break  # oldest still referenced: trim next time
                del self._cls_locks[k]

    def _cache_call_reply(self, reqid: str, reply: MOSDOpReply) -> None:
        """Bounded replay cache for non-idempotent ops (cls calls,
        multis, notifies): a resend whose reply was lost replays the
        ORIGINAL result instead of re-executing."""
        if not reqid:
            return
        self._call_results[reqid] = reply
        while len(self._call_results) > 512:
            self._call_results.pop(next(iter(self._call_results)))

    async def _do_call_locked(self, op, pool, pg, acting, fn,
                              key) -> MOSDOpReply:
        from ceph_tpu_torch.services.cls import ClsContext

        read = await self._do_read_replicated(
            MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid), pool)
        hctx = ClsContext(read.data if read.ok else None,
                          dict(self.store.getattrs(key)))
        ret, out = fn(hctx, op.data)
        if hctx.data_dirty and ret >= 0:
            wr = await self._do_write_replicated(
                MOSDOp(op="write", pool_id=op.pool_id, oid=op.oid,
                       data=hctx.data, reqid=uuid.uuid4().hex),
                pool, pg, acting)
            if not wr.ok:
                return MOSDOpReply(ok=False, code=wr.code,
                                   error=wr.error)
        if hctx.xattrs_dirty and ret >= 0:
            # xattr apply stays INSIDE the critical section: the
            # advisory-lock class's read-check-set is only atomic if
            # the next call observes these bytes
            for name, value in hctx.xattrs.items():
                self.store.setattr(key, name, value)
            # replicate xattr state to the other acting members so a
            # failover primary still sees locks/refcounts (same
            # queue-on-failure discipline as the multi path — cls lock
            # state must not go silently stale either)
            for shard, osd in enumerate(acting):
                if osd in (CRUSH_ITEM_NONE, self.osd_id):
                    continue
                await self._send_meta_repl(
                    osd, MSetXattrs(pool_id=op.pool_id, oid=op.oid,
                                    shard=0, xattrs=dict(hctx.xattrs)))
        return MOSDOpReply(ok=True, data=pickle.dumps((ret, out)))

    # -- compound atomic ops (reference MOSDOp vector<OSDOp>,
    # PrimaryLogPG::do_osd_ops; client side ObjectWriteOperation /
    # neorados WriteOp) ------------------------------------------------------

    # sub-ops whose execution needs the object's prior data image; a multi
    # containing none of these serves existence/version/size from a cheap
    # metadata stat instead of a full (possibly decoding) head read
    _MULTI_NEEDS_DATA = frozenset({
        "read", "write", "append", "truncate", "zero", "call",
    })
    _MULTI_OMAP = frozenset({"omap_set", "omap_rm_keys", "omap_clear",
                             "omap_get_vals", "omap_get_keys"})
    # sub-ops allowed on EC pools (reference parity: EC pools support
    # neither omap nor class calls — doc/dev/osd_internals/erasure_coding)
    _MULTI_EC_OK = frozenset({
        "create", "assert_exists", "assert_version", "cmpxattr",
        "read", "stat", "getxattr", "getxattrs",
        "write", "write_full", "append", "truncate", "zero", "remove",
        "setxattr", "rmxattr",
    })

    async def _do_multi(self, op: MOSDOp) -> MOSDOpReply:
        """Execute op.ops — an ordered vector of (name, kwargs) sub-ops —
        atomically on one object.  All-or-nothing: sub-ops run against a
        STAGED image (data bytes + xattrs + omap) under the object's
        critical section; nothing touches the store or the wire until the
        whole vector has succeeded, so a failing assert/sub-op aborts with
        zero side effects.  Reads inside the vector observe earlier
        staged writes (reference do_osd_ops execution order)."""
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error="no such pool")
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        # compound ops are not idempotent (append, cls calls): replay the
        # original reply on a resend, exactly as _do_call does
        if op.reqid and op.reqid in self._call_results:
            return self._call_results[op.reqid]
        if pool.pool_type == "ec":
            for i, (name, _kw) in enumerate(op.ops):
                if name not in self._MULTI_EC_OK:
                    return MOSDOpReply(
                        ok=False, code=-errno.EOPNOTSUPP,
                        error=f"EOPNOTSUPP: sub-op {i} ({name}) on EC pool")
        # the SAME per-object critical section cls calls use: a multi and
        # a cls call (or two multis) on one object serialize, so the
        # read-stage-commit below is atomic per object
        async with self._object_critical_section(op.pool_id, op.oid):
            # re-check the replay cache INSIDE the section: a resend
            # racing the original execution queues on the lock, then
            # finds the original's reply here instead of re-applying a
            # non-idempotent vector
            if op.reqid and op.reqid in self._call_results:
                return self._call_results[op.reqid]
            reply = await self._do_multi_locked(op, pool, pg, acting)
        if reply.ok:
            # only successes replay; a failed multi applied nothing, so a
            # resend may legitimately re-execute (and could then succeed)
            self._cache_call_reply(op.reqid, reply)
        return reply

    async def _do_multi_locked(self, op: MOSDOp, pool: PoolInfo,
                               pg: int, acting: List[int]) -> MOSDOpReply:
        from ceph_tpu_torch.services.cls import ClsContext
        from ceph_tpu_torch.services.cls import registry as cls_registry

        key0 = (op.pool_id, op.oid, 0)  # canonical metadata shard (cls role)
        # -- gather the current image --------------------------------------
        exists = False
        data = bytearray()
        data_loaded = False  # False: `size` is authoritative, not len(data)
        size = 0
        version = 0
        if any(name in self._MULTI_NEEDS_DATA for name, _ in op.ops):
            read = await self._do_read(
                MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid))
            if read.ok:
                exists, data, version = (
                    True, bytearray(as_bytes(read.data)), read.version)
                data_loaded = True
            elif read.code != -errno.ENOENT:
                # transient failure reading the head: the multi must not
                # run against a guessed image — bubble the retryable error
                return MOSDOpReply(ok=False, code=read.code,
                                   error=read.error, backoff=read.backoff)
        else:
            # metadata-only vector: existence + version + size from the
            # stat path (shard metadata fan-out, no payload transfer)
            st = await self._do_stat(
                MOSDOp(op="stat", pool_id=op.pool_id, oid=op.oid))
            if st.ok:
                exists, version, size = True, st.version, int(st.data or b"0")
            elif st.code != -errno.ENOENT:
                return MOSDOpReply(ok=False, code=st.code,
                                   error=st.error, backoff=st.backoff)
        reserved = {self.SNAPSET_XATTR, HashInfo.XATTR_KEY}
        try:
            xattrs = {k: v for k, v in self.store.getattrs(key0).items()
                      if k not in reserved}
        except NotImplementedError:
            xattrs = {}
        for i, (name, kw) in enumerate(op.ops):
            if (name in ("setxattr", "rmxattr", "getxattr", "cmpxattr")
                    and kw.get("name") in reserved):
                return MOSDOpReply(
                    ok=False, code=-errno.EINVAL,
                    error=f"sub-op {i} ({name}): reserved xattr name",
                    data=pickle.dumps([]))
        omap: Dict[str, bytes] = {}
        if any(name in self._MULTI_OMAP for name, _ in op.ops):
            try:
                omap = dict(self.store.omap_get(key0))
            except NotImplementedError:
                omap = {}
        # -- staged execution ----------------------------------------------
        results: List[Tuple[int, object]] = []
        data_dirty = False
        removed = False
        xattr_sets: Dict[str, bytes] = {}
        xattr_rms: set = set()
        omap_cleared = False
        omap_sets: Dict[str, bytes] = {}
        omap_rms: set = set()

        def fail(i: int, name: str, code: int, why: str) -> MOSDOpReply:
            return MOSDOpReply(
                ok=False, code=code,
                error=f"sub-op {i} ({name}): {why}",
                data=pickle.dumps(results))

        for i, (name, kw) in enumerate(op.ops):
            rval = 0
            out: object = None
            if name == "create":
                if kw.get("exclusive") and exists:
                    return fail(i, name, -errno.EEXIST, "object exists")
                if not exists:
                    exists, data_dirty, removed = True, True, False
                    data_loaded = True  # fresh empty image IS the data
            elif name == "assert_exists":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
            elif name == "assert_version":
                want = int(kw.get("version", 0))
                if not exists or version != want:
                    return fail(i, name, -errno.ERANGE,
                                f"version {version} != asserted {want}")
            elif name == "cmpxattr":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                if xattrs.get(kw["name"]) != kw.get("value"):
                    return fail(i, name, -errno.ECANCELED,
                                "xattr comparison failed")
            elif name == "read":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                off = int(kw.get("offset", 0))
                length = kw.get("length")
                end = len(data) if length is None else off + int(length)
                out = bytes(data[off:end])
            elif name == "stat":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                out = {"size": len(data) if data_loaded else size,
                       "version": version}
            elif name == "getxattr":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                val = xattrs.get(kw["name"])
                if val is None:
                    return fail(i, name, -errno.ENODATA,
                                f"no xattr {kw['name']!r}")
                out = val
            elif name == "getxattrs":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                out = dict(xattrs)
            elif name == "omap_get_vals":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                out = dict(omap)
            elif name == "omap_get_keys":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                out = sorted(omap)
            elif name == "write":
                off = int(kw.get("offset", 0))
                blob = kw["data"]
                if len(data) < off:
                    data.extend(b"\x00" * (off - len(data)))
                data[off:off + len(blob)] = blob
                exists, data_dirty, removed = True, True, False
            elif name == "write_full":
                data = bytearray(kw["data"])
                exists, data_dirty, removed = True, True, False
            elif name == "append":
                data.extend(kw["data"])
                exists, data_dirty, removed = True, True, False
            elif name == "truncate":
                size = int(kw.get("size", 0))
                if len(data) < size:
                    data.extend(b"\x00" * (size - len(data)))
                else:
                    del data[size:]
                exists, data_dirty, removed = True, True, False
            elif name == "zero":
                off, length = int(kw.get("offset", 0)), int(kw["length"])
                if len(data) < off + length:
                    data.extend(b"\x00" * (off + length - len(data)))
                data[off:off + length] = b"\x00" * length
                exists, data_dirty, removed = True, True, False
            elif name == "remove":
                if not exists:
                    return fail(i, name, -errno.ENOENT, "object absent")
                exists, removed, data_dirty = False, True, False
                data = bytearray()
                # a removed object has no metadata: later sub-ops must
                # not see it, earlier-staged sets must not be applied,
                # and commit purges the persisted user names
                xattr_rms.update(xattrs)
                xattrs.clear()
                xattr_sets.clear()
                omap.clear()
                omap_sets.clear()
                omap_rms.clear()
                omap_cleared = True
            elif name == "setxattr":
                if removed:  # write-class op after remove recreates
                    exists, data_dirty, removed = True, True, False
                    data_loaded = True
                xattrs[kw["name"]] = kw["value"]
                xattr_sets[kw["name"]] = kw["value"]
                xattr_rms.discard(kw["name"])
            elif name == "rmxattr":
                if kw["name"] not in xattrs:
                    return fail(i, name, -errno.ENODATA,
                                f"no xattr {kw['name']!r}")
                del xattrs[kw["name"]]
                xattr_sets.pop(kw["name"], None)
                xattr_rms.add(kw["name"])
            elif name == "omap_set":
                if removed:  # write-class op after remove recreates
                    exists, data_dirty, removed = True, True, False
                    data_loaded = True
                entries = dict(kw["entries"])
                omap.update(entries)
                omap_sets.update(entries)
                omap_rms.difference_update(entries)
            elif name == "omap_rm_keys":
                for k in kw["keys"]:
                    omap.pop(k, None)
                    omap_sets.pop(k, None)
                    omap_rms.add(k)
            elif name == "omap_clear":
                omap.clear()
                omap_sets.clear()
                omap_rms.clear()
                omap_cleared = True
            elif name == "call":
                fn = cls_registry.get(kw["cls"], kw["method"])
                if fn is None:
                    return fail(i, name, -errno.ENOENT,
                                f"no class {kw['cls']}.{kw['method']}")
                hctx = ClsContext(bytes(data) if exists else None,
                                  dict(xattrs))
                ret, cout = fn(hctx, kw.get("input", b""))
                if ret < 0:
                    return fail(i, name, ret,
                                f"class {kw['cls']}.{kw['method']} -> {ret}")
                if hctx.data_dirty:
                    data = bytearray(hctx.data or b"")
                    exists, data_dirty, removed = True, True, False
                if hctx.xattrs_dirty:
                    for k, v in hctx.xattrs.items():
                        if xattrs.get(k) != v:
                            xattr_sets[k] = v
                            xattr_rms.discard(k)
                    for k in list(xattrs):
                        if k not in hctx.xattrs:
                            xattr_sets.pop(k, None)
                            xattr_rms.add(k)
                    xattrs = dict(hctx.xattrs)
                rval, out = ret, cout
            else:
                return fail(i, name, -errno.EINVAL, "unknown sub-op")
            results.append((rval, out))
        # -- commit (all sub-ops passed) -----------------------------------
        meta_dirty = bool(xattr_sets or xattr_rms or omap_sets or omap_rms
                          or omap_cleared)
        if not exists and not removed and meta_dirty:
            # metadata mutation on a nonexistent object creates it
            # (reference: every write-class op, setxattr/omap included,
            # creates the object) — commit an empty data write so the
            # object has a PG-log identity, not just orphan metadata
            exists, data_dirty, data_loaded = True, True, True
        elif exists and not removed and meta_dirty and not data_dirty:
            # metadata mutation on an EXISTING object must still bump the
            # object version (reference: every op logs), or two
            # assert_version CAS writers racing on xattrs/omap would both
            # pass the same guard and silently lose one update
            if not data_loaded:
                read = await self._do_read(
                    MOSDOp(op="read", pool_id=op.pool_id, oid=op.oid))
                if read.ok:
                    data = bytearray(as_bytes(read.data))
                    data_loaded = True
                elif read.code != -errno.ENOENT:
                    return MOSDOpReply(ok=False, code=read.code,
                                       error=read.error,
                                       backoff=read.backoff)
            data_dirty = True
        if removed:
            dr = await self._do_delete(MOSDOp(
                op="delete", pool_id=op.pool_id, oid=op.oid,
                reqid=uuid.uuid4().hex, snapc_seq=op.snapc_seq,
                snapc_snaps=list(op.snapc_snaps)))
            if not dr.ok and dr.code != -errno.ENOENT:
                return MOSDOpReply(ok=False, code=dr.code, error=dr.error,
                                   backoff=dr.backoff)
        elif data_dirty:
            wr = await self._do_write(MOSDOp(
                op="write", pool_id=op.pool_id, oid=op.oid,
                data=bytes(data), reqid=uuid.uuid4().hex,
                snapc_seq=op.snapc_seq, snapc_snaps=list(op.snapc_snaps)))
            if not wr.ok:
                # data commit failed: xattr/omap staging is NOT applied —
                # the all-or-nothing contract holds even at commit time
                return MOSDOpReply(ok=False, code=wr.code, error=wr.error,
                                   backoff=wr.backoff)
        if xattr_sets or xattr_rms:
            for k, v in xattr_sets.items():
                self.store.setattr(key0, k, v)
            for k in xattr_rms:
                try:
                    self.store.rmattr(key0, k)
                except NotImplementedError:
                    pass
        if omap_cleared or omap_sets or omap_rms:
            try:
                if omap_cleared:
                    self.store.omap_rm(key0, list(self.store.omap_get(key0)))
                if omap_sets:
                    self.store.omap_set(key0, omap_sets)
                if omap_rms:
                    self.store.omap_rm(key0, sorted(omap_rms))
            except NotImplementedError:
                pass
        # replicate metadata mutations to the acting peers so a failover
        # primary serves the same xattrs/omap (cls durability discipline).
        # A failed send is queued for retry, never dropped: silently
        # losing one leaves the replica stale until the next deep scrub.
        if xattr_sets or xattr_rms or omap_cleared or omap_sets or omap_rms:
            msgs = []
            if xattr_sets or xattr_rms:
                msgs.append(MSetXattrs(pool_id=op.pool_id, oid=op.oid,
                                       shard=0, xattrs=dict(xattr_sets),
                                       removals=sorted(xattr_rms)))
            if omap_cleared or omap_sets or omap_rms:
                msgs.append(MSetOmap(pool_id=op.pool_id, oid=op.oid,
                                     shard=0, clear=omap_cleared,
                                     entries=dict(omap_sets),
                                     removals=sorted(omap_rms)))
            for shard, osd in enumerate(acting):
                if osd in (CRUSH_ITEM_NONE, self.osd_id):
                    continue
                for msg in msgs:
                    await self._send_meta_repl(osd, msg)
        return MOSDOpReply(ok=True, data=pickle.dumps(results),
                           version=version)

    async def _send_meta_repl(self, osd: int, msg) -> None:
        """Send one metadata-replication message (MSetXattrs/MSetOmap)
        to an acting peer, preserving per-peer FIFO order: while earlier
        messages to this peer sit in the retry queue, new ones must
        queue BEHIND them — a direct send racing ahead of a queued
        older mutation would let the pump later overwrite newer state
        with stale bytes."""
        if self._meta_repl_pending.get(osd):
            self._queue_meta_repl(osd, msg)
            return
        try:
            await self.messenger.send(self.osdmap.addr_of(osd), msg)
        except TRANSPORT_ERRORS:
            self._queue_meta_repl(osd, msg)

    def _queue_meta_repl(self, osd: int, msg) -> None:
        """Queue a failed MSetXattrs/MSetOmap for redelivery to `osd`
        (FIFO per peer — reordering a clear+set sequence corrupts the
        replica) and make sure the retry pump is running.  Bounded: on
        overflow the OLDEST entry is dropped with a cluster-visible
        error, so sustained unreachability degrades loudly, not
        silently."""
        q = self._meta_repl_pending.setdefault(osd, deque())
        q.append(msg)
        while len(q) > 4096:
            dropped = q.popleft()
            self.perf.inc("meta_repl_dropped")
            self.ctx.log.error(
                "osd", f"meta replication queue to osd.{osd} overflowed; "
                f"dropping {type(dropped).__name__} for "
                f"{dropped.pool_id}/{dropped.oid} (replica stale until "
                "next deep scrub)")
        if self._meta_repl_task is None or self._meta_repl_task.done():
            self._meta_repl_task = asyncio.get_running_loop().create_task(
                self._meta_repl_pump())

    async def _meta_repl_pump(self) -> None:
        """Drain the per-peer metadata-replication retry queues with
        backoff.  A peer marked OUT has its queue dropped — once out,
        the data is re-mapped and a rejoining OSD is rebuilt by
        peering/backfill, so redelivery is pointless (and entries in
        osdmap.osds are never deleted, so keying off presence would
        never fire).  A merely-down peer keeps its queue: it may return
        with its store intact, and redelivery is idempotent (absolute
        sets/removals)."""
        delay = 0.2
        while self._meta_repl_pending and not self._stopped:
            progressed = False
            for osd in list(self._meta_repl_pending):
                q = self._meta_repl_pending.get(osd)
                if not q:
                    self._meta_repl_pending.pop(osd, None)
                    continue
                info = self.osdmap.osds.get(osd)
                if info is None or not info.in_cluster:
                    self._meta_repl_pending.pop(osd, None)
                    continue
                if not info.up:
                    continue  # keep the queue; retry when it returns
                while q:
                    try:
                        await self.messenger.send(
                            self.osdmap.addr_of(osd), q[0])
                    except TRANSPORT_ERRORS:
                        break
                    q.popleft()
                    progressed = True
                if not q:
                    self._meta_repl_pending.pop(osd, None)
            if not self._meta_repl_pending:
                return
            delay = 0.2 if progressed else min(delay * 1.6, 5.0)
            await asyncio.sleep(delay)

    # -- watch/notify (reference src/osd/Watch.{h,cc}) -----------------------

    async def _do_watch(self, op: MOSDOp, remove: bool = False) -> MOSDOpReply:
        pool = self.osdmap.pools[op.pool_id]
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        watcher = tuple(unpickle.loads(op.data))
        key = (op.pool_id, op.oid)
        if remove:
            self._watchers.get(key, set()).discard(watcher)
        else:
            self._watchers.setdefault(key, set()).add(watcher)
        return MOSDOpReply(ok=True)

    async def _do_notify(self, op: MOSDOp) -> MOSDOpReply:
        """Deliver to every watcher, gather acks (notify2 semantics:
        the notifier's reply lists who acked).  Dedupes by reqid (a resend
        must not re-fire side-effecting callbacks) and gathers acks on a
        task of its own (see _dispatch) so the PG shard worker is never
        blocked — a watcher callback that itself issues ops to this shard
        would otherwise deadlock against the gather."""
        pool = self.osdmap.pools[op.pool_id]
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return MOSDOpReply(ok=False, code=-errno.ESTALE,
                               error="not primary")
        if op.reqid:
            if op.reqid in self._call_results:
                return self._call_results[op.reqid]
            inflight = self._notify_inflight.get(op.reqid)
            if inflight is not None:
                # resend while the first execution still gathers: share it
                return await asyncio.shield(inflight)
            self._notify_inflight[op.reqid] = \
                asyncio.get_running_loop().create_future()
        try:
            watchers = list(self._watchers.get((op.pool_id, op.oid), ()))
            notify_id = uuid.uuid4().hex
            q = self._collector(notify_id)
            sent = []
            for watcher in watchers:
                try:
                    await self.messenger.send(
                        watcher,
                        MWatchNotify(pool_id=op.pool_id, oid=op.oid,
                                     notify_id=notify_id, payload=op.data,
                                     reply_to=self.addr),
                        peer_type="client")
                    sent.append(watcher)
                except TRANSPORT_ERRORS:
                    # dead watcher: drop the registration (watch timeout role)
                    self._watchers.get((op.pool_id, op.oid), set()).discard(watcher)
            acked = []
            for r in await self._gather(notify_id, q, len(sent), timeout=2.0):
                acked.append(tuple(r.watcher))
            # a watcher that took the frame but never acked is hung or gone:
            # prune it so it can't tax every future notify (watch expiry
            # role); live clients re-register, as the reference's do on
            # watch errors
            for watcher in sent:
                if tuple(watcher) not in acked:
                    self._watchers.get((op.pool_id, op.oid), set()).discard(watcher)
            reply = MOSDOpReply(ok=True, data=pickle.dumps(acked))
        except Exception as e:
            # deliberately BROAD: the inflight future must resolve even on
            # an own-code failure, or every same-reqid resend would hang
            # on a forever-pending shield (counted, not silent)
            self.perf.inc("op_unexpected_error")
            reply = MOSDOpReply(ok=False, code=-errno.EIO,
                                error=f"{type(e).__name__}: {e}")
        if op.reqid:
            if reply.ok:
                # only successes are replayable results; a failed notify
                # resend should re-execute
                self._cache_call_reply(op.reqid, reply)
            fut = self._notify_inflight.pop(op.reqid, None)
            if fut is not None and not fut.done():
                fut.set_result(reply)
        return reply

    async def _do_stat(self, op: MOSDOp) -> MOSDOpReply:
        """Size/version from shard metadata — no payload transfer/decode
        (stat must not cost a full read)."""
        pool = self.osdmap.pools[op.pool_id]
        pg, acting = self._acting(pool, op.oid)
        best: Optional[Tuple[int, int]] = None  # (version, object_size)
        for shard, osd in enumerate(acting):
            if osd != self.osd_id:
                continue
            got = self._store_read((op.pool_id, op.oid, shard))
            if got is not None and (best is None or got[1].version > best[0]):
                best = (got[1].version, got[1].object_size)
        # a local copy older than the log's committed version is stale
        log = self._pglog(op.pool_id, pg)
        latest_logged = max(
            (e.object_version for e in log.entries if e.oid == op.oid),
            default=0,
        )
        if best is not None and best[0] < latest_logged:
            best = None
        if best is None:
            # sub-reads to every live acting peer (each transfers one
            # chunk, not k) carry the metadata we need; newest wins
            tid = uuid.uuid4().hex
            q = self._collector(tid)
            sent = 0
            for shard, osd in enumerate(acting):
                if osd in (CRUSH_ITEM_NONE, self.osd_id):
                    continue
                try:
                    await self.messenger.send(
                        self.osdmap.addr_of(osd),
                        MECSubRead(pool_id=op.pool_id, pg=pg, oid=op.oid,
                                   shard=shard, tid=tid, reply_to=self.addr))
                    sent += 1
                except TRANSPORT_ERRORS:
                    continue
            for r in await self._gather(tid, q, sent, timeout=2.0):
                if r.ok and (best is None or r.version > best[0]):
                    best = (r.version, r.object_size)
        hunt_complete = True
        if best is None:
            # placement drift: hunt any shard cluster-wide (metadata only)
            hunted, hunt_complete = await self._fetch_all_shards(
                op.pool_id, op.oid)
            for _s, _c, version, osize in hunted:
                if best is None or version > best[0]:
                    best = (version, osize)
        if best is None:
            return self._absent_reply(hunt_complete, "shards")
        return MOSDOpReply(ok=True, version=best[0],
                           data=str(best[1]).encode())

    async def _do_delete(self, op: MOSDOp) -> MOSDOpReply:
        """Delete every shard of the object on the PG's possible holders
        (acting + up-set + members of intervals since the PG was last
        clean) — stray shards left by placement drift would otherwise
        resurrect the object through the shard hunt.  The scope set, not a
        cluster broadcast: OSDs outside it can only hold copies from
        intervals that ended with a clean PG, and those were purged."""
        pool = self.osdmap.pools[op.pool_id]
        pg, acting = self._acting(pool, op.oid)
        log = self._pglog(op.pool_id, pg)
        if log.has_reqid(op.reqid):
            return MOSDOpReply(ok=True)  # resent delete: already applied
        # snapshot semantics (reference make_writeable on delete): a
        # delete under a snap context first clones the head, then leaves
        # a WHITEOUT carrying the SnapSet so snap reads keep resolving;
        # the head reads as ENOENT.  Without live clones, a delete is a
        # real delete.
        if not is_snap_clone(op.oid):
            cow_err = await self._make_writeable(op, pool, pg, acting)
            if cow_err is not None:
                return cow_err
            ss = self._load_snapset(op.pool_id, op.oid)
            if ss["clones"]:
                self._cache_drop(op.pool_id, op.oid)
                wr = await self._do_write(MOSDOp(
                    op="write", pool_id=op.pool_id, oid=op.oid, data=b"",
                    reqid=op.reqid or uuid.uuid4().hex))
                if not wr.ok:
                    return wr
                ss = self._load_snapset(op.pool_id, op.oid)
                ss["whiteout"] = True
                await self._save_snapset(pool, pg, acting, op.oid, ss)
                return MOSDOpReply(ok=True)
        tid = uuid.uuid4().hex
        self._cache_drop(op.pool_id, op.oid)
        entry = LogEntry(version=log.next_version(self.osdmap.epoch),
                         op="delete", oid=op.oid, prior_version=log.head,
                         reqid=op.reqid)
        entry_blob = entry.encode()
        # local: drop any shard we hold (rollback slots included); the
        # delete is a PG log event
        txn = Transaction()
        for oid, shard in list(self.store.list_objects(op.pool_id)):
            if oid == op.oid:
                txn.delete((op.pool_id, op.oid, shard))
        self._log_in_txn(txn, op.pool_id, pg, entry)
        self.store.queue_transaction(txn)
        acting_set = {a for a in acting if a != CRUSH_ITEM_NONE}
        peers = [o for o in self._scope_osds(pool, pg) if o != self.osd_id]
        q = self._collector(tid)
        sent = 0
        for osd in peers:
            try:
                # shard=-1: drop every shard of the oid (one message per
                # peer); acting members also log the delete so their PG
                # logs advance with the primary's
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MECSubDelete(pool_id=op.pool_id, pg=pg, oid=op.oid,
                                 shard=-1, tid=tid, reply_to=self.addr,
                                 log_entry=entry_blob
                                 if osd in acting_set else b""),
                )
                sent += 1
            except TRANSPORT_ERRORS:
                pass
        await self._gather(tid, q, sent)
        return MOSDOpReply(ok=True)

    # -- shard side ----------------------------------------------------------

    def _apply_shard_write(
        self, pool_id: int, oid: str, shard: int, chunk: bytes, version: int,
        object_size: int, pg: Optional[int] = None,
        entry: Optional[LogEntry] = None, chunk_off: int = -1,
        shard_size: int = 0, hinfo: bytes = b"", prior_version: int = 0,
        chunk_crc: Optional[int] = None,
    ) -> bool:
        # failsafe FIRST — before the rollback-slot read, the in-memory
        # PG-log append, and the store transaction: a refused write must
        # leave both the store AND the in-memory log byte-identical
        # (injection-aware, so CI exercises this without filling disks)
        if self._failsafe_full(len(chunk)):
            raise ENOSPCError(
                f"osd.{self.osd_id} failsafe full: refusing "
                f"{len(chunk)}-byte shard write")
        txn = Transaction()
        # retain the outgoing version in the rollback slot (same txn):
        # reads fall back to it when a newer write never completed
        old = self._store_read((pool_id, oid, shard))
        if old is not None and old[1].version != version:
            # the retained blob is already store-owned: re-mark, don't
            # re-copy
            txn.write((pool_id, oid, shard + PREV_SLOT),
                      old[0] if isinstance(old[0], bytes)
                      else StoreOwned(old[0]), old[1])
        appended = False
        if chunk_off >= 0:
            # splice precondition: the delta only composes with the exact
            # base the primary read.  A shard that missed an intermediate
            # write (or lost the object) must refuse — splicing into a
            # stale blob would stamp corrupt bytes as newest with a
            # self-consistent crc.  Refusal costs one ack; recovery
            # re-pushes the full blob.
            if old is None or old[1].version != prior_version:
                return False
            # splice the chunk range into the stored blob (per-stripe RMW);
            # zero-extension to shard_size covers gap stripes — zero chunks
            # ARE the parity of zero stripes for these linear codes
            base = bytearray(old[0])
            appended = chunk_off == len(base)
            want = max(shard_size, chunk_off + len(chunk), len(base))
            if len(base) < want:
                base.extend(b"\x00" * (want - len(base)))
            base[chunk_off:chunk_off + len(chunk)] = chunk
            blob = bytes(base)
            chunk_crc = None  # splice: the shipped crc covered the delta
        else:
            blob = chunk
        # one crc per shard per write: reuse the crc the primary already
        # computed (or the receiver already VERIFIED the frame against)
        # instead of a third pass over the same bytes
        crc = shard_crc(blob) if chunk_crc is None else chunk_crc
        txn.write(
            (pool_id, oid, shard),
            # a non-bytes full-write blob is an encode-output (or
            # fetched-shard) buffer whose ownership transfers to the
            # store here: mark it Owned so the RAM store keeps the view
            # instead of a 16 MiB defensive copy per shard (stored
            # buffers are never mutated in place — overwrites replace
            # entries)
            blob if isinstance(blob, bytes) else StoreOwned(blob),
            ShardMeta(version=version, object_size=object_size,
                      chunk_crc=crc),
        )
        if entry is not None and pg is not None:
            self._log_in_txn(txn, pool_id, pg, entry)
        self.store.queue_transaction(txn)
        self._update_hinfo(pool_id, oid, shard, blob, chunk, hinfo,
                           chunk_off, appended)
        return True

    def _update_hinfo(self, pool_id: int, oid: str, shard: int, blob: bytes,
                      chunk: bytes, hinfo: bytes, chunk_off: int,
                      appended: bool) -> None:
        """Maintain the hinfo_key xattr (cumulative shard crcs, reference
        ECUtil.h:101-160): full writes store the primary-computed record;
        splices refresh our OWN entry — by crc32 chaining when the splice
        is a pure append (no re-read of prior bytes), by recompute
        otherwise — and mark the record dirty (other entries went stale)."""
        pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
        if pool is not None and pool.pool_type != "ec":
            return  # replicated pools carry no hinfo; skip the xattr I/O
        key = (pool_id, oid, shard)
        try:
            if chunk_off < 0:
                if hinfo:
                    self.store.setattr(key, HashInfo.XATTR_KEY, hinfo)
                else:
                    # full-blob write without a primary-computed record
                    # (e.g. a sub-chunk recovery push whose helper record
                    # was dirty): an existing record is now stale for this
                    # shard — refresh our own entry and mark it dirty so
                    # scrub trusts the self crc and skips the cross-shard
                    # comparison, instead of flagging fresh data as bad
                    raw0 = self.store.getattr(key, HashInfo.XATTR_KEY)
                    if raw0 is not None:
                        h0 = HashInfo.decode(raw0)
                        if shard < len(h0.crcs):
                            h0.crcs[shard] = shard_crc(blob)
                            h0.total_chunk_size = len(blob)
                            h0.dirty = True
                            self.store.setattr(key, HashInfo.XATTR_KEY,
                                               h0.encode())
                return
            raw = self.store.getattr(key, HashInfo.XATTR_KEY)
            if raw is None:
                return
            h = HashInfo.decode(raw)
            if shard >= len(h.crcs):
                return
            if appended and h.total_chunk_size == chunk_off:
                from ceph_tpu_torch.utils.checksum import checksum

                h.crcs[shard] = checksum(chunk, h.crcs[shard]) & 0xFFFFFFFF
            else:
                h.crcs[shard] = shard_crc(blob)
            h.total_chunk_size = len(blob)
            h.dirty = True
            self.store.setattr(key, HashInfo.XATTR_KEY, h.encode())
        except NotImplementedError:
            pass  # store without xattr support

    async def _apply_sub_write(self, msg: MECSubWrite) -> MECSubWriteReply:
        """Validate + apply one sub-write; the reply is the CALLER's to
        send (the group path batches a whole run of them so the replies
        coalesce into one flush window on the primary's connection)."""
        # every sub-write is a first-class tracked op with a span that
        # joins the primary's propagated `ec write` context — this is
        # the peer leg of the client->primary->k+m stitched trace
        t_tid = getattr(msg, "trace_id", "")
        span = None
        if t_tid:
            span = self.ctx.tracer.join(
                f"ec_sub_write s{msg.shard}", t_tid,
                getattr(msg, "span_id", "") or None)
            span.tag("osd", self.osd_id)
        tracked = self.ctx.op_tracker.create(
            f"ec_sub_write({msg.pool_id}.{msg.pg} {msg.oid} s{msg.shard})",
            reqid=msg.tid, trace=span)
        ok = False
        try:
            ok = True
            sender = getattr(msg, "from_osd", -1)
            if sender >= 0 and self.osdmap is not None:
                # interval fence (reference same_interval_since): refuse a
                # sub-write from an OSD that is not this pg's primary in
                # OUR map — a deposed primary with in-flight sub-ops must
                # not complete a write concurrently with its successor.
                # Catch up first when the sender's map is newer than ours.
                if msg.epoch > self.osdmap.epoch:
                    await self._fetch_full_map()
                pool = self.osdmap.pools.get(msg.pool_id)
                if pool is not None:
                    acting = self.osdmap.pg_to_acting(pool, msg.pg)
                    if (self._primary(pool, msg.pg, acting)
                            not in (sender, None)):
                        ok = False
            if not ok:
                tracked.mark_event("refused_interval")
            elif msg.chunk_crc and not getattr(msg, "_wire_verified", False) \
                    and not crc_verify_any(msg.chunk, msg.chunk_crc):
                # _wire_verified: the frame layer already checked the blob
                # against chunk_crc (the sender reused it as the wire crc)
                # — a second pass over the same bytes proves nothing new
                ok = False  # corrupted in flight
                tracked.mark_event("refused_crc")
            else:
                entry = LogEntry.decode(msg.log_entry) \
                    if msg.log_entry else None
                if entry is not None:
                    entry.version = tuple(entry.version)
                    entry.prior_version = tuple(entry.prior_version)
                enospc = False
                try:
                    ok = self._apply_shard_write(
                        msg.pool_id, msg.oid, msg.shard, msg.chunk,
                        msg.version,
                        msg.object_size, pg=msg.pg, entry=entry,
                        chunk_off=msg.chunk_off,
                        shard_size=msg.shard_size,
                        hinfo=msg.hinfo, prior_version=msg.prior_version,
                        # just verified against the frame: reuse, don't
                        # re-crc
                        chunk_crc=msg.chunk_crc or None,
                    )
                except ENOSPCError:
                    # this shard's store is failsafe-full: refuse (one
                    # missing ack at the primary), never mutate
                    ok = False
                    enospc = True
                # another primary wrote this object: cached decode is
                # stale.  EXCEPTION: an adopted raw fast-ack copy at (or
                # past) this sub-write's version IS the cache-tier
                # durability of an ACKED write — this sub-write is that
                # write's own flush landing, and force-dropping the copy
                # here would reopen the acked-data-loss window the
                # replication closed (primary dies mid-flush).  The copy
                # is released only by the owner's post-flush clear.
                self._extent_cache.drop((msg.pool_id, msg.oid))
                _pkey = self._planar_key(msg.pool_id, msg.oid)
                _spare = False
                _ps = self._paged_store()
                if _ps is not None:
                    _snap = _ps.peek_dirty(_pkey)
                    if _snap is not None \
                            and isinstance(_snap[0], CacheDirtyRecord) \
                            and _snap[0].version >= msg.version:
                        _spare = True
                if not _spare and self._planar is not None:
                    self._planar.drop(_pkey, force=True)
                # ONE event per outcome: an ENOSPC refusal must not also
                # count as a splice/crc refusal in the op timeline
                tracked.mark_event("applied" if ok
                                   else "refused_enospc" if enospc
                                   else "refused_splice")
                if ok:
                    self.perf.inc("subop_w")
        finally:
            if span is not None:
                span.tag("ok", ok)
                span.finish()
            tracked.finish()
        return MECSubWriteReply(tid=msg.tid, shard=msg.shard, ok=ok,
                                trace_id=t_tid,
                                span_id=getattr(msg, "span_id", ""))

    async def _handle_sub_write(self, msg: MECSubWrite) -> None:
        reply = await self._apply_sub_write(msg)
        try:
            await self.messenger.send(tuple(msg.reply_to), reply)
        except TRANSPORT_ERRORS:
            pass

    async def _handle_sub_write_group(self, msgs: List[MECSubWrite]) -> None:
        """A consecutive run of sub-writes from one rx batch: apply all
        in arrival order FIRST, then send the replies — replies to the
        same primary land in the same outbox flush window (one writev +
        one piggybacked ack instead of a write+drain per sub-write)."""
        replies = []
        for msg in msgs:
            replies.append((tuple(msg.reply_to),
                            await self._apply_sub_write(msg)))

        async def _send_one(addr, reply):
            try:
                await self.messenger.send(addr, reply)
            except TRANSPORT_ERRORS:
                pass

        # concurrent enqueue (not sequential awaits): every reply joins
        # the connection outbox before the flusher runs, so one flush
        # window carries the whole run
        await asyncio.gather(*[_send_one(a, r) for a, r in replies])

    async def _handle_sub_read(self, msg: MECSubRead) -> None:
        self.perf.inc("subop_r")
        try:
            got = self.store.read((msg.pool_id, msg.oid, msg.shard))
        except IOError:
            # EIO / checksum failure on our shard: reply error so the
            # primary reconstructs from other shards (the behavior
            # qa/standalone/erasure-code/test-erasure-eio.sh exercises)
            got = None
        _ps = self._paged_store()
        if _ps is not None:
            _snap = _ps.peek_dirty(self._planar_key(msg.pool_id, msg.oid))
            if _snap is not None and isinstance(_snap[0], CacheDirtyRecord):
                got = await self._raw_subread_fence(msg, _snap[0], got)
        got = self._dirty_subread_fence(msg, got)
        if got is None:
            reply = MECSubReadReply(tid=msg.tid, shard=msg.shard, ok=False)
        else:
            chunk, meta = got
            stored_crc = 0
            if msg.extents:
                # fragmented read: only the requested blob ranges cross
                # the wire, as a BufferList of extent VIEWS — no join
                # copy (stripe-RMW + sub-chunk recovery, ECMsgTypes.h:105)
                payload = BufferList(
                    [memoryview(chunk)[o:o + l] for o, l in msg.extents])
            else:
                payload = chunk
                # whole-blob reply: the stored meta crc IS the crc of
                # these bytes — the messenger reuses it as the frame's
                # blob crc (BLOB_CRC_ATTR), skipping the checksum pass.
                # MemStore only: its contents were written by THIS
                # process, so the crc kind is the current resolver's; a
                # persistent store may hold crcs from another build/kind
                # (the crc_verify_any discipline), and shipping one as
                # the wire crc would fail every frame at the receiver
                if isinstance(self.store, MemStore):
                    stored_crc = meta.chunk_crc
            hraw = None
            if getattr(msg, "want_hinfo", False):
                try:
                    hraw = self.store.getattr(
                        (msg.pool_id, msg.oid, msg.shard), HashInfo.XATTR_KEY)
                except NotImplementedError:
                    pass
            reply = MECSubReadReply(
                tid=msg.tid, shard=msg.shard, ok=True, chunk=payload,
                version=meta.version, object_size=meta.object_size,
                hinfo=hraw or b"", chunk_crc=stored_crc,
            )
        try:
            await self.messenger.send(tuple(msg.reply_to), reply)
        except TRANSPORT_ERRORS:
            pass

    async def _handle_sub_delete(self, msg: MECSubDelete) -> None:
        txn = Transaction()
        if msg.shard < 0:  # whole-object delete (rollback slots included)
            for oid, shard in list(self.store.list_objects(msg.pool_id)):
                if oid == msg.oid:
                    txn.delete((msg.pool_id, msg.oid, shard))
        else:
            txn.delete((msg.pool_id, msg.oid, msg.shard))
        if msg.log_entry:
            entry = LogEntry.decode(msg.log_entry)
            entry.version = tuple(entry.version)
            entry.prior_version = tuple(entry.prior_version)
            self._log_in_txn(txn, msg.pool_id, msg.pg, entry)
        self._cache_drop(msg.pool_id, msg.oid)
        self.store.queue_transaction(txn)
        try:
            await self.messenger.send(
                tuple(msg.reply_to), MECSubWriteReply(tid=msg.tid, shard=msg.shard, ok=True)
            )
        except TRANSPORT_ERRORS:
            pass

    async def _fetch_all_shards(self, pool_id: int, oid: str,
                                broadcast: bool = False):
        """Shard hunt scoped to the object's PG: ask the PG's possible
        holders (acting + up + past-interval members) for any shard of oid
        they hold; include our own.  Not a cluster broadcast by default —
        OSDs outside the scope set were purged of strays when their
        interval closed; ``broadcast=True`` is the slow-path fallback for
        when that bookkeeping was itself disrupted (lost purges under
        socket failures).

        Returns (shards, complete): ``complete`` is True only when every
        possible holder was up, was reached, and answered — the bar for
        treating an empty result as VERIFIED absence (-ENOENT) rather than
        cannot-locate (-EAGAIN).  A gather timeout or an unreachable/down
        holder makes the hunt incomplete: the shards may exist there."""
        out = []
        complete = True
        for oid2, shard in self.store.list_objects(pool_id):
            if oid2 != oid:
                continue
            got = self._store_read((pool_id, oid, shard))
            if got is not None:
                out.append((shard % PREV_SLOT, got[0], got[1].version,
                            got[1].object_size))
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            return out, False
        pg = self.osdmap.object_to_pg(pool, oid)
        # a down possible-holder may be carrying the shards through a
        # restart: its absence from the queried set forfeits "complete"
        if not self._scope_all_up(pool, pg):
            complete = False
        if broadcast:
            peers = [o.osd_id for o in self.osdmap.osds.values()
                     if o.up and o.osd_id != self.osd_id]
        else:
            peers = [o for o in self._scope_osds(pool, pg)
                     if o != self.osd_id]
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        sent = 0
        for osd in peers:
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MFetchShards(pool_id=pool_id, oid=oid, tid=tid, reply_to=self.addr),
                )
                sent += 1
            except TRANSPORT_ERRORS:
                complete = False  # unreachable holder: unknown contents
        replies = await self._gather(tid, q, sent)
        if len(replies) < sent:
            complete = False  # gather timeout: someone never answered
        for r in replies:
            out.extend(tuple(s) for s in r.shards)
        return out, complete

    async def _handle_fetch_shards(self, msg: MFetchShards) -> None:
        shards = []
        for oid, shard in self.store.list_objects(msg.pool_id):
            if oid != msg.oid:
                continue
            got = self._store_read((msg.pool_id, msg.oid, shard))
            if got is not None:
                shards.append((shard % PREV_SLOT, got[0], got[1].version,
                               got[1].object_size))
        try:
            await self.messenger.send(
                tuple(msg.reply_to),
                MFetchShardsReply(tid=msg.tid, osd_id=self.osd_id, shards=shards),
            )
        except TRANSPORT_ERRORS:
            pass

    async def _handle_list_shards(self, msg: MListShards) -> None:
        entries = []
        want_pg = getattr(msg, "pg", -1)
        pool = self.osdmap.pools.get(msg.pool_id) if self.osdmap else None
        for oid, shard in self._list_pool_objects(msg.pool_id):
            if (want_pg >= 0 and pool is not None
                    and self.osdmap.object_to_pg(pool, oid) != want_pg):
                continue
            got = self._store_read((msg.pool_id, oid, shard))
            if got is not None:
                entries.append((oid, shard, got[1].version))
        try:
            await self.messenger.send(
                tuple(msg.reply_to),
                MListShardsReply(tid=msg.tid, osd_id=self.osd_id, entries=entries),
            )
        except TRANSPORT_ERRORS:
            pass

    def _apply_push(self, msg: MPushShard) -> None:
        # recovery pushes are first-class tracked ops too: a recovering
        # OSD's dump_ops_in_flight shows what it is applying
        tracked = self.ctx.op_tracker.create(
            f"recovery_push({msg.pool_id} {msg.oid} s{msg.shard})")
        try:
            # a push must never regress the object: the primary read and
            # re-encoded at some version, but a client write may have
            # landed here since — applying the stale push would bury the
            # newer acked bytes in the rollback slot where the next write
            # evicts them (the reference's recovery also refuses to move
            # backward)
            cur = self._store_read((msg.pool_id, msg.oid, msg.shard))
            if cur is not None and cur[1].version > msg.version:
                tracked.mark_event("refused_stale")
                return
            self.perf.inc("recovery_push")
            self._cache_drop(msg.pool_id, msg.oid)
            try:
                self._apply_shard_write(
                    msg.pool_id, msg.oid, msg.shard, msg.chunk,
                    msg.version, msg.object_size, hinfo=msg.hinfo,
                )
            except ENOSPCError:
                # failsafe-full: even recovery stops at the last-resort
                # line (the store must survive) — the primary's next
                # sweep re-pushes once space frees
                tracked.mark_event("refused_enospc")
                return
            tracked.mark_event("applied")
            if msg.xattrs:
                try:
                    for name, value in msg.xattrs.items():
                        if name == HashInfo.XATTR_KEY:
                            # cls xattrs ride pushes, but a stale hinfo
                            # record must never clobber the fresh one
                            # written above
                            continue
                        self.store.setattr((msg.pool_id, msg.oid, 0),
                                           name, value)
                except NotImplementedError:
                    pass
        finally:
            tracked.finish()

    # -- peering (GetInfo/GetLog exchange, reference PeeringState) -----------

    async def _handle_pg_info(self, msg: MPGInfoReq) -> None:
        log = self._pglog(msg.pool_id, msg.pg)
        try:
            await self.messenger.send(
                tuple(msg.reply_to),
                MPGInfoReply(tid=msg.tid, osd_id=self.osd_id,
                             last_update=log.head, log_tail=log.tail,
                             past_members=sorted(self._past_members.get(
                                 (msg.pool_id, msg.pg), ()))),
            )
        except (ConnectionError, OSError):
            pass

    async def _handle_pg_log_req(self, msg: MPGLogReq) -> None:
        log = self._pglog(msg.pool_id, msg.pg)
        delta = log.entries_after(tuple(msg.since))
        reply = MPGLogReply(tid=msg.tid, osd_id=self.osd_id,
                            pool_id=msg.pool_id, pg=msg.pg,
                            backfill=delta is None,
                            entries=[e.encode() for e in (delta or [])])
        try:
            await self.messenger.send(tuple(msg.reply_to), reply)
        except (ConnectionError, OSError):
            pass

    async def _peer_pg(self, pool: PoolInfo, pg: int,
                       acting: List[int]) -> Tuple[Dict[int, Tuple[int, int]], bool]:
        """GetInfo round: each acting peer's last_update.  Returns
        (peer -> last_update, any_needs_backfill)."""
        log = self._pglog(pool.pool_id, pg)
        peers = [o for o in acting
                 if o != CRUSH_ITEM_NONE and o != self.osd_id]
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        sent = 0
        for osd in set(peers):
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MPGInfoReq(pool_id=pool.pool_id, pg=pg, tid=tid,
                               reply_to=self.addr))
                sent += 1
            except TRANSPORT_ERRORS:
                pass
        infos: Dict[int, Tuple[int, int]] = {self.osd_id: log.head}
        # short timeout: one dropped frame must not stall the recovery
        # window; the retry loop re-peers and lossless replay catches up
        for r in await self._gather(tid, q, sent, timeout=0.8):
            infos[r.osd_id] = tuple(r.last_update)
            peer_past = getattr(r, "past_members", None)
            if peer_past:
                # union interval history: a primary that missed intervals
                # (down / newly added) inherits the scope its peers saw
                self._past_members.setdefault(
                    (pool.pool_id, pg), set()).update(peer_past)
        backfill = any(
            log.calc_missing(v) is None for v in infos.values()
        )
        return infos, backfill

    async def _merge_log_entries(self, pool_id: int, pg: int,
                                 entries: List[LogEntry]) -> List[LogEntry]:
        """Adopt authoritative log entries; local entries NEWER than the
        incoming base are divergent — writes a dead primary never committed
        cluster-wide — and get rolled back (shard dropped + log rewound,
        the reference's divergent-entry rollback).  Returns merged entries."""
        log = self._pglog(pool_id, pg)
        entries = sorted(entries, key=lambda e: e.version)
        if not entries:
            return []
        base = entries[0].prior_version
        divergent = log.divergent_against(base) if base < log.head else []
        txn = Transaction()
        for d in divergent:
            if d.version >= entries[0].version:
                continue  # same entry arriving again, not divergence
            for oid, shard in list(self._list_pool_objects(pool_id)):
                if oid == d.oid:
                    txn.delete((pool_id, d.oid, shard))
            self._cache_drop(pool_id, d.oid)
        if divergent:
            log.rewind_to(base)
        merged = []
        for e in entries:
            if e.version > log.head:
                self._log_in_txn(txn, pool_id, pg, e)
                merged.append(e)
        if txn.writes or txn.deletes or txn.omap_sets or txn.omap_rms:
            self.store.queue_transaction(txn)
        return merged

    async def _push_log_to_peer(self, pool_id: int, pg: int, osd: int,
                                entries: List[LogEntry]) -> None:
        """Unsolicited authoritative log push (tid='') so a caught-up
        peer's log head advances with the objects it just received."""
        if not entries:
            return
        try:
            await self.messenger.send(
                self.osdmap.addr_of(osd),
                MPGLogReply(tid="", osd_id=self.osd_id, pool_id=pool_id,
                            pg=pg, entries=[e.encode() for e in entries]))
        except TRANSPORT_ERRORS:
            pass

    # -- scrub (be_deep_scrub role, ECBackend.cc:2530) -----------------------

    def _scrub_shard_state(self, key: Tuple[int, str, int],
                           shard: int) -> Tuple[bool, bool, int, int]:
        """(present, crc_ok, version, crc) for a stored shard: the blob crc
        must match BOTH the shard meta and the stored cumulative HashInfo
        entry (hinfo_key, the reference's be_deep_scrub comparison against
        hinfo's cumulative crc, ECBackend.cc:2530).  The raw crc rides the
        reply so the primary can cross-check it against its own hinfo."""
        try:
            got = self.store.read(key)
        except IOError:
            return True, False, 0, 0  # unreadable = scrub error
        if got is None:
            return False, False, 0, 0
        chunk, meta = got
        crc = shard_crc(chunk)
        # accept-either: a persisted chunk_crc may predate a checksum
        # algorithm change (crc32c vs zlib) — scrub must not flag every
        # pre-upgrade object as corrupted
        ok = crc == meta.chunk_crc or crc_verify_any(chunk, meta.chunk_crc)
        try:
            raw = self.store.getattr(key, HashInfo.XATTR_KEY)
        except (IOError, OSError):
            raw = None  # unreadable xattr: scrub treats as missing hinfo
        if raw:
            try:
                h = HashInfo.decode(raw)
                if shard < len(h.crcs):
                    ok = ok and (h.crcs[shard] == crc
                                 or crc_verify_any(chunk, h.crcs[shard])) \
                        and h.total_chunk_size == len(chunk)
            except (ValueError, KeyError, TypeError):
                ok = False  # unparseable hinfo is itself a scrub error
        return True, ok, meta.version, crc

    def _hinfo_cross_check(self, pool_id: int, oid: str,
                           acting: List[int]) -> Optional[HashInfo]:
        """The primary's own stored hinfo record, IF it is clean (no splice
        since the last full write): then its per-shard crcs are
        authoritative for every shard and scrub replies can be compared
        against it — catching a shard whose blob, meta crc AND own hinfo
        entry were all consistently rewritten.  Dirty records (stale
        non-self entries) opt out, which is exactly what HashInfo.dirty
        exists to mark."""
        for shard, osd in enumerate(acting):
            if osd != self.osd_id:
                continue
            try:
                raw = self.store.getattr((pool_id, oid, shard),
                                         HashInfo.XATTR_KEY)
            except (IOError, OSError):
                return None
            if not raw:
                return None
            try:
                h = HashInfo.decode(raw)
            except (ValueError, KeyError, TypeError):
                return None
            return None if h.dirty else h
        return None

    async def _handle_scrub_shard(self, msg: MScrubShard) -> None:
        key = (msg.pool_id, msg.oid, msg.shard)
        present, crc_ok, version, crc = self._scrub_shard_state(key, msg.shard)
        try:
            await self.messenger.send(
                tuple(msg.reply_to),
                MScrubShardReply(tid=msg.tid, osd_id=self.osd_id,
                                 shard=msg.shard, present=present,
                                 crc_ok=crc_ok, version=version, crc=crc))
        except (ConnectionError, OSError):
            pass

    # -- cache tier (reference HitSet + tiering agent, here over the
    #    planar HBM residency; policy classes in ceph_tpu/rados/tiering.py) --

    def _tier_enabled(self, pool: PoolInfo) -> bool:
        return (pool.pool_type == "ec"
                and bool(self.conf.get("osd_tier_enabled", True)))

    def _tier_opt(self, pool: PoolInfo, key: str, default, cast):
        """One tier tunable: the pool's mon-settable opt (reference
        `ceph osd pool set NAME hit_set_period ...`) wins over the OSD
        config default; garbage values fall back to the default rather
        than wedging the read path."""
        opts = getattr(pool, "opts", {}) or {}
        raw = opts.get(key)
        if raw is None:
            raw = self.conf.get(f"osd_{key}", default)
        try:
            return cast(raw)
        except (TypeError, ValueError):
            return cast(default)

    def _tier_archive(self, pool: PoolInfo, pg: int) -> HitSetArchive:
        """The PG's hit-set archive; a pool-param change RETUNES it in
        place (HitSetArchive.retune) so temperature history survives —
        rebuilding from scratch (the r10 behavior) read every resident
        as cold and the next agent pass evicted the working set."""
        key = (pool.pool_id, pg)
        period = max(1e-3, self._tier_opt(pool, "hit_set_period", 2.0,
                                          float))
        count = max(1, self._tier_opt(pool, "hit_set_count", 8, int))
        target = self._tier_opt(pool, "hit_set_target_size", 128, int)
        fpp = self._tier_opt(pool, "hit_set_fpp", 0.05, float)
        arch = self._hit_sets.get(key)
        if arch is None:
            arch = HitSetArchive(period, count, target, fpp,
                                 seed=(pool.pool_id << 20) | pg)
            self._hit_sets[key] = arch
            self.tier_perf.set("hit_sets", len(self._hit_sets))
        elif arch.params_key() != (period, count, target, fpp):
            arch.retune(period, count, target, fpp)
        return arch

    def _tier_cache_mode(self, pool: PoolInfo) -> str:
        """The pool's cache mode (mon-validated pool opt `cache_mode`
        over the osd_tier_cache_mode default).  writeback engages only
        with the paged store underneath (dirty bits live there); an
        unknown value reads as writethrough — never half-engage."""
        opts = getattr(pool, "opts", {}) or {}
        mode = opts.get("cache_mode") or self.conf.get(
            "osd_tier_cache_mode", "writethrough")
        return mode if mode in ("writeback", "writethrough") \
            else "writethrough"

    def _tier_dirty_ratio(self) -> float:
        """Dirty high-water as a fraction of the tier target (reference
        cache_target_dirty_ratio): tightest of the OSD default and any
        pool's mon-set opt, same composition rule as the full ratio."""
        ratio = float(self.conf.get("osd_cache_target_dirty_ratio", 0.4)
                      or 0.4)
        if self.osdmap is not None:
            for pool in self.osdmap.pools.values():
                raw = (getattr(pool, "opts", {}) or {}).get(
                    "cache_target_dirty_ratio")
                if raw:
                    try:
                        ratio = min(ratio, float(raw))
                    except (TypeError, ValueError):
                        pass
        return min(max(ratio, 0.01), 1.0)

    def _install_resident(self, pkey, planar, version: int,
                          object_size: int, k: int) -> bool:
        """Install a planar_encode_async product as a CLEAN resident.
        The paged store gets the trim (drop the encode lane's pow2 pad
        before paging — the fragmentation win) and the data-row
        boundary (shed_parity's partial-eviction line); the monolithic
        store keeps its r10 shape.  False = paged refusal (pool full of
        dirty / oversized), the caller stays cold."""
        _, all_bits, n_rows, n_cols, pw = planar
        store = self._planar
        if self._paged_store() is not None:
            return store.put_planar(
                pkey, all_bits, w=pw, n_rows=n_rows,
                meta=(version, n_cols, object_size),
                trim=n_cols, data_rows=k * pw)
        store.put_planar(pkey, all_bits, w=pw, n_rows=n_rows,
                         meta=(version, n_cols, object_size))
        return True

    def _tier_write_install(self, op: MOSDOp, pool: PoolInfo, pg: int,
                            acting: List[int], nbytes: int,
                            full: bool) -> Optional[str]:
        """Write-path tier hook, the r10 OPEN tail closed: writes record
        hits in the PG hit set like reads do (write heat is heat), and
        resident installation goes through the SAME recency/throttle
        gate as read promotion — no more unconditional installs making a
        hot write set indistinguishable from a cold one under pressure.
        Returns None (no residency), "clean" (install after commit, the
        write-through shape) or "writeback" (install dirty pages and
        defer the local shard store apply to flush)."""
        if not self._tier_enabled(pool):
            # residency predates the tier: a disabled tier keeps the
            # unconditional EC-pipeline install (and records nothing)
            return "clean" if full and self._planar is not None else None
        if getattr(op, "fadvise", "") == "dontneed":
            return None
        arch = self._tier_archive(pool, pg)
        rotated = arch.record(op.oid)
        self.tier_perf.inc("write_hits_recorded")
        if rotated:
            self.tier_perf.inc("hitset_rotations")
            worst = max((a.estimated_fpp()
                         for a in self._hit_sets.values()), default=0.0)
            self.tier_perf.set("hitset_fpp_ppm", int(worst * 1e6))
            self._replicate_hit_set(pool, pg, acting, arch)
        if not full or self._planar is None or not nbytes:
            return None
        recency_min = self._tier_opt(
            pool, "min_write_recency_for_promote", 1, int)
        if getattr(op, "fadvise", "") != "willneed" \
                and arch.recency(op.oid) < recency_min:
            self.tier_perf.inc("write_install_gated")
            return None
        if not planar_eligible(self._codec(pool)):
            return None  # the encode will skip planing anyway
        if not self._promote_throttle.allow(nbytes):
            self.tier_perf.inc("write_install_throttled")
            return None
        self.tier_perf.inc("write_installs")
        if self._tier_cache_mode(pool) == "writeback" \
                and self._paged_store() is not None:
            return "writeback"
        return "clean"

    def _tier_writeback_install(self, op: MOSDOp, pool: PoolInfo,
                                pg: int, planar, version: int,
                                object_size: int, entry,
                                local_shards: List[int], shard_crcs,
                                hinfo_blob: bytes, data) -> set:
        """Writeback install: the local shards' store applies are
        DEFERRED — the PG log entry commits now (same txn discipline as
        the write-through apply), the shard bytes live in resident
        pages marked dirty, and the flush contract (WritebackRecord)
        rides the entry so flush-before-evict / demote / scrub / RMW
        can replay the apply byte-identically later.  Returns the set
        of shards whose apply was deferred; empty = the paged pool
        refused (caller falls back to write-through).  Durability is
        UNCHANGED versus write-through: the remote k+m-1 shards commit
        exactly as before, the log entry is persisted, and losing this
        process loses its local shards either way (store and pages are
        both process-local) — what writeback buys is the local crc +
        store transaction off the hot write path, batched into the
        agent's flush cadence."""
        from ceph_tpu_torch.rados.pagestore import WritebackRecord

        store = self._paged_store()
        _, all_bits, n_rows, n_cols, pw = planar
        # failsafe BEFORE any mutation, exactly like _apply_shard_write:
        # a write whose eventual flush could not land must refuse now,
        # not wedge as unflushable dirt
        if self._failsafe_full(len(local_shards) * n_cols):
            raise ENOSPCError(
                f"osd.{self.osd_id} failsafe full: refusing "
                f"writeback install of {len(local_shards)} shards")
        k = self._codec(pool).get_data_chunk_count()
        rec = WritebackRecord(
            pool_id=op.pool_id, oid=op.oid, pg=pg, version=version,
            object_size=object_size, hinfo=hinfo_blob,
            shards=tuple(local_shards),
            crcs={s: shard_crcs[s] for s in local_shards
                  if shard_crcs is not None})
        pkey = self._planar_key(op.pool_id, op.oid)
        ok = store.put_planar(
            pkey, all_bits, w=pw, n_rows=n_rows,
            meta=(version, n_cols, object_size),
            trim=n_cols, data_rows=k * pw,
            dirty_rows=[(s * pw, (s + 1) * pw) for s in local_shards],
            dirty_info=rec)
        if not ok:
            return set()
        # the log entry commits in its own txn NOW — flush replays only
        # the data apply, never the log (the log is what reads validate
        # the resident against)
        txn = Transaction()
        self._log_in_txn(txn, op.pool_id, pg, entry)
        self.store.queue_transaction(txn)
        if isinstance(data, bytes) and len(data) == object_size:
            store.memo_put(pkey, version, data)
        return set(local_shards)

    def _tier_flush_key(self, pkey) -> bool:
        """Flush one dirty resident: replay the deferred local shard
        applies from its pages (byte-identical to the write-through
        path — same version, hinfo, crc) and clear the dirty bits.
        Generation-tokened: an overwrite that re-installed mid-flush
        keeps ITS dirt.  False leaves the entry dirty (ENOSPC, raced
        install) — eviction stays refused."""
        store = self._paged_store()
        if store is None:
            return True
        snap = store.peek_dirty(pkey)
        if snap is None:
            return True
        info, gen = snap
        if isinstance(info, CacheDirtyRecord):
            # raw fast-ack record: no deferred shard applies to replay —
            # only the async destage plane (_tier_flush_raw_key) may
            # move it (it owns the encode and the k+m fan-out)
            return False
        einfo = store.entry_info(pkey)
        if einfo is None or not einfo[2] or einfo[2][0] != info.version:
            return False  # raced a re-install; the new dirt flushes later
        # defense in depth: the PG log head is the authority on the
        # object's newest version.  A record the log has moved past
        # (a newer write or delete landed write-through) must NEVER
        # replay — it would stamp old bytes over the committed newer
        # shard.  The superseding op owns the object now; the dirt is
        # moot, clear it.
        ent = self._pglog(info.pool_id, info.pg).latest_entry(info.oid)
        if ent is not None and (ent.op != "write"
                                or ent.object_version != info.version):
            store.clear_dirty(pkey, gen)
            return True
        total = 0
        for shard in info.shards:
            blob = planar_shard_bytes(store, pkey, info.version, shard)
            if blob is None:
                return False
            try:
                if not self._apply_shard_write(
                        info.pool_id, info.oid, shard, blob,
                        info.version, info.object_size,
                        hinfo=info.hinfo,
                        chunk_crc=info.crcs.get(shard)):
                    return False
            except ENOSPCError:
                return False
            total += len(blob)
        if store.clear_dirty(pkey, gen):
            store.perf.inc("flushes")
            store.perf.inc("flush_bytes", total)
        return True

    def _my_dirty_items(self, store, pool_id: Optional[int] = None,
                        pg: int = -1):
        """THIS OSD's dirty residents ((key, WritebackRecord, gen,
        dirty_since), oldest-dirty first), optionally scoped to one
        pool / PG.  The one home for the shared-store key-namespace
        rule (keys are (osd_id, pool_id, oid) — see _planar_key): the
        flush planes must never flush, or skip, another colocated
        OSD's dirt."""
        out = []
        for key, info, gen, since in store.dirty_items():
            if not (isinstance(key, tuple) and len(key) == 3
                    and key[0] == self.osd_id) or info is None:
                continue
            if pool_id is not None and info.pool_id != pool_id:
                continue
            if pg >= 0 and info.pg != pg:
                continue
            out.append((key, info, gen, since))
        return out

    def _cache_dirty_summary(self) -> List[Tuple[str, List[int]]]:
        """The safe-to-destroy roster riding MPing (v5): every
        un-destaged dirty object this OSD holds, with the full live-copy
        holder set.  Raw fast-ack records carry their cache replica
        roster (the acked bytes exist ONLY on those peers until
        destage); deferred-apply WritebackRecords are purely local dirt.
        The mon's predicates refuse destroy/stop while a target is the
        last live holder of any key."""
        store = self._paged_store()
        if store is None:
            return []
        out: List[Tuple[str, List[int]]] = []
        for _key, info, _gen, _since in self._my_dirty_items(store):
            key = f"{info.pool_id}:{info.oid}"
            if isinstance(info, CacheDirtyRecord):
                holders = sorted({*info.peers, info.primary, self.osd_id})
            else:
                holders = [self.osd_id]
            out.append((key, holders))
        return out

    def _tier_flush_pass(self, store, target: int, forced: bool) -> None:
        """The agent's flush plane: dirty residents flush when dirty
        bytes exceed cache_target_dirty_ratio x target, when they age
        past osd_tier_flush_age, or unconditionally under fullness
        pressure (NEARFULL on the backing store forces dirty flush
        ahead of eviction — the r15 hook)."""
        if not store.has_dirty():
            return
        ratio = self._tier_dirty_ratio()
        age = float(self.conf.get("osd_tier_flush_age", 5.0) or 0)
        now = time.monotonic()
        dirty_target = int(target * ratio)
        for key, _info, _gen, since in self._my_dirty_items(store):
            if isinstance(_info, CacheDirtyRecord):
                continue  # raw records destage via _tier_flush_raw_pass
            over = store.dirty_bytes > dirty_target
            aged = age > 0 and (now - since) >= age
            if not (forced or over or aged):
                continue
            if self._tier_flush_key(key):
                self.tier_perf.inc("flush_agent")
            else:
                self.tier_perf.inc("flush_error")

    def _dirty_subread_fence(self, msg, got):
        """Writeback fence for peer sub-reads: when this OSD's local
        shard apply is still deferred in dirty pages, a peer asking for
        the shard (shard hunt, recovery pull, a new primary's quorum
        read) must see the ACKED bytes, not the stale/absent store
        blob.  Someone reading the backing store ends the deferral:
        flush the resident and serve the fresh store read — version,
        crc, and hinfo all land consistent in one move."""
        store = self._paged_store()
        if store is None:
            return got
        pkey = self._planar_key(msg.pool_id, msg.oid)
        snap = store.peek_dirty(pkey)
        if snap is None or snap[0] is None:
            return got
        rec = snap[0]
        if isinstance(rec, CacheDirtyRecord):
            return got  # raw record: _raw_subread_fence already ran
        if msg.shard not in rec.shards:
            return got
        if got is not None and got[1].version >= rec.version:
            return got
        if not self._tier_flush_key(pkey):
            self.tier_perf.inc("flush_error")
            return got
        self.tier_perf.inc("dirty_subread_served")
        try:
            return self.store.read((msg.pool_id, msg.oid, msg.shard))
        except IOError:
            return got

    def _tier_flush_demoted(self) -> None:
        """Flush every dirty resident whose PG this OSD no longer leads
        (map-change hook).  Writeback must never be the only copy of
        acked data once primaryship moved: the new primary's sub-reads
        and recovery hit our BACKING store, so the deferred applies
        land before we stop answering for the PG."""
        store = self._paged_store()
        if store is None or not store.has_dirty() or self.osdmap is None:
            return
        for key, info, _gen, _since in self._my_dirty_items(store):
            pool = self.osdmap.pools.get(info.pool_id)
            if pool is None:
                store.drop(key, force=True)  # pool gone: data gone too
                continue
            if isinstance(info, CacheDirtyRecord):
                # raw fast-ack dirt moves by REPLICATION, not local
                # flush: _tier_raw_replay_sweep (same map hook) pushes
                # the copy to the new primary / destages inherited dirt
                continue
            if info.pg >= pool.pg_num:
                if self._tier_flush_key(key):
                    self.tier_perf.inc("flush_demote")
                continue
            acting = self.osdmap.pg_to_acting(pool, info.pg)
            if self._primary(pool, info.pg, acting) != self.osd_id:
                if self._tier_flush_key(key):
                    self.tier_perf.inc("flush_demote")
                else:
                    self.tier_perf.inc("flush_error")

    # -- replicated-writeback fast ack (r22): a full-object put under
    #    cache_mode writeback commits the RAW object on a cache quorum
    #    (primary dirty pages + osd_cache_min_size-1 acting peers'
    #    adopted copies, MCacheDirty/MCacheDirtyAck) and acks there; the
    #    k+m encode and sub-write fan-out run later as a classed
    #    background op (CLASS_FLUSH).  Primary death before flush is
    #    recovered by the new primary replaying the freshest replica
    #    copy (_tier_raw_replay_sweep) and completing the destage. ----

    async def _tier_fast_ack_write(self, op: MOSDOp, pool: PoolInfo,
                                   pg: int, acting: List[int], data,
                                   object_size: int, span,
                                   mark) -> Optional[MOSDOpReply]:
        """The fast-ack put: install the raw dirty object locally,
        replicate it to the first cache_min_size-1 live acting peers,
        ack at that quorum.  None = the quorum cannot form or the store
        refused — the caller falls back to synchronous write-through
        (the degradation contract, counted wb_quorum_short)."""
        store = self._paged_store()
        if store is None:
            return None
        cache_min = max(1, self._tier_opt(pool, "cache_min_size", 2, int))
        peers: List[int] = []
        for osd in acting:
            if osd in (CRUSH_ITEM_NONE, self.osd_id) or osd in peers:
                continue  # pg_to_acting already holed-out down members
            peers.append(osd)
        peers = peers[:cache_min - 1]
        if len(peers) < cache_min - 1:
            self.tier_perf.inc("wb_quorum_short")
            return None
        # failsafe BEFORE any mutation (the _apply_shard_write rule): a
        # put whose eventual flush could not land must refuse now, not
        # wedge as unflushable dirt
        if self._failsafe_full(object_size):
            return None
        raw = bytes(data)
        pkey = self._planar_key(op.pool_id, op.oid)
        log = self._pglog(op.pool_id, pg)
        # synchronous window: eversion -> raw install -> log txn with
        # no awaits, the same discipline as the EC path — a concurrent
        # log merge cannot advance the head under a version we already
        # handed out
        entry = LogEntry(version=log.next_version(self.osdmap.epoch),
                         op="write", oid=op.oid, prior_version=log.head,
                         reqid=op.reqid)
        version = pack_eversion(entry.version)
        entry.object_version = version
        entry.cache_peers = (self.osd_id,) + tuple(peers)
        rec = CacheDirtyRecord(
            pool_id=op.pool_id, oid=op.oid, pg=pg, version=version,
            object_size=object_size, primary=self.osd_id,
            peers=(self.osd_id,) + tuple(peers))
        if not store.put_raw(pkey, raw, meta=(version, -1, object_size),
                             dirty_info=rec):
            self.tier_perf.inc("wb_quorum_short")
            return None  # paged pool refused: write-through instead
        entry_blob = entry.encode()
        txn = Transaction()
        self._log_in_txn(txn, op.pool_id, pg, entry)
        self.store.queue_transaction(txn)
        store.memo_put(pkey, version, raw)
        span.event("raw dirty installed")
        mark("wb_raw_installed")
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        sends = []
        for osd in peers:
            sends.append(self.messenger.send(
                self.osdmap.addr_of(osd),
                MCacheDirty(
                    pool_id=op.pool_id, pg=pg, oid=op.oid, op="install",
                    data=raw, version=version, object_size=object_size,
                    tid=tid, reply_to=self.addr, log_entry=entry_blob,
                    peers=list(rec.peers), from_osd=self.osd_id,
                    epoch=self.osdmap.epoch)))
        sent = 0
        for got in await asyncio.gather(*sends, return_exceptions=True):
            if got is None:
                sent += 1
            elif not isinstance(got, TRANSPORT_ERRORS):
                raise got
        mark("cache_repl_sent")
        replies = await self._gather(tid, q, sent)
        acks = 1 + sum(1 for r in replies if r.ok)  # self + adopters
        span.event(f"cache quorum {acks}/{cache_min}")
        if acks < cache_min:
            # an adopter refused or died mid-replication: the raw copy
            # is NOT on cache_min_size processes, so the fast ack's
            # durability claim does not hold.  Degrade THIS op to the
            # synchronous bar: destage the EC shards inline and ack only
            # if that lands at pool min_size (write-through durability).
            self.tier_perf.inc("wb_quorum_short")
            if await self._tier_flush_raw_key(pkey):
                self._cache_put(op.pool_id, op.oid, version, raw)
                mark("wb_inline_flushed")
                return MOSDOpReply(ok=True)
            self._mark_failed_write(op.reqid)
            self._cache_drop(op.pool_id, op.oid)
            self._tier_raw_clear_peers(rec)
            return MOSDOpReply(
                ok=False, code=-errno.EBUSY,
                error=f"writeback acked by {acks} < cache min_size "
                      f"{cache_min} and inline flush failed")
        self.tier_perf.inc("wb_repl_acks")
        self.tier_perf.inc("wb_repl_bytes", len(raw) * len(peers))
        self._update_flush_backlog()
        self._cache_put(op.pool_id, op.oid, version, raw)
        mark("wb_acked")
        return MOSDOpReply(ok=True)

    async def _handle_cache_dirty(self, msg: MCacheDirty) -> None:
        """Receiver half of the fast-ack pair.  op=install adopts the
        raw dirty copy (pages + memo + the PG log entry — the durability
        unit the ack claims); op=clear is the owner's post-flush (or
        failed-write) release, version-fenced so a newer adopted copy
        keeps its dirt.  An install landing on the PG's CURRENT primary
        from a non-primary sender is a recovery push: adopt, then
        complete the dead installer's deferred destage."""
        store = self._paged_store()
        pkey = self._planar_key(msg.pool_id, msg.oid)
        if msg.op == "clear":
            if store is not None:
                snap = store.peek_dirty(pkey)
                if snap is not None \
                        and isinstance(snap[0], CacheDirtyRecord) \
                        and snap[0].version <= msg.version:
                    store.clear_dirty(pkey, snap[1])
                    store.drop(pkey, force=True)
                self._update_flush_backlog()
            return
        ok = store is not None and self.osdmap is not None
        recovery_push = False
        if ok:
            # interval fence (the _apply_sub_write rule): catch up when
            # the sender's map is newer, refuse a deposed sender
            if msg.epoch > self.osdmap.epoch:
                await self._fetch_full_map()
            pool = self.osdmap.pools.get(msg.pool_id)
            if pool is None:
                ok = False
            else:
                acting = self.osdmap.pg_to_acting(pool, msg.pg)
                prim = self._primary(pool, msg.pg, acting)
                if prim == self.osd_id and msg.from_osd != self.osd_id:
                    recovery_push = True
                elif prim not in (msg.from_osd, None):
                    ok = False
        if ok:
            cur = store.resident_meta(pkey)
            if cur and cur[0] >= msg.version:
                # duplicate / stale push: our copy is already at (or
                # past) this version — adopting would rewind.  Ack ok:
                # the sender's durability claim holds either way.
                pass
            else:
                raw = as_bytes(msg.data)
                peers = tuple(int(x) for x in (msg.peers or ()))
                rec = CacheDirtyRecord(
                    pool_id=msg.pool_id, oid=msg.oid, pg=msg.pg,
                    version=msg.version, object_size=msg.object_size,
                    primary=(self.osd_id if recovery_push
                             else msg.from_osd),
                    peers=peers or (msg.from_osd, self.osd_id))
                if store.put_raw(pkey, raw,
                                 meta=(msg.version, -1, msg.object_size),
                                 dirty_info=rec):
                    if msg.log_entry:
                        entry = LogEntry.decode(msg.log_entry)
                        entry.version = tuple(entry.version)
                        entry.prior_version = tuple(entry.prior_version)
                        txn = Transaction()
                        self._log_in_txn(txn, msg.pool_id, msg.pg, entry)
                        self.store.queue_transaction(txn)
                    store.memo_put(pkey, msg.version, raw)
                    # a stale decode of the OLD version must die, but
                    # NOT the raw pages we just installed — so the
                    # extent cache only, never _cache_drop
                    self._extent_cache.drop((msg.pool_id, msg.oid))
                    self.tier_perf.inc("wb_dirty_adopted")
                    self._update_flush_backlog()
                else:
                    ok = False
        if msg.tid:
            try:
                await self.messenger.send(
                    tuple(msg.reply_to),
                    MCacheDirtyAck(tid=msg.tid, osd=self.osd_id, ok=ok))
            except TRANSPORT_ERRORS:
                pass
        if ok and recovery_push:
            # we are the PG's new primary holding a pushed copy of a
            # dead primary's acked write: finish its flush
            self._spawn_tier_task(self._tier_flush_raw_key(pkey))

    def _tier_raw_clear_peers(self, rec: CacheDirtyRecord) -> None:
        """Fire-and-forget release of the peers' adopted copies (post
        flush, or failed-write cleanup).  Version-fenced at the
        receiver; a lost clear is mopped up by the adopted-copy GC in
        _tier_flush_raw_pass."""
        if self.osdmap is None:
            return

        async def _clear_one(osd: int) -> None:
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MCacheDirty(pool_id=rec.pool_id, pg=rec.pg,
                                oid=rec.oid, op="clear",
                                version=rec.version,
                                from_osd=self.osd_id,
                                epoch=self.osdmap.epoch))
            except TRANSPORT_ERRORS:
                pass

        for osd in rec.peers:
            if osd == self.osd_id or osd not in self.osdmap.osds:
                continue
            self._spawn_tier_task(_clear_one(osd))

    async def _tier_flush_any(self, pkey) -> bool:
        """Route one dirty resident to its flush plane: raw fast-ack
        records destage through the async encode+fan-out path, legacy
        WritebackRecords replay synchronously.  The one entry point for
        the RMW / scrub fences (both async contexts)."""
        store = self._paged_store()
        if store is None:
            return True
        snap = store.peek_dirty(pkey)
        if snap is None:
            return True
        if isinstance(snap[0], CacheDirtyRecord):
            return await self._tier_flush_raw_key(pkey)
        return self._tier_flush_key(pkey)

    async def _tier_flush_raw_key(self, pkey,
                                  background: bool = False) -> bool:
        """Destage one raw fast-ack record: k+m encode the raw object,
        fan the sub-writes out exactly as the write path would have, and
        clear the dirt at pool min_size acks.  Generation-tokened like
        _tier_flush_key: an overwrite that re-installed mid-encode keeps
        ITS dirt (we simply stop owning the flush).  False leaves the
        entry dirty for the next pass."""
        store = self._paged_store()
        if store is None:
            return True
        if pkey in self._raw_flush_inflight:
            return False  # single-flight: another plane is destaging
        snap = store.peek_dirty(pkey)
        if snap is None:
            return True
        rec, gen = snap
        if not isinstance(rec, CacheDirtyRecord):
            return self._tier_flush_key(pkey)
        if self.osdmap is None:
            return False
        pool = self.osdmap.pools.get(rec.pool_id)
        if pool is None or rec.pg >= pool.pg_num:
            store.drop(pkey, force=True)  # pool gone: data gone too
            return True
        acting = self.osdmap.pg_to_acting(pool, rec.pg)
        if self._primary(pool, rec.pg, acting) != self.osd_id:
            return False  # not ours: the replay sweep routes it
        # PG-log-head defense (the _tier_flush_key rule): a record the
        # log moved past must never stamp old bytes over newer shards
        ent = self._pglog(rec.pool_id, rec.pg).latest_entry(rec.oid)
        if ent is not None and (ent.op != "write"
                                or ent.object_version != rec.version):
            # superseded (newer write / delete landed): the dirt is moot
            store.clear_dirty(pkey, gen)
            store.drop(pkey, force=True)
            self._update_flush_backlog()
            return True
        # ent None (trimmed window) still flushes: the record itself is
        # the durability contract, the entry just rides along when held
        data = store.memo_get(pkey, rec.version)
        if data is None:
            data = store.read_raw(pkey)
        if data is None:
            return False  # raced a drop/re-install; next pass re-peeks
        self._raw_flush_inflight.add(pkey)
        try:
            return await self._tier_flush_raw_inner(
                pkey, store, rec, gen, pool, acting, ent, bytes(data),
                background)
        finally:
            self._raw_flush_inflight.discard(pkey)

    async def _tier_flush_raw_inner(self, pkey, store,
                                    rec: CacheDirtyRecord, gen: int,
                                    pool: PoolInfo, acting: List[int],
                                    ent, data: bytes,
                                    background: bool) -> bool:
        if background:
            # classed background op: the destage waits its dmClock turn
            # under CLASS_FLUSH (above best_effort — the backlog holds
            # acked client data), cost scaled to the encode size
            await self._background_throttle(
                CLASS_FLUSH, (rec.pool_id << 20) | rec.pg,
                cost=max(1, len(data) // 65536))
        codec = self._codec(pool)
        sinfo = self._sinfo(pool)
        planar = await planar_encode_async(codec, sinfo, data,
                                           queue=self._ec_queue)
        if planar is not None:
            blobs = planar[0]
        else:
            blobs = await batched_encode_async(codec, sinfo, data,
                                               queue=self._ec_queue)
        # revalidate after the awaits: an overwrite that re-installed
        # mid-encode owns the dirt now (gen moved), and a map change may
        # have deposed us (the sweep re-routes)
        snap = store.peek_dirty(pkey)
        if snap is None or snap[1] != gen:
            return True  # superseded: this flush is no longer needed
        acting = self.osdmap.pg_to_acting(pool, rec.pg)
        if self._primary(pool, rec.pg, acting) != self.osd_id:
            return False
        n = codec.get_chunk_count()
        shard_crcs = [shard_crc(blobs[i]) for i in range(n)]
        hinfo_blob = self._hinfo_for(pool, blobs, crcs=shard_crcs)
        entry_blob = ent.encode() if ent is not None else b""
        self.tier_perf.inc("flush_encodes")
        tid = uuid.uuid4().hex
        local_ok = 0
        remote: List[Tuple[int, int]] = []
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            if osd == self.osd_id:
                try:
                    if self._apply_shard_write(
                            rec.pool_id, rec.oid, shard,
                            memoryview(np.ascontiguousarray(blobs[shard])),
                            rec.version, rec.object_size, pg=rec.pg,
                            entry=ent, hinfo=hinfo_blob,
                            chunk_crc=shard_crcs[shard]):
                        local_ok += 1
                except ENOSPCError:
                    return False
            else:
                remote.append((shard, osd))
        q = self._collector(tid)
        sends = []
        for shard, osd in remote:
            chunk = memoryview(np.ascontiguousarray(blobs[shard]))
            sends.append(self.messenger.send(
                self.osdmap.addr_of(osd),
                MECSubWrite(
                    pool_id=rec.pool_id, pg=rec.pg, oid=rec.oid,
                    shard=shard, chunk=chunk, version=rec.version,
                    object_size=rec.object_size,
                    chunk_crc=shard_crcs[shard], tid=tid,
                    reply_to=self.addr, log_entry=entry_blob,
                    hinfo=hinfo_blob, from_osd=self.osd_id,
                    epoch=self.osdmap.epoch)))
        sent = 0
        for got in await asyncio.gather(*sends, return_exceptions=True):
            if got is None:
                sent += 1
            elif not isinstance(got, TRANSPORT_ERRORS):
                raise got
        replies = await self._gather(tid, q, sent)
        acks = local_ok + sum(1 for r in replies if r.ok)
        if acks < pool.min_size:
            return False  # stays dirty; the next pass retries
        if store.clear_dirty(pkey, gen):
            store.perf.inc("flushes")
            store.perf.inc("flush_bytes", len(data))
            if planar is not None:
                # the raw entry served its purpose: swap the planar
                # rows in as a CLEAN resident (reads keep their
                # zero-shard-read path) and re-seed the memo
                if self._install_resident(pkey, planar, rec.version,
                                          rec.object_size,
                                          codec.get_data_chunk_count()):
                    store.memo_put(pkey, rec.version, data)
            self._tier_raw_clear_peers(rec)
        self._update_flush_backlog()
        return True

    async def _tier_flush_raw_pass(self) -> None:
        """The agent's raw destage plane: fast-ack records flush on the
        same dirty-ratio / age / fullness triggers as the legacy plane,
        throttled as CLASS_FLUSH background work; adopted copies whose
        write our PG log shows superseded (a lost clear) are GC'd."""
        self._update_flush_backlog()
        store = self._paged_store()
        if store is None or not store.has_dirty() or self.osdmap is None:
            return
        ratio = self._tier_dirty_ratio()
        age = float(self.conf.get("osd_tier_flush_age", 5.0) or 0)
        target = self._tier_effective_target()
        forced = bool(self._my_full_state())
        dirty_target = int(target * ratio)
        now = time.monotonic()
        for key, rec, gen, since in self._my_dirty_items(store):
            if not isinstance(rec, CacheDirtyRecord):
                continue
            pool = self.osdmap.pools.get(rec.pool_id)
            if pool is None:
                store.drop(key, force=True)
                continue
            acting = self.osdmap.pg_to_acting(pool, rec.pg)
            prim = self._primary(pool, rec.pg, acting)
            if prim != self.osd_id:
                # adopted copy: our only job is holding it until the
                # owner's clear.  GC when OUR log proves the write
                # superseded (delete / newer write landed) — the clear
                # was lost, the copy is moot.
                ent = self._pglog(rec.pool_id, rec.pg).latest_entry(
                    rec.oid)
                if ent is not None and (ent.op != "write"
                                        or ent.object_version
                                        > rec.version):
                    store.clear_dirty(key, gen)
                    store.drop(key, force=True)
                continue
            over = store.dirty_bytes > dirty_target
            aged = age > 0 and (now - since) >= age
            # inherited raw dirt (we lead the PG but the record names a
            # dead installer as primary — possible when the replay
            # sweep's one-shot recovery flush failed transiently, e.g.
            # min_size short mid-recovery) is a dead primary's acked
            # write: destage it NOW, not at the age/ratio leisure
            inherited = rec.primary != self.osd_id
            if not (forced or over or aged or inherited):
                continue
            if await self._tier_flush_raw_key(key, background=True):
                self.tier_perf.inc("flush_agent")
            else:
                self.tier_perf.inc("flush_error")
        self._update_flush_backlog()

    def _tier_raw_replay_sweep(self) -> None:
        """Map-change hook for raw fast-ack dirt — the durability half
        of the replicated-writeback contract.  A cache peer that
        outlived the writeback primary PUSHES its adopted copy to the
        PG's new primary; a new primary holding inherited raw dirt (its
        own adopted copy) completes the dead installer's deferred
        destage.  Steady state (the installer still leads the PG) is a
        no-op."""
        store = self._paged_store()
        if store is None or not store.has_dirty() or self.osdmap is None:
            return
        for key, rec, _gen, _since in self._my_dirty_items(store):
            if not isinstance(rec, CacheDirtyRecord):
                continue
            pool = self.osdmap.pools.get(rec.pool_id)
            if pool is None or rec.pg >= pool.pg_num:
                store.drop(key, force=True)
                continue
            acting = self.osdmap.pg_to_acting(pool, rec.pg)
            prim = self._primary(pool, rec.pg, acting)
            if prim is None:
                continue
            if prim == self.osd_id:
                if rec.primary != self.osd_id:
                    self._spawn_tier_task(self._tier_flush_raw_key(key))
            elif rec.primary != prim:
                # the installer lost the PG (died, or we were demoted
                # holding our own record): hand the copy to the new
                # primary so it can replay and destage
                self._spawn_tier_task(self._tier_raw_push(key, rec, prim))

    async def _tier_raw_push(self, pkey, rec: CacheDirtyRecord,
                             target: int) -> None:
        """Push our raw dirty copy to ``target`` (the PG's new primary).
        Our copy stays dirty until the destaging primary's post-flush
        clear — the push hands over the bytes, not the custody."""
        store = self._paged_store()
        if store is None or self.osdmap is None \
                or target not in self.osdmap.osds:
            return
        data = store.memo_get(pkey, rec.version)
        if data is None:
            data = store.read_raw(pkey)
        if data is None:
            return
        ent = self._pglog(rec.pool_id, rec.pg).latest_entry(rec.oid)
        blob = ent.encode() if ent is not None and getattr(
            ent, "object_version", 0) == rec.version else b""
        try:
            await self.messenger.send(
                self.osdmap.addr_of(target),
                MCacheDirty(
                    pool_id=rec.pool_id, pg=rec.pg, oid=rec.oid,
                    op="install", data=bytes(data), version=rec.version,
                    object_size=rec.object_size, log_entry=blob,
                    peers=list(rec.peers), from_osd=self.osd_id,
                    epoch=self.osdmap.epoch))
            self.tier_perf.inc("wb_repl_bytes", len(data))
        except TRANSPORT_ERRORS:
            pass

    async def _raw_subread_fence(self, msg, rec: CacheDirtyRecord, got):
        """Raw-record sibling of _dirty_subread_fence: the acked bytes
        exist only as a raw dirty object — no EC shard of this version
        exists anywhere yet.  On the record's OWNER a peer reading the
        backing store ends the deferral (flush, then serve the fresh
        store read); on a holder of an ADOPTED copy the requested shard
        is synthesized from the raw bytes without mutating anything —
        the store stays untouched and the copy stays dirty until the
        owner's clear (a new primary's quorum read must see the acked
        write without stealing custody)."""
        if got is not None and got[1].version >= rec.version:
            return got
        pkey = self._planar_key(msg.pool_id, msg.oid)
        pool = self.osdmap.pools.get(msg.pool_id) if self.osdmap else None
        if pool is None:
            return got
        if rec.primary == self.osd_id:
            if not await self._tier_flush_raw_key(pkey):
                self.tier_perf.inc("flush_error")
                return got
            self.tier_perf.inc("dirty_subread_served")
            try:
                return self.store.read((msg.pool_id, msg.oid, msg.shard))
            except IOError:
                return got
        store = self._paged_store()
        if store is None:
            return got
        data = store.memo_get(pkey, rec.version)
        if data is None:
            data = store.read_raw(pkey)
        if data is None:
            return got
        planar = await planar_encode_async(self._codec(pool),
                                           self._sinfo(pool),
                                           bytes(data), queue=None)
        if planar is None or msg.shard >= self._codec(
                pool).get_chunk_count():
            return got
        blob = bytes(np.ascontiguousarray(planar[0][msg.shard]))
        self.tier_perf.inc("dirty_subread_served")
        return (blob, ShardMeta(version=rec.version,
                                object_size=rec.object_size))

    def _update_flush_backlog(self) -> None:
        """flush_backlog_bytes gauge: acked-but-not-EC-durable raw
        dirty bytes this OSD currently holds (own records + adopted
        copies)."""
        store = self._paged_store()
        if store is None:
            return
        total = 0
        for _key, rec, _gen, _since in self._my_dirty_items(store):
            if isinstance(rec, CacheDirtyRecord):
                total += rec.object_size
        self.tier_perf.set("flush_backlog_bytes", total)

    def _spawn_tier_task(self, coro) -> None:
        """Fire-and-forget a tier coroutine on the running loop, tracked
        in the messenger's task set (the _tier_observe_read idiom).  No
        loop (sync test context): close the coroutine and skip — every
        caller is a best-effort hook whose next trigger retries."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            coro.close()
            return
        t = loop.create_task(coro)
        self.messenger._tasks.add(t)
        t.add_done_callback(self.messenger._tasks.discard)

    def _tier_observe_read(self, op: MOSDOp, reply: MOSDOpReply) -> None:
        """Read-path tier hook (reference PrimaryLogPG::maybe_promote):
        record the hit in the PG's hit-set archive and, when the
        object's recency crosses min_read_recency_for_promote (or the
        client fadvised willneed), promote its full stripe into the
        planar store — throttled by osd_tier_promote_max_objects_sec /
        _bytes_sec.  fadvise=dontneed reads neither record nor promote
        (scans and backups must not heat the working set)."""
        if op.fadvise == "dontneed" or self.osdmap is None:
            return
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None or not self._tier_enabled(pool):
            return
        pg, acting = self._acting(pool, op.oid)
        if self._primary(pool, pg, acting) != self.osd_id:
            return
        arch = self._tier_archive(pool, pg)
        rotated = arch.record(op.oid)
        self.tier_perf.inc("read_hits_recorded")
        if rotated:
            self.tier_perf.inc("hitset_rotations")
            worst = max((a.estimated_fpp()
                         for a in self._hit_sets.values()), default=0.0)
            self.tier_perf.set("hitset_fpp_ppm", int(worst * 1e6))
            self._replicate_hit_set(pool, pg, acting, arch)
        if self._planar is None:
            return
        # already resident at this version?  resident_meta: a policy
        # probe must not refresh LRU position, pollute the hit/miss
        # ratio, or (paged store) pay a page-table gather
        pkey = self._planar_key(op.pool_id, op.oid)
        rmeta = self._planar.resident_meta(pkey)
        if rmeta and rmeta[0] == reply.version:
            return
        if pkey in self._promoting:
            return  # racing reads fund one encode, not N
        recency_min = self._tier_opt(pool, "min_read_recency_for_promote",
                                     1, int)
        if op.fadvise != "willneed" and arch.recency(op.oid) < recency_min:
            return
        nbytes = len(reply.data)
        if not nbytes:
            return
        # eligibility BEFORE the throttle: a pool whose codec can never
        # plane (mapped/bit-layout plugins) must not burn shared tokens
        # on promotions that are guaranteed to skip — that would starve
        # promotable pools on the same OSD
        if not planar_eligible(self._codec(pool)):
            self.tier_perf.inc("promote_skipped")
            return
        if not self._promote_throttle.allow(nbytes):
            self.tier_perf.inc("promote_throttled")
            return
        # materialize once, AFTER the throttle: a scatter reply's views
        # are copied only for promotions that will actually run
        data = as_bytes(reply.data)
        self._promoting.add(pkey)
        t = asyncio.get_running_loop().create_task(
            self._promote_object(pool, op.oid, data, reply.version))
        self.messenger._tasks.add(t)
        t.add_done_callback(self.messenger._tasks.discard)

    async def _promote_object(self, pool: PoolInfo, oid: str, data: bytes,
                              version: int) -> None:
        """Pack the object's full stripe into the planar store as a
        device resident via the packed-bit lane; subsequent reads serve
        from the resident fast path (zero shard reads, zero decode) with
        byte-identical results — the serving path re-validates the
        resident's version against the PG log on every read."""
        try:
            await self._promote_object_inner(pool, oid, data, version)
        finally:
            self._promoting.discard(self._planar_key(pool.pool_id, oid))

    async def _promote_object_inner(self, pool: PoolInfo, oid: str,
                                    data: bytes, version: int) -> None:
        tracked = self.ctx.op_tracker.create(
            f"tier_promote({pool.pool_id} {oid})")
        try:
            tracked.mark_event("encode_dispatched")
            planar = await planar_encode_async(
                self._codec(pool), self._sinfo(pool), data,
                queue=self._ec_queue)
            if planar is None:
                # codec not planar-eligible (mapped/bit-layout plugins)
                self.tier_perf.inc("promote_skipped")
                tracked.mark_event("skipped")
                return
            # staleness gate: between the read and this install a write
            # may have landed.  The log check and the install below are
            # synchronous (no await between them), so a write appending
            # a newer entry either already moved the head (we skip) or
            # will install its own newer resident after ours.  A TRIMMED
            # log (latest_entry None — long-lived objects outlive the
            # per-PG log window) is NOT stale: no entry means no recent
            # write, and the serving paths re-validate the resident's
            # version on every read anyway, so a mis-install can never
            # be served.
            pg = self.osdmap.object_to_pg(pool, oid)
            ent = self._pglog(pool.pool_id, pg).latest_entry(oid)
            if ent is not None and (ent.op != "write"
                                    or ent.object_version != version):
                self.tier_perf.inc("promote_stale")
                tracked.mark_event("stale")
                return
            pkey = self._planar_key(pool.pool_id, oid)
            if not self._install_resident(
                    pkey, planar, version, len(data),
                    self._codec(pool).get_data_chunk_count()):
                # paged pool full of dirty / oversized resident: the
                # promotion stays cold and retries on a later read
                self.tier_perf.inc("promote_skipped")
                tracked.mark_event("refused")
                return
            # the promoted bytes ARE the pack of the resident's data
            # rows at this version: seed the exit-boundary memo so the
            # first resident hit serves host bytes with zero device
            # work (the pack is already paid — it happened as part of
            # this promote's encode)
            self._planar.memo_put(pkey, version, data)
            self.tier_perf.inc("promote")
            self.tier_perf.inc("promote_bytes", len(data))
            tracked.mark_event("installed")
        except (asyncio.CancelledError, GeneratorExit):
            raise
        except Exception as e:
            self.tier_perf.inc("promote_skipped")
            self.ctx.log.error(
                "osd", f"tier promote {oid}: {type(e).__name__}: {e}")
        finally:
            tracked.finish()

    def _replicate_hit_set(self, pool: PoolInfo, pg: int,
                           acting: List[int], arch: HitSetArchive) -> None:
        """Push the PG's encoded archive to the acting peers at rotation
        (reference hit_set_persist): a failover primary seeds its
        temperature state from the freshest received archive instead of
        restarting every object at cold.  Sends ride their own task —
        the read path must not serialize on peer sockets."""
        peers = [a for a in acting
                 if a not in (CRUSH_ITEM_NONE, self.osd_id)]
        if not peers:
            return
        msg = MOSDPGHitSet(pool_id=pool.pool_id, pg=pg,
                           from_osd=self.osd_id, epoch=self.osdmap.epoch,
                           archive=arch.encode())
        span = None
        if self._trace_on:
            span = self.ctx.tracer.new_trace("hitset push")
            span.tag("osd", self.osd_id).tag("pg", f"{pool.pool_id}.{pg}")
            msg.trace_id, msg.span_id = span.context()

        async def _send() -> None:
            tracked = self.ctx.op_tracker.create(
                f"hitset_push({pool.pool_id}.{pg})")
            try:
                for osd in peers:
                    info = self.osdmap.osds.get(osd)
                    if info is None or not info.up:
                        continue
                    try:
                        await self.messenger.send(
                            self.osdmap.addr_of(osd), msg)
                    except TRANSPORT_ERRORS:
                        pass  # the peer catches the next rotation's push
                tracked.mark_event("pushed")
            finally:
                tracked.finish()
                if span is not None:
                    span.finish()

        t = asyncio.get_running_loop().create_task(_send())
        self.messenger._tasks.add(t)
        t.add_done_callback(self.messenger._tasks.discard)

    def _handle_pg_hit_set(self, msg: MOSDPGHitSet) -> None:
        if msg.from_osd == self.osd_id or self.osdmap is None:
            return
        pool = self.osdmap.pools.get(msg.pool_id)
        if pool is None or msg.pg >= pool.pg_num:
            return
        acting = self.osdmap.pg_to_acting(pool, msg.pg)
        if self._primary(pool, msg.pg, acting) == self.osd_id:
            return  # we lead this PG: our live archive is authoritative
        key = (msg.pool_id, msg.pg)
        # epoch fencing: pushes from different senders have no ordering
        # on the wire — a delayed final push from a DEAD former primary
        # must not overwrite the fresher archive the current primary
        # already sent (the exact failover window the replication
        # exists for)
        if msg.epoch < self._hit_set_epochs.get(key, 0):
            return
        try:
            arch = HitSetArchive.decode(as_bytes(msg.archive))
        except ValueError:
            return  # truncated/foreign blob: keep local state
        self._hit_sets[key] = arch
        self._hit_set_epochs[key] = msg.epoch
        self.tier_perf.set("hit_sets", len(self._hit_sets))

    def _tier_effective_target(self) -> int:
        """The byte budget the agent enforces against: the OSD config
        (osd_tier_target_max_bytes, 0 = the planar store's capacity)
        tightened by any pool's mon-set target_max_bytes — the store is
        one process-shared HBM pool, so the tightest configured bound
        governs."""
        if self._planar is None:
            return 0
        target = int(self.conf.get("osd_tier_target_max_bytes", 0) or 0) \
            or self._planar.capacity_bytes
        if self.osdmap is not None:
            for pool in self.osdmap.pools.values():
                raw = (getattr(pool, "opts", {}) or {}).get(
                    "target_max_bytes")
                if raw:
                    try:
                        t = int(raw)
                    except (TypeError, ValueError):
                        continue
                    if t > 0:
                        target = min(target, t)
        return target

    def _tier_full_ratio(self) -> float:
        ratio = float(self.conf.get("osd_cache_target_full_ratio", 0.8)
                      or 0.8)
        if self.osdmap is not None:
            for pool in self.osdmap.pools.values():
                raw = (getattr(pool, "opts", {}) or {}).get(
                    "cache_target_full_ratio")
                if raw:
                    try:
                        ratio = min(ratio, float(raw))
                    except (TypeError, ValueError):
                        pass
        return min(max(ratio, 0.01), 1.0)

    def _maybe_schedule_tier_agent(self) -> None:
        """Tier agent scheduling (reference PrimaryLogPG::agent_work via
        the OSD's agent queue): at most ONE pass in flight, scheduled
        through the sharded op queue's best_effort class so mClock/WPQ
        arbitrate it against client and recovery work — the same
        discipline as the scrub scheduler."""
        if (self._planar is None or self.osdmap is None
                or self._tier_agent_busy
                or not self.conf.get("osd_tier_enabled", True)):
            return
        interval = float(self.conf.get("osd_tier_agent_interval", 0.5)
                         or 0)
        if interval <= 0:
            return
        now = time.monotonic()
        if now - self._last_tier_scan < interval:
            return
        self._last_tier_scan = now
        self._tier_agent_busy = True

        async def _enqueue() -> None:
            try:
                await self.op_queue.enqueue(
                    -2, self._tier_agent_pass, CLASS_BEST_EFFORT, cost=1)
            except BaseException:
                self._tier_agent_busy = False
                raise

        t = asyncio.get_running_loop().create_task(_enqueue())
        self.messenger._tasks.add(t)
        t.add_done_callback(self.messenger._tasks.discard)

    async def _tier_agent_pass(self) -> None:
        # the evict agent's pass is a tracked op like any other: a
        # wedged agent shows up in dump_ops_in_flight with its age
        tracked = self.ctx.op_tracker.create("tier_agent_pass")
        try:
            with self.tier_perf.time_avg("agent_pass_s"):
                # raw destage plane first: fast-ack dirt is acked client
                # data whose EC durability is still pending — it always
                # outranks eviction housekeeping (and eviction needs the
                # entries clean anyway)
                await self._tier_flush_raw_pass()
                self._tier_agent_once()
            tracked.mark_event("evicted")
        finally:
            self._tier_agent_busy = False
            tracked.finish()

    def _tier_agent_once(self) -> None:
        """One flush/evict pass.  Flush plane first (paged store only):
        dirty residents flush on the dirty-ratio / age / fullness
        triggers, and ALWAYS before their eviction — writeback pages are
        never dropped unflushed.  Then eviction: when resident bytes
        exceed cache_target_full_ratio of the effective target (which
        fullness pressure on the backing store SHRINKS by
        osd_tier_full_target_factor — the r15 nearfull hook), evict this
        OSD's residents coldest-temperature-first until back under, at
        O(page) granularity on the paged store: a candidate first sheds
        its parity-row page suffix (the data prefix keeps serving reads)
        and is fully dropped only if still needed.  An entry the LRU
        already dropped underneath the plan is a COUNTED no-op
        (agent_evict_noop), never an error — either side may win that
        race."""
        store = self._planar
        if store is None:
            return
        target = self._tier_effective_target()
        full_state = self._my_full_state()
        if full_state:
            # NEARFULL (or worse) on the backing store is eviction
            # pressure: the tier's effective target shrinks so residency
            # sheds while the store drains, and dirty pages flush AHEAD
            # of the eviction that needs them clean
            factor = float(self.conf.get("osd_tier_full_target_factor",
                                         0.5) or 0.5)
            target = int(target * min(max(factor, 0.0), 1.0))
        self.tier_perf.set("resident_target_bytes", target)
        if target <= 0:
            return
        paged = self._paged_store()
        if paged is not None:
            self._tier_flush_pass(paged, target, forced=bool(full_state))
        high = int(target * self._tier_full_ratio())
        if store.resident_bytes <= high:
            self.tier_perf.inc("agent_skip")
            return
        self.tier_perf.inc("agent_pass")
        self.ctx.dout("osd", 5,
                      f"tier agent pass: resident {store.resident_bytes} "
                      f"> high {high} (target {target})")
        excess = store.resident_bytes - high
        mine = [(k, b) for k, b in store.entries_snapshot()
                if isinstance(k, tuple) and len(k) == 3
                and k[0] == self.osd_id]
        my_bytes = sum(b for _, b in mine)
        # the store is process-shared and every colocated OSD's agent
        # fires on the same excess: evict only OUR proportional share of
        # it, or N agents would each purge the full excess (Nx
        # over-eviction -> promote/evict thrash).  Rounding up keeps the
        # shares covering the whole excess; the next pass (one agent
        # interval away) mops up any remainder.
        need = min(my_bytes, excess * my_bytes
                   // max(1, store.resident_bytes) + 1)

        def temp_of(key) -> float:
            _osd, pool_id, oid = key
            pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
            if pool is None:
                return 0.0
            arch = self._hit_sets.get(
                (pool_id, self.osdmap.object_to_pg(pool, oid)))
            return arch.temperature(oid) if arch is not None else 0.0

        freed = 0
        # the FULL coldest-first ranking (need=my_bytes covers every
        # entry): pages let eviction run in two tiers of violence —
        # first shed only PARITY page suffixes across the cold tail
        # (data prefixes keep serving resident reads at k/n footprint;
        # parity reconstructs from the store on demand), and only if
        # that cannot cover the excess, drop whole entries
        ranked = eviction_candidates(mine, temp_of, max(my_bytes, 1))
        if paged is not None:
            for key, _nb in ranked:
                if freed >= need:
                    break
                freed += paged.shed_parity(key)
        shed_total = freed
        for key, nbytes in ranked:
            if freed >= need:
                break
            if paged is not None:
                if paged.is_dirty(key):
                    _snap = paged.peek_dirty(key)
                    if _snap is not None \
                            and isinstance(_snap[0], CacheDirtyRecord):
                        # acked raw copy: only the async destage plane
                        # (or the owner's post-flush clear) releases it
                        continue
                    # flush-before-evict: an unflushable dirty entry is
                    # skipped, never dropped
                    if self._tier_flush_key(key):
                        self.tier_perf.inc("flush_evict")
                    else:
                        self.tier_perf.inc("flush_error")
                        continue
                # nbytes was snapshotted before the shed phase freed
                # this entry's parity pages
                nbytes = min(nbytes, paged.entry_nbytes(key))
            if store.drop(key):
                freed += nbytes
                self.tier_perf.inc("agent_evict")
                self.tier_perf.inc("agent_evict_bytes", nbytes)
            else:
                self.tier_perf.inc("agent_evict_noop")
        if shed_total:
            self.ctx.dout("osd", 5,
                          f"tier agent shed {shed_total} parity bytes "
                          f"(partial residency), dropped "
                          f"{max(0, freed - shed_total)} more")

    def tier_status(self) -> dict:
        """`tier status` admin-socket shape."""
        store = self._planar
        paged = self._paged_store()
        out = {
            "enabled": bool(self.conf.get("osd_tier_enabled", True)),
            "device_residency": store is not None,
            "resident_bytes": store.resident_bytes if store else 0,
            "memo_bytes": store.memo_bytes if store else 0,
            "resident_entries": len(store.entries_snapshot())
            if store else 0,
            "target_max_bytes": self._tier_effective_target(),
            "cache_target_full_ratio": self._tier_full_ratio(),
            "cache_target_dirty_ratio": self._tier_dirty_ratio(),
            "cache_mode": {
                pool.name: self._tier_cache_mode(pool)
                for pool in (self.osdmap.pools.values()
                             if self.osdmap else [])
                if pool.pool_type == "ec"},
            "hit_set_archives": len(self._hit_sets),
            # page occupancy / dirty bytes (None = monolithic r10 store)
            "pagestore": paged.page_stats() if paged is not None else None,
            "perf": self.tier_perf.dump(),
        }
        return out

    def _dump_hit_sets(self) -> dict:
        return {f"{pool_id}.{pg}": arch.dump()
                for (pool_id, pg), arch in sorted(self._hit_sets.items())}

    def _maybe_schedule_scrubs(self) -> None:
        """Self-scheduled deep scrub (reference osd_scrub_sched.h: PGs
        scrub themselves on configurable intervals, not only on operator
        request).  The due-scan is throttled, runs at most one scrub at
        a time, and runs it on its OWN task — the beacon loop must never
        block behind a scrub gather or the mon would mark this OSD down.
        A freshly-seen PG starts with a STAGGERED deadline (rank-spread
        fraction of the interval) so daemon start does not trigger a
        scrub burst."""
        interval = float(self.conf.get("osd_deep_scrub_interval", 3600.0)
                         or 0)
        if interval <= 0 or self.osdmap is None:
            return
        now = time.monotonic()
        if now - self._last_scrub_scan < max(interval / 20.0, 0.05):
            return
        if self._scrub_task is not None and not self._scrub_task.done():
            return  # one scrub at a time (reference scrub reservations)
        self._last_scrub_scan = now
        due: Optional[Tuple[float, PoolInfo, int]] = None
        for pool in list(self.osdmap.pools.values()):
            for pg in range(pool.pg_num):
                acting = self.osdmap.pg_to_acting(pool, pg)
                if self._primary(pool, pg, acting) != self.osd_id:
                    continue
                last = self._last_scrub.get((pool.pool_id, pg))
                if last is None:
                    # stagger the first due time across PGs and OSDs
                    self._last_scrub[(pool.pool_id, pg)] = now -                         interval * (((pg * 31 + self.osd_id * 17) % 97)
                                    / 97.0)
                    continue
                if now - last < interval:
                    continue
                if due is None or last < due[0]:
                    due = (last, pool, pg)
        if due is None:
            return
        _, pool, pg = due
        self._last_scrub[(pool.pool_id, pg)] = now

        async def _run() -> None:
            try:
                await self._deep_scrub_pg(pool, pg)
            except Exception:
                self.perf.inc("recovery_errors")

        self._scrub_task = asyncio.get_running_loop().create_task(_run())

    async def _deep_scrub_pg(self, pool: PoolInfo, pg: int) -> Dict[str, int]:
        """Deep scrub the objects of ONE PG this OSD leads."""
        return await self.deep_scrub_pool(pool, only_pg=pg)

    async def _pg_admin_scrub(self, pgid: str,
                              repair: bool = False) -> Dict[str, object]:
        """`ceph pg scrub/repair <pgid>` (MCommand tell aimed at the
        primary).  Scrub: one deep-scrub pass of the PG (mismatches
        raise PG_INCONSISTENT and self-repair).  Repair: scrub, then a
        forced-backfill statechart pass (catches silently-missing
        shards the logs cannot see), then a VERIFY re-scrub — zero
        mismatches on the verify pass clears the PG's inconsistency
        record."""
        try:
            pool_part, pg_part = str(pgid).split(".", 1)
            pool_id, pg = int(pool_part), int(pg_part, 16)
        except (ValueError, AttributeError):
            raise ValueError(f"bad pgid {pgid!r} (want <pool>.<hexpg>)")
        pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
        if pool is None or pg < 0 or pg >= pool.pg_num:
            raise ValueError(f"no such pg {pgid!r}")
        acting = self.osdmap.pg_to_acting(pool, pg)
        primary = self._primary(pool, pg, acting)
        if primary != self.osd_id:
            raise ValueError(
                f"osd.{self.osd_id} is not primary of {pgid} "
                f"(primary is osd.{primary})")
        summary: Dict[str, object] = dict(
            await self._deep_scrub_pg(pool, pg))
        if repair:
            m = self._machine(pool_id, pg)
            try:
                await self._peer_and_recover_pg(
                    m, pool, pg, acting, force_backfill=True,
                    reset_interval=True)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass  # verify scrub below judges the outcome
            verify = await self._deep_scrub_pg(pool, pg)
            summary["repaired"] = (int(summary.get("repaired", 0))
                                   + verify["repaired"])
            summary["errors_after_repair"] = verify["errors"]
            summary["verified_clean"] = verify["errors"] == 0
        summary["pgid"] = f"{pool_id}.{pg:x}"
        return summary

    async def deep_scrub_pool(self, pool: PoolInfo,
                              only_pg: int = -1) -> Dict[str, int]:
        """Primary-led deep scrub: every acting shard of every object this
        OSD is primary for recomputes its crc against stored meta; bad or
        missing shards are repaired by re-encode + push.

        Per-object work waits its dmClock turn under CLASS_SCRUB (the
        background-profile ride), mismatches are counted PER PG into
        ``_scrub_errors`` (-> OSD_SCRUB_ERRORS / PG_INCONSISTENT on the
        ping health field), and a pass that verifies a previously
        inconsistent PG clean CLEARS its entry — the repair-confirmed
        lifecycle `ceph pg repair` drives."""
        # writeback fence: scrub compares STORED shards, and a dirty
        # resident means our local shard's apply is still deferred —
        # flush first or every dirty object reads as a mismatch and
        # kicks a repair storm against bytes that were never wrong
        ps = self._paged_store()
        if ps is not None and ps.has_dirty():
            for key, _info, _gen, _since in self._my_dirty_items(
                    ps, pool_id=pool.pool_id, pg=only_pg):
                if await self._tier_flush_any(key):
                    self.tier_perf.inc("flush_scrub")
                else:
                    self.tier_perf.inc("flush_error")
        scrubbed = errors = repaired = 0
        pg_errors: Dict[int, int] = {}
        pg_repaired: Dict[int, int] = {}
        pgs_scanned: Set[int] = set()
        oids = sorted({
            oid for oid, _ in self._list_pool_objects(pool.pool_id)
            if only_pg < 0
            or self.osdmap.object_to_pg(pool, oid) == only_pg})
        # include objects whose shards live elsewhere (scoped to the one
        # PG when scrubbing one PG — peers filter server-side)
        for oid, shard, _v in await self._list_all_shards(pool.pool_id,
                                                          pg=only_pg):
            if oid not in oids:
                oids.append(oid)
        for oid in oids:
            pg, acting = self._acting(pool, oid)
            if self._primary(pool, pg, acting) != self.osd_id:
                continue
            if only_pg >= 0 and pg != only_pg:
                continue
            # classed background work: each object's scrub fan-out waits
            # its CLASS_SCRUB turn against client/recovery traffic
            await self._background_throttle(
                CLASS_SCRUB, (pool.pool_id << 20) | pg)
            pgs_scanned.add(pg)
            scrubbed += 1
            bad: List[Tuple[int, int]] = []  # (shard, osd)
            tid = uuid.uuid4().hex
            q = self._collector(tid)
            sent = 0
            local_results: List[MScrubShardReply] = []
            for shard, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE:
                    continue
                if osd == self.osd_id:
                    present, ok, _v, crc = self._scrub_shard_state(
                        (pool.pool_id, oid, shard), shard)
                    local_results.append(MScrubShardReply(
                        osd_id=self.osd_id, shard=shard,
                        present=present, crc_ok=ok, crc=crc))
                else:
                    try:
                        await self.messenger.send(
                            self.osdmap.addr_of(osd),
                            MScrubShard(pool_id=pool.pool_id, oid=oid,
                                        shard=shard, tid=tid,
                                        reply_to=self.addr))
                        sent += 1
                    except TRANSPORT_ERRORS:
                        pass
            replies = local_results + await self._gather(tid, q, sent,
                                                         timeout=2.0)
            by_shard = {r.shard: r for r in replies}
            x_bad: List[Tuple[int, int]] = []
            xcheck = (self._hinfo_cross_check(pool.pool_id, oid, acting)
                      if pool.pool_type == "ec" else None)
            for shard, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE:
                    continue
                r = by_shard.get(shard)
                if r is None or not r.present or not r.crc_ok:
                    bad.append((shard, osd))
                elif xcheck is not None and shard < len(xcheck.crcs) \
                        and xcheck.crcs[shard] != r.crc:
                    # cross-shard comparison against the primary's clean
                    # hinfo record: self-consistent rewrites still fail
                    x_bad.append((shard, osd))
            if x_bad:
                # a record disagreeing with more shards than the code can
                # even repair is itself the suspect copy: fall back to
                # self-checks only (the reference majority-votes hinfo)
                codec = self._codec(pool)
                m_count = codec.get_coding_chunk_count()
                if len(x_bad) <= m_count:
                    bad.extend(x_bad)
            if not bad:
                # the object is clean: its rollback slots are stale
                # retention — trim them (the reference trims rollback
                # extents once the interval is stable; scrub is our hook)
                txn = Transaction()
                for shard, osd in enumerate(acting):
                    if osd == self.osd_id:
                        txn.delete((pool.pool_id, oid, shard + PREV_SLOT))
                    elif osd != CRUSH_ITEM_NONE:
                        try:
                            await self.messenger.send(
                                self.osdmap.addr_of(osd),
                                MECSubDelete(pool_id=pool.pool_id, pg=pg,
                                             oid=oid,
                                             shard=shard + PREV_SLOT,
                                             tid="", reply_to=self.addr))
                        except TRANSPORT_ERRORS:
                            pass
                if txn.deletes:
                    self.store.queue_transaction(txn)
            if bad:
                errors += len(bad)
                pg_errors[pg] = pg_errors.get(pg, 0) + len(bad)
                self.perf.inc("scrub_errors_found", len(bad))
                # repair: reconstruct WITHOUT the damaged shards and
                # re-push them
                read = await self._do_read(
                    MOSDOp(op="read", pool_id=pool.pool_id, oid=oid),
                    exclude_shards=frozenset(s for s, _ in bad))
                if read.ok:
                    encoded = await self._encode_for(
                        pool, as_bytes(read.data), oid=oid,
                        version=read.version)
                    for shard, osd in bad:
                        push = MPushShard(
                            pool_id=pool.pool_id, pg=pg, oid=oid, shard=shard,
                            chunk=bytes(encoded[shard]), version=read.version,
                            object_size=len(read.data),
                            hinfo=self._hinfo_for(pool, encoded))
                        if osd == self.osd_id:
                            self._apply_push(push)
                            repaired += 1
                        else:
                            try:
                                await self.messenger.send(
                                    self.osdmap.addr_of(osd), push)
                                repaired += 1
                            except TRANSPORT_ERRORS:
                                continue
                        pg_repaired[pg] = pg_repaired.get(pg, 0) + 1
                        self.perf.inc("scrub_repaired")
        # raise/clear the per-PG inconsistency record this pass proved.
        # Mismatches RAISE (the repair that just ran is unverified until
        # a later pass re-reads the pushed shards); a scanned PG with
        # zero mismatches whose entry was raised earlier is repair-
        # confirmed — CLEAR it (the next ping omits the check).
        now = time.time()
        for pg in pgs_scanned:
            key = (pool.pool_id, pg)
            n_err = pg_errors.get(pg, 0)
            if n_err:
                first = key not in self._scrub_errors
                self._scrub_errors[key] = {
                    "errors": n_err,
                    "repaired": pg_repaired.get(pg, 0),
                    "stamp": now}
                if first:
                    self.clog.error(
                        f"pg {pool.pool_id}.{pg:x} deep-scrub: "
                        f"{n_err} inconsistent shard(s), "
                        f"{pg_repaired.get(pg, 0)} repaired")
            elif self._scrub_errors.pop(key, None) is not None:
                self.clog.info(
                    f"pg {pool.pool_id}.{pg:x} repair verified clean "
                    f"(PG_INCONSISTENT cleared)")
        return {"scrubbed": scrubbed, "errors": errors, "repaired": repaired}

    async def _list_all_shards(self, pool_id: int, pg: int = -1):
        """Union shard listing (oid, shard, version) across up OSDs,
        optionally scoped to one PG (peers filter server-side)."""
        tid = uuid.uuid4().hex
        peers = [o for o in self.osdmap.osds.values()
                 if o.up and o.osd_id != self.osd_id]
        q = self._collector(tid)
        sent = 0
        for o in peers:
            try:
                await self.messenger.send(
                    o.addr, MListShards(pool_id=pool_id, pg=pg, tid=tid,
                                        reply_to=self.addr))
                sent += 1
            except TRANSPORT_ERRORS:
                pass
        out = []
        pool = self.osdmap.pools.get(pool_id)
        for oid, shard in self._list_pool_objects(pool_id):
            if (pg >= 0 and pool is not None
                    and self.osdmap.object_to_pg(pool, oid) != pg):
                continue
            got = self._store_read((pool_id, oid, shard))
            if got is not None:
                out.append((oid, shard, got[1].version))
        for r in await self._gather(tid, q, sent):
            out.extend((o, s, v) for (o, s, v) in r.entries)
        return out

    # -- recovery ------------------------------------------------------------

    async def repair_pool(self, pool: PoolInfo) -> int:
        """Admin/safety-net repair: run one full statechart pass (GetInfo
        -> GetLog -> GetMissing -> recover/backfill) for every PG of the
        pool this OSD leads.  Normal recovery does NOT come through here —
        it is event-driven per PG from _on_map (_kick_peering)."""
        async def one(pg: int) -> int:
            pushed = 0
            # iterate to a verified no-op pass: pushes are fire-and-forget
            # and an admin repair must leave the PG actually clean, not
            # merely "progress was made"
            for round_ in range(4):
                acting = self.osdmap.pg_to_acting(pool, pg)
                if self._primary(pool, pg, acting) != self.osd_id:
                    return pushed
                m = self._machine(pool.pool_id, pg)
                try:
                    done, p = await self._peer_and_recover_pg(
                        m, pool, pg, acting,
                        force_backfill=self.conf.get("osd_repair_full_sweep",
                                                     True),
                        reset_interval=True)
                    pushed += p
                    if done:
                        return pushed
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    pass
                except ErasureCodeError as e:
                    # a codec failure is NOT recoverable by retrying
                    # forever: surface it, don't spin an eternal loop
                    self.perf.inc("recovery_errors")
                    self.ctx.log.error(
                        "osd",
                        f"repair pg {pool.pool_id}.{pg} codec error: {e}")
                    return pushed
                except Exception as e:
                    self.perf.inc("recovery_errors")
                    self.ctx.log.error(
                        "osd",
                        f"repair pg {pool.pool_id}.{pg}: {type(e).__name__}: {e}")
                await asyncio.sleep(0.25)
            return pushed

        # PGs peer concurrently (reservations bound the actual backfill
        # concurrency); a zombie peer stalling one PG's RPCs must not
        # serialize the whole pool's recovery behind it
        jobs = [
            one(pg) for pg in range(pool.pg_num)
            if self._primary(pool, pg,
                             self.osdmap.pg_to_acting(pool, pg)) == self.osd_id
        ]
        if not jobs:
            return 0
        return sum(await asyncio.gather(*jobs))

    def _scope_osds(self, pool: PoolInfo, pg: int,
                    up_only: bool = True) -> List[int]:
        """The OSDs that can possibly hold shards of this PG: current
        acting, crush up-set, and every member of intervals since the PG
        was last clean (_past_members / _prior_acting — the reference's
        past_intervals role).  Deletes, shard hunts, and backfill scans
        contact only this set instead of broadcasting to the cluster.
        ``up_only=False`` returns the full holder set including down
        members — decisions that treat absence-of-shards as proof (the
        unfound revert, verified-absent replies) must check that EVERY
        possible holder is up and was heard from, not just the up ones."""
        key = (pool.pool_id, pg)
        scope = {a for a in self.osdmap.pg_to_acting(pool, pg)
                 if a != CRUSH_ITEM_NONE}
        scope.update(a for a in self._raw_up(pool, pg)
                     if a != CRUSH_ITEM_NONE)
        scope.update(a for a in self._prior_acting.get(key, [])
                     if a != CRUSH_ITEM_NONE)
        scope.update(self._past_members.get(key, ()))
        if not up_only:
            return [o for o in scope if o in self.osdmap.osds]
        return [o for o in scope
                if self.osdmap.osds.get(o) and self.osdmap.osds[o].up]

    def _scope_all_up(self, pool: PoolInfo, pg: int) -> bool:
        """Is every POSSIBLE holder of this PG (including past-interval
        members) up right now?  The bar for treating shard absence as
        proof rather than suspicion."""
        return all(
            self.osdmap.osds.get(o) and self.osdmap.osds[o].up
            for o in self._scope_osds(pool, pg, up_only=False))

    def _reserve_lease(self) -> float:
        return float(self.conf.get("osd_backfill_reserve_lease", 300.0)
                     or 300.0)

    @staticmethod
    def _absent_reply(hunt_complete: bool, what: str) -> MOSDOpReply:
        """Typed reply for a fruitless shard hunt: VERIFIED absence only
        when every possible holder answered; otherwise the client must
        retry, not take "no" for an answer."""
        if hunt_complete:
            return MOSDOpReply(ok=False, code=-errno.ENOENT,
                               error="object not found")
        return MOSDOpReply(ok=False, code=-errno.EAGAIN,
                           error=f"{what} unavailable (holders unreachable "
                                 "or listing incomplete)")

    async def _gather_holdings(
        self, pool: PoolInfo, pg: int = -1,
        osds: Optional[List[int]] = None,
    ) -> Tuple[Dict[str, Set[Tuple[int, int, int]]], bool]:
        """(oid -> {(shard, osd, version)}, complete).  Versions matter —
        a stale shard sitting at its acting position is NOT healthy
        redundancy.  With ``pg``/``osds`` given, the listing is scoped to
        one PG's objects on its possible holders; the default remains the
        pool-wide all-up-OSDs union (stray sweep / scrub).

        ``complete`` is True only when EVERY queried peer answered: a
        partial listing makes healthy objects look under-replicated, and
        any decision that treats absence as doneness (Clean, pg_temp
        clear, stray purge) must refuse to act on it."""
        tid = uuid.uuid4().hex
        if osds is None:
            peers = [o.osd_id for o in self.osdmap.osds.values()
                     if o.up and o.osd_id != self.osd_id]
        else:
            peers = [o for o in osds if o != self.osd_id]
        q = self._collector(tid)
        sent = 0
        complete = True
        for osd in peers:
            try:
                await self.messenger.send(
                    self.osdmap.addr_of(osd),
                    MListShards(pool_id=pool.pool_id, tid=tid,
                                reply_to=self.addr, pg=pg))
                sent += 1
            except TRANSPORT_ERRORS:
                complete = False  # unreachable peer: listing is partial
        holdings: Dict[str, Set[Tuple[int, int, int]]] = {}
        for oid, shard in self._list_pool_objects(pool.pool_id):
            if pg >= 0 and self.osdmap.object_to_pg(pool, oid) != pg:
                continue
            got = self._store_read((pool.pool_id, oid, shard))
            if got is not None:
                holdings.setdefault(oid, set()).add((shard, self.osd_id, got[1].version))
        # short timeout: a just-killed peer can still be "up" in our map
        # (heartbeat grace), its send buffers, and no reply ever comes —
        # recovery must not stall a full RPC window on every zombie
        replies = await self._gather(tid, q, sent, timeout=1.5)
        if len(replies) < sent:
            complete = False
        for r in replies:
            for oid, shard, version in r.entries:
                # re-filter: a peer on an older map may lack the pool and
                # skip its pg filter, returning the whole pool's shards
                if pg >= 0 and self.osdmap.object_to_pg(pool, oid) != pg:
                    continue
                holdings.setdefault(oid, set()).add((shard, r.osd_id, version))
        return holdings, complete

    def _raw_up(self, pool: PoolInfo, pg: int) -> List[int]:
        """The CRUSH mapping filtered to up OSDs — backfill's TARGET set.
        With pg_temp installed, `acting` (who serves IO) and this up-set
        (who should eventually hold the data) differ; backfill pushes to
        the up-set so the override can be cleared (reference up vs acting,
        OSDMap.cc:2673)."""
        return [
            a if a != CRUSH_ITEM_NONE and self.osdmap.osds.get(a)
            and self.osdmap.osds[a].up else CRUSH_ITEM_NONE
            for a in self.osdmap.pg_to_placed(pool, pg)
        ]

    async def _maybe_request_pg_temp(self, pool: PoolInfo, pg: int,
                                     acting: List[int]) -> None:
        """This PG needs backfill: ask the mon to install the prior
        interval's acting set as pg_temp so the data-holding members keep
        serving IO meanwhile (reference MOSDPGTemp request flow,
        OSDMonitor::prepare_pgtemp)."""
        key = (pool.pool_id, pg)
        if self.osdmap.pg_temp.get(key):
            return  # an override is already serving
        prior = self._prior_acting.get(key)
        if not prior or list(prior) == list(acting):
            return
        live = [a for a in prior
                if a != CRUSH_ITEM_NONE and self.osdmap.osds.get(a)
                and self.osdmap.osds[a].up]
        if len(live) < pool.min_size:
            return  # the prior set cannot serve either
        try:
            await self._mon_rpc(
                MOSDPGTemp(pool_id=pool.pool_id, pg=pg, acting=list(prior),
                           from_osd=self.osd_id), MMapReply)
        except TRANSPORT_ERRORS:
            pass

    async def _clear_done_pg_temps(
        self, pool: PoolInfo, pushed: int,
        holdings: Optional[Dict[str, Set[Tuple[int, int, int]]]] = None,
    ) -> None:
        """Backfill-completion check for PGs we serve under pg_temp: once
        every object's newest version covers all up-set positions, ask the
        mon to drop the override so the map returns to the CRUSH mapping.
        Reuses the caller's holdings when no pushes were issued this round
        (nothing moved, so they're still current)."""
        temp_pgs = [pg for (pid, pg) in self.osdmap.pg_temp
                    if pid == pool.pool_id]
        temp_pgs = [pg for pg in temp_pgs
                    if self._primary(pool, pg,
                                     self.osdmap.pg_to_acting(pool, pg))
                    == self.osd_id]
        if not temp_pgs:
            return
        if pushed or holdings is None:
            if pushed:
                await asyncio.sleep(0.3)  # fire-and-forget pushes land
            holdings = {}
            listing_ok = True
            for pg in temp_pgs:  # scoped per-PG listings, not O(pool)
                h, ok = await self._gather_holdings(
                    pool, pg=pg, osds=self._scope_osds(pool, pg))
                holdings.update(h)
                listing_ok &= ok
            if not listing_ok:
                return  # partial view: clearing the override on it could
                        # hand IO to members that are not actually caught up
        k_need = (self._codec(pool).get_data_chunk_count()
                  if pool.pool_type == "ec" else 1)
        incomplete: Set[int] = set()
        for oid, locs in holdings.items():
            pg = self.osdmap.object_to_pg(pool, oid)
            if pg not in temp_pgs or pg in incomplete:
                continue
            got = self._newest_complete(locs, k_need)
            if got is None:
                incomplete.add(pg)
                continue
            _newest, at_newest = got
            if self._missing_up_positions(pool, pg, at_newest):
                incomplete.add(pg)
        for pg in temp_pgs:
            if pg in incomplete:
                continue
            # complete (or the PG holds no objects at all): drop override
            try:
                await self._mon_rpc(
                    MOSDPGTemp(pool_id=pool.pool_id, pg=pg, acting=[],
                               from_osd=self.osd_id), MMapReply)
                self._prior_acting.pop((pool.pool_id, pg), None)
            except TRANSPORT_ERRORS:
                pass

    async def _recover_shard_subchunk(
        self, pool: PoolInfo, pg: int, oid: str, lost: int,
        holders: Dict[int, int], newest: int,
    ) -> Optional[Tuple[bytes, int, bytes]]:
        """Bandwidth-efficient single-shard repair for sub-chunk codecs
        (CLAY): each helper ships only the repair sub-chunk byte ranges of
        its blob instead of whole chunks (reference fragmented helper
        reads ECBackend.cc:1049-1071 + ErasureCodeClay.cc:396
        repair_one_lost_chunk; the runs come from
        minimum_to_decode's SubChunkPlan).  Returns (shard_blob,
        object_size, hinfo_blob) or None when the generic full-decode path
        must run.
        """
        codec = self._codec(pool)
        sinfo = self._sinfo(pool)
        sub = codec.get_sub_chunk_count()
        if sub <= 1:
            return None
        try:
            plan = codec.minimum_to_decode({lost}, set(holders))
        except ErasureCodeError:
            return None
        runs = next(iter(plan.values()))
        if all(r == [(0, sub)] for r in plan.values()):
            return None  # plan is whole-chunk: no sub-chunk saving
        cs = sinfo.chunk_size
        sc_size = cs // sub
        # stat one helper for the object extent -> stripe count (its stored
        # hinfo record rides along for the push)
        stat_shard = next(iter(plan))
        stat = await self._sub_read_extents(pool, pg, oid, stat_shard,
                                            holders[stat_shard], [(0, 0)],
                                            want_hinfo=True)
        if stat is None or stat[2] != newest:
            return None
        object_size = stat[1]
        helper_hinfo = stat[3]
        n_stripes = max(1, -(-object_size // sinfo.stripe_width))
        extents = [(s * cs + idx * sc_size, cnt * sc_size)
                   for s in range(n_stripes) for (idx, cnt) in runs]
        rb = sum(cnt for _i, cnt in runs) * sc_size  # per-stripe bytes
        pieces: Dict[int, bytes] = {}
        for shard, shard_runs in plan.items():
            got = await self._sub_read_extents(pool, pg, oid, shard,
                                               holders[shard], extents)
            if got is None or got[2] != newest or len(got[0]) != rb * n_stripes:
                return None
            pieces[shard] = got[0]
            self.perf.inc("recovery_subchunk_bytes", len(got[0]))
        out: List[bytes] = []
        for s in range(n_stripes):
            stripe_chunks = {
                shard: np.frombuffer(buf[s * rb:(s + 1) * rb], dtype=np.uint8)
                for shard, buf in pieces.items()
            }
            decoded = codec.decode({lost}, stripe_chunks, cs)
            out.append(bytes(decoded[lost]))
        blob = b"".join(out)
        # ship the helper's hinfo record with the push only when it is
        # clean AND agrees with the reconstruction; otherwise the push
        # carries none and the target dirties its own entry
        hinfo_blob = b""
        if helper_hinfo:
            try:
                h = HashInfo.decode(helper_hinfo)
                if (not h.dirty and lost < len(h.crcs)
                        and crc_verify_any(blob, h.crcs[lost])):
                    hinfo_blob = helper_hinfo
            except (ValueError, KeyError, TypeError):
                pass  # garbled helper hinfo: target recomputes its own
        return blob, object_size, hinfo_blob

    async def _sub_read_extents(
        self, pool: PoolInfo, pg: int, oid: str, shard: int, osd: int,
        extents: List[Tuple[int, int]], want_hinfo: bool = False,
    ) -> Optional[Tuple[bytes, int, int, bytes]]:
        """One extent sub-read -> (bytes, object_size, version, hinfo) or
        None.  hinfo is only fetched/shipped when want_hinfo is set (the
        once-per-recovery stat probe) — hot-path stripe-RMW sub-reads skip
        the xattr lookup and the extra wire bytes."""
        if osd == self.osd_id:
            got = self._store_read((pool.pool_id, oid, shard))
            if got is None:
                return None
            blob, meta = got
            payload = b"".join(bytes(blob[o:o + l]) for o, l in extents)
            hraw = None
            if want_hinfo:
                try:
                    hraw = self.store.getattr((pool.pool_id, oid, shard),
                                              HashInfo.XATTR_KEY)
                except NotImplementedError:
                    pass
            return payload, meta.object_size, meta.version, hraw or b""
        tid = uuid.uuid4().hex
        q = self._collector(tid)
        try:
            await self.messenger.send(
                self.osdmap.addr_of(osd),
                MECSubRead(pool_id=pool.pool_id, pg=pg, oid=oid, shard=shard,
                           tid=tid, reply_to=self.addr, extents=extents,
                           want_hinfo=want_hinfo))
        except TRANSPORT_ERRORS:
            self._collectors.pop(tid, None)
            return None
        for r in await self._gather(tid, q, 1, timeout=2.0):
            if r.ok:
                return (as_bytes(r.chunk), r.object_size, r.version,
                        getattr(r, "hinfo", b""))
        return None

    async def _push_reencoded(self, pool: PoolInfo, pg: int,
                              items, rebalance: bool = False) -> int:
        """Re-encode a recovery round's worth of objects and push their
        missing shards.  Every object without a planar-resident (or
        replicated) fast path rides ONE group-aware EC submit
        (ecutil.batched_encode_group_async -> BatchingQueue.submit_group)
        — one queue lock, one worker wakeup, one coalesced dispatch for
        the whole stripe group.  ``items``: (oid, data, version, missing)."""
        if not items:
            return 0
        encoded_by_idx: Dict[int, Any] = {}
        group_idx: List[int] = []
        group_bufs: List[bytes] = []
        for i, (oid, data, version, _missing) in enumerate(items):
            if pool.pool_type != "ec":
                encoded_by_idx[i] = OSD._AllShards(data)
                continue
            if self._planar is not None:
                # residency: the resident planar rows at this version ARE
                # the encoded object — one pack, zero matmuls
                rows = planar_rows(
                    self._planar, self._planar_key(pool.pool_id, oid),
                    version)
                if rows is not None:
                    encoded_by_idx[i] = rows
                    continue
            group_idx.append(i)
            group_bufs.append(data)
        if group_bufs:
            encoded_list = await batched_encode_group_async(
                self._codec(pool), self._sinfo(pool), group_bufs,
                queue=self._ec_queue)
            for i, enc in zip(group_idx, encoded_list):
                encoded_by_idx[i] = enc
        pushed = 0
        for i, (oid, data, version, missing) in enumerate(items):
            encoded = encoded_by_idx[i]
            xattrs = self._cls_xattrs(pool.pool_id, oid)
            hinfo_blob = self._hinfo_for(pool, encoded)
            for shard, osd in missing:
                push = MPushShard(
                    pool_id=pool.pool_id, pg=pg, oid=oid, shard=shard,
                    chunk=bytes(encoded[shard]), version=version,
                    object_size=len(data), xattrs=xattrs, hinfo=hinfo_blob,
                )
                if osd == self.osd_id:
                    self._apply_push(push)
                else:
                    try:
                        await self.messenger.send(self.osdmap.addr_of(osd),
                                                  push)
                    except TRANSPORT_ERRORS:
                        continue
                pushed += 1
                self._note_backfill_push(len(push.chunk), rebalance)
        return pushed

    @staticmethod
    def _newest_complete(
        locs: Set[Tuple[int, int, int]], k_need: int,
    ) -> Optional[Tuple[int, Set[Tuple[int, int]]]]:
        """Newest COMPLETE version of one object's shard holdings: group
        (shard, osd, version) triples by version, keep versions with at
        least k_need distinct shards (decodable), and return (newest such
        version, {(shard, osd)} holding it) — or None when nothing is
        decodable.  Membership is by (shard, osd) pair: a shard may
        legitimately live on several OSDs mid-backfill (old holder + new
        target).  Rollback-slot copies (shard >= PREV_SLOT) normalize to
        their real shard id: they are decodable data for their version but
        must not inflate the DISTINCT-shard count.  Shared by backfill
        push planning and pg_temp completion so the two can never disagree
        about doneness."""
        shards_at: Dict[int, Set[int]] = {}
        for (shard, _osd, v) in locs:
            shards_at.setdefault(v, set()).add(shard % PREV_SLOT)
        viable = [v for v, sh in shards_at.items() if len(sh) >= k_need]
        if not viable:
            return None
        newest = max(viable)
        # membership counts LIVE slots only: a rollback-slot copy decodes,
        # but it must not satisfy seat coverage — it dies with the shard
        # that displaced it, so backfill needs a live home for the data
        return newest, {(shard, osd) for shard, osd, v in locs
                        if v == newest and shard < PREV_SLOT}

    def _missing_up_positions(
        self, pool: PoolInfo, pg: int, at_newest: Set[Tuple[int, int]],
    ) -> List[Tuple[int, int]]:
        """Up-set positions (shard, osd) not holding the newest complete
        version — the push targets backfill must fill."""
        return [
            (shard, osd)
            for shard, osd in enumerate(self._raw_up(pool, pg))
            if osd != CRUSH_ITEM_NONE and (shard, osd) not in at_newest
        ]

    async def _backfill_pool(
        self, pool: PoolInfo,
    ) -> Tuple[int, Dict[str, Set[Tuple[int, int, int]]]]:
        """Pool-wide backfill: per-PG scoped sweeps over every PG this OSD
        leads (each contacts only that PG's possible holders)."""
        pushed = 0
        merged: Dict[str, Set[Tuple[int, int, int]]] = {}
        for pg in range(pool.pg_num):
            acting = self.osdmap.pg_to_acting(pool, pg)
            if self._primary(pool, pg, acting) != self.osd_id:
                continue
            p, holdings, _covered = await self._backfill_pg(pool, pg)
            pushed += p
            merged.update(holdings)
        return pushed, merged

    def _note_backfill_push(self, nbytes: int, rebalance: bool) -> None:
        """Account one pushed shard: backfill_bytes_moved always; the
        rebalance pair only for pure placement moves (the bench arm's
        MB/s-moved numerator — recovery of lost redundancy is a
        different operator question than rebalance cost)."""
        self.perf.inc("backfill_bytes_moved", nbytes)
        if rebalance:
            self.perf.inc("rebalance_push")
            self.perf.inc("rebalance_bytes_moved", nbytes)

    async def _backfill_pg(
        self, pool: PoolInfo, pg: int,
    ) -> Tuple[int, Dict[str, Set[Tuple[int, int, int]]], bool]:
        """Scoped backfill of ONE PG (reference backfill): list shards on
        the PG's possible holders only, reconstruct and push whatever is
        missing from the up-set positions, and purge strays once the
        up-set is fully covered.  Returns (shards_pushed, the gathered
        holdings, fully_covered).

        Classing: a sweep over a DEGRADED acting set (holes — lost
        redundancy) is CLASS_RECOVERY; a sweep moving data because
        membership/weights changed with full redundancy intact (out /
        in / reweight / crush reweight) is CLASS_REBALANCE — per-object
        work waits its dmClock turn so client traffic keeps its
        reservation while data moves."""
        gather_epoch = self.osdmap.epoch
        bg_class = (CLASS_RECOVERY
                    if any(a == CRUSH_ITEM_NONE for a in
                           self.osdmap.pg_to_acting(pool, pg))
                    else CLASS_REBALANCE)
        rebalance = bg_class == CLASS_REBALANCE
        # snapshot BEFORE the gather: the revert decision must be made
        # about the cluster as it was when the listing was taken.  A
        # holder that was down during the gather (never queried) but up
        # by decision time would otherwise make its unseen shards count
        # as verified-absent (TOCTOU).  The queried set is the up-filtered
        # scope at this same instant, so "all holders up at gather_epoch
        # AND every queried peer answered" == complete knowledge.
        holders_all_up = self._scope_all_up(pool, pg)
        holdings, listing_ok = await self._gather_holdings(
            pool, pg=pg, osds=self._scope_osds(pool, pg))
        if self.osdmap.epoch != gather_epoch:
            # the map moved mid-gather: the listing may straddle two
            # membership views — never revert on it
            holders_all_up = False
        k_need = (self._codec(pool).get_data_chunk_count()
                  if pool.pool_type == "ec" else 1)
        pushed = 0
        # objects whose re-encode is deferred into one group submit:
        # (oid, data, version, missing) tuples
        pending_encode: List[Tuple[str, bytes, int, List[Tuple[int, int]]]] = []
        # a partial listing (unanswered peer) makes healthy objects look
        # under-replicated: never declare coverage (or purge) on one
        fully_covered = listing_ok
        for oid, locs in holdings.items():
            # classed background work: each object's reconstruct+push
            # waits its turn under the sweep's dmClock class
            await self._background_throttle(
                bg_class, (pool.pool_id << 20) | pg)
            acting = self.osdmap.pg_to_acting(pool, pg)
            # newest COMPLETE version wins; shards newer than it are
            # uncommitted leftovers of a failed write -> roll them back
            # (reference divergent-entry rollback, ECBackend rollback)
            got = self._newest_complete(locs, k_need)
            if got is None:
                continue
            newest, at_newest = got
            # shards NEWER than the newest complete version are either
            # leftovers of a failed write, a concurrent write racing this
            # scan, or an acked write whose holders died (unfound).  The
            # reference leaves resolving this to the operator
            # (mark_unfound_lost revert) because reverting wrongly
            # DESTROYS an acked write; the automated revert here therefore
            # fires only when absence is proof, not suspicion:
            #   - every possible holder of the PG (including down/past-
            #     interval members, who may be holding the missing shards
            #     through a restart) is up and answered the listing;
            #   - the version has stayed partial for at least
            #     osd_unfound_revert_grace seconds AND across two complete
            #     listings (in-flight acks get time to land);
            #   - osd_auto_revert_unfound has not been switched off (the
            #     operator escape hatch to reference behavior).
            newer_partial = {v for (_s, _o, v) in locs if v > newest}
            if newer_partial:
                fully_covered = False  # unresolved versions: never purge
            if newer_partial and listing_ok and holders_all_up \
                    and self.conf.get("osd_auto_revert_unfound", True):
                grace = float(
                    self.conf.get("osd_unfound_revert_grace", 30.0) or 30.0)
                seen = self._partial_newer.setdefault((pool.pool_id, pg), {})
                now = time.monotonic()
                for v_bad in newer_partial:
                    first_seen = seen.get((oid, v_bad))
                    if first_seen is None or now - first_seen < grace:
                        continue  # first sighting / inside grace: wait
                    for shard, osd, v in locs:
                        if v != v_bad or shard >= PREV_SLOT:
                            continue
                        rb = MECSubRollback(pool_id=pool.pool_id, pg=pg,
                                            oid=oid, shard=shard,
                                            bad_version=v_bad,
                                            reply_to=self.addr)
                        if osd == self.osd_id:
                            self._handle_sub_rollback(rb)
                        else:
                            try:
                                await self.messenger.send(
                                    self.osdmap.addr_of(osd), rb)
                            except TRANSPORT_ERRORS:
                                pass
            # push targets are the UP-SET positions: identical to acting
            # normally, but under pg_temp the override serves IO while
            # backfill fills the crush-mapped members
            missing = self._missing_up_positions(pool, pg, at_newest)
            if not missing:
                continue
            fully_covered = False  # pushes are in flight; purge next round
            if len(missing) == 1 and pool.pool_type == "ec":
                # single lost shard: try the sub-chunk repair path (CLAY)
                # — helpers move sub_chunk_no/q of a chunk, not k chunks
                lost, target = missing[0]
                hold = {shard: osd for shard, osd, v in locs if v == newest}
                hold.pop(lost, None)
                got = await self._recover_shard_subchunk(
                    pool, pg, oid, lost, hold, newest)
                if got is not None:
                    blob, osize, sub_hinfo = got
                    push = MPushShard(
                        pool_id=pool.pool_id, pg=pg, oid=oid, shard=lost,
                        chunk=blob, version=newest, object_size=osize,
                        xattrs=self._cls_xattrs(pool.pool_id, oid),
                        hinfo=sub_hinfo)
                    if target == self.osd_id:
                        self._apply_push(push)
                    else:
                        try:
                            await self.messenger.send(
                                self.osdmap.addr_of(target), push)
                        except TRANSPORT_ERRORS:
                            continue
                    pushed += 1
                    self._note_backfill_push(len(blob), rebalance)
                    continue
            # READING: gather k chunks (degraded-read machinery); the
            # re-encode is DEFERRED so every object this round joins one
            # whole-stripe-group submit to the EC tier (below)
            read_op = MOSDOp(op="read", pool_id=pool.pool_id, oid=oid)
            reply = await self._do_read(read_op)
            if not reply.ok:
                continue
            pending_encode.append((oid, as_bytes(reply.data), reply.version,
                                   missing))
        # re-encode at each object's CURRENT version: deterministic encode
        # makes pushed shards byte-identical to the originals, and the
        # version stays consistent with surviving shards.  All plain
        # re-encodes of this round ride ONE group-aware submit
        # (BatchingQueue.submit_group) — the recovery half of the
        # whole-stripe-group handoff.
        pushed += await self._push_reencoded(pool, pg, pending_encode,
                                             rebalance=rebalance)
        if listing_ok and holders_all_up:
            # refresh the partial-version watchlist: entries keep their
            # first-seen time across sweeps (the grace clock), entries no
            # longer partial drop out, new ones start their clock now.
            # Accrual requires FULL visibility (every possible holder up
            # and answering): grace accumulated during an outage that
            # hides the shards would be worthless evidence.
            prev = self._partial_newer.get((pool.pool_id, pg), {})
            now = time.monotonic()
            observed: Dict[Tuple[str, int], float] = {}
            for oid, locs in holdings.items():
                got = self._newest_complete(locs, k_need)
                base = got[0] if got else 0
                for (_s, _o, v) in locs:
                    if v > base:
                        observed[(oid, v)] = prev.get((oid, v), now)
            self._partial_newer[(pool.pool_id, pg)] = observed
        elif not holders_all_up:
            # incomplete visibility invalidates any accrued grace
            self._partial_newer.pop((pool.pool_id, pg), None)
        if fully_covered and not self.osdmap.pg_temp.get((pool.pool_id, pg)):
            # strays seen this pass block Clean like in-flight pushes do:
            # deletes are fire-and-forget (and the purge skips entirely
            # when the epoch moved mid-gather — routine while OTHER PGs'
            # pg_temp churn bumps the map), so Clean — which pops the
            # _past_members scope that makes the stray OSD visible at
            # all — must wait for a later pass to VERIFY the listing
            # shows nothing outside the up set.  Without this, an `osd
            # out` drain races the map churn of its own rebalance and
            # strands the out OSD's shards forever.
            if await self._purge_strays(pool, pg, holdings, gather_epoch):
                fully_covered = False
        return pushed, holdings, fully_covered

    async def _purge_strays(
        self, pool: PoolInfo, pg: int,
        holdings: Dict[str, Set[Tuple[int, int, int]]],
        gather_epoch: int,
    ) -> bool:
        """Once every up-set position holds the newest complete version
        and no override is serving, copies on OSDs OUTSIDE the up set are
        strays from prior intervals: delete them (reference stray purge
        after activation, PG::purge_strays).  Without this, moved-away
        shards would linger forever and the shard hunt could resurrect a
        deleted object from them.  Delete-sending is skipped when the map
        moved since the holdings were gathered — a "stray" under the old
        map may be an acting member under the new one.  Returns True when
        the listing contained ANY stray shard (purged or deferred): the
        caller must not declare Clean until a later pass verifies the
        strays gone."""
        up = {osd for osd in self._raw_up(pool, pg) if osd != CRUSH_ITEM_NONE}
        stray_osds: Dict[int, Set[str]] = {}
        for oid, locs in holdings.items():
            for _shard, osd, _v in locs:
                if osd not in up:
                    stray_osds.setdefault(osd, set()).add(oid)
        if not stray_osds:
            return False
        if self.osdmap.epoch != gather_epoch:
            return True  # defer: re-gather under the settled map
        for osd, oids in stray_osds.items():
            for oid in oids:
                try:
                    await self.messenger.send(
                        self.osdmap.addr_of(osd),
                        MECSubDelete(pool_id=pool.pool_id, pg=pg, oid=oid,
                                     shard=-1, tid="", reply_to=self.addr))
                    self.perf.inc("stray_purged")
                except TRANSPORT_ERRORS:
                    pass
        return True
