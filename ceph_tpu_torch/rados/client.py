# Copy of ceph_tpu/rados/client.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; what it reads back from the
# wire or a store unpickles through rados/unpickle.py.
"""RADOS client: computes placement itself and talks straight to primaries.

Role-equivalent of librados + Objecter (reference src/osdc/Objecter.cc:2257
op_submit / _calc_target): fetch the OSDMap from the mon, map
object -> PG -> primary locally, send the op to the primary, and on failure
refetch the map and resend (the Objecter's retry-across-epochs behavior,
idempotent by reqid).

Resend/backoff discipline (the Objecter-grade op-resilience layer):

- Every data op gets ONE reqid for its whole lifetime and a persistent
  in-flight record (target pg/primary, epoch the target was computed on,
  deadline).  The OSD's PG log dedupes by reqid, so resends are
  exactly-once no matter how many transports they cross.
- Ops RESEND, they do not fail, on transient trouble: wrong-primary /
  degraded replies (typed -ESTALE/-EAGAIN, with the reply's epoch as a
  re-target fence), transport death, per-attempt reply timeouts, and map
  epoch bumps (a refresh that moves an in-flight op's primary wakes its
  reply wait immediately — the Objecter's _scan_requests resend).
  Retry pacing is capped exponential backoff with jitter
  (client_backoff_base/_cap); only DEFINITIVE typed answers (-ENOENT,
  -EPERM, ...) or the op deadline (client_op_deadline) surface errors.
- MOSDBackoff: a blocked PG (peering below min_size, saturated dispatch
  queue) parks every op targeting it until the matching unblock — or
  until the block's duration expires / a map change moves the primary
  (the liveness bounds for a primary that dies holding blocks).
- Paused maps: while the osdmap carries "pausewr"/"full" (writes) or
  "pauserd" (reads), matching ops QUEUE and poll for the map that lifts
  the gate instead of failing (Objecter pauserd/pausewr handling).

The `objecter` perf set counts all of it (resends, timeouts,
backoffs_received, backoff_wait_s, paused_ops, map_kicks); read it via
``perf_dump()``."""

from __future__ import annotations

import asyncio
import errno
import random
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder
from ceph_tpu_torch.common.tracing import Tracer
from ceph_tpu_torch.rados.clog import ClogEntry, LogClient, decode_entries
from ceph_tpu_torch.rados.messenger import BufferList, Messenger
from ceph_tpu_torch.rados.monclient import MonTargets
from ceph_tpu_torch.rados import unpickle
from ceph_tpu_torch.rados.types import (
    MAuthTicket,
    MAuthTicketReply,
    MCommand,
    MCommandReply,
    MConfigGet,
    MCrashQuery,
    MCrashQueryReply,
    MGetHealth,
    MHealthMute,
    MHealthReply,
    MLog,
    MLogAck,
    MLogReply,
    MLogSubscribe,
    MNotifyAck,
    MWatchNotify,
    MConfigReply,
    MConfigSet,
    MCreatePool,
    MCreatePoolReply,
    MDeletePool,
    MGetMap,
    MMapReply,
    MOSDBackoff,
    MOSDSetFlag,
    MSetFullRatio,
    is_delete_only_multi,
    MPoolSet,
    MSetUpmap,
    MMarkDown,
    MOsdMembership,
    MCrushOp,
    MCrushOpReply,
    MOsdPredicate,
    MOsdPredicateReply,
    MOSDOp,
    MOSDOpReply,
    MSnapOp,
    MSnapOpReply,
    OSDMap,
    SNAP_SEP,
)


class RadosError(Exception):
    """Client-visible failure.  ``code`` is the negative errno from the
    reply (0 when the failure had no typed reply, e.g. transport errors),
    so services can branch on errno instead of message text."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


# reply codes that are ANSWERS, not failures: the primary executed the op
# and the result is "no" — retrying would turn every expected miss into a
# multi-second epoch-barrier stall (reference: definitive errno from
# PrimaryLogPG are returned to the caller, not retried by the Objecter)
_DEFINITIVE_CODES = frozenset((
    -errno.ENOENT, -errno.EOPNOTSUPP, -errno.EINVAL, -errno.EPERM,
    -errno.EBADMSG, -errno.ENXIO, -errno.EEXIST, -errno.ERANGE,
    # compound-op asserts: cmpxattr mismatch / missing xattr are verdicts
    # about object state, not transients (reference rados_exec rvals)
    -errno.ECANCELED, -errno.ENODATA,
    # capacity: a FULL acting member / failsafe-full store refused the
    # write — resending into a full cluster cannot succeed (the cure is
    # deleting, which stays exempt from every fullness gate), so ENOSPC
    # surfaces typed and FAST instead of burning the op deadline
    -errno.ENOSPC,
))
# -ESTALE (not primary): the placement this op was computed on is WRONG —
# re-target only after fencing past our own epoch (a newer map exists or
# is imminent; recomputing on the stale one re-picks the same primary).
# -EAGAIN (degraded below min_size / shards unavailable): the cure is a
# MAP CHANGE (failure detection marking the dead member down, recovery
# re-seating shards) — fence past our epoch and wait for it, or the
# retries burn out inside the detection grace window.
# -EBUSY (sub-write ack shortfall): the write partially landed and a
# plain resend usually completes it — retry promptly WITHOUT an epoch
# wait (one dropped ack on a healthy cluster must not pay a multi-second
# epoch poll).

# ops that mutate object state: gated by the map's write-pause flags
# ("pausewr"/"full"); reads pause only under "pauserd".  Class calls and
# watch registration count as writes (the reference flags
# CEPH_OSD_OP_CALL/WATCH as WR ops — cls_rbd/cls_rgw mutations ride
# "call", so excluding it would let metadata writes through a write
# freeze).
_WRITE_OPS = frozenset(("write", "delete", "multi", "snap-trim",
                        "call", "watch", "unwatch"))


class _OpKick(Exception):
    """Internal: an in-flight op's reply wait was woken early — the map
    epoch advanced and its target moved, or an MOSDBackoff landed for its
    PG.  The submit loop re-targets (or parks) immediately instead of
    waiting out the reply timeout."""


class _OpRecord:
    """Persistent in-flight op record (the Objecter's op_t role): one per
    logical op for its whole lifetime, across every resend."""

    __slots__ = ("op", "pg", "target", "epoch", "deadline", "fut",
                 "paused_counted")

    def __init__(self, op: MOSDOp, deadline: float):
        self.op = op
        self.pg: Optional[int] = None          # target pg (last send)
        self.target: Optional[int] = None      # primary osd (last send)
        self.epoch = 0                         # epoch target was computed on
        self.deadline = deadline               # monotonic() ceiling
        self.fut: Optional[asyncio.Future] = None  # live reply wait
        self.paused_counted = False            # paused_ops bumped once


def _build_objecter_perf() -> PerfCounters:
    """The `objecter` counter set — client-side op-resilience telemetry
    (name -> meaning -> kind):

      op                 u64         logical data ops submitted
      resends            u64         op sends beyond the first (map change,
                                     timeout, transport death, backoff)
      timeouts           u64         per-attempt reply timeouts
      backoffs_received  u64         MOSDBackoff blocks received
      backoffs_released  u64         MOSDBackoff unblocks received
      backoff_wait_s     longrunavg  seconds ops spent parked under a block
      paused_ops         u64         ops queued on a paused map (pausewr/
                                     pauserd/full flags)
      map_kicks          u64         in-flight reply waits woken early
                                     (target moved / backoff landed)
      inflight           u64         ops currently in flight (gauge)
    """
    b = PerfCountersBuilder("objecter")
    b.add_u64_counter("op", "logical data ops submitted")
    b.add_u64_counter("resends", "op sends beyond the first")
    b.add_u64_counter("timeouts", "per-attempt reply timeouts")
    b.add_u64_counter("backoffs_received", "MOSDBackoff blocks received")
    b.add_u64_counter("backoffs_released", "MOSDBackoff unblocks received")
    b.add_time_avg("backoff_wait_s", "seconds parked under a PG backoff")
    b.add_u64_counter("paused_ops", "ops queued on a paused map")
    b.add_u64_counter("map_kicks", "in-flight waits woken by map/backoff")
    b.add_u64("inflight", "ops currently in flight (gauge)")
    return b.create_perf_counters()


class RadosClient:
    def __init__(self, mon_addr, conf: Optional[dict] = None):
        # one mon addr or a monmap list; RPCs rotate on mon failure
        self.mons = MonTargets(mon_addr)
        self.conf = conf or {}
        self.op_timeout = self.conf.get("client_op_timeout", 10.0)
        # overall per-op deadline: transient failures RESEND until this
        # long before surfacing an error (definitive typed answers still
        # return immediately) — the bound that keeps "never fail a
        # transient op" from becoming "hang forever on a dead cluster"
        self.op_deadline = float(
            self.conf.get("client_op_deadline", 0) or 0) \
            or max(3.0 * float(self.op_timeout), 15.0)
        # retry pacing: capped exponential backoff with jitter
        self.backoff_base = float(
            self.conf.get("client_backoff_base", 0.1) or 0.1)
        self.backoff_cap = float(
            self.conf.get("client_backoff_cap", 2.0) or 2.0)
        # park ceiling for a server backoff whose unblock never arrives
        self.backoff_park_max = float(
            self.conf.get("client_backoff_park_max", 3.0) or 3.0)
        # entity name riding every data op (MOSDOp v6 `client`): the
        # identity the OSD's per-client dmClock QoS keys on.  Format
        # client.<class>.<id> names a tenant class (pool qos_class:<name>
        # profiles); the default two-part name rides the pool's default
        # client profile.  Multi-tenant harnesses stamp per-op identities
        # through the `client=` kwarg on put/get/delete instead — one
        # client process carries many simulated tenants.
        self.name = str(self.conf.get("client_name", "")
                        or f"client.{uuid.uuid4().hex[:6]}")
        self.messenger = Messenger("client", self.conf, entity_type="client")
        # the `objecter` perf set (schema: _build_objecter_perf)
        self.perf = _build_objecter_perf()
        # client-side trace ring: every logical data op roots a span here
        # and propagates its context on the MOSDOp (ms_trace_propagation)
        # so the primary's and peers' spans stitch under it — the client
        # half of the end-to-end trace
        self.tracer = Tracer(max_spans=512, service="client")
        self._trace_on = bool(self.conf.get("ms_trace_propagation", True))
        self.osdmap: Optional[OSDMap] = None
        self._replies: Dict[str, asyncio.Future] = {}
        # reqid -> persistent op record; map changes and backoffs kick
        # matching in-flight waits (resend-on-map-change)
        self._inflight: Dict[str, _OpRecord] = {}
        # (pool, pg) -> {"event", "expiry", "epoch", "id", "from"}:
        # active MOSDBackoff blocks parking ops for that PG
        self._backoffs: Dict[Tuple[int, int], Dict] = {}
        self._mon_fut: Optional[asyncio.Future] = None
        self._mon_tid: str = ""
        # serialize mon RPCs: _mon_fut is a single slot, and concurrent ops
        # retrying through refresh_map() must not clobber each other
        self._mon_lock = asyncio.Lock()
        # (pool, oid) -> callback(oid, payload) for watch/notify
        self._watches: Dict = {}
        # linger state (reference Objecter::linger_watch, Objecter.cc:598):
        # (pool, oid) -> primary the watch was registered with; on a map
        # change that moves the primary, the watch re-registers itself
        self._watch_primaries: Dict[Tuple[int, int], Optional[int]] = {}
        self._relinger_task: Optional[asyncio.Task] = None
        self._linger_poll_task: Optional[asyncio.Task] = None
        # cluster-log watch (`ceph -w`): callback fed by inbound MLog
        # stream frames after watch_cluster_log() subscribed
        self._clog_cb = None
        # tid -> future for `ceph tell` MCommand round-trips
        self._tell_futs: Dict[str, asyncio.Future] = {}
        # lazy LogClient: client-side tools clog too (audit trails,
        # harness annotations) — created on first .clog use
        self._clog: Optional[LogClient] = None

    @property
    def clog(self) -> LogClient:
        """This client's cluster-log submitter (LogClient role for
        client-side tools); lazily created, flushed on stop()."""
        if self._clog is None:
            self._clog = LogClient(self.messenger, self.mons, self.name,
                                   self.conf)
            try:
                self._clog.start()
            except RuntimeError:
                pass  # no running loop yet: entries queue, flush() later
        return self._clog

    async def start(self) -> None:
        self.messenger.dispatcher = self._dispatch
        # rx batches resolve their reply futures in one pass (and the
        # batch's frames get ONE piggybacked ack instead of one each —
        # an op-reply flood from a busy primary costs a single flush)
        self.messenger.group_dispatcher = self._dispatch_group
        await self.messenger.bind()
        if self.conf.get("auth_cephx", False):
            await self._fetch_ticket()

    async def _fetch_ticket(self) -> None:
        """cephx-lite: obtain a service ticket over a BOOTSTRAP-
        authenticated mon connection; OSD dials present it instead of
        the cluster secret.  The mon refuses to mint tickets over
        ticket-authenticated conns (self-renewal would void the TTL), so
        drop any held ticket and live mon conns first — the re-dial then
        proves the cluster secret."""
        if self.messenger.ticket is not None:
            self.messenger.ticket = None
            self.messenger.session_key = None
            for addr in list(self.mons.addrs):
                await self.messenger.disconnect(addr)
        reply = await self._mon_rpc(
            MAuthTicket(entity="client", entity_type="client"))
        if getattr(reply, "denied", False):
            raise PermissionError("mon refused to mint a client ticket")
        self.messenger.ticket = bytes.fromhex(reply.ticket)
        self.messenger.session_key = bytes.fromhex(reply.session_key)

    async def stop(self) -> None:
        if self._clog is not None:
            await self._clog.stop()
        for t in (self._linger_poll_task, self._relinger_task):
            if t is not None and not t.done():
                t.cancel()
        await self.messenger.shutdown()

    async def _dispatch_group(self, conn, msgs) -> None:
        """A whole rx batch (already-buffered frames): replies resolve
        their futures back-to-back; per-message work is future-set cheap,
        so order-preserving serial dispatch is the right partition here —
        the win is the messenger's single cumulative ack for the batch.
        Per-message isolation matches the serve loop's: one raising
        message (e.g. a watch-ack dial failing) must not drop — and
        still ack — the rest of the batch."""
        for msg in msgs:
            try:
                await self._dispatch(conn, msg)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                import traceback

                traceback.print_exc()

    async def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, MOSDBackoff):
            self._handle_backoff(conn, msg)
            return
        if isinstance(msg, MWatchNotify):
            # ack FIRST (delivery receipt — divergence from notify2, which
            # acks after processing): a slow callback must not look like a
            # dead watcher and get pruned; then run the callback
            try:
                await self.messenger.send(
                    tuple(msg.reply_to),
                    MNotifyAck(notify_id=msg.notify_id,
                               watcher=self.messenger.addr))
            except (ConnectionError, OSError):
                pass
            cb = self._watches.get((msg.pool_id, msg.oid))
            if cb is not None:
                try:
                    res = cb(msg.oid, msg.payload)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    import traceback

                    traceback.print_exc()  # a broken callback must be loud
            return
        if isinstance(msg, MLog):
            # mon -> watcher stream frame (`ceph -w` subscription)
            cb = self._clog_cb
            if cb is not None:
                for e in decode_entries(msg.entries):
                    try:
                        res = cb(e)
                        if asyncio.iscoroutine(res):
                            await res
                    except Exception:
                        import traceback

                        traceback.print_exc()  # broken callback: be loud
            return
        if isinstance(msg, MLogAck):
            if self._clog is not None:
                self._clog.handle_ack(msg)
            return
        if isinstance(msg, MCommandReply):
            fut = self._tell_futs.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        if isinstance(msg, (MMapReply, MCreatePoolReply, MConfigReply,
                            MAuthTicketReply, MSnapOpReply, MHealthReply,
                            MLogReply, MCrashQueryReply,
                            MCrushOpReply, MOsdPredicateReply)):
            # the mon echoes our per-RPC tid (like MOSDOp's reqid): a reply
            # landing after its RPC timed out has a stale tid and is dropped
            # instead of fulfilling the next RPC's future
            if (
                self._mon_fut
                and not self._mon_fut.done()
                and msg.tid == self._mon_tid
            ):
                self._mon_fut.set_result(msg)
        elif isinstance(msg, MOSDOpReply):
            fut = self._replies.pop(msg.reqid, None)
            if fut and not fut.done():
                fut.set_result(msg)

    # -- MOSDBackoff handling (reference Objecter::_handle_backoff) ----------

    def _handle_backoff(self, conn, msg: MOSDBackoff) -> None:
        key = (msg.pool_id, msg.pg)
        if msg.op == "block":
            self.perf.inc("backoffs_received")
            ent = self._backoffs.get(key)
            if ent is not None:
                if ent.get("id") == msg.id:
                    return  # duplicate block for the same interval
                # a NEW block (new interval/primary) displaces the old
                # one: release ops parked on the displaced event — they
                # re-enter the loop and park on the new block, instead
                # of sleeping out the dead entry's full expiry
                ent["event"].set()
            duration = msg.duration if msg.duration > 0 \
                else self.backoff_park_max
            self._backoffs[key] = {
                "event": asyncio.Event(),
                "expiry": time.monotonic() + duration,
                "epoch": msg.epoch,
                "id": msg.id,
                # who blocked us: a map change that moves the primary off
                # this addr releases the block (the new primary has no
                # backoff state for us)
                "from": tuple(conn.peer) if conn is not None
                and getattr(conn, "peer", None) else None,
            }
            # the op that triggered this block got DROPPED server-side:
            # wake its reply wait so it parks instead of timing out
            self._kick_pg(key)
        else:
            ent = self._backoffs.get(key)
            if ent is not None and (not msg.id or ent.get("id") == msg.id):
                self.perf.inc("backoffs_released")
                self._release_backoff(key)

    def _release_backoff(self, key: Tuple[int, int]) -> None:
        ent = self._backoffs.pop(key, None)
        if ent is not None:
            ent["event"].set()

    def _pg_primary(self, pool_id: int, pg: int) -> Optional[int]:
        pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
        if pool is None or pg >= pool.pg_num:
            return None
        acting = self.osdmap.pg_to_acting(pool, pg)
        return self.osdmap.primary_of(acting, seed=(pool_id << 20) | pg)

    def _kick_pg(self, key: Tuple[int, int]) -> None:
        """Wake in-flight ops targeting a just-blocked PG: their reply is
        never coming (the OSD dropped the op), so the loop should park on
        the backoff now, not after a full reply timeout."""
        for rec in list(self._inflight.values()):
            if (rec.op.pool_id, rec.pg) == key and rec.fut is not None \
                    and not rec.fut.done():
                rec.fut.set_exception(_OpKick())

    def _kick_inflight(self) -> None:
        """Map epoch advanced: release backoffs whose blocking primary is
        no longer the PG's primary, and wake in-flight ops whose computed
        target moved so they resend NOW (the Objecter's _scan_requests
        resend-on-map-change, Objecter.cc:1142)."""
        for key, ent in list(self._backoffs.items()):
            p = self._pg_primary(*key)
            if p is None:
                continue  # PG unservable: keep parked, epoch fence cures
            if ent.get("from") and tuple(self.osdmap.addr_of(p)) \
                    != tuple(ent["from"]):
                self._release_backoff(key)
        for rec in list(self._inflight.values()):
            if rec.fut is None or rec.fut.done() \
                    or self.osdmap.epoch <= rec.epoch:
                continue
            pg, primary = self._calc_target(rec.op)
            if pg != rec.pg or primary != rec.target:
                rec.fut.set_exception(_OpKick())

    def perf_dump(self) -> Dict[str, Dict]:
        """Client-side `perf dump` role: the `objecter` set plus the
        messenger's `wire` set (clients own no admin socket — tools,
        benches, and embedding daemons read this)."""
        return {"objecter": self.perf.dump(),
                "wire": self.messenger.perf.dump()}

    @property
    def mon_addr(self) -> Tuple[str, int]:
        return self.mons.current

    async def _mon_rpc(self, msg):
        async with self._mon_lock:
            last: Exception = TimeoutError("no mon reachable")
            for _ in range(len(self.mons)):
                self._mon_tid = msg.tid = uuid.uuid4().hex
                self._mon_fut = asyncio.get_running_loop().create_future()
                try:
                    await self.messenger.send(self.mons.current, msg)
                    return await asyncio.wait_for(self._mon_fut, timeout=5)
                except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                    last = e
                    self.mons.rotate()
            raise last

    async def refresh_map(self, min_epoch: int = 0) -> OSDMap:
        """Fetch the cluster map; with ``min_epoch``, poll until we hold
        AT LEAST that epoch (the Objecter's epoch barrier — a retryable
        error reply names the OSD's epoch, and re-targeting on anything
        older would recompute the same stale primary).  The mon answers
        with an incremental chain from our epoch when it can (subscriber
        protocol); otherwise a full map."""
        import pickle as _pickle

        prev_epoch = self.osdmap.epoch if self.osdmap is not None else -1
        for _ in range(20):
            since = self.osdmap.epoch if self.osdmap is not None else 0
            reply = await self._mon_rpc(MGetMap(min_epoch=since))
            if reply.osdmap is not None:
                self.osdmap = reply.osdmap
            elif getattr(reply, "incrementals", None) and self.osdmap is not None:
                # apply the delta chain to a copy; a broken chain falls
                # back to a full fetch next iteration
                m = _pickle.loads(_pickle.dumps(self.osdmap, protocol=5))
                if all(m.apply_incremental(inc) for inc in reply.incrementals):
                    self.osdmap = m
                else:
                    self.osdmap = (await self._mon_rpc(MGetMap())).osdmap
            if min_epoch <= 0 or (self.osdmap is not None
                                  and self.osdmap.epoch >= min_epoch):
                break
            await asyncio.sleep(0.1)
        if self.osdmap is not None and self.osdmap.epoch > prev_epoch:
            # resend-on-map-change: in-flight ops whose target moved
            # resend now; backoffs from deposed primaries release
            self._kick_inflight()
        if self._watches:
            self._kick_relinger()
        return self.osdmap

    async def create_pool(
        self, name: str, pool_type: str = "ec", pg_num: int = 8,
        profile: Optional[Dict[str, str]] = None,
    ) -> int:
        reply = await self._mon_rpc(
            MCreatePool(name=name, pool_type=pool_type, pg_num=pg_num,
                        profile=profile or {})
        )
        if not reply.ok:
            raise RadosError(reply.error)
        await self.refresh_map()
        return reply.pool_id

    async def config_set(self, key: str, value: str) -> None:
        """Centralized config: `ceph config set` equivalent (replicated by
        the mon quorum, distributed to daemons at boot)."""
        reply = await self._mon_rpc(MConfigSet(key=key, value=str(value)))
        if not reply.ok:
            raise RadosError(reply.error)

    async def config_get(self, key: str = "") -> Dict[str, str]:
        reply = await self._mon_rpc(MConfigGet(key=key))
        return reply.values

    async def set_upmap(self, pool_id: int, pg: int,
                        acting: Optional[List[int]] = None) -> None:
        """Install (or clear, with acting=None) a persistent placement
        override — `ceph osd pg-upmap-items` role."""
        await self._mon_rpc(MSetUpmap(pool_id=pool_id, pg=pg,
                                      acting=list(acting or [])))
        await self.refresh_map()

    async def pool_set(self, pool_id: int, key: str, value) -> None:
        """`ceph osd pool set` role (pg_num drives PG splitting)."""
        await self._mon_rpc(MPoolSet(pool_id=pool_id, key=key,
                                     value=str(value)))
        await self.refresh_map()

    async def delete_pool(self, pool_id: int, confirm_name: str) -> None:
        """`ceph osd pool rm` role: `confirm_name` must echo the pool's
        name (the reference's --yes-i-really-really-mean-it guard).
        OSDs purge the pool's data when they see it gone from the map."""
        reply = await self._mon_rpc(MDeletePool(pool_id=pool_id,
                                                confirm_name=confirm_name))
        if not reply.ok:
            raise RadosError(reply.error)
        await self.refresh_map()

    async def mark_osd_down(self, osd_id: int) -> None:
        """Admin: immediately mark an OSD down+out (test/thrash hook)."""
        await self._mon_rpc(MMarkDown(osd_id=osd_id))
        await self.refresh_map()

    async def _osd_membership(self, op: str, osd_id: int,
                              weight: float = 1.0) -> None:
        await self._mon_rpc(
            MOsdMembership(op=op, osd_id=int(osd_id),
                           weight=float(weight)))
        await self.refresh_map()

    async def osd_out(self, osd_id: int) -> None:
        """`ceph osd out <id>`: drop the OSD from placement (weight 0
        through the in_cluster gate) while it stays up — CRUSH remaps
        its PGs minimally and backfill drains it.  Sticky across the
        OSD's reboots until `osd in`."""
        await self._osd_membership("out", osd_id)

    async def osd_in(self, osd_id: int) -> None:
        """`ceph osd in <id>`: restore an out OSD to placement."""
        await self._osd_membership("in", osd_id)

    async def osd_reweight(self, osd_id: int, weight: float) -> None:
        """`ceph osd reweight <id> <0..1>`: the reweight overlay — a
        fractional multiplier on the OSD's crush weight (0 behaves
        like out)."""
        await self._osd_membership("reweight", osd_id, weight)

    async def osd_crush_reweight(self, osd_id: int,
                                 weight: float) -> None:
        """`ceph osd crush reweight osd.<id> <w>`: the straw2 crush
        weight (nominal device capacity share)."""
        await self._osd_membership("crush-reweight", osd_id, weight)

    async def osd_crush_op(self, op: str, name: str, *,
                           bucket_type: str = "", dest: str = "",
                           weight: float = 1.0,
                           force: bool = False) -> int:
        """`ceph osd crush add-bucket/add/set/move/rm`: runtime CRUSH
        hierarchy surgery.  Raises RadosError on refusal (validation is
        mon-side; a failure means the map is untouched); returns the
        post-mutation epoch."""
        reply = await self._mon_rpc(
            MCrushOp(op=op, name=name, bucket_type=bucket_type,
                     dest=dest, weight=float(weight), force=force))
        if not reply.ok:
            raise RadosError(reply.error)
        await self.refresh_map(min_epoch=reply.epoch)
        return reply.epoch

    async def osd_purge(self, osd_id: int, force: bool = False) -> None:
        """`ceph osd purge <id>`: remove the OSD from the map and crush
        permanently.  The mon refuses while the OSD is up or (unless
        ``force``) while safe-to-destroy says data could be lost; a
        refusal surfaces as RadosError (the id survives in the replied
        map)."""
        await self._osd_membership("purge-force" if force else "purge",
                                   osd_id)
        if self.osdmap is not None and osd_id in self.osdmap.osds:
            raise RadosError(
                f"osd.{osd_id} purge refused by the mon (still up, or "
                f"not safe-to-destroy — see the cluster log)")

    async def osd_predicate(self, op: str, osd_ids: List[int]):
        """`ceph osd safe-to-destroy / ok-to-stop`: the data-safety
        predicates, served as reads at ANY mon.  Returns the typed
        MOsdPredicateReply (safe, unsafe_ids, reasons, pgs_checked,
        dirty_blocked, dirty_keys)."""
        return await self._mon_rpc(
            MOsdPredicate(op=op, osd_ids=[int(i) for i in osd_ids]))

    async def osd_safe_to_destroy(self, osd_id: int):
        return await self.osd_predicate("safe-to-destroy", [osd_id])

    async def osd_ok_to_stop(self, *osd_ids: int):
        return await self.osd_predicate("ok-to-stop", list(osd_ids))

    def _parse_pgid(self, pgid: str) -> Tuple[int, int]:
        pool_part, pg_part = str(pgid).split(".", 1)
        return int(pool_part), int(pg_part, 16)

    async def _pg_tell(self, pgid: str, prefix: str,
                       timeout: float = 60.0):
        """Route a single-PG admin command to the PG's primary via the
        MCommand tell path (`ceph pg scrub/repair <pgid>`)."""
        if self.osdmap is None:
            await self.refresh_map()
        try:
            pool_id, pg = self._parse_pgid(pgid)
        except ValueError:
            raise RadosError(f"bad pgid {pgid!r} (want <pool>.<hexpg>)")
        pool = self.osdmap.pools.get(pool_id)
        if pool is None or pg < 0 or pg >= pool.pg_num:
            raise RadosError(f"no such pg {pgid!r}")
        primary = self._pg_primary(pool_id, pg)
        if primary is None:
            raise RadosError(f"pg {pgid} has no live primary")
        return await self.tell(f"osd.{primary}", prefix,
                               timeout=timeout, pgid=f"{pool_id}.{pg:x}")

    async def pg_scrub(self, pgid: str) -> Dict:
        """`ceph pg scrub <pgid>`: deep-scrub one PG on its primary."""
        return await self._pg_tell(pgid, "pg scrub")

    async def pg_repair(self, pgid: str) -> Dict:
        """`ceph pg repair <pgid>`: scrub + repair + verify one PG;
        a clean verify pass clears its PG_INCONSISTENT record."""
        return await self._pg_tell(pgid, "pg repair")

    async def get_health(self, detail: bool = False) -> Dict:
        """Cluster health from the mon's aggregation (reference `ceph
        health [detail]`): map-derived checks (OSD_DOWN, PG_DEGRADED,
        OSDMAP_FLAGS) plus daemon-reported ones (SLOW_OPS, BREAKER_OPEN,
        TIER_OVER_TARGET), with the mute lifecycle applied — the mon is
        the authority, not client-side osdmap math."""
        reply = await self._mon_rpc(MGetHealth(detail=detail))
        return reply.health

    async def health_mute(self, check: str, ttl: float = 0.0,
                          unmute: bool = False) -> Dict:
        """`ceph health mute/unmute <check> [ttl]`: a muted check keeps
        being tracked but no longer degrades the health status."""
        reply = await self._mon_rpc(
            MHealthMute(check=check, ttl=float(ttl), unmute=bool(unmute)))
        return reply.health

    async def log_last(self, n: int = 0, level: int = 0,
                       channel: str = "") -> List[ClogEntry]:
        """`ceph log last [n] [level] [channel]`: the mon's retained
        cluster-log tail (paxos-replicated), oldest first."""
        reply = await self._mon_rpc(
            MLogSubscribe(last_n=n, level=level, channel=channel))
        return decode_entries(reply.entries)

    async def watch_cluster_log(self, callback, level: int = 0,
                                channel: str = "",
                                last_n: int = 16) -> List[ClogEntry]:
        """`ceph -w`: subscribe this session to the cluster log — the
        mon streams every newly committed matching entry as MLog frames
        and ``callback(entry)`` runs per entry (sync or async).  Returns
        the current tail (the part `ceph -w` prints before following)."""
        self._clog_cb = callback
        reply = await self._mon_rpc(
            MLogSubscribe(last_n=last_n, level=level, channel=channel,
                          sub=True))
        return decode_entries(reply.entries)

    async def crash_ls(self) -> List[Dict]:
        """`ceph crash ls`: crash-report summaries, oldest first."""
        reply = await self._mon_rpc(MCrashQuery(op="ls"))
        if not reply.ok:
            raise RadosError(reply.error)
        return reply.crashes

    async def crash_info(self, crash_id: str) -> Dict:
        """`ceph crash info <id>`: one report in full, the spooled
        dump_recent ring decoded."""
        reply = await self._mon_rpc(MCrashQuery(op="info",
                                                crash_id=crash_id))
        if not reply.ok:
            raise RadosError(reply.error)
        return reply.crashes[0]

    async def crash_archive(self, crash_id: str = "") -> List[Dict]:
        """`ceph crash archive <id>` ('' = archive-all): acknowledged
        crashes stop raising RECENT_CRASH but stay listable."""
        reply = await self._mon_rpc(MCrashQuery(
            op="archive" if crash_id else "archive-all",
            crash_id=crash_id))
        if not reply.ok:
            raise RadosError(reply.error)
        return reply.crashes

    async def crash_prune(self, keep_seconds: float) -> List[Dict]:
        """`ceph crash prune`: drop reports older than keep_seconds."""
        reply = await self._mon_rpc(MCrashQuery(op="prune",
                                                keep=keep_seconds))
        if not reply.ok:
            raise RadosError(reply.error)
        return reply.crashes

    async def tell(self, target: str, prefix: str, timeout: float = 5.0,
                   **args):
        """`ceph tell <target> <cmd> [k=v...]` (reference MCommand):
        run an admin-socket command on a remote daemon.  Targets:
        ``osd.N`` (resolved via the osdmap), ``mon`` / ``mon.N`` (the
        monmap), ``mgr`` (the mgr_addr config key)."""
        if target.startswith("osd."):
            if self.osdmap is None:
                await self.refresh_map()
            osd_id = int(target.split(".", 1)[1])
            info = self.osdmap.osds.get(osd_id)
            if info is None or not info.up:
                raise RadosError(f"{target} is not up")
            addr = tuple(info.addr)
        elif target == "mon" or target.startswith("mon."):
            rank = int(target.split(".", 1)[1]) if "." in target else 0
            addr = self.mons.addrs[rank % len(self.mons.addrs)]
        elif target == "mgr":
            raw = str(self.conf.get("mgr_addr", "") or "")
            if not raw:
                reply = await self.config_get("mgr_addr")
                raw = reply.get("mgr_addr", "")
            if not raw:
                raise RadosError("no mgr_addr known")
            host, port = raw.rsplit(":", 1)
            addr = (host, int(port))
        else:
            raise RadosError(f"bad tell target {target!r} "
                             f"(want osd.N / mon[.N] / mgr)")
        tid = uuid.uuid4().hex
        fut = asyncio.get_running_loop().create_future()
        self._tell_futs[tid] = fut
        try:
            await self.messenger.send(
                addr, MCommand(tid=tid, target=target, prefix=prefix,
                               args=dict(args)))
            reply = await asyncio.wait_for(fut, timeout=timeout)
        finally:
            self._tell_futs.pop(tid, None)
        if not reply.ok:
            raise RadosError(reply.error)
        return reply.result

    async def osd_set_flag(self, flag: str, on: bool = True) -> None:
        """`ceph osd set/unset <flag>` role: toggle a cluster-wide op
        gate ("pausewr", "pauserd", "full") in the OSDMap.  Clients
        QUEUE matching ops while the flag is set (paused-map handling),
        so unsetting it releases the queued work rather than retrying
        failures."""
        await self._mon_rpc(MOSDSetFlag(flag=flag, set=bool(on)))
        await self.refresh_map()

    async def osd_set_full_ratio(self, which: str, ratio: float) -> None:
        """`ceph osd set-nearfull-ratio / set-backfillfull-ratio /
        set-full-ratio`: install a fullness threshold in the OSDMap.
        The mon validates the ladder ordering and answers a typed
        error on violation."""
        reply = await self._mon_rpc(
            MSetFullRatio(which=which, ratio=float(ratio)))
        if not getattr(reply, "ok", True):
            raise RadosError(reply.error, code=-errno.EINVAL)
        await self.refresh_map()

    async def osd_df(self) -> Dict[int, Dict]:
        """Per-OSD utilization + fullness from the MON's aggregated
        view (ONE MGetHealth-style query instead of N per-OSD statfs
        ops).  Falls back to direct per-OSD polling when the mon
        predates the fullness plane (no osd_utilization in its health
        document)."""
        health = await self.get_health()
        util = health.get("osd_utilization")
        if util is not None:
            return {int(k): dict(v) for k, v in util.items()}
        # old mon: poll each up OSD directly, CONCURRENTLY — one
        # unresponsive OSD must cost one timeout, not serialize the
        # sweep (the discipline of the pre-aggregation fan-out)
        await self.refresh_map()

        async def one(osd_id: int, info) -> Tuple[int, Dict]:
            row: Dict = {"up": info.up, "weight": info.weight,
                         "state": ""}
            if info.up:
                try:
                    st = await self.osd_statfs(osd_id)
                    total = int(st.get("total", 0) or 0)
                    used = int(st.get("used", 0) or 0)
                    row.update(
                        total=total, used=used,
                        avail=int(st.get("avail", 0) or 0),
                        num_objects=int(st.get("num_objects", 0) or 0),
                        ratio=round(used / total, 4) if total else 0.0)
                except Exception as e:
                    row["error"] = str(e)
            return osd_id, row

        return dict(await asyncio.gather(
            *(one(osd_id, info)
              for osd_id, info in sorted(self.osdmap.osds.items()))))

    # -- data ops -------------------------------------------------------------

    def _calc_target(self, op: MOSDOp) -> Tuple[Optional[int], Optional[int]]:
        """object -> (PG, primary) on the current map (reference
        Objecter::_calc_target, Objecter.cc:2764)."""
        pool = self.osdmap.pools.get(op.pool_id)
        if pool is None:
            return None, None
        pg = self.osdmap.object_to_pg(pool, op.oid)
        acting = self.osdmap.pg_to_acting(pool, pg)
        return pg, self.osdmap.primary_of(acting,
                                          seed=(op.pool_id << 20) | pg)

    def _retry_pause(self, attempt: int) -> float:
        """Retry pacing: capped exponential backoff with jitter —
        min(base * 2^attempt, cap) scaled by a uniform [0.5, 1.5) draw,
        so colliding clients decorrelate instead of re-colliding every
        backoff period (the Objecter's retry discipline + thundering-herd
        jitter)."""
        return min(self.backoff_base * (2 ** attempt), self.backoff_cap) \
            * (0.5 + random.random())

    def _paused_for(self, op: MOSDOp) -> bool:
        """Is this op gated by the map's pause flags? (reference
        Objecter::target_should_be_paused)  DELETES are exempt from the
        write gates: when the cluster pauses because it is FULL,
        deleting is the only way out — the delete path must thread
        through pausewr/full like it threads through the OSD's fullness
        gates."""
        flags = getattr(self.osdmap, "flags", None) or ()
        if op.op in ("delete", "snap-trim") \
                or (op.op == "multi" and is_delete_only_multi(op)):
            return False
        if op.op in _WRITE_OPS:
            return "pausewr" in flags or "full" in flags
        return "pauserd" in flags

    async def _wait_unpaused(self, rec: _OpRecord) -> None:
        """Paused ops QUEUE, they do not fail: poll the mon for the map
        that lifts the gate (the Objecter keeps paused ops queued and
        resubmits on the flag-clearing map)."""
        interval = 0.2
        while time.monotonic() < rec.deadline:
            await asyncio.sleep(interval)
            interval = min(interval * 1.5, 1.0)
            try:
                await self.refresh_map()
            except (ConnectionError, OSError, asyncio.TimeoutError):
                continue
            if not self._paused_for(rec.op):
                return
        # deadline reached: fall back to the loop, which raises

    async def _park_backoff(self, key: Tuple[int, int],
                            rec: _OpRecord) -> None:
        """Park until the PG's backoff releases — or until its duration
        expires / the op deadline nears (liveness when the unblock is
        lost).  Wait seconds land in the backoff_wait_s longrunavg."""
        ent = self._backoffs.get(key)
        if ent is None:
            return
        now = time.monotonic()
        if now >= ent["expiry"]:
            self._release_backoff(key)  # expired: resend anyway
            return
        timeout = max(0.01, min(ent["expiry"] - now, rec.deadline - now))
        with self.perf.time_avg("backoff_wait_s"):
            try:
                await asyncio.wait_for(ent["event"].wait(), timeout=timeout)
            except asyncio.TimeoutError:
                if self._backoffs.get(key) is ent:
                    self._release_backoff(key)
        # decorrelate the release burst: every op parked on this PG wakes
        # at once, and without jitter the resend order is stable cycle
        # after cycle — under repeated saturation sheds the same ops win
        # admission every time while the tail starves deterministically
        await asyncio.sleep(random.random() * 0.05)

    async def _op(self, op: MOSDOp,
                  retries: Optional[int] = None) -> MOSDOpReply:
        """Objecter-grade submit (reference op_submit/_calc_target/_send_op,
        Objecter.cc:2257,2764,3233): ONE reqid for the op's whole lifetime
        (server dedupe = exactly-once) and a persistent in-flight record;
        re-target on every map change (a refresh that moves the primary
        wakes the reply wait), epoch barriers on retryable errors, pause
        flags queue, MOSDBackoff parks, and capped-exponential-jitter
        pacing between resends.  Transient trouble NEVER fails the op
        before the deadline (client_op_deadline); ``retries`` caps
        attempts for callers that want the old bounded behavior."""
        if self.osdmap is None:
            await self.refresh_map()
        # ONE reqid per logical op: resends carry the same id so the PG
        # log's dup detection can recognize them (reference osd_reqid_t)
        op.reqid = uuid.uuid4().hex
        if not getattr(op, "client", ""):
            op.client = self.name
        rec = _OpRecord(op, time.monotonic() + self.op_deadline)
        # root span for the whole logical op (across every resend); its
        # context rides the MOSDOp so the primary's osd_op span — and
        # through it the k+m sub-write peers — stitch under ONE trace_id
        span = None
        if self._trace_on:
            span = self.tracer.new_trace(f"client_op {op.op} {op.oid}")
            span.tag("reqid", op.reqid).tag("pool", op.pool_id)
            op.trace_id, op.span_id = span.context()
        self.perf.inc("op")
        self._inflight[op.reqid] = rec
        self.perf.set("inflight", len(self._inflight))
        try:
            reply = await self._op_submit(op, rec, retries, span)
            if span is not None:
                span.tag("ok", True)
            return reply
        except BaseException as e:
            if span is not None:
                span.tag("ok", False).tag("error", type(e).__name__)
            raise
        finally:
            if span is not None:
                span.finish()
            self._inflight.pop(op.reqid, None)
            self.perf.set("inflight", len(self._inflight))

    async def _op_submit(self, op: MOSDOp, rec: _OpRecord,
                         retries: Optional[int],
                         span=None) -> MOSDOpReply:
        loop = asyncio.get_running_loop()
        last_error = "no attempt"
        last_code = 0
        fence = 0  # minimum epoch the next target may be computed on
        refresh_next = False  # one refresh owed (transport blip)
        attempt = 0  # attempts CONSUMED (sends + failed refreshes)
        sends = 0
        # the deadline governs from the moment ANY work happened (a send
        # OR a consumed attempt); the virgin first iteration is always
        # admitted so a deadline in the past still tries once
        while (retries is None or attempt < retries) \
                and (time.monotonic() < rec.deadline
                     or (attempt == 0 and sends == 0)):
            if fence > self.osdmap.epoch or (attempt and fence == 0) \
                    or refresh_next:
                refresh_next = False
                try:
                    await self.refresh_map(min_epoch=fence)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    last_error = "map refresh failed"
                    await asyncio.sleep(self._retry_pause(attempt))
                    attempt += 1
                    continue
            if self._paused_for(op):
                # paused map (pausewr/pauserd/full): queue, don't fail —
                # and consume no attempt (the cluster asked us to wait)
                if not rec.paused_counted:
                    rec.paused_counted = True
                    self.perf.inc("paused_ops")
                last_error = "osdmap paused"
                await self._wait_unpaused(rec)
                if self._paused_for(op):
                    break  # deadline ran out still paused
                continue
            pool = self.osdmap.pools.get(op.pool_id)
            if pool is None:
                # a lagging mon may have served us a pre-creation map:
                # refresh-and-retry (Objecter catches up across epochs)
                last_error = (
                    f"pool {op.pool_id} not in map epoch {self.osdmap.epoch}")
                last_code = -errno.ENOENT
                fence = self.osdmap.epoch + 1
                await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
                continue
            pg, primary = self._calc_target(op)
            if primary is None:
                last_error = "no primary (all acting osds down)"
                last_code = 0
                fence = self.osdmap.epoch + 1
                await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
                continue
            rec.pg = pg
            if (op.pool_id, pg) in self._backoffs:
                # the PG told us to hold off: park until release/expiry,
                # then re-target (no attempt consumed — server-directed)
                last_error = f"backoff on pg {op.pool_id}.{pg}"
                await self._park_backoff((op.pool_id, pg), rec)
                if time.monotonic() >= rec.deadline:
                    break
                continue
            rec.target = primary
            rec.epoch = self.osdmap.epoch
            op.epoch = self.osdmap.epoch
            fut: asyncio.Future = loop.create_future()
            rec.fut = fut
            self._replies[op.reqid] = fut
            try:
                if sends:
                    self.perf.inc("resends")
                sends += 1
                if span is not None:
                    span.event("resend" if sends > 1
                               else f"sent to osd.{primary}")
                await self.messenger.send(self.osdmap.addr_of(primary), op)
                timeout = min(float(self.op_timeout),
                              max(0.05, rec.deadline - time.monotonic()))
                reply = await asyncio.wait_for(fut, timeout=timeout)
                if reply.ok:
                    return reply
                last_error = reply.error
                # classification is by TYPED code (reference 0/-errno):
                # a reworded error string can never silently change an
                # op's retry behavior
                code = last_code = getattr(reply, "code", 0)
                if code in _DEFINITIVE_CODES:
                    raise RadosError(
                        f"op {op.op} {op.oid} failed: {reply.error}",
                        code=code)
                # epoch barrier: never re-target on a map older than the
                # replying OSD's (it refused exactly because placement
                # moved — recomputing on our stale map re-picks it)
                fence = max(fence, getattr(reply, "map_epoch", 0))
                if code in (-errno.ESTALE, -errno.EAGAIN):
                    # placement moved / PG degraded: both are cured by a
                    # newer map — fence PAST our own epoch, growing window
                    # while detection + recovery move seats.  A server-
                    # provided backoff hint extends the pause: the PG told
                    # us how long it wants.
                    fence = max(fence, self.osdmap.epoch + 1)
                    pause = max(getattr(reply, "backoff", 0.0),
                                self._retry_pause(attempt) if attempt
                                else 0.0)
                    if pause:
                        await asyncio.sleep(pause)
                    attempt += 1
                    continue
                # -EBUSY and anything unclassified: prompt plain retry
                await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
            except _OpKick:
                # the map moved our target, or a backoff landed for our
                # PG: re-enter the loop NOW (re-target / park) — no
                # attempt consumed, no pause (the kicker knows better)
                self.perf.inc("map_kicks")
            except PermissionError:
                # expired/rotated-away ticket: fetch a fresh one and retry
                last_error = "ticket rejected"
                try:
                    await self._fetch_ticket()
                except Exception:
                    await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
            except asyncio.TimeoutError:
                # per-op reply timeout: the target may be wedged or the
                # reply lost — refresh to the CURRENT map and resend
                # (dedupe-safe); only the deadline fails the op
                self.perf.inc("timeouts")
                last_error = "op timed out"
                last_code = 0
                refresh_next = True
                await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
            except (ConnectionError, OSError) as e:
                last_error = f"{type(e).__name__}: {e}"
                last_code = 0  # transport failure: no typed OSD answer
                # the target may have died — but a transport blip has NO
                # map change coming, so the next attempt refreshes to the
                # CURRENT map (one RPC at loop top), not a future epoch
                # (a 2s poll per blip).  If the target is unchanged the
                # resend is dedupe-safe; if the OSD really died, failure
                # detection bumps the epoch and re-targets us.
                refresh_next = True
                await asyncio.sleep(self._retry_pause(attempt))
                attempt += 1
            finally:
                # a kick may have raced a send() error into the same
                # iteration: mark any unawaited exception retrieved so
                # the abandoned future never logs at GC
                if fut.done() and not fut.cancelled():
                    fut.exception()
                rec.fut = None
                self._replies.pop(op.reqid, None)
        raise RadosError(f"op {op.op} {op.oid} failed: {last_error}",
                         code=last_code)

    @staticmethod
    def _check_oid(oid: str) -> None:
        if SNAP_SEP in oid:
            raise RadosError("oid contains the reserved snap separator",
                             code=-errno.EINVAL)

    def _write_snapc(self, pool_id: int, snapc):
        """The SnapContext a write carries: the caller's, or — for a
        pool in pool-snaps mode — the POOL's own context from the
        osdmap (reference IoCtxImpl: the ioctx snapc defaults to the
        pool snapc), so every writer path clones pre-snap heads without
        knowing pool snapshots exist."""
        if snapc:
            return snapc
        pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
        if pool is not None and getattr(pool, "snap_mode", "") == "pool":
            return pool.pool_snapc()
        return (0, [])

    async def put(self, pool_id: int, oid: str, data: bytes,
                  offset: Optional[int] = None,
                  snapc: Optional[Tuple[int, List[int]]] = None,
                  client: str = "") -> None:
        """Full-object write, or a partial overwrite at `offset` (the
        primary takes the read-modify-write path).  ``snapc`` is a
        self-managed snap context (seq, snaps-descending): the primary
        clones the head before the first write past a new snap
        (reference SnapContext on every write).  ``client`` overrides
        the entity name this op carries (simulated-tenant identity for
        the macro traffic harness; default: this client's name)."""
        self._check_oid(oid)
        seq, snaps = self._write_snapc(pool_id, snapc)
        await self._op(MOSDOp(op="write", pool_id=pool_id, oid=oid, data=data,
                              offset=-1 if offset is None else int(offset),
                              snapc_seq=seq, snapc_snaps=list(snaps),
                              client=client))

    async def multi(self, pool_id: int, oid: str, ops,
                    snapc: Optional[Tuple[int, List[int]]] = None):
        """Compound atomic op (reference MOSDOp vector<OSDOp> /
        ObjectWriteOperation): `ops` is an ordered list of (name, kwargs)
        sub-ops executed all-or-nothing on one object.  Returns
        (per-sub-op results, object version the op observed); a failing
        sub-op raises RadosError with its typed code and nothing
        applied."""
        self._check_oid(oid)
        seq, snaps = self._write_snapc(pool_id, snapc)
        reply = await self._op(MOSDOp(op="multi", pool_id=pool_id, oid=oid,
                                      ops=list(ops), snapc_seq=seq,
                                      snapc_snaps=list(snaps)))
        return unpickle.loads(reply.data), reply.version

    # -- self-managed snapshots (reference IoCtxImpl selfmanaged_snap_*) ----

    async def selfmanaged_snap_create(self, pool_id: int) -> int:
        """Allocate a new cluster-unique snap id (the mon is the
        allocator)."""
        reply = await self._mon_rpc(MSnapOp(pool_id=pool_id, op="create"))
        if not reply.ok:
            raise RadosError(reply.error, code=reply.code)
        await self.refresh_map()
        return reply.snap_id

    async def selfmanaged_snap_remove(self, pool_id: int,
                                      snap_id: int) -> None:
        """Mark the snap removed in the pool and trim its clones
        (reference snap trimmer).  Trim is best-effort immediate and
        idempotent: an OSD that was down during the fan-out keeps its
        clones until this call is re-run (the mon records the removal
        first, so re-running re-trims everywhere)."""
        reply = await self._mon_rpc(
            MSnapOp(pool_id=pool_id, op="remove", snap_id=snap_id))
        if not reply.ok:
            raise RadosError(reply.error, code=reply.code)
        await self.refresh_map()
        for osd_id in self._pg_primaries(pool_id):
            try:
                await self._op_direct(osd_id, MOSDOp(
                    op="snap-trim", pool_id=pool_id, snap_id=snap_id))
            except RadosError:
                continue

    # -- pool-managed snapshots (reference `ceph osd pool mksnap`,
    # OSDMonitor pool-op SNAP_CREATE/SNAP_RM; mixing with self-managed
    # snaps is a typed -EINVAL at the mon) ----------------------------------

    async def pool_snap_create(self, pool_id: int, name: str) -> int:
        """Create a mon-managed pool snapshot; every subsequent write
        carries the pool's SnapContext, so heads clone lazily on first
        overwrite (the same make_writeable machinery as self-managed
        snaps)."""
        reply = await self._mon_rpc(
            MSnapOp(pool_id=pool_id, op="mksnap", name=name))
        if not reply.ok:
            raise RadosError(reply.error, code=reply.code)
        await self.refresh_map()
        return reply.snap_id

    async def pool_snap_remove(self, pool_id: int, name: str) -> None:
        """Remove a pool snapshot and trim its clones (same fan-out
        discipline as selfmanaged_snap_remove: mon records first, trim
        is idempotent best-effort)."""
        reply = await self._mon_rpc(
            MSnapOp(pool_id=pool_id, op="rmsnap", name=name))
        if not reply.ok:
            raise RadosError(reply.error, code=reply.code)
        await self.refresh_map()
        for osd_id in self._pg_primaries(pool_id):
            try:
                await self._op_direct(osd_id, MOSDOp(
                    op="snap-trim", pool_id=pool_id,
                    snap_id=reply.snap_id))
            except RadosError:
                continue

    async def rollback_object(self, pool_id: int, oid: str, snap_id: int,
                              snapc=None) -> None:
        """Restore one object's head to its state at `snap_id`
        (reference rollback: read-at-snap -> write head; an object
        absent at the snap is removed).  The ONE implementation behind
        ioctx self-managed rollback, pool-snap rollback, and the rados
        CLI."""
        try:
            old = await self.get(pool_id, oid, snap=snap_id)
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            await self.delete(pool_id, oid, snapc=snapc)
            return
        await self.put(pool_id, oid, old, snapc=snapc)

    async def pool_snap_list(self, pool_id: int) -> Dict[str, int]:
        await self.refresh_map()
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            raise RadosError(f"pool {pool_id} does not exist",
                             code=-errno.ENOENT)
        return dict(getattr(pool, "pool_snaps", {}) or {})

    async def osd_statfs(self, osd_id: int) -> Dict:
        """One OSD's store utilization (reference ObjectStore::statfs
        feeding `ceph osd df`)."""
        import json as _json

        reply = await self._op_direct(osd_id, MOSDOp(op="statfs"))
        return _json.loads(reply.data)

    async def deep_scrub(self, pool_id: int) -> Dict[str, int]:
        """Ask every up OSD to deep-scrub the PGs it leads; sums the
        per-primary summaries."""
        total = {"scrubbed": 0, "errors": 0, "repaired": 0}
        for osd_id in self._pg_primaries(pool_id):
            try:
                reply = await self._op_direct(
                    osd_id, MOSDOp(op="deep-scrub", pool_id=pool_id))
                for k, v in unpickle.loads(reply.data).items():
                    total[k] = total.get(k, 0) + v
            except RadosError:
                continue
        return total

    async def get(self, pool_id: int, oid: str, snap: int = 0,
                  fadvise: str = "", client: str = "") -> bytes:
        """Read the head, or the object's state AT a snap id (resolved
        through the primary's SnapSet clone list).  ``fadvise`` is
        cache-tier advice (reference librados FADVISE_DONTNEED/WILLNEED
        op flags): "dontneed" keeps this read out of the hit sets and
        off the promotion path (scans, backups); "willneed" asks the
        primary to promote the object to device residency on this read
        regardless of its recency (still promotion-throttled)."""
        self._check_oid(oid)
        reply = await self._op(MOSDOp(op="read", pool_id=pool_id, oid=oid,
                                      snap_read=int(snap),
                                      fadvise=fadvise, client=client))
        data = reply.data
        if isinstance(data, BufferList):
            # colocated fastpath hands the primary's scatter-gather read
            # reply over by reference; materialize at the API boundary
            # (the wire path already delivered one contiguous buffer)
            data = data.tobytes()
        return data

    async def delete(self, pool_id: int, oid: str,
                     snapc: Optional[Tuple[int, List[int]]] = None,
                     client: str = "") -> None:
        """Delete the head; under a snap context the primary clones
        first and leaves a whiteout so snapshots keep resolving."""
        self._check_oid(oid)
        seq, snaps = self._write_snapc(pool_id, snapc)
        await self._op(MOSDOp(op="delete", pool_id=pool_id, oid=oid,
                              snapc_seq=seq, snapc_snaps=list(snaps),
                              client=client))

    async def watch(self, pool_id: int, oid: str, callback) -> None:
        """Register a notify callback on oid (librados watch2 role).
        Watches are LINGER ops (reference Objecter::linger_watch): the
        client tracks the registered primary and automatically
        re-registers when a map refresh shows the primary moved — the
        new primary has no watcher state for us until then."""
        import pickle as _pickle

        self._watches[(pool_id, oid)] = callback
        try:
            await self._op(MOSDOp(op="watch", pool_id=pool_id, oid=oid,
                                  data=_pickle.dumps(self.messenger.addr)))
        except BaseException:
            self._watches.pop((pool_id, oid), None)  # registration failed
            raise
        self._watch_primaries[(pool_id, oid)] = self._primary_for(pool_id, oid)
        if self._linger_poll_task is None or self._linger_poll_task.done():
            # an IDLE watcher issues no ops, so nothing would ever pull a
            # new map: poll while watches exist (reference: the Objecter
            # subscribes to maps; this is the polling analog)
            self._linger_poll_task = asyncio.get_running_loop().create_task(
                self._linger_poll())

    async def _linger_poll(self) -> None:
        interval = float(self.conf.get("client_linger_poll", 1.0) or 1.0)
        while self._watches:
            await asyncio.sleep(interval)
            if not self._watches:
                break
            try:
                await self.refresh_map()  # _kick_relinger rides this
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass

    def _primary_for(self, pool_id: int, oid: str) -> Optional[int]:
        pool = self.osdmap.pools.get(pool_id) if self.osdmap else None
        if pool is None:
            return None
        pg = self.osdmap.object_to_pg(pool, oid)
        acting = self.osdmap.pg_to_acting(pool, pg)
        return self.osdmap.primary_of(acting, seed=(pool_id << 20) | pg)

    def _kick_relinger(self) -> None:
        """After a map change: re-register watches whose primary moved
        (on a task of its own — refresh_map runs inside op retries and
        must not recurse into more ops)."""
        stale = [key for key, registered in self._watch_primaries.items()
                 if key in self._watches
                 and self._primary_for(*key) not in (None, registered)]
        if not stale or (self._relinger_task
                         and not self._relinger_task.done()):
            return

        async def _relinger() -> None:
            import pickle as _pickle

            for pool_id, oid in stale:
                if (pool_id, oid) not in self._watches:
                    continue  # unwatched meanwhile
                try:
                    await self._op(MOSDOp(
                        op="watch", pool_id=pool_id, oid=oid,
                        data=_pickle.dumps(self.messenger.addr)))
                    self._watch_primaries[(pool_id, oid)] = \
                        self._primary_for(pool_id, oid)
                except RadosError:
                    pass  # next map change retries

        self._relinger_task = asyncio.get_running_loop().create_task(
            _relinger())

    async def unwatch(self, pool_id: int, oid: str) -> None:
        import pickle as _pickle

        await self._op(MOSDOp(op="unwatch", pool_id=pool_id, oid=oid,
                              data=_pickle.dumps(self.messenger.addr)))
        self._watches.pop((pool_id, oid), None)  # only after the OSD agreed
        self._watch_primaries.pop((pool_id, oid), None)

    async def notify(self, pool_id: int, oid: str,
                     payload: bytes = b"") -> List:
        """Notify watchers; returns the list of watcher addrs that acked
        (librados notify2 reply role)."""
        reply = await self._op(MOSDOp(op="notify", pool_id=pool_id, oid=oid,
                                      data=payload))
        return unpickle.loads(reply.data)

    async def list_objects(self, pool_id: int,
                           nspace: str = "") -> List[str]:
        """Paginated per-PG-primary listing (reference pgls/do_pgnls):
        admin listings scale with PG count, never cluster size.  Falls
        back to the all-OSD union for a PG whose primary cannot answer
        (mid-peering) — correctness over elegance for admin tooling.
        `nspace` filters server-side ("" = default namespace,
        ALL_NSPACES = everything); returned names are WIRE names — the
        IoCtx strips its namespace prefix for its callers."""
        if self.osdmap is None:
            await self.refresh_map()
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            # our map may predate the pool: one refresh before concluding
            await self.refresh_map()
            pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            raise RadosError(f"pool {pool_id} does not exist",
                             code=-errno.ENOENT)
        oids: set = set()
        fallback = False
        for pg in range(pool.pg_num):
            acting = self.osdmap.pg_to_acting(pool, pg)
            primary = self.osdmap.primary_of(acting,
                                             seed=(pool_id << 20) | pg)
            if primary is None:
                fallback = True
                continue
            cursor = ""
            while True:
                try:
                    reply = await self._op_direct(primary, MOSDOp(
                        op="pgls", pool_id=pool_id, pg=pg, cursor=cursor,
                        nspace=nspace))
                except RadosError:
                    fallback = True
                    break
                oids.update(reply.oids)
                cursor = getattr(reply, "cursor", "")
                if not cursor:
                    break
        if fallback:
            # degraded path: union of per-OSD listings covers the holes
            for osd in self.osdmap.osds.values():
                if not osd.up:
                    continue
                try:
                    reply = await self._op_direct(
                        osd.osd_id, MOSDOp(op="list", pool_id=pool_id,
                                           nspace=nspace))
                    oids.update(reply.oids)
                except RadosError:
                    continue
        return sorted(oids)

    def _pg_primaries(self, pool_id: int) -> List[int]:
        """The distinct primaries of a pool's PGs — the scrub/repair
        fan-out set (per-PG primaries, not every OSD in the cluster)."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            return []
        primaries = set()
        for pg in range(pool.pg_num):
            acting = self.osdmap.pg_to_acting(pool, pg)
            p = self.osdmap.primary_of(acting, seed=(pool_id << 20) | pg)
            if p is not None:
                primaries.add(p)
        return sorted(primaries)

    async def repair_pool(self, pool_id: int) -> None:
        """Primary-led repair, fanned out to the pool's PG primaries."""
        for osd_id in self._pg_primaries(pool_id):
            try:
                await self._op_direct(osd_id,
                                      MOSDOp(op="repair", pool_id=pool_id))
            except RadosError:
                continue

    async def _op_direct(self, osd_id: int, op: MOSDOp) -> MOSDOpReply:
        op.reqid = uuid.uuid4().hex
        if not getattr(op, "client", ""):
            op.client = self.name
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._replies[op.reqid] = fut
        try:
            await self.messenger.send(self.osdmap.addr_of(osd_id), op)
            reply = await asyncio.wait_for(fut, timeout=self.op_timeout)
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            raise RadosError(str(e))
        finally:
            self._replies.pop(op.reqid, None)
        if not reply.ok:
            raise RadosError(reply.error, code=getattr(reply, "code", 0))
        return reply
