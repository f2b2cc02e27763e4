# Copy of ceph_tpu/rados/scheduler.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""OSD op scheduling: sharded op queue with WPQ and mClock schedulers.

Role-equivalent of the reference's op queue stack (reference
src/osd/scheduler/{OpScheduler,mClockScheduler}.cc, the sharded op queue
`op_shardedwq` at src/osd/OSD.h:1590): incoming ops are hashed by PG onto
one of N shards — per-PG ordering is preserved because a PG always lands on
the same shard — and each shard's worker drains a pluggable scheduler:

- WPQ (weighted priority queue, OpScheduler.cc WeightedPriorityQueue):
  strict classes above the high-priority cutoff, weighted-fair draining of
  the rest by priority.
- mClock (mClockScheduler.cc, after the mClock paper): per-class QoS tags
  (reservation r, weight w, limit l).  Each op gets tags R/P/L from its
  class state; dequeue serves first any class with R-tag due (reservation
  guarantee), else the eligible class with the smallest P-tag (weighted
  sharing) subject to L (limit).  Classes here mirror the reference's:
  client, recovery (background_recovery), best_effort (scrub/snaptrim —
  and the cache-tier flush/evict agent, whose single-flight passes ride
  CLASS_BEST_EFFORT so eviction work never outruns client reads).

dmClock tag discipline (multi-tenant QoS, reference mClockScheduler.cc
client_profile_id_map): a CLASS_CLIENT op that carries a client entity
name (MOSDOp v6 ``client``) gets its OWN tag state — per-client
isolation, managed by qos.ClientRegistry — created from the pool's
resolved profile (qos.pool_qos: ``pool set qos_reservation /
qos_weight / qos_limit`` defaults plus ``qos_class:<name>`` tenant-class
overrides, all mon-validated and osdmap-distributed).  Tags at arrival
t:  R = max(R + 1/r, t), P = max(P + 1/w, t), L = max(L + 1/l, t);
reservation and limit are ops/sec (IOPS — tags advance by one op; byte
cost stays with the queue's budget throttle).  Dequeue: (1) any state
with a due R-tag, earliest first — the reservation guarantee; (2) else
the smallest P-tag among states under their limit — weighted surplus
sharing; (3) else the smallest P-tag outright — work-conserving: the
limit SHAPES ordering under contention but never idles the shard (the
hard enforcement of a flooder's limit is the admission-side saturation
shed, osd.py _op_backoff_reason via qos.QosTracker).  The serving split
is counted in the ``osd_scheduler`` perf set
(served_reservation/served_weight/served_fallback); per-shard states
each see ~1/n_shards of a client's traffic, so profiles apply
per-shard while the OSD-level QosTracker sees the full offered rate.
``clock`` is injectable for deterministic tag-math tests.

The asyncio translation: shard workers are tasks, not threads.  The
scheduler decides ORDER; execution preserves strict ordering only per
order_key (the PG): ops for the SAME PG run one at a time in dequeue
order (the PG lock discipline version assignment and log appends rely
on), while ops for DIFFERENT PGs on one shard overlap up to
osd_pg_op_concurrency — the reference's pipeline overlap
(ECBackend.h:557-560) at PG granularity.  Handlers must not assume
shard-level exclusivity for cross-PG or OSD-global state.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.qos import ClientRegistry, ClientState, QosParams

CLASS_CLIENT = "client"
CLASS_RECOVERY = "recovery"
CLASS_REBALANCE = "rebalance"
CLASS_SCRUB = "scrub"
CLASS_BEST_EFFORT = "best_effort"
# cache-tier flush destage (dirty raw replicas -> k+m EC shards): classed
# ABOVE best_effort — flush backlog holds acked-but-not-EC-durable client
# data, so destaging outranks eviction/scrub housekeeping but still
# yields to client reservations
CLASS_FLUSH = "flush"

# Background dmClock profiles by operator intent (reference
# osd_mclock_profile: balanced / high_client_ops / high_recovery_ops
# allocate the OSD's IOPS between client and background service
# classes).  Per class: (reservation ops/s, weight, limit ops/s,
# rho/delta burst seconds — how much idle credit the class may bank, so
# a background sweep waking under client load gets a short head start
# instead of trickling one op per 1/limit).  Rebalance (CRUSH-driven
# data movement after out/in/reweight) is classed BELOW recovery:
# restoring redundancy outranks restoring placement.
MCLOCK_PROFILES = {
    "balanced": {
        CLASS_CLIENT: (100.0, 10.0, 0.0, 0.5),
        CLASS_RECOVERY: (10.0, 3.0, 50.0, 1.0),
        CLASS_REBALANCE: (5.0, 2.0, 30.0, 1.0),
        CLASS_FLUSH: (8.0, 3.0, 40.0, 1.0),
        CLASS_SCRUB: (1.0, 1.0, 20.0, 1.0),
        CLASS_BEST_EFFORT: (1.0, 1.0, 20.0, 0.0),
    },
    "high_client_ops": {
        CLASS_CLIENT: (150.0, 20.0, 0.0, 0.5),
        CLASS_RECOVERY: (5.0, 2.0, 25.0, 0.5),
        CLASS_REBALANCE: (2.0, 1.0, 15.0, 0.5),
        CLASS_FLUSH: (4.0, 2.0, 20.0, 0.5),
        CLASS_SCRUB: (1.0, 1.0, 10.0, 0.5),
        CLASS_BEST_EFFORT: (1.0, 1.0, 10.0, 0.0),
    },
    "high_recovery_ops": {
        CLASS_CLIENT: (50.0, 5.0, 0.0, 0.5),
        CLASS_RECOVERY: (40.0, 8.0, 100.0, 2.0),
        CLASS_REBALANCE: (20.0, 4.0, 60.0, 2.0),
        CLASS_FLUSH: (15.0, 4.0, 60.0, 1.0),
        CLASS_SCRUB: (2.0, 2.0, 30.0, 1.0),
        CLASS_BEST_EFFORT: (1.0, 1.0, 20.0, 0.0),
    },
}

_seq = itertools.count()


@dataclass(order=True)
class _Item:
    sort_key: Tuple = field(compare=True)
    run: Callable[[], Awaitable[None]] = field(compare=False, default=None)
    op_class: str = field(compare=False, default=CLASS_CLIENT)
    cost: int = field(compare=False, default=1)
    # ops sharing an order_key execute strictly in dequeue order (the
    # per-PG lock discipline); different keys on one shard may OVERLAP —
    # the pipelining that keeps the device batching queue fed
    order_key: Any = field(compare=False, default=None)


class WPQScheduler:
    """Weighted priority queue: higher priority drained proportionally more
    often; strict classes (priority >= cutoff) always first."""

    PRIORITIES = {CLASS_CLIENT: 63, CLASS_RECOVERY: 10,
                  CLASS_REBALANCE: 8, CLASS_FLUSH: 7,
                  CLASS_SCRUB: 5, CLASS_BEST_EFFORT: 5}
    STRICT_CUTOFF = 196  # reference osd_op_queue_cut_off high

    def __init__(self, conf: Optional[dict] = None):
        self._strict: List[_Item] = []
        self._queues: Dict[int, List[_Item]] = {}  # priority -> FIFO heap
        self._size = 0

    def enqueue(self, op_class: str, run, cost: int = 1,
                priority: Optional[int] = None, order_key: Any = None,
                client: str = "", qos: Optional[QosParams] = None,
                qos_cost: Optional[float] = None) -> None:
        # WPQ has no per-client state: client/qos/qos_cost are accepted
        # (one enqueue signature across schedulers) and ignored
        prio = priority if priority is not None else self.PRIORITIES.get(
            op_class, 1)
        item = _Item(sort_key=(next(_seq),), run=run, op_class=op_class,
                     cost=cost, order_key=order_key)
        if prio >= self.STRICT_CUTOFF:
            heapq.heappush(self._strict, item)
        else:
            heapq.heappush(self._queues.setdefault(prio, []), item)
        self._size += 1

    def dequeue(self) -> Optional[_Item]:
        if self._strict:
            self._size -= 1
            return heapq.heappop(self._strict)
        if not self._queues:
            return None
        # weighted-fair: draw a priority with probability ~ priority
        total = sum(p * len(q) for p, q in self._queues.items() if q)
        if total == 0:
            return None
        draw = (next(_seq) * 2654435761) % total
        for p in sorted(self._queues, reverse=True):
            q = self._queues[p]
            if not q:
                continue
            draw -= p * len(q)
            if draw < 0:
                item = heapq.heappop(q)
                if not q:
                    del self._queues[p]
                self._size -= 1
                return item
        raise AssertionError("weighted draw must land in a non-empty queue")

    def __len__(self) -> int:
        return self._size


# the per-class tag state lives in qos.py (shared with the per-client
# registry); the historic name stays importable
_MClockClass = ClientState


class MClockScheduler:
    """dmClock-style tag scheduler (reference mClockScheduler.cc profiles:
    client gets reservation+weight, recovery gets weight-only with a limit,
    best-effort gets leftovers) with per-CLIENT states for CLASS_CLIENT
    ops carrying an entity name (the module docstring's dmClock tag
    discipline)."""

    # historic default (== MCLOCK_PROFILES["balanced"] sans burst);
    # kept as the name tests and the per-client fallback import
    DEFAULT_PROFILE = {
        CLASS_CLIENT: (100.0, 10.0, 0.0),
        CLASS_RECOVERY: (10.0, 3.0, 50.0),
        CLASS_BEST_EFFORT: (1.0, 1.0, 20.0),
    }

    STRICT_CUTOFF = WPQScheduler.STRICT_CUTOFF

    def __init__(self, conf: Optional[dict] = None, perf=None,
                 clock=time.monotonic):
        conf = conf or {}
        self.clock = clock  # injectable for deterministic tag-math tests
        self.perf = perf
        self.classes: Dict[str, _MClockClass] = {}
        # per-class (r, w, l, burst) from the selected osd_mclock_profile
        # (reference osd_mclock_profile), with the historic
        # mclock_<class>_res/wgt/lim conf keys overriding individual
        # values on top (the "custom" escape hatch works on any profile)
        profile = MCLOCK_PROFILES.get(
            str(conf.get("osd_mclock_profile", "balanced") or "balanced"),
            MCLOCK_PROFILES["balanced"])
        for name, (r, w, l, burst) in profile.items():
            r = float(conf.get(f"mclock_{name}_res", r))
            w = float(conf.get(f"mclock_{name}_wgt", w))
            l = float(conf.get(f"mclock_{name}_lim", l))
            burst = float(conf.get(f"mclock_{name}_burst", burst))
            self.classes[name] = _MClockClass(r, w, l, burst=burst)
        # per-client tag states (reference client_profile_id_map),
        # bounded; only CLASS_CLIENT ops with an identity land here
        self.clients = ClientRegistry(
            int(conf.get("osd_mclock_max_clients", 1024) or 1024),
            perf=perf)
        # ops at/above the cutoff bypass tag scheduling entirely (the
        # reference mClockScheduler keeps the same strict high_priority
        # queue, mClockScheduler.h) — both schedulers honor `priority`
        self._strict: List[_Item] = []
        self._size = 0

    def enqueue(self, op_class: str, run, cost: int = 1,
                priority: Optional[int] = None, order_key: Any = None,
                client: str = "", qos: Optional[QosParams] = None,
                qos_cost: Optional[float] = None) -> None:
        if priority is not None and priority >= self.STRICT_CUTOFF:
            self._strict.append(_Item(sort_key=(next(_seq),), run=run,
                                      op_class=op_class, cost=cost,
                                      order_key=order_key))
            self._size += 1
            return
        now = self.clock()
        if op_class == CLASS_CLIENT and client:
            # per-client dmClock state, created/refreshed from the op's
            # resolved pool profile; tags advance by the op's byte-COST
            # (qos.qos_op_cost: 1 + bytes/osd_qos_cost_per_io) so a
            # bandwidth hog issuing few large ops pays its true
            # IOPS-equivalent load instead of escaping its limit
            c = self.clients.get(
                client, qos if qos is not None else QosParams(
                    *self.DEFAULT_PROFILE[CLASS_CLIENT]), now)
            tag_cost = max(1.0, float(qos_cost)) \
                if qos_cost is not None else 1
        else:
            c = self.classes.setdefault(
                op_class, _MClockClass(1.0, 1.0, 0.0))
            tag_cost = max(1, cost)
        # rho/delta burst floor: the L tag of an idle state may lag `now`
        # by up to its burst allowance — banked LIMIT credit worth
        # burst*limit immediately-eligible ops (a background sweep waking
        # under client load is not paced down to one op per 1/limit
        # before it even starts).  R and P clamp to now as in strict
        # dmClock: reservation ordering is relative to ACTIVE competitors
        # — banked R-credit would let a background backlog outrank client
        # reservations at wake-up, the exact inversion the reservation
        # guarantee exists to prevent.
        floor = now - max(0.0, getattr(c, "burst", 0.0))
        c.r_tag = max(c.r_tag + tag_cost / c.reservation, now) \
            if c.reservation else 1e18
        c.p_tag = max(c.p_tag + tag_cost / c.weight, now)
        c.l_tag = max(c.l_tag + tag_cost / c.limit, floor) \
            if c.limit else 0.0
        # sort_key = (R, P, seq, L): the item's OWN tags — phase 1 serves
        # a due head R, phase 2 skips a class whose head L is still in
        # the future (the strict dmClock limit check; the class-level
        # l_tag alone would let a high-weight backlog outrun its limit)
        item = _Item(sort_key=(c.r_tag, c.p_tag, next(_seq), c.l_tag),
                     run=run, op_class=op_class, cost=cost,
                     order_key=order_key)
        c.queue.append(item)
        self._size += 1

    def _states(self):
        yield from self.classes.values()
        yield from self.clients.states.values()

    def dequeue(self) -> Optional[_Item]:
        if self._strict:
            self._size -= 1
            return self._strict.pop(0)
        now = self.clock()
        # phase 1: reservations due
        best_c, best_tag, phase = None, None, "reservation"
        for c in self._states():
            if c.queue and c.reservation:
                head_tag = c.queue[0].sort_key[0]
                if head_tag <= now and (best_tag is None or head_tag < best_tag):
                    best_c, best_tag = c, head_tag
        if best_c is None:
            # phase 2: weight-based among states under their limit
            phase = "weight"
            for c in self._states():
                if not c.queue:
                    continue
                head = c.queue[0]
                if c.limit and (head.sort_key[3] if len(head.sort_key) > 3
                                else c.l_tag) > now:
                    continue  # over limit: the head's L-tag is in the future
                head_p = head.sort_key[1]
                if best_tag is None or head_p < best_tag:
                    best_c, best_tag = c, head_p
        if best_c is None:
            # work-conserving fallback: everything left is over its limit;
            # rather than idle the shard, serve the smallest P-tag (the
            # limit shapes ordering under contention, it never starves the
            # queue — divergence from strict dmClock limit semantics; the
            # HARD cap on a flooder is the admission-side saturation shed)
            phase = "fallback"
            for c in self._states():
                if not c.queue:
                    continue
                head_p = c.queue[0].sort_key[1]
                if best_tag is None or head_p < best_tag:
                    best_c, best_tag = c, head_p
        if best_c is None:
            return None
        self._size -= 1
        if self.perf is not None:
            self.perf.inc(f"served_{phase}")
        return best_c.queue.pop(0)

    def dump(self) -> Dict[str, Any]:
        """Per-class and per-client queue depths + current dmClock tags
        (the asok ``dump_op_queue`` payload for one shard)."""
        now = self.clock()

        def one(c: _MClockClass) -> Dict[str, Any]:
            # tags are absolute clock values; report them as deltas from
            # now (negative = due).  0.0 = never enqueued: unset (None).
            return {"depth": len(c.queue),
                    "reservation": c.reservation, "weight": c.weight,
                    "limit": c.limit, "burst": getattr(c, "burst", 0.0),
                    "r_tag": round(c.r_tag - now, 6)
                    if c.r_tag and c.r_tag < 1e17 else None,
                    "p_tag": round(c.p_tag - now, 6) if c.p_tag else None,
                    "l_tag": round(c.l_tag - now, 6) if c.l_tag else 0.0}

        return {"strict": len(self._strict),
                "classes": {n: one(c) for n, c in self.classes.items()},
                "clients": {n: one(c)
                            for n, c in self.clients.states.items()}}

    def __len__(self) -> int:
        return self._size


def make_scheduler(conf: Optional[dict] = None, perf=None,
                   clock=time.monotonic):
    kind = (conf or {}).get("osd_op_queue", "wpq")
    return MClockScheduler(conf, perf=perf, clock=clock) \
        if kind == "mclock" else WPQScheduler(conf)


class ShardedOpQueue:
    """N shards, each with its own scheduler + drain task (op_shardedwq
    role).  `shard_of(key)` pins a PG to a shard so per-PG order holds."""

    def __init__(self, n_shards: int = 4, conf: Optional[dict] = None,
                 perf=None, max_cost: int = 8192, sched_perf=None):
        self.n_shards = max(1, n_shards)
        self.conf = conf or {}
        self.perf = perf
        # the `osd_scheduler` set (qos.build_scheduler_perf): per-class
        # flow counters + dmClock serving split, shared by all shards
        self.sched_perf = sched_perf
        self._scheds = [make_scheduler(conf, perf=sched_perf)
                        for _ in range(self.n_shards)]
        self._events = [asyncio.Event() for _ in range(self.n_shards)]
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        # bounded queue budget: enqueue blocks when full, so the caller
        # (the messenger serve loop) stops reading and TCP backpressure
        # propagates to the sender — without this, handing ops to the
        # queue would defeat ms_dispatch_throttle_bytes entirely
        from ceph_tpu_torch.common.throttle import Throttle

        self._budget = Throttle("opq-cost", max_cost)
        # per-shard strong refs to spawned op tasks: stop() cancels them,
        # and asyncio's weak task refs cannot GC one mid-flight
        self._inflight: List[set] = [set() for _ in range(self.n_shards)]
        # admitted-but-unfinished ops (queued + running): the saturation
        # signal the QoS shed gates on — depth() alone misses ops whose
        # lifetime is spent RUNNING on per-PG chains rather than queued
        self.inflight_ops = 0

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._drain(i)) for i in range(self.n_shards)
        ]

    async def stop(self) -> None:
        self._stopped = True
        for e in self._events:
            e.set()
        for tasks in self._inflight:
            for t in list(tasks):
                t.cancel()
        for t in self._tasks:
            t.cancel()

    def shard_of(self, key: int) -> int:
        return (key * 2654435761 & 0xFFFFFFFF) % self.n_shards

    async def enqueue(self, pg_key: int, run: Callable[[], Awaitable[None]],
                      op_class: str = CLASS_CLIENT, cost: int = 1,
                      priority: Optional[int] = None, client: str = "",
                      qos: Optional[QosParams] = None,
                      qos_cost: Optional[float] = None,
                      ordered: bool = True) -> None:
        cost = max(1, cost)
        await self._budget.get(cost)  # blocks when queues are full
        self.inflight_ops += 1
        shard = self.shard_of(pg_key)
        # ordered=False: shard by PG but skip the per-key ordering chain
        # (background throttle waiters need scheduling arbitration only;
        # chaining them onto a PG's client tail from inside a sweep that
        # itself waits on the grant could deadlock the sweep)
        self._scheds[shard].enqueue(op_class, run, cost, priority=priority,
                                    order_key=pg_key if ordered else None,
                                    client=client,
                                    qos=qos, qos_cost=qos_cost)
        if self.perf is not None:
            self.perf.inc("op_queued")
        if self.sched_perf is not None:
            self.sched_perf.ensure(f"enqueue_{op_class}")
            self.sched_perf.inc(f"enqueue_{op_class}")
            self.sched_perf.set("queue_depth", self.depth())
            self.sched_perf.set("qos_clients", self.qos_clients())
        self._events[shard].set()

    async def _drain(self, shard: int) -> None:
        """Shard worker: ops with the SAME order_key (PG) run strictly in
        dequeue order (version assignment and log appends rely on it);
        ops for DIFFERENT PGs overlap up to osd_pg_op_concurrency — the
        reference's pipeline overlap (ECBackend.h:557-560 three-queue
        design) at PG granularity, which is what keeps concurrent stripes
        flowing into the device batching queue instead of serializing
        behind one PG's commit round-trips."""
        sched = self._scheds[shard]
        event = self._events[shard]
        width = max(1, int(self.conf.get("osd_pg_op_concurrency", 4) or 1))
        running: Dict[Any, asyncio.Task] = {}  # order_key -> tail task
        slots = asyncio.Semaphore(width)
        inflight = self._inflight[shard]

        async def _run_item(item, after: Optional[asyncio.Task]) -> None:
            # The drain loop acquired our slot BEFORE dequeuing us.
            holds_slot = True
            try:
                if after is not None:
                    # per-key ordering: wait out the predecessor (its
                    # failure is its own; ours still runs).  The slot is
                    # given BACK during this wait — queued successors of
                    # a hot PG must not hold width hostage and starve
                    # other PGs out of the very overlap this design adds.
                    slots.release()
                    holds_slot = False
                    await asyncio.gather(after, return_exceptions=True)
                    await slots.acquire()
                    holds_slot = True
                t0 = time.monotonic()
                try:
                    await item.run()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    import traceback

                    traceback.print_exc()
                if self.perf is not None:
                    self.perf.inc("op_dequeued")
                    self.perf.tinc("op_queue_lat",
                                   time.monotonic() - t0)
            finally:
                if holds_slot:
                    slots.release()
                # budget was taken at enqueue: released on EVERY exit,
                # cancellation included (a leaked token would shrink the
                # queue forever)
                self._budget.put(item.cost)
                self.inflight_ops -= 1

        while not self._stopped:
            # Capacity-gate the dequeue: hold an execution slot BEFORE
            # asking the scheduler for the next op, so the WPQ/mClock
            # policy decides at each free slot among EVERYTHING queued at
            # that moment — a later-arriving high-priority op still beats
            # an earlier low-priority one.  Draining the whole backlog
            # into tasks up front would hand ordering to the FIFO
            # semaphore and bypass QoS entirely under load.
            await slots.acquire()
            item = sched.dequeue()
            if item is None:
                slots.release()
                event.clear()
                await event.wait()
                continue
            if self.sched_perf is not None:
                self.sched_perf.ensure(f"dequeue_{item.op_class}")
                self.sched_perf.inc(f"dequeue_{item.op_class}")
                self.sched_perf.set("queue_depth", self.depth())
            key = item.order_key
            prev = running.get(key)
            # the slot acquired above is transferred to _run_item
            task = asyncio.get_running_loop().create_task(
                _run_item(item, prev))
            inflight.add(task)
            task.add_done_callback(inflight.discard)
            if key is not None:
                running[key] = task
                task.add_done_callback(
                    lambda t, k=key: running.pop(k, None)
                    if running.get(k) is t else None)

    def depth(self) -> int:
        return sum(len(s) for s in self._scheds)

    def qos_clients(self) -> int:
        """Per-client dmClock states alive across shards (0 for WPQ)."""
        return sum(len(s.clients) for s in self._scheds
                   if isinstance(s, MClockScheduler))

    def dump(self) -> Dict[str, Any]:
        """Per-shard scheduler snapshot — the asok ``dump_op_queue``
        payload: per-class/per-client queue depths and current dmClock
        tags (mClock shards) or per-priority depths (WPQ shards)."""
        shards = []
        for i, s in enumerate(self._scheds):
            if isinstance(s, MClockScheduler):
                d = s.dump()
            else:
                d = {"strict": len(s._strict),
                     "priorities": {p: len(q)
                                    for p, q in s._queues.items()}}
            d["shard"] = i
            d["depth"] = len(s)
            shards.append(d)
        return {"scheduler": type(self._scheds[0]).__name__,
                "depth": self.depth(),
                "qos_clients": self.qos_clients(),
                "shards": shards}
