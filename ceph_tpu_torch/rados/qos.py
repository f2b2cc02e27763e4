# Copy of ceph_tpu/rados/qos.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Per-client dmClock QoS: tenant identity, profiles, and enforcement state.

Role-equivalent of the reference's mClock client-profile machinery
(reference src/osd/scheduler/mClockScheduler.{h,cc}: client_profile_id_map
keys a dmclock ClientInfo per client; external_client_infos hold the tag
state) plus the pool-level QoS knobs the mon distributes.  Three layers:

- **Identity**: every MOSDOp v6 carries the sender's entity name
  (``client.<class>.<id>``); :func:`tenant_class` extracts the tenant
  CLASS — the granularity profiles are declared at, so thousands of
  tenants share a handful of declared profiles while each still gets its
  OWN dmClock tag state (per-client isolation inside a class).

- **Profiles**: :func:`pool_qos` resolves a client's
  (reservation, weight, limit) from the pool's osdmap-distributed opts —
  ``qos_reservation`` / ``qos_weight`` / ``qos_limit`` are the pool-wide
  client defaults, ``qos_class:<name>`` = ``"r:w:l"`` overrides one
  tenant class — falling back to OSD config defaults.  The mon validates
  every value at ``pool set`` time (:func:`validate_pool_qos`), so a bad
  profile can never wedge admission cluster-wide.

- **Enforcement state**:

  * :class:`ClientRegistry` manages the per-client ``_MClockClass``
    states INSIDE ``MClockScheduler`` (scheduler.py): lazily created
    with the client's resolved profile, refreshed when the profile
    changes, and bounded — idle states past ``max_clients`` are pruned
    oldest-idle-first so millions of tenants cannot grow a shard's state
    without bound (tag state is worth at most ~1/limit seconds of
    memory; an evicted flooder re-earns its tags within one op).
  * :class:`QosTracker` is the OSD-level ADMISSION tracker feeding the
    saturation-shed decision: it observes every arriving client data op
    (pre-shard, full offered rate — per-shard scheduler states each see
    only ~1/n_shards of a client's traffic, so the shed decision cannot
    live there) and answers "who is the most over-limit client right
    now".  At ``osd_backoff_queue_depth`` saturation the OSD sheds THAT
    client via MOSDBackoff instead of blocking everyone (osd.py
    _op_backoff_reason); with nobody over limit the legacy
    block-the-arrival behavior is preserved.

Tag math (dmClock, after the mClock paper): per client c and op arrival
at time t,

    R_tag = max(R_tag + 1/reservation, t)     (0 reservation => never due)
    P_tag = max(P_tag + 1/weight,      t)
    L_tag = max(L_tag + 1/limit,       t)     (0 limit => unlimited)

Reservation/limit are in ops/sec (IOPS — tags advance by cost 1 per op;
the byte-cost dimension stays with the queue's budget throttle).  A
client whose offered rate exceeds its limit accumulates L_tag ahead of
the clock; ``L_tag - now`` is its *over-limit excess* in seconds — the
shed-ranking key.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder

# pool opts the mon validates and every OSD reads through pool.opts
# (reference pg_pool_t::opts QoS analog): defaults for every client of
# the pool, plus per-tenant-class overrides under "qos_class:<name>"
QOS_POOL_KEYS = ("qos_reservation", "qos_weight", "qos_limit",
                 "qos_burst")
QOS_CLASS_PREFIX = "qos_class:"


@dataclass(frozen=True)
class QosParams:
    """One dmClock profile: reservation (ops/sec guaranteed), weight
    (share of surplus), limit (ops/sec hard cap; 0 = unlimited), burst
    (seconds of rho/delta credit an idle client may bank — see
    module docstring tag math; 0 = strict pacing)."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0
    burst: float = 0.0

    def encode(self) -> str:
        base = f"{self.reservation:g}:{self.weight:g}:{self.limit:g}"
        return base + (f":{self.burst:g}" if self.burst else "")

    def normalized(self, spread: int) -> "QosParams":
        """Cross-OSD profile normalization (the dmClock distributed-
        enforcement correction): a tenant whose primaries span N OSDs
        meets N independent enforcers, so each must grant 1/N of the
        declared rates or the tenant gets N x its nominal profile
        cluster-wide.  Reservation and limit divide by the primary
        spread; weight is a RATIO (per-OSD arbitration between local
        competitors) and burst is a TIME allowance — both stay."""
        spread = max(1, int(spread))
        if spread == 1:
            return self
        return QosParams(reservation=self.reservation / spread,
                         weight=self.weight,
                         limit=self.limit / spread,
                         burst=self.burst)


# the OSD-config fallback when a pool declares nothing (matches the
# scheduler's historic CLASS_CLIENT profile so QoS-less clusters behave
# exactly as before)
DEFAULT_CLIENT_QOS = QosParams(reservation=100.0, weight=10.0, limit=0.0)


def parse_class_profile(value: str) -> QosParams:
    """``"r:w:l"`` or ``"r:w:l:b"`` -> QosParams; raises ValueError on
    anything the mon must refuse (non-numeric, weight <= 0, negative
    rates/burst)."""
    parts = str(value).split(":")
    if len(parts) not in (3, 4):
        raise ValueError(f"qos profile {value!r} is not r:w:l[:b]")
    r, w, l = (float(p) for p in parts[:3])
    b = float(parts[3]) if len(parts) == 4 else 0.0
    if r < 0 or l < 0 or w <= 0 or b < 0:
        raise ValueError(
            f"qos profile {value!r}: need r>=0, w>0, l>=0, b>=0")
    return QosParams(reservation=r, weight=w, limit=l, burst=b)


def primary_spread(osdmap: Any, pool: Any) -> int:
    """How many distinct OSDs serve as primaries across one pool's PGs
    under ``osdmap`` — the cross-OSD normalization divisor.  A tenant's
    ops hash uniformly over the pool's PGs, so its offered load meets
    this many independent per-OSD enforcers."""
    primaries = set()
    for pg in range(pool.pg_num):
        acting = osdmap.pg_to_acting(pool, pg)
        p = osdmap.primary_of(acting, seed=(pool.pool_id << 20) | pg)
        if p is not None:
            primaries.add(p)
    return max(1, len(primaries))


def validate_pool_qos(key: str, value: str) -> bool:
    """Mon-side ``pool set`` validation for the QoS opt family; False
    refuses the set (the mon replies with the unchanged map)."""
    try:
        if key == "qos_weight":
            return float(value) > 0
        if key in ("qos_reservation", "qos_limit", "qos_burst"):
            return float(value) >= 0
        if key.startswith(QOS_CLASS_PREFIX):
            name = key[len(QOS_CLASS_PREFIX):]
            # "|" is the optracker class-ring key separator
            # (cls:<name>|<phase>): a class name carrying it would
            # mislabel the per-class percentile reduction
            if not name or ":" in name or "|" in name:
                return False
            parse_class_profile(value)
            return True
    except (TypeError, ValueError):
        return False
    return False


def qos_op_cost(nbytes: int, conf: Optional[Any] = None) -> float:
    """Byte-COST of one op in dmClock tag units (IOPS-equivalents): a
    B-byte op costs ``1 + B / osd_qos_cost_per_io`` — the base IO plus a
    per-byte increment normalized to the configured bytes-per-IO.  This
    closes the bandwidth-hog hole of pure per-op tagging: a tenant
    issuing few LARGE ops (e.g. 25 x 4MiB/s against a 100 ops/s limit)
    tags as its true IOPS-equivalent load instead of escaping its limit
    (reference mClock cost model: osd_mclock_cost_per_io +
    cost_per_byte, src/osd/scheduler/mClockScheduler.cc
    calc_scaled_cost).  ``osd_qos_cost_per_io = 0`` restores pure
    per-op tagging.

    Writes are costed at ARRIVAL (the payload length is in hand).
    Reads carry no payload at arrival, so the OSD charges the
    admission tracker the byte increment at REPLY time (osd.py read
    path) — the shed ranking sees a read hog's true bandwidth; the
    per-client scheduler tags for reads stay per-op (enqueue time
    cannot know the response size)."""
    conf = conf or {}
    try:
        per_io = float(conf.get("osd_qos_cost_per_io", 65536) or 0)
    except (TypeError, ValueError):
        per_io = 65536.0
    if per_io <= 0 or nbytes <= 0:
        return 1.0
    return 1.0 + nbytes / per_io


def tenant_class(client: str) -> str:
    """Tenant class of an entity name: ``client.<class>.<id>`` -> the
    middle token; two-part names (``client.17``) and anonymous ("") map
    to the default class ''."""
    if not client:
        return ""
    parts = client.split(".")
    return parts[1] if len(parts) >= 3 else ""


def pool_qos(pool: Any, client: str,
             conf: Optional[dict] = None) -> QosParams:
    """Resolve one client's profile from the pool's opts: the tenant
    class's ``qos_class:<name>`` override when declared, else the
    pool-wide ``qos_reservation``/``qos_weight``/``qos_limit`` defaults,
    else the OSD config defaults.  Never raises — the mon validated the
    opts, but a pre-validation store must not wedge admission."""
    conf = conf or {}
    opts = getattr(pool, "opts", None) or {}
    cls = tenant_class(client)
    if cls:
        override = opts.get(QOS_CLASS_PREFIX + cls)
        if override is not None:
            try:
                return parse_class_profile(override)
            except ValueError:
                pass

    def _num(key: str, conf_key: str, default: float) -> float:
        v = opts.get(key)
        if v is None:
            v = conf.get(conf_key, default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default
    return QosParams(
        reservation=_num("qos_reservation", "osd_qos_default_reservation",
                         DEFAULT_CLIENT_QOS.reservation),
        weight=max(1e-9, _num("qos_weight", "osd_qos_default_weight",
                              DEFAULT_CLIENT_QOS.weight)),
        limit=_num("qos_limit", "osd_qos_default_limit",
                   DEFAULT_CLIENT_QOS.limit),
        burst=max(0.0, _num("qos_burst", "osd_qos_burst_allowance",
                            DEFAULT_CLIENT_QOS.burst)),
    )


@dataclass
class ClientState:
    """dmClock tag state + FIFO for one scheduling class — the shape
    scheduler.MClockScheduler arbitrates over (its historic
    ``_MClockClass``), shared by op classes and per-client states."""

    reservation: float  # ops/sec guaranteed
    weight: float  # share when capacity remains
    limit: float  # ops/sec cap (0 = unlimited)
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    # rho/delta burst allowance (seconds): how far behind `now` an idle
    # state's LIMIT tag may fall — banked credit for burst*limit
    # immediately-eligible ops (R/P stay clamped to now: banked
    # reservation credit would invert the reservation guarantee)
    burst: float = 0.0
    queue: List[Any] = field(default_factory=list)
    last_active: float = 0.0

    def apply_params(self, params: QosParams) -> None:
        """Refresh r/w/l/burst in place (a `pool set` mid-stream applies
        to live states; accumulated tags keep their meaning — they are
        absolute times)."""
        if (self.reservation, self.weight, self.limit, self.burst) != (
                params.reservation, params.weight, params.limit,
                params.burst):
            self.reservation = params.reservation
            self.weight = max(1e-9, params.weight)
            self.limit = params.limit
            self.burst = max(0.0, params.burst)


class ClientRegistry:
    """Per-client ClientStates inside one MClockScheduler shard
    (reference client_profile_id_map).  Bounded: when more than
    ``max_clients`` states exist, idle ones (empty queue) are pruned
    oldest-``last_active``-first; states with queued ops are never
    pruned."""

    def __init__(self, max_clients: int = 1024, perf=None):
        self.max_clients = max(1, int(max_clients))
        self.states: Dict[str, ClientState] = {}
        self.perf = perf

    def get(self, client: str, params: QosParams,
            now: float) -> ClientState:
        st = self.states.get(client)
        if st is None:
            if len(self.states) >= self.max_clients:
                self._prune()
            st = self.states[client] = ClientState(
                reservation=params.reservation,
                weight=max(1e-9, params.weight),
                limit=params.limit,
                burst=max(0.0, params.burst))
        else:
            st.apply_params(params)
        st.last_active = now
        return st

    def _prune(self) -> None:
        idle = sorted((c for c, s in self.states.items() if not s.queue),
                      key=lambda c: self.states[c].last_active)
        # drop the oldest-idle half: amortizes the sort over many creates
        for c in idle[:max(1, len(idle) // 2)]:
            del self.states[c]
            if self.perf is not None:
                self.perf.inc("qos_evicted")

    def __len__(self) -> int:
        return len(self.states)


class QosTracker:
    """OSD-level admission tracker: per-client L-tags over the FULL
    offered rate, feeding the saturation-shed decision (who is the most
    over-limit client).  Thread-light (asyncio single-loop callers);
    bounded like the registry."""

    def __init__(self, max_clients: int = 4096,
                 clock=time.monotonic, perf=None,
                 arrears_cap: float = 2.0):
        self.max_clients = max(1, int(max_clients))
        self.clock = clock
        self.perf = perf
        # ceiling on accumulated over-limit arrears (seconds the L-tag
        # may run ahead of the clock): arrivals are observed even while
        # being shed — the OFFERED rate is the shed-ranking signal — so
        # without the cap a sustained flood would bank minutes of
        # arrears and keep an ex-flooder shed long after it quieted
        self.arrears_cap = max(0.0, float(arrears_cap))
        # client -> [l_tag, limit, last_active]
        self._state: Dict[str, List[float]] = {}
        # max-L-tag candidate: all L-tags live on the same clock axis,
        # so the largest L-tag IS the most over-limit client — observe()
        # maintains it incrementally and should_shed() answers in O(1)
        # (the shed gate runs per arriving op exactly while the OSD is
        # saturated, the worst moment for an O(clients) scan); a stale
        # candidate (pruned / gone unlimited) falls back to one scan
        self._worst: Optional[str] = None

    def observe(self, client: str, params: QosParams,
                cost: float = 1.0) -> None:
        """One arriving op from ``client`` under ``params``; advances
        its limit tag (no-op for unlimited clients beyond liveness
        bookkeeping)."""
        if not client:
            return
        now = self.clock()
        st = self._state.get(client)
        if st is None:
            if len(self._state) >= self.max_clients:
                self._prune(now)
            # a fresh (or long-idle, pruned) client opens with its full
            # burst credit banked — the same floor the update applies
            st = self._state[client] = [
                now - max(0.0, params.burst), params.limit, now]
        st[2] = now
        if params.limit > 0:
            st[1] = params.limit
            # the rho/delta burst floor: an idle client's L-tag may lag
            # `now` by up to burst seconds (banked credit for
            # burst*limit immediate ops) instead of clamping to now
            st[0] = min(max(st[0] + cost / params.limit,
                            now - max(0.0, params.burst)),
                        now + self.arrears_cap)
            w = self._state.get(self._worst) if self._worst else None
            if w is None or w[1] <= 0 or st[0] >= w[0]:
                self._worst = client
        # an op resolved through an UNLIMITED pool must not launder the
        # client's arrears (state is per client, params are per pool: a
        # flooder with access to any limit-free pool would reset its
        # L-tag with one op and dodge the QoS-directed shed forever) —
        # the limit and tag stand; arrears decay on their own, bounded
        # by arrears_cap, if the client was genuinely reconfigured

    def _prune(self, now: float) -> None:
        # evict the least-recently-active half; an evicted flooder
        # rebuilds its excess within ~limit ops, so eviction cannot be
        # used to launder a sustained overload
        victims = sorted(self._state, key=lambda c: self._state[c][2])
        for c in victims[:max(1, len(victims) // 2)]:
            del self._state[c]

    def excess(self, client: str) -> float:
        """Seconds of accumulated over-limit arrears for one client
        (<= 0: within limit)."""
        st = self._state.get(client)
        if st is None or st[1] <= 0:
            return 0.0
        return st[0] - self.clock()

    def worst_over_limit(self, grace: float = 0.0) -> Tuple[Optional[str], float]:
        """(client, excess) of the most over-limit client with excess >
        grace, or (None, 0.0) when every client is within its limit.
        O(1) via the max-L-tag candidate; falls back to one scan when
        the candidate went stale (pruned or no longer limited)."""
        now = self.clock()
        w = self._state.get(self._worst) if self._worst else None
        if w is not None and w[1] > 0:
            e = w[0] - now
            # the candidate holds the MAX L-tag: within limit => all are
            return (self._worst, e) if e > grace else (None, 0.0)
        # candidate stale (pruned): one rebuild scan.  The new candidate
        # is the max-L-tag client REGARDLESS of grace — storing None for
        # a within-grace max would re-scan on every saturated arrival,
        # exactly the hot path the candidate exists to protect.
        self._worst = None
        worst, worst_tag = None, 0.0
        for c, st in self._state.items():
            if st[1] <= 0:
                continue
            if worst is None or st[0] > worst_tag:
                worst, worst_tag = c, st[0]
        self._worst = worst
        if worst is not None and worst_tag - now > grace:
            return worst, worst_tag - now
        return None, 0.0

    def should_shed(self, client: str,
                    grace: float = 0.25) -> Tuple[bool, bool]:
        """Saturation-shed decision for one arriving op: (shed,
        qos_directed).  qos_directed=True when an over-limit client
        exists — then only ops of over-limit clients are shed (the
        reserved tenant sails through); False falls back to the legacy
        shed-the-arrival behavior (no identities / nobody over limit)."""
        worst, _ = self.worst_over_limit(grace)
        if worst is None:
            return True, False
        return self.excess(client) > grace, True

    def dump(self) -> Dict[str, Dict[str, float]]:
        now = self.clock()
        return {c: {"limit": st[1],
                    "excess_s": round(st[0] - now, 6) if st[1] > 0 else 0.0,
                    "idle_s": round(now - st[2], 3)}
                for c, st in self._state.items()}

    def __len__(self) -> int:
        return len(self._state)


def build_scheduler_perf() -> PerfCounters:
    """The ``osd_scheduler`` counter set — per-class queue flow and the
    dmClock serving split, registered with the OSD collection (rides
    perf dump -> mgr /metrics -> the BENCH record).  Schema:

      enqueue_<class> / dequeue_<class>  u64   ops through the sharded
                                               queue per op class
      queue_depth                        u64   ops queued now (gauge)
      qos_clients                        u64   per-client dmClock states
                                               alive across shards (gauge)
      served_reservation                 u64   dequeues granted by a due
                                               R-tag (guaranteed IOPS)
      served_weight                      u64   dequeues granted by P-tag
                                               order (surplus sharing)
      served_fallback                    u64   work-conserving dequeues
                                               (everything over limit)
      qos_shed                           u64   saturation sheds aimed at
                                               the most over-limit client
      qos_evicted                        u64   idle per-client states
                                               pruned by the bound
    """
    b = PerfCountersBuilder("osd_scheduler")
    for cls in ("client", "recovery", "rebalance", "scrub", "best_effort"):
        b.add_u64_counter(f"enqueue_{cls}", f"{cls} ops enqueued")
        b.add_u64_counter(f"dequeue_{cls}", f"{cls} ops dequeued")
    b.add_u64("queue_depth", "ops queued across shards (gauge)")
    b.add_u64("qos_clients", "per-client dmClock states alive (gauge)")
    b.add_u64_counter("served_reservation",
                      "dequeues granted by a due reservation tag")
    b.add_u64_counter("served_weight",
                      "dequeues granted by weighted sharing")
    b.add_u64_counter("served_fallback",
                      "work-conserving dequeues (all classes over limit)")
    b.add_u64_counter("qos_shed",
                      "saturation sheds aimed at the most over-limit "
                      "client (MOSDBackoff)")
    b.add_u64_counter("qos_evicted", "idle per-client states pruned")
    return b.create_perf_counters()
