# Copy of ceph_tpu/rados/mon.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.  Pool profiles are checked
# with codecs built on the CPU; stored state unpickles through
# rados/unpickle.py.
"""Monitor: cluster-map authority (maps only — never on the data path).

Role-equivalent of the reference's mon (reference src/mon/Monitor.h:108):
a quorum of monitors replicates all cluster state — the OSDMap, the
centralized config database, id allocators — through a single Paxos log
(src/mon/Paxos.h:174; our ceph_tpu.rados.paxos).  The leader (lowest rank
winning a rank-based election, src/mon/Elector.cc) drives all mutations;
peons forward client writes to the leader (reference MForward) and serve
map reads locally under a lease the leader renews (Paxos::lease_*).  Losing
quorum blocks writes; elections re-run when the leader's lease lapses.

OSDMonitor duties live here too: OSD id allocation at boot, liveness from
pings with mark-down/out of laggards (failure detection, SURVEY.md §5.3),
and pool/EC-profile lifecycle — profiles are validated by instantiating the
codec through the plugin registry exactly like OSDMonitor::normalize_profile
(OSDMonitor.cc:7329), stripe_width computed from the codec's own chunk-size
rule (prepare_pool_stripe_width, OSDMonitor.cc:7628).  The ConfigMonitor
(src/mon/ConfigMonitor.cc) replicates `config set` keys and distributes
them to daemons at boot (daemons install them as their "mon" config layer).

Each mon persists committed state in a MonitorDBStore; a restarted mon
recovers its state from disk and syncs forward via the collect phase.
"""

from __future__ import annotations

import asyncio
import errno
import pickle
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import registry
from ceph_tpu_torch.rados import unpickle
from ceph_tpu_torch.rados.auth import KeyServer
from ceph_tpu_torch.rados.clog import (
    CLOG_ERROR,
    CLOG_INFO,
    CLOG_WARN,
    LogMonitor,
    decode_entries,
    describe_command,
    encode_entries,
)
from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE, CrushMap
from ceph_tpu_torch.rados.messenger import TRANSPORT_ERRORS, Messenger
from ceph_tpu_torch.rados.paxos import ElectionLogic, MonitorDBStore, Paxos
from ceph_tpu_torch.rados.types import (
    MCommand,
    MCommandReply,
    MCrashQuery,
    MCrashQueryReply,
    MCrashReport,
    MCrashReportAck,
    MLog,
    MLogAck,
    MLogReply,
    MLogSubscribe,
    MAuthRotating,
    MAuthRotatingReply,
    MAuthTicket,
    MAuthTicketReply,
    MBootReply,
    MConfigGet,
    MConfigReply,
    MConfigSet,
    MCreatePool,
    MCreatePoolReply,
    MCrushOp,
    MCrushOpReply,
    MDeletePool,
    MForward,
    MForwardReply,
    MGetHealth,
    MGetMap,
    MHealthMute,
    MHealthReply,
    MMapReply,
    MMarkDown,
    MMonElection,
    MMonPaxos,
    MOSDFailure,
    MOSDPGTemp,
    MOsdBoot,
    MOsdMembership,
    MOsdPredicate,
    MOsdPredicateReply,
    MOSDSetFlag,
    MPoolSet,
    MSetFullRatio,
    MSetUpmap,
    MSnapOp,
    MSnapOpReply,
    MPing,
    FULL_SEVERITY,
    OSDMap,
    OSDMapIncremental,
    OsdInfo,
    PoolInfo,
    osd_crush_weight,
)

DEFAULT_STRIPE_UNIT = 4096  # reference osd_pool_erasure_code_stripe_unit


class NoQuorum(Exception):
    pass


class Monitor:
    def __init__(self, conf: Optional[dict] = None, rank: int = 0,
                 monmap: Optional[List[Tuple[str, int]]] = None,
                 data_path: Optional[str] = None):
        self.conf = conf or {}
        self.rank = rank
        self.monmap = [tuple(a) for a in monmap] if monmap else None
        self.messenger = Messenger(f"mon.{rank}", self.conf, entity_type="mon")
        self.store = MonitorDBStore(data_path)
        n = len(self.monmap) if self.monmap else 1
        self.logic = ElectionLogic(rank, n)
        self.paxos = Paxos(self.store, rank, self._paxos_send)
        self.paxos.on_commit = self._apply_committed
        # replicated state machine; fullness thresholds seed from conf
        # (reference mon_osd_*_ratio defaults baked into new OSDMaps;
        # `ceph osd set-*full-ratio` moves them live)
        self.osdmap = OSDMap(
            epoch=1, crush=CrushMap.flat([]),
            nearfull_ratio=float(
                self.conf.get("mon_osd_nearfull_ratio", 0.85) or 0.85),
            backfillfull_ratio=float(
                self.conf.get("mon_osd_backfillfull_ratio", 0.90) or 0.90),
            full_ratio=float(
                self.conf.get("mon_osd_full_ratio", 0.95) or 0.95))
        # per-OSD statfs from the latest liveness ping (leader-only, like
        # _health_reports — pings forward to the leader): the raw
        # utilization `ceph osd df` / mgr metrics render, and the input
        # the fullness-state derivation runs on.  NOT in the osdmap:
        # utilization moves every ping, states move rarely — only state
        # TRANSITIONS bump the map epoch.
        self._osd_statfs: Dict[int, Dict] = {}
        self.cluster_conf: Dict[str, str] = {}
        self._next_osd_id = 0
        self._next_pool_id = 1
        self._inc_ring: Dict[int, OSDMapIncremental] = {}
        self._published: Optional[OSDMap] = None
        # cephx-lite key server: rotating service secrets + ticket issue
        # (reference AuthMonitor/CephxKeyServer); state rides the paxos
        # snapshot so the quorum shares one ring.  MUST exist before the
        # state recovery below (it restores the replicated ring).
        self.keyserver = KeyServer(
            ttl=float(self.conf.get("auth_ticket_ttl", 3600.0) or 3600.0))
        # the mon's own acceptor validates tickets against the SAME ring
        # (OSDs attach their tickets when dialing the mon); .keys shares
        # the dict so rotation is visible without re-plumbing
        from ceph_tpu_torch.rados.auth import TicketKeyring
        kr = TicketKeyring()
        kr.keys = self.keyserver.secrets
        self.messenger.keyring = kr
        # HealthMonitor state (reference src/mon/HealthMonitor.cc): the
        # per-OSD health reports pushed on liveness pings (only the
        # LEADER holds them — peons forward pings there) and the mute
        # lifecycle: check name -> monotonic expiry (inf = until
        # unmuted).  Mutes are paxos-replicated (rebased remaining-ttl
        # in the snapshot) so a leader change keeps them; declared
        # BEFORE the state recovery below, which may restore them.
        self._health_reports: Dict[int, Dict] = {}  # osd -> {checks, stamp}
        self._health_mutes: Dict[str, float] = {}
        # OSDs an ADMIN marked out (`ceph osd out`): sticky across the
        # OSD's reboots — a booting/rejoining daemon is auto-marked in
        # only when not admin-out (reference noin semantics for the one
        # OSD).  Paxos-replicated (rides the snapshot below) so a
        # leader change cannot silently pull a draining OSD back in.
        self._admin_out: Set[int] = set()
        # per-daemon observability bundle (CephContext role): local log
        # (messenger/paxos douts ride it), admin socket, config proxy —
        # the mon is a daemon like any other now
        self.ctx = Context(f"mon.{rank}",
                           conf if isinstance(conf, dict) else None)
        self.messenger.log = self.ctx.log
        # membership-lifecycle observability (rides perf dump -> the
        # mon's MMgrReport push -> mgr /metrics -> BENCH record)
        self.perf = self.ctx.perf.add(
            PerfCountersBuilder("mon")
            .add_u64_counter("auto_outs",
                             "down OSDs auto-marked out after "
                             "mon_osd_down_out_interval")
            .add_u64_counter("crush_moves",
                             "crush topology mutations applied "
                             "(add-bucket/add/set/move/rm)")
            .add_u64_counter("predicate_queries",
                             "safe-to-destroy / ok-to-stop reads served")
            .add_u64_counter("predicate_refusals",
                             "predicate reads answered unsafe")
            .create_perf_counters())
        # cluster log + crash registry (reference LogMonitor + mgr/crash):
        # state rides the paxos snapshot below, so it MUST exist before
        # the state recovery; watchers (`ceph -w` sessions) are
        # per-monitor runtime state and stream from _apply_committed
        self.logm = LogMonitor(self.conf, local_log=self.ctx.log,
                               name=f"mon.{rank}")
        self._log_watchers: Dict[int, Dict] = {}  # id(conn) -> sub state
        # (epoch, checks) memo for the per-PG degradation sweep — a pure
        # function of the map, recomputed only when the epoch moves (the
        # mgr polls health at ~1 Hz)
        self._pg_health_memo: Tuple[int, Dict[str, Dict]] = (-1, {})
        # recover committed state from a previous life
        _, latest = self.store.latest()
        if latest is not None:
            self._apply_committed(self.store.last_committed, latest)
        # runtime
        self._last_ping: Dict[int, float] = {}
        self._grace = self.conf.get("mon_osd_report_grace", 1.5)
        self._lease = float(self.conf.get("mon_lease", 5.0))
        self._election_timeout = float(self.conf.get("mon_election_timeout", 0.5))
        self._last_lease_renew = 0.0
        self._tick_task: Optional[asyncio.Task] = None
        self._election_task: Optional[asyncio.Task] = None
        self.addr: Optional[Tuple[str, int]] = None
        self._commit_lock = asyncio.Lock()
        self._accept_event: Optional[asyncio.Event] = None
        self._pending_forwards: Dict[str, Any] = {}  # tid -> (conn, stamp)
        # recently-executed write tids -> reply: suppresses re-execution of
        # messenger-replayed/forward-retried writes (PG-reqid-dedupe role)
        self._applied_tids: "Dict[str, Any]" = {}
        # target_osd -> {reporter: stamp} (OSD failure reports)
        self._failure_reports: Dict[int, Dict[int, float]] = {}
        # osd -> monotonic stamp it went down (the auto-out countdown).
        # Leader-runtime like _last_ping: a leader change restarts the
        # countdown — hysteresis, never premature outs.
        self._down_since: Dict[int, float] = {}
        # osd -> latest unflushed-dirt roster from MPing v5
        # [("pool:oid", [holders]), ...].  EVERY mon records it (peons
        # snoop the pings they forward), so the safe-to-destroy read
        # serves at any mon without a leader round-trip.
        self._osd_dirty: Dict[int, List] = {}
        self._mgr_ticks = 0
        self._last_rotation = time.monotonic()
        # peer rank -> reachability EMA (ConnectionTracker role)
        self._conn_scores: Dict[int, float] = {}
        # strong refs to in-flight forward tasks (asyncio holds tasks
        # weakly; a GC'd task would silently drop a client write)
        self._forward_tasks: Set[asyncio.Task] = set()
        self._stopped = False

    # -- replicated state (de)serialization ----------------------------------

    def _snapshot_state(self) -> bytes:
        # mutes replicate as REMAINING seconds (None = until unmuted):
        # monotonic clocks don't transfer across processes, so the
        # receiver rebases onto its own clock (the HitSetArchive.decode
        # discipline) — a leader change must not silently drop an
        # operator's mutes
        now = time.monotonic()
        mutes = {name: (None if expiry == float("inf")
                        else max(0.0, expiry - now))
                 for name, expiry in self._health_mutes.items()}
        return pickle.dumps(
            {
                "osdmap": self.osdmap,
                "cluster_conf": self.cluster_conf,
                "next_osd_id": self._next_osd_id,
                "next_pool_id": self._next_pool_id,
                "auth_keys": (self.keyserver.current_id,
                              self.keyserver.export_keys()),
                "health_mutes": mutes,
                "admin_out": sorted(self._admin_out),
                "clog": self.logm.snapshot(),
            },
            protocol=5,
        )

    def _apply_committed(self, version: int, value: bytes) -> None:
        state = unpickle.loads(value)
        new_map = state["osdmap"]
        if new_map.epoch >= self.osdmap.epoch:
            self.osdmap = new_map
        self.cluster_conf = state["cluster_conf"]
        self._next_osd_id = max(self._next_osd_id, state["next_osd_id"])
        self._next_pool_id = max(self._next_pool_id, state["next_pool_id"])
        admin_out = state.get("admin_out")
        if admin_out is not None:
            self._admin_out = set(admin_out)
        mutes = state.get("health_mutes")
        if mutes is not None:
            now = time.monotonic()
            self._health_mutes = {
                name: (float("inf") if rem is None else now + rem)
                for name, rem in mutes.items()}
        clog = state.get("clog")
        if clog is not None:
            self.logm.load(clog)
            self._stream_committed_log()
        auth = state.get("auth_keys")
        if auth and auth[0] >= self.keyserver.current_id:
            # adopt the quorum's rotating secrets: every mon must seal and
            # open tickets with the SAME ring (reference CephxKeyServer is
            # paxos-replicated state)
            self.keyserver.current_id = auth[0]
            self.keyserver.secrets.clear()
            self.keyserver.secrets.update(
                {int(k): bytes.fromhex(v) for k, v in auth[1].items()})
        # publish an incremental for subscribers lagging a few epochs
        # (reference: mon hands out OSDMap::Incremental ranges, full map
        # only when the gap exceeds what it kept)
        prev = self._published
        cur = self.osdmap
        if prev is not None and cur.epoch > prev.epoch:
            inc = OSDMapIncremental.diff(prev, cur)
            self._inc_ring[inc.base_epoch] = inc  # keyed for O(1) chaining
            while len(self._inc_ring) > 64:
                self._inc_ring.pop(min(self._inc_ring))
        if prev is None or cur.epoch > prev.epoch:
            # `value` is already a pickled copy of this state: one loads
            # gives an independent snapshot at half the dumps+loads cost
            self._published = unpickle.loads(value)["osdmap"]

    def _map_reply_for(self, since_epoch: int, tid: str = "") -> MMapReply:
        """Incremental chain when we still hold every delta past
        since_epoch; full map otherwise."""
        cur = self.osdmap
        if 0 < since_epoch < cur.epoch:
            chain: List[OSDMapIncremental] = []
            e = since_epoch
            while e < cur.epoch:
                nxt = self._inc_ring.get(e)
                if nxt is None:
                    chain = []
                    break
                chain.append(nxt)
                e = nxt.epoch
            if chain:
                return MMapReply(incrementals=chain, tid=tid)
        return MMapReply(osdmap=cur, tid=tid)

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self.messenger.dispatcher = self._dispatch
        if self.monmap:
            host, port = self.monmap[self.rank]
        self.addr = await self.messenger.bind(host, port)
        if self.monmap is None:
            self.monmap = [self.addr]
        if len(self.monmap) == 1:
            # single mon: trivially leader of a one-man quorum
            self.logic.start()
            self.logic.acked_by = {self.rank}
            self.logic.declare_victory()
        else:
            self._election_task = asyncio.get_running_loop().create_task(
                self._run_election()
            )
        self._tick_task = asyncio.get_running_loop().create_task(self._tick())
        # admin socket (asok `log flush`/`log dump_recent`/`config set`
        # work on the mon like on every daemon); in-process execute()
        # works without the unix socket
        self.ctx.asok.register(
            "quorum_status", lambda a: self.quorum_status(),
            "election epoch, quorum, leader")
        self.ctx.asok.register(
            "log last",
            lambda a: [e.render() for e in self.logm.tail(
                int(a.get("n", 0) or 0))],
            "tail of the cluster log")
        asok_dir = self.conf.get("admin_socket_dir")
        if asok_dir:
            await self.ctx.asok.start(f"{asok_dir}/mon.{self.rank}.asok")
        return self.addr

    async def stop(self) -> None:
        self._stopped = True
        for t in (self._tick_task, self._election_task):
            if t:
                t.cancel()
        await self.ctx.shutdown()
        await self.messenger.shutdown()

    @property
    def is_leader(self) -> bool:
        return self.logic.is_leader

    @property
    def leader_addr(self) -> Optional[Tuple[str, int]]:
        if self.logic.leader is None:
            return None
        return self.monmap[self.logic.leader]

    def quorum_status(self) -> Dict[str, Any]:
        return {
            "rank": self.rank,
            "election_epoch": self.logic.epoch,
            "leader": self.logic.leader,
            "quorum": sorted(self.logic.quorum),
            "is_leader": self.is_leader,
            "map_epoch": self.osdmap.epoch,
            "paxos_version": self.store.last_committed,
        }

    # -- cluster-log streaming (`ceph -w` sessions) --------------------------

    def _stream_committed_log(self) -> None:
        """Push newly committed cluster-log entries to subscribed
        sessions.  Runs on EVERY mon from _apply_committed (the paxos
        snapshot carries the tail), so a watcher subscribed at a peon
        streams within one commit window of the leader taking the
        entry."""
        if not self._log_watchers:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # boot-time state recovery: no loop, no watchers yet
        for key, w in list(self._log_watchers.items()):
            ents = self.logm.since(w["idx"], level=w["level"] or None,
                                   channel=w["channel"])
            if not ents:
                # keep the cursor moving past filtered-out entries
                w["idx"] = max(w["idx"], self.logm.last_idx)
                continue
            w["idx"] = max(e.idx for e in ents)
            t = loop.create_task(self._send_log_stream(key, w, ents))
            self._forward_tasks.add(t)
            t.add_done_callback(self._forward_tasks.discard)

    async def _send_log_stream(self, key, w, ents) -> None:
        try:
            await w["conn"].send(
                MLog(who=f"mon.{self.rank}", entries=encode_entries(ents)))
        except (ConnectionError, OSError):
            self._log_watchers.pop(key, None)  # watcher went away

    def _crash_query_read(self, msg: MCrashQuery) -> MCrashQueryReply:
        """The read half of `ceph crash` (ls/info), servable at any mon."""
        if msg.op == "ls":
            return MCrashQueryReply(tid=msg.tid,
                                    crashes=self.logm.crash_ls())
        info = self.logm.crash_info(msg.crash_id)
        if info is None:
            return MCrashQueryReply(tid=msg.tid, ok=False,
                                    error=f"no crash {msg.crash_id!r}")
        return MCrashQueryReply(tid=msg.tid, crashes=[info])

    def _handle_log_subscribe(self, conn, msg: MLogSubscribe) -> MLogReply:
        tail = self.logm.tail(msg.last_n or 0,
                              level=msg.level or None,
                              channel=msg.channel)
        if msg.sub:
            self._log_watchers[id(conn)] = {
                "conn": conn, "channel": msg.channel,
                "level": msg.level, "idx": self.logm.last_idx}
            while len(self._log_watchers) > 64:
                self._log_watchers.pop(next(iter(self._log_watchers)))
        return MLogReply(tid=msg.tid, entries=encode_entries(tail))

    # -- health (HealthMonitor role, reference src/mon/HealthMonitor.cc) ----

    def _map_health_checks(self) -> Dict[str, Dict]:
        """Checks derivable from the map alone (the half tools/ceph.py
        used to fake client-side): OSD_DOWN/OSD_OUT, OSDMAP_FLAGS, and
        per-PG degradation computed exactly as the data path places."""
        m = self.osdmap
        checks: Dict[str, Dict] = {}
        down = sorted(o.osd_id for o in m.osds.values() if not o.up)
        if down:
            checks["OSD_DOWN"] = {
                "severity": "warning",
                "summary": f"{len(down)} osds down: {down}",
                "osds": down}
        out = sorted(o.osd_id for o in m.osds.values() if not o.in_cluster)
        if out:
            checks["OSD_OUT"] = {
                "severity": "warning",
                "summary": f"{len(out)} osds out: {out}",
                "osds": out}
        flags = sorted(getattr(m, "flags", []) or [])
        if flags:
            checks["OSDMAP_FLAGS"] = {
                "severity": "warning",
                "summary": f"flags set: {','.join(flags)}",
                "flags": flags}
        # fullness ladder (reference OSD_NEARFULL/OSD_BACKFILLFULL/
        # OSD_FULL health checks off the OSDMap full sets)
        by_state: Dict[str, List[int]] = {}
        for osd_id, st in sorted((getattr(m, "full_osds", None)
                                  or {}).items()):
            by_state.setdefault(st, []).append(osd_id)
        nf, bf, fl = m.fullness_ratios()
        for st, check, thr, sev in (
                ("nearfull", "OSD_NEARFULL", nf, "warning"),
                ("backfillfull", "OSD_BACKFILLFULL", bf, "warning"),
                ("full", "OSD_FULL", fl, "error")):
            ids = by_state.get(st)
            if ids:
                checks[check] = {
                    "severity": sev,
                    "summary": f"{len(ids)} {st} osd(s): {ids}",
                    "osds": ids,
                    "detail": [f"osd.{i} has crossed the {st} "
                               f"threshold ({thr:g})" for i in ids]}
        checks.update(self._pg_health_checks())
        return checks

    def _pg_health_checks(self) -> Dict[str, Dict]:
        """The per-PG degradation sweep, memoized per osdmap epoch: a
        pure function of the map, and the mgr polls health at ~1 Hz —
        O(total_pgs) CRUSH work must not recur on an unchanged map."""
        m = self.osdmap
        if self._pg_health_memo[0] == m.epoch:
            # shallow-copy the entries: callers annotate them (mute
            # expiry, detail stripping) and must not mutate the memo
            return {k: dict(v) for k, v in self._pg_health_memo[1].items()}
        degraded: List[str] = []
        incomplete: List[str] = []
        # a pool is FULL when the cluster-wide "full" flag gates it, or
        # when ANY of its PGs' acting sets contains a FULL OSD — writes
        # to that pool fail typed ENOSPC (reference POOL_FULL off the
        # pool full flag); computed in the SAME sweep, same epoch memo
        flag_full = "full" in (getattr(m, "flags", []) or [])
        full_osds = {o for o, s in (getattr(m, "full_osds", None)
                                    or {}).items() if s == "full"}
        full_pools: List[str] = []
        for pool in m.pools.values():
            pool_full = flag_full
            for pg in range(pool.pg_num):
                acting = m.pg_to_acting(pool, pg)
                live = [a for a in acting if a != CRUSH_ITEM_NONE]
                if not pool_full and full_osds \
                        and any(a in full_osds for a in live):
                    pool_full = True
                if len(live) == len(acting):
                    continue
                pgid = f"{pool.pool_id}.{pg:x}"
                if len(live) >= pool.min_size:
                    degraded.append(pgid)
                else:
                    incomplete.append(pgid)
            if pool_full:
                full_pools.append(pool.name)
        checks: Dict[str, Dict] = {}
        if full_pools:
            checks["POOL_FULL"] = {
                "severity": "error",
                "summary": f"{len(full_pools)} pool(s) full: "
                           f"{sorted(full_pools)}",
                "pools": sorted(full_pools),
                "detail": [f"pool '{p}' is full (writes fail ENOSPC; "
                           f"deletes still served)"
                           for p in sorted(full_pools)]}
        if degraded:
            checks["PG_DEGRADED"] = {
                "severity": "warning",
                "summary": f"{len(degraded)} pgs degraded",
                "pgs": degraded[:32]}
        if incomplete:
            checks["PG_INCOMPLETE"] = {
                "severity": "error",
                "summary": f"{len(incomplete)} pgs below min_size "
                           f"(unserviceable)",
                "pgs": incomplete[:32]}
        self._pg_health_memo = (m.epoch, checks)
        return {k: dict(v) for k, v in checks.items()}

    def _daemon_health_checks(self) -> Dict[str, Dict]:
        """Aggregate the OSD-pushed reports: same-named checks merge
        (counts sum, oldest age wins, per-daemon detail concatenates).
        Reports from daemons the map says are down — or stale past a few
        grace periods — are dropped, so a dead OSD cannot wedge a check
        raised forever."""
        now = time.monotonic()
        cutoff = now - max(3.0 * self._grace, 5.0)
        merged: Dict[str, Dict] = {}
        for osd_id, rec in list(self._health_reports.items()):
            info = self.osdmap.osds.get(osd_id)
            if rec["stamp"] < cutoff or info is None or not info.up:
                self._health_reports.pop(osd_id, None)
                continue
            for name, check in rec["checks"].items():
                agg = merged.get(name)
                if agg is None:
                    agg = merged[name] = {
                        "severity": check.get("severity", "warning"),
                        "count": 0, "oldest_age": 0.0,
                        "daemons": [], "detail": []}
                agg["count"] += int(check.get("count", 1) or 1)
                agg["oldest_age"] = max(agg["oldest_age"],
                                        float(check.get("oldest_age", 0.0)
                                              or 0.0))
                agg["daemons"].append(f"osd.{osd_id}")
                if check.get("severity") == "error":
                    agg["severity"] = "error"
                for line in (check.get("detail") or [])[:8]:
                    agg["detail"].append(f"osd.{osd_id}: {line}")
                if not check.get("detail"):
                    agg["detail"].append(
                        f"osd.{osd_id}: {check.get('summary', name)}")
        for name, agg in merged.items():
            if name == "SLOW_OPS":
                agg["summary"] = (
                    f"{agg['count']} slow ops, oldest one blocked for "
                    f"{agg['oldest_age']:.1f} sec, "
                    f"daemons {sorted(set(agg['daemons']))} have slow ops")
            else:
                agg["summary"] = (f"{name} on "
                                  f"{sorted(set(agg['daemons']))}")
        return merged

    def health_summary(self, detail: bool = False) -> Dict:
        """The aggregated health document `ceph -s` / `ceph health
        detail` render: map-derived + daemon-reported checks, with the
        mute lifecycle applied (muted checks are listed separately and
        do not degrade the status)."""
        now = time.monotonic()
        for name, expiry in list(self._health_mutes.items()):
            if expiry != float("inf") and now >= expiry:
                del self._health_mutes[name]
        checks = self._map_health_checks()
        checks.update(self._daemon_health_checks())
        # RECENT_CRASH (crash registry): unarchived crashes keep warning
        # until `ceph crash archive` acknowledges them
        checks.update(self.logm.health_checks())
        if not detail:
            for c in checks.values():
                c.pop("detail", None)
        muted = {}
        for name in list(checks):
            if name in self._health_mutes:
                expiry = self._health_mutes[name]
                entry = checks.pop(name)
                entry["expires_in"] = (round(expiry - now, 1)
                                       if expiry != float("inf") else 0.0)
                muted[name] = entry
        if any(c.get("severity") == "error" for c in checks.values()):
            status = "HEALTH_ERR"
        elif checks:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_OK"
        return {"status": status, "checks": checks, "muted": muted,
                "mutes": sorted(self._health_mutes),
                # per-OSD utilization + fullness (the `ceph osd df` /
                # mgr-metrics aggregated view: one query, not N statfs)
                "osd_utilization": self._osd_utilization()}

    def _handle_health_mute(self, msg: MHealthMute) -> MHealthReply:
        if msg.unmute:
            self._health_mutes.pop(msg.check, None)
        elif msg.check:
            self._health_mutes[msg.check] = (
                time.monotonic() + msg.ttl if msg.ttl > 0 else float("inf"))
        return MHealthReply(tid=msg.tid, health=self.health_summary())

    # -- data-safety predicates (reference OSDMonitor ok-to-stop /
    # safe-to-destroy, OSDMonitor.cc) ---------------------------------------

    def _predicate_reply(self, msg: MOsdPredicate) -> MOsdPredicateReply:
        self.perf.inc("predicate_queries")
        if msg.op not in ("safe-to-destroy", "ok-to-stop"):
            self.perf.inc("predicate_refusals")
            return MOsdPredicateReply(
                tid=msg.tid, op=msg.op, safe=False,
                reasons=[f"EINVAL: unknown predicate {msg.op!r}"])
        if not msg.osd_ids:
            self.perf.inc("predicate_refusals")
            return MOsdPredicateReply(
                tid=msg.tid, op=msg.op, safe=False,
                reasons=["EINVAL: no osd ids"])
        v = self._predicate_verdict(msg.op, list(msg.osd_ids))
        if not v["safe"]:
            self.perf.inc("predicate_refusals")
        return MOsdPredicateReply(
            tid=msg.tid, op=msg.op, safe=v["safe"],
            unsafe_ids=v["unsafe_ids"], reasons=v["reasons"],
            pgs_checked=v["pgs_checked"],
            dirty_blocked=v["dirty_blocked"], dirty_keys=v["dirty_keys"])

    def _predicate_verdict(self, op: str, ids: List[int]) -> Dict[str, Any]:
        """ok-to-stop: would stopping these OSDs leave every PG at or
        above min_size?  safe-to-destroy: is NO shard's last copy on the
        targets — not mapped to any PG, every PG fully recovered (a hole
        anywhere may be data that lives only on the target), and no
        unflushed dirty object whose last live copy the targets hold
        (the r22 fast-ack clause: raw dirty replicas are acked client
        data that exists nowhere else until destage)."""
        m = self.osdmap
        targets = sorted({int(i) for i in ids})
        unknown = [t for t in targets if t not in m.osds]
        if unknown:
            return {"safe": False, "unsafe_ids": unknown,
                    "reasons": [f"ENOENT: osd.{t} not in the osdmap"
                                for t in unknown],
                    "pgs_checked": 0, "dirty_blocked": 0, "dirty_keys": []}
        reasons: List[str] = []
        unsafe: Set[int] = set()
        pgs = 0
        tset = set(targets)
        stop = op == "ok-to-stop"
        for pool in m.pools.values():
            for pg in range(pool.pg_num):
                pgs += 1
                acting = m.pg_to_acting(pool, pg)
                live = [a for a in acting if a != CRUSH_ITEM_NONE]
                if stop:
                    after = [a for a in live if a not in tset]
                    if len(after) < pool.min_size and len(after) < len(live):
                        hit = sorted(set(live) & tset)
                        unsafe.update(hit)
                        if len(reasons) < 8:
                            reasons.append(
                                f"pg {pool.pool_id}.{pg:x} would drop to "
                                f"{len(after)} live < min_size "
                                f"{pool.min_size} without osd {hit}")
                    continue
                hit = sorted(set(live) & tset)
                if hit:
                    unsafe.update(hit)
                    if len(reasons) < 8:
                        reasons.append(
                            f"pg {pool.pool_id}.{pg:x} still maps to "
                            f"osd {hit} (out + drain first)")
                elif len(live) < pool.size:
                    # conservatively unsafe: an unrecovered hole may be
                    # a shard whose only copy sits on the target
                    unsafe.update(targets)
                    if len(reasons) < 8:
                        reasons.append(
                            f"pg {pool.pool_id}.{pg:x} not fully "
                            f"recovered ({len(live)}/{pool.size} live)")
        # the cache-dirt clause: a target holding the LAST live copy of
        # un-destaged dirt blocks both predicates (dirty pages are acked
        # client data; the other holders are the only survivors)
        dirty_blocked = 0
        dirty_keys: List[str] = []
        up = {o for o, i in m.osds.items() if i.up}
        for t in targets:
            for key, holders in (self._osd_dirty.get(t) or []):
                others = [h for h in holders
                          if h != t and h not in tset and h in up]
                if not others:
                    dirty_blocked += 1
                    unsafe.add(t)
                    if len(dirty_keys) < 8:
                        dirty_keys.append(f"{key}@osd.{t}")
        if dirty_blocked:
            reasons.append(
                f"{dirty_blocked} unflushed dirty object(s) whose last "
                f"live copy sits on the target(s) — flush the cache tier "
                f"first")
        return {"safe": not unsafe and not reasons,
                "unsafe_ids": sorted(unsafe), "reasons": reasons,
                "pgs_checked": pgs, "dirty_blocked": dirty_blocked,
                "dirty_keys": dirty_keys}

    # -- elections -----------------------------------------------------------

    async def _run_election(self) -> None:
        """Candidate loop: propose, gather acks, declare victory or retry."""
        await asyncio.sleep(0.05 * self.rank)  # stagger: let rank 0 go first
        while not self._stopped and not self.logic.in_quorum:
            epoch = self.logic.start()
            self.logic.score = self.connectivity_score()
            await self._broadcast(MMonElection(op="propose", epoch=epoch,
                                               rank=self.rank,
                                               score=self.logic.score))
            await asyncio.sleep(self._election_timeout)
            if not self.logic.electing:
                return  # lost to a better candidate mid-wait
            if len(self.logic.acked_by) >= self.logic.majority:
                epoch, quorum = self.logic.declare_victory()
                await self._broadcast(MMonElection(op="victory", epoch=epoch,
                                                   rank=self.rank,
                                                   quorum=sorted(quorum)))
                await self._on_won_election()
                return

    async def _on_won_election(self) -> None:
        """Collect: bring the quorum to the newest committed state, then
        re-propose it so laggards (including us) sync."""
        self.paxos.promise(self.logic.epoch)
        for peer in self.logic.quorum:
            if peer != self.rank:
                await self._paxos_send(peer, {"op": "collect",
                                              "epoch": self.logic.epoch})
        await asyncio.sleep(min(0.3, self._election_timeout))
        self._last_lease_renew = time.monotonic()
        # start every up OSD's liveness countdown at takeover: an OSD that
        # died before we became leader must still go laggard -> down
        now = time.monotonic()
        for osd_id, info in self.osdmap.osds.items():
            if info.up:
                self._last_ping.setdefault(osd_id, now)
        try:
            await self._commit_state()
        except NoQuorum:
            pass

    def _spawn_election(self) -> None:
        if self._election_task is None or self._election_task.done():
            self._election_task = asyncio.get_running_loop().create_task(
                self._run_election()
            )

    async def _handle_election(self, msg: MMonElection) -> None:
        if msg.op == "propose":
            self.logic.score = self.connectivity_score()
            verdict = self.logic.receive_propose(
                msg.rank, msg.epoch, getattr(msg, "score", -1.0))
            if verdict == "ack":
                # carry OUR epoch so a restarted candidate catches up
                await self._send_rank(
                    msg.rank,
                    MMonElection(op="ack", epoch=self.logic.epoch,
                                 rank=self.rank))
                # if no victory follows, the lease-lapse tick re-elects
            elif verdict == "counter":
                self._spawn_election()
        elif msg.op == "ack":
            if self.logic.receive_ack(msg.rank, msg.epoch):
                pass  # majority reached; _run_election declares victory
        elif msg.op == "victory":
            if self.logic.receive_victory(msg.rank, msg.epoch,
                                          set(msg.quorum)):
                self.paxos.promise(msg.epoch)
                self._last_lease_renew = time.monotonic()
            else:
                # stale victory from a restarted mon: wake it into a real
                # election at the current epoch
                await self._send_rank(
                    msg.rank,
                    MMonElection(op="propose", epoch=self.logic.epoch,
                                 rank=self.rank))
                self._spawn_election()

    async def _handle_forward(self, msg: MForward) -> None:
        try:
            reply = await self._process_write(unpickle.loads(msg.inner),
                                              who=getattr(msg, "who", ""))
            await self._send_rank(
                msg.from_rank,
                MForwardReply(tid=msg.tid,
                              inner=pickle.dumps(reply, protocol=5)))
        except TRANSPORT_ERRORS:
            pass  # forwarder retries / client times out and resends
        except Exception:
            import traceback

            traceback.print_exc()  # a dispatcher-bug must be loud, not lost

    # -- paxos transport -----------------------------------------------------

    async def _paxos_send(self, peer_rank: int, payload: Dict[str, Any]) -> None:
        try:
            await self._send_rank(peer_rank,
                                  MMonPaxos(rank=self.rank, payload=payload))
        except (ConnectionError, OSError):
            pass

    async def _handle_paxos(self, msg: MMonPaxos) -> None:
        p = msg.payload
        op = p.get("op")
        if op == "collect":
            # answering collect promises that leader's epoch (reference
            # handle_collect records accepted_pn); stale collectors get
            # state too but no promise — their begin will be nacked
            self.paxos.promise(p.get("epoch", 0))
            await self._paxos_send(msg.rank, self.paxos.collect_state())
        elif op == "last":
            self.paxos.absorb_last(p)
        elif op == "begin":
            await self.paxos.handle_begin(msg.rank, p["version"], p["value"],
                                          p.get("epoch"))
        elif op == "accept":
            if self.paxos.handle_accept(msg.rank, p["version"],
                                        p.get("epoch")):
                if self._accept_event:
                    self._accept_event.set()
        elif op == "nack":
            # a peon promised a newer epoch: we were deposed while
            # believing we still led — abandon and re-elect at that epoch.
            # (handle_nack ignores stale nacks from rounds we already
            # superseded, so a delayed frame can't break a healthy quorum)
            if self.paxos.handle_nack(p.get("epoch", 0)):
                if self.logic.epoch < p["epoch"]:
                    self.logic.epoch = p["epoch"]
                self.logic.leader = None
                self.logic.quorum = set()
                if self._accept_event:
                    self._accept_event.set()
                self._spawn_election()
        elif op == "commit":
            self.paxos.handle_commit(p["version"], p["value"],
                                     p.get("epoch"))
        elif op == "lease":
            self._last_lease_renew = time.monotonic()
            # lease implies this leader's quorum view
            self.logic.receive_victory(msg.rank, p.get("epoch", self.logic.epoch),
                                       set(p.get("quorum", [])))
            # a lease can readmit a restarted mon before any election ran:
            # if the leader is ahead, pull the state we missed
            if p.get("version", 0) > self.store.last_committed:
                await self._paxos_send(msg.rank, {"op": "sync_req"})
        elif op == "sync_req":
            v, val = self.store.latest()
            if val is not None:
                await self._paxos_send(msg.rank,
                                       {"op": "commit", "version": v,
                                        "value": val,
                                        "epoch": self.logic.epoch})

    def _clean_pg_temps(self) -> None:
        """Prune unserviceable pg_temp overrides (reference
        OSDMap::clean_temps): entries of deleted pools, out-of-range pgs,
        and overrides with NO live member — a pg_temp whose members all
        died would otherwise pin the PG primary-less forever, since only
        the override's own primary ever asks to clear it."""
        dead = []
        for key, acting in self.osdmap.pg_temp.items():
            pool = self.osdmap.pools.get(key[0])
            if pool is None or key[1] >= pool.pg_num:
                dead.append(key)
                continue
            live = [a for a in acting
                    if a != CRUSH_ITEM_NONE and self.osdmap.osds.get(a)
                    and self.osdmap.osds[a].up]
            if len(live) < pool.min_size:
                # an override that cannot serve IO is strictly worse than
                # the crush mapping it hides: drop it
                dead.append(key)
        if dead:
            for key in dead:
                self.osdmap.pg_temp.pop(key, None)
            self.osdmap.epoch += 1

    async def _commit_state(self) -> None:
        """Replicate the current state snapshot; blocks until majority."""
        self._clean_pg_temps()
        async with self._commit_lock:
            quorum = self.logic.quorum or {self.rank}
            if not self.is_leader:
                raise NoQuorum("not the leader")
            if len(quorum) < self.logic.majority:
                raise NoQuorum("quorum too small")
            self._accept_event = asyncio.Event()
            await self.paxos.propose(self._snapshot_state(), quorum,
                                     epoch=self.logic.epoch)
            need = len(quorum) // 2 + 1
            if len(self.paxos.accepts) < need:
                try:
                    await asyncio.wait_for(self._accept_event.wait(),
                                           timeout=self._lease)
                except asyncio.TimeoutError:
                    self.paxos.proposing = None
                    raise NoQuorum("proposal not accepted by majority")
            if self.paxos.nacked or self.paxos.proposing is None:
                raise NoQuorum("deposed: a peer promised a newer epoch")
            await self.paxos.commit_current()

    # -- ticks: leases, liveness --------------------------------------------

    async def _tick(self) -> None:
        """Crash-guarded tick loop (daemon guard role): an unexpected
        exception becomes a crash report — spooled to crash_dir (a mon
        cannot file a report with itself) with the dump_recent ring —
        instead of a silently dead task."""
        try:
            await self._tick_inner()
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            from ceph_tpu_torch.rados.clog import build_crash_report, spool_crash

            report = build_crash_report(e, f"mon.{self.rank}",
                                        version=self.ctx.version,
                                        log=self.ctx.log)
            crash_dir = self.conf.get("crash_dir", "")
            if crash_dir:
                try:
                    spool_crash(crash_dir, report)
                except OSError:
                    pass
            self.ctx.log.error("mon", f"tick loop crashed: {e!r} "
                                      f"(crash id {report.crash_id})")
            raise

    async def _tick_inner(self) -> None:
        while not self._stopped:
            await asyncio.sleep(min(self._grace / 3, self._lease / 3))
            now = time.monotonic()
            if self.is_leader:
                # rotate the service secrets each ticket lifetime so a
                # leaked ticket ages out (reference rotating-key cadence);
                # the new ring replicates via the commit
                if now - self._last_rotation > self.keyserver.ttl:
                    self._last_rotation = now
                    self.keyserver.rotate()
                    try:
                        await self._commit_state()
                    except NoQuorum:
                        pass
                # renew peon leases
                if len(self.monmap) > 1:
                    for peer in self.logic.quorum:
                        if peer != self.rank:
                            await self._paxos_send(
                                peer, {"op": "lease", "epoch": self.logic.epoch,
                                       "quorum": sorted(self.logic.quorum),
                                       "version": self.store.last_committed})
                # OSD liveness: mark laggards down (countdown starts at
                # first observation, so a never-pinging OSD still
                # expires).  DOWN is immediate at the grace; OUT is the
                # auto-out pass's separate decision after
                # mon_osd_down_out_interval — down PGs hole instantly,
                # placement only redraws when the interval (plus the
                # noout/min_in_ratio gates) says the death is real.
                changed = False
                for osd_id, info in self.osdmap.osds.items():
                    if not info.up:
                        continue
                    last = self._last_ping.setdefault(osd_id, now)
                    if now - last > self._grace:
                        info.up = False
                        self._down_since.setdefault(osd_id, now)
                        changed = True
                        # the cluster log IS the operator's record of a
                        # daemon death (a crashed OSD simply stops
                        # pinging; its crash report may arrive via the
                        # spool much later)
                        self.logm.log(
                            "cluster", CLOG_WARN,
                            f"osd.{osd_id} marked down (no ping for "
                            f"{now - last:.1f}s)")
                changed |= self._auto_out_pass(now)
                if changed:
                    self.osdmap.epoch += 1
                    try:
                        await self._commit_state()
                    except NoQuorum:
                        pass
            elif len(self.monmap) > 1:
                # leaderless (rejoin, lost election round) or lease lapsed
                # (leader died): elect
                if (self.logic.leader is None
                        or now - self._last_lease_renew > self._lease):
                    if now - self._last_lease_renew > self._lease:
                        self.logic.leader = None
                        self.logic.quorum = set()
                    self._spawn_election()
            # prune forwarded requests whose leader never replied
            if self._pending_forwards:
                cutoff = now - 2 * self._lease
                for tid, (_fconn, t0) in list(self._pending_forwards.items()):
                    if t0 < cutoff:
                        self._pending_forwards.pop(tid, None)
            # push perf/status to the mgr on the OSD's cadence (every
            # third tick) so the membership counters reach /metrics
            self._mgr_ticks += 1
            if self._mgr_ticks % 3 == 0:
                await self._report_to_mgr()

    def _auto_out_pass(self, now: float) -> bool:
        """Auto-out of persistently-down OSDs (reference OSDMonitor tick,
        mon_osd_down_out_interval), gated three ways: the interval itself
        (0 disables), the `noout` osdmap flag (marking freezes; the
        countdown keeps running), and the mon_osd_min_in_ratio floor so a
        partition cannot auto-out half the map.  Admin-out stickiness is
        NOT set: a rejoining OSD auto-marks in again (reference
        auto-out/auto-in pairing).  Returns True when the map changed
        (caller bumps the epoch and commits)."""
        interval = float(
            self.conf.get("mon_osd_down_out_interval", 0.6) or 0.0)
        if interval <= 0:
            return False
        if "noout" in (getattr(self.osdmap, "flags", []) or []):
            return False
        changed = False
        total = len(self.osdmap.osds)
        n_in = sum(1 for o in self.osdmap.osds.values() if o.in_cluster)
        floor = float(self.conf.get("mon_osd_min_in_ratio", 0.0) or 0.0)
        for osd_id, info in sorted(self.osdmap.osds.items()):
            if info.up or not info.in_cluster:
                continue
            since = self._down_since.setdefault(osd_id, now)
            if now - since < interval:
                continue
            if floor > 0 and total and (n_in - 1) / total < floor:
                self.logm.log(
                    "cluster", CLOG_WARN,
                    f"osd.{osd_id} down {now - since:.1f}s but NOT "
                    f"auto-marked out: in-ratio {n_in - 1}/{total} would "
                    f"drop below mon_osd_min_in_ratio ({floor:g})")
                # restart the countdown so the refusal re-logs once per
                # interval instead of every tick
                self._down_since[osd_id] = now
                continue
            info.in_cluster = False
            n_in -= 1
            changed = True
            self.perf.inc("auto_outs")
            self.logm.log(
                "cluster", CLOG_WARN,
                f"osd.{osd_id} auto-marked out after being down "
                f"{max(0.0, now - since):.1f}s "
                f"(mon_osd_down_out_interval)")
        return changed

    async def _report_to_mgr(self) -> None:
        """Push perf/status to the mgr (MMgrReport flow, the OSD's
        _report_to_mgr discipline) when one is configured."""
        raw = self.conf.get("mgr_addr", "")
        if not raw:
            return
        try:
            host, port = str(raw).rsplit(":", 1)
            from ceph_tpu_torch.mgr.daemon import MMgrReport

            await asyncio.wait_for(
                self.messenger.send(
                    (host, int(port)),
                    MMgrReport(name=f"mon.{self.rank}",
                               perf=self.ctx.perf.dump(),
                               status=self.quorum_status(),
                               stamp=time.time()),
                    peer_type="mgr"),
                timeout=2.0)  # a stalled mgr must not starve the tick
        except TRANSPORT_ERRORS:
            pass
        except asyncio.TimeoutError:
            pass

    # -- mon-mon send helpers ------------------------------------------------

    async def _send_rank(self, peer_rank: int, msg: Any) -> None:
        try:
            await self.messenger.send(self.monmap[peer_rank], msg,
                                      peer_type="mon")
        except BaseException:
            self._track_peer(peer_rank, ok=False)
            raise
        self._track_peer(peer_rank, ok=True)

    def _track_peer(self, peer_rank: int, ok: bool) -> None:
        """Per-peer reachability EMA (reference ConnectionTracker.h:80):
        feeds the election connectivity score so a mon that cannot reach
        its peers stops winning leadership."""
        prev = self._conn_scores.get(peer_rank, 1.0)
        self._conn_scores[peer_rank] = 0.8 * prev + (0.2 if ok else 0.0)

    def connectivity_score(self) -> float:
        """Mean peer-reachability in [0,1]; 1.0 with no history."""
        if not self.monmap or len(self.monmap) <= 1:
            return 1.0
        vals = [self._conn_scores.get(r, 1.0)
                for r in range(len(self.monmap)) if r != self.rank]
        return sum(vals) / len(vals)

    async def _broadcast(self, msg: Any) -> None:
        for r in range(len(self.monmap)):
            if r != self.rank:
                try:
                    await self._send_rank(r, msg)
                except (ConnectionError, OSError):
                    pass

    # -- dispatch ------------------------------------------------------------

    # MGetHealth/MHealthMute ride the leader-forward path too: only the
    # leader holds the OSD-pushed health reports (pings forward there),
    # so a peon answering from its own empty report map would render a
    # degraded cluster HEALTH_OK.  MLog/MCrashReport/MCrashQuery are
    # LogMonitor state: replicated, so leader-only mutations.
    WRITE_TYPES = (MOsdBoot, MCreatePool, MDeletePool, MMarkDown,
                   MOsdMembership, MCrushOp,
                   MConfigSet, MOSDFailure,
                   MOSDPGTemp, MSetUpmap, MPoolSet, MSnapOp, MOSDSetFlag,
                   MSetFullRatio,
                   MGetHealth, MHealthMute, MLog, MCrashReport,
                   MCrashQuery)

    # admin mutations mirrored to the `audit` channel (who/what) before
    # execution — daemon-internal traffic (boots, failure reports,
    # pg_temp churn, log pushes) would drown the channel and is not an
    # operator action
    AUDIT_TYPES = (MCreatePool, MDeletePool, MMarkDown, MOsdMembership,
                   MCrushOp, MConfigSet,
                   MSetUpmap, MPoolSet, MSnapOp, MOSDSetFlag,
                   MSetFullRatio, MHealthMute, MCrashQuery)

    @staticmethod
    def _conn_is_daemon(conn) -> bool:
        """Did this connection prove daemon-level credentials: the cluster
        bootstrap secret, or a daemon-type service ticket?  (A peer's
        self-declared entity_type is NOT consulted.)"""
        kind = getattr(conn, "auth_kind", "none")
        etype = getattr(conn, "auth_entity_type", "")
        return kind == "secret" or (
            kind == "ticket" and etype in ("osd", "mon", "mgr", "mds"))

    async def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, MMonElection):
            await self._handle_election(msg)
        elif isinstance(msg, MMonPaxos):
            await self._handle_paxos(msg)
        elif isinstance(msg, MForward):
            # NEVER process a forwarded write inline: this serve loop is
            # the peon's connection, which ALSO carries its paxos accepts
            # — blocking here on consensus would deadlock the very accept
            # the proposal is waiting for (exposed when a score-elected
            # leader is not the client's first live mon)
            t = asyncio.get_running_loop().create_task(
                self._handle_forward(msg))
            self._forward_tasks.add(t)
            t.add_done_callback(self._forward_tasks.discard)
        elif isinstance(msg, MForwardReply):
            entry = self._pending_forwards.pop(msg.tid, None)
            if entry is not None:
                try:
                    await entry[0].send(unpickle.loads(msg.inner))
                except (ConnectionError, OSError):
                    pass
        elif isinstance(msg, MGetMap):
            await conn.send(self._map_reply_for(msg.min_epoch, tid=msg.tid))
        elif isinstance(msg, MAuthTicket):
            # Ticket minting is a credential-class decision:
            #  - daemon-type tickets pass the rotating-key gate below, so
            #    only bootstrap-proved conns or already-daemon tickets may
            #    mint one (else a leaked client ticket upgrades itself);
            #  - CLIENT tickets may only be minted over a bootstrap-proved
            #    conn: ticket-authenticated self-renewal would make the
            #    TTL on a leaked ticket meaningless (holders re-prove the
            #    long-lived secret to renew, as with cephx keyrings).
            want = msg.entity_type or "client"
            allowed = (self._conn_is_daemon(conn)
                       if want in ("osd", "mon", "mgr", "mds")
                       else getattr(conn, "auth_kind", "none") == "secret")
            if not allowed:
                await conn.send(MAuthTicketReply(tid=msg.tid, denied=True))
            else:
                blob, skey = self.keyserver.issue_ticket(
                    msg.entity or conn.peer_name, want)
                await conn.send(MAuthTicketReply(
                    tid=msg.tid, ticket=blob.hex(), session_key=skey.hex()))
        elif isinstance(msg, MAuthRotating):
            # the rotating service secrets can open/forge ANY ticket: only
            # peers that proved the bootstrap secret, or hold a daemon-type
            # ticket, may fetch them.  A ticket-authenticated CLIENT must
            # not be able to upgrade a leaked short-lived ticket into the
            # secrets themselves (reference: rotating keys are served to
            # daemons via their keyring auth, never to cephx clients).
            if self._conn_is_daemon(conn):
                await conn.send(MAuthRotatingReply(
                    tid=msg.tid, keys=self.keyserver.export_keys()))
            else:
                await conn.send(MAuthRotatingReply(tid=msg.tid, denied=True))
        elif isinstance(msg, MConfigGet):
            values = ({msg.key: self.cluster_conf.get(msg.key, "")}
                      if msg.key else dict(self.cluster_conf))
            await conn.send(MConfigReply(tid=msg.tid, values=values))
        elif isinstance(msg, MLogSubscribe):
            # log tail/subscription is a READ served by ANY mon: every
            # mon's LogMonitor tracks the committed tail via the paxos
            # snapshot, and _apply_committed streams to local watchers
            await conn.send(self._handle_log_subscribe(conn, msg))
        elif isinstance(msg, MCrashQuery) and msg.op in ("ls", "info"):
            # crash ls/info are READS (any mon holds the registry via
            # the snapshot): served locally — no leader forward, no
            # state backup, and crucially no audit entry, or a crash-ls
            # poll loop would evict real events from the bounded tail
            await conn.send(self._crash_query_read(msg))
        elif isinstance(msg, MCommand):
            # `ceph tell mon.N ...`: run the admin-socket command here.
            # Same gate as the OSD handler — with auth configured, an
            # unauthenticated peer may not drive runtime config
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
                    reply = MCommandReply(tid=msg.tid, ok=False,
                                          error=f"{type(e).__name__}: {e}")
            await conn.send(reply)
        elif isinstance(msg, MOsdPredicate):
            # safe-to-destroy / ok-to-stop are READS served at ANY mon:
            # the map replicates via paxos and every mon snoops the
            # dirt roster off the pings it sees or forwards — no leader
            # round-trip, no audit entry (a predicate poll loop must not
            # evict real events from the bounded audit tail)
            await conn.send(self._predicate_reply(msg))
        elif isinstance(msg, MPing):
            await self._handle_ping(conn, msg)
        elif isinstance(msg, self.WRITE_TYPES):
            who = getattr(conn, "peer_name", "") or ""
            if self.is_leader:
                reply = await self._process_write(msg, who=who)
                try:
                    await conn.send(reply)
                except (ConnectionError, OSError):
                    pass
            elif self.leader_addr is not None:
                tid = uuid.uuid4().hex
                self._pending_forwards[tid] = (conn, time.monotonic())
                try:
                    await self._send_rank(
                        self.logic.leader,
                        MForward(tid=tid, from_rank=self.rank,
                                 inner=pickle.dumps(msg, protocol=5),
                                 who=who),
                    )
                except (ConnectionError, OSError):
                    self._pending_forwards.pop(tid, None)
                    reply = self._error_reply(msg, "leader unreachable")
                    if reply is not None:
                        await conn.send(reply)
            else:
                reply = self._error_reply(msg, "no quorum")
                if reply is not None:
                    await conn.send(reply)

    async def _handle_ping(self, conn, msg: MPing) -> None:
        if not self.is_leader:
            # snoop the dirt roster before relaying: predicates are READS
            # served at any mon, and this peon's copy of the v5 tail is
            # what makes its safe-to-destroy answer honest
            dirty = getattr(msg, "cache_dirty", None)
            if dirty is not None:
                self._osd_dirty[msg.osd_id] = list(dirty)
            # relay liveness to the leader (fire and forget; a dead leader
            # is the lease-lapse path's problem, not the ping's)
            if self.leader_addr is not None:
                try:
                    await self._send_rank(
                        self.logic.leader,
                        MForward(tid="", from_rank=self.rank,
                                 inner=pickle.dumps(msg, protocol=5)),
                    )
                except (ConnectionError, OSError):
                    pass
            if msg.epoch < self.osdmap.epoch:
                await conn.send(MMapReply(osdmap=self.osdmap))
            return
        await self._process_ping(msg)
        if msg.epoch < self.osdmap.epoch:
            try:
                await conn.send(self._map_reply_for(msg.epoch))
            except (ConnectionError, OSError):
                pass

    async def _process_ping(self, msg: MPing) -> None:
        self._last_ping[msg.osd_id] = time.monotonic()
        # daemon-observed health rides the ping (v3 field; older daemons
        # simply never report): the LATEST report per OSD wins, and an
        # empty dict actively CLEARS that OSD's checks
        health = getattr(msg, "health", None)
        if health is not None:
            if health:
                self._health_reports[msg.osd_id] = {
                    "checks": dict(health), "stamp": time.monotonic()}
            else:
                self._health_reports.pop(msg.osd_id, None)
        # store utilization rides the ping too (v4 field): the fullness
        # plane's input.  A state TRANSITION (nearfull/backfillfull/full
        # crossed, or cleared past the hysteresis margin) mutates the
        # map; mere utilization drift does not.
        statfs = getattr(msg, "statfs", None)
        if statfs:
            self._osd_statfs[msg.osd_id] = dict(statfs)
        # unflushed-dirt roster (v5 field): the safe-to-destroy input.
        # The LATEST report wins; an empty list actively clears it
        # (destage completed) — a missing field (old daemon) leaves the
        # last report standing, conservatively.
        dirty = getattr(msg, "cache_dirty", None)
        if dirty is not None:
            self._osd_dirty[msg.osd_id] = list(dirty)
        changed = self._derive_fullness()
        info = self.osdmap.osds.get(msg.osd_id)
        rejoined = info is not None and not info.up
        if rejoined:
            info.up = True
            info.in_cluster = msg.osd_id not in self._admin_out
            self._down_since.pop(msg.osd_id, None)  # auto-out hysteresis
            changed = True
        if changed:
            self.osdmap.epoch += 1
            try:
                await self._commit_state()
            except NoQuorum:
                return
            # push the new map straight to the rejoining OSD
            if rejoined and msg.addr and msg.addr[0]:
                try:
                    await self.messenger.send(tuple(msg.addr),
                                              MMapReply(osdmap=self.osdmap))
                except (ConnectionError, OSError):
                    pass

    def _derive_fullness(self) -> bool:
        """Derive per-OSD NEARFULL/BACKFILLFULL/FULL states from the
        latest statfs reports vs the map's settable ratios (reference
        OSDMonitor::update_osd_stat + the full/backfillfull/nearfull
        sets).  Promotion is immediate; demotion requires utilization to
        drop mon_osd_full_hysteresis BELOW the state's threshold, so a
        ratio oscillating on the line cannot flap the map every ping.
        Returns True when the state map changed (caller bumps the epoch
        and commits)."""
        m = self.osdmap
        nf, bf, fl = m.fullness_ratios()
        thr = {"nearfull": nf, "backfillfull": bf, "full": fl}
        hyst = float(self.conf.get("mon_osd_full_hysteresis", 0.01) or 0.0)
        cur = dict(getattr(m, "full_osds", None) or {})
        new: Dict[int, str] = {}
        for osd_id, st in self._osd_statfs.items():
            if osd_id not in m.osds:
                continue
            total = int(st.get("total", 0) or 0)
            if total <= 0:
                continue  # no configured capacity: never full
            ratio = int(st.get("used", 0) or 0) / total
            state = m.state_for_ratio(ratio)  # the ONE ladder cascade
            prev = cur.get(osd_id, "")
            if prev and FULL_SEVERITY[state] < FULL_SEVERITY[prev] \
                    and ratio >= thr[prev] - hyst:
                state = prev  # sticky until clearly below the threshold
            if state:
                new[osd_id] = state
        # an OSD with a state but no report THIS leadership (leader
        # change lost the runtime statfs; down OSD stopped pinging)
        # keeps its last-known state — auto-clear must come from an
        # actual below-threshold report, never from missing data
        for osd_id, prev in cur.items():
            if osd_id in m.osds and osd_id not in new \
                    and osd_id not in self._osd_statfs:
                new[osd_id] = prev
        if new == cur:
            return False
        m.full_osds = new
        for osd_id in sorted(set(new) | set(cur)):
            a, b = cur.get(osd_id, ""), new.get(osd_id, "")
            if a == b:
                continue
            if b:
                self.logm.log(
                    "cluster",
                    CLOG_ERROR if b == "full" else CLOG_WARN,
                    f"osd.{osd_id} is {b}")
            else:
                self.logm.log("cluster", CLOG_INFO,
                              f"osd.{osd_id} fullness cleared (was {a})")
        return True

    def _osd_utilization(self) -> Dict[int, Dict]:
        """Per-OSD utilization + fullness view served inside the health
        document (`ceph osd df` renders it; the mgr exports it to
        /metrics) — one MGetHealth instead of N per-OSD statfs ops."""
        m = self.osdmap
        out: Dict[int, Dict] = {}
        for osd_id, info in sorted(m.osds.items()):
            st = self._osd_statfs.get(osd_id) or {}
            total = int(st.get("total", 0) or 0)
            used = int(st.get("used", 0) or 0)
            out[osd_id] = {
                "up": bool(info.up),
                "in": bool(info.in_cluster),
                # WEIGHT = crush weight, REWEIGHT = the 0..1 overlay
                # (the `ceph osd df` column pair); "weight" keeps the
                # historic meaning (the overlay) for old renderers
                "weight": info.weight,
                "crush_weight": osd_crush_weight(info),
                "reweight": info.weight,
                "total": total,
                "used": used,
                "avail": int(st.get("avail", 0) or 0),
                "num_objects": int(st.get("num_objects", 0) or 0),
                "ratio": round(used / total, 4) if total else 0.0,
                "state": m.full_state(osd_id),
            }
        return out

    # -- writes (leader only) ------------------------------------------------

    async def _process_write(self, msg: Any, who: str = "") -> Any:
        """Apply one mutating request and replicate; returns the reply.
        Re-executions (messenger replay, forward retry) are suppressed by
        tid; a failed consensus round rolls the in-memory state back so a
        write reported failed cannot leak into a later snapshot."""
        # health QUERIES ride the leader-forward plumbing but are reads:
        # no state snapshot (a full osdmap pickle per mgr health poll),
        # no replay-dedup entry (each answer is recomputed; caching one
        # would also evict a genuine write's).  Mutes stay on the write
        # path — they replicate.
        if isinstance(msg, MGetHealth):
            return await self._process_write_inner(msg)
        tid = getattr(msg, "tid", "")
        if tid and tid in self._applied_tids:
            return self._applied_tids[tid]
        backup = self._snapshot_state()
        if isinstance(msg, self.AUDIT_TYPES) \
                and not (isinstance(msg, MCrashQuery)
                         and msg.op in ("ls", "info")):
            # every admin MUTATION is mirrored to the `audit` channel
            # (reference: the mon audit log) BEFORE execution, so the
            # entry rides the same commit the handler performs (reads —
            # crash ls/info — never audit: a poll loop must not evict
            # real events from the bounded tail)
            self.logm.log("audit", CLOG_INFO,
                          f"from='{who or 'unknown'}' "
                          f"cmd='{describe_command(msg)}': dispatch")
        try:
            reply = await self._process_write_inner(msg)
        except NoQuorum as e:
            self._restore_state(backup)
            reply = self._error_reply(msg, str(e))
            if reply is None:
                raise
            return reply
        if tid:
            self._applied_tids[tid] = reply
            while len(self._applied_tids) > 1024:
                self._applied_tids.pop(next(iter(self._applied_tids)))
        return reply

    def _restore_state(self, backup: bytes) -> None:
        state = unpickle.loads(backup)
        self.osdmap = state["osdmap"]
        self.cluster_conf = state["cluster_conf"]
        self._next_osd_id = state["next_osd_id"]
        self._next_pool_id = state["next_pool_id"]
        # the cluster log deliberately does NOT roll back: the failed
        # write's audit line says "dispatch" (an attempt, not an
        # outcome), while a strict rewind would erase entries a
        # CONCURRENT write committed after this backup was taken — and
        # a NoQuorum failure usually means we are about to be deposed
        # and resync from the new leader anyway
        # mutes roll back too: a mute whose commit failed must not leak
        # into a later snapshot (the operator was told it failed)
        mutes = state.get("health_mutes")
        if mutes is not None:
            now = time.monotonic()
            self._health_mutes = {
                name: (float("inf") if rem is None else now + rem)
                for name, rem in mutes.items()}

    async def _process_write_inner(self, msg: Any) -> Any:
        if isinstance(msg, MPing):  # forwarded liveness
            await self._process_ping(msg)
            return MMapReply(osdmap=self.osdmap)
        if isinstance(msg, MGetHealth):
            return MHealthReply(
                tid=msg.tid,
                health=self.health_summary(detail=msg.detail))
        if isinstance(msg, MHealthMute):
            reply = self._handle_health_mute(msg)
            # replicate: an operator's mute must survive a leader change
            # (the snapshot carries rebased remaining-ttls)
            await self._commit_state()
            return reply
        if isinstance(msg, MLog):
            # cluster-log batch from a daemon's LogClient: per-sender seq
            # dedupe makes ack-loss resends idempotent; the tail rides
            # the paxos snapshot and _apply_committed streams it to
            # `ceph -w` watchers on every mon
            last = self.logm.submit(msg.who, decode_entries(msg.entries))
            await self._commit_state()
            return MLogAck(who=msg.who, last_seq=last)
        if isinstance(msg, MCrashReport):
            if self.logm.add_crash(msg):
                self.logm.log(
                    "cluster", CLOG_ERROR,
                    f"{msg.entity} crashed: {msg.exception} "
                    f"(crash id {msg.crash_id})")
                await self._commit_state()
            return MCrashReportAck(tid=msg.tid, ok=True)
        if isinstance(msg, MCrashQuery):
            if msg.op in ("ls", "info"):
                # normally served read-side in _dispatch; kept here for
                # forwarded frames from older peers
                return self._crash_query_read(msg)
            if msg.op in ("archive", "archive-all"):
                n = self.logm.crash_archive(
                    "" if msg.op == "archive-all" else msg.crash_id)
                if n:
                    await self._commit_state()
                return MCrashQueryReply(tid=msg.tid,
                                        crashes=self.logm.crash_ls())
            if msg.op == "prune":
                n = self.logm.crash_prune(msg.keep)
                if n:
                    await self._commit_state()
                return MCrashQueryReply(tid=msg.tid,
                                        crashes=self.logm.crash_ls())
            return MCrashQueryReply(tid=msg.tid, ok=False,
                                    error=f"bad crash op {msg.op!r}")
        if isinstance(msg, MOsdBoot):
            return await self._process_boot(msg)
        if isinstance(msg, MCreatePool):
            reply = self._create_pool(msg)
            reply.tid = msg.tid
            if reply.ok:
                await self._commit_state()
            return reply
        if isinstance(msg, MDeletePool):
            pool = self.osdmap.pools.get(msg.pool_id)
            if pool is None:
                return MCreatePoolReply(tid=msg.tid, ok=False,
                                        error="ENOENT: no such pool")
            if msg.confirm_name != pool.name:
                # the reference refuses deletion unless the pool name is
                # echoed back (--yes-i-really-really-mean-it discipline)
                return MCreatePoolReply(
                    tid=msg.tid, ok=False,
                    error="EPERM: confirmation name mismatch")
            del self.osdmap.pools[msg.pool_id]
            for d in (self.osdmap.pg_temp, self.osdmap.pg_upmap):
                for k in [k for k in d if k[0] == msg.pool_id]:
                    d.pop(k, None)
            self.osdmap.epoch += 1
            await self._commit_state()
            return MCreatePoolReply(tid=msg.tid, ok=True,
                                    pool_id=msg.pool_id)
        if isinstance(msg, MMarkDown):
            info = self.osdmap.osds.get(msg.osd_id)
            if info is not None and info.up:
                info.up = False
                self._last_ping[msg.osd_id] = -1e9
                # backdate the auto-out countdown so an admin mark-down
                # outs immediately — but still through _auto_out_pass,
                # so `noout` and the min_in_ratio floor are honored
                self._down_since[msg.osd_id] = -1e9
                self.logm.log("cluster", CLOG_WARN,
                              f"osd.{msg.osd_id} marked down (admin)")
                self._auto_out_pass(time.monotonic())
                self.osdmap.epoch += 1
                await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MCrushOp):
            reply = self._apply_crush_op(msg)
            if reply.ok:
                self.osdmap.epoch += 1
                reply.epoch = self.osdmap.epoch
                self.perf.inc("crush_moves")
                await self._commit_state()
            return reply
        if isinstance(msg, MOsdMembership):
            # `ceph osd out/in/reweight/crush reweight` (reference
            # OSDMonitor prepare_command): audited admin membership
            # mutation.  Every arm replies with the (possibly bumped)
            # map; invalid requests leave the map untouched — the CLI
            # validates and reports, the mon never half-applies.
            info = self.osdmap.osds.get(msg.osd_id)
            if info is None:
                return MMapReply(osdmap=self.osdmap, tid=msg.tid)
            changed = False
            if msg.op == "out":
                self._admin_out.add(msg.osd_id)
                if info.in_cluster:
                    # up stays as-is: the OSD keeps serving (and later
                    # drains via stray purge); only placement weight
                    # drops to zero through the in_cluster gate
                    info.in_cluster = False
                    changed = True
                    self.logm.log("cluster", CLOG_WARN,
                                  f"osd.{msg.osd_id} marked out (admin)")
            elif msg.op == "in":
                self._admin_out.discard(msg.osd_id)
                if not info.in_cluster:
                    info.in_cluster = True
                    changed = True
                    self.logm.log("cluster", CLOG_INFO,
                                  f"osd.{msg.osd_id} marked in (admin)")
            elif msg.op == "reweight":
                # the 0..1 overlay (reference: reweight is clamped)
                w = min(1.0, max(0.0, float(msg.weight)))
                if info.weight != w:
                    info.weight = w
                    changed = True
                    self.logm.log("cluster", CLOG_INFO,
                                  f"osd.{msg.osd_id} reweighted to {w:g}")
            elif msg.op == "crush-reweight":
                w = max(0.0, float(msg.weight))
                if osd_crush_weight(info) != w:
                    info.crush_weight = w
                    self.osdmap.crush.set_weight(msg.osd_id, w)
                    changed = True
                    self.logm.log("cluster", CLOG_INFO,
                                  f"osd.{msg.osd_id} crush weight set "
                                  f"to {w:g}")
            elif msg.op in ("purge", "purge-force"):
                # `ceph osd purge`: remove the OSD from map and crush for
                # good (OSDMonitor "osd purge").  Refused while the OSD is
                # up, and — unless forced — while safe-to-destroy says the
                # target may hold the last copy of anything.  Refusal is
                # signalled by the id surviving in the replied map.
                if info.up:
                    self.logm.log(
                        "cluster", CLOG_WARN,
                        f"osd.{msg.osd_id} purge refused: still up "
                        f"(stop it first)")
                    return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if msg.op != "purge-force":
                    v = self._predicate_verdict("safe-to-destroy",
                                                [msg.osd_id])
                    if not v["safe"]:
                        self.logm.log(
                            "cluster", CLOG_WARN,
                            f"osd.{msg.osd_id} purge refused: "
                            f"{'; '.join(v['reasons'][:2]) or 'not safe'}")
                        return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                self.osdmap.crush.remove_item(msg.osd_id)
                del self.osdmap.osds[msg.osd_id]
                self._admin_out.discard(msg.osd_id)
                for d in (self._osd_statfs, self._osd_dirty,
                          self._down_since, self._last_ping,
                          getattr(self.osdmap, "full_osds", None) or {}):
                    d.pop(msg.osd_id, None)
                changed = True
                self.logm.log("cluster", CLOG_INFO,
                              f"osd.{msg.osd_id} purged"
                              + (" (forced)"
                                 if msg.op == "purge-force" else ""))
            if changed:
                self.osdmap.epoch += 1
            # admin_out stickiness changed even when the map did not
            # (out of an already-out OSD): replicate either way
            await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MOSDFailure):
            # OSD-observed failure report (OSDMonitor::prepare_failure):
            # mark down once enough distinct reporters agree
            now = time.monotonic()
            reporters = self._failure_reports.setdefault(msg.target_osd, {})
            reporters[msg.from_osd] = now
            # drop stale reports
            for r, t0 in list(reporters.items()):
                if now - t0 > 2 * self._grace:
                    reporters.pop(r, None)
            need = int(self.conf.get("mon_osd_min_down_reporters", 1) or 1)
            info = self.osdmap.osds.get(msg.target_osd)
            if info is not None and info.up and len(reporters) >= need:
                # down only — `out` follows later via _auto_out_pass once
                # mon_osd_down_out_interval elapses (hysteresis: a blip
                # re-pings back in before any data moves)
                info.up = False
                self._last_ping[msg.target_osd] = -1e9
                self._down_since.setdefault(msg.target_osd, now)
                self.osdmap.epoch += 1
                self._failure_reports.pop(msg.target_osd, None)
                self.logm.log(
                    "cluster", CLOG_WARN,
                    f"osd.{msg.target_osd} marked down "
                    f"(reported failed by osd.{msg.from_osd})")
                await self._commit_state()
            return MMapReply(osdmap=self.osdmap)
        if isinstance(msg, MOSDPGTemp):
            # primary-requested temporary acting set
            # (OSDMonitor::prepare_pgtemp role)
            key = (msg.pool_id, msg.pg)
            changed = False
            if msg.acting:
                pool = self.osdmap.pools.get(msg.pool_id)
                live_req = [a for a in msg.acting if a != CRUSH_ITEM_NONE]
                valid = (
                    pool is not None
                    and msg.pg < pool.pg_num
                    and len(set(live_req)) == len(live_req)
                    and all(a == CRUSH_ITEM_NONE or a in self.osdmap.osds
                            for a in msg.acting)
                    # an override equal to the effective placement (crush
                    # adjusted by upmap) is a no-op that would only linger
                    and list(msg.acting) != self.osdmap.pg_to_placed(pool,
                                                                     msg.pg)
                )
                if valid and self.osdmap.pg_temp.get(key) != list(msg.acting):
                    self.osdmap.pg_temp[key] = list(msg.acting)
                    changed = True
            elif key in self.osdmap.pg_temp:
                self.osdmap.pg_temp.pop(key)
                changed = True
            if changed:
                self.osdmap.epoch += 1
                await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MOSDSetFlag):
            # `ceph osd set/unset <flag>` (OSDMonitor prepare_set_flag):
            # cluster-wide op gates clients honor by QUEUEING matching
            # ops (pausewr/pauserd/full) until the flag clears
            flags = set(getattr(self.osdmap, "flags", []) or [])
            changed = (msg.flag not in flags) if msg.set \
                else (msg.flag in flags)
            if msg.set:
                flags.add(msg.flag)
            else:
                flags.discard(msg.flag)
            if changed:
                self.osdmap.flags = sorted(flags)
                self.osdmap.epoch += 1
                await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MSetFullRatio):
            # `ceph osd set-nearfull-ratio / set-backfillfull-ratio /
            # set-full-ratio` (OSDMonitor "osd set-*full-ratio"): the
            # ORDERING is validated against the candidate ladder —
            # 0 < nearfull <= backfillfull <= full < failsafe — so one
            # typo cannot invert enforcement cluster-wide
            if msg.which not in ("nearfull", "backfillfull", "full"):
                return MConfigReply(
                    tid=msg.tid, ok=False,
                    error=f"EINVAL: unknown ratio {msg.which!r} (want "
                          f"nearfull|backfillfull|full)")
            try:
                ratio = float(msg.ratio)
            except (TypeError, ValueError):
                return MConfigReply(tid=msg.tid, ok=False,
                                    error=f"EINVAL: bad ratio "
                                          f"{msg.ratio!r}")
            nf, bf, fl = self.osdmap.fullness_ratios()
            cand = {"nearfull": nf, "backfillfull": bf, "full": fl,
                    msg.which: ratio}
            failsafe = float(self.conf.get("osd_failsafe_full_ratio",
                                           0.97) or 0.97)
            if not (0.0 < cand["nearfull"] <= cand["backfillfull"]
                    <= cand["full"] < failsafe):
                return MConfigReply(
                    tid=msg.tid, ok=False,
                    error=f"EINVAL: ratio ordering violated: need "
                          f"0 < nearfull <= backfillfull <= full < "
                          f"failsafe ({failsafe:g}), got "
                          f"nearfull={cand['nearfull']:g} "
                          f"backfillfull={cand['backfillfull']:g} "
                          f"full={cand['full']:g}")
            self.osdmap.nearfull_ratio = cand["nearfull"]
            self.osdmap.backfillfull_ratio = cand["backfillfull"]
            self.osdmap.full_ratio = cand["full"]
            # states may move under the new thresholds right away
            self._derive_fullness()
            self.osdmap.epoch += 1
            await self._commit_state()
            return MConfigReply(
                tid=msg.tid, ok=True,
                values={f"{msg.which}_ratio": f"{ratio:g}"})
        if isinstance(msg, MSetUpmap):
            # balancer-installed persistent override (pg-upmap role)
            key = (msg.pool_id, msg.pg)
            pool = self.osdmap.pools.get(msg.pool_id)
            changed = False
            if msg.acting:
                live_req = [a for a in msg.acting if a != CRUSH_ITEM_NONE]
                valid = (
                    pool is not None and msg.pg < pool.pg_num
                    and len(msg.acting) == pool.size
                    and len(set(live_req)) == len(live_req)
                    and all(a == CRUSH_ITEM_NONE or a in self.osdmap.osds
                            for a in msg.acting)
                )
                if valid and self.osdmap.pg_upmap.get(key) != list(msg.acting):
                    self.osdmap.pg_upmap[key] = list(msg.acting)
                    changed = True
            elif key in self.osdmap.pg_upmap:
                self.osdmap.pg_upmap.pop(key)
                changed = True
            if changed:
                self.osdmap.epoch += 1
                await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MSnapOp):
            pool = self.osdmap.pools.get(msg.pool_id)
            if pool is None:
                return MSnapOpReply(tid=msg.tid, ok=False,
                                    code=-errno.ENOENT,
                                    error="no such pool")
            # one snapshot DISCIPLINE per pool (reference
            # is_pool_snaps_mode/is_unmanaged_snaps_mode): pool ops and
            # self-managed ids disagree about who owns the SnapContext,
            # so the first use latches the mode and mixing is -EINVAL
            if msg.op == "create":
                if pool.snap_mode == "pool":
                    return MSnapOpReply(
                        tid=msg.tid, ok=False, code=-errno.EINVAL,
                        error="pool is in pool-snaps mode; self-managed "
                              "snap ids are not allowed")
                pool.snap_mode = "selfmanaged"
                pool.snap_seq += 1
                self.osdmap.epoch += 1
                await self._commit_state()
                return MSnapOpReply(tid=msg.tid, snap_id=pool.snap_seq)
            if msg.op == "remove":
                if pool.snap_mode == "pool":
                    # symmetric latch: a self-managed remove on a
                    # pool-snaps pool could retire a pool snapshot's id
                    # while its name stays listed — exactly the
                    # inconsistency the mode latch exists to prevent
                    return MSnapOpReply(
                        tid=msg.tid, ok=False, code=-errno.EINVAL,
                        error="pool is in pool-snaps mode; use rmsnap")
                if msg.snap_id <= 0 or msg.snap_id > pool.snap_seq:
                    return MSnapOpReply(tid=msg.tid, ok=False,
                                        code=-errno.EINVAL,
                                        error="bad snap id")
                if msg.snap_id not in pool.removed_snaps:
                    pool.removed_snaps.add(msg.snap_id)
                    self.osdmap.epoch += 1
                    await self._commit_state()
                return MSnapOpReply(tid=msg.tid, snap_id=msg.snap_id)
            if msg.op == "mksnap":
                if pool.snap_mode == "selfmanaged":
                    return MSnapOpReply(
                        tid=msg.tid, ok=False, code=-errno.EINVAL,
                        error="pool already uses self-managed snaps; "
                              "pool snapshots are not allowed")
                if not msg.name:
                    return MSnapOpReply(tid=msg.tid, ok=False,
                                        code=-errno.EINVAL,
                                        error="snap name required")
                if msg.name in pool.pool_snaps:
                    return MSnapOpReply(tid=msg.tid, ok=False,
                                        code=-errno.EEXIST,
                                        error=f"snap {msg.name!r} exists")
                pool.snap_mode = "pool"
                pool.snap_seq += 1
                pool.pool_snaps[msg.name] = pool.snap_seq
                self.osdmap.epoch += 1
                await self._commit_state()
                return MSnapOpReply(tid=msg.tid, snap_id=pool.snap_seq)
            if msg.op == "rmsnap":
                sid = pool.pool_snaps.pop(msg.name, None)
                if sid is None:
                    return MSnapOpReply(tid=msg.tid, ok=False,
                                        code=-errno.ENOENT,
                                        error=f"no snap {msg.name!r}")
                if sid not in pool.removed_snaps:
                    pool.removed_snaps.add(sid)
                # the mode latch survives an empty snap list (reference
                # POOL_SNAPS flag is sticky) — pool vs self-managed is
                # a pool lifetime decision
                self.osdmap.epoch += 1
                await self._commit_state()
                return MSnapOpReply(tid=msg.tid, snap_id=sid)
            return MSnapOpReply(tid=msg.tid, ok=False, code=-errno.EINVAL,
                                error="bad snap op")
        if isinstance(msg, MPoolSet):
            pool = self.osdmap.pools.get(msg.pool_id)
            if pool is None:
                return MMapReply(osdmap=self.osdmap, tid=msg.tid)
            if msg.key in ("qos_reservation", "qos_weight", "qos_limit") \
                    or msg.key.startswith("qos_class:"):
                # per-pool dmClock QoS profile (`pool set qos_reservation/
                # qos_weight/qos_limit` defaults + qos_class:<name> =
                # "r:w:l" tenant-class overrides): validated HERE
                # (qos.validate_pool_qos) and distributed via pool.opts
                # in the osdmap, so a malformed profile can never wedge
                # OSD admission cluster-wide
                from ceph_tpu_torch.rados.qos import validate_pool_qos

                if not validate_pool_qos(msg.key, msg.value):
                    return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if not hasattr(pool, "opts"):
                    pool.opts = {}
                pool.opts[msg.key] = msg.value
                self.osdmap.epoch += 1
                await self._commit_state()
                return MMapReply(osdmap=self.osdmap, tid=msg.tid)
            if msg.key in ("hit_set_period", "hit_set_count",
                           "hit_set_fpp", "hit_set_target_size",
                           "min_read_recency_for_promote",
                           "min_write_recency_for_promote",
                           "target_max_bytes",
                           "cache_target_full_ratio",
                           "cache_target_dirty_ratio",
                           "cache_mode"):
                # cache-tier pool parameters (reference `ceph osd pool
                # set NAME hit_set_period ...`, pg_pool_t hit_set_*
                # and the tier agent knobs): validated here, read by
                # every primary through pool.opts (OSD._tier_opt) so a
                # bad value can never wedge the read path cluster-wide
                validators = {
                    "hit_set_period": lambda v: float(v) > 0,
                    "hit_set_count": lambda v: int(v) >= 1,
                    "hit_set_fpp": lambda v: 0.0 < float(v) < 1.0,
                    "hit_set_target_size": lambda v: int(v) >= 1,
                    "min_read_recency_for_promote":
                        lambda v: int(v) >= 0,
                    "min_write_recency_for_promote":
                        lambda v: int(v) >= 0,
                    "target_max_bytes": lambda v: int(v) >= 0,
                    "cache_target_full_ratio":
                        lambda v: 0.0 < float(v) <= 1.0,
                    "cache_target_dirty_ratio":
                        lambda v: 0.0 < float(v) <= 1.0,
                    # writeback defers local shard applies to dirty
                    # pages (flush-before-evict pinned OSD-side);
                    # anything else is a typo that must not half-engage
                    "cache_mode":
                        lambda v: v in ("writeback", "writethrough"),
                }
                try:
                    if not validators[msg.key](msg.value):
                        return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                except (TypeError, ValueError):
                    return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if not hasattr(pool, "opts"):
                    # PoolInfo unpickled from a pre-opts mon store
                    pool.opts = {}
                pool.opts[msg.key] = msg.value
                self.osdmap.epoch += 1
                await self._commit_state()
                return MMapReply(osdmap=self.osdmap, tid=msg.tid)
            if msg.key in ("compression_mode", "compression_algorithm",
                           "compression_required_ratio",
                           "compression_min_blob_size"):
                # per-pool store options (reference `ceph osd pool set
                # NAME compression_mode ...`, pg_pool_t::opts): validated
                # here, applied by every OSD at its blob boundary
                valid = {
                    "compression_mode": ("none", "passive", "aggressive",
                                         "force"),
                    "compression_algorithm": ("zlib", "zstd", "lzma"),
                }.get(msg.key)
                if valid is not None and msg.value not in valid:
                    return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if msg.key == "compression_algorithm" \
                        and msg.value == "zstd":
                    # zstd needs the optional `zstandard` package
                    # (gated in bluestore the way auth gates
                    # `cryptography`): still a VALID cluster-wide
                    # setting — other hosts may have it — but warn when
                    # this mon's host would store raw, so the operator
                    # learns at config time, not from per-OSD noise
                    import importlib.util

                    if importlib.util.find_spec("zstandard") is None:
                        print("mon: compression_algorithm=zstd set but "
                              "the `zstandard` package is missing on "
                              "this host; OSDs without it store raw")
                if msg.key in ("compression_required_ratio",
                               "compression_min_blob_size"):
                    # numeric opts parse HERE, not in the OSD write
                    # path — a garbage value must be refused, never
                    # fail every subsequent write to the pool
                    try:
                        (float if "ratio" in msg.key else int)(msg.value)
                    except ValueError:
                        return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if not hasattr(pool, "opts"):
                    # PoolInfo unpickled from a pre-opts mon store:
                    # default_factory fields are not class attributes
                    pool.opts = {}
                pool.opts[msg.key] = msg.value
                self.osdmap.epoch += 1
                await self._commit_state()
                return MMapReply(osdmap=self.osdmap, tid=msg.tid)
            if msg.key == "pg_num":
                try:
                    n = int(msg.value)
                except ValueError:
                    return MMapReply(osdmap=self.osdmap, tid=msg.tid)
                if 0 < n <= 4096 and n != pool.pg_num:
                    import dataclasses as _dc

                    new_pool = _dc.replace(pool, pg_num=n)
                    self.osdmap.pools[msg.pool_id] = new_pool
                    # overrides keyed on the old pg space are meaningless
                    for d in (self.osdmap.pg_temp, self.osdmap.pg_upmap):
                        for k in [k for k in d if k[0] == msg.pool_id]:
                            d.pop(k, None)
                    self.osdmap.epoch += 1
                    await self._commit_state()
            return MMapReply(osdmap=self.osdmap, tid=msg.tid)
        if isinstance(msg, MConfigSet):
            if not msg.remove:
                # validate against the option schema before replicating
                # (reference: `config set` rejects bad values at the mon)
                from ceph_tpu_torch.common.config import Config

                try:
                    Config().set(msg.key, msg.value)
                except ValueError as e:
                    return MConfigReply(tid=msg.tid, ok=False, error=str(e))
            if msg.remove:
                self.cluster_conf.pop(msg.key, None)
            else:
                self.cluster_conf[msg.key] = msg.value
            await self._commit_state()
            return MConfigReply(tid=msg.tid, values=dict(self.cluster_conf))
        raise ValueError(f"unhandled write {type(msg).__name__}")

    def _error_reply(self, msg: Any, error: str) -> Any:
        tid = getattr(msg, "tid", "")
        if isinstance(msg, (MCreatePool, MDeletePool)):
            return MCreatePoolReply(tid=tid, ok=False, error=error)
        if isinstance(msg, (MGetHealth, MHealthMute)):
            # no quorum IS a health statement: answer with what this mon
            # can see locally rather than timing the client out
            h = self.health_summary()
            h.setdefault("checks", {})["MON_NO_QUORUM"] = {
                "severity": "error", "summary": error}
            h["status"] = "HEALTH_ERR"
            return MHealthReply(tid=tid, health=h)
        if isinstance(msg, (MConfigSet, MSetFullRatio)):
            return MConfigReply(tid=tid, ok=False, error=error)
        if isinstance(msg, MLog):
            # last_seq 0 acks nothing: the LogClient resends next flush
            return MLogAck(who=msg.who, last_seq=0)
        if isinstance(msg, MCrashReport):
            return MCrashReportAck(tid=tid, ok=False)
        if isinstance(msg, MCrashQuery):
            return MCrashQueryReply(tid=tid, ok=False, error=error)
        if isinstance(msg, MCrushOp):
            return MCrushOpReply(tid=tid, ok=False, error=error,
                                 epoch=self.osdmap.epoch)
        if isinstance(msg, (MMarkDown, MGetMap, MPing, MOSDFailure,
                            MOSDPGTemp, MSetUpmap, MPoolSet, MOSDSetFlag,
                            MOsdMembership)):
            return MMapReply(osdmap=self.osdmap, tid=tid)
        if isinstance(msg, MOsdBoot):
            return MBootReply(osd_id=-1, osdmap=self.osdmap, tid=tid)
        return None

    async def _process_boot(self, msg: MOsdBoot) -> MBootReply:
        osd_id = msg.osd_id
        if osd_id < 0:
            osd_id = self._next_osd_id
            self._next_osd_id += 1
        info = self.osdmap.osds.get(osd_id)
        if info is None:
            self.osdmap.osds[osd_id] = OsdInfo(osd_id=osd_id, addr=tuple(msg.addr))
            self._crush_add_osd(osd_id)
        else:
            info.addr = tuple(msg.addr)
            info.up = True
            # auto-mark-in on boot — EXCEPT an admin-out OSD: the
            # operator's `osd out` survives the daemon's restarts until
            # an explicit `osd in` (reference noin discipline)
            info.in_cluster = osd_id not in self._admin_out
        self._down_since.pop(osd_id, None)  # auto-out hysteresis reset
        self._last_ping[osd_id] = time.monotonic()
        self.osdmap.epoch += 1
        self.logm.log("cluster", CLOG_INFO,
                      f"osd.{osd_id} boot (addr "
                      f"{msg.addr[0]}:{msg.addr[1]})")
        await self._commit_state()
        return MBootReply(osd_id=osd_id, osdmap=self.osdmap, tid=msg.tid,
                          cluster_conf=dict(self.cluster_conf))

    # -- pool / profile lifecycle -------------------------------------------

    def _crush_add_osd(self, osd_id: int) -> None:
        """Incrementally place a freshly-allocated OSD into the crush
        tree — topology-preserving: runtime `osd crush` surgery (moved
        hosts, operator buckets) survives later boots, unlike a
        from-scratch rebuild.  Default placement mirrors the old
        bootstrap shapes: under `host{id % crush_num_hosts}` when hosts
        are configured, else directly under the root."""
        crush = self.osdmap.crush
        if osd_id in crush.devices():
            return
        if crush.root_id == 0:
            crush.add_bucket("root", "default")
        n_hosts = int(self.conf.get("crush_num_hosts", 0) or 0)
        dest = crush.root_id
        if n_hosts:
            hname = f"host{osd_id % n_hosts}"
            host = crush.bucket_by_name(hname)
            if host is None:
                hid = crush.add_bucket("host", hname)
                crush.add_item(crush.root_id, hid, 0.0)
                host = crush.buckets[hid]
            dest = host.id
        info = self.osdmap.osds[osd_id]
        crush.add_item(dest, osd_id, osd_crush_weight(info))

    def _parse_crush_item(self, name: str) -> Optional[int]:
        """'osd.N' -> device id N; bucket name -> (negative) bucket id;
        None when the name resolves to nothing."""
        if name.startswith("osd."):
            try:
                return int(name[4:])
            except ValueError:
                return None
        b = self.osdmap.crush.bucket_by_name(name)
        return b.id if b is not None else None

    def _apply_crush_op(self, msg: MCrushOp) -> MCrushOpReply:
        """`ceph osd crush add-bucket/add/set/move/rm` (reference
        OSDMonitor prepare_command crush arms).  Validates fully before
        mutating — an error reply means the map is untouched."""
        crush = self.osdmap.crush
        ok = MCrushOpReply(tid=msg.tid, ok=True, epoch=self.osdmap.epoch)

        def err(e: str) -> MCrushOpReply:
            return MCrushOpReply(tid=msg.tid, ok=False, error=e,
                                 epoch=self.osdmap.epoch)

        if msg.op == "add-bucket":
            if not msg.name or not msg.bucket_type:
                return err("EINVAL: add-bucket needs <name> <type>")
            if msg.bucket_type == CrushMap.DEVICE_TYPE:
                return err("EINVAL: bucket type may not be 'osd'")
            if msg.name.startswith("osd.") \
                    or crush.bucket_by_name(msg.name) is not None:
                return err(f"EEXIST: {msg.name!r} already names an item")
            dest_id = crush.root_id
            if msg.dest:
                dest = self._parse_crush_item(msg.dest)
                if dest is None or dest >= 0:
                    return err(f"ENOENT: no bucket {msg.dest!r}")
                dest_id = dest
            bid = crush.add_bucket(msg.bucket_type, msg.name)
            # stored weight on the parent edge is informational — the
            # placement weight of a bucket is always its subtree sum
            crush.add_item(dest_id, bid, 0.0)
            self.logm.log("cluster", CLOG_INFO,
                          f"crush add-bucket {msg.name} "
                          f"({msg.bucket_type}) under "
                          f"{msg.dest or 'default'}")
            return ok

        if msg.op in ("add", "set"):
            item = self._parse_crush_item(msg.name)
            if item is None or item < 0:
                return err(f"EINVAL: {msg.op} places a device "
                           f"('osd.N'), got {msg.name!r}")
            if item not in self.osdmap.osds:
                return err(f"ENOENT: osd.{item} not in the osdmap")
            if msg.op == "add" and item in crush.devices():
                return err(f"EEXIST: osd.{item} already placed "
                           f"(use `crush set` or `crush move`)")
            dest_id = crush.root_id
            if msg.dest:
                dest = self._parse_crush_item(msg.dest)
                if dest is None or dest >= 0:
                    return err(f"ENOENT: no bucket {msg.dest!r}")
                dest_id = dest
            w = max(0.0, float(msg.weight))
            crush.move_item(item, dest_id, w)
            self.osdmap.osds[item].crush_weight = w
            self.logm.log("cluster", CLOG_INFO,
                          f"crush {msg.op} osd.{item} weight {w:g} "
                          f"under {msg.dest or 'default'}")
            return ok

        if msg.op == "move":
            item = self._parse_crush_item(msg.name)
            if item is None:
                return err(f"ENOENT: no item {msg.name!r}")
            if item < 0 and item not in crush.buckets:
                return err(f"ENOENT: no bucket {msg.name!r}")
            if item >= 0 and item not in crush.devices():
                return err(f"ENOENT: osd.{item} not in the crush map")
            if item == crush.root_id:
                return err("EINVAL: cannot move the root")
            dest = self._parse_crush_item(msg.dest)
            if dest is None or dest >= 0 or dest not in crush.buckets:
                return err(f"ENOENT: no destination bucket {msg.dest!r}")
            if item < 0 and (item == dest
                             or crush.in_subtree(item, dest)):
                return err(f"EINVAL: moving {msg.name} under "
                           f"{msg.dest} would create a cycle")
            if item >= 0:
                w = osd_crush_weight(self.osdmap.osds[item]) \
                    if item in self.osdmap.osds \
                    else crush.device_weights.get(item, 1.0)
            else:
                w = 0.0  # bucket placement weight = subtree sum
            crush.move_item(item, dest, w)
            self.logm.log("cluster", CLOG_INFO,
                          f"crush move {msg.name} -> {msg.dest}")
            return ok

        if msg.op == "rm":
            item = self._parse_crush_item(msg.name)
            if item is None:
                return err(f"ENOENT: no item {msg.name!r}")
            if item >= 0:
                if item not in crush.devices():
                    return err(f"ENOENT: osd.{item} not in the crush map")
                crush.remove_item(item)
                self.logm.log("cluster", CLOG_INFO,
                              f"crush rm osd.{item}")
                return ok
            if item not in crush.buckets:
                return err(f"ENOENT: no bucket {msg.name!r}")
            if item == crush.root_id:
                return err("EINVAL: cannot remove the root")
            bucket = crush.buckets[item]
            if bucket.items and not msg.force:
                return err(f"ENOTEMPTY: bucket {msg.name} holds "
                           f"{len(bucket.items)} item(s) "
                           f"(--force re-homes them to the parent)")
            parent = crush.parent_of(item) or crush.root_id
            rehomed = list(bucket.items)
            for child in rehomed:
                cw = (crush.device_weights.get(child, 1.0)
                      if child >= 0 else 0.0)
                crush.move_item(child, parent, cw)
            crush.remove_item(item)
            del crush.buckets[item]
            self.logm.log("cluster", CLOG_INFO,
                          f"crush rm bucket {msg.name}"
                          + (f" (forced, {len(rehomed)} re-homed)"
                             if rehomed else ""))
            return ok

        return err(f"EINVAL: unknown crush op {msg.op!r}")

    def _create_pool(self, msg: MCreatePool) -> MCreatePoolReply:
        try:
            return self._create_pool_inner(msg)
        except Exception as e:
            # a bad profile value must become an error reply, not a dead
            # mon connection (the serve loop only absorbs ConnectionError)
            return MCreatePoolReply(ok=False, error=f"{type(e).__name__}: {e}")

    def _create_pool_inner(self, msg: MCreatePool) -> MCreatePoolReply:
        if self.osdmap.pool_by_name(msg.name) is not None:
            return MCreatePoolReply(ok=False, error=f"pool {msg.name} exists")
        profile = dict(msg.profile)
        if msg.pool_type == "ec" and not profile:
            # profile-less `osd pool create NAME erasure` rides the
            # cluster default (reference osd_pool_default_erasure_code_
            # profile; same space-separated k=v encoding as the option)
            default = str(self.conf.get(
                "osd_pool_default_erasure_code_profile", "") or "")
            profile = dict(kv.split("=", 1)
                           for kv in default.split() if "=" in kv)
        if msg.pool_type == "ec":
            plugin = profile.get("plugin", "jerasure")
            try:
                # normalize_profile: factory+init round-trip validates and
                # completes the profile (defaults filled by the codec).  The
                # mon computes nothing with the codec, so a plugin=cuda one
                # is built on the CPU: its geometry is the jerasure
                # technique class's, and the mon needs no card
                codec = registry.factory(plugin, profile.get("directory", ""),
                                         profile, device="cpu")
            except ErasureCodeError as e:
                return MCreatePoolReply(ok=False, error=str(e))
            profile = dict(codec.get_profile())
            k = codec.get_data_chunk_count()
            size = codec.get_chunk_count()
            min_size = min(size, k + 1)
            stripe_width = k * codec.get_chunk_size(k * DEFAULT_STRIPE_UNIT)
        else:
            size = int(profile.get("size", "3"))
            min_size = max(1, size // 2 + 1)
            stripe_width = 0
        # profile wins; else the cluster-wide chooseleaf default
        fd = profile.get("crush-failure-domain") or str(
            self.conf.get("osd_crush_chooseleaf_type", "osd") or "osd")
        if fd != "osd" and not any(
            b.type == fd for b in self.osdmap.crush.buckets.values()
        ):
            # reference add_simple_rule errors on an unknown bucket type; a
            # rule over a nonexistent domain would place nothing, silently
            return MCreatePoolReply(
                ok=False,
                error=f"crush-failure-domain={fd}: no bucket of that type "
                      f"in the crush map (set crush_num_hosts?)",
            )
        pool_id = self._next_pool_id
        self._next_pool_id += 1
        rule = f"{msg.name}-rule"
        self.osdmap.crush.add_simple_rule(
            rule,
            failure_domain=fd,
            mode="indep" if msg.pool_type == "ec" else "firstn",
        )
        self.osdmap.pools[pool_id] = PoolInfo(
            pool_id=pool_id,
            name=msg.name,
            pool_type=msg.pool_type,
            pg_num=msg.pg_num,
            size=size,
            min_size=min_size,
            profile=profile,
            rule=rule,
            stripe_width=stripe_width,
            # the epoch this pool first APPEARS in: an OSD whose map
            # jumps past it knows the pool may already carry history
            # (osd _on_map catch-up peering)
            created_epoch=self.osdmap.epoch + 1,
        )
        self.osdmap.epoch += 1
        return MCreatePoolReply(ok=True, pool_id=pool_id)
