# Copy of ceph_tpu/common/config.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.  It adds ``osd_ec_device``,
# preloads the port's plugins (jerasure isa shec lrc clay cuda) by
# default, where the reference's last one is tpu, and has no
# ``osd_tier_slab_prewarm`` (the port's store compiles nothing per page
# geometry, so the option would be read by nothing).
"""Typed option tables + runtime config proxy.

Role-equivalent of the reference's md_config_t/ConfigProxy
(reference src/common/config.cc) and the YAML option schemas
(src/common/options/{global,mon,osd}.yaml.in): every option is declared once
with a type, default, level (basic/advanced/dev) and flags (startup options
cannot change at runtime; runtime options notify registered observers on
change).  Sources are layered the way the reference layers ceph.conf < env <
CLI < mon-centralized config: ``set_source(name, values)`` installs a source
at a priority, and effective values are resolved highest-priority-first.

Observers mirror md_config_obs_t (src/common/config_obs.h): a subscriber
names the keys it tracks and gets ``handle_conf_change(config, changed)``
callbacks, the mechanism ThreadPool uses to resize itself at runtime
(src/common/WorkQueue.h:44).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

OPT_STR = "str"
OPT_INT = "int"
OPT_FLOAT = "float"
OPT_BOOL = "bool"
OPT_SIZE = "size"  # accepts 4K/1M/2G suffixes
OPT_SECS = "secs"  # accepts 500ms/2s/1m suffixes

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

FLAG_STARTUP = "startup"  # read once at daemon start; runtime set -> error
FLAG_RUNTIME = "runtime"  # observers notified on change
FLAG_CLUSTER = "cluster"  # distributed via the ConfigMonitor

_SIZE_SUFFIX = {"": 1, "b": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                "t": 1 << 40}
_SECS_SUFFIX = {"": 1.0, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


@dataclass
class Option:
    name: str
    type: str = OPT_STR
    default: Any = None
    level: str = LEVEL_ADVANCED
    flags: Tuple[str, ...] = (FLAG_RUNTIME,)
    desc: str = ""
    min: Optional[float] = None
    max: Optional[float] = None
    enum_values: Tuple[str, ...] = ()

    def parse(self, value: Any) -> Any:
        if value is None:
            return None
        if self.type == OPT_STR:
            out: Any = str(value)
            if self.enum_values and out not in self.enum_values:
                raise ValueError(
                    f"{self.name}: {out!r} not in {sorted(self.enum_values)}"
                )
            return out
        if self.type == OPT_BOOL:
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s in ("1", "true", "yes", "on"):
                return True
            if s in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"{self.name}: bad bool {value!r}")
        if self.type == OPT_INT:
            out = int(value)
        elif self.type == OPT_FLOAT:
            out = float(value)
        elif self.type == OPT_SIZE:
            out = self._parse_suffixed(value, _SIZE_SUFFIX, int)
        elif self.type == OPT_SECS:
            out = self._parse_suffixed(value, _SECS_SUFFIX, float)
        else:
            raise ValueError(f"{self.name}: unknown option type {self.type}")
        if self.min is not None and out < self.min:
            raise ValueError(f"{self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ValueError(f"{self.name}: {out} > max {self.max}")
        return out

    def _parse_suffixed(self, value: Any, table: Dict[str, float], cast) -> Any:
        if isinstance(value, (int, float)):
            return cast(value)
        m = re.fullmatch(r"\s*([0-9.]+)\s*([a-zA-Z]*)\s*", str(value))
        if not m:
            raise ValueError(f"{self.name}: bad value {value!r}")
        suffix = m.group(2).lower().rstrip("ib") or m.group(2).lower()
        # allow 4K / 4KB / 4KiB; 500ms stays "ms"
        if suffix not in table:
            suffix = m.group(2).lower()
        if suffix not in table:
            raise ValueError(f"{self.name}: bad suffix in {value!r}")
        return cast(float(m.group(1)) * table[suffix])


def _opts(*options: Option) -> Dict[str, Option]:
    return {o.name: o for o in options}


# Default schema: the subset of the reference's option tables this framework
# consumes, same names where the semantic carries over
# (src/common/options/global.yaml.in, mon.yaml.in, osd.yaml.in).
DEFAULT_SCHEMA: Dict[str, Option] = _opts(
    # EC plugin machinery (global.yaml.in:437,2507,2516; mon.yaml.in:16)
    Option("erasure_code_dir", OPT_STR, "", flags=(FLAG_STARTUP,),
           desc="directory to dlopen native EC plugins from"),
    Option("osd_erasure_code_plugins", OPT_STR,
           "jerasure isa shec lrc clay cuda", flags=(FLAG_STARTUP,),
           desc="plugins preloaded at daemon start"),
    Option("osd_pool_default_erasure_code_profile", OPT_STR,
           "plugin=jerasure technique=reed_sol_van k=2 m=2"),
    Option("osd_pool_erasure_code_stripe_unit", OPT_SIZE, 4096),
    # messenger (global.yaml.in:1240-1265)
    Option("ms_inject_socket_failures", OPT_INT, 0, level=LEVEL_DEV),
    Option("ms_inject_delay_max", OPT_SECS, 0.0, level=LEVEL_DEV),
    Option("ms_crc_data", OPT_BOOL, True),
    Option("ms_local_fastpath", OPT_BOOL, False,
           desc="colocated vstart daemons skip the wire for same-process "
                "peers (implies ms_colocated_ring unless set explicitly)"),
    Option("ms_compress_min_size", OPT_SIZE, 0,
           desc="compress frames >= this size; 0 disables on-wire compression"),
    Option("ms_dispatch_throttle_bytes", OPT_SIZE, 100 << 20),
    Option("ms_trace_propagation", OPT_BOOL, True,
           desc="stamp trace-id/parent-span fields onto data-plane "
                "messages so cross-daemon spans stitch into one tree"),
    Option("ms_auth_secret", OPT_STR, "",
           desc="shared cluster secret; non-empty enables cephx-style frames"),
    # sharded multi-reactor wire plane (reference AsyncMessenger worker
    # pool, src/msg/async/AsyncMessenger.h ms_async_op_threads)
    Option("ms_async_op_threads", OPT_INT, 0, flags=(FLAG_STARTUP,),
           desc="reactor workers per messenger, each its own event loop "
                "owning a socket shard (0 = single-loop legacy path; "
                "in ms_reactor_mode=process, 0 defaults to 2 workers)"),
    Option("ms_reactor_mode", OPT_STR, "thread", flags=(FLAG_STARTUP,),
           desc="reactor worker substrate: 'thread' (N event-loop "
                "threads sharing the interpreter, the r13 plane) or "
                "'process' (forked wire workers, each owning its socket "
                "shard + its own wirepath arm; frames cross via "
                "shared-memory rings into the home-loop dispatch pump). "
                "The CEPH_TPU_REACTOR env overrides process-wide."),
    Option("ms_shm_ring_bytes", OPT_SIZE, 4 << 20, flags=(FLAG_STARTUP,),
           desc="per-direction shared-memory ring capacity of one "
                "process-delegated connection; oversized frames stream "
                "through in bounded pieces instead of deadlocking"),
    Option("ms_lanes_per_peer", OPT_INT, 1, flags=(FLAG_STARTUP,), min=1,
           desc="parallel lanes per peer session (negotiated; lane 0 is "
                "control-only, data stripes across the rest; 1 = single "
                "connection)"),
    Option("ms_lane_stripe_min", OPT_SIZE, 1 << 20,
           desc="blobs at least this large fragment across ALL data "
                "lanes concurrently (0 disables fragmentation)"),
    Option("ms_colocated_ring", OPT_BOOL, False,
           desc="negotiate a zero-serialization in-process ring with "
                "colocated peers at connect time (falls back to TCP)"),
    Option("ms_wirepath_native", OPT_BOOL, True, flags=(FLAG_STARTUP,),
           desc="run the messenger's per-byte hot loop (frame crc, "
                "scatter/gather, writev) through the released-GIL native "
                "wirepath when it builds; False forces the python arm "
                "(the CEPH_TPU_WIREPATH=0 env forces it process-wide)"),
    # auth (reference auth_supported / cephx ticket lifetime)
    Option("auth_cephx", OPT_BOOL, False,
           desc="require cephx-style ticket auth on daemon connections"),
    Option("auth_ticket_ttl", OPT_SECS, 3600.0,
           desc="service-ticket lifetime the mon seals into tickets"),
    # client / objecter (reference objecter_timeout, rados_osd_op_timeout)
    Option("client_name", OPT_STR, "",
           desc="entity name stamped on MOSDOp ops (QoS tenant identity; "
                "empty = anonymous, riding the pool default profile)"),
    Option("client_op_timeout", OPT_SECS, 10.0,
           desc="per-attempt op timeout before the client retargets"),
    Option("client_op_deadline", OPT_SECS, 0.0,
           desc="overall op deadline across retries (0 = retry forever)"),
    Option("client_backoff_base", OPT_SECS, 0.1,
           desc="first retry delay for retryable op errors"),
    Option("client_backoff_cap", OPT_SECS, 2.0,
           desc="retry delay ceiling (exponential backoff cap)"),
    Option("client_backoff_park_max", OPT_SECS, 3.0,
           desc="default park ceiling for an MOSDBackoff block whose "
                "unblock is lost (the server's duration wins when set)"),
    Option("client_linger_poll", OPT_SECS, 1.0,
           desc="watch re-register / linger ping cadence"),
    # mgr (reference mgr module tick / target per-PG object count)
    Option("mgr_addr", OPT_STR, "",
           desc="host:port the mgr's metrics endpoint binds (daemons "
                "learn it via the centralized config)"),
    Option("mgr_balancer", OPT_BOOL, False,
           desc="enable the upmap balancer module"),
    Option("mgr_pg_autoscaler", OPT_BOOL, False,
           desc="enable the pg_num autoscaler module"),
    Option("mgr_module_interval", OPT_SECS, 5.0,
           desc="mgr module tick cadence (balancer/autoscaler)"),
    Option("mgr_health_interval", OPT_SECS, 1.0,
           desc="mgr health-poll cadence against the mon"),
    Option("mgr_target_objects_per_pg", OPT_INT, 32,
           desc="autoscaler split threshold, objects per PG"),
    # mon (reference mon_osd_min_down_reporters / reporter grace)
    Option("mon_osd_report_grace", OPT_SECS, 1.5,
           desc="seconds without a ping before the mon marks an OSD down"),
    Option("mon_osd_min_down_reporters", OPT_INT, 1,
           desc="distinct OSD failure reports required before the mon "
                "marks the target down ahead of its own grace"),
    Option("mon_osd_down_out_interval", OPT_SECS, 0.6,
           desc="seconds an OSD stays down before the mon auto-marks it "
                "out (0 disables auto-out; the `noout` osdmap flag and "
                "mon_osd_min_in_ratio both gate the transition)"),
    Option("mon_osd_min_in_ratio", OPT_FLOAT, 0.0, min=0.0,
           desc="auto-out floor: the mon refuses to auto-out an OSD when "
                "the in-fraction of the cluster would drop below this "
                "(a partition must not auto-out half the map; 0 disables "
                "— test-scaled default, the reference ships 0.75)"),
    Option("osd_crush_chooseleaf_type", OPT_STR, "osd",
           desc="default crush failure domain for new pool rules when "
                "the profile names none (chooseleaf bucket type; 'osd' "
                "keeps device-level placement)"),
    Option("crush_num_hosts", OPT_INT, 0,
           desc="vstart: spread OSDs over this many synthetic hosts in "
                "the crush map (0 = flat osd-level map)"),
    Option("admin_socket_dir", OPT_STR, "", flags=(FLAG_STARTUP,),
           desc="directory for per-daemon asok sockets; empty disables "
                "the admin socket"),
    # osd
    Option("osd_heartbeat_interval", OPT_SECS, 0.3),
    Option("osd_heartbeat_grace", OPT_SECS, 2.0),
    Option("osd_auto_repair", OPT_BOOL, True),
    Option("osd_repair_delay", OPT_SECS, 0.5),
    Option("osd_repair_full_sweep", OPT_BOOL, True,
           desc="repair re-peers with a forced backfill sweep (full "
                "listing) instead of log-only recovery"),
    Option("osd_op_num_shards", OPT_INT, 4),
    Option("osd_op_queue", OPT_STR, "wpq", enum_values=("wpq", "mclock")),
    Option("osd_pg_op_concurrency", OPT_INT, 4,
           desc="per-PG chain width: ops on one PG beyond this queue"),
    Option("osd_min_pg_log_entries", OPT_INT, 500,
           desc="PG log tail retained past the last-complete horizon"),
    Option("osd_max_backfills", OPT_INT, 4,
           desc="concurrent backfill reservations an OSD grants (the "
                "AsyncReserver slot count)"),
    Option("osd_backfill_reserve_lease", OPT_SECS, 300.0,
           desc="remote backfill reservation auto-expiry (a primary that "
                "died holding a slot cannot wedge the target forever)"),
    Option("osd_recovery_retry", OPT_SECS, 1.0,
           desc="retry cadence for recovery steps parked on missing "
                "peers or reservations"),
    Option("osd_backoff_secs", OPT_SECS, 0.5,
           desc="base MOSDBackoff block duration for a busy PG"),
    Option("osd_backoff_max", OPT_SECS, 3.0,
           desc="MOSDBackoff block duration ceiling under escalation"),
    Option("osd_deep_scrub_interval", OPT_SECS, 3600.0,
           desc="auto deep-scrub cadence per PG (osd_scrub_auto)"),
    Option("osd_auto_revert_unfound", OPT_BOOL, True,
           desc="auto-revert objects confirmed unfound to their rollback "
                "version (mark_unfound_lost revert role)"),
    Option("osd_unfound_revert_grace", OPT_SECS, 30.0,
           desc="how long an object must stay unfound (over complete "
                "listings) before auto-revert"),
    # EC device service (ceph_tpu_torch/parallel seams)
    Option("osd_ec_stripe_unit", OPT_SIZE, 4096,
           desc="per-chunk stripe unit EC pools default to"),
    Option("osd_ec_batching", OPT_BOOL, True,
           desc="route codec work through the process-shared "
                "BatchingQueue (device dispatch coalescing)"),
    Option("osd_ec_device", OPT_STR, "cuda", flags=(FLAG_STARTUP,),
           desc="torch device of the OSD's EC queue and resident store: "
                "'cuda' (the card, the default; a daemon fails at start "
                "without one) or 'cpu' (named explicitly, for hosts "
                "without a card: then the queue engages only under "
                "CEPH_TPU_FORCE_BATCH=1)"),
    Option("osd_ec_dispatch_timeout", OPT_SECS, 0.0,
           desc="BatchingQueue device-dispatch watchdog (0 disables); "
                "trips the circuit breaker on a wedged device"),
    Option("osd_ec_planar_residency", OPT_BOOL, True,
           desc="keep encoded shard rows planar-resident on the device "
                "(PlanarShardStore cache tier)"),
    Option("osd_ec_planar_bytes", OPT_SIZE, 0,
           desc="planar residency byte budget (0 = store default)"),
    # multi-tenant QoS (reference mClockScheduler client profiles; pool
    # opts qos_reservation/qos_weight/qos_limit + qos_class:<name>
    # override these cluster defaults per pool)
    Option("osd_backoff_queue_depth", OPT_INT, 0,
           desc="sharded-queue depth past which arriving client ops are "
                "shed via MOSDBackoff (0 disables); with client "
                "identities the shed targets the most over-limit client"),
    Option("osd_qos_default_reservation", OPT_FLOAT, 100.0,
           desc="per-client guaranteed ops/sec when the pool declares "
                "no qos_reservation"),
    Option("osd_qos_default_weight", OPT_FLOAT, 10.0,
           desc="per-client share of surplus when the pool declares no "
                "qos_weight"),
    Option("osd_qos_default_limit", OPT_FLOAT, 0.0,
           desc="per-client ops/sec cap when the pool declares no "
                "qos_limit (0 = unlimited)"),
    Option("osd_qos_cost_per_io", OPT_SIZE, 65536,
           desc="bytes of op payload that cost one extra IOPS unit in "
                "the dmClock tags (byte-COST: a B-byte op tags as "
                "1 + B/this; 0 = pure per-op tagging)"),
    Option("osd_qos_arrears_cap", OPT_FLOAT, 2.0,
           desc="ceiling (seconds) on a client's accumulated over-limit "
                "arrears — bounds how long a quieted flooder stays "
                "shed-eligible"),
    Option("osd_qos_shed_grace", OPT_FLOAT, 0.25,
           desc="seconds of over-limit arrears a client may accumulate "
                "before the saturation shed targets it"),
    Option("osd_mclock_max_clients", OPT_INT, 1024,
           desc="per-shard bound on per-client dmClock states (idle "
                "states pruned oldest-first)"),
    Option("osd_mclock_profile", OPT_STR, "balanced",
           enum_values=("balanced", "high_client_ops",
                        "high_recovery_ops"),
           desc="background dmClock profile set: how the mClock "
                "scheduler splits IOPS between client, recovery, "
                "rebalance, scrub and best-effort classes "
                "(mclock_<class>_res/wgt/lim/burst override "
                "individual values)"),
    Option("osd_qos_burst_allowance", OPT_FLOAT, 0.0,
           desc="default rho/delta burst credit (seconds) a client "
                "profile banks while idle when the pool declares no "
                "qos_burst — burst*rate immediately-eligible ops"),
    Option("osd_qos_normalize_spread", OPT_BOOL, True,
           desc="divide per-client reservation/limit by the pool's "
                "primary spread so a tenant served by N OSDs gets its "
                "nominal profile cluster-wide instead of N x it"),
    Option("osd_background_qos", OPT_BOOL, True,
           desc="route backfill/recovery/scrub per-object work through "
                "the sharded op queue under background dmClock classes "
                "(off: background sweeps run unthrottled)"),
    Option("osd_qos_max_clients", OPT_INT, 4096,
           desc="bound on the admission tracker's per-client states"),
    # op tracking + slow-op health (reference osd_op_complaint_time /
    # osd_op_history_size, TrackedOp.h)
    Option("osd_op_complaint_time", OPT_SECS, 2.0,
           desc="ops older than this raise SLOW_OPS and join the "
                "historic slow ring"),
    Option("osd_op_history_size", OPT_INT, 64,
           desc="completed ops retained by dump_historic_ops"),
    Option("osd_op_history_slow_size", OPT_INT, 64,
           desc="slow completions retained by dump_historic_slow_ops"),
    Option("osd_op_tracker_max_events", OPT_INT, 128,
           desc="timeline events retained per tracked op (bound against "
                "stuck-op timeline growth)"),
    Option("osd_scrub_auto", OPT_BOOL, False),
    # cache tier (osd.yaml.in osd_tier_promote_max_*; pg_pool_t
    # hit_set_*/target_max_bytes/cache_target_full_ratio defaults —
    # pool opts set via `pool set` override these per pool)
    Option("osd_tier_enabled", OPT_BOOL, True,
           desc="record read hits and manage device residency as a "
                "cache tier"),
    Option("osd_hit_set_period", OPT_SECS, 2.0,
           desc="seconds of reads each hit-set interval covers"),
    Option("osd_hit_set_count", OPT_INT, 8,
           desc="archived hit-set intervals retained per PG"),
    Option("osd_hit_set_fpp", OPT_FLOAT, 0.05,
           desc="bloom hit-set target false-positive rate"),
    Option("osd_hit_set_target_size", OPT_INT, 128,
           desc="expected inserts a hit-set interval is sized for"),
    Option("osd_min_read_recency_for_promote", OPT_INT, 1,
           desc="consecutive newest hit sets an object must appear in "
                "before a read promotes it (0 = always)"),
    Option("osd_min_write_recency_for_promote", OPT_INT, 1,
           desc="consecutive newest hit sets an object must appear in "
                "before a write installs a resident (0 = always; the "
                "r10 behavior was an unconditional install)"),
    Option("osd_tier_pagestore", OPT_BOOL, True,
           desc="back the residency tier with the paged store "
                "(page table + ragged tails + dirty bits) instead of "
                "monolithic per-object buffers"),
    Option("osd_tier_page_bytes", OPT_SIZE, 64 << 10,
           desc="page size of the paged resident store (u32-word "
                "pages; eviction and dirty tracking are per page)"),
    Option("osd_tier_device_slab", OPT_BOOL, True,
           desc="allow the paged resident store's device arm "
                "(jax.Array sub-slabs, jitted in-place installs and "
                "gathers) when a real device backend is live; false "
                "pins the host-numpy arm. CEPH_TPU_DEVICE_SLAB=1/0 "
                "overrides in either direction"),
    Option("osd_tier_cache_mode", OPT_STR, "writethrough",
           desc="default cache mode for tiered pools (pool opt "
                "cache_mode overrides): writethrough applies local "
                "shards synchronously, writeback defers them to dirty "
                "pages flushed by the agent"),
    Option("osd_cache_min_size", OPT_INT, 2,
           desc="writeback fast-ack quorum: a put acks once the raw "
                "dirty object is committed on this many cache-tier "
                "processes (primary + min_size-1 acting peers); fewer "
                "live acting members falls back to synchronous "
                "writethrough for that op"),
    Option("osd_cache_target_dirty_ratio", OPT_FLOAT, 0.4,
           desc="agent flushes dirty pages when dirty bytes exceed "
                "this fraction of the tier target"),
    Option("osd_tier_flush_age", OPT_SECS, 5.0,
           desc="dirty residents older than this flush on the next "
                "agent pass regardless of the dirty ratio (0 = "
                "ratio/pressure-driven only)"),
    Option("osd_tier_full_target_factor", OPT_FLOAT, 0.5,
           desc="fullness pressure: NEARFULL or worse on the backing "
                "store scales the tier's effective target by this "
                "factor (and forces dirty flush ahead of eviction)"),
    Option("osd_tier_promote_max_objects_sec", OPT_INT, 32,
           desc="promotion rate ceiling, objects/sec (0 = unthrottled)"),
    Option("osd_tier_promote_max_bytes_sec", OPT_SIZE, 64 << 20,
           desc="promotion rate ceiling, bytes/sec (0 = unthrottled)"),
    Option("osd_tier_target_max_bytes", OPT_SIZE, 0,
           desc="resident byte budget the tier agent enforces "
                "(0 = the planar store's capacity)"),
    Option("osd_cache_target_full_ratio", OPT_FLOAT, 0.8,
           desc="agent evicts when resident bytes exceed this fraction "
                "of the target"),
    Option("osd_tier_agent_interval", OPT_SECS, 0.5,
           desc="tier agent due-scan cadence (0 disables the agent)"),
    # the one name the OSD actually reads (the old *_probability/
    # *_duration pair was never consumed — a lint dead-option finding):
    # seconds every BatchingQueue device dispatch sleeps, aging in-flight
    # ops past the SLOW_OPS complaint threshold in CI
    Option("osd_debug_inject_dispatch_delay", OPT_SECS, 0.0,
           level=LEVEL_DEV),
    # capacity / fullness plane (reference mon_osd_nearfull_ratio /
    # backfillfull / full ratios in the OSDMap + osd_failsafe_full_ratio;
    # the mon derives per-OSD NEARFULL/BACKFILLFULL/FULL states from the
    # statfs piggybacked on liveness pings)
    Option("osd_store_capacity_bytes", OPT_SIZE, 0,
           desc="byte ceiling every object store reports via statfs "
                "(0 = unlimited, the pre-capacity behavior); "
                "vstart seeds each OSD's store from it"),
    Option("osd_failsafe_full_ratio", OPT_FLOAT, 0.97,
           desc="last-resort store guard: a write that would push used "
                "bytes past this fraction of capacity is refused with a "
                "typed ENOSPC BEFORE anything mutates"),
    Option("mon_osd_nearfull_ratio", OPT_FLOAT, 0.85,
           desc="default nearfull ratio seeded into new OSDMaps "
                "(`ceph osd set-nearfull-ratio` overrides live)"),
    Option("mon_osd_backfillfull_ratio", OPT_FLOAT, 0.90,
           desc="default backfillfull ratio seeded into new OSDMaps "
                "(backfill reservations refuse onto OSDs past it)"),
    Option("mon_osd_full_ratio", OPT_FLOAT, 0.95,
           desc="default full ratio seeded into new OSDMaps (writes to "
                "PGs with a FULL acting member fail typed ENOSPC; "
                "deletes are exempt)"),
    Option("mon_osd_full_hysteresis", OPT_FLOAT, 0.01,
           desc="utilization must drop this far below a fullness "
                "threshold before the mon auto-clears the state "
                "(flap damping on the ping cadence)"),
    Option("osd_backfill_toofull_retry", OPT_SECS, 1.0,
           desc="retry cadence for a backfill parked on a BACKFILLFULL "
                "target (resumes when the target frees space)"),
    Option("osd_debug_inject_full", OPT_STR, "", level=LEVEL_DEV,
           desc="force reported utilization: 'RATIO' (this OSD) or "
                "'ID:RATIO[,ID:RATIO...]' — drives the fullness ladder "
                "in CI without writing gigabytes "
                "(CEPH_TPU_INJECT_FULL env equivalent)"),
    # objectstore
    Option("bluestore_csum_type", OPT_STR, "crc32c",
           enum_values=("none", "crc32c")),
    Option("bluestore_debug_inject_read_err", OPT_BOOL, False, level=LEVEL_DEV),
    Option("bluestore_debug_inject_csum_err_probability", OPT_FLOAT, 0.0,
           level=LEVEL_DEV),
    Option("bluestore_prefer_deferred_size", OPT_SIZE, 32768),
    # on-disk compression (reference bluestore_compression_* options;
    # per-pool compression_* opts override these store-wide defaults)
    Option("bluestore_compression_mode", OPT_STR, "none",
           enum_values=("none", "passive", "aggressive", "force")),
    Option("bluestore_compression_algorithm", OPT_STR, "zlib"),
    Option("bluestore_compression_min_blob_size", OPT_SIZE, 4096),
    Option("bluestore_compression_required_ratio", OPT_FLOAT, 0.875,
           desc="keep the compressed blob only when it shrinks to at "
                "most this fraction of the raw bytes"),
    # mon
    Option("mon_lease", OPT_SECS, 5.0),
    Option("mon_election_timeout", OPT_SECS, 1.0),
    # logging (src/common/dout.h per-subsys levels; all RUNTIME-mutable —
    # `ceph tell <daemon> config set debug_ms 10` / asok `config set` is
    # the live-diagnosis workflow, the Log level cache invalidates via a
    # debug_* observer)
    Option("log_max_recent", OPT_INT, 500),
    Option("debug_osd", OPT_INT, 1, level=LEVEL_DEV),
    Option("debug_mon", OPT_INT, 1, level=LEVEL_DEV),
    Option("debug_ms", OPT_INT, 0, level=LEVEL_DEV),
    Option("debug_ec", OPT_INT, 1, level=LEVEL_DEV),
    Option("debug_bluestore", OPT_INT, 1, level=LEVEL_DEV),
    Option("debug_client", OPT_INT, 1, level=LEVEL_DEV),
    Option("debug_clog", OPT_INT, 1, level=LEVEL_DEV,
           desc="local-log mirror level of cluster-log entries"),
    # cluster log + crash telemetry (reference mon_cluster_log_*,
    # mon_client_log_interval, mgr/crash warn_recent_interval)
    Option("mon_cluster_log_entries", OPT_INT, 500,
           desc="cluster-log tail the mon retains (paxos-replicated; "
                "`ceph log last` serves from it)"),
    Option("mon_client_log_interval", OPT_SECS, 0.25,
           desc="LogClient flush cadence; errors flush immediately"),
    Option("clog_max_pending", OPT_INT, 2048,
           desc="unacked cluster-log entries a daemon holds before "
                "dropping oldest (drop count kept)"),
    Option("mon_crash_warn_age", OPT_SECS, 14 * 24 * 3600.0,
           desc="unarchived crashes newer than this raise RECENT_CRASH"),
    Option("mon_crash_max", OPT_INT, 64,
           desc="crash reports the mon retains (oldest pruned)"),
    Option("mon_crash_recent_max_bytes", OPT_SIZE, 32 << 10,
           desc="per-crash dump_recent ring byte budget in the mon's "
                "registry (newest entries kept; the registry rides "
                "every paxos snapshot)"),
    Option("crash_dir", OPT_STR, "", flags=(FLAG_STARTUP,),
           desc="spool dir for crash reports the mon could not take "
                "(replayed at next boot); empty disables spooling"),
    Option("osd_debug_inject_crash", OPT_BOOL, False, level=LEVEL_DEV,
           desc="raise a fatal exception in the OSD's next ping tick "
                "(crash-telemetry CI gate)"),
)


class Config:
    """Layered, observable, typed config (ConfigProxy role).

    Unknown keys are accepted as untyped passthrough values so subsystem
    experiments don't need schema edits first (the reference requires
    declarations; we degrade to OPT_STR-like behavior and flag them in
    ``show()``).
    """

    # source priorities, low to high (mon-centralized beats file, CLI beats all)
    SOURCES = ("default", "file", "env", "mon", "override", "cli")

    def __init__(self, values: Optional[Dict[str, Any]] = None,
                 schema: Optional[Dict[str, Option]] = None):
        self.schema: Dict[str, Option] = dict(schema or DEFAULT_SCHEMA)
        self._sources: Dict[str, Dict[str, Any]] = {s: {} for s in self.SOURCES}
        self._observers: List[Tuple[Callable, Tuple[str, ...]]] = []
        self._started = False
        if values:
            self.set_source("override", values)

    # -- resolution ----------------------------------------------------------

    def get(self, name: str, default: Any = None) -> Any:
        opt = self.schema.get(name)
        for source in reversed(self.SOURCES):
            if name in self._sources[source]:
                raw = self._sources[source][name]
                return opt.parse(raw) if opt else raw
        if opt is not None:
            return opt.default
        return default

    def __contains__(self, name: str) -> bool:
        return any(name in vals for vals in self._sources.values()) or name in self.schema

    def show(self) -> Dict[str, Any]:
        """Effective values for every known + set key, schema'd or not."""
        names: Set[str] = set(self.schema)
        for vals in self._sources.values():
            names |= set(vals)
        return {n: self.get(n) for n in sorted(names)}

    def diff(self) -> Dict[str, Any]:
        """Keys whose effective value differs from the schema default."""
        out = {}
        for name, value in self.show().items():
            opt = self.schema.get(name)
            if opt is None or value != opt.default:
                out[name] = value
        return out

    # -- mutation ------------------------------------------------------------

    def mark_started(self) -> None:
        """Daemon finished global_init: startup-flagged options freeze."""
        self._started = True

    def set(self, name: str, value: Any, source: str = "cli") -> None:
        opt = self.schema.get(name)
        if opt is not None:
            if self._started and FLAG_STARTUP in opt.flags:
                raise ValueError(f"{name} can only be set at daemon startup")
            opt.parse(value)  # validate eagerly
        old = self.get(name)
        self._sources[source][name] = value
        if self.get(name) != old:
            self._notify({name})

    def rm(self, name: str, source: str = "cli") -> None:
        old = self.get(name)
        self._sources[source].pop(name, None)
        if self.get(name) != old:
            self._notify({name})

    def set_source(self, source: str, values: Dict[str, Any]) -> None:
        """Install/replace a whole source layer (e.g. a mon config epoch).
        Values are validated BEFORE the swap so a bad pushed value can't
        poison the layer."""
        if source not in self._sources:
            raise ValueError(f"unknown config source {source}")
        for k, v in values.items():
            opt = self.schema.get(k)
            if opt is not None:
                opt.parse(v)
        before = {k: self.get(k) for k in set(self._sources[source]) | set(values)}
        self._sources[source] = dict(values)
        changed = {k for k, v in before.items() if self.get(k) != v}
        if changed:
            self._notify(changed)

    # -- observers -----------------------------------------------------------

    def add_observer(self, handler: Callable[["Config", Set[str]], None],
                     keys: Iterable[str]) -> None:
        self._observers.append((handler, tuple(keys)))

    def remove_observer(self, handler: Callable) -> None:
        self._observers = [(h, k) for h, k in self._observers if h is not handler]

    def _notify(self, changed: Set[str]) -> None:
        for handler, keys in list(self._observers):
            hit = changed & set(keys)
            # a trailing-* key subscribes to a PREFIX (the debug_* family:
            # per-subsystem level options are open-ended, and the log's
            # level cache must invalidate on any of them)
            for k in keys:
                if k.endswith("*"):
                    hit |= {c for c in changed if c.startswith(k[:-1])}
            if hit:
                handler(self, hit)

    # -- parsing helpers -----------------------------------------------------

    @classmethod
    def from_conf_file(cls, text: str) -> "Config":
        """Parse a minimal ceph.conf-style ini (global section only for now)."""
        cfg = cls()
        values: Dict[str, Any] = {}
        for line in text.splitlines():
            line = line.split("#", 1)[0].split(";", 1)[0].strip()
            if not line or line.startswith("["):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                values[k.strip().replace(" ", "_")] = v.strip()
        cfg.set_source("file", values)
        return cfg
