# Copy of ceph_tpu/tools/non_regression.py at commit 38c1795, with its
# ceph_tpu references rebound to ceph_tpu_torch.  Where the two differ:
# ``--device`` (default ``cuda``; ``cpu`` must be named) is where the codec
# runs and every gate's OSDs run theirs (``osd_ec_device``), and the slab
# parity children get it too; ``--check --plugin cuda`` replays the
# ``plugin=tpu`` archive of the same profile when ``--base`` holds no
# ``plugin=cuda`` one (the tpu archive's chunks are jerasure reed_sol_van's,
# which plugin=cuda's are too); --device-parity prints each child's store
# counters on a line of its own; and a gate's process stops the batching
# queue its OSDs shared before it exits.
"""Non-regression corpus tool: byte-exactness of encodings over time.

Equivalent of the reference's ceph_erasure_code_non_regression
(reference src/test/erasure-code/ceph_erasure_code_non_regression.cc):

    --create  writes <base>/<profile-keyed dir>/{content,0,1,...} with the
              stripe content and every encoded chunk;
    --check   re-encodes the stored content and memcmps every chunk
              (non_regression.cc:252-266), then verifies decode with one
              erasure and with two erasures (:268-284).

The profile-keyed directory name is "plugin=<p> stripe-width=<w> k=v ..."
exactly like the reference (non_regression.cc:116-136), so corpora created
by older versions of this tree keep checking against newer code — the
mechanism that enforces the "parity byte-exact across releases" property.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="erasure code non-regression corpus")
    p.add_argument("--stripe-width", type=int, default=4096)
    p.add_argument("--plugin", default="jerasure")
    p.add_argument("--base", default=".")
    p.add_argument("--parameter", "-P", action="append", default=[])
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device the codec and the gates' OSDs run on: "
                        "cuda, cuda:N or cpu")
    # wire-throughput floor (warn-only): compare a fresh BENCH record's
    # daemon_wire_put/get_MBps against the previous round's record
    p.add_argument("--wire-floor", action="store_true")
    p.add_argument("--bench", default="", help="current BENCH json")
    p.add_argument("--prev", default="", help="previous round's BENCH json")
    p.add_argument("--floor", type=float, default=0.8,
                   help="warn when current < floor * previous")
    # chaos smoke (CI): short injected-failure put/get loop against an
    # in-process cluster; exit nonzero on ANY acked-op failure
    p.add_argument("--chaos", action="store_true")
    p.add_argument("--chaos-seconds", type=float, default=6.0,
                   help="length of the chaos put/get loop")
    p.add_argument("--chaos-osds", type=int, default=4)
    # slow-op health smoke (CI): injected dispatch delay must RAISE
    # SLOW_OPS while ops age and the check must CLEAR after recovery;
    # nonzero exit if it never surfaces or wedges raised once idle
    p.add_argument("--slow-ops", action="store_true")
    p.add_argument("--slow-seconds", type=float, default=10.0,
                   help="ceiling on the wait for SLOW_OPS to raise")
    p.add_argument("--slow-osds", type=int, default=3)
    # QoS isolation gate (CI): 3-tenant chaos loop (reserved /
    # best-effort / flooding past its limit) — exit nonzero unless the
    # flooder is the one backoff-shed, the reserved tenant has ZERO
    # acked-op failures, and its p99 stays bounded vs its solo run
    p.add_argument("--qos", action="store_true")
    p.add_argument("--qos-seconds", type=float, default=3.0,
                   help="length of each qos traffic window")
    p.add_argument("--qos-osds", type=int, default=4)
    # crash-telemetry gate (CI): inject a fatal exception into one OSD
    # of a live cluster; a crash report must land in `ceph crash ls`
    # (with the dump_recent ring), RECENT_CRASH must raise in health and
    # clear on `crash archive`, and the cluster log must show the
    # daemon death — nonzero exit otherwise
    p.add_argument("--crash", action="store_true")
    p.add_argument("--crash-seconds", type=float, default=15.0,
                   help="ceiling on each crash-plane wait")
    p.add_argument("--crash-osds", type=int, default=3)
    # tier smoke (CI): promote/evict/read loop against an in-process
    # cluster; exit nonzero on ANY content mismatch between a
    # resident-hit read and the cold decode path for the same object
    p.add_argument("--tier", action="store_true")
    p.add_argument("--tier-seconds", type=float, default=6.0,
                   help="length of the tier promote/evict/read loop")
    p.add_argument("--tier-osds", type=int, default=3)
    # fullness-ladder gate (CI, FAILING): drive nearfull -> backfillfull
    # -> full -> failsafe against a live cluster (injection + a real
    # capacity-bounded store); typed ENOSPC on writes, reads/deletes
    # served, zero acked-op loss, auto-clear after the drain, backfill
    # completing after a backfillfull target frees space
    p.add_argument("--full", action="store_true")
    p.add_argument("--full-seconds", type=float, default=12.0,
                   help="ceiling on each fullness-ladder wait")
    p.add_argument("--full-osds", type=int, default=4)
    # elastic-membership coexistence gate (CI, FAILING): an out ->
    # backfill -> in -> reweight cycle with CONCURRENT deep scrub and
    # reserved-tenant client traffic — zero acked-op loss, byte-identical
    # data after convergence, reserved p99 bounded vs its solo run,
    # plus backfill parking at a backfillfull target and resuming when
    # space frees
    p.add_argument("--rebalance", action="store_true")
    p.add_argument("--rebalance-seconds", type=float, default=20.0,
                   help="ceiling on each membership-cycle wait")
    p.add_argument("--rebalance-osds", type=int, default=4)
    # node-lifecycle thrash (CI): the full membership arc — add a host
    # bucket, crush move, rebalance converges, kill an OSD, auto-out
    # fires (noout honored first), drain, safe-to-destroy flips green,
    # purge, byte-identity sweep — under client traffic with zero
    # acked-op loss, FAILING on any step
    p.add_argument("--lifecycle", action="store_true")
    p.add_argument("--lifecycle-seconds", type=float, default=25.0,
                   help="ceiling on each lifecycle-step wait")
    p.add_argument("--lifecycle-osds", type=int, default=5)
    # pagestore slab-arm parity (CI): the writeback
    # dirty->flush->evict->cold-re-read cycle run once per slab arm
    # (CEPH_TPU_DEVICE_SLAB=1 child vs =0 child, same deterministic
    # content), digests compared byte-for-byte — the device-arm
    # byte-identity gate, FAILING on any divergence
    p.add_argument("--device-parity", action="store_true")
    p.add_argument("--device-parity-child", action="store_true",
                   help="internal: one slab arm's writeback cycle "
                        "(arm picked by CEPH_TPU_DEVICE_SLAB)")
    return p.parse_args(argv)


def profile_directory(args) -> str:
    name = f"plugin={args.plugin} stripe-width={args.stripe_width}"
    for kv in args.parameter:
        name += " " + kv
    return os.path.join(args.base, name)


def build(args):
    from ceph_tpu_torch.ec.registry import registry
    from ceph_tpu_torch.tools import parse_parameters

    profile = {"plugin": args.plugin}
    profile.update(parse_parameters(args.parameter))
    return registry.factory(args.plugin, "", profile, device=args.device)


def archive_directory(args) -> str:
    """The archive --check replays: the profile's own directory, or for
    plugin=cuda the plugin=tpu one of the same profile when --base holds
    no plugin=cuda archive."""
    directory = profile_directory(args)
    if args.plugin == "cuda" and not os.path.isdir(directory):
        tpu = profile_directory(argparse.Namespace(
            **dict(vars(args), plugin="tpu")))
        if os.path.isdir(tpu):
            return tpu
    return directory


def _cluster(args, n_osds: int, conf: dict):
    """A gate's in-process cluster, its OSDs' codecs on --device."""
    from ceph_tpu_torch.rados.vstart import Cluster

    return Cluster(n_osds=n_osds, conf=dict(conf, osd_ec_device=args.device))


def run_create(args) -> int:
    codec = build(args)
    directory = profile_directory(args)
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0xEC)
    content = rng.integers(0, 256, size=args.stripe_width, dtype=np.uint8).tobytes()
    with open(os.path.join(directory, "content"), "wb") as f:
        f.write(content)
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), content)
    for chunk, buf in encoded.items():
        with open(os.path.join(directory, str(chunk)), "wb") as f:
            f.write(bytes(buf))
    return 0


def _check_decode(codec, encoded, erasures) -> int:
    available = {c: b for c, b in encoded.items() if c not in erasures}
    chunk_size = len(next(iter(encoded.values())))
    decoded = codec.decode(set(erasures), available, chunk_size)
    for c in erasures:
        if not np.array_equal(decoded[c], encoded[c]):
            print(f"chunk {c} incorrectly recovered", file=sys.stderr)
            return 1
    return 0


def run_check(args) -> int:
    codec = build(args)
    directory = archive_directory(args)
    try:
        with open(os.path.join(directory, "content"), "rb") as f:
            content = f.read()
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), content)
    for chunk, buf in encoded.items():
        try:
            with open(os.path.join(directory, str(chunk)), "rb") as f:
                existing = f.read()
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 1
        if existing != bytes(buf):
            print(f"chunk {chunk} encodes differently", file=sys.stderr)
            return 1
    # single erasure: the specific fast path in every plugin
    code = _check_decode(codec, encoded, {0})
    if code:
        return code
    if codec.get_coding_chunk_count() > 1:
        # two erasures: the general case
        code = _check_decode(codec, encoded, {0, n - 1})
        if code:
            return code
    return 0


def _bench_metrics(path: str) -> dict:
    """Flatten a BENCH record: either the raw `bench.py` output dict or
    the round-trajectory shape {"parsed": {...}} the driver archives."""
    import json

    with open(path) as f:
        rec = json.load(f)
    if isinstance(rec, dict) and isinstance(rec.get("parsed"), dict):
        rec = rec["parsed"]
    return rec if isinstance(rec, dict) else {}


def run_wire_floor(args) -> int:
    """FAILING daemon-wire gate, two halves:

    1. Throughput floor: the fresh BENCH record's
       daemon_wire_put/get_MBps against the previous round's — a
       wire-path regression fails CI the round it lands (promoted from
       warn-only now that the multi-lane plane moves the numbers the
       repo's claims rest on).  Skipped when no records are supplied.
    2. Lane byte-identity: an in-process TCP cluster with
       ``ms_lanes_per_peer=4`` + fragmentation must serve every object
       byte-identical to a forced single-lane run of the same payloads —
       the striping/reassembly seam may never change bytes.  Runs
       whenever --wire-floor is requested (no BENCH records needed).

        python -m ceph_tpu_torch.tools.non_regression --wire-floor \\
            [--bench BENCH_rNN.json --prev BENCH_rMM.json]
    """
    rc = 0
    if args.bench and args.prev:
        try:
            cur = _bench_metrics(args.bench)
            prev = _bench_metrics(args.prev)
        except (OSError, ValueError) as e:
            print(f"wire-floor: unreadable BENCH record: {e}",
                  file=sys.stderr)
            return 1
        # like-for-like arms only (ISSUE 12): the headline
        # daemon_wire_* pair rides whichever wirepath arm the host
        # resolved (`wirepath_kind`), so a native-arm record compared
        # against a python-arm record would hide a real wire
        # regression behind the arm speedup (or fail a healthy python
        # host against a native record).  When the arms differ, both
        # records' forced-python numbers (daemon_wire_*_MBps_python,
        # measured every run since ISSUE 12; records older than that
        # ARE the python arm) are the comparable pair.
        ckind = str(cur.get("wirepath_kind") or "python")
        pkind = str(prev.get("wirepath_kind") or "python")
        # like-for-like reactor MODES too (records older than the
        # process-sharded plane are the thread arm): a thread-arm
        # record compared against a process-arm record measures the
        # substrate swap, not a wire regression — skip the throughput
        # half with an explanation instead of failing/greenlighting on
        # an apples-to-oranges pair
        cmode = str(cur.get("reactor_mode") or "thread")
        pmode = str(prev.get("reactor_mode") or "thread")
        if cmode != pmode:
            print(f"wire-floor: reactor_mode differs (cur={cmode} "
                  f"prev={pmode}); skipping the throughput floor — "
                  f"like-for-like modes only (re-run either record "
                  f"with CEPH_TPU_REACTOR={pmode} to compare)")
            lane_rc = _wire_lane_identity(args.device)
            return rc or lane_rc
        for key in ("daemon_wire_put_MBps", "daemon_wire_get_MBps"):
            if ckind == pkind:
                c = float(cur.get(key, 0.0) or 0.0)
                p = float(prev.get(key, 0.0) or 0.0)
                label = f"{key} [{ckind} arms]"
            else:
                c = float(cur.get(
                    f"{key}_python" if ckind == "native" else key,
                    0.0) or 0.0)
                p = float(prev.get(
                    f"{key}_python" if pkind == "native" else key,
                    0.0) or 0.0)
                label = (f"{key} [python arms; wirepath_kind differs: "
                         f"cur={ckind} prev={pkind}]")
            if p <= 0:
                print(f"wire-floor: no previous {label}; skipping")
                continue
            if c <= 0:
                rc = 1
                print(f"FAIL wire-floor: {label} missing in the "
                      f"current record")
                continue
            floor = p * args.floor
            if c < floor:
                rc = 1
                print(f"FAIL wire-floor: {label} {c:.1f} MB/s < "
                      f"{args.floor:.2f} x previous {p:.1f} "
                      f"(floor {floor:.1f})")
            else:
                print(f"wire-floor: {label} {c:.1f} MB/s vs previous "
                      f"{p:.1f} ok")
    elif args.bench or args.prev:
        print("wire-floor: need BOTH --bench and --prev for the "
              "throughput half; running lane identity only")
    lane_rc = _wire_lane_identity(args.device)
    return rc or lane_rc


def _wire_lane_identity(device: str) -> int:
    """Multi-lane vs single-lane byte-identity (the --wire-floor lane
    half): same seeded payloads through a lanes=4 cluster and a forced
    lanes=1 cluster; every get must match the source bytes in both."""
    import asyncio
    import hashlib

    import numpy as np

    from ceph_tpu_torch.rados.vstart import Cluster

    rng = np.random.default_rng(1234)
    payloads = {
        f"obj-{i}": rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for i, size in enumerate((512, 96 << 10, (1 << 20) + 13,
                                  5 << 20))
    }

    async def serve(lanes: int) -> dict:
        cluster = Cluster(n_osds=4, conf={
            "osd_ec_device": device,
            "osd_auto_repair": False,
            "ms_local_fastpath": False,
            "ms_lanes_per_peer": lanes,
        })
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("lanes", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            out = {}
            for oid, data in payloads.items():
                await c.put(pool, oid, data)
            for oid in payloads:
                got = await c.get(pool, oid)
                out[oid] = hashlib.sha256(bytes(got)).hexdigest()
            await c.stop()
            return out
        finally:
            await cluster.stop()

    want = {oid: hashlib.sha256(data).hexdigest()
            for oid, data in payloads.items()}
    multi = asyncio.run(serve(4))
    single = asyncio.run(serve(1))
    bad = 0
    for oid in payloads:
        if multi.get(oid) != want[oid]:
            print(f"FAIL wire-floor: lanes=4 read of {oid} not "
                  f"byte-identical to source", file=sys.stderr)
            bad += 1
        if single.get(oid) != want[oid]:
            print(f"FAIL wire-floor: lanes=1 read of {oid} not "
                  f"byte-identical to source", file=sys.stderr)
            bad += 1
    if bad:
        return 1
    print(f"wire-floor: {len(payloads)} objects byte-identical across "
          f"multi-lane (4) and single-lane runs")
    return 0


def run_chaos(args) -> int:
    """Chaos smoke mode (CI): hammer put/get against an in-process
    cluster with socket-failure + duplicate-frame injection for a few
    seconds; ANY acked-op failure — a put that raises despite the client
    resilience layer, or an acked write that does not read back
    byte-identical — exits nonzero.  The acceptance bar of the op-
    resilience layer (resend-on-map-change, MOSDBackoff, reqid dedup),
    runnable as one command:

        python -m ceph_tpu_torch.tools.non_regression --chaos
    """
    import asyncio
    import os as _os


    async def go() -> int:
        conf = {"osd_auto_repair": True, "osd_repair_delay": 0.2,
                "osd_heartbeat_interval": 0.2,
                "mon_osd_report_grace": 1.0,
                "ms_inject_socket_failures": 80,
                "ms_inject_dup_frames": 20}
        cluster = _cluster(args, max(3, args.chaos_osds), conf)
        await cluster.start()
        failures = []
        try:
            c = await cluster.client()
            pool = await c.create_pool("chaos", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            acked = {}
            import time as _time

            deadline = _time.monotonic() + args.chaos_seconds
            i = 0
            while _time.monotonic() < deadline:
                oid = f"c{i % 16}"
                blob = _os.urandom(3000 + (i % 512))
                try:
                    await c.put(pool, oid, blob)
                    acked[oid] = blob
                except Exception as e:
                    failures.append(f"acked-op failure: put {oid}: {e}")
                if acked and i % 3 == 0:
                    roid = sorted(acked)[i % len(acked)]
                    try:
                        got = await c.get(pool, roid)
                        if got != acked[roid]:
                            failures.append(
                                f"readback mismatch on {roid}")
                    except Exception as e:
                        failures.append(f"read {roid} failed: {e}")
                i += 1
            print(f"chaos: {i} ops, {len(acked)} objects, "
                  f"{len(failures)} failures; objecter: "
                  f"{ {k: v for k, v in c.perf.dump().items() if isinstance(v, int)} }")
            await c.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_slow_ops(args) -> int:
    """Slow-op health smoke (CI): a chaos loop under
    CEPH_TPU_INJECT_DISPATCH_DELAY — every device dispatch sleeps, so
    in-flight writes age past osd_op_complaint_time and the OSDs'
    ping-borne health reports must RAISE the mon's SLOW_OPS check; when
    the injection stops and the backlog drains, the check must CLEAR
    within about one complaint interval (plus the ping cadence).
    Nonzero exit if a slow op never surfaces, or if the check wedges
    raised after the cluster is idle.  The acceptance bar of the health
    model, runnable as one command:

        python -m ceph_tpu_torch.tools.non_regression --slow-ops
    """
    import asyncio
    import os as _os
    import time as _time

    # the batching queue (the injection point) engages only on the
    # card; FORCE_BATCH is the sanctioned CPU override —
    # set BEFORE any OSD asks for the shared queue
    _os.environ["CEPH_TPU_FORCE_BATCH"] = "1"
    _os.environ.setdefault("CEPH_TPU_INJECT_DISPATCH_DELAY", "0.6")

    import ceph_tpu_torch.rados.osd as osdmod

    complaint = 0.25

    async def go() -> int:
        conf = {"osd_auto_repair": False,
                "osd_heartbeat_interval": 0.1,
                "mon_osd_report_grace": 5.0,
                "client_op_timeout": 30.0,
                "client_op_deadline": 120.0,
                "osd_op_complaint_time": complaint}
        cluster = _cluster(args, max(3, args.slow_osds), conf)
        await cluster.start()
        failures = []
        try:
            c = await cluster.client()
            pool = await c.create_pool("slow", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            q = osdmod.shared_batching_queue(args.device)
            if q is None:
                print("FAIL batching queue did not engage under "
                      "CEPH_TPU_FORCE_BATCH=1", file=sys.stderr)
                return 1
            delay = float(_os.environ["CEPH_TPU_INJECT_DISPATCH_DELAY"])
            q.inject_dispatch_delay = delay
            loop = asyncio.get_running_loop()
            # a standing burst of writes: each one's encode dispatch
            # sleeps `delay`, so in-flight ops age past the complaint
            tasks = [loop.create_task(
                c.put(pool, f"s{i}", _os.urandom(60_000 + 512 * i)))
                for i in range(8)]
            raised = False
            deadline = _time.monotonic() + args.slow_seconds
            while _time.monotonic() < deadline:
                h = await c.get_health(detail=True)
                if "SLOW_OPS" in (h.get("checks") or {}):
                    chk = h["checks"]["SLOW_OPS"]
                    print(f"slow-ops raised: {chk['summary']} "
                          f"(oldest {chk.get('oldest_age', 0):.2f}s)")
                    raised = True
                    break
                await asyncio.sleep(0.05)
            if not raised:
                failures.append("SLOW_OPS never raised under injected "
                                "dispatch delay")
            # recovery: stop the injection, drain the backlog
            q.inject_dispatch_delay = 0.0
            got = await asyncio.gather(*tasks, return_exceptions=True)
            for g in got:
                if isinstance(g, Exception):
                    failures.append(f"write failed under delay: {g}")
            # the check must clear within ~one complaint interval after
            # the cluster idles (next ping carries an empty report)
            cleared = False
            clear_deadline = _time.monotonic() + complaint + 3.0
            while _time.monotonic() < clear_deadline:
                h = await c.get_health()
                if "SLOW_OPS" not in (h.get("checks") or {}):
                    cleared = True
                    break
                await asyncio.sleep(0.05)
            if raised and not cleared:
                failures.append("SLOW_OPS wedged raised after the "
                                "cluster went idle")
            if cleared:
                print("slow-ops cleared after recovery")
            await c.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_qos(args) -> int:
    """QoS isolation gate (CI): three tenant classes — one RESERVED
    (qos_class:gold, guaranteed IOPS), one BEST-EFFORT (the pool's
    default client profile), one FLOODING past its declared limit (48
    unpaced workers against qos_limit 30/s) — hammer one pool through
    separate client processes, with every read content-verified.  The
    acceptance bar of the multi-tenant QoS subsystem, runnable as one
    command:

        python -m ceph_tpu_torch.tools.non_regression --qos

    Nonzero exit when any of these fail:
      - the FLOODER (and only the flooder) is backoff-shed: the OSDs'
        qos_shed counters moved and the flooder's client received
        MOSDBackoff blocks while the reserved client received at most a
        bootstrap handful (the legacy shed window before the flooder's
        arrears cross osd_qos_shed_grace)
      - the reserved tenant's acked-op failures are exactly 0 (and all
        its reads were byte-identical)
      - the reserved tenant's contended get p99 stays bounded:
        <= max(3x its solo-run p99, 1.5x the best-effort class's
        contended p99, 200ms).  The best-effort term matters on 1-2
        core CI hosts: the contended window inflates EVERY op's latency
        through process-wide CPU contention (one event loop carries the
        whole in-process cluster), which QoS cannot remove — but a real
        isolation regression (the reserved class being shed/starved)
        shows up as gold >> best-effort in the SAME window, and 0.5s
        backoff parks blow straight past every term of the bound.
    """
    import asyncio

    from ceph_tpu_torch.rados.client import RadosClient
    from ceph_tpu_torch.tools.traffic import TenantClass, TrafficHarness

    flood_limit = 30.0

    async def go() -> int:
        conf = {"osd_auto_repair": False,
                "ms_local_fastpath": False,
                "osd_op_queue": "mclock",
                "osd_backoff_queue_depth": 6,
                "osd_qos_shed_grace": 0.05,
                "osd_backoff_secs": 0.5,
                "client_op_timeout": 30.0,
                "client_op_deadline": 60.0}
        cluster = _cluster(args, max(3, args.qos_osds), conf)
        await cluster.start()
        failures = []
        try:
            c0 = await cluster.client()
            pool = await c0.create_pool("qos", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            await c0.pool_set(pool, "qos_reservation", "50")
            await c0.pool_set(pool, "qos_weight", "5")
            await c0.pool_set(pool, "qos_class:gold", "100:20:0")
            await c0.pool_set(pool, "qos_class:flood",
                              f"0:1:{flood_limit:g}")
            c_gold = await cluster.client()
            c_be = await cluster.client()
            fconf = dict(cluster.conf)
            fconf["client_op_deadline"] = 5.0  # a shed flooder times out
            c_flood = RadosClient(cluster.mon_addrs, fconf)
            await c_flood.start()
            await c_flood.refresh_map()
            gold = TenantClass("gold", c_gold, tenants=1, workers=4,
                              rate=40.0)
            be = TenantClass("", c_be, tenants=64, workers=2, rate=20.0)
            flood = TenantClass("flood", c_flood, tenants=1, workers=48,
                                rate=0.0)
            h = TrafficHarness([gold, be, flood], pool, n_objects=32,
                               obj_size=16 << 10, verify=True)
            await h.preload()
            solo = await h.run_phase("solo", args.qos_seconds, 0.25,
                                     classes=[gold])
            for attempt in range(2):
                shed0 = sum(o.sched_perf.get("qos_shed")
                            for o in cluster.osds.values())
                fb0 = c_flood.perf.get("backoffs_received")
                cont = await h.run_phase("contended", args.qos_seconds,
                                         0.25)
                sheds = sum(o.sched_perf.get("qos_shed")
                            for o in cluster.osds.values()) - shed0
                flood_backoffs = c_flood.perf.get(
                    "backoffs_received") - fb0
                if sheds or flood_backoffs:
                    break
                # saturation never engaged AT ALL (no shed, no block):
                # on a 1-2 core CI host a noisy neighbor can stall the
                # whole in-process event loop so no op volume ever
                # builds — one retry; a real regression (shed machinery
                # broken) reproduces and still fails
                print("qos: saturation never engaged; retrying the "
                      "contended window once (host stall suspected)")
            solo_s, cont_s = solo.summary(), cont.summary()
            gold_solo = solo_s.get("gold", {})
            gold_cont = cont_s.get("gold", {})
            solo_p99 = gold_solo.get("get", {}).get("p99_us", 0.0)
            cont_p99 = gold_cont.get("get", {}).get("p99_us", 0.0)
            be_p99 = cont_s.get("default", {}).get("get", {}).get(
                "p99_us", 0.0)
            gold_backoffs = c_gold.perf.get("backoffs_received")
            gold_fail = (gold_solo.get("failures", 0)
                         + gold_cont.get("failures", 0))
            if sheds <= 0:
                failures.append("no qos-directed shed ever happened "
                                "(qos_shed stayed 0 under a flooder)")
            if flood_backoffs <= 0:
                failures.append("the flooding client never received an "
                                "MOSDBackoff block")
            if gold_fail:
                failures.append(f"reserved tenant had {gold_fail} "
                                "acked-op failures (must be 0)")
            if gold_backoffs > 2:
                failures.append(
                    f"reserved tenant was backoff-shed {gold_backoffs} "
                    "times (the shed must target the flooder; <=2 "
                    "bootstrap blocks tolerated)")
            bound = max(3.0 * solo_p99, 1.5 * be_p99, 200_000.0)
            if not solo_p99 or not cont_p99:
                failures.append("reserved tenant percentiles missing "
                                f"(solo={solo_p99}, contended={cont_p99})")
            elif cont_p99 > bound:
                failures.append(
                    f"reserved get p99 unbounded under flood: "
                    f"{cont_p99:.0f}us > max(3x solo {solo_p99:.0f}us, "
                    f"1.5x best-effort {be_p99:.0f}us, 200ms)")
            print(f"qos: solo p99 {solo_p99:.0f}us, contended p99 "
                  f"{cont_p99:.0f}us (best-effort {be_p99:.0f}us), "
                  f"sheds {sheds}, flooder backoffs "
                  f"{flood_backoffs}, reserved backoffs {gold_backoffs}, "
                  f"flood served {cont_s.get('flood', {}).get('ops', 0)} "
                  f"ops (limit {flood_limit:g}/s), "
                  f"{len(failures)} failures")
            for c in (c0, c_gold, c_be, c_flood):
                await c.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_crash(args) -> int:
    """Crash-telemetry gate (CI): the acceptance bar of the cluster-log
    + crash plane, runnable as one command:

        python -m ceph_tpu_torch.tools.non_regression --crash

    Injects a fatal exception into one OSD of a live cluster and then
    asserts, in order: a crash report lands in `ceph crash ls` whose
    `crash info` carries the injected exception, a backtrace, and the
    daemon's dump_recent ring; `ceph health detail` raises RECENT_CRASH;
    the cluster log records the daemon death (and the mon's subsequent
    mark-down); `crash archive` clears RECENT_CRASH.  Any miss exits
    nonzero."""
    import asyncio
    import time as _time


    async def go() -> int:
        conf = {"osd_auto_repair": False,
                "osd_heartbeat_interval": 0.1,
                "mon_osd_report_grace": 1.0}
        cluster = _cluster(args, max(2, args.crash_osds), conf)
        await cluster.start()
        failures = []
        try:
            c = await cluster.client()
            pool = await c.create_pool("crash", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            # some traffic first, so the victim's dump_recent ring has
            # history worth spooling
            import os as _os

            for i in range(4):
                await c.put(pool, f"o{i}", _os.urandom(8192))
            victim = sorted(cluster.osds)[-1]
            cluster.osds[victim].inject_crash()
            # 1) the crash report must land in `ceph crash ls`
            report = None
            deadline = _time.monotonic() + args.crash_seconds
            while _time.monotonic() < deadline:
                ls = await c.crash_ls()
                mine = [r for r in ls if r["entity"] == f"osd.{victim}"]
                if mine:
                    report = mine[-1]
                    break
                await asyncio.sleep(0.1)
            if report is None:
                failures.append(f"no crash report for osd.{victim} in "
                                f"`crash ls` after injection")
            else:
                info = await c.crash_info(report["crash_id"])
                if "injected crash" not in info.get("exception", ""):
                    failures.append("crash info lost the exception: "
                                    f"{info.get('exception')!r}")
                if "Traceback" not in info.get("backtrace", ""):
                    failures.append("crash info carries no backtrace")
                if not info.get("recent"):
                    failures.append("crash info carries no dump_recent "
                                    "ring")
            # 2) RECENT_CRASH raises in health detail
            raised = False
            deadline = _time.monotonic() + args.crash_seconds
            while _time.monotonic() < deadline:
                h = await c.get_health(detail=True)
                if "RECENT_CRASH" in (h.get("checks") or {}):
                    raised = True
                    break
                await asyncio.sleep(0.1)
            if not raised:
                failures.append("RECENT_CRASH never raised in "
                                "`health detail`")
            # 3) the cluster log shows the daemon death
            deadline = _time.monotonic() + args.crash_seconds
            crash_line = down_line = False
            while _time.monotonic() < deadline:
                tail = await c.log_last(level=3)  # warn+
                crash_line = any("crashed" in e.message
                                 and f"osd.{victim}" in e.message
                                 for e in tail)
                down_line = any("marked down" in e.message
                                and f"osd.{victim}" in e.message
                                for e in tail)
                if crash_line and down_line:
                    break
                await asyncio.sleep(0.1)
            if not crash_line:
                failures.append("cluster log has no crash entry for "
                                f"osd.{victim}")
            if not down_line:
                failures.append("cluster log has no mark-down entry for "
                                f"osd.{victim}")
            # 4) archive clears RECENT_CRASH
            if report is not None:
                await c.crash_archive(report["crash_id"])
                h = await c.get_health()
                if "RECENT_CRASH" in (h.get("checks") or {}):
                    failures.append("RECENT_CRASH still raised after "
                                    "`crash archive`")
            print(f"crash: victim osd.{victim}, report "
                  f"{'found' if report else 'MISSING'}, "
                  f"RECENT_CRASH {'raised' if raised else 'MISSING'}, "
                  f"clog crash/{crash_line} down/{down_line}, "
                  f"{len(failures)} failures")
            await c.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_tier(args) -> int:
    """Tier smoke mode (CI): a promote/evict/read loop against an
    in-process cluster with the device-residency tier forced on.  Every
    iteration reads one hot object through BOTH paths — the cold decode
    path (residents dropped first) and, after promotion, the
    resident-hit fast path — and exits nonzero on ANY content mismatch
    between the two (the tier's byte-identity gate), on any read
    failure, and on the agent failing to bound resident bytes.  The
    acceptance bar of the cache tier, runnable as one command:

        python -m ceph_tpu_torch.tools.non_regression --tier
    """
    import asyncio
    import os as _os

    # the planar store (and with it promotion) engages only on the
    # card; FORCE_BATCH is the sanctioned CPU override —
    # set BEFORE any OSD asks for the shared queue
    _os.environ["CEPH_TPU_FORCE_BATCH"] = "1"

    import ceph_tpu_torch.rados.osd as osdmod

    target_bytes = 3 << 20

    async def go() -> int:
        conf = {"osd_auto_repair": False, "client_op_timeout": 60.0,
                "osd_heartbeat_interval": 0.1,
                "osd_hit_set_period": 0.5,
                "osd_min_read_recency_for_promote": 1,
                "osd_tier_agent_interval": 0.1,
                "osd_tier_target_max_bytes": target_bytes,
                "osd_cache_target_full_ratio": 0.8,
                # writeback legs: dirty residents must flush on the
                # agent cadence (age-driven) so dirty_pages is bounded
                # after settling — the failing gate below
                "osd_tier_flush_age": 0.3}
        # 4-OSD floor: the kill-primary leg needs a SPARE device — the
        # mon auto-outs the dead OSD (mon_osd_down_out_interval) and
        # CRUSH rebuilds a full acting set, but only if one exists
        # (k+m == n_osds leaves a hole no auto-out can fill)
        cluster = _cluster(args, max(4, args.tier_osds), conf)
        await cluster.start()
        failures = []
        resident_reads = cold_reads = 0
        try:
            c = await cluster.client()
            pool = await c.create_pool("tier", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            store = osdmod.shared_planar_store(device=args.device)
            if store is None:
                print("FAIL planar store did not engage under "
                      "CEPH_TPU_FORCE_BATCH=1", file=sys.stderr)
                return 1
            import time as _time

            blobs = {}
            # hot set larger than the agent target: evictions must run
            for i in range(24):
                oid = f"h{i}"
                blobs[oid] = _os.urandom(150_000 + 512 * i)
                await c.put(pool, oid, blobs[oid])

            def drop_residents(oid: str) -> None:
                for o in cluster.osds.values():
                    if o._planar is not None:
                        o._planar.drop(o._planar_key(pool, oid))

            def resident_on(oid: str) -> bool:
                return any(o._planar is not None
                           and o._planar_key(pool, oid) in store
                           for o in cluster.osds.values())

            deadline = _time.monotonic() + args.tier_seconds
            i = 0
            while _time.monotonic() < deadline:
                oid = f"h{i % len(blobs)}"
                want = blobs[oid]
                # COLD path: force the decode pipeline
                drop_residents(oid)
                try:
                    cold = await c.get(pool, oid, fadvise="dontneed")
                    cold_reads += 1
                    if cold != want:
                        failures.append(f"cold-path mismatch on {oid}")
                except Exception as e:
                    failures.append(f"cold read {oid} failed: {e}")
                    i += 1
                    continue
                # PROMOTE (willneed bypasses recency, not the throttle)
                # then read the resident-hit path
                try:
                    await c.get(pool, oid, fadvise="willneed")
                    for _ in range(50):
                        if resident_on(oid):
                            break
                        await asyncio.sleep(0.01)
                    hot = await c.get(pool, oid)
                    if resident_on(oid):
                        resident_reads += 1
                    if hot != cold:
                        failures.append(
                            f"resident-hit vs cold mismatch on {oid}")
                    if hot != want:
                        failures.append(f"resident-hit mismatch on {oid}")
                except Exception as e:
                    failures.append(f"hot read {oid} failed: {e}")
                if i % 7 == 3:
                    # churn: overwrite invalidates the resident; the next
                    # round must serve the NEW bytes on both paths
                    blobs[oid] = _os.urandom(140_000 + 256 * i)
                    await c.put(pool, oid, blobs[oid])
                i += 1
            # bounded residency: the agent must be holding the line.
            # Settle for a few agent intervals first — the loop above
            # promotes flat-out and the agent enforces on its cadence,
            # so an instantaneous sample can catch promotions that
            # landed since the last pass (by-design transient, same as
            # the reference agent)
            await asyncio.sleep(0.5)
            if store.resident_bytes > target_bytes:
                failures.append(
                    f"resident_bytes {store.resident_bytes} exceeds "
                    f"target {target_bytes} after settling")
            # -- writeback legs (paged store only): put under
            # cache_mode=writeback -> dirty pages -> agent flush ->
            # evict -> re-read byte identity, with bounded dirty_pages
            # after settling as the failing gate
            if hasattr(store, "dirty_items"):
                await c.pool_set(pool, "cache_mode", "writeback")
                for o in cluster.osds.values():
                    # pool-opt propagation: poll each OSD's map
                    for _ in range(100):
                        p = (o.osdmap.pools.get(pool)
                             if o.osdmap else None)
                        if p is not None and (getattr(p, "opts", {})
                                              or {}).get("cache_mode") \
                                == "writeback":
                            break
                        await asyncio.sleep(0.02)
                wb_blobs = {}
                saw_dirty = False
                pinned = {}
                for i in range(6):
                    oid = f"wb{i}"
                    wb_blobs[oid] = _os.urandom(120_000 + 1024 * i)
                    await c.put(pool, oid, wb_blobs[oid])
                    # sample dirt per put: the agent (0.1s cadence,
                    # 0.3s flush age) may legitimately drain earlier
                    # puts' pages while later puts run on a slow host —
                    # an after-the-loop snapshot would false-fail
                    saw_dirty = saw_dirty or store.dirty_pages > 0
                    for key, info, _g, _s in store.dirty_items():
                        if info is not None:
                            pinned[key] = info
                pinned = sorted(pinned.items())
                if not saw_dirty or not pinned:
                    failures.append(
                        "writeback puts left no dirty pages (writeback "
                        "never engaged)")
                for oid, want in wb_blobs.items():
                    got = await c.get(pool, oid)
                    if got != want:
                        failures.append(
                            f"writeback resident read mismatch on {oid}")
                # agent settling: age-driven flush must bound dirty
                for _ in range(100):
                    if not store.has_dirty():
                        break
                    await asyncio.sleep(0.05)
                if store.dirty_pages != 0:
                    failures.append(
                        f"dirty_pages {store.dirty_pages} not bounded "
                        f"after agent settling (flush never drained)")
                # the deferred local applies LANDED at their versions.
                # A WritebackRecord pins its deferred local shards; a
                # fast-ack CacheDirtyRecord defers the WHOLE k+m encode
                # (the flush lands the installer's acting shards), and
                # its ADOPTED copies on cache peers pin nothing locally.
                for key, info in pinned:
                    osd = cluster.osds.get(key[0])
                    if osd is None:
                        continue
                    shards = getattr(info, "shards", None)
                    if shards is None:
                        if getattr(info, "primary", key[0]) != key[0]:
                            continue  # adopted copy: owner destages
                        p = osd.osdmap.pools[info.pool_id]
                        acting = osd.osdmap.pg_to_acting(p, info.pg)
                        shards = [s for s, o_id in enumerate(acting)
                                  if o_id == key[0]]
                    for shard in shards:
                        got_s = osd._store_read(
                            (info.pool_id, info.oid, shard))
                        if got_s is None or got_s[1].version < info.version:
                            failures.append(
                                f"flush of {info.oid} shard {shard} on "
                                f"osd.{key[0]} never reached the store")
                # evict everything, then cold re-reads must serve the
                # flushed bytes (flush-before-evict byte identity)
                for oid in wb_blobs:
                    drop_residents(oid)
                for oid, want in wb_blobs.items():
                    got = await c.get(pool, oid, fadvise="dontneed")
                    if got != want:
                        failures.append(
                            f"post-flush cold read mismatch on {oid}")
                wb_perf = store.perf.dump()
                print(f"tier writeback: {len(wb_blobs)} puts, "
                      f"flushes={wb_perf.get('flushes', 0)} "
                      f"flush_bytes={wb_perf.get('flush_bytes', 0)} "
                      f"dirty_pages={store.dirty_pages} "
                      f"page_evictions={wb_perf.get('page_evictions', 0)} "
                      f"frag_saved={wb_perf.get('frag_saved_bytes', 0)}")
                # -- kill-primary-before-flush (the fast-ack durability
                # gate): a put acked at the CACHE quorum, its primary
                # SIGKILLed before any flush, must survive — a replica
                # replays its raw dirty copy to the PG's new primary,
                # who destages it; the cold re-read is byte-identical
                for o in cluster.osds.values():
                    o.conf["osd_tier_flush_age"] = 120.0  # park dirt
                kp_blob = _os.urandom(130_000)
                await c.put(pool, "wbkill", kp_blob)
                owned = [(k, info) for k, info, _g, _s
                         in store.dirty_items()
                         if info is not None and info.oid == "wbkill"
                         and getattr(info, "primary", None) == k[0]]
                if not owned:
                    failures.append(
                        "kill-primary leg: fast-ack put left no owned "
                        "raw dirty record (fast ack never engaged)")
                else:
                    (kp_key, kp_rec), = owned
                    adopters = [p for p in kp_rec.peers
                                if p != kp_key[0]
                                and store.is_dirty((p, pool, "wbkill"))]
                    if not adopters:
                        failures.append(
                            "kill-primary leg: no cache peer adopted "
                            "the dirty copy before the kill")
                    await cluster.kill_osd(kp_key[0])
                    got_kp = None
                    for _ in range(300):
                        await asyncio.sleep(0.1)
                        try:
                            got_kp = await c.get(pool, "wbkill")
                            if got_kp == kp_blob:
                                break
                        except Exception:
                            continue
                    if got_kp != kp_blob:
                        failures.append(
                            "kill-primary leg: acked write lost after "
                            "primary SIGKILL before flush")
                    # the survivors' replay destaged and released the
                    # adopted copies
                    for _ in range(100):
                        if not any(info is not None
                                   and info.oid == "wbkill"
                                   for _k, info, _g, _s
                                   in store.dirty_items()):
                            break
                        await asyncio.sleep(0.1)
                    if any(info is not None and info.oid == "wbkill"
                           for _k, info, _g, _s in store.dirty_items()):
                        failures.append(
                            "kill-primary leg: adopted dirty copies "
                            "never destaged after the failover")
                    drop_residents("wbkill")
                    try:
                        cold_kp = await c.get(pool, "wbkill",
                                              fadvise="dontneed")
                        if cold_kp != kp_blob:
                            failures.append(
                                "kill-primary leg: cold re-read after "
                                "replay is not byte-identical")
                    except Exception as e:
                        failures.append(
                            f"kill-primary leg: cold re-read failed: {e}")
                    tier_enc = sum(o.tier_perf.get("flush_encodes")
                                   for o in cluster.osds.values())
                    print(f"tier kill-primary: victim osd.{kp_key[0]}, "
                          f"{len(adopters)} adopter(s), replay "
                          f"flush_encodes={tier_enc}, re-read "
                          f"{'ok' if got_kp == kp_blob else 'LOST'}")
                for o in cluster.osds.values():
                    o.conf["osd_tier_flush_age"] = 0.3
            else:
                print("tier writeback: SKIPPED (monolithic resident "
                      "store forced; writeback needs the pagestore)")
            tier = {}
            for o in cluster.osds.values():
                for k, v in o.tier_perf.dump().items():
                    if isinstance(v, int):
                        tier[k] = tier.get(k, 0) + v
            print(f"tier: {i} iterations, {resident_reads} resident-hit "
                  f"reads, {cold_reads} cold reads, "
                  f"{len(failures)} failures; "
                  f"promote={tier.get('promote', 0)} "
                  f"evict={tier.get('agent_evict', 0)} "
                  f"evict_noop={tier.get('agent_evict_noop', 0)} "
                  f"resident_hit={tier.get('resident_hit', 0)} "
                  f"throttled={tier.get('promote_throttled', 0)}")
            if not resident_reads:
                failures.append("no resident-hit read ever happened "
                                "(promotion never engaged)")
            await c.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_full(args) -> int:
    """Fullness-ladder gate (CI), the acceptance bar of the capacity
    plane, runnable as one FAILING command:

        python -m ceph_tpu_torch.tools.non_regression --full

    Three legs:

    1. INJECTED LADDER (no gigabytes written): force one OSD's reported
       utilization through nearfull -> full; assert OSD_NEARFULL warns,
       OSD_FULL + POOL_FULL raise, writes into PGs holding the full OSD
       fail TYPED ENOSPC, reads of every acked object stay
       byte-identical (zero acked-op loss), deletes are still served;
       clear the injection and assert the flags auto-clear and writes
       resume.
    2. REAL CAPACITY: a store with a genuine byte ceiling fills until
       the failsafe refuses (typed ENOSPC, store untouched); deleting
       drains below the ratio, states auto-clear, writes resume —
       the delete-is-the-way-out contract on real bytes.
    3. BACKFILLFULL: a backfill whose target is past its backfillfull
       ratio parks as `backfill_toofull` (PG_BACKFILL_FULL in health);
       freeing the target lets the backfill complete with data intact.
    """
    import asyncio
    import errno as _errno
    import os as _os
    import time as _time

    from ceph_tpu_torch.rados.client import RadosError

    async def wait_for(pred, seconds, what, failures):
        deadline = _time.monotonic() + seconds
        while _time.monotonic() < deadline:
            if await pred():
                return True
            await asyncio.sleep(0.1)
        failures.append(f"timed out waiting for {what}")
        return False

    async def verify_acked(c, pool, acked, failures, stage):
        """Zero acked-op loss: every acked object reads byte-identical."""
        for oid, want in acked.items():
            try:
                got = await c.get(pool, oid)
            except Exception as e:
                failures.append(f"[{stage}] acked {oid} unreadable: {e}")
                continue
            if bytes(got) != want:
                failures.append(f"[{stage}] acked {oid} corrupted")

    async def leg_injected(failures) -> None:
        conf = {"osd_auto_repair": True, "osd_heartbeat_interval": 0.1,
                "mon_osd_report_grace": 2.0,
                "client_op_timeout": 5.0, "client_op_deadline": 6.0}
        cluster = _cluster(args, max(3, args.full_osds), conf)
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("fullpool", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            acked = {}
            for i in range(10):
                blob = _os.urandom(48_000 + 997 * i)
                await c.put(pool, f"o{i}", blob)
                acked[f"o{i}"] = blob
            victim = sorted(cluster.osds)[0]

            async def state_is(want):
                h = await c.get_health(detail=True)
                util = h.get("osd_utilization") or {}
                return (util.get(victim) or {}).get("state") == want

            # nearfull: warn raises, writes still flow
            cluster.conf["osd_debug_inject_full"] = f"{victim}:0.87"
            await wait_for(lambda: state_is("nearfull"), args.full_seconds,
                           "nearfull state", failures)
            h = await c.get_health()
            if "OSD_NEARFULL" not in (h.get("checks") or {}):
                failures.append("OSD_NEARFULL never raised")
            await c.put(pool, "nearfull-write", b"x" * 1000)
            acked["nearfull-write"] = b"x" * 1000
            # full: OSD_FULL(+POOL_FULL) raise; writes typed-ENOSPC
            cluster.conf["osd_debug_inject_full"] = f"{victim}:0.96"
            await wait_for(lambda: state_is("full"), args.full_seconds,
                           "full state", failures)
            h = await c.get_health()
            for check in ("OSD_FULL", "POOL_FULL"):
                if check not in (h.get("checks") or {}):
                    failures.append(f"{check} never raised")
            # an oid whose PG's acting set holds the victim
            await c.refresh_map()
            p = c.osdmap.pools[pool]
            target_oid = None
            for i in range(256):
                oid = f"fullprobe{i}"
                pg = c.osdmap.object_to_pg(p, oid)
                if victim in c.osdmap.pg_to_acting(p, pg):
                    target_oid = oid
                    break
            if target_oid is None:
                failures.append("no PG maps onto the full OSD?")
            else:
                t0 = _time.monotonic()
                try:
                    await c.put(pool, target_oid, b"y" * 2000)
                    failures.append("write into a FULL acting set "
                                    "succeeded")
                except RadosError as e:
                    if e.code != -_errno.ENOSPC:
                        failures.append(
                            f"write failed untyped (code {e.code}, "
                            f"want ENOSPC): {e}")
                    elif _time.monotonic() - t0 > 3.0:
                        failures.append(
                            "ENOSPC took the slow retry path "
                            f"({_time.monotonic() - t0:.1f}s): not "
                            "fail-fast")
                # reads + deletes still served at FULL
                await verify_acked(c, pool, acked, failures, "full")
                await c.delete(pool, "o0")
                del acked["o0"]
                try:
                    await c.get(pool, "o0")
                    failures.append("deleted o0 still readable")
                except RadosError:
                    pass
            # the drain: injection cleared = utilization dropped
            cluster.conf["osd_debug_inject_full"] = ""
            await wait_for(lambda: state_is(""), args.full_seconds,
                           "full state to auto-clear", failures)

            async def no_full_checks():
                h = await c.get_health()
                checks = h.get("checks") or {}
                return not ({"OSD_FULL", "POOL_FULL", "OSD_NEARFULL"}
                            & set(checks))

            await wait_for(no_full_checks, args.full_seconds,
                           "fullness health checks to clear", failures)
            if target_oid is not None:
                blob = _os.urandom(3000)
                await c.put(pool, target_oid, blob)  # writes resume
                acked[target_oid] = blob
            await verify_acked(c, pool, acked, failures, "cleared")
            await c.stop()
        finally:
            cluster.conf["osd_debug_inject_full"] = ""
            await cluster.stop()

    async def leg_capacity(failures) -> None:
        # one OSD, one replica, a REAL 1 MiB ceiling: the failsafe must
        # refuse before the store bursts, deletes must drain it
        cap = 1 << 20
        conf = {"osd_auto_repair": False, "osd_heartbeat_interval": 0.1,
                "osd_store_capacity_bytes": cap,
                "client_op_timeout": 5.0, "client_op_deadline": 6.0}
        cluster = _cluster(args, 1, conf)
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("cap", pool_type="replicated",
                                       profile={"size": "1"}, pg_num=8)
            acked = {}
            blocked = None
            for i in range(64):
                oid = f"c{i}"
                blob = _os.urandom(48 << 10)
                try:
                    await c.put(pool, oid, blob)
                    acked[oid] = blob
                except RadosError as e:
                    blocked = e
                    break
            if blocked is None:
                failures.append(
                    f"64 x 48KiB writes into a {cap}-byte store never "
                    f"hit the failsafe")
            elif blocked.code != -_errno.ENOSPC:
                failures.append(f"failsafe refusal untyped "
                                f"(code {blocked.code}): {blocked}")
            osd = next(iter(cluster.osds.values()))
            st = osd.store.statfs()
            if st["used"] > int(cap * 0.98):
                failures.append(f"store burst past the failsafe: "
                                f"used {st['used']} of {cap}")
            await verify_acked(c, pool, acked, failures, "capacity-full")
            # the ONLY way out: delete (exempt from every gate)
            for oid in list(acked)[: len(acked) * 2 // 3]:
                await c.delete(pool, oid)
                del acked[oid]

            async def can_write():
                try:
                    await c.put(pool, "after-drain", b"z" * 4096)
                    return True
                except RadosError:
                    return False

            if await wait_for(can_write, args.full_seconds,
                              "writes to resume after the drain",
                              failures):
                acked["after-drain"] = b"z" * 4096
            await verify_acked(c, pool, acked, failures, "drained")
            await c.stop()
        finally:
            await cluster.stop()

    async def leg_backfillfull(failures) -> None:
        conf = {"osd_auto_repair": True, "osd_heartbeat_interval": 0.1,
                "mon_osd_report_grace": 1.0,
                "osd_backfill_toofull_retry": 0.3,
                "osd_repair_delay": 0.1,
                "client_op_timeout": 5.0, "client_op_deadline": 6.0}
        cluster = _cluster(args, max(4, args.full_osds), conf)
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("bf", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            acked = {}
            for i in range(8):
                blob = _os.urandom(40_000 + 531 * i)
                await c.put(pool, f"b{i}", blob)
                acked[f"b{i}"] = blob
            ids = sorted(cluster.osds)
            target, dead = ids[0], ids[-1]
            cluster.conf["osd_debug_inject_full"] = f"{target}:0.92"

            async def target_backfillfull():
                h = await c.get_health()
                util = h.get("osd_utilization") or {}
                return (util.get(target)
                        or {}).get("state") == "backfillfull"

            await wait_for(target_backfillfull, args.full_seconds,
                           "backfillfull state", failures)
            # force backfill whose reservations land on the injected OSD
            await cluster.kill_osd(dead)

            async def parked():
                h = await c.get_health(detail=True)
                return "PG_BACKFILL_FULL" in (h.get("checks") or {})

            await wait_for(parked, args.full_seconds,
                           "PG_BACKFILL_FULL (backfill_toofull park)",
                           failures)
            # the target frees space -> the parked reservation retries
            # through and backfill completes
            cluster.conf["osd_debug_inject_full"] = ""

            async def resumed():
                h = await c.get_health(detail=True)
                checks = set(h.get("checks") or {})
                return not ({"PG_BACKFILL_FULL", "OSD_BACKFILLFULL"}
                            & checks)

            await wait_for(resumed, max(args.full_seconds, 15.0),
                           "backfill to resume after the target freed "
                           "space", failures)
            await verify_acked(c, pool, acked, failures, "backfilled")
            await c.stop()
        finally:
            cluster.conf["osd_debug_inject_full"] = ""
            await cluster.stop()

    async def go() -> int:
        failures: list = []
        for name, leg in (("injected-ladder", leg_injected),
                          ("real-capacity", leg_capacity),
                          ("backfillfull", leg_backfillfull)):
            t0 = _time.monotonic()
            try:
                await leg(failures)
            except Exception as e:
                import traceback

                traceback.print_exc()
                failures.append(f"[{name}] leg crashed: "
                                f"{type(e).__name__}: {e}")
            print(f"full: leg {name} done in "
                  f"{_time.monotonic() - t0:.1f}s "
                  f"({len(failures)} cumulative failures)")
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_rebalance(args) -> int:
    """Elastic-membership coexistence gate (CI), the acceptance bar of
    the r18 plane, runnable as one FAILING command:

        python -m ceph_tpu_torch.tools.non_regression --rebalance

    Two legs:

    1. COEXISTENCE CYCLE: an `osd out` -> backfill-drain -> `osd in` ->
       refill -> `osd reweight` -> crush bucket-move (a host bucket
       appears and the victim migrates into it, mid-traffic, remap
       converging to zero degraded PGs) cycle runs while a RESERVED tenant
       (qos_class:gold) and a best-effort tenant drive verified
       read/write traffic AND pool-wide deep scrub fans out — the
       scrub + rebalance + client coexistence the background dmClock
       classes exist for.  Fails unless: the cycle converges (the out
       OSD drains to zero shards, refills after `in`), the reserved
       tenant has ZERO acked-op failures and every read was
       byte-identical, all data is byte-identical after convergence,
       the sweeps were CLASSED (rebalance/scrub dmClock enqueues moved),
       data actually moved, no PG_INCONSISTENT is left raised, and the
       reserved tenant's p99 during the cycle stays bounded:
       <= max(2x its solo p99, 1.5x the best-effort p99 of the SAME
       window, 250ms).  The best-effort and absolute terms absorb
       1-2-core CI hosts where process-wide CPU contention inflates
       every op (one event loop carries the whole cluster) — a real
       throttling regression shows gold >> best-effort in the same
       window and blows past all three terms.

    2. BACKFILLFULL PARK: the same out-drain aimed at a target past its
       backfillfull ratio parks (PG_BACKFILL_FULL raises) instead of
       stampeding the full disk, then resumes and completes when the
       target frees space — rebalance rides the r15 fullness gates.
    """
    import asyncio
    import os as _os
    import time as _time

    from ceph_tpu_torch.tools.traffic import TenantClass, TrafficHarness

    async def wait_for(pred, seconds, what, failures):
        deadline = _time.monotonic() + seconds
        while _time.monotonic() < deadline:
            r = pred()
            if asyncio.iscoroutine(r):
                r = await r
            if r:
                return True
            await asyncio.sleep(0.1)
        failures.append(f"timed out waiting for {what}")
        return False

    def shards_on(osd, pool):
        return sum(1 for (p, _o, _s) in osd.store._data if p == pool)

    async def leg_coexistence(failures) -> None:
        conf = {"osd_op_queue": "mclock",
                "osd_mclock_profile": "balanced",
                "osd_auto_repair": True,
                "osd_heartbeat_interval": 0.1,
                "osd_repair_delay": 0.1,
                "osd_recovery_retry": 0.3,
                "mon_osd_report_grace": 2.0,
                "client_op_timeout": 30.0,
                "client_op_deadline": 60.0}
        cluster = _cluster(args, max(4, args.rebalance_osds), conf)
        await cluster.start()
        try:
            c0 = await cluster.client()
            pool = await c0.create_pool("rebal", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            await c0.pool_set(pool, "qos_class:gold", "100:20:0:0.5")
            c_gold = await cluster.client()
            c_be = await cluster.client()
            gold = TenantClass("gold", c_gold, tenants=1, workers=4,
                               rate=40.0)
            be = TenantClass("", c_be, tenants=8, workers=2, rate=20.0)
            h = TrafficHarness([gold, be], pool, n_objects=24,
                               obj_size=24 << 10, verify=True)
            await h.preload()
            victim_id = sorted(cluster.osds)[0]
            victim = cluster.osds[victim_id]
            await wait_for(lambda: shards_on(victim, pool) > 0, 10.0,
                           "the victim to hold shards", failures)
            shards_before = shards_on(victim, pool)

            solo = await h.run_phase("solo", 3.0, 0.25, classes=[gold])
            solo_p99 = solo.summary().get("gold", {}).get(
                "get", {}).get("p99_us", 0.0)

            moved0 = sum(o.perf.get("rebalance_bytes_moved")
                         for o in cluster.osds.values())
            scrub_stats = {"scrubbed": 0, "errors": 0}
            cycle_done = asyncio.Event()

            async def scrub_loop():
                # pool-wide deep scrub fanning out CONCURRENTLY with the
                # rebalance and the client traffic — the coexistence
                # under test
                while not cycle_done.is_set():
                    try:
                        res = await c0.deep_scrub(pool)
                        scrub_stats["scrubbed"] += res.get("scrubbed", 0)
                        scrub_stats["errors"] += res.get("errors", 0)
                    except Exception:
                        pass
                    await asyncio.sleep(0.2)

            async def cycle():
                try:
                    await c0.osd_out(victim_id)
                    await wait_for(
                        lambda: shards_on(victim, pool) == 0,
                        args.rebalance_seconds,
                        "the out OSD to drain", failures)
                    await c0.osd_in(victim_id)
                    await wait_for(
                        lambda: shards_on(victim, pool)
                        >= max(1, shards_before // 2),
                        args.rebalance_seconds,
                        "the re-added OSD to refill", failures)
                    await c0.osd_reweight(victim_id, 0.5)
                    await asyncio.sleep(0.5)  # remap settles under load
                    await c0.osd_reweight(victim_id, 1.0)
                    # bucket-move leg: runtime crush surgery mid-traffic
                    # — a host bucket appears and the victim migrates
                    # into it, the remap drains/refills through the same
                    # recovery machinery, still under the reserved
                    # tenant's zero-failure bar
                    await c0.osd_crush_op("add-bucket", "rebal-host",
                                          bucket_type="host")
                    await c0.osd_crush_op("move", f"osd.{victim_id}",
                                          dest="rebal-host")

                    async def move_clean():
                        # converged AND re-verified: a scrub racing the
                        # remap can transiently flag (and auto-repair)
                        # mid-backfill shards — hold the cycle open
                        # until a clean scrub clears the check
                        h = await c0.get_health()
                        checks = h.get("checks") or {}
                        return ("PG_DEGRADED" not in checks
                                and "PG_INCONSISTENT" not in checks)
                    await wait_for(move_clean, args.rebalance_seconds,
                                   "the bucket-move remap to converge "
                                   "and re-verify clean",
                                   failures)
                finally:
                    cycle_done.set()

            loop = asyncio.get_running_loop()
            scrub_task = loop.create_task(scrub_loop())
            cycle_task = loop.create_task(cycle())
            # the during-cycle traffic window: runs at least as long as
            # the cycle itself (phases repeat until the cycle finishes;
            # the FIRST phase overlaps the drain and carries the bound)
            during = await h.run_phase("rebalance", 4.0, 0.25)
            phases = [during]
            while not cycle_task.done():
                phases.append(await h.run_phase("rebalance-tail", 2.0,
                                                0.25))
            await cycle_task
            await scrub_task
            moved = sum(o.perf.get("rebalance_bytes_moved")
                        for o in cluster.osds.values()) - moved0

            dur_s = during.summary()
            gold_p99 = dur_s.get("gold", {}).get("get", {}).get(
                "p99_us", 0.0)
            be_p99 = dur_s.get("default", {}).get("get", {}).get(
                "p99_us", 0.0)
            gold_fail = (solo.summary().get("gold", {}).get("failures", 0)
                         + sum(ph.summary().get("gold", {}).get(
                             "failures", 0) for ph in phases))
            if gold_fail:
                failures.append(f"reserved tenant had {gold_fail} "
                                "acked-op failures during the cycle "
                                "(must be 0)")
            if moved <= 0:
                failures.append("no rebalance bytes were moved "
                                "(rebalance_bytes_moved stayed 0)")
            classed = sum(o.sched_perf.get("enqueue_rebalance")
                          for o in cluster.osds.values())
            scrub_classed = sum(o.sched_perf.get("enqueue_scrub")
                                for o in cluster.osds.values())
            if classed <= 0:
                failures.append("rebalance sweeps were never CLASSED "
                                "(enqueue_rebalance stayed 0)")
            if scrub_classed <= 0:
                failures.append("scrub sweeps were never CLASSED "
                                "(enqueue_scrub stayed 0)")
            if scrub_stats["scrubbed"] <= 0:
                failures.append("deep scrub never ran during the cycle")
            bound = max(2.0 * solo_p99, 1.5 * be_p99, 250_000.0)
            if not solo_p99 or not gold_p99:
                failures.append("reserved tenant percentiles missing "
                                f"(solo={solo_p99}, during={gold_p99})")
            elif gold_p99 > bound:
                failures.append(
                    f"reserved get p99 unbounded during rebalance: "
                    f"{gold_p99:.0f}us > max(2x solo {solo_p99:.0f}us, "
                    f"1.5x best-effort {be_p99:.0f}us, 250ms)")
            # convergence: every byte identical to the harness's
            # deterministic expectation
            for oid, want in h.blobs.items():
                try:
                    got = await c0.get(pool, oid)
                except Exception as e:
                    failures.append(f"{oid} unreadable after "
                                    f"convergence: {e}")
                    continue
                if bytes(got) != want:
                    failures.append(f"{oid} NOT byte-identical after "
                                    "convergence")
            h2 = await c0.get_health(detail=True)
            if "PG_INCONSISTENT" in (h2.get("checks") or {}):
                failures.append("PG_INCONSISTENT left raised after the "
                                "cycle (scrub found lasting damage)")
            window_s = during.seconds or 1.0
            print(f"rebalance: moved {moved / 1e6:.2f} MB "
                  f"({moved / window_s / 1e6:.2f} MB/s over the "
                  f"{window_s:.1f}s window), gold p99 solo "
                  f"{solo_p99:.0f}us -> during {gold_p99:.0f}us "
                  f"(best-effort {be_p99:.0f}us), rebalance enqueues "
                  f"{classed}, scrub enqueues {scrub_classed}, scrubbed "
                  f"{scrub_stats['scrubbed']} objects, "
                  f"{len(failures)} failures")
            for c in (c0, c_gold, c_be):
                await c.stop()
        finally:
            await cluster.stop()

    async def leg_backfillfull(failures) -> None:
        conf = {"osd_op_queue": "mclock",
                "osd_auto_repair": True,
                "osd_heartbeat_interval": 0.1,
                "osd_repair_delay": 0.1,
                "osd_recovery_retry": 0.3,
                "osd_backfill_toofull_retry": 0.3,
                "mon_osd_report_grace": 2.0,
                "client_op_timeout": 10.0, "client_op_deadline": 20.0}
        cluster = _cluster(args, max(4, args.rebalance_osds), conf)
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("rebalbf", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            acked = {}
            for i in range(8):
                blob = _os.urandom(40_000 + 531 * i)
                await c.put(pool, f"b{i}", blob)
                acked[f"b{i}"] = blob
            ids = sorted(cluster.osds)
            victim_id, target = ids[0], ids[1]
            victim = cluster.osds[victim_id]
            await wait_for(lambda: shards_on(victim, pool) > 0, 10.0,
                           "the victim to hold shards", failures)
            # a rebalance target past its backfillfull ratio: the drain
            # must PARK, not stampede the full disk
            cluster.conf["osd_debug_inject_full"] = f"{target}:0.92"

            async def target_backfillfull():
                h = await c.get_health()
                util = h.get("osd_utilization") or {}
                return (util.get(target)
                        or {}).get("state") == "backfillfull"

            await wait_for(target_backfillfull, args.rebalance_seconds,
                           "backfillfull state", failures)
            await c.osd_out(victim_id)

            async def parked():
                h = await c.get_health(detail=True)
                return "PG_BACKFILL_FULL" in (h.get("checks") or {})

            await wait_for(parked, args.rebalance_seconds,
                           "PG_BACKFILL_FULL (rebalance parked at the "
                           "backfillfull target)", failures)
            # space frees -> the parked rebalance resumes and completes
            cluster.conf["osd_debug_inject_full"] = ""
            await wait_for(lambda: shards_on(victim, pool) == 0,
                           max(args.rebalance_seconds, 20.0),
                           "the drain to resume and complete after the "
                           "target freed space", failures)
            for oid, want in acked.items():
                got = await c.get(pool, oid)
                if bytes(got) != want:
                    failures.append(f"{oid} NOT byte-identical after "
                                    "the parked-then-resumed drain")
            print(f"rebalance-backfillfull: parked and resumed, "
                  f"{len(failures)} cumulative failures")
            await c.stop()
        finally:
            cluster.conf["osd_debug_inject_full"] = ""
            await cluster.stop()

    async def go() -> int:
        failures: list = []
        for name, leg in (("coexistence", leg_coexistence),
                          ("backfillfull-park", leg_backfillfull)):
            t0 = _time.monotonic()
            try:
                await leg(failures)
            except Exception as e:
                import traceback

                traceback.print_exc()
                failures.append(f"[{name}] leg crashed: "
                                f"{type(e).__name__}: {e}")
            print(f"rebalance: leg {name} done in "
                  f"{_time.monotonic() - t0:.1f}s "
                  f"({len(failures)} cumulative failures)")
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_lifecycle(args) -> int:
    """Node-lifecycle thrash gate (CI), the acceptance bar of the
    membership lifecycle plane, runnable as one FAILING command:

        python -m ceph_tpu_torch.tools.non_regression --lifecycle

    One arc, every step verified, all of it under continuous verified
    client traffic:

      1. `osd crush add-bucket` a host, `osd crush move` an OSD into it
         — the remap converges to zero degraded PGs mid-traffic.
      2. Kill a DIFFERENT OSD.  With `noout` set the mon must NOT
         auto-out it (the freeze flag); after `osd unset noout` the
         auto-out fires on its own (mon_osd_down_out_interval).
      3. Recovery drains the dead member: acting sets rebuild full,
         `osd safe-to-destroy` flips green (it REFUSED while PGs still
         mapped to the victim or weren't fully recovered).
      4. `osd purge` removes the victim from map + crush; `osd tree`
         no longer shows it.
      5. Byte-identity sweep over every object; the traffic harness
         must report ZERO acked-op failures across the whole arc.
    """
    import asyncio
    import time as _time

    from ceph_tpu_torch.tools.traffic import TenantClass, TrafficHarness

    async def wait_for(pred, seconds, what, failures):
        deadline = _time.monotonic() + seconds
        while _time.monotonic() < deadline:
            r = pred()
            if asyncio.iscoroutine(r):
                r = await r
            if r:
                return True
            await asyncio.sleep(0.1)
        failures.append(f"timed out waiting for {what}")
        return False

    async def go() -> int:
        failures: list = []
        conf = {"osd_auto_repair": True,
                "osd_heartbeat_interval": 0.1,
                "osd_repair_delay": 0.1,
                "osd_recovery_retry": 0.3,
                "mon_osd_report_grace": 1.5,
                "mon_osd_down_out_interval": 0.6,
                "mon_osd_min_in_ratio": 0.3,
                "client_op_timeout": 30.0,
                "client_op_deadline": 60.0}
        cluster = _cluster(args, max(5, args.lifecycle_osds), conf)
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("life", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            c_t = await cluster.client()
            traffic = TenantClass("", c_t, tenants=4, workers=2,
                                  rate=25.0)
            h = TrafficHarness([traffic], pool, n_objects=24,
                               obj_size=24 << 10, verify=True)
            await h.preload()
            ids = sorted(cluster.osds)
            moved_id, victim_id = ids[0], ids[1]

            arc_done = asyncio.Event()
            arc_failures: list = []

            async def arc():
                try:
                    # 1. crush surgery + convergence
                    await c.osd_crush_op("add-bucket", "life-host",
                                         bucket_type="host")
                    await c.osd_crush_op("move", f"osd.{moved_id}",
                                         dest="life-host")
                    if c.osdmap.crush.parent_of(moved_id) != \
                            c.osdmap.crush.bucket_by_name("life-host").id:
                        arc_failures.append(
                            "crush move did not re-parent the OSD")

                    async def clean():
                        hh = await c.get_health()
                        return "PG_DEGRADED" not in (hh.get("checks")
                                                     or {})
                    await wait_for(clean, args.lifecycle_seconds,
                                   "the bucket-move remap to converge",
                                   arc_failures)
                    # 2. kill under noout: the freeze flag must hold
                    await c.osd_set_flag("noout", True)
                    await cluster.kill_osd(victim_id)
                    await wait_for(
                        lambda: _refresh_not_up(c, victim_id),
                        args.lifecycle_seconds,
                        "the mon to mark the victim down", arc_failures)
                    await asyncio.sleep(1.5)  # > down_out_interval
                    await c.refresh_map()
                    if not c.osdmap.osds[victim_id].in_cluster:
                        arc_failures.append(
                            "auto-out fired UNDER noout (the freeze "
                            "flag must block it)")
                    # safe-to-destroy must refuse while PGs still map
                    # to (or are degraded by) the down victim
                    r = await c.osd_safe_to_destroy(victim_id)
                    if r.safe:
                        arc_failures.append(
                            "safe-to-destroy said SAFE while the "
                            "victim's PGs were still degraded")
                    # 3. unset -> auto-out fires on its own
                    await c.osd_set_flag("noout", False)

                    async def outed():
                        await c.refresh_map()
                        i = c.osdmap.osds[victim_id]
                        return (not i.up) and (not i.in_cluster)
                    await wait_for(outed, args.lifecycle_seconds,
                                   "auto-out after noout cleared",
                                   arc_failures)
                    # drain: recovery rebuilds full acting sets

                    async def std_green():
                        await c.refresh_map()
                        return (await c.osd_safe_to_destroy(
                            victim_id)).safe
                    await wait_for(std_green,
                                   max(args.lifecycle_seconds, 40.0),
                                   "safe-to-destroy to flip green",
                                   arc_failures)
                    # 4. purge: gone from map AND crush
                    await c.osd_purge(victim_id)
                    await c.refresh_map()
                    if victim_id in c.osdmap.osds:
                        arc_failures.append("victim still in the "
                                            "osdmap after purge")
                    if victim_id in c.osdmap.crush.devices():
                        arc_failures.append("victim still in the "
                                            "crush map after purge")
                finally:
                    arc_done.set()

            loop = asyncio.get_running_loop()
            arc_task = loop.create_task(arc())
            phases = [await h.run_phase("lifecycle", 4.0, 0.25)]
            while not arc_task.done():
                phases.append(await h.run_phase("lifecycle-tail", 2.0,
                                                0.25))
            await arc_task
            failures.extend(arc_failures)
            # 5. zero acked-op loss + byte identity
            lost = sum(ph.summary().get("default", {}).get(
                "failures", 0) for ph in phases)
            if lost:
                failures.append(f"{lost} acked-op failures during the "
                                f"lifecycle arc (must be 0)")
            for oid, want in h.blobs.items():
                try:
                    got = await c.get(pool, oid)
                except Exception as e:
                    failures.append(f"{oid} unreadable after the arc: "
                                    f"{e}")
                    continue
                if bytes(got) != want:
                    failures.append(f"{oid} NOT byte-identical after "
                                    "the lifecycle arc")
            auto_outs = cluster.mon.perf.get("auto_outs")
            if auto_outs < 1:
                failures.append("mon auto_outs counter never moved")
            print(f"lifecycle: arc complete, auto_outs {auto_outs}, "
                  f"crush_moves {cluster.mon.perf.get('crush_moves')}, "
                  f"predicate_queries "
                  f"{cluster.mon.perf.get('predicate_queries')}, "
                  f"{len(failures)} failures")
            for cl in (c, c_t):
                await cl.stop()
        finally:
            await cluster.stop()
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    async def _refresh_not_up(c, osd_id) -> bool:
        await c.refresh_map()
        return not c.osdmap.osds[osd_id].up

    return asyncio.run(go())


def run_device_parity_child(args) -> int:
    """ONE slab arm's writeback lifecycle (the arm is whatever
    CEPH_TPU_DEVICE_SLAB says when the store builds): deterministic
    puts under cache_mode=writeback -> dirty pages -> agent flush ->
    evict -> cold re-read, byte identity checked at every read, and a
    ``DEVICE_PARITY {json}`` digest line for the parent to compare
    across arms."""
    import asyncio
    import hashlib
    import json
    import os as _os

    _os.environ["CEPH_TPU_FORCE_BATCH"] = "1"

    import ceph_tpu_torch.rados.osd as osdmod

    async def go() -> int:
        conf = {"osd_auto_repair": False, "client_op_timeout": 60.0,
                "osd_heartbeat_interval": 0.1,
                "osd_hit_set_period": 0.5,
                "osd_min_read_recency_for_promote": 1,
                "osd_tier_agent_interval": 0.1,
                "osd_tier_target_max_bytes": 8 << 20,
                "osd_cache_target_full_ratio": 0.8,
                "osd_tier_flush_age": 0.3}
        cluster = _cluster(args, 3, conf)
        await cluster.start()
        failures = []
        digests = {}
        snap = {}
        try:
            c = await cluster.client()
            pool = await c.create_pool("devp", profile={
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            store = osdmod.shared_planar_store(device=args.device)
            if store is None or not hasattr(store, "dirty_items"):
                print("FAIL paged planar store did not engage",
                      file=sys.stderr)
                return 1
            await c.pool_set(pool, "cache_mode", "writeback")
            for o in cluster.osds.values():
                for _ in range(100):
                    p = (o.osdmap.pools.get(pool) if o.osdmap else None)
                    if p is not None and (getattr(p, "opts", {})
                                          or {}).get("cache_mode") \
                            == "writeback":
                        break
                    await asyncio.sleep(0.02)
            # DETERMINISTIC content: both arms must produce the same
            # bytes at every stage or the parent's digest compare fails
            rng = np.random.default_rng(20260806)
            blobs = {
                f"wb{i}": rng.integers(
                    0, 256, 120_000 + 4096 * i,
                    dtype=np.uint8).tobytes()
                for i in range(6)}
            saw_dirty = False
            for oid, data in blobs.items():
                await c.put(pool, oid, data)
                saw_dirty = saw_dirty or store.dirty_pages > 0
            if not saw_dirty:
                failures.append("writeback puts left no dirty pages")
            for oid, want in blobs.items():
                got = await c.get(pool, oid)
                if got != want:
                    failures.append(
                        f"dirty resident read mismatch on {oid}")
            for _ in range(200):
                if not store.has_dirty():
                    break
                await asyncio.sleep(0.05)
            if store.dirty_pages:
                failures.append(
                    f"dirty_pages {store.dirty_pages} never drained")
            for o in cluster.osds.values():
                if o._planar is not None:
                    for oid in blobs:
                        o._planar.drop(o._planar_key(pool, oid))
            for oid, want in blobs.items():
                got = await c.get(pool, oid, fadvise="dontneed")
                if got != want:
                    failures.append(
                        f"post-flush cold read mismatch on {oid}")
                digests[oid] = hashlib.sha256(got).hexdigest()
            if hasattr(store, "page_stats"):
                snap = store.page_stats()
            await c.stop()
        finally:
            await cluster.stop()
        print("DEVICE_PARITY " + json.dumps({
            "digests": digests,
            "device_arm": snap.get("device_arm", 0),
            "device_slabs": snap.get("device_slabs", 0),
            "h2d_installs": snap.get("h2d_installs", 0),
            "device_installs": snap.get("device_installs", 0),
            "d2h_gathers": snap.get("d2h_gathers", 0)}))
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    return asyncio.run(go())


def run_device_parity(args) -> int:
    """Slab-arm parity gate (CI), FAILING and runnable as one command:

        python -m ceph_tpu_torch.tools.non_regression --device-parity

    Two children run the identical writeback cycle on --device — one
    with CEPH_TPU_DEVICE_SLAB=1 (the device arm: CUDA sub-slabs on the
    card; torch-CPU slabs, the same call structure, with --device cpu)
    and one with =0 (the pinned host arm).  Every cold-re-read digest
    must match across arms, the device child must actually have engaged
    the device arm, and the host child must not have."""
    import json
    import subprocess

    results = {}
    for arm, env_val in (("device", "1"), ("host", "0")):
        env = dict(os.environ)
        env["CEPH_TPU_DEVICE_SLAB"] = env_val
        env["CEPH_TPU_FORCE_BATCH"] = "1"
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.non_regression",
             "--device-parity-child", "--device", args.device],
            env=env, capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("DEVICE_PARITY ")), None)
        if proc.returncode != 0 or line is None:
            print(f"FAIL {arm}-arm child rc={proc.returncode}",
                  file=sys.stderr)
            print(proc.stdout[-2000:], file=sys.stderr)
            return 1
        results[arm] = json.loads(line[len("DEVICE_PARITY "):])
        print(f"device parity {arm} child: " + json.dumps(
            {k: v for k, v in results[arm].items() if k != "digests"}))
    dev, host = results["device"], results["host"]
    failures = []
    if dev["digests"] != host["digests"]:
        diff = [oid for oid in dev["digests"]
                if dev["digests"].get(oid) != host["digests"].get(oid)]
        failures.append(
            f"device vs host arm cold-re-read digests diverge on "
            f"{diff} — the byte-identity gate")
    if not dev["device_arm"]:
        failures.append("CEPH_TPU_DEVICE_SLAB=1 child did not engage "
                        "the device arm")
    if host["device_arm"]:
        failures.append("CEPH_TPU_DEVICE_SLAB=0 child engaged the "
                        "device arm")
    if not (dev["h2d_installs"] + dev["device_installs"]):
        failures.append("device arm recorded no installs (kernels "
                        "never ran)")
    print(f"device parity: {len(dev['digests'])} writeback objects "
          f"byte-identical across slab arms; device arm "
          f"slabs={dev['device_slabs']} h2d={dev['h2d_installs']} "
          f"native={dev['device_installs']} d2h={dev['d2h_gathers']}")
    for f in failures:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.slow_ops:
        return run_slow_ops(args)
    if args.crash:
        return run_crash(args)
    if args.qos:
        return run_qos(args)
    if args.device_parity:
        return run_device_parity(args)
    if args.device_parity_child:
        return run_device_parity_child(args)
    if args.tier:
        return run_tier(args)
    if args.full:
        return run_full(args)
    if args.rebalance:
        return run_rebalance(args)
    if args.lifecycle:
        return run_lifecycle(args)
    if args.chaos:
        return run_chaos(args)
    if args.wire_floor:
        return run_wire_floor(args)
    if not args.create and not args.check:
        print("must specify either --check, or --create", file=sys.stderr)
        return 1
    try:
        if args.create:
            code = run_create(args)
            if code:
                return code
        if args.check:
            return run_check(args)
    except Exception as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


def _close_batching_queue() -> None:
    """Stop the process's batching queue, if a gate's OSDs started one:
    its worker thread must not be polling the card while the interpreter
    tears CUDA down at exit."""
    osdmod = sys.modules.get("ceph_tpu_torch.rados.osd")
    if osdmod is not None and osdmod._BATCH_QUEUE is not None:
        osdmod._BATCH_QUEUE.close()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        _close_batching_queue()
    sys.exit(code)
