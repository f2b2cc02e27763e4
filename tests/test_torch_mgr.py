"""The port's mgr daemon against ceph_tpu's.

The port's mgr is a copy of the reference's: fed the same daemon reports,
both render the same /metrics bytes; their balancer and pg autoscaler make
the same proposals on the same maps; and an MMgrReport frame encodes to the
same bytes.  One port cluster (5 OSDs, a plugin=cuda k=2 m=1 pool of 16 PGs
on the CPU, CEPH_TPU_FORCE_BATCH=1, the mgr started by vstart) gives the
recorded reports and the map, and shows its OSDs' ``ec_cuda`` counters on
the mgr's /metrics: the reference's OSDs export ``ceph_ec_tpu_*``, the
port's ``ceph_ec_cuda_*``.  The mgr part of tests/test_mgr_tools.py runs on
it as well.
"""

import asyncio
import copy
import io
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from ceph_tpu.common.perf_counters import \
    PerfCountersBuilder as RefPerfCountersBuilder
from ceph_tpu.mgr.daemon import MgrDaemon as RefMgrDaemon
from ceph_tpu.mgr.daemon import MMgrReport as RefMMgrReport
from ceph_tpu.mgr.modules import Balancer as RefBalancer
from ceph_tpu.mgr.modules import PgAutoscaler as RefPgAutoscaler
from ceph_tpu.rados.messenger import \
    encode_payload_parts as ref_encode_payload_parts
from ceph_tpu.rados.types import PoolInfo as RefPoolInfo
from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.mgr.daemon import MgrDaemon, MMgrReport
from ceph_tpu_torch.mgr.modules import Balancer, PgAutoscaler
from ceph_tpu_torch.rados import osd as port_osd
from ceph_tpu_torch.rados.clog import build_crash_report
from ceph_tpu_torch.rados.messenger import encode_payload_parts
from ceph_tpu_torch.rados.types import MCrashReport, PoolInfo
from ceph_tpu_torch.rados.vstart import Cluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {"osd_auto_repair": False, "osd_heartbeat_interval": 0.1,
        "osd_ec_device": "cpu"}
PROFILE = {"plugin": "cuda", "technique": "reed_sol_van", "k": "2", "m": "1"}


def payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class _ToReference(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("ceph_tpu_torch."):
            module = "ceph_tpu." + module[len("ceph_tpu_torch."):]
        return super().find_class(module, name)


def to_reference(obj):
    """A port object (an OSDMap) as the same object of ceph_tpu's classes."""
    return _ToReference(io.BytesIO(pickle.dumps(obj))).load()


async def http_get(addr, path):
    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    head = await reader.readline()
    body = await reader.read(-1)
    writer.close()
    return head, body[body.index(b"\r\n\r\n") + 4:] if b"\r\n\r\n" in body \
        else body


@pytest.fixture(scope="module")
def cluster_run():
    """The port cluster's reports, scrapes and map after EC puts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CEPH_TPU_FORCE_BATCH", "1")
        mp.setattr(port_osd, "_BATCH_QUEUE", None)
        mp.setattr(port_osd, "_PLANAR_STORE", None)

        async def go():
            cluster = Cluster(n_osds=5, conf=dict(CONF), with_mgr=True)
            await cluster.start()
            c = await cluster.client()
            try:
                pool = await c.create_pool("b", pg_num=16, profile=PROFILE)
                for i in range(5):
                    await c.put(pool, f"o{i}", payload(8_000, i))
                mgr = cluster.mgr
                # every daemon reports again after the last put
                since = max((r.stamp for r in mgr.reports.values()),
                            default=0.0)
                names = {f"osd.{i}" for i in cluster.osds} | {"mon.0"}
                for _ in range(200):
                    if names <= set(mgr.reports) and all(
                            mgr.reports[n].stamp > since for n in names):
                        break
                    await asyncio.sleep(0.05)
                queue = port_osd._BATCH_QUEUE
                out = {
                    "pool": pool, "osds": sorted(cluster.osds),
                    "reports": {n: copy.deepcopy(vars(r))
                                for n, r in mgr.reports.items()},
                    "health": copy.deepcopy(mgr.latest_health),
                    "status": mgr.daemon_status(),
                    "text": mgr.prometheus_text(),
                    "queue_dispatch": queue.perf.get("dispatch"),
                    "osdmap": pickle.loads(pickle.dumps(c.osdmap))}
                for path in ("/metrics", "/dashboard", "/status"):
                    out[path] = await http_get(mgr.http_addr, path)
                try:
                    raise RuntimeError("daemon exploded")
                except RuntimeError as e:
                    report = build_crash_report(e, "osd.0")
                out["crash_report"] = report
                await next(iter(cluster.osds.values())).messenger.send(
                    mgr.addr, report)
                for _ in range(200):
                    if mgr.crash_ls():
                        break
                    await asyncio.sleep(0.05)
                out["crash_ls"] = mgr.crash_ls()
                out["crash_info"] = (mgr.crash_info(out["crash_ls"][0])
                                     if out["crash_ls"] else None)
                return out
            finally:
                await c.stop()
                await cluster.stop()

        try:
            return asyncio.run(asyncio.wait_for(go(), 120))
        finally:
            if port_osd._BATCH_QUEUE is not None:
                port_osd._BATCH_QUEUE.close()


# -- /metrics: the same reports render the same bytes ------------------------

def synthetic_reports():
    """Every kind of value the renderer knows: plain counters, longrunavg
    pairs, power-of-two histograms (empty leading slots, a clamped last
    slot), and values it skips."""
    return {
        "osd.0": {"perf": {
            "osd": {"op_w": 12, "op_r": 3, "op_lat": {"avgcount": 4,
                                                      "sum": 0.125},
                    "note": "skipped", "ratio": 0.75},
            "ec_cuda": {"dispatch": 9, "group_size": {
                "buckets": [0, 0, 3, 1, 0, 2, 0, 0, 5],
                "sum": 77, "count": 11}}},
            "status": {"osd_id": 0}, "stamp": 1.5},
        "mon.0": {"perf": {"mon": {"elections": 1}, "empty": {}},
                  "status": {"rank": 0}, "stamp": 2.5},
    }


SYNTHETIC_HEALTH = {
    "status": "HEALTH_WARN",
    "checks": {"SLOW_OPS": {"severity": "warning", "count": 2},
               "OSD_DOWN": {"severity": "warning"}},
    "muted": {"POOL_NEARFULL": {}},
    "osd_utilization": {0: {"ratio": 0.5, "used": 10, "total": 20,
                            "state": "nearfull"},
                        1: {"ratio": 0.1, "used": 1, "total": 10}},
}


def mgr_text(Mgr, Report, Builder, reports, health, own):
    mgr = Mgr({})
    mgr.reports = {name: Report(name=name, **copy.deepcopy(fields))
                   for name, fields in reports.items()}
    mgr.latest_health = copy.deepcopy(health)
    if own:
        pc = (Builder("objecter").add_u64_counter("op_resend")
              .add_time_avg("op_latency").add_histogram("batch")
              .create_perf_counters())
        pc.inc("op_resend", 3)
        pc.tinc("op_latency", 0.5)
        for v in (1, 2, 2, 9):
            pc.hinc("batch", v)
        mgr.extra_perf.add(pc)
    return mgr.prometheus_text()


@pytest.mark.parametrize("source", ["recorded", "synthetic"])
def test_prometheus_text_matches_reference(cluster_run, source):
    if source == "recorded":
        reports = {n: {k: v for k, v in r.items() if k != "name"}
                   for n, r in cluster_run["reports"].items()}
        health, own = cluster_run["health"], False
    else:
        reports, health, own = synthetic_reports(), SYNTHETIC_HEALTH, True
    got = mgr_text(MgrDaemon, MMgrReport, PerfCountersBuilder, reports,
                   health, own)
    want = mgr_text(RefMgrDaemon, RefMMgrReport, RefPerfCountersBuilder,
                    reports, health, own)
    assert got == want
    assert "ceph_mgr_daemons_reporting" in got
    if source == "synthetic":
        assert 'ceph_ec_cuda_group_size_bucket{daemon="osd.0",le="+Inf"} 11' \
            in got
        assert 'ceph_osd_full_state{osd="0",state="nearfull"} 1' in got


def test_mmgrreport_frame_matches_reference(cluster_run):
    fields = {k: v for k, v in cluster_run["reports"]["osd.0"].items()}
    port, ref = MMgrReport(**fields), RefMMgrReport(**fields)
    assert (MMgrReport.TYPE_ID, MMgrReport.VERSION) == \
        (RefMMgrReport.TYPE_ID, RefMMgrReport.VERSION) == (50, 1)
    assert encode_payload_parts(port) == ref_encode_payload_parts(ref)


def test_wire_type_50_is_registered_once():
    from ceph_tpu_torch.rados import messenger

    assert messenger._MSG_TYPES[50] is MMgrReport
    assert [c for c in messenger._MSG_IDS if c.__name__ == "MMgrReport"] \
        == [MMgrReport]


# -- the active modules: the same proposals on the same maps -----------------

def test_balancer_proposals_match_reference(cluster_run):
    """The reference's skew case (tests/test_mgr_modules.py): four PGs
    upmapped onto the busiest OSD; both balancers propose the same moves,
    which bring the spread to at most 1."""
    osdmap = cluster_run["osdmap"]
    counts = Balancer.seat_counts(osdmap)
    hot = max(counts, key=counts.get)
    pool = osdmap.pools[cluster_run["pool"]]
    moved = 0
    for pg in range(pool.pg_num):
        seats = osdmap.pg_to_placed(pool, pg)
        if hot not in seats and moved < 4:
            osdmap.pg_upmap[(pool.pool_id, pg)] = [hot] + list(seats[1:])
            moved += 1
    ref_map = to_reference(osdmap)
    before = Balancer.seat_counts(osdmap)
    assert before == RefBalancer.seat_counts(ref_map)
    assert max(before.values()) - min(before.values()) >= 2
    props = Balancer(max_changes_per_round=8).compute(osdmap)
    assert props, "balancer proposed nothing for a skewed map"
    assert props == RefBalancer(max_changes_per_round=8).compute(ref_map)
    for pool_id, pg, seats in props:
        osdmap.pg_upmap[(pool_id, pg)] = seats
    after = Balancer.seat_counts(osdmap)
    assert max(after.values()) - min(after.values()) <= 1, (before, after)


@pytest.mark.parametrize("pg_num,objects,want", [
    (4, 100, None),        # within the band: no change
    (4, 32 * 64, 64),      # far above: grow to a power of two
    (128, 10, 4),          # far below from a big pool: shrink
    (16, 0, 4),            # an empty pool shrinks to pg_min
    (8, 32 * 8 * 5, 64),
    (4, 32 * 1024, 256),   # capped at pg_max
])
def test_autoscaler_proposals_match_reference(pg_num, objects, want):
    pool = PoolInfo(pool_id=1, name="p", pool_type="ec", pg_num=pg_num,
                    size=3, min_size=2)
    ref_pool = RefPoolInfo(pool_id=1, name="p", pool_type="ec",
                           pg_num=pg_num, size=3, min_size=2)
    got = PgAutoscaler(target_objects_per_pg=32).compute(pool, objects)
    assert got == RefPgAutoscaler(target_objects_per_pg=32).compute(
        ref_pool, objects)
    assert got == want


# -- the cluster: reports reach the mgr and its /metrics ---------------------

def test_cluster_exports_ec_cuda_series(cluster_run):
    """Every OSD reports its ec_cuda set: a dispatch series per OSD whose
    value is the process queue's own count (one queue serves every
    in-process OSD), and no ec_tpu series."""
    text = cluster_run["text"]
    lines = text.splitlines()
    want = cluster_run["queue_dispatch"]
    assert want > 0
    for osd_id in cluster_run["osds"]:
        assert f'ceph_ec_cuda_dispatch{{daemon="osd.{osd_id}"}} {want}' \
            in lines
    assert "ceph_ec_tpu_" not in text
    assert any(ln.startswith("ceph_health_status ") for ln in lines)


def test_reports_prometheus_and_crash(cluster_run):
    """tests/test_mgr_tools.py's mgr case on the port cluster."""
    assert len(cluster_run["reports"]) >= 6
    assert any(name.startswith("osd.") for name in cluster_run["status"])
    text = cluster_run["text"]
    assert "ceph_osd_op_w" in text and 'daemon="osd.' in text
    assert "ceph_osd_op_lat_sum" in text
    head, body = cluster_run["/metrics"]
    assert b"200" in head and b"ceph_mgr_daemons_reporting" in body
    assert b"ceph_ec_cuda_dispatch" in body
    head, page = cluster_run["/dashboard"]
    assert b"200" in head and b"ceph_tpu cluster" in page and b"osd." in page
    _, sjson = cluster_run["/status"]
    st = json.loads(sjson[sjson.index(b"{"):])
    assert st["num_daemons"] >= 6
    assert any(n.startswith("osd.") for n in st["daemons"])
    assert isinstance(cluster_run["crash_report"], MCrashReport)
    assert cluster_run["crash_ls"]
    assert "daemon exploded" in cluster_run["crash_info"]["exception"]


MGR_WITHOUT_TORCH = """
import asyncio, sys
from ceph_tpu_torch.mgr.daemon import MgrDaemon

async def go():
    mgr = MgrDaemon({})
    addr = await mgr.start()
    assert addr and mgr.http_addr
    await mgr.stop()

asyncio.run(go())
print(",".join(sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch."))))
"""


def test_mgr_starts_without_torch():
    """The mgr runs no codec: it starts, serves and stops without
    importing torch, so a host without a card runs it."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", MGR_WITHOUT_TORCH], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
