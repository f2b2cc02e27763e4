"""The port's in-process cluster against ceph_tpu's, byte for byte.

One script runs on each package: a 7-OSD cluster with a k=4 m=2 EC pool
puts four objects, reads them, loses two acting OSDs, reads them degraded,
repairs the pool, loses a third OSD and reads them again.  The reference
runs ``plugin=tpu`` with JAX on the CPU (no queue: JAX_PLATFORMS=cpu);
the port runs ``plugin=cuda`` on the CPU (``osd_ec_device: cpu``, on which
the OSDs build their codecs, while the mon checks profiles on the CPU) with
CEPH_TPU_FORCE_BATCH=1, so that its batching queue and paged resident store
carry the writes, reads and recovery.  Every read, and every object's map of
shard index -> (stored bytes, HashInfo) after the put and after the repair,
must be equal across the two packages.

Beside it: the port's counterpart of the reference's residency test
(tests/test_planar.py, TestOsdPlanarResidency), of its sub-chunk recovery
test (tests/test_subchunk_recovery.py) and a mixed-layout pool run (four
pool layouts, full writes, partial overwrites and degraded reads against a
model); a mon without a card that accepts plugin=cuda pools, OSDs that build
codecs on their ``osd_ec_device``, an OSD that must refuse to start on a host
without CUDA when no CPU is named, and the mgr that vstart starts and the
OSDs report to.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.rados.crush import CRUSH_ITEM_NONE
from ceph_tpu.rados.mon import Monitor as RefMonitor
from ceph_tpu.rados.types import MCreatePool as RefMCreatePool
from ceph_tpu.rados.vstart import Cluster as RefCluster
from ceph_tpu_torch.rados import osd as port_osd
from ceph_tpu_torch.rados.mon import Monitor
from ceph_tpu_torch.rados.store import Transaction
from ceph_tpu_torch.rados.types import MCreatePool, PoolInfo
from ceph_tpu_torch.rados.pagestore import PagedResidentStore
from ceph_tpu_torch.rados.vstart import Cluster as PortCluster

FAST = {
    "mon_osd_report_grace": 0.8,
    "osd_heartbeat_interval": 0.2,
    "osd_repair_delay": 0.3,
    # long enough that the reference's first jit compile is not retried
    "client_op_timeout": 30.0,
}
SIZES = (10, 4096, 100_000, 256 << 10)
K, M = 4, 2


def payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture()
def port_cpu(monkeypatch):
    """The queue engages on the CPU for one test (CEPH_TPU_FORCE_BATCH=1),
    and the process-shared queue and store start and end with the test.
    The OSDs' conf names the CPU (``osd_ec_device: cpu``), on which they
    build their plugin=cuda codecs."""
    monkeypatch.setenv("CEPH_TPU_FORCE_BATCH", "1")
    monkeypatch.setattr(port_osd, "_BATCH_QUEUE", None)
    monkeypatch.setattr(port_osd, "_PLANAR_STORE", None)
    try:
        yield
    finally:
        if port_osd._BATCH_QUEUE is not None:
            port_osd._BATCH_QUEUE.close()


def shard_map(cluster, pool, oids):
    """oid -> {shard: (stored bytes, HashInfo blob)} over the live OSDs.  A
    shard held by two OSDs (an old holder mid-backfill) must hold the same
    bytes on both.  Rollback slots (shard + PREV_SLOT) are left out: one
    holds an earlier attempt's bytes where a write was retried on a newer
    map, which depends on how long the first dispatch took."""
    out = {oid: {} for oid in oids}
    for osd_id in sorted(cluster.osds):
        store = cluster.osds[osd_id].store
        for oid, shard in store.list_objects(pool):
            if oid not in out or shard >= port_osd.PREV_SLOT:
                continue
            key = (pool, oid, shard)
            got = (bytes(store.read(key)[0]),
                   store.getattr(key, "hinfo_key"))
            assert out[oid].setdefault(shard, got) == got, (oid, shard)
    return out


async def settled_shard_map(cluster, pool, oids, polls=5):
    """The shard map once it has stayed the same for `polls` polls in a
    row (recovery pushes land asynchronously)."""
    last, same = None, 0
    for _ in range(200):
        got = shard_map(cluster, pool, oids)
        same = same + 1 if got == last else 0
        if same == polls:
            return got
        last = got
        await asyncio.sleep(0.05)
    raise AssertionError("shards did not settle")


async def cluster_script(Cluster, plugin, conf):
    cluster = Cluster(n_osds=7, conf={**FAST, **conf})
    await cluster.start()
    client = await cluster.client()
    try:
        pool = await client.create_pool(
            "ecpool", "ec", pg_num=4,
            profile={"plugin": plugin, "technique": "reed_sol_van",
                     "k": str(K), "m": str(M)})
        objects = {f"obj-{n}": payload(n, seed=i)
                   for i, n in enumerate(SIZES)}
        for oid, data in objects.items():
            await client.put(pool, oid, data)

        async def read_all():
            return [await client.get(pool, oid) for oid in objects]

        reads = [await read_all()]
        shards = [await settled_shard_map(cluster, pool, objects)]
        p = client.osdmap.pools[pool]
        pg = client.osdmap.object_to_pg(p, f"obj-{SIZES[-1]}")
        acting = client.osdmap.pg_to_acting(p, pg)
        for victim in [a for a in acting if a != CRUSH_ITEM_NONE][:2]:
            await cluster.kill_osd(victim)
            await client.mark_osd_down(victim)
        reads.append(await read_all())
        await asyncio.sleep(0.2)
        await client.refresh_map()
        await client.repair_pool(pool)
        shards.append(await settled_shard_map(cluster, pool, objects))
        victim = sorted(cluster.osds)[0]
        await cluster.kill_osd(victim)
        await client.mark_osd_down(victim)
        reads.append(await read_all())
        return objects, reads, shards
    finally:
        await client.stop()
        await cluster.stop()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def reference_run():
    """The script on ceph_tpu: plugin=tpu, JAX on the CPU, no queue."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CEPH_TPU_FORCE_BATCH", raising=False)
        return run(cluster_script(RefCluster, "tpu", {}))


@pytest.mark.parametrize("arm", ["host", "device"])
def test_cluster_script_matches_reference(reference_run, port_cpu,
                                          monkeypatch, arm):
    """The port's run on each arm of its paged store: the host arm, and the
    device arm on CPU tensors (the arm the card runs: paged reads, device
    installs)."""
    monkeypatch.setenv("CEPH_TPU_DEVICE_SLAB", "1" if arm == "device" else "0")
    ref_objects, ref_reads, ref_shards = reference_run
    objects, reads, shards = run(
        cluster_script(PortCluster, "cuda", {"osd_ec_device": "cpu"}))
    want = list(objects.values())
    assert objects == ref_objects
    for phase, (got, ref_got) in enumerate(zip(reads, ref_reads)):
        assert got == ref_got == want, f"read phase {phase}"
    for phase, (got, ref_got) in enumerate(zip(shards, ref_shards)):
        assert got == ref_got, f"shard map {phase}"
    # the port's run went through its queue and resident store
    queue, store = port_osd._BATCH_QUEUE, port_osd._PLANAR_STORE
    assert queue is not None and queue.device.type == "cpu"
    assert queue.submits > 0
    assert isinstance(store, PagedResidentStore)
    assert store.device.type == "cpu"
    assert store.device_arm == (arm == "device")
    assert store.hits > 0  # reads were served from residents
    if arm == "device":
        assert store.device_installs > 0


def test_write_read_repair_ride_residents(port_cpu):
    """Full-object EC writes leave residents; reads at the written version
    serve from them (no decode, no sub-read), overwrites re-install and
    deletes drop them (the reference's TestOsdPlanarResidency case, on
    plugin=cuda)."""
    async def go():
        cluster = PortCluster(n_osds=4, conf={"osd_auto_repair": False,
                                              "client_op_timeout": 60.0,
                                              "osd_ec_device": "cpu"})
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("pl", profile={
                "plugin": "cuda", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            store = port_osd.shared_planar_store(device="cpu")
            assert store is not None
            blob = os.urandom(100_000)
            await c.put(pool, "obj", blob)
            assert any(
                o._planar is not None
                and o._planar_key(pool, "obj") in store
                for o in cluster.osds.values())
            hits0 = store.hits
            subr0 = sum(o.perf.get("subop_r") for o in cluster.osds.values())
            pl0 = sum(o.perf.get("planar_read_hits")
                      for o in cluster.osds.values())
            assert await c.get(pool, "obj") == blob
            assert store.hits > hits0, "read did not touch residents"
            assert sum(o.perf.get("planar_read_hits")
                       for o in cluster.osds.values()) == pl0 + 1
            assert sum(o.perf.get("subop_r")
                       for o in cluster.osds.values()) == subr0
            blob2 = os.urandom(90_000)
            await c.put(pool, "obj", blob2)
            assert await c.get(pool, "obj") == blob2
            await c.delete(pool, "obj")
            assert all(
                o._planar_key(pool, "obj") not in store
                for o in cluster.osds.values() if o._planar is not None)
            await c.stop()
        finally:
            await cluster.stop()

    run(go(), timeout=60)


@pytest.mark.parametrize("conf", [{}, {"osd_ec_device": "cuda"}])
def test_osd_without_cuda_refuses_to_start(monkeypatch, conf):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_osd.OSD(("127.0.0.1", 1), conf=dict(conf))


def test_osd_named_cpu_batches_only_when_forced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CEPH_TPU_FORCE_BATCH", raising=False)
    monkeypatch.setattr(port_osd, "_BATCH_QUEUE", None)
    monkeypatch.setattr(port_osd, "_PLANAR_STORE", None)
    osd = port_osd.OSD(("127.0.0.1", 1), conf={"osd_ec_device": "cpu"})
    assert osd._ec_device == torch.device("cpu")
    assert osd._ec_queue is None and osd._planar is None


def test_shared_store_keeps_its_first_device(port_cpu, monkeypatch):
    store = port_osd.shared_planar_store(device="cpu")
    assert store.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="runs on cpu"):
        port_osd.shared_planar_store(device="cuda")


def test_cluster_with_mgr_starts_and_scrapes(port_cpu):
    """vstart starts the port's mgr before the OSDs and puts its address
    in the conf; the OSDs and the mon report to it and /metrics serves
    their sets over HTTP."""
    async def go():
        cluster = PortCluster(n_osds=3, with_mgr=True, conf={
            "osd_ec_device": "cpu", "osd_heartbeat_interval": 0.1})
        await cluster.start()
        try:
            mgr = cluster.mgr
            assert cluster.conf["mgr_addr"] == \
                f"{mgr.addr[0]}:{mgr.addr[1]}"
            for _ in range(200):
                if len(mgr.reports) >= 4:
                    break
                await asyncio.sleep(0.05)
            assert sorted(mgr.reports) == ["mon.0", "osd.0", "osd.1", "osd.2"]
            reader, writer = await asyncio.open_connection(*mgr.http_addr)
            writer.write(b"GET /metrics HTTP/1.1\r\n\r\n")
            await writer.drain()
            head = await reader.readline()
            body = await reader.read(-1)
            writer.close()
            assert b"200" in head
            assert b"ceph_mgr_daemons_reporting 4" in body
            assert b'ceph_osd_op_w{daemon="osd.0"}' in body
        finally:
            await cluster.stop()

    run(go(), timeout=60)


def test_osd_sends_one_report_with_its_perf_dump_per_tick(monkeypatch):
    """An OSD whose conf names a mgr sends it one MMgrReport per report
    tick, carrying its perf dump and status."""
    from ceph_tpu_torch.mgr.daemon import MMgrReport

    monkeypatch.setattr(port_osd, "_BATCH_QUEUE", None)
    monkeypatch.setattr(port_osd, "_PLANAR_STORE", None)
    osd = port_osd.OSD(("127.0.0.1", 1), conf={"osd_ec_device": "cpu",
                                               "mgr_addr": "127.0.0.1:7"})
    sent = []

    async def send(addr, msg, peer_type=None):
        sent.append((addr, msg, peer_type))

    monkeypatch.setattr(osd.messenger, "send", send)
    for tick in range(3):
        osd.perf.inc("op_w")
        asyncio.run(osd._report_to_mgr())
        assert len(sent) == tick + 1
        addr, msg, peer_type = sent[-1]
        assert (addr, peer_type) == (("127.0.0.1", 7), "mgr")
        assert isinstance(msg, MMgrReport) and msg.name == "osd.-1"
        assert msg.perf == osd.ctx.perf.dump()
        assert msg.perf["osd"]["op_w"] == tick + 1
        assert msg.status == osd.status()


def test_pool_with_a_plugin_the_port_lacks_is_refused():
    """The reference's plugin=tpu is the one plugin the port does not have
    (plugin=cuda takes its place)."""
    from ceph_tpu_torch.rados.client import RadosError

    async def go():
        cluster = PortCluster(n_osds=3, conf={"osd_ec_device": "cpu"})
        await cluster.start()
        c = await cluster.client()
        try:
            for plugin in ("tpu", "nope"):
                with pytest.raises(RadosError, match=f"plugin {plugin} not found"):
                    await c.create_pool(f"no-{plugin}", "ec", pg_num=2,
                                        profile={"plugin": plugin, "k": "2",
                                                 "m": "1"})
        finally:
            await c.stop()
            await cluster.stop()

    run(go(), timeout=60)


# -- devices: the mon checks profiles on the CPU, the OSD builds codecs on
#    its osd_ec_device, including the ones lrc and clay build inside --------

CUDA_LAYERS = json.dumps([[chunks, "plugin=cuda technique=reed_sol_van"]
                          for chunks in ("DDc_DDc_", "DDDc____", "____DDDc")])
CUDA_PROFILES = {
    "cuda": {"plugin": "cuda", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "lrc": {"plugin": "lrc", "mapping": "DD__DD__", "layers": CUDA_LAYERS},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "cuda"},
}
HOST_PROFILES = {
    "isa": {"plugin": "isa", "k": "8", "m": "3"},
    "shec": {"plugin": "shec"},
    "lrc-kml": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
}


def test_mon_without_a_card_accepts_cuda_pools(monkeypatch):
    """A port mon on a host without CUDA accepts plugin=cuda pools, and
    lrc and clay pools whose inner codecs are plugin=cuda; each completed
    profile, size and stripe width equals what the reference's mon makes of
    the same pool with plugin=tpu in plugin=cuda's place, and the host
    plugins' profiles equal the reference's as they are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mon, ref = Monitor(conf={}), RefMonitor(conf={})
    for name, profile in {**CUDA_PROFILES, **HOST_PROFILES}.items():
        reply = mon._create_pool(MCreatePool(name=name, profile=dict(profile)))
        assert reply.ok, (name, reply.error)
        ref_profile = {k: v.replace("cuda", "tpu") for k, v in profile.items()}
        ref_reply = ref._create_pool(RefMCreatePool(name=name,
                                                    profile=ref_profile))
        assert ref_reply.ok, (name, ref_reply.error)
        got, want = mon.osdmap.pool_by_name(name), ref.osdmap.pool_by_name(name)
        assert {k: v.replace("cuda", "tpu") for k, v in got.profile.items()} \
            == want.profile, name
        assert (got.size, got.min_size, got.stripe_width) == \
            (want.size, want.min_size, want.stripe_width), name


def test_osd_builds_cuda_codecs_on_its_ec_device(monkeypatch):
    """``osd_ec_device: cpu`` on a host without CUDA: every plugin=cuda codec
    the OSD builds is on the CPU, the nested ones of lrc's layers and
    clay's mds/pft included, with no plugin registered by hand."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CEPH_TPU_FORCE_BATCH", raising=False)
    monkeypatch.setattr(port_osd, "_BATCH_QUEUE", None)
    monkeypatch.setattr(port_osd, "_PLANAR_STORE", None)
    osd = port_osd.OSD(("127.0.0.1", 1), conf={"osd_ec_device": "cpu"})
    for pool_id, (name, profile) in enumerate(CUDA_PROFILES.items(), 1):
        codec = osd._codec(PoolInfo(pool_id=pool_id, name=name,
                                    pool_type="ec", pg_num=1, size=6,
                                    min_size=5, profile=dict(profile)))
        inner = {"cuda": lambda: [codec],
                 "lrc": lambda: [la.erasure_code for la in codec.layers],
                 "clay": lambda: [codec.mds, codec.pft]}[name]()
        for c in inner:
            assert c.plugin_name == "cuda" and c.device == torch.device("cpu")


def test_cluster_without_a_card_or_a_named_cpu_fails_at_start(monkeypatch):
    """The mon no longer needs a card, but an OSD still does unless its
    conf names the CPU: the cluster fails at start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def go():
        cluster = PortCluster(n_osds=3)
        try:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                await cluster.start()
        finally:
            await cluster.stop()

    run(go(), timeout=60)


# -- clay sub-chunk recovery (tests/test_subchunk_recovery.py on the port) --

def test_clay_single_shard_repair_moves_subchunk_bytes_only(port_cpu):
    async def go():
        cluster = PortCluster(n_osds=7, conf={
            **FAST, "client_op_timeout": 30.0, "osd_auto_repair": False,
            "osd_ec_device": "cpu"})
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("clay", profile={
                "plugin": "clay", "k": "4", "m": "2"})
            data = payload(200_000, seed=1)
            await c.put(pool, "obj", data)
            p = c.osdmap.pools[pool]
            pg = c.osdmap.object_to_pg(p, "obj")
            acting = c.osdmap.pg_to_acting(p, pg)
            primary = cluster.osds[c.osdmap.primary_of(
                acting, seed=(pool << 20) | pg)]
            lost_shard, lost_osd = next(
                (s, o) for s, o in enumerate(acting) if o >= 0)
            victim = cluster.osds[lost_osd]
            original = victim.store.read((pool, "obj", lost_shard))
            blob_len = len(original[0])
            txn = Transaction()
            txn.delete((pool, "obj", lost_shard))
            victim.store.queue_transaction(txn)
            before = primary.perf.get("recovery_subchunk_bytes")
            await c.repair_pool(pool)
            for _ in range(100):  # pushes are fire-and-forget
                restored = victim.store.read((pool, "obj", lost_shard))
                if restored is not None:
                    break
                await asyncio.sleep(0.05)
            assert restored is not None, "shard not repaired"
            assert restored[0] == original[0], "repair not byte-identical"
            moved = primary.perf.get("recovery_subchunk_bytes") - before
            assert moved > 0, "sub-chunk path not taken"
            # d=5 helpers ship blob/q (q=2) each, not whole chunks
            assert moved <= 5 * blob_len // 2 + 1024, (moved, blob_len)
            for o in cluster.osds.values():
                o._extent_cache.clear()
            assert await c.get(pool, "obj") == data
            await c.stop()
        finally:
            await cluster.stop()

    run(go(), timeout=90)


# -- four pool layouts through the daemon, against a model ------------------

LAYOUTS = {
    "rs": {"plugin": "cuda", "technique": "reed_sol_van"},
    "cauchy": {"plugin": "cuda", "technique": "cauchy_good",
               "packetsize": "2048"},
    "w16": {"plugin": "cuda", "technique": "reed_sol_van", "w": "16"},
    "isa": {"plugin": "isa", "technique": "reed_sol_van"},
}


@pytest.mark.parametrize("arm", ["host", "device"])
def test_pool_layouts_write_overwrite_and_degrade_against_a_model(
        port_cpu, monkeypatch, arm):
    """7 OSDs, k=4 m=2: a reed_sol_van, a cauchy_good (packet rows, K3), a
    w=16 (the int8-plane lane) and an isa pool each take full writes and
    partial overwrites (read-modify-write), then lose one OSD; every read,
    before and after, equals the model."""
    monkeypatch.setenv("CEPH_TPU_DEVICE_SLAB", "1" if arm == "device" else "0")
    rng = np.random.default_rng(31)

    async def go():
        cluster = PortCluster(n_osds=7, conf={**FAST, "osd_auto_repair": False,
                                              "osd_ec_device": "cpu"})
        await cluster.start()
        c = await cluster.client()
        model = {}
        try:
            pools = {name: await c.create_pool(name, "ec", pg_num=4, profile={
                **prof, "k": str(K), "m": str(M)})
                for name, prof in LAYOUTS.items()}
            for name, pool in pools.items():
                for i in range(3):
                    oid = f"{name}-{i}"
                    model[pool, oid] = payload(int(rng.integers(1, 150_000)),
                                               seed=int(rng.integers(1 << 30)))
                    await c.put(pool, oid, model[pool, oid])
                for i in range(3):
                    oid = f"{name}-{i}"
                    old = bytearray(model[pool, oid])
                    off = int(rng.integers(0, len(old) + 1))
                    new = payload(int(rng.integers(1, 20_000)),
                                  seed=int(rng.integers(1 << 30)))
                    old.extend(b"\0" * max(0, off + len(new) - len(old)))
                    old[off:off + len(new)] = new
                    model[pool, oid] = bytes(old)
                    await c.put(pool, oid, new, offset=off)
            for (pool, oid), want in model.items():
                assert await c.get(pool, oid) == want, (pool, oid)
            victim = c.osdmap.pg_to_acting(
                c.osdmap.pools[pools["rs"]], 0)[0]
            await cluster.kill_osd(victim)
            await c.mark_osd_down(victim)
            await c.refresh_map()
            for (pool, oid), want in model.items():
                assert await c.get(pool, oid) == want, ("degraded", pool, oid)
        finally:
            await c.stop()
            await cluster.stop()

    run(go(), timeout=120)
    assert port_osd._BATCH_QUEUE.submits > 0
