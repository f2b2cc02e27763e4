"""The port's client APIs against ceph_tpu's, on the same inputs.

One script runs on each package: librados (pool I/O, aio completions,
object classes), the striper, neorados op vectors and the staged executor's
edge cases, rbd (image lifecycle, sparse I/O, snapshots, clones and flatten,
trash, racing writers and creates, groups, object-map rebuild, migration,
journaling and mirroring), rbd export/import/diff streams and the ``rados``
and ``rbd`` CLIs; then one OSD is lost and the striped, replicated and rbd
objects are read degraded, and a replicated pool recovers onto a new OSD.
The cases are those of tests/test_librados.py, tests/test_neorados.py,
tests/test_services.py's rbd classes, tests/test_service_tier.py's rbd
mirroring classes and tests/test_rbd_export.py, each with the reference
test's own checks.

Each package gets one cluster of 5 OSDs with k=2 m=1 EC pools and
replicated pools.  The reference's EC pools are plugin=jerasure;
the port's are plugin=cuda on the CPU (``osd_ec_device: cpu`` and
CEPH_TPU_FORCE_BATCH=1, so its batching queue and paged resident store carry
the EC traffic), whose chunks equal jerasure's.  rbd headers carry
``uuid.uuid4()`` ids and ``time.time()`` stamps; both packages' rbd modules
get the same pinned sequence of each.  Every record of the script (reads,
rbd headers, export streams, CLI output) must be equal across the packages,
and a stream exported by either package must import into the other.
"""

import asyncio
import contextlib
import errno
import importlib
import io
import json
import os
import re
import struct
import types

import numpy as np
import pytest

from ceph_tpu_torch.rados import osd as port_osd

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
# a generous heartbeat grace keeps peers up on a loaded host (the meta
# replication case pins the retry pump, which parks a down peer's queue)
CONF = {"osd_auto_repair": False, "osd_heartbeat_grace": 300.0}
PROFILES = {REF: {"plugin": "jerasure", "technique": "reed_sol_van",
                  "k": "2", "m": "1"},
            PORT: {"plugin": "cuda", "technique": "reed_sol_van",
                   "k": "2", "m": "1"}}
CLOCK = 1_760_000_000.0
BS = 1 << 18  # the rbd cases' object size (order=18)


def blob(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def package(prefix):
    imp = lambda name: importlib.import_module(f"{prefix}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        prefix=prefix,
        Cluster=imp("rados.vstart").Cluster,
        RadosClient=imp("rados.client").RadosClient,
        RadosError=imp("rados.client").RadosError,
        Rados=imp("rados.librados").Rados,
        RadosStriper=imp("rados.striper").RadosStriper,
        neo=imp("rados.neorados"),
        rbd=imp("services.rbd"),
        rbd_export=imp("services.rbd_export"),
        rados_cli=imp("tools.rados"),
        rbd_cli=imp("tools.rbd"))


class PinnedIds:
    """uuid4() stand-in: the same sequence of ids in every package."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return types.SimpleNamespace(hex=f"{0x5eed00000000 + self.n:012x}"
                                     + "0" * 20)


async def raises(exc, aw, match=None):
    """The exception `aw` raises, as (class name, code); fails if none, or
    if its message does not match `match`."""
    try:
        await aw
    except exc as e:
        assert match is None or re.search(match, str(e)), str(e)
        return type(e).__name__, getattr(e, "code", None)
    raise AssertionError(f"{exc.__name__} not raised")


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# -- librados ---------------------------------------------------------------

@case
async def librados_pool_io(r):
    await r.rados.pool_create("app-pool", profile=r.profile)
    pools = await r.rados.pool_list()
    assert "app-pool" in pools
    ioc = await r.rados.open_ioctx("app-pool")
    data = blob(60_000, 1)
    await ioc.write_full("doc", data)
    out = {"pools": pools, "read": await ioc.read("doc"),
           "size": (await ioc.stat("doc"))["size"]}
    assert out["read"] == data and out["size"] == len(data)
    await ioc.write("doc", b"patch", offset=100)
    want = bytearray(data)
    want[100:105] = b"patch"
    out["patched"] = await ioc.read("doc")
    assert out["patched"] == bytes(want)
    out["ls"] = await ioc.list_objects()
    assert out["ls"] == ["doc"]
    await ioc.remove("doc")
    out["removed"] = await raises(r.pkg.RadosError, ioc.read("doc"))
    out["no_pool"] = await raises(r.pkg.RadosError,
                                  r.rados.open_ioctx("no-such-pool"))
    return out


@case
async def librados_aio(r):
    blobs = {f"aio{i}": blob(8_000, 10 + i) for i in range(8)}
    for c in [r.io_ec.aio_write(k, v) for k, v in blobs.items()]:
        await c.wait()
    reads = {k: r.io_ec.aio_read(k) for k in blobs}
    out = {}
    for k, c in reads.items():
        out[k] = await c.wait()
        assert out[k] == blobs[k] and c.is_complete()
    return out


@case
async def striper_roundtrip(r):
    striper = r.pkg.RadosStriper(r.io_ec, object_size=64 * 1024)
    big = blob(300_000, 20)
    await striper.write("big", big)
    out = {"read": await striper.read("big"),
           "stat": await striper.stat("big"), "ls": await striper.list()}
    assert out["read"] == big
    assert out["stat"]["pieces"] == 5 and out["stat"]["size"] == len(big)
    assert out["ls"] == ["big"]
    small = blob(70_000, 21)  # shrink: stale tail pieces are trimmed
    await striper.write("big", small)
    out["shrunk"] = await striper.read("big")
    assert out["shrunk"] == small
    out["pieces"] = sorted(o for o in await r.io_ec.list_objects()
                           if o.startswith("big.") and "__striper__" not in o)
    assert len(out["pieces"]) == 2
    await striper.remove("big")
    out["after_remove"] = await striper.list()
    assert out["after_remove"] == []
    # read again after an OSD is lost (degraded_reads)
    await r.pkg.RadosStriper(r.io_ec, object_size=32 * 1024).write(
        "movie", blob(200_000, 22))
    return out


@case
async def replicated_io(r):
    blobs = {f"r{i}": blob(30_000, 30 + i) for i in range(6)}
    for k, v in blobs.items():
        await r.io_rep.write_full(k, v)
    out = {k: await r.io_rep.read(k) for k in blobs}
    assert out == blobs
    await r.io_rep.write("r0", b"XYZ", offset=5)
    want = bytearray(blobs["r0"])
    want[5:8] = b"XYZ"
    out["patched"] = await r.io_rep.read("r0")
    assert out["patched"] == bytes(want)
    # recovers onto a new OSD after one is lost (replicated_recovery)
    await r.io_rep.write_full("rrec", blob(20_000, 36))
    return out


@case
async def cls_on_replicated_pool(r):
    ioc = r.io_rep
    await ioc.write_full("locked", b"payload")
    calls = [("lock", "lock", {"owner": "alice", "ttl": 30}),
             ("lock", "lock", {"owner": "bob"}),
             ("lock", "info", None),
             ("lock", "unlock", {"owner": "alice"}),
             ("lock", "lock", {"owner": "bob"}),
             ("lock", "unlock", {"owner": "bob"}),
             ("refcount", "get", None), ("refcount", "get", None),
             ("refcount", "put", None)]
    out = []
    for cls, method, arg in calls:
        inp = json.dumps(arg).encode() if arg is not None else b""
        out.append(tuple(await ioc.execute("locked", cls, method, inp)))
    rets = [ret for ret, _ in out]
    assert rets[:2] == [0, -errno.EBUSY] and rets[3:6] == [0, 0, 0]
    assert json.loads(out[2][1])["owner"] == "alice"
    assert [o for _, o in out[6:]] == [b"1", b"2", b"1"]
    out.append(await raises(r.pkg.RadosError,
                            ioc.execute("locked", "nope", "x", b"")))
    return out


@case
async def cls_rejected_on_ec_pool(r):
    await r.io_ec.write_full("clsobj", b"x")
    try:
        await r.io_ec.execute("clsobj", "version", "get", b"")
    except r.pkg.RadosError as e:
        assert "EOPNOTSUPP" in str(e)
        return str(e)
    raise AssertionError("class call on an EC pool was not refused")


# -- neorados (replicated pool unless named) ---------------------------------

@case
async def neo_atomic_write_xattr_omap(r):
    neo = r.pkg.neo
    await r.neo.execute("n1", r.ioc_rep, neo.WriteOp()
                        .create(exclusive=True).write_full(b"payload")
                        .setxattr("owner", b"alice")
                        .omap_set({"k1": b"v1", "k2": b"v2"}))
    res = await r.neo.execute("n1", r.ioc_rep, neo.ReadOp().read()
                              .getxattr("owner").omap_get_vals().stat())
    assert res[0][1] == b"payload" and res[1][1] == b"alice"
    assert res[2][1] == {"k1": b"v1", "k2": b"v2"}
    assert res[3][1]["size"] == 7
    return [res[0][1], res[1][1], res[2][1], res[3][1]["size"]]


@case
async def neo_failing_assert_applies_nothing(r):
    neo = r.pkg.neo
    await r.neo.execute("n2", r.ioc_rep, neo.WriteOp().write_full(b"v1")
                        .setxattr("tag", b"old"))
    bad = (neo.WriteOp().write_full(b"v2").omap_set({"x": b"y"})
           .cmpxattr("tag", b"WRONG").setxattr("tag", b"new"))
    err = await raises(r.pkg.RadosError, r.neo.execute("n2", r.ioc_rep, bad))
    assert err[1] == -errno.ECANCELED
    res = await r.neo.execute("n2", r.ioc_rep, neo.ReadOp().read()
                              .getxattr("tag").omap_get_vals())
    assert [x[1] for x in res] == [b"v1", b"old", {}]
    return err, [x[1] for x in res]


@case
async def neo_create_exclusive_and_assert_exists(r):
    neo = r.pkg.neo
    await r.neo.execute("n3", r.ioc_rep, neo.WriteOp().create(exclusive=True)
                        .write_full(b"x"))
    out = [await raises(r.pkg.RadosError, r.neo.execute(
        "n3", r.ioc_rep, neo.WriteOp().create(exclusive=True)))]
    out.append(await raises(r.pkg.RadosError, r.neo.execute(
        "ghost", r.ioc_rep, neo.WriteOp().assert_exists().write_full(b"y"))))
    out.append(await raises(r.pkg.RadosError, r.neo.execute(
        "ghost", r.ioc_rep, neo.ReadOp().stat())))
    assert [o[1] for o in out[:2]] == [-errno.EEXIST, -errno.ENOENT]
    return out


@case
async def neo_ordering_read_sees_staged_write(r):
    neo = r.pkg.neo
    await r.neo.execute("n4", r.ioc_rep, neo.WriteOp().write_full(b"AAAA")
                        .append(b"BB").zero(1, 2).truncate(5))
    res = await r.neo.execute("n4", r.ioc_rep, neo.ReadOp().read())
    assert res[0][1] == b"A\x00\x00AB"
    return res[0][1]


@case
async def neo_assert_version_cas_loop(r):
    neo = r.pkg.neo
    await r.neo.execute("ctr", r.ioc_rep, neo.WriteOp().write_full(b"0"))

    async def incr(times):
        for _ in range(times):
            while True:
                results, ver = await r.neo.execute_versioned(
                    "ctr", r.ioc_rep, neo.ReadOp().read())
                try:
                    await r.neo.execute("ctr", r.ioc_rep, neo.WriteOp()
                                        .assert_version(ver).write_full(
                                            str(int(results[0][1]) + 1)
                                            .encode()))
                    break
                except r.pkg.RadosError as e:
                    if e.code != -errno.ERANGE:
                        raise

    await asyncio.gather(incr(5), incr(5))
    results, _ = await r.neo.execute_versioned("ctr", r.ioc_rep,
                                               neo.ReadOp().read())
    assert int(results[0][1]) == 10
    return results[0][1]


@case
async def neo_remove_and_omap_lifecycle(r):
    neo = r.pkg.neo
    await r.neo.execute("n5", r.ioc_rep, neo.WriteOp().write_full(b"d")
                        .omap_set({"a": b"1", "b": b"2", "c": b"3"}))
    await r.neo.execute("n5", r.ioc_rep, neo.WriteOp().omap_rm_keys(["a"]))
    keys = (await r.neo.execute("n5", r.ioc_rep,
                                neo.ReadOp().omap_get_keys()))[0][1]
    assert keys == ["b", "c"]
    await r.neo.execute("n5", r.ioc_rep, neo.WriteOp().omap_clear()
                        .omap_set({"z": b"9"}))
    vals = (await r.neo.execute("n5", r.ioc_rep,
                                neo.ReadOp().omap_get_vals()))[0][1]
    assert vals == {"z": b"9"}
    await r.neo.execute("n5", r.ioc_rep, neo.WriteOp().remove())
    gone = await raises(r.pkg.RadosError, r.neo.execute(
        "n5", r.ioc_rep, neo.ReadOp().read()))
    assert gone[1] == -errno.ENOENT
    return keys, vals, gone


@case
async def neo_exec_cls_inside_vector(r):
    neo = r.pkg.neo
    lock = lambda owner: json.dumps({"owner": owner,  # noqa: E731
                                     "ttl": 30}).encode()
    await r.neo.execute("n6", r.ioc_rep, neo.WriteOp().create()
                        .exec_("lock", "lock", lock("me"))
                        .setxattr("claimed", b"1"))
    first = (await r.neo.execute("n6", r.ioc_rep,
                                 neo.ReadOp().getxattr("claimed")))[0][1]
    # the client resends -EBUSY until its op deadline: a short one here
    short = r.pkg.RadosClient(r.cluster.mon_addrs,
                              dict(r.conf, client_op_deadline=1.0))
    await short.start()
    try:
        err = await raises(r.pkg.RadosError, neo.RADOS(
            None, client=short).execute(
                "n6", r.ioc_rep, neo.WriteOp().exec_(
                    "lock", "lock", lock("thief")).setxattr("claimed", b"2")))
    finally:
        await short.stop()
    after = (await r.neo.execute("n6", r.ioc_rep,
                                 neo.ReadOp().getxattr("claimed")))[0][1]
    assert first == after == b"1"
    return first, err, after


@case
async def neo_ec_data_ops_allowed_omap_rejected(r):
    neo = r.pkg.neo
    await r.neo.execute("n7", r.ioc_ec, neo.WriteOp().write_full(b"ec-bytes")
                        .setxattr("tag", b"t"))
    res = await r.neo.execute("n7", r.ioc_ec,
                              neo.ReadOp().read().getxattr("tag"))
    assert [x[1] for x in res] == [b"ec-bytes", b"t"]
    errs = [await raises(r.pkg.RadosError, r.neo.execute(
        "n7", r.ioc_ec, neo.WriteOp().omap_set({"k": b"v"}))),
        await raises(r.pkg.RadosError, r.neo.execute(
            "n7", r.ioc_ec, neo.WriteOp().exec_("lock", "lock")))]
    assert [e[1] for e in errs] == [-errno.EOPNOTSUPP] * 2
    return [x[1] for x in res], errs


@case
async def ioctx_xattr_omap_conveniences(r):
    ioc = r.io_rep
    await ioc.write_full("o", b"data")
    await ioc.setxattr("o", "user.a", b"1")
    out = [await ioc.getxattr("o", "user.a"), await ioc.getxattrs("o")]
    assert out == [b"1", {"user.a": b"1"}]
    await ioc.rmxattr("o", "user.a")
    out.append(await raises(r.pkg.RadosError, ioc.getxattr("o", "user.a")))
    assert out[-1][1] == -errno.ENODATA
    await ioc.omap_set("o", {"x": b"y"})
    out.append(await ioc.omap_get_vals("o"))
    await ioc.omap_rm_keys("o", ["x"])
    out.append(await ioc.omap_get_vals("o"))
    await ioc.operate("o", r.pkg.neo.WriteOp().append(b"+more"))
    out.append(await ioc.read("o"))
    assert out[3:] == [{"x": b"y"}, {}, b"data+more"]
    return out


@case
async def ioctx_reserved_xattr_names_rejected(r):
    await r.io_rep.write_full("reserved", b"d")
    err = await raises(r.pkg.RadosError,
                       r.io_rep.setxattr("reserved", "snapset_key", b"evil"))
    assert err[1] == -errno.EINVAL
    return err


@case
async def neo_meta_replication_retries_after_transport_failure(r):
    """Failed sends of xattr/omap replication to acting peers are queued
    and retried until every peer holds the metadata."""
    neo, pool_id = r.pkg.neo, r.ioc_rep.pool_id
    msg_types = importlib.import_module(f"{r.pkg.prefix}.rados.types")
    await r.neo.execute("robj", r.ioc_rep, neo.WriteOp().write_full(b"seed"))
    primary = peers = None
    for osd in r.cluster.osds.values():
        pool = osd.osdmap.pools[pool_id]
        pg, acting = osd._acting(pool, "robj")
        if osd._primary(pool, pg, acting) == osd.osd_id:
            primary, peers = osd, [a for a in acting if a != osd.osd_id]
            break
    assert primary is not None and peers
    real_send, fail = primary.messenger.send, {"n": 3}

    async def flaky(addr, msg, *a, **kw):
        if isinstance(msg, (msg_types.MSetOmap, msg_types.MSetXattrs)) \
                and fail["n"] > 0:
            fail["n"] -= 1
            raise ConnectionError("injected")
        return await real_send(addr, msg, *a, **kw)

    primary.messenger.send = flaky
    try:
        await r.neo.execute("robj", r.ioc_rep, neo.WriteOp()
                            .setxattr("who", b"x").omap_set({"idx": b"entry"}))
        for _ in range(600):
            if not primary._meta_repl_pending:
                break
            await asyncio.sleep(0.05)
    finally:
        primary.messenger.send = real_send
    assert not primary._meta_repl_pending and fail["n"] == 0
    key = (pool_id, "robj", 0)
    want = [(b"entry", b"x")] * len(peers)
    # the queue empties once the last send returns; each peer applies the
    # message when its own dispatch runs, so wait for that too
    for _ in range(600):
        held = [(r.cluster.osds[p].store.omap_get(key).get("idx"),
                 r.cluster.osds[p].store.getattr(key, "who")) for p in peers]
        if held == want:
            break
        await asyncio.sleep(0.05)
    assert held == want
    return fail["n"], held


@case
async def neo_resend_replays_original_result(r):
    """A resend with the original reqid replays the first result: an
    append applies once."""
    client = r.rados._client
    msg_types = importlib.import_module(f"{r.pkg.prefix}.rados.types")
    await client.refresh_map()
    op = msg_types.MOSDOp(op="multi", pool_id=r.ioc_rep.pool_id, oid="resend",
                          ops=[("append", {"data": b"X"})],
                          reqid="fixed-reqid-1", epoch=client.osdmap.epoch)
    _pg, primary = client._calc_target(op)

    async def send_same_reqid():
        fut = asyncio.get_running_loop().create_future()
        client._replies[op.reqid] = fut
        try:
            await client.messenger.send(client.osdmap.addr_of(primary), op)
            return await asyncio.wait_for(fut, timeout=10)
        finally:
            client._replies.pop(op.reqid, None)

    oks = [(await send_same_reqid()).ok, (await send_same_reqid()).ok]
    res = await r.neo.execute("resend", r.ioc_rep, r.pkg.neo.ReadOp().read())
    assert oks == [True, True] and res[0][1] == b"X"
    return oks, res[0][1]


# -- neorados: the staged executor's edge cases (test_neorados's regression
#    class for serialization, remove and metadata-only ops) ------------------

@case
async def neo_concurrent_multis_serialize(r):
    neo = r.pkg.neo
    await r.neo.execute("rf1", r.ioc_rep, neo.WriteOp().write_full(b""))
    await asyncio.gather(*[r.neo.execute("rf1", r.ioc_rep,
                                         neo.WriteOp().append(b"x"))
                           for _ in range(8)])
    res = await r.neo.execute("rf1", r.ioc_rep, neo.ReadOp().read())
    assert res[0][1] == b"x" * 8
    return res[0][1]


@case
async def neo_remove_purges_metadata(r):
    neo = r.pkg.neo
    await r.neo.execute("rf2", r.ioc_rep, neo.WriteOp().write_full(b"d")
                        .setxattr("a", b"1").omap_set({"k": b"v"}))
    await r.neo.execute("rf2", r.ioc_rep,
                        neo.WriteOp().setxattr("b", b"2").remove())
    await r.neo.execute("rf2", r.ioc_rep, neo.WriteOp().write_full(b"new"))
    res = await r.neo.execute("rf2", r.ioc_rep,
                              neo.ReadOp().getxattrs().omap_get_vals())
    assert [x[1] for x in res] == [{}, {}]
    return [x[1] for x in res]


@case
async def neo_remove_then_recreate_in_one_vector(r):
    neo = r.pkg.neo
    await r.neo.execute("rf3", r.ioc_rep, neo.WriteOp().write_full(b"old")
                        .setxattr("a", b"1"))
    await r.neo.execute("rf3", r.ioc_rep, neo.WriteOp().remove().create()
                        .setxattr("b", b"2"))
    res = await r.neo.execute("rf3", r.ioc_rep,
                              neo.ReadOp().stat().getxattrs())
    assert res[0][1]["size"] == 0 and res[1][1] == {"b": b"2"}
    await r.neo.execute("rf3", r.ioc_rep,
                        neo.WriteOp().remove().setxattr("c", b"3"))
    again = await r.neo.execute("rf3", r.ioc_rep, neo.ReadOp().getxattrs())
    assert again[0][1] == {"c": b"3"}
    return res[0][1]["size"], res[1][1], again[0][1]


@case
async def neo_metadata_mutation_bumps_version(r):
    neo = r.pkg.neo
    await r.neo.execute("rf4", r.ioc_rep, neo.WriteOp().write_full(b"d"))
    _r, v1 = await r.neo.execute_versioned("rf4", r.ioc_rep,
                                           neo.ReadOp().getxattrs())
    await r.neo.execute("rf4", r.ioc_rep, neo.WriteOp().assert_version(v1)
                        .setxattr("winner", b"A"))
    _r, v2 = await r.neo.execute_versioned("rf4", r.ioc_rep,
                                           neo.ReadOp().getxattrs())
    assert v2 > v1
    err = await raises(r.pkg.RadosError, r.neo.execute(
        "rf4", r.ioc_rep, neo.WriteOp().assert_version(v1)
        .setxattr("winner", b"B")))
    assert err[1] == -errno.ERANGE
    res = await r.neo.execute("rf4", r.ioc_rep,
                              neo.ReadOp().getxattr("winner").read())
    assert [x[1] for x in res] == [b"A", b"d"]
    return err, [x[1] for x in res]


@case
async def neo_metadata_only_create(r):
    neo = r.pkg.neo
    await r.neo.execute("rf5", r.ioc_rep, neo.WriteOp().setxattr("k", b"v"))
    res = await r.neo.execute("rf5", r.ioc_rep,
                              neo.ReadOp().stat().getxattr("k"))
    assert res[0][1]["size"] == 0 and res[1][1] == b"v"
    return res[0][1]["size"], res[1][1]


@case
async def neo_fast_path_version_is_real(r):
    neo = r.pkg.neo
    await r.neo.execute("rf6", r.ioc_rep, neo.WriteOp().write_full(b"d"))
    _res, ver = await r.neo.execute_versioned("rf6", r.ioc_rep,
                                              neo.ReadOp().getxattrs())
    assert ver > 0
    await r.neo.execute("rf6", r.ioc_rep, neo.WriteOp().assert_version(ver)
                        .setxattr("ok", b"1"))
    res = await r.neo.execute("rf6", r.ioc_rep, neo.ReadOp().getxattr("ok"))
    return res[0][1]


@case
async def neo_metadata_reads_on_absent_object(r):
    neo = r.pkg.neo
    out = [await raises(r.pkg.RadosError, r.neo.execute("ghost7", r.ioc_rep,
                                                         op))
           for op in (neo.ReadOp().getxattrs(), neo.ReadOp().omap_get_vals(),
                      neo.ReadOp().getxattr("x"))]
    assert [e[1] for e in out] == [-errno.ENOENT] * 3
    return out


# -- rbd (EC pool; each case in a namespace of its own) -----------------------

async def header(img):
    return json.loads(await img.ioctx.read(img._header_oid(img.name)))


@case
async def rbd_image_lifecycle_and_sparse_io(r):
    rbd = await r.rbd_ns("lifecycle")
    img = await rbd.create("vm-disk", 8 << 20, order=18)
    out = {"list": await rbd.list()}
    assert out["list"] == ["vm-disk"]
    out["dup"] = await raises(r.pkg.rbd.RbdError,
                              rbd.create("vm-disk", 1 << 20))
    out["fresh"] = await img.read(0, 4096)
    assert out["fresh"] == b"\x00" * 4096
    data = blob(300_000, 40)
    await img.write(200_000, data)
    out["span"] = await img.read(200_000, len(data))
    assert out["span"] == data
    assert await img.read(0, 1000) == b"\x00" * 1000
    out["stat"] = await img.stat()
    assert out["stat"]["num_objs"] >= 2
    await img.write(200_100, b"PATCH")
    out["patched"] = await img.read(200_000, 200)
    assert out["patched"][100:105] == b"PATCH"
    out["beyond"] = await raises(r.pkg.rbd.RbdError,
                                 img.write(8 << 20, b"x"))
    out["header"] = await header(img)
    return out


@case
async def rbd_snapshots_cow(r):
    rbd = await r.rbd_ns("snaps")
    img = await rbd.create("snapdisk", 4 << 20, order=18)
    v1, v2, v3 = blob(300_000, 41), blob(300_000, 42), blob(100, 43)
    await img.write(0, v1)
    await img.snap_create("s1")
    assert img.snap_list() == ["s1"]
    await img.write(0, v2)
    out = {"head": await img.read(0, len(v2)),
           "s1": await img.read_snap("s1", 0, len(v1))}
    assert (out["head"], out["s1"]) == (v2, v1)
    await img.snap_create("s2")
    await img.write(50, v3)
    head = bytearray(v2)
    head[50:150] = v3
    out["s2"] = await img.read_snap("s2", 0, len(v2))
    out["head2"] = await img.read(0, len(v2))
    assert (out["s2"], out["head2"]) == (v2, bytes(head))
    assert await img.read_snap("s1", 0, len(v1)) == v1
    assert await img.read_snap("s1", 1 << 20, 100) == b"\x00" * 100
    out["dup"] = await raises(r.pkg.rbd.RbdError, img.snap_create("s1"))
    await img.snap_remove("s1")
    assert img.snap_list() == ["s2"]
    assert await img.read_snap("s2", 0, 100) == v2[:100]
    out["gone"] = await raises(r.pkg.rbd.RbdError, img.read_snap("s1", 0, 10))
    out["header"] = await header(img)
    return out


@case
async def rbd_two_snaps_two_writes_oldest_snap_intact(r):
    img = await (await r.rbd_ns("twosnaps")).create("tw", 1 << 20, order=18)
    v1, v2, v3 = (blob(10_000, s) for s in (44, 45, 46))
    await img.write(0, v1)
    await img.snap_create("a")
    await img.snap_create("b")
    await img.write(0, v2)
    await img.write(0, v3)
    out = [await img.read_snap("a", 0, len(v1)),
           await img.read_snap("b", 0, len(v1)), await img.read(0, len(v3))]
    assert out == [v1, v1, v3]
    return out


@case
async def rbd_middle_snapshot_removal_rehomes_clones(r):
    img = await (await r.rbd_ns("midsnap")).create("mid", 2 << 20, order=18)
    v1, v2 = blob(50_000, 47), blob(50_000, 48)
    await img.write(0, v1)
    await img.snap_create("s0")
    await img.snap_create("s1")
    await img.write(0, v2)
    assert await img.read_snap("s0", 0, len(v1)) == v1
    await img.snap_remove("s1")
    out = [await img.read_snap("s0", 0, len(v1)), await img.read(0, len(v2))]
    assert out == [v1, v2]
    return out, await header(img)


@case
async def rbd_resize_and_remove(r):
    rbd = await r.rbd_ns("resize")
    img = await rbd.create("disk2", 2 << 20, order=18)
    await img.write(0, blob(1 << 20, 49))
    await img.resize(256 << 10)
    out = {"shrunk": (await img.stat())["size"]}
    assert out["shrunk"] == 256 << 10
    await img.resize(4 << 20)
    out["grown_tail"] = await img.read(3 << 20, 100)
    assert out["grown_tail"] == b"\x00" * 100
    out["header"] = await header(img)
    await rbd.remove("disk2")
    out["list"] = await rbd.list()
    out["data_left"] = [o for o in await rbd.ioctx.list_objects()
                        if o.startswith("rbd_data.")]
    assert out["list"] == [] and out["data_left"] == []
    return out


@case
async def rbd_layered_clone_read_write_flatten(r):
    rbd = await r.rbd_ns("clone")
    Err = r.pkg.rbd.RbdError
    parent = await rbd.create("golden", 2 << 20, order=18)
    base = blob(600_000, 50)
    await parent.write(0, base)
    await parent.snap_create("v1")
    out = {"unprotected": await raises(Err, rbd.clone("golden", "v1", "vm1"))}
    await parent.snap_protect("v1")
    child = await rbd.clone("golden", "v1", "vm1")
    out["children"] = await rbd.children("golden", "v1")
    assert out["children"] == ["vm1"]
    assert await child.read(0, len(base)) == base
    await parent.write(0, b"NEWHEAD")
    assert await child.read(0, 7) == base[:7]
    await child.write(100, b"CHILD")
    out["copy_up"] = await child.read(0, 200)
    assert out["copy_up"] == base[:100] + b"CHILD" + base[105:200]
    assert await parent.read_snap("v1", 100, 5) == base[100:105]
    out["refused"] = [await raises(Err, parent.snap_remove("v1")),
                      await raises(Err, parent.snap_unprotect("v1"))]
    out["child_header"] = await header(child)
    await child.flatten()
    assert await rbd.children("golden", "v1") == []
    want = bytearray(base)
    want[100:105] = b"CHILD"
    out["flat"] = await child.read(0, len(base))
    assert out["flat"] == bytes(want)
    await parent.snap_unprotect("v1")
    await parent.snap_remove("v1")
    await rbd.snap_purge("golden")
    await rbd.remove("golden")
    child2 = await rbd.open("vm1")
    assert await child2.read(100, 5) == b"CHILD"
    out["flat_header"] = await header(child2)
    return out


@case
async def rbd_clone_removal_unregisters(r):
    rbd = await r.rbd_ns("clonerm")
    parent = await rbd.create("tmpl", 1 << 20, order=18)
    await parent.write(0, b"seed" * 1000)
    await parent.snap_create("s")
    await parent.snap_protect("s")
    await rbd.clone("tmpl", "s", "c1")
    await rbd.clone("tmpl", "s", "c2")
    out = [await rbd.children("tmpl", "s")]
    await rbd.remove("c1")
    out.append(await rbd.children("tmpl", "s"))
    await rbd.remove("c2")
    await parent.snap_unprotect("s")
    assert out == [["c1", "c2"], ["c2"]]
    return out


@case
async def rbd_clone_of_clone_reads_grandparent_blocks(r):
    rbd = await r.rbd_ns("grandparent")
    a = await rbd.create("A", 1 << 20, order=18)
    base = blob(400_000, 51)
    await a.write(0, base)
    await a.snap_create("s1")
    await a.snap_protect("s1")
    b = await rbd.clone("A", "s1", "B")
    await b.write(0, b"BBLOCK")
    await b.snap_create("s2")
    await b.snap_protect("s2")
    c = await rbd.clone("B", "s2", "C")
    got = await c.read(0, 400_000)
    assert got == b"BBLOCK" + base[6:]
    await c.flatten()
    flat = await c.read(262144, 100)
    assert flat == base[262144:262244]
    return got, flat, await header(c)


@case
async def rbd_snap_lifecycle_via_cls(r):
    """On a replicated pool the header updates run in the OSD (cls rbd)."""
    rbd = r.pkg.rbd.RBD(r.io_rep)
    Err = r.pkg.rbd.RbdError
    img = await rbd.create("vm", 4 << 20, order=20)
    v1 = blob(100_000, 52)
    await img.write(0, v1)
    await img.snap_create("s1")
    out = {"dup": await raises(Err, img.snap_create("s1"))}
    await img.write(0, blob(100_000, 53))
    out["s1"] = await img.read_snap("s1", 0, len(v1))
    assert out["s1"] == v1
    await img.snap_protect("s1")
    out["protected"] = await raises(Err, img.snap_remove("s1"))
    await img.snap_unprotect("s1")
    await img.snap_remove("s1")
    assert img.snap_list() == []
    out["header"] = await header(img)
    return out


# -- rbd on a replicated pool: in-OSD classes, groups, object-map rebuild,
#    migration (test_services's TestInOsdClasses, TestRbdGroupsAndRebuild and
#    TestRbdMigration) -----------------------------------------------------------

@case
async def rbd_concurrent_writers_keep_every_block(r):
    rbd = await r.rbd_ns("writers", pool="rep")
    img = await rbd.create("disk", 32 << 20, order=20)
    img2 = await rbd.open("disk")
    blocks = list(range(16))
    await asyncio.gather(*((img if i % 2 else img2).write(
        i << 20, bytes([i + 1]) * 4096) for i in blocks))
    fresh = await rbd.open("disk")
    assert fresh._hdr["object_map"] == blocks
    reads = [await fresh.read(i << 20, 4096) for i in blocks]
    assert reads == [bytes([i + 1]) * 4096 for i in blocks]
    return reads, await header(fresh)


@case
async def rbd_racing_image_creates_exactly_one_wins(r):
    rbd = await r.rbd_ns("race", pool="rep")
    results = await asyncio.gather(*(rbd.create("img", 1 << 20)
                                     for _ in range(6)),
                                   return_exceptions=True)
    wins = [x for x in results if not isinstance(x, Exception)]
    losses = [str(x) for x in results if isinstance(x, r.pkg.rbd.RbdError)]
    assert len(wins) == 1 and len(losses) == 5
    return len(wins), losses


@case
async def rbd_group_snapshot_lifecycle(r):
    rbd = await r.rbd_ns("group", pool="rep")
    Err = r.pkg.rbd.RbdError
    vm1 = await rbd.create("vm1", 2 << 20, order=19)
    vm2 = await rbd.create("vm2", 2 << 20, order=19)
    d1, d2 = blob(100_000, 70), blob(100_000, 71)
    await vm1.write(0, d1)
    await vm2.write(0, d2)
    await rbd.group_create("appgrp")
    await rbd.group_image_add("appgrp", "vm1")
    await rbd.group_image_add("appgrp", "vm2")
    out = {"members": await rbd.group_image_list("appgrp"),
           "groups": await rbd.group_list()}
    assert out["members"] == ["vm1", "vm2"] and "appgrp" in out["groups"]
    await rbd.group_snap_create("appgrp", "checkpoint")
    out["snaps"] = await rbd.group_snap_list("appgrp")
    assert out["snaps"] == ["checkpoint"]
    # reopened: data writes need the snap context the sweep set
    vm1, vm2 = await rbd.open("vm1"), await rbd.open("vm2")
    await vm1.write(0, blob(100_000, 72))
    await vm2.write(0, blob(100_000, 73))
    snap = "group.appgrp.checkpoint"
    out["at_snap"] = [await vm1.read_snap(snap, 0, len(d1)),
                      await vm2.read_snap(snap, 0, len(d2))]
    assert out["at_snap"] == [d1, d2]
    # the second member's duplicate fails the sweep after vm1 was snapped:
    # the rollback undoes vm1's member snap
    await (await rbd.open("vm2")).snap_create("group.appgrp.dup")
    out["dup"] = await raises(Err, rbd.group_snap_create("appgrp", "dup"))
    out["vm1_snaps"] = (await rbd.open("vm1")).snap_list()
    assert "group.appgrp.dup" not in out["vm1_snaps"]
    assert await rbd.group_snap_list("appgrp") == ["checkpoint"]
    await (await rbd.open("vm2")).snap_remove("group.appgrp.dup")
    out["busy"] = await raises(Err, rbd.group_remove("appgrp"),
                               match="has snapshots")
    await rbd.group_snap_remove("appgrp", "checkpoint")
    await rbd.group_remove("appgrp")
    out["after"] = await rbd.group_list()
    assert out["after"] == []
    out["headers"] = [await header(await rbd.open(n)) for n in ("vm1", "vm2")]
    return out


@case
async def rbd_object_map_rebuild_recovers_lost_map(r):
    rbd = await r.rbd_ns("omr", pool="rep")
    img = await rbd.create("disk", 8 << 20, order=20)
    blocks = {idx: blob(4096, 74 + idx) for idx in (0, 3, 6)}
    for idx, data in blocks.items():
        await img.write(idx << 20, data)
    # a lost map: the explicit drop list (a plain push merges with the
    # stored map)
    img._hdr["object_map"] = []
    await img._save_header(drop_blocks=[0, 3, 6])
    fresh = await rbd.open("disk")
    assert fresh._hdr["object_map"] == []
    recovered = await fresh.rebuild_object_map()
    assert recovered == 3 and fresh._hdr["object_map"] == [0, 3, 6]
    reads = [await fresh.read(idx << 20, 4096) for idx in blocks]
    assert reads == list(blocks.values())
    return recovered, reads, await header(fresh)


async def migration(r, nspace):
    """(source RBD, destination RBD, ImageMigrator) between namespace
    `nspace` of the two replicated pools."""
    src = await r.rbd_ns(nspace, pool="rep")
    dst = await r.rbd_ns(nspace, pool="neo")
    return src, dst, r.pkg.rbd.ImageMigrator(src.ioctx, dst.ioctx)


@case
async def rbd_migrate_with_snapshots_then_commit(r):
    rbd, dst, mig = await migration(r, "mig1")
    Err = r.pkg.rbd.RbdError
    img = await rbd.create("vm", 2 << 20, order=19)
    v1, v2, v3 = (blob(200_000, s) for s in (80, 81, 82))
    await img.write(0, v1)
    await img.snap_create("s1")
    await img.write(0, v2)
    await img.snap_create("s2")
    await img.write(0, v3)
    await mig.prepare("vm")
    out = {"again": await raises(Err, mig.prepare("vm"),
                                 match="already migrating")}
    assert await (await rbd.open("vm")).read(0, len(v3)) == v3
    await mig.execute("vm")
    await mig.commit("vm")
    out["source"] = await raises(Err, rbd.open("vm"))
    moved = await dst.open("vm")
    out["head"] = await moved.read(0, len(v3))
    out["snaps"] = sorted(moved.snap_list())
    out["at_snaps"] = [await moved.read_snap("s1", 0, len(v1)),
                       await moved.read_snap("s2", 0, len(v2))]
    assert out["head"] == v3 and out["snaps"] == ["s1", "s2"]
    assert out["at_snaps"] == [v1, v2]
    out["header"] = await header(moved)
    return out


@case
async def rbd_migration_commit_syncs_late_writes_abort_refuses_stranger(r):
    rbd, dst, mig = await migration(r, "mig2")
    img = await rbd.create("vol", 1 << 20, order=19)
    await img.write(0, b"A" * 50_000)
    await mig.prepare("vol")
    await mig.execute("vol")
    late = b"B" * 50_000
    await (await rbd.open("vol")).write(0, late)
    await mig.commit("vol")
    out = [await (await dst.open("vol")).read(0, len(late))]
    assert out[0] == late
    assert "migration" not in (await dst.open("vol"))._hdr
    await rbd.create("vol", 1 << 20, order=19)  # a new source
    mig2 = r.pkg.rbd.ImageMigrator(rbd.ioctx, dst.ioctx)
    out.append(await raises(r.pkg.rbd.RbdError, mig2.abort("vol"),
                            match="not a migration"))
    out.append(await (await dst.open("vol")).read(0, len(late)))
    assert out[2] == late
    return out


@case
async def rbd_migration_clone_source_refused_and_crash_resume(r):
    rbd, dst, mig = await migration(r, "mig3")
    base = await rbd.create("base", 1 << 20, order=19)
    await base.write(0, b"P" * 40_000)
    await base.snap_create("s")
    await base.snap_protect("s")
    await rbd.clone("base", "s", "child")
    out = [await raises(r.pkg.rbd.RbdError, mig.prepare("child"),
                        match="clone")]
    img = await rbd.create("plain", 1 << 20, order=19)
    await img.write(0, b"Q" * 40_000)
    await mig.prepare("plain")
    await mig.execute("plain")
    out.append((await dst.open("plain"))._hdr["migration"])
    assert out[-1]["state"] == "executed"
    # the crash window: the source fully removed, the destination marked
    src_img = await rbd.open("plain")
    src_img._hdr.pop("migration", None)
    await src_img._save_header()
    await rbd.remove("plain")
    await mig.commit("plain")  # the resume branch
    done = await dst.open("plain")
    assert "migration" not in done._hdr
    out.append(await done.read(0, 40_000))
    assert out[-1] == b"Q" * 40_000
    return out


@case
async def rbd_migration_abort_keeps_source_intact(r):
    rbd, dst, mig = await migration(r, "mig4")
    img = await rbd.create("disk", 1 << 20, order=19)
    data = blob(100_000, 83)
    await img.write(0, data)
    await mig.prepare("disk")
    await mig.execute("disk")
    await mig.abort("disk")
    fresh = await rbd.open("disk")
    out = [await fresh.read(0, len(data)), "migration" in fresh._hdr,
           await raises(r.pkg.rbd.RbdError, dst.open("disk"))]
    assert out[:2] == [data, False]
    await mig.prepare("disk")  # can start over
    return out, await header(fresh)


# -- rbd journaling and mirroring (test_service_tier's TestRbdMirroring and
#    TestMirrorLateJoin; EC pools) --------------------------------------------

@case
async def rbd_journal_replay_reproduces_image(r):
    rbd = r.pkg.rbd
    io_a = (await r.rbd_ns("mir1")).ioctx
    io_b = (await r.rbd_ns("mir1", pool="siteb")).ioctx
    jimg = rbd.JournaledImage(await rbd.RBD(io_a).create("vm", 1 << 20,
                                                         order=16))
    await jimg.write(0, blob(100_000, 84))
    await jimg.write(200_000, b"tail" * 2500)
    mir = rbd.Mirrorer(io_a, io_b)
    out = {"first": await mir.replay("vm")}  # initial sync, not replay
    out["synced"] = await (await rbd.RBD(io_b).open("vm")).read(0, 1 << 20)
    assert out["first"] == 0 and out["synced"] == await jimg.read(0, 1 << 20)
    await jimg.write(50_000, b"delta" * 1000)
    out["second"] = await mir.replay("vm")
    out["replayed"] = await (await rbd.RBD(io_b).open("vm")).read(0, 1 << 20)
    assert out["second"] == 1
    assert out["replayed"] == await jimg.read(0, 1 << 20)
    out["third"] = await mir.replay("vm")
    assert out["third"] == 0
    return out


@case
async def rbd_mirror_late_peer_bootstraps_from_image(r):
    rbd = r.pkg.rbd
    io_a = (await r.rbd_ns("mir2")).ioctx
    io_b = (await r.rbd_ns("mir2", pool="siteb")).ioctx
    io_c = (await r.rbd_ns("mir2", pool="sitec")).ioctx
    j = rbd.JournaledImage(await rbd.RBD(io_a).create("vm", 1 << 19,
                                                      order=15))
    await j.write(0, blob(200_000, 85))
    await rbd.Mirrorer(io_a, io_b).replay("vm")
    await j.write(100_000, blob(50_000, 86))
    await rbd.Mirrorer(io_a, io_b).replay("vm")
    # peer C joins after the journal expired behind B: initial sync first
    await rbd.Mirrorer(io_a, io_c).replay("vm")
    out = [await (await rbd.RBD(io_c).open("vm")).read(0, 1 << 19)]
    assert out[0] == await j.read(0, 1 << 19)
    await j.write(5_000, b"post-join" * 100)
    out.append(await rbd.Mirrorer(io_a, io_c).replay("vm"))
    out.append(await (await rbd.RBD(io_c).open("vm")).read(0, 1 << 19))
    assert out[1] == 1 and out[2] == await j.read(0, 1 << 19)
    return out


# -- rbd export / import / diff streams ---------------------------------------

@case
async def export_sparse_roundtrip(r):
    rbd, x = await r.rbd_ns("export"), r.pkg.rbd_export
    img = await rbd.create("src", 4 << 20, order=18)
    data = blob(300_000, 60)
    await img.write(0, data)
    await img.write(3 << 20, b"tail-bytes")
    buf = io.BytesIO()
    stats = await x.export_image(img, buf)
    assert stats["size"] == 4 << 20
    buf.seek(0)
    dst = await x.import_image(rbd, "dst", buf, order=18)
    out = {"stats": stats, "stream": buf.getvalue(),
           "image": await img.read(0, img.size),
           "imported": await dst.read(0, dst.size)}
    assert out["imported"] == out["image"]
    assert await dst.read(1 << 20, 4096) == b"\x00" * 4096
    assert set(dst._hdr["object_map"]) == set(img._hdr["object_map"])
    out["headers"] = [await header(img), await header(dst)]
    return out


@case
async def export_of_snapshot(r):
    rbd, x = await r.rbd_ns("exportsnap"), r.pkg.rbd_export
    img = await rbd.create("s", 1 << 20, order=18)
    await img.write(0, b"frozen")
    await img.snap_create("snap1")
    await img.write(0, b"edited")
    buf = io.BytesIO()
    await x.export_image(img, buf, snap="snap1")
    buf.seek(0)
    dst = await x.import_image(rbd, "restored", buf, order=18)
    got = await dst.read(0, 6)
    assert got == b"frozen"
    return buf.getvalue(), got


@case
async def diff_incremental_backup_chain(r):
    rbd, x = await r.rbd_ns("diffchain"), r.pkg.rbd_export
    img = await rbd.create("vm", 2 << 20, order=18)
    await img.write(0, b"A" * BS)
    await img.write(BS, b"B" * BS)
    await img.snap_create("s1")
    full = io.BytesIO()
    await x.export_image(img, full, snap="s1")
    await img.write(0, b"X" * BS)
    await img.write(4 * BS, b"D" * 1000)
    await img.write(BS, b"\x00" * BS)
    await img.snap_create("s2")
    delta = io.BytesIO()
    stats = await x.export_diff(img, delta, from_snap="s1", to_snap="s2")
    assert stats["blocks_written"] == 2
    full.seek(0)
    dst = await x.import_image(rbd, "restore", full, order=18)
    delta.seek(0)
    await x.apply_diff(dst, delta)
    out = {"full": full.getvalue(), "delta": delta.getvalue(), "stats": stats,
           "restored": await dst.read(0, dst.size)}
    assert out["restored"] == await img.read(0, img.size)
    assert 1 not in dst._hdr["object_map"]
    out["header"] = await header(dst)
    return out


@case
async def diff_resize_propagates(r):
    rbd, x = await r.rbd_ns("diffresize"), r.pkg.rbd_export
    img = await rbd.create("g", 1 << 20, order=18)
    await img.write(0, b"base")
    await img.snap_create("s1")
    await img.resize(2 << 20)
    await img.write(1 << 20, b"grown")
    delta = io.BytesIO()
    await x.export_diff(img, delta, from_snap="s1")
    dst = await rbd.create("g2", 1 << 20, order=18)
    await dst.write(0, b"base")
    delta.seek(0)
    await x.apply_diff(dst, delta)
    assert dst.size == 2 << 20
    got = await dst.read(1 << 20, 5)
    assert got == b"grown"
    return delta.getvalue(), dst.size, got


def zero_stream(x, size, *extents):
    meta = json.dumps({"size": size}).encode()
    return io.BytesIO(x.MAGIC + b"m" + struct.pack("<I", len(meta)) + meta
                      + b"".join(b"z" + x._W.pack(off, n)
                                 for off, n in extents) + b"e")


@case
async def diff_partial_block_zero_record_preserves_live_bytes(r):
    rbd, x = await r.rbd_ns("diffzero"), r.pkg.rbd_export
    img = await rbd.create("pz", 1 << 20, order=18)
    await img.write(0, b"A" * BS)
    await img.write(BS, b"B" * BS)
    z_off = 1000
    stats = await x.apply_diff(img, zero_stream(x, 1 << 20, (z_off, BS)))
    assert stats["trims"] == 1
    out = [await img.read(0, z_off), await img.read(z_off + BS, 100),
           await img.read(z_off, 50), await img.read(BS, 100)]
    assert out == [b"A" * z_off, b"B" * 100, b"\x00" * 50, b"\x00" * 100]
    await x.apply_diff(img, zero_stream(x, 1 << 20, (BS, BS)))
    assert 1 not in img._hdr["object_map"]
    await x.apply_diff(img, zero_stream(x, 1 << 20, (BS + 100, 500)))
    assert 1 not in img._hdr["object_map"]
    return stats, out, await header(img)


@case
async def diff_tail_block_trim_on_unaligned_image(r):
    rbd, x = await r.rbd_ns("difftail"), r.pkg.rbd_export
    size = BS + BS // 2
    img = await rbd.create("tail", size, order=18)
    await img.write(0, b"A" * BS)
    await img.write(BS, b"T" * (size - BS))
    await x.apply_diff(img, zero_stream(x, size, (BS, size - BS)))
    assert 1 not in img._hdr["object_map"]
    out = [await img.read(BS, 100)]
    await x.apply_diff(img, zero_stream(x, size, (BS - 10, 10 * BS)))
    out += [await img.read(BS - 10, 10), await img.read(0, 10)]
    assert out == [b"\x00" * 100, b"\x00" * 10, b"A" * 10]
    return out


@case
async def diff_zero_record_on_clone_writes_zeros_not_parent(r):
    rbd, x = await r.rbd_ns("diffclone"), r.pkg.rbd_export
    parent = await rbd.create("par", 1 << 20, order=18)
    await parent.write(0, b"P" * BS)
    await parent.write(BS, b"Q" * BS)
    await parent.snap_create("base")
    await parent.snap_protect("base")
    clone = await rbd.clone("par", "base", "kid")
    assert await clone.read(0, 4) == b"PPPP"
    await x.apply_diff(clone, zero_stream(x, 1 << 20, (0, BS)))
    out = [await clone.read(0, 100)]
    await x.apply_diff(clone, zero_stream(x, 1 << 20, (BS + 100, 200)))
    out += [await clone.read(BS, 100), await clone.read(BS + 100, 200),
            await clone.read(BS + 300, 100), await parent.read(0, 4)]
    assert out == [b"\x00" * 100, b"Q" * 100, b"\x00" * 200, b"Q" * 100,
                   b"PPPP"]
    return out


@case
async def diff_corrupt_stream_rejected(r):
    rbd, x = await r.rbd_ns("diffbad"), r.pkg.rbd_export
    img = await rbd.create("c", 1 << 20, order=18)
    Err = r.pkg.rbd.RbdError
    try:
        await x.apply_diff(img, io.BytesIO(b"not a stream"))
    except Err as e:
        bad_magic = str(e)
    else:
        raise AssertionError("a stream without the magic was applied")
    truncated = await raises(Err, x.apply_diff(img, io.BytesIO(x.MAGIC
                                                                + b"w")))
    return x.MAGIC, bad_magic, truncated


@case
async def trash_lifecycle(r):
    rbd = await r.rbd_ns("trash")
    img = await rbd.create("vm", 1 << 20, order=18)
    data = blob(100_000, 61)
    await img.write(0, data)
    tid = await rbd.trash_mv("vm", delay=3600)
    out = {"tid": tid, "list": await rbd.list(), "ls": await rbd.trash_ls()}
    assert out["list"] == [] and [e["name"] for e in out["ls"]] == ["vm"]
    assert out["ls"][0]["id"] == tid
    out["early_purge"] = await rbd.trash_purge()
    assert out["early_purge"] == 0 and len(await rbd.trash_ls()) == 1
    restored = await rbd.trash_restore(tid)
    out["restored"] = await restored.read(0, len(data))
    assert out["restored"] == data
    assert await rbd.list() == ["vm"] and await rbd.trash_ls() == []
    await rbd.trash_mv("vm", delay=3600)
    out["forced"] = await rbd.trash_purge(force=True)
    assert out["forced"] == 1 and await rbd.trash_ls() == []
    out["gone"] = await raises(r.pkg.rbd.RbdError, rbd.open("vm"))
    return out


@case
async def trash_restore_name_collision_and_rename(r):
    rbd = await r.rbd_ns("trashname")
    img = await rbd.create("disk", 1 << 20, order=18)
    await img.write(0, b"old-gen")
    tid = await rbd.trash_mv("disk")
    await rbd.create("disk", 1 << 20, order=18)
    out = [await raises(r.pkg.rbd.RbdError, rbd.trash_restore(tid))]
    restored = await rbd.trash_restore(tid, new_name="disk-old")
    out += [await restored.read(0, 7), sorted(await rbd.list())]
    assert out[1:] == [b"old-gen", ["disk", "disk-old"]]
    return out, await header(restored)


@case
async def trash_refuses_snapshotted_image(r):
    rbd = await r.rbd_ns("trashsnap")
    img = await rbd.create("s", 1 << 20, order=18)
    await img.write(0, b"x")
    await img.snap_create("keep")
    return await raises(r.pkg.rbd.RbdError, rbd.trash_mv("s"))


# -- the CLIs (default namespace of the rbd pool) ----------------------------

async def cli(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = await mod.run(mod.parse_args(argv))
    return rc, out.getvalue()


@case
async def rbd_cli_backup_workflow(r):
    rbd = r.pkg.rbd.RBD(r.io_rbd)
    base = ["--mon", r.mon, "--pool", "rbdx"]
    path = os.path.join(r.tmp, "disk.full")
    out = [await cli(r.pkg.rbd_cli, base + ["create", "disk", "--size", "1M",
                                            "--order", "18"])]
    await (await rbd.open("disk")).write(0, b"cli-bytes")
    for argv in (["snap", "create", "disk@backup"],
                 ["export", "disk@backup", path],
                 ["import", path, "disk2", "--order", "18"],
                 ["ls"], ["info", "disk"]):
        out.append(await cli(r.pkg.rbd_cli, base + argv))
    assert await (await rbd.open("disk2")).read(0, 9) == b"cli-bytes"
    out.append(await cli(r.pkg.rbd_cli, base + ["rm", "disk2"]))
    assert "disk2" not in await rbd.list()
    assert [rc for rc, _ in out] == [0] * len(out)
    with open(path, "rb") as f:
        out.append(f.read())
    return out


@case
async def rbd_cli_du_reports_used_from_object_map(r):
    rbd = r.pkg.rbd.RBD(r.io_rbd)
    base = ["--mon", r.mon, "--pool", "rbdx"]
    img = await rbd.create("sparse", 8 << 20, order=18)
    await img.write(0, b"x" * BS)
    await img.write(4 << 20, b"y" * 100)
    await img.snap_create("s1")
    await img.write(0, b"z" * BS)
    one = await cli(r.pkg.rbd_cli, base + ["du", "sparse"])
    row = [ln for ln in one[1].splitlines() if ln.startswith("sparse")][0]
    assert [int(v) for v in row.split()[1:]] == [8 << 20, 2 * BS, 2 * BS]
    await rbd.create("thin", 4 << 20, order=18)
    every = await cli(r.pkg.rbd_cli, base + ["du"])
    lines = every[1].splitlines()
    assert any(ln.startswith("thin") and " 0" in ln for ln in lines)
    assert any(ln.startswith("TOTAL") for ln in lines)
    return one, every


@case
async def rados_cli(r):
    base = ["--mon", r.mon]
    src, dst = os.path.join(r.tmp, "obj.in"), os.path.join(r.tmp, "obj.out")
    data = blob(50_000, 62)
    with open(src, "wb") as f:
        f.write(data)
    prof = [f"{k}={v}" for k, v in r.profile.items()]
    out = [await cli(r.pkg.rados_cli, base + ["mkpool", "clipool", *prof])]
    for argv in (["put", "clipool", "obj1", src],
                 ["get", "clipool", "obj1", dst], ["ls", "clipool"],
                 ["mksnap", "clipool", "snap1"], ["lssnap", "clipool"],
                 ["rm", "clipool", "obj1"], ["ls", "clipool"]):
        out.append(await cli(r.pkg.rados_cli, base + argv))
    with open(dst, "rb") as f:
        got = f.read()
    assert got == data
    assert [rc for rc, _ in out] == [0] * len(out)
    assert out[3][1].split() == ["obj1"] and out[7][1] == ""
    return out, got


# -- after one OSD is lost ---------------------------------------------------

LOSS_CASES = {}


def after_loss(fn):
    LOSS_CASES[fn.__name__] = fn
    return fn


@after_loss
async def degraded_reads(r):
    """The striped object, the replicated objects and an rbd image, read
    after one OSD is lost."""
    out = {"movie": await r.pkg.RadosStriper(
        r.io_ec, object_size=32 * 1024).read("movie")}
    assert out["movie"] == blob(200_000, 22)
    out["replicated"] = [await r.io_rep.read(f"r{i}") for i in range(1, 6)]
    assert out["replicated"] == [blob(30_000, 30 + i) for i in range(1, 6)]
    img = await (await r.rbd_ns("snaps")).open("snapdisk")
    out["rbd"] = await img.read(0, img.size)
    out["rbd_s2"] = await img.read_snap("s2", 0, 300_000)
    assert out["rbd_s2"] == blob(300_000, 42)
    return out


@after_loss
async def replicated_recovery(r):
    """A new OSD joins; repair_pool brings every acting member of the
    replicated object's PG a copy again."""
    await r.add_osd()
    c = r.rados._client
    await c.refresh_map()
    await c.repair_pool(r.io_rep.pool_id)
    p = c.osdmap.pools[r.io_rep.pool_id]
    acting = [a for a in c.osdmap.pg_to_acting(p, c.osdmap.object_to_pg(
        p, "rrec")) if a >= 0]

    def copies():
        return sum(1 for osd_id in acting if osd_id in r.cluster.osds and any(
            o == "rrec" for o, _ in r.cluster.osds[osd_id]
            ._list_pool_objects(r.io_rep.pool_id)))

    for _ in range(200):  # pushes are fire-and-forget
        if copies() == len(acting):
            break
        await asyncio.sleep(0.05)
    assert copies() == len(acting) == 3
    got = await r.io_rep.read("rrec")
    assert got == blob(20_000, 36)
    return got


# -- the run ------------------------------------------------------------------

class Run:
    """One package's cluster, handles and pools."""

    def __init__(self, prefix, tmp, mp):
        self.pkg = package(prefix)
        self.tmp = tmp
        self.profile = PROFILES[prefix]
        self.conf = dict(CONF, **({"osd_ec_device": "cpu"}
                                  if prefix == PORT else {}))
        self._mp = mp
        rbd_mod = self.pkg.rbd
        mp.setattr(rbd_mod, "uuid", PinnedIds())
        clock = types.SimpleNamespace(time=lambda: CLOCK)
        mp.setattr(rbd_mod, "time", clock)
        mp.setattr(importlib.import_module(f"{prefix}.services.cls"), "time",
                   clock)
        self.records = {}

    @contextlib.contextmanager
    def batching(self):
        """The port's OSDs batch on the CPU (CEPH_TPU_FORCE_BATCH=1); the
        reference's run as its own tests run them."""
        with pytest.MonkeyPatch.context() as mp:
            if self.pkg.prefix == PORT:
                mp.setenv("CEPH_TPU_FORCE_BATCH", "1")
            else:
                mp.delenv("CEPH_TPU_FORCE_BATCH", raising=False)
            yield

    async def start(self):
        self.cluster = self.pkg.Cluster(n_osds=5, conf=dict(self.conf))
        with self.batching():
            await self.cluster.start()
        mon = self.cluster.mons[0].addr
        self.mon = f"{mon[0]}:{mon[1]}"
        self.rados = await self.pkg.Rados(self.cluster.mon_addrs,
                                          self.conf).connect()
        await self.rados.pool_create("ec", profile=self.profile)
        await self.rados.pool_create("rep", pool_type="replicated",
                                     profile={"size": "3"})
        await self.rados.pool_create("neo", pool_type="replicated")
        for pool in ("rbdx", "siteb", "sitec"):
            await self.rados.pool_create(pool, profile=self.profile)
        self.io_ec = await self.rados.open_ioctx("ec")
        self.io_rep = await self.rados.open_ioctx("rep")
        self.io_rbd = await self.rados.open_ioctx("rbdx")
        self.neo = self.pkg.neo.RADOS(None, client=self.rados._client)
        self.ioc_rep = self.pkg.neo.IOContext(
            (await self.rados.open_ioctx("neo")).pool_id)
        self.ioc_ec = self.pkg.neo.IOContext(self.io_ec.pool_id)

    async def rbd_ns(self, nspace, pool="rbdx"):
        """An RBD handle on `pool`, in namespace `nspace`."""
        ioc = await self.rados.open_ioctx(pool)
        ioc.set_namespace(nspace)
        return self.pkg.rbd.RBD(ioc)

    async def add_osd(self):
        with self.batching():
            return await self.cluster.add_osd()

    async def run_cases(self, cases):
        for name, fn in cases.items():
            try:
                self.records[name] = await fn(self)
            except Exception as e:  # recorded; the case's test fails on it
                self.records[name] = ("error", type(e).__name__, str(e))

    async def lose_an_osd(self):
        victim = sorted(self.cluster.osds)[0]
        await self.cluster.kill_osd(victim)
        await self.rados._client.mark_osd_down(victim)
        await self.rados._client.refresh_map()

    async def import_stream(self, stream, name, diff=None):
        """Import a full stream (then apply a diff stream, if given) into a
        new image in namespace "cross"; the image's bytes."""
        rbd, x = await self.rbd_ns("cross"), self.pkg.rbd_export
        img = await x.import_image(rbd, name, io.BytesIO(stream), order=18)
        if diff is not None:
            await x.apply_diff(img, io.BytesIO(diff))
        return await img.read(0, img.size)

    async def stop(self):
        await self.rados.shutdown()
        await self.cluster.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' records, and the streams each imported from the
    other: {"ref": records, "port": records, "cross": {...}}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_osd, "_BATCH_QUEUE", None)
        mp.setattr(port_osd, "_PLANAR_STORE", None)
        ref = Run(REF, str(tmp_path_factory.mktemp("ref")), mp)
        port = Run(PORT, str(tmp_path_factory.mktemp("port")), mp)

        async def go():
            try:
                await ref.start()
                await port.start()
                for r in (ref, port):
                    await r.run_cases(CASES)
                cross = {}
                for src, dst in ((ref, port), (port, ref)):
                    chain = src.records["diff_incremental_backup_chain"]
                    sparse = src.records["export_sparse_roundtrip"]
                    if isinstance(chain, dict) and isinstance(sparse, dict):
                        tag = f"{src.pkg.prefix}->{dst.pkg.prefix}"
                        cross[tag] = {
                            "sparse": await dst.import_stream(
                                sparse["stream"], "sparse-" + src.pkg.prefix),
                            "chain": await dst.import_stream(
                                chain["full"], "chain-" + src.pkg.prefix,
                                diff=chain["delta"])}
                for r in (ref, port):
                    await r.lose_an_osd()
                    await r.run_cases(LOSS_CASES)
                stats = {"queue_submits": port_osd._BATCH_QUEUE.submits,
                         "store_hits": port_osd._PLANAR_STORE.hits}
                return {"ref": ref.records, "port": port.records,
                        "cross": cross, "port_stats": stats}
            finally:
                for r in (port, ref):
                    if hasattr(r, "rados"):
                        await r.stop()

        try:
            return asyncio.run(asyncio.wait_for(go(), 240))
        finally:
            if port_osd._BATCH_QUEUE is not None:
                port_osd._BATCH_QUEUE.close()


@pytest.mark.parametrize("name", [*CASES, *LOSS_CASES])
def test_case_matches_reference(runs, name):
    ref, port = runs["ref"][name], runs["port"][name]
    for pkg, got in ((REF, ref), (PORT, port)):
        assert not (isinstance(got, tuple) and got[:1] == ("error",)), \
            f"{pkg}: {got}"
    assert port == ref


@pytest.mark.parametrize("direction", [f"{REF}->{PORT}", f"{PORT}->{REF}"])
def test_streams_import_across_packages(runs, direction):
    """A full export and an export-diff chain made by one package import
    into the other, to the exporting image's bytes."""
    src = runs["ref" if direction.startswith(REF + "-") else "port"]
    got = runs["cross"][direction]
    assert got["sparse"] == src["export_sparse_roundtrip"]["image"]
    assert got["chain"] == src["diff_incremental_backup_chain"]["restored"]


def test_stream_magic_is_the_reference_s(runs):
    from ceph_tpu.services import rbd_export as ref_export
    from ceph_tpu_torch.services import rbd_export

    assert rbd_export.MAGIC == ref_export.MAGIC == b"ceph_tpu-rbd-diff-v1\n"
    stream = runs["port"]["export_sparse_roundtrip"]["stream"]
    assert stream.startswith(rbd_export.MAGIC)


def test_port_ec_traffic_went_through_its_queue_and_store(runs):
    assert runs["port_stats"]["queue_submits"] > 0
    assert runs["port_stats"]["store_hits"] > 0
