"""The port's object gateway and CephFS against ceph_tpu's, on the same inputs.

One script runs on each package: rgw (buckets and objects, the S3 and Swift
HTTP frontend with SigV4 and tempauth, multipart, versioning, lifecycle,
ACLs and bucket policy, users, quotas and usage, presigned URLs, ranges,
copies, tagging, multisite sync), the ``radosgw-admin`` and
``cephfs-shell`` CLIs, the MDS (namespace, journal replay and expiry,
sessions and caps, snapshots), the cap-aware CephFS client and its file
handles, and multi-active MDS (routing, export, failover, balancing,
cross-rank and directory renames).  The cases are those of
tests/test_services.py's rgw and mds classes, tests/test_service_tier.py's
Swift, multisite, MDS session and CephFS client classes,
tests/test_rgw_admin.py, tests/test_rgw_range_copy.py,
tests/test_cephfs_handles.py, tests/test_mds_snapshots.py,
tests/test_cephfs_shell.py and tests/test_mds_cluster.py, each with the
reference test's own checks.  Then every pool's objects (all namespaces)
are read, one OSD is lost, and the EC objects are read again, degraded.
Two races of tests/test_cephfs_handles.py are not in the script (two
clients interleaving writes across ranks, and interleaving appends): each
runs about a minute in its own retry loops, and the order of the race
decides which inode ids the files end on.

Each package gets one cluster of 5 OSDs with a k=2 m=1 EC pool and
replicated pools.  The reference's EC pool is plugin=jerasure; the port's
is plugin=cuda on the CPU (``osd_ec_device: cpu`` and
CEPH_TPU_FORCE_BATCH=1, so its batching queue and paged resident store
carry the EC traffic), whose chunks equal jerasure's.  Each case works in a
RADOS namespace of its own (the CLI cases in pools of their own), so the
cases run concurrently; the multi-rank MDS cases wait out a 5 s revoke
timeout each, as their reference tests do.  rgw and mds draw
``uuid.uuid4()`` ids and stamp ``time.time()``: both packages' modules get
the same pinned ids, counted per case, and one fixed clock.  Every record
of the script must be equal across the packages, and both packages' pools
must hold the same objects with the same bytes.
"""

import asyncio
import contextlib
import contextvars
import errno
import importlib
import io
import json
import sys
import time
import types
from urllib.parse import quote, unquote, urlsplit

import numpy as np
import pytest

from ceph_tpu_torch.rados import osd as port_osd

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
# a generous heartbeat grace keeps peers up on a loaded host
CONF = {"osd_auto_repair": False, "osd_heartbeat_grace": 300.0}
PROFILES = {REF: {"plugin": "jerasure", "technique": "reed_sol_van",
                  "k": "2", "m": "1"},
            PORT: {"plugin": "cuda", "technique": "reed_sol_van",
                   "k": "2", "m": "1"}}
CLOCK = 1_760_000_000.0
POOLS = ("ec", "rep", "rgwadm", "fsx")  # the last two: the CLIs' pools
CASE = contextvars.ContextVar("case", default="")


def blob(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def package(prefix):
    imp = lambda name: importlib.import_module(f"{prefix}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        prefix=prefix,
        Cluster=imp("rados.vstart").Cluster,
        RadosError=imp("rados.client").RadosError,
        Rados=imp("rados.librados").Rados,
        types=imp("rados.types"),
        rgw=imp("services.rgw"),
        mds=imp("services.mds"),
        mdsc=imp("services.mds_cluster"),
        cls=imp("services.cls"),
        rgw_admin_cli=imp("tools.radosgw_admin"),
        shell_cli=imp("tools.cephfs_shell"))


class PinnedIds:
    """uuid4() stand-in: ids counted per case (the CASE context), so cases
    running side by side draw the same ids in every package."""

    def __init__(self, tag):
        self.tag = tag
        self.n = {}

    def uuid4(self):
        case = CASE.get()
        self.n[case] = self.n.get(case, 0) + 1
        idx = CASE_INDEX.get(case, 0xffff)
        return types.SimpleNamespace(
            hex=f"{self.tag:04x}{idx:04x}{self.n[case]:08x}" + "0" * 16)


class PinnedClock:
    """The time module with time() and gmtime() read at CLOCK."""

    def time(self):
        return CLOCK

    def gmtime(self, secs=None):
        return time.gmtime(CLOCK if secs is None else secs)

    def __getattr__(self, name):
        return getattr(time, name)


async def raises(exc, aw, match=None):
    """The exception `aw` raises, as (class name, code); fails if none, or
    if its message does not match `match`."""
    try:
        await aw
    except exc as e:
        assert match is None or match in str(e), str(e)
        return type(e).__name__, getattr(e, "code", None)
    raise AssertionError(f"{exc.__name__} not raised")


async def http(host, port, method, target, body=b"", headers=None):
    """One HTTP/1.1 exchange: (status, response headers, payload)."""
    hdrs = dict(headers or {})
    if not any(k.lower() == "content-length" for k in hdrs):
        hdrs["content-length"] = str(len(body))
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"{method} {target} HTTP/1.1\r\n".encode()
                 + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items()).encode()
                 + b"\r\n" + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    got = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        got[k.strip().lower()] = v.strip()
    n = int(got.get("content-length", 0))
    payload = await reader.readexactly(n) if n else b""
    writer.close()
    return status.split(" ", 1)[1].strip(), got, payload


class Gateway:
    """An RgwFrontend on an ephemeral port, and requests to it: unsigned,
    or SigV4-signed as `access` with its secret from `creds`."""

    def __init__(self, r, svc, creds=None):
        self.pkg, self.fe = r.pkg, r.pkg.rgw.RgwFrontend(svc)
        self.creds = dict(creds or {})

    async def __aenter__(self):
        self.host, self.port = await self.fe.start()
        self.hosthdr = f"{self.host}:{self.port}"
        return self

    async def __aexit__(self, *exc):
        await self.fe.stop()

    async def req(self, method, path, body=b"", access=None, query="",
                  headers=None, secret=None):
        """(status, payload, response headers)."""
        hdrs = {"host": self.hosthdr, "content-length": str(len(body)),
                **(headers or {})}
        if access:
            hdrs.update(self.pkg.rgw.sign_request(
                access, secret or self.creds[access], method, path, query,
                hdrs, body))
        target = path + (f"?{query}" if query else "")
        st, h, payload = await http(self.host, self.port, method, target,
                                    body, hdrs)
        return st, payload, h

    async def raw(self, method, target, body=b"", headers=None):
        """(status, payload, response headers) of a request with no host
        header unless given (the frontend tests' plain helper)."""
        st, h, payload = await http(self.host, self.port, method, target,
                                    body, headers)
        return st, payload, h


CASES, SERIAL_CASES, LOSS_CASES = {}, {}, {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def serial(fn):
    """A case that swaps process state (stdout, a module constant) and so
    runs alone, after the concurrent ones."""
    SERIAL_CASES[fn.__name__] = fn
    return fn


def after_loss(fn):
    LOSS_CASES[fn.__name__] = fn
    return fn


# -- rgw: tests/test_services.py ----------------------------------------------

@case
async def rgw_service_bucket_object_ops(r):
    svc = r.pkg.rgw.RgwService(await r.ns("ec"), chunk_size=64 * 1024)
    await svc.create_bucket("photos")
    out = {"buckets": await svc.list_buckets()}
    assert out["buckets"] == ["photos"]
    data = blob(200_000, 1)  # multi-chunk
    await svc.put_object("photos", "cat.jpg", data)
    out["get"] = await svc.get_object("photos", "cat.jpg")
    assert out["get"] == data
    out["listing"] = await svc.list_objects("photos")
    assert out["listing"]["cat.jpg"]["size"] == len(data)
    await svc.delete_object("photos", "cat.jpg")
    out["after_delete"] = await svc.list_objects("photos")
    assert out["after_delete"] == {}
    out["no_bucket"] = await raises(r.pkg.RadosError, svc.put_object(
        "nope", "k", b"v"), match="NoSuchBucket")
    return out


@case
async def rgw_http_frontend(r):
    svc = r.pkg.rgw.RgwService(await r.ns("ec"), chunk_size=64 * 1024)
    out = {}
    async with Gateway(r, svc) as gw:
        out["mkbucket"] = (await gw.raw("PUT", "/bkt"))[0]
        assert out["mkbucket"] == "200 OK"
        data = blob(150_000, 2)
        out["put"] = (await gw.raw("PUT", "/bkt/file.bin", data))[0]
        assert out["put"] == "200 OK"
        st, got, _ = await gw.raw("GET", "/bkt/file.bin")
        assert st == "200 OK" and got == data
        out["get"] = (st, got)
        st, listing, _ = await gw.raw("GET", "/bkt")
        out["listing"] = json.loads(listing)
        assert out["listing"]["file.bin"]["size"] == len(data)
        out["statuses"] = [(await gw.raw(m, p))[0] for m, p in (
            ("HEAD", "/bkt/file.bin"), ("GET", "/bkt/missing"),
            ("DELETE", "/bkt/file.bin"), ("HEAD", "/bkt/file.bin"))]
        assert out["statuses"] == ["200 OK", "404 Not Found",
                                   "204 No Content", "404 Not Found"]
        out["buckets"] = json.loads((await gw.raw("GET", "/"))[1])
        assert out["buckets"] == ["bkt"]
    return out


@case
async def rgw_multipart_upload_lifecycle(r):
    svc = r.pkg.rgw.RgwService(await r.ns("ec"), chunk_size=64 * 1024)
    await svc.create_bucket("mp")
    upload = await svc.initiate_multipart("mp", "big.bin")
    p1, p2, p3 = (blob(150_000, 3 + i) for i in range(3))
    await svc.upload_part("mp", upload, 2, p2)
    await svc.upload_part("mp", upload, 1, p1)
    await svc.upload_part("mp", upload, 3, p3)
    out = {"upload": upload,
           "etag": await svc.complete_multipart("mp", upload)}
    assert out["etag"].endswith("-3")
    # stitched in PART order regardless of upload order
    out["get"] = await svc.get_object("mp", "big.bin")
    assert out["get"] == p1 + p2 + p3
    out["size"] = (await svc.list_objects("mp"))["big.bin"]["size"]
    assert out["size"] == 450_000
    # delete cleans the manifest's part objects too
    await svc.delete_object("mp", "big.bin")
    out["deleted"] = await raises(Exception, svc.get_object("mp", "big.bin"))
    # abort path
    u2 = await svc.initiate_multipart("mp", "never.bin")
    await svc.upload_part("mp", u2, 1, b"x" * 1000)
    await svc.abort_multipart("mp", u2)
    out["aborted"] = await raises(Exception, svc.complete_multipart("mp", u2))
    return out


@case
async def rgw_sigv4_auth_on_http_frontend(r):
    """Unsigned and wrong-secret requests get 403; signed SigV4 requests
    flow end to end, multipart included."""
    creds = {"AKIDEXAMPLE": "secretsauce"}
    svc = r.pkg.rgw.RgwService(await r.ns("ec"), chunk_size=64 * 1024,
                               credentials=creds)
    out = {}
    async with Gateway(r, svc) as gw:
        async def req(method, target, body=b"", signed=True,
                      secret="secretsauce"):
            url = urlsplit(target)
            headers = {"host": gw.hosthdr, "x-amz-date": "20260730T120000Z"}
            if signed:
                headers = r.pkg.rgw.sign_request(
                    "AKIDEXAMPLE", secret, method, url.path, url.query,
                    headers, body)
            st, _, payload = await http(gw.host, gw.port, method, target,
                                        body, dict(headers, **{
                                            "Content-Length": len(body)}))
            return st, payload

        out["unsigned"] = (await req("PUT", "/b", signed=False))[0]
        out["wrong"] = (await req("PUT", "/b", secret="wrong"))[0]
        assert out["unsigned"] == out["wrong"] == "403 Forbidden"
        out["mkbucket"] = (await req("PUT", "/b"))[0]
        assert out["mkbucket"] == "200 OK"
        data = blob(99_000, 6)
        assert (await req("PUT", "/b/k", data))[0] == "200 OK"
        out["get"] = await req("GET", "/b/k")
        assert out["get"] == ("200 OK", data)
        st, resp = await req("POST", "/b/big?uploads")
        assert st == "200 OK"
        upload = json.loads(resp)["UploadId"]
        pa, pb = blob(70_000, 7), blob(30_000, 8)
        out["parts"] = [
            (await req("PUT", f"/b/big?uploadId={upload}&partNumber=1",
                       pa))[0],
            (await req("PUT", f"/b/big?uploadId={upload}&partNumber=2",
                       pb))[0],
            (await req("POST", f"/b/big?uploadId={upload}"))[0]]
        assert out["parts"] == ["200 OK"] * 3
        out["big"] = await req("GET", "/b/big")
        assert out["big"] == ("200 OK", pa + pb)
        out["upload"] = upload
    return out


@case
async def rgw_concurrent_index_puts_all_land(r):
    """cls_rgw on a replicated pool: concurrent puts and deletes through
    two gateways lose no index entry."""
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    svc2 = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    await svc.create_bucket("b")
    n = 16
    await asyncio.gather(*((svc if i % 2 else svc2).put_object(
        "b", f"k{i}", f"v{i}".encode() * 100) for i in range(n)))
    out = {"listing": sorted(await svc.list_objects("b"))}
    assert out["listing"] == sorted(f"k{i}" for i in range(n))
    await asyncio.gather(*((svc if i % 2 else svc2).delete_object(
        "b", f"k{i}") for i in range(n)))
    out["after"] = await svc.list_objects("b")
    assert out["after"] == {}
    return out


@case
async def rgw_plain_put_over_multipart_keeps_new_data(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    await svc.create_bucket("b")
    up = await svc.initiate_multipart("b", "k")
    p1 = blob(100_000, 9)
    await svc.upload_part("b", up, 1, p1)
    await svc.complete_multipart("b", up, [1])
    out = {"multipart": await svc.get_object("b", "k")}
    assert out["multipart"] == p1
    plain = blob(50_000, 10)
    await svc.put_object("b", "k", plain)
    out["plain"] = await svc.get_object("b", "k")
    assert out["plain"] == plain
    out["entry"] = (await svc.list_objects("b"))["k"]
    assert "parts" not in out["entry"]
    return out


@case
async def rgw_versioned_put_get_delete_marker(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    E = r.pkg.RadosError
    await svc.create_bucket("b")
    await svc.put_object("b", "k", b"v0")  # becomes the "null" version
    await svc.set_versioning("b", True)
    vid1 = await svc.put_object("b", "k", b"v1")
    vid2 = await svc.put_object("b", "k", b"v2")
    assert vid1 and vid2 and vid1 != vid2
    out = {"vids": [vid1, vid2], "head": await svc.get_object("b", "k"),
           "v1": await svc.get_object("b", "k", version_id=vid1),
           "null": await svc.get_object("b", "k", version_id="null")}
    assert (out["head"], out["v1"], out["null"]) == (b"v2", b"v1", b"v0")
    vers = (await svc.list_object_versions("b"))["k"]
    out["versions"] = [v["vid"] for v in vers]
    assert out["versions"] == ["null", vid1, vid2]
    await svc.delete_object("b", "k")  # a delete marker
    out["marked"] = await raises(E, svc.get_object("b", "k"),
                                 match="NoSuchKey")
    assert "k" not in await svc.list_objects("b")
    out["v2"] = await svc.get_object("b", "k", version_id=vid2)
    assert out["v2"] == b"v2"
    vers = (await svc.list_object_versions("b"))["k"]
    marker = [v for v in vers if v.get("delete_marker")][0]
    await svc.delete_object("b", "k", version_id=marker["vid"])
    out["undeleted"] = await svc.get_object("b", "k")
    assert out["undeleted"] == b"v2"
    await svc.delete_object("b", "k", version_id=vid1)
    out["purged"] = await raises(E, svc.get_object("b", "k", version_id=vid1),
                                 match="NoSuchVersion")
    out["final_versions"] = (await svc.list_object_versions("b"))["k"]
    return out


@case
async def rgw_lifecycle_expiration_sweep(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    await svc.create_bucket("b")
    t0 = 1_000_000.0
    await svc.put_object("b", "logs/old", b"x", now=t0)
    await svc.put_object("b", "logs/new", b"y", now=t0 + 5 * 86400)
    await svc.put_object("b", "keep/old", b"z", now=t0)
    await svc.put_lifecycle("b", [{"prefix": "logs/", "days": 7}])
    out = {"day8": await svc.lifecycle_tick(now=t0 + 8 * 86400),
           "listing8": sorted(await svc.list_objects("b"))}
    assert out["day8"] == 1
    assert out["listing8"] == ["keep/old", "logs/new"]
    out["day13"] = await svc.lifecycle_tick(now=t0 + 13 * 86400)
    out["listing13"] = sorted(await svc.list_objects("b"))
    assert out["day13"] == 1 and out["listing13"] == ["keep/old"]
    out["day14"] = await svc.lifecycle_tick(now=t0 + 14 * 86400)
    assert out["day14"] == 0
    await svc.set_versioning("b", True)
    vid = await svc.put_object("b", "logs/v", b"w", now=t0)
    out["versioned"] = await svc.lifecycle_tick(now=t0 + 8 * 86400)
    assert out["versioned"] == 1
    out["marked"] = await raises(r.pkg.RadosError, svc.get_object(
        "b", "logs/v"), match="NoSuchKey")
    out["kept"] = await svc.get_object("b", "logs/v", version_id=vid)
    assert out["kept"] == b"w"
    return out


@case
async def rgw_bucket_acls_enforced_at_frontend(r):
    creds = {"alice": "alice-secret", "bob": "bob-secret"}
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024,
                               credentials=creds)
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", access=None, query="",
                       want="200", got=None):
            st, payload, _ = await gw.req(method, path, body, access, query)
            assert st.startswith(want), (method, path, query, st, payload)
            assert got is None or payload == got
            out.append((method, path, access, query, st, payload))

        await step("PUT", "/priv", access="alice")
        await step("PUT", "/priv/k", b"secret", access="alice")
        private = json.dumps({"owner": "alice", "grants": []}).encode()
        await step("PUT", "/priv", private, access="alice", query="acl")
        await step("GET", "/priv/k", access="bob", want="403")
        await step("PUT", "/priv/k", b"x", access="bob", want="403")
        await step("GET", "/priv/k", access="alice", got=b"secret")
        public = json.dumps({"owner": "alice", "grants": [
            {"grantee": "*", "perm": "READ"}]}).encode()
        await step("PUT", "/priv", public, access="alice", query="acl")
        await step("GET", "/priv/k", access="bob", got=b"secret")
        await step("DELETE", "/priv/k", access="bob", want="403")
        # a plain read grantee may not read the grants or the policy
        await step("GET", "/priv", access="bob", query="acl", want="403")
        await step("GET", "/priv", access="bob", query="policy", want="403")
        await step("GET", "/priv", access="alice", query="acl")
    return out


@case
async def rgw_versioning_via_frontend_subresources(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    out = {}
    async with Gateway(r, svc) as gw:
        await gw.raw("PUT", "/b")
        out["enable"] = (await gw.raw("PUT", "/b?versioning", json.dumps(
            {"Status": "Enabled"}).encode()))[0]
        assert out["enable"].startswith("200")
        out["status"] = json.loads((await gw.raw("GET", "/b?versioning"))[1])
        assert out["status"]["Status"] == "Enabled"
        _, body, _ = await gw.raw("PUT", "/b/k", b"one")
        vid1 = json.loads(body)["VersionId"]
        out["put2"] = (await gw.raw("PUT", "/b/k", b"two"))[1]
        out["head"] = (await gw.raw("GET", "/b/k"))[1]
        out["v1"] = (await gw.raw("GET", f"/b/k?versionId={vid1}"))[1]
        assert (out["head"], out["v1"]) == (b"two", b"one")
        await gw.raw("DELETE", "/b/k")
        out["deleted"] = (await gw.raw("GET", "/b/k"))[0]
        assert out["deleted"].startswith("404")
        out["versions"] = json.loads((await gw.raw("GET", "/b?versions"))[1])
        assert any(v.get("delete_marker") for v in out["versions"]["k"])
    return out


@case
async def rgw_policy_eval_semantics(r):
    """Deny overrides, wildcard action and resource matching, PASS when
    nothing matches (no cluster)."""
    ev = r.pkg.rgw.RgwService.policy_eval
    pol = {"Statement": [
        {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
         "Resource": "arn:aws:s3:::b/*"},
        {"Effect": "Deny", "Principal": {"AWS": ["mallory"]},
         "Action": "s3:*", "Resource": "arn:aws:s3:::b/*"}]}
    pol2 = {"Statement": [{"Effect": "Allow", "Principal": "*",
                           "Action": "s3:Get*",
                           "Resource": "arn:aws:s3:::b*"}]}
    out = [ev(pol, "bob", "s3:GetObject", "arn:aws:s3:::b/k"),
           ev(pol, "mallory", "s3:GetObject", "arn:aws:s3:::b/k"),
           ev(pol, "bob", "s3:PutObject", "arn:aws:s3:::b/k"),
           ev(pol, "bob", "s3:GetObject", "arn:aws:s3:::other/k"),
           ev(None, "bob", "s3:GetObject", "x"),
           ev(pol2, None, "s3:GetObject", "arn:aws:s3:::b/k"),
           ev(pol2, None, "s3:PutObject", "arn:aws:s3:::b/k")]
    assert out == ["Allow", "Deny", None, None, None, "Allow", None]
    return out


@case
async def rgw_policy_grants_and_denies_at_frontend(r):
    creds = {"alice": "a-secret", "bob": "b-secret", "mallory": "m-secret"}
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024,
                               credentials=creds)
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", access=None, query="",
                       want="200"):
            st, payload, _ = await gw.req(method, path, body, access, query)
            assert st.startswith(want), (method, path, query, st, payload)
            out.append((method, path, access, query, st, payload))
            return payload

        await step("PUT", "/data", access="alice")
        await step("PUT", "/data/k", b"bytes", access="alice")
        await step("PUT", "/data", json.dumps(
            {"owner": "alice", "grants": []}).encode(), access="alice",
            query="acl")
        await step("GET", "/data/k", access="bob", want="403")
        pol = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
             "Resource": "arn:aws:s3:::data/*"},
            {"Effect": "Deny", "Principal": {"AWS": ["mallory"]},
             "Action": "s3:*", "Resource": "arn:aws:s3:::data/*"}]}
        await step("PUT", "/data", json.dumps(pol).encode(), access="alice",
                   query="policy")
        assert await step("GET", "/data/k", access="bob") == b"bytes"
        await step("PUT", "/data/k", b"x", access="bob", want="403")
        await step("GET", "/data/k", access="mallory", want="403")
        await step("PUT", "/data", b"{}", access="bob", query="policy",
                   want="403")
        got = await step("GET", "/data", access="alice", query="policy")
        assert json.loads(got)["Version"] == "2012-10-17"
        await step("DELETE", "/data", access="alice", query="policy",
                   want="204")
        await step("GET", "/data/k", access="bob", want="403")
    return out


# -- mds: tests/test_services.py ----------------------------------------------

@case
async def mds_namespace_tree(r):
    fs = r.pkg.mds.FileSystem(await r.ns("ec"))
    FsError = r.pkg.mds.FsError
    await fs.mkfs()
    await fs.mkdir("/home")
    await fs.mkdir("/home/user")
    await fs.write_file("/home/user/notes.txt", b"hello fs")
    await fs.write_file("/home/user/big.bin", blob(120_000, 11))
    out = {"ls": await fs.listdir("/home/user"),
           "notes": await fs.read_file("/home/user/notes.txt"),
           "stat": await fs.stat("/home/user/big.bin"),
           "tree": await fs.walk("/")}
    assert out["ls"] == ["big.bin", "notes.txt"]
    assert out["notes"] == b"hello fs"
    assert out["stat"]["type"] == "file" and out["stat"]["size"] == 120_000
    assert out["tree"] == {"home": {"user": {"big.bin": 120_000,
                                             "notes.txt": 8}}}
    out["errors"] = [
        await raises(FsError, fs.mkdir("/home"), match="EEXIST"),
        await raises(FsError, fs.read_file("/home/user/none"),
                     match="ENOENT"),
        await raises(FsError, fs.unlink("/home/user"), match="ENOTEMPTY")]
    await fs.rename("/home/user/notes.txt", "/home/moved.txt")
    out["moved"] = await fs.read_file("/home/moved.txt")
    assert out["moved"] == b"hello fs"
    assert "notes.txt" not in await fs.listdir("/home/user")
    await fs.unlink("/home/user/big.bin")
    await fs.unlink("/home/user")
    out["home"] = await fs.listdir("/home")
    assert out["home"] == ["moved.txt"]
    return out


@case
async def mds_data_survives_osd_kill(r):
    """Written here; read degraded by fs_reads_degraded after the loss."""
    fs = r.pkg.mds.FileSystem(await r.ns("ec"))
    await fs.mkfs()
    await fs.write_file("/f.bin", blob(80_000, 12))
    return await fs.read_file("/f.bin")


@case
async def mds_journal_crash_replay(r):
    """Events journaled but not applied are completed by the next mount()
    (up:replay)."""
    io = await r.ns("ec")
    fs = r.pkg.mds.FileSystem(io)
    await fs.mkfs()
    await fs.mount()
    await fs.mkdir("/a")
    await fs.mkdir("/a/b")
    await fs.write_file("/a/keep.txt", b"kept")
    real_apply = fs._apply_event

    async def no_apply(ev):
        return None

    fs._apply_event = no_apply  # crash 1: journaled, never applied
    await fs.write_file("/a/b/new.txt", b"journaled!")
    fs._apply_event = real_apply

    async def half_apply(ev):  # crash 2: a rename applied halfway
        if ev.get("op") == "rename":
            return await real_apply(ev["events"][0])
        return await real_apply(ev)

    fs._apply_event = half_apply
    await fs.rename("/a/keep.txt", "/a/b/moved.txt")
    fs._apply_event = real_apply
    out = {"torn_a": await fs.listdir("/a"),
           "torn_b": await fs.listdir("/a/b")}
    assert "keep.txt" in out["torn_a"] and "new.txt" not in out["torn_b"]
    fs2 = r.pkg.mds.FileSystem(io)
    out["replayed"] = await fs2.mount()
    assert out["replayed"] >= 2
    out["a"] = await fs2.listdir("/a")
    out["b"] = sorted(await fs2.listdir("/a/b"))
    out["new"] = await fs2.read_file("/a/b/new.txt")
    out["moved"] = await fs2.read_file("/a/b/moved.txt")
    assert out["a"] == ["b"] and out["b"] == ["moved.txt", "new.txt"]
    assert (out["new"], out["moved"]) == (b"journaled!", b"kept")
    fs3 = r.pkg.mds.FileSystem(io)
    await fs3.mount()  # replay is idempotent
    out["again"] = sorted(await fs3.listdir("/a/b"))
    assert out["again"] == ["moved.txt", "new.txt"]
    return out


@case
async def mds_journal_torn_tail(r):
    """A torn trailing record ends replay cleanly."""
    io = await r.ns("ec")
    fs = r.pkg.mds.FileSystem(io)
    await fs.mkfs()
    await fs.mount()
    await fs.mkdir("/x")
    seg_oid = fs.mdlog._seg_oid(fs.mdlog.seg)
    import struct
    await io.write(seg_oid, struct.pack("<I", 9999) + b"{tr",
                   offset=fs.mdlog.off)
    fs2 = r.pkg.mds.FileSystem(io)
    await fs2.mount()  # must not raise
    out = await fs2.listdir("/")
    assert out == ["x"]
    return out


@serial
async def mds_journal_segments_expire(r):
    """Applied segments are trimmed, and a mount after the trim still
    yields the whole namespace (SEGMENT_EVENTS is the module's, so this
    case runs alone)."""
    io = await r.ns("ec")
    mdsmod = r.pkg.mds
    orig = mdsmod.SEGMENT_EVENTS
    mdsmod.SEGMENT_EVENTS = 12
    try:
        n = 40
        fs = mdsmod.FileSystem(io)
        await fs.mkfs()
        await fs.mount()
        for i in range(n):
            await fs.write_file(f"/f{i}", b"x")
        await fs.mdlog.expire()
        segs = sorted(o for o in await io.list_objects()
                      if o.startswith("mds_journal."))
        assert len(segs) <= 2, f"journal never trimmed: {segs}"
        fs2 = mdsmod.FileSystem(io)
        await fs2.mount()
        names = await fs2.listdir("/")
        assert len(names) == n
    finally:
        mdsmod.SEGMENT_EVENTS = orig
    return {"segments": segs, "names": names}


# -- tests/test_service_tier.py -----------------------------------------------

@case
async def mds_caps_shared_reads_exclusive_writes(r):
    m = r.pkg.mds
    fs = m.FileSystem(await r.ns("ec"))
    await fs.mkfs()
    mds = m.MDSServer(fs, session_timeout=60.0)
    alice, bob = mds.open_session("alice"), mds.open_session("bob")
    await mds.mkdir(alice, "/proj")
    await mds.write_file(alice, "/proj/a.txt", b"hello")
    mds.release_cap(alice, "/proj/a.txt")
    out = {"reads": [await mds.read_file(alice, "/proj/a.txt"),
                     await mds.read_file(bob, "/proj/a.txt")]}
    assert out["reads"] == [b"hello", b"hello"]
    out["conflict"] = await raises(m.CapConflict, mds.write_file(
        bob, "/proj/a.txt", b"bob"))
    out["revoked"] = "/proj/a.txt" in alice.renew()
    assert out["revoked"]
    mds.release_cap(alice, "/proj/a.txt")
    await mds.write_file(bob, "/proj/a.txt", b"bob was here")
    mds.release_cap(bob, "/proj/a.txt")
    out["after"] = await mds.read_file(alice, "/proj/a.txt")
    assert out["after"] == b"bob was here"
    return out


@serial
async def mds_expired_session_is_evicted(r):
    """A lease of 0.2 s lapses while its holder is idle (alone, so the
    holder's own first write is not what outlasts the lease)."""
    m = r.pkg.mds
    fs = m.FileSystem(await r.ns("ec"))
    await fs.mkfs()
    mds = m.MDSServer(fs, session_timeout=0.2)
    ghost = mds.open_session("ghost")
    await mds.write_file(ghost, "/f", b"v1")
    await asyncio.sleep(0.3)  # the lease lapses, never renewed
    live = mds.open_session("live")
    live.renew()
    await mds.write_file(live, "/f", b"v2")  # the dead holder is evicted
    out = {"read": await mds.read_file(live, "/f"),
           "ghost": await raises(m.FsError, mds.read_file(ghost, "/f"))}
    assert out["read"] == b"v2"
    return out


@case
async def swift_auth_and_object_cycle(r):
    svc = r.pkg.rgw.RgwService(await r.ns("ec"),
                               credentials={"acct": "secretkey"})
    out = []
    async with Gateway(r, svc) as gw:
        async def step(method, path, body=b"", headers=None, want="2"):
            st, payload, h = await gw.raw(method, path, body, headers)
            assert st.startswith(want), (method, path, st, payload)
            out.append((method, path, st, payload))
            return h, payload

        await step("GET", "/v1/AUTH_acct", want="401")
        h, _ = await step("GET", "/auth/v1.0", headers={
            "X-Auth-User": "acct", "X-Auth-Key": "secretkey"}, want="200")
        auth = {"X-Auth-Token": h["x-auth-token"]}
        out.append(h["x-auth-token"])
        await step("PUT", "/v1/AUTH_acct/photos", headers=auth, want="201")
        data = blob(10_000, 13)
        await step("PUT", "/v1/AUTH_acct/photos/cat.jpg", data, auth, "201")
        h, listing = await step("GET", "/v1/AUTH_acct/photos", headers=auth,
                                want="200")
        assert listing.decode() == "cat.jpg"
        assert h["x-container-object-count"] == "1"
        _, got = await step("GET", "/v1/AUTH_acct/photos/cat.jpg",
                            headers=auth, want="200")
        assert got == data
        await step("DELETE", "/v1/AUTH_acct/photos", headers=auth,
                   want="409")
        await step("DELETE", "/v1/AUTH_acct/photos/cat.jpg", headers=auth,
                   want="204")
        await step("DELETE", "/v1/AUTH_acct/photos", headers=auth,
                   want="204")
    return out


@case
async def rgw_zone_sync_full_then_incremental(r):
    a = r.pkg.rgw.RgwService(await r.ns("ec", ".zone-a"))
    b = r.pkg.rgw.RgwService(await r.ns("ec", ".zone-b"))
    await a.create_bucket("docs")
    blob1 = blob(30_000, 14)
    await a.put_object("docs", "one", blob1)
    agent = r.pkg.rgw.ZoneSyncAgent(a, b, zone_id="b")
    out = {"full": await agent.sync(),
           "one": await b.get_object("docs", "one")}
    assert out["one"] == blob1
    blob2 = blob(10_000, 15)
    await a.put_object("docs", "two", blob2)
    await a.delete_object("docs", "one")
    await a.create_bucket("media")
    out["applied"] = await agent.sync()
    assert out["applied"] == 3
    out["two"] = await b.get_object("docs", "two")
    out["docs"] = await b.list_objects("docs")
    out["buckets"] = await b.list_buckets()
    assert out["two"] == blob2 and "one" not in out["docs"]
    assert "media" in out["buckets"]
    out["tail"] = await agent.sync()
    assert out["tail"] == 0
    return out


@case
async def rgw_concurrent_local_mutation_during_sync_still_logs(r):
    """A local write on the destination while the sync agent is parked
    inside an apply still appends to the destination's datalog."""
    rgw = r.pkg.rgw
    a = rgw.RgwService(await r.ns("ec", ".zz-a"))
    b = rgw.RgwService(await r.ns("ec", ".zz-b"))
    await a.create_bucket("docs")
    await a.put_object("docs", "one", blob(5_000, 16))
    agent = rgw.ZoneSyncAgent(a, b, zone_id="b")
    await agent.sync()  # full sync; position established
    gate = asyncio.Event()
    real_put = b.put_object
    scoped = []

    async def gated_put(bucket, key, data, **kw):
        scoped.append(rgw._DATALOG_SUPPRESS.get())
        await gate.wait()
        return await real_put(bucket, key, data, **kw)

    await a.put_object("docs", "two", blob(2_000, 17))
    b.put_object = gated_put
    sync_task = asyncio.create_task(agent.sync())
    for _ in range(500):  # until the agent is parked inside apply
        if scoped:
            break
        await asyncio.sleep(0.01)
    b.put_object = real_put
    await b.put_object("docs", "local-write", b"payload")
    gate.set()
    await sync_task
    assert scoped == [True]  # the agent task is scoped
    dlog = await b.datalog_state()
    ops = [(e["op"], e.get("key")) for e in dlog["log"]]
    assert ("put", "local-write") in ops
    assert ("put", "two") not in ops
    return {"ops": ops, "two": await b.get_object("docs", "two")}


@serial
async def cephfs_write_behind_and_flush_on_revoke(r):
    m = r.pkg.mds
    fs = m.FileSystem(await r.ns("ec"))
    await fs.mkfs()
    mds = m.MDSServer(fs)
    a = m.CephFSClient(mds, "a", renew_interval=0.01)
    b = m.CephFSClient(mds, "b", renew_interval=0.01)
    await a.mkdir("/d")
    await a.write("/d/f", b"version-1")  # write-behind under the x cap
    out = {"own": await a.read("/d/f"), "flushes0": a.flushes,
           "unflushed": await raises(m.FsError, fs.read_file("/d/f"))}
    assert out["own"] == b"version-1" and out["flushes0"] == 0

    async def a_ticks():
        for _ in range(50):
            await a.renew()
            await asyncio.sleep(0.01)

    tick = asyncio.create_task(a_ticks())
    out["b_read"] = await b.read("/d/f")
    tick.cancel()
    out["flushes1"] = a.flushes
    assert out["b_read"] == b"version-1" and out["flushes1"] == 1
    await a.renew()

    async def b_write():
        await b.write("/d/f", b"version-2")
        for _ in range(50):
            await b.renew()
            await asyncio.sleep(0.01)

    wtask = asyncio.create_task(b_write())
    await asyncio.sleep(0.05)
    got = None
    for _ in range(50):
        await a.renew()
        got = None
        try:
            got = await a.read("/d/f")
        except Exception:
            await asyncio.sleep(0.01)
            continue
        if got == b"version-2":
            break
        a._clean.pop("/d/f", None)  # not yet: drop and retry
        await asyncio.sleep(0.01)
    wtask.cancel()
    out["a_read"] = got
    assert got == b"version-2", got
    await b.write("/d/g", b"tail")
    await b.unmount()  # the unmount barrier flushes
    out["tail"] = await fs.read_file("/d/g")
    assert out["tail"] == b"tail"
    return out


@case
async def cephfs_read_cache_under_shared_cap(r):
    m = r.pkg.mds
    fs = m.FileSystem(await r.ns("ec"))
    await fs.mkfs()
    mds = m.MDSServer(fs)
    await fs.mkdir("/d")
    await fs.write_file("/d/f", b"shared")
    a = m.CephFSClient(mds, "a", renew_interval=3600)
    b = m.CephFSClient(mds, "b", renew_interval=3600)
    out = {"first": [await a.read("/d/f"), await b.read("/d/f")]}
    assert out["first"] == [b"shared"] * 2
    h0a, h0b = a.cache_hits, b.cache_hits
    for _ in range(5):
        assert await a.read("/d/f") == b"shared"
        assert await b.read("/d/f") == b"shared"
    out["hits"] = [a.cache_hits - h0a, b.cache_hits - h0b]
    assert out["hits"] == [5, 5]
    await a.unmount()
    await b.unmount()
    return out


# -- tests/test_rgw_admin.py --------------------------------------------------

async def admin_gateway(r, uid, display=None, pool="rep", chunk=64 * 1024):
    """(service, RgwAdmin, user, its access key, {access: secret}) on a
    replicated pool in this case's namespace."""
    svc = r.pkg.rgw.RgwService(await r.ns(pool), chunk_size=chunk)
    admin = r.pkg.rgw.RgwAdmin(svc)
    u = await (admin.user_create(uid, display) if display
               else admin.user_create(uid))
    return svc, admin, u, u["access_key"], {u["access_key"]: u["secret_key"]}


@case
async def rgw_user_create_persist_suspend_rm(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=64 * 1024)
    admin = r.pkg.rgw.RgwAdmin(svc)
    u = await admin.user_create("alice", "Alice A")
    assert u["access_key"] and u["secret_key"]
    out = {"user": u}
    out["again"] = await raises(r.pkg.RadosError, admin.user_create("alice"))
    assert out["again"][1] == -errno.EEXIST
    out["list"] = await admin.user_list()
    assert out["list"] == ["alice"]
    svc2 = r.pkg.rgw.RgwService(svc.ioctx)  # a fresh service, same pool
    await svc2.load_users()
    assert svc2.credentials[u["access_key"]] == u["secret_key"]
    await admin.user_suspend("alice")
    out["suspended"] = await admin.user_info("alice")
    assert out["suspended"]["suspended"]
    await admin.user_enable("alice")
    out["enabled"] = await admin.user_info("alice")
    assert not out["enabled"]["suspended"]
    await admin.user_rm("alice")
    out["after_rm"] = await admin.user_list()
    assert out["after_rm"] == []
    out["info"] = await raises(r.pkg.RadosError, admin.user_info("alice"))
    return out


@case
async def rgw_suspended_user_and_quota_enforcement(r):
    svc, admin, u, ak, creds = await admin_gateway(r, "bob", "Bob")
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", want="200", says=None):
            st, payload, _ = await gw.req(method, path, body, ak)
            assert st.startswith(want), (method, path, st, payload)
            assert says is None or says in payload
            out.append((method, path, st, payload))

        await step("PUT", "/box")
        out.append((await svc.get_bucket_meta("box"))["owner"] == ak)
        await admin.quota_set("bob", "user", max_objects=2)
        await admin.quota_enable("bob", "user")
        for i in range(2):
            await step("PUT", f"/box/o{i}", b"x" * 100)
        await step("PUT", "/box/o2", b"x", "403", b"QuotaExceeded")
        await admin.quota_set("bob", "user", max_objects=-1, max_size=250)
        await step("PUT", "/box/o3", b"y" * 100, "403", b"QuotaExceeded")
        await step("PUT", "/box/o3", b"y" * 10)
        await admin.quota_disable("bob", "user")
        await step("PUT", "/box/o4", b"z" * 500)
        await admin.user_suspend("bob")
        await step("GET", "/box", want="403", says=b"UserSuspended")
        await admin.user_enable("bob")
        await step("GET", "/box")
    assert out[1] is True
    return out


@case
async def rgw_bucket_quota_and_multipart(r):
    svc, admin, u, ak, creds = await admin_gateway(r, "carol")
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", query="", want="200",
                       says=None):
            st, payload, _ = await gw.req(method, path, body, ak, query)
            assert st.startswith(want), (method, path, query, st, payload)
            assert says is None or says in payload
            out.append((method, path, query, st, payload))
            return payload

        await step("PUT", "/mp")
        await admin.quota_set("carol", "bucket", max_size=150)
        await admin.quota_enable("carol", "bucket")
        up = json.loads(await step("POST", "/mp/big", query="uploads"))[
            "UploadId"]
        await step("PUT", "/mp/big", b"p" * 100,
                   f"uploadId={up}&partNumber=1")
        await step("PUT", "/mp/big", b"p" * 100,
                   f"uploadId={up}&partNumber=2", "403", b"QuotaExceeded")
        await step("POST", "/mp/big", query=f"uploadId={up}")
        await step("PUT", "/mp/ok", b"s" * 40)
        up3 = json.loads(await step("POST", "/mp/sub", query="uploads"))[
            "UploadId"]
        for part in (1, 2):
            await step("PUT", "/mp/sub", b"s" * 5,
                       f"uploadId={up3}&partNumber={part}")
        part2_oid = svc._part_oid("mp", up3, 2)
        await step("POST", "/mp/sub", json.dumps({"Parts": [1]}).encode(),
                   f"uploadId={up3}")
        out.append(await raises(r.pkg.RadosError,
                                svc.striper.read(part2_oid)))
        up2 = json.loads(await step("POST", "/mp/tmp", query="uploads"))[
            "UploadId"]
        await step("PUT", "/mp/tmp", b"q" * 5, f"uploadId={up2}&partNumber=1")
        await step("DELETE", "/mp/tmp", query=f"uploadId={up2}", want="204")
        s, _o = await svc.bucket_usage("mp")
        assert s == 145  # 100 (mp/big) + 40 (mp/ok) + 5 (mp/sub part 1)
        out.append(s)
    return out


@case
async def rgw_multipart_completion_checks_object_count_quota(r):
    svc, admin, u, ak, creds = await admin_gateway(r, "dave")
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", query="", want="200",
                       says=None):
            st, payload, _ = await gw.req(method, path, body, ak, query)
            assert st.startswith(want), (method, path, query, st, payload)
            assert says is None or says in payload
            out.append((method, path, query, st, payload))
            return payload

        await step("PUT", "/cap")
        await admin.quota_set("dave", "user", max_objects=1)
        await admin.quota_enable("dave", "user")
        await step("PUT", "/cap/one", b"x")
        await step("PUT", "/cap/two", b"x", want="403", says=b"QuotaExceeded")
        up = json.loads(await step("POST", "/cap/two", query="uploads"))[
            "UploadId"]
        await step("PUT", "/cap/two", b"p" * 10, f"uploadId={up}&partNumber=1")
        await step("POST", "/cap/two", query=f"uploadId={up}", want="403",
                   says=b"QuotaExceeded")
        keys = await svc.list_objects("cap")
        assert "two" not in keys
        out.append(sorted(keys))
        up_ow = json.loads(await step("POST", "/cap/one", query="uploads"))[
            "UploadId"]
        await step("PUT", "/cap/one", b"n" * 4,
                   f"uploadId={up_ow}&partNumber=1")
        await step("POST", "/cap/one", query=f"uploadId={up_ow}")
    return out


@case
async def rgw_suspension_and_quota_bind_swift_too(r):
    svc, admin, u, ak, creds = await admin_gateway(r, "eve")
    out = []
    async with Gateway(r, svc) as gw:
        async def swift(method, path, body=b"", token=None, auth=None,
                        want="2", says=None):
            headers = {"host": gw.hosthdr}
            if token:
                headers["x-auth-token"] = token
            if auth:
                headers.update({"x-auth-user": auth[0],
                                "x-auth-key": auth[1]})
            st, payload, h = await gw.raw(method, path, body, headers)
            assert st.startswith(want), (method, path, st, payload)
            assert says is None or says in payload
            out.append((method, path, st, payload))
            return h

        token = (await swift("GET", "/auth/v1.0", auth=(ak, u["secret_key"]),
                             want="200"))["x-auth-token"]
        await swift("PUT", f"/v1/AUTH_{ak}/sc", token=token, want="201")
        await admin.quota_set("eve", "user", max_size=100)
        await admin.quota_enable("eve", "user")
        out.append((await svc.get_bucket_meta("sc"))["owner"] == ak)
        await swift("PUT", f"/v1/AUTH_{ak}/sc/a", b"x" * 80, token, want="201")
        await swift("PUT", f"/v1/AUTH_{ak}/sc/b", b"x" * 80, token,
                    want="403", says=b"QuotaExceeded")
        await admin.user_suspend("eve")
        await swift("GET", f"/v1/AUTH_{ak}/sc", token=token, want="403",
                    says=b"UserSuspended")
        await swift("GET", "/auth/v1.0", auth=(ak, u["secret_key"]),
                    want="403")
    assert out[2] is True
    return out


@contextlib.contextmanager
def captured_stdout():
    """sys.stdout (its text and its byte buffer) into a string."""
    buf = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    text = types.SimpleNamespace(value="")
    old, sys.stdout = sys.stdout, buf
    try:
        yield text
    finally:
        sys.stdout = old
        buf.flush()
        text.value = buf.buffer.getvalue().decode()


@serial
async def rgw_usage_accounting_and_cli(r):
    """Usage through RgwAdmin, then the radosgw-admin CLI against the live
    cluster (its own pool: the CLI opens the default namespace)."""
    svc = r.pkg.rgw.RgwService(await r.rados.open_ioctx("rgwadm"),
                               chunk_size=64 * 1024)
    admin = r.pkg.rgw.RgwAdmin(svc)
    u = await admin.user_create("dave")
    ak = u["access_key"]
    async with Gateway(r, svc, {ak: u["secret_key"]}) as gw:
        await gw.req("PUT", "/u1", access=ak)
        await gw.req("PUT", "/u1/a", b"x" * 300, access=ak)
        await gw.req("PUT", "/u1/b", b"y" * 200, access=ak)
    out = {"usage": await admin.usage("dave")}
    assert out["usage"] == {"size": 500, "objects": 2, "buckets": 1}
    cli = r.pkg.rgw_admin_cli
    for key, argv in (("cli_usage", ["usage", "--uid", "dave"]),
                      ("cli_users", ["user", "list"])):
        with captured_stdout() as text:
            rc = await cli.run(cli.parse_args(
                ["--mon", r.mon, "--pool", "rgwadm", *argv]))
        out[key] = (rc, json.loads(text.value))
    assert out["cli_usage"][0] == 0 and out["cli_usage"][1]["size"] == 500
    assert out["cli_users"] == (0, ["dave"])
    return out


@case
async def rgw_presigned_get_put_expiry_and_tamper(r):
    presign = r.pkg.rgw.presign_url
    svc, admin, u, ak, creds = await admin_gateway(r, "frank")
    sk = u["secret_key"]
    out = []
    async with Gateway(r, svc, creds) as gw:
        host = gw.hosthdr

        async def raw(method, target, body=b"", want="200"):
            st, payload, _ = await gw.raw(method, target, body,
                                          {"host": host})
            assert st.startswith(want), (method, st, payload)
            out.append((method, st, payload))
            return payload

        await gw.req("PUT", "/pb", access=ak)
        await gw.req("PUT", "/pb/doc", b"shared-bytes", access=ak)
        await gw.req("PUT", "/pb", json.dumps(
            {"owner": ak, "grants": []}).encode(), access=ak, query="acl")
        st, _, _ = await gw.req("GET", "/pb/doc")
        assert st.startswith("403")
        url = presign(ak, sk, "GET", "/pb/doc", host)
        assert await raw("GET", url) == b"shared-bytes"
        await raw("PUT", url, b"overwrite", want="403")  # method binding
        await raw("PUT", presign(ak, sk, "PUT", "/pb/upload", host),
                  b"pushed")
        st, body, _ = await gw.req("GET", "/pb/upload", access=ak)
        assert body == b"pushed"
        out.append(body)
        await raw("GET", url[:-4] + "beef", want="403")  # tampered
        old = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(CLOCK - 7200))
        await raw("GET", presign(ak, sk, "GET", "/pb/doc", host, expires=60,
                                 amzdate=old), want="403")  # expired
        await admin.user_suspend("frank")
        body = await raw("GET", presign(ak, sk, "GET", "/pb/doc", host),
                         want="403")
        assert b"UserSuspended" in body
    return out


@case
async def rgw_presigned_url_with_awkward_key(r):
    svc, admin, u, ak, creds = await admin_gateway(r, "gina")
    async with Gateway(r, svc, creds) as gw:
        await gw.req("PUT", "/aw", access=ak)
        raw_key = unquote("sale 100%25 off.txt")
        await svc.put_object("aw", raw_key, b"discount")
        url = r.pkg.rgw.presign_url(ak, u["secret_key"], "GET",
                                    f"/aw/{raw_key}", gw.hosthdr)
        st, payload, _ = await gw.raw("GET", url, headers={
            "host": gw.hosthdr})
    assert st.startswith("200"), st
    assert payload == b"discount"
    return st, payload, quote(raw_key)


# -- tests/test_rgw_range_copy.py: 4 KiB stripes, so ranges cross pieces ------

@case
async def rgw_range_forms_and_content_range(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    data = blob(4096 * 3 + 2048, 18)
    total = len(data)
    out = []
    async with Gateway(r, svc, creds) as gw:
        await gw.req("PUT", "/b", access=ak)
        st, _, _ = await gw.req("PUT", "/b/o", data, access=ak)
        assert st.startswith("200")
        for spec, want, want_body, want_cr in (
                ("bytes=10-99", "206", data[10:100], f"bytes 10-99/{total}"),
                ("bytes=4000-8500", "206", data[4000:8501], None),
                ("bytes=8192-", "206", data[8192:],
                 f"bytes 8192-{total - 1}/{total}"),
                ("bytes=-100", "206", data[-100:], None),
                (f"bytes=100-{total + 999}", "206", data[100:], None),
                (f"bytes={total}-", "416", None, f"bytes */{total}"),
                ("bytes=oops", "200", data, None),
                ("bytes=500-3", "200", data, None)):
            st, body, h = await gw.req("GET", "/b/o", access=ak,
                                       headers={"range": spec})
            assert st.startswith(want), (spec, st)
            assert want_body is None or body == want_body, spec
            assert want_cr is None or h["content-range"] == want_cr, spec
            out.append((spec, st, body, h.get("content-range")))
    return out


@case
async def rgw_range_on_multipart_manifest(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    p1, p2, p3 = b"A" * 5000, b"B" * 7000, b"C" * 3000
    whole = p1 + p2 + p3
    out = []
    async with Gateway(r, svc, creds) as gw:
        await gw.req("PUT", "/m", access=ak)
        _, body, _ = await gw.req("POST", "/m/big", access=ak, query="uploads")
        up = json.loads(body)["UploadId"]
        for i, part in enumerate((p1, p2, p3), start=1):
            st, _, _ = await gw.req("PUT", "/m/big", part, access=ak,
                                    query=f"uploadId={up}&partNumber={i}")
            assert st.startswith("200")
        st, _, _ = await gw.req("POST", "/m/big", access=ak,
                                query=f"uploadId={up}")
        assert st.startswith("200")
        st, body, h = await gw.req("GET", "/m/big", access=ak,
                                   headers={"range": "bytes=4500-6000"})
        assert st.startswith("206") and body == whole[4500:6001]
        assert h["content-range"] == f"bytes 4500-6000/{len(whole)}"
        out.append((st, body, h["content-range"]))
        st, body, _ = await gw.req("GET", "/m/big", access=ak,
                                   headers={"range": "bytes=12500-12599"})
        assert body == whole[12500:12600]
        out.append((st, body))
    return out


@case
async def rgw_copy_same_and_cross_bucket(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    data = blob(9000, 19)
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", query="", headers=None,
                       want="200"):
            st, payload, _ = await gw.req(method, path, body, ak, query,
                                          headers)
            assert st.startswith(want), (method, path, st, payload)
            out.append((method, path, query, st, payload))
            return payload

        await step("PUT", "/src")
        await step("PUT", "/dst")
        await step("PUT", "/src/orig", data)
        await step("PUT", "/src/orig", json.dumps(
            {"TagSet": {"team": "infra"}}).encode(), "tagging")
        got = await step("PUT", "/dst/copy",
                         headers={"x-amz-copy-source": "/src/orig"})
        assert "ETag" in json.loads(got)
        assert await step("GET", "/dst/copy") == data
        tags = await step("GET", "/dst/copy", query="tagging")
        assert json.loads(tags)["TagSet"] == {"team": "infra"}
        assert await step("GET", "/src/orig") == data
        await step("PUT", "/dst/ghost", headers={
            "x-amz-copy-source": "/src/ghost"}, want="404")
    return out


@case
async def rgw_upload_part_copy(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    src = blob(10000, 20)
    out = []
    async with Gateway(r, svc, creds) as gw:
        await gw.req("PUT", "/pc", access=ak)
        await gw.req("PUT", "/pc/src", src, access=ak)
        _, body, _ = await gw.req("POST", "/pc/assembled", access=ak,
                                  query="uploads")
        up = json.loads(body)["UploadId"]
        for part, extra, want in (
                (1, {}, "200"),
                (2, {"x-amz-copy-source-range": "bytes=1000-1999"}, "200"),
                (3, {"x-amz-copy-source-range": "bytes=999999-"}, "416")):
            st, payload, _ = await gw.req(
                "PUT", "/pc/assembled", access=ak,
                query=f"uploadId={up}&partNumber={part}",
                headers={"x-amz-copy-source": "/pc/src", **extra})
            assert st.startswith(want), (part, st)
            out.append((part, st, payload))
        st, _, _ = await gw.req("POST", "/pc/assembled", access=ak,
                                query=f"uploadId={up}")
        assert st.startswith("200")
        st, body, _ = await gw.req("GET", "/pc/assembled", access=ak)
        assert body == src + src[1000:2000]
        out.append((st, body))
    return out


@case
async def rgw_self_copy_preserves_tags(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=4096)
    await svc.create_bucket("s")
    await svc.put_object("s", "k", b"payload")
    await svc.put_object_tagging("s", "k", {"keep": "me"})
    await svc.copy_object("s", "k", "s", "k")
    out = (await svc.get_object("s", "k"),
           await svc.get_object_tagging("s", "k"))
    assert out == (b"payload", {"keep": "me"})
    return out


@case
async def rgw_copy_requires_read_on_source(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    u2 = await admin.user_create("eve2")
    ak2 = u2["access_key"]
    creds[ak2] = u2["secret_key"]
    async with Gateway(r, svc, creds) as gw:
        await gw.req("PUT", "/priv2", access=ak)
        await gw.req("PUT", "/priv2/sec", b"secret", access=ak)
        st1, _, _ = await gw.req("PUT", "/priv2", json.dumps(
            {"owner": ak, "grants": []}).encode(), access=ak, query="acl")
        assert st1.startswith("200")
        await gw.req("PUT", "/evebkt", access=ak2)
        st2, body, _ = await gw.req("PUT", "/evebkt/stolen", access=ak2,
                                    headers={"x-amz-copy-source":
                                             "/priv2/sec"})
        assert st2.startswith("403"), st2
    return st1, st2, body


@case
async def rgw_tagging_lifecycle(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    tags = {"env": "prod", "owner": "ray"}
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", query="", want="200"):
            st, payload, _ = await gw.req(method, path, body, ak, query)
            assert st.startswith(want), (method, path, query, st, payload)
            out.append((method, path, query, st, payload))
            return payload

        await step("PUT", "/t")
        await step("PUT", "/t/obj", b"d")
        assert json.loads(await step("GET", "/t/obj", query="tagging"))[
            "TagSet"] == {}
        await step("PUT", "/t/obj", json.dumps({"TagSet": tags}).encode(),
                   "tagging")
        assert json.loads(await step("GET", "/t/obj", query="tagging"))[
            "TagSet"] == tags
        assert await step("GET", "/t/obj") == b"d"
        await step("PUT", "/t/obj", json.dumps({"TagSet": {
            f"k{i}": "v" for i in range(11)}}).encode(), "tagging", "400")
        await step("PUT", "/t/obj", b"[1,2]", "tagging", "400")
        await step("DELETE", "/t/obj", query="tagging", want="204")
        assert json.loads(await step("GET", "/t/obj", query="tagging"))[
            "TagSet"] == {}
        await step("PUT", "/t/ghost", json.dumps(
            {"TagSet": {"a": "b"}}).encode(), "tagging", "404")
    return out


@case
async def rgw_tagging_on_ec_pool_fallback(r):
    """EC pools answer EOPNOTSUPP to cls calls: tagging falls back to the
    client-side index read-modify-write."""
    svc = r.pkg.rgw.RgwService(await r.ns("ec"), chunk_size=4096)
    await svc.create_bucket("b")
    await svc.put_object("b", "k", b"data")
    await svc.put_object_tagging("b", "k", {"x": "y"})
    out = {"tags": await svc.get_object_tagging("b", "k")}
    assert out["tags"] == {"x": "y"}
    await svc.delete_object_tagging("b", "k")
    out["cleared"] = await svc.get_object_tagging("b", "k")
    assert out["cleared"] == {}
    out["ghost"] = await raises(r.pkg.RadosError, svc.put_object_tagging(
        "b", "ghost", {"a": "b"}))
    return out


@case
async def rgw_list_uploads_and_parts(r):
    svc, admin, u, ak, creds = await admin_gateway(
        r, "ray", chunk=4096)
    out = []
    async with Gateway(r, svc, creds) as gw:
        async def step(method, path, body=b"", query="", want="200"):
            st, payload, _ = await gw.req(method, path, body, ak, query)
            assert st.startswith(want), (method, path, query, st, payload)
            out.append((method, path, query, st, payload))
            return payload

        await step("PUT", "/lp")
        assert json.loads(await step("GET", "/lp", query="uploads"))[
            "Uploads"] == []
        up = json.loads(await step("POST", "/lp/big", query="uploads"))[
            "UploadId"]
        for i, size in ((1, 5000), (3, 700)):
            await step("PUT", "/lp/big", b"x" * size,
                       f"uploadId={up}&partNumber={i}")
        ups = json.loads(await step("GET", "/lp", query="uploads"))["Uploads"]
        assert ups == [{"UploadId": up, "Key": "big"}]
        parts = json.loads(await step("GET", "/lp/big",
                                      query=f"uploadId={up}"))["Parts"]
        assert [p["PartNumber"] for p in parts] == [1, 3]
        assert [p["Size"] for p in parts] == [5000, 700]
        assert all(p["ETag"] for p in parts)
        await step("GET", "/lp/other", query=f"uploadId={up}", want="404")
        await step("POST", "/lp/big", query=f"uploadId={up}")
        assert json.loads(await step("GET", "/lp", query="uploads"))[
            "Uploads"] == []
    return out


@case
async def rgw_swift_get_honors_range(r):
    svc = r.pkg.rgw.RgwService(await r.ns("rep"), chunk_size=4096)
    svc.credentials = {"acct:user": "secret", "acct": "secret"}
    svc._static_credentials = dict(svc.credentials)
    data = blob(10_000, 21)
    out = []
    async with Gateway(r, svc) as gw:
        async def swift(method, path, body=b"", token=None, auth=None,
                        extra=None, want="2"):
            hx = {"host": gw.hosthdr, **(extra or {})}
            if token:
                hx["x-auth-token"] = token
            if auth:
                hx.update({"x-auth-user": auth[0], "x-auth-key": auth[1]})
            st, payload, h = await gw.raw(method, path, body, hx)
            assert st.startswith(want), (method, path, st)
            out.append((method, path, st, payload, h.get("content-range")))
            return payload, h

        _, h = await swift("GET", "/auth/v1.0", auth=("acct:user", "secret"),
                           want="200")
        token = h["x-auth-token"]
        await swift("PUT", "/v1/AUTH_acct/cont", token=token, want="201")
        await swift("PUT", "/v1/AUTH_acct/cont/obj", data, token, want="201")
        body, h = await swift("GET", "/v1/AUTH_acct/cont/obj", token=token,
                              extra={"range": "bytes=2000-4999"}, want="206")
        assert body == data[2000:5000]
        assert h["content-range"] == f"bytes 2000-4999/{len(data)}"
        _, h = await swift("GET", "/v1/AUTH_acct/cont/obj", token=token,
                           extra={"range": "bytes=99999-"}, want="416")
        assert h["content-range"] == f"bytes */{len(data)}"
    return out


# -- tests/test_cephfs_handles.py ---------------------------------------------

async def mds_server(r, pool="ec"):
    """An MDSServer over a fresh, mounted FileSystem in this case's
    namespace of `pool`."""
    fs = r.pkg.mds.FileSystem(await r.ns(pool))
    await fs.mkfs()
    await fs.mount()
    return r.pkg.mds.MDSServer(fs)


@case
async def cephfs_mode_and_permission_enforcement(r):
    mds = await mds_server(r)
    FsError = r.pkg.mds.FsError
    c = r.pkg.mds.CephFSClient(mds, "alice")
    out = {"missing": await raises(FsError, c.open("/missing", "r"),
                                   match="ENOENT")}
    await c.mkdir("/d")
    out["isdir"] = await raises(FsError, c.open("/d", "r"), match="EISDIR")
    out["badmode"] = await raises(FsError, c.open("/x", "rw"), match="EINVAL")
    fh = await c.open("/empty", "w")
    await fh.close()
    await c.fsync("/empty")
    out["created"] = await c.stat("/empty")
    assert out["created"]["type"] == "file" and out["created"]["size"] == 0
    fh = await c.open("/empty", "w")
    out["wo_read"] = await raises(FsError, fh.read(), match="EBADF")
    await fh.pwrite(0, b"data")
    await fh.close()
    fh = await c.open("/empty", "r")
    out["ro_write"] = await raises(FsError, fh.pwrite(0, b"x"), match="EBADF")
    out["read"] = await fh.read()
    assert out["read"] == b"data"
    await fh.close()
    out["closed"] = await raises(FsError, fh.pread(0, 1), match="EBADF")
    fh = await c.open("/empty", "w")  # w truncates
    await fh.close()
    out["truncated"] = (await c.stat("/empty"))["size"]
    assert out["truncated"] == 0
    return out


@case
async def cephfs_positional_sequential_append(r):
    mds = await mds_server(r)
    c = r.pkg.mds.CephFSClient(mds, "alice")
    async with await c.open("/f", "w") as fh:
        await fh.write(b"hello ")
        await fh.write(b"world")
        await fh.pwrite(16, b"TAIL")  # past EOF: a zero-filled hole
    async with await c.open("/f", "r") as fh:
        out = [await fh.read(6), await fh.read(), await fh.pread(0, 5),
               await fh.pread(16, 4)]
    assert out == [b"hello ", b"world\x00\x00\x00\x00\x00TAIL", b"hello",
                   b"TAIL"]
    async with await c.open("/f", "r+") as fh:
        await fh.pwrite(0, b"HELLO")
        out.append(await fh.pread(0, 11))
        assert out[-1] == b"HELLO world"
        await fh.truncate(11)
    async with await c.open("/f", "a") as fh:
        await fh.write(b"+one")
        await fh.write(b"+two")
    out.append(await c.read("/f"))
    assert out[-1] == b"HELLO world+one+two"
    return out


@case
async def cephfs_write_behind_until_fsync(r):
    mds = await mds_server(r)
    c = r.pkg.mds.CephFSClient(mds, "alice")
    fh = await c.open("/wb", "w")
    await fh.pwrite(0, b"buffered")
    out = [await raises(r.pkg.mds.FsError, mds.fs.read_file("/wb"),
                        match="ENOENT")]
    await fh.fsync()
    out.append(await mds.fs.read_file("/wb"))
    await fh.pwrite(0, b"BUFFERED")
    out.append(await mds.fs.read_file("/wb"))
    await fh.close()  # close flushes
    out.append(await mds.fs.read_file("/wb"))
    assert out[1:] == [b"buffered", b"buffered", b"BUFFERED"]
    return out


@serial
async def cephfs_conflicting_open_revokes_and_handle_recovers(r):
    mds = await mds_server(r)
    a = r.pkg.mds.CephFSClient(mds, "alice", renew_interval=0.01)
    b = r.pkg.mds.CephFSClient(mds, "bob", renew_interval=0.01)
    fa = await a.open("/shared", "w")
    await fa.pwrite(0, b"from-alice")

    async def a_side():
        for _ in range(50):
            await a.renew()
            await asyncio.sleep(0.01)

    opened = asyncio.create_task(b.open("/shared", "r+"))
    pump = asyncio.create_task(a_side())
    fb = await asyncio.wait_for(opened, 10)
    out = [await fb.pread(0, -1)]
    assert out[0] == b"from-alice"
    await fb.pwrite(0, b"BOB!")
    await fb.fsync()
    pump.cancel()

    async def b_side():
        for _ in range(200):
            await b.renew()
            await asyncio.sleep(0.01)

    bp = asyncio.create_task(b_side())
    out.append(await asyncio.wait_for(a.pread("/shared", 0, 4), 10))
    assert out[1] == b"BOB!"
    await fa.pwrite(0, b"ALIC")
    await fa.fsync()
    bp.cancel()
    out.append(await mds.fs.read_file("/shared"))
    assert out[2] == b"ALIC-alice"
    await fa.close()
    await fb.close()
    return out


async def mds_cluster(r, n_ranks=2, pool="ec", **kw):
    return await r.pkg.mdsc.MDSCluster(await r.ns(pool), n_ranks=n_ranks,
                                       **kw).start()


@case
async def cephfs_handle_survives_subtree_export(r):
    mc = await mds_cluster(r)
    c = r.pkg.mdsc.CephFSMultiClient(mc, "c", renew_interval=0.01)
    await c.mkdir("/mig")
    fh = await c.open("/mig/file", "w")
    await fh.pwrite(0, b"before-export")
    await fh.fsync()
    await mc.export_dir("/mig", 1)
    out = [mc.rank_of("/mig/file"), await fh.pwrite(0, b"AFTER-")]
    assert out == [1, 6]
    await fh.fsync()
    fh2 = await c.open("/mig/file", "r")
    out.append(await fh2.pread(0, -1))
    assert out[2] == b"AFTER--export"
    await fh.close()
    await fh2.close()
    return out


@case
async def cephfs_pread_missing_file_raises_enoent(r):
    mds = await mds_server(r)
    c = r.pkg.mds.CephFSClient(mds, "alice")
    return await raises(r.pkg.mds.FsError, c.pread("/no-such", 0, 4),
                        match="ENOENT")


async def pumping(*clients):
    """A task renewing `clients` until cancelled (they comply with the
    revokes other clients' requests queue)."""
    async def pump():
        while True:
            for c in clients:
                await c.renew()
            await asyncio.sleep(0.005)

    return asyncio.create_task(pump())


@case
async def cephfs_chmod_and_open_enforcement(r):
    FsError = r.pkg.mds.FsError
    mds = await mds_server(r)
    alice = r.pkg.mds.CephFSClient(mds, "alice", renew_interval=0.01)
    bob = r.pkg.mds.CephFSClient(mds, "bob", renew_interval=0.01)
    fh = await alice.open("/secret", "w")
    await fh.pwrite(0, b"mine")
    await fh.close()
    st = await alice.stat("/secret")
    assert st["owner"] == "alice" and st["mode"] == 0o666
    out = {"stat": st}
    pump = await pumping(alice)
    await alice.chmod("/secret", 0o644)
    fb = await asyncio.wait_for(bob.open("/secret", "r"), 10)
    out["bob_read"] = await fb.pread(0, -1)
    assert out["bob_read"] == b"mine"
    await fb.close()
    out["denied"] = [
        await raises(FsError, bob.open("/secret", "r+"), match="EACCES"),
        await raises(FsError, bob.open("/secret", "a"), match="EACCES"),
        await raises(FsError, bob.chmod("/secret", 0o666), match="EPERM")]
    await alice.chmod("/secret", 0o600)
    bob._clean.pop("/secret", None)
    out["locked"] = [
        await raises(FsError, bob.open("/secret", "r"), match="EACCES"),
        await raises(FsError, bob.read("/secret"), match="EACCES"),
        await raises(FsError, bob.pwrite("/secret", 0, b"x"),
                     match="EACCES")]
    assert bob.session.caps.get("/secret") != "rw"
    fa = await asyncio.wait_for(alice.open("/secret", "r+"), 10)
    out["owner"] = await fa.pread(0, 4)
    assert out["owner"] == b"mine"
    await fa.close()
    await alice.chmod("/secret", 0o666)
    pump.cancel()
    p2 = await pumping(alice, bob)
    fb = await asyncio.wait_for(bob.open("/secret", "r+"), 10)
    await fb.pwrite(0, b"ours")
    await fb.close()
    p2.cancel()
    out["after"] = await bob.stat("/secret")
    assert out["after"]["owner"] == "alice"
    await mds.fs.write_file("/legacy", b"old")  # unstamped: open to all
    fb = await bob.open("/legacy", "r+")
    await fb.close()
    out["legacy"] = await mds.fs.read_file("/legacy")
    return out


@case
async def cephfs_denied_pwrite_fails_up_front_on_0644(r):
    mds = await mds_server(r)
    alice = r.pkg.mds.CephFSClient(mds, "alice", renew_interval=0.01)
    bob = r.pkg.mds.CephFSClient(mds, "bob", renew_interval=0.01)
    await alice.write("/f", b"hers")
    await alice.fsync("/f")
    await alice.chmod("/f", 0o644)
    t = await pumping(alice)
    out = [await raises(r.pkg.mds.FsError, bob.pwrite("/f", 0, b"evil"),
                        match="EACCES")]
    assert "/f" not in bob._dirty
    assert bob.session.caps.get("/f") != "rw"
    out.append(await asyncio.wait_for(alice.read("/f"), 10))
    assert out[1] == b"hers"
    t.cancel()
    return out


@case
async def cephfs_snapshot_read_honors_mode(r):
    mds = await mds_server(r)
    alice = r.pkg.mds.CephFSClient(mds, "alice", renew_interval=0.01)
    bob = r.pkg.mds.CephFSClient(mds, "bob", renew_interval=0.01)
    await alice.mkdir("/docs")
    await alice.write("/docs/secret", b"topsecret")
    await alice.fsync("/docs/secret")
    await alice.chmod("/docs/secret", 0o600)
    await alice.snap_create("/docs", "s1")
    t = await pumping(alice)
    out = [await raises(r.pkg.mds.FsError, asyncio.wait_for(
        bob.read_snap("/docs", "s1", "secret"), 15), match="EACCES"),
        await asyncio.wait_for(alice.read_snap("/docs", "s1", "secret"), 15)]
    assert out[1] == b"topsecret"
    t.cancel()
    return out


@case
async def cephfs_chmod_flushes_write_behind_first(r):
    mds = await mds_server(r)
    alice = r.pkg.mds.CephFSClient(mds, "alice")
    await alice.write("/g", b"x")
    await alice.chmod("/g", 0o600)  # no fsync in between
    out = [(await alice.stat("/g"))["mode"], await mds.fs.read_file("/g")]
    assert out == [0o600, b"x"]
    return out


# -- tests/test_mds_snapshots.py ----------------------------------------------

async def mounted_fs(r, pool="ec"):
    fs = r.pkg.mds.FileSystem(await r.ns(pool))
    await fs.mkfs()
    await fs.mount()
    return fs


@case
async def snap_preserves_bytes_across_overwrite_and_unlink(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.write_file("/d/a", b"v1")
    await fs.write_file("/d/b", b"keep")
    await fs.snap_create("/d", "s1")
    await fs.write_file("/d/a", b"v2")
    await fs.unlink("/d/b")
    out = [await fs.read_file("/d/a"),
           await raises(r.pkg.mds.FsError, fs.read_file("/d/b")),
           await fs.read_snap_file("/d", "s1", "a"),
           await fs.read_snap_file("/d", "s1", "b"),
           await fs.listdir_snap("/d", "s1"), await fs.snap_list("/d")]
    assert out[0] == b"v2" and out[2:] == [b"v1", b"keep", ["a", "b"],
                                           ["s1"]]
    return out


@case
async def snap_delete_reclaims_only_unpinned_inos(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.write_file("/d/f", b"gen1")
    await fs.snap_create("/d", "s1")
    await fs.write_file("/d/f", b"gen2")
    await fs.snap_create("/d", "s2")
    await fs.write_file("/d/f", b"gen3")
    await fs.snap_delete("/d", "s1")
    out = [await fs.snap_list("/d"), await fs.read_snap_file("/d", "s2", "f"),
           await fs.read_file("/d/f")]
    assert out == [["s2"], b"gen2", b"gen3"]
    await fs.snap_delete("/d", "s2")
    out += [await fs.read_file("/d/f"), await raises(
        r.pkg.mds.FsError, fs.read_snap_file("/d", "s2", "f"))]
    assert out[3] == b"gen3"
    return out


@case
async def snap_survives_crash_replay(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.write_file("/d/f", b"old")
    await fs.snap_create("/d", "s")
    await fs.write_file("/d/f", b"new")
    standby = r.pkg.mds.FileSystem(fs.meta, fs.data)
    await standby.mount()
    out = [await standby.read_snap_file("/d", "s", "f"),
           await standby.read_file("/d/f")]
    assert out == [b"old", b"new"]
    return out


@case
async def snap_nested_tree_and_bad_names(r):
    FsError = r.pkg.mds.FsError
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.mkdir("/d/sub")
    await fs.write_file("/d/sub/deep", b"x")
    await fs.snap_create("/d", "s")
    out = [await fs.listdir_snap("/d", "s"),
           await fs.listdir_snap("/d", "s", "sub"),
           await fs.read_snap_file("/d", "s", "sub/deep")]
    assert out == [["sub"], ["deep"], b"x"]
    out += [await raises(FsError, fs.snap_create("/d", "a|b")),
            await raises(FsError, fs.snap_create("/d", "s")),
            await raises(FsError, fs.snap_create("/nope", "s"))]
    return out


@case
async def snap_delete_spares_renamed_live_file(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.mkdir("/elsewhere")
    await fs.write_file("/d/f", b"payload")
    await fs.snap_create("/d", "s")
    await fs.rename("/d/f", "/elsewhere/g")
    await fs.snap_delete("/d", "s")
    out = await fs.read_file("/elsewhere/g")
    assert out == b"payload"
    return out


@case
async def snap_listdir_on_file_is_enotdir(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.write_file("/d/f", b"x")
    await fs.snap_create("/d", "s")
    return await raises(r.pkg.mds.FsError, fs.listdir_snap("/d", "s", "f"),
                        match="ENOTDIR")


@case
async def snap_client_flushes_writeback_into_snapshot(r):
    fs = await mounted_fs(r)
    c = r.pkg.mds.CephFSClient(r.pkg.mds.MDSServer(fs), "writer",
                               renew_interval=0.01)
    await c.mkdir("/d")
    await c.write("/d/f", b"behind")  # stays in the client's cache
    await c.snap_create("/d", "snap")
    await c.write("/d/f", b"after")
    await c.fsync("/d/f")
    out = [await c.read_snap("/d", "snap", "f"), await c.read("/d/f"),
           await c.snap_list("/d")]
    assert out == [b"behind", b"after", ["snap"]]
    await c.snap_delete("/d", "snap")
    out.append(await c.snap_list("/d"))
    assert out[3] == []
    await c.unmount()
    return out


@case
async def snap_across_subtree_authorities(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/proj")
    await mc.export_dir("/proj", 1)
    await fsc.write("/proj/f", b"r1-bytes")  # dirty at rank 1
    await fsc.snap_create("/proj", "s")
    await fsc.write("/proj/f", b"changed")
    await fsc.fsync("/proj/f")
    out = [await fsc.read_snap("/proj", "s", "f"), await fsc.read("/proj/f"),
           await fsc.snap_list("/proj")]
    assert out == [b"r1-bytes", b"changed", ["s"]]
    await mc.replace_rank(0)  # the snap table replays with rank 0
    out.append(await fsc.read_snap("/proj", "s", "f"))
    assert out[3] == b"r1-bytes"
    await fsc.unmount()
    return out


# -- tests/test_cephfs_shell.py -----------------------------------------------

@serial
async def cephfs_shell_workflow(r):
    """The cephfs-shell CLI against the live cluster, each command a fresh
    mount with journal replay (its own pool: the CLI opens the default
    namespace)."""
    fs = r.pkg.mds.FileSystem(await r.rados.open_ioctx("fsx"))
    await fs.mkfs()
    cli = r.pkg.shell_cli
    local = r.tmp / "in.txt"
    local.write_bytes(b"hello from the shell\n")
    fetched = r.tmp / "out.txt"
    out = []

    async def sh(*argv, want=0):
        with captured_stdout() as text:
            rc = await cli.run(cli.parse_args(
                ["--mon", r.mon, "--pool", "fsx", *argv]))
        assert rc == want, (argv, rc)
        out.append((argv[0], rc, text.value))
        return text.value

    await sh("mkdir", "/docs")
    await sh("put", str(local), "/docs/hello")
    assert (await sh("ls", "/docs")).strip() == "hello"
    assert "hello from the shell" in await sh("cat", "/docs/hello")
    await sh("get", "/docs/hello", str(fetched))
    assert fetched.read_bytes() == local.read_bytes()
    assert '"file"' in await sh("stat", "/docs/hello")
    await sh("chmod", "600", "/docs/hello")
    assert "0o600" in await sh("stat", "/docs/hello")
    await sh("mv", "/docs/hello", "/docs/hi")
    assert (await sh("du", "/")).strip() == str(len(local.read_bytes()))
    await sh("rm", "/docs/hi")
    assert (await sh("ls", "/docs")).strip() == ""
    await sh("cat", "/missing", want=1)  # errors are exit code 1
    return out


# -- tests/test_mds_cluster.py ------------------------------------------------

@case
async def mdsc_deepest_prefix_wins(r):
    mc = await mds_cluster(r, n_ranks=3)
    mc.subtrees.update({"/a": 1, "/a/deep": 2})
    out = [mc.rank_of(p) for p in ("/", "/b/c", "/a", "/a/x", "/a/deep/file",
                                   "/ab")]
    assert out == [0, 0, 1, 1, 2, 0]
    return out


@case
async def mdsc_multi_rank_io_through_facade(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/proj")
    await mc.export_dir("/proj", 1)
    assert mc.rank_of("/proj/f") == 1
    await fsc.write("/proj/f", b"on-rank-1")
    await fsc.fsync("/proj/f")
    await fsc.write("/top", b"on-rank-0")
    await fsc.fsync("/top")
    out = [await fsc.read("/proj/f"), await fsc.read("/top"),
           mc.ranks[1].fs.mdlog.seg * 1000 + mc.ranks[1].fs.mdlog.count > 0]
    assert out == [b"on-rank-1", b"on-rank-0", True]
    await fsc.unmount()
    return out


@case
async def mdsc_export_revokes_caps_and_flushes_writeback(r):
    mc = await mds_cluster(r, revoke_timeout=3.0)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/hot")
    await fsc.write("/hot/f", b"dirty-bytes")  # write-behind
    export = asyncio.create_task(mc.export_dir("/hot", 1))
    for _ in range(200):
        if export.done():
            break
        await fsc.renew_all()
        await asyncio.sleep(0.01)
    await export
    out = [mc.rank_of("/hot/f"), await fsc.read("/hot/f")]
    assert out == [1, b"dirty-bytes"]
    await fsc.unmount()
    return out


@case
async def mdsc_ops_frozen_during_export_then_succeed(r):
    mc = await mds_cluster(r, revoke_timeout=0.5)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/m")
    await fsc.write("/m/a", b"1")
    await fsc.fsync("/m/a")
    mc._frozen.add("/m")
    out = [await raises(r.pkg.mds.FsError, fsc._routed(
        "/m/a", "read", retries=2, delay=0.01))]
    mc._frozen.discard("/m")
    export = asyncio.create_task(mc.export_dir("/m", 1))
    writes = asyncio.create_task(fsc.write("/m/b", b"2"))
    await fsc.renew_all()
    await export
    await writes
    await fsc.fsync("/m/b")
    out.append(await fsc.read("/m/b"))
    assert out[1] == b"2"
    await fsc.unmount()
    return out


@case
async def mdsc_crash_between_pending_and_commit_completes(r):
    mdsc = r.pkg.mdsc
    mc = await mds_cluster(r)
    io_ = mc.meta
    fsc = mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/x")
    await fsc.write("/x/f", b"v")
    await fsc.fsync("/x/f")
    await fsc.unmount()
    m = json.loads(await io_.read(mdsc.SUBTREE_MAP_OID))
    m["pending"] = {"path": "/x", "to": 1}
    await io_.write_full(mdsc.SUBTREE_MAP_OID, json.dumps(m).encode())
    mc2 = await mdsc.MDSCluster(io_, n_ranks=2).start()
    out = [mc2.rank_of("/x/f"),
           json.loads(await io_.read(mdsc.SUBTREE_MAP_OID))["pending"]]
    assert out == [1, None]
    fsc2 = mdsc.CephFSMultiClient(mc2)
    out.append(await fsc2.read("/x/f"))
    assert out[2] == b"v"
    await fsc2.unmount()
    return out


@case
async def mdsc_rank_replacement_replays_own_journal(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/svc")
    await mc.export_dir("/svc", 1)
    await fsc.write("/svc/f", b"payload")
    await fsc.fsync("/svc/f")
    # journal an event at rank 1 without applying it
    await mc.ranks[1].fs._journal({
        "op": "set_dentry", "parent": "/svc", "name": "half",
        "dentry": {"type": "file", "size": 0, "ino": "deadbeef" * 4,
                   "mtime": 0.0}})
    await mc.replace_rank(1)
    names = await mc.ranks[1].fs.listdir("/svc")
    assert "half" in names and "f" in names
    out = [names, await fsc.read("/svc/f")]
    assert out[1] == b"payload"
    await fsc.unmount()
    return out


@case
async def mdsc_hot_subtree_moves_to_cold_rank(r):
    mc = await mds_cluster(r, revoke_timeout=0.2)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/busy")
    await fsc.write("/busy/f", b"x")
    await fsc.fsync("/busy/f")
    for _ in range(50):  # heat /busy on rank 0
        await fsc.read("/busy/f")
    await fsc.renew_all()
    moved = await mc.maybe_rebalance(ratio=2.0)
    out = [moved, mc.rank_of("/busy/f"), await fsc.read("/busy/f")]
    assert out == [("/busy", 0, 1), 1, b"x"]
    await fsc.unmount()
    return out


@case
async def mdsc_rename_across_authorities(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/a")
    await fsc.mkdir("/b")
    await mc.export_dir("/b", 1)
    await fsc.write("/a/src", b"moved-bytes")
    await fsc.fsync("/a/src")
    await fsc.rename("/a/src", "/b/dst")
    out = [await fsc.read("/b/dst"),
           await raises(r.pkg.mds.FsError, mc.ranks[0].fs.read_file("/a/src")),
           await fsc.listdir("/a"), await fsc.listdir("/b")]
    assert out[0] == b"moved-bytes"
    assert "src" not in out[2] and "dst" in out[3]
    await fsc.unmount()
    return out


@case
async def mdsc_exporter_replay_cannot_regress_migrated_subtree(r):
    mc = await mds_cluster(r, revoke_timeout=0.2)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/hot")
    await fsc.write("/hot/f", b"OLD")
    await fsc.fsync("/hot/f")
    await mc.export_dir("/hot", 1)
    await fsc.write("/hot/f", b"NEW")
    await fsc.fsync("/hot/f")
    await mc.replace_rank(0)  # must not resurrect the OLD dentry
    out = await fsc.read("/hot/f")
    assert out == b"NEW"
    await fsc.unmount()
    return out


@case
async def mdsc_cross_rename_replay_touches_only_own_dirfrags(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/a")
    await fsc.mkdir("/b")
    await mc.export_dir("/b", 1)
    await fsc.write("/a/src", b"v1")
    await fsc.fsync("/a/src")
    await fsc.rename("/a/src", "/b/dst")
    await fsc.write("/b/dst", b"v2")
    await fsc.fsync("/b/dst")
    await mc.replace_rank(0)
    out = [await fsc.read("/b/dst"), await fsc.listdir("/a")]
    assert out[0] == b"v2" and "src" not in out[1]
    await fsc.unmount()
    return out


@case
async def mdsc_intent_log_completes_interrupted_rename(r):
    mdsc = r.pkg.mdsc
    mc = await mds_cluster(r)
    fsc = mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/a")
    await fsc.mkdir("/b")
    await mc.export_dir("/b", 1)
    await fsc.write("/a/src", b"payload")
    await fsc.fsync("/a/src")
    await fsc.unmount()
    fs0, fs1 = mc.ranks[0].fs, mc.ranks[1].fs
    ent = (await fs0._load_dir("/a"))["src"]
    await mc._save_rename_log(0, [{
        "ino": ent["ino"], "sparent": "/a", "sname": "src",
        "dparent": "/b", "dname": "dst", "dst_rank": 1}])
    ev = {"op": "rename", "events": [
        {"op": "set_dentry", "parent": "/b", "name": "dst", "dentry": ent}]}
    await fs1._journal(ev)
    await fs1._apply_event(ev)
    mc2 = await mdsc.MDSCluster(mc.meta, n_ranks=2).start()
    fsc2 = mdsc.CephFSMultiClient(mc2)
    out = [await fsc2.read("/b/dst"), await fsc2.listdir("/a"),
           await mc2._load_rename_log(0)]
    assert out[0] == b"payload" and "src" not in out[1] and out[2] == []
    await fsc2.unmount()
    return out


@case
async def mdsc_uncommitted_intent_is_discarded(r):
    mdsc = r.pkg.mdsc
    mc = await mds_cluster(r)
    fsc = mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/a")
    await fsc.mkdir("/b")
    await mc.export_dir("/b", 1)
    await fsc.write("/a/src", b"stay")
    await fsc.fsync("/a/src")
    await fsc.unmount()
    ent = (await mc.ranks[0].fs._load_dir("/a"))["src"]
    await mc._save_rename_log(0, [{
        "ino": ent["ino"], "sparent": "/a", "sname": "src",
        "dparent": "/b", "dname": "dst", "dst_rank": 1}])
    mc2 = await mdsc.MDSCluster(mc.meta, n_ranks=2).start()
    fsc2 = mdsc.CephFSMultiClient(mc2)
    out = [await fsc2.read("/a/src"),
           await raises(r.pkg.mds.FsError, fsc2.read("/b/dst")),
           await mc2._load_rename_log(0)]
    assert out[0] == b"stay" and out[2] == []
    await fsc2.unmount()
    return out


@case
async def mdsc_stale_dst_writeback_cannot_clobber_rename(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc, renew_interval=0.01)
    await fsc.mkdir("/a")
    await fsc.mkdir("/b")
    await mc.export_dir("/b", 1)
    await fsc.write("/a/src", b"KEEP")
    await fsc.fsync("/a/src")
    await fsc.write("/b/dst", b"STALE")  # dirty, unflushed
    await fsc.rename("/a/src", "/b/dst")
    await fsc.renew_all()
    await fsc.fsync("/b/dst")
    out = await fsc.read("/b/dst")
    assert out == b"KEEP"
    await fsc.unmount()
    return out


@case
async def mdsc_concurrent_mkdir_same_parent_loses_nothing(r):
    mc = await mds_cluster(r, n_ranks=1)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/p")
    await asyncio.gather(*[fsc.mkdir(f"/p/d{i}") for i in range(8)])
    out = await fsc.listdir("/p")
    assert out == [f"d{i}" for i in range(8)]
    await fsc.unmount()
    return out


@case
async def mdsc_dir_rename_moves_subtree(r):
    FsError = r.pkg.mds.FsError
    mc = await mds_cluster(r, n_ranks=1)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/proj")
    await fsc.mkdir("/proj/src")
    await fsc.mkdir("/proj/src/deep")
    await fsc.write("/proj/src/deep/f", b"payload")
    await fsc.fsync("/proj/src/deep/f")
    await fsc.mkdir("/archive")
    await fsc.rename("/proj/src", "/archive/v1")
    out = [await fsc.read("/archive/v1/deep/f"),
           await fsc.listdir("/archive/v1"), await fsc.listdir("/proj"),
           await raises(FsError, fsc.listdir("/proj/src"))]
    assert out[:3] == [b"payload", ["deep"], []]
    await fsc.mkdir("/proj/a")
    out += [await raises(FsError, mc.ranks[0].fs.rename("/proj", "/proj/a/x"),
                         match="EINVAL"),
            await raises(FsError, mc.ranks[0].fs.rename("/archive/v1",
                                                        "/proj/a"),
                         match="EEXIST")]
    await fsc.unmount()
    return out


@case
async def mdsc_dir_rename_replay_completes_half_move(r):
    mc = await mds_cluster(r, n_ranks=1)
    fs = mc.ranks[0].fs
    await fs.mkdir("/d")
    await fs.mkdir("/d/sub")
    await fs.write_file("/d/sub/f", b"x")
    frags = {"": dict(await fs._load_dir("/d")),
             "sub": dict(await fs._load_dir("/d/sub"))}
    await fs._journal({"op": "rename_dir", "src": "/d", "dst": "/moved",
                       "frags": frags, "sparent": "/", "sname": "d",
                       "dparent": "/", "dname": "moved",
                       "dentry": {"type": "dir", "mtime": 0.0}})
    await fs._save_dir("/moved/sub", frags["sub"])
    await fs.meta.remove(fs._dir_oid("/d/sub"))
    standby = r.pkg.mds.FileSystem(mc.meta, journal_prefix="mds0.")
    await standby.mount()
    out = [await standby.read_file("/moved/sub/f"),
           await standby.listdir("/")]
    assert out[0] == b"x" and "moved" in out[1] and "d" not in out[1]
    return out


@case
async def mdsc_subtree_root_guard(r):
    FsError = r.pkg.mds.FsError
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/team")
    await fsc.mkdir("/team/hot")
    await mc.export_dir("/team/hot", 1)
    await fsc.mkdir("/attic")
    out = [await raises(FsError, fsc.rename("/team", "/attic/team"),
                        match="EXDEV"),
           await raises(FsError, fsc.rename("/attic", "/team/hot/attic"),
                        match="EXDEV")]
    await fsc.unmount()
    return out


@case
async def mdsc_replay_spares_recreated_source(r):
    fs = await mounted_fs(r)
    await fs.mkdir("/d")
    await fs.mkdir("/d/sub")
    await fs.write_file("/d/sub/f", b"keep-me")
    await fs.rename("/d", "/b")
    await fs.mkdir("/d")
    await fs.mkdir("/d/sub")
    await fs.write_file("/d/sub/new", b"fresh")
    standby = r.pkg.mds.FileSystem(fs.meta)
    await standby.mount()
    out = [await standby.read_file("/b/sub/f"),
           await standby.read_file("/d/sub/new")]
    assert out == [b"keep-me", b"fresh"]
    return out


@case
async def mdsc_dir_rename_revokes_other_holders_caps(r):
    mc = await mds_cluster(r, n_ranks=1)
    a = r.pkg.mdsc.CephFSMultiClient(mc, "a", renew_interval=0.01)
    b = r.pkg.mdsc.CephFSMultiClient(mc, "b", renew_interval=0.01)
    await a.mkdir("/d")
    await b.write("/d/f", b"b-bytes")  # write-behind at b
    rename = asyncio.create_task(a.rename("/d", "/moved"))
    for _ in range(200):
        if rename.done():
            break
        await b.renew_all()
        await asyncio.sleep(0.01)
    await rename
    out = [await a.read("/moved/f"), await b.read("/moved/f")]
    assert out == [b"b-bytes"] * 2
    await a.unmount()
    await b.unmount()
    return out


@case
async def mdsc_rename_dir_onto_itself_is_noop(r):
    mc = await mds_cluster(r, n_ranks=1)
    fs = mc.ranks[0].fs
    await fs.mkdir("/same")
    await fs.write_file("/same/f", b"x")
    await fs.rename("/same", "/same")
    out = await fs.read_file("/same/f")
    assert out == b"x"
    return out


@case
async def mdsc_moving_a_subtree_root_itself_is_exdev(r):
    mc = await mds_cluster(r)
    fsc = r.pkg.mdsc.CephFSMultiClient(mc)
    await fsc.mkdir("/hot")
    await mc.export_dir("/hot", 1)
    await fsc.mkdir("/cold")
    out = await raises(r.pkg.mds.FsError, fsc.rename("/hot", "/cold/hot"),
                       match="EXDEV")
    await fsc.unmount()
    return out


@serial
async def mdsc_cluster_level_dir_rename_revokes_caps(r):
    """The holder complies, flushing /d/f inside the 1 s revoke deadline
    (alone, so the concurrent cases' RADOS traffic is not what outlasts
    it; a holder that does outlast it is evicted, as the next case
    shows)."""
    mc = await mds_cluster(r, n_ranks=1, revoke_timeout=1.0)
    b = r.pkg.mdsc.CephFSMultiClient(mc, "b", renew_interval=0.01)
    await b.mkdir("/d")
    await b.write("/d/f", b"held")
    rename = asyncio.create_task(mc.rename("/d", "/m"))
    for _ in range(200):
        if rename.done():
            break
        await b.renew_all()
        await asyncio.sleep(0.01)
    await rename
    out = [await mc.ranks[0].fs.read_file("/m/f"),
           any(p.startswith("/d") for p in mc.ranks[0]._caps)]
    assert out == [b"held", False]
    await b.unmount()
    return out


@case
async def mdsc_holder_flushing_past_revoke_deadline_is_evicted(r):
    """The revoke deadline counts until the cap is released, not until the
    holder starts to comply (the reference's cap-revoke eviction): a
    holder whose flush is still in flight at the deadline loses its caps,
    the rename goes ahead, and the late flush finds its parent gone."""
    mc = await mds_cluster(r, n_ranks=1, revoke_timeout=0.2)
    b = r.pkg.mdsc.CephFSMultiClient(mc, "b", renew_interval=0.01)
    await b.mkdir("/d")
    await b.write("/d/f", b"held")
    fs = mc.ranks[0].fs
    gate, real_write = asyncio.Event(), fs.striper.write

    async def held_write(*args, **kw):
        await gate.wait()
        return await real_write(*args, **kw)

    fs.striper.write = held_write
    rename = asyncio.create_task(mc.rename("/d", "/m"))
    session = b._clients[0].session
    while "/d/f" not in session.revoked:
        await asyncio.sleep(0.01)
    flush = asyncio.create_task(b.renew_all())
    await rename
    gate.set()
    out = [await raises(r.pkg.mds.FsError, flush, match="ENOENT"),
           any(p.startswith("/d") for p in mc.ranks[0]._caps),
           await raises(r.pkg.mds.FsError, fs.read_file("/m/f"),
                        match="ENOENT")]
    assert out == [("FsError", None), False, ("FsError", None)]
    await b.unmount()
    return out


# -- after one OSD is lost ----------------------------------------------------

@after_loss
async def rgw_reads_degraded(r):
    """The EC pool's rgw objects, through fresh gateways, one OSD lost."""
    rgw = r.pkg.rgw.RgwService
    out = {}
    for name, ns, bucket, key, chunk in (
            ("sigv4", "rgw_sigv4_auth_on_http_frontend", "b", "k", 64 << 10),
            ("multipart", "rgw_sigv4_auth_on_http_frontend", "b", "big",
             64 << 10),
            ("zone_b", "rgw_zone_sync_full_then_incremental.zone-b", "docs",
             "two", 1 << 20),
            ("tagged", "rgw_tagging_on_ec_pool_fallback", "b", "k", 4096)):
        svc = rgw(await r.ns("ec", nspace=ns), chunk_size=chunk)
        out[name] = await svc.get_object(bucket, key)
    assert out["sigv4"] == blob(99_000, 6)
    assert out["multipart"] == blob(70_000, 7) + blob(30_000, 8)
    assert out["zone_b"] == blob(10_000, 15)
    assert out["tagged"] == b"data"
    return out


@after_loss
async def fs_reads_degraded(r):
    """CephFS files on the EC pool, one OSD lost, through FileSystems that
    are not mounted: a mount replays and writes the journal, and these
    reads must write nothing."""
    m = r.pkg.mds
    out = {}
    for ns, path in (("mds_data_survives_osd_kill", "/f.bin"),
                     ("mds_namespace_tree", "/home/moved.txt"),
                     ("snap_survives_crash_replay", "/d/f"),
                     ("mdsc_cross_rename_replay_touches_only_own_dirfrags",
                      "/b/dst")):
        fs = m.FileSystem(await r.ns("ec", nspace=ns))
        out[ns] = await fs.read_file(path)
    fs = m.FileSystem(await r.ns("ec", nspace="snap_survives_crash_replay"))
    out["snapshot"] = await fs.read_snap_file("/d", "s", "f")
    assert out["mds_data_survives_osd_kill"] == blob(80_000, 12)
    assert out["mds_namespace_tree"] == b"hello fs"
    assert out["snap_survives_crash_replay"] == b"new"
    assert out["snapshot"] == b"old"
    assert out["mdsc_cross_rename_replay_touches_only_own_dirfrags"] == b"v2"
    return out


# -- the run ------------------------------------------------------------------

CASE_INDEX = {name: i for i, name in enumerate(
    [*CASES, *SERIAL_CASES, *LOSS_CASES])}


class Run:
    """One package's cluster, handles and pools."""

    def __init__(self, prefix, tmp, mp):
        self.pkg = package(prefix)
        self.tmp = tmp
        self.profile = PROFILES[prefix]
        self.conf = dict(CONF, **({"osd_ec_device": "cpu"}
                                  if prefix == PORT else {}))
        clock = PinnedClock()
        for mod, tag in ((self.pkg.rgw, 0x5a1e), (self.pkg.mds, 0xf11e)):
            mp.setattr(mod, "uuid", PinnedIds(tag))
            mp.setattr(mod, "time", clock)
        mp.setattr(self.pkg.cls, "time", clock)
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
        for pool in POOLS[1:]:
            await self.rados.pool_create(pool, pool_type="replicated")

    async def ns(self, pool, suffix="", nspace=None):
        """A fresh ioctx on `pool` in the running case's namespace (plus
        `suffix`), or in `nspace`."""
        ioctx = await self.rados.open_ioctx(pool)
        ioctx.set_namespace(nspace if nspace is not None
                            else CASE.get() + suffix)
        return ioctx

    async def run_case(self, name, fn):
        CASE.set(name)
        try:
            self.records[name] = await fn(self)
        except Exception as e:  # recorded; the case's test fails on it
            self.records[name] = ("error", type(e).__name__, str(e))

    async def run_cases(self, cases, together):
        if together:
            await asyncio.gather(*(asyncio.create_task(self.run_case(n, fn))
                                   for n, fn in cases.items()))
        else:
            for name, fn in cases.items():
                await asyncio.create_task(self.run_case(name, fn))

    async def dump_pools(self):
        """{pool: {(namespace, name): bytes}} of every object in every
        pool."""
        c, t = self.rados._client, self.pkg.types
        out = {}
        for pool in POOLS:
            ioctx = await self.rados.open_ioctx(pool)
            ioctx.set_namespace(t.ALL_NSPACES)
            objs = {}
            for wire in sorted(await ioctx.list_objects()):
                objs[t.split_ns(wire)] = await c.get(ioctx.pool_id, wire)
            out[pool] = objs
        return out

    async def read_back(self, objs, pool):
        """{(namespace, name): bytes} of `objs`' keys, read again.  Each
        read is retried while the OSD answers -EAGAIN (a PG still peering
        after the loss tells its client to retry)."""
        c, t = self.rados._client, self.pkg.types
        pool_id = (await self.rados.open_ioctx(pool)).pool_id
        out = {}
        for key in objs:
            for attempt in range(50):
                try:
                    out[key] = await c.get(pool_id, t.make_oid(*key))
                    break
                except self.pkg.RadosError as e:
                    if e.code != -errno.EAGAIN or attempt == 49:
                        raise
                    await asyncio.sleep(0.1)
        return out

    async def lose_an_osd(self):
        victim = sorted(self.cluster.osds)[0]
        await self.cluster.kill_osd(victim)
        await self.rados._client.mark_osd_down(victim)
        await self.rados._client.refresh_map()

    async def stop(self):
        await self.rados.shutdown()
        await self.cluster.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' records and pool contents, before and after the
    loss: {"ref": ..., "port": ..., "state": {...}, "port_stats": ...}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_osd, "_BATCH_QUEUE", None)
        mp.setattr(port_osd, "_PLANAR_STORE", None)
        ref = Run(REF, tmp_path_factory.mktemp("ref"), mp)
        port = Run(PORT, tmp_path_factory.mktemp("port"), mp)

        async def go():
            try:
                state = {}
                for r in (ref, port):
                    await r.start()
                    await r.run_cases(CASES, together=True)
                    await r.run_cases(SERIAL_CASES, together=False)
                    state[r.pkg.prefix] = await r.dump_pools()
                for r in (ref, port):
                    await r.lose_an_osd()
                    state[r.pkg.prefix + ".degraded"] = await r.read_back(
                        state[r.pkg.prefix]["ec"], "ec")
                    await r.run_cases(LOSS_CASES, together=False)
                stats = {"queue_submits": port_osd._BATCH_QUEUE.submits,
                         "store_hits": port_osd._PLANAR_STORE.hits}
                return {"ref": ref.records, "port": port.records,
                        "state": state, "port_stats": stats}
            finally:
                for r in (port, ref):
                    if hasattr(r, "rados"):
                        await r.stop()

        try:
            return asyncio.run(asyncio.wait_for(go(), 240))
        finally:
            if port_osd._BATCH_QUEUE is not None:
                port_osd._BATCH_QUEUE.close()


@pytest.mark.parametrize("name", [*CASES, *SERIAL_CASES, *LOSS_CASES])
def test_case_matches_reference(runs, name):
    ref, port = runs["ref"][name], runs["port"][name]
    for pkg, got in ((REF, ref), (PORT, port)):
        assert not (isinstance(got, tuple) and got[:1] == ("error",)), \
            f"{pkg}: {got}"
    assert port == ref


# The one object whose bytes the script does not decide: two gateways of
# rgw_concurrent_index_puts_all_land rewrite the whole datalog object under
# locks of their own, so which racing append survives is the race's outcome.
RACED = {"rep": {("rgw_concurrent_index_puts_all_land", ".rgw.datalog")}}


@pytest.mark.parametrize("pool", POOLS)
def test_pools_hold_the_same_objects(runs, pool):
    """After the script both packages' pools list the same (namespace,
    name) objects with the same bytes: bucket indexes, manifests, users,
    datalogs, MDLog segments, dirfrags, snap tables, stripe objects."""
    ref, port = runs["state"][REF][pool], runs["state"][PORT][pool]
    assert ref, f"{pool}: no objects"
    only = (sorted(set(ref) - set(port)), sorted(set(port) - set(ref)))
    assert only == ([], []), f"{pool}: only in {REF}, only in {PORT}: {only}"
    for key in RACED.get(pool, ()):
        assert json.loads(port[key])["log"] and json.loads(ref[key])["log"]
    differ = sorted(k for k in ref if port[k] != ref[k]
                    and k not in RACED.get(pool, ()))
    assert not differ, f"{pool}: {len(differ)} objects differ: {differ[:8]}"


@pytest.mark.parametrize("pkg", [REF, PORT])
def test_ec_objects_read_the_same_degraded(runs, pkg):
    """Every object of the EC pool reads back, one OSD lost, with the
    bytes it held before (the loss cases added none)."""
    assert runs["state"][pkg + ".degraded"] == runs["state"][pkg]["ec"]


def test_port_ec_traffic_went_through_its_queue_and_store(runs):
    assert runs["port_stats"]["queue_submits"] > 0
    assert runs["port_stats"]["store_hits"] > 0
