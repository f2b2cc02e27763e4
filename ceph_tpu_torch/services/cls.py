# Copy of ceph_tpu/services/cls.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""In-OSD object classes (reference src/cls/ + src/osd/ClassHandler.cc).

A class is a named bundle of methods executed ON the OSD against an
object: ``method(hctx, input) -> (retcode, output)`` where hctx exposes
read/write/xattr access to the target object.  The registry mirrors the
reference's dlopen ClassHandler: classes register at import; the OSD looks
them up at `op=call` dispatch.  EC pools return -EOPNOTSUPP exactly as the
reference does (doc/dev/osd_internals/erasure_coding/ecbackend.rst
"Object Classes") — class methods read/modify objects in place, which the
EC write path cannot do server-side.

Shipped classes mirror the most-used reference ones in miniature:
- ``lock``: advisory lock (cls_lock role) stored in an xattr
- ``refcount``: get/put a reference counter (cls_refcount role)
- ``version``: object version stamp (cls_version role)
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional, Tuple

ENOTSUP = -95
ENOENT = -2
EBUSY = -16


class ClsContext:
    """Handle the OSD passes to a class method (cls_method_context role)."""

    def __init__(self, data: Optional[bytes], xattrs: Dict[str, bytes]):
        self.data = data  # None: object absent
        self.xattrs = xattrs
        self.data_dirty = False
        self.xattrs_dirty = False

    def read(self) -> Optional[bytes]:
        return self.data

    def write(self, data: bytes) -> None:
        self.data = data
        self.data_dirty = True

    def getxattr(self, name: str) -> Optional[bytes]:
        return self.xattrs.get(name)

    def setxattr(self, name: str, value: bytes) -> None:
        self.xattrs[name] = value
        self.xattrs_dirty = True


Method = Callable[[ClsContext, bytes], Tuple[int, bytes]]


class ClassRegistry:
    def __init__(self):
        self._classes: Dict[str, Dict[str, Method]] = {}

    def register(self, cls_name: str, method: str, fn: Method) -> None:
        self._classes.setdefault(cls_name, {})[method] = fn

    def get(self, cls_name: str, method: str) -> Optional[Method]:
        return self._classes.get(cls_name, {}).get(method)

    def classes(self) -> Dict[str, list]:
        return {c: sorted(m) for c, m in self._classes.items()}


registry = ClassRegistry()


def cls_method(cls_name: str, method: str):
    def deco(fn: Method) -> Method:
        registry.register(cls_name, method, fn)
        return fn

    return deco


# -- shipped classes ---------------------------------------------------------


@cls_method("lock", "lock")
def _lock_acquire(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    req = json.loads(inp or b"{}")
    owner = req.get("owner", "")
    ttl = float(req.get("ttl", 30.0))
    raw = hctx.getxattr("lock.state")
    if raw:
        st = json.loads(raw)
        if (st.get("owner") and st["owner"] != owner
                and st.get("expires", 0) > time.time()):
            return EBUSY, json.dumps(st).encode()
    hctx.setxattr("lock.state", json.dumps(
        {"owner": owner, "expires": time.time() + ttl}).encode())
    return 0, b""


@cls_method("lock", "unlock")
def _lock_release(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    req = json.loads(inp or b"{}")
    raw = hctx.getxattr("lock.state")
    st = json.loads(raw) if raw else {}
    if not st.get("owner"):
        return ENOENT, b""
    if st["owner"] != req.get("owner", ""):
        return EBUSY, json.dumps(st).encode()
    hctx.setxattr("lock.state", b"{}")
    return 0, b""


@cls_method("lock", "info")
def _lock_info(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    return 0, hctx.getxattr("lock.state") or b"{}"


@cls_method("refcount", "get")
def _ref_get(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    n = int(hctx.getxattr("refcount") or b"0") + 1
    hctx.setxattr("refcount", str(n).encode())
    return 0, str(n).encode()


@cls_method("refcount", "put")
def _ref_put(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    n = max(0, int(hctx.getxattr("refcount") or b"0") - 1)
    hctx.setxattr("refcount", str(n).encode())
    return 0, str(n).encode()


@cls_method("version", "set")
def _ver_set(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    hctx.setxattr("cls.version", inp)
    return 0, b""


@cls_method("version", "get")
def _ver_get(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    v = hctx.getxattr("cls.version")
    if v is None:
        return ENOENT, b""
    return 0, v


EEXIST = -17
EINVAL = -22


def _json_or(default, raw):
    try:
        return json.loads(raw) if raw else default
    except (ValueError, TypeError):
        return default


# -- cls_rbd (reference src/cls/rbd/cls_rbd.cc) ------------------------------
#
# RBD header operations executed IN the OSD against the rbd_header object:
# each call is one atomic read-mutate-write under the PG's op
# serialization, so concurrent clients cannot lose header updates the way
# client-side read-modify-write races do (VERDICT r03 #5).  The header is
# the service's JSON record; methods mirror the reference's create /
# snapshot_add / snapshot_remove / set_protection_status /
# object_map_update family.


@cls_method("rbd", "create")
def _rbd_create(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    if hctx.read():
        return EEXIST, b""
    req = _json_or(None, inp)
    if not isinstance(req, dict) or "header" not in req:
        return EINVAL, b""
    hctx.write(json.dumps(req["header"]).encode())
    return 0, b""


@cls_method("rbd", "get")
def _rbd_get(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    return 0, bytes(raw)


@cls_method("rbd", "snap_create")
def _rbd_snap_create(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    hdr = _json_or(None, raw)
    req = _json_or({}, inp)
    name, snap_id = req.get("name"), req.get("snap_id")
    if hdr is None or not name or snap_id is None:
        return EINVAL, b""
    snaps = hdr.setdefault("snaps", {})
    if name in snaps:
        return EEXIST, b""
    snaps[name] = {"id": snap_id, "size": hdr["size"],
                   "object_map": list(hdr["object_map"])}
    hctx.write(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rbd", "snap_remove")
def _rbd_snap_remove(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    hdr = _json_or(None, raw)
    req = _json_or({}, inp)
    name = req.get("name")
    if hdr is None or not name:
        return EINVAL, b""
    snap = hdr.get("snaps", {}).get(name)
    if snap is None:
        return ENOENT, b""
    if snap.get("protected"):
        return EBUSY, b""
    hdr["snaps"].pop(name)
    hctx.write(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rbd", "set_protection")
def _rbd_set_protection(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    hdr = _json_or(None, raw)
    req = _json_or({}, inp)
    name = req.get("name")
    if hdr is None or not name:
        return EINVAL, b""
    snap = hdr.get("snaps", {}).get(name)
    if snap is None:
        return ENOENT, b""
    snap["protected"] = bool(req.get("protected"))
    hctx.write(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rbd", "merge_object_map")
def _rbd_merge_object_map(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    """Atomic object-map union (reference object_map_update role): the
    client-side read-modify-write of the whole header LOSES blocks when
    two writers race; this merge cannot."""
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    hdr = _json_or(None, raw)
    req = _json_or({}, inp)
    if hdr is None:
        return EINVAL, b""
    objmap = set(hdr.get("object_map", []))
    objmap.update(int(i) for i in req.get("add", ()))
    for i in req.get("remove", ()):
        objmap.discard(int(i))
    hdr["object_map"] = sorted(objmap)
    hctx.write(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rbd", "set_header")
def _rbd_set_header(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    """Header update for image ops (resize, parent link/unlink, journal
    fields).  NOT a blind replace: the stored object_map and snaps are
    MERGED into the provided header (minus an explicit drop_blocks
    list), so a client whose cached header predates a concurrent
    writer's merge_object_map or snap_create cannot silently discard
    those updates.  Returns the merged header for the caller to adopt."""
    req = _json_or(None, inp)
    if not isinstance(req, dict) or "header" not in req:
        return EINVAL, b""
    raw = hctx.read()
    if not raw:
        return ENOENT, b""
    stored = _json_or({}, raw)
    hdr = req["header"]
    om = set(stored.get("object_map", [])) | set(hdr.get("object_map", []))
    om -= {int(i) for i in req.get("drop_blocks", ())}
    hdr["object_map"] = sorted(om)
    # snaps present only in the store survive (snap removal goes through
    # snap_remove, never through a header push); for names in both, the
    # STORED entry wins (protection flips land via set_protection)
    merged_snaps = dict(hdr.get("snaps", {}))
    merged_snaps.update(stored.get("snaps", {}))
    if merged_snaps:
        hdr["snaps"] = merged_snaps
    blob = json.dumps(hdr).encode()
    hctx.write(blob)
    return 0, blob


# -- cls_rgw (reference src/cls/rgw/cls_rgw.cc) ------------------------------
#
# Bucket-index mutation executed IN the OSD against the index object: the
# reference's bucket index is a cls-maintained omap precisely so that
# concurrent gateways update it atomically; the client-side
# _load_index/_save_index read-modify-write this replaces loses entries
# under racing PUTs.


@cls_method("rgw", "bucket_init")
def _rgw_bucket_init(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    if hctx.read():
        return EEXIST, b""
    hctx.write(b"{}")
    return 0, b""


@cls_method("rgw", "index_put")
def _rgw_index_put(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""  # NoSuchBucket
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    key = req.get("key")
    if not key:
        return EINVAL, b""
    prev = index.get(key)
    index[key] = req.get("meta", {})
    hctx.write(json.dumps(index).encode())
    return 0, json.dumps({"prev": prev}).encode()


@cls_method("rgw", "index_rm")
def _rgw_index_rm(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    key = req.get("key")
    if not key:
        return EINVAL, b""
    prev = index.pop(key, None)
    if prev is None:
        return ENOENT, b""
    hctx.write(json.dumps(index).encode())
    return 0, json.dumps({"prev": prev}).encode()


@cls_method("rgw", "index_set_tags")
def _rgw_index_set_tags(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    """Object tagging rides the bucket index entry (reference
    cls_rgw + rgw_tag.cc: tags live in the object's index/attrs, not
    the data): set, or clear with tags=None."""
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    key = req.get("key")
    if not key or key not in index:
        return ENOENT, b""
    entry = index[key]
    tags = req.get("tags")
    if tags is None:
        entry.pop("tags", None)
    else:
        if not isinstance(tags, dict) or len(tags) > 10:
            return EINVAL, b""  # S3 caps object tag sets at 10
        entry["tags"] = tags
    hctx.write(json.dumps(index).encode())
    return 0, b""


@cls_method("rgw", "index_list")
def _rgw_index_list(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    after = req.get("after", "")
    limit = int(req.get("max", 0)) or len(index)
    keys = sorted(k for k in index if k > after)[:limit]
    return 0, json.dumps({k: index[k] for k in keys}).encode()


@cls_method("rgw", "registry_add")
def _rgw_registry_add(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    """Atomic bucket-registry append (the buckets root object)."""
    req = _json_or({}, inp)
    bucket = req.get("bucket")
    if not bucket:
        return EINVAL, b""
    buckets = _json_or([], hctx.read() or b"[]")
    if bucket not in buckets:
        buckets.append(bucket)
        hctx.write(json.dumps(sorted(buckets)).encode())
    return 0, b""


@cls_method("rgw", "registry_rm")
def _rgw_registry_rm(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    req = _json_or({}, inp)
    bucket = req.get("bucket")
    if not bucket:
        return EINVAL, b""
    buckets = _json_or([], hctx.read() or b"[]")
    if bucket in buckets:
        buckets.remove(bucket)
        hctx.write(json.dumps(buckets).encode())
    return 0, b""


@cls_method("rgw", "index_put_version")
def _rgw_index_put_version(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    """Append one object VERSION to an index entry atomically (reference
    cls_rgw versioned-bucket index ops): the entry keeps its full
    version stack plus derived newest-live size/etag for flat readers."""
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    key, ver = req.get("key"), req.get("version")
    if not key or not isinstance(ver, dict):
        return EINVAL, b""
    entry = index.get(key)
    if not isinstance(entry, dict) or "versions" not in entry:
        entry = {"versions": ([] if entry is None else
                              [dict(entry, vid="null",
                                    ts=entry.get("ts", 0))])}
    entry["versions"].append(ver)
    cur = entry["versions"][-1]
    cur = None if cur.get("delete_marker") else cur
    entry["size"] = cur.get("size", 0) if cur else 0
    entry["etag"] = cur.get("etag", "") if cur else ""
    index[key] = entry
    hctx.write(json.dumps(index).encode())
    return 0, json.dumps(entry).encode()


@cls_method("rgw", "index_rm_version")
def _rgw_index_rm_version(hctx: ClsContext, inp: bytes) -> Tuple[int, bytes]:
    raw = hctx.read()
    if raw is None:
        return ENOENT, b""
    index = _json_or({}, raw)
    req = _json_or({}, inp)
    key, vid = req.get("key"), req.get("vid")
    entry = index.get(key)
    if not key or not vid or not isinstance(entry, dict) \
            or "versions" not in entry:
        return ENOENT, b""
    removed = [v for v in entry["versions"] if v.get("vid") == vid]
    if not removed:
        return ENOENT, b""
    entry["versions"] = [v for v in entry["versions"]
                         if v.get("vid") != vid]
    if entry["versions"]:
        cur = entry["versions"][-1]
        cur = None if cur.get("delete_marker") else cur
        entry["size"] = cur.get("size", 0) if cur else 0
        entry["etag"] = cur.get("etag", "") if cur else ""
        index[key] = entry
    else:
        index.pop(key)
    hctx.write(json.dumps(index).encode())
    return 0, json.dumps({"removed": removed[0]}).encode()
