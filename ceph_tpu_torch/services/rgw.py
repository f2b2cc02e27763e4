# Copy of ceph_tpu/services/rgw.py at commit ac6dced, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""RGW-lite: S3-style object gateway over RADOS.

Role-equivalent of the reference's RGW core request path (reference
src/rgw/): an asyncio HTTP frontend (the beast frontend role) maps
S3-shaped requests onto RADOS — buckets are index objects, object data is
striped over RADOS objects (rgw_max_chunk_size-style chunking via the
striper), and listings come from the bucket index, not pool scans, exactly
the reference's bucket-index discipline.

Multipart uploads (reference rgw_multipart): POST ?uploads opens an
upload, PUT ?uploadId=..&partNumber=N stores each part as its own striped
object, complete-POST records a MANIFEST in the bucket index (the
reference's RGWObjManifest role) that GET stitches back in part order —
parts are never rewritten into one blob.  Abort deletes the parts.

Auth (reference rgw_auth + AWS SigV4): when the service is constructed
with credentials, every request must carry an AWS4-HMAC-SHA256
Authorization header whose signature verifies over the canonical request
(method, path, signed headers, payload hash) with the standard SigV4
signing-key chain (date -> region -> service -> aws4_request).  Unsigned
requests get 403.  Without configured credentials the gateway stays open
(the reference's anonymous/system mode), so embedded uses need no keys.

API subset: PUT /b (create bucket), GET / (list buckets), PUT /b/k,
GET /b/k, DELETE /b/k (and bucket), GET /b (list objects), HEAD /b/k,
POST /b/k?uploads, PUT /b/k?uploadId&partNumber, POST /b/k?uploadId
(complete), DELETE /b/k?uploadId (abort) — plus the Swift dialect
(tempauth /auth/v1.0, /v1/AUTH_<acct>/container/object routes,
reference rgw_rest_swift.h).

Multisite (reference src/rgw/driver/rados/rgw_sync.cc): every mutation
appends to the zone's bounded data log; a ZoneSyncAgent replays another
zone's log resumably — full image sync (including deletions) when first
contacted or when trimmed past its position, incremental tail after.
Replicated applies suppress the destination's own datalog so
active-active pairs do not echo.

Data management (reference src/rgw/rgw_lc.cc, rgw_acl.cc): per-bucket
VERSIONING (every put appends a version; deletes add delete markers;
gets resolve the newest live version or an explicit versionId),
LIFECYCLE expiration rules swept by lifecycle_tick (prefix + age; the
mgr/embedder drives the tick, injectable clock), and bucket ACLs
(owner + grants, canned private/public-read) enforced by the HTTP
frontend's principal resolution.
"""

from __future__ import annotations

import asyncio
import contextvars
import errno
import hashlib
import hmac
import json
import re
import time
import uuid
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, quote, unquote, urlsplit

from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.rados.librados import IoCtx
from ceph_tpu_torch.rados.striper import RadosStriper

BUCKETS_ROOT = ".rgw.buckets"  # registry of buckets

# Task-scoped datalog suppression: set while a ZoneSyncAgent task APPLIES
# replicated mutations, so they do not re-enter the destination's datalog
# (active-active echo).  A contextvar — NOT a service attribute — so a
# concurrent local client mutation on the same gateway in another task
# still logs; a service-wide flag would silently skip its _log_mutation
# and leave a permanent replication gap.
_DATALOG_SUPPRESS: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "rgw_datalog_suppress", default=False)


class RgwService:
    """Bucket/object operations (usable directly or via the HTTP frontend)."""

    def __init__(self, ioctx: IoCtx, chunk_size: int = 1 << 20,
                 credentials: Optional[Dict[str, str]] = None):
        self.ioctx = ioctx
        self.striper = RadosStriper(ioctx, object_size=chunk_size)
        # access_key -> secret_key; empty = anonymous gateway.  The
        # ctor dict seeds static credentials; managed users (RgwAdmin)
        # are merged in by load_users().
        self.credentials = dict(credentials or {})
        self._static_credentials = dict(credentials or {})
        self.users: Dict[str, Dict] = {}  # uid -> user record
        self._users_loaded_at = 0.0
        # user-record staleness bound on a RUNNING gateway: admin
        # changes from another process (suspend, quota enable) take
        # effect within this window without a restart
        self.users_refresh_ttl = 2.0
        # usage figures are cached per principal/bucket for this long:
        # quota enforcement is deliberately approximate within the
        # window (the reference's RGWQuotaCache makes the same trade)
        self.usage_cache_ttl = 2.0
        self._usage_cache: Dict[str, Tuple[float, Dict[str, int]]] = {}
        self._bucket_usage_cache: Dict[str, Tuple[float,
                                                  Tuple[int, int]]] = {}
        self._owner_cache: Dict[str, Optional[str]] = {}  # bucket -> owner
        self._uploads_lock = asyncio.Lock()

    # -- users / quotas (reference rgw_user.cc, RGWQuotaHandler) -------------

    USERS_OID = ".rgw.users"

    async def load_users(self) -> None:
        """Load the persisted user store and rebuild the credential
        map (static ctor credentials + every active managed user)."""
        try:
            self.users = json.loads(await self.ioctx.read(self.USERS_OID))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            self.users = {}
        creds = dict(self._static_credentials)
        for u in self.users.values():
            creds[u["access_key"]] = u["secret_key"]
        self.credentials = creds
        self._users_loaded_at = time.monotonic()

    async def maybe_reload_users(self) -> None:
        """TTL-bounded refresh of the user store, so a live gateway
        honors out-of-process admin changes (suspend/quota) without a
        restart."""
        if time.monotonic() - self._users_loaded_at > self.users_refresh_ttl:
            await self.load_users()

    def user_by_access(self, access_key: Optional[str]) -> Optional[Dict]:
        if access_key is None:
            return None
        for u in self.users.values():
            if u.get("access_key") == access_key:
                return u
        return None

    def _invalidate_usage(self, bucket: str) -> None:
        """Drop the usage figures a mutation on `bucket` staled: the
        bucket's own entry, and the owning principal's aggregate (owner
        known from the meta-read cache; unknown owner falls back to a
        full clear, the safe direction)."""
        self._bucket_usage_cache.pop(bucket, None)
        owner = self._owner_cache.get(bucket)
        if owner is not None:
            self._usage_cache.pop(owner, None)
        else:
            self._usage_cache.clear()

    async def bucket_usage(self, bucket: str,
                           use_cache: bool = False) -> Tuple[int, int]:
        """(bytes, objects) currently indexed in the bucket — versions
        and multipart manifests count every stored generation, and
        STAGED multipart parts count toward bytes (or a capped user
        could park unbounded data in never-completed uploads)."""
        if use_cache:
            hit = self._bucket_usage_cache.get(bucket)
            if hit and time.monotonic() - hit[0] < self.usage_cache_ttl:
                return hit[1]
        index = await self._load_index(bucket)
        size = objects = 0
        for entry in (index or {}).values():
            if isinstance(entry, dict) and "versions" in entry:
                live = [v for v in entry["versions"]
                        if not v.get("delete_marker")]
                size += sum(int(v.get("size", 0)) for v in live)
                objects += 1 if live else 0
            elif isinstance(entry, dict):
                size += int(entry.get("size", 0))
                objects += 1
        for upload_id in await self._uploads_registry(bucket):
            try:
                up = await self._load_upload(bucket, upload_id)
            except RadosError:
                continue  # completed/aborted since the registry read
            size += sum(int(p.get("size", 0))
                        for p in up.get("parts", {}).values())
        self._bucket_usage_cache[bucket] = (time.monotonic(),
                                            (size, objects))
        while len(self._bucket_usage_cache) > 4096:
            self._bucket_usage_cache.pop(
                next(iter(self._bucket_usage_cache)))
        return size, objects

    async def usage(self, access_key: str,
                    use_cache: bool = False) -> Dict[str, int]:
        """Aggregate usage over every bucket the principal owns
        (radosgw-admin usage role)."""
        if use_cache:
            hit = self._usage_cache.get(access_key)
            if hit and time.monotonic() - hit[0] < self.usage_cache_ttl:
                return hit[1]
        total_size = total_objects = buckets = 0
        for bucket in await self.list_buckets(strict=True):
            meta = await self.get_bucket_meta(bucket)
            if meta.get("owner") != access_key:
                continue
            s, o = await self.bucket_usage(bucket, use_cache=use_cache)
            total_size += s
            total_objects += o
            buckets += 1
        out = {"size": total_size, "objects": total_objects,
               "buckets": buckets}
        self._usage_cache[access_key] = (time.monotonic(), out)
        while len(self._usage_cache) > 4096:
            self._usage_cache.pop(next(iter(self._usage_cache)))
        return out

    @staticmethod
    def _quota_violated(quota: Optional[Dict], size: int, objects: int,
                        add_bytes: int, add_objects: int) -> bool:
        if not quota or not quota.get("enabled"):
            return False
        max_size = int(quota.get("max_size", -1))
        max_objects = int(quota.get("max_objects", -1))
        if max_size >= 0 and size + add_bytes > max_size:
            return True
        if max_objects >= 0 and objects + add_objects > max_objects:
            return True
        return False

    async def check_quota(self, access_key: Optional[str], bucket: str,
                          add_bytes: int, add_objects: int = 1) -> None:
        """Raise QuotaExceeded (EDQUOT) if the write would break the
        principal's user quota or the bucket quota (reference
        RGWQuotaHandler::check_quota, consulted pre-exec)."""
        user = self.user_by_access(access_key)
        if user is None:
            return
        bq = user.get("bucket_quota")
        uq = user.get("quota")
        if bq and bq.get("enabled"):
            s, o = await self.bucket_usage(bucket, use_cache=True)
            if self._quota_violated(bq, s, o, add_bytes, add_objects):
                raise RadosError("QuotaExceeded: bucket quota",
                                 code=-errno.EDQUOT)
        if uq and uq.get("enabled"):
            u = await self.usage(access_key, use_cache=True)
            if self._quota_violated(uq, u["size"], u["objects"],
                                    add_bytes, add_objects):
                raise RadosError("QuotaExceeded: user quota",
                                 code=-errno.EDQUOT)

    @staticmethod
    def _index_oid(bucket: str) -> str:
        return f".bucket.index.{bucket}"

    # -- data log (multisite source side; reference datalog/bilog) ----------

    async def datalog_state(self) -> Dict:
        """One read: {"log": [...], "trimmed": floor} — callers must not
        stitch log and floor from two reads (a trim in between would
        force a spurious full re-sync)."""
        try:
            return json.loads(await self.ioctx.read(".rgw.datalog"))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            return {"log": [], "trimmed": 0}

    async def _log_mutation(self, op: str, bucket: str,
                            key: Optional[str] = None) -> None:
        """Append one mutation to the zone's data log (bounded: agents
        whose position predates the trim floor run a full re-sync).
        Serialized — the append is a read-modify-write of one object,
        and a lost entry is a silent replication gap.  Suppressed while
        a sync agent is APPLYING replicated mutations, so active-active
        topologies do not echo entries back and forth forever.  The
        whole-object rewrite is O(window) per mutation; the reference
        shards its datalog — acceptable at this gateway's scale, noted
        as the next step if the log becomes hot."""
        # any mutation invalidates the usage caches FIRST (before the
        # sync-agent suppression — replicated applies change usage too),
        # so this gateway's own quota checks never see their own writes
        # stale; cross-gateway writes are bounded by usage_cache_ttl
        self._invalidate_usage(bucket)
        if _DATALOG_SUPPRESS.get():
            return
        lock = getattr(self, "_datalog_lock", None)
        if lock is None:
            lock = self._datalog_lock = asyncio.Lock()
        async with lock:
            d = await self.datalog_state()
            seq = (d["log"][-1]["seq"] + 1) if d["log"] else d["trimmed"] + 1
            d["log"].append({"seq": seq, "op": op, "bucket": bucket,
                             "key": key})
            while len(d["log"]) > 4096:
                d["trimmed"] = d["log"].pop(0)["seq"]
            await self.ioctx.write_full(".rgw.datalog",
                                        json.dumps(d).encode())

    async def _load_index(self, bucket: str) -> Optional[Dict[str, Dict]]:
        try:
            return json.loads(await self.ioctx.read(self._index_oid(bucket)))
        except RadosError as e:
            # None means the bucket verifiably does not exist (-ENOENT).
            # A transient failure (-EAGAIN shard unavailability, timeout
            # exhaustion) must surface as an error — mapping it to None
            # would 404 a bucket that exists (NoSuchBucket vs 503).
            if e.code == -errno.ENOENT:
                return None
            raise

    async def _save_index(self, bucket: str, index: Dict[str, Dict]) -> None:
        await self.ioctx.write_full(self._index_oid(bucket),
                                    json.dumps(index).encode())

    async def _idx_cls(self, bucket: str, method: str, payload: Dict):
        """Bucket-index mutation as a single in-OSD class call
        (reference cls_rgw, src/cls/rgw/cls_rgw.cc: the index is
        cls-maintained precisely so concurrent gateways update it
        atomically).  Returns (ret, out), or None on an EC pool — where
        class calls answer EOPNOTSUPP per reference semantics — so
        callers fall back to the client-side read-modify-write (which is
        then the ONLY writer path and keeps its existing behavior)."""
        try:
            return await self.ioctx.execute(
                self._index_oid(bucket), "rgw", method,
                json.dumps(payload).encode())
        except RadosError as e:
            if e.code == -errno.EOPNOTSUPP:
                return None
            raise

    # -- bucket metadata: versioning / lifecycle / ACL ----------------------
    #
    # Stored beside the index (rare admin writes: client-side RMW is the
    # single-writer admin path, like the reference's bucket-info cache).

    @staticmethod
    def _meta_oid(bucket: str) -> str:
        return f".bucket.meta.{bucket}"

    async def get_bucket_meta(self, bucket: str) -> Dict:
        try:
            meta = json.loads(await self.ioctx.read(self._meta_oid(bucket)))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            meta = {"versioning": False, "lifecycle": [], "acl": None}
        self._owner_cache[bucket] = meta.get("owner")
        while len(self._owner_cache) > 8192:
            self._owner_cache.pop(next(iter(self._owner_cache)))
        return meta

    async def _save_bucket_meta(self, bucket: str, meta: Dict) -> None:
        await self.ioctx.write_full(self._meta_oid(bucket),
                                    json.dumps(meta).encode())
        self._owner_cache[bucket] = meta.get("owner")

    async def set_versioning(self, bucket: str, enabled: bool) -> None:
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        meta = await self.get_bucket_meta(bucket)
        meta["versioning"] = bool(enabled)
        await self._save_bucket_meta(bucket, meta)

    async def put_lifecycle(self, bucket: str, rules: List[Dict]) -> None:
        """rules: [{"prefix": str, "days": N}, ...] — objects whose key
        matches prefix and whose age exceeds N days expire on the next
        lifecycle_tick (reference RGWLC rule model in miniature)."""
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        for rule in rules:
            try:
                float(rule["days"])
            except (KeyError, TypeError, ValueError):
                raise RadosError("MalformedXML: lifecycle rule needs "
                                 "numeric days", code=-errno.EINVAL) from None
        meta = await self.get_bucket_meta(bucket)
        meta["lifecycle"] = list(rules)
        await self._save_bucket_meta(bucket, meta)

    async def put_bucket_acl(self, bucket: str, acl: Dict) -> None:
        """acl: {"owner": access_key, "grants": [{"grantee": "*"|key,
        "perm": "READ"|"WRITE"|"FULL_CONTROL"}]} (canned "private" =
        owner-only, "public-read" = owner + {"*": READ})."""
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        meta = await self.get_bucket_meta(bucket)
        meta["acl"] = acl
        await self._save_bucket_meta(bucket, meta)

    # -- bucket policy (reference src/rgw/rgw_iam_policy.cc) ------------------

    async def put_bucket_policy(self, bucket: str, policy: Dict) -> None:
        """S3-style policy document: {"Version": ..., "Statement":
        [{"Effect": "Allow"|"Deny", "Principal": "*"|key|{"AWS": [...]},
        "Action": "s3:GetObject"|[...], "Resource": arn|[...]}]}.
        Statements support trailing-* wildcards in Action and Resource
        exactly like the reference's IAM matcher."""
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        for stmt in policy.get("Statement", ()):
            if stmt.get("Effect") not in ("Allow", "Deny"):
                raise RadosError("MalformedPolicy: bad Effect",
                                 code=-errno.EINVAL)
        meta = await self.get_bucket_meta(bucket)
        meta["policy"] = policy
        await self._save_bucket_meta(bucket, meta)

    async def delete_bucket_policy(self, bucket: str) -> None:
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        meta = await self.get_bucket_meta(bucket)
        meta["policy"] = None
        await self._save_bucket_meta(bucket, meta)

    @staticmethod
    def _iam_match(pattern: str, value: str) -> bool:
        if pattern.endswith("*"):
            return value.startswith(pattern[:-1])
        return pattern == value

    @staticmethod
    def policy_eval(policy: Optional[Dict], principal: Optional[str],
                    action: str, resource: str) -> Optional[str]:
        """Evaluate the bucket policy for (principal, action, resource):
        returns "Deny" (explicit deny — overrides everything), "Allow"
        (explicit allow), or None (no statement matched — the caller
        falls through to the ACL, the reference's PASS verdict)."""
        if not policy:
            return None
        verdict: Optional[str] = None
        for stmt in policy.get("Statement", ()):
            pr = stmt.get("Principal", "*")
            if isinstance(pr, dict):
                pr = pr.get("AWS", [])
            principals = [pr] if isinstance(pr, str) else list(pr)
            if "*" not in principals and principal not in principals:
                continue
            actions = stmt.get("Action", [])
            if isinstance(actions, str):
                actions = [actions]
            if not any(RgwService._iam_match(a, action) for a in actions):
                continue
            resources = stmt.get("Resource", [])
            if isinstance(resources, str):
                resources = [resources]
            if resources and not any(RgwService._iam_match(r, resource)
                                     for r in resources):
                continue
            if stmt.get("Effect") == "Deny":
                return "Deny"  # deny-overrides: stop immediately
            verdict = "Allow"
        return verdict

    @staticmethod
    def acl_allows(acl: Optional[Dict], principal: Optional[str],
                   need: str) -> bool:
        """ACL check (reference rgw_acl verify_permission): no ACL set =
        open (the gateway's anonymous/system mode keeps working); the
        owner may do anything; grants match an explicit principal or
        the public grantee "*"."""
        if not acl:
            return True
        if principal is not None and acl.get("owner") == principal:
            return True
        for g in acl.get("grants", ()):
            if g.get("grantee") not in ("*", principal):
                continue
            perm = g.get("perm", "")
            if perm == "FULL_CONTROL" or perm == need:
                return True
        return False

    async def lifecycle_tick(self, now: Optional[float] = None) -> int:
        """One expiration sweep over every bucket's lifecycle rules
        (reference RGWLC::process): expired objects are deleted through
        the normal path (so versioned buckets get delete markers and the
        datalog replicates the expiry).  The mgr/embedder drives this on
        its periodic tick; `now` is injectable for tests.  Returns the
        number of objects expired."""
        now = time.time() if now is None else now
        expired = 0
        for bucket in list(await self.list_buckets()):
            try:
                expired += await self._lifecycle_bucket(bucket, now)
            except Exception:
                # one bucket's bad state must not stop the cluster-wide
                # sweep (reference RGWLC isolates per-bucket failures)
                continue
        return expired

    async def _lifecycle_bucket(self, bucket: str, now: float) -> int:
        meta = await self.get_bucket_meta(bucket)
        rules = meta.get("lifecycle") or []
        if not rules:
            return 0
        index = await self._load_index(bucket)
        if not index:
            return 0
        expired = 0
        for key, entry in list(index.items()):
            ts = entry.get("ts")
            if "versions" in entry:
                vs = entry["versions"]
                if not vs or vs[-1].get("delete_marker"):
                    continue  # already expired/deleted
                ts = vs[-1].get("ts")
            if ts is None:
                # unknown age (pre-versioning or multipart entries
                # without a stamp) must NEVER expire — deleting data of
                # unknown age is silent loss, not lifecycle policy
                continue
            for rule in rules:
                if not key.startswith(rule.get("prefix", "")):
                    continue
                try:
                    days = float(rule["days"])
                except (KeyError, TypeError, ValueError):
                    continue  # malformed legacy rule: skip, not crash
                if now - ts >= days * 86400.0:
                    try:
                        await self.delete_object(bucket, key, now=now)
                        expired += 1
                    except RadosError:
                        pass
                    break
        return expired

    async def create_bucket(self, bucket: str,
                            owner: Optional[str] = None) -> None:
        created = False
        made = await self._idx_cls(bucket, "bucket_init", {})
        if made is not None:
            ret, _ = made
            if ret not in (0, -17):  # -EEXIST: already created, idempotent
                raise RadosError(f"bucket_init failed ({ret})", code=ret)
            if ret == 0:
                created = True
                try:
                    await self.ioctx.execute(
                        BUCKETS_ROOT, "rgw", "registry_add",
                        json.dumps({"bucket": bucket}).encode())
                except RadosError as e:
                    if e.code != -errno.EOPNOTSUPP:
                        raise
                await self._log_mutation("create_bucket", bucket)
        elif await self._load_index(bucket) is None:
            created = True
            await self._save_index(bucket, {})
            buckets = await self.list_buckets()
            if bucket not in buckets:
                buckets.append(bucket)
                await self.ioctx.write_full(
                    BUCKETS_ROOT, json.dumps(sorted(buckets)).encode())
            await self._log_mutation("create_bucket", bucket)
        if created and owner is not None:
            # bucket ownership (reference rgw_bucket owner field): the
            # creating principal's uid keys quota/usage accounting
            meta = await self.get_bucket_meta(bucket)
            meta["owner"] = owner
            await self._save_bucket_meta(bucket, meta)

    async def list_buckets(self, strict: bool = False) -> List[str]:
        """strict=True re-raises transient read failures instead of
        answering [] — quota enforcement must fail CLOSED, not admit
        writes because the registry was momentarily unreadable."""
        try:
            return json.loads(await self.ioctx.read(BUCKETS_ROOT))
        except RadosError as e:
            if strict and e.code != -errno.ENOENT:
                raise
            return []

    async def _drop_parts(self, entry: Dict) -> None:
        """Remove ONLY a manifest entry's part objects — never the plain
        striped object, which after a multipart->plain replace holds the
        bytes that were JUST written."""
        for p in entry.get("parts", ()):
            try:
                await self.striper.remove(p["oid"])
            except RadosError:
                pass

    async def put_object(self, bucket: str, key: str, data: bytes,
                         now: Optional[float] = None,
                         bmeta: Optional[Dict] = None) -> Optional[str]:
        # existence check BEFORE writing data: a put to a missing bucket
        # must not orphan striped objects (small TOCTOU window against a
        # concurrent bucket delete is bounded and matches the reference)
        index0 = await self._load_index(bucket)
        if index0 is None:
            raise RadosError(f"NoSuchBucket: {bucket}", code=-errno.ENOENT)
        now = time.time() if now is None else now
        if bmeta is None:
            bmeta = await self.get_bucket_meta(bucket)
        entry0 = index0.get(key)
        if bmeta.get("versioning") or (
                isinstance(entry0, dict) and "versions" in entry0):
            # versioned bucket — or a SUSPENDED bucket whose key already
            # has a version stack: history must survive suspension
            # (divergence: suspended puts append a fresh vid rather than
            # replacing the "null" version)
            return await self._put_versioned(bucket, key, data, now)
        meta = {"size": len(data), "etag": hashlib.md5(data).hexdigest(),
                "ts": now}
        await self.striper.write(f"{bucket}/{key}", data)
        got = await self._idx_cls(bucket, "index_put",
                                  {"key": key, "meta": meta})
        if got is not None:
            ret, out = got
            if ret == -2:
                raise RadosError(f"NoSuchBucket: {bucket}",
                                 code=-errno.ENOENT)
            if ret < 0:
                raise RadosError(f"index_put failed ({ret})", code=ret)
            prev = json.loads(out or b"{}").get("prev")
            if prev and "parts" in prev:
                # the replaced entry was a multipart manifest: its part
                # objects are unreferenced now (parts ONLY — the plain
                # striped object is the data just written)
                await self._drop_parts(prev)
            await self._log_mutation("put", bucket, key)
            return None
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        prev = index.get(key)
        index[key] = meta
        await self._save_index(bucket, index)
        if prev and "parts" in prev:
            await self._drop_parts(prev)
        await self._log_mutation("put", bucket, key)
        return None

    @staticmethod
    def _version_oid(bucket: str, key: str, vid: str) -> str:
        return f"{bucket}/{key}@{vid}"

    @staticmethod
    def _as_versioned_entry(entry: Optional[Dict]) -> Dict:
        """Flat index entry -> versioned form (the existing state becomes
        the addressable "null" version, as S3 does on enabling
        versioning)."""
        if isinstance(entry, dict) and "versions" in entry:
            return entry
        return {"versions": ([] if entry is None else
                             [dict(entry, vid="null",
                                   ts=entry.get("ts", 0))])}

    @staticmethod
    def _set_derived(entry: Dict) -> Dict:
        """Size/etag follow the CURRENT (newest) version; a delete-marker
        current means the flat view reads empty.  One rule, shared with
        the in-OSD class methods."""
        cur = entry["versions"][-1] if entry["versions"] else None
        if cur is not None and cur.get("delete_marker"):
            cur = None
        entry["size"] = cur.get("size", 0) if cur else 0
        entry["etag"] = cur.get("etag", "") if cur else ""
        return entry

    async def _put_versioned(self, bucket: str, key: str, data: bytes,
                             now: float) -> str:
        """Versioned PUT (reference versioned-bucket semantics): every
        put appends a NEW version; nothing is overwritten."""
        vid = uuid.uuid4().hex[:16]
        await self.striper.write(self._version_oid(bucket, key, vid), data)
        ver = {"vid": vid, "size": len(data),
               "etag": hashlib.md5(data).hexdigest(), "ts": now}
        got = await self._idx_cls(bucket, "index_put_version",
                                  {"key": key, "version": ver})
        if got is not None:
            ret, _ = got
            if ret == -2:
                raise RadosError(f"NoSuchBucket: {bucket}",
                                 code=-errno.ENOENT)
            if ret < 0:
                raise RadosError(f"index_put_version failed ({ret})",
                                 code=ret)
        else:
            index = await self._load_index(bucket)
            if index is None:
                raise RadosError(f"NoSuchBucket: {bucket}")
            entry = self._as_versioned_entry(index.get(key))
            entry["versions"].append(ver)
            index[key] = self._set_derived(entry)
            await self._save_index(bucket, index)
        await self._log_mutation("put", bucket, key)
        return vid

    async def _resolve_object(self, bucket: str, key: str,
                              version_id: Optional[str] = None):
        """One resolution of (bucket, key[, version]) to its storage
        form: ("plain", soid, size) or ("manifest", parts, size) — the
        shared head of full GET, Range GET, and CopyObject (reference
        RGWObjManifest resolution in RGWGetObj/RGWCopyObj)."""
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        if key not in index:
            raise RadosError(f"NoSuchKey: {key}")
        entry = index[key]
        if "versions" in entry:
            versions = entry["versions"]
            if version_id is not None:
                match = [v for v in versions if v.get("vid") == version_id]
                if not match:
                    raise RadosError(f"NoSuchVersion: {version_id}",
                                     code=-errno.ENOENT)
                v = match[0]
                if v.get("delete_marker"):
                    raise RadosError(f"MethodNotAllowed: {version_id} is "
                                     f"a delete marker")
            else:
                if not versions or versions[-1].get("delete_marker"):
                    # the CURRENT (newest) version is a delete marker:
                    # the object reads as absent (S3 semantics)
                    raise RadosError(f"NoSuchKey: {key}",
                                     code=-errno.ENOENT)
                v = versions[-1]
            if "parts" in v:
                return ("manifest", v["parts"],
                        sum(p["size"] for p in v["parts"]))
            if v.get("vid") == "null":
                return ("plain", f"{bucket}/{key}", v.get("size", 0))
            return ("plain", self._version_oid(bucket, key, v["vid"]),
                    v.get("size", 0))
        if "parts" in entry:
            return ("manifest", entry["parts"],
                    sum(p["size"] for p in entry["parts"]))
        return ("plain", f"{bucket}/{key}", entry.get("size", 0))

    async def _read_resolved(self, kind: str, ref) -> bytes:
        if kind == "manifest":
            # manifest object: stitch the parts in order (RGWObjManifest)
            blobs = await asyncio.gather(
                *(self.striper.read(p["oid"]) for p in ref))
            return b"".join(blobs)
        return await self.striper.read(ref)

    async def get_object(self, bucket: str, key: str,
                         version_id: Optional[str] = None) -> bytes:
        kind, ref, _size = await self._resolve_object(bucket, key,
                                                      version_id)
        return await self._read_resolved(kind, ref)

    @staticmethod
    def parse_range(spec: str, total: int) -> Optional[Tuple[int, int]]:
        """RFC 7233 single byte-range (reference RGWGetObj range
        parsing): 'bytes=a-b' / 'bytes=a-' / 'bytes=-N' -> (start,
        end_inclusive) clamped to `total`.  Returns None for a
        malformed spec (S3: ignore the header, serve the whole
        object); raises InvalidRange (-ERANGE) when syntactically
        valid but unsatisfiable — the 416 contract."""
        m = re.fullmatch(r"bytes=(\d*)-(\d*)", spec.strip())
        if not m or (not m.group(1) and not m.group(2)):
            return None
        a, b = m.group(1), m.group(2)
        if a and b and int(b) < int(a):
            # RFC 7233 §2.1: last-byte-pos < first-byte-pos makes the
            # spec syntactically INVALID — ignored, not 416
            return None
        if not a:  # suffix form: last N bytes
            n = int(b)
            if n == 0 or total == 0:
                raise RadosError("InvalidRange", code=-errno.ERANGE)
            start, end = max(0, total - n), total - 1
        else:
            start = int(a)
            if start >= total:
                raise RadosError("InvalidRange", code=-errno.ERANGE)
            end = min(int(b), total - 1) if b else total - 1
        return (start, end)

    async def get_object_range(self, bucket: str, key: str, spec: str,
                               version_id: Optional[str] = None
                               ) -> Tuple[bytes, int,
                                          Optional[Tuple[int, int]]]:
        """Range GET (reference RGWGetObj with ofs/end): only the
        stripes/parts overlapping the range are read.  Returns
        (bytes, total_size, (start, end_inclusive)); a malformed spec
        degrades to the full object per S3."""
        kind, ref, total = await self._resolve_object(bucket, key,
                                                      version_id)
        try:
            rng = self.parse_range(spec, total)
        except RadosError as e:
            # unsatisfiable: carry the total so the 416 reply's
            # Content-Range needs no second resolution
            e.total = total
            raise
        if rng is None:
            # malformed spec: serve the whole object (S3 ignores the
            # header); rng=None tells the frontend to answer 200 —
            # read the form already resolved, no second index read
            return await self._read_resolved(kind, ref), total, None
        start, end = rng
        length = end - start + 1
        if kind == "plain":
            return (await self.striper.read_range(ref, start, length),
                    total, rng)
        # manifest: walk parts by cumulative offset, partial-read only
        # the overlapping ones (the multipart analog of the stripe walk)
        chunks, pos = [], 0
        for p in ref:
            p_end = pos + p["size"]
            if p_end > start and pos <= end:
                sub_off = max(0, start - pos)
                sub_len = min(end + 1, p_end) - (pos + sub_off)
                chunks.append(self.striper.read_range(
                    p["oid"], sub_off, sub_len))
            pos = p_end
            if pos > end:
                break
        return b"".join(await asyncio.gather(*chunks)), total, rng

    async def stat_object(self, bucket: str, key: str,
                          version_id: Optional[str] = None) -> int:
        """Total size without reading data (HEAD / 416 support)."""
        _kind, _ref, total = await self._resolve_object(bucket, key,
                                                        version_id)
        return total

    async def copy_object(self, src_bucket: str, src_key: str,
                          dst_bucket: str, dst_key: str,
                          version_id: Optional[str] = None,
                          principal: Optional[str] = None) -> Dict:
        """Server-side copy (reference RGWCopyObj, x-amz-copy-source):
        the data never leaves the cluster — read source form, write
        destination through the normal put path (index + versioning +
        datalog all apply).  Tags copy with the object (S3 default
        COPY directive)."""
        data = await self.get_object(src_bucket, src_key,
                                     version_id=version_id)
        # read source tags BEFORE the destination put: copying an
        # object onto itself replaces the index entry, and reading
        # after would see the fresh (tagless) entry and drop them
        src_index = await self._load_index(src_bucket)
        tags = (src_index or {}).get(src_key, {}).get("tags")
        await self.check_quota(principal, dst_bucket, len(data))
        vid = await self.put_object(dst_bucket, dst_key, data)
        if tags and version_id is None:
            await self.put_object_tagging(dst_bucket, dst_key, tags)
        out = {"ETag": hashlib.md5(data).hexdigest(),
               "LastModified": time.time()}
        if vid:
            out["VersionId"] = vid
        return out

    # -- object tagging (reference rgw_tag.cc, cls_rgw: tags ride the
    #    bucket index entry, not the object data) ---------------------------

    async def put_object_tagging(self, bucket: str, key: str,
                                 tags: Dict[str, str]) -> None:
        if not isinstance(tags, dict) or len(tags) > 10:
            raise RadosError("InvalidTag: at most 10 tags",
                             code=-errno.EINVAL)
        await self._set_tags(bucket, key, dict(tags))

    async def get_object_tagging(self, bucket: str, key: str
                                 ) -> Dict[str, str]:
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        if key not in index:
            raise RadosError(f"NoSuchKey: {key}")
        return dict(index[key].get("tags") or {})

    async def delete_object_tagging(self, bucket: str, key: str) -> None:
        await self._set_tags(bucket, key, None)

    async def _set_tags(self, bucket: str, key: str,
                        tags: Optional[Dict[str, str]]) -> None:
        got = await self._idx_cls(bucket, "index_set_tags",
                                  {"key": key, "tags": tags})
        if got is not None:
            ret, _ = got
            if ret == -errno.ENOENT:
                raise RadosError(f"NoSuchKey: {key}", code=ret)
            if ret < 0:
                raise RadosError(f"index_set_tags failed ({ret})",
                                 code=ret)
            return
        # EC pool: client-side RMW is the single writer path
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        if key not in index:
            raise RadosError(f"NoSuchKey: {key}")
        if tags is None:
            index[key].pop("tags", None)
        else:
            index[key]["tags"] = tags
        await self._save_index(bucket, index)

    async def _drop_object_data(self, bucket: str, key: str,
                                entry: Optional[Dict]) -> None:
        """Remove an index entry's backing data in EVERY form it may
        exist: version objects (bucket/key@vid), manifest parts, and the
        plain striped object — a key may have been written all three
        ways over its lifetime, and dropping one form must not orphan
        another."""
        for v in (entry or {}).get("versions", ()):
            if v.get("delete_marker"):
                continue
            for p in v.get("parts", ()):
                try:
                    await self.striper.remove(p["oid"])
                except RadosError:
                    pass
            if v.get("vid") not in (None, "null"):
                try:
                    await self.striper.remove(
                        self._version_oid(bucket, key, v["vid"]))
                except RadosError:
                    pass
        if entry and "parts" in entry:
            for p in entry["parts"]:
                try:
                    await self.striper.remove(p["oid"])
                except RadosError:
                    pass
        try:
            await self.striper.remove(f"{bucket}/{key}")
        except RadosError:
            pass

    async def delete_object(self, bucket: str, key: str,
                            version_id: Optional[str] = None,
                            now: Optional[float] = None,
                            bmeta: Optional[Dict] = None) -> None:
        now = time.time() if now is None else now
        if bmeta is None:
            bmeta = await self.get_bucket_meta(bucket)
        if version_id is not None:
            return await self._delete_version(bucket, key, version_id)
        versioned = bmeta.get("versioning")
        if not versioned:
            index0 = await self._load_index(bucket)
            entry0 = (index0 or {}).get(key)
            versioned = isinstance(entry0, dict) and "versions" in entry0
        if versioned:
            # versioned delete: a DELETE MARKER becomes the newest
            # version; data stays reachable via explicit versionIds
            marker = {"vid": uuid.uuid4().hex[:16], "delete_marker": True,
                      "ts": now}
            got = await self._idx_cls(bucket, "index_put_version",
                                      {"key": key, "version": marker})
            if got is None:
                index = await self._load_index(bucket)
                if index is None:
                    raise RadosError(f"NoSuchBucket: {bucket}")
                entry = self._as_versioned_entry(index.get(key))
                entry["versions"].append(marker)
                index[key] = self._set_derived(entry)
                await self._save_index(bucket, index)
            elif got[0] == -2:
                raise RadosError(f"NoSuchBucket: {bucket}",
                                 code=-errno.ENOENT)
            await self._log_mutation("delete", bucket, key)
            return
        got = await self._idx_cls(bucket, "index_rm", {"key": key})
        if got is not None:
            ret, out = got
            if ret == -2 and await self._load_index(bucket) is None:
                raise RadosError(f"NoSuchBucket: {bucket}",
                                 code=-errno.ENOENT)
            entry = (json.loads(out or b"{}").get("prev")
                     if ret == 0 else None)
            await self._drop_object_data(bucket, key, entry)
            await self._log_mutation("delete", bucket, key)
            return
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        entry = index.pop(key, None)
        await self._drop_object_data(bucket, key, entry)
        await self._save_index(bucket, index)
        await self._log_mutation("delete", bucket, key)

    async def _delete_version(self, bucket: str, key: str,
                              vid: str) -> None:
        """Permanently remove ONE version (S3 DELETE ?versionId=...)."""
        got = await self._idx_cls(bucket, "index_rm_version",
                                  {"key": key, "vid": vid})
        removed = None
        if got is not None:
            ret, out = got
            if ret == -2:
                raise RadosError(f"NoSuchVersion: {vid}",
                                 code=-errno.ENOENT)
            if ret < 0:
                raise RadosError(f"index_rm_version failed ({ret})",
                                 code=ret)
            removed = json.loads(out or b"{}").get("removed")
        else:
            index = await self._load_index(bucket)
            if index is None:
                raise RadosError(f"NoSuchBucket: {bucket}")
            entry = index.get(key)
            if not entry or "versions" not in entry:
                raise RadosError(f"NoSuchVersion: {vid}",
                                 code=-errno.ENOENT)
            match = [v for v in entry["versions"] if v.get("vid") == vid]
            if not match:
                raise RadosError(f"NoSuchVersion: {vid}",
                                 code=-errno.ENOENT)
            removed = match[0]
            entry["versions"] = [v for v in entry["versions"]
                                 if v.get("vid") != vid]
            if entry["versions"]:
                index[key] = self._set_derived(entry)
            else:
                index.pop(key)
            await self._save_index(bucket, index)
        if removed and not removed.get("delete_marker"):
            for p in removed.get("parts", ()):
                try:
                    await self.striper.remove(p["oid"])
                except RadosError:
                    pass
            if "parts" not in removed:
                oid = (f"{bucket}/{key}" if removed.get("vid") == "null"
                       else self._version_oid(bucket, key, vid))
                try:
                    await self.striper.remove(oid)
                except RadosError:
                    pass
        # a version-targeted delete changes the key's CURRENT state in a
        # direction only the source knows (prune, or undelete by marker
        # removal): replicas RESYNC the key instead of blindly deleting
        await self._log_mutation("resync", bucket, key)

    async def list_object_versions(self, bucket: str,
                                   key: Optional[str] = None) -> Dict:
        """{key: [versions newest-last]} (S3 ListObjectVersions role)."""
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        out: Dict[str, List[Dict]] = {}
        for k, entry in index.items():
            if key is not None and k != key:
                continue
            if "versions" in entry:
                out[k] = list(entry["versions"])
            else:
                out[k] = [dict(entry, vid="null")]
        return out

    async def list_objects(self, bucket: str) -> Dict[str, Dict]:
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        out = {}
        for k, entry in index.items():
            if "versions" in entry:
                vs = entry["versions"]
                if not vs or vs[-1].get("delete_marker"):
                    continue  # current version is a delete marker: hidden
            out[k] = entry
        return out

    async def delete_bucket(self, bucket: str) -> None:
        """Delete an EMPTY bucket (both S3 and Swift refuse non-empty
        deletion: BucketNotEmpty / 409 Conflict)."""
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        if index:
            raise RadosError(f"BucketNotEmpty: {bucket}")
        uploads = [o for o in await self.ioctx.list_objects()
                   if o.startswith(".upload.")
                   and o.rsplit(".", 1)[0] == f".upload.{bucket}"]
        if uploads:
            # the reference refuses deletion while multipart uploads are
            # in flight; allowing it would orphan every part object
            raise RadosError(f"BucketNotEmpty: {bucket} has "
                             f"{len(uploads)} multipart upload(s) in flight")
        await self.ioctx.remove(self._index_oid(bucket))
        try:
            # the bucket's versioning/lifecycle/ACL die with it — a
            # recreated bucket must not resurrect the old owner's policy
            await self.ioctx.remove(self._meta_oid(bucket))
        except RadosError:
            pass
        try:
            await self.ioctx.execute(
                BUCKETS_ROOT, "rgw", "registry_rm",
                json.dumps({"bucket": bucket}).encode())
        except RadosError as e:
            if e.code != -errno.EOPNOTSUPP:
                raise
            # EC pool: client-side registry (single-writer semantics)
            buckets = await self.list_buckets()
            if bucket in buckets:
                buckets.remove(bucket)
                await self.ioctx.write_full(
                    BUCKETS_ROOT, json.dumps(sorted(buckets)).encode())
        await self._log_mutation("delete_bucket", bucket)

    # -- multipart (reference rgw multipart upload machinery) ---------------

    @staticmethod
    def _upload_meta_oid(bucket: str, upload_id: str) -> str:
        return f".upload.{bucket}.{upload_id}"

    def _part_oid(self, bucket: str, upload_id: str, part: int) -> str:
        return f"_mp.{bucket}.{upload_id}.{part:05d}"

    @staticmethod
    def _uploads_oid(bucket: str) -> str:
        return f".uploads.{bucket}"

    async def _uploads_registry(self, bucket: str) -> List[str]:
        """Fail-closed like list_buckets(strict=True): quota accounting
        consumes this, so a transient read error must propagate rather
        than under-count staged bytes."""
        try:
            return json.loads(await self.ioctx.read(
                self._uploads_oid(bucket)))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            return []

    async def _uploads_registry_update(self, bucket: str, add=None,
                                       remove=None) -> None:
        # serialized read-modify-write (same discipline as
        # _log_mutation): a lost registry entry is staged bytes the
        # quota can never see again
        async with self._uploads_lock:
            ids = await self._uploads_registry(bucket)
            if add is not None and add not in ids:
                ids.append(add)
            if remove is not None and remove in ids:
                ids.remove(remove)
            await self.ioctx.write_full(self._uploads_oid(bucket),
                                        json.dumps(ids).encode())

    async def initiate_multipart(self, bucket: str, key: str) -> str:
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        upload_id = uuid.uuid4().hex
        await self.ioctx.write_full(
            self._upload_meta_oid(bucket, upload_id),
            json.dumps({"key": key, "parts": {}}).encode())
        # in-progress registry: staged parts are visible to usage
        # accounting (reference: uploads live in the bucket index's
        # multipart namespace and are listable/chargeable)
        await self._uploads_registry_update(bucket, add=upload_id)
        return upload_id

    async def list_multipart_uploads(self, bucket: str) -> List[Dict]:
        """In-progress uploads (reference RGWListBucketMultiparts, GET
        /bucket?uploads): upload id + target key per entry."""
        if await self._load_index(bucket) is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        out = []
        for upload_id in await self._uploads_registry(bucket):
            try:
                meta = await self._load_upload(bucket, upload_id)
            except RadosError as e:
                if e.code == -errno.ENOENT:
                    continue  # registry/meta race: entry mid-abort
                raise  # transient I/O error: fail closed, never omit
            out.append({"UploadId": upload_id, "Key": meta["key"]})
        return out

    async def list_parts(self, bucket: str, upload_id: str,
                         key: Optional[str] = None) -> List[Dict]:
        """Staged parts of one upload (reference RGWListMultipart, GET
        /bucket/key?uploadId): number, size, etag — what a resuming
        client needs to skip already-staged parts.  When `key` is
        given it must match the upload's target (the frontend's
        per-object authorization gate was evaluated against IT —
        a mismatch is NoSuchUpload, as S3 answers)."""
        meta = await self._load_upload(bucket, upload_id)
        if key is not None and meta["key"] != key:
            raise RadosError(f"NoSuchUpload: {upload_id} targets a "
                             "different key", code=-errno.ENOENT)
        return [{"PartNumber": int(n), "Size": p["size"],
                 "ETag": p["etag"]}
                for n, p in sorted(meta["parts"].items(),
                                   key=lambda kv: int(kv[0]))]

    async def _load_upload(self, bucket: str, upload_id: str) -> Dict:
        try:
            return json.loads(await self.ioctx.read(
                self._upload_meta_oid(bucket, upload_id)))
        except RadosError as e:
            if e.code == -errno.ENOENT:
                raise RadosError(f"NoSuchUpload: {upload_id}",
                                 code=-errno.ENOENT)
            raise  # transient I/O: keep the typed code, fail closed

    async def upload_part(self, bucket: str, upload_id: str, part: int,
                          data: bytes) -> str:
        meta = await self._load_upload(bucket, upload_id)
        oid = self._part_oid(bucket, upload_id, part)
        await self.striper.write(oid, data)
        etag = hashlib.md5(data).hexdigest()
        meta["parts"][str(part)] = {"oid": oid, "size": len(data),
                                    "etag": etag}
        await self.ioctx.write_full(
            self._upload_meta_oid(bucket, upload_id),
            json.dumps(meta).encode())
        # staged bytes count toward usage: the next part's quota check
        # must see this one
        self._invalidate_usage(bucket)
        return etag

    async def complete_multipart(self, bucket: str, upload_id: str,
                                 parts: Optional[List[int]] = None,
                                 principal: Optional[str] = None) -> str:
        """Assemble the object from its parts; the bucket index entry
        becomes a manifest referencing the part objects in order.
        Byte quota was charged when each part was STAGED (staged parts
        count in bucket_usage), but completion creates a NEW indexed
        object — the object-count axis must be re-checked here or
        multipart becomes a max_objects bypass (parts stage with
        add_objects=0; reference re-checks quota at completion)."""
        meta = await self._load_upload(bucket, upload_id)
        index = await self._load_index(bucket)
        if index is None:
            raise RadosError(f"NoSuchBucket: {bucket}")
        # overwrite of an existing key replaces its index entry — the
        # object count only grows when the key is new (the index is in
        # hand here, so be exact where the plain-PUT pre-check is
        # conservative)
        await self.check_quota(
            principal, bucket, 0,
            add_objects=0 if meta["key"] in index else 1)
        have = {int(n): p for n, p in meta["parts"].items()}
        order = sorted(have) if parts is None else list(parts)
        if not order or any(n not in have for n in order):
            raise RadosError("InvalidPart: upload has missing parts")
        key = meta["key"]
        manifest = [have[n] for n in order]

        async def discard_unselected():
            # parts NOT selected into the manifest are discarded (S3
            # semantics) — leaving them stored after the upload's
            # registry entry vanished would be bytes no quota ever
            # counts again.  Runs AFTER the index commit: deleting them
            # first would let a failed commit + retried complete build a
            # manifest referencing already-deleted part objects.
            for n, p in have.items():
                if n not in order:
                    try:
                        await self.striper.remove(p["oid"])
                    except RadosError:
                        pass
        # S3 multipart etag convention: md5 of concatenated part md5s
        etag = hashlib.md5(
            b"".join(bytes.fromhex(p["etag"]) for p in manifest)
        ).hexdigest() + f"-{len(manifest)}"
        entry = {"size": sum(p["size"] for p in manifest),
                 "etag": etag, "parts": manifest, "ts": time.time()}
        bmeta = await self.get_bucket_meta(bucket)
        if bmeta.get("versioning") or (
                isinstance(index.get(key), dict)
                and "versions" in index[key]):
            # versioned bucket: multipart completion appends a VERSION
            # carrying its manifest — prior versions' data survives
            ver = dict(entry, vid=uuid.uuid4().hex[:16])
            got = await self._idx_cls(bucket, "index_put_version",
                                      {"key": key, "version": ver})
            if got is not None:
                ret, _ = got
                if ret < 0:
                    raise RadosError(f"index_put_version failed ({ret})",
                                     code=ret)
            else:
                e = self._as_versioned_entry(index.get(key))
                e["versions"].append(ver)
                index[key] = self._set_derived(e)
                await self._save_index(bucket, index)
            await discard_unselected()
            await self.ioctx.remove(self._upload_meta_oid(bucket, upload_id))
            await self._uploads_registry_update(bucket, remove=upload_id)
            await self._log_mutation("put", bucket, key)
            return etag
        got = await self._idx_cls(bucket, "index_put",
                                  {"key": key, "meta": entry})
        if got is not None:
            ret, out = got
            if ret < 0:
                raise RadosError(f"index_put failed ({ret})", code=ret)
            # the REPLACED entry's data is stale now: old parts and the
            # old plain object both (the new bytes live in OUR parts)
            prev = json.loads(out or b"{}").get("prev")
            await self._drop_object_data(bucket, key, prev)
        else:
            prev = index.get(key)
            index[key] = entry
            await self._save_index(bucket, index)
            await self._drop_object_data(bucket, key, prev)
        await discard_unselected()
        await self.ioctx.remove(self._upload_meta_oid(bucket, upload_id))
        await self._uploads_registry_update(bucket, remove=upload_id)
        # a completed multipart IS an object mutation: without this the
        # zone sync agent never replicates multipart uploads (and its
        # first act invalidates the usage caches)
        await self._log_mutation("put", bucket, key)
        return etag

    async def abort_multipart(self, bucket: str, upload_id: str) -> None:
        meta = await self._load_upload(bucket, upload_id)
        for p in meta["parts"].values():
            try:
                await self.striper.remove(p["oid"])
            except RadosError:
                pass
        await self.ioctx.remove(self._upload_meta_oid(bucket, upload_id))
        await self._uploads_registry_update(bucket, remove=upload_id)
        self._invalidate_usage(bucket)


# -- SigV4 (reference rgw_auth; AWS Signature Version 4) --------------------


class RgwAdmin:
    """radosgw-admin role (reference src/rgw/rgw_admin.cc, rgw_user.cc):
    managed-user lifecycle, quotas, and usage over a gateway's user
    store.  Users persist in the pool, so a restarted gateway serves
    the same principals."""

    def __init__(self, service: RgwService):
        self.service = service

    async def _load(self) -> Dict[str, Dict]:
        await self.service.load_users()
        return self.service.users

    async def _save(self, users: Dict[str, Dict]) -> None:
        await self.service.ioctx.write_full(
            self.service.USERS_OID, json.dumps(users).encode())
        await self.service.load_users()

    async def user_create(self, uid: str, display_name: str = "",
                          access_key: Optional[str] = None,
                          secret_key: Optional[str] = None) -> Dict:
        users = await self._load()
        if uid in users:
            raise RadosError(f"UserAlreadyExists: {uid}",
                             code=-errno.EEXIST)
        user = {
            "uid": uid,
            "display_name": display_name or uid,
            "access_key": access_key or uuid.uuid4().hex[:20].upper(),
            "secret_key": secret_key or uuid.uuid4().hex,
            "suspended": False,
            "quota": None,          # user-scope quota
            "bucket_quota": None,   # per-bucket quota
        }
        users[uid] = user
        await self._save(users)
        return dict(user)

    async def user_rm(self, uid: str) -> None:
        users = await self._load()
        if uid not in users:
            raise RadosError(f"NoSuchUser: {uid}", code=-errno.ENOENT)
        del users[uid]
        await self._save(users)

    async def user_info(self, uid: str) -> Dict:
        users = await self._load()
        if uid not in users:
            raise RadosError(f"NoSuchUser: {uid}", code=-errno.ENOENT)
        return dict(users[uid])

    async def user_list(self) -> List[str]:
        return sorted(await self._load())

    async def _set_suspended(self, uid: str, suspended: bool) -> None:
        users = await self._load()
        if uid not in users:
            raise RadosError(f"NoSuchUser: {uid}", code=-errno.ENOENT)
        users[uid]["suspended"] = suspended
        await self._save(users)

    async def user_suspend(self, uid: str) -> None:
        await self._set_suspended(uid, True)

    async def user_enable(self, uid: str) -> None:
        await self._set_suspended(uid, False)

    async def quota_set(self, uid: str, scope: str = "user",
                        max_size: int = -1,
                        max_objects: int = -1) -> None:
        """-1 = unlimited on that axis (reference quota semantics);
        setting leaves the quota disabled until quota_enable."""
        if scope not in ("user", "bucket"):
            raise RadosError(f"InvalidArgument: scope {scope!r}",
                             code=-errno.EINVAL)
        users = await self._load()
        if uid not in users:
            raise RadosError(f"NoSuchUser: {uid}", code=-errno.ENOENT)
        field = "quota" if scope == "user" else "bucket_quota"
        prev = users[uid].get(field) or {}
        users[uid][field] = {"enabled": bool(prev.get("enabled")),
                             "max_size": int(max_size),
                             "max_objects": int(max_objects)}
        await self._save(users)

    async def _quota_toggle(self, uid: str, scope: str,
                            enabled: bool) -> None:
        users = await self._load()
        if uid not in users:
            raise RadosError(f"NoSuchUser: {uid}", code=-errno.ENOENT)
        field = "quota" if scope == "user" else "bucket_quota"
        q = users[uid].get(field) or {"max_size": -1, "max_objects": -1}
        q["enabled"] = enabled
        users[uid][field] = q
        await self._save(users)

    async def quota_enable(self, uid: str, scope: str = "user") -> None:
        await self._quota_toggle(uid, scope, True)

    async def quota_disable(self, uid: str, scope: str = "user") -> None:
        await self._quota_toggle(uid, scope, False)

    async def usage(self, uid: str) -> Dict[str, int]:
        user = await self.user_info(uid)
        return await self.service.usage(user["access_key"])


def _access_key_of(headers: Dict[str, str]) -> Optional[str]:
    """The SigV4 access key naming the request's principal (verification
    already happened; this only extracts identity for ACL checks)."""
    auth = headers.get("authorization", "")
    if "Credential=" not in auth:
        return None
    try:
        return auth.split("Credential=")[1].split("/")[0]
    except IndexError:
        return None


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str = "us-east-1",
                service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(method: str, path: str, query: str,
                      headers: Dict[str, str], signed: List[str],
                      payload_hash: str) -> str:
    canon_q = "&".join(sorted(
        f"{k}={v}" for k, v in parse_qsl(query, keep_blank_values=True)))
    canon_h = "".join(f"{h}:{headers.get(h, '').strip()}\n" for h in signed)
    return "\n".join([method, path, canon_q, canon_h, ";".join(signed),
                      payload_hash])


def sign_request(access_key: str, secret: str, method: str, path: str,
                 query: str, headers: Dict[str, str],
                 payload: bytes) -> Dict[str, str]:
    """Produce the Authorization (+x-amz-*) headers for a request — the
    client half, used by tests and any embedded S3 client."""
    amzdate = headers.get("x-amz-date", "20260101T000000Z")
    date = amzdate[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    hdrs = dict(headers)
    hdrs["x-amz-date"] = amzdate
    hdrs["x-amz-content-sha256"] = payload_hash
    hdrs.setdefault("host", "")
    signed = sorted(["host", "x-amz-content-sha256", "x-amz-date"])
    scope = f"{date}/us-east-1/s3/aws4_request"
    creq = canonical_request(method, path, query, hdrs, signed, payload_hash)
    sts = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date), sts.encode(),
                   hashlib.sha256).hexdigest()
    hdrs["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return hdrs


def presign_url(access_key: str, secret: str, method: str, path: str,
                host: str, expires: int = 3600,
                amzdate: Optional[str] = None) -> str:
    """Client half of query-string auth (reference rgw_auth_s3
    presigned URLs / AWS SigV4 query parameters): returns path?query
    that grants `method` on `path` until amzdate+expires, bearer-style
    — no headers or secret needed by the holder."""
    if amzdate is None:
        amzdate = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amzdate[:8]
    scope = f"{date}/us-east-1/s3/aws4_request"
    params = [
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amzdate),
        ("X-Amz-Expires", str(int(expires))),
        ("X-Amz-SignedHeaders", "host"),
    ]
    query = "&".join(f"{k}={quote(v, safe='')}" for k, v in params)
    # sign the DECODED path (the frontend unquotes before verifying),
    # ship the ENCODED one (keys with %, spaces, etc. stay valid URLs)
    creq = canonical_request(method, path, query, {"host": host},
                             ["host"], "UNSIGNED-PAYLOAD")
    sts = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date), sts.encode(),
                   hashlib.sha256).hexdigest()
    return f"{quote(path)}?{query}&X-Amz-Signature={sig}"


def verify_presigned(credentials: Dict[str, str], method: str, path: str,
                     query: str, headers: Dict[str, str],
                     now: Optional[float] = None) -> Optional[str]:
    """Server half: returns the authenticated access key, or None when
    the signature is wrong or the grant expired.  The signature covers
    method+path+query (minus the signature itself) and the host header;
    the payload is unsigned, as AWS defines for presigned uploads."""
    q = dict(parse_qsl(query, keep_blank_values=True))
    sig = q.pop("X-Amz-Signature", "")
    cred = q.get("X-Amz-Credential", "")
    access_key, _, scope = cred.partition("/")
    secret = credentials.get(access_key)
    if not sig or secret is None:
        return None
    amzdate = q.get("X-Amz-Date", "")
    try:
        import calendar
        expires = int(q.get("X-Amz-Expires", "0"))
        # amzdate is Zulu: timegm, NOT mktime (which reads local time)
        issued = calendar.timegm(time.strptime(amzdate,
                                               "%Y%m%dT%H%M%SZ"))
    except (ValueError, OverflowError):
        return None
    if now is None:
        now = time.time()
    expires = min(expires, 604800)  # AWS caps presigned life at 7 days
    if not (0 < expires and issued <= now + 300  # small clock skew
            and now <= issued + expires):
        return None
    canon_q = "&".join(f"{quote(k, safe='')}={quote(v, safe='')}"
                       for k, v in sorted(q.items()))
    creq = canonical_request(method, path, canon_q,
                             {"host": headers.get("host", "")},
                             ["host"], "UNSIGNED-PAYLOAD")
    date = scope.split("/")[0] if scope else ""
    sts = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    want = hmac.new(signing_key(secret, date), sts.encode(),
                    hashlib.sha256).hexdigest()
    return access_key if hmac.compare_digest(want, sig) else None


def verify_request(credentials: Dict[str, str], method: str, path: str,
                   query: str, headers: Dict[str, str],
                   payload: bytes) -> bool:
    """Server half: recompute the signature from the stored secret and
    compare (constant time)."""
    auth = headers.get("authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256 "):
        return False
    fields = dict(
        kv.strip().split("=", 1)
        for kv in auth[len("AWS4-HMAC-SHA256 "):].split(",") if "=" in kv)
    cred = fields.get("Credential", "")
    access_key, _, scope = cred.partition("/")
    secret = credentials.get(access_key)
    if secret is None:
        return False
    signed = [h for h in fields.get("SignedHeaders", "").split(";") if h]
    date = scope.split("/")[0] if scope else ""
    payload_hash = headers.get("x-amz-content-sha256", "")
    if payload_hash != hashlib.sha256(payload).hexdigest():
        return False
    creq = canonical_request(method, path, query, headers, signed,
                             payload_hash)
    sts = "\n".join(["AWS4-HMAC-SHA256", headers.get("x-amz-date", ""),
                     scope, hashlib.sha256(creq.encode()).hexdigest()])
    want = hmac.new(signing_key(secret, date), sts.encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, fields.get("Signature", ""))


class RgwFrontend:
    """Minimal HTTP frontend (beast role): newline-framed HTTP/1.1.

    Serves BOTH API dialects the reference gateway does: the S3-style
    routes (bucket/key paths, SigV4 when credentials are set) and the
    Swift API (reference src/rgw/rgw_rest_swift.h): tempauth-style token
    issue at /auth/v1.0 (X-Auth-User/X-Auth-Key -> X-Auth-Token +
    X-Storage-Url) and /v1/AUTH_<account>/<container>/<object> routes
    over the same bucket/object backend."""

    def __init__(self, service: RgwService):
        self.service = service
        self._server: Optional[asyncio.AbstractServer] = None
        self.addr: Optional[Tuple[str, int]] = None
        # Swift tempauth tokens: token -> (account, issued_monotonic);
        # TTL-bounded and size-capped (reference tempauth tokens expire)
        self._swift_tokens: Dict[str, Tuple[str, float]] = {}
        self.swift_token_ttl = 3600.0

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        await self.service.load_users()  # managed principals + statics
        self._server = await asyncio.start_server(self._serve, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1)
            except asyncio.TimeoutError:
                pass

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await reader.readline()
                if not request:
                    return
                try:
                    method, target, _ = request.decode().split(" ", 2)
                except ValueError:
                    return
                headers = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                try:
                    length = max(0, int(headers.get("content-length", 0)))
                except ValueError:
                    writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"Content-Length: 0\r\n\r\n")
                    await writer.drain()
                    return
                if length:
                    body = await reader.readexactly(length)
                url = urlsplit(target)
                path, query = unquote(url.path), url.query
                extra: Dict[str, str] = {}
                # TTL-bounded user-store refresh: out-of-process admin
                # changes (suspend, quota) bite live gateways
                await self.service.maybe_reload_users()
                presigned = "X-Amz-Signature=" in query
                if path == "/auth/v1.0" or path.startswith("/v1/"):
                    status, payload, extra = await self._route_swift(
                        method, path, query, body, headers)
                elif presigned:
                    # query-string auth (presigned URL): the signature
                    # IS the credential — no Authorization header
                    principal = verify_presigned(
                        self.service.credentials, method, path, query,
                        headers)
                    user = self.service.user_by_access(principal)
                    if principal is None:
                        status, payload = ("403 Forbidden",
                                           b"AccessDenied")
                    elif user is not None and user.get("suspended"):
                        status, payload = ("403 Forbidden",
                                           b"UserSuspended")
                    else:
                        out = await self._route(
                            method, path, query, body, principal, headers)
                        status, payload = out[0], out[1]
                        if len(out) == 3:
                            extra.update(out[2])
                elif (self.service.credentials
                        and not verify_request(self.service.credentials,
                                               method, path, query, headers,
                                               body)):
                    status, payload = "403 Forbidden", b"SignatureDoesNotMatch"
                else:
                    # the ACL principal: the SigV4 access key that signed
                    # the request; anonymous (None) without credentials
                    principal = _access_key_of(headers)
                    user = self.service.user_by_access(principal)
                    if user is not None and user.get("suspended"):
                        status, payload = ("403 Forbidden",
                                           b"UserSuspended")
                    else:
                        out = await self._route(
                            method, path, query, body, principal, headers)
                        status, payload = out[0], out[1]
                        if len(out) == 3:
                            extra.update(out[2])
                hdr_lines = "".join(f"{k}: {v}\r\n" for k, v in extra.items())
                writer.write(
                    f"HTTP/1.1 {status}\r\nContent-Length: {len(payload)}\r\n"
                    f"{hdr_lines}"
                    f"Connection: keep-alive\r\n\r\n".encode() + payload)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _route_swift(self, method: str, path: str, query: str,
                           body: bytes, headers: Dict[str, str]
                           ) -> Tuple[str, bytes, Dict[str, str]]:
        """Swift dialect (reference rgw_rest_swift.h).  Containers map to
        buckets, objects to keys; accounts are authentication scope only
        (one backing store, as the reference's rados driver)."""
        if path == "/auth/v1.0":
            # tempauth: user "acct:user" + key -> token + storage URL
            if not self.service.credentials:
                return "501 Not Implemented", b"no credentials configured", {}
            user = headers.get("x-auth-user", "")
            key = headers.get("x-auth-key", "")
            acct = user.split(":")[0] if user else ""
            want = self.service.credentials.get(user) \
                or self.service.credentials.get(acct)
            if want is None or not hmac.compare_digest(want, key):
                return "401 Unauthorized", b"", {}
            managed = (self.service.user_by_access(user)
                       or self.service.user_by_access(acct))
            if managed is not None and managed.get("suspended"):
                return "403 Forbidden", b"UserSuspended", {}
            now = time.monotonic()
            for t, (_a, issued) in list(self._swift_tokens.items()):
                if now - issued > self.swift_token_ttl:
                    self._swift_tokens.pop(t, None)
            token = "AUTH_tk" + uuid.uuid4().hex
            self._swift_tokens[token] = (acct or user, now)
            while len(self._swift_tokens) > 10_000:
                self._swift_tokens.pop(next(iter(self._swift_tokens)))
            host, port = self.addr or ("127.0.0.1", 0)
            return "200 OK", b"", {
                "X-Auth-Token": token,
                "X-Storage-Token": token,
                "X-Storage-Url": f"http://{host}:{port}/v1/AUTH_{acct or user}",
            }
        principal = None
        if self.service.credentials:
            token = headers.get("x-auth-token", "")
            entry = self._swift_tokens.get(token)
            if entry is None or                     time.monotonic() - entry[1] > self.swift_token_ttl:
                self._swift_tokens.pop(token, None)
                return "401 Unauthorized", b"", {}
            principal = entry[0]  # the token's account, for ACL checks
            managed = self.service.user_by_access(principal)
            if managed is not None and managed.get("suspended"):
                # suspension after token issue still bites (reference:
                # every op re-checks the user record)
                return "403 Forbidden", b"UserSuspended", {}
        parts = [p for p in path.split("/") if p]
        # parts = ["v1", "AUTH_acct", container?, object...]
        if len(parts) < 2 or not parts[1].startswith("AUTH_"):
            return "400 Bad Request", b"", {}
        if len(parts) >= 3 and not (len(parts) == 3 and method == "PUT"):
            # bucket ACLs bind BOTH dialects (reference: one policy
            # store behind rgw_rest_swift and rgw_rest_s3) — container
            # creation itself is ungated, like the S3 create path
            need = "READ" if method in ("GET", "HEAD") else "WRITE"
            meta = await self.service.get_bucket_meta(parts[2])
            if not RgwService.acl_allows(meta.get("acl"), principal, need):
                return "403 Forbidden", b"AccessDenied", {}
        try:
            if len(parts) == 2:  # account: list containers
                if method in ("GET", "HEAD"):
                    names = await self.service.list_buckets()
                    extra = {"X-Account-Container-Count": str(len(names))}
                    if method == "HEAD":
                        return "204 No Content", b"", extra
                    return "200 OK", "\n".join(names).encode(), extra
                return "405 Method Not Allowed", b"", {}
            container = parts[2]
            if len(parts) == 3:
                if method == "PUT":
                    await self.service.create_bucket(container,
                                                     owner=principal)
                    return "201 Created", b"", {}
                if method in ("GET", "HEAD"):
                    index = await self.service.list_objects(container)
                    extra = {"X-Container-Object-Count": str(len(index)),
                             "X-Container-Bytes-Used": str(sum(
                                 e.get("size", 0) for e in index.values()))}
                    if method == "HEAD":
                        return "204 No Content", b"", extra
                    return "200 OK", "\n".join(sorted(index)).encode(), extra
                if method == "DELETE":
                    await self.service.delete_bucket(container)
                    return "204 No Content", b"", {}
                return "405 Method Not Allowed", b"", {}
            key = "/".join(parts[3:])
            if method == "PUT":
                # quotas bind both dialects (one store behind them)
                await self.service.check_quota(principal, container,
                                               len(body))
                await self.service.put_object(container, key, body)
                etag = hashlib.md5(body).hexdigest()
                return "201 Created", b"", {"ETag": etag}
            if method == "GET":
                rng_hdr = headers.get("range")
                if rng_hdr:
                    # same range engine AND reply shape as the S3
                    # dialect: one shared helper, zero divergence
                    return await self._ranged_get(container, key,
                                                  rng_hdr)
                data = await self.service.get_object(container, key)
                return "200 OK", data, {}
            if method == "HEAD":
                index = await self.service.list_objects(container)
                if key in index:
                    return "200 OK", b"", {
                        "Content-Length-Hint": str(index[key].get("size", 0)),
                        "ETag": index[key].get("etag", "")}
                return "404 Not Found", b"", {}
            if method == "DELETE":
                await self.service.delete_object(container, key)
                return "204 No Content", b"", {}
            return "405 Method Not Allowed", b"", {}
        except RadosError as e:
            msg = str(e)
            if "NoSuch" in msg:
                return "404 Not Found", msg.encode(), {}
            if "BucketNotEmpty" in msg:
                return "409 Conflict", msg.encode(), {}
            if "QuotaExceeded" in msg:
                return "403 Forbidden", msg.encode(), {}
            return "500 Internal Server Error", msg.encode(), {}

    async def _resolve_copy_source(self, headers: Dict[str, str],
                                   principal: Optional[str]):
        """Parse + authorize x-amz-copy-source, shared by CopyObject
        and UploadPartCopy: returns (sbucket, skey, svid) on success,
        or an (status, body) error pair — ONE copy of the source
        policy/ACL gate, so a fix to either branch cannot miss the
        other."""
        src = unquote(headers["x-amz-copy-source"])
        src_path, _, src_q = src.partition("?")
        sparts = [p for p in src_path.split("/") if p]
        if len(sparts) < 2:
            return None, ("400 Bad Request",
                          b"InvalidArgument: copy-source")
        sbucket, skey = sparts[0], "/".join(sparts[1:])
        svid = dict(parse_qsl(src_q)).get("versionId")
        smeta = await self.service.get_bucket_meta(sbucket)
        sverdict = RgwService.policy_eval(
            smeta.get("policy"), principal, "s3:GetObject",
            f"arn:aws:s3:::{sbucket}/{skey}")
        if sverdict == "Deny" or (
                sverdict != "Allow" and not RgwService.acl_allows(
                    smeta.get("acl"), principal, "READ")):
            return None, ("403 Forbidden", b"AccessDenied")
        return (sbucket, skey, svid), None

    async def _ranged_get(self, bucket: str, key: str, rng_hdr: str,
                          version_id: Optional[str] = None):
        """Range GET reply, shared by the S3 and Swift dialects: 206 +
        Content-Range for a satisfiable range, 416 + 'bytes */total'
        when past the end, plain 200 for a malformed spec."""
        try:
            data, total, rng = await self.service.get_object_range(
                bucket, key, rng_hdr, version_id=version_id)
        except RadosError as e:
            if e.code == -errno.ERANGE:
                total = getattr(e, "total", None)
                if total is None:
                    total = await self.service.stat_object(
                        bucket, key, version_id=version_id)
                return ("416 Requested Range Not Satisfiable",
                        b"InvalidRange",
                        {"Content-Range": f"bytes */{total}"})
            raise
        if rng is None:
            return "200 OK", data, {}
        a, b = rng
        return ("206 Partial Content", data,
                {"Content-Range": f"bytes {a}-{b}/{total}",
                 "Accept-Ranges": "bytes"})

    async def _route(self, method: str, path: str, query: str,
                     body: bytes,
                     principal: Optional[str] = None,
                     headers: Optional[Dict[str, str]] = None):
        """Returns (status, payload) or (status, payload, extra
        response headers) — Range GETs carry Content-Range."""
        headers = headers or {}
        parts = [p for p in path.split("/") if p]
        q = dict(parse_qsl(query, keep_blank_values=True))
        try:
            if not parts:
                if method == "GET":
                    return "200 OK", json.dumps(
                        await self.service.list_buckets()).encode()
                return "405 Method Not Allowed", b""
            bucket = parts[0]
            # authorization gate (reference rgw_op verify_permission):
            # the bucket POLICY is consulted first — explicit Deny wins,
            # explicit Allow grants, and no match falls through to the
            # ACL (reads need READ, mutations WRITE).  Administrative
            # subresources (acl/versioning/lifecycle/policy mutations)
            # are owner-level and deliberately NOT policy-gated, so a
            # bad Deny statement can never lock the owner out of
            # repairing the policy (AWS root-user semantics).
            gate_meta = None
            if parts and method in ("GET", "HEAD", "PUT", "POST", "DELETE"):
                need = "READ" if method in ("GET", "HEAD") else "WRITE"
                # GET ?acl / ?policy are READ_ACP-class subresources
                # (AWS: READ_ACP / s3:GetBucketPolicy is owner-level) —
                # a plain read grantee must not be able to enumerate
                # grants or the policy document, so they share the
                # owner-level gate with the mutating admin ops.
                admin_op = (method in ("PUT", "DELETE") and q.keys() & {
                    "acl", "versioning", "lifecycle", "policy"}) or (
                    method == "GET" and q.keys() & {"acl", "policy"})
                if admin_op:
                    need = "FULL_CONTROL"
                is_create = len(parts) == 1 and method == "PUT" \
                    and not q.keys() & {"versioning", "lifecycle", "acl",
                                        "policy"}
                if not is_create:
                    gate_meta = await self.service.get_bucket_meta(bucket)
                    if len(parts) >= 2:
                        action = {"GET": "s3:GetObject",
                                  "HEAD": "s3:GetObject",
                                  "PUT": "s3:PutObject",
                                  "POST": "s3:PutObject",
                                  "DELETE": "s3:DeleteObject"}[method]
                        resource = f"arn:aws:s3:::{bucket}/" + \
                            "/".join(parts[1:])
                    else:
                        action = {"GET": "s3:ListBucket",
                                  "HEAD": "s3:ListBucket",
                                  "PUT": "s3:CreateBucket",
                                  "POST": "s3:PutObject",
                                  "DELETE": "s3:DeleteBucket"}[method]
                        resource = f"arn:aws:s3:::{bucket}"
                    verdict = None
                    if not admin_op:
                        verdict = RgwService.policy_eval(
                            gate_meta.get("policy"), principal, action,
                            resource)
                    if verdict == "Deny":
                        return "403 Forbidden", b"AccessDenied"
                    if verdict != "Allow" and not RgwService.acl_allows(
                            gate_meta.get("acl"), principal, need):
                        return "403 Forbidden", b"AccessDenied"
            if len(parts) == 1:
                if method == "PUT" and "versioning" in q:
                    cfg = json.loads(body or b"{}")
                    await self.service.set_versioning(
                        bucket, cfg.get("Status") == "Enabled")
                    return "200 OK", b""
                if method == "GET" and "versioning" in q:
                    meta = await self.service.get_bucket_meta(bucket)
                    return "200 OK", json.dumps(
                        {"Status": "Enabled" if meta.get("versioning")
                         else "Suspended"}).encode()
                if method == "PUT" and "lifecycle" in q:
                    rules = json.loads(body or b"[]")
                    await self.service.put_lifecycle(bucket, rules)
                    return "200 OK", b""
                if method == "GET" and "lifecycle" in q:
                    meta = await self.service.get_bucket_meta(bucket)
                    return "200 OK", json.dumps(
                        meta.get("lifecycle") or []).encode()
                if method == "PUT" and "acl" in q:
                    acl = json.loads(body or b"{}")
                    await self.service.put_bucket_acl(bucket, acl)
                    return "200 OK", b""
                if method == "GET" and "acl" in q:
                    meta = await self.service.get_bucket_meta(bucket)
                    return "200 OK", json.dumps(meta.get("acl")).encode()
                if method == "PUT" and "policy" in q:
                    try:
                        doc = json.loads(body or b"{}")
                    except ValueError:
                        return "400 Bad Request", b"MalformedPolicy"
                    await self.service.put_bucket_policy(bucket, doc)
                    return "200 OK", b""
                if method == "GET" and "policy" in q:
                    meta = await self.service.get_bucket_meta(bucket)
                    if not meta.get("policy"):
                        return "404 Not Found", b"NoSuchBucketPolicy"
                    return "200 OK", json.dumps(meta["policy"]).encode()
                if method == "DELETE" and "policy" in q:
                    await self.service.delete_bucket_policy(bucket)
                    return "204 No Content", b""
                if method == "GET" and "versions" in q:
                    return "200 OK", json.dumps(
                        await self.service.list_object_versions(
                            bucket)).encode()
                if method == "GET" and "uploads" in q:
                    return "200 OK", json.dumps({
                        "Uploads":
                        await self.service.list_multipart_uploads(
                            bucket)}).encode()
                if method == "PUT":
                    await self.service.create_bucket(bucket,
                                                     owner=principal)
                    return "200 OK", b""
                if method == "GET":
                    return "200 OK", json.dumps(
                        await self.service.list_objects(bucket)).encode()
                if method == "DELETE":
                    await self.service.delete_bucket(bucket)
                    return "204 No Content", b""
                return "405 Method Not Allowed", b""
            key = "/".join(parts[1:])
            if method == "POST" and "uploads" in q:
                upload_id = await self.service.initiate_multipart(bucket, key)
                return "200 OK", json.dumps({"UploadId": upload_id}).encode()
            if method == "POST" and "uploadId" in q:
                order = None
                if body:
                    try:
                        order = [int(n) for n in json.loads(body)["Parts"]]
                    except (ValueError, KeyError, TypeError):
                        return "400 Bad Request", b"MalformedXML"
                etag = await self.service.complete_multipart(
                    bucket, q["uploadId"], order, principal=principal)
                return "200 OK", json.dumps({"ETag": etag}).encode()
            if method == "PUT" and "uploadId" in q and "partNumber" in q:
                try:
                    part = int(q["partNumber"])
                except ValueError:
                    return "400 Bad Request", b"InvalidArgument: partNumber"
                if headers.get("x-amz-copy-source"):
                    # UploadPartCopy (reference RGWCopyObj part mode):
                    # the part bytes come from an existing object, with
                    # an optional x-amz-copy-source-range — silently
                    # staging the empty request body instead would
                    # complete into a truncated object
                    resolved, err = await self._resolve_copy_source(
                        headers, principal)
                    if err is not None:
                        return err
                    sbucket, skey, svid = resolved
                    src_rng = headers.get("x-amz-copy-source-range")
                    if src_rng:
                        try:
                            body, _total, rng = \
                                await self.service.get_object_range(
                                    sbucket, skey, src_rng,
                                    version_id=svid)
                        except RadosError as e:
                            if e.code == -errno.ERANGE:
                                # unsatisfiable source range: the S3
                                # contract is 416, never a 500
                                return ("416 Requested Range Not "
                                        "Satisfiable", b"InvalidRange")
                            raise
                        if rng is None:
                            return ("400 Bad Request",
                                    b"InvalidArgument: copy-source-range")
                    else:
                        body = await self.service.get_object(
                            sbucket, skey, version_id=svid)
                # staged parts are quota-charged too (against indexed
                # usage — a bound, not exact accounting), or a capped
                # user could park unlimited bytes in never-completed
                # uploads
                await self.service.check_quota(principal, bucket,
                                               len(body), add_objects=0)
                etag = await self.service.upload_part(
                    bucket, q["uploadId"], part, body)
                return "200 OK", json.dumps({"ETag": etag}).encode()
            if method == "DELETE" and "uploadId" in q:
                await self.service.abort_multipart(bucket, q["uploadId"])
                return "204 No Content", b""
            if method == "GET" and "uploadId" in q:
                # key must match the upload's target: the per-object
                # authorization gate above was evaluated against it
                return "200 OK", json.dumps({
                    "Parts": await self.service.list_parts(
                        bucket, q["uploadId"], key=key)}).encode()
            if method == "PUT" and "tagging" in q:
                try:
                    parsed = json.loads(body or b"{}")
                except ValueError:
                    return "400 Bad Request", b"MalformedXML"
                if not isinstance(parsed, dict) or not isinstance(
                        parsed.get("TagSet", {}), dict):
                    return "400 Bad Request", b"MalformedXML"
                await self.service.put_object_tagging(
                    bucket, key, parsed.get("TagSet", {}))
                return "200 OK", b""
            if method == "GET" and "tagging" in q:
                tags = await self.service.get_object_tagging(bucket, key)
                return "200 OK", json.dumps({"TagSet": tags}).encode()
            if method == "DELETE" and "tagging" in q:
                await self.service.delete_object_tagging(bucket, key)
                return "204 No Content", b""
            if method == "PUT" and headers.get("x-amz-copy-source"):
                # server-side copy (reference RGWCopyObj): the caller
                # needs WRITE on the destination (already gated above)
                # AND read access to the SOURCE bucket/key
                resolved, err = await self._resolve_copy_source(
                    headers, principal)
                if err is not None:
                    return err
                sbucket, skey, svid = resolved
                out = await self.service.copy_object(
                    sbucket, skey, bucket, key, version_id=svid,
                    principal=principal)
                return "200 OK", json.dumps(out).encode()
            if method == "PUT":
                await self.service.check_quota(principal, bucket,
                                               len(body))
                vid = await self.service.put_object(bucket, key, body,
                                                    bmeta=gate_meta)
                return "200 OK", (json.dumps({"VersionId": vid}).encode()
                                  if vid else b"")
            if method == "GET":
                rng_hdr = headers.get("range")
                if rng_hdr:
                    return await self._ranged_get(
                        bucket, key, rng_hdr,
                        version_id=q.get("versionId"))
                return "200 OK", await self.service.get_object(
                    bucket, key, version_id=q.get("versionId"))
            if method == "HEAD":
                index = await self.service.list_objects(bucket)
                if key in index:
                    return "200 OK", b""
                return "404 Not Found", b""
            if method == "DELETE":
                await self.service.delete_object(
                    bucket, key, version_id=q.get("versionId"),
                    bmeta=gate_meta)
                return "204 No Content", b""
            return "405 Method Not Allowed", b""
        except RadosError as e:
            msg = str(e)
            if "NoSuch" in msg:
                return "404 Not Found", msg.encode()
            if "BucketNotEmpty" in msg:
                return "409 Conflict", msg.encode()
            if "InvalidPart" in msg or "MalformedXML" in msg \
                    or "MalformedPolicy" in msg or "InvalidTag" in msg \
                    or "InvalidArgument" in msg:
                return "400 Bad Request", msg.encode()
            if "MethodNotAllowed" in msg:
                return "405 Method Not Allowed", msg.encode()
            if "QuotaExceeded" in msg:
                return "403 Forbidden", msg.encode()
            return "500 Internal Server Error", msg.encode()


# -- multisite sync (reference src/rgw/driver/rados/rgw_sync.cc: zones
#    replicate via datalog/bilog replay) -------------------------------------

DATALOG_OID = ".rgw.datalog"


class ZoneSyncAgent:
    """radosgw sync agent role: replays one zone's data log into another
    zone, resumably.  The source gateway appends an entry per mutation
    (the reference's datalog/bucket-index-log pair collapsed into one
    ordered log); the agent reads entries past its persisted position,
    fetches the referenced objects from the source, and applies them to
    the destination — full-sync bootstrap first, then incremental tail,
    exactly the reference's full-sync -> incremental state machine in
    miniature."""

    def __init__(self, src: RgwService, dst: RgwService,
                 zone_id: str = "zone"):
        self.src = src
        self.dst = dst
        self.zone_id = zone_id

    def _pos_oid(self) -> str:
        return f".rgw.sync.pos.{self.zone_id}"

    async def _load_pos(self) -> int:
        try:
            return json.loads(await self.dst.ioctx.read(self._pos_oid()))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            return -1

    async def sync(self) -> int:
        """Apply new source mutations to the destination; returns the
        number applied.  First contact runs a FULL SYNC of every bucket
        (log history may predate this zone), then tails the log."""
        pos = await self._load_pos()
        state = await self.src.datalog_state()
        log, trimmed = state["log"], state.get("trimmed", 0)
        if 0 <= pos < trimmed:
            pos = -1  # fell behind the trim floor: full re-sync
        # replicated applies must not re-enter the DESTINATION's datalog:
        # in active-active topologies the echo would ping-pong forever.
        # Scoped to THIS task (contextvar): concurrent local mutations on
        # the destination gateway keep logging normally.
        token = _DATALOG_SUPPRESS.set(True)
        try:
            if pos < 0:
                src_buckets = set(await self.src.list_buckets())
                for bucket in sorted(src_buckets):
                    await self.dst.create_bucket(bucket)
                    src_keys = set(await self.src.list_objects(bucket))
                    for key in sorted(src_keys):
                        data = await self.src.get_object(bucket, key)
                        await self.dst.put_object(bucket, key, data)
                    # deletions the trimmed log no longer tells us about
                    for key in set(await self.dst.list_objects(bucket))                             - src_keys:
                        await self.dst.delete_object(bucket, key)
                for bucket in set(await self.dst.list_buckets())                         - src_buckets:
                    for key in await self.dst.list_objects(bucket):
                        await self.dst.delete_object(bucket, key)
                    await self.dst.delete_bucket(bucket)
                pos = log[-1]["seq"] if log else trimmed
                await self.dst.ioctx.write_full(self._pos_oid(),
                                                json.dumps(pos).encode())
                return 0
            applied = 0
            for ev in log:
                if ev["seq"] <= pos:
                    continue
                bucket, key, op = ev["bucket"], ev.get("key"), ev["op"]
                try:
                    if op == "create_bucket":
                        await self.dst.create_bucket(bucket)
                    elif op == "delete_bucket":
                        await self.dst.delete_bucket(bucket)
                    elif op == "put":
                        data = await self.src.get_object(bucket, key)
                        await self.dst.create_bucket(bucket)
                        await self.dst.put_object(bucket, key, data)
                    elif op == "resync":
                        # version-targeted mutations change the key's
                        # current state in a source-only way: mirror the
                        # VISIBLE state (present -> copy, absent -> del)
                        try:
                            data = await self.src.get_object(bucket, key)
                        except RadosError as e:
                            if e.code != -errno.ENOENT \
                                    and "NoSuch" not in str(e):
                                raise
                            data = None
                        if data is None:
                            try:
                                await self.dst.delete_object(bucket, key)
                            except RadosError:
                                pass
                        else:
                            await self.dst.create_bucket(bucket)
                            await self.dst.put_object(bucket, key, data)
                    elif op == "delete":
                        await self.dst.delete_object(bucket, key)
                except RadosError as e:
                    # the source object may be gone again (put then
                    # delete before we synced): a later entry covers it
                    if e.code != -errno.ENOENT and "NoSuch" not in str(e):
                        raise
                pos = ev["seq"]
                applied += 1
            if applied:
                await self.dst.ioctx.write_full(self._pos_oid(),
                                                json.dumps(pos).encode())
            return applied
        finally:
            _DATALOG_SUPPRESS.reset(token)
