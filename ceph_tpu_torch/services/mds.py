# Copy of ceph_tpu/services/mds.py at commit ac6dced, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""MDS-lite: a POSIX-style file namespace over RADOS.

Role-equivalent of the reference's CephFS metadata path in miniature
(reference src/mds/, src/client/): directories are metadata objects
holding dentries (the CInode/CDir/CDentry cache's persistent form —
reference stores dirfrags as omap on meta-pool objects); file data is
striped over data-pool objects exactly like the reference's
``<ino>.<frag>`` layout (via the striper).  The API mirrors libcephfs's
shape: mkdir/listdir/stat/write/read/unlink/rename.

Journaling (reference src/mds/MDLog.cc + osdc/Journaler): every
metadata mutation appends a journal EVENT to a segmented journal in the
metadata pool BEFORE the dirfrag updates are written.  Events record
idempotent POST-state (set/remove this dentry, ensure/remove this dir),
so a standby taking over after a crash calls ``mount()``, which replays
every unexpired event — completing half-applied multi-object updates —
exactly the reference's up:replay stage.  Fully applied positions are
expired (LogSegment trim) and their segments removed.

Multi-active MDS lives in :mod:`ceph_tpu_torch.services.mds_cluster`
(subtree partitioning across ranks, journaled export/import, balancer,
rank failover); this module is the single-rank core it composes.
"""

from __future__ import annotations

import asyncio
import errno
import json
import posixpath
import struct
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.rados.librados import IoCtx
from ceph_tpu_torch.rados.striper import RadosStriper

SEGMENT_EVENTS = 128  # events per journal segment (LogSegment role)
_REC = struct.Struct("<I")  # length prefix per journal record


def is_under(path: str, root: str) -> bool:
    """True if `path` is `root` or inside it (component-wise)."""
    return path == root or (root == "/" and path.startswith("/")) \
        or path.startswith(root + "/")


class FsError(Exception):
    pass


class MDLog:
    """Segmented metadata journal (reference MDLog/Journaler): append
    length-prefixed JSON events to segment objects; replay probes each
    segment to its end (a torn tail terminates the scan, exactly the
    reference's journal-end probe); expiry advances past applied events
    and removes fully expired segments."""

    HEAD_OID = "mds_journal_head"

    def __init__(self, ioctx: IoCtx, prefix: str = ""):
        # `prefix` names WHOSE journal this is: multi-active MDS gives
        # each rank its own journal objects (the reference's per-rank
        # 20X.xxxx journal inodes), so rank recovery replays only its
        # own log
        self.ioctx = ioctx
        self.prefix = prefix
        self.seg = 0          # segment being appended
        self.off = 0          # byte offset within it
        self.expire_seg = 0   # first segment that may hold unapplied events
        self.count = 0        # events in the current segment

    def _seg_oid(self, seg: int) -> str:
        return f"{self.prefix}mds_journal.{seg:08d}"

    async def _save_head(self) -> None:
        await self.ioctx.write_full(self.prefix + self.HEAD_OID, json.dumps(
            {"expire_seg": self.expire_seg, "write_seg": self.seg}).encode())

    async def load(self) -> List[Dict]:
        """Read the head and scan unexpired segments; positions the
        append cursor at the end.  Returns every event that may not have
        been fully applied (mount() replays them)."""
        try:
            head = json.loads(await self.ioctx.read(self.prefix
                                                    + self.HEAD_OID))
        except RadosError as e:
            # a fresh journal is only the right answer for VERIFIED
            # absence; resetting the cursor on a transient read failure
            # would replay from scratch / lose the append position
            if e.code != -errno.ENOENT:
                raise
            head = {"expire_seg": 0, "write_seg": 0}
        self.expire_seg = head["expire_seg"]
        events: List[Dict] = []
        seg = self.expire_seg
        last_seg, last_off, last_count = head["write_seg"], 0, 0
        while True:
            try:
                blob = await self.ioctx.read(self._seg_oid(seg))
            except RadosError:
                if seg <= head["write_seg"]:
                    seg += 1  # removed/expired segment inside the window
                    continue
                break
            off = count = 0
            while off + _REC.size <= len(blob):
                (n,) = _REC.unpack_from(blob, off)
                if off + _REC.size + n > len(blob):
                    break  # torn tail: journal ends here
                try:
                    events.append(json.loads(
                        blob[off + _REC.size:off + _REC.size + n]))
                except ValueError:
                    break
                off += _REC.size + n
                count += 1
            last_seg, last_off, last_count = seg, off, count
            seg += 1
        self.seg, self.off, self.count = last_seg, last_off, last_count
        return events

    async def append(self, event: Dict) -> None:
        if self.count >= SEGMENT_EVENTS:
            self.seg += 1
            self.off = 0
            self.count = 0
            await self._save_head()
        rec = json.dumps(event).encode()
        await self.ioctx.write(self._seg_oid(self.seg),
                               _REC.pack(len(rec)) + rec, offset=self.off)
        self.off += _REC.size + len(rec)
        self.count += 1

    async def expire(self) -> None:
        """Everything appended so far is applied: move the expiry floor
        to the current segment and drop older segments (LogSegment
        expiry)."""
        if self.expire_seg == self.seg:
            return
        old, self.expire_seg = self.expire_seg, self.seg
        await self._save_head()
        for s in range(old, self.expire_seg):
            try:
                await self.ioctx.remove(self._seg_oid(s))
            except RadosError:
                pass

    async def roll(self) -> None:
        """Close the CURRENT segment (start a fresh one), so a following
        expire() retires every event appended so far — expire() alone
        cannot drop the in-progress segment.  Subtree export uses this
        as its flush barrier: after roll+expire, nothing a replay could
        re-apply refers to the migrated subtree."""
        if self.count == 0 and self.off == 0:
            return  # current segment already empty
        self.seg += 1
        self.off = 0
        self.count = 0
        await self._save_head()


class FileSystem:
    def __init__(self, meta_ioctx: IoCtx, data_ioctx: Optional[IoCtx] = None,
                 object_size: int = 1 << 22, journal: bool = True,
                 journal_prefix: str = ""):
        self.meta = meta_ioctx
        self.data = data_ioctx or meta_ioctx
        self.striper = RadosStriper(self.data, object_size=object_size)
        self.mdlog: Optional[MDLog] = (
            MDLog(meta_ioctx, journal_prefix) if journal else None)
        self._applied_since_expire = 0
        # serializes this rank's metadata mutations: dirfrag updates are
        # read-modify-write of one dentries object, so two interleaved
        # ops on the same directory would lose the first update (the
        # reference serializes through per-CDir locks under the mds_lock)
        self._mutate = asyncio.Lock()
        self._snap_cache: Optional[Dict[str, Dict]] = None

    async def mount(self) -> int:
        """Recover the namespace: replay unexpired journal events (the
        up:replay stage a standby runs at takeover).  Returns the number
        of events replayed.  Safe to call on a fresh filesystem."""
        if self.mdlog is None:
            return 0
        events = await self.mdlog.load()
        for ev in events:
            await self._apply_event(ev)
        if events:
            await self.mdlog.expire()
        return len(events)

    # -- journal ------------------------------------------------------------

    async def _journal(self, event: Dict) -> None:
        if self.mdlog is not None:
            await self.mdlog.append(event)

    async def _journal_applied(self) -> None:
        """Called after an op's dirfrag updates landed: periodically
        expire the journal so replay stays short (the reference expires
        segments whose events are all flushed)."""
        if self.mdlog is None:
            return
        self._applied_since_expire += 1
        if self._applied_since_expire >= SEGMENT_EVENTS:
            self._applied_since_expire = 0
            await self.mdlog.expire()

    async def _apply_event(self, ev: Dict) -> None:
        """Idempotent replay of one journal event: events carry POST-
        state, so applying an already-applied event is a no-op."""
        op = ev.get("op")
        if op == "set_dentry":
            if ev.get("mkdir"):
                if await self._load_dir(ev["mkdir"]) is None:
                    await self._save_dir(ev["mkdir"], {})
            dentries = await self._load_dir(ev["parent"])
            if dentries is None:
                return  # parent itself gone (later event removed it)
            dentries[ev["name"]] = ev["dentry"]
            await self._save_dir(ev["parent"], dentries)
            old_ino = ev.get("drop_old_ino")
            if old_ino and old_ino != ev["dentry"].get("ino"):
                # whole-file replace: the superseded inode's data goes
                # with the same event (idempotent: already-gone is fine)
                try:
                    await self.striper.remove(self._file_oid(old_ino))
                except RadosError:
                    pass
        elif op == "setattr_dentry":
            dentries = await self._load_dir(ev["parent"])
            if dentries is not None and ev["name"] in dentries:
                dentries[ev["name"]].update(ev["attrs"])
                await self._save_dir(ev["parent"], dentries)
        elif op == "rm_dentry":
            dentries = await self._load_dir(ev["parent"])
            if dentries is not None and ev["name"] in dentries:
                del dentries[ev["name"]]
                await self._save_dir(ev["parent"], dentries)
            if ev.get("rmdir"):
                try:
                    await self.meta.remove(self._dir_oid(ev["rmdir"]))
                except RadosError:
                    pass
            if ev.get("drop_ino"):
                try:
                    await self.striper.remove(self._file_oid(ev["drop_ino"]))
                except RadosError:
                    pass
        elif op == "drop_ino":
            try:
                await self.striper.remove(self._file_oid(ev["ino"]))
            except RadosError:
                pass
        elif op == "rename":
            for sub in ev["events"]:
                await self._apply_event(sub)
        elif op == "rename_dir":
            # ordering for lock-free readers: write every destination
            # dirfrag from the JOURNALED post-state, flip the parent
            # dentries (dst set, src rm — never-neither), THEN delete
            # the old dirfrag objects.  At every point the namespace
            # resolves: pre-flip readers walk src over still-present
            # old frags, post-flip readers walk dst over the new ones.
            sdentries = await self._load_dir(ev["sparent"])
            fully_applied = (sdentries is not None
                             and ev["sname"] not in sdentries)
            if not fully_applied:
                for rel, frag in ev["frags"].items():
                    new_path = posixpath.join(ev["dst"], rel) if rel \
                        else ev["dst"]
                    await self._save_dir(new_path, frag)
                ddentries = await self._load_dir(ev["dparent"])
                if ddentries is not None:
                    ddentries[ev["dname"]] = ev["dentry"]
                    await self._save_dir(ev["dparent"], ddentries)
                sdentries = await self._load_dir(ev["sparent"])
                if sdentries is not None and ev["sname"] in sdentries:
                    del sdentries[ev["sname"]]
                    await self._save_dir(ev["sparent"], sdentries)
            # old-frag cleanup (also on replay after a crash between the
            # flip and the deletes): remove a source object only if its
            # CONTENT matches the journaled post-state — a re-created
            # directory at the old path has different contents and is
            # left alone (content-addressed idempotency)
            for rel, frag in ev["frags"].items():
                old_path = posixpath.join(ev["src"], rel) if rel \
                    else ev["src"]
                cur = await self._load_dir(old_path)
                if cur is None or (fully_applied and cur != frag):
                    continue
                try:
                    await self.meta.remove(self._dir_oid(old_path))
                except RadosError:
                    pass
        elif op == "snap_create":
            table = await self._load_snaptable()
            table[ev["key"]] = {"root": ev["root"], "name": ev["name"],
                                "created": ev.get("created", 0.0),
                                "tree": ev["tree"]}
            await self._save_snaptable(table)
        elif op == "snap_delete":
            table = await self._load_snaptable()
            if ev["key"] in table:
                del table[ev["key"]]
                await self._save_snaptable(table)
            for ino in ev.get("drop", ()):
                try:
                    await self.striper.remove(self._file_oid(ino))
                except RadosError:
                    pass

    # -- dentries ------------------------------------------------------------

    @staticmethod
    def _norm(path: str) -> str:
        p = posixpath.normpath("/" + path.strip("/"))
        return p

    @staticmethod
    def _dir_oid(path: str) -> str:
        return f"dir:{path}"

    @staticmethod
    def _file_oid(ino: str) -> str:
        # data rides an IMMUTABLE inode id (the reference's <ino>.<frag>
        # layout), so rename never touches data objects
        return f"ino:{ino}"

    async def _load_dir(self, path: str) -> Optional[Dict[str, Dict]]:
        try:
            return json.loads(await self.meta.read(self._dir_oid(path)))
        except RadosError:
            return None

    async def _save_dir(self, path: str, dentries: Dict[str, Dict]) -> None:
        await self.meta.write_full(self._dir_oid(path),
                                   json.dumps(dentries).encode())

    async def mkfs(self) -> None:
        if await self._load_dir("/") is None:
            await self._save_dir("/", {})

    async def _parent_of(self, path: str):
        parent = posixpath.dirname(path)
        name = posixpath.basename(path)
        dentries = await self._load_dir(parent)
        if dentries is None:
            raise FsError(f"ENOENT: parent {parent}")
        return parent, name, dentries

    # -- namespace ops -------------------------------------------------------

    async def mkdir(self, path: str, owner: Optional[str] = None) -> None:
        path = self._norm(path)
        if path == "/":
            raise FsError("EEXIST: /")
        async with self._mutate:
            parent, name, dentries = await self._parent_of(path)
            if name in dentries:
                raise FsError(f"EEXIST: {path}")
            # no umask model: creations default to world-rw (0777/0666
            # like a 000-umask process) so multi-client workflows keep
            # working until an owner narrows with chmod
            dentry = {"type": "dir", "mtime": time.time(), "mode": 0o777}
            if owner is not None:
                dentry["owner"] = owner
            event = {"op": "set_dentry", "parent": parent, "name": name,
                     "mkdir": path, "dentry": dentry}
            await self._journal(event)
            await self._apply_event(event)
            await self._journal_applied()

    async def chmod(self, path: str, mode: int,
                    requester: Optional[str] = None) -> None:
        """Journaled permission-bit update (reference CInode mode +
        MClientRequest setattr): merges into the dentry, preserving
        everything else.  The ownership gate runs HERE, under _mutate,
        against the dentry the change will land on — a check-then-act
        pair outside the lock would race a rename re-binding the
        path."""
        path = self._norm(path)
        if path == "/":
            raise FsError("EPERM: cannot chmod /")
        async with self._mutate:
            parent, name, dentries = await self._parent_of(path)
            if name not in dentries:
                raise FsError(f"ENOENT: {path}")
            owner = dentries[name].get("owner")
            if requester is not None and owner is not None \
                    and owner != requester:
                raise FsError(f"EPERM: {path} owned by {owner}")
            event = {"op": "setattr_dentry", "parent": parent,
                     "name": name, "attrs": {"mode": int(mode) & 0o7777}}
            await self._journal(event)
            await self._apply_event(event)
            await self._journal_applied()

    async def listdir(self, path: str) -> List[str]:
        path = self._norm(path)
        dentries = await self._load_dir(path)
        if dentries is None:
            raise FsError(f"ENOENT: {path}")
        return sorted(dentries)

    async def stat(self, path: str) -> Dict:
        path = self._norm(path)
        if path == "/":
            return {"type": "dir"}
        parent, name, dentries = await self._parent_of(path)
        if name not in dentries:
            raise FsError(f"ENOENT: {path}")
        return dict(dentries[name])

    async def write_file(self, path: str, data: bytes,
                         owner: Optional[str] = None) -> None:
        path = self._norm(path)
        # data rides a FRESH inode, written OUTSIDE the rank mutation
        # lock: bulk data transfers from unrelated files proceed
        # concurrently, and the dentry flip below makes each write an
        # atomic whole-file replace (an inode without a dentry is
        # harmless garbage; a dentry without data would not be)
        ino = uuid.uuid4().hex
        await self.striper.write(self._file_oid(ino), data)
        async with self._mutate:
            parent, name, dentries = await self._parent_of(path)
            existing = dentries.get(name)
            if existing and existing["type"] == "dir":
                raise FsError(f"EISDIR: {path}")
            dentry = {"type": "file", "size": len(data),
                      "mtime": time.time(), "ino": ino}
            if existing:
                # overwrite keeps identity metadata (POSIX: writing
                # does not chown/chmod)
                for k in ("mode", "owner"):
                    if k in existing:
                        dentry[k] = existing[k]
            else:
                dentry["mode"] = 0o666
                if owner is not None:
                    dentry["owner"] = owner
            event = {"op": "set_dentry", "parent": parent, "name": name,
                     "dentry": dentry}
            if existing and existing.get("ino"):
                # the replaced inode's data is dropped in the same
                # journaled event (concurrent readers are excluded by the
                # caps layer: writes need the exclusive cap) — UNLESS a
                # snapshot pins it (COW: the snap keeps the old bytes)
                if existing["ino"] not in self._snap_inos(
                        await self._load_snaptable(use_cache=True)):
                    event["drop_old_ino"] = existing["ino"]
            await self._journal(event)
            await self._apply_event(event)
            await self._journal_applied()

    async def read_file(self, path: str) -> bytes:
        path = self._norm(path)
        parent, name, dentries = await self._parent_of(path)
        ent = dentries.get(name)
        if ent is None:
            raise FsError(f"ENOENT: {path}")
        if ent["type"] != "file":
            raise FsError(f"EISDIR: {path}")
        return await self.striper.read(self._file_oid(ent["ino"]))

    async def unlink(self, path: str) -> None:
        path = self._norm(path)
        async with self._mutate:
            parent, name, dentries = await self._parent_of(path)
            ent = dentries.get(name)
            if ent is None:
                raise FsError(f"ENOENT: {path}")
            event = {"op": "rm_dentry", "parent": parent, "name": name}
            if ent["type"] == "dir":
                children = await self._load_dir(path)
                if children:
                    raise FsError(f"ENOTEMPTY: {path}")
                event["rmdir"] = path
            elif ent["ino"] not in self._snap_inos(
                    await self._load_snaptable(use_cache=True)):
                event["drop_ino"] = ent["ino"]
            await self._journal(event)
            await self._apply_event(event)
            await self._journal_applied()

    async def rename(self, src: str, dst: str) -> None:
        """File rename is a dentry-only move (the inode id stays, so no
        data transfer and no window where the data exists twice).
        Directory rename additionally RE-KEYS the subtree's dirfrag
        objects — dirfrags are path-keyed here, so this is O(subtree)
        where the reference's inode-keyed layout is O(1); the whole
        re-key rides ONE journal event, so replay finishes a half-moved
        tree."""
        src, dst = self._norm(src), self._norm(dst)
        async with self._mutate:
            sparent, sname, sdentries = await self._parent_of(src)
            ent = sdentries.get(sname)
            if ent is None:
                raise FsError(f"ENOENT: {src}")
            if ent["type"] == "dir":
                await self._rename_dir_locked(src, dst, ent)
                return
            dparent, dname, ddentries = await self._parent_of(dst)
            if ddentries.get(dname, {}).get("type") == "dir":
                raise FsError(f"EISDIR: {dst}")
            if src == dst:
                return
            old_dst = (sdentries if dparent == sparent
                       else ddentries).get(dname)
            # one journal event covering the whole multi-object update:
            # set the destination dentry FIRST, then drop the source
            # (replay after a crash between the two completes the move;
            # worst case both dentries briefly exist, never neither — the
            # reference's EUpdate orders its metablob the same way)
            subs = [{"op": "set_dentry", "parent": dparent, "name": dname,
                     "dentry": ent},
                    {"op": "rm_dentry", "parent": sparent, "name": sname}]
            if (old_dst and old_dst.get("ino")
                    and old_dst["ino"] != ent.get("ino")
                    and old_dst["ino"] not in self._snap_inos(
                        await self._load_snaptable(use_cache=True))):
                subs.append({"op": "drop_ino", "ino": old_dst["ino"]})
            event = {"op": "rename", "events": subs}
            await self._journal(event)
            await self._apply_event(event)
            await self._journal_applied()

    # -- snapshots (reference src/mds/SnapServer.cc + SnapRealm COW) ---------
    #
    # The fresh-inode-per-write discipline makes file data naturally
    # copy-on-write: a snapshot is a frozen {relpath -> dentry} tree in
    # the snap table plus a liveness rule — an inode referenced by any
    # snapshot is never dropped by overwrite/unlink/rename.  Snapshots
    # are crash-consistent (callers flush their write-behind first; the
    # client does).  In multi-rank deployments every snap-table mutation
    # routes through rank 0, the reference's snapserver seat.

    SNAPS_OID = "mds_snaptable"

    async def _load_snaptable(self, use_cache: bool = False
                              ) -> Dict[str, Dict]:
        """The hot-path pinned-ino checks pass use_cache=True: with no
        snapshots (the common case) the cache is a dict-hit, not a
        meta-pool round-trip per mutation.  Cache coherence across
        FileSystem instances is the CLUSTER's job: MDSCluster snapshot
        ops run under an all-ranks barrier and invalidate every rank's
        cache (invalidate_snap_cache)."""
        if use_cache and self._snap_cache is not None:
            return self._snap_cache
        try:
            table = json.loads(await self.meta.read(self.SNAPS_OID))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            table = {}
        self._snap_cache = table
        return table

    def invalidate_snap_cache(self) -> None:
        self._snap_cache = None

    async def _save_snaptable(self, table: Dict[str, Dict]) -> None:
        await self.meta.write_full(self.SNAPS_OID,
                                   json.dumps(table).encode())
        self._snap_cache = table

    @staticmethod
    def _snap_inos(table: Dict[str, Dict]) -> set:
        out = set()
        for snap in table.values():
            for ent in snap.get("tree", {}).values():
                if ent.get("ino"):
                    out.add(ent["ino"])
        return out

    async def _collect_tree(self, root: str) -> Dict[str, Dict]:
        """{relpath -> dentry} for the subtree at root ('' = root dir
        itself); dirs carry {"type": "dir"}, files keep ino/size."""
        tree: Dict[str, Dict] = {}

        async def rec(path: str, rel: str) -> None:
            dentries = await self._load_dir(path)
            if dentries is None:
                return
            for name, ent in dentries.items():
                r = f"{rel}/{name}" if rel else name
                tree[r] = dict(ent)
                if ent["type"] == "dir":
                    await rec(posixpath.join(path, name), r)

        await rec(root, "")
        return tree

    async def snap_create(self, root: str, name: str) -> None:
        async with self._mutate:
            await self._snap_create_locked(root, name)

    async def _snap_create_locked(self, root: str, name: str) -> None:
        """Body of snap_create, caller holds the mutation barrier —
        MDSCluster calls this holding EVERY rank's lock, so no rank can
        race a drop_old_ino decision against the table commit."""
        root = self._norm(root)
        if "|" in name or "/" in name or not name:
            raise FsError(f"EINVAL: bad snap name {name!r}")
        if await self._load_dir(root) is None:
            raise FsError(f"ENOENT: {root}")
        table = await self._load_snaptable()
        key = f"{root}|{name}"
        if key in table:
            raise FsError(f"EEXIST: snap {name} on {root}")
        tree = await self._collect_tree(root)
        event = {"op": "snap_create", "key": key, "root": root,
                 "name": name, "tree": tree,
                 "created": time.time()}
        await self._journal(event)
        await self._apply_event(event)
        await self._journal_applied()

    async def snap_delete(self, root: str, name: str) -> None:
        async with self._mutate:
            await self._snap_delete_locked(root, name)

    async def _snap_delete_locked(self, root: str, name: str) -> None:
        root = self._norm(root)
        table = await self._load_snaptable()
        key = f"{root}|{name}"
        snap = table.get(key)
        if snap is None:
            raise FsError(f"ENOENT: snap {name} on {root}")
        # reclaim inodes only this snapshot pins AND no live dentry
        # references.  Liveness is decided by a NAMESPACE-WIDE walk, not
        # the snapshot-time path: a rename since the snapshot moved the
        # dentry (possibly out of the subtree) while the inode stayed
        # live — a path-stat would misread it as dead and destroy the
        # live file's data
        others = {k: v for k, v in table.items() if k != key}
        pinned_elsewhere = self._snap_inos(others)
        candidates = {ent["ino"] for ent in snap.get("tree", {}).values()
                      if ent.get("ino")
                      and ent["ino"] not in pinned_elsewhere}
        if candidates:
            live = {ent.get("ino")
                    for ent in (await self._collect_tree("/")).values()
                    if ent.get("ino")}
            candidates -= live
        event = {"op": "snap_delete", "key": key,
                 "drop": sorted(candidates)}
        await self._journal(event)
        await self._apply_event(event)
        await self._journal_applied()

    async def snap_list(self, root: str) -> List[str]:
        root = self._norm(root)
        table = await self._load_snaptable()
        return sorted(v["name"] for k, v in table.items()
                      if v.get("root") == root)

    async def _snap_entry(self, root: str, name: str) -> Dict:
        table = await self._load_snaptable()
        snap = table.get(f"{self._norm(root)}|{name}")
        if snap is None:
            raise FsError(f"ENOENT: snap {name} on {root}")
        return snap

    async def listdir_snap(self, root: str, name: str,
                           rel: str = "") -> List[str]:
        snap = await self._snap_entry(root, name)
        rel = rel.strip("/")
        if rel:
            ent = snap.get("tree", {}).get(rel)
            if ent is None:
                raise FsError(f"ENOENT: {rel} in snap {name}")
            if ent["type"] != "dir":
                raise FsError(f"ENOTDIR: {rel}")
        prefix = f"{rel}/" if rel else ""
        out = set()
        for r in snap.get("tree", {}):
            if r.startswith(prefix) and r != rel:
                out.add(r[len(prefix):].split("/")[0])
        return sorted(out)

    async def read_snap_file(self, root: str, name: str,
                             rel: str) -> bytes:
        snap = await self._snap_entry(root, name)
        ent = snap.get("tree", {}).get(rel.strip("/"))
        if ent is None:
            raise FsError(f"ENOENT: {rel} in snap {name}")
        if ent["type"] != "file":
            raise FsError(f"EISDIR: {rel}")
        return await self.striper.read(self._file_oid(ent["ino"]))

    async def _rename_dir_locked(self, src: str, dst: str,
                                 ent: Dict) -> None:
        """Directory move (caller holds _mutate).  Guards: dst must not
        exist (no dir-over-dir replace), dst must not be inside src
        (EINVAL, the classic cycle), parents must exist.  The journal
        event carries the POST-STATE dirfrag contents (like every other
        event), so replay never re-reads live objects a later mkdir may
        have re-created."""
        if src == dst:
            return  # POSIX: same entry, success
        if is_under(dst, src):
            raise FsError(f"EINVAL: cannot move {src} into itself")
        dparent, dname, ddentries = await self._parent_of(dst)
        if dname in ddentries:
            raise FsError(f"EEXIST: {dst}")
        # post-state snapshot: rel dir path -> its dentries (root = ""),
        # collected in ONE walk (each dirfrag read exactly once while
        # the rank lock is held)
        frags: Dict[str, Dict] = {}

        async def collect(path: str, rel: str) -> None:
            dentries = dict(await self._load_dir(path) or {})
            frags[rel] = dentries
            for name, e in dentries.items():
                if e["type"] == "dir":
                    await collect(posixpath.join(path, name),
                                  f"{rel}/{name}" if rel else name)

        await collect(src, "")
        sparent = posixpath.dirname(src)
        sname = posixpath.basename(src)
        event = {"op": "rename_dir", "src": src, "dst": dst,
                 "frags": frags,
                 "sparent": sparent, "sname": sname,
                 "dparent": dparent, "dname": dname, "dentry": ent}
        await self._journal(event)
        await self._apply_event(event)
        await self._journal_applied()

    async def walk(self, path: str = "/") -> Dict:
        """Recursive tree dump (debugging/`ceph fs dump` role)."""
        path = self._norm(path)
        out: Dict = {}
        for name in await self.listdir(path):
            full = posixpath.join(path, name)
            st = await self.stat(full)
            if st["type"] == "dir":
                out[name] = await self.walk(full)
            else:
                out[name] = st.get("size", 0)
        return out


# -- client sessions + capabilities (reference src/mds/SessionMap.h,
#    src/mds/Locker.cc caps/lease machinery) ---------------------------------


def may_access(st: Optional[Dict], client: Optional[str],
               want: str, path: str = "") -> None:
    """THE permission check (reference Client::may_read/may_write/
    may_open), shared by the server's path ops, snapshot reads, and
    open_file: owner and unstamped entries pass; others need the
    other-class bit of the mode (default world-rw 0o666 — no umask
    model).  `st` None (absent file) passes: creation is allowed,
    parent-directory permissions are out of scope."""
    if st is None:
        return
    owner = st.get("owner")
    if owner is None or owner == client:
        return
    bits = int(st.get("mode", 0o666))
    if want == "r" and not bits & 0o004:
        raise FsError(f"EACCES: {path} not readable")
    if want == "w" and not bits & 0o002:
        raise FsError(f"EACCES: {path} not writable")


class CapConflict(FsError):
    """The cap is held by a live conflicting session (retry after the
    holder releases, acks the revoke, or its lease lapses)."""


class MDSSession:
    """One client's stateful session (reference Session): identity, a
    renewable lease, the caps it holds, and a revoke queue the client is
    expected to drain (ack) — exactly the contract CephFS clients follow."""

    def __init__(self, client: str, session_id: str, ttl: float):
        self.client = client
        self.session_id = session_id
        self.ttl = ttl
        self.renewed = time.monotonic()
        self.caps: Dict[str, str] = {}  # path -> "r" | "rw"
        self.revoked: List[str] = []  # paths the MDS wants back

    @property
    def expired(self) -> bool:
        return time.monotonic() - self.renewed > self.ttl

    def renew(self) -> List[str]:
        """Refresh the lease; returns (and clears) pending revokes — the
        client must stop using those paths and release_cap() them."""
        self.renewed = time.monotonic()
        out, self.revoked = self.revoked, []
        return out


class MDSServer:
    """Session/caps gatekeeper over a FileSystem (reference mds Server +
    Locker in miniature): clients open sessions, acquire read (shared) or
    rw (exclusive) capabilities per path, and operate through the server,
    which enforces that the needed cap is held and live.  Conflicting
    grants revoke the loser: live holders get the path queued on their
    revoke list and the requester is refused with CapConflict until the
    holder releases or its lease lapses (session autoclose role).

    Divergence by design: path-granular caps (the reference's are
    per-inode with Fw/Fr/Fx bit splits).  One MDSServer serves one
    RANK; multi-active deployments compose several through
    mds_cluster.MDSCluster, which owns subtree authority + migration."""

    def __init__(self, fs: FileSystem, session_timeout: float = 60.0):
        self.fs = fs
        self.session_timeout = session_timeout
        self.sessions: Dict[str, MDSSession] = {}
        # path -> {session_id: mode}
        self._caps: Dict[str, Dict[str, str]] = {}

    # -- session lifecycle ---------------------------------------------------

    def open_session(self, client: str) -> MDSSession:
        s = MDSSession(client, uuid.uuid4().hex, self.session_timeout)
        self.sessions[s.session_id] = s
        return s

    def close_session(self, session_id: str) -> None:
        s = self.sessions.pop(session_id, None)
        if s is None:
            return
        for path in list(s.caps):
            self._drop(path, session_id)

    def _evict_if_dead(self, session_id: str) -> bool:
        s = self.sessions.get(session_id)
        if s is None:
            return True
        if s.expired:
            self.close_session(session_id)  # autoclose: caps released
            return True
        return False

    def _drop(self, path: str, session_id: str) -> None:
        holders = self._caps.get(path)
        if holders:
            holders.pop(session_id, None)
            if not holders:
                self._caps.pop(path, None)
        s = self.sessions.get(session_id)
        if s:
            s.caps.pop(path, None)

    # -- capabilities --------------------------------------------------------

    def acquire_cap(self, session: MDSSession, path: str,
                    mode: str = "r") -> None:
        """Grant `mode` on `path` or raise CapConflict.  "r" caps are
        shared; "rw" is exclusive.  Conflicting live holders get the path
        queued for revoke (they learn at their next renew()); dead
        holders are evicted on the spot."""
        assert mode in ("r", "rw")
        if self._evict_if_dead(session.session_id):
            raise FsError("ESTALE: session expired")
        path = FileSystem._norm(path)
        conflict = False
        for sid, held in list(self._caps.get(path, {}).items()):
            if sid == session.session_id:
                continue
            if mode == "r" and held == "r":
                continue  # shared read
            if self._evict_if_dead(sid):
                continue
            # live conflicting holder: ask for the cap back, refuse now
            other = self.sessions[sid]
            if path not in other.revoked:
                other.revoked.append(path)
            conflict = True
        if conflict:
            raise CapConflict(f"EAGAIN: cap on {path} held elsewhere")
        # re-fetch AFTER evictions: evicting the last holder pops the
        # path's dict from _caps, and granting into the detached dict
        # would make the cap invisible to later conflict checks
        holders = self._caps.setdefault(path, {})
        holders[session.session_id] = mode
        session.caps[path] = mode
        if path in session.revoked:
            session.revoked.remove(path)  # fresh grant supersedes

    def release_cap(self, session: MDSSession, path: str) -> None:
        path = FileSystem._norm(path)
        self._drop(path, session.session_id)
        # releasing IS complying with a pending revoke: a later fresh
        # grant must not trip over the stale revocation marker
        if path in session.revoked:
            session.revoked.remove(path)

    def _require(self, session: MDSSession, path: str, mode: str) -> None:
        if self._evict_if_dead(session.session_id):
            raise FsError("ESTALE: session expired")
        path = FileSystem._norm(path)
        held = session.caps.get(path)
        if held is None or (mode == "rw" and held != "rw"):
            # implicit acquisition, as clients do on open
            self.acquire_cap(session, path, mode)
        elif path in session.revoked:
            raise FsError(f"ESTALE: cap on {path} revoked; renew first")

    # -- capped operations (the libcephfs-style surface) ---------------------

    async def write_file(self, session: MDSSession, path: str,
                         data: bytes) -> None:
        self._require(session, path, "rw")
        await self._may(session, path, "w")
        await self.fs.write_file(path, data, owner=session.client)

    async def read_file(self, session: MDSSession, path: str) -> bytes:
        self._require(session, path, "r")
        await self._may(session, path, "r")
        return await self.fs.read_file(path)

    async def mkdir(self, session: MDSSession, path: str) -> None:
        self._require(session, path, "rw")
        await self.fs.mkdir(path, owner=session.client)

    async def chmod(self, session: MDSSession, path: str,
                    mode: int) -> None:
        """Owner-gated permission update (POSIX chmod needs ownership,
        not write permission; files created before ownership stamping
        have no owner and stay mutable by anyone, like uid-0-less
        legacy data).  Ownership verifies INSIDE FileSystem.chmod
        under the mutation lock; here only session liveness."""
        if self._evict_if_dead(session.session_id):
            raise FsError("ESTALE: session expired")
        await self.fs.chmod(path, mode, requester=session.client)

    async def _may(self, session: MDSSession, path: str,
                   want: str) -> None:
        """Mode-bit check for the path-based surface: one shared rule
        (module-level may_access) for every enforcement point."""
        try:
            st = await self.fs.stat(path)
        except FsError:
            return
        may_access(st, session.client, want, path)

    async def unlink(self, session: MDSSession, path: str) -> None:
        self._require(session, path, "rw")
        await self.fs.unlink(path)
        self._drop(FileSystem._norm(path), session.session_id)

    def _revoke_subtree(self, root: str, keep_session: str) -> bool:
        """Queue revokes for every OTHER session's caps under `root`
        (directory rename must not strand caps naming dead paths);
        returns True if a live conflicting holder remains."""
        root = FileSystem._norm(root)
        conflict = False
        for path, holders in list(self._caps.items()):
            if not is_under(path, root):
                continue
            for sid in list(holders):
                if sid == keep_session:
                    continue
                if self._evict_if_dead(sid):
                    continue
                other = self.sessions[sid]
                if path not in other.revoked:
                    other.revoked.append(path)
                conflict = True
        return conflict

    async def rename(self, session: MDSSession, src: str, dst: str) -> None:
        self._require(session, src, "rw")
        self._require(session, dst, "rw")
        src_n, dst_n = FileSystem._norm(src), FileSystem._norm(dst)
        is_dir = False
        try:
            is_dir = (await self.fs.stat(src_n))["type"] == "dir"
        except FsError:
            pass
        if is_dir and self._revoke_subtree(src_n, session.session_id):
            # live holders under the moving tree must flush + release
            # first, or their write-behind would later flush into dead
            # paths (same compliance contract as subtree export)
            raise CapConflict(
                f"EAGAIN: caps under {src_n} held elsewhere")
        await self.fs.rename(src, dst)
        if is_dir:
            # every cap under either path now names a dead (or brand
            # new) path: drop them; clients re-acquire at the new paths
            for path in list(self._caps):
                if is_under(path, src_n) or is_under(path, dst_n):
                    for sid in list(self._caps.get(path, {})):
                        self._drop(path, sid)

    async def listdir(self, session: MDSSession, path: str) -> List[str]:
        self._require(session, path, "r")
        return await self.fs.listdir(path)

    async def stat(self, session: MDSSession, path: str) -> Dict:
        self._require(session, path, "r")
        return await self.fs.stat(path)

    # snapshots: creation is a metadata write on the root (rw); reads
    # are read-capped on the root, like the reference's .snap dirs
    async def snap_create(self, session: MDSSession, path: str,
                          name: str) -> None:
        self._require(session, path, "rw")
        await self.fs.snap_create(path, name)

    async def snap_delete(self, session: MDSSession, path: str,
                          name: str) -> None:
        self._require(session, path, "rw")
        await self.fs.snap_delete(path, name)

    async def snap_list(self, session: MDSSession, path: str) -> List[str]:
        self._require(session, path, "r")
        return await self.fs.snap_list(path)

    async def read_snap_file(self, session: MDSSession, path: str,
                             name: str, rel: str) -> bytes:
        self._require(session, path, "r")
        # the snapshot captured the file's mode/owner with its dentry:
        # a 0600 file's content must not leak through a snapshot of an
        # ancestor (r5 review bypass)
        snap = await self.fs._snap_entry(FileSystem._norm(path), name)
        may_access(snap.get("tree", {}).get(rel.strip("/")),
                   session.client, "r", f"{path}@{name}/{rel}")
        return await self.fs.read_snap_file(path, name, rel)

    async def listdir_snap(self, session: MDSSession, path: str,
                           name: str, rel: str = "") -> List[str]:
        self._require(session, path, "r")
        return await self.fs.listdir_snap(path, name, rel)


class CephFSClient:
    """The CLIENT half of the filesystem (reference src/client/Client.cc
    in miniature): a cap-aware cache over an MDSServer session.

    Capability semantics, as the reference client enforces them in its
    own cache (Client.cc Fc/Fb handling):
    - under a SHARED "r" cap, reads are cached locally and served
      without touching the MDS until the cap goes away;
    - under an EXCLUSIVE "rw" cap, writes are WRITE-BEHIND: they land in
      the local dirty cache and reach the MDS only on flush — revoke,
      release, fsync, or unmount;
    - a revoke (delivered on lease renewal, the reference's cap message
      flow) forces compliance before the conflicting client's grant can
      succeed: flush dirty bytes, drop the cache, release the cap.

    Coherence across clients therefore holds exactly because the server
    refuses a conflicting grant until the holder has complied — the
    writer's dirty data is visible to the next reader by construction.

    ``renew_interval`` piggybacks a lease renewal (and thus revoke
    processing) on client operations, so a busy client converges without
    a background thread; tests and embedders may call renew() directly.
    """

    def __init__(self, mds: MDSServer, client: str = "client",
                 renew_interval: float = 1.0):
        self.mds = mds
        self.client_name = client
        self.session = mds.open_session(client)
        self.renew_interval = renew_interval
        self._last_renew = time.monotonic()
        self._clean: Dict[str, bytes] = {}  # path -> cached file data
        self._dirty: Dict[str, bytes] = {}  # path -> write-behind data
        self.cache_hits = 0
        self.flushes = 0

    # -- cap compliance ------------------------------------------------------

    async def renew(self) -> None:
        """Renew the lease and COMPLY with pending revokes: flush dirty
        data, drop the cache, release the cap — the contract that lets
        the MDS grant the path to the conflicting client."""
        for path in self.mds.sessions.get(
                self.session.session_id, self.session).renew():
            await self._flush_path(path)
            self._clean.pop(path, None)
            self.mds.release_cap(self.session, path)

    async def _maybe_renew(self) -> None:
        if time.monotonic() - self._last_renew >= self.renew_interval:
            self._last_renew = time.monotonic()
            await self.renew()

    async def _flush_path(self, path: str) -> None:
        data = self._dirty.pop(path, None)
        if data is not None:
            self.flushes += 1
            await self.mds.write_file(self.session, path, data)
            self._clean[path] = data

    async def _acquire(self, path: str, mode: str,
                       retries: int = 20, delay: float = 0.05) -> None:
        """Acquire with revoke-processing retries: a CapConflict means a
        live holder was asked to give the cap back — renew (processing
        OUR revokes too) and retry while the holder complies."""
        for attempt in range(retries):
            try:
                self.mds.acquire_cap(self.session, path, mode)
                return
            except CapConflict:
                await self.renew()
                if attempt == retries - 1:
                    raise
                await asyncio.sleep(delay)

    # -- file surface (libcephfs role) ---------------------------------------

    async def write(self, path: str, data: bytes) -> None:
        await self._maybe_renew()
        held = self.session.caps.get(FileSystem._norm(path))
        if held != "rw":
            await self._acquire(path, "rw")
        # write-behind under the exclusive cap: bytes stay local
        self._dirty[FileSystem._norm(path)] = bytes(data)

    async def read(self, path: str) -> bytes:
        # whole-file read = positional read of everything: ONE copy of
        # the dirty/clean/server tier logic (_image), one counter
        return await self.pread(path, 0, -1)

    async def fsync(self, path: str) -> None:
        # process pending revokes FIRST: flushing a path whose cap was
        # revoked would ESTALE mid-flush (renew() both complies and
        # flushes revoked paths, so the dirty bytes land either way)
        await self.renew()
        await self._flush_path(FileSystem._norm(path))

    async def mkdir(self, path: str) -> None:
        await self._maybe_renew()
        await self.mds.mkdir(self.session, path)

    async def listdir(self, path: str) -> List[str]:
        await self._maybe_renew()
        # a fresh listing must see peers' flushed creates: dir listings
        # are not cached (the reference caches dentries under Fs caps;
        # path-granular caps make that a follow-up, not a default)
        return await self.mds.listdir(self.session, path)

    async def stat(self, path: str) -> Dict:
        await self._maybe_renew()
        p = FileSystem._norm(path)
        if p in self._dirty:
            return {"type": "file", "size": len(self._dirty[p])}
        return await self.mds.stat(self.session, path)

    async def unlink(self, path: str) -> None:
        await self._maybe_renew()
        p = FileSystem._norm(path)
        self._dirty.pop(p, None)
        self._clean.pop(p, None)
        await self._acquire(path, "rw")
        await self.mds.unlink(self.session, path)

    async def rename(self, path: str, dst: str) -> None:
        """Rename through the server (cap-checked; directory renames
        force other holders under the tree to comply first).  The local
        cache entries under BOTH paths are purged — they name dead
        paths afterwards."""
        s, d = FileSystem._norm(path), FileSystem._norm(dst)
        await self.renew()
        # our own write-behind under the source tree must land first:
        # it flushes by OLD path, which is only writable pre-rename
        for dirty in list(self._dirty):
            if is_under(dirty, s):
                await self._flush_path(dirty)
        # few internal retries only: OTHER holders comply through THEIR
        # renewals, which an embedding facade drives between ITS retries
        # — spinning here would just delay that outer loop
        for attempt in range(3):
            try:
                await self.mds.rename(self.session, s, d)
                break
            except CapConflict:
                await self.renew()
                if attempt == 2:
                    raise
                await asyncio.sleep(0.02)
        for cache in (self._dirty, self._clean):
            for p in list(cache):
                if is_under(p, s) or is_under(p, d):
                    cache.pop(p, None)
        for p in list(self.session.caps):
            if is_under(p, s) or is_under(p, d):
                self.mds.release_cap(self.session, p)

    # -- snapshots -----------------------------------------------------------

    async def snap_create(self, path: str, name: str) -> None:
        """Snapshot the subtree at `path`.  The client's own
        write-behind bytes under the subtree are flushed FIRST, so the
        snapshot captures them (crash consistency is only as good as
        what has reached the MDS)."""
        await self.renew()
        p = FileSystem._norm(path)
        for dirty in list(self._dirty):
            if is_under(dirty, p):
                await self._flush_path(dirty)
        await self.mds.snap_create(self.session, path, name)

    async def snap_delete(self, path: str, name: str) -> None:
        await self._maybe_renew()
        await self.mds.snap_delete(self.session, path, name)

    async def snap_list(self, path: str) -> List[str]:
        await self._maybe_renew()
        return await self.mds.snap_list(self.session, path)

    async def read_snap(self, path: str, name: str, rel: str) -> bytes:
        await self._maybe_renew()
        # same conflict-retry discipline as every capped op: the
        # implicit "r" acquisition on the snap root may need a holder
        # to comply first
        for attempt in range(20):
            try:
                return await self.mds.read_snap_file(
                    self.session, path, name, rel)
            except CapConflict:
                await self.renew()
                if attempt == 19:
                    raise
                await asyncio.sleep(0.05)

    async def listdir_snap(self, path: str, name: str,
                           rel: str = "") -> List[str]:
        await self._maybe_renew()
        return await self.mds.listdir_snap(self.session, path, name, rel)

    # -- positional I/O (the ll_read/ll_write substrate for handles) ---------

    async def _image(self, p: str, create: bool = False) -> bytes:
        """The file's current image through the cache tiers (the ONE
        copy of the dirty/clean/server resolution — read() and the
        positional ops all ride it): our own write-behind bytes, the
        clean cache, else the server.  ENOENT raises unless `create`
        (the write path treats a missing file as empty)."""
        if p in self._dirty:
            self.cache_hits += 1
            return self._dirty[p]
        if p in self._clean and self.session.caps.get(p):
            self.cache_hits += 1
            return self._clean[p]
        try:
            data = await self.mds.read_file(self.session, p)
        except FsError as e:
            if create and "ENOENT" in str(e):
                return b""
            raise
        self._clean[p] = data
        return data

    async def _image_capped(self, p: str, mode: str,
                            create: bool = False) -> bytes:
        """Acquire (or upgrade to) `mode` and resolve the image.  A
        permission denial RELEASES the cap acquired for this very op —
        a denied client squatting an exclusive cap would wedge every
        authorized client behind a revoke it has no reason to answer."""
        had = self.session.caps.get(p)
        need = (had is None) if mode == "r" else (had != "rw")
        if need and not (mode == "r" and p in self._dirty):
            await self._acquire(p, mode)
        try:
            if mode == "rw":
                # write permission checks UP FRONT, not at flush time:
                # a denied write surfacing later from renew() would
                # have already dropped the dirty bytes and left this
                # client squatting the exclusive cap (r5 review repro)
                await self.mds._may(self.session, p, "w")
            return await self._image(p, create=create)
        except FsError as e:
            if "EACCES" in str(e) and had != self.session.caps.get(p):
                self.mds.release_cap(self.session, p)
            raise

    async def pread(self, path: str, off: int, n: int = -1) -> bytes:
        await self._maybe_renew()
        p = FileSystem._norm(path)
        data = await self._image_capped(p, "r")
        return data[off:] if n < 0 else data[off:off + n]

    async def pwrite(self, path: str, off: int, data: bytes) -> int:
        """Positional write-behind: splice `data` at `off` over the
        current image (zero-extending a hole), dirty under the
        exclusive cap (Client::_write role)."""
        await self._maybe_renew()
        p = FileSystem._norm(path)
        buf = bytearray(await self._image_capped(p, "rw", create=True))
        if len(buf) < off:
            buf.extend(b"\x00" * (off - len(buf)))
        buf[off:off + len(data)] = data
        self._dirty[p] = bytes(buf)
        return len(data)

    async def append(self, path: str, data: bytes) -> int:
        """O_APPEND write: EOF resolves and the splice lands in ONE
        step under the exclusive cap, so a concurrent client cannot
        slip an append between a stat and a pwrite.  Returns the
        offset the data landed at."""
        await self._maybe_renew()
        p = FileSystem._norm(path)
        buf = bytearray(await self._image_capped(p, "rw", create=True))
        off = len(buf)
        buf.extend(data)
        self._dirty[p] = bytes(buf)
        return off

    async def truncate(self, path: str, size: int) -> None:
        await self._maybe_renew()
        p = FileSystem._norm(path)
        buf = bytearray(await self._image_capped(p, "rw", create=True))
        if len(buf) < size:
            buf.extend(b"\x00" * (size - len(buf)))
        else:
            del buf[size:]
        self._dirty[p] = bytes(buf)

    async def chmod(self, path: str, mode: int) -> None:
        await self._maybe_renew()
        # our own write-behind must land first: the file may exist only
        # in the dirty cache, and FileSystem.chmod stats the server
        await self._flush_path(FileSystem._norm(path))
        await self.mds.chmod(self.session, path, mode)

    async def open(self, path: str, mode: str = "r") -> "CephFSFile":
        return await open_file(self, path, mode)

    async def unmount(self) -> None:
        """Flush every dirty file, release every cap, close the session
        (the reference client's unmount barrier)."""
        await self.renew()  # comply with pending revokes before flushing
        for path in list(self._dirty):
            await self._flush_path(path)
        self._clean.clear()
        self.mds.close_session(self.session.session_id)


# -- file handles (libcephfs ll_open/ll_read/ll_write/ll_fsync role) ---------


async def open_file(io, path: str, mode: str = "r") -> "CephFSFile":
    """Open a handle on `io` (a CephFSClient or any facade exposing the
    same pread/pwrite/truncate/stat/fsync surface).  Modes follow the
    POSIX open flags the reference's ll_open honors:

      r   read-only, must exist (O_RDONLY)
      r+  read/write, must exist (O_RDWR)
      w   write-only, create or TRUNCATE (O_WRONLY|O_CREAT|O_TRUNC)
      a   write-only append, create if missing (O_WRONLY|O_CREAT|O_APPEND)

    Permission checks happen HERE (EISDIR on directories, ENOENT for
    must-exist modes) and per-op (EBADF for the wrong direction on a
    one-way handle) — cap acquisition rides the first read/write, per
    handle direction."""
    if mode not in ("r", "r+", "w", "a"):
        raise FsError(f"EINVAL: bad open mode {mode!r}")
    p = FileSystem._norm(path)
    st = None
    last: Optional[FsError] = None
    for _attempt in range(50):
        try:
            st = await io.stat(p)
            break
        except FsError as e:
            if "ENOENT" in str(e):
                st = None
                break
            if "EAGAIN" not in str(e) and "ESTALE" not in str(e):
                raise
            # a conflicting holder was asked for the cap back: drive
            # our own revoke compliance and retry while it complies
            # (the same loop every capped client op runs)
            last = e
            renew = getattr(io, "renew_all", None) or getattr(
                io, "renew", None)
            if renew is not None:
                await renew()
            await asyncio.sleep(0.05)
    else:
        raise last if last is not None else FsError(f"EAGAIN: {p}")
    if st is not None and st.get("type") == "dir":
        raise FsError(f"EISDIR: {p}")
    if st is None and mode in ("r", "r+"):
        raise FsError(f"ENOENT: {p}")
    # permission bits: the ONE shared check (may_access) against the
    # open direction(s)
    me = getattr(io, "client_name", None)
    if mode in ("r", "r+"):
        may_access(st, me, "r", p)
    if mode in ("r+", "w", "a"):
        may_access(st, me, "w", p)
    fh = CephFSFile(io, p, mode)
    if mode == "w":
        # O_TRUNC|O_CREAT: the handle starts from an empty image (a
        # close with no writes still creates the empty file)
        await io.truncate(p, 0)
    elif mode == "a" and st is None:
        await io.truncate(p, 0)  # O_CREAT
    return fh


class CephFSFile:
    """An open file handle (reference Fh, src/client/Client.cc
    ll_read/ll_write semantics): per-handle mode enforcement, a
    sequential offset for read()/write(), positional pread/pwrite, and
    O_APPEND writes landing at the current EOF.  Data rides the owning
    client's cap-aware write-behind cache, so a revoke mid-write
    flushes and the next operation transparently re-acquires."""

    def __init__(self, io, path: str, mode: str):
        self._io = io
        self.path = path
        self.mode = mode
        self.offset = 0
        self.closed = False

    def _check(self, want: str) -> None:
        if self.closed:
            raise FsError(f"EBADF: {self.path} handle closed")
        if want == "r" and self.mode in ("w", "a"):
            raise FsError(f"EBADF: {self.path} not open for read")
        if want == "w" and self.mode == "r":
            raise FsError(f"EBADF: {self.path} not open for write")

    async def pread(self, off: int, n: int = -1) -> bytes:
        self._check("r")
        return await self._io.pread(self.path, off, n)

    async def pwrite(self, off: int, data: bytes) -> int:
        self._check("w")
        return await self._io.pwrite(self.path, off, data)

    async def read(self, n: int = -1) -> bytes:
        self._check("r")
        data = await self._io.pread(self.path, self.offset, n)
        self.offset += len(data)
        return data

    async def write(self, data: bytes) -> int:
        self._check("w")
        if self.mode == "a":
            # O_APPEND: EOF resolution and splice are ONE operation
            # under the exclusive cap (io.append) — a stat-then-pwrite
            # pair would let a concurrent append slip in between
            off = await self._io.append(self.path, data)
            self.offset = off + len(data)
            return len(data)
        n = await self._io.pwrite(self.path, self.offset, data)
        self.offset += n
        return n

    async def truncate(self, size: int) -> None:
        self._check("w")
        await self._io.truncate(self.path, size)

    async def fsync(self) -> None:
        if self.closed:
            raise FsError(f"EBADF: {self.path} handle closed")
        await self._io.fsync(self.path)

    async def close(self) -> None:
        """Flush on close (the reference's ll_release -> _flush): the
        handle's writes are durable at the MDS once close returns."""
        if self.closed:
            return
        self.closed = True
        if self.mode != "r":
            await self._io.fsync(self.path)

    async def __aenter__(self) -> "CephFSFile":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()
