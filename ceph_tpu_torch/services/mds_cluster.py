# Copy of ceph_tpu/services/mds_cluster.py at commit ac6dced, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Multi-active MDS: subtree partitioning, migration, and balancing.

Role-equivalent of the reference's multi-MDS metadata cluster (reference
src/mds/Migrator.cc subtree export/import, src/mds/MDBalancer.cc load
balancing, src/mds/MDSMap.h rank table): the namespace is partitioned by
DIRECTORY SUBTREE across N active ranks, each rank serializes and
journals mutations for the subtrees it is authoritative over, and
authority over a subtree can MIGRATE between ranks online.

TPU-first simplifications that keep the semantics honest:

- dirfrags live in shared RADOS objects, so migration moves AUTHORITY
  (who may mutate + grant caps), never data — the same property the
  reference gets from metadata-in-RADOS;
- the export protocol is two-phase against a persisted subtree map:
  freeze -> revoke caps under the subtree -> drain+flush the exporter's
  journal -> persist a pending record -> commit the map.  A crash
  between pending and commit is completed at next start() (the
  reference's EExport/EImportStart journal pair in miniature);
- cap/lease state is volatile per rank (the reference journals it in
  ESessions; here clients re-acquire after a rank replacement, the
  up:reconnect stage).

Single-rank deployments are unchanged: MDSCluster(n_ranks=1) behaves
exactly like a lone MDSServer.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import posixpath
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.rados.librados import IoCtx
from ceph_tpu_torch.services.mds import (CephFSClient, FileSystem, FsError,
                                   MDSServer, is_under as _is_under,
                                   open_file)

SUBTREE_MAP_OID = "mds_subtree_map"


def _norm(path: str) -> str:
    return FileSystem._norm(path)


class MDSCluster:
    """N active MDS ranks over one metadata/data pool pair.

    The subtree map (persisted at SUBTREE_MAP_OID) assigns each subtree
    root to a rank; a path's authority is the DEEPEST matching root (the
    reference resolves auth the same way through its subtree bounds).
    """

    def __init__(self, meta_ioctx: IoCtx, data_ioctx: Optional[IoCtx] = None,
                 n_ranks: int = 2, session_timeout: float = 60.0,
                 revoke_timeout: float = 5.0):
        self.meta = meta_ioctx
        self.data = data_ioctx or meta_ioctx
        self.n_ranks = int(n_ranks)
        self.session_timeout = session_timeout
        self.revoke_timeout = revoke_timeout
        self.epoch = 0
        self.subtrees: Dict[str, int] = {"/": 0}
        self.ranks: List[MDSServer] = []
        self._frozen: set = set()      # subtree roots mid-export
        self.rank_ops: List[int] = []  # balancer heat, per rank
        self._dir_ops: Dict[str, int] = {}  # top-level dir -> ops
        # serializes TOPOLOGY-changing operations (subtree export and
        # directory rename): a directory rename racing an export could
        # otherwise commit a subtree root whose path just moved
        self._topology = asyncio.Lock()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "MDSCluster":
        """Load (or create) the subtree map, start every rank (each
        replays its OWN journal — up:replay), and resolve any export
        that was cut down mid-flight."""
        try:
            m = json.loads(await self.meta.read(SUBTREE_MAP_OID))
            self.epoch = m["epoch"]
            self.subtrees = {p: int(r) for p, r in m["subtrees"].items()}
            pending = m.get("pending")
        except RadosError as e:
            import errno as _errno
            # a fresh map is only right for VERIFIED absence: writing
            # the default over a transiently-unreadable real map would
            # silently revert every migrated subtree to rank 0
            if e.code != -_errno.ENOENT:
                raise
            pending = None
            await self._save_map(pending=None)
        self.ranks = []
        for r in range(self.n_ranks):
            fs = FileSystem(self.meta, self.data,
                            journal_prefix=f"mds{r}.")
            if r == 0:
                await fs.mkfs()
            await fs.mount()
            self.ranks.append(MDSServer(fs, self.session_timeout))
        self.rank_ops = [0] * self.n_ranks
        if pending is not None:
            # the exporter flushed its journal BEFORE the pending record
            # was persisted, so completing the map flip is always safe
            # (EImportFinish replay role)
            self.subtrees[pending["path"]] = int(pending["to"])
            await self._save_map(pending=None)
        for r in range(self.n_ranks):
            async with self.ranks[r].fs._mutate:
                await self._reconcile_renames(r)
        return self

    async def _save_map(self, pending) -> None:
        self.epoch += 1
        await self.meta.write_full(SUBTREE_MAP_OID, json.dumps(
            {"epoch": self.epoch, "subtrees": self.subtrees,
             "pending": pending}).encode())

    # -- authority resolution ------------------------------------------------

    def rank_of(self, path: str) -> int:
        path = _norm(path)
        best, best_len = 0, -1
        for root, rank in self.subtrees.items():
            if _is_under(path, root):
                depth = 0 if root == "/" else root.count("/")
                if depth > best_len:
                    best, best_len = rank, depth
        return best

    def server(self, rank: int) -> MDSServer:
        return self.ranks[rank]

    def _check_frozen(self, path: str) -> None:
        path = _norm(path)
        for root in self._frozen:
            if _is_under(path, root):
                raise FsError(f"EAGAIN: subtree {root} migrating")

    def route(self, path: str) -> Tuple[int, MDSServer]:
        """(rank, authoritative server) for `path`, with balancer heat
        accounting; raises retryable EAGAIN while the covering subtree
        is mid-export (the reference freezes the exported CDir the same
        way)."""
        self._check_frozen(path)
        rank = self.rank_of(path)
        self.rank_ops[rank] += 1
        p = _norm(path)
        top = "/" + p.split("/")[1] if p != "/" else "/"
        self._dir_ops[top] = self._dir_ops.get(top, 0) + 1
        return rank, self.ranks[rank]

    # -- subtree migration (Migrator role) -----------------------------------

    async def export_dir(self, path: str, to_rank: int) -> None:
        """Move authority over the subtree at `path` to `to_rank`:
        freeze -> revoke caps -> drain + flush exporter journal ->
        persist pending -> commit map -> thaw.  Holds the topology lock
        so a concurrent directory rename cannot move the path out from
        under the commit."""
        path = _norm(path)
        if not (0 <= to_rank < self.n_ranks):
            raise FsError(f"EINVAL: no rank {to_rank}")
        from_rank = self.rank_of(path)
        if from_rank == to_rank:
            return
        src = self.ranks[from_rank]
        st = await src.fs.stat(path)
        if st["type"] != "dir":
            raise FsError(f"ENOTDIR: {path}")
        if path in self._frozen:
            raise FsError(f"EAGAIN: {path} already migrating")
        self._frozen.add(path)
        try:
            # the revoke wait (up to revoke_timeout of client
            # compliance) runs OUTSIDE the topology lock: one slow
            # client must not stall unrelated exports/renames
            await self._revoke_subtree_caps(src, path)
            # drain in-flight mutations, then flush: roll closes the
            # write segment so expire retires EVERY applied event —
            # without the roll, current-segment events survive and a
            # later replace_rank() of the exporter would replay them
            # onto dirfrags the importer has since rewritten.  The
            # re-validation + map commit hold topology + rank locks:
            # a directory rename (which takes the same pair) cannot
            # move the path between them.
            async with self._topology:
                # re-resolve UNDER the lock: an ancestor export that
                # committed while we waited may have moved authority —
                # draining the stale rank's journal would leave the
                # real authority's in-flight events undrained
                if self.rank_of(path) != from_rank:
                    raise FsError(f"EAGAIN: authority of {path} moved "
                                  f"during export; retry")
                async with src.fs._mutate:
                    if src.fs.mdlog is not None:
                        await src.fs.mdlog.roll()
                        await src.fs.mdlog.expire()
                    if await src.fs._load_dir(path) is None:
                        raise FsError(f"EAGAIN: {path} vanished "
                                      f"before export commit")
                    # two-phase commit against the persisted map
                    await self._save_map(
                        pending={"path": path, "to": to_rank})
                    self.subtrees[path] = to_rank
                    await self._save_map(pending=None)
        finally:
            self._frozen.discard(path)

    async def _revoke_subtree_caps(self, src: MDSServer, root: str) -> None:
        """Queue revokes for every cap under the subtree and wait for
        the holders to comply (flush + release on their next renew).
        Holders that never comply within revoke_timeout are evicted —
        the session-autoclose semantics the reference applies to
        unresponsive clients."""
        deadline = time.monotonic() + self.revoke_timeout
        while True:
            live = []
            for path, holders in list(src._caps.items()):
                if not _is_under(path, root):
                    continue
                for sid in list(holders):
                    if src._evict_if_dead(sid):
                        continue
                    sess = src.sessions[sid]
                    if path not in sess.revoked:
                        sess.revoked.append(path)
                    live.append((path, sid))
            if not live:
                return
            if time.monotonic() >= deadline:
                # forcible eviction: identical outcome to lease expiry
                for path, sid in live:
                    src._drop(path, sid)
                return
            await asyncio.sleep(0.02)

    # -- snapshots (snapserver seat: rank 0) ---------------------------------

    @contextlib.asynccontextmanager
    async def _all_ranks_barrier(self):
        """Hold every rank's mutation lock (stable id order, matching
        the cross-rank rename's two-lock ordering, so the two cannot
        deadlock against each other)."""
        locks = sorted((r.fs for r in self.ranks), key=id)
        async with contextlib.AsyncExitStack() as stack:
            for fs in locks:
                await stack.enter_async_context(fs._mutate)
            yield

    async def snap_create(self, path: str, name: str) -> None:
        async with self._all_ranks_barrier():
            await self.ranks[0].fs._snap_create_locked(path, name)
            for r in self.ranks:
                r.fs.invalidate_snap_cache()

    async def snap_delete(self, path: str, name: str) -> None:
        async with self._all_ranks_barrier():
            await self.ranks[0].fs._snap_delete_locked(path, name)
            for r in self.ranks:
                r.fs.invalidate_snap_cache()

    def _guard_dir_move(self, src_path: str) -> None:
        """A directory move must not carry (or be) a SUBTREE ROOT — the
        map keys authority by path, so the root would dangle; export
        authority away first (EXDEV, the reference's unmovable subtree
        bounds).  Call with the topology lock held."""
        for root in self.subtrees:
            if root != "/" and _is_under(root, src_path):
                raise FsError(f"EXDEV: {src_path} contains/is subtree "
                              f"root {root}; move authority first")

    # -- cross-rank rename intent log ----------------------------------------
    # One log object per SOURCE rank ("mds<r>.rename_log"): an entry is
    # persisted BEFORE either dentry half mutates and removed after both
    # landed, so a crash between the two journal appends leaves a
    # durable intent that reconciliation completes (the reference's
    # EPeerUpdate prepare/commit pair in miniature).  All mutations of a
    # rank's log happen while holding that rank's _mutate lock.

    def _rename_log_oid(self, rank: int) -> str:
        return f"mds{rank}.rename_log"

    async def _load_rename_log(self, rank: int) -> List[Dict]:
        try:
            return json.loads(await self.meta.read(
                self._rename_log_oid(rank)))
        except RadosError as e:
            import errno as _errno
            if e.code != -_errno.ENOENT:
                raise
            return []

    async def _save_rename_log(self, rank: int,
                               entries: List[Dict]) -> None:
        await self.meta.write_full(self._rename_log_oid(rank),
                                   json.dumps(entries).encode())

    async def _reconcile_renames(self, rank: int,
                                 fs_override: Optional[FileSystem] = None
                                 ) -> None:
        """Complete (or discard) cross-rank renames whose source half
        may not have landed.  If the destination dentry shows the
        rename committed, the stale source dentry is removed — through
        the SOURCE rank's own journal; dirfrags of other ranks are only
        ever read."""
        entries = await self._load_rename_log(rank)
        if not entries:
            return
        fs_src = fs_override or self.ranks[rank].fs
        for e in list(entries):
            fs_dst = self.ranks[e["dst_rank"]].fs
            ddentries = await fs_dst._load_dir(e["dparent"])
            committed = bool(ddentries) and \
                ddentries.get(e["dname"], {}).get("ino") == e["ino"]
            if committed:
                sdentries = await fs_src._load_dir(e["sparent"])
                if sdentries is not None and \
                        sdentries.get(e["sname"], {}).get("ino") == e["ino"]:
                    ev = {"op": "rename", "events": [
                        {"op": "rm_dentry", "parent": e["sparent"],
                         "name": e["sname"]}]}
                    await fs_src._journal(ev)
                    await fs_src._apply_event(ev)
                    await fs_src._journal_applied()
            # not committed: the rename never happened — source stays
            entries.remove(e)
        await self._save_rename_log(rank, entries)

    # -- rank failure / replacement ------------------------------------------

    async def replace_rank(self, rank: int) -> MDSServer:
        """Stand up a replacement for a failed rank: a fresh server
        mounts the SAME per-rank journal and replays it (up:replay),
        then completes any cross-rank rename whose source half the
        crash cut short, then serves.  Sessions/caps are gone — clients
        reconnect (up:reconnect is client-driven here)."""
        fs = FileSystem(self.meta, self.data, journal_prefix=f"mds{rank}.")
        await fs.mount()
        async with fs._mutate:
            await self._reconcile_renames(rank, fs_override=fs)
        self.ranks[rank] = MDSServer(fs, self.session_timeout)
        return self.ranks[rank]

    # -- balancing (MDBalancer role) -----------------------------------------

    async def maybe_rebalance(self, ratio: float = 2.0) -> Optional[Tuple]:
        """If the hottest rank carries > `ratio` x the coldest rank's
        ops, export the hottest top-level subtree it owns to the coldest
        rank.  Returns (path, from, to) when a migration ran."""
        if self.n_ranks < 2 or not any(self.rank_ops):
            return None
        hot = max(range(self.n_ranks), key=lambda r: self.rank_ops[r])
        cold = min(range(self.n_ranks), key=lambda r: self.rank_ops[r])
        if self.rank_ops[hot] < ratio * max(1, self.rank_ops[cold]):
            return None
        candidates = [
            (ops, d) for d, ops in self._dir_ops.items()
            if d != "/" and self.rank_of(d) == hot
        ]
        if not candidates:
            return None
        _ops, path = max(candidates)
        try:
            if (await self.ranks[hot].fs.stat(path))["type"] != "dir":
                return None
        except FsError:
            return None
        await self.export_dir(path, cold)
        self.rank_ops = [0] * self.n_ranks
        self._dir_ops.clear()
        return (path, hot, cold)

    # -- cross-rank rename ---------------------------------------------------

    async def rename(self, src_path: str, dst_path: str) -> None:
        """Rename whose source and destination live under different
        authorities (the reference's slave-request rename): both ranks'
        mutation locks are held (rank order, so two concurrent cross
        renames cannot deadlock), the intent is journaled at the SOURCE
        rank as one event, and both dirfrag halves are applied under the
        locks.  Same-rank renames route normally."""
        src_path, dst_path = _norm(src_path), _norm(dst_path)
        self._check_frozen(src_path)
        self._check_frozen(dst_path)
        r_src, r_dst = self.rank_of(src_path), self.rank_of(dst_path)
        if r_src == r_dst:
            server = self.ranks[r_src]
            is_dir = False
            try:
                is_dir = (await server.fs.stat(src_path))["type"] == "dir"
            except FsError:
                pass
            if is_dir:
                # other sessions' caps under the moving tree must be
                # revoked first (their write-behind would flush into
                # dead paths) — same compliance wait as export
                await self._revoke_subtree_caps(server, src_path)
            async with self._topology:
                # re-resolve UNDER the lock (same discipline as
                # export_dir and the cross-rank branch below): an
                # export that committed while the revoke wait ran may
                # have moved authority — renaming via the stale rank
                # would mutate dirfrags the new authority owns outside
                # its _mutate lock.
                self._check_frozen(src_path)
                self._check_frozen(dst_path)
                if (self.rank_of(src_path) != r_src
                        or self.rank_of(dst_path) != r_src):
                    raise FsError(
                        f"EAGAIN: authority of {src_path} or {dst_path} "
                        "moved during rename lock wait")
                if is_dir:
                    self._guard_dir_move(src_path)
                await server.fs.rename(src_path, dst_path)
            if is_dir:
                # caps under either tree now name dead paths
                for p in list(server._caps):
                    if _is_under(p, src_path) or _is_under(p, dst_path):
                        for sid in list(server._caps.get(p, {})):
                            server._drop(p, sid)
            return
        fs_src, fs_dst = self.ranks[r_src].fs, self.ranks[r_dst].fs
        first, second = sorted((fs_src, fs_dst), key=id)
        async with first._mutate:
            async with second._mutate:
                # re-resolve UNDER the locks (mirror export_dir): a
                # subtree export may have committed while we waited, in
                # which case journaling dentry mutations at the stale
                # ranks would mutate dirfrags outside the new
                # authority's _mutate lock — lost updates, and a later
                # replace_rank() would replay them onto importer-owned
                # dirfrags.  Retryable EAGAIN, same as export_dir.
                self._check_frozen(src_path)
                self._check_frozen(dst_path)
                if (self.rank_of(src_path) != r_src
                        or self.rank_of(dst_path) != r_dst):
                    raise FsError(
                        f"EAGAIN: authority of {src_path} or {dst_path} "
                        "moved during rename lock wait")
                sparent = posixpath.dirname(src_path)
                sname = posixpath.basename(src_path)
                sdentries = await fs_src._load_dir(sparent)
                if sdentries is None or sname not in sdentries:
                    raise FsError(f"ENOENT: {src_path}")
                ent = sdentries[sname]
                if ent["type"] == "dir":
                    raise FsError("EXDEV: cross-rank directory rename "
                                  "unsupported; export the subtree "
                                  "instead")
                dparent = posixpath.dirname(dst_path)
                dname = posixpath.basename(dst_path)
                ddentries = await fs_dst._load_dir(dparent)
                if ddentries is None:
                    raise FsError(f"ENOENT: parent {dparent}")
                if ddentries.get(dname, {}).get("type") == "dir":
                    raise FsError(f"EISDIR: {dst_path}")
                # each HALF is journaled at the rank that owns its
                # dirfrag, destination first (set) then source (rm), so
                # each rank's replay touches ONLY its own dirfrags and
                # replaying one rank never races the live peer's
                # read-modify-writes.  The durable INTENT goes to the
                # source rank's rename log FIRST: a crash between the
                # two halves leaves a record that reconciliation uses to
                # finish the source removal — without it the stale
                # source dentry would share the inode with the renamed
                # file forever, and unlinking it would destroy the data.
                intent = {"ino": ent.get("ino"), "sparent": sparent,
                          "sname": sname, "dparent": dparent,
                          "dname": dname, "dst_rank": r_dst}
                log = await self._load_rename_log(r_src)
                log.append(intent)
                await self._save_rename_log(r_src, log)
                dst_subs = [{"op": "set_dentry", "parent": dparent,
                             "name": dname, "dentry": ent}]
                old = ddentries.get(dname)
                if (old and old.get("ino") and old["ino"] != ent.get("ino")
                        and old["ino"] not in fs_dst._snap_inos(
                            await fs_dst._load_snaptable(use_cache=True))):
                    dst_subs.append({"op": "drop_ino", "ino": old["ino"]})
                dst_event = {"op": "rename", "events": dst_subs}
                src_event = {"op": "rename", "events": [
                    {"op": "rm_dentry", "parent": sparent,
                     "name": sname}]}
                await fs_dst._journal(dst_event)
                await fs_dst._apply_event(dst_event)
                await fs_dst._journal_applied()
                await fs_src._journal(src_event)
                await fs_src._apply_event(src_event)
                await fs_src._journal_applied()
                log = [e for e in await self._load_rename_log(r_src)
                       if e != intent]
                await self._save_rename_log(r_src, log)


class CephFSMultiClient:
    """Client facade over an MDSCluster: one cap-aware CephFSClient per
    rank, each op routed to the path's authoritative rank.  Frozen
    subtrees (mid-export) are retried; the retry loop renews EVERY
    per-rank session so pending revokes get complied with — which is
    exactly what lets the exporter finish."""

    def __init__(self, cluster: MDSCluster, client: str = "client",
                 renew_interval: float = 1.0):
        self.cluster = cluster
        self.name = client
        self.client_name = client  # identity for open-time permission
        self.renew_interval = renew_interval
        self._clients: Dict[int, CephFSClient] = {}

    def _client_for(self, rank: int) -> CephFSClient:
        c = self._clients.get(rank)
        if c is None or c.session.session_id not in \
                self.cluster.ranks[rank].sessions:
            # first contact, or the rank was replaced (sessions are
            # volatile): open a fresh session — up:reconnect role
            c = CephFSClient(self.cluster.ranks[rank], self.name,
                             self.renew_interval)
            self._clients[rank] = c
        return c

    async def _handoff(self, path: str, rank: int) -> None:
        """Cache handoff after a migration: write-behind bytes staged at
        a rank that is no longer the path's authority are re-staged at
        the new one (the reference client re-targets its caps to the
        importing MDS after an export).  Without this, dirty data from
        before a forced cap drop would be stranded — or worse, flushed
        through the stale authority."""
        from ceph_tpu_torch.services.mds import FileSystem
        p = FileSystem._norm(path)
        for r, c in list(self._clients.items()):
            if r == rank:
                continue
            data = c._dirty.pop(p, None)
            c._clean.pop(p, None)
            if p in c.session.caps:
                c.mds.release_cap(c.session, p)
            if data is not None:
                await self._client_for(rank).write(p, data)

    async def _routed(self, path: str, op: str, *args,
                      retries: int = 100, delay: float = 0.02):
        for attempt in range(retries):
            try:
                rank, _server = self.cluster.route(path)
                await self._handoff(path, rank)
                return await getattr(self._client_for(rank), op)(
                    path, *args)
            except FsError as e:
                if "EAGAIN" not in str(e) or attempt == retries - 1:
                    raise
                await self.renew_all()
                await asyncio.sleep(delay)

    async def renew_all(self) -> None:
        for c in list(self._clients.values()):
            await c.renew()

    async def write(self, path: str, data: bytes) -> None:
        await self._routed(path, "write", data)

    async def read(self, path: str) -> bytes:
        return await self._routed(path, "read")

    # -- file handles (libcephfs ll_open surface over the cluster) -----------

    async def pread(self, path: str, off: int, n: int = -1) -> bytes:
        return await self._routed(path, "pread", off, n)

    async def pwrite(self, path: str, off: int, data: bytes) -> int:
        return await self._routed(path, "pwrite", off, data)

    async def append(self, path: str, data: bytes) -> int:
        return await self._routed(path, "append", data)

    async def truncate(self, path: str, size: int) -> None:
        await self._routed(path, "truncate", size)

    async def chmod(self, path: str, mode: int) -> None:
        await self._routed(path, "chmod", mode)

    async def open(self, path: str, mode: str = "r"):
        """Open a handle whose every operation re-routes to the path's
        CURRENT authoritative rank — a subtree export mid-handle just
        redirects the next op (with cache handoff), it does not
        invalidate the handle."""
        return await open_file(self, path, mode)

    async def fsync(self, path: str) -> None:
        await self._routed(path, "fsync")

    async def mkdir(self, path: str) -> None:
        await self._routed(path, "mkdir")

    async def listdir(self, path: str) -> List[str]:
        return await self._routed(path, "listdir")

    async def stat(self, path: str) -> Dict:
        return await self._routed(path, "stat")

    async def unlink(self, path: str) -> None:
        await self._routed(path, "unlink")

    async def rename(self, src: str, dst: str,
                     retries: int = 100, delay: float = 0.02) -> None:
        """Same-rank renames (files AND directories) go through the
        authoritative rank's SERVER, so cap holders under a moving
        directory are forced to comply first; the topology lock keeps
        directory moves ordered against subtree exports.  Cross-rank
        renames (files only) take the cluster's two-lock path.  The
        SOURCE's write-behind is flushed first; DESTINATION caches are
        dropped WITHOUT flushing — the rename clobbers that content by
        definition.  Frozen subtrees retry like every other facade op."""
        s, d = _norm(src), _norm(dst)
        for attempt in range(retries):
            try:
                self.cluster._check_frozen(s)
                self.cluster._check_frozen(d)
                r_src, r_dst = self.cluster.rank_of(s), \
                    self.cluster.rank_of(d)
                if r_src == r_dst:
                    async with self.cluster._topology:
                        try:
                            st = await self.cluster.ranks[
                                r_src].fs.stat(s)
                        except FsError:
                            st = {}
                        if st.get("type") == "dir":
                            self.cluster._guard_dir_move(s)
                        await self._handoff(s, r_src)
                        await self._client_for(r_src).rename(s, d)
                else:
                    await self._routed(s, "fsync")
                    for c in self._clients.values():
                        c._dirty.pop(d, None)
                        c._clean.pop(d, None)
                        c._clean.pop(s, None)
                        for p in (s, d):
                            if p in c.session.caps:
                                c.mds.release_cap(c.session, p)
                    await self.cluster.rename(s, d)
                # purge EVERY client's caches under both trees (the
                # rename may have moved a whole subtree)
                for c in self._clients.values():
                    for cache in (c._dirty, c._clean):
                        for p in list(cache):
                            if _is_under(p, s) or _is_under(p, d):
                                cache.pop(p, None)
                return
            except FsError as e:
                if "EAGAIN" not in str(e) or attempt == retries - 1:
                    raise
                await self.renew_all()
                await asyncio.sleep(delay)

    # -- snapshots: every snap-table mutation routes through rank 0 (the
    # reference's snapserver runs on rank 0) UNDER AN ALL-RANKS BARRIER,
    # so no rank can decide a drop_old_ino against a table the snapshot
    # is about to change (and the walk is point-in-time, not fuzzy) ---------

    async def snap_create(self, path: str, name: str) -> None:
        p = _norm(path)
        # flush EVERY per-rank client's write-behind under the subtree
        # THROUGH THE ROUTER (handoff + frozen retry): bytes staged at a
        # stale authority must not be flushed through it
        for c in list(self._clients.values()):
            for dirty in list(c._dirty):
                if _is_under(dirty, p):
                    await self._routed(dirty, "fsync")
        await self.cluster.snap_create(p, name)

    async def snap_delete(self, path: str, name: str) -> None:
        await self.cluster.snap_delete(path, name)

    async def snap_list(self, path: str) -> List[str]:
        return await self.cluster.ranks[0].fs.snap_list(path)

    async def read_snap(self, path: str, name: str, rel: str) -> bytes:
        return await self.cluster.ranks[0].fs.read_snap_file(
            path, name, rel)

    async def listdir_snap(self, path: str, name: str,
                           rel: str = "") -> List[str]:
        return await self.cluster.ranks[0].fs.listdir_snap(
            path, name, rel)

    async def unmount(self) -> None:
        for c in self._clients.values():
            await c.unmount()
        self._clients.clear()
