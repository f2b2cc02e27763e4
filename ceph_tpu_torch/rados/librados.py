# Copy of ceph_tpu/rados/librados.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; an object-class reply
# unpickles through rados/unpickle.py.
"""librados-style public API: cluster handle + per-pool IoCtx.

Role-equivalent of the reference's librados (reference
src/librados/librados_c.cc, IoCtxImpl.cc): applications connect a
:class:`Rados` handle, open an :class:`IoCtx` per pool (by name), and do
sync or async object I/O — the async completions mirror rados_aio_*
(IoCtxImpl::aio_read/aio_write bridging to Objecter completions).  The
underlying engine is RadosClient (the Objecter role: client-side
placement, resend across epochs, reqid idempotency).
"""

from __future__ import annotations

import asyncio
import errno as _errno
from typing import Any, Dict, List, Optional

from ceph_tpu_torch.rados.client import RadosClient, RadosError


class Completion:
    """rados_completion_t role: await it, or poll is_complete()."""

    def __init__(self, task: "asyncio.Task"):
        self._task = task

    def is_complete(self) -> bool:
        return self._task.done()

    async def wait(self) -> Any:
        return await self._task

    def result(self) -> Any:
        return self._task.result()


class IoCtx:
    """Per-pool I/O context (librados::IoCtx role)."""

    def __init__(self, rados: "Rados", pool_id: int, pool_name: str):
        self._rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        # self-managed snapshot state (librados set_snap_write_context /
        # snap_set_read roles): writes carry the context; reads resolve
        # at the read snap when set
        self._snapc_seq = 0
        self._snapc_snaps: List[int] = []
        self._snap_read = 0
        # rados namespace (reference rados_ioctx_set_namespace /
        # object_locator_t nspace): part of object IDENTITY — the same
        # name in two namespaces is two objects, placed independently
        self._nspace = ""

    @property
    def _c(self) -> RadosClient:
        return self._rados._client

    # -- namespaces (reference rados_ioctx_set_namespace) --------------------

    def set_namespace(self, nspace: str) -> None:
        """All subsequent I/O on this ioctx targets (nspace, name)
        identities; "" returns to the default namespace and the
        ALL_NSPACES sentinel makes listings span every namespace
        (I/O in that state is rejected, as in the reference)."""
        from ceph_tpu_torch.rados.types import ALL_NSPACES, NS_SEP, SNAP_SEP

        if nspace != ALL_NSPACES and (NS_SEP in nspace
                                      or SNAP_SEP in nspace):
            raise RadosError("invalid namespace", code=-_errno.EINVAL)
        self._nspace = nspace

    def get_namespace(self) -> str:
        return self._nspace

    def _full(self, oid: str) -> str:
        """Compose the wire object name for this ioctx's namespace;
        the separator (and the all-namespaces sentinel) cannot ride in
        from user names."""
        from ceph_tpu_torch.rados.types import ALL_NSPACES, NS_SEP, make_oid

        if NS_SEP in oid:
            raise RadosError("oid contains the reserved namespace "
                             "separator", code=-_errno.EINVAL)
        if self._nspace == ALL_NSPACES:
            raise RadosError("I/O requires a concrete namespace "
                             "(ioctx is set to ALL_NSPACES)",
                             code=-_errno.EINVAL)
        return make_oid(self._nspace, oid)

    # -- self-managed snapshots (reference rados_ioctx_selfmanaged_*) --------

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id and fold it into this ioctx's write
        context."""
        snap_id = await self._c.selfmanaged_snap_create(self.pool_id)
        self.set_snap_write_context(
            snap_id, [snap_id] + list(self._snapc_snaps))
        return snap_id

    async def selfmanaged_snap_remove(self, snap_id: int) -> None:
        await self._c.selfmanaged_snap_remove(self.pool_id, snap_id)
        self._snapc_snaps = [s for s in self._snapc_snaps if s != snap_id]

    async def selfmanaged_snap_rollback(self, oid: str,
                                        snap_id: int) -> None:
        """Restore the head to its state at `snap_id` (reference
        rollback: read-at-snap -> write head; an object absent at the
        snap is removed)."""
        await self._c.rollback_object(self.pool_id, self._full(oid),
                                      snap_id, snapc=self._snapc)

    # -- pool snapshots (reference rados_ioctx_snap_create / mksnap) ---------

    async def snap_create(self, name: str) -> int:
        """Mon-managed POOL snapshot (reference `rados mksnap`): the
        whole pool's state becomes readable at the returned snap id;
        mixing with self-managed snaps is refused by the mon
        (-EINVAL)."""
        return await self._c.pool_snap_create(self.pool_id, name)

    async def snap_remove(self, name: str) -> None:
        await self._c.pool_snap_remove(self.pool_id, name)

    async def snap_list(self) -> Dict[str, int]:
        return await self._c.pool_snap_list(self.pool_id)

    async def snap_lookup(self, name: str) -> int:
        snaps = await self._c.pool_snap_list(self.pool_id)
        if name not in snaps:
            raise RadosError(f"no pool snap {name!r}",
                             code=-_errno.ENOENT)
        return snaps[name]

    async def snap_rollback(self, oid: str, name: str) -> None:
        """Restore one object's head to its state at the named pool
        snapshot (reference `rados rollback <obj> <snap>`: per-object,
        not pool-wide)."""
        sid = await self.snap_lookup(name)
        await self._c.rollback_object(self.pool_id, self._full(oid), sid)

    async def allocate_snap_id(self) -> int:
        """Allocate a snap id WITHOUT touching this ioctx's write
        context — services managing many volumes over one ioctx (RBD)
        build per-volume contexts themselves."""
        return await self._c.selfmanaged_snap_create(self.pool_id)

    async def release_snap_id(self, snap_id: int) -> None:
        await self._c.selfmanaged_snap_remove(self.pool_id, snap_id)

    def set_snap_write_context(self, seq: int, snaps: List[int]) -> None:
        """snaps must be DESCENDING (newest first), seq >= snaps[0]."""
        self._snapc_seq = int(seq)
        self._snapc_snaps = sorted((int(s) for s in snaps), reverse=True)

    def snap_set_read(self, snap_id: int) -> None:
        """0 = head; else reads resolve at that snap."""
        self._snap_read = int(snap_id)

    @property
    def _snapc(self):
        # None lets the client supply the pool's SnapContext for a
        # pool-snaps-mode pool (client._write_snapc — ONE fallback for
        # every writer path, ioctx or raw)
        if self._snapc_seq:
            return (self._snapc_seq, self._snapc_snaps)
        return None

    # -- sync ops ------------------------------------------------------------
    # per-call snapc/snap overrides let services (RBD) manage MANY
    # logical volumes' contexts over one shared ioctx

    async def write_full(self, oid: str, data: bytes, snapc=None) -> None:
        await self._c.put(self.pool_id, self._full(oid), data,
                          snapc=snapc if snapc is not None else self._snapc)

    async def write(self, oid: str, data: bytes, offset: int = 0,
                    snapc=None) -> None:
        await self._c.put(self.pool_id, self._full(oid), data, offset=offset,
                          snapc=snapc if snapc is not None else self._snapc)

    async def read(self, oid: str, snap: Optional[int] = None) -> bytes:
        return await self._c.get(
            self.pool_id, self._full(oid),
            snap=snap if snap is not None else self._snap_read)

    async def remove(self, oid: str, snapc=None) -> None:
        await self._c.delete(self.pool_id, self._full(oid),
                             snapc=snapc if snapc is not None else self._snapc)

    async def stat(self, oid: str) -> Dict[str, int]:
        """Size/version from shard metadata — no payload transfer."""
        from ceph_tpu_torch.rados.types import MOSDOp

        reply = await self._c._op(MOSDOp(op="stat", pool_id=self.pool_id,
                                         oid=self._full(oid)))
        return {"size": int(reply.data), "version": reply.version}

    async def list_objects(self) -> List[str]:
        """Objects in THIS ioctx's namespace, bare names; with the
        ALL_NSPACES sentinel set, every namespace's WIRE names (callers
        split them with types.split_ns)."""
        from ceph_tpu_torch.rados.types import ALL_NSPACES, split_ns

        wire = await self._c.list_objects(self.pool_id,
                                          nspace=self._nspace)
        if self._nspace == ALL_NSPACES:
            return wire
        return [split_ns(o)[1] for o in wire]

    async def execute(self, oid: str, cls: str, method: str,
                      inp: bytes = b"") -> Any:
        """Object-class call (rados_exec role); EC pools raise
        EOPNOTSUPP exactly as the reference does."""
        from ceph_tpu_torch.rados import unpickle
        from ceph_tpu_torch.rados.types import MOSDOp

        reply = await self._c._op(MOSDOp(op="call", pool_id=self.pool_id,
                                         oid=self._full(oid), data=inp,
                                         cls=cls, method=method), retries=3)
        return unpickle.loads(reply.data)

    # -- xattr / omap conveniences (rados_{set,get}xattr, rados_omap_*) -----
    # each is a one-sub-op compound (the multi executor is the single
    # server-side metadata path, so these are atomic with cls calls)

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        await self._c.multi(self.pool_id, self._full(oid),
                            [("setxattr", {"name": name,
                                           "value": bytes(value)})],
                            snapc=self._snapc)

    async def getxattr(self, oid: str, name: str) -> bytes:
        results, _v = await self._c.multi(
            self.pool_id, self._full(oid), [("getxattr", {"name": name})])
        return results[0][1]

    async def rmxattr(self, oid: str, name: str) -> None:
        await self._c.multi(self.pool_id, self._full(oid),
                            [("rmxattr", {"name": name})],
                            snapc=self._snapc)

    async def getxattrs(self, oid: str) -> Dict[str, bytes]:
        results, _v = await self._c.multi(self.pool_id, self._full(oid),
                                          [("getxattrs", {})])
        return results[0][1]

    async def omap_set(self, oid: str, entries: Dict[str, bytes]) -> None:
        await self._c.multi(self.pool_id, self._full(oid),
                            [("omap_set", {"entries": dict(entries)})],
                            snapc=self._snapc)

    async def omap_get_vals(self, oid: str) -> Dict[str, bytes]:
        results, _v = await self._c.multi(self.pool_id, self._full(oid),
                                          [("omap_get_vals", {})])
        return results[0][1]

    async def omap_rm_keys(self, oid: str, keys) -> None:
        await self._c.multi(self.pool_id, self._full(oid),
                            [("omap_rm_keys", {"keys": list(keys)})],
                            snapc=self._snapc)

    async def operate(self, oid: str, op) -> list:
        """Execute a neorados WriteOp/ReadOp through this ioctx
        (librados operate/operate_read role over the same engine)."""
        results, _v = await self._c.multi(self.pool_id, self._full(oid),
                                          op._ops, snapc=self._snapc)
        return results

    async def watch(self, oid: str, callback) -> None:
        await self._c.watch(self.pool_id, self._full(oid), callback)

    async def unwatch(self, oid: str) -> None:
        await self._c.unwatch(self.pool_id, self._full(oid))

    async def notify(self, oid: str, payload: bytes = b"") -> List:
        return await self._c.notify(self.pool_id, self._full(oid), payload)

    # -- async (aio_*) -------------------------------------------------------

    def aio_write(self, oid: str, data: bytes) -> Completion:
        return Completion(asyncio.get_running_loop().create_task(
            self.write_full(oid, data)))

    def aio_read(self, oid: str) -> Completion:
        return Completion(asyncio.get_running_loop().create_task(
            self.read(oid)))

    def aio_remove(self, oid: str) -> Completion:
        return Completion(asyncio.get_running_loop().create_task(
            self.remove(oid)))


class Rados:
    """Cluster handle (rados_t role): connect, open pools by name."""

    def __init__(self, mon_addr, conf: Optional[dict] = None):
        self._client = RadosClient(mon_addr, conf)
        self.connected = False

    async def connect(self) -> "Rados":
        await self._client.start()
        await self._client.refresh_map()
        self.connected = True
        return self

    async def shutdown(self) -> None:
        await self._client.stop()
        self.connected = False

    async def open_ioctx(self, pool_name: str) -> IoCtx:
        await self._client.refresh_map()
        pool = self._client.osdmap.pool_by_name(pool_name)
        if pool is None:
            raise RadosError(f"pool {pool_name!r} does not exist")
        return IoCtx(self, pool.pool_id, pool_name)

    async def pool_create(self, name: str, pool_type: str = "ec",
                          pg_num: int = 8,
                          profile: Optional[Dict[str, str]] = None) -> int:
        return await self._client.create_pool(name, pool_type, pg_num,
                                              profile)

    async def pool_list(self) -> List[str]:
        await self._client.refresh_map()
        return sorted(p.name for p in self._client.osdmap.pools.values())

    async def config_set(self, key: str, value: str) -> None:
        await self._client.config_set(key, value)

    async def mon_command(self, prefix: str, **kwargs) -> Any:
        """Tiny `ceph` command surface over typed client calls."""
        if prefix == "osd pool ls":
            return await self.pool_list()
        if prefix == "config get":
            return await self._client.config_get(kwargs.get("key", ""))
        raise RadosError(f"unknown mon command {prefix!r}")
