# Copy of ceph_tpu/rados/neorados.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""neorados-style modern async client API: composable compound operations.

Role-equivalent of the reference's src/neorados/ (RADOS.cc, cls/…): an
asio-flavored second client API over the same Objecter engine, whose
defining feature vs classic librados is the first-class **operation
object** — a :class:`WriteOp`/:class:`ReadOp` accumulates an ordered
vector of sub-ops that execute atomically on one object (the reference's
``MOSDOp`` carries ``vector<OSDOp>``; neorados ``WriteOp::exec`` /
``ReadOp::read`` append to it, ``RADOS::execute`` submits).

Semantics (matched to reference PrimaryLogPG::do_osd_ops):

- sub-ops run in order; reads observe earlier staged writes;
- any failing sub-op aborts the WHOLE op with a typed -errno and zero
  side effects (all-or-nothing, enforced server-side under the object's
  critical section);
- asserts (`assert_exists`, `assert_version`, `cmpxattr`) make optimistic
  concurrency loops possible without advisory locks;
- EC pools reject omap and class-call sub-ops with -EOPNOTSUPP exactly
  as the reference does.

The executor lives in the OSD (`osd.py _do_multi`); this module is the
thin, typed client surface.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.client import RadosClient, RadosError

__all__ = ["RADOS", "IOContext", "WriteOp", "ReadOp", "RadosError"]


class _Op:
    """Shared builder core: an ordered vector of (name, kwargs)."""

    def __init__(self):
        self._ops: List[Tuple[str, Dict[str, Any]]] = []

    def _add(self, _subop: str, **kw) -> "_Op":
        self._ops.append((_subop, kw))
        return self

    # -- guards usable in both read and write ops ---------------------------

    def assert_exists(self):
        return self._add("assert_exists")

    def assert_version(self, version: int):
        """Fail with -ERANGE unless the object's version equals
        `version` (optimistic concurrency; reference assert_version)."""
        return self._add("assert_version", version=int(version))

    def cmpxattr(self, name: str, value: bytes):
        """Fail with -ECANCELED unless xattr `name` equals `value`."""
        return self._add("cmpxattr", name=name, value=bytes(value))

    def exec_(self, cls: str, method: str, input: bytes = b""):
        """In-OSD object-class call inside the vector (neorados
        WriteOp::exec / ReadOp::exec)."""
        return self._add("call", cls=cls, method=method, input=bytes(input))


class ReadOp(_Op):
    """Accumulates non-mutating sub-ops (neorados ReadOp role).  Each
    output-producing sub-op contributes one entry to execute()'s result
    list, in vector order."""

    def read(self, offset: int = 0, length: Optional[int] = None):
        return self._add("read", offset=int(offset), length=length)

    def stat(self):
        return self._add("stat")

    def getxattr(self, name: str):
        return self._add("getxattr", name=name)

    def getxattrs(self):
        return self._add("getxattrs")

    def omap_get_vals(self):
        return self._add("omap_get_vals")

    def omap_get_keys(self):
        return self._add("omap_get_keys")


class WriteOp(_Op):
    """Accumulates mutating sub-ops (neorados WriteOp role)."""

    def create(self, exclusive: bool = False):
        """Ensure the object exists; exclusive=True fails -EEXIST if it
        already does (reference CEPH_OSD_OP_CREATE + EXCL)."""
        return self._add("create", exclusive=bool(exclusive))

    def write(self, data: bytes, offset: int = 0):
        return self._add("write", data=bytes(data), offset=int(offset))

    def write_full(self, data: bytes):
        return self._add("write_full", data=bytes(data))

    def append(self, data: bytes):
        return self._add("append", data=bytes(data))

    def truncate(self, size: int):
        return self._add("truncate", size=int(size))

    def zero(self, offset: int, length: int):
        return self._add("zero", offset=int(offset), length=int(length))

    def remove(self):
        return self._add("remove")

    def setxattr(self, name: str, value: bytes):
        return self._add("setxattr", name=name, value=bytes(value))

    def rmxattr(self, name: str):
        return self._add("rmxattr", name=name)

    def omap_set(self, entries: Dict[str, bytes]):
        return self._add("omap_set", entries=dict(entries))

    def omap_rm_keys(self, keys: List[str]):
        return self._add("omap_rm_keys", keys=list(keys))

    def omap_clear(self):
        return self._add("omap_clear")


class IOContext:
    """Pool + snap-context scope an op executes in (neorados IOContext
    role: pool id, namespace, snap context travel WITH the execute call,
    not as ambient ioctx state)."""

    def __init__(self, pool_id: int,
                 snapc: Optional[Tuple[int, List[int]]] = None):
        self.pool_id = int(pool_id)
        self.snapc = snapc

    def with_snapc(self, seq: int, snaps: List[int]) -> "IOContext":
        return IOContext(self.pool_id, (int(seq), list(snaps)))


class RADOS:
    """The neorados cluster handle: connect once, execute ops against
    (oid, IOContext) pairs.  Wraps the same RadosClient engine classic
    librados uses (one Objecter, reference neorados sharing Objecter)."""

    def __init__(self, mon_addr, conf: Optional[dict] = None,
                 client: Optional[RadosClient] = None):
        self._client = client if client is not None else RadosClient(
            mon_addr, conf)
        self._owns_client = client is None

    @classmethod
    def from_librados(cls, rados) -> "RADOS":
        """Build on an already-connected librados Rados handle (shares
        its Objecter; reference neorados::RADOS::make_with_librados)."""
        r = cls(None, client=rados._client)
        return r

    async def connect(self) -> "RADOS":
        await self._client.start()
        await self._client.refresh_map()
        return self

    async def shutdown(self) -> None:
        if self._owns_client:
            await self._client.stop()

    async def lookup_pool(self, name: str) -> IOContext:
        await self._client.refresh_map()
        pool = self._client.osdmap.pool_by_name(name)
        if pool is None:
            raise RadosError(f"pool {name!r} does not exist")
        return IOContext(pool.pool_id)

    async def execute(self, oid: str, ioc: IOContext, op: _Op
                      ) -> List[Tuple[int, Any]]:
        """Submit the op vector; returns the per-sub-op (rval, out)
        results in vector order.  Raises RadosError (typed code) if any
        sub-op failed — in which case nothing was applied."""
        results, _version = await self._client.multi(
            ioc.pool_id, oid, op._ops, snapc=ioc.snapc)
        return results

    async def execute_versioned(self, oid: str, ioc: IOContext, op: _Op):
        """execute() variant also returning the object version the op
        observed (for assert_version read-modify-write loops)."""
        return await self._client.multi(ioc.pool_id, oid, op._ops,
                                        snapc=ioc.snapc)
