# Copy of ceph_tpu/services/rbd.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""RBD-lite: block images striped over RADOS objects.

Role-equivalent of the reference's librbd core data path (reference
src/librbd/): an image is a header object (size, object order, id) plus
data objects ``rbd_data.<id>.<n>`` of 2^order bytes each; reads/writes map
byte extents onto data objects; unwritten extents read as zeros (sparse).
The object map (which blocks exist, reference object-map feature) lives in
the header and makes sparse reads and fast remove possible without listing.

Snapshots sit on RADOS self-managed snaps exactly as the reference's
librbd sits on librados (IoCtxImpl selfmanaged snap ops): snap_create
allocates a pool-unique snap id from the mon and records the object map;
every data write carries the image's SnapContext so the OSD primary
clones a block before its first post-snap write (make_writeable);
snapshot reads resolve per object through the RADOS SnapSet (covering
clone, unchanged head, or absent); snap removal trims clones that no
live snap still references.

Layered clones (reference librbd clone v2, src/librbd/ + cls_rbd
children bookkeeping): a PROTECTED snapshot can be cloned into a child
image whose header records the parent (image, snap).  Child reads fall
through to the parent snapshot for objects the child has never written;
child writes COPY-UP the parent block first when partially overwriting
(reference CopyupRequest), so the child diverges object by object.
``flatten`` copies every remaining parent block into the child and drops
the parent link; ``snap_unprotect`` refuses while children exist (tracked
in a pool-level ``rbd_children`` registry, the reference's cls_rbd
children object).

Journaling + mirroring (reference journal feature, src/journal/
Journaler.h, and the rbd-mirror daemon): a JournaledImage appends every
mutation to a per-image segmented journal BEFORE applying it, and a
Mirrorer replays those events into a peer pool's image resumably (the
replay position persists with the peer), expiring replayed segments.
"""

from __future__ import annotations

import asyncio
import errno
import json
import time
import uuid
from typing import Dict, List, Optional

from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.rados.librados import IoCtx

DEFAULT_ORDER = 22  # 4 MiB objects, the reference default


class RbdError(Exception):
    pass


class Image:
    def __init__(self, ioctx: IoCtx, name: str, header: Dict):
        self.ioctx = ioctx
        self.name = name
        self._hdr = header

    # -- layout --------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._hdr["size"]

    @property
    def object_size(self) -> int:
        return 1 << self._hdr["order"]

    def _data_oid(self, index: int) -> str:
        return f"rbd_data.{self._hdr['id']}.{index:016d}"

    @staticmethod
    def _header_oid(name: str) -> str:
        return f"rbd_header.{name}"

    async def _save_header(self, drop_blocks=()) -> None:
        """Whole-header write-back.  Routed through the in-OSD rbd class
        (reference cls_rbd, src/cls/rbd/cls_rbd.cc) when the pool
        supports class calls, so a concurrent merge_object_map cannot
        interleave mid-update; EC pools (class calls answer EOPNOTSUPP
        per reference semantics) keep the client-side write."""
        got = await self._hdr_cls(
            "set_header",
            {"header": self._hdr, "drop_blocks": sorted(drop_blocks)})
        if got is not None:
            ret, out = got
            if ret == 0:
                # adopt the server-side merge: concurrent writers'
                # object-map/snap updates survive our push
                self._hdr = json.loads(out)
                return
            if ret != -errno.ENOENT:
                raise RbdError(f"set_header failed ({ret})")
            # header object vanished (image being removed): fall through
        await self.ioctx.write_full(self._header_oid(self.name),
                                    json.dumps(self._hdr).encode())

    async def _hdr_cls(self, method: str, payload: Dict):
        """(ret, out) from an in-OSD rbd-class call on this image's
        header, or None on an EC pool (caller takes the client path)."""
        try:
            return await self.ioctx.execute(
                self._header_oid(self.name), "rbd", method,
                json.dumps(payload).encode())
        except RadosError as e:
            if e.code == -errno.EOPNOTSUPP:
                return None
            raise

    # -- IO ------------------------------------------------------------------

    async def _parent(self) -> Optional["Image"]:
        """Open the parent image of a clone.  NOT cached: the parent's
        header carries the snap COW bookkeeping, and a parent head write
        after we opened it would otherwise leak post-snap bytes into the
        child's read-through (the clone must always resolve through the
        parent's CURRENT clone map)."""
        p = self._hdr.get("parent")
        if not p:
            return None
        raw = await self.ioctx.read(self._header_oid(p["image"]))
        return Image(self.ioctx, p["image"], json.loads(raw))

    async def _read_from_parent(self, idx: int,
                                parent: Optional["Image"] = None) -> bytes:
        """A clone's view of one object it never wrote: the parent
        SNAPSHOT's bytes for that block (zeros past the snap's extent) —
        the read-fall-through half of the reference's clone layering.
        Callers doing many blocks pass ``parent`` (opened once per call)
        so each block does not re-read the parent header."""
        p = self._hdr.get("parent")
        parent = parent if parent is not None else await self._parent()
        if parent is None:
            return b""
        base = idx * self.object_size
        limit = min(p["size"], self.size)
        if base >= limit:
            return b""
        n = min(self.object_size, limit - base)
        return await parent.read_snap(p["snap"], base, n)

    async def read(self, offset: int, length: int) -> bytes:
        if offset >= self.size:
            return b""
        length = min(length, self.size - offset)
        objmap = set(self._hdr["object_map"])
        layered = bool(self._hdr.get("parent"))
        out = bytearray()
        pos = offset
        end = offset + length
        spans = []
        while pos < end:
            idx = pos // self.object_size
            off_in = pos % self.object_size
            n = min(self.object_size - off_in, end - pos)
            spans.append((idx, off_in, n))
            pos += n

        parent = await self._parent() if layered else None

        async def fetch(idx: int):
            if idx in objmap:
                return await self.ioctx.read(self._data_oid(idx))
            if layered:
                return await self._read_from_parent(idx, parent)
            return None

        datas = await asyncio.gather(*(fetch(idx) for idx, _, _ in spans))
        for (idx, off_in, n), blob in zip(spans, datas):
            if not blob:
                out.extend(b"\x00" * n)  # sparse hole
            else:
                piece = blob[off_in:off_in + n]
                out.extend(piece)
                out.extend(b"\x00" * (n - len(piece)))  # short object tail
        return bytes(out)

    async def write(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self.size:
            raise RbdError("write beyond image size (resize first)")
        objmap = set(self._hdr["object_map"])
        layered = bool(self._hdr.get("parent"))
        snapc = self._image_snapc()  # every data write carries the context:
        # the OSD primary clones a block before its first post-snap write
        pos = 0
        dirty_map = False
        while pos < len(data):
            lofs = offset + pos
            idx = lofs // self.object_size
            off_in = lofs % self.object_size
            n = min(self.object_size - off_in, len(data) - pos)
            piece = data[pos:pos + n]
            if (layered and idx not in objmap
                    and (off_in or n < self.object_size)):
                # copy-up (reference CopyupRequest): a partial write to a
                # block the clone never owned must compose with the
                # PARENT's bytes, not zeros — materialize the parent block
                # in the child first, then overwrite part of it
                base = await self._read_from_parent(idx)
                if base:
                    await self.ioctx.write_full(self._data_oid(idx), base,
                                                snapc=snapc)
                    objmap.add(idx)
                    dirty_map = True
            if idx in objmap and (off_in or n < self.object_size):
                # partial overwrite rides the OSD's RMW path
                await self.ioctx.write(self._data_oid(idx), piece,
                                       offset=off_in, snapc=snapc)
            elif off_in or n < self.object_size:
                # sparse partial write into a fresh object: pad the head
                await self.ioctx.write_full(self._data_oid(idx),
                                            b"\x00" * off_in + piece,
                                            snapc=snapc)
            else:
                await self.ioctx.write_full(self._data_oid(idx), piece,
                                            snapc=snapc)
            if idx not in objmap:
                objmap.add(idx)
                dirty_map = True
            pos += n
        if dirty_map:
            await self._merge_object_map(objmap)

    async def _merge_object_map(self, objmap) -> None:
        """Record newly-materialized blocks.  In-OSD merge (cls_rbd
        object_map_update role): two clients writing disjoint blocks
        concurrently must both land — the client-side whole-header
        rewrite loses one side's blocks in that race."""
        got = await self._hdr_cls("merge_object_map",
                                  {"add": sorted(objmap)})
        if got is not None:
            ret, out = got
            if ret != 0:
                raise RbdError(f"object map update failed ({ret})")
            self._hdr = json.loads(out)
            return
        self._hdr["object_map"] = sorted(
            set(self._hdr["object_map"]) | set(objmap))
        await self._save_header()

    async def resize(self, new_size: int) -> None:
        old_size = self.size
        old_objects = (old_size + self.object_size - 1) // self.object_size
        new_objects = (new_size + self.object_size - 1) // self.object_size
        dropped = []
        if new_size < old_size:
            snapc = self._image_snapc()
            objmap = set(self._hdr["object_map"])
            for idx in range(new_objects, old_objects):
                if idx in objmap:
                    try:
                        # under a snap context the OSD clones first and
                        # whiteouts, so snapshots keep their blocks
                        await self.ioctx.remove(self._data_oid(idx),
                                                snapc=snapc)
                    except RadosError:
                        pass
                    objmap.discard(idx)
                    dropped.append(idx)
            # truncate the partial boundary object so a later grow reads
            # zeros, not pre-shrink data (reference librbd trims it)
            tail = new_size % self.object_size
            bidx = new_size // self.object_size
            if tail and bidx in objmap:
                try:
                    blob = await self.ioctx.read(self._data_oid(bidx))
                    await self.ioctx.write_full(self._data_oid(bidx),
                                                blob[:tail], snapc=snapc)
                except RadosError:
                    pass
            self._hdr["object_map"] = sorted(objmap)
        self._hdr["size"] = new_size
        await self._save_header(drop_blocks=dropped)

    async def stat(self) -> Dict:
        return {"size": self.size, "object_size": self.object_size,
                "num_objs": len(self._hdr["object_map"]),
                "snaps": sorted(self._hdr.get("snaps", {})),
                "id": self._hdr["id"]}

    # -- snapshots (RADOS self-managed snaps, librbd snapshot role) ----------
    # Rebased onto the RADOS-level primitive: writes carry the image's
    # snap context, the OSD primary does the per-object COW clone
    # (make_writeable), snap reads resolve through the object's SnapSet,
    # and snap removal trims clones that no live snap references — the
    # clone-sharing/re-homing bookkeeping the service layer used to
    # maintain is the storage layer's job now (reference librbd sits on
    # librados selfmanaged snaps the same way).

    def _snaps(self) -> Dict[str, Dict]:
        return self._hdr.setdefault("snaps", {})

    async def _refresh(self) -> None:
        """Re-read the header (reference ImageCtx refresh on header
        watch): another handle (a group snapshot sweep, a concurrent
        admin) may have changed snaps/map since this handle opened."""
        raw = await self.ioctx.read(self._header_oid(self.name))
        self._hdr = json.loads(raw)

    async def _snap_or_refresh(self, name: str) -> Optional[Dict]:
        """The snap record, refreshing ONCE when the local header does
        not know the name — absorbing out-of-band snap creation without
        a watch/notify channel.  Data WRITES still require the owning
        handle (the reference's exclusive-lock discipline)."""
        snap = self._snaps().get(name)
        if snap is None:
            await self._refresh()
            snap = self._snaps().get(name)
        return snap

    def _image_snapc(self):
        """(seq, snaps-descending) over the image's live snaps — the
        SnapContext every data-object write rides."""
        ids = sorted((s["id"] for s in self._snaps().values()),
                     reverse=True)
        if not ids:
            return None
        return (ids[0], ids)

    async def snap_create(self, name: str) -> None:
        """Single in-OSD call (cls_rbd snapshot_add role): the snap
        lands in the header atomically against concurrent writers'
        object-map merges."""
        if name in self._snaps():
            raise RbdError(f"snapshot {name!r} exists")
        snap_id = await self.ioctx.allocate_snap_id()
        got = await self._hdr_cls("snap_create",
                                  {"name": name, "snap_id": snap_id})
        if got is not None:
            ret, out = got
            if ret != 0:
                # ANY failure releases the freshly-allocated id — a
                # leaked id keeps its clones untrimmable forever
                await self.ioctx.release_snap_id(snap_id)
                if ret == -17:
                    raise RbdError(f"snapshot {name!r} exists")
                raise RbdError(f"snap_create failed ({ret})")
            self._hdr = json.loads(out)
            return
        snaps = self._snaps()
        snaps[name] = {"id": snap_id, "size": self.size,
                       "object_map": list(self._hdr["object_map"])}
        await self._save_header()

    def snap_list(self) -> List[str]:
        return sorted(self._snaps())

    async def read_snap(self, name: str, offset: int, length: int) -> bytes:
        """Read from a snapshot: each object resolves at the snap id
        through its RADOS SnapSet (covering clone, unchanged head, or
        absent)."""
        snap = await self._snap_or_refresh(name)
        if snap is None:
            raise RbdError(f"no snapshot {name!r}")
        size = snap["size"]
        if offset >= size:
            return b""
        length = min(length, size - offset)
        spans = []
        pos = offset
        end = offset + length
        while pos < end:
            idx = pos // self.object_size
            off_in = pos % self.object_size
            n = min(self.object_size - off_in, end - pos)
            spans.append((idx, off_in, n))
            pos += n

        layered = bool(self._hdr.get("parent"))
        parent = await self._parent() if layered else None

        async def resolve(idx: int):
            if idx not in snap["object_map"]:
                # a clone's snapshot: blocks it never wrote were (and
                # still are) served by ITS parent snapshot — fall through
                # so clones-of-clones don't read zeros for
                # grandparent-backed data
                if layered:
                    return await self._read_from_parent(idx, parent)
                return None
            try:
                return await self.ioctx.read(self._data_oid(idx),
                                             snap=snap["id"])
            except RadosError as e:
                if e.code != -errno.ENOENT:
                    raise
                return b""

        blobs = await asyncio.gather(*(resolve(idx) for idx, _, _ in spans))
        out = bytearray()
        for (idx, off_in, n), blob in zip(spans, blobs):
            if blob is None:
                out.extend(b"\x00" * n)
            else:
                piece = blob[off_in:off_in + n]
                out.extend(piece)
                out.extend(b"\x00" * (n - len(piece)))
        return bytes(out)

    async def snap_protect(self, name: str) -> None:
        """Mark a snapshot protected — the precondition for cloning
        (reference: clones may only be made from protected snaps, so a
        snap can never vanish under its children)."""
        snap = await self._snap_or_refresh(name)
        if snap is None:
            raise RbdError(f"no snapshot {name!r}")
        got = await self._hdr_cls("set_protection",
                                  {"name": name, "protected": True})
        if got is not None:
            ret, out = got
            if ret != 0:
                raise RbdError(f"snap_protect failed ({ret})")
            self._hdr = json.loads(out)
            return
        snap["protected"] = True
        await self._save_header()

    async def snap_unprotect(self, name: str) -> None:
        snap = self._snaps().get(name)
        if snap is None:
            raise RbdError(f"no snapshot {name!r}")
        children = await RBD(self.ioctx).children(self.name, name)
        if children:
            raise RbdError(
                f"snapshot {name!r} has children {children}; flatten or "
                f"remove them first")
        got = await self._hdr_cls("set_protection",
                                  {"name": name, "protected": False})
        if got is not None:
            ret, out = got
            if ret != 0:
                raise RbdError(f"snap_unprotect failed ({ret})")
            self._hdr = json.loads(out)
            return
        snap["protected"] = False
        await self._save_header()

    async def flatten(self) -> None:
        """Copy every block the clone still reads through its parent into
        the clone itself, then drop the parent link (reference
        librbd::flatten) — afterwards the parent snap can be unprotected
        and the parent removed."""
        p = self._hdr.get("parent")
        if not p:
            return
        objmap = set(self._hdr["object_map"])
        limit = min(p["size"], self.size)
        n_objs = (limit + self.object_size - 1) // self.object_size
        parent = await self._parent()
        for idx in range(n_objs):
            if idx in objmap:
                continue
            blob = await self._read_from_parent(idx, parent)
            if blob and blob.strip(b"\x00"):
                await self.ioctx.write_full(self._data_oid(idx), blob)
                objmap.add(idx)
        self._hdr["object_map"] = sorted(objmap)
        parent_ref = f"{p['image']}@{p['snap']}"
        self._hdr.pop("parent", None)
        await self._save_header()
        await RBD(self.ioctx)._unregister_child(parent_ref, self.name)

    async def rebuild_object_map(self) -> int:
        """Reconstruct the object map by scanning the pool for this
        image's data objects (reference object_map rebuild operation):
        the recovery path when the header's map was lost or corrupted —
        reads would otherwise treat existing blocks as sparse holes.
        Returns the number of blocks recovered into the map."""
        prefix = f"rbd_data.{self._hdr['id']}."
        found = set()
        for oid in await self.ioctx.list_objects():
            if not oid.startswith(prefix):
                continue
            try:
                found.add(int(oid[len(prefix):]))
            except ValueError:
                continue
        before = set(self._hdr["object_map"])
        n_objs = (self.size + self.object_size - 1) // self.object_size
        rebuilt = {i for i in found if i < n_objs}
        await self._merge_object_map(rebuilt)
        # blocks past the current size stay out of the map (a shrink
        # already trimmed them); blocks the old map falsely claimed are
        # corrected by the authoritative scan
        if before - rebuilt:
            self._hdr["object_map"] = sorted(rebuilt)
            await self._save_header(drop_blocks=sorted(before - rebuilt))
        return len(rebuilt - before)

    async def snap_remove(self, name: str) -> None:
        """Remove a snapshot: the RADOS snap-trim deletes only clones no
        LIVE snap still references (each clone records the snap ids it
        covers), so clones shared with older snapshots survive without
        any service-level re-homing."""
        snap = await self._snap_or_refresh(name)
        snaps = self._snaps()
        if snap is not None and snap.get("protected"):
            raise RbdError(f"snapshot {name!r} is protected")
        if snap is None:
            raise RbdError(f"no snapshot {name!r}")
        # the AUTHORITATIVE protection check is the in-OSD header (a
        # concurrent client may have protected the snap after we opened
        # the image): remove from the header FIRST, release the id after.
        # A failed release then leaks the snap id (space, retried by an
        # operator) — the reverse order could release a PROTECTED snap's
        # id and let snap-trim destroy its clones (data loss).
        got = await self._hdr_cls("snap_remove", {"name": name})
        if got is not None:
            ret, out = got
            if ret == -16:
                raise RbdError(f"snapshot {name!r} is protected")
            if ret not in (0, -2):
                raise RbdError(f"snap_remove failed ({ret})")
            if ret == 0:
                self._hdr = json.loads(out)
            await self.ioctx.release_snap_id(snap["id"])
            return
        await self.ioctx.release_snap_id(snap["id"])
        snaps.pop(name, None)
        await self._save_header()


class RBD:
    """Image management (librbd::RBD role)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    async def create(self, name: str, size: int,
                     order: int = DEFAULT_ORDER) -> Image:
        hdr_oid = Image._header_oid(name)
        header = {"id": uuid.uuid4().hex[:12], "size": size, "order": order,
                  "object_map": []}
        # single in-OSD call (cls_rbd create role): exclusive creation —
        # two racing create()s cannot both win the check-then-write
        try:
            ret, _ = await self.ioctx.execute(
                hdr_oid, "rbd", "create",
                json.dumps({"header": header}).encode())
            if ret == -17:
                raise RbdError(f"image {name!r} exists")
            if ret != 0:
                raise RbdError(f"create failed ({ret})")
            return Image(self.ioctx, name, header)
        except RadosError as e:
            if e.code != -errno.EOPNOTSUPP:
                raise
        try:
            await self.ioctx.read(hdr_oid)
            raise RbdError(f"image {name!r} exists")
        except RadosError as e:
            # only typed absence clears the way: a transient read failure
            # must not let create() overwrite a LIVE header (orphaning its
            # data objects and journal) — same discipline as open()
            if e.code != -errno.ENOENT:
                raise
        await self.ioctx.write_full(hdr_oid, json.dumps(header).encode())
        return Image(self.ioctx, name, header)

    async def open(self, name: str) -> Image:
        try:
            raw = await self.ioctx.read(Image._header_oid(name))
        except RadosError as e:
            # only typed absence means "no image": a transient failure
            # must surface, or callers (the mirrorer!) would treat a
            # blip as image-gone and recreate over live data
            if e.code == -errno.ENOENT:
                raise RbdError(f"image {name!r} does not exist")
            raise
        return Image(self.ioctx, name, json.loads(raw))

    CHILDREN_OID = "rbd_children"  # pool-level clone registry (cls_rbd role)

    async def _children_map(self) -> Dict[str, List[str]]:
        try:
            return json.loads(await self.ioctx.read(self.CHILDREN_OID))
        except RadosError:
            return {}

    async def _register_child(self, parent_ref: str, child: str) -> None:
        cm = await self._children_map()
        kids = cm.setdefault(parent_ref, [])
        if child not in kids:
            kids.append(child)
        await self.ioctx.write_full(self.CHILDREN_OID,
                                    json.dumps(cm).encode())

    async def _unregister_child(self, parent_ref: str, child: str) -> None:
        cm = await self._children_map()
        kids = cm.get(parent_ref, [])
        if child in kids:
            kids.remove(child)
            if not kids:
                cm.pop(parent_ref, None)
            await self.ioctx.write_full(self.CHILDREN_OID,
                                        json.dumps(cm).encode())

    async def children(self, image: str, snap: str) -> List[str]:
        """Clones of image@snap (reference `rbd children`)."""
        return sorted((await self._children_map()).get(f"{image}@{snap}", []))

    async def clone(self, parent: str, snap: str, child: str,
                    order: Optional[int] = None) -> Image:
        """Create a copy-on-write child of a protected parent snapshot
        (reference librbd clone v2).  The child starts with no objects of
        its own: reads fall through to the parent snap, writes copy-up."""
        pimg = await self.open(parent)
        psnap = pimg._snaps().get(snap)
        if psnap is None:
            raise RbdError(f"no snapshot {parent}@{snap}")
        if not psnap.get("protected"):
            raise RbdError(f"snapshot {parent}@{snap} is not protected")
        hdr_oid = Image._header_oid(child)
        try:
            await self.ioctx.read(hdr_oid)
            raise RbdError(f"image {child!r} exists")
        except RadosError:
            pass
        header = {
            "id": uuid.uuid4().hex[:12],
            "size": psnap["size"],
            "order": order if order is not None else pimg._hdr["order"],
            "object_map": [],
            "parent": {"image": parent, "snap": snap, "size": psnap["size"]},
        }
        await self.ioctx.write_full(hdr_oid, json.dumps(header).encode())
        await self._register_child(f"{parent}@{snap}", child)
        return Image(self.ioctx, child, header)

    # -- consistency groups (reference src/librbd/api/Group.cc) -------------
    #
    # A named set of images snapshotted together: the group snapshot is a
    # per-member image snapshot taken under one sweep, named
    # group.<group>.<snap> so member snaps are identifiable and the
    # group object records the membership at snap time.

    @staticmethod
    def _group_oid(group: str) -> str:
        return f"rbd_group.{group}"

    async def _load_group(self, group: str) -> Dict:
        try:
            raw = await self.ioctx.read(self._group_oid(group))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            raise RbdError(f"no group {group!r}") from None
        return json.loads(raw)

    async def _save_group(self, group: str, state: Dict) -> None:
        await self.ioctx.write_full(self._group_oid(group),
                                    json.dumps(state).encode())

    async def group_create(self, group: str) -> None:
        state = {"members": [], "snaps": {}}
        # exclusive creation via the in-OSD class (same discipline as
        # image create: two racing creates must not both win)
        try:
            ret, _ = await self.ioctx.execute(
                self._group_oid(group), "rbd", "create",
                json.dumps({"header": state}).encode())
            if ret == -17:
                raise RbdError(f"group {group!r} exists")
            if ret != 0:
                raise RbdError(f"group create failed ({ret})")
            return
        except RadosError as e:
            if e.code != -errno.EOPNOTSUPP:
                raise
        # EC pool fallback: typed absence check, then write
        exists = True
        try:
            await self._load_group(group)
        except RbdError:
            exists = False
        if exists:
            raise RbdError(f"group {group!r} exists")
        await self._save_group(group, state)

    async def group_remove(self, group: str) -> None:
        state = await self._load_group(group)
        if state["snaps"]:
            raise RbdError(f"group {group!r} has snapshots; remove them")
        await self.ioctx.remove(self._group_oid(group))

    async def group_list(self) -> List[str]:
        pfx = "rbd_group."
        return sorted(o[len(pfx):] for o in await self.ioctx.list_objects()
                      if o.startswith(pfx))

    async def group_image_add(self, group: str, image: str) -> None:
        await self.open(image)  # must exist
        state = await self._load_group(group)
        if image not in state["members"]:
            state["members"].append(image)
            await self._save_group(group, state)

    async def group_image_remove(self, group: str, image: str) -> None:
        state = await self._load_group(group)
        if image in state["members"]:
            state["members"].remove(image)
            await self._save_group(group, state)

    async def group_image_list(self, group: str) -> List[str]:
        return sorted((await self._load_group(group))["members"])

    async def group_snap_create(self, group: str, snap: str) -> None:
        """Snapshot EVERY member at one sweep (the reference quiesces
        via exclusive locks; here member snaps are taken back-to-back on
        one event loop — writes issued after the sweep started land
        after their image's snap, the same point-in-time-per-image
        guarantee a non-quiesced reference group snap gives)."""
        state = await self._load_group(group)
        if snap in state["snaps"]:
            raise RbdError(f"group snapshot {snap!r} exists")
        member_snap = f"group.{group}.{snap}"
        done = []
        try:
            for name in state["members"]:
                img = await self.open(name)
                await img.snap_create(member_snap)
                done.append(name)
        except Exception:
            # partial failure: roll the sweep back so the group snap is
            # all-or-nothing (reference group snap create semantics)
            for name in done:
                try:
                    img = await self.open(name)
                    await img.snap_remove(member_snap)
                except Exception:
                    pass
            raise
        state["snaps"][snap] = {"members": list(state["members"])}
        await self._save_group(group, state)

    async def group_snap_remove(self, group: str, snap: str) -> None:
        state = await self._load_group(group)
        info = state["snaps"].get(snap)
        if info is None:
            raise RbdError(f"no group snapshot {snap!r}")
        member_snap = f"group.{group}.{snap}"
        failed = []
        for name in info["members"]:
            try:
                img = await self.open(name)
            except RbdError:
                continue  # member image since removed: nothing to clean
            try:
                await img.snap_remove(member_snap)
            except RbdError as e:
                if "no snapshot" in str(e):
                    continue  # already gone: idempotent
                failed.append((name, str(e)))
        if failed:
            # keep the group record so the removal can be RETRIED once
            # the blocker clears (e.g. a protected member snap) — popping
            # it would orphan member snaps with no handle left
            raise RbdError(f"group snapshot {snap!r} not fully removed: "
                           f"{failed}")
        state["snaps"].pop(snap)
        await self._save_group(group, state)

    async def group_snap_list(self, group: str) -> List[str]:
        return sorted((await self._load_group(group))["snaps"])

    async def remove(self, name: str) -> None:
        """Remove an image.  Refuses while snapshots exist (reference
        librbd behavior: `rbd snap purge` first)."""
        img = await self.open(name)
        if img._hdr.get("snaps"):
            raise RbdError(f"image {name!r} has snapshots; purge them first")
        for idx in img._hdr["object_map"]:
            try:
                await self.ioctx.remove(img._data_oid(idx))
            except RadosError:
                pass
        p = img._hdr.get("parent")
        if p:
            await self._unregister_child(f"{p['image']}@{p['snap']}", name)
        await self.ioctx.remove(Image._header_oid(name))

    async def snap_purge(self, name: str) -> None:
        img = await self.open(name)
        for snap in list(img.snap_list()):
            await img.snap_remove(snap)

    async def list(self) -> List[str]:
        prefix = "rbd_header."
        return sorted(o[len(prefix):] for o in await self.ioctx.list_objects()
                      if o.startswith(prefix))

    # -- trash (reference librbd trash_* API / `rbd trash`) ------------------
    # Deferred deletion: the header moves to a trash record (the data
    # objects are untouched, keyed by the image id), the image vanishes
    # from list(), and until the deferment window passes it can be
    # restored byte-identically.  Purge deletes expired entries' data.

    @staticmethod
    def _trash_oid(image_id: str) -> str:
        return f"rbd_trash_header.{image_id}"

    async def trash_mv(self, name: str, delay: float = 0.0,
                       now: Optional[float] = None) -> str:
        """Move an image to trash; returns the trash id.  Same snapshot
        guard as remove(): purge snapshots first (divergence: the
        reference allows trashing snapshotted images)."""
        img = await self.open(name)
        if img._hdr.get("snaps"):
            raise RbdError(f"image {name!r} has snapshots; purge them "
                           f"first")
        now = time.time() if now is None else now
        record = {"name": name, "header": img._hdr, "trashed_at": now,
                  "deferment_end": now + max(0.0, delay)}
        image_id = img._hdr["id"]
        await self.ioctx.write_full(self._trash_oid(image_id),
                                    json.dumps(record).encode())
        p = img._hdr.get("parent")
        if p:
            await self._unregister_child(f"{p['image']}@{p['snap']}",
                                         name)
        await self.ioctx.remove(Image._header_oid(name))
        return image_id

    async def trash_ls(self) -> List[Dict]:
        prefix = "rbd_trash_header."
        out = []
        for oid in await self.ioctx.list_objects():
            if not oid.startswith(prefix):
                continue
            try:
                rec = json.loads(await self.ioctx.read(oid))
            except RadosError:
                continue
            out.append({"id": rec["header"]["id"], "name": rec["name"],
                        "trashed_at": rec["trashed_at"],
                        "deferment_end": rec["deferment_end"]})
        return sorted(out, key=lambda r: r["trashed_at"])

    async def _trash_rec(self, image_id: str) -> Dict:
        try:
            return json.loads(await self.ioctx.read(
                self._trash_oid(image_id)))
        except RadosError as e:
            if e.code == -errno.ENOENT:
                raise RbdError(f"no trash entry {image_id!r}")
            raise

    async def trash_restore(self, image_id: str,
                            new_name: Optional[str] = None) -> Image:
        rec = await self._trash_rec(image_id)
        name = new_name or rec["name"]
        if name in await self.list():
            raise RbdError(f"image {name!r} exists; restore under "
                           f"another name")
        await self.ioctx.write_full(Image._header_oid(name),
                                    json.dumps(rec["header"]).encode())
        p = rec["header"].get("parent")
        if p:
            await self._register_child(f"{p['image']}@{p['snap']}", name)
        await self.ioctx.remove(self._trash_oid(image_id))
        return Image(self.ioctx, name, rec["header"])

    async def trash_purge(self, now: Optional[float] = None,
                          force: bool = False) -> int:
        """Delete expired trash entries' data (all entries with
        force=True).  Returns how many images were reclaimed."""
        now = time.time() if now is None else now
        purged = 0
        for entry in await self.trash_ls():
            if not force and now < entry["deferment_end"]:
                continue
            rec = await self._trash_rec(entry["id"])
            hdr = rec["header"]
            img = Image(self.ioctx, rec["name"], hdr)
            for idx in hdr["object_map"]:
                try:
                    await self.ioctx.remove(img._data_oid(idx))
                except RadosError:
                    pass
            await self.ioctx.remove(self._trash_oid(entry["id"]))
            purged += 1
        return purged


# -- image journaling + mirroring (reference src/journal/Journaler.h,
#    src/librbd/mirror/, the rbd-mirror daemon) ------------------------------


class ImageJournal:
    """Per-image write journal (reference journal feature / Journaler):
    every mutating op appends an event BEFORE it applies, into
    length-capped journal segments; a mirror peer replays the events in
    order to reproduce the image bit-for-bit.  Events carry a
    monotonically increasing entry id so replay is resumable and
    idempotent (the mirror records its replay position)."""

    SEGMENT_EVENTS = 256

    def __init__(self, ioctx: IoCtx, image_id: str):
        self.ioctx = ioctx
        self.image_id = image_id
        # appends are read-modify-writes of the segment + head objects:
        # serialized per journal instance.  Cross-INSTANCE writers are the
        # reference's exclusive-lock feature's job (one journaling writer
        # per image at a time); this mirrors that single-writer contract.
        self._append_lock = asyncio.Lock()

    def _head_oid(self) -> str:
        return f"journal.{self.image_id}.head"

    def _seg_oid(self, seg: int) -> str:
        return f"journal.{self.image_id}.{seg:08d}"

    async def _load_head(self) -> Dict:
        try:
            return json.loads(await self.ioctx.read(self._head_oid()))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            return {"next_id": 0, "write_seg": 0, "expire_seg": 0}

    async def append(self, event: Dict) -> int:
        """Append one event; returns its entry id."""
        async with self._append_lock:
            return await self._append_locked(event)

    async def _append_locked(self, event: Dict) -> int:
        head = await self._load_head()
        seg = head["write_seg"]
        oid = self._seg_oid(seg)
        try:
            events = json.loads(await self.ioctx.read(oid))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            events = []
        event = dict(event)
        event["id"] = head["next_id"]
        # persist the HEAD (id reservation + per-segment first-id index)
        # BEFORE the segment: a crash between the two leaves an unused id
        # (a harmless gap) — the reverse order would REUSE an id after
        # restart, and a mirror already past it would skip the event
        # silently forever
        head["next_id"] += 1
        head.setdefault("seg_first", {}).setdefault(str(seg), event["id"])
        if len(events) + 1 >= self.SEGMENT_EVENTS:
            head["write_seg"] += 1
        await self.ioctx.write_full(self._head_oid(),
                                    json.dumps(head).encode())
        events.append(event)
        await self.ioctx.write_full(oid, json.dumps(events).encode())
        return event["id"]

    async def events_after(self, last_id: int) -> List[Dict]:
        """Every event with id > last_id, in order.  The per-segment
        first-id index in the head lets the scan skip fully-replayed
        segments instead of re-reading the whole unexpired journal."""
        head = await self._load_head()
        out: List[Dict] = []
        start = head["expire_seg"]
        seg_first = head.get("seg_first", {})
        for seg in range(head["expire_seg"], head["write_seg"] + 1):
            first = seg_first.get(str(seg))
            if first is not None and first <= last_id:
                start = seg  # last_id lies at/after this segment's start
        for seg in range(start, head["write_seg"] + 1):
            try:
                events = json.loads(await self.ioctx.read(self._seg_oid(seg)))
            except RadosError as e:
                if e.code != -errno.ENOENT:
                    raise
                continue
            out.extend(ev for ev in events if ev["id"] > last_id)
        return out

    async def expire_through(self, entry_id: int) -> None:
        """Drop whole segments whose every event id <= entry_id (mirror
        peers record their positions; the caller passes the minimum)."""
        head = await self._load_head()
        seg = head["expire_seg"]
        changed = False
        while seg < head["write_seg"]:
            try:
                events = json.loads(await self.ioctx.read(self._seg_oid(seg)))
            except RadosError as e:
                if e.code != -errno.ENOENT:
                    raise
                events = []
            if events and events[-1]["id"] > entry_id:
                break
            try:
                await self.ioctx.remove(self._seg_oid(seg))
            except RadosError:
                pass
            seg += 1
            changed = True
        if changed:
            head["expire_seg"] = seg
            await self.ioctx.write_full(self._head_oid(),
                                        json.dumps(head).encode())


class JournaledImage:
    """An Image whose writes/resizes journal before applying (the rbd
    journaling feature): wrap an open Image; mutations append an event,
    then apply.  Reads pass through."""

    def __init__(self, image: Image):
        self.image = image
        self.journal = ImageJournal(image.ioctx, image._hdr["id"])

    @property
    def size(self) -> int:
        return self.image.size

    async def write(self, offset: int, data: bytes) -> None:
        # validate BEFORE journaling: a write the primary would refuse
        # must never reach the journal, or the mirror (which auto-grows)
        # would apply bytes the primary never accepted
        if offset + len(data) > self.image.size:
            raise RbdError("write beyond image size (resize first)")
        await self.journal.append({"op": "write", "offset": offset,
                                   "data": data.hex()})
        await self.image.write(offset, data)

    async def resize(self, new_size: int) -> None:
        await self.journal.append({"op": "resize", "size": new_size})
        await self.image.resize(new_size)

    async def read(self, offset: int, length: int) -> bytes:
        return await self.image.read(offset, length)


class Mirrorer:
    """rbd-mirror daemon role (reference src/librbd/mirror/ +
    src/tools/rbd_mirror): replays a primary image's journal into a
    peer image, resumably — the replay position persists in the peer
    pool so a restarted mirrorer continues where it left off."""

    def __init__(self, src_ioctx: IoCtx, dst_ioctx: IoCtx):
        self.src = src_ioctx
        self.dst = dst_ioctx

    def _pos_oid(self, image_id: str) -> str:
        return f"rbd_mirror.pos.{image_id}"

    def _peers_oid(self, image_id: str) -> str:
        # lives in the SRC pool: every peer's replay position, so journal
        # expiry advances only past what EVERY registered peer replayed
        return f"rbd_mirror.peers.{image_id}"

    async def _load_pos(self, image_id: str) -> int:
        try:
            return json.loads(await self.dst.read(self._pos_oid(image_id)))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            return -1

    async def _update_peer_positions(self, image_id: str,
                                     pos: int) -> int:
        """Record this peer's position in the src pool; returns the
        MINIMUM across peers (the safe expiry floor)."""
        oid = self._peers_oid(image_id)
        try:
            peers = json.loads(await self.src.read(oid))
        except RadosError as e:
            if e.code != -errno.ENOENT:
                raise
            peers = {}
        peers[f"pool{self.dst.pool_id}"] = pos
        await self.src.write_full(oid, json.dumps(peers).encode())
        return min(peers.values())

    async def replay(self, name: str) -> int:
        """Replay new journal events of src image `name` into the dst
        pool's image of the same name (created on first replay).
        Returns the number of events applied."""
        src_img = await RBD(self.src).open(name)
        journal = ImageJournal(self.src, src_img._hdr["id"])
        dst_rbd = RBD(self.dst)
        try:
            dst_img = await dst_rbd.open(name)
        except RbdError:
            dst_img = await dst_rbd.create(
                name, src_img.size, order=src_img._hdr["order"])
        pos = await self._load_pos(src_img._hdr["id"])
        if pos < 0:
            # first contact (rbd-mirror initial image sync): journal
            # events before now may already be expired for other peers,
            # so copy the CURRENT image content, then tail the journal
            # from the newest reserved id
            head = await journal._load_head()
            content = await src_img.read(0, src_img.size)
            if dst_img.size != src_img.size:
                await dst_img.resize(src_img.size)
            await dst_img.write(0, content)
            pos = head["next_id"] - 1
            await self.dst.write_full(self._pos_oid(src_img._hdr["id"]),
                                      json.dumps(pos).encode())
            await self._update_peer_positions(src_img._hdr["id"], pos)
        events = await journal.events_after(pos)
        applied = 0
        for ev in events:
            if ev["op"] == "write":
                data = bytes.fromhex(ev["data"])
                if ev["offset"] + len(data) > dst_img.size:
                    await dst_img.resize(ev["offset"] + len(data))
                await dst_img.write(ev["offset"], data)
            elif ev["op"] == "resize":
                await dst_img.resize(ev["size"])
            pos = ev["id"]
            applied += 1
        if applied:
            await self.dst.write_full(self._pos_oid(src_img._hdr["id"]),
                                      json.dumps(pos).encode())
            floor = await self._update_peer_positions(
                src_img._hdr["id"], pos)
            await journal.expire_through(floor)
        return applied


class ImageMigrator:
    """Live image migration between pools (reference src/librbd/migration/):
    prepare -> execute -> commit, with abort at any point before commit.

    prepare() creates the destination image and marks BOTH headers with
    the migration link; execute() copies the head and re-materializes
    every snapshot's content at the destination (point-in-time copies —
    destination snap ids are fresh, as the reference's snapshot-copy
    phase produces); commit() verifies the copy, drops the links, and
    removes the source; abort() removes the destination and clears the
    source's link.  The source stays readable throughout (migration is a
    background copy, not a cut-over), matching the reference's
    read-from-source-until-commit behavior."""

    def __init__(self, src_ioctx: IoCtx, dst_ioctx: IoCtx):
        self.src_rbd = RBD(src_ioctx)
        self.dst_rbd = RBD(dst_ioctx)

    async def prepare(self, name: str) -> None:
        src = await self.src_rbd.open(name)
        if src._hdr.get("migration"):
            raise RbdError(f"image {name!r} is already migrating")
        if src._hdr.get("parent"):
            # a clone's parent-backed blocks are not in its object map;
            # the block copier would silently migrate zeros there
            raise RbdError(f"image {name!r} is a clone; flatten it "
                           f"before migrating")
        dst = await self.dst_rbd.create(name, src.size,
                                        order=src._hdr["order"])
        dst._hdr["migration"] = {"role": "destination", "state": "prepared"}
        await dst._save_header()
        src._hdr["migration"] = {"role": "source", "state": "prepared"}
        await src._save_header()

    @staticmethod
    async def _sync_block_set(dst: Image, keep) -> None:
        """DEALLOCATE destination blocks absent from the source's map for
        this pass: a snapshot (or head) whose map shrank between passes
        must not expose the previous pass's bytes where the source reads
        zeros.  Removal (the resize-shrink pattern) keeps holes holes —
        zero-WRITES would materialize the blocks and make every later
        pass re-process them."""
        keep = set(keep)
        extra = sorted(set(dst._hdr["object_map"]) - keep)
        if not extra:
            return
        snapc = dst._image_snapc()
        for idx in extra:
            try:
                await dst.ioctx.remove(dst._data_oid(idx), snapc=snapc)
            except RadosError:
                pass
        dst._hdr["object_map"] = sorted(
            set(dst._hdr["object_map"]) - set(extra))
        await dst._save_header(drop_blocks=extra)

    @staticmethod
    async def _copy_blocks(read_at, dst: Image, size: int,
                           blocks) -> None:
        """Block-granular copy: bounded memory for any image size, and
        holes stay holes (only the source's materialized blocks are
        written, so a sparse source does not become a fully-allocated
        destination)."""
        bs = dst.object_size
        for idx in sorted(blocks):
            base = idx * bs
            if base >= size:
                continue
            n = min(bs, size - base)
            await dst.write(base, await read_at(base, n))

    async def execute(self, name: str) -> None:
        src = await self.src_rbd.open(name)
        dst = await self.dst_rbd.open(name)
        mig = src._hdr.get("migration")
        if not mig or mig.get("role") != "source":
            raise RbdError(f"image {name!r} is not migration-prepared")
        # snapshots first, OLDEST to newest: each snap's content is
        # written then snapped at the destination, rebuilding the
        # point-in-time history before the head lands on top.
        # Idempotent: a re-execute after a failed commit skips snapshots
        # the first pass already rebuilt (commit's advertised recovery).
        existing = set(dst.snap_list())
        snaps = sorted(src._snaps().items(), key=lambda kv: kv[1]["id"])
        for snap_name, info in snaps:
            if snap_name in existing:
                continue
            if dst.size != info["size"]:
                await dst.resize(info["size"])
            await self._sync_block_set(dst, info.get("object_map", ()))
            await self._copy_blocks(
                lambda off, n, s=snap_name: src.read_snap(s, off, n),
                dst, info["size"], info.get("object_map", ()))
            await dst.snap_create(snap_name)
            if info.get("protected"):
                await dst.snap_protect(snap_name)
        if dst.size != src.size:
            await dst.resize(src.size)
        await self._sync_block_set(dst, src._hdr["object_map"])
        await self._copy_blocks(src.read, dst, src.size,
                                src._hdr["object_map"])
        dst._hdr["migration"] = {"role": "destination", "state": "executed"}
        await dst._save_header()

    async def commit(self, name: str) -> None:
        dst = await self.dst_rbd.open(name)
        try:
            src = await self.src_rbd.open(name)
        except RbdError:
            # crash-resume: the source was already torn down by a prior
            # commit that died before unmarking the destination — finish
            # that last step
            if dst._hdr.get("migration", {}).get("state") == "executed":
                dst._hdr.pop("migration", None)
                await dst._save_header()
                return
            raise
        if dst._hdr.get("migration", {}).get("state") != "executed":
            raise RbdError(f"migration of {name!r} has not executed")
        # ALL validation before ANY destructive step: sizes line up,
        # every SOURCE snapshot exists at the destination, and no source
        # snapshot has clone children (teardown would wedge otherwise).
        # Subset, not equality: a commit that crashed mid-source-teardown
        # resumes with some source snaps already gone — the destination
        # holding MORE history than the torn source is the expected
        # resumable state, not a validation failure.
        if dst.size != src.size or not set(src.snap_list()) <= \
                set(dst.snap_list()):
            raise RbdError(f"migration of {name!r} failed validation; "
                           f"abort or re-execute")
        for snap in src.snap_list():
            children = await self.src_rbd.children(name, snap)
            if children:
                raise RbdError(
                    f"source snapshot {snap!r} has clone children "
                    f"{children}; flatten them before committing")
        # final catch-up pass: writes that landed on the source AFTER
        # execute() are re-copied now — and blocks the source trimmed
        # since execute are deallocated — so commit is a full sync point,
        # not a silent cutoff (the reference's commit-time final sync
        # role); sizes were validated equal above
        await self._sync_block_set(dst, src._hdr["object_map"])
        await self._copy_blocks(src.read, dst, src.size,
                                src._hdr["object_map"])
        # teardown order matters for crash recovery: the source dies
        # FIRST and the destination is unmarked LAST, so a crash at any
        # point leaves a state commit() can resume from (src-gone +
        # dst-executed = the resume branch above); the reverse order
        # would strand a marked source no API call can clear
        for snap in list(src.snap_list()):
            snap_obj = src._snaps().get(snap, {})
            if snap_obj.get("protected"):
                await src.snap_unprotect(snap)
            await src.snap_remove(snap)
        src = await self.src_rbd.open(name)
        src._hdr.pop("migration", None)
        await src._save_header()
        await self.src_rbd.remove(name)
        dst._hdr.pop("migration", None)
        await dst._save_header()

    async def abort(self, name: str) -> None:
        dst = None
        try:
            dst = await self.dst_rbd.open(name)
        except RbdError:
            pass  # destination never created: abort is idempotent
        if dst is not None:
            if dst._hdr.get("migration", {}).get("role") != "destination":
                # a same-named image that was never a migration
                # destination must NOT be torn down by an aborted (or
                # mistyped) migration
                raise RbdError(
                    f"image {name!r} in the destination pool is not a "
                    f"migration destination; refusing to remove it")
            # teardown failures SURFACE (the destination stays marked and
            # abort can be retried) — swallowing them would clear the
            # source link below and wedge the half-removed destination
            for snap in list(dst.snap_list()):
                snap_obj = dst._snaps().get(snap, {})
                if snap_obj.get("protected"):
                    await dst.snap_unprotect(snap)
                await dst.snap_remove(snap)
            dst = await self.dst_rbd.open(name)
            dst._hdr.pop("migration", None)
            await dst._save_header()
            await self.dst_rbd.remove(name)
        src = await self.src_rbd.open(name)
        if src._hdr.pop("migration", None) is not None:
            await src._save_header()
