# Copy of ceph_tpu/rados/striper.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""radosstriper: stripe one logical object across many RADOS objects.

Role-equivalent of the reference's libradosstriper
(src/libradosstriper/RadosStriperImpl.cc): a logical object is cut into
`object_size`-byte pieces named ``<soid>.%016d``; a header object
``<soid>`` carries the striping layout + total size in xattr-style
metadata so readers reassemble without listing.  This is the same layout
discipline RBD and CephFS use for their data objects.
"""

from __future__ import annotations

import asyncio
import json
from typing import List, Optional

from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.rados.librados import IoCtx

DEFAULT_OBJECT_SIZE = 1 << 22  # 4 MiB, the reference default


class RadosStriper:
    def __init__(self, ioctx: IoCtx, object_size: int = DEFAULT_OBJECT_SIZE):
        self.ioctx = ioctx
        self.object_size = object_size

    @staticmethod
    def _piece(soid: str, index: int) -> str:
        return f"{soid}.{index:016d}"

    def _header(self, soid: str) -> str:
        return f"{soid}.__striper__"

    async def write(self, soid: str, data: bytes) -> None:
        """Full-object striped write: pieces in parallel + header
        (layout + size)."""
        # the previous header (one tiny read) tells us exactly which tail
        # pieces a shrinking rewrite must trim — never a pool listing
        old_pieces = 0
        try:
            old_pieces = json.loads(
                await self.ioctx.read(self._header(soid)))["pieces"]
        except (RadosError, KeyError, ValueError):
            pass
        n = max(1, (len(data) + self.object_size - 1) // self.object_size)
        try:
            await asyncio.gather(*(
                self.ioctx.write_full(
                    self._piece(soid, i),
                    data[i * self.object_size:(i + 1) * self.object_size])
                for i in range(n)
            ))
        except BaseException:
            # pieces 0..old_n may now hold MIXED generations: mark the
            # object unreadable (size -1 tombstone) rather than let reads
            # stitch old and new bytes together, then drop this attempt's
            # orphan tail pieces
            try:
                await self.ioctx.write_full(
                    self._header(soid),
                    json.dumps({"object_size": self.object_size,
                                "size": -1,
                                "pieces": max(old_pieces, n)}).encode())
            except Exception:
                pass
            await asyncio.gather(*(
                self.ioctx.remove(self._piece(soid, i))
                for i in range(max(0, old_pieces), n)
            ), return_exceptions=True)
            raise
        header = {"object_size": self.object_size, "size": len(data),
                  "pieces": n}
        await self.ioctx.write_full(self._header(soid),
                                    json.dumps(header).encode())
        if old_pieces > n:
            await asyncio.gather(*(
                self.ioctx.remove(self._piece(soid, i))
                for i in range(n, old_pieces)
            ), return_exceptions=True)

    async def read(self, soid: str) -> bytes:
        header = json.loads(await self.ioctx.read(self._header(soid)))
        if header.get("size", 0) < 0:
            raise RadosError(f"{soid}: torn by an interrupted write")
        pieces = await asyncio.gather(*(
            self.ioctx.read(self._piece(soid, i))
            for i in range(header["pieces"])
        ))
        return b"".join(pieces)[:header["size"]]

    async def read_range(self, soid: str, off: int, length: int) -> bytes:
        """Partial read: only the pieces overlapping [off, off+length)
        are fetched (reference libradosstriper read path: extent →
        per-object extents via the layout, no full-object
        materialization).  Clamped to the object size."""
        header = json.loads(await self.ioctx.read(self._header(soid)))
        if header.get("size", 0) < 0:
            raise RadosError(f"{soid}: torn by an interrupted write")
        size = header["size"]
        osize = header["object_size"]
        end = min(off + max(0, length), size)
        if off >= end:
            return b""
        first, last = off // osize, (end - 1) // osize
        pieces = await asyncio.gather(*(
            self.ioctx.read(self._piece(soid, i))
            for i in range(first, last + 1)
        ))
        base = first * osize
        return b"".join(pieces)[off - base:end - base]

    async def stat(self, soid: str) -> dict:
        return json.loads(await self.ioctx.read(self._header(soid)))

    async def remove(self, soid: str) -> None:
        try:
            header = json.loads(await self.ioctx.read(self._header(soid)))
        except RadosError:
            return
        for i in range(header["pieces"]):
            try:
                await self.ioctx.remove(self._piece(soid, i))
            except RadosError:
                pass
        await self.ioctx.remove(self._header(soid))

    async def list(self) -> List[str]:
        suffix = ".__striper__"
        return sorted(
            o[: -len(suffix)]
            for o in await self.ioctx.list_objects()
            if o.endswith(suffix)
        )
