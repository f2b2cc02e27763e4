# Copy of ceph_tpu/services/rbd_export.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""RBD export / import / diff streams (reference `rbd export`,
`rbd export-diff` / `rbd import-diff`, src/tools/rbd + librbd/api/DiffIterate).

A stream is a framed record sequence:

    magic  b"ceph_tpu-rbd-diff-v1\\n"
    b"m" + u32 len + JSON   stream metadata {size, from_snap, to_snap}
    b"w" + u64 off + u32 len + bytes   write these bytes at off
    b"z" + u64 off + u32 len           zero (trim) this extent
    b"e"                               end

A full export is a diff against the empty image (from_snap=None): only
allocated blocks are emitted, so sparse images stay sparse through a
backup round-trip.  Diffs enumerate blocks through the image OBJECT
MAPS (the fast-diff role): candidate set = union of both sides'
allocated blocks; bytes are compared so an allocated-but-identical
block is not shipped.  Blocks allocated in `from` but gone in `to`
become trim records, so a shrunken/discarded extent propagates.
"""

from __future__ import annotations

import json
import struct
from typing import BinaryIO, Optional

from ceph_tpu_torch.services.rbd import RBD, Image, RbdError

MAGIC = b"ceph_tpu-rbd-diff-v1\n"
_W = struct.Struct("<QI")  # offset, length


def _emit_meta(out: BinaryIO, meta: dict) -> None:
    blob = json.dumps(meta).encode()
    out.write(b"m" + struct.pack("<I", len(blob)) + blob)


async def _side_state(img: Image, snap: Optional[str]):
    """(block set, size, reader) for one side of the diff."""
    if snap is None:
        return (set(img._hdr["object_map"]), img.size,
                lambda off, n: img.read(off, n))
    info = img._snaps().get(snap)
    if info is None:
        raise RbdError(f"no snapshot {snap!r}")
    return (set(info.get("object_map", ())), info["size"],
            lambda off, n: img.read_snap(snap, off, n))


async def export_diff(img: Image, out: BinaryIO,
                      from_snap: Optional[str] = None,
                      to_snap: Optional[str] = None) -> dict:
    """Write the delta from `from_snap` (None = empty image: a FULL
    export) up to `to_snap` (None = head).  Returns stream stats."""
    await img._refresh()
    if from_snap is None:
        from_blocks, from_size = set(), 0
        from_read = None
    else:
        from_blocks, from_size, from_read = await _side_state(
            img, from_snap)
    to_blocks, to_size, to_read = await _side_state(img, to_snap)
    out.write(MAGIC)
    _emit_meta(out, {"size": to_size, "from_snap": from_snap,
                     "to_snap": to_snap})
    bs = img.object_size
    written = trimmed = 0
    for idx in sorted(to_blocks | from_blocks):
        off = idx * bs
        if off >= to_size:
            continue  # beyond the target size: the size shrink trims it
        n = min(bs, to_size - off)
        if idx not in to_blocks:
            # allocated before, gone now: propagate the hole
            out.write(b"z" + _W.pack(off, n))
            trimmed += 1
            continue
        data = await to_read(off, n)
        if idx in from_blocks and from_read is not None \
                and off + n <= from_size:
            old = await from_read(off, n)
            if old == data:
                continue  # allocated both sides, identical: skip
        if not data.strip(b"\x00"):
            # all zeros: a trim record keeps the destination sparse
            out.write(b"z" + _W.pack(off, n))
            trimmed += 1
            continue
        out.write(b"w" + _W.pack(off, n) + data)
        written += 1
    out.write(b"e")
    return {"size": to_size, "blocks_written": written,
            "blocks_trimmed": trimmed}


async def export_image(img: Image, out: BinaryIO,
                       snap: Optional[str] = None) -> dict:
    """Full (sparse-preserving) export of head or a snapshot."""
    return await export_diff(img, out, from_snap=None, to_snap=snap)


def _read_exact(inp: BinaryIO, n: int) -> bytes:
    buf = inp.read(n)
    if len(buf) != n:
        raise RbdError("truncated diff stream")
    return buf


async def apply_diff(img: Image, inp: BinaryIO) -> dict:
    """Apply a diff stream to an image (rbd import-diff role).  The
    image is resized to the stream's recorded size first, so size
    changes (grow AND shrink) propagate."""
    if _read_exact(inp, len(MAGIC)) != MAGIC:
        raise RbdError("bad magic: not a ceph_tpu rbd diff stream")
    meta: dict = {}
    applied = trims = 0
    while True:
        tag = _read_exact(inp, 1)
        if tag == b"e":
            break
        if tag == b"m":
            (n,) = struct.unpack("<I", _read_exact(inp, 4))
            meta = json.loads(_read_exact(inp, n))
            if img.size != int(meta["size"]):
                await img.resize(int(meta["size"]))
        elif tag == b"w":
            off, n = _W.unpack(_read_exact(inp, _W.size))
            await img.write(off, _read_exact(inp, n))
            applied += 1
        elif tag == b"z":
            off, n = _W.unpack(_read_exact(inp, _W.size))
            # a zero record must DEALLOCATE where it can, but only
            # blocks the extent FULLY covers — a partial-block zero
            # extent (legal in the framed format) must not discard
            # live bytes outside [off, off+n).  The extent is clamped
            # to the image size (export_diff emits tail trims with
            # n = size - off; a foreign over-long extent must not
            # abort mid-stream after earlier records applied).
            bs = img.object_size
            end = min(off + n, img.size)
            if bool(img._hdr.get("parent")) and end > off:
                # a CLONE's hole is parent data, not zeros (reads fall
                # through to the parent snapshot) — dropping blocks or
                # skipping unallocated ones would resurrect the
                # parent's bytes where the stream says zero.
                # Materialize zeros instead (copy-up keeps the rest of
                # each block intact); hole preservation is the
                # flat-image optimization only.  Block-sized steps
                # bound memory for huge extents.
                pos = off
                while pos < end:
                    step = min(end - pos, bs - pos % bs)
                    await img.write(pos, b"\x00" * step)
                    pos += step
                trims += 1
                continue
            drop = []
            partial = []
            for i in (range(off // bs, (end - 1) // bs + 1)
                      if end > off else ()):
                b_start = i * bs
                b_end = min((i + 1) * bs, img.size)
                if off <= b_start and end >= b_end:
                    # fully covered up to the image size: the tail
                    # block of a non-aligned image deallocates too
                    # (holes stay holes through a backup round-trip)
                    if i in img._hdr["object_map"]:
                        drop.append(i)
                elif i in img._hdr["object_map"]:
                    # allocated partial head/tail: explicit zeros over
                    # just the extent; an UNALLOCATED partial is
                    # already zeros — writing would materialize it
                    partial.append((max(off, b_start), min(end, b_end)))
            for i in drop:
                try:
                    await img.ioctx.remove(img._data_oid(i),
                                           snapc=img._image_snapc())
                except Exception:
                    pass
            if drop:
                img._hdr["object_map"] = sorted(
                    set(img._hdr["object_map"]) - set(drop))
                await img._save_header(drop_blocks=drop)
            for p_off, p_end in partial:
                await img.write(p_off, b"\x00" * (p_end - p_off))
            trims += 1
        else:
            raise RbdError(f"bad record tag {tag!r}")
    return {"meta": meta, "writes": applied, "trims": trims}


async def import_image(rbd: RBD, name: str, inp: BinaryIO,
                       order: int = 22) -> Image:
    """Create `name` from a full export stream (rbd import role)."""
    head = _read_exact(inp, len(MAGIC))
    if head != MAGIC:
        raise RbdError("bad magic: not a ceph_tpu rbd diff stream")
    tag = _read_exact(inp, 1)
    if tag != b"m":
        raise RbdError("stream missing metadata record")
    (n,) = struct.unpack("<I", _read_exact(inp, 4))
    meta = json.loads(_read_exact(inp, n))
    img = await rbd.create(name, int(meta["size"]), order=order)
    while True:
        tag = _read_exact(inp, 1)
        if tag == b"e":
            break
        if tag == b"w":
            off, length = _W.unpack(_read_exact(inp, _W.size))
            await img.write(off, _read_exact(inp, length))
        elif tag == b"z":
            _W.unpack(_read_exact(inp, _W.size))  # fresh image: hole
        elif tag == b"m":
            (n,) = struct.unpack("<I", _read_exact(inp, 4))
            _read_exact(inp, n)
        else:
            raise RbdError(f"bad record tag {tag!r}")
    return img
