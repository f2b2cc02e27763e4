"""BufferList and as_bytes: the messenger's multi-buffer blob.

Copy of ceph_tpu/rados/messenger.py:396-460 at commit 645aba9
(``_norm_segments``, ``BufferList``, ``as_bytes``), the part of the
messenger that ecutil's scatter decode returns.  The messenger itself is
not ported yet.
"""

from __future__ import annotations

import copyreg


def _norm_segments(segments):
    """Normalize buffers to non-empty 1-D byte memoryviews; returns
    (views, total_bytes)."""
    segs = []
    total = 0
    for s in segments:
        mv = s if isinstance(s, memoryview) else memoryview(s)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            segs.append(mv)
            total += mv.nbytes
    return segs, total


class BufferList:
    """A blob made of multiple buffers (the reference's bufferlist,
    src/common/buffer.h): a message's bulk field may be handed over as a
    list of byte pieces (per-stripe chunk views, extent slices) that a
    send path writes straight from their owning buffers, with no gather
    copy.  The bytes it stands for are the concatenation of its pieces.
    Pickling one materializes it to plain bytes."""

    __slots__ = ("segments", "nbytes")

    def __init__(self, segments=()):
        self.segments, self.nbytes = _norm_segments(segments)

    def __len__(self) -> int:
        return self.nbytes

    def tobytes(self) -> bytes:
        return b"".join(self.segments)

    def __bytes__(self) -> bytes:
        return self.tobytes()


# a BufferList that rides pickle lands as plain bytes
copyreg.pickle(BufferList, lambda bl: (bytes, (bl.tobytes(),)))


def as_bytes(data) -> bytes:
    """Materialize a message bulk field to bytes: it may be bytes,
    bytearray, memoryview or BufferList depending on the path it took."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, BufferList):
        return data.tobytes()
    return bytes(data)
