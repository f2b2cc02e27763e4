# Copy of ceph_tpu/rados/shm_ring.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Shared-memory ring pipe: the RingPipe discipline across a process
boundary.

The colocated :class:`~ceph_tpu.rados.reactor.RingPipe` (r13) proved the
bounded-slot / cross-loop-wakeup handoff inside one process.  This module
generalizes it to the PROCESS-sharded reactor plane (``ms_reactor_mode=
process``): a :class:`ShmRingPipe` is one direction of a delegated
connection's frame path — a single-producer/single-consumer byte ring
living in a ``multiprocessing.shared_memory`` block, with a socketpair
doorbell for cross-process (and cross-event-loop) wakeups.

Discipline, mirrored from the in-process ring:

- **bounded**: capacity is fixed at creation; a full ring parks the
  producer exactly like a full socket buffer parks ``drain()`` — the
  shm seam carries the same backpressure the TCP path has;
- **wakeup**: state changes (bytes published, space freed, close) are
  followed by a 1-byte doorbell send; the waiting side re-checks shared
  state after every doorbell read, so a coalesced/dropped byte can only
  ever cause a spurious re-check, never a lost wakeup.  The doorbell
  write is a syscall, which also orders the shm stores before the
  peer's loads (the release/acquire pair the plain-Python ring got for
  free from the GIL);
- **payload rule** (enforced by tpu-lint's cross-process-seam check):
  only WIRE BYTES cross — frame records, fixed-layout struct packs,
  raw flush-window bytes.  No live objects, loops, or locks survive a
  fork; anything else must be serialized by the caller first;
- **teardown**: every ``shared_memory`` open has a paired close (both
  ends) and unlink (creator only).  ``close()`` also shuts down its OWN
  doorbell socket so a parked ``await`` on this end wakes with
  ConnectionResetError instead of waiting on a peer that will never
  ding again.

Layout: ``[u64 head][u64 tail][u32 closed_p][u32 closed_c][pad to 64]``
then ``capacity`` data bytes.  ``head`` (free-running produced-byte
count) is written ONLY by the producer, ``tail`` ONLY by the consumer —
the classic SPSC split, so no cross-process lock exists at all.
Records larger than the ring stream through it: both sides copy in
bounded pieces, so one oversized fragment degrades to pipelined copies
instead of deadlocking the ring.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import socket
import struct
from typing import List, Optional, Tuple

_HDR_SIZE = 64
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_CLOSED_P = 16  # producer hung up
_OFF_CLOSED_C = 20  # consumer hung up

# record framing used by the frame-crossing (rx) direction:
# [u32 length-of-rest][u8 kind] then kind-specific bytes.  The tx
# direction is a raw byte stream (socket bytes need no records).
REC_HDR = struct.Struct("<IB")
REC_FRAME = 1   # [u16 type_id][u16 ver][u16 flags][u64 seq][u32 plen]
#                 [u32 blen][payload][blob]
REC_ERR = 2     # utf-8 error text (BadFrame on the parent side)
REC_EOF = 3     # clean transport EOF / reset
FRAME_HDR = struct.Struct("<HHHQII")
# REC_FRAME flag bits (worker -> parent; NOT wire flags)
RF_FIXED = 1
RF_VERIFIED = 2
RF_BLOB = 4


def _attach_shm(name: str, size: int):
    """Child-side attach to a parent-created shared_memory block.

    Prefers a direct ``/dev/shm`` open+mmap: the forked worker has had
    its inherited fds closed and must not re-enter multiprocessing's
    resource tracker (whose unlink-at-exit would race the parent's
    paired close/unlink).  Falls back to SharedMemory attach with the
    tracker registration undone.  Returns (memoryview, closer)."""
    try:
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            m = mmap.mmap(fd, _HDR_SIZE + size)
        finally:
            os.close(fd)
        return memoryview(m), m.close
    except OSError:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        return shm.buf, shm.close


class ShmRingPipe:
    """One end of one direction of a delegated connection's shm seam.

    Construct via :meth:`create` (parent; owns the shared_memory block
    and its unlink) or :meth:`attach` (worker child).  Exactly one
    producer end and one consumer end may exist per ring."""

    def __init__(self, buf, sock: socket.socket, capacity: int,
                 producer: bool, closer=None, shm=None):
        self._buf = buf                    # memoryview over hdr+data
        self._data = buf[_HDR_SIZE:_HDR_SIZE + capacity]
        self.capacity = capacity
        self.sock = sock                   # doorbell (nonblocking)
        self.producer = producer
        self._closer = closer              # child-side unmapper
        self._shm = shm                    # parent-side SharedMemory
        self.closed = False
        self._waiter = None                # parked _wait future, if any
        self.name = shm.name if shm is not None else ""

    # -- construction --------------------------------------------------------

    @staticmethod
    def create(capacity: int) -> Tuple["ShmRingPipe", str, socket.socket]:
        """Parent side: allocate the block + doorbell pair.  Returns
        (parent_end, shm_name, child_doorbell_sock); the caller chooses
        the parent role via ``parent_end.producer`` before use by
        calling :meth:`as_role`."""
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(create=True,
                                         size=_HDR_SIZE + capacity)
        try:
            shm.buf[:_HDR_SIZE] = b"\x00" * _HDR_SIZE
            a, b = socket.socketpair()
        except OSError:
            # fd exhaustion after the segment landed: unlink it now or
            # it outlives every process (the shm-lifecycle pairing)
            shm.close()
            shm.unlink()
            raise
        a.setblocking(False)
        b.setblocking(False)
        pipe = ShmRingPipe(shm.buf, a, capacity, producer=True, shm=shm)
        return pipe, shm.name, b

    def as_role(self, producer: bool) -> "ShmRingPipe":
        self.producer = producer
        return self

    @staticmethod
    def attach(name: str, capacity: int, sock: socket.socket,
               producer: bool) -> "ShmRingPipe":
        """Worker-child side: map the parent's block (see _attach_shm)."""
        buf, closer = _attach_shm(name, capacity)
        sock.setblocking(False)
        return ShmRingPipe(buf, sock, capacity, producer=producer,
                           closer=closer)

    # -- shared-state accessors ----------------------------------------------

    def _head(self) -> int:
        try:
            return _U64.unpack_from(self._buf, _OFF_HEAD)[0]
        except ValueError:  # buffer released by a concurrent close()
            raise ConnectionResetError("shm ring closed") from None

    def _tail(self) -> int:
        try:
            return _U64.unpack_from(self._buf, _OFF_TAIL)[0]
        except ValueError:
            raise ConnectionResetError("shm ring closed") from None

    def _set_head(self, v: int) -> None:
        try:
            _U64.pack_into(self._buf, _OFF_HEAD, v)
        except ValueError:
            raise ConnectionResetError("shm ring closed") from None

    def _set_tail(self, v: int) -> None:
        try:
            _U64.pack_into(self._buf, _OFF_TAIL, v)
        except ValueError:
            raise ConnectionResetError("shm ring closed") from None

    def peer_closed(self) -> bool:
        off = _OFF_CLOSED_C if self.producer else _OFF_CLOSED_P
        try:
            return bool(_U32.unpack_from(self._buf, off)[0])
        except ValueError:
            return True

    def fill(self) -> int:
        return self._head() - self._tail()

    # -- doorbell ------------------------------------------------------------

    def _ding(self) -> None:
        try:
            self.sock.send(b"\x01")
        except (BlockingIOError, InterruptedError):
            pass  # a byte is already pending: the peer will re-check
        except OSError:
            pass  # peer gone; state flags carry the close

    async def _wait(self) -> None:
        """Park until the peer dings (draining the doorbell), a local
        close() wakes us, or the doorbell EOFs (peer process death —
        which must look exactly like transport death, the lane-revival
        signal).  Implemented with an explicit waiter future instead of
        loop.sock_recv: closing an fd with a pending sock_recv silently
        drops it from the selector and the waiter would hang forever —
        close() resolves the future directly."""
        if self.closed:
            raise ConnectionResetError("shm ring closed")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        sock = self.sock
        try:
            fd = sock.fileno()
        except OSError:
            fd = -1
        if fd < 0:
            raise ConnectionResetError("shm ring doorbell lost")

        def _on_ready():
            try:
                data = sock.recv(4096)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
            if not fut.done():
                fut.set_result(bool(data))
        try:
            loop.add_reader(fd, _on_ready)
        except (OSError, ValueError):
            raise ConnectionResetError("shm ring doorbell lost") from None
        self._waiter = fut
        try:
            alive = await fut
        finally:
            self._waiter = None
            try:
                loop.remove_reader(fd)
            except (OSError, ValueError):
                pass
        if not alive:
            raise ConnectionResetError("shm ring peer gone")

    # -- producer ------------------------------------------------------------

    # publish threshold: batch head/tail updates + doorbells so a blob
    # handed over as MANY small pieces (a BufferList of 4 KiB stripe
    # views) costs one doorbell per ~chunk, not one syscall per piece —
    # and the peer still starts draining while a long copy is running
    _PUBLISH_CHUNK = 256 << 10

    async def send_bytes(self, pieces: List) -> int:
        """Stream ``pieces`` (bytes-like) into the ring in bounded
        copies, parking on a full ring.  Returns total bytes written."""
        assert self.producer
        total = 0
        cap = self.capacity
        data = self._data
        head = self._head()
        published = head
        try:
            for piece in pieces:
                mv = piece if isinstance(piece, memoryview) \
                    else memoryview(piece)
                if mv.ndim != 1 or mv.itemsize != 1:
                    mv = mv.cast("B")
                off = 0
                n = mv.nbytes
                while off < n:
                    if self.closed or self.peer_closed():
                        raise ConnectionResetError("shm ring closed")
                    free = cap - (head - self._tail())
                    if free <= 0:
                        if head != published:
                            self._set_head(head)
                            published = head
                            self._ding()
                            continue  # the peer may have drained already
                        await self._wait()
                        continue
                    take = min(free, n - off)
                    pos = head % cap
                    first = min(take, cap - pos)
                    data[pos:pos + first] = mv[off:off + first]
                    if take > first:
                        data[:take - first] = mv[off + first:off + take]
                    head += take
                    off += take
                    total += take
                    if head - published >= self._PUBLISH_CHUNK:
                        self._set_head(head)
                        published = head
                        self._ding()
        finally:
            if head != published:
                self._set_head(head)
                self._ding()
        return total

    async def put_record(self, kind: int, parts: List) -> None:
        """Record framing on top of the byte stream (rx direction):
        one [len][kind] header then the parts."""
        total = sum(
            (p.nbytes if isinstance(p, memoryview) else len(p))
            for p in parts)
        await self.send_bytes([REC_HDR.pack(total, kind), *parts])

    async def send_gather(self, wp, pieces: List) -> int:
        """send_bytes through the native wirepath's gather: ONE
        released-GIL foreign call copies a whole run of segments into
        each contiguous free region of the ring, instead of one
        interpreter copy per piece — the flush-window seam for blobs
        handed over as BufferLists of many small views (EC read replies
        are ~stripe-unit-sized slices)."""
        assert self.producer
        segs = []
        for p in pieces:
            mv = p if isinstance(p, memoryview) else memoryview(p)
            if mv.ndim != 1 or mv.itemsize != 1:
                mv = mv.cast("B")
            if mv.nbytes:
                segs.append(mv)
        total = 0
        cap = self.capacity
        data = self._data
        head = self._head()
        published = head
        idx = 0
        seg_off = 0
        try:
            while idx < len(segs):
                if self.closed or self.peer_closed():
                    raise ConnectionResetError("shm ring closed")
                free = cap - (head - self._tail())
                if free <= 0:
                    if head != published:
                        self._set_head(head)
                        published = head
                        self._ding()
                        continue
                    await self._wait()
                    continue
                pos = head % cap
                room = min(free, cap - pos)
                sub = []
                got = 0
                while idx < len(segs) and got < room:
                    seg = segs[idx]
                    avail = seg.nbytes - seg_off
                    take = min(room - got, avail)
                    sub.append(seg if (seg_off == 0 and take == avail)
                               else seg[seg_off:seg_off + take])
                    got += take
                    if take == avail:
                        idx += 1
                        seg_off = 0
                    else:
                        seg_off += take
                wp.wirepy_gather(sub, data[pos:pos + got])
                head += got
                total += got
                if head - published >= self._PUBLISH_CHUNK:
                    self._set_head(head)
                    published = head
                    self._ding()
        finally:
            if head != published:
                self._set_head(head)
                self._ding()
        return total

    # -- consumer ------------------------------------------------------------

    def _consumer_ding(self, pre_fill: int) -> None:
        """Space-available doorbell, TRANSITION-batched: the producer
        only parks after observing a FULL ring (it publishes its staged
        head before waiting, and its pre-park publish dings us), so a
        consume needs to ding back only when the ring was near capacity
        — consumes from a half-empty ring ring no bells.  The slack
        covers staleness of our head read; a parked producer's ring
        genuinely sat at capacity, which any post-doorbell (post-
        syscall, hence fresh) read of ours observes."""
        if pre_fill >= self.capacity - self._PUBLISH_CHUNK:
            self._ding()

    async def read_into(self, dest, n: int, wp=None) -> None:
        """Consume exactly n bytes into dest (writable buffer).  With a
        wirepath module (``wp``) the ring views land in dest through
        ONE released-GIL native gather per wait cycle — the consumer
        sibling of send_gather's producer-side copy, and the last
        parent-side per-byte pass on the rx plane when dest is the
        frame assembly buffer / install staging.  Error paths (closed /
        peer-closed ring) are identical with or without wp: the torn
        ring raises before any partial-cycle accounting."""
        assert not self.producer
        mv = dest if isinstance(dest, memoryview) else memoryview(dest)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        cap = self.capacity
        data = self._data
        off = 0
        while off < n:
            tail = self._tail()
            avail = self._head() - tail
            if avail <= 0:
                if self.closed:
                    raise ConnectionResetError("shm ring closed")
                if self.peer_closed():
                    raise ConnectionResetError("shm ring peer closed")
                await self._wait()
                continue
            take = min(avail, n - off)
            pos = tail % cap
            first = min(take, cap - pos)
            if wp is not None:
                pieces = [data[pos:pos + first]]
                if take > first:
                    pieces.append(data[:take - first])
                wp.wirepy_gather(pieces, mv[off:off + take])
            else:
                mv[off:off + first] = data[pos:pos + first]
                if take > first:
                    mv[off + first:off + take] = data[:take - first]
            self._set_tail(tail + take)
            self._consumer_ding(avail)
            off += take

    async def read_exact(self, n: int) -> bytes:
        buf = bytearray(n)
        await self.read_into(buf, n)
        return bytes(buf)

    async def read_record_hdr(self) -> Tuple[int, int]:
        """(kind, length) of the next record."""
        hdr = await self.read_exact(REC_HDR.size)
        length, kind = REC_HDR.unpack(hdr)
        return kind, length

    def peek(self, n: int) -> Optional[bytes]:
        """Non-consuming read of the next n buffered bytes (None when
        fewer are available) — the rx-batching predicate's peek."""
        if self.closed:
            return None
        try:
            tail = self._tail()
            if self._head() - tail < n:
                return None
        except ConnectionResetError:
            return None
        cap = self.capacity
        pos = tail % cap
        first = min(n, cap - pos)
        try:
            out = bytes(self._data[pos:pos + first])
            if n > first:
                out += bytes(self._data[:n - first])
        except ValueError:
            return None
        return out

    def complete_record_len(self) -> Optional[int]:
        """Length of the next record when it is FULLY buffered, else
        None — mirrors Messenger._buffered_frame_len: batch only what
        needs no further wait."""
        hdr = self.peek(REC_HDR.size)
        if hdr is None:
            return None
        length, _kind = REC_HDR.unpack(hdr)
        try:
            if self.fill() < REC_HDR.size + length:
                return None
        except ConnectionResetError:
            return None
        return length

    # -- consumer, zero-copy (worker tx drain) -------------------------------

    def get_views(self) -> List[memoryview]:
        """Views of every buffered byte (1 or 2 pieces across the wrap)
        WITHOUT consuming — the worker writev's straight from the ring
        and calls :meth:`consume` with what the kernel took."""
        tail = self._tail()
        avail = self._head() - tail
        if avail <= 0:
            return []
        cap = self.capacity
        pos = tail % cap
        first = min(avail, cap - pos)
        views = [self._data[pos:pos + first]]
        if avail > first:
            views.append(self._data[:avail - first])
        return views

    def consume(self, n: int) -> None:
        tail = self._tail()
        pre_fill = self._head() - tail
        self._set_tail(tail + n)
        self._consumer_ding(pre_fill)

    async def wait_readable(self) -> None:
        """Park until bytes are buffered (or the ring dies)."""
        while self.fill() <= 0:
            if self.closed:
                raise ConnectionResetError("shm ring closed")
            if self.peer_closed():
                raise ConnectionResetError("shm ring peer closed")
            await self._wait()

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        """Idempotent.  Marks this role closed, dings the peer, wakes
        any LOCAL parked await directly (its future resolves False =
        "ring gone"), then releases the mapping (paired close; the
        creating end also unlinks — the shared_memory lifecycle
        tpu-lint pins)."""
        if self.closed:
            return
        self.closed = True
        try:
            off = _OFF_CLOSED_P if self.producer else _OFF_CLOSED_C
            _U32.pack_into(self._buf, off, 1)
        except (ValueError, TypeError):
            pass  # buffer already released
        self._ding()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        w = self._waiter
        if w is not None and not w.done():
            # wake the parked await, but defer the fd close until after
            # its finally-block removed the reader: closing now would
            # let the fd number be reused before remove_reader runs,
            # unregistering some OTHER connection's watcher
            w.set_result(False)
            sock = self.sock
            try:
                w.get_loop().call_soon_threadsafe(sock.close)
            except RuntimeError:
                sock.close()
        else:
            try:
                self.sock.close()
            except OSError:
                pass
        # release views before unmapping (a live export blocks close)
        try:
            self._data.release()
            self._buf.release()
        except (AttributeError, ValueError):
            pass
        if self._shm is not None:
            try:
                self._shm.close()
            except Exception:
                pass
            try:
                self._shm.unlink()
            except Exception:
                pass  # already unlinked (double-close is a no-op)
        elif self._closer is not None:
            try:
                self._closer()
            except Exception:
                pass
