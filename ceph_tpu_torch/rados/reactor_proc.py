# Copy of ceph_tpu/rados/reactor_proc.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Process-sharded reactor workers (``ms_reactor_mode=process``).

The thread-mode reactor pool (reactor.py) gave each socket shard its own
event loop, but every shard still shares ONE interpreter: pickle, frame
bookkeeping, lane accounting and dispatch pumping contend on the GIL, so
the measured lanes_sweep curve collapses past 2 lanes on a small host.
This module is the other half of the GIL escape: a reactor worker is a
forked PROCESS owning its socket shard outright — frame rx (header
parse, burst crc verify), and tx (whole-backlog writev straight out of
the shm ring) run on a truly independent core, with its own copy of the
native wirepath (resolved pre-fork, inherited per process).

Topology (one delegated connection):

    parent (home loop)                      worker process
    ------------------                      --------------
    Connection.send -> frame -> outbox      tx ring  --> writev(sock)
      flusher window --> ShmConnEndpoint -->   (zero-copy out of the ring)
    Connection.read_frame <-- rx ring  <--  sock recv -> parse -> crc
      decode + dispatch on the home loop        verify (native, batched)

Frames cross the boundary through :class:`~ceph_tpu.rados.shm_ring.
ShmRingPipe` as WIRE BYTES only — the tpu-lint cross-process-seam rule:
no live object, event loop, or lock survives the fork.  Lane fragments
land scatter-side in the parent's shm-fed assembly slice (the
MLaneSegment chunk is copied once socket->shm by the worker; the parent
reads it straight into its slice of the group assembly buffer), so the
crossing adds no per-fragment gather pass.

Worker death is handled like lossless lane death (messenger
_revive_lane): the parent's ring awaits wake with ConnectionResetError,
the lane closes, the owning shard revives in a FRESH worker (the pool
respawns the slot) and replays only its own pinned frames; lossy shards
die group-fatal.  The pool reaps every child it forks — respawn joins
the old pid, shutdown SIGKILLs and joins stragglers — so daemon
shutdown leaves no zombies (test-pinned).

The child is fork-hygienic: it closes every inherited fd except its
control socket (an inherited copy of ANOTHER shard's socket would keep
that socket alive past its worker's death), clears the inherited asyncio
state, arms PDEATHSIG, and exits on control-socket EOF — a dying parent
can never strand workers.
"""

from __future__ import annotations

import asyncio
import base64
import ctypes
import json
import os
import signal
import socket
import struct
import sys
import traceback
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.shm_ring import (FRAME_HDR, REC_EOF, REC_ERR, REC_FRAME,
                                     RF_BLOB, RF_FIXED, RF_VERIFIED,
                                     ShmRingPipe)
from ceph_tpu_torch.utils import wirepath as _wirepath
from ceph_tpu_torch.utils.checksum import checksum as _checksum

# wire frame geometry, mirrored from messenger.py (module-level there;
# duplicated here so the child never imports the messenger at runtime —
# the layouts below are the frame ABI the wire corpus pins)
_WHDR = struct.Struct("<IHHBIQ")   # len, type, version, flags, crc, seq
_BPFX = struct.Struct("<II")       # pickled len, blob crc
_F_COMPRESSED = 1
_F_BLOB = 2
_F_FIXED = 4

# per-worker counter block (u64 slots in a pre-fork SharedMemory the
# child writes and the parent reads lock-free: single-writer slots)
CTR_CONNS = 0
CTR_ACCEPTED = 1
CTR_RX_FRAMES = 2
CTR_RX_BYTES = 3
CTR_TX_CALLS = 4
CTR_TX_BYTES = 5
CTR_NATIVE_RX = 6
CTR_NATIVE_TX = 7
CTR_NATIVE_BYTES = 8
CTR_WIREPATH = 9
COUNTER_SLOTS = 12
_CTR = struct.Struct("<Q")

_LEFTOVER_CHUNK = 32 << 10
_CTRL_BUF = 1 << 20


class _Counters:
    """Single-writer view over the worker's counter block."""

    def __init__(self, buf):
        self.buf = buf

    def add(self, slot: int, n: int = 1) -> None:
        _CTR.pack_into(self.buf, slot * 8,
                       _CTR.unpack_from(self.buf, slot * 8)[0] + n)

    def set(self, slot: int, v: int) -> None:
        _CTR.pack_into(self.buf, slot * 8, v)


def read_counters(buf) -> Dict[str, int]:
    vals = struct.unpack_from(f"<{COUNTER_SLOTS}Q", buf, 0)
    return {"conns": vals[CTR_CONNS], "accepted": vals[CTR_ACCEPTED],
            "rx_frames": vals[CTR_RX_FRAMES], "rx_bytes": vals[CTR_RX_BYTES],
            "tx_calls": vals[CTR_TX_CALLS], "tx_bytes": vals[CTR_TX_BYTES],
            "native_rx_calls": vals[CTR_NATIVE_RX],
            "native_tx_calls": vals[CTR_NATIVE_TX],
            "native_bytes": vals[CTR_NATIVE_BYTES],
            "wirepath_kind": vals[CTR_WIREPATH]}


# -- child process ------------------------------------------------------------


def _close_inherited_fds(keep: set) -> None:
    try:
        fds = [int(x) for x in os.listdir("/proc/self/fd")]
    except OSError:
        fds = list(range(3, 1024))
    for fd in fds:
        if fd not in keep:
            try:
                os.close(fd)
            except OSError:
                pass


def _arm_pdeathsig() -> None:
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except Exception:
        pass  # ctrl-EOF exit remains the portable backstop


async def _readable(loop, sock) -> None:
    fut = loop.create_future()
    fd = sock.fileno()
    loop.add_reader(fd, lambda: (not fut.done()) and fut.set_result(None))
    try:
        await fut
    finally:
        loop.remove_reader(fd)


async def _writable(loop, sock) -> None:
    fut = loop.create_future()
    fd = sock.fileno()
    loop.add_writer(fd, lambda: (not fut.done()) and fut.set_result(None))
    try:
        await fut
    finally:
        loop.remove_writer(fd)


async def _ctrl_recv(loop, ctrl):
    """One SEQPACKET control message (+ passed fds); (None, []) on EOF."""
    while True:
        try:
            msg, fds, _flags, _addr = socket.recv_fds(ctrl, _CTRL_BUF, 8)
        except (BlockingIOError, InterruptedError):
            await _readable(loop, ctrl)
            continue
        except OSError:
            return None, []
        if not msg:
            return None, []
        return msg, list(fds)


class _WConn:
    """Child-side state of one delegated connection."""

    def __init__(self, conn_id: int, sock, tx: ShmRingPipe, rx: ShmRingPipe,
                 crc_mode: str, leftover_chunks: int):
        self.conn_id = conn_id
        self.sock = sock
        self.tx = tx                 # parent->worker bytes (we consume)
        self.rx = rx                 # worker->parent records (we produce)
        self.crc_mode = crc_mode
        self.want_leftover = leftover_chunks
        self.leftover = bytearray()
        self.tasks: List[asyncio.Task] = []
        self.dead = False

    def crc_fn(self):
        if self.crc_mode == "shared":
            return _checksum
        if self.crc_mode == "zlib":
            return zlib.crc32
        return None

    def close(self) -> None:
        if self.dead:
            return
        self.dead = True
        for t in self.tasks:
            t.cancel()
        try:
            self.sock.close()
        except OSError:
            pass
        self.tx.close()
        self.rx.close()


def _parse_burst(backlog: bytearray, crc_fn, wp, ctr: _Counters):
    """Parse every COMPLETE frame buffered in backlog.  Returns
    (consumed, frames, error_text): frames are
    [type_id, version, seq, wire_flags, payload_off, payload_len,
    blob_off, blob_len, verified]; crc sections of the whole burst are
    verified in ONE released-GIL native call when the wirepath resolved
    (the r17 discipline, now running on the worker's own core)."""
    pos = 0
    end = len(backlog)
    frames: List[list] = []
    voffs: List[int] = []
    vlens: List[int] = []
    vwants: List[int] = []
    expect: List[Tuple[int, bool]] = []
    err: Optional[str] = None
    err_end = 0
    crc_on = crc_fn is not None
    while end - pos >= _WHDR.size:
        length, type_id, version, flags, crc, seq = _WHDR.unpack_from(
            backlog, pos)
        if end - pos - _WHDR.size < length:
            break
        fstart = pos + _WHDR.size
        fend = fstart + length
        if flags & _F_BLOB:
            if _BPFX.size > length:
                err = f"bad blob prefix on type {type_id}"
                err_end = fend
                break
            plen, blob_crc = _BPFX.unpack_from(backlog, fstart)
            if _BPFX.size + plen > length:
                err = f"bad blob prefix on type {type_id}"
                err_end = fend
                break
            hdr_end = fstart + _BPFX.size + plen
            blen = length - _BPFX.size - plen
            verified = False
            if crc and crc_on:
                voffs.append(fstart)
                vlens.append(hdr_end - fstart)
                vwants.append(crc)
                expect.append((len(frames), False))
            if blob_crc and crc_on:
                voffs.append(hdr_end)
                vlens.append(blen)
                vwants.append(blob_crc)
                expect.append((len(frames), True))
                verified = True
            frames.append([type_id, version, seq, flags,
                           fstart + _BPFX.size, plen, hdr_end, blen,
                           verified])
        else:
            if crc and crc_on:
                voffs.append(fstart)
                vlens.append(length)
                vwants.append(crc)
                expect.append((len(frames), False))
            frames.append([type_id, version, seq, flags, fstart, length,
                           -1, 0, False])
        pos = fend
    bad_idx = len(frames)
    if voffs:
        if wp is not None:
            bad = wp.wirepy_verify_regions(backlog, voffs, vlens, vwants)
            ctr.add(CTR_NATIVE_RX)
            ctr.add(CTR_NATIVE_BYTES, sum(vlens))
        else:
            bad = -1
            mv = memoryview(backlog)
            for i, (o, ln, want) in enumerate(zip(voffs, vlens, vwants)):
                if crc_fn(mv[o:o + ln]) != want:
                    bad = i
                    break
            mv.release()
        if bad >= 0:
            fidx, is_blob = expect[bad]
            if fidx < bad_idx:
                bad_idx = fidx
                err = (("blob crc mismatch on type {}" if is_blob
                        else "crc mismatch on frame type {}")
                       .format(frames[fidx][0]))
                err_end = sum(_WHDR.size + (
                    f[5] if f[6] < 0 else _BPFX.size + f[5] + f[7])
                    for f in frames[:fidx + 1])
    consumed = pos if err is None else err_end
    return consumed, frames[:bad_idx], err


async def _rx_task(st: _WConn, loop, wp, ctr: _Counters) -> None:
    """Socket -> rx ring: parse, burst-verify, decompress, and stream
    each frame's bytes into the shm record — the single socket->shm
    copy of the crossing."""
    sock = st.sock
    backlog = bytearray(st.leftover)
    st.leftover = bytearray()
    crc_fn = st.crc_fn()
    # the native verifier computes crc32c: only the SHARED-resolver
    # connections may use it — a zlib-negotiated connection (mixed-host
    # degrade, messenger._negotiated_crc) must verify with zlib or
    # every frame would fail and loop the lane through BadFrame
    wp = wp if st.crc_mode == "shared" else None

    async def _emit(frames) -> None:
        # own scope: every memoryview slice of the backlog dies here,
        # so the caller's `del backlog[:consumed]` can resize it
        mv = memoryview(backlog)
        try:
            for (type_id, version, seq, flags, poff, plen, boff,
                 blen, verified) in frames:
                payload: Any = mv[poff:poff + plen]
                if flags & _F_COMPRESSED and not (flags & _F_BLOB):
                    payload = zlib.decompress(payload)
                    plen = len(payload)
                rflags = ((RF_FIXED if flags & _F_FIXED else 0)
                          | (RF_VERIFIED if verified else 0)
                          | (RF_BLOB if flags & _F_BLOB else 0))
                parts = [FRAME_HDR.pack(type_id, version, rflags,
                                        seq, plen, blen), payload]
                if blen:
                    parts.append(mv[boff:boff + blen])
                await st.rx.put_record(REC_FRAME, parts)
                del parts, payload
                ctr.add(CTR_RX_FRAMES)
                ctr.add(CTR_RX_BYTES, _WHDR.size + plen + blen)
        finally:
            mv.release()

    try:
        while True:
            consumed, frames, err = _parse_burst(backlog, crc_fn, wp, ctr)
            if frames or err:
                await _emit(frames)
                if err is not None:
                    await st.rx.put_record(REC_ERR, [err.encode()])
                    return
            if consumed:
                del backlog[:consumed]
            try:
                data = await loop.sock_recv(sock, 256 << 10)
            except (ConnectionError, OSError):
                data = b""
            if not data:
                await st.rx.put_record(REC_EOF, [])
                return
            backlog += data
    except ConnectionResetError:
        return  # ring torn down (parent close / worker shutdown)
    except asyncio.CancelledError:
        raise
    except Exception:
        traceback.print_exc(file=sys.stderr)
        try:
            await st.rx.put_record(REC_EOF, [])
        except ConnectionResetError:
            pass


async def _writev_once(loop, sock, views, wp, ctr: _Counters) -> int:
    """One write pass over the ring's buffered views; parks on EAGAIN.
    Returns bytes the kernel took (so the caller can consume them)."""
    while True:
        try:
            if wp is not None:
                n = wp.wirepy_writev(sock.fileno(), views)
                ctr.add(CTR_NATIVE_TX)
                if n:
                    ctr.add(CTR_NATIVE_BYTES, n)
            else:
                n = sock.sendmsg(views[:64])
        except (BlockingIOError, InterruptedError):
            n = 0
        if n:
            ctr.add(CTR_TX_CALLS)
            ctr.add(CTR_TX_BYTES, n)
            return n
        await _writable(loop, sock)


async def _tx_task(st: _WConn, loop, wp, ctr: _Counters) -> None:
    """tx ring -> socket: writev STRAIGHT from the shm ring (no copy on
    this side); consume only what the kernel actually took so the
    parent can never overwrite unsent bytes."""
    pipe = st.tx
    sock = st.sock
    try:
        while True:
            views = pipe.get_views()
            if not views:
                await pipe.wait_readable()
                continue
            n = await _writev_once(loop, sock, views, wp, ctr)
            for v in views:
                v.release()
            pipe.consume(n)
    except ConnectionResetError:
        return  # ring torn down
    except asyncio.CancelledError:
        raise
    except (ConnectionError, OSError):
        # socket died: close it so the rx side's read raises promptly
        # and reports EOF to the parent (transport-death signal)
        try:
            sock.close()
        except OSError:
            pass
    except Exception:
        traceback.print_exc(file=sys.stderr)


def _start_conn(st: _WConn, loop, wp, ctr: _Counters) -> None:
    # called from the ctrl serve coroutine: on-loop by construction
    running = asyncio.get_running_loop()
    st.tasks.append(running.create_task(_rx_task(st, loop, wp, ctr)))
    st.tasks.append(running.create_task(_tx_task(st, loop, wp, ctr)))
    ctr.add(CTR_CONNS)


async def _accept_task(lsock, ctrl, loop, ctr: _Counters) -> None:
    """Accept on the inherited dup'd listening fd and forward each
    fresh socket to the parent (the handshake needs parent state:
    keyring, session table, ring registry)."""
    while True:
        try:
            c, _addr = lsock.accept()
        except (BlockingIOError, InterruptedError):
            await _readable(loop, lsock)
            continue
        except OSError:
            return
        ctr.add(CTR_ACCEPTED)
        try:
            while True:
                try:
                    socket.send_fds(ctrl, [b'{"op": "accepted"}'],
                                    [c.fileno()])
                    break
                except (BlockingIOError, InterruptedError):
                    await _writable(loop, ctrl)
        except OSError:
            pass
        c.close()


async def _child_serve(ctrl, counters_buf, use_native: bool) -> None:
    loop = asyncio.get_running_loop()
    ctr = _Counters(counters_buf)
    wp = _wirepath.impl() if use_native else None
    ctr.set(CTR_WIREPATH, 1 if wp is not None else 0)
    conns: Dict[int, _WConn] = {}
    acceptors: List[asyncio.Task] = []
    lsocks: List[socket.socket] = []

    def _op_delegate(obj, fds) -> None:
        # a failed attach means the parent already tore the connection
        # down (delegate->close races are legitimate: injected failures
        # close right behind the handoff) — discard THIS delegation;
        # never let it kill the worker and every other shard it carries
        sock = socket.socket(fileno=fds[0])
        db_tx = socket.socket(fileno=fds[1])
        db_rx = socket.socket(fileno=fds[2])
        tx = rx = None
        try:
            sock.setblocking(False)
            cap = int(obj["cap"])
            tx = ShmRingPipe.attach(obj["tx"], cap, db_tx, producer=False)
            rx = ShmRingPipe.attach(obj["rx"], cap, db_rx, producer=True)
        except Exception:
            for closable in (tx, rx):
                if closable is not None:
                    closable.close()
            for s in (sock, db_tx, db_rx):
                try:
                    s.close()
                except OSError:
                    pass
            return
        st = _WConn(int(obj["conn"]), sock, tx, rx,
                    str(obj.get("crc", "off")), int(obj.get("nleft", 0)))
        conns[st.conn_id] = st
        if st.want_leftover == 0:
            _start_conn(st, loop, wp, ctr)

    try:
        while True:
            msg, fds = await _ctrl_recv(loop, ctrl)
            if msg is None:
                return  # parent gone: exit (PDEATHSIG is the backstop)
            try:
                obj = json.loads(msg)
            except ValueError:
                obj = {}
            try:
                op = obj.get("op")
                if op == "delegate" and len(fds) == 3:
                    _op_delegate(obj, fds)
                elif op == "leftover":
                    st = conns.get(int(obj.get("conn", -1)))
                    if st is not None and st.want_leftover > 0:
                        st.leftover += base64.b64decode(
                            obj.get("data", ""))
                        st.want_leftover -= 1
                        if st.want_leftover == 0:
                            _start_conn(st, loop, wp, ctr)
                elif op == "close":
                    st = conns.pop(int(obj.get("conn", -1)), None)
                    if st is not None:
                        st.close()
                elif op == "listen" and len(fds) == 1:
                    lsock = socket.socket(fileno=fds[0])
                    lsock.setblocking(False)
                    lsocks.append(lsock)
                    acceptors.append(loop.create_task(
                        _accept_task(lsock, ctrl, loop, ctr)))
                elif op == "shutdown":
                    return
                else:
                    for fd in fds:
                        os.close(fd)
            except Exception:
                # one bad control op must never take the worker (and
                # every other shard it carries) down
                traceback.print_exc(file=sys.stderr)
                for fd in fds:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
    finally:
        for t in acceptors:
            t.cancel()
        for ls in lsocks:
            try:
                ls.close()
            except OSError:
                pass
        for st in list(conns.values()):
            st.close()


def _child_main(ctrl, counters_buf, use_native: bool) -> None:
    """Forked worker body.  Never returns (os._exit in the caller)."""
    _close_inherited_fds({0, 1, 2, ctrl.fileno()})
    _arm_pdeathsig()
    # drop the inherited asyncio state: the parent's loop object (and
    # its "currently running" thread-state marker) crossed the fork
    try:
        asyncio.events._set_running_loop(None)
        asyncio.set_event_loop(None)
    except Exception:
        pass
    ctrl.setblocking(False)
    try:
        asyncio.run(_child_serve(ctrl, counters_buf, use_native))
    except Exception:
        traceback.print_exc(file=sys.stderr)


# -- parent-side worker handle ------------------------------------------------


class ReactorProcessWorker:
    """Parent-side handle of one forked reactor worker: ctrl channel,
    counter block, delegation + listen fan-out, respawn and reap.

    Duck-types the ReactorWorker attributes the thread-mode code paths
    probe (``loop`` is always None here: a process worker has no loop
    the parent can hop to — frames cross the shm seam instead)."""

    loop = None

    def __init__(self, name: str, index: int, use_native: bool = True):
        self.name = name
        self.index = index
        self.use_native = use_native
        self.pid: Optional[int] = None
        self.ctrl: Optional[socket.socket] = None
        self.counters = None  # SharedMemory (parent create/close/unlink)
        self.respawns = 0
        # thread-worker dump compat (parent-side accounting only; the
        # real per-worker numbers live in the counter block)
        self.sockets = 0
        self.accepted = 0
        self.dialed = 0
        self.rx_msgs = 0
        self.tx_flushes = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.pid is not None and self.is_alive():
            return
        from multiprocessing import shared_memory

        if self.counters is None:
            self.counters = shared_memory.SharedMemory(
                create=True, size=COUNTER_SLOTS * 8)
        self.counters.buf[:COUNTER_SLOTS * 8] = b"\x00" * (COUNTER_SLOTS * 8)
        # resolve the native arm and checksum BEFORE forking: the child
        # must never pay (or race) a g++ build — per-process arm
        # resolution means each worker INHERITS a resolved arm
        if self.use_native:
            _wirepath.impl()
        parent_sock, child_sock = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_SEQPACKET)
        for s in (parent_sock, child_sock):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _CTRL_BUF)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _CTRL_BUF)
            except OSError:
                pass
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            try:
                parent_sock.close()
                _child_main(child_sock, self.counters.buf, self.use_native)
            finally:
                os._exit(0)
        child_sock.close()
        self.pid = pid
        self.ctrl = parent_sock
        self.ctrl.setblocking(False)

    def is_alive(self) -> bool:
        if self.pid is None:
            return False
        try:
            done, _status = os.waitpid(self.pid, os.WNOHANG)
        except ChildProcessError:
            return False
        if done == self.pid:
            self.pid = None
            return False
        return True

    def restart(self) -> None:
        """Respawn a dead worker in place (reaping the old pid)."""
        self.reap()
        if self.ctrl is not None:
            try:
                self.ctrl.close()
            except OSError:
                pass
            self.ctrl = None
        self.pid = None
        self.respawns += 1
        self.start()

    def reap(self, timeout: float = 0.0) -> bool:
        """waitpid the child (non-blocking by default); True when the
        pid is gone (reaped or never started)."""
        if self.pid is None:
            return True
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            try:
                done, _status = os.waitpid(self.pid, os.WNOHANG)
            except ChildProcessError:
                self.pid = None
                return True
            if done == self.pid:
                self.pid = None
                return True
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.01)

    def kill(self) -> None:
        if self.pid is not None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def shutdown(self) -> None:
        """Graceful stop + guaranteed reap (no zombies)."""
        if self.ctrl is not None:
            try:
                self.ctrl.settimeout(0.2)
                self.ctrl.send(b'{"op": "shutdown"}')
            except OSError:
                pass
            try:
                self.ctrl.close()
            except OSError:
                pass
            self.ctrl = None
        if not self.reap(timeout=0.5):
            self.kill()
            self.reap(timeout=2.0)
        if self.counters is not None:
            try:
                self.counters.close()
            except Exception:
                pass
            try:
                self.counters.unlink()
            except Exception:
                pass
            self.counters = None

    # -- control channel -----------------------------------------------------

    def _send_ctrl(self, obj: dict, fds: Optional[List[int]] = None) -> bool:
        if self.ctrl is None:
            return False
        data = json.dumps(obj).encode()
        try:
            self.ctrl.settimeout(2.0)
            if fds:
                socket.send_fds(self.ctrl, [data], fds)
            else:
                self.ctrl.send(data)
            return True
        except OSError:
            return False
        finally:
            try:
                self.ctrl.setblocking(False)
            except OSError:
                pass

    def delegate(self, conn_id: int, sock_fd: int, tx_name: str,
                 rx_name: str, tx_db_fd: int, rx_db_fd: int, cap: int,
                 crc_mode: str, leftover: bytes) -> bool:
        chunks = [leftover[i:i + _LEFTOVER_CHUNK]
                  for i in range(0, len(leftover), _LEFTOVER_CHUNK)]
        if not self._send_ctrl(
                {"op": "delegate", "conn": conn_id, "tx": tx_name,
                 "rx": rx_name, "cap": cap, "crc": crc_mode,
                 "nleft": len(chunks)},
                fds=[sock_fd, tx_db_fd, rx_db_fd]):
            return False
        for ch in chunks:
            if not self._send_ctrl(
                    {"op": "leftover", "conn": conn_id,
                     "data": base64.b64encode(ch).decode()}):
                self.send_close(conn_id)
                return False
        self.sockets += 1
        return True

    def send_close(self, conn_id: int) -> None:
        self._send_ctrl({"op": "close", "conn": conn_id})

    def listen(self, base_sock) -> bool:
        """Hand the worker a dup of the listening socket: inbound
        sockets shard over the workers' accept loops."""
        try:
            dup = base_sock.dup()
        except OSError:
            return False
        try:
            return self._send_ctrl({"op": "listen"}, fds=[dup.fileno()])
        finally:
            dup.close()

    # -- introspection -------------------------------------------------------

    def counters_dict(self) -> Dict[str, int]:
        if self.counters is None:
            return {}
        try:
            return read_counters(self.counters.buf)
        except (ValueError, struct.error):
            return {}

    def dump(self) -> Dict[str, Any]:
        out = {"id": self.index, "mode": "process", "pid": self.pid,
               "alive": self.is_alive(), "respawns": self.respawns,
               "delegated": self.sockets}
        out.update(self.counters_dict())
        return out


# -- parent-side delegated transport ------------------------------------------


class ShmConnEndpoint:
    """The parent half of a delegated connection: reader AND writer over
    the shm ring pair.  Duck-types the slice of the StreamWriter surface
    the Connection flusher/adopt/close paths touch (write / writelines /
    drain / close / wait_closed) and exposes the record reads
    Connection._read_frame_shm consumes.

    tx: ``writelines`` queues segment VIEWS; ``drain`` streams them into
    the tx ring (bounded — a full ring parks the flush window exactly
    like a full socket buffer) and only then resolves, so callers'
    buffers are free to mutate after drain, the CorkedWriter contract.

    Teardown returns the discipline the r13 leak fix demands, extended
    to the process plane: close() wakes BOTH parked directions (a drain
    parked on ring space, a read parked on the doorbell) with
    ConnectionResetError so throttle costs held by the serve loop's
    batch are returned through its normal finally path, and the worker
    is told to drop the socket (the peer must observe the death)."""

    def __init__(self, worker: ReactorProcessWorker, conn_id: int,
                 tx: ShmRingPipe, rx: ShmRingPipe, wp=None, perf=None):
        self.worker = worker
        self.conn_id = conn_id
        self.tx = tx
        self.rx = rx
        # parent-side native arm: drain() gathers the window into the
        # ring below the GIL (wirepy_gather), the tx half of the
        # crossing's single copy
        self._wp = wp
        self._perf = perf
        self.closed = False
        self._pending: List[memoryview] = []

    # -- writer surface ------------------------------------------------------

    def write(self, data) -> None:
        self.writelines([data])

    def writelines(self, segments) -> None:
        for s in segments:
            mv = s if isinstance(s, memoryview) else memoryview(s)
            if mv.ndim != 1 or mv.itemsize != 1:
                mv = mv.cast("B")
            if mv.nbytes:
                self._pending.append(mv)

    async def drain(self) -> None:
        if self.closed:
            raise ConnectionResetError("shm transport closed")
        segs, self._pending = self._pending, []
        if not segs:
            return
        if self._wp is not None:
            n = await self.tx.send_gather(self._wp, segs)
            if self._perf is not None:
                self._perf.inc("native_tx_calls")
                self._perf.inc("native_bytes", n)
        else:
            await self.tx.send_bytes(segs)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._pending = []
        # the worker must close the REAL socket: peers observe the
        # connection death (fault-injection parity), and a worker-side
        # fd may not outlive the session it carried
        self.worker.send_close(self.conn_id)
        self.tx.close()
        self.rx.close()

    async def wait_closed(self) -> None:
        return

    # -- reader surface (see Connection._read_frame_shm) ---------------------

    async def read_record_hdr(self):
        return await self.rx.read_record_hdr()

    async def read_exact(self, n: int) -> bytes:
        return await self.rx.read_exact(n)

    async def read_into(self, dest, n: int) -> None:
        # rx half of the crossing's single copy: ring views gather into
        # the caller's assembly buffer / install staging below the GIL
        # (the drain() mirror) — no parent-side per-byte pass remains
        await self.rx.read_into(dest, n, wp=self._wp)
        if self._wp is not None and self._perf is not None:
            self._perf.inc("native_rx_calls")
            self._perf.inc("native_bytes", n)

    def complete_record_len(self):
        return self.rx.complete_record_len()

    def dump(self) -> Dict[str, Any]:
        try:
            tx_fill, rx_fill = self.tx.fill(), self.rx.fill()
        except ConnectionResetError:
            tx_fill = rx_fill = -1  # rings torn down under the dump
        return {"worker": self.worker.index, "worker_pid": self.worker.pid,
                "conn_id": self.conn_id, "tx_ring_fill": tx_fill,
                "rx_ring_fill": rx_fill, "closed": self.closed}


def delegate_socket(worker: ReactorProcessWorker, conn_id: int,
                    sock_fd: int, leftover: bytes, cap: int,
                    crc_mode: str, wp=None,
                    perf=None) -> Optional[ShmConnEndpoint]:
    """Build the shm ring pair for one connection and hand the socket
    (plus any already-buffered rx bytes) to the worker.  Returns the
    parent endpoint, or None when the worker could not take it (caller
    keeps the in-process transport — graceful fallback, never an
    error)."""
    tx_pipe, tx_name, tx_db = ShmRingPipe.create(cap)
    try:
        rx_pipe, rx_name, rx_db = ShmRingPipe.create(cap)
    except OSError:
        # half-allocated: the tx segment must not outlive this failure
        # (close unlinks — the shm-lifecycle pairing)
        tx_pipe.close()
        tx_db.close()
        raise
    tx_pipe.as_role(producer=True)     # parent produces tx bytes
    rx_pipe.as_role(producer=False)    # parent consumes rx records
    ok = worker.delegate(conn_id, sock_fd, tx_name, rx_name,
                         tx_db.fileno(), rx_db.fileno(), cap, crc_mode,
                         leftover)
    # the child received dups of the doorbell fds via SCM_RIGHTS (or
    # never will): the parent's copies of the CHILD ends close either way
    tx_db.close()
    rx_db.close()
    if not ok:
        tx_pipe.close()
        rx_pipe.close()
        return None
    return ShmConnEndpoint(worker, conn_id, tx_pipe, rx_pipe,
                           wp=wp, perf=perf)
