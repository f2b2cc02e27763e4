# Copy of ceph_tpu/rados/reactor.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Sharded multi-reactor wire plane: reactor worker pool + colocated ring.

Role-equivalent of the reference's AsyncMessenger worker pool (reference
src/msg/async/AsyncMessenger.{h,cc}, Stack.h): a Messenger owns N reactor
workers (``ms_async_op_threads``), each a thread running its OWN event
loop and owning a SHARD of the sockets — connections are bound to a
worker by a stable hash of (peer addr, lane), the way
``AsyncMessenger::get_connection`` binds a ``Worker`` for a peer, so a
connection's socket work (framing, crc, sendmsg/recv, flush windows)
never migrates between reactors and needs no cross-thread locking of its
own state.  The daemon keeps its single home loop: dispatch hops back to
it (``run_coroutine_threadsafe``), so daemon state stays single-loop
while the wire bytes move in parallel — crc32c, memcpy and the socket
syscalls all release the GIL, which is where the parallel win lives in
this Python reproduction.

This module also carries the COLOCATED transport: daemons sharing one
host process (the vstart/test topology, the bench loopback arm)
negotiate, at connect time, an in-process ring instead of a TCP session
(``ms_colocated_ring``; the handshake hello carries a per-process token
— matching tokens on both ends mean the "wire" would be a kernel
loopback round-trip for bytes that never leave the process).  A
:class:`RingPipe` hands typed messages over by reference —
``BufferList``/memoryview blob fields stay views, nothing is framed,
crc'd or serialized — with the same delivery contract as the messenger's
local fastpath: per-connection order, exactly-once, messages immutable
once sent, control-plane payloads isolated by deep copy.  Negotiation
failure (token mismatch, knob off on either end, registry race) falls
back to the TCP session transparently; the caller cannot tell except by
the ``ring_msgs`` counter.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import random
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

# Per-process identity token: two messengers whose handshakes carry the
# same token ARE the same process, so an in-process ring is reachable.
# Random (not pid): pid alone would false-positive across containers or
# a recycled pid on the far end of a real wire.
PROC_TOKEN = random.randbytes(16).hex()


# -- reactor workers ---------------------------------------------------------


class ReactorWorker(threading.Thread):
    """One reactor: a thread running its own asyncio loop, owning a shard
    of sockets (the reference's msg/async Worker: private epoll, private
    event center).  Work enters via :meth:`spawn` (fire-and-forget task
    on this loop) or :meth:`run` (awaitable from another loop)."""

    def __init__(self, name: str, index: int):
        super().__init__(name=f"{name}-reactor-{index}", daemon=True)
        self.index = index
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        # shard accounting for dump_reactors / the bench's reactor
        # balance: plain ints under the GIL, written only from this
        # worker's own loop (sockets) or its owner (assignments)
        self.sockets = 0        # live connections owned by this shard
        self.accepted = 0       # inbound sockets this shard accepted
        self.dialed = 0         # outbound sockets dialed on this shard
        self.rx_msgs = 0        # messages decoded on this shard
        self.tx_flushes = 0     # flush windows written on this shard

    def run(self) -> None:  # thread body
        asyncio.set_event_loop(self.loop)
        self._started.set()
        try:
            self.loop.run_forever()
        finally:
            try:
                pending = asyncio.all_tasks(self.loop)
                for t in pending:
                    t.cancel()
                if pending:
                    self.loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True))
            except Exception:
                pass
            self.loop.close()

    def ensure_started(self) -> None:
        if not self.is_alive():
            self.start()
        self._started.wait(timeout=5.0)

    async def submit(self, coro) -> Any:
        """Run ``coro`` on this worker's loop, awaited from the caller's
        loop (no-op hop when the caller already runs here)."""
        if asyncio.get_running_loop() is self.loop:
            return await coro
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return await asyncio.wrap_future(fut)

    def spawn(self, coro) -> None:
        """Fire-and-forget a task on this worker's loop (thread-safe)."""
        if not self.loop.is_closed():
            self.loop.call_soon_threadsafe(
                lambda: self.loop.create_task(coro))

    def stop(self) -> None:
        if self._started.is_set() and not self.loop.is_closed():
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.join(timeout=2.0)

    def dump(self) -> Dict[str, Any]:
        return {"id": self.index, "alive": self.is_alive(),
                "sockets": self.sockets, "accepted": self.accepted,
                "dialed": self.dialed, "rx_msgs": self.rx_msgs,
                "tx_flushes": self.tx_flushes}


class ReactorPool:
    """The messenger's worker pool (AsyncMessenger ``workers`` +
    ``get_worker`` role).  ``worker_for(addr, lane)`` is the STABLE HASH
    binding: the same (peer, lane) always lands on the same worker, so a
    lane's revival redials on the loop (thread mode) or re-delegates to
    the shard slot (process mode) that owns its session state.

    ``mode`` selects the execution substrate (``ms_reactor_mode``):

    - ``thread`` (default): N ReactorWorker threads, each its own event
      loop owning a socket shard — the r13 plane;
    - ``process``: N forked reactor worker PROCESSES
      (reactor_proc.ReactorProcessWorker), each owning its socket shard
      outright with its own interpreter and its own copy of the native
      wirepath; frames cross via shared-memory rings (shm_ring.py) into
      the daemon's single home-loop dispatch pump.  A dead worker slot
      respawns on demand (ensure_worker) and every fork is reaped."""

    def __init__(self, name: str, n_workers: int, mode: str = "thread",
                 use_native: bool = True):
        self.name = name
        self.mode = mode if mode in ("thread", "process") else "thread"
        self.n_workers = max(1, int(n_workers))
        if self.mode == "process":
            from ceph_tpu_torch.rados.reactor_proc import ReactorProcessWorker

            self.workers: List[Any] = [
                ReactorProcessWorker(name, i, use_native=use_native)
                for i in range(self.n_workers)]
        else:
            self.workers = [
                ReactorWorker(name, i) for i in range(self.n_workers)]
        self._servers: List[Tuple[ReactorWorker, Any]] = []
        self._started = False
        # the owning daemon's Log (debug_ms douts); attached by the
        # messenger when the daemon wires its Context in
        self.log = None
        # process-mode accept fan-out state: the listening socket the
        # workers hold dups of, the parent-side accepted-fd callback,
        # and the home loop the ctrl readers are registered on
        self._listen_sock = None
        self._on_fd = None
        self._ctrl_loop = None

    def dout(self, level: int, message: str) -> None:
        log = self.log
        if log is not None:
            log.dout("ms", level, message)

    def start(self) -> None:
        if not self._started:
            self._started = True
            for w in self.workers:
                if self.mode == "process":
                    w.start()
                else:
                    w.ensure_started()
            self.dout(1, f"reactor pool {self.name}: {self.n_workers} "
                         f"{self.mode} workers started"
                      + (f" (pids {[w.pid for w in self.workers]})"
                         if self.mode == "process" else ""))

    def worker_for(self, addr: Tuple[str, int], lane: int = 0):
        key = f"{addr[0]}:{addr[1]}:{lane}".encode()
        h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                           "little")
        return self.workers[h % self.n_workers]

    # -- process mode --------------------------------------------------------

    def ensure_worker(self, worker) -> bool:
        """Process mode: make sure the slot has a live child, respawning
        (and reaping the old pid) after a worker death — the shard slot
        identity survives, the way a revived lane keeps its session."""
        if self.mode != "process":
            return True
        self.start()
        if worker.is_alive():
            return True
        self.dout(1, f"reactor pool {self.name}: worker {worker.index} "
                     f"died; respawning shard slot")
        try:
            worker.restart()
        except OSError:
            return False
        if self._listen_sock is not None:
            worker.listen(self._listen_sock)
        self._register_ctrl_reader(worker)
        return worker.is_alive()

    def serve_shards_process(self, base_sock, on_fd: Callable) -> None:
        """Process-mode inbound sharding: every worker gets a dup of the
        listening socket and accepts on it; accepted fds forward to the
        parent (``on_fd``) whose home loop runs the handshake — the
        parent owns auth/session state, the workers own the byte work
        once the connection is delegated."""
        import asyncio as _asyncio

        self.start()
        self._listen_sock = base_sock
        self._on_fd = on_fd
        self._ctrl_loop = _asyncio.get_event_loop()
        for w in self.workers:
            w.listen(base_sock)
            self._register_ctrl_reader(w)

    def _register_ctrl_reader(self, worker) -> None:
        """Watch the worker's ctrl socket for forwarded accepted fds."""
        loop = self._ctrl_loop
        if loop is None or worker.ctrl is None or loop.is_closed():
            return
        import socket as _socket

        ctrl = worker.ctrl
        fd = ctrl.fileno()

        def _on_readable(w=worker, c=ctrl, fdnum=fd):
            while True:
                try:
                    msg, fds, _fl, _ad = _socket.recv_fds(c, 65536, 8)
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    msg, fds = b"", []
                if not msg:
                    try:
                        loop.remove_reader(fdnum)
                    except (OSError, ValueError):
                        pass
                    return
                if b"accepted" in msg and fds and self._on_fd is not None:
                    w.accepted += 1
                    self._on_fd(fds[0], w)
                    for extra in fds[1:]:
                        import os as _os

                        _os.close(extra)
                else:
                    import os as _os

                    for f in fds:
                        _os.close(f)

        try:
            loop.add_reader(fd, _on_readable)
        except (OSError, ValueError):
            pass

    def counters_sum(self) -> Dict[str, int]:
        """Aggregate the per-process counter blocks (perf-dump seam)."""
        agg: Dict[str, int] = {}
        if self.mode != "process":
            return agg
        for w in self.workers:
            for k, v in w.counters_dict().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    async def serve_shards(self, base_sock, accept_cb: Callable) -> None:
        """Register the listening socket with EVERY worker loop (dup'd
        fd per worker): whichever reactor's selector wins the accept
        race owns the new socket — inbound sockets shard across workers
        without a handoff (the reference's per-worker Processor).
        Thread mode only; process mode shards accepts through
        :meth:`serve_shards_process`."""
        self.start()
        for w in self.workers:
            dup = base_sock.dup()
            dup.setblocking(False)

            async def _serve(sock=dup, worker=w):
                def _cb(reader, writer, _w=worker):
                    _w.accepted += 1
                    return accept_cb(reader, writer)
                return await asyncio.start_server(_cb, sock=sock)

            server = await w.submit(_serve())
            self._servers.append((w, server))

    def shutdown(self) -> None:
        for w, server in self._servers:
            try:
                w.loop.call_soon_threadsafe(server.close)
            except Exception:
                pass
        self._servers.clear()
        if self.mode == "process":
            loop = self._ctrl_loop
            for w in self.workers:
                if loop is not None and w.ctrl is not None \
                        and not loop.is_closed():
                    try:
                        loop.remove_reader(w.ctrl.fileno())
                    except (OSError, ValueError):
                        pass
                # graceful stop + guaranteed reap: daemon shutdown must
                # leave no zombies (worker.shutdown SIGKILLs stragglers
                # and waitpids them)
                w.shutdown()
            self._listen_sock = None
            self._on_fd = None
            return
        for w in self.workers:
            w.stop()

    def dump(self) -> List[Dict[str, Any]]:
        return [w.dump() for w in self.workers]


# -- colocated in-process ring transport -------------------------------------

# ring id -> (initiator_rx pipe, acceptor_rx pipe) awaiting attachment.
# Registered by the ACCEPTOR during the handshake fin, claimed by the
# initiator immediately after (same process by construction).
_RING_REGISTRY: Dict[str, Tuple["RingPipe", "RingPipe"]] = {}
_RING_LOCK = threading.Lock()


class RingPipe:
    """One direction of a colocated ring: a bounded in-process slot ring
    handing message objects (and their BufferList/memoryview blob views)
    across by reference.  Loop-agnostic and thread-safe — the two ends
    may live on different event loops (daemon home loops, reactor
    workers), so waiters are woken through their OWN loop's
    ``call_soon_threadsafe``."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._getters: List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []
        self._putters: List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []
        self.closed = False

    @staticmethod
    def _wake(waiters: List) -> None:
        while waiters:
            loop, fut = waiters.pop(0)

            def _set(f=fut):
                if not f.done():
                    f.set_result(None)

            try:
                if loop is asyncio.get_event_loop_policy().get_event_loop() \
                        and loop.is_running():
                    _set()
                else:
                    loop.call_soon_threadsafe(_set)
            except Exception:
                try:
                    loop.call_soon_threadsafe(_set)
                except Exception:
                    pass

    async def put(self, item: Any) -> None:
        """Append one message; parks when the ring is full (the bounded
        backpressure a full socket buffer gives the TCP path)."""
        while True:
            with self._lock:
                if self.closed:
                    raise ConnectionResetError("ring closed")
                if len(self._dq) < self.capacity:
                    self._dq.append(item)
                    getters, self._getters = self._getters, []
                else:
                    getters = None
                    loop = asyncio.get_running_loop()
                    fut: asyncio.Future = loop.create_future()
                    self._putters.append((loop, fut))
            if getters is not None:
                self._wake(getters)
                return
            await fut

    async def get(self) -> Any:
        while True:
            with self._lock:
                if self._dq:
                    item = self._dq.popleft()
                    putters, self._putters = self._putters, []
                else:
                    if self.closed:
                        raise ConnectionResetError("ring closed")
                    putters = None
                    loop = asyncio.get_running_loop()
                    fut: asyncio.Future = loop.create_future()
                    self._getters.append((loop, fut))
            if putters is not None:
                self._wake(putters)
                return item
            await fut

    def close(self) -> None:
        with self._lock:
            self.closed = True
            waiters = self._getters + self._putters
            self._getters, self._putters = [], []
        self._wake(waiters)

    def depth(self) -> int:
        return len(self._dq)


def ring_offer(capacity: int = 1024) -> Tuple[str, "RingPipe", "RingPipe"]:
    """Acceptor side: allocate a ring pair, register it, return
    (ring_id, my_rx, my_tx)."""
    ring_id = random.randbytes(8).hex()
    i_rx = RingPipe(capacity)   # acceptor tx -> initiator rx
    a_rx = RingPipe(capacity)   # initiator tx -> acceptor rx
    with _RING_LOCK:
        _RING_REGISTRY[ring_id] = (i_rx, a_rx)
    return ring_id, a_rx, i_rx


def ring_claim(ring_id: str) -> Optional[Tuple["RingPipe", "RingPipe"]]:
    """Initiator side: claim the offered ring -> (my_rx, my_tx), or None
    when the offer is gone (negotiation falls back to TCP)."""
    with _RING_LOCK:
        pair = _RING_REGISTRY.pop(ring_id, None)
    if pair is None:
        return None
    i_rx, a_rx = pair
    return i_rx, a_rx


def ring_abandon(ring_id: str) -> None:
    with _RING_LOCK:
        pair = _RING_REGISTRY.pop(ring_id, None)
    if pair is not None:
        for p in pair:
            p.close()


class RingConnection:
    """A colocated session over a RingPipe pair: the Connection surface
    (send/close/peer/auth metadata) with ZERO serialization — negotiated
    at connect time by :class:`Messenger`, transparently replacing the
    TCP transport when both ends share the process.  Delivery contract
    matches the local fastpath: per-connection order (one pump task on
    the owning messenger's home loop), exactly-once, dispatcher
    isolation, messages immutable once sent; control-plane payloads are
    pickled round-trip so a live mon object graph is never shared."""

    is_ring = True

    def __init__(self, messenger, peer: Tuple[str, int], peer_name: str,
                 rx: RingPipe, tx: RingPipe, outbound: bool,
                 auth_kind: str = "ring", auth_entity_type: str = ""):
        self.messenger = messenger
        self.peer = tuple(peer)
        self.peer_name = peer_name
        self.rx = rx
        self.tx = tx
        self.outbound = outbound
        self.auth_kind = auth_kind
        self.auth_entity_type = auth_entity_type
        self.closed = False
        from ceph_tpu_torch.rados.messenger import Policy

        self.policy = Policy.lossless_peer()
        self._pump_task: Optional[asyncio.Task] = None

    def start_pump(self) -> None:
        """Serve inbound ring messages on the owning messenger's loop."""
        loop = self.messenger.home_loop or asyncio.get_running_loop()
        if loop is asyncio.get_running_loop():
            self._pump_task = loop.create_task(self._pump())
            self.messenger._tasks.add(self._pump_task)
            self._pump_task.add_done_callback(
                self.messenger._tasks.discard)
        else:  # messenger homed on another loop (reactor-side accept)
            loop.call_soon_threadsafe(self.start_pump)

    async def send(self, msg: Any) -> None:
        if self.closed:
            raise ConnectionResetError("ring connection closed")
        from ceph_tpu_torch.rados import messenger as m

        cls = type(msg)
        fields = getattr(cls, "FIXED_FIELDS", None)
        when = getattr(cls, "FIXED_WHEN", None)
        if fields is None or (when is not None and not when(msg)):
            # control-plane payload: isolate the receiver's object graph
            # exactly as the pickled wire would (LocalConnection rule)
            import pickle

            msg = pickle.loads(pickle.dumps(msg, protocol=5))
        try:
            await self.tx.put(msg)
        except ConnectionResetError:
            self.closed = True
            raise
        self.messenger.perf.inc("ring_msgs")
        self.messenger.perf.inc("tx_msgs")
        p = self.messenger.perf
        name = type(msg).__name__
        p.ensure(f"tx_{name}", desc=f"{name} messages sent")
        p.inc(f"tx_{name}")

    async def _pump(self) -> None:
        while not self.closed and not self.messenger._shutdown:
            try:
                msg = await self.rx.get()
            except ConnectionResetError:
                break
            self.messenger.perf.inc("rx_msgs")
            disp = self.messenger.dispatcher
            if disp is None and self.messenger.group_dispatcher is not None:
                try:
                    await self.messenger.group_dispatcher(self, [msg])
                except (asyncio.CancelledError, GeneratorExit):
                    raise
                except Exception:
                    traceback.print_exc()
                continue
            if disp is None:
                continue
            try:
                await disp(self, msg)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                traceback.print_exc()
        self.closed = True

    async def close(self, gen: int = 0) -> None:
        self.closed = True
        self.tx.close()
        self.rx.close()
        if self._pump_task is not None:
            self._pump_task.cancel()

    def dump(self) -> Dict[str, Any]:
        return {"peer": list(self.peer), "peer_name": self.peer_name,
                "rx_depth": self.rx.depth(), "tx_depth": self.tx.depth(),
                "closed": self.closed}
