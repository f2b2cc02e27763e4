# Copy of ceph_tpu/common/lockdep.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Lock-order cycle detection (reference src/common/lockdep.cc).

The reference's debug mutexes register every (held -> acquiring) lock
pair in a global order graph and assert when an acquisition would close
a cycle — catching ABBA deadlocks the first time the ORDER is violated,
not the (possibly never-reproduced) time the threads actually interleave
into the deadlock.  This is that machinery for a codebase that mixes
real threads (BatchingQueue worker, native calls) with asyncio tasks
(daemons): both lock flavors funnel into one order graph, keyed by the
execution context (thread id for threads, task id for tasks).

Engagement mirrors the reference's debug-build gating: OFF unless
``CEPH_TPU_LOCKDEP=1`` (or ``enable()`` is called), because the graph
bookkeeping costs a dict walk per acquisition.  ``make_mutex(name)`` /
``make_async_mutex(name)`` return plain primitives when disabled, so
production hot paths pay nothing.

A violation raises ``LockOrderError`` naming the cycle — tests assert on
it; daemons run with it disabled unless debugging.
"""

from __future__ import annotations

import asyncio
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

_ENABLED = os.environ.get("CEPH_TPU_LOCKDEP") == "1"

# order graph: edge (a, b) means "a was held while acquiring b"; a cycle
# through the graph is a potential deadlock.  Guarded by _GRAPH_LOCK (a
# plain lock — it is never held while taking a tracked lock).
_EDGES: Dict[str, Set[str]] = {}
_GRAPH_LOCK = threading.Lock()

# held stack per execution context
_HELD: Dict[Tuple[str, int], List[str]] = {}
_HELD_LOCK = threading.Lock()


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the global lock order."""


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Clear the order graph (tests)."""
    with _GRAPH_LOCK:
        _EDGES.clear()
    with _HELD_LOCK:
        _HELD.clear()


def _ctx_key() -> Tuple[str, int]:
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    if task is not None:
        return ("task", id(task))
    return ("thread", threading.get_ident())


def _find_path(frm: str, to: str) -> Optional[List[str]]:
    """DFS: an existing path frm -> to means adding edge to -> frm would
    close a cycle."""
    stack, seen = [(frm, [frm])], {frm}
    while stack:
        node, path = stack.pop()
        if node == to:
            return path
        for nxt in _EDGES.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def will_lock(name: str) -> None:
    """Record intent to acquire `name`; raises LockOrderError when the
    acquisition inverts an established order (the lockdep check)."""
    key = _ctx_key()
    with _HELD_LOCK:
        held = list(_HELD.get(key, ()))
    if not held:
        return
    with _GRAPH_LOCK:
        for h in held:
            if h == name:
                continue  # recursive acquisition: not an order edge
            # adding h -> name: would name -> ... -> h already exist?
            path = _find_path(name, h)
            if path is not None:
                raise LockOrderError(
                    f"lock order violation: acquiring {name!r} while "
                    f"holding {h!r}, but the established order is "
                    f"{' -> '.join(path)} -> {name!r} (cycle)")
            _EDGES.setdefault(h, set()).add(name)


def locked(name: str) -> None:
    key = _ctx_key()
    with _HELD_LOCK:
        _HELD.setdefault(key, []).append(name)


def unlocked(name: str) -> None:
    key = _ctx_key()
    with _HELD_LOCK:
        held = _HELD.get(key)
        if held and name in held:
            held.reverse()
            held.remove(name)  # innermost matching acquisition
            held.reverse()
            if not held:
                _HELD.pop(key, None)


class DebugLock:
    """threading.Lock with lockdep tracking (ceph::mutex_debug role)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        will_lock(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            locked(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        unlocked(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()


class DebugAsyncLock:
    """asyncio.Lock with lockdep tracking: the same order graph catches
    an asyncio task locking A-then-B against a worker thread locking
    B-then-A — the cross-runtime inversions a thread-only lockdep never
    sees."""

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()

    async def acquire(self) -> bool:
        will_lock(self.name)
        await self._lock.acquire()
        locked(self.name)
        return True

    def release(self) -> None:
        self._lock.release()
        unlocked(self.name)

    async def __aenter__(self):
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()


def make_mutex(name: str):
    """A threading lock: debug-tracked when lockdep is enabled, plain
    otherwise (zero hot-path cost in production)."""
    return DebugLock(name) if _ENABLED else threading.Lock()


def make_async_mutex(name: str):
    return DebugAsyncLock(name) if _ENABLED else asyncio.Lock()
