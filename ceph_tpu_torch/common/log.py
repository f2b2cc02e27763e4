# Copy of ceph_tpu/common/log.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Leveled, per-subsystem logging with an in-memory crash ring.

Role-equivalent of the reference's dout/dendl + src/log/Log.cc: each log
call carries a subsystem and level; the gather level (``debug_<subsys>``
config options) decides whether it is emitted to the sink, but recent
entries are ALWAYS kept in a bounded in-memory ring so a crash dump
(``dump_recent``) shows high-verbosity history even when the on-disk level
was low — the reference's signature debugging affordance.  Writes to the
sink happen on a background thread (async Log thread) so the hot path only
appends to a deque.

Per-subsystem levels are CACHED (the reference's SubsystemMap): the hot
path pays one dict lookup, not a layered-config resolution per ``dout``
call.  ``invalidate_levels()`` drops the cache; the Context wires it to a
``debug_*`` config observer so runtime ``config set debug_ms 10`` (asok or
``ceph tell``) takes effect immediately.  ``wants(subsys, level)`` is the
call-site guard hot paths use so a disabled high-verbosity dout costs a
cached compare, not a ring append.

Error entries are additionally PINNED in a separate bounded ring (the
reference's m_recent vs gather split): ``dump_recent`` shows them even
when the main ring wrapped between the error and the crash.
"""

from __future__ import annotations

import collections
import queue
import sys
import threading
import time
import traceback
from typing import Deque, Dict, List, Optional, TextIO, Tuple

Entry = Tuple[float, str, int, str]  # (stamp, subsys, level, message)


class Log:
    def __init__(self, conf=None, sink: Optional[TextIO] = None, name: str = ""):
        self.conf = conf
        self.name = name
        self.sink = sink if sink is not None else sys.stderr
        max_recent = 500
        if conf is not None:
            try:
                max_recent = int(conf.get("log_max_recent", 500))
            except Exception:
                pass
        self._recent: Deque[Entry] = collections.deque(maxlen=max_recent)
        # errors pinned separately: a wrapped ring cannot lose them
        self._recent_errors: Deque[Entry] = collections.deque(
            maxlen=max(32, max_recent // 8))
        self._queue: "queue.Queue[Optional[Entry]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # subsys -> gather level; rebuilt lazily after invalidate_levels()
        self._levels: Dict[str, int] = {}

    # -- levels --------------------------------------------------------------

    def gather_level(self, subsys: str) -> int:
        """Cached per-subsystem emit level (debug_<subsys>); one dict
        lookup on the hot path instead of a config resolution."""
        level = self._levels.get(subsys)
        if level is None:
            level = self._resolve_level(subsys)
            self._levels[subsys] = level
        return level

    def _resolve_level(self, subsys: str) -> int:
        if self.conf is None:
            return 1
        try:
            return int(self.conf.get(f"debug_{subsys}", 1))
        except Exception:
            return 1

    def invalidate_levels(self) -> None:
        """Drop the level cache (a debug_* option changed at runtime)."""
        self._levels = {}

    def wants(self, subsys: str, level: int) -> bool:
        """Call-site guard for hot-path douts: would this entry emit?
        Guarded douts skip the ring too — turning the level up is what
        starts capturing them (the runtime-diagnostic workflow)."""
        return level <= self.gather_level(subsys)

    # -- hot path ------------------------------------------------------------

    def dout(self, subsys: str, level: int, message: str) -> None:
        entry = (time.time(), subsys, level, message)
        with self._lock:
            self._recent.append(entry)
            if level < 0:
                self._recent_errors.append(entry)
        if level <= self.gather_level(subsys):
            self._emit(entry)

    def error(self, subsys: str, message: str) -> None:
        self.dout(subsys, -1, message)

    def _emit(self, entry: Entry) -> None:
        if self._thread is not None:
            self._queue.put(entry)
        else:
            self._write(entry)

    def _write(self, entry: Entry) -> None:
        stamp, subsys, level, message = entry
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(stamp))
        frac = f"{stamp % 1:.6f}"[1:]
        try:
            self.sink.write(f"{ts}{frac} {self.name} {level:2d} {subsys}: {message}\n")
        except ValueError:
            pass  # sink closed at interpreter teardown

    # -- async writer --------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"log-{self.name}")
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=2)
            self._thread = None

    def flush(self) -> None:
        """Drain pending async writes (asok `log flush` equivalent)."""
        if self._thread is not None:
            self._queue.join()

    def _run(self) -> None:
        while True:
            entry = self._queue.get()
            try:
                if entry is None:
                    return
                self._write(entry)
            finally:
                self._queue.task_done()

    # -- crash ring ----------------------------------------------------------

    def dump_recent(self, out: Optional[TextIO] = None) -> List[Entry]:
        """Dump the full ring at max verbosity (crash handler path),
        merged with the pinned error entries the ring may have wrapped
        past (same-object dedupe, stamp order)."""
        with self._lock:
            entries = list(self._recent)
            pinned = list(self._recent_errors)
        ring_ids = {id(e) for e in entries}
        extra = [e for e in pinned if id(e) not in ring_ids]
        if extra:
            entries = sorted(entries + extra, key=lambda e: e[0])
        if out is not None:
            out.write(f"--- begin dump of recent events ({self.name}) ---\n")
            for e in entries:
                stamp, subsys, level, message = e
                out.write(f"{stamp:.6f} {level:3d} {subsys}: {message}\n")
            out.write("--- end dump of recent events ---\n")
        return entries

    def dump_on_exception(self, exc: BaseException) -> List[Entry]:
        self.sink.write("".join(traceback.format_exception(exc)))
        return self.dump_recent(self.sink)
