# Copy of ceph_tpu/rados/peering.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Per-PG peering statechart + recovery reservations.

The reference drives every PG through an explicit boost::statechart machine
(src/osd/PeeringState.cc): a map change opens a new *interval*, the primary
runs GetInfo -> GetLog -> GetMissing against the acting set, activates, and
recovery/backfill proceed under reservation throttles
(doc/dev/osd_internals/backfill_reservation.rst) so a failed OSD does not
stampede the cluster.  This module is the asyncio equivalent:

- ``PGMachine`` records one PG's state, interval, peer infos and per-peer
  missing sets.  Transitions are validated against an allowed-edge table
  and the history ring is dumpable through the admin socket.
- ``ReservationSlots`` is the reservation throttle: a counted pool of
  local/remote slots with FIFO-within-priority queueing.  The primary
  takes a LOCAL slot before recovering and a REMOTE slot on every
  backfill target before bulk pushes (reference RequestBackfill ->
  WaitLocalBackfillReserved -> WaitRemoteBackfillReserved flow).

The OSD owns the IO (RPCs, pushes); the machine owns the bookkeeping.
Events, not timers, drive recovery: ``Osd._on_map`` kicks the machine for
every PG whose mapping changed (reference AdvMap/ActMap events).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Set, Tuple

# statechart states (reference PeeringState.h state names)
INITIAL = "Initial"
GET_INFO = "GetInfo"
GET_LOG = "GetLog"
GET_MISSING = "GetMissing"
ACTIVE = "Active"
WAIT_LOCAL_RESERVE = "WaitLocalBackfillReserved"
WAIT_REMOTE_RESERVE = "WaitRemoteBackfillReserved"
RECOVERING = "Recovering"
BACKFILLING = "Backfilling"
CLEAN = "Clean"

# legal transitions; anything else is a programming error we want loud
_EDGES: Dict[str, Set[str]] = {
    INITIAL: {GET_INFO},
    GET_INFO: {GET_LOG, GET_INFO},
    GET_LOG: {GET_MISSING},
    GET_MISSING: {ACTIVE},
    ACTIVE: {RECOVERING, WAIT_LOCAL_RESERVE, CLEAN},
    WAIT_LOCAL_RESERVE: {WAIT_REMOTE_RESERVE, ACTIVE},
    WAIT_REMOTE_RESERVE: {BACKFILLING, ACTIVE},
    RECOVERING: {ACTIVE, WAIT_LOCAL_RESERVE, CLEAN},
    BACKFILLING: {ACTIVE, CLEAN},
    CLEAN: set(),
}
# a new interval resets any state back to GetInfo
_ALWAYS = {GET_INFO, INITIAL}


class PGMachine:
    """State + bookkeeping for one PG on its primary.

    The machine never does IO; the OSD's ``_run_peering`` walks it through
    the states and stores what each round learned:

    - ``peer_info``: osd -> last_update eversion (GetInfo round)
    - ``missing``:   osd -> {oid: LogEntry} the peer lacks (GetMissing)
    - ``backfill_targets``: up-set positions needing a full copy sweep
      because the log window cannot bridge them
    """

    HISTORY = 32

    def __init__(self, pool_id: int, pg: int):
        self.pool_id = pool_id
        self.pg = pg
        self.state = INITIAL
        # one statechart walk at a time: the event-driven peering task and
        # an admin repair_pool call must not interleave transitions
        self.lock = asyncio.Lock()
        self.interval_epoch = 0  # epoch that opened the current interval
        self.acting: List[int] = []
        self.peer_info: Dict[int, Tuple[int, int]] = {}
        self.missing: Dict[int, Dict[str, object]] = {}
        self.backfill_targets: List[int] = []
        self.history: List[Tuple[float, str, int]] = []  # (ts, state, epoch)
        self.task: Optional[asyncio.Task] = None
        # last backfill attempt was refused a reservation slot (the retry
        # loop polls quickly instead of backing off)
        self.reserve_blocked = False
        # a BACKFILLFULL target refused the reservation (reference
        # backfill_toofull PG state): surfaced in health detail; the
        # retry loop parks on the slower toofull cadence until the
        # target frees space
        self.backfill_toofull = False

    def transition(self, state: str) -> None:
        if state not in _EDGES.get(self.state, set()) and state not in _ALWAYS:
            raise RuntimeError(
                f"pg {self.pool_id}.{self.pg}: illegal transition "
                f"{self.state} -> {state}")
        self.state = state
        self.history.append((time.time(), state, self.interval_epoch))
        del self.history[:-self.HISTORY]

    def new_interval(self, epoch: int, acting: List[int]) -> bool:
        """A map change altered this PG's acting set: reset peering state
        (reference AdvMap -> Reset).  Returns True when the interval really
        advanced (re-delivery of the current interval is ignored).

        The machine's own acting memory must NOT veto the reset when the
        epoch advanced: kicks are issued by a caller that OBSERVED an
        acting change between its old and new map, and a primary that
        skipped intervals (batched map catch-up while it was not the
        primary) can see acting "unchanged" while the world moved
        A -> B -> A underneath it — e.g. an out OSD re-promoted by a
        pg_temp override naming its old interval.  Trusting the stale
        memory there swallows the kick and strands the PG's backfill."""
        if epoch <= self.interval_epoch and acting == self.acting:
            return False
        self.interval_epoch = epoch
        self.acting = list(acting)
        self.peer_info.clear()
        self.missing.clear()
        self.backfill_targets = []
        self.backfill_toofull = False  # stale verdict: new interval
        self.transition(GET_INFO)
        return True

    def is_stale(self, epoch: int) -> bool:
        """True when a newer interval superseded the one a running peering
        round started in — the round must abort (its plan is for a dead
        world)."""
        return epoch != self.interval_epoch

    def dump(self) -> Dict[str, object]:
        return {
            "pg": f"{self.pool_id}.{self.pg}",
            "state": self.state,
            "interval_epoch": self.interval_epoch,
            "acting": self.acting,
            "peers": {str(k): list(v) if isinstance(v, tuple) else v
                      for k, v in self.peer_info.items()},
            "missing_counts": {str(k): len(v) for k, v in self.missing.items()},
            "backfill_targets": self.backfill_targets,
            "backfill_toofull": self.backfill_toofull,
            "history": [
                {"at": ts, "state": s, "epoch": e} for ts, s, e in self.history
            ],
        }


class ReservationSlots:
    """Counted reservation pool with FIFO-within-priority queueing — the
    reference's AsyncReserver<pg_t> (common/AsyncReserver.h) backing both
    local_reserver and remote_reserver on every OSD.  ``osd_max_backfills``
    bounds how many PGs may recover/backfill concurrently with this OSD as
    a participant."""

    def __init__(self, slots: int):
        self.slots = max(1, int(slots))
        # key -> grant metadata (grantee osd id or None, monotonic grant
        # time).  Remote grants carry who they were granted TO so stale
        # holds can be revoked when that primary dies or loses the PG
        # (the reference cancels remote reservations on interval change).
        self.held: Dict[Tuple[int, int], Tuple[Optional[int], float]] = {}
        self._waiters: List[Tuple[int, int, Tuple[int, int], asyncio.Future]] = []
        self._seq = 0

    def try_acquire(self, key: Tuple[int, int],
                    grantee: Optional[int] = None) -> bool:
        """Non-blocking grant (remote reservation RPC path): the requester
        retries later on rejection rather than holding a wire slot open.
        Re-acquiring a held key refreshes its grant time (lease renewal)."""
        if key in self.held:
            self.held[key] = (grantee, time.monotonic())
            return True
        if len(self.held) < self.slots:
            self.held[key] = (grantee, time.monotonic())
            return True
        return False

    def revoke_stale(self, keep) -> int:
        """Drop held grants a predicate no longer endorses; returns the
        number revoked and wakes queued waiters for the freed slots.
        ``keep(key, grantee, granted_at)`` -> bool."""
        stale = [k for k, (g, t) in self.held.items() if not keep(k, g, t)]
        for k in stale:
            self.release(k)
        return len(stale)

    async def acquire(self, key: Tuple[int, int], priority: int = 0,
                      timeout: Optional[float] = None) -> bool:
        """Blocking grant (local reservation path).  Higher priority wins;
        FIFO within a priority level."""
        if self.try_acquire(key):
            return True
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._seq += 1
        self._waiters.append((-priority, self._seq, key, fut))
        self._waiters.sort(key=lambda w: (w[0], w[1]))
        try:
            await asyncio.wait_for(asyncio.shield(fut), timeout)
            return True
        except asyncio.TimeoutError:
            self._waiters = [w for w in self._waiters if w[3] is not fut]
            if fut.done():  # granted in the race window: keep it
                return True
            return False
        except asyncio.CancelledError:
            # the waiting task died (interval change cancels peering):
            # drop the waiter, and if the grant raced the cancel, hand the
            # slot back — a dead task can never release it
            self._waiters = [w for w in self._waiters if w[3] is not fut]
            if fut.done():
                self.release(key)
            raise

    def release(self, key: Tuple[int, int]) -> None:
        self.held.pop(key, None)
        while self._waiters and len(self.held) < self.slots:
            _p, _s, k, fut = self._waiters.pop(0)
            if fut.done():
                continue
            self.held[k] = (None, time.monotonic())
            fut.set_result(True)

    def dump(self) -> Dict[str, object]:
        return {
            "slots": self.slots,
            "held": sorted(f"{p}.{g}" for p, g in self.held),
            "queued": len(self._waiters),
        }
