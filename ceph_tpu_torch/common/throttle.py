# Copy of ceph_tpu/common/throttle.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Throttles: bounded-resource backpressure primitives.

Role-equivalent of the reference's Throttle family (reference
src/common/Throttle.cc): a counted budget (bytes, ops) that producers
``get`` (blocking when exhausted, FIFO-fair) and consumers ``put`` back.
The messenger uses one per connection policy for dispatch bytes
(ms_dispatch_throttle_bytes); BlueStore-lite uses one for deferred bytes.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Deque, Optional, Tuple


class Throttle:
    def __init__(self, name: str, max_amount: int):
        self.name = name
        self.max = max_amount
        self.current = 0
        self._waiters: Deque[Tuple[int, asyncio.Future]] = collections.deque()

    def past_midpoint(self) -> bool:
        return self.current >= self.max // 2

    def get_or_fail(self, amount: int) -> bool:
        """Non-blocking acquire (fast-dispatch path uses this).  Fails while
        blocking waiters are queued so it cannot starve them."""
        if self._waiters:
            return False
        if self.max and self.current + amount > self.max and self.current > 0:
            return False
        self.current += amount
        return True

    async def get(self, amount: int) -> None:
        """Blocking acquire, FIFO order so large requests can't starve.
        An idle throttle admits even an oversize request (ref behavior:
        a single op larger than the budget must not wedge)."""
        if self.max == 0 or (
            not self._waiters
            and (self.current + amount <= self.max or self.current == 0)
        ):
            self.current += amount
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append((amount, fut))
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # _wake already granted us the budget; hand it back
                self.current = max(0, self.current - amount)
            else:
                self._waiters = collections.deque(
                    (a, f) for a, f in self._waiters if f is not fut
                )
            self._wake()
            raise

    def would_admit(self, amount: int) -> bool:
        """True when get(amount) would return WITHOUT waiting — the
        messenger's rx batching peeks this before pulling another frame
        into a batch, because blocking on the throttle while holding
        undispatched frames (whose cost is only put() back after
        dispatch) would deadlock the serve loop against itself."""
        if self.max == 0:
            return True
        return not self._waiters and (
            self.current + amount <= self.max or self.current == 0)

    def put(self, amount: int) -> None:
        self.current = max(0, self.current - amount)
        self._wake()

    def _wake(self) -> None:
        while self._waiters:
            amount, fut = self._waiters[0]
            if self.current + amount > self.max and self.current > 0:
                return
            self._waiters.popleft()
            if not fut.done():
                self.current += amount
                fut.set_result(None)

    def reset_max(self, new_max: int) -> None:
        self.max = new_max
        self._wake()
