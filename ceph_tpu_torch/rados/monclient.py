# Copy of ceph_tpu/rados/monclient.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Shared mon-target bookkeeping for daemons and clients.

The reference's MonClient (src/mon/MonClient.cc) hunts for a reachable
monitor from the monmap and re-hunts on failure; this helper is the shared
core of that behavior for RadosClient and OSD: parse one addr or a monmap
list, expose the current target, rotate on failure.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class MonTargets:
    def __init__(self, mon_addr):
        """Accepts ('host', port) or a sequence of them."""
        if mon_addr and isinstance(mon_addr[0], (tuple, list)):
            self.addrs: List[Tuple[str, int]] = [tuple(a) for a in mon_addr]
        else:
            self.addrs = [tuple(mon_addr)]
        self._idx = 0

    @property
    def current(self) -> Tuple[str, int]:
        return self.addrs[self._idx % len(self.addrs)]

    def rotate(self) -> None:
        self._idx += 1

    def __len__(self) -> int:
        return len(self.addrs)
